"""Top-level run configuration: input/output/batch/task aggregation, the
run-directory layout and the command.json resume manifest.

A copy of warpdemux_tpu/config/config.py with the port's SigProcConfig.
`command.json` has the JAX manifest's keys, so a run directory of either
package can be continued or predicted by the other.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from pathlib import Path

from warpdemux_tpu_torch.config.sig_proc import SigProcConfig


@dataclass
class InputConfig:
    files: list = field(default_factory=list)
    read_ids_incl: set = field(default_factory=set)
    read_ids_excl: set = field(default_factory=set)
    continue_from: str = ""


@dataclass
class OutputConfig:
    output_dir: str = ""
    save_fpts: bool = False
    save_dwell_time: bool = False
    save_boundaries: bool = False
    save_predictions: bool = True

    output_subdir_pred: str = "predictions"
    output_subdir_fail: str = "failed_reads"
    output_subdir_fpts: str = "fingerprints"
    output_subdir_boundaries: str = "boundaries"
    # prefix of every shard file name (the JAX package's multi-host runs
    # tag them "h001_"; single-GPU runs leave it empty)
    shard_tag: str = ""

    def __post_init__(self):
        o = self.output_dir
        self.output_dir_pred = os.path.join(o, self.output_subdir_pred)
        self.output_dir_fail = os.path.join(o, self.output_subdir_fail)
        self.output_dir_fpts = os.path.join(o, self.output_subdir_fpts)
        self.output_dir_boundaries = os.path.join(o, self.output_subdir_boundaries)
        if o:
            os.makedirs(o, exist_ok=True)
            os.makedirs(self.output_dir_fail, exist_ok=True)
            if self.save_predictions:
                os.makedirs(self.output_dir_pred, exist_ok=True)
            if self.save_boundaries:
                os.makedirs(self.output_dir_boundaries, exist_ok=True)
            if self.save_fpts:
                os.makedirs(self.output_dir_fpts, exist_ok=True)


@dataclass
class BatchConfig:
    minibatch_size: int = 1000
    batch_size_output: int = 40000
    bidx_pass: int = 0
    bidx_fail: int = 0
    bidx_predict: int = 0
    # worker processes a host, one a device, each over its share of the pod5
    # files (cli.py; 0: every card; a request is capped at the cards there
    # are); the run loop of each runs on one device
    devices: int = 1
    # host->device wire format: "vbz" ships the VBZ inner layout (decoded
    # on the device), "adc" the raw int16 counts
    wire: str = "vbz"
    # two-stage wire of predictions-only vbz runs: samples of each read
    # shipped in stage 1, the tails only where a decision needs them
    # (pipeline/run.use_twostage; 0: the whole preload at once)
    stage1_preload: int = 7168


@dataclass
class TaskConfig:
    command: str = "demux"
    preprocess: bool = True
    predict: bool = True


@dataclass
class ClassifConfig:
    model_name: str = ""


@dataclass
class Config:
    input: InputConfig
    output: OutputConfig
    batch: BatchConfig
    task: TaskConfig
    classif: ClassifConfig
    sig_proc: SigProcConfig

    def write_command_json(self, argv: list[str]) -> None:
        """Persist the run manifest for `continue` / `predict`."""
        path = Path(self.output.output_dir) / "command.json"
        payload = {
            "command": self.task.command,
            "argv": argv,
            "model_name": self.classif.model_name,
            "output_dir": self.output.output_dir,
            "input_files": list(self.input.files),
            "batch": {
                "minibatch_size": self.batch.minibatch_size,
                "batch_size_output": self.batch.batch_size_output,
                "devices": self.batch.devices,
                "wire": self.batch.wire,
            },
            "output": {
                "save_fpts": self.output.save_fpts,
                "save_boundaries": self.output.save_boundaries,
                "save_dwell_time": self.output.save_dwell_time,
            },
        }
        path.write_text(json.dumps(payload, indent=2))

    @staticmethod
    def read_command_json(run_dir: str) -> dict:
        path = Path(run_dir) / "command.json"
        if not path.exists():
            raise FileNotFoundError(
                f"no command.json in {run_dir}; not a previous run directory"
            )
        return json.loads(path.read_text())
