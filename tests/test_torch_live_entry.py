"""The port's live entry point as a user runs it: the replay harness on the
CPU when asked, and an error (nothing run) without a GPU otherwise."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
CONFIG = """
[model]
model_name = "WDX4_rna004_v1_0"
[flowcell]
flowcell_type = "flongle"
[processing]
nproc_classification = 1
[[balancers]]
balance_type = "adapter_count"
min_stat = 2
[reporting]
save_every_sec = 600
save_path = "{save}"
"""


def _run(tmp_path, *flags):
    config = tmp_path / "live.toml"
    config.write_text(CONFIG.format(save=tmp_path / "results"))
    # one CPU thread for torch: the tests share the machine's cores
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return subprocess.run(
        [sys.executable, "-m", "warpdemux_tpu_torch.live.entry_point", "--config_file", str(config), *flags],
        cwd=ROOT, capture_output=True, text=True, timeout=600, env=env,
    )


def test_dummy_session_on_the_cpu(tmp_path):
    out = _run(tmp_path, "--dummy", "--device", "cpu", "--n_reads", "24")
    assert out.returncode == 0, out.stderr
    assert "live lane warm-up" in out.stdout and "counters:" in out.stdout
    assert "segmentation" in out.stdout.split("latency:")[1]
    assert list((tmp_path / "results").glob("barcode_balancing_*.csv"))


def test_without_a_gpu_nothing_runs(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA GPU: the default device exists")
    out = _run(tmp_path, "--dummy", "--n_reads", "24")
    assert out.returncode == 2
    assert "no CUDA device" in out.stderr
    assert "warm-up" not in out.stdout and not (tmp_path / "results").exists()
