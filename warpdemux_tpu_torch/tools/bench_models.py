"""Step throughput across model sizes, with the inputs on the device.

Port of tools/bench_models.py: WDX4 (851 reference fingerprints, 5
classes), WDX6 (1,368) and WDX10 (2,601, 11 classes) RNA004 through the
`full` and `decision` steps of pipeline/step.make_demux_step on the adc
feed, over 16 staged minibatches of
utils/synthetic.synth_minibatch(default_rng(0), 1000, 10000), each timed
by the fetch-closed pipelined loop of tools/_throughput.py (4 fetch
threads) after one warm-up call. Prints the JAX tool's JSON line for each
model (`model, n_ref, n_classes, full_reads_per_s, full_vs_baseline,
decision_reads_per_s, decision_vs_baseline`, baseline 700 reads/s: the
reference's CPU figure), with the card's name and power limit under
`device` and, with `--rounds R` (the paths timed in turns), each round.

Usage:
    python -m warpdemux_tpu_torch.tools.bench_models [MODEL ...] [--rounds 1] [--batch 1000]
        [--batches 16] [--device cpu]

Runs on the CUDA GPU unless `--device` names another, and raises without
one. `bench_models` is the same run as a function.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from warpdemux_tpu_torch import _cuda
from warpdemux_tpu_torch.tools import _throughput, _trace
from warpdemux_tpu_torch.utils import synthetic

BASELINE_READS_PER_S = 700.0
N_BATCHES = 16  # the JAX tool's (ramp and drain weigh ~25% at 12)
MODELS = ("WDX4_rna004_v1_0", "WDX6_rna004_v1_0", "WDX10_rna004_v1_0")
OUTPUTS = ("full", "decision")


def bench_models(models=MODELS, device=None, rounds: int = 1, B: int = synthetic.B, n_batches: int = N_BATCHES,
                 distinct: int | None = None) -> list[tuple[dict, dict[str, _throughput.Rates]]]:
    """For each model, (its JSON row, the Rates of its `full` and `decision`
    steps) over the same staged minibatches on `device` (the GPU unless
    named)."""
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    device = _cuda.resolve_device(device)
    name = _trace.device_name(device)
    staged = _throughput.stage_minibatches(np.random.default_rng(0), B, n_batches, device, distinct)
    out = []
    for model_name in models:
        model = load_model(model_name, device)
        spc = get_model_spc_config(model_name)
        paths = {
            outputs: _throughput.Path(
                make_demux_step(model, spc, input_format="adc", outputs=outputs, device=device), staged)
            for outputs in OUTPUTS
        }
        rates = _throughput.in_turns(paths, rounds)
        full, dec = rates["full"].median, rates["decision"].median
        row = dict(
            model=model_name,
            n_ref=int(model.X_sv.shape[0]),
            n_classes=int(model.n_classes),
            full_reads_per_s=round(full, 0),
            full_vs_baseline=round(full / BASELINE_READS_PER_S, 1),
            decision_reads_per_s=round(dec, 0),
            decision_vs_baseline=round(dec / BASELINE_READS_PER_S, 1),
            device=name,
        )
        if rounds > 1:
            # unrounded: the median of exactly these values is the row's rate
            row["full_rounds"] = list(rates["full"].rounds)
            row["decision_rounds"] = list(rates["decision"].rounds)
        out.append((row, rates))
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("models", nargs="*", default=list(MODELS), help="model names (default: WDX4, WDX6, WDX10)")
    p.add_argument("--rounds", type=int, default=1, help="timed passes of each step, taken in turns")
    p.add_argument("--batch", type=int, default=synthetic.B, help="reads a minibatch")
    p.add_argument("--batches", type=int, default=N_BATCHES, help="staged minibatches a pass")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA GPU)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = _cuda.resolve_device(args.device)
    print(f"# device={_trace.device_name(device)} B={args.batch} batches={args.batches} rounds={args.rounds} "
          f"(device-resident adc feed)", file=sys.stderr)
    for row, rates in bench_models(args.models, device, args.rounds, args.batch, args.batches):
        if args.rounds > 1:
            print("\n".join(f"# {row['model']} {line[2:]}" for line in _throughput.round_lines(rates, row["device"])),
                  file=sys.stderr)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
