"""Minibatch-size sweep of the step, with the inputs on the device.

Port of tools/sweep_minibatch.py: WDX4 RNA004 on the adc feed, the `full`
and `decision` steps at B in {500, 1000, 2000, 4000}, each over
max(16000 // B, 4) staged minibatches of utils/synthetic.synth_minibatch
(one default_rng(0) drawn in turn for every B, as the JAX tool draws
them), timed by the fetch-closed pipelined loop of tools/_throughput.py
(2 fetch threads) after one warm-up call. Prints the JAX tool's Markdown
table; "compile s" is the full step's first call at that B (the kernels'
build at the process's first launch, then the warm-up), and a last column
gives the peak memory the caching allocator held for that B (staged
inputs and the step's intermediates). The card's name and power limit
head the table.

Usage:
    python -m warpdemux_tpu_torch.tools.sweep_minibatch [B ...] [--rounds 1] [--reads 16000] [--device cpu]

Runs on the CUDA GPU unless `--device` names another, and raises without
one. `sweep` is the same run as a function.
"""

from __future__ import annotations

import argparse
import sys
from typing import NamedTuple

import numpy as np

from warpdemux_tpu_torch import _cuda
from warpdemux_tpu_torch.tools import _throughput, _trace

MODEL = "WDX4_rna004_v1_0"
SIZES = (500, 1000, 2000, 4000)
N_READS = 16000  # a measurement
OUTPUTS = ("full", "decision")


class SweepRow(NamedTuple):
    B: int
    n_batches: int
    rates: dict[str, _throughput.Rates]  # by outputs
    peak_bytes: int | None  # None on the CPU

    def cells(self) -> list[str]:
        peak = "n/a" if self.peak_bytes is None else f"{self.peak_bytes / 2**30:.2f}"
        return [str(self.B), f"{self.rates['full'].first_s:.0f}", f"{self.rates['full'].median:.0f}",
                f"{self.rates['decision'].median:.0f}", peak]


HEADER = ["| B | compile s | full-output reads/s | decision reads/s | peak allocated GiB |",
          "|---|---|---|---|---|"]


def sweep(sizes=SIZES, device=None, rounds: int = 1, n_reads: int = N_READS, distinct: int | None = None):
    """Yield a SweepRow for each B in `sizes` on `device` (the GPU unless
    named). `distinct`: draw only that many minibatches a B and stage the
    rest as copies of them."""
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    device = _cuda.resolve_device(device)
    model = load_model(MODEL, device)
    spc = get_model_spc_config(MODEL)
    steps = {outputs: make_demux_step(model, spc, input_format="adc", outputs=outputs, device=device)
             for outputs in OUTPUTS}
    rng = np.random.default_rng(0)
    for B in sizes:
        n_batches = max(n_reads // B, 4)
        _throughput.reset_peak_memory(device)
        staged = _throughput.stage_minibatches(rng, B, n_batches, device, distinct)
        rates = _throughput.in_turns(
            {outputs: _throughput.Path(steps[outputs], staged, fetchers=2) for outputs in OUTPUTS}, rounds)
        yield SweepRow(B, n_batches, rates, _throughput.peak_memory(device))
        del staged


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("sizes", nargs="*", type=int, default=list(SIZES), help="minibatch sizes")
    p.add_argument("--rounds", type=int, default=1, help="timed passes of each step, taken in turns")
    p.add_argument("--reads", type=int, default=N_READS, help="reads a measurement (at least 4 minibatches)")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA GPU)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = _cuda.resolve_device(args.device)
    name = _trace.device_name(device)
    print(f"# {MODEL}, adc feed, inputs on the device, {args.reads} reads a measurement, "
          f"rounds={args.rounds}, on {name}")
    print("\n".join(HEADER), flush=True)
    for row in sweep(args.sizes, device, args.rounds, args.reads):
        print("| " + " | ".join(row.cells()) + " |", flush=True)
        if args.rounds > 1:
            print("\n".join(f"# B={row.B} {line[2:]}" for line in _throughput.round_lines(row.rates, name)),
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
