"""Device operations of the whole demux step, from torch.profiler.

Port of tools/profile_step_trace.py: `make_demux_step` (WDX4, the adc feed
or the vbz wire) on synthetic.synth_minibatch(default_rng(0), B, 10000) with
the inputs on the device, traced after a warm-up over 6 steps
(tools/_trace.py). Prints the unprofiled wall time, the device's busy ms
a step and its idle share of the traced window (in place of the JAX tool's
module-lane and op-lane times), then the top 30 device operations with the
CPU operation that launched each (the JAX tool's scope column).

Usage:
    python -m warpdemux_tpu_torch.tools.profile_step_trace [B] [full|decision] [--feed adc|vbz]
        [--reps 6] [--device cpu]

Runs on the CUDA GPU unless `--device` names another, and raises without
one. `profile_step` is the same run as a function.
"""

from __future__ import annotations

import argparse
import sys

import torch

from warpdemux_tpu_torch import _cuda
from warpdemux_tpu_torch.tools import _trace

TOP = 30


def profile_step(B: int = 1000, outputs: str = "full", feed: str = "adc", device=None,
                 reps: int = _trace.REPS) -> _trace.Trace:
    """The trace of `reps` steps of make_demux_step(WDX4, input_format=feed,
    outputs=outputs) on B bench reads on `device` (the GPU unless named)."""
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    device = _cuda.resolve_device(device)
    step = make_demux_step(load_model(_trace.MODEL, device), get_model_spc_config(_trace.MODEL),
                           input_format=feed, outputs=outputs, device=device)
    adc, offset, scale, lens = _trace.bench_minibatch(B)
    head = _trace.vbz_pack(adc) if feed == "vbz" else (adc,)
    args = tuple(torch.as_tensor(a, device=device) for a in (*head, offset, scale, lens))
    return _trace.trace(lambda: step(*args), device, reps)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("B", nargs="?", type=int, default=1000, help="reads a minibatch")
    p.add_argument("outputs", nargs="?", choices=("full", "decision"), default="full")
    p.add_argument("--feed", choices=("adc", "vbz"), default="adc", help="the step's input format")
    p.add_argument("--reps", type=int, default=_trace.REPS, help="calls timed (and traced)")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA GPU)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    t = profile_step(args.B, args.outputs, args.feed, args.device, args.reps)
    print(f"# step({args.feed}, {args.outputs}) wall: {t.wall_ms:.2f} ms/minibatch "
          f"({args.B / t.wall_ms * 1e3:.0f} reads/s), B={args.B}, on {t.device}")
    print(t.summary())
    print("\n".join(t.table(TOP)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
