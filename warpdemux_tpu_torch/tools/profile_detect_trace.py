"""Device operations of the detect stage alone, from torch.profiler.

Port of tools/profile_detect_trace.py: detect/boundaries.py
`detect_boundaries_with_fallback` (WDX4's detect config, the CNN its spc
names) on the calibrated signals of synthetic.synth_minibatch(default_rng(0),
B, 10000) on the device, traced after a warm-up over 6 calls
(tools/_trace.py). Prints the unprofiled wall time, the device's busy ms a
call and its idle share, then the top 40 device operations.

Usage:
    python -m warpdemux_tpu_torch.tools.profile_detect_trace [B] [--reps 6] [--device cpu]

Runs on the CUDA GPU unless `--device` names another, and raises without
one. `profile_detect` is the same run as a function.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from warpdemux_tpu_torch import _cuda
from warpdemux_tpu_torch.tools import _trace

TOP = 40


def profile_detect(B: int = 1000, device=None, reps: int = _trace.REPS) -> _trace.Trace:
    """The trace of `reps` calls of detect_boundaries_with_fallback on B
    calibrated bench reads on `device` (the GPU unless named)."""
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.detect.boundaries import detect_boundaries_with_fallback
    from warpdemux_tpu_torch.models.registry import load_cnn

    device = _cuda.resolve_device(device)
    dcfg = get_model_spc_config(_trace.MODEL).detect
    cnn = load_cnn(get_model_spc_config(_trace.MODEL).cnn_model_name, device) if dcfg.method == "cnn" else None
    adc, offset, scale, lens = _trace.bench_minibatch(B)
    signals = torch.as_tensor((adc.astype(np.float32) + offset[:, None]) * scale[:, None], device=device)
    in_lens = torch.as_tensor(lens.astype(np.int32), device=device)

    @torch.inference_mode()
    def detect():
        return detect_boundaries_with_fallback(signals, in_lens, dcfg, cnn)

    return _trace.trace(detect, device, reps)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("B", nargs="?", type=int, default=1000, help="reads a minibatch")
    p.add_argument("--reps", type=int, default=_trace.REPS, help="calls timed (and traced)")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA GPU)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    t = profile_detect(args.B, args.device, args.reps)
    print(f"# detect wall: {t.wall_ms:.2f} ms/minibatch ({args.B / t.wall_ms * 1e3:.0f} reads/s), B={args.B}, "
          f"on {t.device}")
    print(t.summary())
    print("\n".join(t.table(TOP)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
