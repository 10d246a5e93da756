"""Throughput of the tRNA step, with the inputs on the device.

Port of tools/bench_trna.py: the full tRNA step of WDX4_tRNA_rna004_v1_0
(start-peak detect, consensus-refined segmentation through the
subsequence DTW of kernel K10, re-segmentation, DTW + SVM) on the pa feed
at the chemistry's sig_preload_size, over 12 staged copies of one
minibatch, timed by the fetch-closed pipelined loop of
tools/_throughput.py (2 fetch threads) after one warm-up call. The reads
are synthetic tRNA reads of utils/synthetic (trna_barcode_patterns(4, 25),
synth_trna_barcoded_read, default_rng(0), barcode i % 4 in row i), as the
JAX tool draws them.

With --real the minibatch is instead the small_pod5_*.pod5 reads of the
directory WDX_FIXTURE_DIR names (RNA004 mRNA: the wrong chemistry on
purpose), read through io/pod5.yield_signal_batches and looped to fill B;
the pass count then shows how many wrong-chemistry reads clear the
structural gates. It needs pyarrow (a CPU host's feature: the card's
machine has none).

Prints the JAX tool's line: reads/s, x the 2,630 reads/s of the
reference's 16-core tRNA run, pass=n/N (the first timed pass), then the
card's name and power limit; with --rounds R each round and the median.

Usage:
    python -m warpdemux_tpu_torch.tools.bench_trna [B] [--real] [--rounds 1] [--batches 12] [--device cpu]

Runs on the CUDA GPU unless `--device` names another, and raises without
one. `bench_trna` is the same run as a function.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path
from typing import NamedTuple

import numpy as np

from warpdemux_tpu_torch import _cuda
from warpdemux_tpu_torch.tools import _throughput, _trace

MODEL = "WDX4_tRNA_rna004_v1_0"
TRNA_BASELINE = 2630.0
N_BATCHES = 12


class TrnaRun(NamedTuple):
    feed: str
    B: int
    L: int
    rates: _throughput.Rates
    n_reads: int  # of the first timed pass


def synthetic_reads(B: int, L: int) -> tuple[np.ndarray, np.ndarray]:
    """(sigs (B, L) float32 picoamps, lens (B,) int32): row i a synthetic
    tRNA read of barcode i % 4, drawn from default_rng(0)."""
    from warpdemux_tpu_torch.utils.synthetic import synth_trna_barcoded_read, trna_barcode_patterns

    rng = np.random.default_rng(0)
    sigs = np.zeros((B, L), np.float32)
    lens = np.zeros(B, np.int32)
    pats = trna_barcode_patterns(n_barcodes=4, n_events=25)
    for i in range(B):
        sig, _ = synth_trna_barcoded_read(rng, pats[i % 4])
        n = min(L, sig.size)
        sigs[i, :n] = sig[:n]
        lens[i] = n
    return sigs, lens


def fixture_reads(B: int, L: int, fixture_dir=None) -> tuple[np.ndarray, np.ndarray]:
    """The reads of every small_pod5_*.pod5 in `fixture_dir` (default: the
    WDX_FIXTURE_DIR environment variable), looped to fill B rows; exits with
    the JAX tool's message where there is none."""
    from warpdemux_tpu_torch.io.pod5 import yield_signal_batches

    fixture_dir = fixture_dir or os.environ.get("WDX_FIXTURE_DIR")
    fixtures = sorted(Path(fixture_dir).glob("small_pod5_*.pod5")) if fixture_dir else []
    if not fixtures:
        sys.exit(f"--real: no small_pod5_*.pod5 fixtures in {fixture_dir or '(WDX_FIXTURE_DIR unset)'} "
                 "(set WDX_FIXTURE_DIR to a directory with pod5 fixtures)")
    real_sigs, real_lens = [], []
    for f in fixtures:
        for s, in_lens, _full, _ids in yield_signal_batches([str(f)], None, None, batch_size=200, preload_size=L):
            real_sigs.append(np.asarray(s, np.float32))
            real_lens.append(np.asarray(in_lens, np.int32))
    pool_s = np.concatenate(real_sigs)
    pool_l = np.concatenate(real_lens)
    idx = np.arange(B) % pool_s.shape[0]
    return pool_s[idx], pool_l[idx]


def bench_trna(B: int = 1000, device=None, rounds: int = 1, real: bool = False,
               n_batches: int = N_BATCHES) -> TrnaRun:
    """The tRNA step's throughput on `device` (the GPU unless named)."""
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    device = _cuda.resolve_device(device)
    spc = get_model_spc_config(MODEL)
    L = spc.sig_preload_size
    sigs, lens = fixture_reads(B, L) if real else synthetic_reads(B, L)
    step = make_demux_step(load_model(MODEL, device), spc, input_format="pa", device=device)
    staged = _throughput.stage([(sigs, lens)] * n_batches, device)
    rates = _throughput.in_turns({"trna": _throughput.Path(step, staged, fetchers=2)}, rounds)["trna"]
    feed = "real-mRNA-fixture (wrong chemistry)" if real else "synthetic tRNA"
    return TrnaRun(feed, B, L, rates, n_batches * B)


def line(run: TrnaRun, device) -> str:
    """The JAX tool's line, the card's name and power limit after it."""
    rps = run.rates.median
    return (f"tRNA compute [{run.feed}]: {rps:.0f} reads/s "
            f"(= {rps / TRNA_BASELINE:.1f}x the 16-core reference tRNA baseline) "
            f"pass={run.rates.n_pass}/{run.n_reads} backend={device.type} B={run.B} L={run.L} "
            f"on {_trace.device_name(device)}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("B", nargs="?", type=int, default=1000, help="reads a minibatch")
    p.add_argument("--real", action="store_true", help="the pod5 fixtures of WDX_FIXTURE_DIR in place of tRNA reads")
    p.add_argument("--rounds", type=int, default=1, help="timed passes, each printed, and their median")
    p.add_argument("--batches", type=int, default=N_BATCHES, help="staged copies of the minibatch a pass")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA GPU)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = _cuda.resolve_device(args.device)
    run = bench_trna(args.B, device, args.rounds, args.real, n_batches=args.batches)
    if args.rounds > 1:
        print("\n".join(_throughput.round_lines({"tRNA": run.rates}, _trace.device_name(device))))
    print(line(run, device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
