"""Decision latency of the live read-until lane.

Port of tools/live_latency.py: the dummy client (48 barcoded reads drawn
from WDX4's support vectors with default_rng(5), seed 7, 126 channels, one
chunk of 1500 samples every 100 ms, molecules entering their pores over
4 s) runs through a whole live/session.Session, and the decision latency
of each stage is printed as p50 / p90 / p99 / max against the decision
budget, one MinKNOW chunk period of 100 ms.

Usage:
    python -m warpdemux_tpu_torch.tools.live_latency [--reads 400] [--channels 126]
        [--max-batch 16] [--batch-wait 0.005] [--save DIR] [--assert-budget] [--device cpu]

The session runs on the CUDA GPU unless `--device` names another, and
raises without one. `measure` is the same run as a function.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from warpdemux_tpu_torch import _cuda

MODEL = "WDX4_rna004_v1_0"
BUDGET_S = 0.100  # one MinKNOW chunk period


class LatencyRun(NamedTuple):
    """What one measured session gives: per-stage latency percentiles in
    seconds (LiveReporter.latency_percentiles), the kernel launches of the
    whole run, its wall time, the reads the client delivered and how many
    of them got no decision, the reporter's counters, and every exception a
    classifier thread raised (thread name, exception)."""

    percentiles: dict
    launches: dict
    wall_s: float
    delivered: int
    undecided: int
    counters: dict
    errors: list


def measure(reads=400, channels=126, max_batch=16, batch_wait=0.005, nproc_classification=4, device=None,
            save=None) -> LatencyRun:
    """One session of `reads` replayed reads on `device` (the GPU unless
    named), `nproc_classification` classifier threads."""
    from warpdemux_tpu_torch.live.balancer import BalancerConfig, BarcodeBalancers
    from warpdemux_tpu_torch.live.dummy import DummyClient, synth_barcoded_read
    from warpdemux_tpu_torch.live.session import Session, SessionConfig
    from warpdemux_tpu_torch.models.registry import load_model

    device = _cuda.resolve_device(device)
    model = load_model(MODEL, device)
    rng = np.random.default_rng(5)
    X_sv = model.X_sv.cpu().numpy()
    signals = [synth_barcoded_read(rng, X_sv[rng.integers(0, len(X_sv))]) for _ in range(48)]
    client = DummyClient(
        n_reads=reads, chunk_size=1500, seed=7, signals=signals, n_channels=channels,
        chunk_period_s=0.1,  # MinKNOW's 100 ms chunk cadence
        stagger_s=4.0,  # molecules enter their pores at random times
    )
    cfg = SessionConfig(
        model_name=MODEL,
        save_path=save or tempfile.mkdtemp(prefix="wdx_live_latency_"),
        run_id="latency",
        check_real_range=False,
        max_batch=max_batch,
        batch_wait_s=batch_wait,
        nproc_classification=nproc_classification,
    )
    balancers = BarcodeBalancers.from_configs(4, [BalancerConfig(balance_type="read_count")], [1.0], n_channels=126)
    session = Session(client, cfg, balancers, model=model, device=device)
    errors = []
    hook = threading.excepthook
    threading.excepthook = lambda a: errors.append((a.thread.name if a.thread else "", a.exc_value))
    try:
        _cuda.reset_launches()
        t0 = time.perf_counter()
        session.run(batch_size=64)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        launches = dict(_cuda.launches)
    finally:
        threading.excepthook = hook
    delivered = {r.read_id for r in client._reads if r.delivered}
    decided = set(client.stopped) | set(client.unblocked)
    return LatencyRun(
        session.reporter.latency_percentiles(), launches, wall, len(delivered), len(delivered - decided),
        session.reporter.counters.summary(), errors,
    )


def table(pct: dict) -> list[str]:
    """The per-stage markdown table, in milliseconds."""
    lines = ["| stage | n | p50 ms | p90 ms | p99 ms | max ms |", "|---|---|---|---|---|---|"]
    for stage, s in pct.items():
        lines.append(
            f"| {stage} | {s['n']} | {s['p50'] * 1e3:.1f} | {s['p90'] * 1e3:.1f}"
            f" | {s['p99'] * 1e3:.1f} | {s['max'] * 1e3:.1f} |"
        )
    return lines


def build_parser():
    ap = argparse.ArgumentParser(description="Decision latency of the live lane on the dummy client.")
    ap.add_argument("--reads", type=int, default=400)
    ap.add_argument("--save", default=None, help="reporting directory (default: a new temporary one)")
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--batch-wait", type=float, default=0.005)
    ap.add_argument("--channels", type=int, default=126, help="active channel count")
    ap.add_argument("--assert-budget", action="store_true",
                    help="exit nonzero unless p99 total latency < one chunk period")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="torch device of the session (default: the CUDA GPU)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = _cuda.resolve_device(args.device)
    run = measure(args.reads, args.channels, args.max_batch, args.batch_wait, device=device, save=args.save)
    if run.errors:
        raise RuntimeError(f"a classifier thread raised: {run.errors}")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"# device={name} reads={args.reads} channels={args.channels} wall={run.wall_s:.1f}s")
    print("\n".join(table(run.percentiles)))
    tot = run.percentiles.get("total")
    if tot:
        verdict = "PASS" if tot["p99"] < BUDGET_S else "FAIL"
        print(f"# p99 decision latency {tot['p99'] * 1e3:.1f} ms vs one 100 ms chunk period: {verdict}")
        if args.assert_budget and verdict == "FAIL":
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
