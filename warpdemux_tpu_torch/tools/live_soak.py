"""Soak of the live read-until lane: does anything grow with run length?

Port of tools/live_soak.py. The dummy session runs for many reads
(optionally paced at the MinKNOW chunk cadence) while a sampler thread
records, once a second, the size of every structure that could grow with
the run: the latency reservoirs, the CRUD escalation map, the fingerprint
queue, the process's peak RSS and, on the card, the device memory PyTorch
holds (allocated now and at its peak). It prints ONE JSON report:

    python -m warpdemux_tpu_torch.tools.live_soak [--reads 12000] [--chunk-period 0.1]
        [--duration-min 10] [--channels 126] [--batch 64] [--seed 3] [--out report.json] [--device cpu]

With --duration-min, fresh clients are replayed through a new Session
that carries the reporter, the CRUD map and the skip statistics forward,
until the time is up. The session runs on the CUDA GPU unless `--device`
names another, and raises without one.
"""

from __future__ import annotations

import argparse
import csv
import json
import resource
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from warpdemux_tpu_torch._cuda import resolve_device

MODEL = "WDX4_rna004_v1_0"


def build_parser():
    ap = argparse.ArgumentParser(description="Soak of the live lane on the dummy client.")
    ap.add_argument("--reads", type=int, default=12000)
    ap.add_argument("--chunk-period", type=float, default=0.0)
    ap.add_argument(
        "--duration-min", type=float, default=0.0,
        help="if > 0, keep replaying fresh reads until this many minutes "
        "have elapsed (reads count becomes a lower bound)",
    )
    ap.add_argument("--channels", type=int, default=126)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="torch device of the session (default: the CUDA GPU)")
    return ap


def soak(args) -> dict:
    """The soak the parsed `args` describe; returns the report."""
    from warpdemux_tpu_torch.live.balancer import BalancerConfig, BarcodeBalancers
    from warpdemux_tpu_torch.live.dummy import DummyClient, synth_barcoded_read
    from warpdemux_tpu_torch.live.session import Session, SessionConfig
    from warpdemux_tpu_torch.models.registry import load_model

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    model = load_model(MODEL, device)
    rng = np.random.default_rng(args.seed)
    X_sv = model.X_sv.cpu().numpy()
    signals = [synth_barcoded_read(rng, X_sv[i]) for i in range(0, 800, 16)]

    n_reads = args.reads

    def client_for(seed):
        return DummyClient(
            n_reads=n_reads,
            chunk_size=1500,
            n_channels=args.channels,
            seed=seed,
            signals=signals,
            chunk_period_s=args.chunk_period,
            stagger_s=args.chunk_period * 10 if args.chunk_period else 0.0,
        )

    client = client_for(args.seed)
    save_dir = tempfile.mkdtemp(prefix="wdx_soak_")
    cfg = SessionConfig(
        model_name=MODEL,
        save_path=save_dir,
        run_id="soak",
        check_real_range=False,
        max_batch=32,
    )
    balancers = BarcodeBalancers.from_configs(
        model.n_classes - 1,
        [BalancerConfig(balance_type="adapter_count")],
        [1.0],
        n_channels=args.channels,
    )
    session = Session(client, cfg, balancers, model=model, device=device)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    samples: list[dict] = []
    stop = threading.Event()
    progress = {"base": 0}

    def sample():
        with session.reporter._lock:
            lat_n = sum(len(v) for v in session.reporter._lat.values())
        samples.append(dict(
            t=time.time(),
            decided=progress["base"] + len(client.stopped) + len(client.unblocked),
            lat_samples=lat_n,
            crud_channels=len(session.crud._last),
            fpt_queue=session.fpt_queue.qsize(),
            rss_mb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0,
            device_mb=torch.cuda.memory_allocated(device) / 2**20 if on_card else None,
            device_max_mb=torch.cuda.max_memory_allocated(device) / 2**20 if on_card else None,
        ))

    def sampler():
        while not stop.is_set():
            sample()
            stop.wait(1.0)

    th = threading.Thread(target=sampler, daemon=True)
    t0 = time.time()
    th.start()
    deadline = t0 + args.duration_min * 60 if args.duration_min else None
    total_reads = 0
    while True:
        session.run(batch_size=args.batch, warmup=(total_reads == 0))
        total_reads += n_reads
        if deadline is None or time.time() >= deadline:
            break
        # classifier threads are one-shot: replay another client through a
        # fresh Session, carrying the reporter / CRUD / skip stats forward so
        # the memory story spans the whole soak
        client = client_for(args.seed + total_reads)
        progress["base"] = total_reads
        prev = session
        session = Session(client, cfg, balancers, model=model, device=device, reporter=prev.reporter)
        session.crud = prev.crud
        session.skip_stats = prev.skip_stats
    elapsed = time.time() - t0
    stop.set()
    th.join(timeout=3)
    # one final synchronous sample: the shutdown drain decides the last few
    # reads after the sampler's last tick
    sample()

    with open(Path(save_dir) / "barcode_balancing_soak.csv") as fh:
        csv_rows = sum(1 for _ in csv.reader(fh)) - 1
    pct = session.reporter.latency_percentiles()
    table = session.reporter.balance_table(balancers.balancers)
    stats_files = sorted(str(p.name) for p in Path(save_dir).glob("balancer_stats_*.csv"))

    # memory flatness: the sample nearest 1/3 of the decisions against the
    # last (the warm-up's growth is over well before 1/3)
    decided_total = samples[-1]["decided"]
    third = next((s for s in samples if s["decided"] >= decided_total / 3), samples[0])
    last = samples[-1]
    return dict(
        reads=total_reads,
        elapsed_s=round(elapsed, 1),
        reads_per_s=round(total_reads / elapsed, 1),
        decided=decided_total,
        csv_rows=csv_rows,
        skip_stats=dict(session.skip_stats),
        latency_stages=sorted(pct),
        latency_p99_ms={k: round(v["p99"] * 1e3, 2) for k, v in pct.items()},
        latency_reservoir_cap=session.reporter.LAT_RESERVOIR,
        balance_table_lines=len(table.splitlines()),
        balancer_stats_files=stats_files,
        rss_mb_third=third["rss_mb"],
        rss_mb_final=last["rss_mb"],
        device=torch.cuda.get_device_name(device) if on_card else "cpu",
        device_mb_third=third["device_mb"],
        device_mb_final=last["device_mb"],
        device_max_mb_third=third["device_max_mb"],
        device_max_mb_final=last["device_max_mb"],
        lat_samples_third=third["lat_samples"],
        lat_samples_final=last["lat_samples"],
        crud_channels_final=last["crud_channels"],
        fpt_queue_max=max(s["fpt_queue"] for s in samples),
        save_dir=save_dir,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # no CUDA device and no --device cpu: raise before any work
    line = json.dumps(soak(args))
    print(line)
    if args.out:
        Path(args.out).write_text(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
