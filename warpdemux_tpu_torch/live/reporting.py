"""Live-run reporting: accept/reject counters, per-read CSV, latency stats
(a copy of warpdemux_tpu/live/reporting.py; the `csv` module, no pandas).

Capability parity with the reference's reporting worker
(warpdemux/live_balancing/reporting.py): ProcessedCounters tracks
Accept/Reject x {Classified, Unclassified, Failed, Noise} plus per-barcode
accept/reject counts (:23-80); per-read rows append to
barcode_balancing_<runid>.csv; end-of-run per-stage latency mean+/-std
(:505-535).
"""

from __future__ import annotations

import csv
import threading
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

OUTCOMES = ("classified", "unclassified", "failed", "noise")


class ProcessedCounters:
    def __init__(self, num_bcs: int):
        self.num_bcs = num_bcs
        self.accept = {o: 0 for o in OUTCOMES}
        self.reject = {o: 0 for o in OUTCOMES}
        self.bc_accept = np.zeros(num_bcs, int)
        self.bc_reject = np.zeros(num_bcs, int)
        self._lock = threading.Lock()

    def record(self, outcome: str, accepted: bool, barcode: int | None = None):
        with self._lock:
            (self.accept if accepted else self.reject)[outcome] += 1
            if barcode is not None and 0 <= barcode < self.num_bcs:
                if accepted:
                    self.bc_accept[barcode] += 1
                else:
                    self.bc_reject[barcode] += 1

    def summary(self) -> dict:
        with self._lock:
            return {
                "accept": dict(self.accept),
                "reject": dict(self.reject),
                "bc_accept": self.bc_accept.tolist(),
                "bc_reject": self.bc_reject.tolist(),
            }


class LiveReporter:
    """Appends per-read decisions to CSV and aggregates latency stats."""

    LAT_RESERVOIR = 100_000  # per-stage latency samples kept in memory

    CSV_FIELDS = [
        "time",
        "channel",
        "read_id",
        "outcome",
        "barcode",
        "confidence",
        "decision",
        "balancer",
        "chunk_len",
    ]

    def __init__(self, save_path: str | Path, run_id: str, num_bcs: int):
        self.dir = Path(save_path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.csv_path = self.dir / f"barcode_balancing_{run_id}.csv"
        self.counters = ProcessedCounters(num_bcs)
        self._lat = defaultdict(list)
        self._lat_seen = defaultdict(int)
        self._lat_rng = np.random.default_rng(0)
        self._lock = threading.Lock()
        self._fh = open(self.csv_path, "w", newline="")
        self._writer = csv.DictWriter(self._fh, fieldnames=self.CSV_FIELDS)
        self._writer.writeheader()

    def report_read(
        self,
        channel,
        read_id,
        outcome,
        barcode,
        confidence,
        accepted,
        balancer,
        chunk_len,
        time_per_step=None,
    ):
        self.counters.record(
            outcome, accepted, barcode if outcome == "classified" else None
        )
        with self._lock:
            self._writer.writerow(
                {
                    "time": f"{time.time():.3f}",
                    "channel": channel,
                    "read_id": read_id,
                    "outcome": outcome,
                    "barcode": barcode,
                    "confidence": (
                        f"{confidence:.3f}" if confidence is not None else ""
                    ),
                    "decision": "accept" if accepted else "reject",
                    "balancer": balancer,
                    "chunk_len": chunk_len,
                }
            )
            if time_per_step:
                for stage, dt in time_per_step.items():
                    v = self._lat[stage]
                    n = self._lat_seen[stage] = self._lat_seen[stage] + 1
                    # bounded reservoir sample per stage: latency memory
                    # stays flat over an overnight run while percentiles
                    # remain unbiased (reference keeps raw per-read lists,
                    # live_balancing/reporting.py:505-535)
                    if len(v) < self.LAT_RESERVOIR:
                        v.append(dt)
                    else:
                        j = int(self._lat_rng.integers(0, n))
                        if j < self.LAT_RESERVOIR:
                            v[j] = dt

    def latency_stats(self) -> dict:
        """Per-stage (mean, std) seconds — the reference's end-of-run
        latency report (live_balancing/reporting.py:505-535)."""
        with self._lock:
            return {
                stage: (float(np.mean(v)), float(np.std(v)))
                for stage, v in self._lat.items()
                if v
            }

    def latency_percentiles(self) -> dict:
        """Per-stage {p50, p90, p99, max} seconds — the live lane's decision
        budget is one MinKNOW chunk period (100 ms with the shipped
        protocol fragment, minknow_config/...100ms.toml)."""
        with self._lock:
            out = {}
            for stage, v in self._lat.items():
                if not v:
                    continue
                a = np.asarray(v)
                out[stage] = {
                    "n": int(a.size),
                    "p50": float(np.percentile(a, 50)),
                    "p90": float(np.percentile(a, 90)),
                    "p99": float(np.percentile(a, 99)),
                    "max": float(a.max()),
                }
            return out

    # ---- per-balancer time series + console tables (reference
    # report_worker, live_balancing/reporting.py:112-575) ------------------

    def report_balancer_stats(self, balancers) -> None:
        """Append one row per balancer to balancer_stats_<runid>.csv."""
        path = self.dir / self.csv_path.name.replace(
            "barcode_balancing", "balancer_stats"
        )
        new = not path.exists()
        with self._lock:
            with open(path, "a", newline="") as fh:
                w = csv.writer(fh)
                if new:
                    w.writerow(
                        ["time", "balancer", "balance_type"]
                        + [f"bc{i}" for i in range(len(balancers[0].stats))]
                    )
                for b in balancers:
                    w.writerow(
                        [f"{time.time():.3f}", b.name, b.config.balance_type]
                        + [f"{s:.3f}" for s in b.stats]
                    )

    def balance_table(self, balancers) -> str:
        """Human-readable per-balancer barcode statistics."""
        lines = []
        for b in balancers:
            stats = " ".join(f"{s:8.1f}" for s in b.stats)
            valid = "".join("+" if v else "-" for v in b.valid)
            lines.append(
                f"{b.name:<12} {b.config.balance_type:<18} [{valid}] {stats}"
            )
        return "\n".join(lines)

    def reopen(self):
        """Resume appending after a close() — lets one reporter span
        several Session lifetimes (e.g. tools/live_soak.py's replay
        rounds) so counters/latency reservoirs accumulate run-long."""
        with self._lock:
            if self._fh.closed:
                self._fh = open(self.csv_path, "a", newline="")
                self._writer = csv.DictWriter(
                    self._fh, fieldnames=self.CSV_FIELDS
                )

    def close(self):
        with self._lock:
            self._fh.flush()
            self._fh.close()
