"""Barcode balancers: per-channel-group accept/reject policy (a copy of
warpdemux_tpu/live/balancer.py; the pod5 watcher reads through the port's
io/pod5.py).

Capability parity with the reference's live balancing strategies
(warpdemux/live_balancing/balancer.py:268-643):

- strategies: none / reject_all / adapter_count / read_count /
  base_normalization,
- decision rule (balancer.py:480-515): accept unless
  stats[bc] - mean(valid stats) > balance_threshold * mean(valid stats),
- blacklist / ignorelist / per-barcode max_stats caps,
- watcher strategies (read_count, base_normalization) poll a pod5 output
  directory and credit only reads that were accepted in-run, with
  kbases ~ (num_minknow_events - 100) / 1000 (balancer.py:125-136),
- a missing-barcode watchdog marks barcodes invalid for the mean when not
  seen after wait_to_see seconds (balancer.py:535-549).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

_log = logging.getLogger(__name__)

WATCHER_STRATEGIES = {"read_count", "base_normalization"}
STRATEGIES = {"none", "reject_all", "adapter_count"} | WATCHER_STRATEGIES


@dataclass
class BalancerConfig:
    """One [[balancers]] entry (reference config_parser.py:225-363).

    reject_duration=None means "use the session-global [balancing]
    reject_duration" (reference worker.py:196-200). channels, when
    non-empty, is an explicit channel list that bypasses the
    channel_frac/channel_num split."""

    balance_type: str = "none"
    name: str = ""
    balance_threshold: float = 0.4
    min_stat: float = 10.0
    reject_duration: float | None = None
    watch_for_missing: bool = True
    wait_to_see: float = 60.0
    channel_frac: float | None = None
    channel_num: int | None = None
    channels: tuple = ()
    pred_conf_threshold: float | None = None
    barcodes_blacklist: tuple = ()
    barcodes_ignorelist: tuple = ()
    max_stats: dict = field(default_factory=dict)
    pod5_watch_dir: str = ""
    pod5_check_interval: float = 0.5


class BarcodeBalancer:
    def __init__(self, num_bcs: int, config: BalancerConfig, name: str = "b0"):
        if config.balance_type not in STRATEGIES:
            raise ValueError(
                f"unknown balance_type {config.balance_type!r}; "
                f"choose from {sorted(STRATEGIES)}"
            )
        self.name = name
        self.config = config
        self.num_bcs = num_bcs
        self.stats = np.zeros(num_bcs)  # per-barcode balancing statistic
        self.valid = np.ones(num_bcs, bool)
        self.t_start = time.time()
        self.seen = np.zeros(num_bcs, bool)
        self._lock = threading.Lock()
        self._accepted_read_ids: dict[str, int] = {}  # read_id -> barcode
        self._watched_files: set[str] = set()
        self._watcher: threading.Thread | None = None
        self._stop = threading.Event()
        # NOTE: blacklisted barcodes stay in `valid` — they count toward the
        # balance mean like the reference's (their reads are rejected in
        # decide(), but their statistics still shape the target mean)
        if config.balance_type in WATCHER_STRATEGIES and config.pod5_watch_dir:
            self._watcher = threading.Thread(
                target=self._pod5_watch_loop, daemon=True
            )
            self._watcher.start()

    # ---- decision --------------------------------------------------------
    def decide(self, barcode: int) -> bool:
        """True = accept (keep sequencing), False = reject (unblock)."""
        cfg = self.config
        if cfg.balance_type == "none":
            return True
        if cfg.balance_type == "reject_all":
            return False
        if barcode < 0 or barcode >= self.num_bcs:
            return True  # unclassified/noise handled upstream
        if barcode in cfg.barcodes_blacklist:
            return False
        if barcode in cfg.barcodes_ignorelist:
            return True
        with self._lock:
            stat = self.stats[barcode]
            mx = cfg.max_stats.get(barcode)
            if mx is not None and stat >= mx:
                return False
            self._update_watchdog()
            valid = self.valid & ~np.isin(
                np.arange(self.num_bcs), cfg.barcodes_ignorelist
            )
            vstats = self.stats[valid]
            if vstats.size == 0 or vstats.mean() < cfg.min_stat:
                return True
            mean = vstats.mean()
            return not (stat - mean > cfg.balance_threshold * mean)

    def _update_watchdog(self):
        # missing-barcode watchdog (reference balancer.py:535-549), gated by
        # watch_for_missing (config_parser.py watch_for_missing key)
        if not self.config.watch_for_missing:
            return
        if time.time() - self.t_start > self.config.wait_to_see:
            self.valid = self.valid & self.seen

    # ---- statistics updates ---------------------------------------------
    def record_classified(self, read_id: str, barcode: int, accepted: bool):
        if barcode < 0 or barcode >= self.num_bcs:
            return
        with self._lock:
            self.seen[barcode] = True
            if self.config.balance_type == "adapter_count" and accepted:
                self.stats[barcode] += 1
            elif accepted and self.config.balance_type in WATCHER_STRATEGIES:
                self._accepted_read_ids[read_id] = barcode

    # ---- pod5 watcher ----------------------------------------------------
    def _pod5_watch_loop(self):
        from warpdemux_tpu_torch.io.pod5 import Pod5Reader

        while not self._stop.is_set():
            try:
                for f in Path(self.config.pod5_watch_dir).glob("*.pod5"):
                    key = str(f)
                    if key in self._watched_files:
                        continue
                    self._watched_files.add(key)
                    reader = Pod5Reader(f)
                    for rec in reader.reads():
                        bc = self._accepted_read_ids.get(rec.read_id)
                        if bc is None:
                            continue
                        with self._lock:
                            if self.config.balance_type == "read_count":
                                self.stats[bc] += 1
                            else:  # base_normalization
                                kb = max(rec.num_minknow_events - 100, 0) / 1000.0
                                self.stats[bc] += kb
            except Exception:  # a file being written, a missing directory
                _log.warning("pod5 watcher: %s", self.config.pod5_watch_dir, exc_info=True)
            self._stop.wait(self.config.pod5_check_interval)

    def stop(self):
        self._stop.set()
        if self._watcher is not None:
            self._watcher.join(timeout=2.0)


class BarcodeBalancers:
    """Maps channels to balancers (reference balancer.py:567-643); channels
    are assigned by random permutation according to channel_frac splits
    (config_parser.py:445-506)."""

    def __init__(self, balancers: list[BarcodeBalancer], channel_map: dict):
        self.balancers = balancers
        self.channel_map = channel_map  # channel -> balancer index

    @classmethod
    def from_configs(
        cls,
        num_bcs: int,
        configs: list[BalancerConfig],
        channel_fracs: list[float] | None = None,
        n_channels: int = 512,
        seed: int = 0,
        min_channel: int = 1,
        max_channel: int | None = None,
    ):
        """Assign channels to balancers (reference config_parser.py:445-506).

        Per balancer, an explicit `channels` list wins; else `channel_num`;
        else `channel_frac` of the flowcell (the legacy positional
        channel_fracs list overrides cfg.channel_frac when given). Channels
        are drawn from a seeded random permutation of
        [min_channel, max_channel]. Leftover channels join the first 'none'
        balancer, or a new 'unused_channels' none balancer is appended
        (reference MainConfig._create_balancers). Duplicate balancer names
        raise.
        """
        if max_channel is None:
            max_channel = n_channels
        rng = np.random.default_rng(seed)
        all_channels = np.arange(min_channel, max_channel + 1)
        n_all = all_channels.size
        pool = list(rng.permutation(all_channels))
        explicit = {int(c) for cfg in configs for c in cfg.channels}
        pool = [c for c in pool if int(c) not in explicit]

        balancers, channel_map = [], {}
        for i, cfg in enumerate(configs):
            if cfg.channels:
                chans = [int(c) for c in cfg.channels]
            else:
                if channel_fracs is not None:
                    frac = channel_fracs[i]
                    n = int(frac * n_all)
                elif cfg.channel_num is not None:
                    n = int(cfg.channel_num)
                else:
                    n = int((cfg.channel_frac
                             if cfg.channel_frac is not None else 1.0) * n_all)
                if n > len(pool):
                    raise ValueError(
                        f"balancer {i}: wants {n} channels but only "
                        f"{len(pool)} are available; specify channel_frac "
                        "for each balancer"
                    )
                chans = sorted(int(c) for c in pool[:n])
                del pool[:n]
            b = BarcodeBalancer(num_bcs, cfg, name=cfg.name or f"balancer{i}")
            balancers.append(b)
            for c in chans:
                channel_map[c] = i

        names = [b.name for b in balancers]
        if len(names) != len(set(names)):
            raise ValueError(
                f"duplicate balancer names in config: {names}; give each "
                "balancer of the same balance_type a unique name"
            )

        if pool:
            none_idx = next(
                (i for i, b in enumerate(balancers)
                 if b.config.balance_type == "none"),
                None,
            )
            if none_idx is None:
                balancers.append(
                    BarcodeBalancer(
                        num_bcs,
                        BalancerConfig(balance_type="none"),
                        name="unused_channels",
                    )
                )
                none_idx = len(balancers) - 1
            for c in pool:
                channel_map[int(c)] = none_idx
        return cls(balancers, channel_map)

    def for_channel(self, channel: int) -> BarcodeBalancer | None:
        i = self.channel_map.get(channel)
        return self.balancers[i] if i is not None else None

    def stop(self):
        for b in self.balancers:
            b.stop()
