"""Live balancing session: the streaming classify-and-eject loop.

Port of warpdemux_tpu/live/session.py, with the same gates, micro-batching,
decisions and reports:

  client chunks -> gates (missed-start, too-long, streaming polyA detect,
  real-range) -> fingerprint queue -> micro-batching classifier threads ->
  balancer decision -> unblock / stop-receiving -> reporting.

Where the JAX lane takes two device programs and two host round trips a
micro-batch (fingerprint, fetch, pack on the host, classify, fetch), the
port takes one: `Session._classify_on_device` copies the padded signals to
the device once, fingerprints them (kernels K5, K4, K2 and K3 on CUDA),
packs the kept rows on the device exactly as the JAX lane packs them on the
host, classifies (K1 and the SVM) and fetches everything in one copy.

The session runs on the CUDA GPU unless it is given `device="cpu"`; with
no device given and no GPU it raises.
"""

from __future__ import annotations

import queue
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from warpdemux_tpu_torch._cuda import resolve_device
from warpdemux_tpu_torch.detect.streaming import (
    RealRangeConfig,
    StreamingConfig,
    mean_var_shift_polya_detect,
    real_range_check,
)
from warpdemux_tpu_torch.live.balancer import BarcodeBalancers
from warpdemux_tpu_torch.live.reporting import LiveReporter
from warpdemux_tpu_torch.ops.fingerprint import fingerprints_from_boundaries


@dataclass
class ReadObject:
    channel: int
    read_id: str
    read_number: int
    signal: np.ndarray
    polya_start: int
    t_created: float = field(default_factory=time.time)
    time_per_step: dict = field(default_factory=dict)
    barcode: int = -1
    confidence: float = 0.0
    outcome: str = "failed"


class ChannelRepeatedUnblockDuration:
    """Escalating unblock durations for repeat offenders
    (reference session.py:61-124).

    Level 0 uses `base` when given — the per-balancer reject_duration
    (reference worker.py:196-200, where the balance-decision unblock takes
    the balancer's duration); repeats within the window escalate to the
    session-wide durations[1], durations[2]."""

    def __init__(self, durations=(0.1, 0.5, 2.0), window_s: float = 1.5):
        self.durations = durations
        self.window_s = window_s
        self._last: dict[int, tuple[float, int]] = {}
        self._lock = threading.Lock()

    def duration(self, channel: int, base: float | None = None) -> float:
        now = time.time()
        with self._lock:
            t_last, level = self._last.get(channel, (0.0, -1))
            level = level + 1 if now - t_last < self.window_s else 0
            level = min(level, len(self.durations) - 1)
            self._last[channel] = (now, level)
            if level == 0 and base is not None:
                return base
            return self.durations[level]


@dataclass
class SessionConfig:
    model_name: str = "WDX4_rna004_v1_0"
    # [acquisition] (reference config_parser.py AcquisitionConfig)
    min_chunk_size: int = 1000
    max_chunk_size: int = 12000
    max_missed_start_offset: int = 400
    # parsed for schema parity; the reference parses it (default
    # min_chunk_size) but no code path consumes it (config_parser.py:140-142)
    min_adapter_length: int = 0
    repeated_unblock_time_window: float = 1.5
    repeated_unblock_duration_2: float = 0.5
    repeated_unblock_duration_3: float = 2.0
    # [balancing]
    max_signal_after_polya: int = 4000
    pred_conf_threshold: float = 0.2
    reject_duration: float = 0.1  # global; per-balancer overrides win
    # [processing]: nproc_classification sizes the classifier-thread pool
    # (the reference's classification pool, session.py:163-166);
    # nproc_segmentation is parsed for schema parity
    nproc_segmentation: int = 2
    nproc_classification: int = 4
    # [reporting]
    save_every_sec: float = 10.0
    save_path: str = "results"
    run_id: str = ""
    check_real_range: bool = True
    max_batch: int = 32
    batch_wait_s: float = 0.005
    streaming: StreamingConfig = field(default_factory=StreamingConfig)
    real_range: RealRangeConfig = field(default_factory=RealRangeConfig)


class LaneResult(NamedTuple):
    """One micro-batch through the lane program, on the host. Row i of
    `fpt` / `ok` is signal i; `pred` / `conf` / `probs` hold the kept rows
    (ok) in their order, then the zero rows of the padding."""

    fpt: np.ndarray  # (n, fingerprint_len) float32
    ok: np.ndarray  # (n,) bool
    pred: np.ndarray  # (max_batch,) int32
    conf: np.ndarray  # (max_batch,) float32
    probs: np.ndarray  # (max_batch, k) float32
    seconds_fingerprint: float  # device time (CUDA events) or host time (CPU)
    seconds_classify: float


class _Clock:
    """Split points of one lane program: CUDA events on the GPU (read after
    the fetch, which waits for them), the host clock on the CPU, where every
    operation has finished when it returns."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def seconds(self, a, b) -> float:
        return a.elapsed_time(b) / 1e3 if self.cuda else b - a


class Session:
    """Drives a read-until-style client with barcode balancing."""

    def __init__(self, client, config: SessionConfig, balancers: BarcodeBalancers,
                 model=None, spc=None, reporter=None, device=None):
        self.client = client
        self.config = config
        self.balancers = balancers
        self.device = resolve_device(device)
        if model is None:
            from warpdemux_tpu_torch.models.registry import load_model

            model = load_model(config.model_name, self.device)
        elif model.device.type != self.device.type:
            raise ValueError(
                f"the model lies on {model.device}, the session runs on {self.device}"
            )
        if spc is None:
            from warpdemux_tpu_torch.config.utils import get_model_spc_config

            spc = get_model_spc_config(config.model_name)
        self.model = model
        self.spc = spc
        self._label_map = model.label_map.cpu().numpy()
        self._clock = _Clock(self.device)
        run_id = config.run_id or uuid.uuid4().hex[:8]
        if reporter is not None:
            # an existing reporter (a previous session's) keeps
            # accumulating; reopen in append mode if that session closed it
            reporter.reopen()
            self.reporter = reporter
        else:
            self.reporter = LiveReporter(config.save_path, run_id, model.n_classes)
        self.crud = ChannelRepeatedUnblockDuration(
            durations=(
                config.reject_duration,
                config.repeated_unblock_duration_2,
                config.repeated_unblock_duration_3,
            ),
            window_s=config.repeated_unblock_time_window,
        )
        self.fpt_queue: queue.Queue = queue.Queue()
        # missed_obs is tracked as a bounded running aggregate (count, sum,
        # last) rather than a per-chunk list: one float per chunk would grow
        # without bound over a multi-hour run. The mean is reported at
        # shutdown like the reference's skip stats (session.py:140-145).
        self.skip_stats = dict(
            missed_obs_n=0,
            missed_obs_sum=0.0,
            missed_obs_last=0,
            missed_reads=0,
            too_long_reads=0,
            not_real_read=0,
            no_polya_yet=0,
        )
        self._stop = threading.Event()
        self._busy = 0  # classifier threads currently processing a batch
        self._busy_lock = threading.Lock()
        # every torch call inside is thread-safe, the kernel library loads
        # under a lock (_cuda.library), balancers / reporter / crud carry
        # their own locks
        n_cls = max(1, int(getattr(config, "nproc_classification", 1)))
        self._classifier_threads = [
            threading.Thread(target=self._classify_loop, name=f"classifier{i}")
            for i in range(n_cls)
        ]

    # ---- the lane program: one device round trip a micro-batch ----------
    # One fixed batch dim (max_batch, padded) and a short ladder of
    # signal-length buckets, as the JAX lane, so the kernels see at most
    # len(_LEN_BUCKETS) shapes.
    _LEN_BUCKETS = (2048, 4096, 6144, 8192, 10240, 12288)

    def _pad(self, signals: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
        """(max_batch, L) float32 signals and (max_batch,) int32 lengths: L
        is the first bucket that holds the longest signal, else its length."""
        B = self.config.max_batch
        max_len = max(s.size for s in signals)
        L = next((b for b in self._LEN_BUCKETS if b >= max_len), max_len)
        sigs = np.zeros((B, L), np.float32)
        lens = np.zeros(B, np.int32)
        for i, s in enumerate(signals):
            m = min(s.size, L)
            sigs[i, :m] = s[:m]
            lens[i] = m
        return sigs, lens

    @torch.inference_mode()
    def _classify_on_device(self, signals: list[np.ndarray]) -> LaneResult:
        """Fingerprint and classify up to max_batch signals in one program
        and one fetch; the same values the JAX lane's `_fingerprint_batch`
        and `model.predict` on its packed rows give."""
        n = len(signals)
        sigs, lens = self._pad(signals)
        B = sigs.shape[0]
        dev = self.device
        t0 = self._clock.mark()
        x = torch.from_numpy(sigs).to(dev)
        in_lens = torch.from_numpy(lens).to(dev)
        res = fingerprints_from_boundaries(
            x, in_lens, torch.zeros_like(in_lens), in_lens, self.spc.fingerprint
        )
        ok = res.ok & torch.isfinite(res.fpt).all(1) & (torch.arange(B, device=dev) < n)
        t1 = self._clock.mark()
        # the kept rows, in their order, to the front of a zero buffer
        order = torch.argsort((~ok).to(torch.int8), stable=True)
        packed = torch.where(ok[order][:, None], res.fpt[order], torch.zeros((), device=dev))
        pred, conf, probs = self.model(packed)
        t2 = self._clock.mark()
        m = res.fpt.shape[1]
        host = torch.cat(
            [res.fpt, ok.float()[:, None], pred.float()[:, None], conf[:, None], probs], 1
        ).cpu().numpy()
        return LaneResult(
            fpt=host[:n, :m],
            ok=host[:n, m] > 0,
            pred=host[:, m + 1].astype(np.int32),
            conf=host[:, m + 2],
            probs=host[:, m + 3 :],
            seconds_fingerprint=self._clock.seconds(t0, t1),
            seconds_classify=self._clock.seconds(t1, t2),
        )

    # ---- classification micro-batcher ------------------------------------
    def _classify_loop(self):
        cfg = self.config
        while not self._stop.is_set():
            batch: list[ReadObject] = []
            try:
                item = self.fpt_queue.get(timeout=0.05)
            except queue.Empty:
                continue
            with self._busy_lock:
                self._busy += 1
            batch.append(item)
            t_deadline = time.time() + cfg.batch_wait_s
            while len(batch) < cfg.max_batch:
                remaining = t_deadline - time.time()
                if remaining <= 0:
                    break
                try:
                    batch.append(self.fpt_queue.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                self._classify_batch(batch)
            finally:
                with self._busy_lock:
                    self._busy -= 1

    def _classify_batch(self, batch: list[ReadObject]):
        cfg = self.config
        t0 = time.time()
        lane = self._classify_on_device([ro.signal for ro in batch])
        dt_seg = lane.seconds_fingerprint / len(batch)
        kept = []
        for ro, ok in zip(batch, lane.ok):
            # the wait from the poly(A) call to the micro-batch's start: the
            # part of the decision latency that is neither stage
            ro.time_per_step["queue"] = t0 - ro.t_created
            ro.time_per_step["segmentation"] = dt_seg
            if not ok:
                ro.outcome = "failed"
                self._decide_and_act(ro, accepted=True)
                continue
            kept.append(ro)
        if not kept:
            return
        dt = lane.seconds_classify / len(kept)
        for ro, p, c in zip(kept, lane.pred, lane.conf):
            ro.time_per_step["classification"] = dt
            ro.confidence = float(c)
            if c < cfg.pred_conf_threshold:
                ro.outcome = "unclassified"
                ro.barcode = -1
            elif int(p) == -1:
                ro.outcome = "noise"
                ro.barcode = -1
            else:
                ro.outcome = "classified"
                # barcode index within the model's class list
                ro.barcode = int(np.nonzero(self._label_map == int(p))[0][0])
            self._decide_and_act(ro)

    def _decide_and_act(self, ro: ReadObject, accepted: bool | None = None):
        cfg = self.config
        balancer = self.balancers.for_channel(ro.channel)
        name = balancer.name if balancer else "-"
        if accepted is None:
            if ro.outcome == "classified" and balancer is not None:
                accepted = balancer.decide(ro.barcode)
                balancer.record_classified(ro.read_id, ro.barcode, accepted)
            else:
                accepted = True  # unclassified/noise/failed: keep sequencing
        # too-late-to-reject suppression (reference worker.py:184-193)
        if not accepted and ro.signal.size - ro.polya_start > cfg.max_signal_after_polya:
            accepted = True
        if accepted:
            self.client.stop_receiving_read(ro.channel, ro.read_number)
        else:
            # per-balancer reject_duration wins over the global one
            # (reference worker.py:196-205); CRUD escalation applies to
            # repeat offenders on top of that base
            base = cfg.reject_duration
            if balancer is not None and balancer.config.reject_duration is not None:
                base = balancer.config.reject_duration
            self.client.unblock_read(
                ro.channel, ro.read_number, self.crud.duration(ro.channel, base)
            )
        ro.time_per_step["total"] = time.time() - ro.t_created
        self.reporter.report_read(
            ro.channel,
            ro.read_id,
            ro.outcome,
            ro.barcode if ro.outcome == "classified" else None,
            ro.confidence,
            accepted,
            name,
            ro.signal.size,
            ro.time_per_step,
        )

    def warmup(self):
        """Run the lane program once in every signal-length bucket, so the
        first live reads pay neither the kernel build nor first launches."""
        rng = np.random.default_rng(0)
        for L in self._LEN_BUCKETS:
            self._classify_on_device([rng.normal(80, 10, L).astype(np.float32)])

    # ---- main loop -------------------------------------------------------
    def run(self, batch_size: int = 64, save_every_sec: float | None = None,
            warmup: bool = True):
        cfg = self.config
        if save_every_sec is None:
            save_every_sec = cfg.save_every_sec
        if warmup:
            t0 = time.time()
            self.warmup()
            print(f"live lane warm-up: {time.time() - t0:.1f}s "
                  f"({len(self._LEN_BUCKETS)} buckets)")
        for th in self._classifier_threads:
            th.start()
        next_report = time.time() + save_every_sec
        try:
            while self.client.is_running:
                chunks = self.client.get_read_chunks(
                    batch_size=batch_size, min_chunk_length=cfg.min_chunk_size
                )
                if time.time() >= next_report:
                    # per-balancer time series + console balance table
                    # (reference report_worker cadence)
                    self.reporter.report_balancer_stats(self.balancers.balancers)
                    print(self.reporter.balance_table(self.balancers.balancers))
                    next_report = time.time() + save_every_sec
                if not chunks:
                    time.sleep(0.005)
                    continue
                for channel, read in chunks:
                    self._handle_chunk(channel, read)
        finally:
            self.reporter.report_balancer_stats(self.balancers.balancers)
            self.shutdown()

    def _handle_chunk(self, channel, read):
        cfg = self.config
        sig = read.signal
        # missed-start gate (reference session.py:287-312): observations
        # missed before the first captured chunk = chunk_start_sample -
        # read start_sample (negative means the read started inside this
        # chunk); too many missed samples means the adapter is gone
        missed_obs = read.chunk_start - read.start_sample
        ss = self.skip_stats
        ss["missed_obs_n"] += 1
        ss["missed_obs_sum"] += missed_obs
        ss["missed_obs_last"] = missed_obs
        if missed_obs > cfg.max_missed_start_offset:
            self.skip_stats["missed_reads"] += 1
            self.client.stop_receiving_read(channel, read.read_number)
            # reference emits a FailedRead(reason="missed_obs",
            # decision="retain") result row (session.py:295-311)
            self.reporter.report_read(
                channel, read.read_id, "failed", -1, 0.0,
                accepted=True, balancer=-1, chunk_len=sig.size,
            )
            return
        if missed_obs < 0:
            # the read started inside this captured chunk: the leading
            # -missed_obs samples belong to the previous read / open pore
            # and must not enter polyA detection or the adapter region
            # (reference session.py:316-317, calibrated_signal[-missed_obs:]).
            # chunk_start / start_sample are fixed per read, so every
            # re-delivery trims identically.
            sig = sig[-missed_obs:]
        if sig.size > cfg.max_chunk_size:
            self.skip_stats["too_long_reads"] += 1
            self.client.stop_receiving_read(channel, read.read_number)
            return
        polya = mean_var_shift_polya_detect(sig, cfg.streaming)
        if polya == 0:
            self.skip_stats["no_polya_yet"] += 1
            return  # keep accumulating
        self.client.stop_receiving_read(channel, read.read_number)
        if cfg.check_real_range and not real_range_check(sig[:polya], cfg.real_range):
            self.skip_stats["not_real_read"] += 1
            return
        pad = self.spc.fingerprint.padding
        ro = ReadObject(
            channel=channel,
            read_id=read.read_id,
            read_number=read.read_number,
            signal=sig[: polya + pad],
            polya_start=polya,
        )
        self.fpt_queue.put(ro)

    def shutdown(self):
        # drain the classification queue, then stop the workers cleanly
        deadline = time.time() + 30.0
        while time.time() < deadline:
            with self._busy_lock:
                busy = self._busy
            if self.fpt_queue.empty() and busy == 0:
                break
            time.sleep(0.05)
        self._stop.set()
        for th in self._classifier_threads:
            if th.is_alive():
                th.join()
        self.balancers.stop()
        ss = self.skip_stats
        mean_missed = ss["missed_obs_sum"] / max(ss["missed_obs_n"], 1)
        print(
            "skip stats: "
            f"missed_reads={ss['missed_reads']} "
            f"too_long_reads={ss['too_long_reads']} "
            f"not_real_read={ss['not_real_read']} "
            f"no_polya_yet={ss['no_polya_yet']} "
            f"mean_missed_obs={mean_missed:.1f} over {ss['missed_obs_n']} chunks"
        )
        self.reporter.close()
