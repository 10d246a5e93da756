"""Offline batch pipeline: pod5 minibatches -> device steps -> sharded CSVs.

Port of warpdemux_tpu/pipeline/run.py, with the JAX design:

- a producer thread turns the feed's minibatches into device tensors,
  padded to the step's batch size, behind a bounded queue (4);
- the main thread dispatches one demux step a minibatch;
- a postprocess thread (queue of 3) fetches results, builds the tables and
  writes `batch_size_output`-row shards; it alone updates RunStats;
- a minibatch whose step fails is logged and its reads counted as failed.

Predictions-only runs on the vbz wire take the JAX package's two-stage
wire where its rule allows (`use_twostage`): the producer cuts each
minibatch's wire on the host and stages only the first stage1_preload
samples of each read; stage 1 runs the decision chain on them with the
detect `resolved` bit; where a row of the minibatch is unresolved, its
tail is packed on the host, copied, and stage 2 runs the full-width chain
and merges row-wise. Stage 2 runs on the main thread, one minibatch
behind its stage 1, so the device has the next stage 1 queued while the
host reads `resolved` and packs the tails. (The JAX run launches stage 2
on its postprocess thread; on the H100 that placement ran at 0.71x this
one, two threads launching contending for the interpreter lock: PERF.md
section 6.)

`run_demux` builds the pod5 feed (`yield_vbz_batches` or
`yield_adc_batches` by `config.batch.wire`) and hands it to
`demux_minibatches`, which runs the loop over any iterable of the tuples
those feeds yield.

On a CUDA device the producer copies each minibatch from pinned host memory
on a copy stream of its own; the step's stream waits on the copy's event,
and the tensors made on the copy stream are recorded on the step's stream
for the caching allocator. The main thread starts each result's copy back
into pinned memory right after the step and records an event, which the
postprocess thread waits on: no thread synchronises the whole stream.

A run loop runs on one device. Runs over several devices or hosts are
several processes (parallel/multihost.run_workers, cli.py `-j` and
`--coordinator`), each over its own pod5 files; in a process group the
run's counters are summed over the processes at the end.

The tables are io/writers.Table, written with gzip and csv: the run loop,
the writers and the resume scan need no pandas.
"""

from __future__ import annotations

import logging
import queue
import sys
import threading
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from warpdemux_tpu_torch._cuda import resolve_device
from warpdemux_tpu_torch.config.config import Config
from warpdemux_tpu_torch.detect.containers import DetectArrays, fail_code_to_reason
from warpdemux_tpu_torch.io import writers
from warpdemux_tpu_torch.io.writers import Table
from warpdemux_tpu_torch.parallel.multihost import global_class_counts, init_distributed
from warpdemux_tpu_torch.ops.vbz_device import split_wire_host
from warpdemux_tpu_torch.pipeline.step import (
    PackedStepOutput,
    make_demux_step,
    make_twostage_decision_step,
    twostage_stage2,
)


class _ShardAccumulator:
    """Accumulates tables and flushes batch_size_output-row shards."""

    def __init__(self, flush_fn, rows_per_shard: int, bidx0: int = 0):
        self.flush_fn = flush_fn
        self.rows_per_shard = rows_per_shard
        self.bidx = bidx0
        self.tables: list[Table] = []
        self.count = 0

    def add(self, table: Table | None):
        if table is None or not len(table):
            return
        self.tables.append(table)
        self.count += len(table)
        while self.count >= self.rows_per_shard:
            big = Table.concat(self.tables)
            self.flush_fn(big.rows(slice(None, self.rows_per_shard)), self.bidx)
            rest = big.rows(slice(self.rows_per_shard, None))
            self.tables = [rest] if len(rest) else []
            self.count = len(rest)
            self.bidx += 1

    def close(self):
        if self.count:
            self.flush_fn(Table.concat(self.tables), self.bidx)
            self.bidx += 1
            self.tables, self.count = [], 0


@dataclass
class RunStats:
    total: int = 0
    passed: int = 0
    failed: int = 0
    predicted: int = 0
    elapsed_s: float = 0.0
    # per-class prediction counts aligned with the model's label_map
    # (noise/-1 last); None for prep-only runs
    class_counts: np.ndarray | None = None
    # two-stage wire: minibatches whose stage 2 ran
    stage2_minibatches: int = 0


class _Progress:
    """Total / failed / pass progress: three tqdm bars on a terminal (when
    tqdm is installed), else a log line every LOG_EVERY_S. The expected
    total is counted in a background thread so the run starts at once."""

    LOG_EVERY_S = 15.0

    def __init__(self, stats: RunStats, total_fn, label: str):
        self.stats = stats
        self.total = None
        self._bars = None
        self._label = label
        self._last_log = time.monotonic()
        threading.Thread(target=self._count_total, args=(total_fn,), daemon=True).start()
        try:
            from tqdm import tqdm

            if sys.stderr.isatty():
                self._bars = (
                    tqdm(desc="total", unit="reads", position=0),
                    tqdm(desc="failed", unit="reads", position=1),
                    tqdm(desc=label, unit="reads", position=2),
                )
        except ImportError:
            pass

    def _count_total(self, total_fn):
        try:
            self.total = total_fn()
            if self._bars:
                self._bars[0].total = self.total
        except Exception:
            pass

    def update(self):
        s = self.stats
        if self._bars:
            b_tot, b_fail, b_pass = self._bars
            b_tot.n, b_fail.n, b_pass.n = s.total, s.failed, s.passed
            for b in self._bars:
                b.refresh()
        elif time.monotonic() - self._last_log >= self.LOG_EVERY_S:
            self._last_log = time.monotonic()
            tot = f"/{self.total}" if self.total else ""
            logging.info(
                "progress: %d%s reads (%d %s, %d failed)",
                s.total, tot, s.passed, self._label, s.failed,
            )

    def close(self):
        if self._bars:
            for b in self._bars:
                b.close()


def select_outputs_mode(config: Config) -> str:
    """"decision" when the run only needs barcode calls (no boundary or
    fingerprint output requested), else "full"."""
    if (
        config.task.predict
        and not config.output.save_boundaries
        and not config.output.save_fpts
    ):
        return "decision"
    return "full"


class _Staged:
    """A minibatch's tensors on the device, and the event of their copy
    (None where no copy stream was used)."""

    def __init__(self, tensors, event):
        self.tensors, self.event = tensors, event

    def take(self) -> list[torch.Tensor]:
        """The tensors, ordered after their copy on their device's current
        stream."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.tensors[0].device)
            stream.wait_event(self.event)
            for t in self.tensors:
                t.record_stream(stream)
        return self.tensors


class _HostToDevice:
    """The producer's copy of a minibatch to the device: from pinned host
    memory, non-blocking, on a copy stream of its own."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(self, arrays) -> _Staged:
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        if self.stream is None:  # the CPU: the step reads the arrays in place
            return _Staged(host, None)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            tensors = [h.pin_memory().to(self.device, non_blocking=True) for h in host]
            event = torch.cuda.Event()
            event.record(self.stream)
        return _Staged(tensors, event)


def _fetch_async(res, device: torch.device):
    """(host copy of a step output on `device`, event): copies into pinned
    memory started on the device's current stream, the event recorded
    after them (None on the CPU, where the output is already on the host).
    `res` is a tuple of tensors (None kept) or of such tuples."""
    if device.type != "cuda":
        return res, None

    def to_host(t):
        if t is None:
            return None
        if isinstance(t, tuple):
            vals = [to_host(a) for a in t]
            return type(t)(*vals) if hasattr(t, "_fields") else tuple(vals)
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t, non_blocking=True)
        return out

    with torch.cuda.device(device):
        host = to_host(res)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
    return host, event


def use_twostage(config: Config, outputs_mode: str) -> bool:
    """The JAX run's rule for the two-stage wire, term for term (less its
    mesh: a process runs one card): a predictions-only run on the vbz
    wire, stage1_preload in (0, preload) and 8-aligned, an llr or cnn
    detect without [med_shift] (start_peak and that gate resolve whole
    reads only), and a CNN that reads no further than stage 1."""
    s1 = int(config.batch.stage1_preload or 0)
    dcfg = config.sig_proc.detect
    return bool(
        s1
        and 0 < s1 < config.sig_proc.sig_preload_size
        and s1 % 8 == 0
        and outputs_mode == "decision"
        and config.batch.wire == "vbz"
        and config.task.predict
        and dcfg.method in ("cnn", "llr")
        and not dcfg.detect_med_shift
        and (dcfg.method != "cnn" or 0 < dcfg.cnn_input_cap <= s1)
    )


def _to_device(arrays, device: torch.device) -> list[torch.Tensor]:
    """numpy arrays on `device`: from pinned memory, non-blocking, on the
    device's current stream (the CPU: the arrays in place)."""
    host = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    if device.type != "cuda":
        return host
    with torch.cuda.device(device):
        return [h.pin_memory().to(device, non_blocking=True) for h in host]


class _Stage1(NamedTuple):
    """A two-stage minibatch after stage 1."""

    handle: object  # pipeline/step.TwoStageHandle
    host1: tuple  # (out1, resolved), stage 1's outputs copied to the host
    event1: object  # the event of that copy (None on the CPU)
    host_wire: tuple  # (keys, data, lens, off1) of the whole wire
    n: int  # rows of the minibatch (the rest is padding)


def _pad_rows(a: np.ndarray, pad: int) -> np.ndarray:
    return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])


def run_demux(config: Config, model=None, *, device=None) -> RunStats:
    """Demux / prep over the pod5 inputs of `config` on `device` (default:
    the CUDA GPU; RuntimeError without one). `model` may be preloaded;
    otherwise it is loaded from config.classif.model_name when predicting."""
    from warpdemux_tpu_torch.io.pod5 import count_reads, yield_adc_batches, yield_vbz_batches

    feed = yield_adc_batches if config.batch.wire == "adc" else yield_vbz_batches
    batches = feed(
        config.input.files,
        config.input.read_ids_incl,
        config.input.read_ids_excl,
        batch_size=config.batch.minibatch_size,
        preload_size=config.sig_proc.sig_preload_size,
    )
    return demux_minibatches(
        config, model, batches, device=device,
        total_fn=lambda: count_reads(config.input.files),
    )


def demux_minibatches(config: Config, model, batches, *, device=None, total_fn=None) -> RunStats:
    """The run loop over `batches`: tuples as `yield_vbz_batches` (wire
    "vbz") or `yield_adc_batches` (wire "adc") yields them, the last
    element the read ids and the one before it the full lengths. Outputs
    go where `config.output` says; `total_fn` gives the progress display
    its expected total."""
    t0 = time.time()
    device = resolve_device(device)
    spc = config.sig_proc
    do_predict = config.task.predict
    if do_predict and model is None:
        from warpdemux_tpu_torch.models.registry import load_model

        model = load_model(config.classif.model_name, device)

    wire = config.batch.wire
    # predictions-only runs take the decision lane: only pred / conf / probs
    # / fail come back to the host, and no region statistics are computed
    outputs_mode = select_outputs_mode(config)
    L = spc.sig_preload_size
    two_stage = use_twostage(config, outputs_mode)
    S1 = int(config.batch.stage1_preload or 0)
    if two_stage:
        stage1, stage2 = make_twostage_decision_step(model, spc, S1, device=device)
        logging.info("two-stage wire: stage-1 preload %d of %d samples", S1, L)
    else:
        step = make_demux_step(
            model, spc, with_predict=do_predict, input_format=wire,
            outputs=outputs_mode, device=device,
        )
    B = config.batch.minibatch_size

    feed: queue.Queue = queue.Queue(maxsize=4)
    copier = _HostToDevice(device)

    def producer():
        """Minibatches padded to B rows, their copy to the device started
        here so it overlaps the main thread's steps."""
        try:
            for batch in batches:
                *arrays, full_lens, read_ids = batch
                n = arrays[0].shape[0]
                in_lens = np.asarray(arrays[-1])[:n]
                if n < B:
                    arrays = [_pad_rows(np.asarray(a), B - n) for a in arrays]
                host_wire = None
                if two_stage:
                    # stage 1's wire crosses now; the tails only if needed
                    keys, data, offset, scale, lens = arrays
                    keys1, data1, off1 = split_wire_host(keys, data, lens, S1)
                    arrays = (keys1, data1, offset, scale, lens)
                    host_wire = (keys, data, lens, off1)
                feed.put((copier.put(arrays), host_wire, n, full_lens, read_ids, in_lens))
        except Exception:
            logging.exception("pod5 producer failed; stopping feed")
        finally:
            feed.put(None)

    threading.Thread(target=producer, daemon=True).start()

    out = config.output
    tag = out.shard_tag
    rows_per = config.batch.batch_size_output
    pred_acc = _ShardAccumulator(
        lambda t, b: writers.save_predictions(t, out.output_dir_pred, b, tag=tag),
        rows_per, config.batch.bidx_predict,
    )
    fail_acc = _ShardAccumulator(
        lambda t, b: writers.save_boundaries(t, out.output_dir_fail, b, failed=True, tag=tag),
        rows_per, config.batch.bidx_fail,
    )
    bound_acc = _ShardAccumulator(
        lambda t, b: writers.save_boundaries(t, out.output_dir_boundaries, b, tag=tag),
        rows_per, config.batch.bidx_pass,
    )

    # fingerprints are written one npz per pass-shard, aligned with bound_acc
    fpt_rows: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    fpt_count = 0
    fpt_bidx = config.batch.bidx_pass

    def flush_fpts(force=False):
        nonlocal fpt_rows, fpt_count, fpt_bidx
        while fpt_count >= rows_per or (force and fpt_count > 0):
            take, taken, rest = [], 0, []
            for ids, fp, dw in fpt_rows:
                if taken >= rows_per:
                    rest.append((ids, fp, dw))
                    continue
                k = min(len(ids), rows_per - taken)
                take.append((ids[:k], fp[:k], dw[:k]))
                taken += k
                if k < len(ids):
                    rest.append((ids[k:], fp[k:], dw[k:]))
            ids, fp, dw = (np.concatenate([t[i] for t in take]) for i in range(3))
            writers.save_fingerprints(
                ids, fp, out.output_dir_fpts, fpt_bidx,
                dwell_times=dw if out.save_dwell_time else None, tag=tag,
            )
            fpt_bidx += 1
            fpt_rows = rest
            fpt_count = sum(len(r[0]) for r in fpt_rows)

    stats = RunStats()
    label_vals = None
    if do_predict and model is not None:
        label_vals = model.label_values
        stats.class_counts = np.zeros(len(label_vals), np.int64)

    def add_predictions(read_ids, success, pred, conf, probs):
        """The passing rows of a minibatch's calls (numpy, n rows)."""
        pred, conf, probs = pred[success], conf[success], probs[success]
        table = model.predictions_to_table(np.asarray(read_ids)[success], pred, conf, probs)
        pred_acc.add(table)
        stats.predicted += len(table)
        if label_vals is not None:
            stats.class_counts += (pred[:, None] == label_vals[None, :]).sum(axis=0)

    progress = _Progress(
        stats, total_fn=total_fn or (lambda: None),
        label="pass" if not do_predict else "predicted",
    )

    def count(success, n):
        stats.total += n
        stats.passed += int(success.sum())
        stats.failed += int((~success).sum())

    def postprocess_decision(res, n, read_ids):
        """Predictions and a minimal failed-reads table (read_id and
        fail_reason; --save_boundaries gives the full failure table)."""
        success = res.success.numpy()[:n]
        fail_code = res.fail_code.numpy()[:n]
        count(success, n)
        if not success.all():
            ids = np.asarray(read_ids)
            fail_acc.add(Table({
                "read_id": list(ids[~success]),
                "fail_reason": fail_code_to_reason(fail_code[~success]),
            }))
        if success.any():
            add_predictions(
                read_ids, success, res.pred.numpy()[:n], res.conf.numpy()[:n],
                res.probs.numpy()[:n],
            )
        progress.update()

    def postprocess(packed, n, full_lens, read_ids, in_lens):
        nonlocal fpt_count
        res = packed.unpack()
        success = res.success[:n]
        count(success, n)
        det_n = DetectArrays(*[a[:n] if a is not None else None for a in res.detect])
        table = det_n.to_summary_frame(
            read_ids, full_lens, in_lens, primary_method=spc.detect.method
        )
        fptA = res.fpt
        for col in (
            "adapter_dt_med", "adapter_dt_mad", "adapter_event_mean",
            "adapter_event_std", "adapter_event_med", "adapter_event_mad",
        ):
            table[col] = getattr(fptA, col)[:n]
        if res.consensus is not None:  # the tRNA path's consensus match
            table["seg_cons_query_start"] = res.consensus.seg_query_start[:n]
            table["seg_cons_query_end"] = res.consensus.seg_query_end[:n]
            table["sig_barcode_start"] = res.consensus.sig_barcode_start[:n]
        table["fail_reason"] = fail_code_to_reason(res.fail_code[:n])

        if out.save_boundaries:
            bound_acc.add(table.rows(success).drop("fail_reason"))
        fail_acc.add(table.rows(~success))

        if out.save_fpts and success.any():
            fpt_rows.append(
                (np.asarray(read_ids)[success], fptA.fpt[:n][success], fptA.dwell[:n][success])
            )
            fpt_count += int(success.sum())
            flush_fpts()

        if do_predict and success.any():
            add_predictions(read_ids, success, res.pred[:n], res.conf[:n], res.probs[:n])
        progress.update()

    results: queue.Queue = queue.Queue(maxsize=3)

    stage2_runs = 0  # the main thread's count, into stats after the loop

    def run_stage2(s1: _Stage1):
        """A stage-1 minibatch's decisions, (outputs on the host, their
        fetch event): stage 1's where every row resolved, else stage 2's,
        launched on the unresolved rows' tails."""
        nonlocal stage2_runs
        if s1.event1 is not None:
            s1.event1.synchronize()
        out1, resolved = s1.host1
        out2, _ = twostage_stage2(
            stage2, s1.handle, resolved.numpy(), s1.host_wire, s1.n, L,
            put=lambda tails: _to_device(tails, device),
        )
        if out2 is None:
            return out1, None
        stage2_runs += 1
        return _fetch_async(out2, device)

    def postproc_worker():
        # ALL RunStats mutation in the loop happens on this thread (dispatch
        # failures arrive as res=None), so the counters need no lock; the
        # main thread's count of stage-2 runs is added after the join
        while True:
            item = results.get()
            if item is None:
                return
            res, event, n, full_lens, read_ids, in_lens = item
            try:
                if res is None:
                    raise RuntimeError("minibatch dispatch failed")
                if event is not None:
                    event.synchronize()
                if isinstance(res, PackedStepOutput):
                    postprocess(res, n, full_lens, read_ids, in_lens)
                else:
                    postprocess_decision(res, n, read_ids)
            except Exception:
                # a poisoned minibatch must not kill the run; its reads are
                # dropped, logged and counted as failed
                logging.exception(
                    "minibatch failed (%d reads dropped): %s...",
                    n, read_ids[0] if len(read_ids) else "-",
                )
                stats.total += n
                stats.failed += n

    def dispatch(staged, host_wire, n):
        """The minibatch's step launched: (output, fetch event), or on the
        two-stage wire (its _Stage1, None)."""
        if not two_stage:
            return _fetch_async(step(*staged.take()), device)
        handle = stage1(*staged.take())
        host1, event1 = _fetch_async((handle.out1, handle.resolved), device)
        return _Stage1(handle, host1, event1, host_wire, n), None

    def finish_stage2(item):
        """A queued stage-1 item with its stage 2 run: the postprocess
        thread's (outputs, fetch event, ...)."""
        res, event, n, *rest = item
        if res is not None:
            try:
                res, event = run_stage2(res)
            except Exception:
                logging.exception(
                    "minibatch stage 2 failed (%d reads dropped): %s...",
                    n, rest[1][0] if len(rest[1]) else "-",
                )
                res = None
        return (res, event, n, *rest)

    pp_thread = threading.Thread(target=postproc_worker, daemon=True)
    pp_thread.start()
    behind = None  # the two-stage wire: the minibatch whose stage 2 is next
    while True:
        item = feed.get()
        if item is None:
            break
        staged, host_wire, n, full_lens, read_ids, in_lens = item
        event = None
        try:
            res, event = dispatch(staged, host_wire, n)
        except Exception:
            logging.exception(
                "minibatch dispatch failed (%d reads dropped): %s...",
                n, read_ids[0] if len(read_ids) else "-",
            )
            res = None  # accounted on the postprocess thread
        item = (res, event, n, full_lens, read_ids, in_lens)
        if two_stage:
            # stage 1 of this minibatch is queued before stage 2 of the last
            # one reads its `resolved`: the device has work while it does
            if behind is not None:
                results.put(finish_stage2(behind))
            behind = item
        else:
            results.put(item)
    if behind is not None:
        results.put(finish_stage2(behind))
    results.put(None)
    pp_thread.join()
    stats.stage2_minibatches = stage2_runs

    progress.close()
    pred_acc.close()
    fail_acc.close()
    bound_acc.close()
    flush_fpts(force=True)
    stats.elapsed_s = time.time() - t0
    logging.info(
        "demux done: %d reads (%d pass / %d fail / %d predicted) in %.1fs "
        "(%.0f reads/s)",
        stats.total, stats.passed, stats.failed, stats.predicted,
        stats.elapsed_s, stats.total / max(stats.elapsed_s, 1e-9),
    )
    if stats.class_counts is not None:
        logging.info(
            "class counts (%s): %s",
            "/".join(str(v) for v in label_vals),
            "/".join(str(int(c)) for c in stats.class_counts),
        )
    n_proc = init_distributed()[1]
    if n_proc > 1:
        # a run over several processes: every process's counters summed
        # into one end-of-run summary (the reference's Manager-shared
        # counters, file_proc.py:1055-1071)
        vec = np.array([stats.total, stats.passed, stats.failed, stats.predicted], np.int64)
        if stats.class_counts is not None:
            vec = np.concatenate([vec, stats.class_counts.astype(np.int64)])
        g = global_class_counts(vec)
        logging.info(
            "GLOBAL (%d hosts): %d reads (%d pass / %d fail / %d predicted)%s",
            n_proc, g[0], g[1], g[2], g[3],
            " class counts " + "/".join(str(int(c)) for c in g[4:]) if len(g) > 4 else "",
        )
    return stats


def run_predict_from_fpts(config: Config, model=None, *, device=None) -> RunStats:
    """predict mode: classify the fingerprints a prep run saved, on
    `device` (default: the CUDA GPU)."""
    t0 = time.time()
    if model is None:
        from warpdemux_tpu_torch.models.registry import load_model

        model = load_model(config.classif.model_name, resolve_device(device))
    out = config.output
    pred_acc = _ShardAccumulator(
        lambda t, b: writers.save_predictions(t, out.output_dir_pred, b),
        config.batch.batch_size_output, config.batch.bidx_predict,
    )
    fail_acc = _ShardAccumulator(
        lambda t, b: writers.save_boundaries(t, out.output_dir_fail, b, failed=True),
        config.batch.batch_size_output, config.batch.bidx_fail,
    )
    stats = RunStats()
    excl = config.input.read_ids_excl
    for npz_file in config.input.files:
        with np.load(npz_file, allow_pickle=True) as z:
            ids = z["read_ids"]
            fpts = z["signals"]
        if excl:
            keep = np.array([rid not in excl for rid in ids])
            ids, fpts = ids[keep], fpts[keep]
        if not len(ids):
            continue
        finite = np.isfinite(fpts).all(axis=1)
        if finite.any():
            pred, conf, probs = model.predict(np.nan_to_num(fpts[finite].astype(np.float32)))
            table = model.predictions_to_table(ids[finite], pred, conf, probs)
            pred_acc.add(table)
            stats.predicted += len(table)
        if not finite.all():
            # every read lands in predictions or failed_reads
            bad = ids[~finite]
            fail_acc.add(Table({
                "read_id": list(bad),
                "fail_reason": ["non-finite fingerprint"] * len(bad),
            }))
            stats.failed += int((~finite).sum())
        stats.total += len(ids)
    pred_acc.close()
    fail_acc.close()
    stats.elapsed_s = time.time() - t0
    return stats
