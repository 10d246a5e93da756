"""Offline batch pipeline: pod5 minibatches -> device steps -> sharded CSVs.

Port of warpdemux_tpu/pipeline/run.py, with the JAX design:

- a producer thread turns the feed's minibatches into device tensors,
  padded to the step's batch size, behind a bounded queue (4);
- the main thread dispatches one demux step a minibatch;
- a postprocess thread (queue of 3) fetches results, builds the tables and
  writes `batch_size_output`-row shards; it alone updates RunStats;
- a minibatch whose step fails is logged and its reads counted as failed.

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

import numpy as np
import torch

from warpdemux_tpu_torch._cuda import resolve_device
from warpdemux_tpu_torch.config.config import Config
from warpdemux_tpu_torch.detect.containers import DetectArrays, fail_code_to_reason
from warpdemux_tpu_torch.io import writers
from warpdemux_tpu_torch.io.writers import Table
from warpdemux_tpu_torch.parallel.multihost import global_class_counts, init_distributed
from warpdemux_tpu_torch.pipeline.step import PackedStepOutput, make_demux_step


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
    after them (None on the CPU, where the output is already on the host)."""
    if device.type != "cuda":
        return res, None

    def to_host(t):
        if t is None:
            return None
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t, non_blocking=True)
        return out

    with torch.cuda.device(device):
        host = type(res)(*(to_host(t) for t in res))
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
    return host, event


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
    if config.batch.stage1_preload and outputs_mode == "decision" and wire == "vbz":
        logging.info(
            "two-stage wire not ported (ROADMAP queue 1 item 9): "
            "the one-shot decision step runs on the whole preload"
        )
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
                feed.put((copier.put(arrays), n, full_lens, read_ids, in_lens))
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

    def postproc_worker():
        # ALL RunStats mutation happens on this thread (dispatch failures
        # arrive as res=None), so the counters need no lock
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

    pp_thread = threading.Thread(target=postproc_worker, daemon=True)
    pp_thread.start()
    while True:
        item = feed.get()
        if item is None:
            break
        staged, n, full_lens, read_ids, in_lens = item
        event = None
        try:
            res, event = _fetch_async(step(*staged.take()), device)
        except Exception:
            logging.exception(
                "minibatch dispatch failed (%d reads dropped): %s...",
                n, read_ids[0] if len(read_ids) else "-",
            )
            res = None  # accounted on the postprocess thread
        results.put((res, event, n, full_lens, read_ids, in_lens))
    results.put(None)
    pp_thread.join()

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
