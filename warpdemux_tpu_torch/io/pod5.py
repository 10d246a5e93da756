"""Pod5 ingest: Arrow-container parsing, VBZ signal decode and the
fixed-shape minibatch feeds of the offline run.

A copy of warpdemux_tpu/io/pod5.py: `Pod5Reader` (which the live
balancer's pod5 watcher also reads), `count_reads` and the feeds
`yield_signal_batches` (picoamps), `yield_adc_batches` (int16 ADC counts
with calibration scalars) and `yield_vbz_batches` (the VBZ inner layout,
decoded on the device). `pyarrow` and `zstandard` are imported inside the
functions, so the package imports where they are not installed.

The pod5 format is a container of embedded Apache Arrow IPC files (a signal
table, a run-info table, and a reads table) behind an 8-byte signature.
The reader locates the embedded Arrow files (each starts with the 8-byte
"ARROW1\\0\\0" magic and ends with the trailing "ARROW1"), opens them with
pyarrow, and decodes VBZ signal chunks on demand (io/vbz.py).
"""

from __future__ import annotations

import re
import uuid
from dataclasses import dataclass
from pathlib import Path
from typing import Generator, Iterable, Sequence

import numpy as np

from warpdemux_tpu_torch.io import vbz

_POD5_SIGNATURE = b"\x8bPOD\r\n\x1a\n"
_ARROW_MAGIC = b"ARROW1\x00\x00"


def _embedded_arrow_tables(data: bytes) -> list:
    """Locate and open every embedded Arrow IPC file in the container."""
    import pyarrow as pa
    import pyarrow.ipc as ipc

    starts = [m.start() for m in re.finditer(re.escape(_ARROW_MAGIC), data)]
    tables = []
    used_end = 0
    for s in starts:
        if s < used_end:
            continue  # offset inside a previously-parsed file
        # the file ends at the next trailing ARROW1 magic
        probe = data.find(b"ARROW1", s + 8)
        while probe != -1:
            chunk = data[s : probe + 6]
            try:
                reader = ipc.open_file(pa.BufferReader(chunk))
                tables.append(reader.read_all())
                used_end = probe + 6
                break
            except Exception:
                probe = data.find(b"ARROW1", probe + 6)
    return tables


@dataclass
class ReadRecord:
    """One sequencing read; signal decoded lazily."""

    read_id: str
    num_samples: int
    channel: int
    well: int
    end_reason: str
    num_minknow_events: int
    calibration_offset: float
    calibration_scale: float
    _reader: "Pod5Reader"
    _signal_rows: np.ndarray

    def signal_adc(self, max_samples: int | None = None) -> np.ndarray:
        return self._reader._decode_signal(self._signal_rows, max_samples)

    @property
    def signal_pa(self) -> np.ndarray:
        return self.signal_pa_head(None)

    def signal_pa_head(self, max_samples: int | None) -> np.ndarray:
        adc = self.signal_adc(max_samples)
        return (adc.astype(np.float32) + self.calibration_offset) * (
            self.calibration_scale
        )


class Pod5Reader:
    """Read-only pod5 file access."""

    def __init__(self, path: str | Path):
        self.path = str(path)
        data = Path(path).read_bytes()
        if not data.startswith(_POD5_SIGNATURE):
            raise ValueError(f"{path} is not a pod5 file")
        tables = _embedded_arrow_tables(data)
        self._signal_t = None
        self._reads_t = None
        self._runinfo_t = None
        for t in tables:
            names = set(t.schema.names)
            if {"read_id", "signal", "samples"} <= names:
                self._signal_t = t
            elif "read_number" in names or "num_samples" in names:
                self._reads_t = t
            elif "sample_rate" in names:
                self._runinfo_t = t
        if self._signal_t is None or self._reads_t is None:
            raise ValueError(f"{path}: missing pod5 tables")
        # materialize hot columns once
        self._sig_payload = self._signal_t.column("signal").to_pylist()
        self._sig_samples = np.asarray(self._signal_t.column("samples"), np.int64)
        rt = self._reads_t
        self._read_ids = [str(uuid.UUID(bytes=b.as_py())) for b in rt.column("read_id")]
        self._signal_rows = rt.column("signal").to_pylist()
        self._num_samples = np.asarray(rt.column("num_samples"), np.int64)
        self._channel = np.asarray(rt.column("channel"), np.int64)
        self._well = np.asarray(rt.column("well"), np.int64)
        self._cal_offset = np.asarray(rt.column("calibration_offset"), np.float64)
        self._cal_scale = np.asarray(rt.column("calibration_scale"), np.float64)
        self._end_reason = [str(v) for v in rt.column("end_reason").to_pylist()]
        self._num_mk_events = np.asarray(rt.column("num_minknow_events"), np.int64)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __len__(self):
        return len(self._read_ids)

    @property
    def sample_rate(self) -> float:
        if self._runinfo_t is not None:
            return float(self._runinfo_t.column("sample_rate")[0].as_py())
        return 4000.0

    def _decode_signal(self, rows: Sequence[int], max_samples: int | None) -> np.ndarray:
        chunks = []
        got = 0
        for r in rows:
            n = int(self._sig_samples[r])
            chunks.append(vbz.decode(self._sig_payload[r], n))
            got += n
            if max_samples is not None and got >= max_samples:
                break
        sig = np.concatenate(chunks) if chunks else np.zeros(0, np.int16)
        if max_samples is not None:
            sig = sig[:max_samples]
        return sig

    def reads(
        self,
        selection: Iterable[str] | None = None,
        missing_ok: bool = True,
    ) -> Generator[ReadRecord, None, None]:
        """Stream reads, optionally restricted to a read-id selection."""
        if selection is not None:
            sel = set(str(s) for s in selection)
            idxs = [i for i, rid in enumerate(self._read_ids) if rid in sel]
            if not missing_ok and len(idxs) < len(sel):
                missing = sel - {self._read_ids[i] for i in idxs}
                raise KeyError(f"read ids not in {self.path}: {sorted(missing)[:5]}")
        else:
            idxs = range(len(self._read_ids))
        for i in idxs:
            yield ReadRecord(
                read_id=self._read_ids[i],
                num_samples=int(self._num_samples[i]),
                channel=int(self._channel[i]),
                well=int(self._well[i]),
                end_reason=self._end_reason[i],
                num_minknow_events=int(self._num_mk_events[i]),
                calibration_offset=float(self._cal_offset[i]),
                calibration_scale=float(self._cal_scale[i]),
                _reader=self,
                _signal_rows=np.asarray(self._signal_rows[i], np.int64),
            )


def count_reads(pod5_files: Iterable[str | Path]) -> int:
    total = 0
    for f in pod5_files:
        total += len(Pod5Reader(f))
    return total


def _selection(read_ids_incl, read_ids_excl):
    """(selection or None, exclude set): an include set wins over an
    exclude set, less the excluded ids."""
    read_ids_incl = set(read_ids_incl or ())
    read_ids_excl = set(read_ids_excl or ())
    if read_ids_incl and read_ids_excl:
        read_ids_incl = read_ids_incl - read_ids_excl
        read_ids_excl = set()
    return read_ids_incl or None, read_ids_excl


def _records(pod5_files, read_ids_incl, read_ids_excl):
    """(reader, record) of every selected read, file by file."""
    selection, excl = _selection(read_ids_incl, read_ids_excl)
    for filename in pod5_files:
        with Pod5Reader(filename) as reader:
            for rec in reader.reads(selection=selection, missing_ok=True):
                if rec.read_id not in excl:
                    yield reader, rec


def yield_signal_batches(
    pod5_files: Iterable[str | Path],
    read_ids_incl: set[str] | None,
    read_ids_excl: set[str] | None,
    batch_size: int,
    preload_size: int,
) -> Generator[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray], None, None]:
    """Fixed-shape minibatch preloading in picoamps.

    Yields (signals (N, m) f32 zero-padded, in_arr_lengths (N,), full_lengths
    (N,), read_ids (N,) object). The final batch may be short.
    """
    N, m = batch_size, preload_size
    signals = np.zeros((N, m), np.float32)
    full_lengths = np.empty(N, np.int32)
    in_lengths = np.empty(N, np.int32)
    read_ids = np.empty(N, object)
    i = 0
    for _, rec in _records(pod5_files, read_ids_incl, read_ids_excl):
        _m = min(m, rec.num_samples)
        sig = rec.signal_pa_head(_m)
        _m = min(_m, sig.size)
        full_lengths[i] = rec.num_samples
        in_lengths[i] = _m
        signals[i, :_m] = sig[:_m]
        signals[i, _m:] = 0.0
        read_ids[i] = rec.read_id
        if i == N - 1:
            yield signals, in_lengths, full_lengths, read_ids
            signals = np.zeros((N, m), np.float32)
            full_lengths = np.empty(N, np.int32)
            in_lengths = np.empty(N, np.int32)
            read_ids = np.empty(N, object)
            i = 0
        else:
            i += 1
    if i > 0:
        yield signals[:i], in_lengths[:i], full_lengths[:i], read_ids[:i]


# data widths a vbz batch is padded to: a few fixed shapes, whatever the reads
_DATA_WIDTH_LADDER = (10752, 11776, 12800, 14336, 16384, 20480, 24576)


def yield_vbz_batches(
    pod5_files: Iterable[str | Path],
    read_ids_incl: set[str] | None,
    read_ids_excl: set[str] | None,
    batch_size: int,
    preload_size: int,
) -> Generator[tuple, None, None]:
    """Compressed-wire minibatch preloading: the VBZ inner layout to the
    device.

    The pod5 payload is zstd(keys || data); after the host's zstd step the
    inner layout itself crosses to the device (~11.5 KB a 10k-sample read
    against 20 KB of int16) and ops/vbz_device.vbz_decode_batch rebuilds the
    ADC counts there. Yields (keys (B, L/8) u8, data (B, D) u8, offset,
    scale, in_lengths, full_lengths, read_ids) with D the first width of
    `_DATA_WIDTH_LADDER` that holds the batch's longest body.

    Reads whose first signal row covers the preload slice that row's keys
    and data; a head over several rows is decoded and re-encoded with
    inner_layout_from_adc (pod5 rows delta-encode independently, so their
    bodies cannot be concatenated).
    """
    from warpdemux_tpu_torch.ops.vbz_device import inner_layout_from_adc

    N, L = batch_size, preload_size
    klen = (L + 7) // 8

    def flush(rows):
        B = len(rows)
        keys = np.zeros((B, klen), np.uint8)
        max_d = max((r[1].size for r in rows), default=1)
        D = next(
            (d for d in _DATA_WIDTH_LADDER if d >= max_d),
            ((max_d + 1023) // 1024) * 1024,
        )
        data = np.zeros((B, D), np.uint8)
        offset = np.zeros(B, np.float32)
        scale = np.zeros(B, np.float32)
        in_lengths = np.zeros(B, np.int32)
        full_lengths = np.zeros(B, np.int32)
        read_ids = np.empty(B, object)
        for i, (kb, db, off, sc, n, full, rid) in enumerate(rows):
            keys[i, : kb.size] = kb
            data[i, : db.size] = db
            offset[i], scale[i] = off, sc
            in_lengths[i], full_lengths[i] = n, full
            read_ids[i] = rid
        return keys, data, offset, scale, in_lengths, full_lengths, read_ids

    def make_row(reader, rec):
        n = min(L, rec.num_samples)
        srows = rec._signal_rows
        if len(srows) and int(reader._sig_samples[srows[0]]) >= n:
            row_n = int(reader._sig_samples[srows[0]])
            raw = vbz.zstd_decompressor().decompress(
                reader._sig_payload[srows[0]], max_output_size=4 * row_n + 16
            )
            row_klen = (row_n + 7) // 8
            bits = np.unpackbits(
                np.frombuffer(raw, np.uint8, count=row_klen),
                bitorder="little",
                count=n,
            )
            kb = np.packbits(bits, bitorder="little")
            db = np.frombuffer(raw, np.uint8, offset=row_klen, count=n + int(bits.sum()))
        else:  # a head over several rows: decode and re-encode
            body = inner_layout_from_adc(rec.signal_adc(n)[:n])
            kb = np.frombuffer(body, np.uint8, count=(n + 7) // 8)
            db = np.frombuffer(body, np.uint8, offset=(n + 7) // 8)
        return (
            kb, db, rec.calibration_offset, rec.calibration_scale, n,
            rec.num_samples, rec.read_id,
        )

    rows: list = []
    for reader, rec in _records(pod5_files, read_ids_incl, read_ids_excl):
        rows.append(make_row(reader, rec))
        if len(rows) == N:
            yield flush(rows)
            rows = []
    if rows:
        yield flush(rows)


def yield_adc_batches(
    pod5_files: Iterable[str | Path],
    read_ids_incl: set[str] | None,
    read_ids_excl: set[str] | None,
    batch_size: int,
    preload_size: int,
) -> Generator[tuple, None, None]:
    """ADC-domain minibatch preloading.

    The batching of yield_signal_batches, with the signals left as the
    pod5's int16 ADC counts beside each read's calibration scalars; the
    step converts `(adc + offset) * scale` on the device. Yields (adc (N, m)
    int16, offset (N,) f32, scale (N,) f32, in_lengths (N,) i32,
    full_lengths (N,) i32, read_ids (N,) object).
    """
    N, m = batch_size, preload_size
    adc = np.zeros((N, m), np.int16)
    offset = np.zeros(N, np.float32)
    scale = np.zeros(N, np.float32)
    full_lengths = np.empty(N, np.int32)
    in_lengths = np.empty(N, np.int32)
    read_ids = np.empty(N, object)
    i = 0
    for _, rec in _records(pod5_files, read_ids_incl, read_ids_excl):
        sig = rec.signal_adc(m)
        _m = min(m, sig.size)
        full_lengths[i] = rec.num_samples
        in_lengths[i] = _m
        adc[i, :_m] = sig[:_m]
        adc[i, _m:] = 0
        offset[i] = rec.calibration_offset
        scale[i] = rec.calibration_scale
        read_ids[i] = rec.read_id
        if i == N - 1:
            yield adc, offset, scale, in_lengths, full_lengths, read_ids
            adc = np.zeros((N, m), np.int16)
            offset = np.zeros(N, np.float32)
            scale = np.zeros(N, np.float32)
            full_lengths = np.empty(N, np.int32)
            in_lengths = np.empty(N, np.int32)
            read_ids = np.empty(N, object)
            i = 0
        else:
            i += 1
    if i > 0:
        yield adc[:i], offset[:i], scale[:i], in_lengths[:i], full_lengths[:i], read_ids[:i]
