"""Minimal pod5 writer: VBZ-compressed signal in embedded Arrow tables.

A copy of warpdemux_tpu/io/pod5_writer.py: the container shape the reader
consumes (signature + embedded Arrow IPC files for the signal / reads /
run-info tables, VBZ-compressed signal chunks of SIGNAL_CHUNK samples).
Used for synthetic test fixtures. `pyarrow` is imported inside
`write_pod5`.
"""

from __future__ import annotations

import uuid as uuid_mod
from pathlib import Path

import numpy as np

from warpdemux_tpu_torch.io import vbz

_POD5_SIGNATURE = b"\x8bPOD\r\n\x1a\n"
SIGNAL_CHUNK = 102400  # samples per signal row (pod5 default scale)


def _arrow_file_bytes(table) -> bytes:
    import pyarrow as pa
    import pyarrow.ipc as ipc

    sink = pa.BufferOutputStream()
    with ipc.new_file(sink, table.schema) as w:
        w.write_table(table)
    return sink.getvalue().to_pybytes()


def write_pod5(path: str | Path, reads: list[dict], sample_rate: float = 4000.0):
    """Write reads to a pod5 container.

    Each read dict: read_id (uuid str; generated if absent), signal (int16
    ADC), calibration_offset (float), calibration_scale (float), channel,
    well, end_reason, num_minknow_events.
    """
    import pyarrow as pa

    sig_ids, sig_payloads, sig_samples = [], [], []
    r_ids, r_rows, r_nsamp, r_chan, r_well = [], [], [], [], []
    r_off, r_scale, r_endr, r_mk = [], [], [], []

    row_idx = 0
    for rd in reads:
        rid = rd.get("read_id") or str(uuid_mod.uuid4())
        sig = np.asarray(rd["signal"], np.int16)
        rows = []
        for s in range(0, max(sig.size, 1), SIGNAL_CHUNK):
            chunk = sig[s : s + SIGNAL_CHUNK]
            sig_ids.append(uuid_mod.UUID(rid).bytes)
            sig_payloads.append(vbz.encode(chunk))
            sig_samples.append(len(chunk))
            rows.append(row_idx)
            row_idx += 1
        r_ids.append(uuid_mod.UUID(rid).bytes)
        r_rows.append(rows)
        r_nsamp.append(int(sig.size))
        r_chan.append(int(rd.get("channel", 1)))
        r_well.append(int(rd.get("well", 1)))
        r_off.append(float(rd.get("calibration_offset", -240.0)))
        r_scale.append(float(rd.get("calibration_scale", 0.1755)))
        r_endr.append(str(rd.get("end_reason", "signal_positive")))
        r_mk.append(int(rd.get("num_minknow_events", sig.size // 10)))

    signal_t = pa.table(
        {
            "read_id": pa.array(sig_ids, pa.binary(16)),
            "signal": pa.array(sig_payloads, pa.large_binary()),
            "samples": pa.array(sig_samples, pa.uint32()),
        }
    )
    reads_t = pa.table(
        {
            "read_id": pa.array(r_ids, pa.binary(16)),
            "signal": pa.array(r_rows, pa.list_(pa.uint64())),
            "num_samples": pa.array(r_nsamp, pa.uint64()),
            "channel": pa.array(r_chan, pa.uint16()),
            "well": pa.array(r_well, pa.uint8()),
            "calibration_offset": pa.array(r_off, pa.float32()),
            "calibration_scale": pa.array(r_scale, pa.float32()),
            "end_reason": pa.array(r_endr, pa.string()),
            "num_minknow_events": pa.array(r_mk, pa.uint64()),
        }
    )
    runinfo_t = pa.table({"sample_rate": pa.array([sample_rate], pa.float64())})

    blob = (
        _POD5_SIGNATURE
        + _arrow_file_bytes(signal_t)
        + _arrow_file_bytes(reads_t)
        + _arrow_file_bytes(runinfo_t)
    )
    Path(path).write_bytes(blob)
    return path
