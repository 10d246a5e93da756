"""VBZ inner-layout decode: the compressed wire format of the vbz feed.

Port of warpdemux_tpu/ops/vbz_device.py. pod5 signal payloads are
zstd(keys || data): `keys` has one bit per sample (0 -> 1 byte, 1 -> 2
bytes little-endian) and `data` holds the zig-zag-coded int16 deltas at
that width. The host zstd-decompresses; the inner layout crosses to the
device as (B, L/8) keys and (B, D) data and is decoded there:

    bits    = unpack(keys)                  (B, L)
    offsets = exclusive_cumsum(bits + 1)    (B, L)   int32
    lo, hi  = data[offsets], data[offsets + 1]       row gathers
    value   = lo | (hi << 8) where wide
    delta   = zigzag^-1(value);  adc = cumsum(delta)

The JAX package decodes with XLA ops, not a Pallas kernel; the port uses
torch ops. Every step is integer arithmetic, exact on every device.
`inner_layout_from_adc` and `pack_inner_host` are JAX-free copies of the
JAX module's numpy helpers that build the wire on the host;
`split_wire_host` and `pack_tails_host` cut a packed batch into the
two-stage wire's stage-1 prefix and the tails of the unresolved rows
(pipeline/step.make_twostage_decision_step), with the JAX module's width
ladders.
"""

from __future__ import annotations

import numpy as np
import torch


def vbz_decode_batch(keys: torch.Tensor, data: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Decode (B, ceil(n/8)) uint8 keys and (B, D) zero-padded uint8 data
    to (B, n_samples) int32 ADC counts."""
    n = n_samples
    dev = keys.device
    # unpack bits LSB-first: bit i of byte i // 8
    byte = keys.repeat_interleave(8, dim=1)[:, :n].to(torch.int32)
    shift = torch.arange(8, dtype=torch.int32, device=dev).repeat((n + 7) // 8)[:n]
    bits = (byte >> shift[None, :]) & 1
    nbytes = bits + 1
    offs = torch.cumsum(nbytes, dim=1, dtype=torch.int32) - nbytes  # exclusive
    D = data.shape[1]
    lo = data.gather(1, offs.clamp(0, D - 1).long()).to(torch.int32)
    hi = data.gather(1, (offs + 1).clamp(0, D - 1).long()).to(torch.int32)
    val = torch.where(bits == 1, lo | (hi << 8), lo)
    delta = (val >> 1) ^ -(val & 1)
    return torch.cumsum(delta, dim=1, dtype=torch.int32)


def inner_layout_from_adc(sig: np.ndarray) -> bytes:
    """The VBZ inner layout (keys || data) of int16 samples."""
    sig = np.asarray(sig, np.int32)
    deltas = np.diff(sig, prepend=np.int32(0))
    zz = ((deltas << 1) ^ (deltas >> 31)).astype(np.uint32)
    if np.any(zz > 0xFFFF):
        raise ValueError("delta out of int16 zig-zag range")
    zz = zz.astype(np.uint16)
    bits = (zz > 0xFF).astype(np.uint8)
    keys = np.packbits(bits, bitorder="little")
    nbytes = bits.astype(np.int64) + 1
    offs = np.concatenate([[0], np.cumsum(nbytes)[:-1]])
    data = np.zeros(int(nbytes.sum()), np.uint8)
    data[offs] = zz & 0xFF
    wide = bits == 1
    data[offs[wide] + 1] = zz[wide] >> 8
    return keys.tobytes() + data.tobytes()


def pack_inner_host(
    payloads: list[bytes | None], n_samples: int, data_width: int
) -> tuple[np.ndarray, np.ndarray]:
    """Pack VBZ inner-layout bodies (keys || data for exactly n_samples
    samples, or None for an empty row) into (B, ceil(n/8)) keys and
    (B, data_width) data arrays, zero-padded past each read."""
    B = len(payloads)
    klen = (n_samples + 7) // 8
    keys = np.zeros((B, klen), np.uint8)
    data = np.zeros((B, data_width), np.uint8)
    for i, body in enumerate(payloads):
        if body is None:
            continue
        keys[i] = np.frombuffer(body, np.uint8, count=klen)
        db = np.frombuffer(body, np.uint8, offset=klen)
        m = min(db.size, data_width)
        data[i, :m] = db[:m]
    return keys, data


# the data bytes of a wide sample: a key bit's count of a prefix gives its
# offset in the data stream
_POPCOUNT = np.array([bin(i).count("1") for i in range(256)], np.uint8)

# widths of the stage-1 data, the tail data and the tail rows: 128-byte
# rungs near the stage-1 sizes of 7,168 samples (1-3% wide samples),
# coarser above; the JAX package compiles one decode program a rung
_D1_LADDER = (
    7168, 7296, 7424, 7552, 7680, 7936, 8192, 8704, 9216, 10240, 12288,
    14336,
)
_DT_LADDER = (2048, 2560, 2816, 2944, 3072, 3584, 4096, 5120, 5888)
_ROW_LADDER = (64, 128, 256, 512)


def _ladder_pick(ladder, need: int) -> int:
    """The first rung of `ladder` at least `need`, else `need` rounded up
    to a multiple of 256."""
    for v in ladder:
        if v >= need:
            return v
    return -(-need // 256) * 256


def split_wire_host(
    keys: np.ndarray, data: np.ndarray, in_lens: np.ndarray, stage1_len: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(keys1, data1, off1): the stage-1 wire of a packed VBZ batch.

    The inner layout is prefix-closed: the first `stage1_len` samples of a
    row are its first stage1_len / 8 key bytes and its data bytes up to
    off1 = min(in_len, stage1_len) + (wide samples among them). keys1 and
    data1 are slices of `keys` and `data`, data1's width the first rung of
    the stage-1 ladder that holds the longest off1."""
    if stage1_len % 8:
        raise ValueError("stage1_len must be a multiple of 8")
    keys1 = np.ascontiguousarray(keys[:, : stage1_len // 8])
    n_wide1 = _POPCOUNT[keys1].sum(axis=1, dtype=np.int64)
    off1 = np.minimum(in_lens.astype(np.int64), stage1_len) + n_wide1
    d1 = _ladder_pick(_D1_LADDER, int(off1.max(initial=1)))
    return keys1, np.ascontiguousarray(data[:, :d1]), off1


def pack_tails_host(
    keys: np.ndarray,
    data: np.ndarray,
    in_lens: np.ndarray,
    off1: np.ndarray,
    rows: np.ndarray,
    stage1_len: int,
    n_samples: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(rows_padded, keys_t, data_t): the tail wire, samples [stage1_len,
    min(in_len, n_samples)), of the batch's rows `rows` (in that order).

    The row count is padded to a rung of the row ladder (all B rows past
    512) with the sentinel row index B, which stage 2 drops; the data width
    is a rung of the tail ladder. The tail bytes are the row's own stream
    past off1 (split_wire_host): decoded, they are deltas from the row's
    last stage-1 sample."""
    B = keys.shape[0]
    klen1 = stage1_len // 8
    klen = (n_samples + 7) // 8
    rows = np.asarray(rows, np.int64)
    bu = _ladder_pick(_ROW_LADDER, max(len(rows), 1)) if len(rows) <= 512 else B
    bu = min(bu, B)
    n_wide = _POPCOUNT[keys[rows, :klen]].sum(axis=1, dtype=np.int64)
    end = np.minimum(in_lens[rows].astype(np.int64), n_samples) + n_wide
    dt = _ladder_pick(_DT_LADDER, int((end - off1[rows]).max(initial=1)))
    keys_t = np.zeros((bu, klen - klen1), np.uint8)
    data_t = np.zeros((bu, dt), np.uint8)
    rows_out = np.full(bu, B, np.int32)
    keys_t[: len(rows)] = keys[rows, klen1:klen]
    rows_out[: len(rows)] = rows
    for j, r in enumerate(rows):
        seg = data[r, off1[r] : end[j]]
        data_t[j, : seg.size] = seg
    return rows_out, keys_t, data_t
