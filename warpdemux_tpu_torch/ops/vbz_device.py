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
JAX module's numpy helpers that build the wire on the host.
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
