"""VBZ signal codec (the pod5 signal compression): zstd over
streamvbyte-16 with zig-zag delta encoding.

Port of warpdemux_tpu/io/vbz.py: `decode` prefers the native C++ decoder
(warpdemux_tpu_torch/native, one pass, no temporaries) and falls back to
the vectorized numpy path below where that library does not build (a
WARNING, logged once, says so). Both run on the host; the device decodes
only the inner layout (ops/vbz_device). `zstandard` is imported inside the
functions, so the package imports where it is not installed. A zstd
decompressor is not safe for concurrent use, so each thread takes its own
(`zstd_decompressor`): the run loop's producer and the live pod5 watcher
decode at the same time.

Decode layout (n = sample count):
  raw = zstd_decompress(payload)
  keys = raw[: ceil(n/8)]          1 bit per value (LSB-first): 0 -> 1 byte,
                                   1 -> 2 bytes (little-endian)
  data = raw[ceil(n/8):]           variable-width values
  value -> zig-zag decode -> cumulative sum -> int16 ADC counts
"""

from __future__ import annotations

import logging
import threading

import numpy as np

from warpdemux_tpu_torch import native

_ZSTD_TLS = threading.local()
_warned = False


def zstd_decompressor():
    """This thread's zstandard.ZstdDecompressor."""
    d = getattr(_ZSTD_TLS, "d", None)
    if d is None:
        import zstandard

        d = _ZSTD_TLS.d = zstandard.ZstdDecompressor()
    return d


def decode(payload: bytes, n: int) -> np.ndarray:
    """Decode a VBZ-compressed signal chunk into int16 ADC counts."""
    global _warned
    if n == 0:
        return np.zeros(0, np.int16)
    out = native.vbz_decode(payload, n)
    if out is not None:
        return out
    if not _warned:
        _warned = True
        logging.warning("native VBZ decoder unavailable (no g++ or zstd.h): decoding with numpy")
    raw = zstd_decompressor().decompress(payload, max_output_size=4 * n + 16)
    keylen = (n + 7) // 8
    keys = np.frombuffer(raw, np.uint8, count=keylen)
    data = np.frombuffer(raw, np.uint8, offset=keylen)
    bits = np.unpackbits(keys, bitorder="little", count=n)
    nbytes = bits.astype(np.int64) + 1
    offs = np.empty(n, np.int64)
    offs[0] = 0
    np.cumsum(nbytes[:-1], out=offs[1:])
    lo = data[offs].astype(np.uint16)
    hi_idx = np.minimum(offs + 1, len(data) - 1)
    hi = np.where(bits == 1, data[hi_idx].astype(np.uint16), 0)
    vals = lo | (hi << np.uint16(8))
    # zig-zag decode to signed deltas, then integrate.
    sv = (vals >> 1).astype(np.int32) ^ -(vals & 1).astype(np.int32)
    return np.cumsum(sv, dtype=np.int32).astype(np.int16)


def encode(signal: np.ndarray) -> bytes:
    """Inverse of decode (used by tests and synthetic-fixture generation)."""
    import zstandard

    sig = np.asarray(signal, np.int32)
    deltas = np.diff(sig, prepend=np.int32(0))
    zz = ((deltas << 1) ^ (deltas >> 31)).astype(np.uint32)
    if np.any(zz > 0xFFFF):
        raise ValueError("delta out of int16 zig-zag range")
    zz = zz.astype(np.uint16)
    n = len(zz)
    bits = (zz > 0xFF).astype(np.uint8)
    keys = np.packbits(bits, bitorder="little")
    lo = (zz & 0xFF).astype(np.uint8)
    hi = (zz >> 8).astype(np.uint8)
    data = np.empty(int(bits.sum()) + n, np.uint8)
    offs = np.concatenate([[0], np.cumsum(bits.astype(np.int64) + 1)[:-1]])
    data[offs] = lo
    data[offs[bits == 1] + 1] = hi[bits == 1]
    raw = keys.tobytes() + data.tobytes()
    return zstandard.ZstdCompressor(level=1).compress(raw)
