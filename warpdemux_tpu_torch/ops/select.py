"""Exact ranged medians / MADs by radix selection.

Port of warpdemux_tpu/ops/select.py `range_median_mad`. Float32 values map
onto int32 keys by the monotone image

    key(x) = bits(x) >= 0 ? bits(x) : bits(x) ^ 0x7FFFFFFF

and the JAX package finds the k-th smallest key of a range by one
sign-deciding count followed by 31 MSB-first rounds: bit b is set iff
count(key < candidate) <= k. Medians follow numpy exactly (mean of the
two middle order statistics for even counts, NaN for an empty range);
MAD = median of |x - median|.

CUDA tensors go to kernel K4 (csrc/select.cu): one block per (range, row)
stages the range's keys in shared memory once and finds the rank-th key by
histograms of 8-bit digits, most significant first, starting at the highest
bit in which the range's keys differ (3 or 4 rounds where the bisection
takes 32); rows whose keys do not fit shared memory stream the bisection
from device memory. CPU tensors go to the plain version over (R, B, L)
masks, which sorts each range's keys once.

`range_medians_adc` is the median-only path of the adc and vbz feeds: the
order statistics are selected over the int16 ADC preimage of the calibrated
signal as a 16-bit key and read back out of the calibrated float32 values.
The plain version bisects the key in 16 rounds (instead of the sign pass
and 31); kernel K8 on CUDA stages a range's keys in shared memory as
uint16 and runs K4's digit histograms over them, at most two rounds (rows
above 65,535 samples stream the bisection from device memory). It is
bit-identical to range_median_mad(with_mad=False) as long as the
calibration (adc + offset) * scale is monotone (scale > 0).
"""

from __future__ import annotations

import torch

from warpdemux_tpu_torch import _cuda
from warpdemux_tpu_torch.ops.numerics import fma

_I32_MAX = 2**31 - 1
# room kept for K4's static shared memory (its histograms and the warps'
# slots: 6,464 bytes as built, 12,928 with the 11-bit digits of the sweep in
# tune_kernels.py)
_SELECT_STATIC_BYTES = 13 * 1024
# the longest row whose keys (whole 16-byte vectors) fit beside it: 54,784
_STAGED_MAX_LEN = (_cuda.MAX_SHARED_BYTES - _SELECT_STATIC_BYTES) // 16 * 4


def _staged_bytes(L: int) -> int:
    """Dynamic shared memory of a K4 launch over rows of L samples: a whole
    row's staged keys (the range lengths are device data), 4 bytes each in
    whole 16-byte vectors, or 0 where they do not fit a block: then the
    streaming kernel runs."""
    return -(-L // 4) * 16 if L <= _STAGED_MAX_LEN else 0


def order_keys(x: torch.Tensor) -> torch.Tensor:
    """Monotone int32 image of float32 values (total order)."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(i >= 0, i, i ^ 0x7FFFFFFF)


def keys_to_float(key: torch.Tensor) -> torch.Tensor:
    """Inverse of order_keys."""
    i = torch.where(key >= 0, key, key ^ 0x7FFFFFFF)
    return i.contiguous().view(torch.float32)


def median_from_keys(key, mask, n):
    """Median (numpy semantics) from precomputed keys; n = count(mask).

    The two middle order statistics of each masked row, read off one sort
    of its keys with those outside the mask moved past the end: an order
    statistic takes no float arithmetic, so any exact selection gives the
    bits that the kernels' radix selection gives."""
    if key.shape[-1] == 0:
        return torch.full(n.shape, float("nan"), device=key.device)
    srt = torch.where(mask, key, torch.full_like(key, _I32_MAX)).sort(-1).values
    n = n.to(torch.int64)
    lo = keys_to_float(srt.gather(-1, torch.clamp_min(torch.div(n - 1, 2, rounding_mode="floor"), 0)[..., None]))
    hi = keys_to_float(srt.gather(-1, (n // 2).clamp_max(key.shape[-1] - 1)[..., None]))
    med = torch.where(n[..., None] % 2 == 1, lo, 0.5 * (lo + hi))[..., 0]
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def range_median_mad_plain(
    x, starts, ends, with_mad=True, given_meds=None, given=(), calibration=None
):
    """Plain version of range_median_mad over (R, B, L) masks."""
    B, L = x.shape
    pos = torch.arange(L, device=x.device)[None, None, :]
    masks = (pos >= starts[..., None]) & (pos < ends[..., None])
    n = masks.sum(-1).to(torch.int32)
    key = order_keys(x)[None].expand_as(masks)
    meds = median_from_keys(key, masks, n)
    if given_meds is not None and any(given):
        g = torch.tensor(given, dtype=torch.bool, device=x.device)[:, None]
        meds = torch.where(g, given_meds.to(torch.float32), meds)
    if not with_mad:
        return meds, None
    if calibration is None:
        y = (x[None] - meds[..., None]).abs()
    else:
        adc, offset, scale = calibration
        ao = adc.to(torch.float32) + offset.to(torch.float32)[:, None]
        y = fma(ao[None], scale.to(torch.float32)[None, :, None], -meds[..., None]).abs()
    return meds, median_from_keys(order_keys(y), masks, n)


def range_median_mad(
    x: torch.Tensor,
    starts: torch.Tensor,
    ends: torch.Tensor,
    with_mad: bool = True,
    given_meds: torch.Tensor | None = None,
    given: tuple = (),
    calibration: tuple | None = None,
):
    """Exact median (+ MAD) over R contiguous [start, end) ranges per row.

    Args:
      x: (B, L) float32.
      starts, ends: (R, B) int (clamped to [0, L]).
      given_meds / given: optional (R, B) precomputed medians and per-range
        flags; flagged ranges pass given_meds through and only search the MAD.
      calibration: optional (adc (B, L) int16, offset (B,), scale (B,))
        with x = (adc + offset) * scale computed in the same step. The MAD
        deviations are then |fma(adc + offset, scale, -median)|: XLA:CPU
        fuses the calibration into the subtraction with that one rounding.
    Returns:
      (meds (R, B) float32, mads (R, B) float32 or None).
    """
    starts = starts.to(torch.int32)
    ends = ends.to(torch.int32)
    if not _cuda.on_cuda(x, starts, ends, *(calibration or ())):
        return range_median_mad_plain(
            x, starts, ends, with_mad, given_meds, given, calibration
        )
    R, B = starts.shape
    L = x.shape[1]
    if ends.shape != (R, B) or x.shape[0] != B:
        raise ValueError("starts/ends must be (R, B) for x of shape (B, L)")
    if len(given) not in (0, R):
        raise ValueError("given must have one flag per range")
    x = x.contiguous()
    starts, ends = starts.contiguous(), ends.contiguous()
    _cuda.check(x, torch.float32, 2, "range_median_mad x")
    given_mask = sum(1 << r for r, g in enumerate(given) if g)
    gm = None
    if given_mask:
        if given_meds is None:
            raise ValueError("given ranges need given_meds")
        gm = given_meds.to(torch.float32).contiguous()
        _cuda.check(gm, torch.float32, 2, "range_median_mad given_meds")
        if gm.shape != (R, B):
            raise ValueError("given_meds must be (R, B) like starts")
    cal = (None, None, None)
    if calibration is not None:
        adc, offset, scale = calibration
        cal = (
            adc.contiguous(),
            offset.to(torch.float32).contiguous(),
            scale.to(torch.float32).contiguous(),
        )
        _cuda.check(cal[0], torch.int16, 2, "range_median_mad adc")
        if cal[0].shape != x.shape or cal[1].shape != (B,) or cal[2].shape != (B,):
            raise ValueError("calibration must be adc (B, L), offset and scale (B,)")
    meds = torch.empty((R, B), dtype=torch.float32, device=x.device)
    mads = torch.empty((R, B), dtype=torch.float32, device=x.device)
    _cuda.launch(
        "wdx_range_median_mad", x.device, x.data_ptr(), starts.data_ptr(),
        ends.data_ptr(), None if gm is None else gm.data_ptr(), given_mask,
        int(with_mad), *[None if t is None else t.data_ptr() for t in cal],
        meds.data_ptr(), mads.data_ptr(), R, B, L, _staged_bytes(L),
    )
    return (meds, mads) if with_mad else (meds, None)


_I16_BIAS = 32768  # adc + bias -> [0, 65535]
# the longest row K8 stages: its histograms count a range in 16-bit halves
# (shared memory would hold the 2-byte keys of a row of 109,568 samples)
_ADC_STAGED_MAX_LEN = 65535


def _adc_staged_bytes(L: int) -> int:
    """Dynamic shared memory of a K8 launch over rows of L samples: a whole
    row's staged keys, 2 bytes each in whole 16-byte vectors, or 0 where
    the row is too long: then the streaming kernel runs."""
    return -(-L // 8) * 16 if L <= _ADC_STAGED_MAX_LEN else 0


def range_medians_adc_plain(x, adc, starts, ends):
    """Plain version of range_medians_adc over (R, B, L) masks."""
    B, L = x.shape
    pos = torch.arange(L, device=x.device)[None, None, :]
    masks = (pos >= starts[..., None]) & (pos < ends[..., None])
    n = masks.sum(-1).to(torch.int32)
    key = (adc.to(torch.int32) + _I16_BIAS)[None]
    kz = torch.where(masks, key, torch.full_like(key, 1 << 20))
    rank = torch.clamp_min(torch.div(n - 1, 2, rounding_mode="floor"), 0)
    lo_key = torch.zeros_like(rank)
    for bit in range(15, -1, -1):
        t = lo_key | (1 << bit)
        cnt = (kz < t[..., None]).sum(-1)
        lo_key = torch.where(cnt <= rank, t, lo_key)
    inf = torch.full_like(masks, float("inf"), dtype=torch.float32)
    xb = x.to(torch.float32)[None].expand_as(inf)
    lo = torch.where(masks & (key == lo_key[..., None]), xb, inf).amin(-1)
    nxt = torch.where(masks & (key > lo_key[..., None]), xb, inf).amin(-1)
    cnt_le = (masks & (key <= lo_key[..., None])).sum(-1)
    need_next = (n % 2 == 0) & (cnt_le <= n // 2)
    hi = torch.where(need_next, nxt, lo)
    med = torch.where(n % 2 == 1, lo, 0.5 * (lo + hi))
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def range_medians_adc(
    x: torch.Tensor, adc: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor
) -> torch.Tensor:
    """Exact medians of x over R [start, end) ranges per row, selected over
    x's int16 ADC preimage.

    Args:
      x: (B, L) float32 calibrated signal, a monotone (non-decreasing)
        per-row image of adc: every caller passes (adc + offset) * scale
        with scale > 0.
      adc: (B, L) int16 ADC counts.
      starts, ends: (R, B) int (clamped to [0, L]).
    Returns:
      (R, B) float32 medians (numpy semantics; NaN for an empty range).

    Where x is no such image the result is unspecified between the two
    versions: the plain one takes the smallest x over all positions of the
    range that carry the middle key (and the next larger keys), K8 reads x
    at the first position that carries the middle key and at the first that
    carries the next larger key.
    """
    starts = starts.to(torch.int32)
    ends = ends.to(torch.int32)
    if x.shape != adc.shape:
        raise ValueError("x and adc must have the same (B, L) shape")
    if not _cuda.on_cuda(x, adc, starts, ends):
        return range_medians_adc_plain(x, adc, starts, ends)
    R, B = starts.shape
    L = x.shape[1]
    if ends.shape != (R, B) or x.shape[0] != B:
        raise ValueError("starts/ends must be (R, B) for x of shape (B, L)")
    x, adc = x.contiguous(), adc.contiguous()
    starts, ends = starts.contiguous(), ends.contiguous()
    _cuda.check(x, torch.float32, 2, "range_medians_adc x")
    _cuda.check(adc, torch.int16, 2, "range_medians_adc adc")
    meds = torch.empty((R, B), dtype=torch.float32, device=x.device)
    _cuda.launch(
        "wdx_range_median_adc", x.device, x.data_ptr(), adc.data_ptr(),
        starts.data_ptr(), ends.data_ptr(), meds.data_ptr(), R, B, L,
        _adc_staged_bytes(L),
    )
    return meds
