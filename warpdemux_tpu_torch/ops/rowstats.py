"""Masked row means and standard deviations of [start, end) ranges, in the
jitted JAX step's float32 order.

The detector's region statistics (adapter, poly(A) and RNA means and stds)
and the [mvs_polya] gate's poly(A) mean are, in the JAX package, float32
sums of the whole masked row (`jnp.where(mask, x, 0)`), which XLA:CPU
reduces as a tree of 32-wide sequential windows (`numerics.xla_sum`).
`range_mean_std_plain` computes them so with torch operations
(`normalize.masked_mean_std`); each `xla_sum` of a 10,000-sample row is
some 75 dependent operations. On CUDA tensors `range_mean_std` runs every
range of a call in one launch of kernel K11 (csrc/rowstats.cu), which
sums in the same association. K11 has no Pallas counterpart: the JAX
package leaves these sums to XLA.
"""

from __future__ import annotations

import torch

from warpdemux_tpu_torch import _cuda
from warpdemux_tpu_torch.ops.normalize import masked_mean, masked_mean_std

# warps (one a range and row) a block of K11
WARPS = 4
# floats of K11's shared memory a warp beyond its window sums: a staged tile
# of 32 windows of 32 samples, rows padded to 33 against bank conflicts
_TILE_FLOATS = 32 * 33


def _check(x, starts, ends, calibration):
    if x.dim() != 2 or starts.dim() != 2 or starts.shape != ends.shape or starts.shape[1] != x.shape[0]:
        raise ValueError("want x (B, L) and starts, ends (R, B)")
    if calibration is not None:
        adc, offset, scale = calibration
        if adc.shape != x.shape or offset.shape != (x.shape[0],) or scale.shape != (x.shape[0],):
            raise ValueError("calibration must be (adc (B, L), offset (B,), scale (B,))")


def range_mean_std_plain(x, starts, ends, with_std: bool = True, calibration=None):
    """(means, stds), each (R, B) (stds None without `with_std`), of the
    samples of x in [starts[r, b], ends[r, b]) of row b; an empty range
    gives mean 0 and std 0. With `calibration` = (adc, offset, scale), x is
    (adc + offset) * scale computed by the caller, and the deviations take
    the calibration's fused form (`normalize.masked_mean_std`)."""
    _check(x, starts, ends, calibration)
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    masks = [(pos >= s[:, None]) & (pos < e[:, None]) for s, e in zip(starts, ends)]
    if not with_std:
        return torch.stack([masked_mean(x, m) for m in masks]), None
    means, stds = zip(*[masked_mean_std(x, m, calibration) for m in masks])
    return torch.stack(means), torch.stack(stds)


def shared_bytes(L: int) -> int:
    """K11's dynamic shared memory a block at row length L: a warp's window
    sums and its staged tile."""
    return WARPS * 4 * (-(-L // 32) + _TILE_FLOATS)


def range_mean_std(x, starts, ends, with_std: bool = True, calibration=None):
    """`range_mean_std_plain`; K11 on CUDA, one launch for every range.

    A CUDA call outside K11's domain (a row too long for its shared memory)
    raises ValueError."""
    tensors = (x, starts, ends) if calibration is None else (x, starts, ends, *calibration)
    if not _cuda.on_cuda(*tensors):
        return range_mean_std_plain(x, starts, ends, with_std, calibration)
    _check(x, starts, ends, calibration)
    R, B = starts.shape
    L = x.shape[1]
    smem = shared_bytes(L)
    if smem > _cuda.MAX_SHARED_BYTES or L == 0:
        raise ValueError(f"range_mean_std: rows of {L} samples are outside K11's domain")
    starts = starts.to(torch.int32).contiguous()
    ends = ends.to(torch.int32).contiguous()
    if calibration is None:
        x = x.contiguous()
        _cuda.check(x, torch.float32, 2, "range_mean_std x")
        adc = offset = scale = None
    else:
        adc, offset, scale = calibration
        adc = adc.to(torch.int16).contiguous()
        offset = offset.to(torch.float32).contiguous()
        scale = scale.to(torch.float32).contiguous()
    means = torch.empty((R, B), dtype=torch.float32, device=x.device)
    stds = torch.empty((R, B), dtype=torch.float32, device=x.device) if with_std else None
    ptr = lambda t: None if t is None else t.data_ptr()
    _cuda.launch(
        "wdx_rowstats", x.device, ptr(None if calibration is not None else x), ptr(adc), ptr(offset),
        ptr(scale), starts.data_ptr(), ends.data_ptr(), means.data_ptr(), ptr(stds), R, B, L, smem,
    )
    return means, stds
