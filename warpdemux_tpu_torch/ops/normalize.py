"""Masked, batched normalization primitives.

Port of warpdemux_tpu/ops/normalize.py. Every op takes an explicit
validity mask over fixed-shape (..., L) batches. Medians follow numpy
(mean of the two middle order statistics; NaN when nothing is valid).

`masked_median` takes the JAX function's two forms: float32 rows of 512
lanes or more read the order statistics off the order keys, as the JAX
package's radix select does (`select.median_from_keys`: NaN and inf in
their key order, the midpoint only for an even count); shorter rows sort
with the invalid lanes pushed to float32's max (`sorted_median`), as
JAX's sort does. `mean_normalize`, `mad_normalize`, `normalize`,
`normalize_wrt` and `clip_outliers` are the JAX functions of the same
name, bit for bit on the CPU, non-finite rows included.
"""

from __future__ import annotations

import numpy as np
import torch

from warpdemux_tpu_torch.ops.numerics import XLA_REDUCE_WINDOW, exact_sqrt, fma, xla_sum
from warpdemux_tpu_torch.ops.select import median_from_keys, order_keys, range_median_mad

# the row width from which the JAX package's float32 median selects by
# order keys instead of sorting
SELECT_MIN_WIDTH = 512
METHODS = ("mean", "median", "none")


def sorted_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median over the valid lanes of the last axis by one sort, the
    invalid lanes pushed to float32's max, midpoint 0.5 * (lo + hi): the
    JAX function's bits at any width on finite rows (an order statistic
    takes no arithmetic). Where a row of 512 or more holds +inf or NaN
    beside invalid lanes, the JAX package's select differs: use
    `masked_median` there."""
    n = mask.sum(-1)
    big = torch.finfo(x.dtype).max
    s = torch.sort(torch.where(mask, x, torch.full_like(x, big)), dim=-1).values
    lo = s.gather(-1, torch.clamp_min(torch.div(n - 1, 2, rounding_mode="floor"), 0)[..., None])
    hi = s.gather(-1, torch.clamp_min(n // 2, 0)[..., None])
    med = 0.5 * (lo[..., 0] + hi[..., 0])
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median over the valid lanes of the last axis: x[..., L] -> x[...],
    in the JAX function's form for the row's width and dtype."""
    if x.dtype == torch.float32 and x.shape[-1] >= SELECT_MIN_WIDTH:
        return median_from_keys(order_keys(x), mask, mask.sum(-1))
    return sorted_median(x, mask)


def masked_mad(x: torch.Tensor, mask: torch.Tensor, med: torch.Tensor | None = None):
    """Median absolute deviation over the valid lanes of the last axis."""
    if med is None:
        med = masked_median(x, mask)
    return masked_median((x - med[..., None]).abs(), mask)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over the valid lanes of the last axis (0 where none is valid),
    with the bits of the jitted JAX step: the masked row summed over every
    lane in XLA's order (`xla_sum`), then a true float32 division by the
    count."""
    return xla_sum(torch.where(mask, x, torch.zeros_like(x))) / _count(mask)


def masked_mean_std(x: torch.Tensor, mask: torch.Tensor, calibration=None):
    """(mean, population std) over the valid lanes of the last axis, two
    passes like np.mean / np.std, with the bits of the jitted JAX step.

    The squared deviations are summed in XLA's order (`_sum_of_squares`),
    divided by the count and square-rooted correctly rounded. Where
    the step calibrated x = (adc + offset) * scale itself, XLA contracts
    the calibration into the deviation: pass `calibration` = (adc (B, L),
    offset (B,), scale (B,)) and the deviation is fma(adc + offset, scale,
    -mean), as the region MADs take it (ops/select)."""
    mean = masked_mean(x, mask)
    if calibration is None:
        dev = x - mean[..., None]
    else:
        adc, offset, scale = calibration
        dev = fma(adc.to(torch.float32) + offset[:, None], scale[:, None], -mean[..., None])
    d = torch.where(mask, dev, torch.zeros_like(dev))
    return mean, exact_sqrt(_sum_of_squares(d) / _count(mask))


def _sum_of_squares(d: torch.Tensor) -> torch.Tensor:
    """The sum of d * d along the last dim, as XLA:CPU computes it: the
    squares rounded on their own and summed in `xla_sum`'s tree for rows
    longer than 32; in a row of at most 32, one sequential chain of fused
    multiply-adds."""
    if d.shape[-1] > XLA_REDUCE_WINDOW:
        return xla_sum(d * d)
    acc = torch.zeros_like(d[..., 0])
    for j in range(d.shape[-1]):
        acc = fma(d[..., j], d[..., j], acc)
    return acc


def _count(mask: torch.Tensor) -> torch.Tensor:
    """The float32 count of valid lanes, at least 1."""
    return torch.clamp_min(mask.sum(-1).to(torch.float32), 1.0)


def mean_std(x: torch.Tensor):
    """(mean, population std) over every lane of the last axis, with the
    bits of the jitted JAX `masked_mean_std` under an all-true mask: the
    sums in XLA's order (`xla_sum`), and the count folded, so that XLA
    multiplies by its float32 reciprocal where it would divide. For rows
    longer than 32 (a fingerprint's 111 or 121 events): in a shorter row
    XLA also contracts the sum of squares into fused multiply-adds."""
    inv_n = float(np.float32(1) / np.float32(max(x.shape[-1], 1)))
    mean = xla_sum(x) * inv_n
    d = x - mean[..., None]
    return mean, exact_sqrt(xla_sum(d * d) * inv_n)


def mean_normalize(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std over the valid lanes of the last axis, a true
    division (NaN or inf where std is 0, as in JAX)."""
    mean, std = masked_mean_std(x, mask)
    return (x - mean[..., None]) / std[..., None]


def mad_normalize(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(x - median) / MAD over the valid lanes of the last axis."""
    med = masked_median(x, mask)
    return (x - med[..., None]) / masked_mad(x, mask, med)[..., None]


def check_method(method: str, methods=METHODS) -> None:
    """ValueError, in the JAX package's words, for a method not in `methods`."""
    if method not in methods:
        raise ValueError(f"Normalization method {method} not recognized.")


def normalize(x: torch.Tensor, mask: torch.Tensor, method: str = "mean") -> torch.Tensor:
    """`mean_normalize`, `mad_normalize` or x itself, by `method` ("mean",
    "median" or "none"); ValueError for any other."""
    check_method(method)
    if method == "mean":
        return mean_normalize(x, mask)
    return mad_normalize(x, mask) if method == "median" else x


def normalize_wrt(
    to_norm: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor, method: str = "mean"
) -> torch.Tensor:
    """`to_norm` (..., M1) shifted and scaled by the statistics of the valid
    lanes of `ref` (..., M2): mean and std ("mean") or median and MAD
    ("median"); ValueError for any other method."""
    check_method(method, ("mean", "median"))
    if method == "mean":
        shift, scale = masked_mean_std(ref, ref_mask)
    else:
        shift = masked_median(ref, ref_mask)
        scale = masked_mad(ref, ref_mask, shift)
    return (to_norm - shift[..., None]) / scale[..., None]


def clip_outliers(x: torch.Tensor, mask: torch.Tensor, thresh: float) -> torch.Tensor:
    """Clip to median +/- thresh * MAD of the valid lanes of the last axis."""
    med = masked_median(x, mask)
    mad = masked_mad(x, mask, med)
    return torch.minimum(torch.maximum(x, (med - thresh * mad)[..., None]), (med + thresh * mad)[..., None])


def clip_outliers_prefix(
    x: torch.Tensor, n_valid: torch.Tensor, thresh: float
) -> torch.Tensor:
    """Clip to median +/- thresh * MAD of the valid prefix [0, n_valid).

    The median and MAD come from range_median_mad (kernel K4 on CUDA)."""
    B = x.shape[0]
    med, mad = range_median_mad(
        x,
        torch.zeros((1, B), dtype=torch.int32, device=x.device),
        n_valid.to(torch.int32)[None],
    )
    lo = med[0] - thresh * mad[0]
    hi = med[0] + thresh * mad[0]
    return torch.minimum(torch.maximum(x, lo[:, None]), hi[:, None])
