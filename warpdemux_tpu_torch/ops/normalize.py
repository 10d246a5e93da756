"""Masked, batched normalization primitives.

Port of the parts of warpdemux_tpu/ops/normalize.py on the decision path.
Every op takes an explicit validity mask over fixed-shape (B, L) batches.
Medians follow numpy (mean of the two middle order statistics; NaN when
nothing is valid). The masked median sorts: it is exact, so it equals the
JAX package's radix-select result bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from warpdemux_tpu_torch.ops.numerics import exact_sqrt, xla_sum
from warpdemux_tpu_torch.ops.select import range_median_mad


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median over the valid lanes of the last axis: x[..., L] -> x[...]."""
    n = mask.sum(-1)
    big = torch.finfo(x.dtype).max
    s = torch.sort(torch.where(mask, x, torch.full_like(x, big)), dim=-1).values
    lo = s.gather(-1, torch.clamp_min(torch.div(n - 1, 2, rounding_mode="floor"), 0)[..., None])
    hi = s.gather(-1, torch.clamp_min(n // 2, 0)[..., None])
    med = 0.5 * (lo[..., 0] + hi[..., 0])
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def masked_mad(x: torch.Tensor, mask: torch.Tensor, med: torch.Tensor | None = None):
    """Median absolute deviation over the valid lanes of the last axis."""
    if med is None:
        med = masked_median(x, mask)
    return masked_median((x - med[..., None]).abs(), mask)


def masked_mean_std(x: torch.Tensor, mask: torch.Tensor):
    """(mean, population std) over valid lanes, two-pass like np.mean/np.std.

    Sums accumulate in float64 and round to x's dtype, so CPU and CUDA agree."""
    zero = torch.zeros_like(x)
    safe_n = torch.clamp_min(mask.sum(-1).to(x.dtype), 1.0)
    mean = _sum(torch.where(mask, x, zero)) / safe_n
    d = torch.where(mask, x - mean[..., None], zero)
    return mean, torch.sqrt(_sum(d * d) / safe_n)


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


def _sum(a: torch.Tensor) -> torch.Tensor:
    return a.sum(-1, dtype=torch.float64).to(a.dtype)


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
