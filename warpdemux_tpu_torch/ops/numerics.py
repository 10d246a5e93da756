"""Float32 arithmetic with a fixed, device-independent rounding.

The detector compares rolling means and variances, changepoint costs and
t-scores against thresholds and minima, so a last-bit difference can move a
boundary. The port therefore fixes how those float32 values are rounded to
what the JAX package computes on the CPU, instead of leaving it to each
device's summation order and contraction choices:

- `blocked_cumsum`: XLA:CPU lowers a float32 cumsum to a blocked scan:
  sequential sums inside blocks of 16 samples, the block totals scanned the
  same way recursively, each block's exclusive offset added last.
- `fma`: XLA:CPU contracts a*b + c into one fused multiply-add (a single
  rounding) where the expression allows it, e.g. s2/n - mean*mean.
- `exact_sqrt`: XLA's float32 sqrt is correctly rounded; PyTorch's
  vectorized CPU sqrt is not always.

Both give the same bits on CPU and CUDA; the kernels run the same trees
and call __fmaf_rn at the same places.
"""

from __future__ import annotations

import torch

BLOCK = 16


def blocked_cumsum(a: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sum along dim 1 of a (B, n) tensor."""
    B, n = a.shape
    if n <= BLOCK:
        return _sequential_cumsum(a)
    nb = -(-n // BLOCK)
    blocks = torch.nn.functional.pad(a, (0, nb * BLOCK - n)).reshape(B, nb, BLOCK)
    inner = _sequential_cumsum(blocks)
    totals = blocked_cumsum(inner[..., -1])
    offsets = torch.cat([totals.new_zeros((B, 1)), totals[:, :-1]], dim=1)
    return (inner + offsets[..., None]).reshape(B, nb * BLOCK)[:, :n]


def _sequential_cumsum(a: torch.Tensor) -> torch.Tensor:
    """Left-to-right running sum along the last dim, one add per element."""
    cols = [a[..., 0]]
    for j in range(1, a.shape[-1]):
        cols.append(cols[-1] + a[..., j])
    return torch.stack(cols, dim=-1)


def prefix_sums(a: torch.Tensor) -> torch.Tensor:
    """(B, L) -> (B, L+1) prefix sums with a leading zero column."""
    return torch.cat([a.new_zeros((a.shape[0], 1)), blocked_cumsum(a)], dim=1)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c with one rounding. The product of two float32 values
    is exact in float64; the float64 sum rounds once more, which changes
    the float32 result only if it lands exactly on a float32 rounding tie."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def exact_sqrt(a: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (via float64, whose correctly
    rounded root rounds to the correctly rounded float32 root)."""
    return torch.sqrt(a.double()).to(torch.float32)
