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

K11 is bound by bytes: the span of a row its ranges cover, read once. It
has three variants:

- the block kernel: one block a row, the span staged once in shared
  memory (int16 where the step calibrated, else float32), every touched
  window of every range summed by a thread of its own, the levels above
  and the top only where a range has entries, then the squares from the
  same staged span. It answers the warp kernel's four limits: one long
  dependent chain a warp, the tree's top run over every window sum of the
  row, too few warps an SM (8 at the gate's one range) to hide that chain,
  and a second read of device memory for the squares.
- the warp kernel (the first design): one warp a range and row, 32 windows
  staged at a time, for rows beyond the block kernel's shared memory.
- the workspace kernel: the warp kernel with its window sums (level 1 and
  every level above, as many as the row needs) in a global workspace the
  wrapper allocates, for rows whose sums outgrow shared memory.

The wrapper takes the block kernel where `block_shared_bytes(L, R,
calibrated)` fits a block (`_cuda.MAX_SHARED_BYTES`): rows of up to 92,480
samples calibrated and 51,456 float at three ranges (103,072 and 54,624 at
one); the warp kernel above, to 431,104 samples; the workspace kernel at
any longer row. `variant="block"`, `"warp"` or `"global"` forces one (for
timing them and holding each to the plain version); a forced kernel beyond
its own rows, or a row of no samples, raises ValueError.
"""

from __future__ import annotations

import torch

from warpdemux_tpu_torch import _cuda
from warpdemux_tpu_torch.ops.normalize import masked_mean, masked_mean_std

# warps (one a range and row) a block of K11's warp kernel
WARPS = 4
# floats of the warp kernel's shared memory a warp beyond its window sums:
# a staged tile of 32 windows of 32 samples, rows padded to 33 against bank
# conflicts
_TILE_FLOATS = 32 * 33
# ints a range of the block kernel keeps in shared memory (its bounds and
# the touched entries of three levels), and its mean
_RANGE_WORDS = 8 + 1
VARIANTS = {"block": 0, "warp": 1, "global": 2}


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
    """The warp kernel's dynamic shared memory a block at row length L: a
    warp's window sums and its staged tile."""
    return WARPS * 4 * (-(-L // 32) + _TILE_FLOATS)


def _levels(L: int) -> tuple[int, int, int]:
    """Entries of the sum tree's levels 1-3 over a row of L (0: no level)."""
    n1 = -(-L // 32)
    n2 = -(-n1 // 32) if n1 > 32 else 0
    n3 = -(-n2 // 32) if n2 > 32 else 0
    return n1, n2, n3


def block_shared_bytes(L: int, R: int, calibrated: bool) -> int:
    """The block kernel's dynamic shared memory at row length L and R
    ranges: the ranges' bounds and means, every level's sums and the staged
    span, a window of 32 samples in 17 words (int16) or 33 (float32); 0
    where the tree would need a fourth level."""
    n1, n2, n3 = _levels(L)
    if n3 > 32:
        return 0
    a16 = lambda n: -(-n // 16) * 16
    return a16(4 * R * _RANGE_WORDS) + a16(4 * R * (n1 + n2 + n3)) + 4 * n1 * (17 if calibrated else 33)


def _kernel_shared_bytes(kind: str, L: int, R: int, calibrated: bool) -> int:
    """Dynamic shared memory of K11's kernel `kind` at rows of L and R
    ranges (0: the block kernel's tree would need a fourth level)."""
    if kind == "block":
        return block_shared_bytes(L, R, calibrated)
    return shared_bytes(L) if kind == "warp" else WARPS * 4 * _TILE_FLOATS


def takes(L: int, R: int, calibrated: bool, variant: str) -> bool:
    """Whether K11's kernel `variant` serves rows of L samples at R ranges."""
    return L > 0 and 0 < _kernel_shared_bytes(variant, L, R, calibrated) <= _cuda.MAX_SHARED_BYTES


def _variant(L: int, R: int, calibrated: bool, variant):
    """(variant, shared bytes) of K11 for rows of L and R ranges: the block
    kernel where its shared memory fits, else the warp kernel where its
    window sums fit, else the workspace kernel; `variant` forces one.
    ValueError outside the domain."""
    if variant not in (None, *VARIANTS):
        raise ValueError(f"range_mean_std: variant must be one of {tuple(VARIANTS)}, got {variant!r}")
    for kind in VARIANTS if variant is None else (variant,):
        if takes(L, R, calibrated, kind):
            return kind, _kernel_shared_bytes(kind, L, R, calibrated)
    raise ValueError(f"range_mean_std: rows of {L} samples are outside K11's domain"
                     + (f" ({variant} kernel)" if variant else ""))


def range_mean_std(x, starts, ends, with_std: bool = True, calibration=None, *, variant=None):
    """`range_mean_std_plain`; K11 on CUDA, one launch for every range: the
    block kernel where its shared memory fits, else the warp kernel, else
    the workspace kernel (`variant` forces one).

    A CUDA call with rows of no samples, or a forced kernel beyond its own
    rows, raises ValueError."""
    tensors = (x, starts, ends) if calibration is None else (x, starts, ends, *calibration)
    if not _cuda.on_cuda(*tensors):
        return range_mean_std_plain(x, starts, ends, with_std, calibration)
    _check(x, starts, ends, calibration)
    R, B = starts.shape
    L = x.shape[1]
    kind, smem = _variant(L, R, calibration is not None, variant)
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
    # the workspace kernel's window sums: ceil(L / 32) floats a range and row
    ws = torch.empty(R * B * -(-L // 32), dtype=torch.float32, device=x.device) if kind == "global" else None
    ptr = lambda t: None if t is None else t.data_ptr()
    _cuda.launch(
        "wdx_rowstats", x.device, ptr(None if calibration is not None else x), ptr(adc), ptr(offset),
        ptr(scale), starts.data_ptr(), ends.data_ptr(), means.data_ptr(), ptr(stds), ptr(ws), R, B, L,
        VARIANTS[kind], smem,
    )
    return means, stds
