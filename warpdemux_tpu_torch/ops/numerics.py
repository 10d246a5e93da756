"""Float32 arithmetic with a fixed, device-independent rounding.

The detector compares rolling means and variances, changepoint costs and
t-scores against thresholds and minima, so a last-bit difference can move a
boundary. The port therefore fixes how those float32 values are rounded to
what the JAX package computes on the CPU, instead of leaving it to each
device's summation order and contraction choices:

- `blocked_cumsum`: XLA:CPU lowers a float32 cumsum to a blocked scan:
  sequential sums inside blocks of 16 samples, the block totals scanned the
  same way recursively, each block's exclusive offset added last.
- `xla_sum`: XLA:CPU rewrites a float32 row sum longer than 32 into a
  tree: sequential sums over windows of 32 (the row zero-padded to whole
  windows, half the padding in front), the window sums summed the same
  way, until 32 or fewer are left, which are summed in order.
- `fma`: XLA:CPU contracts a*b + c into one fused multiply-add (a single
  rounding) where the expression allows it, e.g. s2/n - mean*mean.
- `exact_sqrt`: XLA's float32 sqrt is correctly rounded; PyTorch's
  vectorized CPU sqrt is not always.
- `xla_log`: XLA:CPU's float32 log is the Cephes/Eigen polynomial, off
  the correctly rounded result by one ulp on a few percent of inputs;
  torch.log (and CUDA's logf) round differently.
- `xla_rsqrt`: XLA:CPU rewrites a / sqrt(b) into a * rsqrt(b) and computes
  the rsqrt as the x86 hardware estimate (`vrsqrtps`, a table of 2 x 1024
  entries of 12 bits) refined by two Newton steps with fused
  multiply-adds: neither 1 / sqrt(b) nor the correctly rounded rsqrt. The
  port carries the table as data (`ops/_rsqrt_table.py`).

All give the same bits on CPU and CUDA; the kernels run the same trees
and call __fmaf_rn at the same places.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading

import numpy as np
import torch

from warpdemux_tpu_torch.ops import _rsqrt_table

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


XLA_REDUCE_WINDOW = 32


def xla_sum(a: torch.Tensor) -> torch.Tensor:
    """float32 sum along the last dim with the bits of a jitted `jnp.sum`
    (a row of one is itself: XLA drops the initial zero, and keeps -0.0)."""
    if a.shape[-1] == 1:
        return a[..., 0]
    while a.shape[-1] > XLA_REDUCE_WINDOW:
        d = a.shape[-1]
        windows = -(-d // XLA_REDUCE_WINDOW)
        pad = windows * XLA_REDUCE_WINDOW - d
        a = torch.nn.functional.pad(a, (pad // 2, pad - pad // 2))
        a = _sequential_sum(a.reshape(*a.shape[:-1], windows, XLA_REDUCE_WINDOW))
    return _sequential_sum(a)


def _sequential_sum(a: torch.Tensor) -> torch.Tensor:
    """0 + a[..., 0] + a[..., 1] + ... along the last dim, one add each."""
    acc = a[..., 0] + 0.0
    for j in range(1, a.shape[-1]):
        acc = acc + a[..., j]
    return acc


def prefix_sums(a: torch.Tensor) -> torch.Tensor:
    """(B, L) -> (B, L+1) prefix sums with a leading zero column."""
    return torch.cat([a.new_zeros((a.shape[0], 1)), blocked_cumsum(a)], dim=1)


class _Float32Scope:
    """The TF32 switches are the process's, not a thread's: threads that
    run the CNN or a DTW-MLP at once (the live lane's classifier threads)
    enter and leave the scope at different times, so the first to enter
    saves the switches and the last to leave restores them."""

    def __init__(self):
        self.lock = threading.Lock()
        self.depth = 0
        self.saved = None

    def enter(self):
        with self.lock:
            if self.depth == 0:
                self.saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
                torch.backends.cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.allow_tf32 = False
            self.depth += 1

    def leave(self):
        with self.lock:
            self.depth -= 1
            if self.depth == 0:
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved


_float32_scope = _Float32Scope()


@contextlib.contextmanager
def full_float32():
    """Inside, float32 matrix products and convolutions on the GPU run in
    full float32: cuDNN would otherwise take TF32 for convolutions (its
    default), and so would matrix products where a caller switched it on.
    Any number of threads may be inside at once."""
    _float32_scope.enter()
    try:
        yield
    finally:
        _float32_scope.leave()


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c with one rounding. The product of two float32 values
    is exact in float64; the float64 sum rounds once more, which changes
    the float32 result only if it lands exactly on a float32 rounding tie."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def exact_sqrt(a: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (via float64, whose correctly
    rounded root rounds to the correctly rounded float32 root)."""
    return torch.sqrt(a.double()).to(torch.float32)


def _f32(v: float) -> float:
    """v rounded to float32 (as a Python float)."""
    return torch.tensor(v, dtype=torch.float32).item()


# Cephes/Eigen logf: polynomial coefficients, then ln(2) split in two
_LOG_P = tuple(_f32(p) for p in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1,
))
_LOG_Q1 = _f32(-2.12194440e-4)
_LOG_Q2 = _f32(0.693359375)
_SQRT_HALF = _f32(0.707106781186547524)
_TINY = torch.finfo(torch.float32).tiny


def xla_log(a: torch.Tensor) -> torch.Tensor:
    """float32 natural log with the bits of XLA:CPU's `jnp.log`.

    The algorithm of the kernel XLA compiles for log: range reduction to a
    mantissa m in [sqrt(1/2) - 1, sqrt(2) - 1) and an exponent e, a degree-8
    polynomial in m evaluated as three FMA chains in m**3, and
    e * ln(2) added in two parts, with the same fused multiply-adds (each
    emulated as `fma` does: an exact float64 product, one float64 add,
    one rounding to float32).

    Domain: finite x > 0, for which the bits equal XLA's. The other inputs
    give what XLA:CPU gives: -inf for zero and for subnormals (which it
    reads as zero), +inf for +inf, NaN for negative numbers and NaN.
    """
    x = a.to(torch.float32)
    bits = torch.clamp_min(x, _TINY).view(torch.int32)
    e = ((bits >> 23) - 126).to(torch.float32)
    m = ((bits & 0x807FFFFF) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    small = m < _SQRT_HALF
    e = torch.where(small, e - 1.0, e)
    m = torch.where(small, (m - 1.0) + m, m - 1.0)
    x2 = m * m
    x3 = m * x2
    m64, x3_64 = m.double(), x3.double()

    def fma64(a64, b, c):
        # float32 fma(a, b, c) for a given in float64 (b, c: float32 values)
        return (a64 * b + c).to(torch.float32)

    def chain(p0, p1, p2):
        return fma64(fma64(m64, p0, p1).double(), m64, p2)

    A = chain(*_LOG_P[0:3])
    B = chain(*_LOG_P[3:6])
    C = chain(*_LOG_P[6:9])
    y = fma64(fma64(A.double(), x3_64, B).double(), x3_64, C)
    t = fma64(y.double(), x3_64, e * _LOG_Q1)
    r = fma64(e.double(), _LOG_Q2, fma64(x2.double(), -0.5, m) + t)
    r = torch.where(x == float("inf"), x, r)
    r = torch.where((x < 0) | torch.isnan(x), torch.full_like(r, float("nan")), r)
    # zero and subnormal inputs (read as zero) give -inf, of either sign
    return torch.where(x.abs() < _TINY, torch.full_like(r, float("-inf")), r)


_rsqrt_tables: dict[torch.device, torch.Tensor] = {}


def rsqrt_table(device) -> torch.Tensor:
    """The (2048,) int16 table of `ops/_rsqrt_table.py` on `device` (made
    once a device): entry p * 1024 + hi for the parity p of the unbiased
    exponent and the top 10 mantissa bits hi."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    table = _rsqrt_tables.get(device)
    if table is None:
        digits = _rsqrt_table.HEX
        values = np.array(
            [int(digits[i : i + 3], 16) for i in range(0, len(digits), 3)], dtype="<u2"
        )
        if hashlib.sha256(values.tobytes()).hexdigest() != _rsqrt_table.SHA256:
            raise RuntimeError("ops/_rsqrt_table.py: the table does not match its SHA-256")
        table = _rsqrt_tables[device] = torch.from_numpy(values.astype(np.int16)).to(device)
    return table


def xla_rsqrt(a: torch.Tensor) -> torch.Tensor:
    """float32 1 / sqrt(x) with the bits of XLA:CPU's `lax.rsqrt` on an x86
    host whose `vrsqrtps` estimate is the recorded table's.

    The algorithm of the kernel XLA compiles: y0 = the hardware estimate
    (for a normal x = 4**k * x', x' in [1, 4): the table's entry for x',
    scaled by 2**-k), then twice a = x*y, b = y*(-0.5), d = fma(a, y, -1),
    y = fma(b, d, y). +inf, positive subnormals and both zeros keep the raw
    estimate: 0 for +inf, an infinity of x's sign for the others (the
    estimate reads a subnormal as zero). A negative subnormal gives -inf;
    other negative numbers and NaN give NaN.
    """
    x = a.to(torch.float32)
    bits = x.view(torch.int32)
    e = (bits >> 23) & 0xFF
    p = (e - 127) & 1
    k = (e - 127 - p) >> 1  # e - 127 - p is even: an exact half
    entry = rsqrt_table(x.device)[(p << 10) | ((bits >> 13) & 0x3FF)].to(torch.int32)
    y = (0x3F000000 + (entry << 11) - (k << 23)).view(torch.float32)
    minus_half = torch.full_like(x, -0.5)
    minus_one = torch.full_like(x, -1.0)
    for _ in range(2):
        y = fma(y * minus_half, fma(x * y, y, minus_one), y)
    inf = torch.full_like(x, float("inf"))
    y = torch.where(x.abs() < _TINY, torch.copysign(inf, x), y)
    y = torch.where(x == inf, torch.zeros_like(x), y)
    return torch.where((x <= -_TINY) | torch.isnan(x), torch.full_like(x, float("nan")), y)
