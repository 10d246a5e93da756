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
  torch.log (and CUDA's logf) round differently. The elementwise kernel
  `wdx_xla_log` on CUDA; the LLR cost takes its device function inside
  K14 (`detect/boundaries.llr_split`).
- `xla_exp`: XLA:CPU's float32 exp (Cephes, its FMAs, subnormal results
  flushed to zero), of the input times a float32 scale. Kernel K16 on
  CUDA.
- `xla_softmax`: jax.nn.softmax jitted on XLA:CPU: XLA's exp of z less
  the row max over the row's `xla_sum`, a subnormal quotient flushed to
  zero. Kernel K15 on CUDA, at any width.
- `xla_rsqrt`: XLA:CPU rewrites a / sqrt(b) into a * rsqrt(b) and computes
  the rsqrt as the x86 hardware estimate (`vrsqrtps`, a table of 2 x 1024
  entries of 12 bits) refined by two Newton steps with fused
  multiply-adds: neither 1 / sqrt(b) nor the correctly rounded rsqrt. The
  port carries the table as data (`ops/_rsqrt_table.py`).
- `xla_dot`: a jitted float32 `jnp.dot` of a (B, N) by an (N, P) matrix
  sums each output in one of a few fixed orders, chosen by the shape
  (`xla_dot_order`): four interleaved FMA chains, or one FMA chain over
  blocks of k; one of these, fixed for the shape, where XLA's is not
  known (`dot_order`).

All give the same bits on CPU and CUDA; the kernels run the same trees
and call __fmaf_rn at the same places.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading

import numpy as np
import torch

from warpdemux_tpu_torch import _cuda
from warpdemux_tpu_torch.ops import _rsqrt_table

BLOCK = 16
_TINY = torch.finfo(torch.float32).tiny


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
    run the CNN at once (the live lane's classifier threads, the trainer)
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


_TIE_BITS = (1 << 29) - 1  # the float64 mantissa bits below float32's
_TIE = 1 << 28  # ... of a float32 half-way point


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c with one rounding, as a fused multiply-add (the
    CUDA kernels' __fmaf_rn). The product of two float32 values is exact in
    float64, so a*b + c is rounded twice: to float64, then to float32. That
    moves the result only where the float64 sum lands exactly on a float32
    half-way point, or among float32's subnormals, while the exact sum is
    not there. On the CPU one mask test finds those elements, and only they
    are summed again with the float64 sum rounded to odd, which rounds to
    float32 correctly. On other devices every element's sum is rounded to
    odd: a mask would cost a host sync or a dozen more launches."""
    if a.device.type != "cpu":
        p = a.double() * b.double()
        c = c.double()
        return _round_to_odd(p, c, p + c)
    shape = torch.broadcast_shapes(a.shape, b.shape, c.shape)
    s = a.expand(shape).to(torch.float64, memory_format=torch.contiguous_format, copy=True)
    s.mul_(b)
    s.add_(c)
    out = s.to(torch.float32)
    low = s.reshape(-1).view(torch.int32)[0::2].contiguous()  # each float64's low word (little-endian)
    low &= _TIE_BITS
    tie = (low == _TIE).reshape(shape) | (out.abs() <= _TINY)
    if bool(tie.any()):
        at = tie.nonzero(as_tuple=True)
        a, b, c = (x.expand(shape)[at].double() for x in (a, b, c))
        out[at] = _round_to_odd(a * b, c, s[at])
    return out


def _round_to_odd(p: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """float32 of p + c from its float64 sum s = fl(p + c) rounded to odd:
    where s is inexact, the neighbour with an odd last bit on the side of
    the exact sum (its rounding error's), whose rounding to float32 is the
    correctly rounded result."""
    v = s - p
    err = (p - (s - v)) + (c - v)  # p + c = s + err exactly; NaN where s is not finite
    bits = s.view(torch.int64)
    away = torch.where((err > 0) == (s > 0), 1, -1)  # toward the exact sum: the magnitude up, or down
    inexact_even = (err != 0) & ~torch.isnan(err) & ((bits & 1) == 0)
    return (bits + torch.where(inexact_even, away, 0)).view(torch.float64).to(torch.float32)


LANES, CHAIN = 0, 1  # the two summation orders of xla_dot (K12's `mode`)
LANES_MAX_N = 2048  # the widest N at which P = 78 and 100 were found in the lanes order


def xla_dot_order(B: int, N: int, P: int) -> tuple[int, int] | None:
    """(order, kc) of XLA:CPU's jitted float32 (B, N) x (N, P) dot, or None
    where the order is not known (`dot_order` then picks one).

    Read off jax 0.9.0's XLA:CPU on an AVX-512 Xeon by comparing candidate
    orders with the jitted dot bit for bit (tests/test_torch_svm_dot.py):
    - LANES: four FMA chains over the k of each residue mod 4, combined
      (l0 + l1) + (l2 + l3), then the last N mod 4 terms as rounded
      products added one by one from 0, added last. B >= 2 and P <= 16
      (every five-class model); P = 21 (seven classes) from B = 51 on;
      P = 78 (twelve classes) and 100 (the DTW-MLP's hidden width) from
      B = 51 on while N <= 2048 (at N = 2304, 2601 and 3617 it is not).
    - CHAIN: one FMA chain from 0 over each block of kc terms, the block
      sums added in order to 0. P = 21 below B = 51 (kc = N); P = 55
      (eleven classes) from B = 51 on (kc = 512).
    Not found: B = 1 with the coefficients constant, as a model's are (with
    them as arguments it is one chain); P = 36 at any B; P = 55, 78 and 100
    below B = 51; P = 78 and 100 beyond N = 2048, WDX12's (1000, 3617) x
    (3617, 78) among them (ROADMAP queue 3, item C)."""
    if B < 2:
        return None
    if P <= 16:
        return LANES, N
    if P == 21:
        return (CHAIN, N) if B <= 50 else (LANES, N)
    if P == 55 and B >= 51:
        return CHAIN, 512
    if P in (78, 100) and B >= 51 and N <= LANES_MAX_N:
        return LANES, N
    return None


FULL_BATCH = 1000  # a minibatch of the offline run


def dot_order(B: int, N: int, P: int) -> tuple[int, int]:
    """(order, kc) that `xla_dot` and K12 sum in: XLA:CPU's where
    `xla_dot_order` knows it; else, as one fixed order for the shape, the
    one XLA:CPU takes at the same width for a full minibatch, or the lanes
    where that is not known either. The kernel and its plain version agree
    bit for bit at every shape (and stay within rtol 1e-5 of XLA's where
    the order is not its own, ROADMAP queue 3, item C)."""
    return xla_dot_order(B, N, P) or xla_dot_order(FULL_BATCH, N, P) or (LANES, N)


def xla_dot(K: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """float32 (B, N) x (N, P) product summed in `dot_order`: the bits of a
    jitted `jnp.dot` at the shapes `xla_dot_order` knows; the plain version
    of kernel K12 (csrc/svmdot.cu), its FMAs `fma`'s."""
    B, N = K.shape
    P = C.shape[1]
    mode, kc = dot_order(B, N, P)
    K = K.to(torch.float32)
    C = C.to(torch.float32)
    if mode == CHAIN:
        out = K.new_zeros((B, P))
        for lo in range(0, N, kc):
            acc = K.new_zeros((B, P))
            for k in range(lo, min(N, lo + kc)):
                acc = fma(K[:, k, None].expand(B, P), C[k].expand(B, P), acc)
            out = out + acc
        return out
    m = 4 * (N // 4)
    Kg = K[:, :m].reshape(B, m // 4, 4, 1).expand(B, m // 4, 4, P)
    Cg = C[:m].reshape(m // 4, 4, P).expand(B, m // 4, 4, P)
    lanes = K.new_zeros((B, 4, P))
    for g in range(m // 4):
        lanes = fma(Kg[:, g], Cg[:, g], lanes)
    out = (lanes[:, 0] + lanes[:, 1]) + (lanes[:, 2] + lanes[:, 3])
    tail = K.new_zeros((B, P))
    for k in range(m, N):
        tail = tail + K[:, k, None] * C[k]
    return out + tail


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


def xla_log(a: torch.Tensor) -> torch.Tensor:
    """float32 natural log with the bits of XLA:CPU's `jnp.log`
    (`xla_log_plain`); the elementwise kernel `wdx_xla_log`
    (csrc/xlalog.cu) on CUDA tensors."""
    if not _cuda.on_cuda(a):
        return xla_log_plain(a)
    x = a.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    if x.numel():
        _cuda.launch("wdx_xla_log", x.device, x.data_ptr(), out.data_ptr(), x.numel())
    return out


def xla_log_plain(a: torch.Tensor) -> torch.Tensor:
    """float32 natural log with the bits of XLA:CPU's `jnp.log`; the plain
    version of `xla_log` (any device).

    The algorithm of the kernel XLA compiles for log: range reduction to a
    mantissa m in [sqrt(1/2) - 1, sqrt(2) - 1) and an exponent e, a degree-8
    polynomial in m evaluated as three FMA chains in m**3, and
    e * ln(2) added in two parts, each multiply-add one fused multiply-add
    (`fma`, one rounding). Rounded twice instead (a float64 sum rounded to
    float32), no positive float32 input changes its result: an exhaustive
    search over all of them found none.

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
    c = x.new_tensor

    def chain(p0, p1, p2):
        return fma(fma(m, c(p0), c(p1)), m, c(p2))

    A = chain(*_LOG_P[0:3])
    B = chain(*_LOG_P[3:6])
    C = chain(*_LOG_P[6:9])
    y = fma(fma(A, x3, B), x3, C)
    t = fma(y, x3, e * _LOG_Q1)
    r = fma(e, c(_LOG_Q2), fma(x2, c(-0.5), m) + t)
    r = torch.where(x == float("inf"), x, r)
    r = torch.where((x < 0) | torch.isnan(x), torch.full_like(r, float("nan")), r)
    # zero and subnormal inputs (read as zero) give -inf, of either sign
    return torch.where(x.abs() < _TINY, torch.full_like(r, float("-inf")), r)


_EXP_P = tuple(_f32(p) for p in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1,
))
_LOG2E = _f32(1.44269504088896341)


def xla_exp(a: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """float32 exp(scale * a) with the bits of XLA:CPU's jitted
    `jnp.exp(scale * a)` (`xla_exp_plain`); kernel K16 (csrc/xlaexp.cu) on
    CUDA tensors."""
    if not _cuda.on_cuda(a):
        return xla_exp_plain(a, scale)
    x = a.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    if x.numel():
        _cuda.launch("wdx_xla_exp_scaled", x.device, x.data_ptr(), out.data_ptr(), x.numel(), float(scale))
    return out


def xla_exp_plain(a: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """float32 exp(scale * a) with the bits of XLA:CPU's jitted `jnp.exp`;
    the plain version of `xla_exp` (any device).

    The product is a float32 one, scale rounded to float32 first, as torch
    and a jitted JAX function both take a Python float times a float32
    array. Then the Cephes algorithm XLA compiles for exp, with the
    multiply-adds it contracts into FMAs (each emulated as `fma` does): the
    input clamped to [-87.8, 88.8], n = floor(fma(x, log2(e), 0.5)) clamped
    to [-126, 127], r = x - n * ln(2) in two FMAs, a degree-5 polynomial in
    r by Horner's FMAs, z = 1 + fma(poly, r * r, r), the result z * 2**n
    with subnormal results flushed to zero (XLA:CPU runs with
    flush-to-zero). NaN gives NaN, +inf +inf and -inf 0."""
    x = a.to(torch.float32) * scale
    xc = x.clamp(-87.8, 88.8)
    n = torch.floor(fma(xc, torch.full_like(xc, _LOG2E), torch.full_like(xc, 0.5))).clamp(-126.0, 127.0)
    r = fma(n, torch.full_like(n, -0.693359375), xc)
    r = fma(n, torch.full_like(n, _f32(2.12194440e-4)), r)
    z = fma(r, torch.full_like(r, _EXP_P[0]), torch.full_like(r, _EXP_P[1]))
    for p in _EXP_P[2:]:
        z = fma(z, r, torch.full_like(r, p))
    z = 1.0 + fma(z, r * r, r)
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    y = z * pow2
    y = torch.where(y < _TINY, torch.zeros_like(y), y)
    return torch.where(torch.isnan(x), x, y)


SOFTMAX_VARIANTS = {"lanes": 0, "warp": 1, "block": 2, "global": 3}  # K15's kernels (csrc/xlasoftmax.cu)


def softmax_level_floats(k: int) -> int:
    """Window sums of every level of `xla_sum`'s tree over a row of k."""
    n, d = 0, k
    while d > XLA_REDUCE_WINDOW:
        d = -(-d // XLA_REDUCE_WINDOW)
        n += d
    return n


def softmax_block_shared_bytes(k: int) -> int:
    """The block kernel's dynamic shared memory: the row's terms at their
    padded positions (33 words a window) and every level's sums."""
    return 4 * (-(-k // XLA_REDUCE_WINDOW) * 33 + softmax_level_floats(k))


def _k15_variant(k: int, variant):
    """K15's kernel for rows of k classes: a warp a row by lanes up to 32
    classes, by windows up to 1,024; a block a row beyond (its sums in
    shared memory where the row fits, else in a global workspace);
    `variant` forces one."""
    if variant not in (None, *SOFTMAX_VARIANTS):
        raise ValueError(f"xla_softmax: variant must be one of {tuple(SOFTMAX_VARIANTS)}, got {variant!r}")
    fits = softmax_block_shared_bytes(k) + 128 <= _cuda.MAX_SHARED_BYTES
    if (variant == "lanes" and k > 32) or (variant == "warp" and k > 32 * 32) or (variant == "block" and not fits):
        raise ValueError(f"xla_softmax: the {variant} kernel does not take {k} classes")
    if variant is not None:
        return variant
    if k <= 32:
        return "lanes"
    if k <= 32 * 32:
        return "warp"
    return "block" if fits else "global"


def xla_softmax(z: torch.Tensor, *, variant=None) -> torch.Tensor:
    """float32 softmax over the last dim with the bits of XLA:CPU's jitted
    `jax.nn.softmax` (`xla_softmax_plain`); kernel K15 (csrc/xlasoftmax.cu)
    on CUDA tensors, at any width (`variant` forces "lanes", "warp",
    "block" or "global")."""
    if not _cuda.on_cuda(z):
        return xla_softmax_plain(z)
    k = z.shape[-1] if z.dim() else 0
    if k < 1:
        raise ValueError(f"xla_softmax: a last dim of at least 1 wanted, got shape {tuple(z.shape)}")
    kind = _k15_variant(k, variant)
    x = z.to(torch.float32).contiguous()
    rows = x.numel() // k
    if rows >= 2**31:
        raise ValueError(f"xla_softmax: {rows} rows, K15 takes fewer than 2**31")
    out = torch.empty_like(x)
    if rows:
        stride = softmax_level_floats(k) if kind == "global" else 0
        ws = torch.empty(rows * stride, dtype=torch.float32, device=x.device) if stride else None
        _cuda.launch(
            "wdx_xla_softmax", x.device, x.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
            rows, k, SOFTMAX_VARIANTS[kind], stride,
        )
    return out


def xla_softmax_plain(z: torch.Tensor) -> torch.Tensor:
    """float32 softmax over the last dim with the bits of XLA:CPU's jitted
    `jax.nn.softmax`; the plain version of `xla_softmax` (any device).

    e = `xla_exp_plain`(z - the row max), then e / `xla_sum`(e) as an IEEE
    division, a subnormal quotient flushed to zero (XLA:CPU runs with
    flush-to-zero: a row [0, 0, 0, -87.0, -87.2] gives 0 where the
    division gives 5.49e-39). A row holding NaN gives NaN; +inf gives NaN
    (inf - inf); -inf gives 0 beside a finite value, NaN where the whole
    row is -inf: what the jitted JAX function gives
    (tests/test_torch_softmax.py)."""
    x = z.to(torch.float32)
    e = xla_exp_plain(x - x.amax(-1, keepdim=True))
    q = e / xla_sum(e)[..., None]
    return torch.where(q < _TINY, torch.zeros_like(q), q)


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
