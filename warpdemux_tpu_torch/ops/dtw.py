"""Banded DTW distance matrices with dtaidistance-2.3.13 semantics.

Port of warpdemux_tpu/ops/dtw.py. Every query fingerprint (length m = 25)
is compared with every reference fingerprint of the model:

- local cost d(i, j) = (s1[i] - s2[j])**2,
- D[i+1, j+1] = d(i, j) + min(D[i, j], D[i, j+1] + p, D[i+1, j] + p)
  with p = penalty**2, D[0, 0] = 0 and +inf elsewhere,
- Sakoe-Chiba band |i - j| <= window - 1 (equal lengths),
- result sqrt(D[m, m]).

CUDA tensors go to kernel K1 (csrc/dtw.cu: a block per tile of references
by queries, a thread per reference; a fully unrolled instance in registers
for m = 25, window = 15, and at any other shape the wide kernel, each row's
band in a loop, its DP rows in shared memory or in a global workspace); CPU tensors go to the plain
anti-diagonal wavefront, the same recurrence as the jnp version. Each cell
is one fused multiply-add, (q_i - r_j)^2 + best, rounded once, as XLA:CPU
contracts it; the minimum propagates NaN; the final square root is
correctly rounded.

`dtw_kernel_matrix` gives the SVM's kernel matrix exp(-gamma * D) of the
same distances (pwr_dist = 1, every shipped bundle's), K1 storing XLA's
exp (K16's element, csrc/common.cuh `wdx_xla_exp_scaled1`) in place of D:
one launch, and no (B, N) pass of its own.

`distance_matrix_to` is the reference's drop-in (numpy in, numpy out);
`dtw_distance_ref` / `dtw_distance_matrix_ref` the scalar float64 golden
reference of the same recurrence.
"""

from __future__ import annotations

import numpy as np
import torch

from warpdemux_tpu_torch import _cuda
from warpdemux_tpu_torch.ops.numerics import exact_sqrt, fma, xla_exp_plain


def dtw_distance_ref(s1: np.ndarray, s2: np.ndarray, window: int, penalty: float) -> float:
    """Scalar golden-reference banded DTW (numpy, float64)."""
    r, c = len(s1), len(s2)
    p = penalty * penalty
    D = np.full((r + 1, c + 1), np.inf)
    D[0, 0] = 0.0
    for i in range(r):
        for j in range(max(0, i - max(0, r - c) - window + 1), min(c, i + max(0, c - r) + window)):
            D[i + 1, j + 1] = (s1[i] - s2[j]) ** 2 + min(D[i, j], D[i, j + 1] + p, D[i + 1, j] + p)
    return float(np.sqrt(D[r, c]))


def dtw_distance_matrix_ref(X: np.ndarray, Y: np.ndarray, window: int, penalty: float) -> np.ndarray:
    """Golden-reference cross distance matrix (numpy float64, slow)."""
    return np.array([[dtw_distance_ref(x, y, window, penalty) for y in Y] for x in X], np.float64).reshape(len(X), len(Y))


# bytes of one block of query rows' (rows, N, m) float64 intermediates in
# the plain version on the CPU: a block's ~15 passes a diagonal then run
# from cache rather than from memory (the tRNA trainer's Gram matrix is
# 713 x 713); each cell is computed as without blocks. On the GPU the passes
# stream through device memory either way, and every block would add its
# launches: one block there.
PLAIN_BLOCK_BYTES = 8 << 20


def dtw_distance_matrix_plain(
    X: torch.Tensor, Y: torch.Tensor, window: int = 15, penalty: float = 0.1
) -> torch.Tensor:
    """(B, m) x (N, m) -> (B, N) distances, anti-diagonal wavefront (on the
    CPU in blocks of query rows)."""
    if X.shape[1] != Y.shape[1]:
        raise ValueError("query and reference fingerprints must have equal length")
    rows = max(1, PLAIN_BLOCK_BYTES // (8 * max(1, Y.shape[0] * Y.shape[1])))
    if X.shape[0] <= rows or X.device.type != "cpu":
        return _wavefront(X, Y, window, penalty)
    return torch.cat([_wavefront(X[i : i + rows], Y, window, penalty) for i in range(0, X.shape[0], rows)])


def _wavefront(X: torch.Tensor, Y: torch.Tensor, window: int, penalty: float) -> torch.Tensor:
    B, m = X.shape
    N = Y.shape[0]
    dev, dtype = X.device, X.dtype
    p = torch.tensor(penalty * penalty, dtype=dtype, device=dev)
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    iarr = torch.arange(m, device=dev)  # cell index along a diagonal == i
    Xb = X[:, None, :]  # (B, 1, m)

    def shift_i(a):  # a[..., i-1] with +inf shifted into i = 0
        return torch.cat([inf.expand(a.shape[:-1] + (1,)), a[..., :-1]], dim=-1)

    d2 = inf.expand(B, N, m)  # diagonal k-2
    d1 = inf.expand(B, N, m)  # diagonal k-1
    for k in range(2 * m - 1):
        j = k - iarr
        j_ok = (j >= 0) & (j < m)
        jc = j.clamp(0, m - 1)
        diff = Xb - Y[:, jc][None]  # (B, N, m): q[i] - r[k - i]
        valid = j_ok & ((iarr - jc).abs() <= window - 1) & (iarr <= min(k, m - 1))
        up = shift_i(d1) + p  # (i-1, j)
        left = d1 + p  # (i, j-1)
        best = torch.minimum(up, left)
        if k > 0:
            best = torch.minimum(shift_i(d2), best)  # (i-1, j-1)
        else:
            best = torch.minimum(torch.zeros_like(best), best)  # D[0, 0] = 0
        d2, d1 = d1, torch.where(valid, fma(diff, diff, best), inf)
    return exact_sqrt(d1[..., m - 1])


VARIANTS = {"registers": 0, "shared": 1, "global": 2}  # K1's kernels (csrc/dtw.cu)
QUERIES_A_TILE = 3  # WDX_DTW_TQ
WORKSPACE_BYTES = 256 << 20  # the global variant's DP rows, at most (one block's at least)
GLOBAL_THREADS = 128


def wide_threads(m: int) -> int:
    """Threads a block of the wide kernel in shared memory at fingerprints of
    m (128, 64 or 32: the most whose references, queries and DP rows fit),
    or 0 where even 32 do not."""
    for threads in (128, 64, 32):
        if 4 * (threads * (m | 1) + QUERIES_A_TILE * m + threads * (m + 1)) <= _cuda.MAX_SHARED_BYTES:
            return threads
    return 0


REGISTER_SHAPE = (25, 15)  # (m, window) of the register kernel: every shipped model's


def _k1_variant(m: int, window: int, variant):
    """K1's kernel at fingerprints of m in a band of `window`: the register
    kernel at REGISTER_SHAPE, else the wide kernel in shared memory where a
    block of 32 fits, else in a global workspace; `variant` forces one.
    ValueError for an unknown name or a forced kernel that does not take
    the shape."""
    if variant not in (None, *VARIANTS):
        raise ValueError(f"dtw: variant must be one of {tuple(VARIANTS)}, got {variant!r}")
    if variant == "registers" and (m, window) != REGISTER_SHAPE:
        raise ValueError(f"dtw: the register kernel takes (m, window) = {REGISTER_SHAPE} alone, got ({m}, {window})")
    if variant == "shared" and not wide_threads(m):
        raise ValueError(f"dtw: fingerprints of {m} do not fit the shared-memory kernel")
    if variant is not None:
        return variant
    if (m, window) == REGISTER_SHAPE:
        return "registers"
    return "shared" if wide_threads(m) else "global"


def dtw_distance_matrix(
    X: torch.Tensor, Y: torch.Tensor, window: int = 15, penalty: float = 0.1, *, variant=None
) -> torch.Tensor:
    """Cross DTW distance matrix; K1 on CUDA tensors (any m >= 1 and any
    window: the register kernel at m = 25, window = 15, the wide kernel at
    every other shape; `variant` forces "registers", "shared" or "global"),
    plain on CPU ones."""
    if not _cuda.on_cuda(X, Y):
        return dtw_distance_matrix_plain(X, Y, window, penalty)
    return _k1(X, Y, window, penalty, variant, None)


def dtw_kernel_matrix_plain(X, Y, window: int, penalty: float, gamma: float) -> torch.Tensor:
    """The plain version of `dtw_kernel_matrix` (any device)."""
    return xla_exp_plain(dtw_distance_matrix_plain(X, Y, window, penalty), -gamma)


def dtw_kernel_matrix(X, Y, window: int, penalty: float, gamma: float, *, variant=None) -> torch.Tensor:
    """The SVM's kernel matrix exp(-gamma * D) of the DTW distances, with
    the bits of `svm.pdist_kernel(dtw_distance_matrix(...), gamma)`: on
    CUDA tensors one launch of K1, which stores XLA's exp where it would
    store D (`variant` as in `dtw_distance_matrix`); plain on CPU ones."""
    if not _cuda.on_cuda(X, Y):
        return dtw_kernel_matrix_plain(X, Y, window, penalty, gamma)
    return _k1(X, Y, window, penalty, variant, -gamma)


def _k1(X, Y, window, penalty, variant, exp_scale):
    """One launch of K1 on CUDA tensors: the distances, or exp(exp_scale *
    D) where exp_scale is not None."""
    B, m = X.shape
    N = Y.shape[0]
    if Y.shape[1] != m or m < 1:
        raise ValueError(f"dtw: fingerprints of equal length >= 1 wanted, got {tuple(X.shape)} and {tuple(Y.shape)}")
    kind = _k1_variant(m, int(window), variant)
    X, Y = X.contiguous(), Y.contiguous()
    _cuda.check(X, torch.float32, 2, "dtw X")
    _cuda.check(Y, torch.float32, 2, "dtw Y")
    out = torch.empty((B, N), dtype=torch.float32, device=X.device)
    threads, slots, ws = 0, 0, None
    if kind == "shared":
        threads = wide_threads(m)
    elif kind == "global":
        threads = GLOBAL_THREADS
        tiles = -(-B // QUERIES_A_TILE) * -(-N // threads)
        slots = max(1, min(tiles, WORKSPACE_BYTES // (4 * threads * (m + 1))))
        ws = torch.empty(slots * threads * (m + 1), dtype=torch.float32, device=X.device)
    _cuda.launch(
        "wdx_dtw", X.device, X.data_ptr(), Y.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
        B, N, m, int(window), float(penalty * penalty), VARIANTS[kind], threads, slots,
        exp_scale is not None, 0.0 if exp_scale is None else float(exp_scale),
    )
    return out


def distance_matrix_to(X, Y, window: int = 15, penalty: float = 0.1, block_size=None, n_jobs=None,
                       device=None, **_ignored) -> np.ndarray:
    """The reference's `distance_matrix_to` (warpdemux/parallel_distances.py):
    the (len(X), len(Y)) float32 banded DTW distances as a numpy array. One
    launch of K1 on the card unless `device` names another ("cpu": the
    plain version); block_size and n_jobs are taken for the reference's
    signature and not used."""
    dev = _cuda.resolve_device(device)
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return dtw_distance_matrix(as_t(X), as_t(Y), window, penalty).cpu().numpy()
