"""Precomputed-kernel SVC inference (libsvm predict_proba) in PyTorch.

Port of warpdemux_tpu/ops/svm.py:

- kernel K = exp(-gamma * D**pwr_dist) over DTW distances, with XLA:CPU's
  exp (`numerics.xla_exp`),
- one-vs-one decision values: one (B, n_SV) x (n_SV, n_pairs) product
  against a coefficient matrix assembled from libsvm's dual coefficients,
  summed in the order of the jitted JAX product where that order is known,
  in one fixed order elsewhere (`numerics.xla_dot`; kernel K12,
  csrc/svmdot.cu, on CUDA),
- libsvm's sigmoid_predict Platt calibration with the 1e-7 clamp, then
  libsvm's multiclass_probability (Wu & Lin 2004, method 2): Gauss-Seidel
  with eps = 0.005 / k and max(100, k) iterations, batched with
  per-sample convergence freezing, in the float32 operations of the jitted
  JAX function (bit for bit up to seven classes); kernel K13,
  csrc/svmprob.cu, on CUDA, one thread a row,
- argmax -> label map -> threshold-to-noise (-1) post-processing.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from warpdemux_tpu_torch import _cuda
from warpdemux_tpu_torch.ops import numerics


class SVMParams(NamedTuple):
    """A trained one-vs-one probability SVC: n_sv support vectors, k
    classes, P = k*(k-1)/2 class pairs."""

    coef: torch.Tensor  # (n_sv, P) per-pair dual coefficients
    intercept: torch.Tensor  # (P,)
    probA: torch.Tensor  # (P,) Platt slope
    probB: torch.Tensor  # (P,) Platt offset
    n_classes: int


def pair_index(k: int) -> list[tuple[int, int]]:
    """libsvm pair enumeration order: (0,1), (0,2), ..., (k-2,k-1)."""
    return [(i, j) for i in range(k) for j in range(i + 1, k)]


def build_pair_coef(dual_coef: np.ndarray, n_support: np.ndarray) -> np.ndarray:
    """Assemble the (n_sv, P) per-pair coefficient matrix.

    libsvm stores dual_coef as (k-1, n_sv). For pair p = (i, j): SVs of
    class i contribute dual_coef[j-1], SVs of class j contribute dual_coef[i].
    """
    k = len(n_support)
    n_sv = int(np.sum(n_support))
    starts = np.concatenate([[0], np.cumsum(n_support)]).astype(int)
    C = np.zeros((n_sv, k * (k - 1) // 2), dual_coef.dtype)
    for p, (i, j) in enumerate(pair_index(k)):
        si, ei = starts[i], starts[i + 1]
        sj, ej = starts[j], starts[j + 1]
        C[si:ei, p] = dual_coef[j - 1, si:ei]
        C[sj:ej, p] = dual_coef[i, sj:ej]
    return C


def pdist_kernel(D: torch.Tensor, gamma: float = 1.0, pwr_dist: int = 1):
    """K = exp(-gamma * D**pwr_dist), XLA:CPU's exp."""
    Dp = D if pwr_dist == 1 else D**pwr_dist
    return numerics.xla_exp(-gamma * Dp)


def decision_values_plain(K_sv: torch.Tensor, params: SVMParams) -> torch.Tensor:
    """The plain version of `decision_values` (any device)."""
    return numerics.xla_dot(K_sv, params.coef) + params.intercept


def decision_values(K_sv: torch.Tensor, params: SVMParams) -> torch.Tensor:
    """(B, P) one-vs-one decision values from the kernel vs support vectors,
    summed in `numerics.dot_order`; K12 on CUDA."""
    if not _cuda.on_cuda(K_sv, params.coef, params.intercept):
        return decision_values_plain(K_sv, params)
    B, N = K_sv.shape
    P = params.coef.shape[1]
    K_sv = K_sv.contiguous()
    coef = params.coef.contiguous()
    intercept = params.intercept.contiguous()
    _cuda.check(K_sv, torch.float32, 2, "svm_dot K_sv")
    _cuda.check(coef, torch.float32, 2, "svm_dot coef")
    _cuda.check(intercept, torch.float32, 1, "svm_dot intercept")
    if coef.shape[0] != N or intercept.shape[0] != P:
        raise ValueError(f"svm_dot: coef {tuple(coef.shape)} / intercept {tuple(intercept.shape)} for K_sv {(B, N)}")
    out = torch.empty((B, P), dtype=torch.float32, device=K_sv.device)
    if B:
        mode, kc = numerics.dot_order(B, N, P)
        _cuda.launch(
            "wdx_svm_dot", K_sv.device, K_sv.data_ptr(), coef.data_ptr(), intercept.data_ptr(),
            out.data_ptr(), B, N, P, mode, kc,
        )
    return out


def sigmoid_predict(dec, A, B):
    """libsvm sigmoid_predict: numerically stable 1 / (1 + exp(dec*A + B)),
    with the FMA and the exp of the jitted JAX function."""
    fApB = numerics.fma(dec, A.expand_as(dec), B.expand_as(dec))
    efa = numerics.xla_exp(-fApB.abs())
    return torch.where(fApB >= 0, efa / (1.0 + efa), 1.0 / (1.0 + efa))


def xla_vector_rows(B: int) -> int:
    """How many leading rows of a batch of B the jitted JAX coupling sums
    p Q p for in vectors (rounded products added in order); the rows after
    them run XLA:CPU's scalar loop, where the sum is an FMA chain. Read off
    jax 0.9.0's XLA:CPU (tests/test_torch_svm_dot.py): vectors of 8 rows
    from B = 48, of 4 rows from B = 16, below that vectors only at B = 4
    and 8."""
    if B >= 48:
        return B - B % 8
    if B >= 16:
        return B - B % 4
    return B if B in (4, 8) else 0


def _p_dot(p: torch.Tensor, Qp: torch.Tensor) -> torch.Tensor:
    """(B,) sums of p * Qp over k as the jitted JAX function sums them
    (`xla_vector_rows`)."""
    B, k = p.shape
    out = numerics.xla_sum(p * Qp)
    start = xla_vector_rows(B)
    if start < B:
        acc = out.new_zeros(B - start)
        for j in range(k):
            acc = numerics.fma(p[start:, j], Qp[start:, j], acc)
        out = torch.cat([out[:start], acc])
    return out


def multiclass_probability(r: torch.Tensor, k: int) -> torch.Tensor:
    """libsvm multiclass_probability, batched.

    r: (B, k, k) pairwise probabilities, r[b, i, j] = P(i | i or j, x_b).
    Returns (B, k) class probabilities, with the float32 operations of the
    jitted JAX function: Q p as an FMA chain over j from 0, the sums p Q p
    (`_p_dot`) and Q's diagonal in XLA's order, and the multiply-adds of the
    update contracted into FMAs where XLA:CPU contracts them.
    """
    B = r.shape[0]
    max_iter = max(100, k)
    eps = 0.005 / k
    rT = r.transpose(1, 2)
    off_eye = 1 - torch.eye(k, dtype=r.dtype, device=r.device)
    # Q[t][t] = sum_{j != t} r[j][t]^2 ; Q[t][j] = -r[j][t] * r[t][j]
    Q = (-rT * r) * off_eye
    Q = Q + torch.diag_embed(numerics.xla_sum((rT * rT) * off_eye))
    p = torch.full((B, k), 1.0 / k, dtype=r.dtype, device=r.device)
    Qtt = Q.diagonal(dim1=1, dim2=2)
    for _ in range(max_iter):
        # libsvm recomputes Qp/pQp from scratch at each loop head
        Qp = torch.zeros_like(p)
        for j in range(k):
            Qp = numerics.fma(Q[:, :, j], p[:, j, None].expand(B, k), Qp)
        pQp = _p_dot(p, Qp)
        active = (Qp - pQp[:, None]).abs().amax(1) >= eps
        if not bool(active.any()):
            break
        for t in range(k):
            diff = (-Qp[:, t] + pQp) / Qtt[:, t]
            diff = torch.where(active, diff, torch.zeros_like(diff))
            p = p.clone()
            p[:, t] = p[:, t] + diff
            inner = numerics.fma(diff, Qtt[:, t], 2.0 * Qp[:, t])
            pQp = numerics.fma(diff, inner, pQp) / ((1.0 + diff) * (1.0 + diff))
            Qp = numerics.fma(diff[:, None].expand(B, k), Q[:, t, :], Qp) / (1.0 + diff)[:, None]
            p = p / (1.0 + diff)[:, None]
    return p


def probabilities_plain(dec: torch.Tensor, params: SVMParams, min_prob: float = 1e-7) -> torch.Tensor:
    """The plain version of `probabilities` (any device)."""
    k = params.n_classes
    rp = sigmoid_predict(dec, params.probA, params.probB)
    rp = rp.clamp(min_prob, 1.0 - min_prob)
    pairs = pair_index(k)
    iidx = torch.tensor([i for i, _ in pairs], device=dec.device)
    jidx = torch.tensor([j for _, j in pairs], device=dec.device)
    r = torch.zeros((dec.shape[0], k, k), dtype=rp.dtype, device=dec.device)
    r[:, iidx, jidx] = rp
    r[:, jidx, iidx] = 1.0 - rp
    return multiclass_probability(r, k)


MAX_CLASSES = 16  # K13 keeps a row's k x k matrix in its thread


def probabilities(dec: torch.Tensor, params: SVMParams, min_prob: float = 1e-7) -> torch.Tensor:
    """(B, P) decision values -> (B, k) probabilities: Platt sigmoid, clamp,
    Wu-Lin coupling; K13 (csrc/svmprob.cu) on CUDA."""
    k = params.n_classes
    B = dec.shape[0]
    if not _cuda.on_cuda(dec, params.probA, params.probB):
        return probabilities_plain(dec, params, min_prob)
    if not 2 <= k <= MAX_CLASSES or dec.shape[1] != k * (k - 1) // 2:
        raise ValueError(f"svm_probs: {k} classes with decision values of shape {tuple(dec.shape)}")
    dec = dec.contiguous()
    probA = params.probA.contiguous()
    probB = params.probB.contiguous()
    _cuda.check(dec, torch.float32, 2, "svm_probs dec")
    _cuda.check(probA, torch.float32, 1, "svm_probs probA")
    _cuda.check(probB, torch.float32, 1, "svm_probs probB")
    out = torch.empty((B, k), dtype=torch.float32, device=dec.device)
    if B:
        _cuda.launch(
            "wdx_svm_probs", dec.device, dec.data_ptr(), probA.data_ptr(), probB.data_ptr(),
            out.data_ptr(), B, k, min_prob, 1.0 - min_prob, 0.005 / k, max(100, k), xla_vector_rows(B),
        )
    return out


def predict_proba(
    K_sv: torch.Tensor, params: SVMParams, min_prob: float = 1e-7
) -> torch.Tensor:
    """libsvm svm_predict_probability over a batch of kernel rows:
    (B, n_sv) -> (B, k) probabilities in classes_ order."""
    return probabilities(decision_values(K_sv, params), params, min_prob)


def confidence_margin(probs: torch.Tensor) -> torch.Tensor:
    """top1 - top2 probability."""
    top2 = torch.topk(probs, 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def process_probs(probs, label_map, thresholds):
    """argmax -> label map -> threshold-to-noise (-1).

    Returns (pred labels (B,) int32, conf (B,))."""
    pred_idx = torch.argmax(probs, dim=1)  # first maximum, as jnp.argmax
    pred = label_map[pred_idx]
    conf = confidence_margin(probs)
    if thresholds is not None:
        pred = torch.where(
            conf < thresholds[pred_idx], torch.full_like(pred, -1), pred
        )
    return pred.to(torch.int32), conf
