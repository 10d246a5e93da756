"""Precomputed-kernel SVC inference (libsvm predict_proba) in PyTorch.

Port of warpdemux_tpu/ops/svm.py:

- kernel K = exp(-gamma * D**pwr_dist) over DTW distances,
- one-vs-one decision values: one (B, n_SV) x (n_SV, n_pairs) torch.matmul
  against a coefficient matrix assembled from libsvm's dual coefficients,
- libsvm's sigmoid_predict Platt calibration with the 1e-7 clamp,
- libsvm's multiclass_probability (Wu & Lin 2004, method 2): Gauss-Seidel
  with eps = 0.005 / k and max(100, k) iterations, batched with
  per-sample convergence freezing so every row matches a one-row solve,
- argmax -> label map -> threshold-to-noise (-1) post-processing.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


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
    """K = exp(-gamma * D**pwr_dist)."""
    Dp = D if pwr_dist == 1 else D**pwr_dist
    return torch.exp(-gamma * Dp)


def decision_values(K_sv: torch.Tensor, params: SVMParams) -> torch.Tensor:
    """(B, P) one-vs-one decision values from the kernel vs support vectors."""
    return torch.matmul(K_sv, params.coef) + params.intercept


def sigmoid_predict(dec, A, B):
    """libsvm sigmoid_predict: numerically stable 1 / (1 + exp(dec*A + B))."""
    fApB = dec * A + B
    efa = torch.exp(-fApB.abs())
    return torch.where(fApB >= 0, efa / (1.0 + efa), 1.0 / (1.0 + efa))


def multiclass_probability(r: torch.Tensor, k: int) -> torch.Tensor:
    """libsvm multiclass_probability, batched.

    r: (B, k, k) pairwise probabilities, r[b, i, j] = P(i | i or j, x_b).
    Returns (B, k) class probabilities.
    """
    B = r.shape[0]
    max_iter = max(100, k)
    eps = 0.005 / k
    rT = r.transpose(1, 2)
    off_eye = 1 - torch.eye(k, dtype=r.dtype, device=r.device)
    # Q[t][t] = sum_{j != t} r[j][t]^2 ; Q[t][j] = -r[j][t] * r[t][j]
    Q = (-rT * r) * off_eye
    Q = Q + torch.diag_embed(((rT * rT) * off_eye).sum(2))
    p = torch.full((B, k), 1.0 / k, dtype=r.dtype, device=r.device)
    Qtt = Q.diagonal(dim1=1, dim2=2)
    for _ in range(max_iter):
        # libsvm recomputes Qp/pQp from scratch at each loop head
        Qp = torch.matmul(Q, p[:, :, None])[:, :, 0]
        pQp = (p * Qp).sum(1)
        active = (Qp - pQp[:, None]).abs().amax(1) >= eps
        if not bool(active.any()):
            break
        for t in range(k):
            diff = (-Qp[:, t] + pQp) / Qtt[:, t]
            diff = torch.where(active, diff, torch.zeros_like(diff))
            p = p.clone()
            p[:, t] = p[:, t] + diff
            pQp = (pQp + diff * (diff * Qtt[:, t] + 2.0 * Qp[:, t])) / (
                (1.0 + diff) * (1.0 + diff)
            )
            Qp = (Qp + diff[:, None] * Q[:, t, :]) / (1.0 + diff)[:, None]
            p = p / (1.0 + diff)[:, None]
    return p


def predict_proba(
    K_sv: torch.Tensor, params: SVMParams, min_prob: float = 1e-7
) -> torch.Tensor:
    """libsvm svm_predict_probability over a batch of kernel rows:
    (B, n_sv) -> (B, k) probabilities in classes_ order."""
    k = params.n_classes
    dec = decision_values(K_sv, params)
    rp = sigmoid_predict(dec, params.probA, params.probB)
    rp = rp.clamp(min_prob, 1.0 - min_prob)
    pairs = pair_index(k)
    iidx = torch.tensor([i for i, _ in pairs], device=K_sv.device)
    jidx = torch.tensor([j for _, j in pairs], device=K_sv.device)
    r = torch.zeros((K_sv.shape[0], k, k), dtype=rp.dtype, device=K_sv.device)
    r[:, iidx, jidx] = rp
    r[:, jidx, iidx] = 1.0 - rp
    return multiclass_probability(r, k)


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
