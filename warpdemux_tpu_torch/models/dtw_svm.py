"""Batched DTW + precomputed-kernel SVM classifier.

Port of warpdemux_tpu/models/dtw_svm.py as an nn.Module whose arrays are
buffers: DTW distances against the support-vector fingerprints (kernel K1
on CUDA), the exp kernel (stored by K1 itself at pwr_dist = 1, every
shipped bundle's; K16 over the powered distances otherwise), one-vs-one
decision values, Platt + Wu-Lin probabilities and the argmax / margin /
threshold post-processing, for a whole minibatch at once.
"""

from __future__ import annotations

import torch

from warpdemux_tpu_torch.models.base import Classifier
from warpdemux_tpu_torch.ops import svm as svm_ops
from warpdemux_tpu_torch.ops.dtw import dtw_distance_matrix, dtw_kernel_matrix


class DTWSVMModel(Classifier):
    def __init__(
        self,
        X_sv: torch.Tensor,
        coef: torch.Tensor,
        intercept: torch.Tensor,
        probA: torch.Tensor,
        probB: torch.Tensor,
        label_map: torch.Tensor,
        thresholds: torch.Tensor,
        n_classes: int,
        window: int,
        penalty: float,
        gamma: float,
        pwr_dist: int,
        name: str = "",
    ):
        super().__init__(label_map, thresholds, name)
        self.register_buffer("X_sv", X_sv)  # (n_sv, m) support vectors
        self.register_buffer("coef", coef)  # (n_sv, P)
        self.register_buffer("intercept", intercept)  # (P,)
        self.register_buffer("probA", probA)
        self.register_buffer("probB", probB)
        self.n_classes = int(n_classes)
        self.window = int(window)
        self.penalty = float(penalty)
        self.gamma = float(gamma)
        self.pwr_dist = int(pwr_dist)

    @property
    def params(self) -> svm_ops.SVMParams:
        return svm_ops.SVMParams(
            self.coef, self.intercept, self.probA, self.probB, self.n_classes
        )

    @property
    def fingerprint_len(self) -> int:
        return int(self.X_sv.shape[1])

    def kernel_matrix(self, fpts: torch.Tensor) -> torch.Tensor:
        """(B, m) fingerprints -> (B, n_sv) exp(-gamma * D**pwr_dist): one
        launch of K1 at pwr_dist = 1, else K1 and K16 (`svm.pdist_kernel`)."""
        if self.pwr_dist == 1:
            return dtw_kernel_matrix(fpts, self.X_sv, self.window, self.penalty, self.gamma)
        D = dtw_distance_matrix(fpts, self.X_sv, self.window, self.penalty)
        return svm_ops.pdist_kernel(D, self.gamma, self.pwr_dist)

    def forward(self, fpts: torch.Tensor):
        """(B, m) fingerprints -> (pred (B,) int32, conf (B,), probs (B, k))."""
        K = self.kernel_matrix(fpts)
        probs = svm_ops.predict_proba(K, self.params)
        pred, conf = svm_ops.process_probs(probs, self.label_map, self.thresholds)
        return pred, conf, probs
