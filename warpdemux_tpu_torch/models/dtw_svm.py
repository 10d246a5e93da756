"""Batched DTW + precomputed-kernel SVM classifier.

Port of warpdemux_tpu/models/dtw_svm.py as an nn.Module whose arrays are
buffers: DTW distances against the support-vector fingerprints (kernel K1
on CUDA), the exp kernel, one-vs-one decision values, Platt + Wu-Lin
probabilities and the argmax / margin / threshold post-processing, for a
whole minibatch at once.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from warpdemux_tpu_torch.ops import svm as svm_ops
from warpdemux_tpu_torch.ops.dtw import dtw_distance_matrix


class DTWSVMModel(nn.Module):
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
        super().__init__()
        self.register_buffer("X_sv", X_sv)  # (n_sv, m) support vectors
        self.register_buffer("coef", coef)  # (n_sv, P)
        self.register_buffer("intercept", intercept)  # (P,)
        self.register_buffer("probA", probA)
        self.register_buffer("probB", probB)
        self.register_buffer("label_map", label_map)  # (k,) int32
        # the labels on the host, read once: a table built on another thread
        # never waits for the device
        self.label_values = label_map.cpu().numpy()
        self.register_buffer("thresholds", thresholds)  # (k,)
        self.n_classes = int(n_classes)
        self.window = int(window)
        self.penalty = float(penalty)
        self.gamma = float(gamma)
        self.pwr_dist = int(pwr_dist)
        self.name = name

    @property
    def params(self) -> svm_ops.SVMParams:
        return svm_ops.SVMParams(
            self.coef, self.intercept, self.probA, self.probB, self.n_classes
        )

    @property
    def fingerprint_len(self) -> int:
        return int(self.X_sv.shape[1])

    def forward(self, fpts: torch.Tensor):
        """(B, m) fingerprints -> (pred (B,) int32, conf (B,), probs (B, k))."""
        D = dtw_distance_matrix(fpts, self.X_sv, self.window, self.penalty)
        K = svm_ops.pdist_kernel(D, self.gamma, self.pwr_dist)
        probs = svm_ops.predict_proba(K, self.params)
        pred, conf = svm_ops.process_probs(probs, self.label_map, self.thresholds)
        return pred, conf, probs

    def predict(self, fpts) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Classify numpy fingerprints on the model's device; returns numpy
        (pred_labels, confidence, probs), as the JAX model's `predict`."""
        fpts = torch.as_tensor(np.asarray(fpts, np.float32), device=self.X_sv.device)
        if fpts.ndim == 1:
            fpts = fpts[None]
        pred, conf, probs = self(fpts)
        return pred.cpu().numpy(), conf.cpu().numpy(), probs.cpu().numpy()

    def predictions_to_table(self, read_ids, pred, conf, probs):
        """The prediction table of the JAX model's `predictions_to_df`
        (numpy inputs): #read_id, predicted_barcode, confidence_score
        rounded to 3 decimals, p{label:02d} rounded to 4, as a Table."""
        from warpdemux_tpu_torch.io.writers import Table

        cols = {
            "#read_id": read_ids,
            "predicted_barcode": pred,
            "confidence_score": np.round(conf, 3),
        }
        for i in range(probs.shape[1]):
            cols[f"p{self.label_values[i]:02d}"] = np.round(probs[:, i], 4)
        return Table(cols)
