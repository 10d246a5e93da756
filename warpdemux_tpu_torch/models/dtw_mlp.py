"""Batched DTW + MLP classifier (the DTW-MLP family).

Port of warpdemux_tpu/models/dtw_mlp.py as an nn.Module whose arrays are
buffers: DTW distances against the reference fingerprints (kernel K1 on
CUDA), an optional standard scaling, ReLU hidden layers, a softmax output
(sklearn MLPClassifier.predict_proba with k >= 2 classes) and the argmax /
margin / threshold post-processing. The products are summed as XLA:CPU's
jitted `h @ W + b` sums them where that order is known, each layer one
launch of kernel K12 on CUDA (`ops/svm.dot_bias`); the softmax is
jax.nn.softmax's bits, one launch of kernel K15 (`numerics.xla_softmax`).
"""

from __future__ import annotations

import torch

from warpdemux_tpu_torch.models.base import Classifier
from warpdemux_tpu_torch.ops import numerics
from warpdemux_tpu_torch.ops import svm as svm_ops
from warpdemux_tpu_torch.ops.dtw import dtw_distance_matrix


def mlp_logits(D, weights, biases, scaler_mean=None, scaler_scale=None) -> torch.Tensor:
    """(B, n_ref) distances -> (B, k) output-layer pre-activations: the
    optional scaling, then each layer's product and bias, ReLU between."""
    h = D
    if scaler_mean is not None:
        # the jitted JAX model divides by its constant scale as XLA rewrites
        # it: a multiply by the float32 reciprocal
        h = (h - scaler_mean[None, :]) * (1.0 / scaler_scale)[None, :]
    for i, (W, b) in enumerate(zip(weights, biases)):
        h = svm_ops.dot_bias(h, W, b)
        if i < len(weights) - 1:
            h = torch.relu(h)
    return h


def mlp_predict_proba(D, weights, biases, scaler_mean=None, scaler_scale=None) -> torch.Tensor:
    """(B, n_ref) distances -> (B, k) class probabilities: ReLU hidden
    layers, XLA's softmax output."""
    return numerics.xla_softmax(mlp_logits(D, weights, biases, scaler_mean, scaler_scale))


class DTWMLPModel(Classifier):
    def __init__(
        self,
        X_ref: torch.Tensor,
        weights: list[torch.Tensor],
        biases: list[torch.Tensor],
        scaler_mean: torch.Tensor | None,
        scaler_scale: torch.Tensor | None,
        label_map: torch.Tensor,
        thresholds: torch.Tensor,
        window: int,
        penalty: float,
        name: str = "",
    ):
        super().__init__(label_map, thresholds, name)
        self.register_buffer("X_ref", X_ref)  # (n_ref, m) reference fingerprints
        self.n_layers = len(weights)
        for i, (W, b) in enumerate(zip(weights, biases)):
            self.register_buffer(f"w{i}", W)  # (in, out)
            self.register_buffer(f"b{i}", b)
        self.register_buffer("scaler_mean", scaler_mean)
        self.register_buffer("scaler_scale", scaler_scale)
        self.n_classes = int(weights[-1].shape[1])
        self.window = int(window)
        self.penalty = float(penalty)

    @property
    def fingerprint_len(self) -> int:
        return int(self.X_ref.shape[1])

    def layers(self):
        """(weights, biases) of the MLP, input layer first."""
        return (
            [getattr(self, f"w{i}") for i in range(self.n_layers)],
            [getattr(self, f"b{i}") for i in range(self.n_layers)],
        )

    def forward(self, fpts: torch.Tensor):
        """(B, m) fingerprints -> (pred (B,) int32, conf (B,), probs (B, k))."""
        D = dtw_distance_matrix(fpts, self.X_ref, self.window, self.penalty)
        probs = mlp_predict_proba(D, *self.layers(), self.scaler_mean, self.scaler_scale)
        pred, conf = svm_ops.process_probs(probs, self.label_map, self.thresholds)
        return pred, conf, probs
