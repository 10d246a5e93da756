"""Fingerprint -> oblivious-forest classifier (the Fpt-Boost family).

Port of warpdemux_tpu/models/fpt_boost.py as an nn.Module whose arrays are
buffers. A catboost multiclass model is an ensemble of oblivious trees:
each level of a tree tests one (feature, threshold) pair, so a depth-d tree
is d split conditions and 2^d leaf vectors, and a sample's leaf is the
d-bit word of its split outcomes (bit j from level j). For (B, m)
fingerprints and T trees:

    bits   = x[:, feat] > thr              (B, T, d)
    leaf   = sum_j bits[..., j] << j       (B, T)
    scores = sum_t leaf_values[t, leaf_t]  (B, k)
    probs  = softmax(scores + bias)

The sum over trees takes XLA's order (`numerics.xla_sum` over T): bit for
bit the jitted JAX function's scores for T > 32 trees. For 32 or fewer,
XLA:CPU sums in an order not found; the scores there differ from JAX's in
the last bits (probabilities within rtol 1e-5, atol 1e-6). The softmax is
jax.nn.softmax's bits (`numerics.xla_softmax`, kernel K15 on CUDA), so
above 32 trees the probabilities and confidences are the JAX model's.
"""

from __future__ import annotations

import torch

from warpdemux_tpu_torch.models.base import Classifier
from warpdemux_tpu_torch.ops import svm as svm_ops
from warpdemux_tpu_torch.ops.numerics import xla_softmax, xla_sum


def oblivious_forest_scores(x, feat, thr, leaf_values) -> torch.Tensor:
    """Raw class scores of an oblivious-tree ensemble: x (B, m), feat
    (T, d) int, thr (T, d), leaf_values (T, 2^d, k) -> (B, k)."""
    T, d = feat.shape
    xv = x[:, feat.reshape(-1).long()].reshape(x.shape[0], T, d)
    bits = (xv > thr[None]).to(torch.int64)
    leaf = (bits << torch.arange(d, device=x.device)).sum(-1)  # (B, T)
    trees = torch.arange(T, device=x.device)[None, :]
    vals = leaf_values[trees, leaf]  # (B, T, k)
    return xla_sum(vals.transpose(1, 2))


class FptBoostModel(Classifier):
    def __init__(
        self,
        feat: torch.Tensor,
        thr: torch.Tensor,
        leaf_values: torch.Tensor,
        bias: torch.Tensor,
        label_map: torch.Tensor,
        thresholds: torch.Tensor,
        fingerprint_len: int,
        name: str = "",
    ):
        super().__init__(label_map, thresholds, name)
        self.register_buffer("feat", feat)  # (T, d) int32
        self.register_buffer("thr", thr)  # (T, d)
        self.register_buffer("leaf_values", leaf_values)  # (T, 2^d, k)
        self.register_buffer("bias", bias)  # (k,)
        self.n_classes = int(leaf_values.shape[-1])
        self._fingerprint_len = int(fingerprint_len)

    @property
    def fingerprint_len(self) -> int:
        return self._fingerprint_len

    def forward(self, fpts: torch.Tensor):
        """(B, m) fingerprints -> (pred (B,) int32, conf (B,), probs (B, k))."""
        scores = oblivious_forest_scores(fpts, self.feat, self.thr, self.leaf_values) + self.bias
        probs = xla_softmax(scores)
        pred, conf = svm_ops.process_probs(probs, self.label_map, self.thresholds)
        return pred, conf, probs
