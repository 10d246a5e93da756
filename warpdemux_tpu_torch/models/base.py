"""The classifier surface the three model families share.

Each family (models/dtw_svm.py, dtw_mlp.py, fpt_boost.py) is an nn.Module
whose arrays are buffers and whose `forward` maps (B, m) fingerprints to
(pred (B,) int32, conf (B,), probs (B, k)). This base keeps what the
callers of any family use: the label map and thresholds, `predict` on
numpy fingerprints, and the predictions table, as the JAX package's
`predict` and `predictions_to_df` give them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


class Classifier(nn.Module):
    """Base of the model families: `label_map` (k,) int32 and `thresholds`
    (k,) float32 as buffers, `n_classes` and the model's `name`."""

    def __init__(self, label_map: torch.Tensor, thresholds: torch.Tensor, name: str = ""):
        super().__init__()
        self.register_buffer("label_map", label_map)
        self.register_buffer("thresholds", thresholds)
        # the labels on the host, read once: a table built on another thread
        # never waits for the device
        self.label_values = label_map.cpu().numpy()
        self.n_classes = int(label_map.shape[0])
        self.name = name

    @property
    def device(self) -> torch.device:
        return self.label_map.device

    @property
    def fingerprint_len(self) -> int:
        raise NotImplementedError

    def predict(self, fpts) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Classify numpy fingerprints on the model's device; returns numpy
        (pred_labels, confidence, probs), as the JAX model's `predict`."""
        fpts = torch.as_tensor(np.asarray(fpts, np.float32), device=self.device)
        if fpts.ndim == 1:
            fpts = fpts[None]
        with torch.inference_mode():
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
