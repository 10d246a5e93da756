"""CNN region prior of the [cnn_boundaries] detect method.

Port of warpdemux_tpu/detect/cnn.py: the calibrated signal is mean-pooled
by `downscale_factor`, normalized per read (median/MAD over the valid
lanes), and a dilated 1-D conv stack (layer i dilated 2**i, the last a 1x1
projection to {adapter, polyA, RNA}) emits per-position logits; argmax ==
polyA, morphologically closed, is the region prior that gates the poly(A)
search in detect/boundaries.py.

The convolutions are torch.nn.functional.conv1d (the JAX package leaves
them to XLA, not to a Pallas kernel). TF32 is switched off inside
`BoundaryCNN.forward`: cuDNN would otherwise run float32 convolutions in
TF32 on the GPU, and the logits' argmax gates the detector.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from warpdemux_tpu_torch.ops.normalize import masked_median
from warpdemux_tpu_torch.ops.numerics import _sequential_sum, fma, full_float32


class BoundaryCNN(nn.Module):
    """Dilated conv stack; weights w{i} (out, in, k) and biases b{i} are
    buffers taken from the reference npz bundle."""

    def __init__(self, weights: list[torch.Tensor], biases: list[torch.Tensor]):
        super().__init__()
        self.n_layers = len(weights)
        for i, (w, b) in enumerate(zip(weights, biases)):
            self.register_buffer(f"w{i}", w)
            self.register_buffer(f"b{i}", b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, Lds) normalized signal -> (B, Lds, 3) logits."""
        h = x[:, None, :]
        with full_float32():
            for i in range(self.n_layers):
                w = getattr(self, f"w{i}")
                k = w.shape[2]
                d = 2**i if k > 1 else 1
                h = F.conv1d(
                    h, w, getattr(self, f"b{i}"), padding=(k - 1) * d // 2,
                    dilation=d,
                )
                if i < self.n_layers - 1:
                    h = torch.relu(h)
        return h.transpose(1, 2)


def _block_sums(x: torch.Tensor, ds: int) -> torch.Tensor:
    """Left-to-right float32 sums of consecutive blocks of ds samples."""
    B, L = x.shape
    Lds = L // ds
    return _sequential_sum(x[:, : Lds * ds].reshape(B, Lds, ds))


def downscale_mean(x: torch.Tensor, ds: int) -> torch.Tensor:
    """Means of consecutive blocks of ds samples, (B, L // ds), rounded as
    the jitted jnp.mean rounds them on the CPU: a left-to-right float32
    sum, then a product with float32(1 / ds)."""
    return _block_sums(x, ds) * _inverse(ds)


def _inverse(ds: int) -> float:
    return float(np.float32(1.0) / np.float32(ds))


def preprocess(signals: torch.Tensor, in_lens: torch.Tensor, ds: int):
    """Mean-pool by ds and normalize per read (median/MAD over valid lanes).

    Bit for bit the jitted JAX function: the median is taken over the
    pooled means, but XLA contracts the pool's product with float32(1 / ds)
    into the deviation from it, fma(block sum, 1 / ds, -median), in the MAD
    and in the normalized signal alike.

    Returns (xds (B, Lds), valid_ds (B, Lds) bool)."""
    sums = _block_sums(signals, ds)
    inv = torch.tensor(_inverse(ds), dtype=torch.float32, device=signals.device)
    pos = torch.arange(sums.shape[1], device=signals.device)
    valid = pos[None, :] < (in_lens // ds)[:, None]
    med = masked_median(sums * inv, valid)
    dev = fma(sums, inv, -med[:, None])
    mad = masked_median(dev.abs(), valid)
    xn = dev / torch.clamp_min(mad[:, None], 1e-3)
    return torch.where(valid, xn, torch.zeros_like(xn)), valid


def polya_mask_from_logits(
    logits: torch.Tensor, valid: torch.Tensor, close_gap: int = 2
) -> torch.Tensor:
    """(B, Lds) bool mask of predicted-polyA positions, with gaps of up to
    ~2*close_gap closed (dilation, then erosion, window 2*close_gap + 1)."""
    is_pa = (torch.argmax(logits, dim=-1) == 1) & valid
    if close_gap:
        w = 2 * close_gap + 1
        f = is_pa.to(torch.float32)[:, None, :]
        # out-of-range lanes count as False for the dilation and as True
        # for the erosion (max_pool1d pads with -inf)
        dil = F.max_pool1d(f, w, stride=1, padding=close_gap)
        ero = -F.max_pool1d(-dil, w, stride=1, padding=close_gap)
        is_pa = (ero[:, 0, :] > 0) & valid
    return is_pa
