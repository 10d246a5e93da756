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

Training (warpdemux_tpu_torch/tools/train_cnn.py) and serving share one
forward, `apply(params, x)`: `init_params` draws the JAX package's He
initialization from the same numpy Generator in the same order, and
`save_params` / `load_arrays` / `load_params` write and read its npz
bundles in the weights directory (config/utils.CNN_DIR, read when called;
models/registry.load_cnn reads through load_arrays too).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from warpdemux_tpu_torch._cuda import resolve_device
from warpdemux_tpu_torch.config import utils as config_utils
from warpdemux_tpu_torch.ops.normalize import sorted_median
from warpdemux_tpu_torch.ops.numerics import _sequential_sum, fma, full_float32


# (out_ch, in_ch, kernel) per layer; layer i is dilated 2**i unless its
# kernel is 1 (the final projection to the classes), so a bundle's weight
# shapes say its architecture
ARCH = (
    (16, 1, 7),
    (32, 16, 7),
    (32, 32, 7),
    (32, 32, 7),
    (3, 32, 1),
)
# dilations to 32 (~3.8k samples at ds=10): context enough to span a whole
# adapter when judging a poly(A) candidate
ARCH_WIDE = (
    (16, 1, 7),
    (32, 16, 7),
    (32, 32, 7),
    (32, 32, 7),
    (32, 32, 7),
    (32, 32, 7),
    (3, 32, 1),
)
N_CLASSES = 3  # 0=adapter, 1=polyA, 2=RNA


def init_params(rng: np.random.Generator, arch=ARCH, device=None) -> dict[str, torch.Tensor]:
    """He-initialized float32 weights w{i} (out, in, k) and zero biases b{i},
    drawn layer by layer from `rng` as the JAX package draws them, on
    `device` (the GPU unless the caller names another)."""
    device = resolve_device(device)
    params = {}
    for i, (co, ci, k) in enumerate(arch):
        std = float(np.sqrt(2.0 / (ci * k)))
        w = np.asarray(rng.normal(0, std, size=(co, ci, k)), np.float32)
        params[f"w{i}"] = torch.as_tensor(w, device=device)
        params[f"b{i}"] = torch.zeros(co, dtype=torch.float32, device=device)
    return params


def apply(params: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """(B, Lds) normalized signal -> (B, Lds, 3) logits (NCW inside)."""
    n = sum(1 for key in params if key.startswith("w"))
    h = x[:, None, :]
    for i in range(n):
        w = params[f"w{i}"]
        k = w.shape[2]
        d = 2**i if k > 1 else 1
        h = F.conv1d(h, w, params[f"b{i}"], padding=(k - 1) * d // 2, dilation=d)
        if i < n - 1:
            h = torch.relu(h)
    return h.transpose(1, 2)


class BoundaryCNN(nn.Module):
    """The serving CNN: weights w{i} (out, in, k) and biases b{i} are
    buffers (no gradient) taken from a weights bundle."""

    def __init__(self, weights: list[torch.Tensor], biases: list[torch.Tensor]):
        super().__init__()
        self.n_layers = len(weights)
        for i, (w, b) in enumerate(zip(weights, biases)):
            self.register_buffer(f"w{i}", w)
            self.register_buffer(f"b{i}", b)

    def params(self) -> dict[str, torch.Tensor]:
        return {f"{p}{i}": getattr(self, f"{p}{i}") for i in range(self.n_layers) for p in "wb"}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, Lds) normalized signal -> (B, Lds, 3) logits."""
        with full_float32():
            return apply(self.params(), x)


def save_params(params: dict[str, torch.Tensor], path: str | Path) -> None:
    """Write the weights as the JAX package's npz bundle."""
    np.savez_compressed(path, **{k: v.detach().cpu().numpy() for k, v in params.items()})


def load_arrays(name: str) -> dict[str, np.ndarray]:
    """A weights bundle by name (no extension), as the numpy arrays it
    holds: the port's weights directory (config/utils.CNN_DIR, read when
    called) before the JAX package's (SHARED_CNN_DIR)."""
    path = config_utils.find_bundle(name, config_utils.CNN_DIR, config_utils.SHARED_CNN_DIR)
    if not path.exists():
        raise FileNotFoundError(
            f"CNN weights {name!r} not found at {path}; train with "
            "tools/train_cnn.py or use the llr/start_peak methods."
        )
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_params(name: str, device=None) -> dict[str, torch.Tensor]:
    """load_arrays' bundle as float32 tensors on `device` (the GPU unless
    the caller names another)."""
    device = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device) for k, v in load_arrays(name).items()}


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
    med = sorted_median(sums * inv, valid)
    dev = fma(sums, inv, -med[:, None])
    mad = sorted_median(dev.abs(), valid)
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


def polya_candidates_from_logits(
    logits: torch.Tensor, valid: torch.Tensor, k: int, close_gap: int = 2
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k predicted-polyA runs by length: (starts (B, k), lengths (B, k))
    int32 in ds units; absent candidates have length 0. Among runs of equal
    length (the zeros of non-starts among them) the lower position comes
    first, as jax.lax.top_k orders them: a stable descending sort."""
    B, Lds, _ = logits.shape
    is_pa = polya_mask_from_logits(logits, valid, close_gap)
    pos = torch.arange(Lds, device=logits.device).expand(B, Lds)
    prev = torch.cat([torch.zeros_like(is_pa[:, :1]), is_pa[:, :-1]], dim=1)
    run_start = is_pa & ~prev
    # the next non-polyA index at or after p (a reverse running minimum)
    stop = torch.where(is_pa, torch.full_like(pos, Lds), pos)
    nxt = torch.flip(torch.cummin(torch.flip(stop, [1]), dim=1).values, [1])
    run_len = torch.where(run_start, nxt - pos, torch.zeros_like(pos))
    lens_k, idx_k = torch.sort(run_len, dim=1, descending=True, stable=True)
    return idx_k[:, :k].to(torch.int32), lens_k[:, :k].to(torch.int32)
