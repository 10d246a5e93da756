"""Model registry: model and CNN npz bundles -> the port's modules.

Reads the JAX package's array bundles by path (warpdemux_tpu/models/
model_files/<name>.npz, warpdemux_tpu/detect/cnn_files/<name>.npz) as
numpy arrays. `dtw_svm_from_arrays` and `cnn_from_arrays` carry the
weights into the port's nn.Modules, so the port and the JAX package
compute from identical arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from warpdemux_tpu_torch._cuda import resolve_device
from warpdemux_tpu_torch.config.utils import CNN_DIR, MODEL_DIR
from warpdemux_tpu_torch.detect.cnn import BoundaryCNN
from warpdemux_tpu_torch.models.dtw_svm import DTWSVMModel
from warpdemux_tpu_torch.ops.svm import build_pair_coef


def _load_npz(path) -> dict[str, np.ndarray]:
    if not path.exists():
        raise FileNotFoundError(f"array bundle not found: {path}")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_model_arrays(name: str) -> dict[str, np.ndarray]:
    return _load_npz(MODEL_DIR / f"{name}.npz")


def load_cnn_arrays(name: str) -> dict[str, np.ndarray]:
    return _load_npz(CNN_DIR / f"{name}.npz")


def dtw_svm_from_arrays(arrays: dict, device, name: str = "") -> DTWSVMModel:
    """A float32 DTWSVMModel on `device` from a model bundle's arrays."""
    mtype = str(arrays.get("model_type", "dtw_svm"))
    if mtype != "dtw_svm":
        raise NotImplementedError(f"model_type {mtype!r} is not ported")

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    coef = build_pair_coef(arrays["dual_coef"], arrays["n_support"])
    return DTWSVMModel(
        X_sv=f32(arrays["X_sv"]),
        coef=f32(coef),
        intercept=f32(arrays["intercept"]),
        probA=f32(arrays["probA"]),
        probB=f32(arrays["probB"]),
        label_map=torch.as_tensor(
            np.asarray(arrays["label_map"], np.int32), device=device
        ),
        thresholds=f32(arrays["thresholds"]),
        n_classes=int(arrays["n_classes"]),
        window=int(arrays["window"]),
        penalty=float(arrays["penalty"]),
        gamma=float(arrays["gamma"]),
        pwr_dist=int(arrays["pwr_dist"]),
        name=name,
    )


def cnn_from_arrays(arrays: dict, device) -> BoundaryCNN:
    """The BoundaryCNN on `device` from a CNN bundle (w{i}, b{i})."""
    n = sum(1 for k in arrays if k.startswith("w"))
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return BoundaryCNN(
        [as_t(arrays[f"w{i}"]) for i in range(n)],
        [as_t(arrays[f"b{i}"]) for i in range(n)],
    )


def load_model(name: str, device=None) -> DTWSVMModel:
    """The named model on `device`: by default the CUDA GPU (RuntimeError
    where there is none); `device="cpu"` for the CPU."""
    return dtw_svm_from_arrays(load_model_arrays(name), resolve_device(device), name=name)


def load_cnn(name: str, device=None) -> BoundaryCNN:
    """The named boundary CNN on `device`; the default as in load_model."""
    return cnn_from_arrays(load_cnn_arrays(name), resolve_device(device))
