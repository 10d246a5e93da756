"""Model registry: model and CNN npz bundles -> the port's modules.

Reads the JAX package's registry by path (warpdemux_tpu/models/
model_files/config.toml) and array bundles as numpy arrays: <name>.npz of
the port's model directory (MODEL_DIR, warpdemux_tpu_torch/models/
model_files/, where its trainers and importer write) if it is there, else
the JAX package's (warpdemux_tpu/models/model_files/); CNN weights the
same way (detect/cnn.load_arrays). The bundle's `model_type` selects
the family (absent: dtw_svm, as every shipped model is), and
`dtw_svm_from_arrays`, `dtw_mlp_from_arrays`, `fpt_boost_from_arrays` and
`cnn_from_arrays` carry the arrays into the port's nn.Modules, so the port
and the JAX package compute from identical arrays.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from warpdemux_tpu_torch._cuda import resolve_device
from warpdemux_tpu_torch.config.utils import (  # noqa: F401
    MODEL_DIR,
    SHARED_MODEL_DIR,
    available_models,
    find_bundle,
    model_config,
)
from warpdemux_tpu_torch.detect.cnn import BoundaryCNN, load_arrays
from warpdemux_tpu_torch.models.dtw_mlp import DTWMLPModel
from warpdemux_tpu_torch.models.dtw_svm import DTWSVMModel
from warpdemux_tpu_torch.models.fpt_boost import FptBoostModel
from warpdemux_tpu_torch.ops.svm import build_pair_coef


def _load_npz(path) -> dict[str, np.ndarray]:
    if not path.exists():
        raise FileNotFoundError(f"array bundle not found: {path}")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_model_arrays(name: str) -> dict[str, np.ndarray]:
    """The bundle <name>.npz: the port's own (MODEL_DIR, read when called)
    before the JAX package's."""
    return _load_npz(find_bundle(name, MODEL_DIR, SHARED_MODEL_DIR))


def load_cnn_arrays(name: str) -> dict[str, np.ndarray]:
    return load_arrays(name)


def _tensors(device):
    """Carriers of numpy arrays to `device`: float32, and int32."""

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    return f32, i32


def dtw_svm_from_arrays(arrays: dict, device, name: str = "") -> DTWSVMModel:
    """A float32 DTWSVMModel on `device` from a model bundle's arrays."""
    f32, i32 = _tensors(device)
    coef = build_pair_coef(arrays["dual_coef"], arrays["n_support"])
    return DTWSVMModel(
        X_sv=f32(arrays["X_sv"]),
        coef=f32(coef),
        intercept=f32(arrays["intercept"]),
        probA=f32(arrays["probA"]),
        probB=f32(arrays["probB"]),
        label_map=i32(arrays["label_map"]),
        thresholds=f32(arrays["thresholds"]),
        n_classes=int(arrays["n_classes"]),
        window=int(arrays["window"]),
        penalty=float(arrays["penalty"]),
        gamma=float(arrays["gamma"]),
        pwr_dist=int(arrays["pwr_dist"]),
        name=name,
    )


def dtw_mlp_from_arrays(arrays: dict, device, name: str = "") -> DTWMLPModel:
    """A float32 DTWMLPModel on `device` from a DTW-MLP bundle's arrays
    (X_sv, n_layers, mlp_w{i} (in, out), mlp_b{i}, optional scaler_mean /
    scaler_scale, label_map, thresholds, window, penalty)."""
    f32, i32 = _tensors(device)
    n = int(arrays["n_layers"])
    sm, ss = arrays.get("scaler_mean"), arrays.get("scaler_scale")
    return DTWMLPModel(
        X_ref=f32(arrays["X_sv"]),
        weights=[f32(arrays[f"mlp_w{i}"]) for i in range(n)],
        biases=[f32(arrays[f"mlp_b{i}"]) for i in range(n)],
        scaler_mean=None if sm is None else f32(sm),
        scaler_scale=None if ss is None else f32(ss),
        label_map=i32(arrays["label_map"]),
        thresholds=f32(arrays["thresholds"]),
        window=int(arrays["window"]),
        penalty=float(arrays["penalty"]),
        name=name,
    )


def fpt_boost_from_arrays(arrays: dict, device, name: str = "") -> FptBoostModel:
    """A float32 FptBoostModel on `device` from a Fpt-Boost bundle's arrays
    (feat (T, d), thr (T, d), leaf_values (T, 2^d, k), optional bias,
    label_map, thresholds, fingerprint_len)."""
    f32, i32 = _tensors(device)
    leaf = f32(arrays["leaf_values"])
    k = leaf.shape[-1]
    return FptBoostModel(
        feat=i32(arrays["feat"]),
        thr=f32(arrays["thr"]),
        leaf_values=leaf,
        bias=f32(arrays.get("bias", np.zeros(k, np.float32))),
        label_map=i32(arrays["label_map"]),
        thresholds=f32(arrays["thresholds"]),
        fingerprint_len=int(arrays["fingerprint_len"]),
        name=name,
    )


FROM_ARRAYS = {
    "dtw_svm": dtw_svm_from_arrays,
    "dtw_mlp": dtw_mlp_from_arrays,
    "fpt_boost": fpt_boost_from_arrays,
}


def model_from_arrays(arrays: dict, device, name: str = ""):
    """The model of the family the bundle's `model_type` names, on
    `device`; ValueError for an unknown type."""
    mtype = str(arrays.get("model_type", "dtw_svm"))
    if mtype not in FROM_ARRAYS:
        raise ValueError(f"unknown model_type {mtype!r} in bundle {name!r}")
    return FROM_ARRAYS[mtype](arrays, device, name=name)


def cnn_from_arrays(arrays: dict, device) -> BoundaryCNN:
    """The BoundaryCNN on `device` from a CNN bundle (w{i}, b{i})."""
    n = sum(1 for k in arrays if k.startswith("w"))
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return BoundaryCNN(
        [as_t(arrays[f"w{i}"]) for i in range(n)],
        [as_t(arrays[f"b{i}"]) for i in range(n)],
    )


def load_model(name: str, device=None):
    """The named model on `device`: by default the CUDA GPU (RuntimeError
    where there is none); `device="cpu"` for the CPU. The bundle's
    `model_type` picks the family."""
    arrays = load_model_arrays(name)
    if bool(arrays.get("stand_in", False)):
        # an in-repository replacement for an upstream model whose file is
        # missing: the same form, not the published weights
        logging.warning(
            "model %r is an in-repo-trained STAND-IN (the upstream model "
            "file is a missing blob in the reference checkout); barcode "
            "calls will not match the published model",
            name,
        )
    return model_from_arrays(arrays, resolve_device(device), name=name)


def load_cnn(name: str, device=None) -> BoundaryCNN:
    """The named boundary CNN on `device`; the default as in load_model."""
    return cnn_from_arrays(load_cnn_arrays(name), resolve_device(device))
