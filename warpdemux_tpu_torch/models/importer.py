"""Model bundle conversion into the neutral npz format.

Port of warpdemux_tpu/models/importer.py (numpy, json and, inside the
functions that read pickles, joblib): the arrays it returns are the npz
bundle that `models/registry.load_model` reads (`np.savez_compressed(
<name>.npz, **arrays)` in the registry's model directory).

- `convert_joblib`: a reference WarpDemuX model joblib (a DTW_SVM whose
  sklearn SVC(kernel='precomputed') holds the one-vs-one solution) ->
  the DTW-SVM bundle:

    X_sv          (n_sv, m)  support-vector fingerprints (pruned to support set)
    dual_coef     (k-1, n_sv)
    n_support     (k,)
    intercept     (P,)       P = k(k-1)/2 one-vs-one pairs
    probA, probB  (P,)       Platt calibration
    label_map     (k,)       prob-column index -> output barcode (-1 = noise)
    thresholds    (k,)       per-class confidence thresholds (99% precision)
    window, penalty, gamma, pwr_dist, block_size, noise_class scalars

- `arrays_from_svc`: the same bundle from a fitted SVC and its training
  fingerprints (the tRNA trainer's, tools/train_trna_model.py);
- `convert_catboost_json`: a catboost JSON export -> a Fpt-Boost bundle.

Run as a module to convert every joblib of a reference checkout:

    python -m warpdemux_tpu_torch.models.importer --reference <WarpDemuX checkout> [--out DIR]

(`--src DIR` names the joblib directory itself; `--out` defaults to the
registry's model directory, config/utils.MODEL_DIR.)
"""

from __future__ import annotations

import argparse
import json
import sys
import types
import warnings
from pathlib import Path

import numpy as np

from warpdemux_tpu_torch.config import utils as config_utils


def _install_unpickle_stubs() -> None:
    """Provide stub classes for the reference's model modules so its pickles
    load as plain attribute bags without importing reference code."""
    stubs = {
        "warpdemux.models.dtw_svm": ["DTW_SVM"],
        "warpdemux.models.dtw_base": ["BaseDTWModel"],
        "warpdemux.models.dtw_mlp": ["DTW_MLP"],
        "warpdemux.models.fpt_boost": ["Fpt_Boost"],
        "warpdemux.models.fpt_base": ["BaseFptModel"],
    }
    for modname, classes in stubs.items():
        parts = modname.split(".")
        for i in range(1, len(parts) + 1):
            mn = ".".join(parts[:i])
            if mn not in sys.modules:
                sys.modules[mn] = types.ModuleType(mn)
        m = sys.modules[modname]
        for c in classes:
            if not hasattr(m, c):
                setattr(m, c, type(c, (), {}))


def arrays_from_svc(
    svc,
    X: np.ndarray,
    label_mapper: dict,
    thresholds,
    window: int = 15,
    penalty: float = 0.1,
    gamma: float = 1.0,
    pwr_dist: int = 1,
    block_size: int = 500,
    noise_class: bool = True,
) -> dict[str, np.ndarray]:
    """Arrays bundle from a fitted sklearn SVC(kernel='precomputed') and
    its training fingerprints X (the support vectors are X's rows at
    svc.support_)."""
    X = np.asarray(X, np.float64)
    support = np.asarray(svc.support_, np.int64)
    k = len(svc.classes_)
    label_map = np.array([label_mapper[i] for i in range(k)], np.int32)
    thresholds = np.asarray(thresholds, np.float64)
    if thresholds.shape == ():
        thresholds = np.full(k, float(thresholds))
    return dict(
        X_sv=X[support].astype(np.float32),
        X_sv_f64=X[support],
        dual_coef=np.asarray(svc.dual_coef_, np.float64),
        n_support=np.asarray(svc.n_support_, np.int64),
        intercept=np.asarray(svc.intercept_, np.float64),
        probA=np.asarray(svc.probA_, np.float64),
        probB=np.asarray(svc.probB_, np.float64),
        classes=np.asarray(svc.classes_, np.int64),
        label_map=label_map,
        thresholds=thresholds,
        window=np.int64(window),
        penalty=np.float64(penalty),
        gamma=np.float64(gamma),
        pwr_dist=np.int64(pwr_dist),
        block_size=np.int64(block_size),
        noise_class=np.bool_(noise_class),
        n_classes=np.int64(k),
    )


def convert_joblib(joblib_path: str | Path) -> dict[str, np.ndarray]:
    """The DTW-SVM bundle of a reference model joblib: its SVC, training
    fingerprints `_X`, `label_mapper`, `thresholds` and DTW settings."""
    import joblib

    _install_unpickle_stubs()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        obj = joblib.load(joblib_path)
    d = obj.__dict__
    return arrays_from_svc(
        d["model"],
        d["_X"],
        d["label_mapper"],
        d["thresholds"],
        window=d["window"],
        penalty=d["penalty"],
        gamma=d.get("gamma", 1.0),
        pwr_dist=d.get("pwr_dist", 1),
        block_size=d.get("block_size", 500),
        noise_class=d.get("noise_class", False),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Convert reference WarpDemuX model joblibs into npz bundles.")
    ap.add_argument("--reference", default=None,
                    help="a reference WarpDemuX checkout (its warpdemux/models/model_files/)")
    ap.add_argument("--src", default=None,
                    help="explicit joblib dir (e.g. a DEPRECATED/model_files)")
    ap.add_argument("--out", default=None,
                    help="output directory (default: the registry's model directory)")
    args = ap.parse_args(argv)
    if args.src is None and args.reference is None:
        ap.error("give --reference or --src")
    src = (
        Path(args.src)
        if args.src
        else Path(args.reference) / "warpdemux" / "models" / "model_files"
    )
    out = Path(args.out) if args.out else config_utils.MODEL_DIR
    out.mkdir(parents=True, exist_ok=True)
    for jl in sorted(src.glob("*.joblib")):
        arrays = convert_joblib(jl)
        dst = out / (jl.stem + ".npz")
        np.savez_compressed(dst, **arrays)
        print(
            f"{jl.stem}: n_sv={arrays['X_sv'].shape[0]} "
            f"k={int(arrays['n_classes'])} -> {dst}"
        )
    return 0


def convert_catboost_json(
    path: str | Path,
    label_mapper: dict,
    thresholds,
    fingerprint_len: int = 25,
    noise_class: bool = True,
) -> dict[str, np.ndarray]:
    """Arrays bundle from a catboost JSON model export (the Fpt_Boost family).

    Parses the documented `save_model(..., format="json")` schema: a list of
    oblivious trees, each with per-level `splits`
    ({float_feature_index, border}) and a flat `leaf_values` array of
    2^depth x approx_dimension values (leaf-major). Bit convention: split
    level j contributes bit j of the leaf index (x[feat_j] > border_j);
    `scale_and_bias` is folded into the leaf values / bias vector.
    The convention follows catboost's public schema documentation and is
    pinned by tests/test_torch_catboost_import.py's independent tree-walk
    evaluator and hand-computed fixture.

    Trees of differing depth are padded to the ensemble max depth with
    always-false splits (threshold +inf) and zero-padded leaf tables.
    """
    doc = json.loads(Path(path).read_text())
    trees = doc["oblivious_trees"]
    k = len(label_mapper)
    depths = [len(t["splits"]) for t in trees]
    D = max(depths)
    T = len(trees)
    feat = np.zeros((T, D), np.int32)
    thr = np.full((T, D), np.inf, np.float32)
    leaf = np.zeros((T, 2**D, k), np.float64)
    for ti, t in enumerate(trees):
        d = len(t["splits"])
        for j, s in enumerate(t["splits"]):
            feat[ti, j] = int(s["float_feature_index"])
            thr[ti, j] = float(s["border"])
        lv = np.asarray(t["leaf_values"], np.float64)
        dim = lv.size // (2**d)
        lv = lv.reshape(2**d, dim)
        if dim == 1 and k > 1:
            raise ValueError(
                "binary-approx catboost models are not supported; export a "
                "multiclass model (approx_dimension == n_classes)"
            )
        leaf[ti, : 2**d, :] = lv[:, :k]
    bias = np.zeros(k, np.float64)
    snb = doc.get("scale_and_bias")
    if snb:
        scale = float(snb[0])
        leaf *= scale
        b = np.asarray(snb[1], np.float64).reshape(-1)
        bias[: b.size] = b
    label_map = np.array([label_mapper[i] for i in range(k)], np.int32)
    thresholds = np.asarray(thresholds, np.float64)
    if thresholds.shape == ():
        thresholds = np.full(k, float(thresholds))
    return dict(
        model_type=np.str_("fpt_boost"),
        feat=feat,
        thr=thr,
        leaf_values=leaf.astype(np.float32),
        bias=bias.astype(np.float32),
        label_map=label_map,
        thresholds=thresholds.astype(np.float32),
        fingerprint_len=np.int64(fingerprint_len),
        noise_class=np.bool_(noise_class),
    )


if __name__ == "__main__":
    sys.exit(main())
