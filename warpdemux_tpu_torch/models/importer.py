"""Model bundle conversion: a catboost JSON export -> a Fpt-Boost bundle.

Port of `convert_catboost_json` of warpdemux_tpu/models/importer.py (numpy
and json only): the arrays it returns are the npz bundle that
`models/registry.load_model` reads (`np.savez_compressed(<name>.npz,
**arrays)` in the registry's model directory) and that
`registry.fpt_boost_from_arrays` turns into a FptBoostModel.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


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
