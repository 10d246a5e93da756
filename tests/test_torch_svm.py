"""Port parity: libsvm probability SVC (ops/svm.py, models/dtw_svm.py)
against the JAX package on all five RNA004 model bundles, float32."""

import numpy as np
import pytest
import torch

from warpdemux_tpu.models.registry import load_model as jax_load_model
from warpdemux_tpu.ops.dtw import dtw_distance_matrix
from warpdemux_tpu.ops import svm as jax_svm
from warpdemux_tpu_torch.models.registry import load_model
from warpdemux_tpu_torch.ops import svm as torch_svm

RNA004_MODELS = [
    "WDX4_rna004_v1_0",
    "WDX4b_rna004_v1_0",
    "WDX4c_rna004_v1_0",
    "WDX6_rna004_v1_0",
    "WDX10_rna004_v1_0",
]


@pytest.mark.parametrize("name", RNA004_MODELS)
def test_predict_proba_and_labels_match_jax(name):
    jm = jax_load_model(name)
    tm = load_model(name, "cpu")
    rng = np.random.default_rng(5)
    X = np.asarray(jm.X_sv)
    fpts = np.concatenate(
        [
            X[rng.integers(0, len(X), 12)] + rng.normal(0, 0.3, (12, X.shape[1])),
            rng.normal(0, 1, (12, X.shape[1])),
        ]
    ).astype(np.float32)
    D = np.asarray(dtw_distance_matrix(fpts, X, jm.window, jm.penalty))
    K = np.array(jax_svm.pdist_kernel(D, jm.gamma, jm.pwr_dist), np.float32)

    want = np.array(jax_svm.predict_proba(K, jm.params))
    got = torch_svm.predict_proba(torch.from_numpy(K), tm.params).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)

    wpred, wconf = jax_svm.process_probs(want, jm.label_map, jm.thresholds)
    gpred, gconf = torch_svm.process_probs(
        torch.from_numpy(want), tm.label_map, tm.thresholds
    )
    np.testing.assert_array_equal(gpred.numpy(), np.asarray(wpred))
    np.testing.assert_allclose(gconf.numpy(), np.asarray(wconf), rtol=1e-6)


@pytest.mark.parametrize("name", RNA004_MODELS)
def test_model_forward_matches_jax_predict(name):
    """The whole classifier (DTW -> kernel -> proba -> labels) on the same
    fingerprints: identical labels, probabilities within rtol 1e-5."""
    jm = jax_load_model(name)
    tm = load_model(name, "cpu")
    rng = np.random.default_rng(11)
    X = np.asarray(jm.X_sv)
    fpts = (
        X[rng.integers(0, len(X), 16)] + rng.normal(0, 0.5, (16, X.shape[1]))
    ).astype(np.float32)
    wpred, wconf, wprobs = jm.predict(fpts)
    gpred, gconf, gprobs = tm(torch.from_numpy(fpts))
    np.testing.assert_array_equal(gpred.numpy(), wpred)
    np.testing.assert_allclose(gprobs.numpy(), wprobs, rtol=1e-5, atol=1e-7)
    # conf = p1 - p2 of probabilities <= 1, each within rtol 1e-5
    np.testing.assert_allclose(gconf.numpy(), wconf, rtol=0, atol=2e-5)


def test_pair_coef_matches_jax():
    from warpdemux_tpu_torch.models.registry import load_model_arrays

    a = load_model_arrays("WDX6_rna004_v1_0")
    np.testing.assert_array_equal(
        torch_svm.build_pair_coef(a["dual_coef"], a["n_support"]),
        jax_svm.build_pair_coef(a["dual_coef"], a["n_support"]),
    )
