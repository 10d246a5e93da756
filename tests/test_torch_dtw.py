"""Port parity: banded DTW (kernel K1's plain version) against the JAX
package's jnp wavefront, its Pallas kernel in interpret mode and the numpy
golden reference. Inputs are numpy arrays from fixed seeds."""

import numpy as np
import pytest
import torch

from warpdemux_tpu.ops.dtw import dtw_distance_matrix, dtw_distance_matrix_ref
from warpdemux_tpu.ops.dtw_pallas import dtw_distance_matrix_pallas
from warpdemux_tpu_torch.models.registry import load_model_arrays
from warpdemux_tpu_torch.ops.dtw import dtw_distance_matrix as torch_dtw
from warpdemux_tpu_torch.ops.dtw import dtw_distance_matrix_plain


def _support_vectors(name):
    return load_model_arrays(name)["X_sv"].astype(np.float32)


@pytest.mark.parametrize(
    "model, b", [("WDX4_rna004_v1_0", 16), ("WDX10_rna004_v1_0", 8)]
)
def test_dtw_matches_jax_at_model_lattices(model, b):
    """Both oracles at the shipped model widths, N = 851 and N = 2601
    (float32, rtol 1e-6)."""
    Y = _support_vectors(model)
    X = np.random.default_rng(0).normal(0, 1, (b, 25)).astype(np.float32)
    got = torch_dtw(torch.from_numpy(X), torch.from_numpy(Y), 15, 0.1).numpy()
    want = np.asarray(dtw_distance_matrix(X, Y, 15, 0.1))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    want_pallas = np.asarray(
        dtw_distance_matrix_pallas(X, Y, 15, 0.1, interpret=True)
    )
    np.testing.assert_allclose(got, want_pallas, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "window, penalty", [(15, 0.1), (3, 0.0), (25, 0.5), (1, 0.1)]
)
def test_dtw_window_and_penalty_variants(window, penalty):
    rng = np.random.default_rng(window)
    X = rng.normal(0, 1, (6, 25)).astype(np.float32)
    Y = rng.normal(0, 1, (40, 25)).astype(np.float32)
    got = torch_dtw(torch.from_numpy(X), torch.from_numpy(Y), window, penalty)
    want = np.asarray(dtw_distance_matrix(X, Y, window, penalty))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    golden = dtw_distance_matrix_ref(
        X.astype(np.float64), Y.astype(np.float64), window, penalty
    )
    np.testing.assert_allclose(got.numpy(), golden, rtol=1e-5, atol=1e-5)


def test_dtw_self_distance_is_zero():
    Y = _support_vectors("WDX4_rna004_v1_0")[:32]
    D = torch_dtw(torch.from_numpy(Y), torch.from_numpy(Y), 15, 0.1)
    assert torch.all(torch.diagonal(D) == 0)


@pytest.mark.parametrize("m, window, penalty", [(20, 8, 0.1), (32, 32, 0.5)])
def test_dtw_plain_matches_jax_at_other_lattices(m, window, penalty):
    """The plain version (the yardstick of kernel K1's generic instance)
    at fingerprint lengths and windows other than the models': bit for bit
    the jitted jnp wavefront, and the float64 golden reference to 1e-5."""
    rng = np.random.default_rng(m)
    X = rng.normal(0, 1, (7, m)).astype(np.float32)
    Y = rng.normal(0, 1, (33, m)).astype(np.float32)
    got = dtw_distance_matrix_plain(torch.from_numpy(X), torch.from_numpy(Y), window, penalty).numpy()
    np.testing.assert_array_equal(got, np.asarray(dtw_distance_matrix(X, Y, window, penalty)))
    golden = dtw_distance_matrix_ref(X.astype(np.float64), Y.astype(np.float64), window, penalty)
    np.testing.assert_allclose(got, golden, rtol=1e-5, atol=1e-5)


def test_dtw_plain_non_finite_fingerprints_match_jax():
    """NaN and infinite samples come out as in the jnp wavefront: a NaN
    anywhere in a fingerprint makes its distances NaN (minimum propagates
    it), an infinite sample makes them infinite; the other pairs are
    untouched (exact)."""
    rng = np.random.default_rng(5)
    X = rng.normal(0, 1, (6, 25)).astype(np.float32)
    Y = rng.normal(0, 1, (20, 25)).astype(np.float32)
    X[1, 3], X[2, 24], X[3, 0], Y[19, 2] = np.nan, np.inf, -np.inf, np.nan
    got = dtw_distance_matrix_plain(torch.from_numpy(X), torch.from_numpy(Y), 15, 0.1).numpy()
    want = np.asarray(dtw_distance_matrix(X, Y, 15, 0.1))
    np.testing.assert_array_equal(got, want)  # NaN == NaN here
    assert np.isnan(got[1]).all() and np.isnan(got[:, 19]).all()
    assert np.isinf(got[2, :19]).all() and np.isinf(got[3, :19]).all()
    assert np.isfinite(got[[0, 4, 5], :19]).all()
