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
