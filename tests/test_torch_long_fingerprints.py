"""Fingerprints of more than 32 events in the port against the JAX package.

`barcode_num_events` is a setting of the chemistry's config TOML, and the
JAX models' DTW (warpdemux_tpu/ops/dtw.py, the jnp wavefront) takes any
length. The port's plain DTW (the reference of kernel K1, which since takes
any length on CUDA) against the jitted JAX DTW bit for bit at 33, 40 and 64
events, in the band of 15 and on the full lattice; then the whole step
(adc feed, full outputs) at barcode_num_events = barcode_seg_num_events =
40 with a 5-class SVM of 40-event support vectors made from a seed
(chip_smoke.svm_arrays), every column row for row, exact.
"""

import jax
import numpy as np
import pytest
import torch

from warpdemux_tpu.ops.dtw import dtw_distance_matrix as jax_dtw
from warpdemux_tpu_torch.ops import dtw
from test_torch_wide_classes import compare_steps, step_against_jax


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("m", [33, 40, 64])
@pytest.mark.parametrize("window", [15, "m"])
def test_dtw_past_32_events_matches_the_jitted_jax_dtw(m, window):
    """24 queries by 37 references from a seed, NaN and infinite samples
    planted: bit for bit, NaN where JAX's is."""
    window = m if window == "m" else window
    rng = np.random.default_rng(m)
    X = rng.normal(0, 1, (24, m)).astype(np.float32)
    Y = rng.normal(0, 1, (37, m)).astype(np.float32)
    X[1, 3], X[2, m - 1], Y[5, 0] = np.nan, np.inf, -np.inf
    want = np.asarray(jax.jit(jax_dtw, static_argnums=(2, 3))(X, Y, window, 0.1))
    got = dtw.dtw_distance_matrix(torch.from_numpy(X), torch.from_numpy(Y), window, 0.1).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.nan_to_num(got).view(np.int32), np.nan_to_num(want).view(np.int32))


def test_the_40_event_step_matches_jax_row_for_row():
    """The adc step, full outputs, fingerprints of 40 events (the segment
    counts of the barcode and the fingerprint both 40) and a 5-class SVM of
    40-event support vectors: every column row for row, exact."""
    port, want = step_against_jax(5, 40)
    assert port.big_f.shape == np.asarray(want.big_f).shape
    pred = compare_steps(port, want)
    assert (pred != -1).any()
