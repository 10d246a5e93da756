"""The port's copy of the exact linear-kernel changepoint program
(ops/changepoint.py, numpy only) against the JAX package's: the same
breakpoints, exactly, on numpy-seeded piecewise-constant and noise series,
and on series too short for the requested segments."""

import numpy as np
import pytest

from warpdemux_tpu.ops.changepoint import kernel_cpd_linear as jax_cpd
from warpdemux_tpu_torch.ops.changepoint import kernel_cpd_linear


def _piecewise(seed, levels, lengths, noise):
    rng = np.random.default_rng(seed)
    return np.concatenate([np.full(n, v) + rng.normal(0, noise, n) for v, n in zip(levels, lengths)])


@pytest.mark.parametrize(
    "x, n_bkps, min_size",
    [
        (_piecewise(0, [0.0, 4.0, -3.0, 2.0], [200, 150, 250, 180], 0.3), 3, 10),
        (_piecewise(1, [80.0, 95.0, 70.0], [40, 25, 60], 2.0), 2, 3),
        (np.random.default_rng(2).normal(size=90), 4, 2),
        (np.random.default_rng(3).normal(size=7).astype(np.float32), 3, 2),  # too short
    ],
    ids=["four-levels", "pA-levels", "noise", "too-short"],
)
def test_breakpoints_equal_jax(x, n_bkps, min_size):
    got = kernel_cpd_linear(x, n_bkps, min_size)
    want = jax_cpd(x, n_bkps, min_size)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
