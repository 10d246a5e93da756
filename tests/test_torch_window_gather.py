"""Port parity: per-row window copy (kernel K5's plain version) against
the JAX package's Pallas kernel in interpret mode and its gather path:
exact."""

import numpy as np
import pytest
import torch

from warpdemux_tpu.ops.window_gather import shift_rows as jax_shift_rows
from warpdemux_tpu.ops.window_gather import shift_rows_auto
from warpdemux_tpu_torch.ops.window_gather import shift_rows


@pytest.mark.parametrize("L, out_len", [(1000, 800), (2000, 640), (700, 700)])
def test_shift_rows_exact(L, out_len):
    rng = np.random.default_rng(L)
    B = 9
    x = rng.normal(80, 12, (B, L)).astype(np.float32)
    starts = rng.integers(0, L - out_len + 1, B).astype(np.int32)
    starts[0], starts[-1] = 0, L - out_len
    got = shift_rows(torch.from_numpy(x), torch.from_numpy(starts), out_len).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_shift_rows(x, starts, out_len, interpret=True))
    )
    np.testing.assert_array_equal(got, np.asarray(shift_rows_auto(x, starts, out_len)))
    for b in range(B):
        np.testing.assert_array_equal(got[b], x[b, starts[b] : starts[b] + out_len])


def test_shift_rows_clamps_like_the_gather_path():
    """Starts outside [0, L - out_len] read clamped indices, as the JAX
    package's gather path (shift_rows_auto off the TPU) does."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (4, 300)).astype(np.float32)
    starts = np.array([-20, 0, 250, 400], np.int32)
    got = shift_rows(torch.from_numpy(x), torch.from_numpy(starts), 100).numpy()
    np.testing.assert_array_equal(got, np.asarray(shift_rows_auto(x, starts, 100)))
