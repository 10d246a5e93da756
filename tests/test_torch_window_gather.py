"""Port parity: per-row window copy (kernel K5's plain version) against
the JAX package's Pallas kernel in interpret mode and its gather path:
exact."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import k5_edge_cases  # noqa: E402

from warpdemux_tpu.ops.window_gather import shift_rows as jax_shift_rows  # noqa: E402
from warpdemux_tpu.ops.window_gather import shift_rows_auto  # noqa: E402
from warpdemux_tpu_torch.ops.window_gather import shift_rows, shift_rows_plain  # noqa: E402


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


def _loop(x, starts, out_len, lengths):
    """The definition, an element at a time."""
    B_x, L = x.shape
    out = np.zeros((len(starts), out_len), np.float32)
    for r, start in enumerate(starts):
        for j in range(out_len):
            src = int(start) + j
            if lengths is None:
                out[r, j] = x[r % B_x, min(max(src, 0), L - 1)]
            elif j < lengths[r] and 0 <= src < L:
                out[r, j] = x[r % B_x, src]
    return out


@pytest.mark.parametrize("case", range(len(k5_edge_cases())), ids=[c[0] for c in k5_edge_cases()])
def test_shift_rows_edge_cases_match_the_definition(case):
    """The cases K5 is held to on the GPU: starts that leave the row with
    and without lengths, lengths of 0 and beyond, sizes off the vectors,
    K = 2 and 3 windows a row."""
    _, x, starts, out_len, lengths = k5_edge_cases()[case]
    if x.shape[1] * out_len > 10**6:  # the loop is slow: the first rows' worth
        out_len = 300
    got = shift_rows(torch.from_numpy(x), torch.from_numpy(starts), out_len,
                     None if lengths is None else torch.from_numpy(lengths))
    np.testing.assert_array_equal(got.numpy(), _loop(x, starts, out_len, lengths))


def test_shift_rows_lengths_equal_the_padded_gather_and_mask():
    """What the JAX package does around the gather (ops/fingerprint.py
    extract_adapter_batch): a zero-padded copy and a mask afterwards."""
    rng = np.random.default_rng(2)
    x = rng.normal(80, 12, (9, 1000)).astype(np.float32)
    starts = rng.integers(0, 1001, 9).astype(np.int32)
    lengths = rng.integers(0, 641, 9).astype(np.int32)
    padded = np.concatenate([x, np.zeros((9, 640), np.float32)], axis=1)
    want = np.where(np.arange(640)[None, :] < lengths[:, None], np.asarray(shift_rows_auto(padded, starts, 640)), 0.0)
    got = shift_rows(torch.from_numpy(x), torch.from_numpy(starts), 640, torch.from_numpy(lengths))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("K", [1, 2, 3])
def test_shift_rows_of_k_windows_a_row_equal_the_repeated_signal(K):
    rng = np.random.default_rng(K)
    x = rng.normal(80, 12, (7, 2000)).astype(np.float32)
    starts = rng.integers(-5, 1300, 7 * K).astype(np.int32)
    got = shift_rows(torch.from_numpy(x), torch.from_numpy(starts), 800)
    want = shift_rows_auto(np.tile(x, (K, 1)), starts, 800)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_shift_rows_rejects_starts_that_are_no_multiple_of_the_rows():
    x = torch.zeros((4, 100))
    with pytest.raises(ValueError):
        shift_rows_plain(x, torch.zeros(6, dtype=torch.int32), 10)
    with pytest.raises(ValueError):
        shift_rows(x, torch.zeros(8, dtype=torch.int32), 10, torch.zeros(4, dtype=torch.int32))
