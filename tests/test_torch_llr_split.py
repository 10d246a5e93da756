"""Port parity: the LLR changepoint split (detect/boundaries.py
`llr_split_plain`, the plain version of kernel K14) against the jitted JAX
functions it stands for, bit for bit: the split of every window equals
`_llr_refine`'s (warpdemux_tpu/detect/boundaries.py:201) and
`_llr_split_window`'s (:229).

A window of W samples whose coarse position is its middle is its own
refinement window (start 0), so `_llr_refine` returns its split; a window
read from start 0 with n_valid = its row end is `_llr_split_window`'s.
The windows come from a seeded default_rng (chip_smoke.llr_windows) and
the edge rows of chip_smoke.LLR_EDGES: constant windows (every variance
clamped to 1e-6), palindromes whose two end splits tie to the last bit,
NaN and inf samples (jnp.argmin takes the first NaN), squares that
overflow, a NaN past the row's end, row ends that mask every split. Plus
row 795 of the seed-0 bench batch, whose two end splits tie within an ulp.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import LLR_EDGES, LLR_MIN_SPLIT, llr_edge_windows, llr_windows  # noqa: E402
from warpdemux_tpu.detect import boundaries as jax_bd  # noqa: E402
from warpdemux_tpu_torch.detect import boundaries as bd  # noqa: E402
from warpdemux_tpu_torch.ops.numerics import prefix_sums  # noqa: E402
from warpdemux_tpu_torch.utils.synthetic import synth_minibatch  # noqa: E402

_refine = jax.jit(jax_bd._llr_refine, static_argnums=2)
_split_window = jax.jit(jax_bd._llr_split_window, static_argnums=2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(win, weff=None, min_split=1):
    x = torch.from_numpy(win)
    c1, c2 = prefix_sums(x), prefix_sums(x * x)
    we = None if weff is None else torch.from_numpy(weff)
    got = bd.llr_split_plain(c1, c2, we, min_split)
    assert got.dtype == torch.int32 and torch.equal(bd.llr_split(c1, c2, we, min_split), got)
    return got.numpy()


def _jax_refine(win):
    R, W = win.shape
    return np.asarray(_refine(win, jnp.full(R, W // 2, jnp.int32), W // 2, 0, W))


def _jax_split_window(win, weff, min_split):
    R, W = win.shape
    return np.asarray(_split_window(win, jnp.zeros(R, jnp.int32), W, jnp.full(R, min_split, jnp.int32), weff))


def test_refinement_windows_of_800():
    """2 x 64 windows of 800 samples, every split counted."""
    win, _ = llr_windows(2 * 64, 800, 0)
    np.testing.assert_array_equal(_port(win), _jax_refine(win))


def test_split_windows_of_6000():
    """16 windows of 6000 samples, each with its own end, splits from the
    tRNA chemistry's min_obs_adapter."""
    win, weff = llr_windows(16, 6000, 1)
    weff[1::4] = LLR_MIN_SPLIT + np.arange(4)  # ends just past the first split
    np.testing.assert_array_equal(_port(win, weff, LLR_MIN_SPLIT), _jax_split_window(win, weff, LLR_MIN_SPLIT))


@pytest.mark.parametrize("edge", LLR_EDGES)
def test_refinement_edge_rows(edge):
    win, _ = llr_edge_windows(800)
    row = win[LLR_EDGES.index(edge)][None]
    np.testing.assert_array_equal(_port(row), _jax_refine(row))


@pytest.mark.parametrize("edge", LLR_EDGES)
def test_split_window_edge_rows(edge):
    win, weff = llr_edge_windows(6000)
    i = LLR_EDGES.index(edge)
    row, end = win[i][None], weff[i : i + 1]
    np.testing.assert_array_equal(_port(row, end, LLR_MIN_SPLIT), _jax_split_window(row, end, LLR_MIN_SPLIT))


def test_palindromes_tie_at_both_ends():
    """The edge palindromes' first and last splits cost the same to the
    last bit and no split costs less: the split is the first one."""
    win, _ = llr_edge_windows(800)
    for edge in ("palindrome", "integer palindrome"):
        cost = bd._llr_cost(torch.from_numpy(win[LLR_EDGES.index(edge)][None]))[0]
        assert cost[0] == cost[-1] == cost.min(), edge
        assert _port(win[LLR_EDGES.index(edge)][None])[0] == 1


def test_tied_bench_window():
    """Row 795 of the seed-0 bench batch at [3654, 4454): its end splits tie
    within an ulp; JAX's split is the last one."""
    adc, off, sc, _ = synth_minibatch(np.random.default_rng(0), 1000, 10000)
    win = ((adc[795].astype(np.float32) + off[795]) * sc[795])[None, 3654:4454]
    got = _port(win)
    np.testing.assert_array_equal(got, _jax_refine(win))
    assert got[0] == 799


def test_step_functions_take_the_first_nan():
    """A NaN sample reaches the step's own functions as it reaches JAX's:
    the refinement and the split window agree with the jitted JAX ones."""
    rng = np.random.default_rng(7)
    x = rng.normal(90, 6, (4, 9000)).astype(np.float32)
    x[0, 2100] = np.nan
    x[1, 5000] = np.nan
    x[3, 100] = np.nan
    coarse = np.array([[2000, 4800, 3000, 400]], np.int32)
    got = bd._llr_refine(torch.from_numpy(x), torch.from_numpy(coarse), 400).numpy()
    want = np.asarray(_refine(x, coarse[0], 400, 0, 9000))
    np.testing.assert_array_equal(got[0], want)
    starts = np.array([0, 1000, 2500, 0], np.int32)
    lens = np.array([9000, 9000, 7000, 3000], np.int32)
    got = bd._llr_split_window(torch.from_numpy(x), torch.from_numpy(starts), 6000, LLR_MIN_SPLIT,
                               torch.from_numpy(lens)).numpy()
    want = np.asarray(_split_window(x, starts, 6000, jnp.full(4, LLR_MIN_SPLIT, jnp.int32), lens))
    np.testing.assert_array_equal(got, want)
