"""Port parity: the subsequence DTW of the tRNA path (kernel K10's plain
version) against the jitted JAX function and the scalar golden.

Inputs are numpy-seeded (B, 121) series of normalized event means, with the
84-event consensus embedded in noise in half the rows, at several psi and
series lengths. Against JAX: start and end exact, the distance bit-equal
(the plain version takes XLA:CPU's fused multiply-add for d + best and its
product with float32(1 / r) for the division). Against the float64 golden:
start and end exact where the consensus is embedded, the distance within
rtol 1e-5 (float32 against float64 sums over 84 + steps).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from warpdemux_tpu.ops import subsequence as jax_ss
from warpdemux_tpu_torch import _cuda
from warpdemux_tpu_torch.models.consensus_data import CONSENSUS
from warpdemux_tpu_torch.ops import subsequence as ss

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import k10_edge_cases  # noqa: E402

QUERY = np.asarray(CONSENSUS["rna004_130bps_v1_0"], np.float32)
E = 121


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One CPU thread for torch here: the test workers share the machine's
    cores, and this file's many small operations gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _series(seed, B=64, C=E, noise=0.3):
    """(series, lens, embedded rows): the consensus planted at a random
    offset (with noise) in the even rows."""
    rng = np.random.default_rng(seed)
    s = rng.normal(0, 1, (B, C)).astype(np.float32)
    planted = np.arange(0, B, 2)
    for b in planted:
        o = int(rng.integers(0, C - QUERY.size + 1))
        s[b, o : o + QUERY.size] = QUERY + rng.normal(0, noise, QUERY.size)
    return s, np.full(B, C, np.int32), planted


def _both(s, lens, psi=(5, 0, 40, 0), penalty=1.5):
    got = [a.numpy() for a in ss.subsequence_dtw(
        torch.from_numpy(QUERY), torch.from_numpy(s), torch.from_numpy(lens), penalty, psi
    )]
    want = [np.asarray(a) for a in jax_ss.subsequence_dtw_batch(QUERY, s, lens, penalty=penalty, psi=psi)]
    return got, want


def _assert_equal(got, want):
    for name, g, w in zip(("start", "end", "dist"), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32), err_msg=name)


@pytest.mark.parametrize("psi", [(5, 0, 40, 0), (0, 0, 0, 0), (10, 0, 200, 0), (84, 0, 120, 0)],
                         ids=["shipped", "unrelaxed", "psi_2b-beyond-the-series", "all-relaxed"])
def test_plain_matches_jax_bit_for_bit(psi):
    s, lens, _ = _series(1)
    _assert_equal(*_both(s, lens, psi))


@pytest.mark.parametrize("penalty", [0.0, 0.5, 3.0])
def test_plain_matches_jax_at_other_penalties(penalty):
    s, lens, _ = _series(2)
    _assert_equal(*_both(s, lens, penalty=penalty))


def test_plain_matches_jax_at_ragged_series_lengths():
    """Lengths of 0 (no valid end: end 1, distance inf), 1, shorter than
    the query and beyond the series' width."""
    s, lens, _ = _series(3)
    lens[:8] = [0, 1, 2, 40, 83, 84, 121, 126]
    lens[8:] = np.random.default_rng(3).integers(1, E + 1, lens.size - 8)
    got, want = _both(s, lens)
    _assert_equal(got, want)
    assert got[1][0] == 1 and np.isinf(got[2][0])


def test_plain_matches_jax_on_ties_and_non_finite_series():
    s, lens, _ = _series(4, B=12)
    s[0] = 0.5  # constant
    s[1] = np.round(s[1])  # exact ties between cells
    s[2, 5] = np.nan
    s[3, :] = np.nan
    s[4, 50] = np.inf
    s[5, :] = np.inf
    s[6, 7] = -np.inf
    got, want = _both(s, lens)
    for name, g, w in zip(("start", "end", "dist"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)  # NaN where JAX has NaN
    assert np.isnan(got[2][2]) and np.isnan(got[2][3])


def test_ref_matches_the_jax_golden_and_the_plain_version():
    s, lens, planted = _series(5, B=16)
    start, end, dist = [a.numpy() for a in ss.subsequence_dtw_plain(
        torch.from_numpy(QUERY), torch.from_numpy(s), torch.from_numpy(lens)
    )]
    for b in range(s.shape[0]):
        ref = ss.subsequence_dtw_ref(QUERY, s[b], 1.5, (5, 0, 40, 0))
        assert ref == jax_ss.subsequence_dtw_ref(QUERY, s[b], 1.5, (5, 0, 40, 0))
        if b in planted:
            assert (start[b], end[b]) == ref[:2]
            np.testing.assert_allclose(dist[b], ref[2], rtol=1e-5)


def test_embedded_consensus_is_found():
    """The planted query comes back where it was put, to an event."""
    rng = np.random.default_rng(6)
    B = 16
    s = rng.normal(0, 1, (B, E)).astype(np.float32)
    offsets = rng.integers(0, E - QUERY.size + 1, B)
    for b, o in enumerate(offsets):
        s[b, o : o + QUERY.size] = QUERY + rng.normal(0, 0.1, QUERY.size)
    start, end, _ = ss.subsequence_dtw(torch.from_numpy(QUERY), torch.from_numpy(s), torch.full((B,), E))
    assert np.abs(start.numpy() - offsets).max() <= 1
    assert np.abs(end.numpy() - (offsets + QUERY.size)).max() <= 1


def test_cpu_tensors_take_the_plain_version():
    _cuda.reset_launches()
    s, lens, _ = _series(7, B=4)
    ss.subsequence_dtw(torch.from_numpy(QUERY), torch.from_numpy(s), torch.from_numpy(lens))
    assert _cuda.launches["wdx_subseq_dtw"] == 0


@pytest.mark.parametrize("case", k10_edge_cases(), ids=lambda case: case[0])
def test_k10_edge_cases_plain_matches_jax(case):
    """The inputs kernel K10 is held to on the card (chip_smoke.k10_edge_cases),
    one case a test: the plain version gives the JAX function's bits."""
    name, q, s, lens, psi = case
    got = [a.numpy() for a in ss.subsequence_dtw(torch.from_numpy(q), torch.from_numpy(s),
                                                 torch.from_numpy(lens), 1.5, psi)]
    want = [np.asarray(a) for a in jax_ss.subsequence_dtw_batch(q, s, lens, penalty=1.5, psi=psi)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_k10_variant_by_query_length():
    """The warp kernel for queries of at most 256 (3 rows a lane for a
    multiple of 3 up to 96, else 8), at any series width; the block kernel
    from 257 to 1023 where its shared memory fits; ValueError beyond both."""
    rows = {r: ss._rows_per_lane(r, E) for r in (1, 3, 32, 33, 64, 65, 84, 96, 97, 99, 255, 256, 257, 1023)}
    assert rows == {1: 8, 3: 3, 32: 8, 33: 3, 64: 8, 65: 8, 84: 3, 96: 3, 97: 8, 99: 8, 255: 8, 256: 8, 257: 0, 1023: 0}
    assert ss._rows_per_lane(84, 10**6) == 3
    for r, c in ((0, E), (84, 0), (1024, E), (257, 20000)):
        with pytest.raises(ValueError, match="beyond K10"):
            ss._rows_per_lane(r, c)
