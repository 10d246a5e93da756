"""Port parity: peak picking (kernel K3's plain version) against the JAX
package's jnp path, its Pallas kernel in interpret mode and scipy: masks
and selected positions are exact, ties go to the later position."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import find_peaks

from warpdemux_tpu.ops import peaks as jax_peaks
from warpdemux_tpu.ops.peaks_pallas import suppress_by_distance_pallas
from warpdemux_tpu_torch import _cuda
from warpdemux_tpu_torch.ops import peaks

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import k3_edge_cases  # noqa: E402

# the inputs kernel K3 is held to on the GPU
EDGE_CASES = k3_edge_cases()


def _scores(rng, B, L, quantize=False):
    s = rng.gamma(2.0, 1.0, (B, L)).astype(np.float32)
    if quantize:  # plateaus and exact ties
        s = np.round(s * 4) / 4
    return s


@pytest.mark.parametrize("quantize", [False, True])
def test_peak_mask_matches_jax(quantize):
    rng = np.random.default_rng(1 + quantize)
    B, L = 8, 1500
    s = _scores(rng, B, L, quantize)
    n = rng.integers(200, L + 1, B).astype(np.int32)
    got, cnt = peaks.peak_mask_batch(torch.from_numpy(s), torch.from_numpy(n))
    want, wcnt = jax_peaks.peak_mask_batch(jnp.asarray(s), jnp.asarray(n))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))


@pytest.mark.parametrize("quantize", [False, True])
def test_suppress_matches_pallas_interpret_and_jnp(quantize):
    rng = np.random.default_rng(7 + quantize)
    B, L = 8, 1200
    s = _scores(rng, B, L, quantize)
    n = np.full(B, L, np.int32)
    is_peak, _ = peaks.peak_mask_batch(torch.from_numpy(s), torch.from_numpy(n))
    dist = rng.integers(1, 8, B).astype(np.int32)
    got = peaks.suppress_by_distance(
        torch.from_numpy(s), is_peak, torch.from_numpy(dist), 7
    ).numpy()
    want = suppress_by_distance_pallas(
        jnp.asarray(s), jnp.asarray(is_peak.numpy()), jnp.asarray(dist), 7,
        interpret=True,
    )
    np.testing.assert_array_equal(got, np.asarray(want))
    want_jnp = jax_peaks.suppress_by_distance(
        jnp.asarray(s), jnp.asarray(is_peak.numpy()), jnp.asarray(dist), 7
    )
    np.testing.assert_array_equal(got, np.asarray(want_jnp))


def test_find_peaks_matches_scipy():
    rng = np.random.default_rng(3)
    B, L = 6, 800
    s = rng.normal(size=(B, L)).astype(np.float32)  # unique scores
    dist = np.array([1, 2, 3, 5, 6, 7], np.int32)
    keep, cnt = peaks.find_peaks_batch(
        torch.from_numpy(s), torch.full((B,), L), torch.from_numpy(dist), 8
    )
    for b in range(B):
        want, _ = find_peaks(s[b], distance=int(dist[b]))
        np.testing.assert_array_equal(np.nonzero(keep[b].numpy())[0], want)
        assert cnt[b] == len(want)


@pytest.mark.parametrize("quantize", [False, True])
def test_select_top_peaks_matches_jax(quantize):
    """Exact positions on the rows with enough peaks; with quantized
    scores many kept peaks tie, and the later one must win."""
    rng = np.random.default_rng(11 + quantize)
    B, L, k = 8, 6272, 110
    s = _scores(rng, B, L, quantize)
    n = rng.integers(1500, L + 1, B).astype(np.int32)
    keep, cnt = peaks.find_peaks_batch(
        torch.from_numpy(s), torch.from_numpy(n), torch.full((B,), 6), 7
    )
    got, ok = peaks.select_top_peaks(torch.from_numpy(s), keep, cnt, k)
    want, wok = jax_peaks.select_top_peaks(
        jnp.asarray(s), jnp.asarray(keep.numpy()), jnp.asarray(cnt.numpy()), k
    )
    wok = np.asarray(wok)
    np.testing.assert_array_equal(ok.numpy(), wok)
    assert wok.all()
    np.testing.assert_array_equal(
        np.sort(got.numpy(), 1), np.sort(np.asarray(want), 1)
    )


def test_select_top_peaks_tie_prefers_later_position():
    s = np.zeros((1, 20), np.float32)
    s[0, [3, 8, 13, 17]] = [2.0, 1.0, 1.0, 1.0]
    keep = torch.from_numpy(s > 0)
    got, ok = peaks.select_top_peaks(torch.from_numpy(s), keep, torch.tensor([4]), 2)
    assert bool(ok[0])
    assert sorted(got[0].tolist()) == [3, 17]


@pytest.mark.parametrize("case", range(len(EDGE_CASES)), ids=[c[0] for c in EDGE_CASES])
def test_suppress_plain_matches_jax_at_edge_cases(case):
    """K3's plain version (the kernel's yardstick) on rows of 1 to 6272
    positions, distances from 1 to above max_distance, reaches to 32, empty
    and full masks, runs of equal scores, the staircases that take a round a
    winner, peaks at the row's ends and across 32-position word boundaries,
    inf, -inf and NaN scores, and rows at and beyond the longest the
    bit-word kernel takes: the exact mask of the JAX package's jnp
    path (the one the step runs on the CPU) and of its Pallas kernel in
    interpret mode. The two JAX paths agree on every non-finite score here;
    they differ only for a flagged score at or below -3.4e38 beside a dead
    neighbour (the Pallas kernel pads with -3.4e38, the jnp path with -inf),
    where neither ends: no case holds one."""
    _, s, flags, dist, W = EDGE_CASES[case]
    got = peaks.suppress_by_distance_plain(
        torch.from_numpy(s), torch.from_numpy(flags), torch.from_numpy(dist), W
    ).numpy()
    want = jax_peaks.suppress_by_distance(jnp.asarray(s), jnp.asarray(flags), jnp.asarray(dist), W)
    np.testing.assert_array_equal(got, np.asarray(want))
    want = suppress_by_distance_pallas(
        jnp.asarray(s), jnp.asarray(flags), jnp.asarray(dist), W, interpret=True
    )
    np.testing.assert_array_equal(got, np.asarray(want))
    assert not (got & ~flags).any()


def test_suppress_counts_the_rounds_of_each_row():
    """count_rounds changes nothing of the mask and counts a row's rounds:
    the falling staircase of 512 peaks two apart at distance 3 crowns one
    winner in two a round."""
    _, s, flags, dist, W = next(c for c in EDGE_CASES if c[0].startswith("staircases"))
    args = (torch.from_numpy(s), torch.from_numpy(flags), torch.from_numpy(dist), W)
    keep, rounds = peaks.suppress_by_distance_plain(*args, count_rounds=True)
    assert torch.equal(keep, peaks.suppress_by_distance_plain(*args))
    assert rounds.tolist() == [256, 256]
    none = torch.zeros_like(args[1])
    assert peaks.suppress_by_distance_plain(args[0], none, args[2], W, count_rounds=True)[1].tolist() == [0, 0]


@pytest.mark.parametrize(
    "L, W, shared_bytes",
    [(1, 7, 32), (32, 7, 32), (33, 1, 48), (6271, 7, 2368), (6272, 7, 2368), (6272, 32, 2368),
     (6272, 33, 0), (6273, 7, 2384), (619_000, 7, 232_144), (620_000, 7, 0)],
)
def test_suppress_variant_follows_the_reach_and_the_shared_memory_limit(L, W, shared_bytes):
    """K3's launch geometry, chosen from (L, max_distance) alone: three bit
    words for every 32 positions, four pad words, in whole 16-byte vectors;
    0 bytes (the byte-flag kernel with its device scratch) where the reach
    may exceed the kernel's 64-bit windows or the words outgrow a block."""
    assert peaks._suppress_shared_bytes(L, W) == shared_bytes
    if shared_bytes:
        assert shared_bytes == 16 * -(-(3 * -(-L // 32) + 4) // 4) <= _cuda.MAX_SHARED_BYTES
        assert W <= peaks._SUPPRESS_MAX_REACH


@pytest.mark.parametrize("L", [1024, 6271, 6272])
def test_select_top_peaks_on_rows_short_of_peaks_matches_jax(L):
    """Rows with fewer than k kept peaks (the fingerprint fails there) fill
    their positions as JAX does: the later of each pair of -inf positions,
    the latest pairs first. Those positions set the dwell-time statistics
    that the failed_reads CSV carries."""
    rng = np.random.default_rng(L)
    B, k = 6, 110
    s = _scores(rng, B, L, False)
    keep = np.zeros((B, L), bool)
    for r, n_peaks in enumerate((0, 1, 5, 40, 109, 0)):
        keep[r, rng.choice(L // 2, n_peaks, replace=False) * 2] = True
    cnt = keep.sum(1).astype(np.int32)
    got, ok = peaks.select_top_peaks(torch.from_numpy(s), torch.from_numpy(keep), torch.from_numpy(cnt), k)
    want, wok = jax_peaks.select_top_peaks(jnp.asarray(s), jnp.asarray(keep), jnp.asarray(cnt), k)
    assert not np.asarray(wok).any() and not ok.numpy().any()
    np.testing.assert_array_equal(np.sort(got.numpy(), 1), np.sort(np.asarray(want), 1))
