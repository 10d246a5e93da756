"""Port parity: peak picking (kernel K3's plain version) against the JAX
package's jnp path, its Pallas kernel in interpret mode and scipy: masks
and selected positions are exact, ties go to the later position."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import find_peaks

from warpdemux_tpu.ops import peaks as jax_peaks
from warpdemux_tpu.ops.peaks_pallas import suppress_by_distance_pallas
from warpdemux_tpu_torch.ops import peaks


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
