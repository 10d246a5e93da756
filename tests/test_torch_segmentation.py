"""Port parity: windowed t-test (kernel K2's plain version), segment means,
the segmentation contract and the fingerprint stage against the JAX
package."""

import numpy as np
import pytest
import torch

from warpdemux_tpu.ops.segmentation import segment_means as jax_segment_means
from warpdemux_tpu.ops.segmentation import segment_signal_batch as jax_segment
from warpdemux_tpu.ops.segmentation import windowed_t_test as jax_ttest
from warpdemux_tpu.ops.ttest_pallas import windowed_t_test_pallas
from warpdemux_tpu.utils.synthetic import synth_batch, synth_read
from warpdemux_tpu_torch.ops.segmentation import (
    segment_means,
    segment_signal_batch,
    windowed_t_test,
)

# The eager jnp call divides by the correctly rounded sqrt and the Pallas
# kernel (interpret mode) by its own; the port multiplies by XLA:CPU's
# rsqrt, as the jitted function does (equal bits: test_torch_xla_rsqrt.py).
# The three differ by that last operation: 2 ulp (tests/test_segmentation.py:131
# holds the kernel to the jnp path at the same 2 ulp for the same reason).
TTEST_RTOL = 2.0**-22


def _adapters(rng, B, L):
    """Event-structured adapter-like rows with per-row valid lengths."""
    x = np.zeros((B, L), np.float32)
    n = rng.integers(L // 3, L + 1, B).astype(np.int32)
    for b in range(B):
        sig, _ = synth_read(rng, adapter_len=L, polya_len=0, rna_len=0)
        x[b, : n[b]] = sig[: n[b]]
    return x, n


@pytest.mark.parametrize("B, L, seed", [(9, 2048, 23), (4, 6272, 5)])
def test_windowed_t_test_matches_jax(B, L, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(70, 12, (B, L)).astype(np.float32)
    n = rng.integers(100, L + 1, B).astype(np.int32)
    w = rng.integers(1, 13, B).astype(np.int32)
    got, n_scores = windowed_t_test(
        torch.from_numpy(x), torch.from_numpy(n), torch.from_numpy(w), 12
    )
    want, n_want = jax_ttest(x, n, w, 12)
    np.testing.assert_array_equal(n_scores.numpy(), np.asarray(n_want))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TTEST_RTOL, atol=1e-30)
    want_pallas = windowed_t_test_pallas(x, n, w, 12, interpret=True)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want_pallas), rtol=TTEST_RTOL, atol=1e-30
    )


def test_segment_means_match_jax():
    rng = np.random.default_rng(2)
    B, L, E = 6, 3000, 40
    x = rng.normal(80, 10, (B, L)).astype(np.float32)
    n = rng.integers(1500, L + 1, B).astype(np.int32)
    bounds = np.sort(rng.integers(0, 1500, (B, E - 1)), axis=1)
    bounds = np.concatenate([np.zeros((B, 1)), bounds, n[:, None]], 1).astype(np.int32)
    got = segment_means(torch.from_numpy(x), torch.from_numpy(bounds), torch.from_numpy(n))
    want = np.asarray(jax_segment_means(x, bounds, n))
    # both center the row on its mean, whose float32 sum is taken in
    # another order: a few ulp of the ~80 pA level
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_segment_signal_batch_matches_jax():
    """Changepoints, dwell times and the ok bits are identical; event
    means agree to the segment-means tolerance."""
    rng = np.random.default_rng(8)
    x, n = _adapters(rng, 8, 6272)
    got = segment_signal_batch(torch.from_numpy(x), torch.from_numpy(n), 110, 6, 12)
    want = jax_segment(x, n, 110, 6, 12)
    ok = np.asarray(want[2])
    assert ok.any()
    np.testing.assert_array_equal(got[2].numpy(), ok)
    np.testing.assert_array_equal(got[5].numpy()[ok], np.asarray(want[5])[ok])
    np.testing.assert_array_equal(got[1].numpy()[ok], np.asarray(want[1])[ok])
    np.testing.assert_allclose(got[0].numpy()[ok], np.asarray(want[0])[ok], rtol=0, atol=1e-4)


def test_fingerprints_from_boundaries_match_jax():
    """The fingerprint stage on the JAX-detected boundaries of synthetic
    reads: identical ok bits and dwell times, fingerprints within float32
    rounding of the normalized event means."""
    from warpdemux_tpu.config.utils import get_model_spc_config as jax_spc
    from warpdemux_tpu.detect.boundaries import DetectConfig, detect_boundaries_batch
    from warpdemux_tpu.ops.fingerprint import fingerprints_from_boundaries as jax_fpt
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.ops.fingerprint import fingerprints_from_boundaries

    rng = np.random.default_rng(12)
    sigs, lens, _ = synth_batch(rng, 12)
    spc = jax_spc("WDX4_rna004_v1_0")
    det = detect_boundaries_batch(sigs, lens, DetectConfig())  # llr method
    a0, a1 = np.array(det.adapter_start), np.array(det.adapter_end)
    want = jax_fpt(sigs, lens, a0, a1, spc.fingerprint)
    got = fingerprints_from_boundaries(
        torch.from_numpy(sigs), torch.from_numpy(lens), torch.from_numpy(a0),
        torch.from_numpy(a1), get_model_spc_config("WDX4_rna004_v1_0").fingerprint,
    )
    ok = np.asarray(want.ok)
    assert ok.sum() >= 8
    np.testing.assert_array_equal(got.ok.numpy(), ok)
    np.testing.assert_array_equal(got.dwell.numpy()[ok], np.asarray(want.dwell)[ok])
    np.testing.assert_allclose(got.fpt.numpy()[ok], np.asarray(want.fpt)[ok], rtol=0, atol=1e-4)
    # rows that fail segmentation carry unspecified changepoints in both
    np.testing.assert_array_equal(
        got.adapter_dt_med.numpy()[ok], np.asarray(want.adapter_dt_med)[ok]
    )
