"""Port parity: the consensus-refined fingerprints of the tRNA path
(ops/fingerprint.fingerprints_consensus_refined: K5, K4, K2, K3 twice and
K10's plain versions) and peak picking from a slice origin, against the
jitted JAX functions.

Inputs: numpy-seeded synthetic barcoded tRNA reads (the port's copy of
utils/synthetic, with and without a poly(A), uniform and real-fitted
dwell times) cut at their JAX start_peak boundaries. Held exactly: the
fingerprint and dwell times bit for bit, every adapter event statistic,
the matched consensus segment, the barcode start and the outlier gate;
with the shipped gates and with wide ones (every read passes the gate).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from warpdemux_tpu.config.utils import get_model_spc_config as jax_spc
from warpdemux_tpu.detect import boundaries as jax_bd
from warpdemux_tpu.ops import fingerprint as jax_fp
from warpdemux_tpu.ops import peaks as jax_peaks
from warpdemux_tpu_torch.config.utils import get_model_spc_config
from warpdemux_tpu_torch.models.consensus_data import CONSENSUS
from warpdemux_tpu_torch.ops import fingerprint as fp
from warpdemux_tpu_torch.ops import peaks
from warpdemux_tpu_torch.utils.synthetic import (
    real_dwell_sampler,
    synth_trna_barcoded_read,
    trna_barcode_patterns,
)

MODEL = "WDX4_tRNA_rna004_v1_0"
L = 10000
QUERY = np.asarray(CONSENSUS["rna004_130bps_v1_0"], np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One CPU thread for torch here: the test workers share the machine's
    cores, and this file's many small operations gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reads():
    """48 reads: poly(A) or none, uniform or real-fitted dwell times, and
    their JAX start_peak adapter boundaries."""
    rng = np.random.default_rng(11)
    pats = trna_barcode_patterns(4, 25)
    x = np.zeros((48, L), np.float32)
    lens = np.zeros(48, np.int32)
    for k in range(48):
        kw = {"polya_len": (600, 0)[k % 2]}
        if k % 3 == 2:
            kw["dwell"] = real_dwell_sampler()
        sig, _ = synth_trna_barcoded_read(rng, pats[k % 4], **kw)
        n = min(L, sig.size)
        x[k, :n], lens[k] = sig[:n], n
    det = jax_bd.detect_boundaries_with_fallback(x, lens, jax_spc(MODEL).detect, with_stats=False)
    return x, lens, np.array(det.adapter_start), np.array(det.adapter_end)


@pytest.mark.parametrize("gates", ["shipped", "wide"])
def test_consensus_fingerprints_equal_jax(reads, gates):
    x, lens, a0, a1 = reads
    spc, jspc = get_model_spc_config(MODEL), jax_spc(MODEL)
    sx, jsx = spc.seg_extra, jspc.seg_extra
    if gates == "wide":
        wide = dict(consensus_subseq_match_ub_start=1000, consensus_subseq_match_lb_end=0,
                    consensus_subseq_match_ub_end=1000)
        sx, jsx = replace(sx, **wide), replace(jsx, **wide)
    got = fp.fingerprints_consensus_refined(
        torch.from_numpy(x), torch.from_numpy(lens), torch.from_numpy(a0), torch.from_numpy(a1),
        torch.from_numpy(QUERY), spc.fingerprint, sx,
    )
    want = jax_fp.fingerprints_consensus_refined(x, lens, a0, a1, QUERY, jspc.fingerprint, jsx)
    for name in got.base._fields:
        g, w = getattr(got.base, name).numpy(), np.asarray(getattr(want.base, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    for name in ("outlier", "seg_query_start", "seg_query_end", "sig_barcode_start"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    ok = got.base.ok.numpy()
    assert ok.sum() >= 40  # the planted reads pass
    if gates == "wide":
        assert not got.outlier.numpy().any()


def test_outlier_gate_fires_on_reads_without_the_consensus(reads):
    """Adapters of noise: the match lands anywhere, the gate flags most,
    as JAX does."""
    x, lens, a0, a1 = reads
    rng = np.random.default_rng(12)
    noise = (68.0 + rng.normal(0, 7.0, x.shape)).astype(np.float32)
    spc, jspc = get_model_spc_config(MODEL), jax_spc(MODEL)
    got = fp.fingerprints_consensus_refined(
        torch.from_numpy(noise), torch.from_numpy(lens), torch.from_numpy(a0), torch.from_numpy(a1),
        torch.from_numpy(QUERY), spc.fingerprint, spc.seg_extra,
    )
    want = jax_fp.fingerprints_consensus_refined(noise, lens, a0, a1, QUERY, jspc.fingerprint, jspc.seg_extra)
    np.testing.assert_array_equal(got.outlier.numpy(), np.asarray(want.outlier))
    np.testing.assert_array_equal(got.base.ok.numpy(), np.asarray(want.base.ok))
    assert got.outlier.numpy().sum() >= 24


@pytest.mark.parametrize("seed", [0, 1])
def test_find_peaks_from_a_slice_origin_equals_jax(seed):
    """min_pos masks the plateaus that start at or before the origin, on
    plateau-rich quantized scores, at max_distance 10 (the tRNA path's)."""
    rng = np.random.default_rng(seed)
    B, W = 16, 2048
    scores = np.round(rng.random((B, W)) * 8).astype(np.float32) / 8
    n_scores = rng.integers(W // 2, W + 1, B).astype(np.int32)
    dist = np.full(B, 9, np.int32)
    min_pos = rng.integers(0, W, B).astype(np.int32)
    min_pos[:3] = [0, W - 1, n_scores[2]]
    got = peaks.find_peaks_batch(
        torch.from_numpy(scores), torch.from_numpy(n_scores), torch.from_numpy(dist), 10,
        min_pos=torch.from_numpy(min_pos),
    )
    want = jax_peaks.find_peaks_batch(scores, n_scores, dist, 10, min_pos=min_pos)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    keep = got[0].numpy()
    for b in range(B):
        assert not keep[b, : min_pos[b] + 1].any()
    mask, _ = peaks.peak_mask_batch(torch.from_numpy(scores), torch.from_numpy(n_scores))
    mask_cut, _ = peaks.peak_mask_batch(torch.from_numpy(scores), torch.from_numpy(n_scores),
                                       torch.from_numpy(min_pos))
    assert bool((mask_cut <= mask).all()) and int(mask_cut.sum()) < int(mask.sum())
