"""Port parity: boundary detection (kernels K6 and K7's plain versions, the
CNN region prior, the LLR fallback chain) against the JAX package."""

import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpdemux_tpu.config.utils import get_model_spc_config as jax_spc
from warpdemux_tpu.detect import boundaries as jax_bd
from warpdemux_tpu.detect import cnn as jax_cnn
from warpdemux_tpu.ops.rolling_pallas import (
    rolling_mean_var_pallas,
    rolling_run_sum_pallas,
)
from warpdemux_tpu.utils.synthetic import synth_batch
from warpdemux_tpu_torch.config.utils import get_model_spc_config
from warpdemux_tpu_torch.detect import boundaries as bd
from warpdemux_tpu_torch.models.registry import load_cnn

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import synth_minibatch  # noqa: E402

MODEL = "WDX4_rna004_v1_0"


def _bench_rows(n, seed=0):
    """Calibrated reads of bench.py's generator (seed 0 = the bench batch)."""
    adc, off, sc, lens = synth_minibatch(np.random.default_rng(seed), n, 10000)
    x = (adc.astype(np.float32) + off[:, None]) * sc[:, None]
    return x.astype(np.float32), lens


def test_rolling_mean_var_matches_jax():
    """Bit-identical to the jitted jnp path (same blocked prefix sums, same
    fused multiply-add); within tests/test_detect.py:106's prefix-sum tolerance
    of the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(31)
    B, L = 5, 2048
    x = rng.normal(80, 12, (B, L)).astype(np.float32)
    got = [a.numpy() for a in bd.rolling_mean_var(torch.from_numpy(x), 300, 150)]
    # jitted, as in the step: XLA fuses s2/n - mean*mean into one FMA only
    # inside a compiled program
    stats = jax.jit(lambda a: jax_bd._rolling_stats(a, 300, 150))
    want = [np.asarray(a) for a in stats(x)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    m, vf, vw = [np.asarray(a) for a in rolling_mean_var_pallas(x, 300, 150, interpret=True)]
    np.testing.assert_allclose(got[0], m, rtol=5e-4, atol=0.05)
    for g, w, win in ((got[1], vf, 300), (got[2], vw, 150)):
        np.testing.assert_allclose(g[:, : L - win], w[:, : L - win], rtol=3e-3, atol=0.1)
        np.testing.assert_allclose(g[:, L - win :], w[:, L - win :], atol=5.0)


@pytest.mark.parametrize("w", [1, 100, 130, 5000])
def test_run_sum_exact(w):
    rng = np.random.default_rng(w)
    mask = rng.random((6, 3000)) < 0.4
    got = bd.run_sum(torch.from_numpy(mask), w).numpy()
    want = np.asarray(rolling_run_sum_pallas(jnp.asarray(mask), w, interpret=True))
    np.testing.assert_array_equal(got, want)


def test_cnn_region_prior_matches_jax():
    spc = get_model_spc_config(MODEL)
    x, lens = _bench_rows(16, seed=3)
    lens[:4] = [3000, 7000, 7168, 9000]
    pos = np.arange(x.shape[1])[None]
    xz = np.where(pos < lens[:, None], x, 0).astype(np.float32)
    cnn = load_cnn(spc.cnn_model_name)
    got = bd.cnn_region_mask(
        torch.from_numpy(xz), torch.from_numpy(lens), spc.detect, cnn, x.shape[1]
    ).numpy()
    params = jax_cnn.load_params(spc.cnn_model_name)
    want = np.asarray(
        jax_bd._cnn_region_mask(
            jnp.asarray(xz), jnp.asarray(lens), jax_spc(MODEL).detect, params,
            jnp.asarray(np.broadcast_to(pos, x.shape).astype(np.int32)), x.shape[1],
        )
    )
    assert want.sum() > 0
    np.testing.assert_array_equal(got, want)


def _assert_detect_equal(got, want):
    for name, value in got._asdict().items():
        np.testing.assert_array_equal(
            value.numpy(), np.asarray(getattr(want, name)), err_msg=name
        )


def test_detect_with_fallback_matches_jax_on_bench_reads():
    """The production configuration (CNN prior + LLR fallback) on 64 bench
    reads: every column the decision lane computes is identical."""
    spc = get_model_spc_config(MODEL)
    x, lens = _bench_rows(64)
    got = bd.detect_boundaries_with_fallback(
        torch.from_numpy(x), torch.from_numpy(lens), spc.detect,
        load_cnn(spc.cnn_model_name),
    )
    jspc = jax_spc(MODEL)
    want = jax_bd.detect_boundaries_with_fallback(
        x, lens, jspc.detect, jax_cnn.load_params(jspc.cnn_model_name),
        with_stats=False,
    )
    assert 0 < int(np.asarray(want.used_llr_fallback).sum())
    _assert_detect_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_detect_llr_matches_jax_on_synthetic_reads(seed):
    rng = np.random.default_rng(seed)
    sigs, lens, _ = synth_batch(rng, 24)
    lens[:3] = [1500, 2100, 4000]  # too short / short reads
    cfg = replace(get_model_spc_config(MODEL).detect, method="llr", fallback_to_llr=False)
    got = bd.detect_boundaries_with_fallback(torch.from_numpy(sigs), torch.from_numpy(lens), cfg)
    want = jax_bd.detect_boundaries_with_fallback(
        sigs, lens, jax_bd.DetectConfig(**cfg.__dict__), with_stats=False
    )
    assert np.asarray(want.success).sum() >= 12
    _assert_detect_equal(got, want)


@pytest.mark.parametrize(
    "change",
    [
        {"method": "start_peak"},
        {"real_signal_check": True},
        {"detect_med_shift": True},
    ],
)
def test_unported_detect_options_raise(change):
    cfg = replace(get_model_spc_config(MODEL).detect, **change)
    x, lens = _bench_rows(2)
    with pytest.raises(NotImplementedError):
        bd.detect_boundaries_batch(torch.from_numpy(x), torch.from_numpy(lens), cfg)
