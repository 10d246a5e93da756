"""Hand-written CUDA kernels (csrc/) against their plain PyTorch versions,
and the decision step on the GPU against the CPU path.

These need a CUDA GPU of compute capability 9.0 (the kernels are built for
sm_90a) and the CUDA toolkit; they carry the `cuda` marker and skip
elsewhere. Run them on the GPU host with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py imports jax, which that host lacks;
this file needs neither jax nor the JAX package.)
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import synth_minibatch  # noqa: E402
from warpdemux_tpu_torch import _cuda  # noqa: E402
from warpdemux_tpu_torch.detect import boundaries as bd  # noqa: E402
from warpdemux_tpu_torch.models.registry import load_model_arrays  # noqa: E402
from warpdemux_tpu_torch.ops import dtw, peaks, segmentation, select, window_gather  # noqa: E402

pytestmark = pytest.mark.cuda
MODEL = "WDX4_rna004_v1_0"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; the csrc/ kernels have no CPU mode")
    return torch.device("cuda", 0)


def _signal(dev, B=64, L=10000, seed=2):
    adc, off, sc, _ = synth_minibatch(np.random.default_rng(seed), B, L)
    t = lambda a: torch.as_tensor(a, device=dev)
    return (t(adc).float() + t(off)[:, None]) * t(sc)[:, None]


def _launched(name, fn):
    before = _cuda.launches[name]
    out = fn()
    torch.cuda.synchronize()
    assert _cuda.launches[name] == before + 1
    return out


@pytest.mark.parametrize("n_ref", [851, 2601])
def test_k1_dtw(dev, n_ref):
    Y = load_model_arrays(MODEL if n_ref == 851 else "WDX10_rna004_v1_0")["X_sv"]
    Y = torch.as_tensor(Y.astype(np.float32), device=dev)
    # the last 25 of 30 columns: a strided view, as the step's fingerprints are
    X = torch.as_tensor(np.random.default_rng(0).normal(0, 1, (64, 30)).astype(np.float32), device=dev)[:, -25:]
    got = _launched("wdx_dtw", lambda: dtw.dtw_distance_matrix(X, Y, 15, 0.1))
    want = dtw.dtw_distance_matrix_plain(X, Y, 15, 0.1)
    torch.testing.assert_close(got, want, rtol=4 * 2.0**-23, atol=0)


def test_k2_ttest(dev):
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(80, 12, (64, 6272)).astype(np.float32), device=dev)
    n = torch.as_tensor(rng.integers(100, 6273, 64).astype(np.int32), device=dev)
    w = torch.as_tensor(rng.integers(1, 13, 64).astype(np.int32), device=dev)
    got, _ = _launched("wdx_ttest", lambda: segmentation.windowed_t_test(x, n, w, 12))
    want = segmentation.windowed_t_test_plain(x, n, w, 12)
    torch.testing.assert_close(got, want, rtol=4 * 2.0**-23, atol=0)


@pytest.mark.parametrize("quantize", [False, True])
def test_k3_suppress(dev, quantize):
    rng = np.random.default_rng(3)
    s = rng.gamma(2.0, 1.0, (64, 6272)).astype(np.float32)
    if quantize:
        s = np.round(s * 4) / 4
    s = torch.as_tensor(s, device=dev)
    is_peak, _ = peaks.peak_mask_batch(s, torch.full((64,), 6272, device=dev))
    dist = torch.as_tensor(rng.integers(1, 8, 64).astype(np.int32), device=dev)
    got = _launched("wdx_suppress", lambda: peaks.suppress_by_distance(s, is_peak, dist, 7))
    assert torch.equal(got, peaks.suppress_by_distance_plain(s, is_peak, dist, 7))


@pytest.mark.parametrize("with_mad", [False, True])
def test_k4_range_median_mad(dev, with_mad):
    x = _signal(dev)
    rng = np.random.default_rng(4)
    starts = torch.as_tensor(rng.integers(0, 10000, (3, 64)).astype(np.int32), device=dev)
    ends = starts + torch.as_tensor(rng.integers(-50, 6000, (3, 64)).astype(np.int32), device=dev)
    given_meds = torch.full((3, 64), 80.0, device=dev)
    args = (x, starts, ends, with_mad, given_meds, (False, True, False))
    km, kd = _launched("wdx_range_median_mad", lambda: select.range_median_mad(*args))
    pm, pd = select.range_median_mad_plain(*args)
    assert torch.equal(km.view(torch.int32), pm.view(torch.int32))
    if with_mad:
        assert torch.equal(kd.view(torch.int32), pd.view(torch.int32))


def test_k5_shift_rows(dev):
    x = _signal(dev)
    starts = torch.as_tensor(np.random.default_rng(5).integers(-10, 9300, 64).astype(np.int32), device=dev)
    got = _launched("wdx_shift_rows", lambda: window_gather.shift_rows(x, starts, 800))
    assert torch.equal(got, window_gather.shift_rows_plain(x, starts, 800))


def test_k6_rolling_mean_var(dev):
    x = _signal(dev)
    got = _launched("wdx_rolling_mean_var", lambda: bd.rolling_mean_var(x, 200, 500))
    for g, w in zip(got, bd.rolling_mean_var_plain(x, 200, 500)):
        assert torch.equal(g, w)


def test_k7_run_sum(dev):
    mask = torch.as_tensor(np.random.default_rng(7).random((64, 10000)) < 0.4, device=dev)
    got = _launched("wdx_run_sum", lambda: bd.run_sum(mask, 100))
    assert torch.equal(got, bd.run_sum_plain(mask, 100))


def test_decision_step_gpu_matches_cpu(dev):
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    spc = get_model_spc_config(MODEL)
    adc, off, sc, lens = synth_minibatch(np.random.default_rng(0), 64, 10000)
    _cuda.reset_launches()
    gpu = make_demux_step(load_model(MODEL), spc, "adc", device=dev)(adc, off, sc, lens)
    torch.cuda.synchronize()
    assert all(n > 0 for n in _cuda.launches.values()), _cuda.launches
    cpu = make_demux_step(load_model(MODEL), spc, "adc")(adc, off, sc, lens)
    for name in ("success", "fail_code", "pred"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name
    torch.testing.assert_close(gpu.probs.cpu(), cpu.probs, rtol=1e-5, atol=1e-6)
