"""Rows past the shapes the port's kernels once refused, and the SVM's kernel
matrix stored by K1, against the JAX package on the CPU.

- The region means and stds (`rowstats.range_mean_std_plain`, the plain
  version of K11, whose workspace kernel serves rows past 431,104 samples
  on CUDA) against the jitted `masked_mean_std` at 431,105 and 1,048,577
  samples (a fourth level of XLA's sum tree), calibrated and float, bit
  for bit.
- The SVM's kernel matrix (`dtw.dtw_kernel_matrix`'s plain version, which
  K1 computes in one launch on CUDA) against the jitted JAX
  `pdist_kernel(dtw_distance_matrix(...), 1.0)` on WDX4's support vectors,
  bit for bit; and an SVM of pwr_dist 2 (the one path left to K16)
  against the JAX model built from the same arrays.
- The whole step (adc feed, full outputs) at a sig_preload_size of 450,000
  samples against the jitted JAX step: every column exact, as
  tests/test_torch_step_full.py holds them.

No case here runs `windowed_t_test` at w_max past 8,986: the JAX function
unrolls three loops of w_max terms, too long to compile in a test; K2 is
held to the plain version there on the card (tests/test_torch_cuda.py).
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpdemux_tpu.ops.dtw import dtw_distance_matrix as jax_dtw
from warpdemux_tpu.ops.normalize import masked_mean_std as jax_masked_mean_std
from warpdemux_tpu.ops.svm import pdist_kernel as jax_pdist_kernel
from warpdemux_tpu_torch.ops import dtw
from warpdemux_tpu_torch.ops.rowstats import range_mean_std_plain

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import K11_LONG_ROWS, k11_step_ranges, long_row_spc, svm_arrays  # noqa: E402

MODEL = "WDX4_rna004_v1_0"
LONG_STEP_ROWS, LONG_STEP_SAMPLES = 2, 450_000
FPT_COLS = {"dwell", "fpt", "adapter_dt_med", "adapter_dt_mad", "adapter_event_mean", "adapter_event_std",
            "adapter_event_med", "adapter_event_mad"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("calibrated", [True, False], ids=["adc", "pa"])
@pytest.mark.parametrize("L", K11_LONG_ROWS)
def test_range_mean_std_past_the_warp_kernel_equals_the_jitted_jax(L, calibrated):
    """B = 2 rows, R = 3 ranges: the step's adapter, poly(A) and RNA ranges
    of the first row, the whole second row, its halves and a range in its
    last window."""
    rng = np.random.default_rng(L)
    adc = rng.integers(-2000, 3000, (2, L)).astype(np.int16)
    off = rng.uniform(-5, 20, 2).astype(np.float32)
    sc = rng.uniform(0.1, 0.3, 2).astype(np.float32)
    x = ((adc.astype(np.float32) + off[:, None]) * sc[:, None]).astype(np.float32)
    st, en = k11_step_ranges(rng, 2, L)
    st[:, 1], en[:, 1] = (0, L // 2, L - 17), (L, L - 1, L)
    t = torch.from_numpy
    calibration = (adc, off, sc) if calibrated else None
    means, stds = range_mean_std_plain(t(x), t(st), t(en), True,
                                       None if calibration is None else tuple(map(t, calibration)))
    if calibration is None:
        jfn = jax.jit(jax_masked_mean_std)
    else:  # the calibration inside the program, as the step forms it
        jfn = jax.jit(lambda adc, off, sc, m: jax_masked_mean_std(
            (adc.astype(jnp.float32) + off[:, None]) * sc[:, None], m))
    pos = np.arange(L)[None, :]
    for r in range(3):
        mask = (pos >= st[r][:, None]) & (pos < en[r][:, None])
        want_mean, want_std = jfn(*(calibration or (x,)), mask)
        np.testing.assert_array_equal(_bits(means[r].numpy()), _bits(want_mean), err_msg=f"mean, range {r}")
        np.testing.assert_array_equal(_bits(stds[r].numpy()), _bits(want_std), err_msg=f"std, range {r}")


def test_dtw_kernel_matrix_equals_the_jitted_jax_kernel():
    """32 seed-0 fingerprints against WDX4's 851 support vectors: exp(-D)
    of the banded DTW distances, bit for bit; the wrapper on CPU tensors is
    its plain version."""
    from warpdemux_tpu_torch.models.registry import load_model_arrays

    Y = load_model_arrays(MODEL)["X_sv"].astype(np.float32)
    X = np.random.default_rng(0).normal(0, 1, (32, 25)).astype(np.float32)
    want = jax.jit(lambda X, Y: jax_pdist_kernel(jax_dtw(X, Y, 15, 0.1), 1.0))(X, Y)
    got = dtw.dtw_kernel_matrix_plain(torch.from_numpy(X), torch.from_numpy(Y), 15, 0.1, 1.0)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert torch.equal(dtw.dtw_kernel_matrix(torch.from_numpy(X), torch.from_numpy(Y), 15, 0.1, 1.0), got)


def test_svm_of_pwr_dist_2_equals_the_jax_model():
    """The synthetic 5-class SVM of pwr_dist 2 that chip_smoke's phase 15a
    sends through K16: pred, conf and probs of 48 fingerprints from a seed
    equal the JAX model's, bit for bit."""
    from warpdemux_tpu.models.dtw_svm import DTWSVMModel as JaxModel
    from warpdemux_tpu_torch.models.registry import dtw_svm_from_arrays

    arrays = {**svm_arrays(5, np.random.default_rng(2), pwr_dist=2), "gamma": np.float64(0.05)}
    fpts = np.random.default_rng(3).normal(0, 1, (48, 25)).astype(np.float32)
    port = dtw_svm_from_arrays(arrays, "cpu")
    got = port.predict(fpts)
    want = JaxModel.from_arrays(arrays).predict(fpts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g).view(np.int32), np.asarray(w).view(np.int32))
    K = port.kernel_matrix(torch.from_numpy(fpts))
    assert 0.0 < float(K.min()) and float(K.max()) < 1.0


def test_the_step_at_a_sig_preload_size_of_450000_matches_jax():
    """The adc step, full outputs, on two seed-0 bench reads of 450,000
    samples (past K11's warp kernel): every packed column row for row, the
    fingerprint columns where JAX's fingerprint succeeded, exact."""
    from warpdemux_tpu.config.utils import get_model_spc_config as jax_spc
    from warpdemux_tpu.models.registry import load_model as jax_load_model
    from warpdemux_tpu.pipeline.schema import PackSchema as JaxSchema
    from warpdemux_tpu.pipeline.step import make_demux_step as jax_make_step
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.pipeline.schema import PackSchema
    from warpdemux_tpu_torch.pipeline.step import make_demux_step
    from warpdemux_tpu_torch.utils.synthetic import synth_minibatch

    args = synth_minibatch(np.random.default_rng(0), LONG_STEP_ROWS, LONG_STEP_SAMPLES)
    port = make_demux_step(load_model(MODEL, "cpu"), long_row_spc(get_model_spc_config(MODEL), LONG_STEP_SAMPLES),
                           input_format="adc", outputs="full", device="cpu")(*args)
    jspc = jax_spc(MODEL)
    jspc = dataclasses.replace(jspc, sig_preload_size=LONG_STEP_SAMPLES,
                               detect=dataclasses.replace(jspc.detect, max_obs_trace=LONG_STEP_SAMPLES))
    want = jax_make_step(jax_load_model(MODEL), jspc, input_format="adc")(*args)
    gi, gf = port.big_i.numpy(), port.big_f.numpy()
    wi, wf = np.asarray(want.big_i), np.asarray(want.big_f)
    assert gi.shape == wi.shape and gf.shape == wf.shape
    schema, jschema = PackSchema.from_buffers(gi, gf), JaxSchema.from_buffers(wi, wf)
    wints = jschema.unpack(wi, np.int32)
    ok = wints["fpt_ok"] == 1
    assert ok.any()
    for name, g in schema.unpack(gi, np.int32).items():
        rows = ok if name in FPT_COLS else slice(None)
        np.testing.assert_array_equal(g[rows], wints[name][rows], err_msg=name)
    wcols = jschema.unpack(wf, np.float32)
    for name, g in schema.unpack(gf, np.float32).items():
        rows = ok if name in FPT_COLS else slice(None)
        np.testing.assert_array_equal(_bits(g[rows]), _bits(wcols[name][rows]), err_msg=name)
    for name in ("success", "pred", "conf"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    assert (schema.unpack(gf, np.float32)["rna_std"] > 0).all()
