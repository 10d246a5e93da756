"""SVMs of more than 16 classes in the port against the JAX package.

The port's probabilities (ops/svm.py; kernel K13 on CUDA, any class count)
against the jitted JAX coupling at 17 to 64 classes, and the whole step
(adc feed, full outputs) with a 24-class SVM made from a seed
(chip_smoke.svm_arrays: 960 support vectors) against the JAX step built
from the same arrays.

Tolerances: past seven classes the jitted coupling's order of operations is
not known, nor is the product's at these pair counts (ROADMAP queue 3, item
C), so the probabilities are held at rtol 1e-5, atol 1e-6, the confidence
(a difference of two of them) at atol 2e-6; the predictions, the noise calls
and every other column of the step are exact. Where a row's residual lies
within rounding of the coupling's stopping threshold, JAX can stop it one
pass apart: those rows are counted and held against the port at a threshold
moved by 1%, at the same tolerance.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpdemux_tpu.ops import svm as jax_svm
from warpdemux_tpu_torch.ops import svm

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import L, synth_minibatch  # noqa: E402
from chip_smoke import svm_arrays  # noqa: E402

MODEL = "WDX4_rna004_v1_0"
PROB_RTOL, PROB_ATOL, CONF_ATOL = 1e-5, 1e-6, 2e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_probabilities(dec, A, Bp, k):
    def coupled(dec):
        rp = jnp.clip(jax_svm.sigmoid_predict(dec, A, Bp), 1e-7, 1 - 1e-7)
        pairs = jax_svm.pair_index(k)
        i, j = np.array([a for a, _ in pairs]), np.array([b for _, b in pairs])
        r = jnp.zeros((dec.shape[0], k, k), rp.dtype).at[:, i, j].set(rp).at[:, j, i].set(1.0 - rp)
        return jax_svm.multiclass_probability(r, k)

    return np.asarray(jax.jit(coupled)(dec))


def _rows_close(got, want):
    both_nan = np.isnan(got) & np.isnan(want)
    close = np.abs(got - want) <= PROB_ATOL + PROB_RTOL * np.abs(want)
    return (close | both_nan).all(1)


# rows of each k whose residual at a pass head lies so close to the stopping
# threshold that the jitted coupling stops them a pass apart
STOPPING_TIES = {17: 0, 24: 2, 32: 0, 48: 1, 64: 0}


@pytest.mark.parametrize("k", [17, 24, 32, 48, 64])
def test_probabilities_past_16_classes_match_the_jitted_coupling(k, monkeypatch):
    """B = 64 rows of decision values from a seed, rows of NaN, inf and 0
    planted: the probabilities within the tolerance, NaN where JAX's are, and
    the predicted class and noise call (the margin against 0.2 / k) equal.

    Past seven classes the jitted coupling's Q p (a batched dot) sums in
    another order (item C), and its residuals near the stopping threshold
    eps = 0.005 / k were seen 0.3% off the port's, so a row whose largest
    residual at a pass head lies that close to eps can take one pass more or
    less there: on the STOPPING_TIES rows (the port's residuals 2.0844e-4
    against eps 2.0833e-4 at k = 24, 1.0440e-4 against 1.0417e-4 at k = 48)
    JAX's probabilities are the port's with eps moved by 1%, within the same
    tolerance; on every other row the port's at eps."""
    P = k * (k - 1) // 2
    rng = np.random.default_rng(k)
    dec = rng.normal(0, 3, (64, P)).astype(np.float32)
    dec[:3] = np.array([np.nan, np.inf, 0.0], np.float32)[:, None]
    A, Bp = rng.normal(-2, 0.5, P).astype(np.float32), rng.normal(0, 0.3, P).astype(np.float32)
    params = svm.SVMParams(None, None, torch.from_numpy(A), torch.from_numpy(Bp), k)
    got = svm.probabilities(torch.from_numpy(dec), params)
    want = _jax_probabilities(dec, A, Bp, k)
    at_eps = _rows_close(got.numpy(), want)
    moved = []
    for factor in (1.01, 0.99):
        monkeypatch.setattr(svm, "COUPLING_EPS", 0.005 * factor)
        moved.append(_rows_close(svm.probabilities(torch.from_numpy(dec), params).numpy(), want))
    assert (at_eps | moved[0] | moved[1]).all()
    assert (~at_eps).sum() == STOPPING_TIES[k]
    labels = torch.arange(k, dtype=torch.int32)
    thresholds = torch.full((k,), 0.2 / k)
    g_pred, _ = svm.process_probs(got, labels, thresholds)
    w_pred, _ = svm.process_probs(torch.from_numpy(want.copy()), labels, thresholds)
    np.testing.assert_array_equal(g_pred.numpy(), w_pred.numpy())
    assert len(set(w_pred[3:].tolist())) >= 3  # classes and noise calls both


def _spc(spc_of, m):
    spc = spc_of(MODEL)
    return dataclasses.replace(
        spc, fingerprint=dataclasses.replace(spc.fingerprint, barcode_num_events=m),
        seg_extra=dataclasses.replace(spc.seg_extra, barcode_seg_num_events=m))


def step_against_jax(k, m, n=48):
    """(port, JAX) full outputs of the adc step on the first n seed-0 bench
    reads with a k-class SVM of m-event fingerprints from chip_smoke.svm_arrays,
    the config's barcode_num_events and barcode_seg_num_events set to m."""
    from warpdemux_tpu.config.utils import get_model_spc_config as jax_spc
    from warpdemux_tpu.models.dtw_svm import DTWSVMModel as JaxModel
    from warpdemux_tpu.pipeline.step import make_demux_step as jax_make_step
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import dtw_svm_from_arrays
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    arrays = svm_arrays(k, np.random.default_rng(k), m=m)
    adc, off, sc, lens = synth_minibatch(np.random.default_rng(0), 1000, L)
    args = (adc[:n], off[:n], sc[:n], lens[:n])
    port = make_demux_step(dtw_svm_from_arrays(arrays, "cpu"), _spc(get_model_spc_config, m), input_format="adc",
                           device="cpu")(*args)
    want = jax_make_step(JaxModel.from_arrays(arrays), _spc(jax_spc, m), input_format="adc")(*args)
    return port, want


def compare_steps(port, want, tolerant=()):
    """Every packed column row for row (the fingerprint columns where JAX's
    fingerprint succeeded), exact but for the float columns in `tolerant`
    (at the probabilities' tolerance); success and pred exact; conf within
    CONF_ATOL where probs are tolerant, else exact. Returns JAX's pred."""
    from warpdemux_tpu.pipeline.schema import PackSchema as JaxSchema
    from warpdemux_tpu_torch.pipeline.schema import PackSchema

    gi, gf = port.big_i.numpy(), port.big_f.numpy()
    wi, wf = np.asarray(want.big_i), np.asarray(want.big_f)
    assert gi.shape == wi.shape and gf.shape == wf.shape
    schema, jschema = PackSchema.from_buffers(gi, gf), JaxSchema.from_buffers(wi, wf)
    assert schema.int_spec == jschema.int_spec and schema.float_spec == jschema.float_spec
    wints = jschema.unpack(wi, np.int32)
    ok = wints["fpt_ok"] == 1
    assert ok.sum() >= 40
    fpt_cols = {"dwell", "fpt", "adapter_dt_med", "adapter_dt_mad", "adapter_event_mean", "adapter_event_std",
                "adapter_event_med", "adapter_event_mad"}
    for name, g in schema.unpack(gi, np.int32).items():
        w = wints[name]
        rows = ok if name in fpt_cols else slice(None)
        np.testing.assert_array_equal(g[rows], w[rows], err_msg=name)
    wcols = jschema.unpack(wf, np.float32)
    for name, g in schema.unpack(gf, np.float32).items():
        w = wcols[name]
        rows = ok if name in fpt_cols else slice(None)
        if name in tolerant:
            np.testing.assert_allclose(g[rows], w[rows], rtol=PROB_RTOL, atol=PROB_ATOL, err_msg=name)
        else:
            np.testing.assert_array_equal(g[rows], w[rows], err_msg=name)
    for name in ("success", "pred"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    conf, wconf = port.conf.numpy(), np.asarray(want.conf)
    if tolerant:
        np.testing.assert_allclose(conf, wconf, rtol=0, atol=CONF_ATOL)
    else:
        np.testing.assert_array_equal(conf, wconf)
    return np.asarray(want.pred)


def test_the_24_class_step_matches_jax_row_for_row():
    """The adc step, full outputs, with a 24-class SVM (P = 276 pairs, 960
    support vectors): every column row for row, the probabilities and the
    confidence at the tolerances above, and the calls (classes and noise)
    exact."""
    pred = compare_steps(*step_against_jax(24, 25), tolerant={"probs"})
    assert len(set(pred.tolist()) - {-1}) >= 2 and (pred == -1).any()


@pytest.mark.parametrize(
    "kernel, shape",
    [("K1", (m, window)) for m in (1, 25, 32, 33, 64, 100, 800, 1000, 10000) for window in (15, 0, m)]
    + [("K13", (k,)) for k in (2, 5, 16, 17, 32, 33, 64, 239, 240, 1000)]
    + [("K15", (variant, k)) for variant in (None, "warp", "block")
       for k in (1, 5, 32, 33, 1024, 1025, 12288, 60000, 10**6)],
)
def test_the_wrappers_choose_a_kernel_for_every_shape(kernel, shape):
    """The CUDA wrappers' routing refuses no shape the JAX functions take:
    K1 at any fingerprint length and window, K13 at any class count, K15 at
    any width, each a kernel whose own limits the shape meets (the
    shared-memory variants only where their buffers fit); a K15 kernel
    forced beyond its widths is refused."""
    from warpdemux_tpu_torch import _cuda
    from warpdemux_tpu_torch.ops import dtw, numerics

    if kernel == "K1":
        m, window = shape
        kind = dtw._k1_variant(m, window, None)
        assert kind in dtw.VARIANTS
        assert (kind == "registers") == ((m, window) == dtw.REGISTER_SHAPE)
        assert kind != "shared" or dtw.wide_threads(m)
    elif kernel == "K13":
        (k,) = shape
        kind = svm._k13_variant(k, None)
        assert kind != "warp" or k <= 32
        assert kind != "shared" or 4 * (k * k + 3 * k + 32) <= _cuda.MAX_SHARED_BYTES
        assert (kind == "global") == (k >= 240)
    else:
        variant, k = shape
        fits = {"lanes": k <= 32, "warp": k <= 1024, "global": True,
                "block": numerics.softmax_block_shared_bytes(k) + 128 <= _cuda.MAX_SHARED_BYTES}
        if variant is not None and not fits[variant]:
            with pytest.raises(ValueError, match=f"the {variant} kernel"):
                numerics._k15_variant(k, variant)
            return
        kind = numerics._k15_variant(k, variant)
        assert kind in numerics.SOFTMAX_VARIANTS and fits[kind]
        assert variant is not None or kind == ("lanes" if k <= 32 else "warp" if k <= 1024 else
                                               "block" if fits["block"] else "global")
