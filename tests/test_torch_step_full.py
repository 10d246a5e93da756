"""The full-output step of the port (vbz feed) against the JAX step.

Inputs: the first 64 reads of the seed-0 bench batch and its row 795 (the
near-tie of the LLR refinement), packed into the VBZ wire by the port's
numpy helpers. Every packed column is compared by name, each group with
its stated tolerance:

- int32 columns and dwell times: exact;
- region medians / MADs, gate values (mvs_*), dwell-time medians: exact
  (order statistics, the same float32 operations);
- region means / stds: exact (the masked rows summed in XLA's order,
  ops/rowstats.py);
- the fingerprint columns (dwell, fpt, adapter_dt_*, adapter_event_*) are
  compared where the fingerprint succeeded (fpt_ok): a read whose adapter
  is empty segments an all-zero t-score row, whose changepoints are
  unspecified in both packages (as in tests/test_torch_segmentation.py);
- fingerprints and adapter event statistics: atol 1e-4 (segment means
  normalized by float32 sums of another association);
- class probabilities: rtol 1e-5, atol 1e-6 (the decision step's bound).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import L, VBZ_WIDTH, synth_minibatch  # noqa: E402

MODEL = "WDX4_rna004_v1_0"
ROWS = list(range(64)) + [795]

EXACT_F = {
    "adapter_med", "adapter_mad", "polya_med", "polya_mad", "rna_med",
    "rna_mad", "mvs_med_shift", "mvs_min_polya_var", "adapter_dt_med",
    "adapter_dt_mad",
}
FPT_COLS = {
    "dwell", "fpt", "adapter_dt_med", "adapter_dt_mad", "adapter_event_mean",
    "adapter_event_std", "adapter_event_med", "adapter_event_mad",
}
REGION_F = {
    "adapter_mean", "adapter_std", "polya_mean", "polya_std", "rna_mean",
    "rna_std",
}
FPT_F = {
    "fpt", "adapter_event_mean", "adapter_event_std", "adapter_event_med",
    "adapter_event_mad",
}


def _vbz(adc):
    from warpdemux_tpu_torch.ops.vbz_device import inner_layout_from_adc, pack_inner_host

    bodies = [inner_layout_from_adc(row) for row in adc]
    return pack_inner_host(bodies, adc.shape[1], VBZ_WIDTH)


@pytest.fixture(scope="module")
def batch():
    adc, off, sc, lens = synth_minibatch(np.random.default_rng(0), 1000, L)
    adc, off, sc, lens = adc[ROWS], off[ROWS], sc[ROWS], lens[ROWS]
    keys, data = _vbz(adc)
    return adc, keys, data, off, sc, lens


@pytest.fixture(scope="module")
def port_model_spc():
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model

    return load_model(MODEL, "cpu"), get_model_spc_config(MODEL)


@pytest.fixture(scope="module")
def outputs(batch, port_model_spc):
    from warpdemux_tpu.config.utils import get_model_spc_config as jax_spc
    from warpdemux_tpu.models.registry import load_model as jax_load_model
    from warpdemux_tpu.pipeline.step import make_demux_step as jax_make_step
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    _, keys, data, off, sc, lens = batch
    jax_step = jax_make_step(jax_load_model(MODEL), jax_spc(MODEL), input_format="vbz")
    port_step = make_demux_step(*port_model_spc, input_format="vbz", device="cpu")
    return port_step(keys, data, off, sc, lens), jax_step(keys, data, off, sc, lens)


def test_vbz_full_step_matches_jax_column_by_column(outputs):
    from warpdemux_tpu.pipeline.schema import PackSchema as JaxSchema
    from warpdemux_tpu_torch.pipeline.schema import PackSchema

    got, want = outputs
    gi, gf = got.big_i.numpy(), got.big_f.numpy()
    wi, wf = np.asarray(want.big_i), np.asarray(want.big_f)
    assert gi.shape == wi.shape and gf.shape == wf.shape
    schema, jschema = PackSchema.from_buffers(gi, gf), JaxSchema.from_buffers(wi, wf)
    assert schema.int_spec == jschema.int_spec
    assert schema.float_spec == jschema.float_spec
    wints = jschema.unpack(wi, np.int32)
    ok = wints["fpt_ok"] == 1
    assert ok.sum() >= 50
    for name, g in schema.unpack(gi, np.int32).items():
        w = wints[name]
        if name in FPT_COLS:
            g, w = g[ok], w[ok]
        np.testing.assert_array_equal(g, w, err_msg=name)
    wcols = jschema.unpack(wf, np.float32)
    for name, g in schema.unpack(gf, np.float32).items():
        w = wcols[name]
        if name in FPT_COLS:
            g, w = g[ok], w[ok]
        if name in EXACT_F or name in REGION_F:
            np.testing.assert_array_equal(g, w, err_msg=name)
        elif name in FPT_F:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=name)
        else:
            assert name == "probs"
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=name)
    for name in ("success", "pred"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    np.testing.assert_allclose(got.conf.numpy(), np.asarray(want.conf), rtol=1e-5, atol=1e-6)
    # row 795 (the last row): JAX fails it at the [mvs_polya] gate
    assert int(gi[-1, schema.int_slices["det_fail"]][0]) == 5
    # the region statistics are real values, not the decision lane's zeros
    assert np.all(schema.unpack(gf, np.float32)["rna_std"][:64] > 0)


def test_fingerprint_columns_equal_jax_bit_for_bit(outputs):
    """Within the atol above, and in fact equal: the fingerprint's sums take
    XLA:CPU's order (ops/numerics.xla_sum, ops/normalize.mean_std)."""
    from warpdemux_tpu.pipeline.schema import PackSchema as JaxSchema
    from warpdemux_tpu_torch.pipeline.schema import PackSchema

    got, want = outputs
    gi, gf = got.big_i.numpy(), got.big_f.numpy()
    wi, wf = np.asarray(want.big_i), np.asarray(want.big_f)
    ok = JaxSchema.from_buffers(wi, wf).unpack(wi, np.int32)["fpt_ok"] == 1
    gcols = PackSchema.from_buffers(gi, gf).unpack(gf, np.float32)
    wcols = JaxSchema.from_buffers(wi, wf).unpack(wf, np.float32)
    for name in FPT_F:
        np.testing.assert_array_equal(gcols[name][ok], wcols[name][ok], err_msg=name)


def test_unpack_gives_the_jax_field_set(outputs):
    got, want = outputs
    g, w = got.unpack(), want.unpack()
    assert g._fields == w._fields
    # `resolved` belongs to the two-stage wire (resolve_limit, stage 1 of
    # the decision lane): both full steps leave it None
    assert g.detect.resolved is None and w.detect.resolved is None
    assert g.detect._fields == w.detect._fields
    assert g.fpt._fields == w.fpt._fields
    for name in g.detect._fields[:-1]:
        gv, wv = getattr(g.detect, name), np.asarray(getattr(w.detect, name))
        assert gv.dtype == wv.dtype and gv.shape == wv.shape, name
    np.testing.assert_array_equal(g.detect.polya_end, w.detect.polya_end)
    np.testing.assert_array_equal(g.fail_code, w.fail_code)
    np.testing.assert_array_equal(got.probs.numpy(), g.probs)
    assert g.consensus is None and w.consensus is None


def test_vbz_and_adc_full_outputs_are_identical(batch, port_model_spc, outputs):
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    adc, _, _, off, sc, lens = batch
    adc_out = make_demux_step(*port_model_spc, input_format="adc", device="cpu")(adc, off, sc, lens)
    for a, b in zip(adc_out, outputs[0]):
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("model", ["none", "with_predict_false"])
def test_full_step_without_classification(batch, port_model_spc, outputs, model):
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    _, keys, data, off, sc, lens = batch
    m, spc = port_model_spc
    if model == "none":
        step = make_demux_step(None, spc, input_format="vbz", device="cpu")
    else:
        step = make_demux_step(m, spc, with_predict=False, input_format="vbz", device="cpu")
    out = step(keys[:8], data[:8], off[:8], sc[:8], lens[:8])
    assert out.probs.shape == (8, 1)
    assert (out.pred == -1).all() and (out.conf == 0).all() and (out.probs == 0).all()
    full = outputs[0]
    np.testing.assert_array_equal(out.big_i.numpy(), full.big_i.numpy()[:8])
    np.testing.assert_array_equal(out.big_f.numpy()[:, :-1], full.big_f.numpy()[:8, :-5])
