"""The WDX4_tRNA step of the port (start_peak detect, [real_range] and
[med_shift] gates, consensus-refined fingerprints) against the JAX step,
on the pa, adc and vbz feeds, decision and full outputs.

Rows: the first 60 of chip_smoke.trna_minibatch(default_rng(5), 60), which
cycles through barcoded tRNA reads with and without a poly(A), reads
without a capture spike, reads whose body sits at the adapter's level and
mRNA rows. One module-scoped JAX step a feed (full outputs; its decision
columns are the decision lane's). Exact, as in
tests/test_torch_step_full.py:

- (success, fail_code, pred), every int32 column, dwell times and cons_i
  (the consensus match): exact;
- region means / stds and medians / MADs, dwell-time medians, the
  fingerprint and the adapter event statistics: exact (the sums take
  XLA's order);
- class probabilities and confidences: exact (the SVM in the jitted JAX
  step's float32 operations).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import VBZ_WIDTH  # noqa: E402
from chip_smoke import trna_minibatch  # noqa: E402

MODEL = "WDX4_tRNA_rna004_v1_0"
FEEDS = ("pa", "adc", "vbz")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One CPU thread for torch here: the test workers share the machine's
    cores, and this file's many small operations gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def batch():
    from warpdemux_tpu_torch.ops.vbz_device import inner_layout_from_adc, pack_inner_host

    adc, off, sc, lens, kind, barcode = trna_minibatch(np.random.default_rng(5), 60)
    pa = ((adc.astype(np.float32) + off[:, None]) * sc[:, None]).astype(np.float32)
    keys, data = pack_inner_host([inner_layout_from_adc(r) for r in adc], adc.shape[1], VBZ_WIDTH)
    args = {"pa": (pa, lens), "adc": (adc, off, sc, lens), "vbz": (keys, data, off, sc, lens)}
    return args, kind, barcode


@pytest.fixture(scope="module")
def jax_outputs(batch):
    from warpdemux_tpu.config.utils import get_model_spc_config as jax_spc
    from warpdemux_tpu.models.registry import load_model as jax_load_model
    from warpdemux_tpu.pipeline.step import make_demux_step as jax_make_step

    model, spc = jax_load_model(MODEL), jax_spc(MODEL)
    return {feed: jax_make_step(model, spc, input_format=feed)(*batch[0][feed]) for feed in FEEDS}


@pytest.fixture(scope="module")
def port_model_spc():
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model

    return load_model(MODEL, "cpu"), get_model_spc_config(MODEL)


def _port(port_model_spc, feed, outputs, args):
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    return make_demux_step(*port_model_spc, input_format=feed, outputs=outputs, device="cpu")(*args)


def _jax_cols(want):
    from warpdemux_tpu.pipeline.schema import PackSchema as JaxSchema

    wi, wf = np.asarray(want.big_i), np.asarray(want.big_f)
    schema = JaxSchema.from_buffers(wi, wf)
    return schema.unpack(wi, np.int32), schema.unpack(wf, np.float32)


@pytest.mark.parametrize("feed", FEEDS)
def test_decision_lane_equals_jax(batch, jax_outputs, port_model_spc, feed):
    got = _port(port_model_spc, feed, "decision", batch[0][feed])
    want = jax_outputs[feed]
    wints, wfloats = _jax_cols(want)
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    np.testing.assert_array_equal(got.fail_code.numpy(), wints["merged_fail"])
    np.testing.assert_array_equal(got.pred.numpy(), np.asarray(want.pred))
    np.testing.assert_array_equal(got.conf.numpy(), np.asarray(want.conf))
    np.testing.assert_array_equal(got.probs.numpy(), wfloats["probs"])
    fails = set(got.fail_code.numpy().tolist())
    assert {0, 6, 7, 9, 13} <= fails, fails


@pytest.mark.parametrize("feed", FEEDS)
def test_full_outputs_equal_jax_column_by_column(batch, jax_outputs, port_model_spc, feed):
    from warpdemux_tpu_torch.pipeline.schema import PackSchema

    got = _port(port_model_spc, feed, "full", batch[0][feed])
    want = jax_outputs[feed]
    gi, gf = got.big_i.numpy(), got.big_f.numpy()
    schema = PackSchema.from_buffers(gi, gf)
    wints, wfloats = _jax_cols(want)
    assert gi.shape == np.asarray(want.big_i).shape and gf.shape == np.asarray(want.big_f).shape
    for name, g in schema.unpack(gi, np.int32).items():
        np.testing.assert_array_equal(g, wints[name], err_msg=name)
    for name, g in schema.unpack(gf, np.float32).items():
        np.testing.assert_array_equal(g, wfloats[name], err_msg=name)
    np.testing.assert_array_equal(got.cons_i.numpy(), np.asarray(want.cons_i))
    np.testing.assert_array_equal(got.pred.numpy(), np.asarray(want.pred))
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    view, jview = got.unpack().consensus, want.unpack().consensus
    for name in view._fields:
        np.testing.assert_array_equal(getattr(view, name), getattr(jview, name), err_msg=name)


def test_planted_barcodes_are_recovered(batch, jax_outputs, port_model_spc):
    """The barcoded reads pass and come back as their planted class."""
    _, kind, barcode = batch
    got = _port(port_model_spc, "adc", "decision", batch[0]["adc"])
    succ, pred = got.success.numpy(), got.pred.numpy()
    planted = barcode >= 0
    assert succ[planted].mean() >= 0.9
    called = planted & succ & (pred != -1)
    assert (pred[called] == barcode[called]).mean() >= 0.9 and called.sum() >= 0.8 * planted.sum()
    # no read of another kind is called as a barcode
    assert not (succ & ~planted & (pred != -1)).any()


def test_wdx4b_trna_step_equals_jax(batch):
    """The second tRNA model builds and decides as the JAX step does."""
    from warpdemux_tpu.config.utils import get_model_spc_config as jax_spc
    from warpdemux_tpu.models.registry import load_model as jax_load_model
    from warpdemux_tpu.pipeline.step import make_demux_step as jax_make_step
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    name = "WDX4b_tRNA_rna004_v1_0"
    args = tuple(a[:20] for a in batch[0]["adc"])
    got = make_demux_step(load_model(name, "cpu"), get_model_spc_config(name), input_format="adc",
                          outputs="decision", device="cpu")(*args)
    want = jax_make_step(jax_load_model(name), jax_spc(name), input_format="adc",
                         outputs="decision")(*args)
    for field in ("success", "fail_code", "pred"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)))
    np.testing.assert_array_equal(got.probs.numpy(), np.asarray(want.probs))
