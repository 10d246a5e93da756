"""The RNA002 legacy surface of the port: the twin of
tests/test_rna002_legacy.py (registry entries, arrays, the chemistry
config, a step), and the step's outputs against the jitted JAX step on 64
reads of utils/synthetic.synth_batch at the chemistry's 15,000-sample
preload (LLR detect, no CNN), WDX4 and WDX10:

- the adc feed, full outputs: (success, fail_code, pred) and every int32
  column exact; every float column exact (region means / stds and
  medians / MADs, gate values, the fingerprint and the adapter event
  statistics, the fingerprint columns where the fingerprint succeeded), but
  the probabilities (rtol 1e-5, atol 1e-6) and the confidences (the
  difference of the two largest probabilities: the sum of their bounds);
- the adc feed, decision outputs: the decisions exact, against the same
  JAX outputs.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from warpdemux_tpu_torch.config.utils import load_chemistry_config
from warpdemux_tpu_torch.models.registry import available_models, load_model, model_config

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import RNA002_L, RNA002_MODELS, rna002_minibatch  # noqa: E402

N_ROWS = 64
FPT_COLS = {
    "dwell", "fpt", "adapter_dt_med", "adapter_dt_mad", "adapter_event_mean",
    "adapter_event_std", "adapter_event_med", "adapter_event_mad",
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One CPU thread for torch here: the test workers share the machine's
    cores, and this file's many small operations gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_rna002_models_registered_and_loadable():
    names = [n for n in available_models() if "rna002" in n]
    assert len(names) == 6
    for n in names:
        cfg = model_config(n)
        assert cfg["SQK"] == "RNA002"
        assert cfg.get("deprecated") is True
        m = load_model(n, "cpu")
        assert m.X_sv.shape[1] == 25
        assert m.n_classes == cfg["num_bcs"] + 1  # noise class


def test_rna002_chemistry_config():
    spc = load_chemistry_config("rna002_70bps@v0.4.4")
    assert spc.primary_method == "llr"
    assert spc.sig_preload_size == RNA002_L
    assert spc.fingerprint.num_events == 110
    assert spc.fingerprint.min_obs_per_base == 15
    assert spc.fingerprint.running_stat_width == 30


def test_rna002_prep_step_runs():
    from warpdemux_tpu_torch.pipeline.step import make_demux_step
    from warpdemux_tpu_torch.utils.synthetic import synth_batch

    spc = load_chemistry_config("rna002_70bps@v0.4.4")
    step = make_demux_step(load_model("WDX4_rna002_v0_4_4", "cpu"), spc, device="cpu")
    sigs, lens, _ = synth_batch(np.random.default_rng(0), 4, L=RNA002_L)
    out = step(sigs, lens).unpack()
    assert np.asarray(out.pred).shape == (4,)
    ok = np.asarray(out.success)
    assert np.isin(np.asarray(out.pred)[ok], [4, 5, 6, 8, -1]).all()


@pytest.fixture(scope="module")
def batch():
    return rna002_minibatch(np.random.default_rng(0), N_ROWS)


@pytest.fixture(scope="module")
def jax_outputs(batch):
    """The jitted JAX step's full outputs on the adc feed, by model."""
    from warpdemux_tpu.config.utils import get_model_spc_config as jax_spc
    from warpdemux_tpu.models.registry import load_model as jax_load_model
    from warpdemux_tpu.pipeline.step import make_demux_step as jax_make_step

    return {name: jax_make_step(jax_load_model(name), jax_spc(name), input_format="adc")(*batch)
            for name in RNA002_MODELS}


def _port(name, outputs, batch):
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    step = make_demux_step(load_model(name, "cpu"), get_model_spc_config(name), input_format="adc",
                           outputs=outputs, device="cpu")
    return step(*batch)


@pytest.mark.parametrize("name", RNA002_MODELS)
def test_full_outputs_equal_the_jitted_jax_step(batch, jax_outputs, name):
    from warpdemux_tpu.pipeline.schema import PackSchema as JaxSchema
    from warpdemux_tpu_torch.pipeline.schema import PackSchema

    got, want = _port(name, "full", batch), jax_outputs[name]
    gi, gf = got.big_i.numpy(), got.big_f.numpy()
    wi, wf = np.asarray(want.big_i), np.asarray(want.big_f)
    assert gi.shape == wi.shape and gf.shape == wf.shape
    schema, jschema = PackSchema.from_buffers(gi, gf), JaxSchema.from_buffers(wi, wf)
    wints, wfloats = jschema.unpack(wi, np.int32), jschema.unpack(wf, np.float32)
    ok = wints["fpt_ok"] == 1
    assert ok.sum() >= 40 and (~ok).sum() >= 1
    for col, g in schema.unpack(gi, np.int32).items():
        rows = ok if col in FPT_COLS else slice(None)
        np.testing.assert_array_equal(g[rows], wints[col][rows], err_msg=col)
    for col, g in schema.unpack(gf, np.float32).items():
        rows = ok if col in FPT_COLS else slice(None)
        g, w = g[rows], wfloats[col][rows]
        if col == "probs":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=col)
        else:
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32), err_msg=col)
    for field in ("success", "pred"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)))
    # the confidence is the difference of the two largest probabilities, so
    # its bound is the sum of theirs
    top2 = np.sort(wfloats["probs"], axis=1)[:, -2:].sum(1)
    assert (np.abs(got.conf.numpy() - np.asarray(want.conf)) <= 2e-6 + 1e-5 * top2).all()


@pytest.mark.parametrize("name", RNA002_MODELS)
def test_adc_decisions_equal_the_jitted_jax_step(batch, jax_outputs, name):
    got, want = _port(name, "decision", batch), jax_outputs[name]
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    np.testing.assert_array_equal(got.fail_code.numpy(), np.asarray(want.unpack().fail_code))
    np.testing.assert_array_equal(got.pred.numpy(), np.asarray(want.pred))
    assert 30 <= int(got.success.sum()) < N_ROWS
