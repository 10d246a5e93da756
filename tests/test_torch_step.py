"""The whole decision step of the port against the JAX step.

Same inputs as tests/test_bench_population.py: the first 256 reads of the
seed-0 bench batch and the planted WDX4 barcode reads. The port's CPU path
must reproduce the JAX step row for row on (success, fail_code, pred) and
hit the same pins.
"""

import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import B as BENCH_B  # noqa: E402
from bench import L, synth_minibatch  # noqa: E402

MODEL = "WDX4_rna004_v1_0"
ADC_SCALE, ADC_OFFSET = np.float32(0.1755), np.float32(-240.0)
N = 256


@pytest.fixture(scope="module")
def steps():
    from warpdemux_tpu.config.utils import get_model_spc_config as jax_spc
    from warpdemux_tpu.models.registry import load_model as jax_load_model
    from warpdemux_tpu.pipeline.step import make_demux_step as jax_make_step
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    jax_model = jax_load_model(MODEL)
    jax_step = jax_make_step(
        jax_model, jax_spc(MODEL), input_format="adc", outputs="decision"
    )
    port_step = make_demux_step(
        load_model(MODEL, "cpu"), get_model_spc_config(MODEL), input_format="adc",
        outputs="decision", device="cpu",
    )
    return jax_model, jax_step, port_step


def _decisions(res):
    return tuple(
        np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
        for a in (res.success, res.fail_code, res.pred, res.probs)
    )


def test_bench_rows_match_jax_row_for_row_and_hit_the_pins(steps):
    _, jax_step, port_step = steps
    adc, offset, scale, lens = synth_minibatch(np.random.default_rng(0), BENCH_B, L)
    args = (adc[:N], offset[:N], scale[:N], lens[:N])
    succ, fail, pred, probs = _decisions(port_step(*args))
    w_succ, w_fail, w_pred, w_probs = _decisions(jax_step(*args))

    np.testing.assert_array_equal(succ, w_succ)
    np.testing.assert_array_equal(fail, w_fail)
    np.testing.assert_array_equal(pred, w_pred)
    np.testing.assert_allclose(probs, w_probs, rtol=1e-5, atol=1e-6)
    assert int(succ.sum()) == 237
    assert dict(Counter(pred[succ].tolist())) == {-1: 236, 7: 1}
    assert dict(Counter(fail[~succ].tolist())) == {2: 15, 5: 4}


def test_planted_barcodes_match_jax(steps):
    """Reads planted from WDX4 support-vector fingerprints come back as
    their barcode, exactly as through the JAX step (46 / 39 / 38)."""
    from warpdemux_tpu.live.dummy import synth_barcoded_read
    from warpdemux_tpu_torch.models.registry import load_model_arrays

    jax_model, jax_step, port_step = steps
    rng = np.random.default_rng(7)
    X = np.asarray(jax_model.X_sv)
    label_map = np.asarray(jax_model.label_map)
    n_sup = load_model_arrays(MODEL)["n_support"]
    bounds = np.concatenate([[0], np.cumsum(n_sup)])
    rows, truth = [], []
    for ci, bc in enumerate(label_map[:-1]):
        for _ in range(12):
            sv = X[rng.integers(bounds[ci], bounds[ci + 1])]
            adc = np.clip(
                np.rint(synth_barcoded_read(rng, sv) / ADC_SCALE - ADC_OFFSET),
                -32768, 32767,
            ).astype(np.int16)
            row = np.zeros(L, np.int16)
            m = min(len(adc), L)
            row[:m] = adc[:m]
            rows.append(row)
            truth.append(int(bc))
    nb = len(rows)
    args = (
        np.stack(rows), np.full(nb, ADC_OFFSET, np.float32),
        np.full(nb, ADC_SCALE, np.float32), np.full(nb, L, np.int32),
    )
    succ, fail, pred, _ = _decisions(port_step(*args))
    w_succ, w_fail, w_pred, _ = _decisions(jax_step(*args))
    np.testing.assert_array_equal(succ, w_succ)
    np.testing.assert_array_equal(fail, w_fail)
    np.testing.assert_array_equal(pred, w_pred)
    called = succ & (pred != -1)
    truth = np.asarray(truth)
    assert int(succ.sum()) == 46
    assert int(called.sum()) == 39
    assert int((pred[called] == truth[called]).sum()) == 38


def test_pa_feed_matches_adc_feed(steps):
    """The pa feed on the calibrated signal gives the adc feed's result."""
    _, _, port_step = steps
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    adc, offset, scale, lens = synth_minibatch(np.random.default_rng(4), 24, L)
    pa = (adc.astype(np.float32) + offset[:, None]) * scale[:, None]
    pa_step = make_demux_step(
        load_model(MODEL, "cpu"), get_model_spc_config(MODEL), input_format="pa",
        outputs="decision", device="cpu",
    )
    got = _decisions(pa_step(pa, lens))
    want = _decisions(port_step(adc, offset, scale, lens))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("option", ["consensus_refinement", "start_peak"])
def test_trna_step_options_on_the_mrna_config_equal_jax(option):
    """The tRNA chemistry's consensus-refined fingerprints and start_peak
    detector, each switched on in the WDX4 configuration: the port's
    decisions equal the JAX step's on 16 bench reads."""
    from dataclasses import replace

    from warpdemux_tpu.config.utils import get_model_spc_config as jax_spc
    from warpdemux_tpu.models.registry import load_model as jax_load_model
    from warpdemux_tpu.pipeline.step import make_demux_step as jax_make_step
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    def switch(spc):
        if option == "consensus_refinement":
            return replace(spc, seg_extra=replace(
                spc.seg_extra, consensus_refinement=True, consensus_model="rna004_130bps_v1_0"
            ))
        return replace(spc, detect=replace(spc.detect, method="start_peak"))

    args = tuple(a[:16] for a in synth_minibatch(np.random.default_rng(0), 16, L))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the test workers share the machine's cores
    try:
        got = make_demux_step(
            load_model(MODEL, "cpu"), switch(get_model_spc_config(MODEL)), input_format="adc",
            outputs="decision", device="cpu",
        )(*args)
    finally:
        torch.set_num_threads(threads)
    want = jax_make_step(
        jax_load_model(MODEL), switch(jax_spc(MODEL)), input_format="adc", outputs="decision"
    )(*args)
    for g, w in zip(_decisions(got), _decisions(want)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.fail_code.numpy(), np.asarray(want.fail_code))


def test_a_positional_feed_name_fails_loudly():
    """Options after spc are keywords: a feed name passed by position
    cannot turn into with_predict."""
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    with pytest.raises(TypeError):
        make_demux_step(load_model(MODEL, "cpu"), get_model_spc_config(MODEL), "adc", device="cpu")
    with pytest.raises(ValueError):
        make_demux_step(load_model(MODEL, "cpu"), get_model_spc_config(MODEL), input_format="pod5", device="cpu")


def test_cpu_tensors_take_the_plain_versions(steps):
    """The dispatch rule: CPU tensors never build or launch a kernel."""
    from warpdemux_tpu_torch import _cuda

    _, _, port_step = steps
    _cuda.reset_launches()
    adc, offset, scale, lens = synth_minibatch(np.random.default_rng(9), 4, L)
    port_step(adc, offset, scale, lens)
    assert set(_cuda.launches.values()) == {0}
    assert not _cuda._libraries


def test_mixed_devices_raise():
    from warpdemux_tpu_torch.ops.window_gather import shift_rows

    x = torch.zeros((2, 10))
    with pytest.raises(ValueError):
        shift_rows(x, torch.zeros(2, dtype=torch.int32, device="meta"), 4)


def test_entry_points_default_to_the_gpu(monkeypatch):
    """make_demux_step, load_model and load_cnn run on the CUDA device
    unless a device is named; without one they raise and never carry on on
    the CPU. device="cpu" runs the plain PyTorch path."""
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_cnn, load_model
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spc = get_model_spc_config(MODEL)
    for call in (
        lambda: load_model(MODEL),
        lambda: load_cnn(spc.cnn_model_name),
        lambda: make_demux_step(None, spc, input_format="adc"),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    model = load_model(MODEL, "cpu")
    assert model.X_sv.device.type == "cpu"
    assert next(load_cnn(spc.cnn_model_name, "cpu").buffers()).device.type == "cpu"
    step = make_demux_step(model, spc, input_format="adc", outputs="decision", device="cpu")
    out = step(*synth_minibatch(np.random.default_rng(9), 2, L))
    assert out.pred.device.type == "cpu" and out.pred.shape == (2,)
