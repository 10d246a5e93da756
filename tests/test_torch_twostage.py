"""The port's two-stage wire (pipeline/step.make_twostage_decision_step,
ops/vbz_device.split_wire_host / pack_tails_host, detect resolve_limit)
against the JAX package's, on the CPU.

- the wire: split_wire_host and pack_tails_host return the JAX functions'
  arrays byte for byte, ladder widths included; the stage-1 decode and
  assemble_preload give the whole wire's decode on rows of mixed lengths
  (seed 3, as tests/test_twostage.py);
- stage 1's `resolved` equals the jitted JAX stage 1's on every row: the
  seed-0 bench batch and the short-read batch of seed 11;
- the port's two-stage decisions equal its one-shot vbz step's bit for
  bit; against JAX's two-stage, pred, fail_code and success exact, conf
  and probs within rtol 1e-5, atol 1e-6 (the decision tests' tolerance);
- the ValueErrors, and a start_peak (tRNA) configuration resolving only
  the reads that fit the prefix;
- the run loop's rule for taking the two-stage wire (use_twostage).

B = 96 a batch; the JAX and port steps are built once for the module.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench  # noqa: E402
from chip_smoke import vbz_ragged  # noqa: E402

MODEL = "WDX4_rna004_v1_0"
L, L1, B = 10000, 7168, 96


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One CPU thread for torch here: the test workers share the machine's
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mixed_batch(seed):
    """Seed 3's rows: 16 reads cut inside the prefix, the rest as drawn."""
    rng = np.random.default_rng(seed)
    adc, off, sc, in_lens = bench.synth_minibatch(rng, 64, L)
    in_lens = in_lens.copy()
    in_lens[:16] = rng.integers(2500, L1, 16)
    return vbz_ragged(adc, off, sc, in_lens)


def short_batch():
    """Seed 11's batch: every read ends inside the prefix."""
    rng = np.random.default_rng(11)
    adc, off, sc, _ = bench.synth_minibatch(rng, B, L)
    return vbz_ragged(adc, off, sc, rng.integers(2200, L1 + 1, B).astype(np.int32))


def bench_batch():
    """The seed-0 bench population, packed whole as the bench packs it."""
    return bench.synth_minibatch_vbz(np.random.default_rng(0), B, L)


def port_twostage(stage1, stage2, keys, data, off, sc, in_lens):
    """(decisions, resolved) through the port's host protocol, the run
    loop's own (pipeline/step.twostage_stage2)."""
    from warpdemux_tpu_torch.ops.vbz_device import split_wire_host
    from warpdemux_tpu_torch.pipeline.step import twostage_stage2

    keys1, data1, off1 = split_wire_host(keys, data, in_lens, L1)
    h = stage1(keys1, data1, off, sc, in_lens)
    resolved = h.resolved.numpy()
    out2, _ = twostage_stage2(stage2, h, resolved, (keys, data, in_lens, off1), len(in_lens), L)
    return (h.out1 if out2 is None else out2), resolved


def jax_twostage(stage1, stage2, keys, data, off, sc, in_lens):
    """(decisions, resolved) through the JAX run loop's host protocol."""
    from warpdemux_tpu.ops.vbz_device import pack_tails_host, split_wire_host

    keys1, data1, off1 = split_wire_host(keys, data, in_lens, L1)
    h = stage1(keys1, data1, off, sc, in_lens)
    resolved = np.asarray(h.resolved)
    rows = np.nonzero(~resolved)[0]
    if not rows.size:
        return h.out1, resolved
    return stage2(h, *pack_tails_host(keys, data, in_lens, off1, rows, L1, L)), resolved


def test_split_and_tails_equal_the_jax_wire_byte_for_byte():
    from warpdemux_tpu.ops import vbz_device as jv
    from warpdemux_tpu_torch.ops import vbz_device as pv

    for name in ("_D1_LADDER", "_DT_LADDER", "_ROW_LADDER"):
        assert getattr(pv, name) == getattr(jv, name), name
    np.testing.assert_array_equal(pv._POPCOUNT, jv._POPCOUNT)
    keys, data, _, _, in_lens = mixed_batch(3)
    got, want = pv.split_wire_host(keys, data, in_lens, L1), jv.split_wire_host(keys, data, in_lens, L1)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    off1 = want[2]
    # every row, none, and row counts at and past the row ladder's rungs
    rng = np.random.default_rng(4)
    for rows in (np.arange(64), np.zeros(0, np.int64), np.array([63, 0, 17]), rng.permutation(64)[:40]):
        got = pv.pack_tails_host(keys, data, in_lens, off1, rows, L1, L)
        want = jv.pack_tails_host(keys, data, in_lens, off1, rows, L1, L)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    for ladder in (pv._D1_LADDER, pv._DT_LADDER, pv._ROW_LADDER):
        for need in (1, ladder[0], ladder[0] + 1, ladder[-1], ladder[-1] + 1, 3 * ladder[-1]):
            assert pv._ladder_pick(ladder, need) == jv._ladder_pick(ladder, need)


def test_stage1_decode_and_assembly_give_the_whole_wire():
    from warpdemux_tpu_torch.ops.vbz_device import pack_tails_host, split_wire_host, vbz_decode_batch
    from warpdemux_tpu_torch.pipeline.step import assemble_preload

    keys, data, _, _, in_lens = mixed_batch(3)
    whole = vbz_decode_batch(torch.from_numpy(keys), torch.from_numpy(data), L).to(torch.int16)
    keys1, data1, off1 = split_wire_host(keys, data, in_lens, L1)
    adc1 = vbz_decode_batch(torch.from_numpy(keys1), torch.from_numpy(data1), L1).to(torch.int16)
    assert torch.equal(adc1, whole[:, :L1])
    for rows in (np.arange(64), np.array([5, 40, 20, 63])):
        rows_p, keys_t, data_t = pack_tails_host(keys, data, in_lens, off1, rows, L1, L)
        assert (rows_p[len(rows):] == 64).all()  # the sentinel
        full = assemble_preload(
            adc1, torch.from_numpy(rows_p).long(), torch.from_numpy(keys_t), torch.from_numpy(data_t), L
        )
        assert torch.equal(full[rows], whole[rows])
        # the other rows hold their last stage-1 sample
        rest = np.setdiff1d(np.arange(64), rows)
        assert torch.equal(full[rest, L1:], adc1[rest, -1:].expand(-1, L - L1))
        # a row whose read fits the prefix is the whole wire's either way
        fits = rest[in_lens[rest] <= L1]
        assert torch.equal(full[fits], whole[fits])


@pytest.fixture(scope="module")
def steps():
    from warpdemux_tpu.config.utils import get_model_spc_config as jax_spc
    from warpdemux_tpu.models.registry import load_model as jax_load_model
    from warpdemux_tpu.pipeline.step import make_twostage_decision_step as jax_make_twostage
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.pipeline.step import make_demux_step, make_twostage_decision_step

    model, spc = load_model(MODEL, "cpu"), get_model_spc_config(MODEL)
    port = make_twostage_decision_step(model, spc, L1, device="cpu")
    one = make_demux_step(model, spc, input_format="vbz", outputs="decision", device="cpu")
    jax = jax_make_twostage(jax_load_model(MODEL), jax_spc(MODEL), stage1_len=L1)
    return {"port": port, "jax": jax, "one": one}


@pytest.fixture(scope="module")
def runs(steps):
    """Each batch through the port's and JAX's two-stage wire and the port's
    one-shot step."""
    out = {}
    for name, batch in (("bench", bench_batch()), ("short", short_batch())):
        out[name] = {
            "port": port_twostage(*steps["port"], *batch),
            "jax": jax_twostage(*steps["jax"], *batch),
            "one": steps["one"](*batch),
            "in_lens": batch[-1],
        }
    return out


@pytest.mark.parametrize("batch", ["bench", "short"])
def test_stage1_resolved_equals_jax_on_every_row(runs, batch):
    r = runs[batch]
    np.testing.assert_array_equal(r["port"][1], r["jax"][1])
    if batch == "short":
        assert r["port"][1].all()  # every read fits the prefix
    else:
        assert 0.55 <= r["port"][1].mean() < 1.0, r["port"][1].mean()  # stage 2 runs


@pytest.mark.parametrize("batch", ["bench", "short"])
def test_twostage_equals_the_one_shot_step_bit_for_bit(runs, batch):
    got, one = runs[batch]["port"][0], runs[batch]["one"]
    for field in got._fields:
        assert torch.equal(getattr(got, field), getattr(one, field)), field


@pytest.mark.parametrize("batch", ["bench", "short"])
def test_twostage_equals_jax_twostage(runs, batch):
    got, want = runs[batch]["port"][0], runs[batch]["jax"][0]
    for field in ("pred", "fail_code", "success"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)), field)
    for field in ("conf", "probs"):
        np.testing.assert_allclose(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)), rtol=1e-5, atol=1e-6, err_msg=field
        )


def test_value_errors():
    from dataclasses import replace

    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.detect.boundaries import detect_boundaries_batch
    from warpdemux_tpu_torch.ops.vbz_device import split_wire_host
    from warpdemux_tpu_torch.pipeline.step import make_demux_step, make_twostage_decision_step

    spc = get_model_spc_config(MODEL)
    long_cap = replace(spc, detect=replace(spc.detect, cnn_input_cap=L1 + 8))
    with pytest.raises(ValueError, match="prefix-causal"):
        make_twostage_decision_step(None, long_cap, L1, device="cpu")
    with pytest.raises(ValueError, match="prefix-causal"):
        make_demux_step(None, long_cap, input_format="adc", outputs="decision", resolve_limit=L1, device="cpu")
    for bad in (L1 + 4, 0, L):
        with pytest.raises(ValueError, match="8-aligned"):
            make_twostage_decision_step(None, spc, bad, device="cpu")
    with pytest.raises(ValueError, match="multiple of 8"):
        split_wire_host(np.zeros((1, L // 8), np.uint8), np.zeros((1, 16), np.uint8), np.ones(1), L1 + 4)
    for fmt, outputs in (("vbz", "decision"), ("pa", "decision"), ("adc", "full")):
        with pytest.raises(ValueError, match="resolve_limit requires"):
            make_demux_step(None, spc, input_format=fmt, outputs=outputs, resolve_limit=L1, device="cpu")
    dcfg = replace(spc.detect, method="llr")
    short = dcfg.min_obs_adapter + dcfg.var_window - 1
    x = torch.zeros((2, 4096))
    with pytest.raises(ValueError, match="rolling margin"):
        detect_boundaries_batch(x, torch.full((2,), 4096), dcfg, resolve_limit=short)


def test_start_peak_resolves_only_whole_reads():
    from chip_smoke import trna_minibatch
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    spc = get_model_spc_config("WDX4_tRNA_rna004_v1_0")
    assert spc.detect.method == "start_peak"
    adc, off, sc, lens, _, _ = trna_minibatch(np.random.default_rng(5), 40)
    limit = int(np.median(lens)) // 8 * 8
    step = make_demux_step(
        None, spc, with_predict=False, input_format="adc", outputs="decision", resolve_limit=limit, device="cpu"
    )
    _, resolved = step(adc[:, :limit], off, sc, lens)
    fits = lens <= limit
    assert fits.any() and not fits.all()
    np.testing.assert_array_equal(resolved.numpy(), fits)


@pytest.mark.parametrize(
    "change, takes_it",
    [
        ({}, True),
        ({"stage1_preload": 0}, False),
        ({"stage1_preload": 7172}, False),
        ({"stage1_preload": 10000}, False),
        ({"wire": "adc"}, False),
        ({"save_boundaries": True}, False),
        ({"predict": False}, False),
        ({"cnn_input_cap": 8192}, False),
        ({"method": "llr", "cnn_input_cap": 8192}, True),
        ({"model": "WDX4_tRNA_rna004_v1_0"}, False),
    ],
)
def test_the_jax_runs_rule_for_the_two_stage_wire(tmp_path, change, takes_it):
    """pipeline/run.use_twostage, term for term the JAX run's rule
    (warpdemux_tpu/pipeline/run.py:205-220, one device)."""
    from dataclasses import replace

    from chip_smoke import offline_config
    from warpdemux_tpu_torch.pipeline.run import select_outputs_mode, use_twostage

    cfg = offline_config(
        tmp_path, change.get("wire", "vbz"), False, model=change.get("model", MODEL),
        boundaries=change.get("save_boundaries", False), stage1_preload=change.get("stage1_preload", L1),
    )
    dcfg = replace(
        cfg.sig_proc.detect, **{k: change[k] for k in ("method", "cnn_input_cap") if k in change}
    )
    cfg = replace(
        cfg, sig_proc=replace(cfg.sig_proc, detect=dcfg),
        task=replace(cfg.task, predict=change.get("predict", True)),
    )
    assert use_twostage(cfg, select_outputs_mode(cfg)) is takes_it
