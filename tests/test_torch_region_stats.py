"""The region means and stds and the [mvs_polya] gate's poly(A) mean of the
port (ops/rowstats.py, the plain version of kernel K11) against the jitted
JAX step, bit for bit.

- The full step's six region columns on rows 0-255 of the seed-0 bench
  batch, on the adc, vbz and pa feeds (WDX4, full outputs).
- The gate's poly(A) mean, `sum(where(pa_mask, x, 0)) / max(count, 1)` as
  warpdemux_tpu/detect/boundaries.py:695 computes it, jitted with the
  calibration in the same program, on the poly(A) ranges the step detected.
- `range_mean_std_plain` on chip_smoke.k11_edge_cases() (row lengths at
  each window seam, empty, inverted and out-of-row ranges, NaN and inf,
  the calibrated form) against the JAX package's `masked_mean_std`, jitted
  as the step runs it.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpdemux_tpu.ops.normalize import masked_mean_std as jax_masked_mean_std

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import VBZ_WIDTH, synth_minibatch  # noqa: E402
from chip_smoke import k11_edge_cases  # noqa: E402
from warpdemux_tpu_torch.ops.rowstats import range_mean_std, range_mean_std_plain  # noqa: E402

MODEL = "WDX4_rna004_v1_0"
N_ROWS = 256
REGION_COLS = ("adapter_mean", "adapter_std", "polya_mean", "polya_std", "rna_mean", "rna_std")
EDGE = k11_edge_cases()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One CPU thread for torch here: the test workers share the machine's
    cores, and this file's many small operations gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def feeds():
    from warpdemux_tpu_torch.ops.vbz_device import inner_layout_from_adc, pack_inner_host

    adc, off, sc, lens = (a[:N_ROWS] for a in synth_minibatch(np.random.default_rng(0), 1000, 10000))
    pa = ((adc.astype(np.float32) + off[:, None]) * sc[:, None]).astype(np.float32)
    keys, data = pack_inner_host([inner_layout_from_adc(r) for r in adc], adc.shape[1], VBZ_WIDTH)
    return {"adc": (adc, off, sc, lens), "vbz": (keys, data, off, sc, lens), "pa": (pa, lens)}


def _columns(out, schema_cls):
    bi, bf = np.asarray(out.big_i), np.asarray(out.big_f)
    schema = schema_cls.from_buffers(bi, bf)
    return {**schema.unpack(bi, np.int32), **schema.unpack(bf, np.float32)}


@pytest.fixture(scope="module")
def steps(feeds):
    """{feed: (port columns, JAX columns)} of the full step on N_ROWS rows."""
    from warpdemux_tpu.config.utils import get_model_spc_config as jax_spc
    from warpdemux_tpu.models.registry import load_model as jax_load_model
    from warpdemux_tpu.pipeline.schema import PackSchema as JaxSchema
    from warpdemux_tpu.pipeline.step import make_demux_step as jax_make_step
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.pipeline.schema import PackSchema
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    jmodel, jspc = jax_load_model(MODEL), jax_spc(MODEL)
    model, spc = load_model(MODEL, "cpu"), get_model_spc_config(MODEL)
    out = {}
    for feed, args in feeds.items():
        got = make_demux_step(model, spc, input_format=feed, device="cpu")(*args)
        want = jax_make_step(jmodel, jspc, input_format=feed)(*args)
        out[feed] = (_columns(got, PackSchema), _columns(want, JaxSchema))
    return out


@pytest.mark.parametrize("feed", ["adc", "vbz", "pa"])
def test_region_means_and_stds_equal_the_jitted_jax_step(steps, feed):
    got, want = steps[feed]
    assert (want["polya_end"] > want["polya_start"]).sum() >= 200
    for name in REGION_COLS:
        g, w = got[name], want[name]
        assert np.array_equal(g.view(np.int32), w.view(np.int32)), (
            f"{name}: {int((g != w).sum())} of {N_ROWS} rows differ"
        )


def test_gate_polya_mean_equals_the_jitted_jax_expression(feeds, steps):
    """On the poly(A) ranges of the detect passes (the merged columns and
    the CNN's and LLR's own), with the calibration inside the program."""
    adc, off, sc, _ = feeds["adc"]
    cols = steps["adc"][1]

    @jax.jit
    def jax_gate_mean(adc, off, sc, ps, pe):
        x = (adc.astype(jnp.float32) + off[:, None]) * sc[:, None]
        pos = jnp.arange(x.shape[1], dtype=jnp.int32)[None, :]
        pa_mask = (pos >= ps[:, None]) & (pos < pe[:, None])
        return jnp.sum(jnp.where(pa_mask, x, 0.0), axis=1) / jnp.maximum(jnp.sum(pa_mask, axis=1), 1)

    t = torch.from_numpy
    x = (t(adc).to(torch.float32) + t(off)[:, None]) * t(sc)[:, None]
    n_ranges = 0
    for prefix in ("", "prim_", "llr_"):
        ps, pe = cols[f"{prefix}polya_start"], cols[f"{prefix}polya_end"]
        want = np.asarray(jax_gate_mean(adc, off, sc, ps, pe))
        got = range_mean_std(x, t(ps)[None], t(pe)[None], with_std=False,
                             calibration=(t(adc), t(off), t(sc)))[0][0].numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=prefix)
        n_ranges += int((pe > ps).sum())
    assert n_ranges >= 600


@pytest.mark.parametrize("case", EDGE, ids=[c[0] for c in EDGE])
def test_range_mean_std_plain_equals_jitted_jax_on_edge_cases(case):
    _, x, calibration, starts, ends = case
    L = x.shape[1]
    pos = np.arange(L)[None, :]

    if calibration is None:
        jfn = jax.jit(jax_masked_mean_std)
    else:  # the calibration inside the program, from arguments (not constants)
        jfn = jax.jit(lambda adc, off, sc, m: jax_masked_mean_std(
            (adc.astype(jnp.float32) + off[:, None]) * sc[:, None], m))
    t = torch.from_numpy
    cal_t = None if calibration is None else tuple(t(a) for a in calibration)
    means, stds = range_mean_std_plain(t(x), t(starts), t(ends), True, cal_t)
    only_means, none = range_mean_std_plain(t(x), t(starts), t(ends), False, cal_t)
    assert none is None and torch.equal(only_means.nan_to_num(), means.nan_to_num())
    for r in range(starts.shape[0]):
        mask = (pos >= starts[r][:, None]) & (pos < ends[r][:, None])
        wm, ws = (np.asarray(a) for a in jfn(*(calibration or (x,)), mask))
        for name, g, w in (("mean", means[r].numpy(), wm), ("std", stds[r].numpy(), ws)):
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{name} range {r}")
            same = np.isnan(w) | (g.view(np.int32) == w.view(np.int32))
            assert same.all(), f"{name} range {r}: rows {np.nonzero(~same)[0]}: {g[~same]} vs {w[~same]}"


def test_range_mean_std_dispatch_and_shape_checks():
    x = torch.zeros((3, 40))
    st = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        range_mean_std(x, st, torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        range_mean_std(x, st, st, calibration=(torch.zeros((3, 41), dtype=torch.int16), x[:, 0], x[:, 0]))
    means, stds = range_mean_std(x, st, st + 5)
    assert means.shape == stds.shape == (2, 3) and not means.any() and not stds.any()


def test_k11_variant_switch_shapes():
    """K11's block kernel takes rows up to the stated lengths (calibrated /
    float, three ranges and one), the warp kernel the rows above to 431,104
    samples, the workspace kernel every longer row (a fourth level of the
    sum tree past 1,048,576); a row of no samples, a forced kernel beyond
    its own rows or an unknown kernel, ValueError."""
    from warpdemux_tpu_torch.ops.rowstats import _variant

    for R, calibrated, longest in ((3, True, 92480), (3, False, 51456), (1, True, 103072), (1, False, 54624)):
        assert _variant(longest, R, calibrated, None)[0] == "block"
        assert _variant(longest + 1, R, calibrated, None)[0] == "warp"
    assert _variant(10000, 3, True, None) == ("block", 25284)
    assert _variant(10000, 3, True, "warp")[0] == "warp"
    assert _variant(10000, 3, True, "global") == ("global", 4 * 4 * 32 * 33)
    assert _variant(431104, 3, True, None)[0] == "warp"
    for L in (431105, 1048577):
        for calibrated in (True, False):
            assert _variant(L, 3, calibrated, None) == ("global", 4 * 4 * 32 * 33)
    for args in ((431105, 3, True, "warp"), (1048577, 3, False, "block"), (92481, 3, True, "block"),
                 (0, 3, True, None), (0, 3, True, "global"), (100, 3, True, "tile")):
        with pytest.raises(ValueError):
            _variant(*args)
