"""Port parity against the *jitted* JAX functions, which depend on the
host: under `jax.jit` XLA:CPU rewrites the t-score's num / sqrt(vsum) into
num * rsqrt(vsum) and computes the rsqrt as the x86 `vrsqrtps` estimate
plus two Newton steps, so its last bit is that of the CPU's estimate table.
The port carries the table of one Intel Xeon as data
(warpdemux_tpu_torch/ops/_rsqrt_table.py) and gives the same bits on every
host and on the GPU. Where this host's estimate is another (an AMD CPU, a
build of XLA that takes `vrsqrt14ps`), the jitted JAX function differs from
itself on the recording host, and these tests skip.

With the table: `xla_rsqrt`, the windowed t-test and the event
segmentation equal the jitted JAX functions bit for bit, and the full step
stays inside its column tolerances on the rows where the eager-equal port
did not (rows 88-92 of bench.synth_minibatch(default_rng(8), 300, 10000):
row 90's changepoint after event 33 moved, and with it 25 fingerprint
entries, 5 probabilities and the adapter event statistics).
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import synth_minibatch  # noqa: E402
from chip_smoke import k2_edge_cases  # noqa: E402
from warpdemux_tpu.ops.segmentation import segment_signal_batch as jax_segment  # noqa: E402
from warpdemux_tpu.ops.segmentation import windowed_t_test as jax_ttest  # noqa: E402
from warpdemux_tpu_torch.ops.numerics import xla_rsqrt  # noqa: E402
from warpdemux_tpu_torch.ops.segmentation import (  # noqa: E402
    segment_signal_batch,
    windowed_t_test_plain,
)

MODEL = "WDX4_rna004_v1_0"
ROWS = slice(88, 93)  # row 90 is the third
jit_ttest = jax.jit(jax_ttest, static_argnums=3)
jit_rsqrt = jax.jit(jax.lax.rsqrt)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.fixture(scope="module")
def table_host():
    """Skips unless this host's jitted rsqrt is the table's."""
    x = np.exp(np.random.default_rng(0).uniform(np.log(1e-30), np.log(1e30), 4096)).astype(np.float32)
    if not np.array_equal(_bits(jit_rsqrt(x)), _bits(xla_rsqrt(torch.from_numpy(x)).numpy())):
        pytest.skip("this host's rsqrt estimate is not the table's")


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("exponent", [-126, -31, -2, 0, 12, 126])
def test_xla_rsqrt_matches_jitted_lax_rsqrt_on_every_table_cell(table_host, parity, exponent):
    """Every cell of the table (10 mantissa bits) under a few exponents of
    each parity and low mantissa bits (zero, all ones, random): (1024, 8)."""
    rng = np.random.default_rng(exponent + 200)
    e = np.clip(exponent - exponent % 2 + parity, -126, 127) + 127
    low = np.concatenate([[0, 0x1FFF, 1, 0x1000], rng.integers(0, 0x2000, 4)]).astype(np.uint32)
    hi = np.arange(1024, dtype=np.uint32)[:, None]
    x = ((np.uint32(e) << 23) | (hi << 13) | low[None, :]).view(np.float32)
    assert x.shape == (1024, 8)
    np.testing.assert_array_equal(_bits(xla_rsqrt(torch.from_numpy(x)).numpy()), _bits(jit_rsqrt(x)))


def test_xla_rsqrt_specials_match_jitted_lax_rsqrt(table_host):
    x = np.array(
        [0.0, -0.0, 1e-45, -1e-45, 1e-40, -1e-40, 1.1754944e-38, -1.1754944e-38,
         -1.0, np.inf, -np.inf, np.nan, 1.0, 4.0, 3.4028235e38, 2.0], np.float32)
    got, want = xla_rsqrt(torch.from_numpy(x)).numpy(), np.asarray(jit_rsqrt(x))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(_bits(np.nan_to_num(got)), _bits(np.nan_to_num(want)))


def _random_adapters():
    rng = np.random.default_rng(3)
    x = rng.normal(80, 12, (8, 6272)).astype(np.float32)
    n = rng.integers(1000, 6273, 8).astype(np.int32)
    return x, n, np.clip(np.round(n / 110), 1, 12).astype(np.int32)


def test_windowed_t_test_equals_the_jitted_jax_function(table_host):
    x, n, w = _random_adapters()
    got = windowed_t_test_plain(torch.from_numpy(x), torch.from_numpy(n), torch.from_numpy(w), 12)
    want = np.asarray(jit_ttest(x, n, w, 12)[0])
    assert int(np.clip(n - 2 * w, 0, None).sum()) > 20000
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # dividing by the correctly rounded sqrt, as the eager JAX call does,
    # differs in the last bit on a third of the scores
    eager = np.asarray(jax_ttest(x, n, w, 12)[0])
    assert (_bits(eager) != _bits(want)).sum() > 5000


@pytest.mark.parametrize("L, w_fixed", [(6271, 1), (6271, 3), (100, 1), (100, 2), (103, 3), (6277, None)])
def test_windowed_t_test_equals_jitted_jax_off_the_vector_width(table_host, L, w_fixed):
    """XLA:CPU's loop is 8 wide; a length that is no multiple of 8 leaves a
    remainder, scored here by full-length rows of narrow windows. It takes
    the same lowering: equal bits there too."""
    rng = np.random.default_rng(L)
    x = rng.normal(80, 12, (8, L)).astype(np.float32)
    n = rng.integers(L // 2, L + 1, 8).astype(np.int32)
    n[:3] = L
    w = np.full(8, w_fixed, np.int32) if w_fixed else np.clip(np.round(n / 110), 1, 12).astype(np.int32)
    got = windowed_t_test_plain(torch.from_numpy(x), torch.from_numpy(n), torch.from_numpy(w), 12)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(jit_ttest(x, n, w, 12)[0]))


_FINITE_CASES = [c for c in k2_edge_cases() if "NaN" not in c[0] and "subnormal" not in c[0]]


@pytest.mark.parametrize("case", range(len(_FINITE_CASES)), ids=[c[0] for c in _FINITE_CASES])
def test_windowed_t_test_edge_cases_equal_jitted_jax(table_host, case):
    """The edge cases K2 is held to on the GPU (every width, widths outside
    [1, w_max], short and full rows, equal samples, odd lengths), through
    the plain version and the jitted JAX function."""
    _, x, n, w, w_max = _FINITE_CASES[case]
    got = windowed_t_test_plain(torch.from_numpy(x), torch.from_numpy(n), torch.from_numpy(w), w_max)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(jax.jit(jax_ttest, static_argnums=3)(x, n, w, w_max)[0]))


@pytest.fixture(scope="module")
def step_rows():
    """Rows 88-92 through both full steps (adc feed), and their clipped
    adapter buffers as the fingerprint stage segments them."""
    from warpdemux_tpu.config.utils import get_model_spc_config as jax_spc
    from warpdemux_tpu.models.registry import load_model as jax_load_model
    from warpdemux_tpu.pipeline.step import make_demux_step as jax_make_step
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.ops.fingerprint import extract_adapter_batch
    from warpdemux_tpu_torch.ops.normalize import clip_outliers_prefix
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    adc, off, sc, lens = (a[ROWS] for a in synth_minibatch(np.random.default_rng(8), 300, 10000))
    want = jax_make_step(jax_load_model(MODEL), jax_spc(MODEL), input_format="adc")(adc, off, sc, lens)
    spc = get_model_spc_config(MODEL)
    got = make_demux_step(load_model(MODEL, "cpu"), spc, input_format="adc", device="cpu")(adc, off, sc, lens)
    t = torch.from_numpy
    signals = (t(adc).float() + t(off)[:, None]) * t(sc)[:, None]
    det = want.unpack().detect
    cfg = spc.fingerprint
    adapter, a_len = extract_adapter_batch(
        signals, t(lens).int(), t(np.array(det.adapter_start)).int(), t(np.array(det.adapter_end)).int(),
        cfg.padding, cfg.buffer_len,
    )
    adapter = clip_outliers_prefix(adapter, a_len, cfg.sig_norm_outlier_thresh)
    mask = torch.arange(adapter.shape[1])[None, :] < a_len[:, None]
    return got, want, torch.where(mask, adapter, torch.zeros(())), a_len, cfg


def test_windowed_t_test_equals_jitted_jax_on_the_adapters_of_rows_88_to_92(table_host, step_rows):
    _, _, adapter, a_len, cfg = step_rows
    assert adapter.shape == (5, 6272)
    w = torch.clamp(torch.round(a_len.float() / cfg.num_events).int(), 1, cfg.running_stat_width)
    got = windowed_t_test_plain(adapter, a_len, w, cfg.running_stat_width)
    want = jit_ttest(adapter.numpy(), a_len.numpy(), w.numpy(), cfg.running_stat_width)[0]
    assert int((a_len - 2 * w).sum()) > 14000
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_every_dwell_of_row_90_equals_jitted_jax(table_host, step_rows):
    """All 111 events of the segmentation, not the fingerprint's last 25:
    the eager-equal t-score put row 90's changepoint after event 33
    elsewhere than JAX's 950."""
    _, _, adapter, a_len, cfg = step_rows
    args = (cfg.num_events, cfg.min_obs_per_base, cfg.running_stat_width)
    got = segment_signal_batch(adapter, a_len, *args)
    want = jax.jit(jax_segment, static_argnums=(2, 3, 4))(adapter.numpy(), a_len.numpy(), *args)
    ok = np.asarray(want[2])
    assert ok[2] and ok.sum() == 4 and np.asarray(want[1]).shape == (5, 111)
    np.testing.assert_array_equal(got[2].numpy(), ok)
    np.testing.assert_array_equal(got[1].numpy()[ok], np.asarray(want[1])[ok])
    np.testing.assert_array_equal(got[5].numpy()[ok], np.asarray(want[5])[ok])
    assert int(got[5][2, 34]) == 950


def test_full_step_columns_of_rows_88_to_92_within_tolerance(table_host, step_rows):
    """Every column of the full output, at the tolerances of
    tests/test_torch_step_full.py (its lists of columns)."""
    from test_torch_step_full import EXACT_F, FPT_COLS, FPT_F, REGION_F
    from warpdemux_tpu.pipeline.schema import PackSchema as JaxSchema
    from warpdemux_tpu_torch.pipeline.schema import PackSchema

    got, want = step_rows[:2]
    gi, gf = got.big_i.numpy(), got.big_f.numpy()
    wi, wf = np.asarray(want.big_i), np.asarray(want.big_f)
    schema, jschema = PackSchema.from_buffers(gi, gf), JaxSchema.from_buffers(wi, wf)
    wints = jschema.unpack(wi, np.int32)
    ok = wints["fpt_ok"] == 1
    assert ok.tolist() == [True, False, True, True, True]
    for name, g in schema.unpack(gi, np.int32).items():
        rows = ok if name in FPT_COLS else slice(None)
        np.testing.assert_array_equal(g[rows], wints[name][rows], err_msg=name)
    wcols = jschema.unpack(wf, np.float32)
    for name, g in schema.unpack(gf, np.float32).items():
        rows = ok if name in FPT_COLS else slice(None)
        g, w = g[rows], wcols[name][rows]
        assert name in EXACT_F | REGION_F | FPT_F | {"probs"}, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    for name in ("success", "pred", "conf"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
