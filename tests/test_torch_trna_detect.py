"""Port parity: the tRNA chemistry's detect (start_peak primary, the
[real_range] and [med_shift] gates, fail codes 6, 7 and 9) against the
jitted JAX function.

Rows (numpy-seeded, L = 10000): barcoded tRNA reads with a poly(A) and
without one (the two-segment split path), tRNA reads without a capture
spike (fail 9), tRNA reads whose body sits at the adapter's level (fail 7)
and mRNA rows of bench.synth_minibatch (fail 6 and others). Every column
is held exactly but the region means and stds (rtol 1e-5, atol 1e-4: the
port sums in float64, XLA in float32), with the decision lane's gate-only
statistics and with the full region statistics.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpdemux_tpu.config.utils import get_model_spc_config as jax_spc
from warpdemux_tpu.detect import boundaries as jax_bd
from warpdemux_tpu_torch.config.utils import get_model_spc_config
from warpdemux_tpu_torch.detect import boundaries as bd
from warpdemux_tpu_torch.detect import cnn
from warpdemux_tpu_torch.utils.synthetic import (
    synth_trna_barcoded_read,
    synth_trna_read,
    trna_barcode_patterns,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import synth_minibatch  # noqa: E402

MODEL = "WDX4_tRNA_rna004_v1_0"
L = 10000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One CPU thread for torch here: the test workers share the machine's
    cores, and this file's many small operations gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def trna_rows(seed, n):
    """n rows cycling through: poly(A), no poly(A), no spike, a body at the
    adapter's level, an mRNA bench row."""
    rng = np.random.default_rng(seed)
    pats = trna_barcode_patterns(4, 25)
    adc, off, sc, lens_m = synth_minibatch(np.random.default_rng(seed), n, L)
    mrna = (adc.astype(np.float32) + off[:, None]) * sc[:, None]
    x = np.zeros((n, L), np.float32)
    lens = np.zeros(n, np.int32)
    for k in range(n):
        kind = k % 5
        if kind == 4:
            x[k], lens[k] = np.where(np.arange(L) < lens_m[k], mrna[k], 0), lens_m[k]
            continue
        if kind == 0:
            sig, _ = synth_trna_barcoded_read(rng, pats[k % 4])
        elif kind == 1:
            sig, _ = synth_trna_barcoded_read(rng, pats[k % 4], polya_len=0)
        elif kind == 2:
            sig, _ = synth_trna_read(rng, spike_idx=None)
        else:
            sig, _ = synth_trna_read(rng, trna_level=70.0)
        m = min(L, sig.size)
        x[k, :m], lens[k] = sig[:m], m
    return x, lens


@pytest.fixture(scope="module")
def rows():
    return trna_rows(21, 60)


def _assert_detect_equal(got, want, with_stats):
    for name in got._fields:
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            continue
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("with_stats", [False, True], ids=["gate-statistics", "region-statistics"])
def test_start_peak_detect_equals_jax(rows, with_stats):
    x, lens = rows
    got = bd.detect_boundaries_with_fallback(
        torch.from_numpy(x), torch.from_numpy(lens), get_model_spc_config(MODEL).detect,
        with_stats=with_stats,
    )
    want = jax_bd.detect_boundaries_with_fallback(x, lens, jax_spc(MODEL).detect, with_stats=with_stats)
    _assert_detect_equal(got, want, with_stats)
    fails = got.fail_code.numpy()
    # every branch is reached: passes, the real-range (6), med-shift (7)
    # and start-peak (9) gates; the split path on the rows without a poly(A)
    assert {0, 6, 7, 9} <= set(fails.tolist()), np.bincount(fails)
    no_polya = np.arange(x.shape[0]) % 5 == 1
    split = (got.polya_start == got.adapter_end).numpy() & (got.polya_end == got.polya_start).numpy()
    assert split[no_polya & (fails == 0)].all() and (no_polya & (fails == 0)).sum() >= 6
    assert (fails[np.arange(x.shape[0]) % 5 == 2] == 9).all()


def test_llr_split_window_bit_equal_to_jax(rows):
    """The two-segment split of the max_obs_adapter window (cumsum over
    6000 samples, fused multiply-adds, XLA's log): the split position bit
    for bit, from the rows' start-peak adapter starts and from starts near
    and past the row's end."""
    x, lens = rows
    cfg = get_model_spc_config(MODEL).detect
    xz = np.where(np.arange(L)[None, :] < lens[:, None], x, 0).astype(np.float32)
    starts = np.asarray(bd.detect_boundaries_with_fallback(
        torch.from_numpy(x), torch.from_numpy(lens), cfg, with_stats=False
    ).adapter_start.numpy())
    starts[:4] = [0, lens[1] - 10, lens[2], L - 1]
    jfn = jax.jit(jax_bd._llr_split_window, static_argnums=(2,))
    want = np.asarray(jfn(xz, starts, cfg.max_obs_adapter,
                          jnp.full(x.shape[0], cfg.min_obs_adapter, jnp.int32), lens))
    got = bd._llr_split_window(torch.from_numpy(xz), torch.from_numpy(starts), cfg.max_obs_adapter,
                               cfg.min_obs_adapter, torch.from_numpy(lens)).numpy()
    np.testing.assert_array_equal(got, want)


def test_downscale_mean_bit_equal_to_jax(rows):
    x, _ = rows
    want = np.asarray(jax.jit(lambda a: jnp.mean(a.reshape(a.shape[0], L // 10, 10), axis=2))(x))
    np.testing.assert_array_equal(cnn.downscale_mean(torch.from_numpy(x), 10).numpy(), want)


def test_wdx4b_trna_detect_config_equals_jax(rows):
    """The second tRNA model's chemistry gives the same columns."""
    x, lens = rows
    name = "WDX4b_tRNA_rna004_v1_0"
    got = bd.detect_boundaries_with_fallback(
        torch.from_numpy(x[:20]), torch.from_numpy(lens[:20]), get_model_spc_config(name).detect,
        with_stats=False,
    )
    want = jax_bd.detect_boundaries_with_fallback(x[:20], lens[:20], jax_spc(name).detect, with_stats=False)
    _assert_detect_equal(got, want, False)
