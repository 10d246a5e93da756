"""Port parity: boundary detection (kernels K6, K7 and K9's plain versions,
the CNN region prior, the LLR fallback chain, the region statistics)
against the JAX package."""

import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpdemux_tpu.config.utils import get_model_spc_config as jax_spc
from warpdemux_tpu.detect import boundaries as jax_bd
from warpdemux_tpu.detect import cnn as jax_cnn
from warpdemux_tpu.ops.rolling_pallas import (
    rolling_detect_pallas,
    rolling_mean_var_pallas,
    rolling_run_sum_pallas,
)
from warpdemux_tpu.utils.synthetic import synth_batch
from warpdemux_tpu_torch.config.utils import get_model_spc_config
from warpdemux_tpu_torch.detect import boundaries as bd
from warpdemux_tpu_torch.models.registry import load_cnn

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import synth_minibatch  # noqa: E402
from chip_smoke import k7_edge_cases  # noqa: E402

# the masks kernel K7 is held to on the GPU
EDGE_MASKS = k7_edge_cases()

MODEL = "WDX4_rna004_v1_0"


def _bench_rows(n, seed=0):
    """Calibrated reads of bench.py's generator (seed 0 = the bench batch)."""
    adc, off, sc, lens = synth_minibatch(np.random.default_rng(seed), n, 10000)
    x = (adc.astype(np.float32) + off[:, None]) * sc[:, None]
    return x.astype(np.float32), lens


def test_rolling_mean_var_matches_jax():
    """Bit-identical to the jitted jnp path (same blocked prefix sums, same
    fused multiply-add); within tests/test_detect.py:106's prefix-sum tolerance
    of the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(31)
    B, L = 5, 2048
    x = rng.normal(80, 12, (B, L)).astype(np.float32)
    got = [a.numpy() for a in bd.rolling_mean_var(torch.from_numpy(x), 300, 150)]
    # jitted, as in the step: XLA fuses s2/n - mean*mean into one FMA only
    # inside a compiled program
    stats = jax.jit(lambda a: jax_bd._rolling_stats(a, 300, 150))
    want = [np.asarray(a) for a in stats(x)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    m, vf, vw = [np.asarray(a) for a in rolling_mean_var_pallas(x, 300, 150, interpret=True)]
    np.testing.assert_allclose(got[0], m, rtol=5e-4, atol=0.05)
    for g, w, win in ((got[1], vf, 300), (got[2], vw, 150)):
        np.testing.assert_allclose(g[:, : L - win], w[:, : L - win], rtol=3e-3, atol=0.1)
        np.testing.assert_allclose(g[:, L - win :], w[:, L - win :], atol=5.0)


@pytest.mark.parametrize(
    "L, w_mean, w_var",
    [(2047, 300, 150), (9, 3, 5), (300, 400, 1000), (4100, 200, 500), (70001, 200, 500)],
    ids=["not-a-multiple-of-16", "shorter-than-a-block", "windows-longer-than-the-row",
         "three-levels", "five-levels"],
)
def test_rolling_mean_var_plain_matches_jax_at_edge_lengths(L, w_mean, w_var):
    """The plain version (kernel K6's yardstick) at the lengths where the
    blocked scan's levels end unevenly: bit for bit the jitted jnp path,
    except the variances of the windows of 2 and 4 samples at the row's end.
    There XLA:CPU knows the count when it compiles the loop's remainder,
    multiplies by 1/n and fuses that product, not mean * mean, into the
    subtraction: one more float32 rounding of mean**2, at most 2**-9 for the
    means here (below 180). No run of min_obs_polya samples starts there."""
    x = np.random.default_rng(L).normal(80, 12, (3, L)).astype(np.float32)
    got = bd.rolling_mean_var_plain(torch.from_numpy(x), w_mean, w_var)
    want = jax.jit(lambda a: jax_bd._rolling_stats(a, w_mean, w_var))(x)
    loose = np.zeros(L, bool)
    loose[[t for t in (L - 2, L - 4) if t >= 0]] = True
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_array_equal(g[:, ~loose], w[:, ~loose])
        np.testing.assert_allclose(g[:, loose], w[:, loose], rtol=0, atol=2.0**-9)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))  # means: everywhere


@pytest.mark.parametrize("L", [1, 16, 17, 10000, 25731, 25732, 70001])
def test_scan_buffers_follow_the_shared_memory_limit(L):
    """K6's launch geometry: the prefix buffers (level 0 padded by one float
    per block of 16, the levels above behind it) go into shared memory
    while two of them fit 232,448 bytes, else into a device scratch tensor
    of the unpadded length."""
    row_len, shared_bytes, scratch = bd._scan_buffers(2, L, "cpu")
    levels, n = [], L
    while n > 16:
        n = -(-n // 16)
        levels.append(n)
    if L <= 25731:
        assert scratch is None and shared_bytes == 8 * row_len <= bd.MAX_SHARED_BYTES
        assert row_len == L + (L - 1) // 16 + sum(levels)
        # K9's candidate bytes ride along
        assert bd._scan_buffers(2, L, "cpu", extra_shared=L)[1] in (0, shared_bytes + L)
    else:
        assert shared_bytes == 0 and scratch.shape == (2, 2, L + sum(levels))


@pytest.mark.parametrize("w", [1, 100, 130, 5000])
def test_run_sum_exact(w):
    rng = np.random.default_rng(w)
    mask = rng.random((6, 3000)) < 0.4
    got = bd.run_sum(torch.from_numpy(mask), w).numpy()
    want = np.asarray(rolling_run_sum_pallas(jnp.asarray(mask), w, interpret=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", range(len(EDGE_MASKS)), ids=[c[0] for c in EDGE_MASKS])
def test_run_sum_plain_matches_jax_at_edge_cases(case):
    """K7's plain version (the kernel's yardstick) on rows of 1, 7 and 9999
    samples with windows from 1 to longer than the row, and on constant
    masks: equal to the JAX package's jnp path and to its Pallas kernel in
    interpret mode."""
    _, mask, w = EDGE_MASKS[case]
    got = bd.run_sum_plain(torch.from_numpy(mask), w).numpy()
    assert got.dtype == np.int32 and got.max() <= min(w, mask.shape[1])
    np.testing.assert_array_equal(got, np.asarray(jax_bd._run_sum(jnp.asarray(mask), w)))
    np.testing.assert_array_equal(
        got, np.asarray(rolling_run_sum_pallas(jnp.asarray(mask), w, interpret=True))
    )


@pytest.mark.parametrize(
    "L, want",
    [(0, 16), (1, 16), (7, 16), (15, 32), (9999, 20000), (10000, 20016), (57856, 115728),
     (65535, 131072), (65536, 0), (70000, 0)],
)
def test_run_sum_counts_follow_the_shared_memory_limit(L, want):
    """K7's launch geometry: the row's L + 1 uint16 prefix counts, in whole
    16-byte vectors, go into shared memory while a count can hold L (they
    then fit a block's 232,448 bytes beside the scan's static kilobyte);
    longer rows get 0 bytes, the direct variant."""
    assert bd._run_sum_shared_bytes(L) == want
    if want:
        assert (L + 1) * 2 <= want <= bd.MAX_SHARED_BYTES - bd._RUN_SUM_STATIC_BYTES
    assert (want > 0) == (L <= bd._RUN_SUM_MAX_LEN)


@pytest.mark.parametrize("L", [1, 10000, 22000, 25731])
def test_rolling_detect_buffers_leave_room_for_the_run_sum_scan(L):
    """K9's launch geometry: the candidate bytes ride behind the prefix sums
    padded to 16-byte chunks, and the shared-memory variant is taken only
    while the scan's static kilobyte still fits."""
    pad = -(-L // 16) * 16
    row_len, shared_bytes, scratch = bd._scan_buffers(
        2, L, "cpu", extra_shared=pad, static_shared=bd._RUN_SUM_STATIC_BYTES
    )
    if scratch is None:
        assert shared_bytes == 8 * row_len + pad <= bd.MAX_SHARED_BYTES - bd._RUN_SUM_STATIC_BYTES
        assert 2 * row_len >= L + 1  # the packed counts take the prefix sums' place
    else:
        assert shared_bytes == 0 and L > 20000


def test_cnn_region_prior_matches_jax():
    spc = get_model_spc_config(MODEL)
    x, lens = _bench_rows(16, seed=3)
    lens[:4] = [3000, 7000, 7168, 9000]
    pos = np.arange(x.shape[1])[None]
    xz = np.where(pos < lens[:, None], x, 0).astype(np.float32)
    cnn = load_cnn(spc.cnn_model_name, "cpu")
    got = bd.cnn_region_mask(
        torch.from_numpy(xz), torch.from_numpy(lens), spc.detect, cnn, x.shape[1]
    ).numpy()
    params = jax_cnn.load_params(spc.cnn_model_name)
    want = np.asarray(
        jax_bd._cnn_region_mask(
            jnp.asarray(xz), jnp.asarray(lens), jax_spc(MODEL).detect, params,
            jnp.asarray(np.broadcast_to(pos, x.shape).astype(np.int32)), x.shape[1],
        )
    )
    assert want.sum() > 0
    np.testing.assert_array_equal(got, want)


def _assert_detect_equal(got, want):
    """Every column exact, the region means / stds too (the masked rows
    summed in XLA's order, ops/rowstats.py)."""
    for name, value in got._asdict().items():
        if value is None:  # `resolved`, set only with a resolve_limit
            assert getattr(want, name) is None, name
            continue
        np.testing.assert_array_equal(value.numpy(), np.asarray(getattr(want, name)), err_msg=name)


def test_detect_with_fallback_matches_jax_on_bench_reads():
    """The production configuration (CNN prior + LLR fallback) on 64 bench
    reads: every column the decision lane computes is identical."""
    spc = get_model_spc_config(MODEL)
    x, lens = _bench_rows(64)
    got = bd.detect_boundaries_with_fallback(
        torch.from_numpy(x), torch.from_numpy(lens), spc.detect,
        load_cnn(spc.cnn_model_name, "cpu"), with_stats=False,
    )
    jspc = jax_spc(MODEL)
    want = jax_bd.detect_boundaries_with_fallback(
        x, lens, jspc.detect, jax_cnn.load_params(jspc.cnn_model_name),
        with_stats=False,
    )
    assert 0 < int(np.asarray(want.used_llr_fallback).sum())
    _assert_detect_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_detect_llr_matches_jax_on_synthetic_reads(seed):
    rng = np.random.default_rng(seed)
    sigs, lens, _ = synth_batch(rng, 24)
    lens[:3] = [1500, 2100, 4000]  # too short / short reads
    cfg = replace(get_model_spc_config(MODEL).detect, method="llr", fallback_to_llr=False)
    got = bd.detect_boundaries_with_fallback(
        torch.from_numpy(sigs), torch.from_numpy(lens), cfg, with_stats=False
    )
    want = jax_bd.detect_boundaries_with_fallback(
        sigs, lens, jax_bd.DetectConfig(**cfg.__dict__), with_stats=False
    )
    assert np.asarray(want.success).sum() >= 12
    _assert_detect_equal(got, want)


@pytest.mark.parametrize(
    "change",
    [
        {"method": "start_peak"},
        {"real_signal_check": True},
        {"detect_med_shift": True},
    ],
)
def test_trna_detect_options_on_the_mrna_config_equal_jax(change):
    """The options of the tRNA chemistry on the production mRNA
    configuration (CNN prior + LLR fallback, start_peak with the fallback):
    every column the decision lane computes equals the jitted JAX
    function's on 16 bench reads."""
    spc = get_model_spc_config(MODEL)
    cfg = replace(spc.detect, **change)
    x, lens = _bench_rows(16)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the test workers share the machine's cores
    try:
        got = bd.detect_boundaries_with_fallback(
            torch.from_numpy(x), torch.from_numpy(lens), cfg, load_cnn(spc.cnn_model_name, "cpu"),
            with_stats=False,
        )
    finally:
        torch.set_num_threads(threads)
    jcfg = replace(jax_spc(MODEL).detect, **change)
    want = jax_bd.detect_boundaries_with_fallback(
        x, lens, jcfg, jax_cnn.load_params(spc.cnn_model_name), with_stats=False
    )
    _assert_detect_equal(got, want)


def test_rolling_detect_matches_jax_kernel_and_the_unfused_stats():
    """K9's plain version on tests/test_detect.py:190's inputs, with a flat
    elevated stretch added so that the candidate masks are not empty: the
    statistics are rolling_mean_var's bit for bit (and within prefix-sum
    rounding of the Pallas kernel in interpret mode, whose scan differs);
    each implementation's run sums are exact on the masks rebuilt from its
    own statistics."""
    rng = np.random.default_rng(41)
    B, L = 6, 2048
    w_mean, w_var, w_run, svm = 200, 500, 100, 30.0
    x = rng.normal(80, 12, (B, L)).astype(np.float32)
    x[:, 600:1500] = rng.normal(104, 1.8, (B, 900))
    in_lens = rng.integers(900, L + 1, B).astype(np.int32)
    pos = np.arange(L)[None, :]
    xz = np.where(pos < in_lens[:, None], x, 0.0).astype(np.float32)
    region = (rng.random((B, L)) < 0.5).astype(np.float32)
    thr = rng.uniform(85, 100, B).astype(np.float32)

    t = torch.from_numpy
    got = [a.numpy() for a in bd.rolling_detect(t(xz), t(region), t(thr), t(in_lens),
                                                w_mean, w_var, w_run, svm)]
    unfused = bd.rolling_mean_var(t(xz), w_mean, w_var)
    for g, u in zip(got[:3], unfused):
        np.testing.assert_array_equal(g, u.numpy())
    want = [np.asarray(a) for a in rolling_detect_pallas(
        jnp.asarray(xz), jnp.asarray(region), jnp.asarray(thr), jnp.asarray(in_lens),
        w_mean, w_var, w_run, svm, interpret=True,
    )]
    np.testing.assert_allclose(got[0], want[0], rtol=5e-4, atol=0.05)
    np.testing.assert_allclose(got[2][:, : L - w_var], want[2][:, : L - w_var], rtol=3e-3, atol=0.1)

    valid = (pos < in_lens[:, None]) & (pos + w_run <= in_lens[:, None])
    for m, vw, rsp, rsm in ((got[0], got[2], got[3], got[4]), (want[0], want[2], want[3], want[4])):
        base = (m > thr[:, None]) & (vw < svm) & valid
        for rs, mask in ((rsp, base), (rsm, base & (region > 0))):
            np.testing.assert_array_equal(rs, bd.run_sum(t(mask), w_run).numpy())
    assert got[3].max() == w_run and got[4].max() > 0


def test_fused_detect_equals_unfused_on_bench_reads():
    """fused_rolling (K9) and the unfused path (K6 + K7) decide identically
    on the production configuration: every field equal."""
    spc = get_model_spc_config(MODEL)
    x, lens = _bench_rows(64, seed=5)
    cnn = load_cnn(spc.cnn_model_name, "cpu")
    args = (torch.from_numpy(x), torch.from_numpy(lens), spc.detect, cnn)
    fused = bd.detect_boundaries_with_fallback(*args, fused_rolling=True)
    plain = bd.detect_boundaries_with_fallback(*args, fused_rolling=False)
    assert 0 < int(plain.used_llr_fallback.sum()) and int(plain.success.sum()) > 32
    for name, value in fused._asdict().items():
        if value is None:  # `resolved`, set only with a resolve_limit
            assert getattr(plain, name) is None, name
            continue
        assert torch.equal(value, getattr(plain, name)), name


def test_detect_with_stats_and_adc_matches_jax_on_bench_reads():
    """with_stats (the full step's region statistics on the merged
    boundaries) and the adc preimage (K8's gate medians) against the JAX
    detect given the same inputs: boundaries, codes, medians and MADs
    exact, means and stds within float32 summation order."""
    spc = get_model_spc_config(MODEL)
    adc, off, sc, lens = synth_minibatch(np.random.default_rng(6), 48, 10000)
    x = ((adc.astype(np.float32) + off[:, None]) * sc[:, None]).astype(np.float32)
    got = bd.detect_boundaries_with_fallback(
        torch.from_numpy(x), torch.from_numpy(lens), spc.detect,
        load_cnn(spc.cnn_model_name, "cpu"), adc=torch.from_numpy(adc),
    )
    jspc = jax_spc(MODEL)
    want = jax_bd.detect_boundaries_with_fallback(
        x, lens, jspc.detect, jax_cnn.load_params(jspc.cnn_model_name), adc=adc,
    )
    assert np.asarray(want.rna_mad).min() > 0
    _assert_detect_equal(got, want)


def test_detect_llr_with_stats_matches_jax():
    """A single llr pass with the region statistics (three ranges, one K4
    launch with the MAD)."""
    rng = np.random.default_rng(2)
    sigs, lens, _ = synth_batch(rng, 24)
    lens[:2] = [1500, 4000]
    cfg = replace(get_model_spc_config(MODEL).detect, method="llr", fallback_to_llr=False)
    got = bd.detect_boundaries_batch(torch.from_numpy(sigs), torch.from_numpy(lens), cfg)
    want = jax_bd.detect_boundaries_batch(sigs, lens, jax_bd.DetectConfig(**cfg.__dict__))
    _assert_detect_equal(got, want)


def test_fused_rolling_default_reads_the_environment(monkeypatch):
    monkeypatch.delenv("WDX_FUSED_ROLLING", raising=False)
    assert bd.fused_rolling_default() is False
    monkeypatch.setenv("WDX_FUSED_ROLLING", "1")
    assert bd.fused_rolling_default() is True


def test_cnn_preprocess_equals_jitted_jax_on_1000_rows():
    """The CNN's input (mean-pooled by 10, median / MAD normalized) at all
    716,000 positions of the seed-0 bench batch cut at cnn_input_cap 7168,
    bit for bit: the pool a sequential float32 sum times float32(0.1), and
    that product contracted into the deviations as XLA contracts it."""
    from warpdemux_tpu_torch.detect import cnn

    spc = get_model_spc_config(MODEL)
    cap, ds = spc.detect.cnn_input_cap, spc.detect.downscale_factor
    x, lens = _bench_rows(1000)
    x, lens = np.ascontiguousarray(x[:, :cap]), np.minimum(lens, cap)
    want = jax.jit(jax_cnn.preprocess, static_argnums=(2,))(x, lens, ds)
    got = cnn.preprocess(torch.from_numpy(x), torch.from_numpy(lens), ds)
    assert got[0].shape == (1000, cap // ds) == (1000, 716)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy().view(np.int32), np.asarray(want[0]).view(np.int32))
