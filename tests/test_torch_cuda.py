"""Hand-written CUDA kernels (csrc/) against their plain PyTorch versions,
and the decision step on the GPU against the CPU path.

These need a CUDA GPU of compute capability 9.0 (the kernels are built for
sm_90a) and the CUDA toolkit; they carry the `cuda` marker and skip
elsewhere. Run them on the GPU host with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py imports jax, which that host lacks;
this file needs neither jax nor the JAX package.)
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import synth_minibatch  # noqa: E402
from chip_smoke import (  # noqa: E402
    K12_SHAPES,
    LAUNCHES,
    k1_tie_case,
    k2_edge_cases,
    k3_edge_cases,
    k4_edge_cases,
    k5_edge_cases,
    k7_edge_cases,
    k8_edge_cases,
    k10_edge_cases,
    k10_step_series,
    k11_edge_cases,
    k11_step_ranges,
    family_arrays,
    rna002_minibatch,
    RNA002_MODELS,
    live_bucket_batches,
    live_lane_reads,
    check_worker_runs,
    offline_batches,
    offline_config,
    shard_texts,
    trna_minibatch,
    worker_runs,
)
from warpdemux_tpu_torch import _cuda  # noqa: E402
from warpdemux_tpu_torch.detect import boundaries as bd  # noqa: E402
from warpdemux_tpu_torch.models.registry import load_model_arrays  # noqa: E402
from warpdemux_tpu_torch.ops import dtw, peaks, rowstats, segmentation, select, subsequence, window_gather  # noqa: E402

pytestmark = pytest.mark.cuda
MODEL = "WDX4_rna004_v1_0"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; the csrc/ kernels have no CPU mode")
    return torch.device("cuda", 0)


def _signal(dev, B=64, L=10000, seed=2):
    return _calibrated(dev, B, L, seed)[0]


def _calibrated(dev, B=64, L=10000, seed=2):
    """(x, adc, offset, scale) of bench reads on the card."""
    adc, off, sc, _ = synth_minibatch(np.random.default_rng(seed), B, L)
    t = lambda a: torch.as_tensor(a, device=dev)
    adc, off, sc = t(adc), t(off), t(sc)
    return (adc.float() + off[:, None]) * sc[:, None], adc, off, sc


def _launched(name, fn):
    before = _cuda.launches[name]
    out = fn()
    torch.cuda.synchronize()
    assert _cuda.launches[name] == before + 1
    return out


@pytest.mark.parametrize("n_ref", [851, 2601])
def test_k1_dtw(dev, n_ref):
    Y = load_model_arrays(MODEL if n_ref == 851 else "WDX10_rna004_v1_0")["X_sv"]
    Y = torch.as_tensor(Y.astype(np.float32), device=dev)
    # the last 25 of 30 columns: a strided view, as the step's fingerprints are
    X = torch.as_tensor(np.random.default_rng(0).normal(0, 1, (64, 30)).astype(np.float32), device=dev)[:, -25:]
    got = _launched("wdx_dtw", lambda: dtw.dtw_distance_matrix(X, Y, 15, 0.1))
    want = dtw.dtw_distance_matrix_plain(X, Y, 15, 0.1)
    torch.testing.assert_close(got, want, rtol=4 * 2.0**-23, atol=0)


@pytest.mark.parametrize(
    "m, window, penalty, b, n",
    [(25, 15, 0.1, 37, 131), (20, 8, 0.1, 37, 131), (32, 32, 0.5, 9, 300), (25, 1, 0.0, 5, 7)],
)
def test_k1_dtw_instances_and_edge_tiles(dev, m, window, penalty, b, n):
    """The static instance at a B and N that divide no tile, the generic
    instance at other lattices, NaN and infinite samples included: bit for
    bit the plain version."""
    rng = np.random.default_rng(m + window)
    X = rng.normal(0, 1, (b, m)).astype(np.float32)
    Y = rng.normal(0, 1, (n, m)).astype(np.float32)
    X[1, 3], X[2, m - 1], X[3, 0], Y[n - 1, 2] = np.nan, np.inf, -np.inf, np.nan
    X, Y = torch.as_tensor(X, device=dev), torch.as_tensor(Y, device=dev)
    got = _launched("wdx_dtw", lambda: dtw.dtw_distance_matrix(X, Y, window, penalty))
    want = dtw.dtw_distance_matrix_plain(X, Y, window, penalty)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    assert bool(got[1].isnan().all()) and bool(torch.isfinite(got[0, : n - 1]).all())


def test_k1_dtw_at_a_float32_tie(dev):
    """K1's __fmaf_rn at a cell whose float64 sum lands on a float32 tie
    (chip_smoke.k1_tie_case): bit for bit the plain version's `fma`."""
    X, Y, window, penalty = (torch.as_tensor(a, device=dev) if isinstance(a, np.ndarray) else a
                             for a in k1_tie_case())
    got = _launched("wdx_dtw", lambda: dtw.dtw_distance_matrix(X, Y, window, penalty))
    assert torch.equal(got, dtw.dtw_distance_matrix_plain(X, Y, window, penalty))


def _same_bits(a, b):
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(
        a.nan_to_num().view(torch.int32), b.nan_to_num().view(torch.int32)
    )


def test_k2_ttest(dev):
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(80, 12, (64, 6272)).astype(np.float32), device=dev)
    n = torch.as_tensor(rng.integers(100, 6273, 64).astype(np.int32), device=dev)
    w = torch.as_tensor(rng.integers(1, 13, 64).astype(np.int32), device=dev)
    got, n_scores = _launched("wdx_ttest", lambda: segmentation.windowed_t_test(x, n, w, 12))
    assert _same_bits(got, segmentation.windowed_t_test_plain(x, n, w, 12))
    assert torch.equal(n_scores, torch.clamp_min(n - 2 * w, 0))


@pytest.mark.parametrize("case", range(len(k2_edge_cases())), ids=[c[0] for c in k2_edge_cases()])
def test_k2_ttest_edge_cases(dev, case):
    """Every width from 1 to 12, widths outside [1, w_max], rows shorter
    than two windows, full rows, windows of equal samples, a subnormal sum
    of squares, NaN and infinite samples, lengths off the vectors and the
    tiles: the bits of the plain version, and its n_scores."""
    _, x, n, w, w_max = k2_edge_cases()[case]
    x, n, w = (torch.as_tensor(a, device=dev) for a in (x, n, w))
    got, n_scores = _launched("wdx_ttest", lambda: segmentation.windowed_t_test(x, n, w, w_max))
    assert _same_bits(got, segmentation.windowed_t_test_plain(x, n, w, w_max))
    assert torch.equal(n_scores, torch.clamp_min(n - 2 * w, 0))


def test_k2_ttest_rows_off_the_vector_alignment(dev):
    flat = torch.as_tensor(np.random.default_rng(2).normal(80, 12, 9 * 1000 + 1).astype(np.float32), device=dev)
    x = flat[1:].view(9, 1000)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    n = torch.full((9,), 1000, dtype=torch.int32, device=dev)
    w = torch.arange(4, 13, dtype=torch.int32, device=dev)
    got, _ = _launched("wdx_ttest", lambda: segmentation.windowed_t_test(x, n, w, 12))
    assert _same_bits(got, segmentation.windowed_t_test_plain(x, n, w, 12))


@pytest.mark.parametrize("quantize", [False, True])
def test_k3_suppress(dev, quantize):
    rng = np.random.default_rng(3)
    s = rng.gamma(2.0, 1.0, (64, 6272)).astype(np.float32)
    if quantize:
        s = np.round(s * 4) / 4
    s = torch.as_tensor(s, device=dev)
    is_peak, _ = peaks.peak_mask_batch(s, torch.full((64,), 6272, device=dev))
    dist = torch.as_tensor(rng.integers(1, 8, 64).astype(np.int32), device=dev)
    got = _launched("wdx_suppress", lambda: peaks.suppress_by_distance(s, is_peak, dist, 7))
    assert torch.equal(got, peaks.suppress_by_distance_plain(s, is_peak, dist, 7))


@pytest.mark.parametrize("variant", ["bit words", "byte flags"])
@pytest.mark.parametrize("case", range(len(k3_edge_cases())), ids=[c[0] for c in k3_edge_cases()])
def test_k3_suppress_edge_cases(dev, monkeypatch, case, variant):
    """Rows of 1 to 6272 positions, distances from 1 to above max_distance,
    reaches to 32, empty and full masks, equal scores, staircases, peaks at
    the ends and across word boundaries, non-finite scores, rows at and
    beyond the longest whose bit words fit shared memory: the plain
    version's mask from both kernels (the byte-flag one forced at any
    shape)."""
    _, s, flags, dist, W = k3_edge_cases()[case]
    if variant == "byte flags":
        monkeypatch.setattr(peaks, "_suppress_shared_bytes", lambda L, W: 0)
    else:
        assert (peaks._suppress_shared_bytes(s.shape[1], W) > 0) == (W <= 32 and s.shape[1] <= 619808)
    args = (*(torch.as_tensor(a, device=dev) for a in (s, flags, dist)), W)
    got = _launched("wdx_suppress", lambda: peaks.suppress_by_distance(*args))
    assert torch.equal(got, peaks.suppress_by_distance_plain(*args))


def test_k3_allocates_no_scratch_at_the_step_shape(dev):
    s = torch.as_tensor(np.random.default_rng(3).gamma(2.0, 1.0, (64, 6272)).astype(np.float32), device=dev)
    is_peak, _ = peaks.peak_mask_batch(s, torch.full((64,), 6272, device=dev))
    dist = torch.full((64,), 6, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = peaks.suppress_by_distance(s, is_peak, dist, 7)
    assert torch.cuda.max_memory_allocated() - before - out.numel() < 2**16
    del out


@pytest.mark.parametrize("with_mad", [False, True])
def test_k4_range_median_mad(dev, with_mad):
    x = _signal(dev)
    rng = np.random.default_rng(4)
    starts = torch.as_tensor(rng.integers(0, 10000, (3, 64)).astype(np.int32), device=dev)
    ends = starts + torch.as_tensor(rng.integers(-50, 6000, (3, 64)).astype(np.int32), device=dev)
    given_meds = torch.full((3, 64), 80.0, device=dev)
    args = (x, starts, ends, with_mad, given_meds, (False, True, False))
    km, kd = _launched("wdx_range_median_mad", lambda: select.range_median_mad(*args))
    pm, pd = select.range_median_mad_plain(*args)
    assert torch.equal(km.view(torch.int32), pm.view(torch.int32))
    if with_mad:
        assert torch.equal(kd.view(torch.int32), pd.view(torch.int32))


@pytest.mark.parametrize("case", range(len(k4_edge_cases())), ids=[c[0] for c in k4_edge_cases()])
def test_k4_edge_ranges(dev, case):
    """Ranges of 1, 2 and 3 samples, all-equal ranges, signed zeros, heavy
    ties, infinities and NaNs, range starts off the float4 alignment: the
    bits of the plain version, NaNs included."""
    _, x, starts, ends = k4_edge_cases()[case]
    args = tuple(torch.as_tensor(a, device=dev) for a in (x, starts, ends))
    km, kd = _launched("wdx_range_median_mad", lambda: select.range_median_mad(*args))
    pm, pd = select.range_median_mad_plain(*args)
    assert torch.equal(km.view(torch.int32), pm.view(torch.int32))
    assert torch.equal(kd.view(torch.int32), pd.view(torch.int32))


@pytest.mark.parametrize("length", [select._STAGED_MAX_LEN, select._STAGED_MAX_LEN + 1, 60000])
def test_k4_long_rows(dev, length):
    """The longest row whose keys fit shared memory, and one beyond it (the
    streaming variant)."""
    rng = np.random.default_rng(length)
    x = rng.normal(80, 12, (4, length)).astype(np.float32)
    x[:, :3000] = np.round(x[:, :3000])
    starts = np.stack([np.zeros(4), rng.integers(0, length // 2, 4)]).astype(np.int32)
    ends = np.stack([np.full(4, length), starts[1] + rng.integers(1, length // 2, 4)]).astype(np.int32)
    assert (select._staged_bytes(length) > 0) == (length == select._STAGED_MAX_LEN)
    args = tuple(torch.as_tensor(a, device=dev) for a in (x, starts, ends))
    km, kd = _launched("wdx_range_median_mad", lambda: select.range_median_mad(*args))
    pm, pd = select.range_median_mad_plain(*args)
    assert torch.equal(km, pm) and torch.equal(kd, pd)


def test_k5_shift_rows(dev):
    x = _signal(dev)
    starts = torch.as_tensor(np.random.default_rng(5).integers(-10, 9300, 64).astype(np.int32), device=dev)
    got = _launched("wdx_shift_rows", lambda: window_gather.shift_rows(x, starts, 800))
    assert torch.equal(got, window_gather.shift_rows_plain(x, starts, 800))


@pytest.mark.parametrize("K", [1, 2])
def test_k5_shift_rows_step_shapes(dev, K):
    """The refine windows (K a read from the one signal) and the adapter
    extraction with lengths, as the step calls them."""
    x = _signal(dev)
    rng = np.random.default_rng(5 + K)
    starts = torch.as_tensor(rng.integers(0, 9201, 64 * K).astype(np.int32), device=dev)
    got = _launched("wdx_shift_rows", lambda: window_gather.shift_rows(x, starts, 800))
    assert torch.equal(got, window_gather.shift_rows_plain(x, starts, 800))
    assert torch.equal(got, window_gather.shift_rows_plain(x.repeat(K, 1), starts, 800))
    a_start = torch.as_tensor(rng.integers(0, 10000, 64).astype(np.int32), device=dev)
    a_len = torch.as_tensor(rng.integers(0, 6273, 64).astype(np.int32), device=dev)
    got = _launched("wdx_shift_rows", lambda: window_gather.shift_rows(x, a_start, 6272, a_len))
    assert torch.equal(got, window_gather.shift_rows_plain(x, a_start, 6272, a_len))
    padded = torch.cat([x, x.new_zeros((64, 6272))], 1)
    mask = torch.arange(6272, device=dev)[None, :] < a_len[:, None]
    assert torch.equal(got, torch.where(mask, window_gather.shift_rows_plain(padded, a_start, 6272), x.new_zeros(())))


@pytest.mark.parametrize("case", range(len(k5_edge_cases())), ids=[c[0] for c in k5_edge_cases()])
def test_k5_shift_rows_edge_cases(dev, case):
    """Starts that leave the row with and without lengths, lengths of 0,
    out_len and beyond, an out_len and an L off the vector size, K = 2 and
    3 windows a row."""
    _, x, starts, out_len, lengths = k5_edge_cases()[case]
    args = (torch.as_tensor(x, device=dev), torch.as_tensor(starts, device=dev), out_len,
            None if lengths is None else torch.as_tensor(lengths, device=dev))
    got = _launched("wdx_shift_rows", lambda: window_gather.shift_rows(*args))
    assert torch.equal(got.view(torch.int32), window_gather.shift_rows_plain(*args).view(torch.int32))


def test_k5_shift_rows_rows_off_the_vector_alignment(dev):
    flat = torch.as_tensor(np.random.default_rng(6).normal(80, 12, 9 * 2000 + 1).astype(np.float32), device=dev)
    x = flat[1:].view(9, 2000)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    starts = torch.as_tensor(np.arange(9, dtype=np.int32) * 130 - 3, device=dev)
    got = _launched("wdx_shift_rows", lambda: window_gather.shift_rows(x, starts, 800))
    assert torch.equal(got, window_gather.shift_rows_plain(x, starts, 800))


def test_k6_rolling_mean_var(dev):
    x = _signal(dev)
    got = _launched("wdx_rolling_mean_var", lambda: bd.rolling_mean_var(x, 200, 500))
    for g, w in zip(got, bd.rolling_mean_var_plain(x, 200, 500)):
        assert torch.equal(g, w)


@pytest.mark.parametrize(
    "b, length, w_mean, w_var",
    [(33, 9999, 200, 500), (33, 7, 3, 5), (33, 300, 400, 1000), (33, 4100, 200, 500), (8, 30000, 200, 500)],
)
def test_k6_rolling_mean_var_edge_lengths(dev, b, length, w_mean, w_var):
    """Lengths that are no multiple of 16 (nor of 4), shorter than a block,
    windows longer than the row, and a row too long for shared memory (the
    device-scratch variant)."""
    x = torch.as_tensor(np.random.default_rng(length).normal(80, 12, (b, length)).astype(np.float32), device=dev)
    assert (bd._scan_buffers(b, length, dev)[2] is not None) == (length == 30000)
    got = _launched("wdx_rolling_mean_var", lambda: bd.rolling_mean_var(x, w_mean, w_var))
    for g, w in zip(got, bd.rolling_mean_var_plain(x, w_mean, w_var)):
        assert torch.equal(g, w)


def test_k6_allocates_no_scratch_at_the_step_length(dev):
    x = _signal(dev)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = bd.rolling_mean_var(x, 200, 500)
    assert torch.cuda.max_memory_allocated() - before - 3 * x.numel() * 4 < 2**20
    del out


def test_k9_rolling_detect_long_rows(dev):
    """A row too long for shared memory takes K9's device-scratch variant."""
    x = torch.as_tensor(np.random.default_rng(9).normal(100, 3, (8, 30000)).astype(np.float32), device=dev)
    args = (x, torch.ones_like(x), torch.full((8,), 99.0, device=dev),
            torch.full((8,), 29000, dtype=torch.int32, device=dev), 200, 500, 100, 30.0)
    got = _launched("wdx_rolling_detect", lambda: bd.rolling_detect(*args))
    for g, w in zip(got, bd.rolling_detect_plain(*args)):
        assert torch.equal(g, w)
    assert int(got[4].max()) == 100


def test_k7_run_sum(dev):
    mask = torch.as_tensor(np.random.default_rng(7).random((64, 10000)) < 0.4, device=dev)
    got = _launched("wdx_run_sum", lambda: bd.run_sum(mask, 100))
    assert torch.equal(got, bd.run_sum_plain(mask, 100))


@pytest.mark.parametrize("case", range(len(k7_edge_cases())), ids=[c[0] for c in k7_edge_cases()])
def test_k7_run_sum_edge_cases(dev, case):
    """Rows of 1, 7 and 9999 samples (no multiple of 16: byte loads and
    scalar stores), windows longer than the row, constant masks."""
    _, mask, w = k7_edge_cases()[case]
    mask = torch.as_tensor(mask, device=dev)
    assert bd._run_sum_shared_bytes(mask.shape[1]) > 0
    got = _launched("wdx_run_sum", lambda: bd.run_sum(mask, w))
    assert torch.equal(got, bd.run_sum_plain(mask, w))


def test_k7_run_sum_row_starts_off_the_vector_alignment(dev):
    flat = torch.as_tensor(np.random.default_rng(8).random(33 * 9984 + 1) < 0.4, device=dev)
    mask = flat[1:].view(33, 9984)
    assert mask.is_contiguous() and mask.data_ptr() % 16 != 0
    got = _launched("wdx_run_sum", lambda: bd.run_sum(mask, 100))
    assert torch.equal(got, bd.run_sum_plain(mask, 100))


def test_k7_run_sum_long_rows(dev):
    """A row too long for a uint16 count in shared memory takes the direct
    kernel."""
    mask = torch.as_tensor(np.random.default_rng(9).random((4, 70000)) < 0.4, device=dev)
    assert bd._run_sum_shared_bytes(70000) == 0
    got = _launched("wdx_run_sum", lambda: bd.run_sum(mask, 100))
    assert torch.equal(got, bd.run_sum_plain(mask, 100))


@pytest.mark.parametrize("b, length, w_run", [(33, 9999, 100), (5, 7, 3), (33, 300, 500), (9, 1, 1)])
def test_k9_rolling_detect_edge_lengths(dev, b, length, w_run):
    """The shared-memory variant's packed prefix counts at lengths that are
    no multiple of 16 and with a window longer than the row."""
    rng = np.random.default_rng(length)
    t = lambda a: torch.as_tensor(a, device=dev)
    args = (t(rng.normal(100, 3, (b, length)).astype(np.float32)),
            t((rng.random((b, length)) < 0.7).astype(np.float32)), t(np.full(b, 99.5, np.float32)),
            t(rng.integers(length // 2, length + 1, b).astype(np.int32)), 20, 50, w_run, 30.0)
    assert bd._scan_buffers(b, length, dev, extra_shared=length)[2] is None
    got = _launched("wdx_rolling_detect", lambda: bd.rolling_detect(*args))
    for g, w in zip(got, bd.rolling_detect_plain(*args)):
        assert torch.equal(g.isnan(), w.isnan()) and torch.equal(g.nan_to_num(), w.nan_to_num())


def _ranges(dev, R, B=64, L=10000, seed=4):
    rng = np.random.default_rng(seed)
    starts = torch.as_tensor(rng.integers(0, L, (R, B)).astype(np.int32), device=dev)
    return starts, starts + torch.as_tensor(rng.integers(-50, 6000, (R, B)).astype(np.int32), device=dev)


def test_k4_calibrated_mad(dev):
    x, adc, off, sc = _calibrated(dev)
    starts, ends = _ranges(dev, 3)
    args = (x, starts, ends, True, None, (), (adc, off, sc))
    km, kd = _launched("wdx_range_median_mad", lambda: select.range_median_mad(*args))
    pm, pd = select.range_median_mad_plain(*args)
    assert torch.equal(km.view(torch.int32), pm.view(torch.int32))
    assert torch.equal(kd.view(torch.int32), pd.view(torch.int32))


@pytest.mark.parametrize("variant", ["staged", "streaming"])
@pytest.mark.parametrize("case", range(len(k8_edge_cases())), ids=[c[0] for c in k8_edge_cases()])
def test_k8_edge_ranges(dev, monkeypatch, case, variant):
    """Ranges of 1, 2 and 3 samples, empty and inverted ranges, all-equal
    ranges, heavy ties, the keys -32768 and 32767, starts off the 16-byte
    alignment, rows at and beyond the staging limit: the bits of the plain
    version and of K4 from both kernels (the streaming one forced at any
    length)."""
    _, x, adc, starts, ends = k8_edge_cases()[case]
    if variant == "streaming":
        monkeypatch.setattr(select, "_adc_staged_bytes", lambda L: 0)
    else:
        assert (select._adc_staged_bytes(x.shape[1]) > 0) == (x.shape[1] <= 65535)
    x, adc, starts, ends = (torch.as_tensor(a, device=dev) for a in (x, adc, starts, ends))
    got = _launched("wdx_range_median_adc", lambda: select.range_medians_adc(x, adc, starts, ends))
    for want in (select.range_medians_adc_plain(x, adc, starts, ends), select.range_median_mad(x, starts, ends, False)[0]):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("variant", ["staged", "streaming"])
@pytest.mark.parametrize("R", [1, 2])
def test_k8_range_medians_adc(dev, monkeypatch, R, variant):
    if variant == "streaming":
        monkeypatch.setattr(select, "_adc_staged_bytes", lambda L: 0)
    x, adc, _, _ = _calibrated(dev)
    starts, ends = _ranges(dev, R)
    got = _launched("wdx_range_median_adc", lambda: select.range_medians_adc(x, adc, starts, ends))
    plain = select.range_medians_adc_plain(x, adc, starts, ends)
    k4, _ = select.range_median_mad(x, starts, ends, with_mad=False)
    for want in (plain, k4):
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.nan_to_num().view(torch.int32), want.nan_to_num().view(torch.int32))


def test_k9_rolling_detect(dev):
    x, _, _, _ = _calibrated(dev)
    rng = np.random.default_rng(9)
    region = torch.as_tensor((rng.random(x.shape) < 0.5).astype(np.float32), device=dev)
    lens = torch.as_tensor(rng.integers(3000, 10001, 64).astype(np.int32), device=dev)
    thr = torch.as_tensor(rng.uniform(95, 110, 64).astype(np.float32), device=dev)
    args = (x, region, thr, lens, 200, 500, 100, 30.0)
    got = _launched("wdx_rolling_detect", lambda: bd.rolling_detect(*args))
    for g, w in zip(got, bd.rolling_detect_plain(*args)):
        assert torch.equal(g, w)
    for g, w in zip(got[:3], bd.rolling_mean_var(x, 200, 500)):
        assert torch.equal(g, w)
    assert int(got[4].max()) > 0


def test_vbz_decode_gpu(dev):
    from warpdemux_tpu_torch.ops.vbz_device import inner_layout_from_adc, pack_inner_host, vbz_decode_batch

    adc, _, _, _ = synth_minibatch(np.random.default_rng(0), 16, 10000)
    keys, data = pack_inner_host([inner_layout_from_adc(r) for r in adc], 10000, 10 * 1024)
    got = vbz_decode_batch(torch.as_tensor(keys, device=dev), torch.as_tensor(data, device=dev), 10000)
    assert torch.equal(got.to(torch.int16).cpu(), torch.from_numpy(adc))


def test_full_step_gpu_matches_cpu(dev):
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.ops.vbz_device import inner_layout_from_adc, pack_inner_host
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    spc = get_model_spc_config(MODEL)
    adc, off, sc, lens = synth_minibatch(np.random.default_rng(0), 64, 10000)
    keys, data = pack_inner_host([inner_layout_from_adc(r) for r in adc], 10000, 10 * 1024)
    args = (keys, data, off, sc, lens)
    _cuda.reset_launches()
    gpu = make_demux_step(load_model(MODEL, dev), spc, input_format="vbz", device=dev)(*args)
    torch.cuda.synchronize()
    assert _cuda.launches["wdx_range_median_adc"] > 0 and _cuda.launches["wdx_range_median_mad"] > 0
    cpu = make_demux_step(load_model(MODEL, "cpu"), spc, input_format="vbz", device="cpu")(*args)
    g, c = gpu.unpack(), cpu.unpack()
    ok = c.fpt.ok
    for name in g.detect._fields:
        np.testing.assert_array_equal(getattr(g.detect, name), getattr(c.detect, name), err_msg=name)
    np.testing.assert_array_equal(g.fpt.dwell[ok], c.fpt.dwell[ok])
    np.testing.assert_array_equal(g.fpt.fpt[ok], c.fpt.fpt[ok])
    for name in ("fail_code", "success", "pred", "conf", "probs"):
        np.testing.assert_array_equal(getattr(g, name), getattr(c, name), err_msg=name)


def test_fused_decision_step_gpu(dev):
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    spc = get_model_spc_config(MODEL)
    adc, off, sc, lens = synth_minibatch(np.random.default_rng(0), 64, 10000)
    outs = {}
    for fused in (True, False):
        step = make_demux_step(
            load_model(MODEL, dev), spc, input_format="adc", outputs="decision",
            fused_rolling=fused, device=dev,
        )
        _cuda.reset_launches()
        outs[fused] = step(adc, off, sc, lens)
        torch.cuda.synchronize()
        fused_launches = _cuda.launches["wdx_rolling_detect"]
        unfused_launches = _cuda.launches["wdx_rolling_mean_var"] + _cuda.launches["wdx_run_sum"]
        assert (fused_launches > 0, unfused_launches > 0) == (fused, not fused)
    for name in ("success", "fail_code", "pred", "probs"):
        assert torch.equal(getattr(outs[True], name), getattr(outs[False], name)), name


def test_decision_step_gpu_matches_cpu(dev):
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    spc = get_model_spc_config(MODEL)
    adc, off, sc, lens = synth_minibatch(np.random.default_rng(0), 64, 10000)
    kw = dict(input_format="adc", outputs="decision", fused_rolling=False)
    _cuda.reset_launches()
    gpu = make_demux_step(load_model(MODEL, dev), spc, device=dev, **kw)(adc, off, sc, lens)
    torch.cuda.synchronize()
    idle = {"wdx_rolling_detect", "wdx_subseq_dtw"}  # K9 replaces K6 + K7; K10 is the tRNA path's
    assert all(n > 0 for k, n in _cuda.launches.items() if k not in idle), _cuda.launches
    cpu = make_demux_step(load_model(MODEL, "cpu"), spc, device="cpu", **kw)(adc, off, sc, lens)
    for name in ("success", "fail_code", "pred"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name
    torch.testing.assert_close(gpu.probs.cpu(), cpu.probs, rtol=1e-5, atol=1e-6)


def _k10_equal(args):
    k = subsequence.subsequence_dtw(*args)
    p = subsequence.subsequence_dtw_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    assert torch.equal(k[2].isnan(), p[2].isnan())
    assert torch.equal(k[2].nan_to_num().view(torch.int32), p[2].nan_to_num().view(torch.int32))


@pytest.mark.parametrize("variant", ["warp", "block"])
def test_k10_subseq_dtw(dev, monkeypatch, variant):
    """The tRNA path's shape: the consensus (m=84) into 256 series of 121
    events; start, end and dist bit for bit, on both kernels (the block
    kernel forced)."""
    if variant == "block":
        monkeypatch.setattr(subsequence, "_warp_rows", lambda r: 0)
    q, s, lens = k10_step_series(np.random.default_rng(3), 256)
    t = lambda a: torch.as_tensor(a, device=dev)
    _cuda.reset_launches()
    _k10_equal((t(q), t(s), t(lens)))
    assert _cuda.launches["wdx_subseq_dtw"] == 1


@pytest.mark.parametrize("variant", ["by length", "block"])
@pytest.mark.parametrize("case", k10_edge_cases(), ids=lambda c: c[0])
def test_k10_subseq_dtw_edge_cases(dev, monkeypatch, case, variant):
    """Each case on the kernel its query length takes (the warp kernel up to
    256, the block kernel above) and on the block kernel, forced at any
    length."""
    _, q, s, lens, psi = case
    if variant == "block":
        monkeypatch.setattr(subsequence, "_warp_rows", lambda r: 0)
    t = lambda a: torch.as_tensor(a, device=dev)
    _k10_equal((t(q), t(s), t(lens), 1.5, psi))


@pytest.mark.parametrize("path", ["trna_adc_decision", "trna_vbz_full"])
def test_trna_step_gpu_matches_cpu(dev, path):
    """The WDX4_tRNA step on the card: the pinned launch counts (K10 once),
    and the CPU step's decisions and consensus columns."""
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.ops.vbz_device import inner_layout_from_adc, pack_inner_host
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    name = "WDX4_tRNA_rna004_v1_0"
    spc = get_model_spc_config(name)
    adc, off, sc, lens, _, _ = trna_minibatch(np.random.default_rng(0), 64)
    if path == "trna_vbz_full":
        keys, data = pack_inner_host([inner_layout_from_adc(r) for r in adc], 10000, 10 * 1024)
        args, kw = (keys, data, off, sc, lens), dict(input_format="vbz", outputs="full")
    else:
        args, kw = (adc, off, sc, lens), dict(input_format="adc", outputs="decision")
    _cuda.reset_launches()
    gpu = make_demux_step(load_model(name, dev), spc, device=dev, **kw)(*args)
    torch.cuda.synchronize()
    assert tuple(_cuda.launches.values()) == LAUNCHES[path], _cuda.launches
    cpu = make_demux_step(load_model(name, "cpu"), spc, device="cpu", **kw)(*args)
    if path == "trna_vbz_full":
        gpu, cpu = gpu.unpack(), cpu.unpack()
        for field in gpu.consensus._fields:
            np.testing.assert_array_equal(getattr(gpu.consensus, field), getattr(cpu.consensus, field))
        gpu_d = (gpu.success, gpu.fail_code, gpu.pred)
        cpu_d = (cpu.success, cpu.fail_code, cpu.pred)
    else:
        gpu_d = [getattr(gpu, f).cpu().numpy() for f in ("success", "fail_code", "pred")]
        cpu_d = [getattr(cpu, f).numpy() for f in ("success", "fail_code", "pred")]
    for g, c in zip(gpu_d, cpu_d):
        np.testing.assert_array_equal(g, c)


def _lane_session(device, max_batch, tmp_path):
    from warpdemux_tpu_torch.live.balancer import BalancerConfig, BarcodeBalancers
    from warpdemux_tpu_torch.live.session import Session, SessionConfig
    from warpdemux_tpu_torch.models.registry import load_model

    cfg = SessionConfig(model_name=MODEL, save_path=str(tmp_path), run_id=str(device), max_batch=max_batch)
    balancers = BarcodeBalancers.from_configs(4, [BalancerConfig()], [1.0], n_channels=4)
    return Session(None, cfg, balancers, model=load_model(MODEL, device), device=device)


@pytest.mark.parametrize("max_batch", [16, 32])
@pytest.mark.parametrize("bucket", [2048, 12288])
def test_live_lane_gpu_matches_cpu(dev, tmp_path, bucket, max_batch):
    """The live lane program on the card against the CPU lane: one launch
    of each of K5, K4, K2, K3 and K1 a micro-batch, none of K6-K9."""
    gpu, cpu = _lane_session(dev, max_batch, tmp_path), _lane_session("cpu", max_batch, tmp_path)
    reads = live_lane_reads(load_model_arrays(MODEL)["X_sv"], n=32)
    for signals in live_bucket_batches(reads, bucket, max_batch):
        _cuda.reset_launches()
        got = gpu._classify_on_device(signals)
        assert tuple(_cuda.launches.values()) == LAUNCHES["live_lane"], _cuda.launches
        want = cpu._classify_on_device(signals)
        n = len(signals)
        assert (got.ok == want.ok).sum() >= n - 1
        kept = int(want.ok.sum())
        assert (got.pred[:kept] == want.pred[:kept]).sum() >= kept - 1
        if np.array_equal(got.ok, want.ok):
            np.testing.assert_allclose(got.conf[:kept], want.conf[:kept], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("wire", ["vbz", "adc"])
def test_offline_run_loop_gpu_writes_the_cpu_runs_files(dev, tmp_path, wire):
    """pipeline/run.demux_minibatches at B=64 (100 reads: a full and a
    padded minibatch) on the card against the CPU: the same shard files,
    failed_reads equal as text, predictions row for row with confidence
    and probabilities within one unit of their last decimal; each kernel
    of the decision step launched twice, and on the vbz wire (two-stage)
    once more for each minibatch whose stage 2 ran."""
    from test_torch_run_cli import same_failed_reads, same_predictions
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.pipeline.run import demux_minibatches

    adc, off, sc, lens = synth_minibatch(np.random.default_rng(0), 100, 10000)
    batches = [(adc[:64], off[:64], sc[:64], lens[:64]), (adc[64:], off[64:], sc[64:], lens[64:])]
    ids = np.array([f"read{i:03d}" for i in range(100)], object)
    runs = {}
    for where in ("cuda", "cpu"):
        runs[where] = tmp_path / where
        _cuda.reset_launches()
        stats = demux_minibatches(
            offline_config(runs[where], wire, False, 64), load_model(MODEL, dev if where == "cuda" else "cpu"),
            offline_batches(batches, ids, wire), device=dev if where == "cuda" else "cpu",
        )
        assert stats.total == 100
        if where == "cuda":
            torch.cuda.synchronize()
            runs_of_step = 2 + stats.stage2_minibatches
            assert (stats.stage2_minibatches > 0) == (wire == "vbz")
            assert tuple(_cuda.launches.values()) == tuple(runs_of_step * k for k in LAUNCHES["adc_decision"])
    same_failed_reads(runs["cuda"], runs["cpu"])
    same_predictions(runs["cuda"], runs["cpu"])


def _k11_bits_equal(got, want):
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(a.nan_to_num().view(torch.int32), b.nan_to_num().view(torch.int32))


def _k11_equal(x, calibration, st, en, with_std):
    """The wrapper's choice and both variants, each bit-equal to the plain
    version."""
    p = rowstats.range_mean_std_plain(x, st, en, with_std, calibration)
    _k11_bits_equal(_launched("wdx_rowstats", lambda: rowstats.range_mean_std(x, st, en, with_std, calibration)), p)
    for variant in rowstats.VARIANTS:
        _k11_bits_equal(rowstats.range_mean_std(x, st, en, with_std, calibration, variant=variant), p)


@pytest.mark.parametrize("with_std", [True, False])
@pytest.mark.parametrize("calibrated", [True, False])
def test_k11_rowstats_at_the_step_shape(dev, calibrated, with_std):
    """The three region ranges of 1000 reads of 10,000 samples, bit for bit."""
    x, adc, off, sc = _calibrated(dev, B=1000)
    st, en = (torch.as_tensor(a, device=dev) for a in k11_step_ranges(np.random.default_rng(4), 1000, 10000))
    _k11_equal(x, (adc, off, sc) if calibrated else None, st, en, with_std)


@pytest.mark.parametrize("with_std", [True, False])
@pytest.mark.parametrize("case", k11_edge_cases(), ids=lambda c: c[0])
def test_k11_rowstats_edge_cases(dev, case, with_std):
    _, x, calibration, st, en = case
    t = lambda a: torch.as_tensor(a, device=dev)
    _k11_equal(t(x), None if calibration is None else tuple(map(t, calibration)), t(st), t(en), with_std)


def test_k11_variants_agree_at_the_gate_shape(dev):
    """The [mvs_polya] gate's poly(A) mean (R = 1, calibrated, no stds) of
    1000 reads of 10,000 samples: the block kernel, the wrapper's choice
    there, and the warp kernel give the same bits."""
    x, adc, off, sc = _calibrated(dev, B=1000)
    st, en = (torch.as_tensor(a[1:2], device=dev) for a in k11_step_ranges(np.random.default_rng(6), 1000, 10000))
    assert rowstats._variant(10000, 1, True, None)[0] == "block"
    block = rowstats.range_mean_std(x, st, en, False, (adc, off, sc), variant="block")
    warp = rowstats.range_mean_std(x, st, en, False, (adc, off, sc), variant="warp")
    assert block[1] is None and warp[1] is None
    assert torch.equal(block[0].view(torch.int32), warp[0].view(torch.int32))


def test_k11_rows_outside_its_domain_raise(dev):
    L = 1_000_000  # the window sums of four warps exceed shared memory
    x = torch.zeros((1, L), device=dev)
    st = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="K11"):
        rowstats.range_mean_std(x, st, st + 5)


@pytest.mark.parametrize("kind", ["dtw_mlp", "fpt_boost"])
def test_model_family_gpu_matches_cpu(dev, kind):
    """DTW-MLP (851 references, hidden 100) and Fpt-Boost (1,000 trees of
    depth 6) at 1000 fingerprints: pred on all but one row, probs within
    rtol 1e-5, atol 1e-6."""
    from warpdemux_tpu_torch.models.registry import model_from_arrays

    X_ref = load_model_arrays(MODEL)["X_sv"].astype(np.float32)
    arrays = family_arrays(kind, np.random.default_rng(4), X_ref)
    rng = np.random.default_rng(5)
    fpts = (X_ref[rng.integers(0, len(X_ref), 1000)] + rng.normal(0, 0.3, (1000, 25))).astype(np.float32)
    _cuda.reset_launches()
    gpu = model_from_arrays(arrays, dev).predict(fpts)
    assert _cuda.launches["wdx_dtw"] == (1 if kind == "dtw_mlp" else 0)
    cpu = model_from_arrays(arrays, "cpu").predict(fpts)
    assert (gpu[0] == cpu[0]).sum() >= 999
    np.testing.assert_allclose(gpu[2], cpu[2], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", RNA002_MODELS)
def test_rna002_step_gpu_matches_cpu(dev, name):
    """The RNA002 step (LLR detect, 15,000-sample preload) on 64 reads:
    decisions on all but one row, K11 launched."""
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    spc = get_model_spc_config(name)
    rows = rna002_minibatch(np.random.default_rng(0), 64)
    _cuda.reset_launches()
    gpu = make_demux_step(load_model(name, dev), spc, input_format="adc", outputs="full", device=dev)(*rows)
    torch.cuda.synchronize()
    assert _cuda.launches["wdx_rowstats"] > 0 and _cuda.launches["wdx_dtw"] == 1
    cpu = make_demux_step(load_model(name, "cpu"), spc, input_format="adc", outputs="full", device="cpu")(*rows)
    same = (gpu.success.cpu() == cpu.success) & (gpu.pred.cpu() == cpu.pred)
    assert int(same.sum()) >= 63


def test_workers_on_the_cards_write_the_one_process_rows(dev, tmp_path):
    """chip_smoke's phase 10 at B=64 (3 minibatches, 160 reads): one worker
    process a card (two on cuda:0 on a machine of one card) against one
    process on cuda:0: the merged rows equal as text, each process's
    GLOBAL line the totals, each process's launches its minibatches x the
    adc decision step's pin."""
    from warpdemux_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh() if torch.cuda.device_count() > 1 else [dev, dev]
    one = worker_runs([dev], tmp_path / "one", 3, 64, 32)
    many = worker_runs(mesh, tmp_path / "many", 3, 64, 32)
    assert sum(r[0] for r in many) == 160
    check_worker_runs(f"{len(mesh)} processes", tmp_path / "many", many, tmp_path / "one", one, 3)


def test_run_loop_on_a_card_that_is_not_current(dev, tmp_path):
    """The run loop on cuda:1 while cuda:0 is the current card (its copy
    stream, events and fetches made on cuda:1) writes the rows of the loop
    on cuda:0, as text."""
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.pipeline.run import demux_minibatches

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    adc, off, sc, lens = synth_minibatch(np.random.default_rng(0), 100, 10000)
    batches = [(adc[:64], off[:64], sc[:64], lens[:64]), (adc[64:], off[64:], sc[64:], lens[64:])]
    ids = np.array([f"read{i:03d}" for i in range(100)], object)
    for name, d in (("current", dev), ("other", torch.device("cuda", 1))):
        with torch.cuda.device(0):
            stats = demux_minibatches(
                offline_config(tmp_path / name, "vbz", False, 64), load_model(MODEL, d),
                offline_batches(batches, ids, "vbz"), device=d,
            )
        assert stats.total == 100
    assert shard_texts(tmp_path / "other") == shard_texts(tmp_path / "current")


def test_cnn_trainer_on_the_card_is_deterministic_and_near_the_cpu(dev):
    """Five steps of 8 reads (ARCH, cap 7168) twice on the card: equal
    weights and losses bit for bit (cuDNN's deterministic algorithms);
    against the CPU within chip_smoke's tolerances; the cuDNN and TF32
    switches restored; no csrc/ kernel launched."""
    from chip_smoke import CNN_LOSS_RTOL, CNN_WEIGHT_ATOL
    from warpdemux_tpu_torch.detect import cnn
    from warpdemux_tpu_torch.tools import train_cnn

    def run(device):
        rng = np.random.default_rng(0)
        params = cnn.init_params(rng, cnn.ARCH, device)
        return params, train_cnn.train(params, rng, 5, 8, log=lambda line: None)

    switches = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32)
    _cuda.reset_launches()
    a, ha = run(dev)
    assert not any(_cuda.launches.values())
    assert (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32) == switches
    b, hb = run(dev)
    c, hc = run("cpu")
    np.testing.assert_array_equal(ha.losses, hb.losses)
    np.testing.assert_allclose(ha.losses, hc.losses, rtol=CNN_LOSS_RTOL)
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert float((a[k].cpu() - c[k]).abs().max()) <= CNN_WEIGHT_ATOL, k


def test_trna_trainer_device_half_equals_the_cpu(dev):
    """WDX4b's prep at 10 reads a barcode and 10 noise reads (50 rows, one
    step): fingerprints and classes equal to the CPU's; their Gram matrix
    by K1 bit for bit the CPU's plain version."""
    from warpdemux_tpu_torch.tools import train_trna_model as tt

    name = "WDX4b_tRNA_rna004_v1_0"
    pats, barcodes = tt.patterns(name), tt.MODEL_BARCODES[name]
    got = tt.make_fingerprints(np.random.default_rng(11), 10, 10, tt.prep_step(name, dev), pats, barcodes)
    want = tt.make_fingerprints(np.random.default_rng(11), 10, 10, tt.prep_step(name, "cpu"), pats, barcodes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    _cuda.reset_launches()
    np.testing.assert_array_equal(tt.gram_distances(got[0], dev), tt.gram_distances(want[0], torch.device("cpu")))
    assert _cuda.launches["wdx_dtw"] == 1


@pytest.mark.parametrize("name, b", K12_SHAPES)
def test_svm_kernels_equal_their_plain_versions(dev, name, b):
    """K12 (decision values in XLA's order) bit for bit `xla_dot` plus the
    intercepts, and K13 (Platt sigmoid, Wu-Lin coupling) bit for bit its
    plain version on K12's output and on rows of NaN, inf and 0."""
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.ops import numerics, svm

    m = load_model(name, dev)
    n = m.coef.shape[0]
    K = torch.as_tensor(np.exp(-np.random.default_rng(b).uniform(0, 8, (b, n))).astype(np.float32), device=dev)
    _cuda.reset_launches()
    dec = svm.decision_values(K, m.params)
    assert _cuda.launches["wdx_svm_dot"] == 1
    assert torch.equal(dec, numerics.xla_dot(K, m.coef) + m.intercept)
    dec[: min(b, 3)] = torch.tensor([float("nan"), float("inf"), 0.0], device=dev)[: min(b, 3), None]
    got, want = svm.probabilities(dec, m.params), svm.probabilities_plain(dec, m.params)
    assert _cuda.launches["wdx_svm_probs"] == 1
    assert torch.equal(got.isnan(), want.isnan()) and torch.equal(got.nan_to_num(), want.nan_to_num())
