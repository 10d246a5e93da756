"""Port parity: exact ranged median / MAD (kernel K4's plain version)
against numpy and the JAX package's Pallas kernel in interpret mode:
bit-exact, including empty ranges, ties, signed zeros and `given`."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from warpdemux_tpu.ops.select import range_median_mad as jax_range_median_mad
from warpdemux_tpu.ops.select_pallas import range_median_mad_pallas
from warpdemux_tpu_torch import _cuda
from warpdemux_tpu_torch.ops import select
from warpdemux_tpu_torch.ops.normalize import clip_outliers_prefix
from warpdemux_tpu_torch.ops.select import range_median_mad

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import k4_edge_cases, k8_edge_cases  # noqa: E402

# the ranges kernel K4 is held to on the GPU, without the NaN samples
EDGE_RANGES = k4_edge_cases(with_nan=False)
# the ranges kernel K8 is held to on the GPU
ADC_EDGE_RANGES = k8_edge_cases()


def _np_median(v):
    return np.float32(np.median(v)) if v.size else np.float32(np.nan)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _ranges(rng, R, B, L):
    starts = rng.integers(0, L, (R, B)).astype(np.int32)
    ends = np.minimum(starts + rng.integers(0, L, (R, B)), L).astype(np.int32)
    ends[0, :3] = starts[0, :3]  # empty ranges
    ends[-1, 3:5] = starts[-1, 3:5] - 1  # end before start: empty too
    return starts, ends


@pytest.mark.parametrize("with_mad", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_range_median_mad_exact(with_mad, seed):
    rng = np.random.default_rng(seed)
    B, L, R = 10, 700, 3
    x = rng.normal(70, 15, (B, L)).astype(np.float32)
    x[:, :100] = np.round(x[:, :100])  # heavy ties
    x[0, :50] = -0.0
    x[1, :50] = 0.0
    starts, ends = _ranges(rng, R, B, L)

    meds, mads = range_median_mad(
        torch.from_numpy(x), torch.from_numpy(starts), torch.from_numpy(ends),
        with_mad=with_mad,
    )
    pm, pd = range_median_mad_pallas(x, starts, ends, with_mad, interpret=True)
    np.testing.assert_array_equal(_bits(meds), _bits(pm))
    for r in range(R):
        for b in range(B):
            vals = x[b, starts[r, b] : max(ends[r, b], starts[r, b])]
            np.testing.assert_array_equal(meds[r, b].item(), _np_median(vals))
            if with_mad:
                mad = _np_median(np.abs(vals - meds[r, b].numpy()))
                np.testing.assert_array_equal(mads[r, b].item(), mad)
    if with_mad:
        np.testing.assert_array_equal(_bits(mads), _bits(pd))
    else:
        assert mads is None


def test_given_medians_pass_through_and_only_mad_is_searched():
    rng = np.random.default_rng(4)
    B, L, R = 8, 400, 3
    x = rng.normal(80, 10, (B, L)).astype(np.float32)
    starts, ends = _ranges(rng, R, B, L)
    given_meds = rng.normal(80, 1, (R, B)).astype(np.float32)
    given = (True, False, True)
    meds, mads = range_median_mad(
        torch.from_numpy(x), torch.from_numpy(starts), torch.from_numpy(ends),
        given_meds=torch.from_numpy(given_meds), given=given,
    )
    pm, pd = range_median_mad_pallas(
        x, starts, ends, True, interpret=True, given_meds=given_meds, given=given
    )
    np.testing.assert_array_equal(_bits(meds), _bits(pm))
    np.testing.assert_array_equal(_bits(mads), _bits(pd))
    np.testing.assert_array_equal(meds.numpy()[[0, 2]], given_meds[[0, 2]])


def test_clip_outliers_prefix_matches_jax():
    from warpdemux_tpu.ops.normalize import clip_outliers_prefix as jax_clip

    rng = np.random.default_rng(9)
    B, L = 6, 1300
    x = rng.normal(75, 12, (B, L)).astype(np.float32)
    x[:, ::97] = 400.0  # outliers
    n = np.array([L, 1000, 640, 17, 1, 0], np.int32)
    got = clip_outliers_prefix(torch.from_numpy(x), torch.from_numpy(n), 5.0)
    want = np.asarray(jax_clip(x, n, 5.0))
    np.testing.assert_array_equal(got.numpy(), want)


def _adc_inputs(seed):
    """tests/test_select.py:130's inputs: calibrated int16 rows with heavy
    ties, even counts, and an empty third range."""
    rng = np.random.default_rng(seed)
    B, L = 16, 500
    adc = rng.integers(-32768, 32767, (B, L)).astype(np.int16)
    adc[:, :200] = rng.integers(-5, 5, (B, 200))  # heavy ties
    off = rng.uniform(-260, -200, B).astype(np.float32)
    s = rng.uniform(0.1, 0.3, B).astype(np.float32)
    x = (adc.astype(np.float32) + off[:, None]) * s[:, None]
    starts = np.stack(
        [np.zeros(B), rng.integers(0, L // 2, B), np.full(B, 10)]
    ).astype(np.int32)
    ends = np.stack(
        [np.full(B, L), rng.integers(L // 2, L, B), np.full(B, 10)]
    ).astype(np.int32)
    return x, adc, off, s, starts, ends


@pytest.mark.parametrize("seed", [7, 8])
def test_range_medians_adc_matches_jax_and_the_float_path(seed):
    """K8's plain version: bit-identical to the JAX package's ADC-domain
    kernel in interpret mode and to the port's float-key path (K4 with the
    MAD off), NaN pattern included."""
    from warpdemux_tpu.ops.select_pallas import range_median_pallas_adc
    from warpdemux_tpu_torch.ops.select import range_medians_adc

    x, adc, _, _, starts, ends = _adc_inputs(seed)
    got = range_medians_adc(
        torch.from_numpy(x), torch.from_numpy(adc), torch.from_numpy(starts),
        torch.from_numpy(ends),
    ).numpy()
    want = np.asarray(range_median_pallas_adc(x, adc, starts, ends, interpret=True))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    flt, _ = range_median_mad(
        torch.from_numpy(x), torch.from_numpy(starts), torch.from_numpy(ends),
        with_mad=False,
    )
    np.testing.assert_array_equal(_bits(got), _bits(flt))
    assert np.isnan(got[2]).all() and not np.isnan(got[:2]).any()


def test_mad_with_calibration_matches_the_fused_jax_program():
    """With the calibration preimage, the MAD rounds |x - median| as one
    fused multiply-add, as the JAX package's jitted program does when it
    computes x = (adc + offset) * scale in the same program."""
    import jax

    from warpdemux_tpu.ops.select import range_median_mad as jax_rmm

    x, adc, off, s, starts, ends = _adc_inputs(9)

    @jax.jit
    def fused(adc, off, s):
        xc = (adc.astype(np.float32) + off[:, None]) * s[:, None]
        return jax_rmm(xc, starts, ends, with_mad=True, pallas_ok=False)

    w_meds, w_mads = fused(adc, off, s)
    meds, mads = range_median_mad(
        torch.from_numpy(x), torch.from_numpy(starts), torch.from_numpy(ends),
        calibration=(torch.from_numpy(adc), torch.from_numpy(off), torch.from_numpy(s)),
    )
    np.testing.assert_array_equal(_bits(meds), _bits(w_meds))
    np.testing.assert_array_equal(_bits(mads), _bits(w_mads))
    # without it, the MAD is the rounded difference of the stored signal
    _, plain = range_median_mad(
        torch.from_numpy(x), torch.from_numpy(starts), torch.from_numpy(ends)
    )
    _, w_plain = jax_rmm(x, starts, ends, with_mad=True, pallas_ok=False)
    np.testing.assert_array_equal(_bits(plain), _bits(w_plain))


@pytest.mark.parametrize("with_mad", [True, False], ids=["median+MAD", "median"])
@pytest.mark.parametrize("case", range(len(EDGE_RANGES)), ids=[c[0] for c in EDGE_RANGES])
def test_range_median_mad_plain_matches_jax_at_edge_ranges(case, with_mad):
    """K4's plain version (the kernel's yardstick) on ranges of 1, 2 and 3
    samples, all-equal ranges, signed zeros, heavy ties, infinities and
    range starts off the vector alignment: the bits of the JAX package's
    jnp path and of its Pallas kernel in interpret mode, NaNs (the MAD of an
    infinite median) included."""
    _, x, starts, ends = EDGE_RANGES[case]
    t = torch.from_numpy
    meds, mads = select.range_median_mad_plain(t(x), t(starts), t(ends), with_mad)
    for want_meds, want_mads in (
        jax_range_median_mad(x, starts, ends, with_mad, pallas_ok=False),
        range_median_mad_pallas(x, starts, ends, with_mad, interpret=True),
    ):
        np.testing.assert_array_equal(_bits(meds), _bits(want_meds))
        if with_mad:
            np.testing.assert_array_equal(_bits(mads), _bits(want_mads))
    for r in range(starts.shape[0]):
        for b in range(x.shape[0]):
            vals = x[b, starts[r, b] : ends[r, b]]
            np.testing.assert_array_equal(meds[r, b].item(), _np_median(vals))
    assert mads is None or not with_mad or mads.shape == meds.shape


_SWITCH = select._STAGED_MAX_LEN  # the longest row K4 stages


@pytest.mark.parametrize("L", [0, 1, 6271, 6272, 10000, _SWITCH, _SWITCH + 1, 70001])
def test_staged_keys_follow_the_shared_memory_limit(L):
    """K4's launch geometry: a whole row's keys (4 bytes a sample in whole
    16-byte vectors, whatever the range lengths) go into dynamic shared
    memory while they fit a block's 232,448 bytes beside the room kept for
    the kernel's static histograms; longer rows (and empty ones) get 0
    bytes, the streaming variant."""
    shared_bytes = select._staged_bytes(L)
    if 0 < L <= _SWITCH:
        assert shared_bytes == 16 * -(-L // 4) >= 4 * L
        assert shared_bytes + select._SELECT_STATIC_BYTES <= _cuda.MAX_SHARED_BYTES
    else:
        assert shared_bytes == 0
    # the switch is where the room ends: the next whole vector no longer
    # fits, and the room covers the kernel's histograms at either digit width
    assert 16 * (_SWITCH // 4 + 1) + select._SELECT_STATIC_BYTES > _cuda.MAX_SHARED_BYTES
    assert _SWITCH % 4 == 0 and _SWITCH < 65536  # the histograms' 16-bit bins hold a row
    assert 12928 <= select._SELECT_STATIC_BYTES


@pytest.mark.parametrize("case", range(len(ADC_EDGE_RANGES)), ids=[c[0] for c in ADC_EDGE_RANGES])
def test_range_medians_adc_plain_matches_jax_at_edge_ranges(case):
    """K8's plain version (the kernel's yardstick) on ranges of 1, 2 and 3
    samples, empty and inverted ranges, all-equal ranges, heavy ties with an
    even count (middle keys equal, and not), the keys -32768 and 32767,
    range starts off the 16-byte alignment and rows at and beyond the
    longest the kernel stages: the bits of the JAX package's ADC-domain
    kernel in interpret mode, of its jnp path (the float engine, which the
    step runs on the CPU) and of numpy, NaNs (empty ranges) included."""
    from warpdemux_tpu.ops.select import range_medians_adc as jax_range_medians_adc
    from warpdemux_tpu.ops.select_pallas import range_median_pallas_adc

    _, x, adc, starts, ends = ADC_EDGE_RANGES[case]
    t = torch.from_numpy
    got = select.range_medians_adc_plain(t(x), t(adc), t(starts), t(ends)).numpy()
    want = range_median_pallas_adc(x, adc, starts, ends, interpret=True)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    want, _ = jax_range_medians_adc(x, adc, starts, ends)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    for r in range(starts.shape[0]):
        for b in range(x.shape[0]):
            vals = x[b, max(starts[r, b], 0) : max(ends[r, b], 0)]
            np.testing.assert_array_equal(got[r, b], _np_median(vals))


@pytest.mark.parametrize("L", [0, 1, 8, 9, 10000, 65528, 65535, 65536, 200000])
def test_adc_staged_keys_follow_the_histograms_limit(L):
    """K8's launch geometry: a whole row's 2-byte keys in whole 16-byte
    vectors go into dynamic shared memory up to 65,535 samples, the most the
    histograms' 16-bit halves (and the key-and-position words) count; longer
    rows (and empty ones) get 0 bytes, the streaming variant. Shared memory
    itself would hold more."""
    shared_bytes = select._adc_staged_bytes(L)
    if 0 < L <= 65535:
        assert shared_bytes == 16 * -(-L // 8) >= 2 * L
        assert shared_bytes + select._SELECT_STATIC_BYTES <= _cuda.MAX_SHARED_BYTES
    else:
        assert shared_bytes == 0
    assert select._ADC_STAGED_MAX_LEN == 65535
    assert 16 * -(-200000 // 8) + select._SELECT_STATIC_BYTES > _cuda.MAX_SHARED_BYTES
