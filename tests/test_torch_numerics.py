"""Port parity: the device-independent float32 roundings of
ops/numerics.py against XLA:CPU, bit for bit.

`xla_log` must give the bits of the jitted jnp.log (XLA's own polynomial,
not the correctly rounded log); `xla_rsqrt` is pinned to the bits XLA:CPU
gives on the host whose rsqrt estimate the port carries as a table (the
comparison with this host's jitted rsqrt is in test_torch_xla_rsqrt.py,
which skips on a host with another estimate; the pins never skip); and the LLR refinement's cost must equal
the jitted JAX expression on the window where the two ends of the scan
tie to the last bit: row 795 of the seed-0 bench batch.
"""

import sys
from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpdemux_tpu_torch.detect import boundaries as bd
from warpdemux_tpu_torch.ops import _rsqrt_table
from warpdemux_tpu_torch.ops.numerics import rsqrt_table, xla_log, xla_rsqrt

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import synth_minibatch  # noqa: E402

EDGES = [
    0.0, -0.0, 1e-45, -1e-45, 1e-40, 1.1754944e-38, -1.0, np.inf, -np.inf,
    np.nan, 1.0, 0.5, 2.0, 0.70710677, 0.7071068, 1e-6, 1e6, 3.4e38,
]


def _same_bits(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) & np.isnan(b))


def test_xla_log_matches_jitted_jnp_log():
    rng = np.random.default_rng(0)
    x = np.exp(rng.uniform(np.log(1e-6), np.log(1e6), 1_000_000)).astype(np.float32)
    x = np.concatenate([x, np.asarray(EDGES, np.float32)])
    want = np.asarray(jax.jit(jnp.log)(x))
    got = xla_log(torch.from_numpy(x)).numpy()
    bad = ~_same_bits(got, want)
    assert not bad.any(), (x[bad][:5], got[bad][:5], want[bad][:5])
    # torch.log rounds differently on a share of these inputs
    assert (~_same_bits(torch.log(torch.from_numpy(x)).numpy(), want)).sum() > 1000


def test_xla_log_matches_jitted_jnp_log_across_the_float32_range():
    """Random bit patterns over every binade of the positive float32,
    subnormals included, and every mantissa of [1, 2): the plain version
    (xla_log on CPU tensors) against the jitted jnp.log."""
    rng = np.random.default_rng(3)
    bits = np.concatenate([rng.integers(1, 0x7F800000, 2_000_000), 0x3F800000 + np.arange(1 << 23)])
    x = bits.astype(np.uint32).view(np.float32)
    want = np.asarray(jax.jit(jnp.log)(x))
    got = xla_log(torch.from_numpy(x)).numpy()
    bad = ~_same_bits(got, want)
    assert not bad.any(), (x[bad][:5], got[bad][:5], want[bad][:5])


@pytest.mark.parametrize("binades", [(1, 126, 127), (128, 200, 254)])
def test_xla_log_has_no_input_where_its_multiply_adds_round_twice(binades):
    """tools/xla_log_ties: in these binades (all of them when run alone) no
    positive float32 gives another log with each multiply-add rounded
    twice (a float64 sum rounded to float32) than rounded once, which is
    why no tie input is pinned here."""
    from warpdemux_tpu_torch.tools import xla_log_ties

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        assert xla_log_ties.search(binades, log=lambda line: None) == []
    finally:
        torch.set_num_threads(threads)


def _row_795():
    adc, off, sc, _ = synth_minibatch(np.random.default_rng(0), 1000, 10000)
    return (adc[795].astype(np.float32) + off[795]) * sc[795]


@jax.jit
def _jax_cost(win):
    """The cost expression of warpdemux_tpu/detect/boundaries.py
    _llr_refine, jitted as in the step."""
    B, W = win.shape
    z = jnp.zeros((B, 1), win.dtype)
    c1 = jnp.concatenate([z, jnp.cumsum(win, axis=1)], axis=1)
    c2 = jnp.concatenate([z, jnp.cumsum(win * win, axis=1)], axis=1)
    n1 = jnp.arange(1, W, dtype=win.dtype)[None, :]
    n2 = W - n1
    s1, s2 = c1[:, 1:W], c2[:, 1:W]
    v1 = jnp.maximum(s2 / n1 - (s1 / n1) ** 2, 1e-6)
    sT1 = c1[:, W : W + 1] - s1
    sT2 = c2[:, W : W + 1] - s2
    v2 = jnp.maximum(sT2 / n2 - (sT1 / n2) ** 2, 1e-6)
    return n1 * jnp.log(v1) + n2 * jnp.log(v2)


def test_llr_cost_on_the_tied_window_matches_jax():
    """Coarse start 4054 gives the window [3654, 4454). Its first and last
    splits tie within one ulp; JAX's argmin is the last split."""
    win = _row_795()[None, 3654:4454]
    got = bd._llr_cost(torch.from_numpy(win)).numpy()
    want = np.asarray(_jax_cost(win))
    assert _same_bits(got, want).all()
    assert int(np.argmin(want[0])) == 798
    # the argmin of the whole refinement: polya_start 4453, as JAX finds
    x = torch.from_numpy(_row_795()[None])
    refined = bd._llr_refine(x, torch.tensor([[4054]], dtype=torch.int32), 400)
    assert int(refined[0, 0]) == 4453


@pytest.mark.parametrize("seed", [0, 1])
def test_llr_cost_matches_jax_on_random_windows(seed):
    rng = np.random.default_rng(seed)
    win = rng.normal(90, 6, (8, 800)).astype(np.float32)
    win[:4, 400:] += 15  # a level step in half of the rows
    got = bd._llr_cost(torch.from_numpy(win)).numpy()
    assert _same_bits(got, np.asarray(_jax_cost(win))).all()


# (bits of x, bits of XLA:CPU's rsqrt(x)) recorded with the table's host:
# 1, 2, 3, 4, 0.1 (one ulp under the correctly rounded 0x404a62c2), 80,
# 1234.5678, 6e-8, the smallest normal, the largest finite, a subnormal,
# +0, -0, +inf, -1, NaN
RSQRT_PINS = [
    (0x3F800000, 0x3F800000), (0x40000000, 0x3F3504F3), (0x40400000, 0x3F13CD3A),
    (0x40800000, 0x3F000000), (0x3DCCCCCD, 0x404A62C1), (0x42A00000, 0x3DE4F92E),
    (0x449A522B, 0x3CE925FF), (0x3380D959, 0x457F27BB), (0x00800000, 0x5F000000),
    (0x7F7FFFFF, 0x1F800000), (0x000116C2, 0x7F800000), (0x00000000, 0x7F800000),
    (0x80000000, 0xFF800000), (0x7F800000, 0x00000000), (0xBF800000, 0x7FC00000),
    (0x7FC00000, 0x7FC00000),
]


@pytest.mark.parametrize("x_bits, want_bits", RSQRT_PINS, ids=[f"{x:08x}" for x, _ in RSQRT_PINS])
def test_xla_rsqrt_pinned_bits(x_bits, want_bits):
    x = torch.tensor([x_bits], dtype=torch.int64).to(torch.int32).view(torch.float32)
    got = xla_rsqrt(x)
    if want_bits == 0x7FC00000:
        assert bool(got.isnan().all())
    else:
        assert int(got.view(torch.int32)) & 0xFFFFFFFF == want_bits


def test_rsqrt_table_is_the_recorded_one():
    import hashlib

    table = rsqrt_table("cpu")
    assert table.dtype == torch.int16 and table.shape == (2048,)
    assert hashlib.sha256(table.numpy().astype("<u2").tobytes()).hexdigest() == _rsqrt_table.SHA256
    assert _rsqrt_table.SHA256 == "3e6b1f1505c0535421fcc996e154d1f2504933071d3a5d3181e84db0e336c36c"
    assert _rsqrt_table.SHA256 in _rsqrt_table.__doc__
    # estimates of [1, 4) lie in [0.5, 1) with 12 mantissa bits, falling
    # within each parity
    t = table.view(2, 1024).int()
    assert int(t.min()) >= 1 and int(t.max()) <= 4094
    assert bool((t[:, 1:] <= t[:, :-1]).all()) and int(t[0, -1]) > int(t[1, 0])
    assert rsqrt_table("cpu") is table  # made once a device


def test_xla_rsqrt_is_within_two_ulp_of_the_rounded_rsqrt_and_not_it():
    x = torch.from_numpy(np.exp(np.random.default_rng(1).uniform(-60, 60, 200_000)).astype(np.float32))
    got = xla_rsqrt(x)
    exact = (1.0 / torch.sqrt(x.double())).to(torch.float32)
    ulps = (got.view(torch.int32) - exact.view(torch.int32)).abs()
    assert int(ulps.max()) <= 2
    assert 0.02 < float((ulps > 0).float().mean()) < 0.5


@pytest.mark.parametrize("width", [1, 2, 31, 32, 33, 111, 1000, 6272, 10000, 12288])
def test_xla_sum_matches_jitted_jnp_sum(width):
    """A float32 row sum in XLA:CPU's tree of 32-wide sequential windows,
    with zeros, signed zeros and values of mixed magnitude."""
    from warpdemux_tpu_torch.ops.numerics import xla_sum

    rng = np.random.default_rng(width)
    x = (rng.normal(80, 12, (7, width)) * rng.choice([1, 1e-3, 1e3], (7, width))).astype(np.float32)
    x[1] = 0.0
    x[2] = -0.0
    x[3, ::3] = -x[3, ::3]
    want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=1))(x))
    got = xla_sum(torch.from_numpy(x)).numpy()
    assert _same_bits(got, want).all()


@pytest.mark.parametrize("width", [33, 111, 121, 200])
def test_mean_std_matches_jitted_masked_mean_std_over_all_lanes(width):
    """The fingerprint's event mean and std (111 events, 121 for tRNA):
    under an all-true mask XLA folds the count and multiplies by its
    reciprocal."""
    from warpdemux_tpu.ops.normalize import masked_mean_std
    from warpdemux_tpu_torch.ops.normalize import mean_std

    x = np.random.default_rng(width).normal(78, 8, (64, width)).astype(np.float32)
    want = jax.jit(lambda a: masked_mean_std(a, jnp.ones(a.shape, bool)))(x)
    got = mean_std(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert _same_bits(g.numpy(), np.asarray(w)).all()


def _rounded_once(x):
    """The float32 nearest to the rational x, ties to even."""
    f = np.float32(float(x))
    near = [f, np.nextafter(f, np.float32(np.inf)), np.nextafter(f, np.float32(-np.inf))]
    return min(near, key=lambda v: (abs(Fraction(float(v)) - x), int(np.float32(v).view(np.int32)) & 1))


def _tie_triples(n):
    """n float32 triples (a, b, c) whose float64 sum a*b + c lands exactly
    on a float32 half-way point while the exact sum does not, on the side
    where rounding that sum again to float32 goes wrong."""
    rng = np.random.default_rng(7)
    out = []
    while len(out) < n:
        a, b = rng.uniform(1, 2, 2).astype(np.float32) * np.float32(2.0 ** rng.integers(-20, 20))
        p = Fraction(float(a)) * Fraction(float(b))
        e = int(np.floor(np.log2(float(p))))
        unit = Fraction(2) ** (e - 24)
        m = round(p / unit)
        if m % 2 == 0 or abs(p - m * unit) >= Fraction(2) ** (e - 31):
            continue
        even_up = (m // 2) % 2 == 1  # ties to even goes up from the half-way point
        c = m * unit - p + (-1 if even_up else 1) * Fraction(2) ** (e - 54)
        cf = np.float32(float(c))
        if Fraction(float(cf)) == c:
            out.append((a, b, cf))
    return [np.array(v, np.float32) for v in zip(*out)]


def _subnormal_tie_triples():
    """Triples whose sum is a float32 subnormal tie: c = k 2**-149 for odd
    k, a*b = 2**-150 (1 - 2**-46), so the float64 sum is c + 2**-150."""
    a = np.float32(2.0**-75 * (1 + 2.0**-23))
    b = np.float32(2.0**-75 * (1 - 2.0**-23))
    ks = np.array([2**20 + 1, 2**22 + 3, 2**23 - 1, 129], np.int64)
    c = (ks.astype(np.float64) * 2.0**-149).astype(np.float32)
    c = np.concatenate([c, -c]).astype(np.float32)
    a = np.concatenate([np.full(4, a), np.full(4, -a)]).astype(np.float32)
    return a, np.full(8, b, np.float32), c


def test_fma_rounds_once_at_float32_ties():
    """Where the float64 sum sits on a float32 tie, normal or subnormal,
    `fma` rounds the exact sum (the float64 sum rounded again to float32
    would not)."""
    from warpdemux_tpu_torch.ops.numerics import fma

    a, b, c = (np.concatenate(v) for v in zip(_tie_triples(64), _subnormal_tie_triples()))
    want = np.array([_rounded_once(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    twice = (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)
    assert not _same_bits(twice, want).any()
    got = fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    assert _same_bits(got, want).all()


def test_fma_rounds_once_on_random_and_subnormal_sums():
    from warpdemux_tpu_torch.ops.numerics import fma

    rng = np.random.default_rng(8)
    n = 3000
    scale = lambda lo, hi: (2.0 ** rng.integers(lo, hi, n)).astype(np.float32)
    a = rng.normal(size=n).astype(np.float32) * scale(-75, 40)
    b = rng.normal(size=n).astype(np.float32) * scale(-75, 40)
    c = rng.normal(size=n).astype(np.float32) * scale(-149, 60)
    c[::7] = -(a[::7] * b[::7])  # cancellations, some exact
    want = np.array([_rounded_once(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    got = fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    assert _same_bits(got, want).all()
    assert (np.abs(want[want != 0]) < np.finfo(np.float32).tiny).sum() > 10  # subnormal results


def test_dtw_plain_equals_jax_at_a_float32_tie(monkeypatch):
    """K1's cell, fma(d, d, best), at an input whose float64 sum lands on a
    float32 tie (chip_smoke.k1_tie_case): the port's plain DTW equals the
    jitted JAX one; with the sum rounded twice, 77 of the 256 distances
    move."""
    from chip_smoke import k1_tie_case
    from warpdemux_tpu.ops.dtw import dtw_distance_matrix as jax_dtw
    from warpdemux_tpu_torch.ops import dtw

    X, Y, window, penalty = k1_tie_case()
    want = np.asarray(jax_dtw(X, Y, window, penalty))
    got = dtw.dtw_distance_matrix_plain(torch.from_numpy(X), torch.from_numpy(Y), window, penalty).numpy()
    assert _same_bits(got, want).all()
    monkeypatch.setattr(dtw, "fma", lambda a, b, c: (a.double() * b.double() + c.double()).float())
    twice = dtw.dtw_distance_matrix_plain(torch.from_numpy(X), torch.from_numpy(Y), window, penalty).numpy()
    assert (~_same_bits(twice, want)).sum() == 77
