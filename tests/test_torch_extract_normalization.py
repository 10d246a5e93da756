"""sig_extract.normalization = "mean" and "median" (fault K) against the
JAX package on the CPU, bit for bit, NaN for NaN.

- The JAX package's normalization functions (`normalize`,
  `mean_normalize`, `mad_normalize`, `normalize_wrt`, `clip_outliers`,
  `masked_median`, `masked_mad`, `masked_mean_std`) against `jax.jit` of
  theirs on the adapter buffer of chip_smoke.norm_buffer: 4 reads at
  prefix masks from a seed and the 8 edge rows of chip_smoke.NORM_EDGES
  (a constant read, MAD 0, lengths 0-2, a single inf, -inf or NaN
  sample), at the buffer's width (the median selects by order keys) and
  at 300 lanes (it sorts).
- `masked_median` at 512 lanes or more on rows whose median falls on NaN
  or +inf beside masked lanes, where a sort with the masked lanes pushed
  to float32's max (`sorted_median`) gives other medians.
- `fingerprints_from_boundaries` and `fingerprints_consensus_refined`
  with each method on 4 synthetic reads and the 8 edge rows made from the
  first: every column, the non-finite rows included.
- The adc step, full outputs, with "median" on 4 seed-0 reads against the
  jitted JAX step: every column that tests/test_torch_step_full.py holds
  exact.
- An unknown method raises ValueError in both packages.
"""

import dataclasses
import importlib
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import NORM_EDGES, NORM_METHODS, norm_buffer, norm_edge_row  # noqa: E402

# the modules, not the functions of the same name that the packages export
jn = importlib.import_module("warpdemux_tpu.ops.normalize")
pn = importlib.import_module("warpdemux_tpu_torch.ops.normalize")

MODEL = "WDX4_rna004_v1_0"
TRNA_MODEL = "WDX4_tRNA_rna004_v1_0"
L = 10000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One CPU thread for torch here: the test workers share the machine's
    cores, and this file's small operations gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same(got, want):
    """Equal bit for bit (int and bool exactly), NaN for NaN; per row."""
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
    if g.dtype != np.float32:
        return (g == w).reshape(len(g), -1).all(1)
    return ((g.view(np.int32) == w.view(np.int32)) | (np.isnan(g) & np.isnan(w))).reshape(len(g), -1).all(1)


def _assert_same(got, want, what):
    rows = _same(got, want)
    assert rows.all(), f"{what}: rows {np.nonzero(~rows)[0].tolist()} differ"


@pytest.fixture(scope="module")
def buffer():
    x, n = norm_buffer(4)
    return x, np.arange(x.shape[1])[None, :] < n[:, None]


# name -> (port function, JAX function, static arguments)
FUNCTIONS = {
    "mean_normalize": (pn.mean_normalize, jn.mean_normalize, ()),
    "mad_normalize": (pn.mad_normalize, jn.mad_normalize, ()),
    "normalize mean": (pn.normalize, jn.normalize, ("mean",)),
    "normalize median": (pn.normalize, jn.normalize, ("median",)),
    "normalize none": (pn.normalize, jn.normalize, ("none",)),
    "clip_outliers": (pn.clip_outliers, jn.clip_outliers, (5.0,)),
    "masked_median": (pn.masked_median, jn.masked_median, ()),
    "masked_mad": (pn.masked_mad, jn.masked_mad, ()),
    "masked_mean_std": (pn.masked_mean_std, jn.masked_mean_std, ()),
}


@pytest.mark.parametrize("width", [None, 300], ids=["buffer width", "300 lanes"])
@pytest.mark.parametrize("name", FUNCTIONS)
def test_normalization_function_equals_the_jitted_jax(buffer, name, width):
    x, mask = (a[:, :width] for a in buffer)
    port, jax_fn, static = FUNCTIONS[name]
    got = port(torch.from_numpy(x), torch.from_numpy(mask), *static)
    want = jax.jit(lambda a, m: jax_fn(a, m, *static))(x, mask)
    for k, (g, w) in enumerate(zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,))))):
        _assert_same(g.numpy(), w, f"{name} output {k}")


@pytest.mark.parametrize("method", NORM_METHODS)
def test_normalize_wrt_equals_the_jitted_jax(buffer, method):
    x, mask = buffer
    y = np.random.default_rng(5).normal(0, 40, (x.shape[0], 25)).astype(np.float32)
    got = pn.normalize_wrt(*map(torch.from_numpy, (y, x, mask)), method)
    want = jax.jit(lambda a, b, m: jn.normalize_wrt(a, b, m, method))(y, x, mask)
    _assert_same(got.numpy(), want, f"normalize_wrt {method}")


def test_masked_median_selects_by_order_keys_past_512_lanes():
    """Rows whose median falls on NaN or +inf beside masked lanes: the JAX
    median of a float32 row of 512 or more selects by order keys (NaN above
    +inf above every finite value), where a sort with the masked lanes at
    float32's max reads those instead: (inf, inf) for NaN, (finite, max)
    for a row half +inf."""
    rng = np.random.default_rng(3)
    x = rng.normal(80, 12, (6, 1024)).astype(np.float32)
    x[:3, :300] = np.nan
    for row, k in zip(range(3, 6), (200, 250, 300)):
        x[row, :k] = np.inf
    n = np.array([500, 501, 560, 400, 500, 600])
    mask = np.arange(1024)[None, :] < n[:, None]
    want = np.asarray(jax.jit(jn.masked_median)(x, mask))
    t = torch.from_numpy
    _assert_same(pn.masked_median(t(x), t(mask)).numpy(), want, "masked_median")
    assert np.isnan(want[:3]).all() and np.isposinf(want[3:]).all()
    assert not _same(pn.sorted_median(t(x), t(mask)).numpy(), want).any()


def _edge_rows(x, lens, a0, a1):
    """The 4 reads, then NORM_EDGES made from the first (boundaries at 0
    for the lengths, so that the adapter keeps them)."""
    rows, n, s, e = list(x[:4]), list(lens[:4]), list(a0[:4]), list(a1[:4])
    for kind in NORM_EDGES:
        row, k = norm_edge_row(kind, x[0], lens[0])
        rows.append(row)
        n.append(k)
        s.append(0 if kind.startswith("length") else a0[0])
        e.append(a1[0])
    return np.stack(rows), *(np.asarray(v, np.int32) for v in (n, s, e))


def _spc(get_spc, model, method):
    spc = get_spc(model)
    return dataclasses.replace(spc, fingerprint=dataclasses.replace(spc.fingerprint, extract_normalization=method))


def _mrna_rows():
    from warpdemux_tpu_torch.utils.synthetic import synth_minibatch

    adc, off, sc, lens = synth_minibatch(np.random.default_rng(0), 4, L)
    x = ((adc.astype(np.float32) + off[:, None]) * sc[:, None]).astype(np.float32)
    rng = np.random.default_rng(9)
    a0 = rng.integers(0, 400, 4)
    return _edge_rows(x, lens, a0, a0 + rng.integers(2500, 5000, 4))


@pytest.mark.parametrize("method", NORM_METHODS)
def test_fingerprints_from_boundaries_equal_the_jitted_jax(method):
    from warpdemux_tpu.config.utils import get_model_spc_config as jax_spc
    from warpdemux_tpu.ops.fingerprint import fingerprints_from_boundaries as jax_fpt
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.ops.fingerprint import fingerprints_from_boundaries

    x, n, s, e = _mrna_rows()
    got = fingerprints_from_boundaries(*map(torch.from_numpy, (x, n, s, e)),
                                       _spc(get_model_spc_config, MODEL, method).fingerprint)
    want = jax_fpt(x, n, s, e, _spc(jax_spc, MODEL, method).fingerprint)
    for name in got._fields:
        _assert_same(getattr(got, name).numpy(), getattr(want, name), name)
    ok = got.ok.numpy()
    assert ok[:4].all() and not ok[[4, 5, 6, 7, 8, 11]].any()  # the NaN rows and the empty ones fail
    assert np.isnan(got.fpt.numpy()[4:]).any()


@pytest.mark.parametrize("method", NORM_METHODS)
def test_consensus_fingerprints_equal_the_jitted_jax(method):
    from warpdemux_tpu.config.utils import get_model_spc_config as jax_spc
    from warpdemux_tpu.ops.fingerprint import fingerprints_consensus_refined as jax_refined
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.consensus_data import CONSENSUS
    from warpdemux_tpu_torch.ops.fingerprint import fingerprints_consensus_refined
    from warpdemux_tpu_torch.utils.synthetic import synth_trna_barcoded_read, trna_barcode_patterns

    rng = np.random.default_rng(11)
    pats = trna_barcode_patterns(4, 25)
    x, lens, a0, a1 = np.zeros((4, L), np.float32), [], [], []
    for k in range(4):
        sig, truth = synth_trna_barcoded_read(rng, pats[k], polya_len=(600, 0)[k % 2])
        x[k, : min(L, sig.size)] = sig[:L]
        lens.append(min(L, sig.size))
        a0.append(truth["adapter_start"])
        a1.append(truth["adapter_end"])
    x, n, s, e = _edge_rows(x, np.asarray(lens), np.asarray(a0), np.asarray(a1))
    query = np.asarray(CONSENSUS["rna004_130bps_v1_0"], np.float32)
    spc, jspc = _spc(get_model_spc_config, TRNA_MODEL, method), _spc(jax_spc, TRNA_MODEL, method)
    got = fingerprints_consensus_refined(*map(torch.from_numpy, (x, n, s, e, query)), spc.fingerprint, spc.seg_extra)
    want = jax_refined(x, n, s, e, query, jspc.fingerprint, jspc.seg_extra)
    for name in got.base._fields:
        _assert_same(getattr(got.base, name).numpy(), getattr(want.base, name), name)
    for name in ("outlier", "seg_query_start", "seg_query_end", "sig_barcode_start"):
        _assert_same(getattr(got, name).numpy(), getattr(want, name), name)
    assert got.base.ok.numpy()[:4].all()


def test_median_step_equals_the_jitted_jax_step():
    """The adc step, full outputs, with sig_extract.normalization =
    "median" on 4 seed-0 reads: every packed column exact (the fingerprint
    columns where the fingerprint succeeded, as
    tests/test_torch_step_full.py holds them), success, pred and conf."""
    from warpdemux_tpu.config.utils import get_model_spc_config as jax_spc
    from warpdemux_tpu.models.registry import load_model as jax_load_model
    from warpdemux_tpu.pipeline.schema import PackSchema as JaxSchema
    from warpdemux_tpu.pipeline.step import make_demux_step as jax_make_step
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.pipeline.schema import PackSchema
    from warpdemux_tpu_torch.pipeline.step import make_demux_step
    from warpdemux_tpu_torch.utils.synthetic import synth_minibatch

    rows = synth_minibatch(np.random.default_rng(0), 4, L)
    got = make_demux_step(load_model(MODEL, "cpu"), _spc(get_model_spc_config, MODEL, "median"),
                          input_format="adc", device="cpu")(*rows)
    want = jax_make_step(jax_load_model(MODEL), _spc(jax_spc, MODEL, "median"), input_format="adc")(*rows)
    gi, gf, wi, wf = got.big_i.numpy(), got.big_f.numpy(), np.asarray(want.big_i), np.asarray(want.big_f)
    schema, jschema = PackSchema.from_buffers(gi, gf), JaxSchema.from_buffers(wi, wf)
    gcols = {**schema.unpack(gi, np.int32), **schema.unpack(gf, np.float32)}
    wcols = {**jschema.unpack(wi, np.int32), **jschema.unpack(wf, np.float32)}
    assert gcols.keys() == wcols.keys()
    ok = wcols["fpt_ok"] == 1
    assert ok.all()
    for name, g in gcols.items():
        _assert_same(g, wcols[name], name)
    for name in ("success", "pred", "conf"):
        _assert_same(getattr(got, name).numpy(), getattr(want, name), name)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_an_unknown_method_raises_value_error(package):
    from warpdemux_tpu.config.utils import get_model_spc_config as jax_spc
    from warpdemux_tpu.ops.fingerprint import fingerprints_from_boundaries as jax_fpt
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.ops.fingerprint import fingerprints_from_boundaries

    x, n, s, e = (a[:2] for a in _mrna_rows())
    if package == "port":
        fpt, mod, get_spc, wrap = fingerprints_from_boundaries, pn, get_model_spc_config, torch.from_numpy
    else:
        fpt, mod, get_spc, wrap = jax_fpt, jn, jax_spc, np.asarray
    mask = np.ones(x.shape, bool)
    with pytest.raises(ValueError, match="Normalization method zscore not recognized"):
        mod.normalize(wrap(x), wrap(mask), "zscore")
    with pytest.raises(ValueError, match="Normalization method none not recognized"):
        mod.normalize_wrt(wrap(x), wrap(x), wrap(mask), "none")
    with pytest.raises(ValueError, match="Normalization method zscore not recognized"):
        fpt(*map(wrap, (x, n, s, e)), _spc(get_spc, MODEL, "zscore").fingerprint)
