"""XLA's softmax in the port (ops/numerics.py `xla_softmax`, kernel K15 on
CUDA) against the jitted `jax.nn.softmax` bit for bit, and the DTW-MLP and
Fpt-Boost families that call it against the JAX models: pred, conf and
probs exact.

`jax.nn.softmax` jitted on XLA:CPU is XLA's exp of z less the row max over
XLA's row sum, the quotient flushed to zero where it is subnormal; the
families' probabilities were one ulp off it in some cells with
torch.softmax."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from warpdemux_tpu.models.dtw_mlp import DTWMLPModel as JaxMLP
from warpdemux_tpu.models.fpt_boost import FptBoostModel as JaxBoost
from warpdemux_tpu_torch.models import registry
from warpdemux_tpu_torch.ops import numerics

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import K15_EDGE_ROWS, family_arrays, k15_edge_rows, k15_logits  # noqa: E402

jit_softmax = jax.jit(jax.nn.softmax)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Several test workers share this host's cores; the emulated exp's many
    small operations gain nothing from more threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_bits_equal(got, want):
    """Bit for bit, any NaN equal to any NaN."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = ~np.isnan(want)
    np.testing.assert_array_equal(got[finite].view(np.int32), want[finite].view(np.int32))


@pytest.mark.parametrize("B", [1, 2, 16, 17, 48, 64, 1000])
@pytest.mark.parametrize("k", [5, 7, 11, 13, 33])
def test_xla_softmax_equals_the_jitted_jax_softmax(k, B):
    z = k15_logits((B, k), 100 * k + B)
    assert_bits_equal(numerics.xla_softmax(torch.from_numpy(z)).numpy(), jit_softmax(z))


@pytest.mark.parametrize("k", [1, 2, 5, 13, 33])
def test_xla_softmax_on_the_edge_rows(k):
    """Subnormal quotients (flushed to 0), +-inf, NaN, subnormal and signed-
    zero logits, exp's clamps and a difference that overflows; the rows cut
    to k classes or padded with -inf."""
    z = k15_edge_rows(k)
    assert_bits_equal(numerics.xla_softmax_plain(torch.from_numpy(z)).numpy(), jit_softmax(z))


@pytest.mark.parametrize("B, k", [(16, 1025), (8, 2000), (4, 12288)])
def test_xla_softmax_past_1024_classes_equals_the_jitted_jax_softmax(B, k):
    """Rows of more than one level of XLA's 32-wide windows (12,288: two
    levels, the widest that test_torch_numerics pins `xla_sum` at), on logits
    from a seed and on the edge rows padded with -inf: bit for bit, as K15's
    block kernels on the card."""
    for z in (k15_logits((B, k), B + k), k15_edge_rows(k)):
        assert_bits_equal(numerics.xla_softmax_plain(torch.from_numpy(z)).numpy(), jit_softmax(z))


def test_the_quotient_is_flushed_where_it_is_subnormal():
    """Without the flush the first two edge rows are off in 3 cells: each
    exp there is a normal float32, and its quotient by the row's sum is
    subnormal (5.49e-39, 4.49e-39, 4.55e-39), where XLA gives 0."""
    z = torch.tensor(K15_EDGE_ROWS[:2])
    e = numerics.xla_exp(z - z.amax(-1, keepdim=True))
    unflushed = (e / numerics.xla_sum(e)[:, None]).numpy()
    want = np.asarray(jit_softmax(z.numpy()))
    off = unflushed.view(np.int32) != want.view(np.int32)
    assert off.sum() == 3 and (want[off] == 0).all()
    assert_bits_equal(numerics.xla_softmax(z).numpy(), want)


@pytest.fixture(scope="module")
def X_ref():
    return registry.load_model_arrays("WDX4_rna004_v1_0")["X_sv"].astype(np.float32)


@pytest.mark.parametrize("kind", ["dtw_mlp", "fpt_boost"])
def test_family_models_equal_the_jax_models(X_ref, kind):
    """The DTW-MLP (851 references, one hidden layer of 100, 5 classes) and a
    1,000-tree Fpt-Boost, whole, on 200 fingerprints: pred, conf and probs
    those of the jitted JAX models."""
    arrays = family_arrays(kind, np.random.default_rng(12), X_ref)
    rng = np.random.default_rng(13)
    fpts = (X_ref[rng.integers(0, len(X_ref), 200)] + rng.normal(0, 0.3, (200, 25))).astype(np.float32)
    got = registry.model_from_arrays(arrays, "cpu", name=kind).predict(fpts)
    want = (JaxMLP if kind == "dtw_mlp" else JaxBoost).from_arrays(arrays, name=kind).predict(fpts)
    np.testing.assert_array_equal(got[0], want[0])
    assert_bits_equal(got[1], want[1])
    assert_bits_equal(got[2], want[2])
    assert len(set(got[0].tolist()) - {-1}) >= 2  # the seeded models do call barcodes
