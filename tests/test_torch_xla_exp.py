"""Port parity: the SVM kernel matrix's exp (ops/numerics.py
`xla_exp_plain`, the plain version of kernel K16) against the jitted JAX
expression it stands for, `jnp.exp(-gamma * D)` (warpdemux_tpu/ops/svm.py
`pdist_kernel`), bit for bit (a NaN as a NaN), at the gamma of the shipped
WDX4, WDX6 and WDX10 bundles (and RNA002's WDX4, whose gamma is not 1):

- on 2**20 float32 bit patterns from a seeded default_rng, with the edge
  values of chip_smoke.K16_EDGES;
- on the DTW distances of the step test's rows: the fingerprints the
  port's CPU step computes for the first 64 reads of the seed-0 bench
  batch, against each model's support vectors.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import K16_EDGES  # noqa: E402
from warpdemux_tpu.ops import svm as jax_svm  # noqa: E402
from warpdemux_tpu_torch.ops import numerics, svm  # noqa: E402

MODELS = ("WDX4_rna004_v1_0", "WDX6_rna004_v1_0", "WDX10_rna004_v1_0", "WDX4_rna002_v0_4_4")
STEP_ROWS = 64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same_bits(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) & np.isnan(b))


def _gamma(name):
    from warpdemux_tpu_torch.models.registry import load_model_arrays

    return float(load_model_arrays(name)["gamma"])


def _sweep():
    bits = np.random.default_rng(20).integers(0, 1 << 32, (1 << 20) - len(K16_EDGES), dtype=np.uint64)
    return np.concatenate([bits.astype(np.uint32).view(np.float32), np.asarray(K16_EDGES, np.float32)])


@pytest.mark.parametrize("name", MODELS)
def test_bit_patterns_at_the_models_gamma(name):
    gamma = _gamma(name)
    x = _sweep()
    want = np.asarray(jax.jit(lambda d: jnp.exp(-gamma * d))(x))
    got = numerics.xla_exp_plain(torch.from_numpy(x), -gamma).numpy()
    bad = ~_same_bits(got, want)
    assert not bad.any(), (gamma, x[bad][:5], got[bad][:5], want[bad][:5])
    assert torch.equal(numerics.xla_exp(torch.from_numpy(x), -gamma).view(torch.int32),
                       torch.from_numpy(got).view(torch.int32))


def test_bit_patterns_at_scale_one():
    """xla_exp_plain's own exp: the softmax and the Platt sigmoid call it
    with the scale at 1."""
    x = _sweep()
    bad = ~_same_bits(numerics.xla_exp_plain(torch.from_numpy(x)).numpy(), np.asarray(jax.jit(jnp.exp)(x)))
    assert not bad.any(), x[bad][:5]


@pytest.fixture(scope="module")
def step_fingerprints():
    """The fingerprints the port's WDX4 CPU step hands to the DTW for the
    first STEP_ROWS reads of the seed-0 bench batch."""
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models import dtw_svm
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.pipeline.step import make_demux_step
    from warpdemux_tpu_torch.utils.synthetic import synth_minibatch

    adc, off, sc, lens = synth_minibatch(np.random.default_rng(0), STEP_ROWS, 10000)
    step = make_demux_step(load_model(MODELS[0], "cpu"), get_model_spc_config(MODELS[0]), input_format="adc",
                           outputs="decision", device="cpu")
    seen = []
    kernel_matrix = dtw_svm.dtw_kernel_matrix  # the distances and their exp, one call (K1 on CUDA)

    def record(fpts, *args):
        seen.append(fpts.clone())
        return kernel_matrix(fpts, *args)

    dtw_svm.dtw_kernel_matrix = record
    try:
        step(adc, off, sc, lens)
    finally:
        dtw_svm.dtw_kernel_matrix = kernel_matrix
    assert len(seen) == 1 and seen[0].shape[0] == STEP_ROWS
    return seen[0]


@pytest.mark.parametrize("name", MODELS[:3])
def test_step_distances(name, step_fingerprints):
    """exp(-gamma * D) over the step rows' distances to the model's support
    vectors: xla_exp_plain and svm.pdist_kernel against the jitted JAX
    pdist_kernel."""
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.ops.dtw import dtw_distance_matrix

    model = load_model(name, "cpu")
    D = dtw_distance_matrix(step_fingerprints, model.X_sv, model.window, model.penalty)
    assert D.shape == (STEP_ROWS, model.X_sv.shape[0]) and bool(torch.isfinite(D).all())
    want = np.asarray(jax.jit(jax_svm.pdist_kernel, static_argnums=(1, 2))(D.numpy(), model.gamma, model.pwr_dist))
    assert _same_bits(numerics.xla_exp_plain(D, -model.gamma).numpy(), want).all()
    assert _same_bits(svm.pdist_kernel(D, model.gamma, model.pwr_dist).numpy(), want).all()
