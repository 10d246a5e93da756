"""The port's adc decision step against the JAX step on the rest of the
seed-0 bench batch: rows 256-999 (tests/test_torch_step.py covers 0-255),
row for row on (success, fail_code, pred). Row 795 holds a last-bit tie in
the LLR refinement (tests/test_torch_numerics.py): JAX fails it with
code 5 at poly(A) start = end = 4453."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import B as BENCH_B  # noqa: E402
from bench import L, synth_minibatch  # noqa: E402

MODEL = "WDX4_rna004_v1_0"
CHUNKS = [(256, 504), (504, 752), (752, 1000)]


@pytest.fixture(scope="module")
def setup():
    from warpdemux_tpu.config.utils import get_model_spc_config as jax_spc
    from warpdemux_tpu.models.registry import load_model as jax_load_model
    from warpdemux_tpu.pipeline.step import make_demux_step as jax_make_step
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    jax_step = jax_make_step(
        jax_load_model(MODEL), jax_spc(MODEL), input_format="adc", outputs="decision"
    )
    port_step = make_demux_step(
        load_model(MODEL, "cpu"), get_model_spc_config(MODEL), input_format="adc",
        outputs="decision", device="cpu",
    )
    batch = synth_minibatch(np.random.default_rng(0), BENCH_B, L)
    return jax_step, port_step, batch


@pytest.mark.parametrize("lo, hi", CHUNKS)
def test_bench_rows_match_jax_row_for_row(setup, lo, hi):
    jax_step, port_step, batch = setup
    args = tuple(a[lo:hi] for a in batch)
    got, want = port_step(*args), jax_step(*args)
    for name in ("success", "fail_code", "pred"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name
        )
    np.testing.assert_allclose(got.probs.numpy(), np.asarray(want.probs), rtol=1e-5, atol=1e-6)
    if lo <= 795 < hi:
        assert int(want.fail_code[795 - lo]) == 5
        assert int(got.fail_code[795 - lo]) == 5
