"""Port parity: the JAX-free config copies parse every chemistry TOML into
the same fields and values as the JAX package."""

import dataclasses

import pytest

from warpdemux_tpu.config.utils import get_model_spc_config as jax_model_spc
from warpdemux_tpu.config.utils import load_chemistry_config as jax_chemistry
from warpdemux_tpu_torch.config.utils import get_model_spc_config, load_chemistry_config

CHEMISTRIES = [
    "rna004_130bps@v1.0",
    "rna004_130bps@v1.0_tRNA",
    "rna002_70bps@v0.4.4",
    "rna002_70bps@v0.4.4_live",
]


def _as_dict(spc):
    return {
        f.name: (
            dataclasses.asdict(getattr(spc, f.name))
            if dataclasses.is_dataclass(getattr(spc, f.name))
            else getattr(spc, f.name)
        )
        for f in dataclasses.fields(spc)
    }


@pytest.mark.parametrize("name", CHEMISTRIES)
def test_chemistry_configs_match_jax(name):
    assert _as_dict(load_chemistry_config(name)) == _as_dict(jax_chemistry(name))


def test_overrides_and_model_resolution_match_jax():
    overrides = {"core": {"max_obs_adapter": 9000}, "cnn_boundaries": {"cnn_detect": False}}
    got = get_model_spc_config("WDX10_rna004_v1_0", overrides)
    want = jax_model_spc("WDX10_rna004_v1_0", overrides)
    assert _as_dict(got) == _as_dict(want)
    assert got.detect.max_obs_adapter == 9000 and got.detect.method == "llr"
    assert got.fingerprint.buffer_len == want.fingerprint.buffer_len
