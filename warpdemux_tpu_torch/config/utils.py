"""Config resolution: model name -> chemistry TOML -> SigProcConfig.

Reads the reference package's chemistry TOMLs and model registry by path
(warpdemux_tpu/config/config_files/, warpdemux_tpu/models/model_files/),
with the same layered overrides as warpdemux_tpu/config/utils.py.
"""

from __future__ import annotations

import tomllib
from pathlib import Path

from warpdemux_tpu_torch.config.sig_proc import SigProcConfig

# data files shared with the reference package, read by path
DATA_ROOT = Path(__file__).resolve().parents[2] / "warpdemux_tpu"
CONFIG_DIR = DATA_ROOT / "config" / "config_files"
MODEL_DIR = DATA_ROOT / "models" / "model_files"
CNN_DIR = DATA_ROOT / "detect" / "cnn_files"


def _deep_merge(base: dict, overlay: dict) -> dict:
    out = dict(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _read_toml(path: Path) -> dict:
    with open(path, "rb") as f:
        return tomllib.load(f)


def load_chemistry_dict(name: str) -> dict:
    path = CONFIG_DIR / f"{name}.toml"
    if not path.exists():
        raise FileNotFoundError(
            f"chemistry config {name!r} not found in {CONFIG_DIR}"
        )
    return _read_toml(path)


def load_chemistry_config(
    name: str, overrides: dict | None = None
) -> SigProcConfig:
    d = load_chemistry_dict(name)
    if overrides:
        d = _deep_merge(d, overrides)
    return SigProcConfig.from_dict(d)


def model_config(name: str) -> dict:
    """The registry entry of a model (models/model_files/config.toml)."""
    reg = _read_toml(MODEL_DIR / "config.toml")
    if name not in reg:
        raise KeyError(f"Unknown model {name!r}; available: {sorted(reg)}")
    return reg[name]


def get_model_spc_config(
    model_name: str, overrides: dict | None = None
) -> SigProcConfig:
    """Resolve a model name to its chemistry SigProcConfig via the registry."""
    return load_chemistry_config(model_config(model_name)["spc"], overrides)
