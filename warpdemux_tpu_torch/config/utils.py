"""Config resolution: model name -> chemistry TOML -> SigProcConfig.

Reads the reference package's chemistry TOMLs and model registry by path
(warpdemux_tpu/config/config_files/, warpdemux_tpu/models/model_files/),
with the same layered overrides as warpdemux_tpu/config/utils.py, its
`--export` parsing and its `config.toml` snapshot writer.

Array bundles (models, CNN weights) are looked up by name in the port's own
directories first (MODEL_DIR, CNN_DIR: what its trainers and importer
write, generated and not tracked), then in the reference package's
(SHARED_MODEL_DIR, SHARED_CNN_DIR), which the port only reads. The writers
take names that do not ship (`bundle_path`) unless told to replace one.
"""

from __future__ import annotations

import ast
import logging
import tomllib
from pathlib import Path

from warpdemux_tpu_torch.config.sig_proc import SigProcConfig

# data files shared with the reference package, read by path, never written
DATA_ROOT = Path(__file__).resolve().parents[2] / "warpdemux_tpu"
CONFIG_DIR = DATA_ROOT / "config" / "config_files"
SHARED_MODEL_DIR = DATA_ROOT / "models" / "model_files"
SHARED_CNN_DIR = DATA_ROOT / "detect" / "cnn_files"
# the port's writable bundle directories, looked up before the shared ones
PORT_ROOT = Path(__file__).resolve().parents[1]
MODEL_DIR = PORT_ROOT / "models" / "model_files"
CNN_DIR = PORT_ROOT / "detect" / "cnn_files"


_shadowing: set[Path] = set()  # port bundles already warned of


def find_bundle(name: str, own: Path, shared: Path) -> Path:
    """<name>.npz in the port's directory `own` if it is there, else in the
    shared directory (whether or not it exists there). A port bundle served
    in place of a shipped one of the same name is logged, once a path."""
    path = Path(own) / f"{name}.npz"
    if not path.exists():
        return Path(shared) / f"{name}.npz"
    if (Path(shared) / f"{name}.npz").exists() and path not in _shadowing:
        _shadowing.add(path)
        logging.warning("bundle %r: serving %s in place of the shipped %s", name, path, Path(shared) / f"{name}.npz")
    return path


def bundle_path(name: str, own: Path, shared: Path, replace_shipped: bool = False) -> Path:
    """<own>/<name>.npz, where a writer puts bundle `name`. Refused
    (FileExistsError) where `shared` ships a bundle of that name, unless
    `replace_shipped`: the loaders would serve the written one in its
    place."""
    if not replace_shipped and (Path(shared) / f"{name}.npz").exists():
        raise FileExistsError(
            f"bundle {name!r} ships in {shared}: writing it to {own} would replace it for every "
            "load of that name; pick another name, or pass --replace-shipped"
        )
    return Path(own) / f"{name}.npz"


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


def available_models() -> list[str]:
    """The registry's model names (models/model_files/config.toml), those
    without shipped arrays among them."""
    return list(_read_toml(SHARED_MODEL_DIR / "config.toml"))


def model_config(name: str) -> dict:
    """The registry entry of a model (models/model_files/config.toml)."""
    reg = _read_toml(SHARED_MODEL_DIR / "config.toml")
    if name not in reg:
        raise KeyError(f"Unknown model {name!r}; available: {sorted(reg)}")
    return reg[name]


def get_model_spc_config(
    model_name: str, overrides: dict | None = None
) -> SigProcConfig:
    """Resolve a model name to its chemistry SigProcConfig via the registry."""
    return load_chemistry_config(model_config(model_name)["spc"], overrides)


def parse_export_overrides(pairs: list[str]) -> dict:
    """Parse `section.key=value` CLI overrides (`--export`) into a nested
    dict. An argument naming an existing .toml file is loaded and merged
    whole."""
    out: dict = {}
    for pair in pairs:
        if pair.endswith(".toml") and Path(pair).exists():
            out = _deep_merge(out, _read_toml(Path(pair)))
            continue
        if "=" not in pair:
            raise ValueError(f"override {pair!r} is not key=value")
        key, val = pair.split("=", 1)
        try:
            value = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            value = val
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        if v == float("inf"):
            return "inf"
        if v == float("-inf"):
            return "-inf"
        return repr(v)
    if isinstance(v, int):
        return str(v)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    raise TypeError(f"cannot serialize {type(v)} to TOML")


def dump_toml(d: dict) -> str:
    """Serialize a two-level {section: {key: value}} dict to TOML: the
    `config.toml` snapshot of the resolved chemistry in a run directory."""
    lines = []
    for k, v in d.items():
        if not isinstance(v, dict):
            lines.append(f"{k} = {_toml_value(v)}")
    for section, body in d.items():
        if isinstance(body, dict):
            lines.append("")
            lines.append(f"[{section}]")
            for k, v in body.items():
                lines.append(f"{k} = {_toml_value(v)}")
    return "\n".join(lines) + "\n"


def resolve_model_chemistry_dict(
    model_name: str, overrides: dict | None = None
) -> dict:
    """The merged chemistry dict (registry -> chemistry TOML -> overrides)
    for snapshotting alongside a run."""
    d = load_chemistry_dict(model_config(model_name)["spc"])
    if overrides:
        d = _deep_merge(d, overrides)
    return d
