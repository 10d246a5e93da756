"""The port's package-level API against the JAX package's.

- Every name that an `__init__.py` of the JAX package binds (its imports
  from the package's modules, its functions, classes and assignments) is an
  attribute of the port's subpackage of the same path, except EXCLUDED.
- `ops.distance_matrix_to` (the reference's drop-in), `ops.dtw_distance_ref`
  / `dtw_distance_matrix_ref` (the float64 golden DTW) and
  `config.apply_overrides` equal the JAX functions on the CPU.
"""

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "warpdemux_tpu"

# (subpackage, name) -> why the port leaves it out
EXCLUDED = {
    ("parallel", "make_sharded_demux_step"): "the port runs one process a card (parallel/multihost.run_workers)",
    ("parallel", "class_counts_psum"): "the port runs one process a card (parallel/multihost.run_workers)",
    ("native", "windowed_t_test"): "no caller in either package but the JAX package's tests",
    ("native", "segment_means"): "no caller in either package but the JAX package's tests",
    ("native", "mvs_scan"): "no caller in either package but the JAX package's tests",
    ("native", "_DIR"): "private: the JAX library's build directory",
    ("native", "_LIB_PATH"): "private: the JAX library's path",
}


def _bound_names(init: Path):
    """Names an __init__.py binds at its top level, but module imports
    (`import x`) and `from __future__`."""
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.module != "__future__":
            yield from (a.asname or a.name for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            yield node.name
        elif isinstance(node, ast.Assign):
            yield from (t.id for t in node.targets if isinstance(t, ast.Name))


EXPORTS = [
    (".".join(init.parent.relative_to(JAX_PKG).parts), name)
    for init in sorted(JAX_PKG.rglob("__init__.py"))
    for name in _bound_names(init)
]


PORTED = [e for e in EXPORTS if e not in EXCLUDED]


def _port(sub):
    return importlib.import_module("warpdemux_tpu_torch" + (f".{sub}" if sub else ""))


def test_the_exclusions_are_jax_exports_the_port_lacks():
    subs = {sub for sub, _ in EXPORTS}
    assert {"", "config", "detect", "io", "live", "models", "native", "ops", "parallel", "pipeline", "utils"} <= subs
    assert set(EXCLUDED) <= set(EXPORTS)
    assert not [(sub, name) for sub, name in EXCLUDED if hasattr(_port(sub), name)]


@pytest.mark.parametrize("sub, name", PORTED, ids=[f"{s or 'root'}.{n}" for s, n in PORTED])
def test_the_port_exports_each_name_of_the_jax_package(sub, name):
    assert hasattr(_port(sub), name), f"warpdemux_tpu_torch.{sub} lacks {name}"


def test_ops_normalize_is_the_function_as_in_jax():
    import warpdemux_tpu.ops as jax_ops
    import warpdemux_tpu_torch.ops as ops

    assert callable(jax_ops.normalize) and callable(ops.normalize)
    assert ops.normalize.__module__ == "warpdemux_tpu_torch.ops.normalize"


def test_version_is_the_ports_own():
    import warpdemux_tpu_torch

    assert isinstance(warpdemux_tpu_torch.__version__, str) and warpdemux_tpu_torch.__version__


def test_distance_matrix_to_equals_jax_on_the_cpu():
    """32 fingerprints against WDX4's 851 support vectors."""
    from warpdemux_tpu.ops import distance_matrix_to as jax_distance_matrix_to
    from warpdemux_tpu_torch.models.registry import load_model_arrays
    from warpdemux_tpu_torch.ops import distance_matrix_to

    Y = load_model_arrays("WDX4_rna004_v1_0")["X_sv"].astype(np.float32)
    X = np.random.default_rng(0).normal(0, 1, (32, Y.shape[1])).astype(np.float32)
    got = distance_matrix_to(X, Y, device="cpu", block_size=64, n_jobs=4)
    want = jax_distance_matrix_to(X, Y, block_size=64, n_jobs=4)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32 and got.shape == (32, len(Y))
    np.testing.assert_array_equal(got, want)


def test_dtw_distance_ref_equals_jax():
    from warpdemux_tpu.ops.dtw import dtw_distance_matrix_ref as jax_matrix_ref
    from warpdemux_tpu.ops.dtw import dtw_distance_ref as jax_ref
    from warpdemux_tpu_torch.ops import dtw_distance_matrix_ref, dtw_distance_ref

    rng = np.random.default_rng(1)
    for k, (m, n, window) in enumerate([(25, 25, 15)] * 4 + [(25, 30, 5), (12, 7, 3), (1, 1, 1), (40, 40, 40)]):
        s1, s2 = rng.normal(0, 1, m), rng.normal(0, 1, n)
        assert dtw_distance_ref(s1, s2, window, 0.1 * k) == jax_ref(s1, s2, window, 0.1 * k)
    X, Y = rng.normal(0, 1, (3, 25)), rng.normal(0, 1, (4, 25))
    np.testing.assert_array_equal(dtw_distance_matrix_ref(X, Y, 15, 0.1), jax_matrix_ref(X, Y, 15, 0.1))


def test_apply_overrides_equals_jax():
    from warpdemux_tpu.config.utils import apply_overrides as jax_apply
    from warpdemux_tpu.config.utils import load_chemistry_dict as jax_chemistry
    from warpdemux_tpu_torch.config import apply_overrides
    from warpdemux_tpu_torch.config.utils import load_chemistry_dict

    base = load_chemistry_dict("rna004_130bps@v1.0")
    assert base == jax_chemistry("rna004_130bps@v1.0")
    overrides = {"sig_extract": {"normalization": "median", "padding": 50},
                 "segmentation": {"barcode_num_events": 30, "new": {"deep": [1, 2]}}, "extra": 1}
    got = apply_overrides(base, overrides)
    assert got == jax_apply(base, overrides)
    assert got["sig_extract"]["normalization"] == "median" and got["segmentation"]["new"] == {"deep": [1, 2]}
    assert base["sig_extract"].get("normalization") != "median"  # the base is left as it was
