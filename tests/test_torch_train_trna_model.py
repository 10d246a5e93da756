"""The port's stand-in tRNA model trainer (warpdemux_tpu_torch/tools/
train_trna_model.py) against the JAX trainer (tools/train_trna_model.py,
loaded by path) and against the shipped bundles it made, on the CPU.

All exact:
- make_fingerprints at --per-bc 8 --noise-n 8 (40 reads, one prep step),
  fingerprints and classes, for both generator families;
- the Gram matrix of those fingerprints (the port's dtw_distance_matrix
  against the JAX package's, bit for bit: an SVC fit on a matrix one bit
  off can differ);
- the trainer at its default arguments writes the shipped
  WDX4_tRNA_rna004_v1_0.npz key for key, dtype for dtype, bit for bit (713
  training fingerprints, K1's plain version at 713 x 713), as
  WDX4_tRNA_rna004_v1_0_torch.npz;
- with --model WDX4b_tRNA_rna004_v1_0 at a smaller size (--per-bc 20
  --noise-n 16 --holdout-per-bc 4) it writes the bundle of the JAX
  trainer's --out WDX4b_tRNA_rna004_v1_0 and prints its lines. (At its defaults it writes the shipped WDX4b bundle
  too, 714 fingerprints; that costs as much as the WDX4 pin, ~55 s on one
  thread, and is left to a run by hand.)
The JAX side runs in 32 bits, as the JAX trainer runs as a script.
"""

import importlib.util
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from warpdemux_tpu_torch.models import registry  # noqa: E402
from warpdemux_tpu_torch.tools import train_trna_model  # noqa: E402

MODELS = tuple(train_trna_model.MODEL_BARCODES)
FAMILIES = ("real", "legacy")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One CPU thread for torch here: the test workers share the machine's
    cores, and this file's many small operations gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def jax_in_32_bits():
    """The JAX trainer's mode (tests/conftest.py switches x64 on)."""
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="module")
def jax_trainer():
    spec = importlib.util.spec_from_file_location("jax_train_trna_model", REPO / "tools" / "train_trna_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fingerprints(jax_trainer):
    """{family: (JAX (X, y), port (X, y))} of WDX4b at 8 reads a barcode
    and 8 noise reads, seed 11."""
    from warpdemux_tpu.config.utils import get_model_spc_config
    from warpdemux_tpu.pipeline.step import make_demux_step

    name = MODELS[1]
    barcodes = train_trna_model.MODEL_BARCODES[name]
    pats = train_trna_model.patterns(name)
    jax_trainer.BARCODES = barcodes  # what its main() rebinds
    jax_step = make_demux_step(None, get_model_spc_config(name), with_predict=False)
    port_step = train_trna_model.prep_step(name, "cpu")
    out = {}
    for family in FAMILIES:
        want = jax_trainer.make_fingerprints(np.random.default_rng(11), 8, 8, jax_step, pats, family=family)
        got = train_trna_model.make_fingerprints(np.random.default_rng(11), 8, 8, port_step, pats, barcodes, family)
        out[family] = want, got
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_make_fingerprints_equal_jax(fingerprints, family):
    (want_X, want_y), (got_X, got_y) = fingerprints[family]
    assert got_X.dtype == want_X.dtype == np.float64
    assert got_y.dtype == want_y.dtype == np.int64
    assert got_X.shape[0] >= 30
    np.testing.assert_array_equal(got_X, want_X)
    np.testing.assert_array_equal(got_y, want_y)


def test_gram_matrix_equals_jax(fingerprints):
    from warpdemux_tpu.ops.dtw import dtw_distance_matrix

    X = np.concatenate([fingerprints[f][1][0] for f in FAMILIES])
    Xf = jnp.asarray(X.astype(np.float32))
    want = np.asarray(dtw_distance_matrix(Xf, Xf, 15, 0.1), np.float64)
    got = train_trna_model.gram_distances(X, torch.device("cpu"))
    assert got.dtype == np.float64 and got.shape == (len(X), len(X))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.diag(got), 0.0)


def read_npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def assert_same_arrays(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_trainer_writes_the_shipped_bundle(tmp_path, monkeypatch, capsys):
    pytest.importorskip("sklearn")
    name = MODELS[0]
    shipped = registry.load_model_arrays(name)
    monkeypatch.setattr(registry, "MODEL_DIR", tmp_path)
    arrays = train_trna_model.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert "training fingerprints: (713, 25)" in printed, printed
    assert f"saved {tmp_path / name}_torch.npz" in printed
    assert printed.count("holdout[") == 2
    assert sorted(arrays) == sorted(shipped)
    assert_same_arrays(read_npz(tmp_path / f"{name}_torch.npz"), shipped)


def test_trainer_matches_the_jax_trainer(jax_trainer, tmp_path, monkeypatch, capsys):
    """WDX4b at 20 reads a barcode, 16 noise reads and holdouts of 4: the
    same bundle and the same printed lines but the saved path."""
    import shutil

    import warpdemux_tpu.models.registry as jax_registry

    pytest.importorskip("sklearn")
    name = MODELS[1]
    argv = ["--out", name, "--per-bc", "20", "--noise-n", "16", "--holdout-per-bc", "4"]
    (tmp_path / "jax").mkdir()
    shutil.copy(jax_registry.MODEL_DIR / "config.toml", tmp_path / "jax")  # the JAX registry reads it there
    monkeypatch.setattr(jax_registry, "MODEL_DIR", tmp_path / "jax")
    monkeypatch.setattr(registry, "MODEL_DIR", tmp_path)
    monkeypatch.setattr(sys, "argv", ["train_trna_model.py", *argv])
    jax_trainer.main()
    want_out = capsys.readouterr().out
    train_trna_model.main(["--model", *argv[1:], "--device", "cpu"])  # --out names the file alone
    got_out = capsys.readouterr().out
    assert_same_arrays(read_npz(tmp_path / f"{name}_torch.npz"), read_npz(tmp_path / "jax" / f"{name}.npz"))
    not_saved = lambda out: [line for line in out.splitlines() if not line.startswith("saved ")]
    assert not_saved(got_out) == not_saved(want_out)
    assert "training fingerprints: (" in got_out and got_out.count("holdout[") == 2


def test_trainer_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_trna_model.main([])
