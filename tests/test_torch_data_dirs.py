"""The port's bundle directories: its writers (the CNN trainer, the tRNA
trainer, the joblib importer) write into the port's own directories by
default, never into the JAX package's, and under no shipped name unless
told; its loaders read a bundle there before the JAX package's bundle of
the same name, and log when they do."""

import logging
from pathlib import Path

import numpy as np
import pytest

from warpdemux_tpu_torch.config import utils as config_utils
from warpdemux_tpu_torch.detect import cnn
from warpdemux_tpu_torch.models import importer, registry
from warpdemux_tpu_torch.tools import train_cnn, train_trna_model

REPO = Path(__file__).resolve().parents[1]
JAX_PACKAGE = REPO / "warpdemux_tpu"
PORT_PACKAGE = REPO / "warpdemux_tpu_torch"


def default_outputs():
    return {
        "train_cnn": train_cnn.output_path(train_cnn.build_parser().parse_args([])),
        "train_trna_model": train_trna_model.output_path(train_trna_model.build_parser().parse_args([])),
        "importer": importer.output_dir(importer.build_parser().parse_args(["--src", "joblibs"])),
    }


@pytest.mark.parametrize("writer", ["train_cnn", "train_trna_model", "importer"])
def test_writer_defaults_resolve_outside_the_jax_package(writer):
    out = default_outputs()[writer].resolve()
    assert not out.is_relative_to(JAX_PACKAGE.resolve()), out
    assert out.is_relative_to(PORT_PACKAGE.resolve()), out


def test_the_shared_directories_are_the_jax_packages():
    assert config_utils.SHARED_MODEL_DIR == JAX_PACKAGE / "models" / "model_files"
    assert config_utils.SHARED_CNN_DIR == JAX_PACKAGE / "detect" / "cnn_files"
    assert (config_utils.SHARED_MODEL_DIR / "config.toml").exists()
    assert "WDX4_rna004_v1_0" in config_utils.available_models()


def test_a_model_bundle_of_the_port_is_found_before_the_jax_one(tmp_path, monkeypatch, caplog):
    name = "WDX4_rna004_v1_0"
    monkeypatch.setattr(registry, "MODEL_DIR", tmp_path)
    shipped = registry.load_model_arrays(name)
    mine = dict(shipped, thresholds=np.full_like(shipped["thresholds"], 0.25))
    np.savez_compressed(tmp_path / f"{name}.npz", **mine)
    with caplog.at_level(logging.WARNING):
        got = registry.load_model_arrays(name)
    assert f"serving {tmp_path / name}.npz in place of the shipped" in caplog.text
    np.testing.assert_array_equal(got["thresholds"], mine["thresholds"])
    assert float(registry.load_model(name, "cpu").thresholds[0]) == 0.25
    (tmp_path / f"{name}.npz").unlink()
    np.testing.assert_array_equal(registry.load_model_arrays(name)["thresholds"], shipped["thresholds"])


def test_a_cnn_bundle_of_the_port_is_found_before_the_jax_one(tmp_path, monkeypatch):
    name = "rna004_cnn_synth_v1"
    monkeypatch.setattr(config_utils, "CNN_DIR", tmp_path)
    shipped = cnn.load_arrays(name)
    mine = {k: v + 1.0 for k, v in shipped.items()}
    np.savez_compressed(tmp_path / f"{name}.npz", **mine)
    for got in (cnn.load_arrays(name), registry.load_cnn_arrays(name)):
        for k in shipped:
            np.testing.assert_array_equal(got[k], mine[k], err_msg=k)
    (tmp_path / f"{name}.npz").unlink()
    np.testing.assert_array_equal(cnn.load_arrays(name)["w0"], shipped["w0"])


@pytest.mark.parametrize(
    "argv, model, out",
    [
        ([], "WDX4_tRNA_rna004_v1_0", "WDX4_tRNA_rna004_v1_0_torch"),
        (["--model", "WDX4b_tRNA_rna004_v1_0"], "WDX4b_tRNA_rna004_v1_0", "WDX4b_tRNA_rna004_v1_0_torch"),
        (["--out", "my_trna"], "WDX4_tRNA_rna004_v1_0", "my_trna"),
        (["--model", "WDX4b_tRNA_rna004_v1_0", "--out", "my_trna"], "WDX4b_tRNA_rna004_v1_0", "my_trna"),
    ],
)
def test_the_trna_trainer_writes_any_name(argv, model, out):
    """`--model` picks what is trained, `--out` only names the bundle (by
    default the model's name with `_torch`, which ships nowhere)."""
    args = train_trna_model.build_parser().parse_args(argv)
    assert args.model == model
    assert train_trna_model.output_path(args) == registry.MODEL_DIR / f"{out}.npz"


@pytest.mark.parametrize("writer", ["train_cnn", "train_trna_model", "importer"])
def test_writers_refuse_a_shipped_name_unless_told(writer, tmp_path, monkeypatch):
    """A bundle written under a shipped name would be served in the
    shipped one's place, so each writer refuses one, before any work,
    without --replace-shipped."""
    monkeypatch.setattr(config_utils, "CNN_DIR", tmp_path)
    monkeypatch.setattr(config_utils, "MODEL_DIR", tmp_path)
    monkeypatch.setattr(registry, "MODEL_DIR", tmp_path)
    if writer == "importer":
        src = tmp_path / "joblibs"
        src.mkdir()
        (src / "WDX4_rna004_v1_0.joblib").write_bytes(b"")  # refused before it is read
        with pytest.raises(FileExistsError, match="--replace-shipped"):
            importer.main(["--src", str(src)])
        assert not list(tmp_path.glob("*.npz"))
        with pytest.raises(Exception) as raised:  # told: the (empty) joblib is read
            importer.main(["--src", str(src), "--replace-shipped"])
        assert not isinstance(raised.value, FileExistsError)
        return
    module, name = {"train_cnn": (train_cnn, "rna004_cnn_synth_v1"),
                    "train_trna_model": (train_trna_model, "WDX4_tRNA_rna004_v1_0")}[writer]
    with pytest.raises(FileExistsError, match="--replace-shipped"):
        module.output_path(module.build_parser().parse_args(["--out", name]))
    with pytest.raises(FileExistsError):
        module.main(["--out", name, "--device", "cpu"])
    assert module.output_path(module.build_parser().parse_args(["--out", name, "--replace-shipped"])) == (
        tmp_path / f"{name}.npz")


def test_a_default_cnn_training_run_leaves_the_shipped_weights_served(tmp_path, monkeypatch):
    """The CNN trainer at its default name (one step of two reads) writes
    beside the shipped default CNN of every chemistry, not over it, and the
    loaders go on serving the shipped weights."""
    name = "rna004_cnn_synth_v1"
    monkeypatch.setattr(config_utils, "CNN_DIR", tmp_path)
    with np.load(config_utils.SHARED_CNN_DIR / f"{name}.npz") as z:
        shipped = dict(z)
    train_cnn.main(["--steps", "1", "--batch", "2", "--device", "cpu"])
    assert [p.name for p in tmp_path.glob("*.npz")] == [f"{name}_torch.npz"]
    for got in (cnn.load_arrays(name), registry.load_cnn_arrays(name)):
        assert sorted(got) == sorted(shipped)
        for k in shipped:
            np.testing.assert_array_equal(got[k], shipped[k], err_msg=k)
