"""The DTW-MLP and Fpt-Boost families of the port against scalar numpy
goldens (the twins of tests/test_model_families.py) and against the JAX
package's models on the same arrays, and the registry, the demux step, the
predict run and the live lane with each family.

Against the JAX models: decisions (pred), confidences and probabilities
bit for bit at the widths users train (the MLP's products and logits are
XLA's, tests/test_torch_svm_dot.py; the forest's raw scores where it has
more than 32 trees, the sum over trees in XLA's order; the softmax is
XLA's, tests/test_torch_softmax.py).
"""

import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from warpdemux_tpu.models.dtw_mlp import DTWMLPModel as JaxMLP
from warpdemux_tpu.models.fpt_boost import FptBoostModel as JaxBoost
from warpdemux_tpu.models.fpt_boost import oblivious_forest_scores as jax_forest_scores
from warpdemux_tpu_torch.models import registry
from warpdemux_tpu_torch.models.dtw_mlp import DTWMLPModel, mlp_predict_proba
from warpdemux_tpu_torch.models.fpt_boost import FptBoostModel, oblivious_forest_scores

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import family_arrays  # noqa: E402

MODEL = "WDX4_rna004_v1_0"
FAMILIES = ("dtw_mlp", "fpt_boost")
PROBS_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One CPU thread for torch here: the test workers share the machine's
    cores, and this file's many small operations gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(a):
    return torch.as_tensor(np.asarray(a))


def _softmax(z):
    e = np.exp(z - z.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def test_mlp_predict_proba_matches_numpy():
    rng = np.random.default_rng(0)
    B, n_ref, h, k = 7, 40, 16, 4
    D = rng.normal(size=(B, n_ref))
    W0, b0 = rng.normal(size=(n_ref, h)), rng.normal(size=h)
    W1, b1 = rng.normal(size=(h, k)), rng.normal(size=k)
    sm, ss = rng.normal(size=n_ref), rng.uniform(0.5, 2, n_ref)
    probs = mlp_predict_proba(t(D), [t(W0), t(W1)], [t(b0), t(b1)], t(sm), t(ss)).numpy()
    hidden = np.maximum((D - sm) / ss @ W0 + b0, 0)
    np.testing.assert_allclose(probs, _softmax(hidden @ W1 + b1), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-6)


def _small_mlp_arrays(rng, n_ref=30, m=25, h=8, k=3):
    return dict(
        X_sv=rng.normal(size=(n_ref, m)).astype(np.float32),
        n_layers=2,
        mlp_w0=rng.normal(size=(n_ref, h)).astype(np.float32),
        mlp_b0=rng.normal(size=h).astype(np.float32),
        mlp_w1=rng.normal(size=(h, k)).astype(np.float32),
        mlp_b1=rng.normal(size=k).astype(np.float32),
        label_map=np.array([3, 5, -1], np.int32),
        thresholds=np.zeros(k, np.float32),
        window=15,
        penalty=0.1,
    )


def test_mlp_model_end_to_end():
    rng = np.random.default_rng(1)
    model = registry.dtw_mlp_from_arrays(_small_mlp_arrays(rng), "cpu", name="test_mlp")
    assert isinstance(model, DTWMLPModel) and model.fingerprint_len == 25 and model.n_classes == 3
    pred, conf, probs = model.predict(rng.normal(size=(5, 25)).astype(np.float32))
    assert pred.shape == (5,) and set(np.unique(pred)) <= {3, 5, -1}
    assert probs.shape == (5, 3)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-5)
    s = np.sort(probs, axis=1)  # confidence = top1 - top2
    np.testing.assert_allclose(conf, s[:, -1] - s[:, -2], rtol=1e-5, atol=1e-6)


def _golden_forest(x, feat, thr, leaf):
    B = x.shape[0]
    T, d = feat.shape
    out = np.zeros((B, leaf.shape[-1]))
    for b in range(B):
        for tree in range(T):
            idx = 0
            for j in range(d):
                if x[b, feat[tree, j]] > thr[tree, j]:
                    idx |= 1 << j
            out[b] += leaf[tree, idx]
    return out


def test_oblivious_forest_matches_golden():
    rng = np.random.default_rng(2)
    B, m, T, d, k = 6, 25, 12, 4, 5
    x = rng.normal(size=(B, m)).astype(np.float32)
    feat = rng.integers(0, m, size=(T, d)).astype(np.int32)
    thr = rng.normal(size=(T, d)).astype(np.float32)
    leaf = rng.normal(size=(T, 2**d, k)).astype(np.float32)
    scores = oblivious_forest_scores(t(x), t(feat), t(thr), t(leaf)).numpy()
    np.testing.assert_allclose(scores, _golden_forest(x, feat, thr, leaf), rtol=1e-5, atol=1e-5)


def test_fpt_boost_model_end_to_end():
    rng = np.random.default_rng(3)
    m, T, d, k = 25, 20, 3, 4
    arrays = dict(
        feat=rng.integers(0, m, size=(T, d)).astype(np.int32),
        thr=rng.normal(size=(T, d)).astype(np.float32),
        leaf_values=rng.normal(size=(T, 2**d, k)).astype(np.float32),
        label_map=np.array([4, 5, 7, -1], np.int32),
        thresholds=np.array([0.2, 0.2, 0.2, 1.01], np.float32),
        fingerprint_len=m,
        model_type="fpt_boost",
    )
    model = registry.fpt_boost_from_arrays(arrays, "cpu", name="test_boost")
    assert isinstance(model, FptBoostModel) and model.fingerprint_len == m
    pred, conf, probs = model.predict(rng.normal(size=(8, m)).astype(np.float32))
    assert probs.shape == (8, k)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-5)
    below = conf < np.array([0.2, 0.2, 0.2, 1.01])[np.argmax(probs, axis=1)]
    assert (pred[below] == -1).all()


@pytest.fixture(scope="module")
def X_ref():
    return registry.load_model_arrays(MODEL)["X_sv"].astype(np.float32)


def _fingerprints(X_ref, n, seed):
    """Reference fingerprints with noise: reads that resemble the classes."""
    rng = np.random.default_rng(seed)
    rows = X_ref[rng.integers(0, X_ref.shape[0], n)]
    return (rows + rng.normal(0, 0.3, rows.shape)).astype(np.float32)


def _jax_model(kind, arrays):
    return (JaxMLP if kind == "dtw_mlp" else JaxBoost).from_arrays(arrays, name=kind)


@pytest.mark.parametrize("kind", FAMILIES)
def test_port_model_equals_the_jax_model_at_user_widths(X_ref, kind):
    """DTW-MLP: 851 references, one hidden layer of 100, 5 classes;
    Fpt-Boost: 1,000 trees of depth 6; 64 fingerprints."""
    arrays = family_arrays(kind, np.random.default_rng(4), X_ref)
    fpts = _fingerprints(X_ref, 64, 5)
    got = registry.model_from_arrays(arrays, "cpu", name=kind).predict(fpts)
    want = _jax_model(kind, arrays).predict(fpts)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].view(np.int32), want[1].view(np.int32))
    np.testing.assert_array_equal(got[2].view(np.int32), want[2].view(np.int32))
    assert len(set(got[0].tolist()) - {-1}) >= 2  # the seeded models do call barcodes


@pytest.mark.parametrize("trees", [33, 1000])
def test_forest_scores_equal_the_jitted_jax_function_bit_for_bit(trees):
    import jax

    arrays = family_arrays("fpt_boost", np.random.default_rng(6), trees=trees)
    x = np.random.default_rng(7).normal(0, 1, (256, 25)).astype(np.float32)
    args = (x, arrays["feat"], arrays["thr"], arrays["leaf_values"])
    want = np.asarray(jax.jit(jax_forest_scores)(*args))
    got = oblivious_forest_scores(*map(t, args)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("kind", [*FAMILIES, "dtw_svm", "unknown"])
def test_load_model_dispatches_on_model_type(tmp_path, monkeypatch, X_ref, kind):
    if kind == "dtw_svm":
        arrays = registry.load_model_arrays(MODEL)
    else:
        arrays = family_arrays("dtw_mlp" if kind == "unknown" else kind, np.random.default_rng(8), X_ref[:40])
        if kind == "unknown":
            arrays["model_type"] = np.str_("svm_forest")
    np.savez_compressed(tmp_path / "FAMILY.npz", **arrays)
    monkeypatch.setattr(registry, "MODEL_DIR", tmp_path)
    if kind == "unknown":
        with pytest.raises(ValueError, match="svm_forest"):
            registry.load_model("FAMILY", "cpu")
        return
    model = registry.load_model("FAMILY", "cpu")
    want = {"dtw_svm": "DTWSVMModel", "dtw_mlp": "DTWMLPModel", "fpt_boost": "FptBoostModel"}[kind]
    assert type(model).__name__ == want and model.name == "FAMILY"
    assert model.device == torch.device("cpu") and model.fingerprint_len == 25
    assert model.n_classes == 5 and len(model.label_values) == 5


def test_stand_in_bundles_warn(caplog):
    with caplog.at_level("WARNING"):
        registry.load_model("WDX4_tRNA_rna004_v1_0", "cpu")
    assert "STAND-IN" in caplog.text


def test_available_models_and_model_config_are_the_registrys():
    from warpdemux_tpu.models.registry import available_models, model_config

    assert registry.available_models() == available_models()
    assert registry.model_config(MODEL) == model_config(MODEL)


@pytest.mark.parametrize("kind", FAMILIES)
def test_make_demux_step_refuses_other_families(X_ref, kind):
    """The JAX step reads the SVM's support vectors and parameters
    (warpdemux_tpu/pipeline/step.py:279-281) and cannot take these."""
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    model = registry.model_from_arrays(family_arrays(kind, np.random.default_rng(9), X_ref[:40]), "cpu")
    spc = get_model_spc_config(MODEL)
    with pytest.raises(ValueError, match="DTWSVMModel"):
        make_demux_step(model, spc, device="cpu")
    make_demux_step(model, spc, with_predict=False, device="cpu")  # no classification: accepted


@pytest.fixture(scope="module")
def prep_dir(tmp_path_factory):
    """A port prep run (fingerprints saved) of the synthetic pod5 set."""
    from test_torch_run_cli import COMMON, port_cli, write_fixture

    d = tmp_path_factory.mktemp("pod5_set")
    write_fixture(d)
    out = tmp_path_factory.mktemp("prep") / "run"
    port_cli("prep", "-i", d, "-o", out, *COMMON)
    return out


@pytest.mark.parametrize("kind", FAMILIES)
def test_predict_run_writes_the_jax_clis_shards(prep_dir, tmp_path, monkeypatch, X_ref, kind):
    """`predict` on the saved fingerprints with a model of each family:
    the port's shards against the JAX CLI's (the model each registry's
    load_model returns replaced by the family's, built from the same
    arrays)."""
    import warpdemux_tpu.models.registry as jax_registry
    from test_torch_run_cli import jax_cli, port_cli, same_failed_reads, same_predictions, shard_names

    arrays = family_arrays(kind, np.random.default_rng(10), X_ref[:128])
    monkeypatch.setattr(registry, "load_model", lambda name, device=None: registry.model_from_arrays(arrays, device))
    monkeypatch.setattr(jax_registry, "load_model", lambda name, dtype=np.float32: _jax_model(kind, arrays))
    by_port, by_jax = tmp_path / "by_port", tmp_path / "by_jax"
    shutil.copytree(prep_dir, by_port)
    shutil.copytree(prep_dir, by_jax)
    port_cli("predict", by_port)
    jax_cli("predict", by_jax)
    same_predictions(by_port, by_jax)
    same_failed_reads(by_port, by_jax)
    assert shard_names(by_port, "predictions")
    calls = [line.split(",")[1] for name in shard_names(by_port, "predictions")
             for line in _gunzip_lines(by_port / "predictions" / name)[1:]]
    assert len(set(calls) - {"-1"}) >= 2


def _gunzip_lines(path):
    from test_torch_run_cli import gunzip

    return gunzip(path).splitlines()


@pytest.mark.parametrize("kind", FAMILIES)
def test_live_lane_classifies_with_every_family(tmp_path, X_ref, kind):
    """A session on the replay client with a model of each family: the lane
    program's decisions are the model's `predict` on the lane's
    fingerprints."""
    from warpdemux_tpu_torch.live.balancer import BalancerConfig, BarcodeBalancers
    from warpdemux_tpu_torch.live.dummy import DummyClient
    from warpdemux_tpu_torch.live.session import Session, SessionConfig

    model = registry.model_from_arrays(family_arrays(kind, np.random.default_rng(11), X_ref[:128]), "cpu")
    session = Session(DummyClient(n_reads=2), SessionConfig(save_path=str(tmp_path)),
                      BarcodeBalancers.from_configs(4, [BalancerConfig()], [1.0]), model=model, device="cpu")
    rng = np.random.default_rng(12)
    signals = [rng.normal(90, 12, n).astype(np.float32) for n in (6000, 7000, 8000)]
    res = session._classify_on_device(signals)
    session.reporter.close()
    fpt = res.fpt[res.ok]
    pred, conf, probs = model.predict(fpt)
    k = len(fpt)
    np.testing.assert_array_equal(res.pred[:k], pred)
    np.testing.assert_allclose(res.probs[:k], probs, **PROBS_TOL)
    with pytest.raises(ValueError, match="lies on"):
        Session(DummyClient(n_reads=2), SessionConfig(save_path=str(tmp_path)),
                BarcodeBalancers.from_configs(4, [BalancerConfig()], [1.0]), model=model,
                device="meta")
