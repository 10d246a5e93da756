"""The port's joblib importer (warpdemux_tpu_torch/models/importer.py:
arrays_from_svc, convert_joblib and the module's command line) against
the JAX package's importer, on the CPU.

The reference's joblibs are not in the repository, so the tests pickle
their own: a fitted sklearn SVC(kernel='precomputed') inside an instance
of the reference's class `warpdemux.models.dtw_svm.DTW_SVM`, which the
importer's stubs stand for when it loads the pickle. Every array must
equal the JAX importer's: key for key, dtype for dtype, bit for bit.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from warpdemux_tpu.models import importer as jax_importer  # noqa: E402
from warpdemux_tpu_torch.models import importer  # noqa: E402

STUB_MODULE = "warpdemux.models.dtw_svm"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One CPU thread for torch here: the test workers share the machine's
    cores, and this file's many small operations gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fitted_svc(seed, n_classes=5, per_class=8):
    """(svc, X, y): an SVC on exp(-DTW) of synthetic fingerprints."""
    from sklearn.svm import SVC

    from warpdemux_tpu_torch.ops.dtw import dtw_distance_matrix

    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 1, (n_classes, 25))
    y = np.repeat(np.arange(n_classes), per_class)
    X = centers[y] + rng.normal(0, 0.4, (len(y), 25))
    Xf = torch.as_tensor(X.astype(np.float32))
    K = np.exp(-dtw_distance_matrix(Xf, Xf, 15, 0.1).numpy().astype(np.float64))
    svc = SVC(kernel="precomputed", probability=True, class_weight="balanced", random_state=9)
    return svc.fit(K, y), X, y


def assert_same_arrays(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.fixture
def stub_modules():
    """Remove the importers' stub modules afterwards (they are installed in
    sys.modules while a pickle is written or read)."""
    saved = {k: v for k, v in sys.modules.items() if k == "warpdemux" or k.startswith("warpdemux.")}
    yield
    for k in [k for k in sys.modules if k == "warpdemux" or k.startswith("warpdemux.")]:
        del sys.modules[k]
    sys.modules.update(saved)


def write_reference_joblib(path, seed, extra):
    """Pickle a DTW_SVM as the reference writes one: an instance of
    warpdemux.models.dtw_svm.DTW_SVM (here the importer's stub) whose
    attributes are the model's."""
    import joblib

    pytest.importorskip("sklearn")
    importer._install_unpickle_stubs()
    cls = sys.modules[STUB_MODULE].DTW_SVM
    cls.__module__, cls.__qualname__ = STUB_MODULE, "DTW_SVM"
    svc, X, y = fitted_svc(seed)
    obj = cls()
    obj.__dict__.update(model=svc, _X=X, label_mapper={0: 3, 1: 4, 2: 5, 3: 7, 4: -1}, window=15, penalty=0.1, **extra)
    joblib.dump(obj, path)
    for k in [k for k in sys.modules if k == "warpdemux" or k.startswith("warpdemux.")]:
        del sys.modules[k]  # the importer installs its stubs itself


JOBLIBS = {  # name -> the model's other attributes
    "WDX_a_rna004_v1_0": dict(thresholds=np.array([0.5, 0.6, 0.7, 0.8, 0.0])),
    "WDX_b_rna004_v1_0": dict(thresholds=0.9, gamma=0.5, pwr_dist=2, block_size=100, noise_class=True),
}


def test_arrays_from_svc_equals_jax():
    pytest.importorskip("sklearn")
    svc, X, _y = fitted_svc(0)
    mapper = {0: 3, 1: 4, 2: 5, 3: 7, 4: -1}
    for kw in ({}, dict(window=10, penalty=0.2, gamma=0.5, noise_class=False)):
        for thresholds in (np.zeros(5), 0.75):
            assert_same_arrays(
                importer.arrays_from_svc(svc, X, mapper, thresholds, **kw),
                jax_importer.arrays_from_svc(svc, X, mapper, thresholds, **kw),
            )


@pytest.mark.parametrize("name", JOBLIBS)
def test_convert_joblib_equals_jax(name, tmp_path, stub_modules):
    pytest.importorskip("joblib")
    path = tmp_path / f"{name}.joblib"
    write_reference_joblib(path, list(JOBLIBS).index(name), JOBLIBS[name])
    got = importer.convert_joblib(path)
    assert_same_arrays(got, jax_importer.convert_joblib(path))
    assert got["X_sv"].shape[0] == int(got["n_support"].sum())


def test_importer_main_equals_jax(tmp_path, stub_modules, capsys):
    """Both command lines over one joblib directory (`--src`), and the
    port's over a reference checkout's layout (`--reference`) and as
    `python -m warpdemux_tpu_torch.models.importer`: the same npz files."""
    pytest.importorskip("joblib")
    ref = tmp_path / "reference"
    src = ref / "warpdemux" / "models" / "model_files"
    src.mkdir(parents=True)
    for i, (name, extra) in enumerate(JOBLIBS.items()):
        write_reference_joblib(src / f"{name}.joblib", i, extra)
    jax_importer.main(["--src", str(src), "--out", str(tmp_path / "jax")])
    assert importer.main(["--src", str(src), "--out", str(tmp_path / "port")]) == 0
    assert importer.main(["--reference", str(ref), "--out", str(tmp_path / "port_ref")]) == 0
    out = capsys.readouterr().out
    assert "WDX_a_rna004_v1_0: n_sv=" in out and str(tmp_path / "port_ref") in out
    run = subprocess.run(
        [sys.executable, "-m", "warpdemux_tpu_torch.models.importer", "--src", str(src), "--out", str(tmp_path / "module")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert run.returncode == 0, run.stderr
    for name in JOBLIBS:
        with np.load(tmp_path / "jax" / f"{name}.npz") as z:
            want = {k: z[k] for k in z.files}
        for out_dir in ("port", "port_ref", "module"):
            with np.load(tmp_path / out_dir / f"{name}.npz") as z:
                assert_same_arrays({k: z[k] for k in z.files}, want)


def test_importer_main_needs_a_source(capsys):
    with pytest.raises(SystemExit) as e:
        importer.main([])
    assert e.value.code == 2
    assert "give --reference or --src" in capsys.readouterr().err
