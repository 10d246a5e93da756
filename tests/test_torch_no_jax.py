"""The PyTorch port stands alone: no module of warpdemux_tpu_torch, and
neither of the GPU scripts at the repository root, imports jax, the JAX
package or the JAX package's benchmark (the root bench.py), and the
package loads with jax unavailable. Importing a subpackage (and with it
the names its __init__.py exports) pulls in neither jax, the JAX package
nor the optional dependencies that the pod5 reader, the VBZ codec and the
CSV writers import inside their functions."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1] / "warpdemux_tpu_torch"
SCRIPTS = [PKG.parent / "chip_smoke.py", PKG.parent / "tune_kernels.py"]
MODULES = sorted(PKG.rglob("*.py")) + SCRIPTS
FORBIDDEN = ("jax", "jaxlib", "warpdemux_tpu", "bench")
SUBPACKAGES = sorted(".".join(p.parent.relative_to(PKG.parent).parts) for p in PKG.rglob("__init__.py"))
NOT_AT_IMPORT = ("jax", "warpdemux_tpu", "pyarrow", "pandas", "zstandard")


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path", MODULES, ids=lambda p: p.name if p in SCRIPTS else str(p.relative_to(PKG))
)
def test_module_imports_neither_jax_nor_the_jax_package(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.name} imports {bad}"


@pytest.fixture(scope="module")
def pulled_in():
    """{subpackage: the modules of NOT_AT_IMPORT loaded once it and those
    before it are imported}, in one fresh interpreter."""
    code = (
        "import importlib, json, sys\n"
        "out = {}\n"
        f"for sub in {SUBPACKAGES!r}:\n"
        "    importlib.import_module(sub)\n"
        f"    out[sub] = [m for m in {NOT_AT_IMPORT!r} if m in sys.modules]\n"
        "print(json.dumps(out))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_importing_a_subpackage_pulls_in_no_optional_dependency(pulled_in, sub):
    assert pulled_in[sub] == [], f"importing {sub} loads {pulled_in[sub]}"


# what the GPU host lacks: jax and the JAX package, the optional
# dependencies of the pod5 reader, the CSV writers and the MinKNOW client,
# and the tRNA trainer's SVC fit and the joblib importer's unpickler
ABSENT = ("jax", "warpdemux_tpu", "pyarrow", "pandas", "zstandard", "minknow_api", "sklearn", "joblib")


def test_package_loads_without_jax():
    """Every module imports with those blocked; the step and a live session
    on the replay client build; the offline run loop writes its CSVs and
    the resume scan reads them back (the card drives the loop from
    minibatches held in memory, without pyarrow, pandas or zstandard); a
    DTW-MLP and a Fpt-Boost model classify, and target_accuracy filters
    their tables; the CNN trainer takes a step and writes its bundle, the
    tRNA trainer's device half (prep step, Gram matrix) runs, and its fit
    and the joblib importer say that they need sklearn / joblib."""
    code = (
        "import sys, tempfile\n"
        f"for name in {ABSENT!r}:\n"
        "    sys.modules[name] = None\n"
        "import pkgutil, importlib, warpdemux_tpu_torch\n"
        "for m in pkgutil.walk_packages(warpdemux_tpu_torch.__path__, 'warpdemux_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from warpdemux_tpu_torch.config.utils import get_model_spc_config\n"
        "from warpdemux_tpu_torch.models.registry import load_model\n"
        "from warpdemux_tpu_torch.pipeline.step import make_demux_step\n"
        "make_demux_step(load_model('WDX4_rna004_v1_0', 'cpu'), get_model_spc_config('WDX4_rna004_v1_0'), device='cpu')\n"
        "from warpdemux_tpu_torch.live.balancer import BalancerConfig, BarcodeBalancers\n"
        "from warpdemux_tpu_torch.live.dummy import DummyClient\n"
        "from warpdemux_tpu_torch.live.session import Session, SessionConfig\n"
        "session = Session(DummyClient(n_reads=2), SessionConfig(save_path=tempfile.mkdtemp()),\n"
        "                  BarcodeBalancers.from_configs(4, [BalancerConfig()], [1.0]), device='cpu')\n"
        "session.reporter.close()\n"
        "from warpdemux_tpu_torch.live.read_until import minknow_transport\n"
        "try:\n"
        "    minknow_transport()\n"
        "except RuntimeError as e:\n"
        "    assert 'minknow_api is required' in str(e)\n"
        "else:\n"
        "    raise AssertionError('minknow_transport ran without minknow_api')\n"
        "import numpy as np\n"
        "from warpdemux_tpu_torch.utils.synthetic import synth_minibatch\n"
        "from warpdemux_tpu_torch.cli import main\n"
        "from warpdemux_tpu_torch.config import config as c\n"
        "from warpdemux_tpu_torch.pipeline.resume import scan_processed_reads\n"
        "from warpdemux_tpu_torch.pipeline.run import demux_minibatches\n"
        "out = tempfile.mkdtemp()\n"
        "cfg = c.Config(c.InputConfig(), c.OutputConfig(output_dir=out, save_boundaries=True),\n"
        "               c.BatchConfig(minibatch_size=4, batch_size_output=2, wire='adc'), c.TaskConfig(),\n"
        "               c.ClassifConfig(model_name='WDX4_rna004_v1_0'), get_model_spc_config('WDX4_rna004_v1_0'))\n"
        "adc, off, sc, lens = synth_minibatch(np.random.default_rng(0), 3, 10000)\n"
        "ids = np.array(['r0', 'r1', 'r2'], object)\n"
        "stats = demux_minibatches(cfg, None, [(adc, off, sc, lens, lens, ids)], device='cpu')\n"
        "assert stats.total == 3, stats\n"
        "assert scan_processed_reads(out)[0] == {'r0', 'r1', 'r2'}\n"
        "from warpdemux_tpu_torch.models import registry, target_accuracy\n"
        "rng = np.random.default_rng(1)\n"
        "fam = [registry.dtw_mlp_from_arrays(dict(X_sv=rng.normal(size=(9, 25)), n_layers=1,\n"
        "       mlp_w0=rng.normal(size=(9, 3)), mlp_b0=np.zeros(3), label_map=np.array([1, 2, -1]),\n"
        "       thresholds=np.zeros(3), window=15, penalty=0.1), 'cpu'),\n"
        "       registry.fpt_boost_from_arrays(dict(feat=rng.integers(0, 25, (4, 2)), thr=rng.normal(size=(4, 2)),\n"
        "       leaf_values=rng.normal(size=(4, 4, 3)), label_map=np.array([1, 2, -1]),\n"
        "       thresholds=np.zeros(3), fingerprint_len=25), 'cpu')]\n"
        "for m in fam:\n"
        "    table = m.predictions_to_table(ids, *m.predict(rng.normal(size=(3, 25))))\n"
        "    assert len(target_accuracy.filter_predictions_table(table, 'WDX4_rna004_v1_0', 99.0)) == 3\n"
        "import contextlib, io, pathlib\n"
        "from warpdemux_tpu_torch.config import utils as cu\n"
        "from warpdemux_tpu_torch.tools import train_cnn, train_trna_model as tt\n"
        "cu.CNN_DIR = pathlib.Path(tempfile.mkdtemp())\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    train_cnn.main(['--steps', '1', '--batch', '2', '--out', 'w', '--device', 'cpu'])\n"
        "assert (cu.CNN_DIR / 'w.npz').exists()\n"
        "name = 'WDX4_tRNA_rna004_v1_0'\n"
        "X, y = tt.make_fingerprints(rng, 2, 2, tt.prep_step(name, 'cpu'), tt.patterns(name), tt.MODEL_BARCODES[name])\n"
        "assert tt.gram_distances(X, 'cpu').shape == (len(X), len(X))\n"
        "from warpdemux_tpu_torch.models.importer import convert_joblib\n"
        "for call in (lambda: tt.main(['--device', 'cpu']), lambda: convert_joblib('absent.joblib')):\n"
        "    try:\n"
        "        call()\n"
        "    except ImportError as e:\n"
        "        assert e.name in ('sklearn.svm', 'sklearn', 'joblib'), e\n"
        "    else:\n"
        "        raise AssertionError('ran without sklearn / joblib')\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=PKG.parent, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
