"""The port's throughput tools (warpdemux_tpu_torch/tools/bench_models,
sweep_minibatch, bench_trna over tools/_throughput) and its seed
minibatch.

- utils/synthetic.synth_minibatch equals the root bench.py's, bit for bit
  on all four arrays, at three seeds and three shapes: the port's tools and
  chip_smoke.py draw their reads from it and no longer import bench.
- Each tool runs as a module with `--device cpu` at a small B and prints
  the JAX tool's JSON keys, table columns or line; without a card and
  without `--device cpu` each exits non-zero.
- `bench_trna --real` on one pod5 file written by the port's writer gives
  the JAX tool's (tools/bench_trna.py) pass count.
- `_throughput.in_turns` takes the paths in turns and counts its calls.

The tool processes start together and pin torch to one thread."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

JAX_KEYS = ["model", "n_ref", "n_classes", "full_reads_per_s", "full_vs_baseline", "decision_reads_per_s",
            "decision_vs_baseline"]
JAX_COLUMNS = ["B", "compile s", "full-output reads/s", "decision reads/s"]
TRNA_LINE = re.compile(r"^tRNA compute \[(.*)\]: (\d+) reads/s \(= ([\d.]+)x the 16-core reference tRNA baseline\) "
                       r"pass=(\d+)/(\d+) backend=(\w+) B=(\d+) L=(\d+)")
CPU_RUNS = {
    "bench_models": ["WDX4_rna004_v1_0", "--batch", "8", "--batches", "2", "--rounds", "2"],
    "sweep_minibatch": ["8", "--reads", "8"],
    "bench_trna": ["8", "--batches", "2"],
}


@pytest.mark.parametrize("shape", [(1000, 10000), (64, 10000), (3, 25)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_synth_minibatch_equals_bench(seed, shape):
    import bench

    from warpdemux_tpu_torch.utils import synthetic

    got = synthetic.synth_minibatch(np.random.default_rng(seed), *shape)
    want = bench.synth_minibatch(np.random.default_rng(seed), *shape)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for name in ("B", "L", "VBZ_WIDTH", "ADC_SCALE", "ADC_OFFSET"):
        assert getattr(synthetic, name) == getattr(bench, name)


def start(argv, **env):
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", **env}
    return subprocess.Popen([sys.executable, *map(str, argv)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every tool run at once: name -> (returncode, stdout, stderr). `<tool>`
    with --device cpu, `<tool> no device` without, and bench_trna --real of
    the port and of the JAX package on one small_pod5_0.pod5."""
    from test_torch_validate_boundaries import write_small_pod5

    fixtures = tmp_path_factory.mktemp("bench_trna_real")
    write_small_pod5(fixtures)
    procs = {}
    for name, args in CPU_RUNS.items():
        procs[name] = start(["-m", f"warpdemux_tpu_torch.tools.{name}", *args, "--device", "cpu"])
        procs[f"{name} no device"] = start(["-m", f"warpdemux_tpu_torch.tools.{name}", *args])
    procs["port real"] = start(["-m", "warpdemux_tpu_torch.tools.bench_trna", "16", "--real", "--device", "cpu"],
                               WDX_FIXTURE_DIR=str(fixtures))
    procs["jax real"] = start(["tools/bench_trna.py", "16", "--real"], WDX_FIXTURE_DIR=str(fixtures),
                              JAX_PLATFORMS="cpu")
    done = {}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        done[name] = (proc.returncode, out, err)
    return done


def test_bench_models_prints_the_jax_keys(runs):
    rc, out, err = runs["bench_models"]
    assert rc == 0, err
    assert "# device=cpu B=8 batches=2 rounds=2" in err
    rows = [json.loads(line) for line in out.splitlines()]
    assert [row["model"] for row in rows] == ["WDX4_rna004_v1_0"]
    row = rows[0]
    assert list(row)[: len(JAX_KEYS)] == JAX_KEYS
    assert (row["n_ref"], row["n_classes"], row["device"]) == (851, 5, "cpu")
    for path in ("full", "decision"):
        assert len(row[f"{path}_rounds"]) == 2 and all(r > 0 for r in row[f"{path}_rounds"])
        assert row[f"{path}_reads_per_s"] == round(float(np.median(row[f"{path}_rounds"])), 0)
        assert row[f"{path}_vs_baseline"] == round(row[f"{path}_reads_per_s"] / 700.0, 1)
    assert err.count("round 1:") == 1 and "median of 2" in err


def test_sweep_minibatch_prints_the_jax_table(runs):
    rc, out, err = runs["sweep_minibatch"]
    assert rc == 0, err
    lines = [line for line in out.splitlines() if line.startswith("|")]
    header = [c.strip() for c in lines[0].strip("|").split("|")]
    assert header[: len(JAX_COLUMNS)] == JAX_COLUMNS and header[-1] == "peak allocated GiB"
    assert lines[1] == "|---|---|---|---|---|"
    cells = [c.strip() for c in lines[2].strip("|").split("|")]
    assert len(lines) == 3 and cells[0] == "8" and cells[-1] == "n/a"
    assert float(cells[1]) >= 0 and float(cells[2]) > 0 and float(cells[3]) > 0
    assert out.startswith("# WDX4_rna004_v1_0, adc feed") and "on cpu" in out.splitlines()[0]


def test_bench_trna_prints_the_jax_line(runs):
    rc, out, err = runs["bench_trna"]
    assert rc == 0, err
    m = TRNA_LINE.match(out.splitlines()[-1])
    assert m, out
    feed, rps, _x, n_pass, n, backend, B, L = m.groups()
    assert (feed, backend, B, L) == ("synthetic tRNA", "cpu", "8", "10000")
    assert int(rps) > 0 and int(n) == 16 and 0 < int(n_pass) <= 16
    assert out.splitlines()[-1].endswith(" on cpu")


@pytest.mark.parametrize("name", CPU_RUNS)
def test_tool_without_a_card_and_without_device_cpu_exits_non_zero(runs, name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    rc, _, err = runs[f"{name} no device"]
    assert rc != 0 and "no CUDA device" in err


def test_bench_trna_real_gives_the_jax_tools_pass_count(runs):
    (rc, out, err), (jrc, jout, jerr) = runs["port real"], runs["jax real"]
    assert rc == 0, err
    assert jrc == 0, jerr
    got, want = TRNA_LINE.match(out.splitlines()[-1]), TRNA_LINE.match(jout.splitlines()[-1])
    assert got and want, (out, jout)
    assert got.group(1) == want.group(1) == "real-mRNA-fixture (wrong chemistry)"
    # pass=n/N, B and L equal
    assert got.group(4, 5, 7, 8) == want.group(4, 5, 7, 8)
    assert 0 < int(got.group(4)) < int(got.group(5))


def test_bench_trna_real_without_fixtures_exits_with_the_jax_message(tmp_path):
    from warpdemux_tpu_torch.tools.bench_trna import fixture_reads

    with pytest.raises(SystemExit, match=r"--real: no small_pod5_\*\.pod5 fixtures in .*set WDX_FIXTURE_DIR"):
        fixture_reads(4, 100, tmp_path)


def test_in_turns_takes_the_paths_in_turns():
    from warpdemux_tpu_torch.tools import _throughput

    calls = []

    class Out:
        def __init__(self, n):
            self.pred = torch.zeros(n, dtype=torch.int32)
            self.conf = torch.zeros(n)
            self.success = torch.arange(n) % 2 == 0

    def step_of(name):
        def step(x):
            calls.append(name)
            return Out(len(x))
        return step

    staged = _throughput.stage([(np.zeros(5),)] * 3, torch.device("cpu"))
    rates = _throughput.in_turns({"a": _throughput.Path(step_of("a"), staged),
                                  "b": _throughput.Path(step_of("b"), staged, fetchers=2)}, rounds=3)
    assert calls == ["a", "b"] + ["a"] * 3 + ["b"] * 3 + ["a"] * 3 + ["b"] * 3 + ["a"] * 3 + ["b"] * 3
    for r in rates.values():
        assert r.calls == 10 and len(r.rounds) == 3 and r.n_pass == 9 and r.launches == {}
        assert r.median == sorted(r.rounds)[1] and r.first_s > 0
    with pytest.raises(ValueError):
        _throughput.in_turns({"a": _throughput.Path(step_of("a"), staged)}, rounds=0)
