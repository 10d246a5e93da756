"""The live lane's tools on the port (warpdemux_tpu_torch/tools/
live_latency.py and live_soak.py), run as subprocesses on the CPU at a
small size (`--device cpu`, torch on one thread: several test workers
share this host's cores), and the soak report against the JAX soak
tool's (tools/live_soak.py) on the same seed.

The soak runs 600 reads, not fewer: the 15% RSS rule compares the peak
RSS at a third of the decisions with the last, and at 300 reads the
classifier threads were still growing their allocator arenas past the
third (15.4% in one of three runs).

The twins of tests/test_live_soak.py: the 12,000-read soak (`slow`, as
in JAX) and the decision budget on the card (`cuda`; its round-trip probe
is a torch copy to the card and back).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}
STAGES = {"queue", "segmentation", "classification", "total"}
SOAK_READS = 600
# counts of the soak report that do not depend on thread timing
TIMING_FREE = ("reads", "decided", "csv_rows", "skip_stats", "latency_reservoir_cap",
               "balance_table_lines", "balancer_stats_files")


def run_tool(args, timeout=600, env=ENV):
    return subprocess.run([sys.executable, *args], capture_output=True, text=True, timeout=timeout, cwd=REPO, env=env)


def soak_report(args, timeout=600):
    out = run_tool(args, timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def latency_table(stdout):
    rows = [line.split("|")[1:-1] for line in stdout.splitlines() if line.startswith("| ") and "stage" not in line]
    return {cells[0].strip(): [float(c) for c in cells[1:]] for cells in rows}


@pytest.fixture(scope="module")
def port_soak():
    return soak_report(["-m", "warpdemux_tpu_torch.tools.live_soak", "--reads", str(SOAK_READS), "--device", "cpu"])


def test_latency_tool_prints_every_stage_and_the_budget_line():
    out = run_tool(["-m", "warpdemux_tpu_torch.tools.live_latency", "--reads", "120", "--channels", "24",
                    "--device", "cpu"])
    assert out.returncode == 0, out.stderr[-3000:]
    assert "# device=cpu reads=120 channels=24 wall=" in out.stdout
    table = latency_table(out.stdout)
    assert set(table) == STAGES
    assert table["total"][0] == 120  # every read decided
    for stage, (n, p50, p90, p99, top) in table.items():
        assert 0 <= p50 <= p90 <= p99 <= top, stage
    verdict = [line for line in out.stdout.splitlines() if line.startswith("# p99 decision latency")]
    assert len(verdict) == 1 and verdict[0].endswith(("PASS", "FAIL"))


def test_soak_report_is_complete_and_memory_flat(port_soak):
    rep = port_soak
    assert rep["reads"] == rep["decided"] == rep["csv_rows"] == SOAK_READS
    assert STAGES == set(rep["latency_stages"])
    assert rep["balancer_stats_files"] == ["balancer_stats_soak.csv"]
    for key in ("missed_reads", "too_long_reads", "not_real_read", "no_polya_yet", "missed_obs_n"):
        assert key in rep["skip_stats"]
    assert rep["lat_samples_final"] <= rep["latency_reservoir_cap"] * len(rep["latency_stages"])
    assert rep["crud_channels_final"] <= 126
    assert rep["device"] == "cpu" and rep["device_mb_final"] is None
    growth = rep["rss_mb_final"] / rep["rss_mb_third"] - 1.0
    assert growth < 0.15, (rep["rss_mb_third"], rep["rss_mb_final"])


def test_soak_report_equals_the_jax_tools_on_the_same_seed(port_soak):
    """Every count that thread timing cannot move, and every key of the
    JAX report; the port's lane reports one stage more (`queue`, the wait
    for a classifier thread) and the device's memory beside the RSS."""
    jax_rep = soak_report([str(REPO / "tools" / "live_soak.py"), "--reads", str(SOAK_READS)])
    assert set(jax_rep) <= set(port_soak)
    assert set(port_soak) - set(jax_rep) == {
        "device", "device_mb_third", "device_mb_final", "device_max_mb_third", "device_max_mb_final"}
    for key in TIMING_FREE:
        assert port_soak[key] == jax_rep[key], key
    assert set(port_soak["latency_stages"]) == set(jax_rep["latency_stages"]) | {"queue"}


@pytest.mark.parametrize("tool", ["live_latency", "live_soak"])
def test_tools_need_the_card_unless_told(tool, monkeypatch):
    import importlib

    module = importlib.import_module(f"warpdemux_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--reads", "4"])


@pytest.mark.slow
def test_live_soak_memory_flat_and_reports_complete():
    rep = soak_report(["-m", "warpdemux_tpu_torch.tools.live_soak", "--reads", "12000", "--device", "cpu"],
                      timeout=1200)
    assert rep["reads"] == rep["decided"] == rep["csv_rows"] == 12000
    assert {"segmentation", "classification", "total"} <= set(rep["latency_stages"])
    assert rep["balancer_stats_files"]
    for key in ("missed_reads", "too_long_reads", "not_real_read", "no_polya_yet", "missed_obs_n"):
        assert key in rep["skip_stats"]
    assert rep["lat_samples_final"] <= rep["latency_reservoir_cap"] * len(rep["latency_stages"])
    assert rep["crud_channels_final"] <= 126
    growth = rep["rss_mb_final"] / rep["rss_mb_third"] - 1.0
    assert growth < 0.15, (rep["rss_mb_third"], rep["rss_mb_final"])


@pytest.mark.cuda
def test_live_decision_budget_on_device():
    """p99 decision latency within one 100 ms chunk period at a channel
    count of 24, on the card. As its JAX twin, it runs only when asked
    (WDX_LIVE_BUDGET_TESTS=1): the port's lane does not meet the budget yet
    with the configured four classifier threads (p99 276.5 ms on an H100,
    ROADMAP queue 1 item 15). The round trip of a small copy to the card
    and back is probed first; where it alone exceeds 5 ms the budget is a
    statement about the link, and the test skips with the measurement."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    if not os.environ.get("WDX_LIVE_BUDGET_TESTS"):
        pytest.skip("the decision budget is pinned on request: set WDX_LIVE_BUDGET_TESTS=1")
    probe = run_tool(["-c", (
        "import time, torch\n"
        "x = torch.zeros(8)\n"
        "(x.cuda() + 1).cpu()\n"
        "ts = []\n"
        "for _ in range(10):\n"
        "    t0 = time.perf_counter(); (x.cuda() + 1).cpu(); ts.append(time.perf_counter() - t0)\n"
        "print(f'RT_MS={sorted(ts)[5] * 1e3:.3f}')\n"
    )], timeout=300, env=os.environ)
    assert probe.returncode == 0, probe.stdout + probe.stderr
    rt_ms = float(probe.stdout.split("RT_MS=")[1].split()[0])
    if rt_ms > 5.0:
        pytest.skip(f"round trip {rt_ms:.1f} ms: the link alone exceeds the budget's order")
    out = run_tool(["-m", "warpdemux_tpu_torch.tools.live_latency", "--reads", "120", "--channels", "24",
                    "--assert-budget"], timeout=1800, env=os.environ)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
