"""The port's profiling tools (warpdemux_tpu_torch/tools/profile_step_trace,
profile_detect_trace, profile_stages) on the CPU: each runs as a module
with `--device cpu` at B = 16 and prints tables that parse; without a card
and without `--device cpu` each exits non-zero; and the chain of stages
that profile_stages times computes what the vbz full step computes.

The `cuda` tests run the traces on the card: every kernel of csrc/ that a
path launches is in its trace, with the calls a step that chip_smoke.py
pins for that path."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

TOOLS = {
    "profile_step_trace": ["16", "decision"],
    "profile_detect_trace": ["16"],
    "profile_stages": ["16"],
}


def start_tool(name, *args):
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}  # torch on one thread
    return subprocess.Popen([sys.executable, "-m", f"warpdemux_tpu_torch.tools.{name}", *args], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs():
    """Each tool run once with `--device cpu` (one traced call) and once
    with neither a card nor `--device cpu`, all six processes started
    together; name -> (cpu run, run without a device), each (returncode,
    stdout, stderr)."""
    procs = {name: (start_tool(name, *args, "--reps", "1", "--device", "cpu"), start_tool(name, *args))
             for name, args in TOOLS.items()}
    done = {}
    for name, pair in procs.items():
        done[name] = []
        for proc in pair:
            out, err = proc.communicate(timeout=300)
            done[name].append((proc.returncode, out, err))
    return done


def table_rows(stdout):
    """The rows of the markdown table in `stdout` (header and rules left out)."""
    rows = [line.strip("|").split("|") for line in stdout.splitlines() if line.startswith("| ")]
    return [[c.strip() for c in row] for row in rows[1:]]


@pytest.mark.parametrize("name", ["profile_step_trace", "profile_detect_trace"])
def test_trace_tool_prints_its_tables_on_the_cpu(runs, name):
    rc, stdout, stderr = runs[name][0]
    assert rc == 0, stderr
    wall = float(re.search(r"wall: ([\d.]+) ms/minibatch", stdout).group(1))
    busy = re.search(r"# device busy ([\d.]+) ms/call; idle share ([-\d.]+)", stdout)
    assert wall > 0 and float(busy.group(1)) > 0 and float(busy.group(2)) < 1
    rows = table_rows(stdout)
    assert 10 <= len(rows) <= (30 if name == "profile_step_trace" else 40)
    for op, ms, calls, share, _ in rows:
        assert op.startswith("aten::") and float(ms) >= 0 and int(calls) >= 1 and 0 <= float(share) <= 100
    assert sum(float(row[3]) for row in rows) <= 100.5


def test_profile_stages_prints_its_table_on_the_cpu(runs):
    rc, stdout, stderr = runs["profile_stages"][0]
    assert rc == 0, stderr
    rows = [row for row in table_rows(stdout) if not row[0].startswith("---")]
    names = [row[0] for row in rows]
    assert names == ["vbz decode", "detect", "fingerprint", "dtw (B x 851)", "svm proba", "extract_adapter_batch",
                     "clip_outliers_prefix", "windowed_t_test", "peak_mask_batch", "suppress_by_distance",
                     "select_top_peaks", "segment_means", "svm decision_values", "svm probabilities"]
    assert all(float(ms) > 0 and float(rate) > 0 and launches == "" for _, ms, rate, launches in rows)


@pytest.mark.parametrize("name", TOOLS)
def test_tool_without_a_card_and_without_device_cpu_exits_non_zero(runs, name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    rc, _, stderr = runs[name][1]
    assert rc != 0 and "no CUDA device" in stderr


def test_profile_stages_times_the_steps_computation():
    """The chain of stages profile_stages times gives the vbz full step's
    pred, conf, probs, fingerprints and success on the same reads."""
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.pipeline.step import make_demux_step
    from warpdemux_tpu_torch.tools import _trace
    from warpdemux_tpu_torch.tools.profile_stages import stage_table

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        chain = stage_table(16, "cpu", reps=1).outputs
        adc, offset, scale, lens = _trace.bench_minibatch(16)
        step = make_demux_step(load_model(_trace.MODEL, "cpu"), get_model_spc_config(_trace.MODEL),
                               input_format="vbz", outputs="full", device="cpu")
        want = step(*_trace.vbz_pack(adc), offset, scale, lens).unpack()
    finally:
        torch.set_num_threads(threads)
    assert want.success.sum() >= 8  # the chain is held on rows that classify
    for key, ref in (("pred", want.pred), ("conf", want.conf), ("probs", want.probs), ("fpt", want.fpt.fpt),
                     ("fpt_ok", want.fpt.ok), ("success", want.success)):
        got = chain[key].numpy()
        if got.dtype == np.float32:
            np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32), err_msg=key)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=key)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; the csrc/ kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("feed, outputs, path", [("adc", "decision", "adc_decision"), ("vbz", "full", "vbz_full")])
def test_step_trace_lists_the_pinned_kernels(dev, feed, outputs, path):
    from chip_smoke import KERNELS, LAUNCHES
    from warpdemux_tpu_torch.tools.profile_step_trace import profile_step

    trace = profile_step(1000, outputs, feed, dev, reps=2)
    pinned = {key: n for key, n in zip(KERNELS, LAUNCHES[path]) if n}
    assert trace.kernel_calls() == pinned
    assert trace.busy_ms > 0


@pytest.mark.cuda
def test_stage_table_launches_dtw_and_svm_kernels_once_a_call(dev):
    from warpdemux_tpu_torch.tools.profile_stages import stage_table

    stages = {s.name: s.launches for s in stage_table(1000, dev, reps=2).stages}
    assert stages["dtw (B x 851)"] == {"wdx_dtw": 1}
    assert stages["svm proba"] == {"wdx_svm_dot": 1, "wdx_svm_probs": 1}
