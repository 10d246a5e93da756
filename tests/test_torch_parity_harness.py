"""The port's parity harness (warpdemux_tpu_torch/tools/parity_vs_reference)
against the JAX tool's (tools/parity_vs_reference.py): on each synthetic
run-directory case of tests/test_parity_harness.py, and on a few more
(several shards, missing columns, empty runs), the port's `diff_runs`,
which reads the shards with csv and gzip, returns the report the JAX
tool's pandas `diff_runs` returns. The reference environment is absent
here, so the probe must say so, and the command line keeps the JAX tool's
exit codes."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import parity_vs_reference as jax_tool  # noqa: E402

from warpdemux_tpu_torch.tools import parity_vs_reference as port_tool  # noqa: E402


def write_run(root: Path, preds, fails, rid_col="#read_id", pcols=("p03",), fail_col="fail_reason", shard=0):
    """One shard of predictions and of failed_reads, as the JAX test writes
    them (pandas, gzip'd CSV)."""
    (root / "predictions").mkdir(parents=True, exist_ok=True)
    (root / "failed_reads").mkdir(parents=True, exist_ok=True)
    df = pd.DataFrame(preds, columns=[rid_col, "predicted_barcode", "confidence_score"])
    for k, c in enumerate(pcols):
        df[c] = 0.5 - 0.125 * k * np.arange(len(df))
    df.to_csv(root / "predictions" / f"barcode_predictions_{shard}.csv.gz", index=False, compression="gzip")
    columns = ["read_id", fail_col] if fail_col else ["read_id"]
    pd.DataFrame([f[: len(columns)] for f in fails], columns=columns).to_csv(
        root / "failed_reads" / f"failed_reads_{shard}.csv.gz", index=False, compression="gzip")


def case_identical(tmp):
    preds = [("r1", 3, 0.9), ("r2", -1, 0.1), ("r3", 7, 0.55)]
    fails = [("r4", "adapter too long")]
    write_run(tmp / "a", preds, fails)
    write_run(tmp / "b", preds, fails)


def case_disagreement(tmp):
    write_run(tmp / "a", [("r1", 3, 0.9), ("r2", -1, 0.1), ("r5", 4, 0.8)], [("r4", "no polyA found")])
    write_run(tmp / "b", [("r1", 5, 0.87), ("r2", -1, 0.1)],
              [("r4", "adapter too long"), ("r5", "mvs polya check failed")], rid_col="read_id")


def case_diff_only(tmp):
    write_run(tmp / "a", [("r1", 3, 0.9)], [])
    write_run(tmp / "b", [("r1", 3, 0.9)], [])


def case_read_id_variants(tmp):
    """`read_id` on the reference's side, `#read_id` on the port's, uuid ids."""
    ids = [f"{i:08x}-0000-4000-8000-{i:012x}" for i in range(6)]
    write_run(tmp / "a", [(ids[0], 1, 0.333), (ids[1], 2, 0.25), (ids[2], -1, 0.0)], [(ids[3], "no polyA found")],
              rid_col="read_id")
    write_run(tmp / "b", [(ids[0], 1, 0.334), (ids[2], 4, 0.75), (ids[4], 2, 0.125)],
              [(ids[3], "no polyA found"), (ids[1], "adapter too short")])


def case_shards(tmp):
    """Two shards a side, a probability column only on one side and one in
    one shard of the reference alone, fails without a reason column."""
    write_run(tmp / "a", [("r1", 3, 0.9), ("r2", 5, 0.6)], [("r7", "x")], pcols=("p03", "p05"), shard=0)
    write_run(tmp / "a", [("r3", -1, 0.05)], [("r8", "y")], pcols=("p03",), shard=1)
    write_run(tmp / "b", [("r1", 3, 0.875), ("r3", -1, 0.05)], [("r7",), ("r8",)], pcols=("p03", "p-1"),
              fail_col=None, shard=0)
    write_run(tmp / "b", [("r2", 6, 0.5)], [], pcols=("p03", "p-1"), fail_col=None, shard=1)


def case_empty(tmp):
    """No shard on the port's side; nothing failed on the reference's."""
    write_run(tmp / "a", [("r1", 3, 0.9)], [])
    (tmp / "b").mkdir()


CASES = {f.__name__[5:]: f for f in (case_identical, case_disagreement, case_diff_only, case_read_id_variants,
                                     case_shards, case_empty)}


@pytest.mark.parametrize("name", CASES)
def test_diff_runs_gives_the_jax_tools_report(tmp_path, name):
    CASES[name](tmp_path)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    want = jax_tool.diff_runs(a, b)
    got = port_tool.diff_runs(a, b)
    assert got == want
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def test_check_reference_env_degrades_gracefully(tmp_path):
    ok, msg = port_tool.check_reference_env(sys.executable, str(tmp_path / "absent"))
    assert ok is False and msg
    ok, msg = port_tool.check_reference_env(sys.executable, None)
    assert ok is False and "--reference-repo" in msg


def run_tool(*args):
    return subprocess.run([sys.executable, "-m", "warpdemux_tpu_torch.tools.parity_vs_reference", *map(str, args)],
                          cwd=REPO, capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("name, rc", [("diff_only", 0), ("disagreement", 2)])
def test_cli_diff_only_exit_codes(tmp_path, name, rc):
    CASES[name](tmp_path)
    out = run_tool("--diff-only", tmp_path / "a", tmp_path / "b")
    assert out.returncode == rc, out.stderr
    assert json.loads(out.stdout) == jax_tool.diff_runs(str(tmp_path / "a"), str(tmp_path / "b"))


def test_cli_without_the_reference_env_exits_3(tmp_path):
    out = run_tool("--check-only", "--reference-repo", tmp_path / "absent")
    assert out.returncode == 3 and out.stdout.startswith("reference env UNAVAILABLE")
    out = run_tool("--pod5", tmp_path / "reads.pod5", "--reference-repo", tmp_path / "absent")
    assert out.returncode == 3 and "reference environment unavailable" in out.stderr
