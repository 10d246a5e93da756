"""The port's `prep` and `predict` (`--device cpu`) against the JAX CLI's on
the synthetic pod5 set of tests/test_torch_run_cli.py (`-b 48
--batch_size_output 40 --no-create_subdir --save_dwell_time`).

- boundaries and failed_reads: the same shard files, columns in the JAX
  order; every cell equal as text, the region means and stds included
  (summed in XLA's order);
- fingerprints: the same npz files, `read_ids` and `dwell_times` equal,
  `signals` bit-equal;
- a port prep directory predicted by the JAX CLI and by the port's: the
  same predictions, by the rules of test_torch_run_cli.same_predictions.
"""

import csv
import gzip
import io
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_torch_run_cli import (  # noqa: E402
    COMMON,
    gunzip,
    jax_cli,
    port_cli,
    read_ids_of,
    same_failed_reads,
    same_predictions,
    shard_names,
    write_fixture,
)


@pytest.fixture(scope="module")
def prep_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pod5_set")
    ids = write_fixture(d)
    out = tmp_path_factory.mktemp("prep")
    port_cli("prep", "-i", d, "-o", out / "port", *COMMON, "--save_dwell_time")
    jax_cli("prep", "-i", d, "-o", out / "jax", *COMMON, "--save_dwell_time")
    return out / "port", out / "jax", ids


def _table(path):
    rows = list(csv.reader(io.StringIO(gunzip(path))))
    return rows[0], rows[1:]


@pytest.mark.parametrize("sub", ["boundaries", "failed_reads"])
def test_prep_summary_shards_equal_jax(prep_runs, sub):
    port, ref, _ = prep_runs
    names = shard_names(ref, sub)
    assert names and shard_names(port, sub) == names
    for name in names:
        p_head, p_rows = _table(port / sub / name)
        r_head, r_rows = _table(ref / sub / name)
        assert p_head == r_head and len(p_rows) == len(r_rows)
        for j, col in enumerate(r_head):
            assert [r[j] for r in p_rows] == [r[j] for r in r_rows], (name, col)
    if sub == "boundaries":
        assert "fail_reason" not in r_head and r_head[:3] == ["read_id", "signal_len", "preloaded"]
        assert "cnn_fail_reason" in r_head and "llr_fail_reason" in r_head


def test_prep_fingerprints_equal_jax(prep_runs):
    port, ref, ids = prep_runs
    names = sorted(p.name for p in (ref / "fingerprints").glob("*.npz"))
    assert names and sorted(p.name for p in (port / "fingerprints").glob("*.npz")) == names
    for name in names:
        with np.load(port / "fingerprints" / name, allow_pickle=True) as a, np.load(
            ref / "fingerprints" / name, allow_pickle=True
        ) as b:
            assert sorted(a.files) == sorted(b.files) == ["dwell_times", "num_reads", "read_ids", "signals"]
            assert a["read_ids"].tolist() == b["read_ids"].tolist()
            assert int(a["num_reads"]) == int(b["num_reads"])
            np.testing.assert_array_equal(a["dwell_times"], b["dwell_times"])
            assert a["signals"].dtype == b["signals"].dtype
            assert a["signals"].tobytes() == b["signals"].tobytes()  # bit-equal
    # every read once in fingerprints or failed_reads, and the boundaries
    # rows are the fingerprint rows
    fpt_ids = []
    for name in names:
        with np.load(port / "fingerprints" / name, allow_pickle=True) as z:
            fpt_ids += z["read_ids"].tolist()
    assert fpt_ids == read_ids_of(port, "boundaries")
    assert sorted(fpt_ids + read_ids_of(port, "failed_reads")) == sorted(ids)


def test_port_prep_predicted_by_either_cli(prep_runs, tmp_path):
    port, _, _ = prep_runs
    by_port, by_jax = tmp_path / "by_port", tmp_path / "by_jax"
    shutil.copytree(port, by_port)
    shutil.copytree(port, by_jax)
    port_cli("predict", by_port)
    jax_cli("predict", by_jax)
    same_predictions(by_port, by_jax)
    same_failed_reads(by_port, by_jax)
    assert sorted(read_ids_of(by_port, "predictions")) == sorted(read_ids_of(port, "boundaries"))
    # the prep's failed_reads are untouched (no fingerprint was non-finite)
    assert shard_names(by_port, "failed_reads") == shard_names(port, "failed_reads")
