"""The port's runs over several processes, on the CPU.

- Two processes join a gloo group over a local address: each takes its
  round-robin share of the files and its host tag, and
  `global_class_counts` sums distinct vectors (the twin of
  tests/test_multihost_2proc.py::test_two_process_distributed_counts).
- Two processes run the port's CLI (`demux --device cpu --coordinator ...
  --num-processes 2 --process-id i`) over the two files of
  tests/test_torch_run_cli.py's 122-read pod5 set: merged and sorted by
  read id, the predictions and failed_reads rows equal those of one
  process byte for byte; the shards carry h000_ / h001_; each log has a
  `GLOBAL (2 hosts)` line whose counts equal the one-process totals.
- `-j 4 --device cpu` (four worker processes on the CPU, two of them
  without a file) writes the one-process run's rows byte for byte, in
  shards tagged with the workers' ranks (the twin of
  tests/test_sharded_e2e.py); with `-b 50 -j 3` every read is written
  once.
- Two CLI processes of `-j 2` each at one coordinator: one group of four
  workers, the one-process run's rows, `GLOBAL (4 hosts)`.
- `continue` of a `-j 2` run whose last shard was deleted runs its workers
  again and ends with the one-process run's rows.
- `--coordinator env` (torchrun: one process a card) with `-j 2` exits.
"""

import re
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from test_torch_run_cli import COMMON, gunzip, shard_names, write_fixture  # noqa: E402

TIMEOUT_S = 300
SUMMARY = re.compile(r"(\d+) reads \((\d+) pass / (\d+) fail / (\d+) predicted\)")

COUNTS_WORKER = textwrap.dedent(
    """
    import os, sys
    sys.path.insert(0, os.getcwd())
    import numpy as np
    from warpdemux_tpu_torch.parallel.multihost import (
        global_class_counts, host_shard_tag, init_distributed, shard_files,
    )

    coord, pid = sys.argv[1], int(sys.argv[2])
    assert init_distributed(coord, 2, pid) == (pid, 2)
    assert init_distributed() == (pid, 2)
    files = [f"f{i}.pod5" for i in range(7)]
    mine = shard_files(files)
    # round-robin: process 0 gets 0, 2, 4, 6; process 1 gets 1, 3, 5
    want = [f for i, f in enumerate(files) if i % 2 == pid]
    assert mine == want, (mine, want)
    assert host_shard_tag() == f"h{pid:03d}"
    local = np.arange(5, dtype=np.int32) + 10 * (pid + 1)  # distinct a process
    total = global_class_counts(local)
    assert total.dtype == np.int32, total.dtype
    want_total = (np.arange(5) + 10) + (np.arange(5) + 20)
    assert (total == want_total).all(), (total, want_total)
    import torch.distributed as dist
    dist.destroy_process_group()
    print(f"proc {pid} ok: {total.tolist()}")
    """
)

CLI_WORKER = textwrap.dedent(
    """
    import os, sys
    sys.path.insert(0, os.getcwd())
    import torch
    from warpdemux_tpu_torch.cli import main
    if __name__ == "__main__":  # -j's workers are spawned: they import this file
        torch.set_num_threads(2)  # the test workers share the machine's cores
        sys.exit(main(sys.argv[1:]))
    """
)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def free_address() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def run_processes(argvs) -> list[str]:
    """Run the commands at once; their outputs, each having exited 0."""
    procs = [
        subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for argv in argvs
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-3000:]}"
    return outs


def csv_rows(run: Path, sub: str) -> tuple[set[str], list[str]]:
    """(the headers, the rows) of a run's CSV shards of one kind, the rows
    sorted by read id."""
    headers, rows = set(), []
    for name in shard_names(run, sub):
        header, *body = gunzip(run / sub / name).splitlines()
        headers.add(header)
        rows += body
    return headers, sorted(rows)


def port_cli(*argv):
    from warpdemux_tpu_torch.cli import main

    assert main([*map(str, argv), "--device", "cpu"]) == 0


def same_rows(run: Path, one: Path):
    """The merged predictions and failed_reads rows of `run` are those of
    `one`, byte for byte."""
    for sub in ("predictions", "failed_reads"):
        assert csv_rows(run, sub) == csv_rows(one, sub), sub


@pytest.fixture(scope="module")
def pod5_set(tmp_path_factory):
    d = tmp_path_factory.mktemp("pod5_set")
    return d, write_fixture(d)


@pytest.fixture(scope="module")
def one_process(pod5_set, tmp_path_factory):
    d, _ = pod5_set
    out = tmp_path_factory.mktemp("one") / "run"
    port_cli("demux", "-i", d, "-o", out, *COMMON)
    return out


def test_two_process_distributed_counts(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(COUNTS_WORKER)
    coord = free_address()
    outs = run_processes([[sys.executable, str(script), coord, str(pid)] for pid in (0, 1)])
    for pid, out in enumerate(outs):
        assert f"proc {pid} ok: [30, 32, 34, 36, 38]" in out, out


def test_two_process_cli_demux_matches_one_process(pod5_set, one_process, tmp_path):
    d, ids = pod5_set
    script = tmp_path / "cli_worker.py"
    script.write_text(CLI_WORKER)
    out = tmp_path / "run2"
    coord = free_address()
    outs = run_processes([
        [sys.executable, str(script), "demux", "-i", str(d), "-o", str(out), *COMMON, "--device", "cpu",
         "--coordinator", coord, "--num-processes", "2", "--process-id", str(pid)]
        for pid in (0, 1)
    ])
    for sub in ("predictions", "failed_reads"):
        names = shard_names(out, sub)
        assert {n for n in names if "_h000_" in n} and {n for n in names if "_h001_" in n}, names
        assert all("_h000_" in n or "_h001_" in n for n in names), names
        assert csv_rows(out, sub) == csv_rows(one_process, sub), sub
    n_rows = sum(len(csv_rows(out, sub)[1]) for sub in ("predictions", "failed_reads"))
    assert n_rows == len(ids) == 122

    log = (one_process / "warpdemux.log").read_text()
    want = SUMMARY.search(log.split("demux done: ")[1]).groups()
    want_classes = re.search(r"class counts \([^)]*\): ([\d/]+)", log).group(1)
    assert int(want[0]) == 122
    for pid, text in enumerate(outs):
        assert f"process {pid}/2" in text, text[-2000:]
        line = re.search(r"GLOBAL \(2 hosts\): (.*)", text)
        assert line, text[-2000:]
        assert SUMMARY.search(line.group(1)).groups() == want, (line.group(0), want)
        assert line.group(1).endswith(f" class counts {want_classes}"), (line.group(0), want_classes)


def test_four_shards_write_the_one_device_runs_files(pod5_set, one_process, tmp_path, capsys):
    d, ids = pod5_set
    out = tmp_path / "j4"
    port_cli("demux", "-i", d, "-o", out, *COMMON, "-j", "4")
    assert "done (4 processes): 122 reads" in capsys.readouterr().out
    same_rows(out, one_process)
    for sub in ("predictions", "failed_reads"):  # two files: the workers of rank 2 and 3 have none
        assert {n.split("_h")[1][:3] for n in shard_names(out, sub)} == {"000", "001"}, sub
    log = (out / "warpdemux.log").read_text()
    assert log.count("GLOBAL (4 hosts): 122 reads") == 4, log[-3000:]


def test_workers_write_every_read_once(pod5_set, tmp_path):
    d, ids = pod5_set
    out = tmp_path / "j3"
    port_cli("demux", "-i", d, "-o", out, *COMMON, "-b", "50", "-j", "3")  # the last -b holds
    written = [row.split(",")[0] for sub in ("predictions", "failed_reads") for row in csv_rows(out, sub)[1]]
    assert sorted(written) == sorted(ids)


def test_two_hosts_of_two_workers_match_one_process(pod5_set, one_process, tmp_path):
    d, _ = pod5_set
    script = tmp_path / "cli_worker.py"
    script.write_text(CLI_WORKER)
    out = tmp_path / "hosts"
    coord = free_address()
    outs = run_processes([
        [sys.executable, str(script), "demux", "-i", str(d), "-o", str(out / f"host{pid}"), *COMMON,
         "--device", "cpu", "-j", "2", "--coordinator", coord, "--num-processes", "2", "--process-id", str(pid)]
        for pid in (0, 1)
    ])
    runs = [out / f"host{pid}" for pid in (0, 1)]
    for sub in ("predictions", "failed_reads"):
        merged = sorted(row for run in runs for row in csv_rows(run, sub)[1])
        assert merged == csv_rows(one_process, sub)[1], sub
    for pid, text in enumerate(outs):
        assert text.count("GLOBAL (4 hosts): 122 reads") == 2, text[-3000:]
        assert f"process {2 * pid}/4" in text and f"process {2 * pid + 1}/4" in text, text[-3000:]


def test_continue_of_a_two_worker_run(pod5_set, one_process, tmp_path):
    from warpdemux_tpu_torch.cli import main

    d, _ = pod5_set
    out = tmp_path / "cont"
    port_cli("demux", "-i", d, "-o", out, *COMMON, "-j", "2")
    last = sorted((out / "predictions").glob("*_h001_*.csv.gz"))[-1]
    last.unlink()
    assert main(["continue", str(out), "--device", "cpu"]) == 0
    same_rows(out, one_process)


def test_coordinator_env_with_workers_exits(pod5_set, tmp_path):
    from warpdemux_tpu_torch.cli import main

    d, _ = pod5_set
    with pytest.raises(SystemExit, match="torchrun starts one process a card"):
        main(["demux", "-i", str(d), "-o", str(tmp_path / "out"), *COMMON, "--device", "cpu",
              "--coordinator", "env", "-j", "2"])
