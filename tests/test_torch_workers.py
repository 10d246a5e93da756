"""parallel/multihost.run_workers on the CPU: one spawned process a device,
all in one gloo group.

- each worker gets its rank, the group's size, its device and this
  process's torch thread count; the all-reduce sums over the workers;
  shard_files and host_shard_tag follow the rank;
- two "hosts" (two run_workers calls at one coordinator) form one group of
  their workers, ranks host_id * n + i;
- a worker that fails stops the others, also one waiting in the
  all-reduce, and the call raises with the worker's error.

The module holds only light imports: every worker imports it again.
"""

import os
import threading

import numpy as np
import pytest
import torch

FILES = [f"f{i}.pod5" for i in range(7)]


def report(device, scale):
    """A worker's view of itself and of the group."""
    from warpdemux_tpu_torch.parallel.multihost import (
        global_class_counts, host_shard_tag, init_distributed, shard_files,
    )

    rank, world = init_distributed()
    total = global_class_counts(np.full(3, scale * (rank + 1), np.int32))
    return rank, world, str(device), torch.get_num_threads(), total.tolist(), host_shard_tag(), shard_files(FILES), os.getpid()


def fail_before_the_reduce(device):
    """Rank 1 raises; rank 0 waits in the all-reduce for it."""
    from warpdemux_tpu_torch.parallel.multihost import global_class_counts, init_distributed

    if init_distributed()[0] == 1:
        raise ValueError("rank one fails")
    return global_class_counts(np.ones(2, np.int64)).tolist()


@pytest.mark.parametrize("n", [1, 2, 3])
def test_run_workers_one_rank_a_device(n):
    threads = torch.get_num_threads()
    got = run(report, (10,), n)
    assert [r[0] for r in got] == list(range(n))
    assert len({r[7] for r in got} | {os.getpid()}) == n + 1  # a process each
    for rank, (_, world, device, t, total, tag, files, _) in enumerate(got):
        assert (world, device, t) == (n, "cpu", threads)
        assert total == [10 * n * (n + 1) // 2] * 3
        assert tag == f"h{rank:03d}"
        assert files == FILES[rank::n]


def test_two_hosts_share_one_group():
    """Two run_workers calls of two workers each, at one coordinator, as two
    hosts would make them: ranks 0-3 in one group of four."""
    from warpdemux_tpu_torch.parallel.multihost import local_address, run_workers

    address = local_address()
    got = {}

    def host(h):
        got[h] = run_workers(report, (1,), [torch.device("cpu")] * 2, address, 2, h)

    hosts = [threading.Thread(target=host, args=(h,)) for h in (0, 1)]
    for t in hosts:
        t.start()
    for t in hosts:
        t.join(timeout=300)
    assert sorted(got) == [0, 1]
    for h in (0, 1):
        for i, (rank, world, _, _, total, tag, files, _) in enumerate(got[h]):
            assert (rank, world, tag) == (2 * h + i, 4, f"h{2 * h + i:03d}")
            assert total == [1 + 2 + 3 + 4] * 3
            assert files == FILES[rank::4]


def test_a_failing_worker_stops_the_others():
    with pytest.raises(Exception, match="rank one fails"):
        run(fail_before_the_reduce, (), 2)


def run(fn, args, n):
    from warpdemux_tpu_torch.parallel.multihost import run_workers

    return run_workers(fn, args, [torch.device("cpu")] * n)
