"""Multi-process data parallelism: a disjoint share of the pod5 files a
process, and run counters summed over every process.

Port of warpdemux_tpu/parallel/multihost.py on torch.distributed:

- each process reads a disjoint subset of the pod5 inputs (files are the
  shard unit; `shard_files` deals them round-robin),
- every process runs the same demux step over its minibatches on its own
  device: `run_workers` starts one process a local device (`-j`), and
  several hosts each start theirs into one group (`--coordinator`),
- the run's counters come back through one all-reduce (`global_class_counts`),
  the analog of the reference's Manager-lock shared counters,
- outputs stay with their process: CSV / npz shards named with the
  process's tag (`host_shard_tag`), like the reference's per-process
  bidx shards.

The collective backend is gloo, always. What crosses processes is one
small vector of host counters a run, and the JAX function takes and gives
numpy too (warpdemux_tpu/parallel/multihost.py:70-90); NCCL would reduce
device tensors only, and needs a card a rank, while two processes of a
one-card host share it.
"""

from __future__ import annotations

import socket
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKEND = "gloo"


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> tuple[int, int]:
    """Join the process group; returns (process index, process count).

    coordinator=None joins nothing: (0, 1), or the rank and world size of
    a group this process is already in. "host:port" is process 0's
    rendezvous address, with `num_processes` and `process_id` given; "env"
    reads MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE, the environment
    torchrun sets (the counterpart of JAX's pod autodetection)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator is None:
        return 0, 1
    if coordinator == "env":
        dist.init_process_group(BACKEND, init_method="env://")
    else:
        dist.init_process_group(
            BACKEND, init_method=f"tcp://{coordinator}", rank=process_id,
            world_size=num_processes,
        )
    return dist.get_rank(), dist.get_world_size()


def shard_files(
    files: list[str], process_index: int | None = None, process_count: int | None = None,
) -> list[str]:
    """This process's share of the input files (round-robin, deterministic)."""
    pi, pc = init_distributed()
    pi = pi if process_index is None else process_index
    pc = pc if process_count is None else process_count
    return [f for i, f in enumerate(files) if i % pc == pi]


def host_shard_tag(process_index: int | None = None) -> str:
    """Prefix of output shard names so that processes never collide."""
    pi = init_distributed()[0] if process_index is None else process_index
    return f"h{pi:03d}"


def global_class_counts(local_counts: np.ndarray) -> np.ndarray:
    """Sum (k + 1,) integer counters over every process of the group.

    One process: the input, unchanged. Otherwise one all-reduce (SUM) of an
    int64 copy; the result comes back in the input's dtype."""
    local = np.asarray(local_counts)
    if init_distributed()[1] == 1:
        return local
    total = torch.from_numpy(local.astype(np.int64))
    dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return total.numpy().astype(local.dtype)


def local_address() -> str:
    """A free TCP address of this host, for a group of its own processes."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{sock.getsockname()[1]}"


def run_workers(fn, args, devices, coordinator=None, num_hosts=1, host_id=0) -> list:
    """Run fn(device, *args) in one process a device of `devices`, all in
    one gloo group; their results in device order.

    Worker i of host `host_id` takes rank host_id * len(devices) + i of the
    group of num_hosts * len(devices) processes that meets at
    `coordinator` (host:port; a free address of this host where None).
    Every host runs as many workers. On a card the worker makes it its
    current device; on the CPU it takes this process's thread count, as a
    product's last bits follow the thread count. The workers are spawned:
    fn and args are pickled, and fn's result should be small. A worker
    that fails stops the others and raises here, with the error of the
    worker that failed first (its peers' collectives fail after it)."""
    n = len(devices)
    results = mp.get_context("spawn").SimpleQueue()
    context = mp.start_processes(
        _worker,
        args=(fn, args, devices, coordinator or local_address(), num_hosts * n, host_id * n,
              torch.get_num_threads(), results),
        nprocs=n, join=False, start_method="spawn",
    )
    try:
        while not context.join():
            pass
    except mp.ProcessRaisedException:
        # the first process found dead may be a peer whose collective the
        # failing worker reset; each worker puts its error before it leaves
        # the group, so the first error put is the cause
        errors = []
        while not results.empty():
            i, ok, value = results.get()
            if not ok:
                errors.append((i, value))
        if not errors:
            raise
        i, trace = errors[0]
        raise RuntimeError(f"worker {i} failed:\n{trace}") from None
    got = {i: value for i, _, value in (results.get() for _ in range(n))}
    return [got[i] for i in range(n)]


def _worker(i, fn, args, devices, coordinator, world, rank0, threads, results):
    """Process i of run_workers."""
    device = devices[i]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(threads)
    init_distributed(coordinator, world, rank0 + i)
    try:
        results.put((i, True, fn(device, *args)))
    except BaseException:
        results.put((i, False, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()
