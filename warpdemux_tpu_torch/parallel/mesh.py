"""The devices of one host that a run spreads over.

Counterpart of warpdemux_tpu/parallel/mesh.py. The reference's only
scaling axis is data parallelism over reads (a process pool,
file_proc.py:1197-1245). The JAX package splits each minibatch's rows over
a mesh of devices inside one process; the port runs one process a device
instead (parallel/multihost.run_workers), each over its own share of the
pod5 files. The step is bound by its host thread (some 1,870 launches a
minibatch, and the Wu-Lin loop reads the device at every head), so rows
split over cards from one process ran slower than one card (PERF.md
section 6); processes do not share a host thread.

A "mesh" here is the list of torch devices those processes run on, one
entry a process.
"""

from __future__ import annotations

import torch


def make_mesh(n_devices: int | None = None, device_type: str = "cuda") -> list[torch.device]:
    """The devices of a run's processes, one a process.

    CUDA: the distinct cards cuda:0 .. cuda:n-1; None or 0 means every
    card, and a request is capped at torch.cuda.device_count().
    CPU: n entries of the CPU device (None or 0: one)."""
    if device_type == "cuda":
        avail = torch.cuda.device_count()
        if avail == 0:
            raise RuntimeError("no CUDA device: pass device_type='cpu' for a mesh of the CPU")
        n = avail if not n_devices else min(n_devices, avail)
        return [torch.device("cuda", i) for i in range(n)]
    if device_type != "cpu":
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    return [torch.device("cpu")] * (n_devices or 1)
