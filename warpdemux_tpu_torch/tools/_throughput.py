"""Reads/s of a demux step over minibatches already on the device.

The shared half of the throughput tools (bench_models, sweep_minibatch,
bench_trna): the JAX tools' fetch-closed pipelined loop
(tools/bench_models.py `measure`) in torch. The inputs are staged on the
device beforehand; the main thread calls the step on each staged
minibatch and queues its output; N fetch threads copy each output's
`pred`, `conf` and `success` to the host. The rate is the reads of the
timed calls over the window from the fetch threads' start to their last
copy. A warm-up call before it, fetched the same way, is the JAX tools'
compile call: it builds the kernels (at the process's first launch) and
is left out of the timing.

`in_turns` measures several paths R times, the paths taken in turns
(A B A B ...), because one pass of a host-bound step lies inside the
host's spread from call to call; its `Rates` hold each round and the
median. On the CPU (`device="cpu"`) the step runs the plain PyTorch path
and the rate is the CPU's, not a device metric.
"""

from __future__ import annotations

import queue
import statistics
import threading
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from warpdemux_tpu_torch import _cuda
from warpdemux_tpu_torch.tools._trace import synchronize
from warpdemux_tpu_torch.utils import synthetic


class Path(NamedTuple):
    """One measured path: the step and the staged minibatches it runs on."""

    step: Callable
    staged: list  # tuples of tensors on the device
    fetchers: int = 4


class Rates(NamedTuple):
    """What `in_turns` gives a path: the warm-up call's seconds, reads/s of
    each round, the passes (`success`) of the first round's calls, the step
    calls made (warm-up included) and the kernels they launched."""

    first_s: float
    rounds: list[float]
    n_pass: int
    calls: int
    launches: dict[str, int]

    @property
    def median(self) -> float:
        return statistics.median(self.rounds)


def stage(batches, device: torch.device) -> list[tuple]:
    """Each minibatch's arrays as tensors on `device`, copied once now."""
    staged = [tuple(torch.as_tensor(np.asarray(a), device=device) for a in b) for b in batches]
    synchronize(device)
    return staged


def stage_minibatches(rng, B: int, n_batches: int, device: torch.device, distinct: int | None = None) -> list[tuple]:
    """`n_batches` minibatches of synth_minibatch(rng, B, 10000), the seed
    minibatch, staged on `device`; with `distinct`, only the first
    `distinct` are drawn and the rest repeat them (each staged copy its own
    memory)."""
    drawn = [synthetic.synth_minibatch(rng, B, synthetic.L) for _ in range(min(n_batches, distinct or n_batches))]
    return stage([drawn[i % len(drawn)] for i in range(n_batches)], device)


def fetch(out) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """pred, conf and success of a step's output on the host."""
    return out.pred.cpu().numpy(), out.conf.cpu().numpy(), out.success.cpu().numpy()


def warm(step, staged) -> float:
    """Seconds of one call on the first minibatch, fetched."""
    t0 = time.perf_counter()
    fetch(step(*staged[0]))
    return time.perf_counter() - t0


def timed(step, staged, fetchers: int = 4) -> tuple[float, int]:
    """(reads/s, passes) of one pass over `staged`: the main thread calls the
    step on each minibatch, `fetchers` threads copy the outputs back."""
    fetchq: queue.Queue = queue.Queue()
    passes = []
    errors = []

    def fetcher():
        while True:
            out = fetchq.get()
            if out is None:
                return
            try:
                passes.append(int(fetch(out)[2].sum()))
            except Exception as e:  # noqa: BLE001 - re-raised on the main thread below
                errors.append(e)

    threads = [threading.Thread(target=fetcher) for _ in range(fetchers)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    try:
        for b in staged:
            fetchq.put(step(*b))
    finally:
        for _ in threads:
            fetchq.put(None)
        for th in threads:
            th.join()
    elapsed = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return sum(len(b[0]) for b in staged) / elapsed, sum(passes)


def in_turns(paths: dict[str, Path], rounds: int = 1) -> dict[str, Rates]:
    """Each path warmed once, then timed `rounds` times, the paths in turns.
    A path's launches are those of its calls (the kernels launch on the
    main thread; the fetch threads only copy)."""
    if rounds < 1:
        raise ValueError(f"rounds must be at least 1, got {rounds}")
    first, rates, n_pass, launches = {}, {name: [] for name in paths}, {}, {}

    def counted(name, fn):
        before = dict(_cuda.launches)
        result = fn()
        after = dict(_cuda.launches)
        for key, n in after.items():
            launches.setdefault(name, dict.fromkeys(after, 0))[key] += n - before.get(key, 0)
        return result

    for name, path in paths.items():
        first[name] = counted(name, lambda: warm(path.step, path.staged))
    for r in range(rounds):
        for name, path in paths.items():
            rate, passes = counted(name, lambda: timed(path.step, path.staged, path.fetchers))
            rates[name].append(rate)
            if r == 0:
                n_pass[name] = passes
    return {
        name: Rates(first[name], rates[name], n_pass[name], 1 + rounds * len(path.staged),
                    {k: n for k, n in launches[name].items() if n})
        for name, path in paths.items()
    }


def round_lines(rates: dict[str, Rates], device: str) -> list[str]:
    """One line a round with each path's reads/s, then the medians."""
    names = list(rates)
    n = len(rates[names[0]].rounds)
    lines = [f"# round {r + 1}: " + ", ".join(f"{name} {rates[name].rounds[r]:.0f}" for name in names)
             + f" reads/s on {device}" for r in range(n)]
    lines.append(f"# median of {n}: " + ", ".join(f"{name} {rates[name].median:.0f}" for name in names)
                 + f" reads/s on {device}")
    return lines


def peak_memory(device: torch.device) -> int | None:
    """Bytes the caching allocator held at its peak since the last reset,
    None on the CPU."""
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def reset_peak_memory(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
