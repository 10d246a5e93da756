"""Where a callable's time goes on the device, from torch.profiler.

The shared half of the profiling tools (profile_step_trace,
profile_detect_trace, profile_stages): the inputs they build, the card's
name and power limit, and `trace`, which profiles a callable under
torch.profiler after a warm-up, over `reps` calls, and returns

- the wall ms a call, timed without the profiler;
- the device's busy ms a call, overlapping operations counted once;
- the idle share of the traced window (the profiled calls, host clock);
- every device operation by name with its total ms, its calls, its share
  of the busy time and the CPU operation that launched it (the twin of
  the JAX tools' HLO scope): the aten operation that CUPTI correlates with
  the launch, or, for the port's own kernels (`wdx_*`, launched through
  ctypes outside any aten operation), the kernel's C entry point.

On the CPU (`device="cpu"`, the plain PyTorch path) the "device"
operations are the aten operations by self time, launched by the aten
operation they run inside (empty at the top level), and busy is the time
inside them: what the CPU computed, not a device metric.
"""

from __future__ import annotations

import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from warpdemux_tpu_torch import _cuda

MODEL = "WDX4_rna004_v1_0"
L = 10000  # the preload of a bench read
REPS = 6


class Op(NamedTuple):
    name: str
    ms: float  # total over the traced calls
    count: int  # over the traced calls
    launched_by: str


class Trace(NamedTuple):
    device: str  # the card's name and power limit, or "cpu"
    reps: int
    wall_ms: float  # a call, unprofiled
    busy_ms: float  # a call
    window_ms: float  # a call, profiled
    ops: list[Op]  # every device operation, by total ms

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_ms / self.window_ms

    def kernel_calls(self) -> dict[str, float]:
        """Calls a call of each of the port's kernels, by C entry point (the
        keys of `_cuda.launches`)."""
        calls: dict[str, float] = defaultdict(float)
        for op in self.ops:
            entry = entry_point(op.name)
            if entry:
                calls[entry] += op.count / self.reps
        return dict(calls)

    def table(self, top: int) -> list[str]:
        """The top operations as a markdown table: ms a call, calls a call,
        % of the busy time, the CPU operation that launched it."""
        lines = ["| op | ms/call | calls/call | % of busy | launched by |", "|---|---|---|---|---|"]
        for op in self.ops[:top]:
            calls = op.count // self.reps if op.count % self.reps == 0 else op.count / self.reps
            share = 100 * op.ms / self.reps / max(self.busy_ms, 1e-12)
            lines.append(f"| {op.name[:70]} | {op.ms / self.reps:8.3f} | {calls} | {share:5.1f} | {op.launched_by[:70]} |")
        return lines

    def summary(self) -> str:
        return (f"# device busy {self.busy_ms:.3f} ms/call; idle share {self.idle_share:.3f} of the traced "
                f"window ({self.window_ms:.3f} ms/call profiled, {self.wall_ms:.3f} ms/call unprofiled) on {self.device}")


def entry_point(kernel: str) -> str | None:
    """The C entry point of csrc/ (a key of `_cuda.launches`) whose kernel
    `kernel` is, e.g. "void wdx_svm_probs_kernel<5, true>(...)" ->
    "wdx_svm_probs"; None for any other device operation. Each entry point
    launches one kernel a call, named after it."""
    name = kernel.split("(")[0].split("<")[0].split()[-1] if kernel.strip() else ""
    matches = [e for e in _cuda.launches if name.startswith(e + "_")]
    return max(matches, key=len) if matches else None


def device_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", f"--id={device.index}"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def _bench():
    """The repository root's bench.py, whose module level imports numpy
    only (its JAX half is imported inside its functions)."""
    root = str(Path(__file__).resolve().parents[2])
    if root not in sys.path:
        sys.path.insert(0, root)
    import bench

    return bench


def bench_minibatch(B: int, seed: int = 0):
    """(adc, offset, scale, lens): bench.synth_minibatch(default_rng(seed),
    B, 10000), the reads every tool and chip_smoke.py profile."""
    return _bench().synth_minibatch(np.random.default_rng(seed), B, L)


def vbz_pack(adc: np.ndarray):
    """(keys, data): the reads packed into the VBZ wire with the port's numpy
    helpers, at bench.VBZ_WIDTH data bytes a row or the multiple of 1024
    that holds the longest (rows of more than 10,000 samples)."""
    from warpdemux_tpu_torch.ops.vbz_device import inner_layout_from_adc, pack_inner_host

    bodies = [inner_layout_from_adc(r) for r in adc]
    need = max(len(b) for b in bodies) - (adc.shape[1] + 7) // 8
    return pack_inner_host(bodies, adc.shape[1], max(_bench().VBZ_WIDTH, -(-need // 1024) * 1024))


def busy_us(events) -> float:
    """Microseconds in which the device ran at least one of the profiler's
    `events` (overlapping operations counted once)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in events if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def trace(fn, device: torch.device, reps: int = REPS, warmup: int = 2) -> Trace:
    """Profile `fn()` on `device`: `warmup` calls, `reps` timed calls
    without the profiler, then `reps` calls under it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    synchronize(device)
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        synchronize(device)
        window_ms = (time.perf_counter() - t0) * 1e3 / reps
    events = prof.events()
    total: dict[str, float] = defaultdict(float)  # us
    count: dict[str, int] = defaultdict(int)
    by: dict[str, dict[str, float]] = defaultdict(lambda: defaultdict(float))  # op -> launcher -> us
    if cuda:
        for e in events:
            if e.device_type == DeviceType.CPU:
                for k in e.kernels:  # the device operations CUPTI correlates with this CPU operation
                    by[k.name][e.name] += k.duration
        for e in events:
            if e.device_type == DeviceType.CUDA:
                total[e.name] += e.time_range.end - e.time_range.start
                count[e.name] += 1
        busy = busy_us(events)
    else:
        busy = 0.0
        for e in events:
            if e.device_type == DeviceType.CPU and e.name.startswith("aten::"):
                total[e.name] += e.self_cpu_time_total
                count[e.name] += 1
                busy += e.self_cpu_time_total
                by[e.name][e.cpu_parent.name if e.cpu_parent is not None else ""] += e.self_cpu_time_total

    def launcher(name):
        if by[name]:
            return max(by[name].items(), key=lambda kv: kv[1])[0]
        return entry_point(name) or ""

    ops = [Op(name, us / 1e3, count[name], launcher(name)) for name, us in total.items()]
    ops.sort(key=lambda op: -op.ms)
    return Trace(device_name(device), reps, wall_ms, busy / 1e3 / reps, window_ms, ops)
