"""Build, load and launch the hand-written CUDA kernels under csrc/.

Every `*.cu` file in csrc/ is compiled for Hopper (sm_90a) by an `nvcc`
call of its own, all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ctypes. The sources
include no PyTorch headers, so the build takes seconds. The library lands
in `build/torch_kernels/` at the repository root, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused; what ptxas said of each kernel (registers, shared memory, spills)
lands beside it as `<library>.log`. Nothing here runs at import time: the
first launch builds.

Each launch runs on PyTorch's current stream and returns the CUDA error
code, which `launch` turns into an exception. `launches` counts the
launches of each kernel, so a run can show that its work went through
the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-O3",
    "-std=c++17",
    "-fmad=false",
    "-Xptxas=-v",
    "-Xcompiler",
    "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry point -> argument types (every entry point ends with the stream)
SIGNATURES = {
    "wdx_dtw": (_P, _P, _P, _I, _I, _I, _I, _F),
    "wdx_ttest": (_P, _P, _P, _P, _P, _P, _I, _I, _I),
    "wdx_suppress": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I),
    "wdx_range_median_mad": (_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I),
    "wdx_shift_rows": (_P, _P, _P, _P, _I, _I, _I, _I),
    "wdx_rolling_mean_var": (_P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I),
    "wdx_run_sum": (_P, _P, _I, _I, _I, _I),
    "wdx_range_median_adc": (_P, _P, _P, _P, _P, _I, _I, _I, _I),
    "wdx_rolling_detect": (
        _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
    ),
    "wdx_subseq_dtw": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _I),
    "wdx_rowstats": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I),
    "wdx_svm_dot": (_P, _P, _P, _P, _I, _I, _I, _I, _I),
    "wdx_svm_probs": (_P, _P, _P, _P, _I, _I, _F, _F, _F, _I, _I),
}

# entry points that launch no kernel of the port and are not counted
PROBES = {"wdx_empty_launch": (_I, _I)}

launches: dict[str, int] = {name: 0 for name in SIGNATURES}

# Shared memory (static and dynamic together) a block may take on sm_90
MAX_SHARED_BYTES = 232448

# -DNAME=value overrides of the sources' tile sizes; a sweep (tune_kernels.py)
# sets them, and the next launch builds and loads that variant
defines: tuple[str, ...] = ()

_libraries: dict[tuple, ctypes.CDLL] = {}  # by the defines they were built with
_entry_points: dict[tuple, object] = {}  # by (defines, name): resolved once, not per launch
# the live lane calls the kernels from several threads: one builds and loads
# the library while the others wait, and no count is lost
_library_lock = threading.Lock()
_launches_lock = threading.Lock()


def reset_launches() -> None:
    with _launches_lock:
        for name in launches:
            launches[name] = 0


def on_cuda(*tensors: torch.Tensor) -> bool:
    """The dispatch rule: True for CUDA tensors, False for CPU tensors.

    Mixed devices, or any other device type, raise."""
    types = {t.device.type for t in tensors}
    if types == {"cuda"}:
        return True
    if types == {"cpu"}:
        return False
    raise ValueError(f"tensors must all be on cpu or all on cuda, got {types}")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA GPU unless the caller
    names another (`device="cpu"` for the CPU path). With no device given
    and no CUDA GPU this raises; nothing moves to the CPU unasked.

    A card always comes back with its index (the current card where none
    was named): the launches, streams and events of the step are made on
    the device of its tensors, which a device without an index does not
    say once the current card is another."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: warpdemux_tpu_torch runs on the GPU by default; "
            'pass device="cpu" to run the plain PyTorch path on the CPU'
        )
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: cannot build csrc/ kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def compile_library(sources, out: Path, defines=()) -> None:
    """Compile `sources` (one nvcc each, in parallel) and link them into the
    shared library `out`; what the compilers printed (ptxas -v) is written
    to `<out>.log` before the library appears."""
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    stem = f"{out.name}.{os.getpid()}.{threading.get_ident()}"
    objects = [out.with_name(f"{stem}.{Path(src).stem}.o") for src in sources]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *defines, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(sources, objects)
    ]
    logs = [proc.communicate()[0] for proc in procs]  # waits for every compiler
    try:
        for proc, log in zip(procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(proc.args)}\n{log}")
        tmp = out.with_name(f"{stem}.tmp")
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objects)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(link)}\n{proc.stderr}")
        build_log(out).write_text("".join(logs))
        os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)


def build_log(library_path: Path) -> Path:
    return library_path.with_name(library_path.name + ".log")


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel of a compile log: registers, spills, shared memory."""
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            info = " ".join(lines[i + 1 : i + 4])
            regs = re.search(r"Used (\d+) registers", info)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", info)
            smem = re.search(r"(\d+) bytes smem", info)
            out.append(
                f"ptxas {entry.group(1)[:60]}: registers={regs and regs.group(1)} "
                f"spill stores/loads={spill and '/'.join(spill.groups())} "
                f"static smem={smem.group(1) if smem else 0}"
            )
    return out


def build(defines=()) -> Path:
    """Compile csrc/ with `defines` into a kernel library (reused when up
    to date)."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            digest.update(path.name.encode() + path.read_bytes())
    digest.update(" ".join((*NVCC_FLAGS, *defines)).encode())
    out = BUILD_DIR / f"libwdx_kernels_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        compile_library(sources, out, defines)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built with the module's `defines`; built
    and loaded once however many threads ask at the same time."""
    key = defines
    with _library_lock:
        if key not in _libraries:
            lib = ctypes.CDLL(str(build(key)))
            for name, argtypes in {**SIGNATURES, **PROBES}.items():
                fn = getattr(lib, name)
                fn.argtypes = [*argtypes, _P]
                fn.restype = ctypes.c_int
            _libraries[key] = lib
        return _libraries[key]


def _raw_stream(index: int) -> int:
    """The handle of PyTorch's current stream on device `index`, without the
    `torch.cuda.Stream` object where this build offers the raw call."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel `name` on `device`'s current stream; raise on failure.

    The host's time a launch is what a caller of a kernel of a few
    microseconds pays, so the entry point is looked up once, and the device
    context is entered only when `device` is not the current one."""
    fn = _entry_points.get((defines, name))
    if fn is None:
        fn = _entry_points[(defines, name)] = getattr(library(), name)
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        err = fn(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, _raw_stream(index))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    if name in launches:
        with _launches_lock:
            launches[name] += 1


def empty_launch(device: torch.device, blocks: int, threads: int) -> None:
    """Launch an empty kernel of `blocks` x `threads`: the floor under a
    kernel's time at that grid. Not counted in `launches`."""
    launch("wdx_empty_launch", device, blocks, threads)


def check(t: torch.Tensor, dtype: torch.dtype, ndim: int, name: str) -> None:
    """Validate a kernel operand before its pointer is handed to C."""
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name}: want a contiguous {ndim}-d {dtype} tensor, got "
            f"{t.dtype} of shape {tuple(t.shape)} (contiguous="
            f"{t.is_contiguous()})"
        )
