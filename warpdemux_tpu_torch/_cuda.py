"""Build, load and launch the hand-written CUDA kernels under csrc/.

Every `*.cu` file in csrc/ is compiled for Hopper (sm_90a) by one `nvcc`
call into a shared library with a plain C interface, loaded with ctypes.
The sources include no PyTorch headers, so the build takes seconds. The
library lands in `build/torch_kernels/` at the repository root, named by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused. Nothing here runs at import time: the first
launch builds.

Each launch runs on PyTorch's current stream and returns the CUDA error
code, which `launch` turns into an exception. `launches` counts the
launches of each kernel, so a run can show that its work went through
the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-O3",
    "-std=c++17",
    "-fmad=false",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry point -> argument types (every entry point ends with the stream)
SIGNATURES = {
    "wdx_dtw": (_P, _P, _P, _I, _I, _I, _I, _F),
    "wdx_ttest": (_P, _P, _P, _P, _I, _I, _I),
    "wdx_suppress": (_P, _P, _P, _P, _P, _P, _I, _I, _I),
    "wdx_range_median_mad": (_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I),
    "wdx_shift_rows": (_P, _P, _P, _I, _I, _I),
    "wdx_rolling_mean_var": (_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I),
    "wdx_run_sum": (_P, _P, _I, _I, _I),
    "wdx_range_median_adc": (_P, _P, _P, _P, _P, _I, _I, _I),
    "wdx_rolling_detect": (
        _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
    ),
}

launches: dict[str, int] = {name: 0 for name in SIGNATURES}

_library: ctypes.CDLL | None = None


def reset_launches() -> None:
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


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: cannot build csrc/ kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build() -> Path:
    """Compile csrc/ into the kernel library (reused when up to date)."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            digest.update(path.name.encode() + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"libwdx_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    return out


def library() -> ctypes.CDLL:
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = [*argtypes, _P]
            fn.restype = ctypes.c_int
        _library = lib
    return _library


def launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel `name` on `device`'s current stream; raise on failure."""
    fn = getattr(library(), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    launches[name] += 1


def check(t: torch.Tensor, dtype: torch.dtype, ndim: int, name: str) -> None:
    """Validate a kernel operand before its pointer is handed to C."""
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name}: want a contiguous {ndim}-d {dtype} tensor, got "
            f"{t.dtype} of shape {tuple(t.shape)} (contiguous="
            f"{t.is_contiguous()})"
        )
