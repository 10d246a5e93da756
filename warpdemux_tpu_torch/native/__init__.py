"""ctypes bindings for the native host codec (wdx_native.cpp).

Port of warpdemux_tpu/native with its own copy of the C++ source. The
shared library is built with g++ (-O3 -march=native, links libzstd) the
first time an entry point is called, into `build/native/` at the
repository root, named by a digest of the source and the flags: an edited
source rebuilds, an unchanged one is reused, and concurrent builds (test
workers, worker processes) each write a file of their own and rename it
into place. Nothing is built at import. Where the build fails (no g++, no
zstd.h) every entry point returns None and its caller takes its numpy
path. Exposes vbz_decode / vbz_encode, the pod5 signal codec (zstd over
streamvbyte-16 zig-zag deltas), io/vbz.decode's preferred decoder. The
JAX package's native host scans (windowed_t_test, segment_means,
mvs_scan) are not copied: no module of the port calls them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).parent / "wdx_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib = None
_build_failed = False

_P = ctypes.POINTER
_I64 = ctypes.c_int64
# entry point -> (result type, argument types)
SIGNATURES = {
    "vbz_decode": (ctypes.c_int, (ctypes.c_char_p, _I64, _I64, _P(ctypes.c_int16), _P(ctypes.c_uint8), _I64)),
    "vbz_encode_bound": (_I64, (_I64,)),
    "vbz_encode": (_I64, (_P(ctypes.c_int16), _I64, _P(ctypes.c_uint8), _I64, _P(ctypes.c_uint8), _I64)),
}


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libwdx_native-{digest}.so"


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(
            ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lzstd"],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, out)  # atomic: a concurrent load never sees a partial file
    finally:
        tmp.unlink(missing_ok=True)


def _load():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = library_path()
        try:
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.SubprocessError):
            _build_failed = True
            return None
        for name, (restype, argtypes) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, list(argtypes)
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds (or is built) and loads."""
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def vbz_decode(payload: bytes, n: int) -> np.ndarray | None:
    """A VBZ payload of n samples decoded to int16 ADC counts; None without
    the library. ValueError for a payload that does not decode."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(n, np.int16)
    scratch = np.empty(4 * n + 64, np.uint8)
    rc = lib.vbz_decode(
        payload, len(payload), n, _ptr(out, ctypes.c_int16), _ptr(scratch, ctypes.c_uint8), scratch.size
    )
    if rc != 0:
        raise ValueError(f"vbz_decode failed (rc={rc})")
    return out


def vbz_encode(signal: np.ndarray) -> bytes | None:
    """int16 samples encoded as a VBZ payload (zstd level 1); None without
    the library."""
    lib = _load()
    if lib is None:
        return None
    sig = np.ascontiguousarray(signal, np.int16)
    n = sig.size
    out = np.empty(lib.vbz_encode_bound(n), np.uint8)
    scratch = np.empty((n + 7) // 8 + 2 * n + 64, np.uint8)
    size = lib.vbz_encode(
        _ptr(sig, ctypes.c_int16), n, _ptr(out, ctypes.c_uint8), out.size,
        _ptr(scratch, ctypes.c_uint8), scratch.size,
    )
    if size < 0:
        raise ValueError(f"vbz_encode failed (rc={size})")
    return out[:size].tobytes()

