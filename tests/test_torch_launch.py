"""The port's launch path (`_cuda.launch`) without a GPU: a stand-in kernel
library shows that an entry point is looked up once and not on every launch,
that the launch runs on PyTorch's current stream of the tensor's device,
that a CUDA error raises, and that only a kernel's launches are counted."""

import pytest
import torch

from warpdemux_tpu_torch import _cuda


class _Library:
    """Counts attribute look-ups; its entry points record their arguments."""

    def __init__(self, err=0):
        self.lookups, self.calls, self.err = [], [], err

    def __getattr__(self, name):
        self.lookups.append(name)
        return lambda *args: self.calls.append((name, args)) or self.err


@pytest.fixture
def library(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "_entry_points", {})
    monkeypatch.setattr(_cuda, "_raw_stream", lambda index: 1000 + index)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(_cuda, "launches", {name: 0 for name in _cuda.SIGNATURES})
    return lib


def test_entry_point_is_resolved_once_and_launches_are_counted(library):
    for i in range(3):
        _cuda.launch("wdx_shift_rows", torch.device("cuda", 0), i, 7)
    assert library.lookups == ["wdx_shift_rows"]
    assert library.calls == [("wdx_shift_rows", (i, 7, 1000)) for i in range(3)]
    assert _cuda.launches["wdx_shift_rows"] == 3
    _cuda.empty_launch(torch.device("cuda"), 4, 32)  # a probe: no index, not counted
    assert library.calls[-1] == ("wdx_empty_launch", (4, 32, 1000))
    assert sum(_cuda.launches.values()) == 3


def test_entry_points_are_kept_by_the_defines_they_were_built_with(library, monkeypatch):
    _cuda.launch("wdx_ttest", torch.device("cuda", 0))
    monkeypatch.setattr(_cuda, "defines", ("-DWDX_SELECT_THREADS=128",))
    _cuda.launch("wdx_ttest", torch.device("cuda", 0))
    _cuda.launch("wdx_ttest", torch.device("cuda", 0))
    assert library.lookups == ["wdx_ttest", "wdx_ttest"]


def test_another_device_is_entered_for_the_launch(library, monkeypatch):
    entered = []

    class _Device:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            entered.append(self.index)

        def __exit__(self, *exc):
            entered.append(-self.index)

    monkeypatch.setattr(torch.cuda, "device", _Device)
    _cuda.launch("wdx_ttest", torch.device("cuda", 0))
    assert entered == []  # the current device: no context
    _cuda.launch("wdx_ttest", torch.device("cuda", 2))
    assert entered == [2, -2] and library.calls[-1] == ("wdx_ttest", (1002,))


def test_a_cuda_error_raises_and_is_not_counted(library):
    library.err = 9
    with pytest.raises(RuntimeError, match="wdx_dtw: CUDA launch failed with error 9"):
        _cuda.launch("wdx_dtw", torch.device("cuda", 0))
    assert _cuda.launches["wdx_dtw"] == 0


# ---- several threads (the live lane's classifier threads) ------------------

def _at_once(n, fn):
    """Run fn(i) in n threads released together; re-raise the first error."""
    import threading

    barrier, errors = threading.Barrier(n), []

    def run(i):
        try:
            barrier.wait(timeout=10)
            fn(i)
        except BaseException as e:  # recorded and re-raised in the caller
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]


def test_library_is_built_and_loaded_once_from_eight_threads(monkeypatch, tmp_path):
    import time

    builds, loads = [], []

    def compile_library(sources, out, defines=()):
        builds.append(out)
        time.sleep(0.2)  # long enough for every thread to ask meanwhile
        out.write_bytes(b"")

    class _CDLL:
        def __init__(self, path):
            loads.append(path)

        def __getattr__(self, name):
            fn = lambda *args: 0  # noqa: E731
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_cuda, "compile_library", compile_library)
    monkeypatch.setattr(_cuda.ctypes, "CDLL", _CDLL)
    monkeypatch.setattr(_cuda, "_libraries", {})
    got = []
    _at_once(8, lambda i: got.append(_cuda.library()))
    assert len(builds) == 1 and len(loads) == 1
    assert len(got) == 8 and all(lib is got[0] for lib in got)


def test_concurrent_builds_name_their_objects_apart(monkeypatch, tmp_path):
    """Two threads of one process compiling into the same library path
    write different object files."""
    import threading

    objects, lock = [], threading.Lock()

    class _Compiler:
        returncode = 1

        def __init__(self, args, **kw):
            with lock:
                objects.append(args[args.index("-o") + 1])
            self.args = args

        def communicate(self):
            return ("refused",)

    monkeypatch.setattr(_cuda, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_cuda.subprocess, "Popen", _Compiler)

    def compile_once(i):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            _cuda.compile_library(["a.cu", "b.cu"], tmp_path / "lib.so")

    _at_once(2, compile_once)
    assert len(objects) == 4 and len(set(objects)) == 4


def test_launch_counts_lose_nothing_across_threads(library):
    import sys

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _at_once(16, lambda i: [_cuda.launch("wdx_dtw", torch.device("cuda", 0)) for _ in range(2000)])
    finally:
        sys.setswitchinterval(switch)
    assert _cuda.launches["wdx_dtw"] == 16 * 2000
