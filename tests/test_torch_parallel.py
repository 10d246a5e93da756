"""The port's one-device pieces that its runs over several processes rest
on, on the CPU.

- make_mesh: the devices of a host's worker processes (distinct cards,
  capped at the cards there are; n entries of the CPU);
- a read's row of the step does not depend on the other rows of its
  minibatch (their order, the reads beside it, zero padding), at a fixed
  B: the three feeds, both output modes, fused_rolling on and off. A run
  over several processes puts a read in another minibatch than a run in
  one, so this is what makes their rows equal;
- resolve_device names the card's index;
- full_float32, which the CNN enters, holds while any of
  many threads is inside (the live lane's classifier threads).
"""

import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import L, VBZ_WIDTH, synth_minibatch  # noqa: E402

MODEL = "WDX4_rna004_v1_0"
ROWS = 64
FORMATS = ("pa", "adc", "vbz")
OUTPUTS = ("decision", "full")


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two CPU threads for torch here: the test workers share the
    machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def port_model_spc():
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model

    return load_model(MODEL, "cpu"), get_model_spc_config(MODEL)


@pytest.fixture(scope="module")
def feeds():
    """{input format: step arguments} of the first 96 seed-0 bench rows."""
    from warpdemux_tpu_torch.ops.vbz_device import inner_layout_from_adc, pack_inner_host

    adc, off, sc, lens = (a[:96] for a in synth_minibatch(np.random.default_rng(0), 1000, L))
    signals = (adc.astype(np.float32) + off[:, None]) * sc[:, None]
    keys, data = pack_inner_host([inner_layout_from_adc(r) for r in adc], L, VBZ_WIDTH)
    return {
        "pa": (signals.astype(np.float32), lens),
        "adc": (adc, off, sc, lens),
        "vbz": (keys, data, off, sc, lens),
    }


def assert_outputs_equal(got, want):
    assert type(got) is type(want)
    for name, g, w in zip(want._fields, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), f"{name}: rows {torch.nonzero((g != w).reshape(len(g), -1).any(1)).flatten().tolist()}"


def test_mesh_of_the_cpu():
    from warpdemux_tpu_torch.parallel.mesh import make_mesh

    assert make_mesh(8, "cpu") == [torch.device("cpu")] * 8
    assert make_mesh(None, "cpu") == make_mesh(0, "cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError):
        make_mesh(2, "mps")


@pytest.mark.parametrize("count,asked,want", [(4, None, 4), (4, 0, 4), (4, 2, 2), (4, 8, 4), (1, 3, 1)])
def test_mesh_of_the_cards(monkeypatch, count, asked, want):
    """Distinct cards from cuda:0; None or 0 every card; capped at the cards
    there are."""
    from warpdemux_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    assert make_mesh(asked) == [torch.device("cuda", i) for i in range(want)]


def test_mesh_without_a_card_raises(monkeypatch):
    from warpdemux_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("outputs", OUTPUTS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_a_reads_row_does_not_depend_on_its_minibatch(port_model_spc, feeds, fmt, outputs, fused):
    """Rows 0-63 as one minibatch, against a minibatch of the same 64 rows
    of rows 63-32 in reverse, 20 other reads and 12 rows of zeros (the run
    loop's padding): every column of rows 32-63 bit-equal."""
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    step = make_demux_step(*port_model_spc, input_format=fmt, outputs=outputs, fused_rolling=fused, device="cpu")
    arrays = feeds[fmt]
    whole = step(*(a[:ROWS] for a in arrays))
    order = np.r_[np.arange(63, 31, -1), np.arange(64, 84)]
    mixed = step(*(np.concatenate([a[order], np.zeros((12,) + a.shape[1:], a.dtype)]) for a in arrays))
    back = torch.arange(63, 31, -1)
    assert_outputs_equal(type(mixed)(*(None if t is None else t[:32] for t in mixed)),
                         type(whole)(*(None if t is None else t[back] for t in whole)))


def test_resolve_device_gives_the_card_its_index(monkeypatch):
    """A card without an index resolves to the current card's index, so
    that a run's launches, streams and events go to its own card."""
    from warpdemux_tpu_torch._cuda import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert resolve_device() == torch.device("cuda", 3)
    assert resolve_device("cuda") == torch.device("cuda", 3)
    assert resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")


def test_resolve_device_without_a_card_raises(monkeypatch):
    from warpdemux_tpu_torch._cuda import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", "cuda:1"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(device)


def test_full_float32_holds_while_any_thread_is_inside():
    """The TF32 switches stay off while any of many threads is inside
    full_float32, and come back as they were when the last one leaves."""
    from warpdemux_tpu_torch.ops.numerics import full_float32

    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    seen_on = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def worker():
        for _ in range(300):
            with full_float32():
                if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
                    seen_on.append(1)

    try:
        threads = [threading.Thread(target=worker) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not seen_on
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        sys.setswitchinterval(interval)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
