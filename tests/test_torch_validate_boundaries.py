"""The port's boundary validation (warpdemux_tpu_torch/tools/validate_boundaries)
against the JAX tool's (tools/validate_boundaries.py) on one synthetic pod5
file of 48 reads written by the port's io/pod5_writer: the port's tool,
run with `--device cpu`, prints the JAX tool's tables cell for cell (every
figure there is a count or a rate of counts, so equal means equal text).

The reads, built as tests/test_torch_run_cli.py builds its set: 24
barcoded reads (`live/dummy.synth_barcoded_read` on WDX4's support
vectors, 6 a class), so that the barcode-call tables are not all noise,
and 24 rows of synth_minibatch(default_rng(0), 1000, 10000), 6 of them
cut to 300-1,800 samples (reads that end inside the preload)."""

import sys
import uuid
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

MODEL = "WDX4_rna004_v1_0"
N_READS = 48


def small_pod5_reads():
    """The 48 read dicts of the file."""
    from warpdemux_tpu_torch.live.dummy import synth_barcoded_read
    from warpdemux_tpu_torch.models.registry import load_model_arrays
    from warpdemux_tpu_torch.utils.synthetic import ADC_OFFSET, ADC_SCALE, synth_minibatch

    arrays = load_model_arrays(MODEL)
    X, label_map = arrays["X_sv"], arrays["label_map"]
    bounds = np.concatenate([[0], np.cumsum(arrays["n_support"])])
    rng = np.random.default_rng(0)

    def read(signal, offset=ADC_OFFSET, scale=ADC_SCALE):
        return dict(read_id=str(uuid.UUID(bytes=rng.bytes(16))), signal=signal,
                    calibration_offset=float(offset), calibration_scale=float(scale))

    reads = []
    for ci in range(len(label_map) - 1):  # the noise class has no reads
        for _ in range(6):
            sig = synth_barcoded_read(rng, X[rng.integers(bounds[ci], bounds[ci + 1])])
            reads.append(read(np.clip(np.rint(sig / ADC_SCALE - ADC_OFFSET), -32768, 32767).astype(np.int16)))
    adc, off, sc, lens = synth_minibatch(np.random.default_rng(0), 24, 10000)
    reads += [read(adc[i, : lens[i]], off[i], sc[i]) for i in range(18)]
    reads += [read(adc[18 + i, : 300 + 300 * i], off[i], sc[i]) for i in range(6)]
    return reads


def write_small_pod5(d: Path) -> Path:
    """small_pod5_0.pod5 in `d`, written by the port's writer."""
    from warpdemux_tpu_torch.io.pod5_writer import write_pod5

    path = d / "small_pod5_0.pod5"
    write_pod5(path, small_pod5_reads())
    return path


@pytest.fixture(scope="module")
def one_torch_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pod5_file(tmp_path_factory):
    return write_small_pod5(tmp_path_factory.mktemp("validate"))


def test_tables_equal_the_jax_tools(pod5_file, one_torch_thread, monkeypatch, capsys):
    import validate_boundaries as jax_tool

    from warpdemux_tpu_torch.tools import validate_boundaries as port_tool

    monkeypatch.setattr(jax_tool, "FIXTURES", [pod5_file])
    monkeypatch.setattr(sys, "argv", ["validate_boundaries.py"])
    jax_tool.main()
    want = capsys.readouterr().out
    assert port_tool.main(["--fixtures", str(pod5_file.parent / "small_pod5_*.pod5"), "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    print(got)
    assert got.splitlines()[0] == f"# {N_READS} real reads from 1 pod5 files"
    # the tables are not empty of what they compare
    assert "| llr pred distribution |" in got and "# cnn vs llr, both-pass reads: 0" not in got
    assert got == want


def test_without_a_card_and_without_device_cpu_raises(pod5_file):
    import torch

    from warpdemux_tpu_torch.tools import validate_boundaries as port_tool

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_tool.main(["--fixtures", str(pod5_file)])
