"""The port's command line (`python -m warpdemux_tpu_torch.cli`, run with
`--device cpu`) against the JAX CLI on one synthetic pod5 set: the same
shard files with the same contents.

The set (two pod5 files from the port's writer, 122 reads): 48 barcoded
reads (`live/dummy.synth_barcoded_read` on WDX4's support vectors, as
tests/test_demux_accuracy_e2e.py builds them), the first 64 rows of
`bench.synth_minibatch(default_rng(0), 1000, 10000)`, 6 reads under 2,000
samples and 4 of 15,000. Runs take `-b 48 --batch_size_output 40
--no-create_subdir`.

What is compared, shard by shard:
- failed_reads CSVs: equal byte for byte after gunzip;
- predictions: the same rows in the same order with equal `#read_id` and
  `predicted_barcode`; `confidence_score` (3 decimals) and `pNN` (4
  decimals) equal as text except cells one unit of their last decimal
  apart, which are counted and printed (the port's probabilities agree
  with JAX's within rtol 1e-5, atol 1e-6, so a cell can round the other
  way).
The default run takes the two-stage wire in both CLIs, and its log says so
in the JAX CLI's words; a `--stage1_preload 0` run of the port (the
one-shot wire) writes the same shards.
"""

import gzip
import json
import shutil
import sys
import uuid
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

MODEL = "WDX4_rna004_v1_0"
COMMON = ["-m", MODEL, "-b", "48", "--batch_size_output", "40", "--no-create_subdir"]
ADC_SCALE, ADC_OFFSET = 0.1755, -240.0
DECIMALS = {"confidence_score": 3}  # pNN columns: 4


def fixture_reads():
    """The set's reads, as two files' read dicts."""
    from bench import synth_minibatch
    from warpdemux_tpu_torch.live.dummy import synth_barcoded_read
    from warpdemux_tpu_torch.models.registry import load_model_arrays

    arrays = load_model_arrays(MODEL)
    X, label_map = arrays["X_sv"], arrays["label_map"]
    bounds = np.concatenate([[0], np.cumsum(arrays["n_support"])])
    rng = np.random.default_rng(0)

    def read(signal, offset=ADC_OFFSET, scale=ADC_SCALE):
        return dict(
            read_id=str(uuid.UUID(bytes=rng.bytes(16))), signal=signal,
            calibration_offset=float(offset), calibration_scale=float(scale),
        )

    barcoded = []
    for ci in range(len(label_map) - 1):  # the noise class has no reads
        for _ in range(12):
            sig = synth_barcoded_read(rng, X[rng.integers(bounds[ci], bounds[ci + 1])])
            barcoded.append(read(np.clip(np.rint(sig / ADC_SCALE - ADC_OFFSET), -32768, 32767).astype(np.int16)))
    adc, off, sc, lens = synth_minibatch(np.random.default_rng(0), 1000, 10000)
    bench_rows = [read(adc[i, : lens[i]], off[i], sc[i]) for i in range(64)]
    short = [read(adc[64 + i, : 300 + 300 * i]) for i in range(6)]
    ladc, loff, lsc, _ = synth_minibatch(np.random.default_rng(1), 4, 15000)
    long_ = [read(ladc[i], loff[i], lsc[i]) for i in range(4)]
    return [barcoded + short, bench_rows + long_]


def write_fixture(d: Path) -> list[str]:
    from warpdemux_tpu_torch.io.pod5_writer import write_pod5

    ids = []
    for k, reads in enumerate(fixture_reads()):
        write_pod5(d / f"part{k}.pod5", reads)
        ids += [r["read_id"] for r in reads]
    return ids


def port_cli(*argv):
    from warpdemux_tpu_torch.cli import main

    assert main([*map(str, argv), "--device", "cpu"]) == 0


def jax_cli(*argv):
    from warpdemux_tpu.cli import main

    assert main(list(map(str, argv))) in (0, None)


def gunzip(path) -> str:
    with gzip.open(path, "rt", encoding="utf-8", newline="") as fh:
        return fh.read()


def shard_names(run: Path, sub: str) -> list[str]:
    return sorted(p.name for p in (run / sub).glob("*.csv.gz"))


def same_failed_reads(port: Path, ref: Path):
    assert shard_names(port, "failed_reads") == shard_names(ref, "failed_reads")
    for name in shard_names(ref, "failed_reads"):
        assert gunzip(port / "failed_reads" / name) == gunzip(ref / "failed_reads" / name), name


def one_unit_apart(a: str, b: str, decimals: int) -> bool:
    return round(abs(float(a) - float(b)) * 10**decimals) == 1


def same_predictions(port: Path, ref: Path) -> int:
    """Shards equal as described above; returns the count of cells one
    unit of their last decimal apart (and prints it)."""
    names = shard_names(ref, "predictions")
    assert names and shard_names(port, "predictions") == names
    near = 0
    for name in names:
        p_lines = gunzip(port / "predictions" / name).splitlines()
        r_lines = gunzip(ref / "predictions" / name).splitlines()
        assert p_lines[0] == r_lines[0] and len(p_lines) == len(r_lines), name
        header = r_lines[0].split(",")
        for p_line, r_line in zip(p_lines[1:], r_lines[1:]):
            p_cells, r_cells = p_line.split(","), r_line.split(",")
            assert p_cells[:2] == r_cells[:2], (name, p_line, r_line)
            for col, a, b in zip(header[2:], p_cells[2:], r_cells[2:]):
                if a != b:
                    assert one_unit_apart(a, b, DECIMALS.get(col, 4)), (name, col, a, b)
                    near += 1
    print(f"{port.name}: {near} confidence / probability cells one unit of the last decimal from JAX's")
    return near


def read_ids_of(run: Path, sub: str) -> list[str]:
    ids = []
    for name in shard_names(run, sub):
        ids += [line.split(",")[0] for line in gunzip(run / sub / name).splitlines()[1:]]
    return ids


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two CPU threads for the port's torch here: the test workers share the
    machine's cores, and the runs' small minibatches gain little from
    more."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pod5_set(tmp_path_factory):
    d = tmp_path_factory.mktemp("pod5_set")
    return d, write_fixture(d)


@pytest.fixture(scope="module")
def default_runs(pod5_set, tmp_path_factory):
    d, _ = pod5_set
    out = tmp_path_factory.mktemp("default")
    port_cli("demux", "-i", d, "-o", out / "port", *COMMON)
    jax_cli("demux", "-i", d, "-o", out / "jax", *COMMON)
    return out / "port", out / "jax"


def test_demux_writes_the_jax_clis_shards(default_runs, pod5_set):
    port, ref = default_runs
    same_failed_reads(port, ref)
    same_predictions(port, ref)
    # every read once in predictions or failed_reads
    ids = read_ids_of(port, "predictions") + read_ids_of(port, "failed_reads")
    assert sorted(ids) == sorted(pod5_set[1])
    assert (port / "config.toml").read_bytes() == (ref / "config.toml").read_bytes()
    manifest = json.loads((port / "command.json").read_text())
    want = json.loads((ref / "command.json").read_text())
    assert manifest.keys() == want.keys()
    assert {k: v for k, v in manifest.items() if k not in ("argv", "output_dir")} == {
        k: v for k, v in want.items() if k not in ("argv", "output_dir")
    }
    assert two_stage_lines(port) == two_stage_lines(ref) == [
        "INFO two-stage wire: stage-1 preload 7168 of 10000 samples"
    ]


def two_stage_lines(run: Path) -> list[str]:
    """The run log's lines that name the two-stage wire, their time stamps
    cut off."""
    lines = (run / "warpdemux.log").read_text().splitlines()
    return [line.split(" ", 2)[2] for line in lines if "two-stage" in line]


def test_one_shot_wire_writes_the_default_runs_shards(pod5_set, default_runs, tmp_path):
    d, _ = pod5_set
    port_cli("demux", "-i", d, "-o", tmp_path / "port", *COMMON, "--stage1_preload", "0")
    assert two_stage_lines(tmp_path / "port") == []
    two_stage = default_runs[0]
    for sub in ("predictions", "failed_reads"):
        names = shard_names(two_stage, sub)
        assert names and shard_names(tmp_path / "port", sub) == names
        for name in names:
            assert gunzip(tmp_path / "port" / sub / name) == gunzip(two_stage / sub / name)


def test_demux_adc_wire_writes_the_jax_clis_shards(pod5_set, default_runs, tmp_path):
    d, _ = pod5_set
    port_cli("demux", "-i", d, "-o", tmp_path / "port", *COMMON, "--wire", "adc")
    jax_cli("demux", "-i", d, "-o", tmp_path / "jax", *COMMON, "--wire", "adc")
    same_failed_reads(tmp_path / "port", tmp_path / "jax")
    same_predictions(tmp_path / "port", tmp_path / "jax")
    # the adc wire gives the vbz wire's text
    vbz_run = default_runs[0]
    for sub in ("predictions", "failed_reads"):
        for name in shard_names(vbz_run, sub):
            assert gunzip(tmp_path / "port" / sub / name) == gunzip(vbz_run / sub / name)


def test_demux_read_id_csv_writes_the_jax_clis_shards(pod5_set, tmp_path):
    d, ids = pod5_set
    chosen = ids[5::4][:30]
    (tmp_path / "ids.txt").write_text("\n".join(chosen) + "\n")
    args = ("demux", "-i", d, *COMMON, "--read_id_csv", tmp_path / "ids.txt")
    port_cli(*args, "-o", tmp_path / "port")
    jax_cli(*args, "-o", tmp_path / "jax")
    same_failed_reads(tmp_path / "port", tmp_path / "jax")
    same_predictions(tmp_path / "port", tmp_path / "jax")
    got = read_ids_of(tmp_path / "port", "predictions") + read_ids_of(tmp_path / "port", "failed_reads")
    assert sorted(got) == sorted(chosen)


def test_continue_after_deleting_the_last_shard_follows_the_jax_cli(default_runs, tmp_path):
    """Both CLIs continue a copy of their own default run whose last
    predictions shard was deleted: the shard's reads come back once, in
    the shard the JAX CLI numbers, and nothing is duplicated."""
    runs = {}
    for name, src in zip(("port", "jax"), default_runs):
        runs[name] = tmp_path / name
        shutil.copytree(src, runs[name])
        last = runs[name] / "predictions" / shard_names(src, "predictions")[-1]
        lost = [line.split(",")[0] for line in gunzip(last).splitlines()[1:]]
        last.unlink()
    port_cli("continue", runs["port"])
    jax_cli("continue", runs["jax"])
    port, ref = runs["port"], runs["jax"]
    same_failed_reads(port, ref)
    same_predictions(port, ref)
    assert shard_names(port, "predictions") == shard_names(default_runs[0], "predictions")
    ids = read_ids_of(port, "predictions")
    assert len(ids) == len(set(ids)) == len(read_ids_of(default_runs[0], "predictions"))
    assert lost and set(lost) <= set(ids)


def test_no_gpu_and_no_device_exits_2(pod5_set, tmp_path, capsys):
    import torch

    from warpdemux_tpu_torch.cli import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device runs")
    d, _ = pod5_set
    assert main(["demux", "-i", str(d), "-o", str(tmp_path / "out"), *COMMON]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()  # nothing ran
