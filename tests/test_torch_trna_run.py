"""The port's command line on the tRNA chemistry (`demux` and `prep
--save_boundaries` with WDX4_tRNA_rna004_v1_0, `--device cpu`) against the
JAX CLI, on the 40-read synthetic tRNA pod5 of tests/test_trna_demux_e2e.py
(default_rng(12345), 10 barcoded reads of each of the model's four
classes), written with the port's pod5 writer.

- predictions: the same rows, with confidence and probability cells equal
  as text or one unit of their last decimal apart
  (test_torch_run_cli.same_predictions); failed_reads byte for byte;
- prep: boundaries and failed_reads as tests/test_torch_run_prep.py holds
  them, the consensus columns (seg_cons_query_start, seg_cons_query_end,
  sig_barcode_start) included and exact; the fingerprints bit-equal;
- 0.9 or more of the planted barcodes recovered.
"""

import csv
import io
import sys
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_torch_run_cli import (  # noqa: E402
    gunzip,
    jax_cli,
    port_cli,
    read_ids_of,
    same_failed_reads,
    same_predictions,
    shard_names,
)

MODEL = "WDX4_tRNA_rna004_v1_0"
COMMON = ["-m", MODEL, "-b", "40", "--no-create_subdir"]
ADC_SCALE, ADC_OFFSET = 0.1755, -240.0
BARCODES = [3, 4, 5, 7]
CONSENSUS_COLS = ["seg_cons_query_start", "seg_cons_query_end", "sig_barcode_start"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One CPU thread for torch here: the test workers share the machine's
    cores, and this file's many small operations gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trna_pod5(tmp_path_factory):
    from warpdemux_tpu_torch.io.pod5_writer import write_pod5
    from warpdemux_tpu_torch.utils.synthetic import synth_trna_barcoded_read, trna_barcode_patterns

    rng = np.random.default_rng(12345)
    pats = trna_barcode_patterns(n_barcodes=4, n_events=25)
    reads, truth = [], {}
    for ci, bc in enumerate(BARCODES):
        for _ in range(10):
            sig_pa, _ = synth_trna_barcoded_read(rng, pats[ci])
            adc = np.clip(np.rint(sig_pa / ADC_SCALE - ADC_OFFSET), -32768, 32767).astype(np.int16)
            rid = str(uuid.UUID(bytes=rng.bytes(16)))
            truth[rid] = bc
            reads.append(dict(read_id=rid, signal=adc, calibration_offset=ADC_OFFSET,
                              calibration_scale=ADC_SCALE))
    d = tmp_path_factory.mktemp("trna_pod5")
    write_pod5(d / "trna.pod5", reads)
    return d, truth


@pytest.fixture(scope="module")
def runs(trna_pod5, tmp_path_factory):
    d, _ = trna_pod5
    out = tmp_path_factory.mktemp("trna_runs")
    for cmd, extra in (("demux", []), ("prep", ["--save_boundaries"])):
        port_cli(cmd, "-i", d, "-o", out / f"{cmd}_port", *COMMON, *extra)
        jax_cli(cmd, "-i", d, "-o", out / f"{cmd}_jax", *COMMON, *extra)
    return out


def test_demux_writes_the_jax_clis_shards_and_recovers_the_barcodes(runs, trna_pod5):
    _, truth = trna_pod5
    port, ref = runs / "demux_port", runs / "demux_jax"
    same_failed_reads(port, ref)
    same_predictions(port, ref)
    ids = read_ids_of(port, "predictions") + read_ids_of(port, "failed_reads")
    assert sorted(ids) == sorted(truth)
    rows = list(csv.reader(io.StringIO(gunzip(port / "predictions" / shard_names(port, "predictions")[0]))))
    head, body = rows[0], rows[1:]
    assert {"p03", "p04", "p05", "p07", "p-1"} <= set(head)
    hits = sum(int(r[1]) == truth[r[0]] for r in body)
    assert hits >= 0.9 * len(truth), f"{hits} of {len(truth)} planted barcodes"


@pytest.mark.parametrize("sub", ["boundaries", "failed_reads"])
def test_prep_summary_shards_equal_jax_with_the_consensus_columns(runs, sub):
    port, ref = runs / "prep_port", runs / "prep_jax"
    names = shard_names(ref, sub)
    if sub == "failed_reads" and not names:  # every planted read passed
        assert not shard_names(port, sub)
        return
    assert names and shard_names(port, sub) == names
    for name in names:
        p_rows = list(csv.reader(io.StringIO(gunzip(port / sub / name))))
        r_rows = list(csv.reader(io.StringIO(gunzip(ref / sub / name))))
        assert p_rows[0] == r_rows[0] and len(p_rows) == len(r_rows)
        head = r_rows[0]
        assert set(CONSENSUS_COLS) <= set(head)
        for j, col in enumerate(head):
            assert [r[j] for r in p_rows[1:]] == [r[j] for r in r_rows[1:]], (name, col)


def test_prep_fingerprints_equal_jax(runs):
    port, ref = runs / "prep_port", runs / "prep_jax"
    names = sorted(p.name for p in (ref / "fingerprints").glob("*.npz"))
    assert names and sorted(p.name for p in (port / "fingerprints").glob("*.npz")) == names
    for name in names:
        with np.load(port / "fingerprints" / name, allow_pickle=True) as a, np.load(
            ref / "fingerprints" / name, allow_pickle=True
        ) as b:
            assert a["read_ids"].tolist() == b["read_ids"].tolist()
            assert a["signals"].tobytes() == b["signals"].tobytes()
