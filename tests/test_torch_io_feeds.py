"""Port parity: the offline run's pod5 feeds and the synthetic pod5 writer
(warpdemux_tpu_torch/io/pod5.py, io/pod5_writer.py) against the JAX
package's, array for array.

Inputs: a two-file synthetic set (reads of 1 to 30,000 samples, some
shorter than the preload, some longer), and one file written with
SIGNAL_CHUNK = 4096 in both writers, whose heads span several signal rows
(the vbz feed's decode-and-re-encode branch). Cases: every read, an
include set, an exclude set, both, each with a short final batch.
"""

import threading
import uuid

import numpy as np
import pytest

import warpdemux_tpu.io.pod5 as jax_pod5
import warpdemux_tpu.io.pod5_writer as jax_writer
import warpdemux_tpu_torch.io.pod5 as pod5
import warpdemux_tpu_torch.io.pod5_writer as writer
from warpdemux_tpu_torch.io import vbz

B, L = 5, 10000
FEEDS = ("yield_signal_batches", "yield_adc_batches", "yield_vbz_batches")


def _reads(n, seed, lengths=()):
    rng = np.random.default_rng(seed)
    lengths = list(lengths) + list(rng.integers(2000, 30000, n - len(lengths)))
    return [
        dict(
            read_id=str(uuid.UUID(bytes=rng.bytes(16))),
            signal=np.clip(np.cumsum(rng.integers(-300, 300, k)) + 500, -32768, 32767).astype(np.int16),
            calibration_offset=float(rng.uniform(-260, -200)),
            calibration_scale=float(rng.uniform(0.1, 0.3)),
            channel=int(rng.integers(1, 513)),
            num_minknow_events=int(rng.integers(0, 5000)),
        )
        for k in lengths
    ]


@pytest.fixture(scope="module")
def pod5_set(tmp_path_factory):
    d = tmp_path_factory.mktemp("feeds")
    parts = [_reads(9, 0, lengths=(1, 7, 1999, 10000, 10001)), _reads(8, 1)]
    files = []
    for k, reads in enumerate(parts):
        files.append(str(d / f"part{k}.pod5"))
        writer.write_pod5(files[-1], reads)
    return files, [r["read_id"] for part in parts for r in part]


@pytest.fixture(scope="module")
def chunked_file(tmp_path_factory):
    """A file whose signal rows hold 4096 samples, written by both writers."""
    d = tmp_path_factory.mktemp("chunked")
    reads = _reads(7, 2, lengths=(4096, 4097, 8192, 9999))
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(writer, "SIGNAL_CHUNK", 4096)
        mp.setattr(jax_writer, "SIGNAL_CHUNK", 4096)
        writer.write_pod5(d / "port.pod5", reads)
        jax_writer.write_pod5(d / "jax.pod5", reads)
    finally:
        mp.undo()
    return str(d / "port.pod5"), str(d / "jax.pod5")


def _same_batches(port, ref):
    port, ref = list(port), list(ref)
    assert len(port) == len(ref)
    for pb, rb in zip(port, ref):
        assert len(pb) == len(rb)
        for p, r in zip(pb, rb):
            assert p.dtype == r.dtype and p.shape == r.shape
            if r.dtype == object:
                assert p.tolist() == r.tolist()
            else:
                np.testing.assert_array_equal(p, r)
    return port


def _selection(ids, case):
    incl = set(ids[2:14]) if case in ("include", "both") else None
    excl = set(ids[::3]) if case in ("exclude", "both") else None
    return incl, excl


def test_count_reads_equals_jax(pod5_set):
    files, ids = pod5_set
    assert pod5.count_reads(files) == jax_pod5.count_reads(files) == len(ids)


@pytest.mark.parametrize("case", ["all", "include", "exclude", "both"])
@pytest.mark.parametrize("feed", FEEDS)
def test_feed_equals_jax(pod5_set, feed, case):
    files, ids = pod5_set
    incl, excl = _selection(ids, case)
    port = _same_batches(
        getattr(pod5, feed)(files, incl, excl, batch_size=B, preload_size=L),
        getattr(jax_pod5, feed)(files, incl, excl, batch_size=B, preload_size=L),
    )
    assert len(port[-1][-1]) < B  # a short final batch
    if feed == "yield_vbz_batches":  # the data width is a rung of the ladder
        assert all(b[1].shape[1] in pod5._DATA_WIDTH_LADDER for b in port)


@pytest.mark.parametrize("feed", FEEDS)
def test_feed_on_multi_row_heads_equals_jax(chunked_file, feed):
    port_file, _ = chunked_file
    port = _same_batches(
        getattr(pod5, feed)([port_file], None, None, batch_size=3, preload_size=L),
        getattr(jax_pod5, feed)([port_file], None, None, batch_size=3, preload_size=L),
    )
    with pod5.Pod5Reader(port_file) as reader:
        heads = [len(r._signal_rows) for r in reader.reads()]
    assert max(heads) > 1  # heads over several rows were read


def test_write_pod5_writes_the_jax_writers_bytes(tmp_path, pod5_set, chunked_file):
    reads = _reads(6, 3, lengths=(1, 2, 102401))
    writer.write_pod5(tmp_path / "port.pod5", reads)
    jax_writer.write_pod5(tmp_path / "jax.pod5", reads)
    assert (tmp_path / "port.pod5").read_bytes() == (tmp_path / "jax.pod5").read_bytes()
    port_file, jax_file = chunked_file
    with open(port_file, "rb") as a, open(jax_file, "rb") as b:
        assert a.read() == b.read()


def test_zstd_decompressor_is_one_per_thread():
    seen = {}

    def grab(k):
        seen[k] = (vbz.zstd_decompressor(), vbz.zstd_decompressor())

    threads = [threading.Thread(target=grab, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(a is b for a, b in seen.values())  # reused within a thread
    assert len({id(a) for a, _ in seen.values()}) == 3  # not shared across threads
