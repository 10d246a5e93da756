"""Port parity: the pod5 reader and VBZ codec the live balancer's watcher
reads through (warpdemux_tpu_torch/io/), and the watcher strategies
themselves. The pod5 files are written by the JAX package's writer."""

import os
import time
import uuid

import numpy as np
import pytest

from warpdemux_tpu.io import vbz as jax_vbz
from warpdemux_tpu.io.pod5 import Pod5Reader as JaxPod5Reader
from warpdemux_tpu.io.pod5_writer import SIGNAL_CHUNK, write_pod5
from warpdemux_tpu.live.balancer import BalancerConfig as JaxBalancerConfig
from warpdemux_tpu.live.balancer import BarcodeBalancer as JaxBarcodeBalancer
from warpdemux_tpu_torch.io import vbz
from warpdemux_tpu_torch.io.pod5 import Pod5Reader
from warpdemux_tpu_torch.live.balancer import BalancerConfig, BarcodeBalancer


def _reads(n=12, seed=0):
    rng = np.random.default_rng(seed)
    lengths = [1, 7, 5000, SIGNAL_CHUNK + 3] + list(rng.integers(2000, 30000, n - 4))
    return [
        dict(
            read_id=str(uuid.UUID(bytes=rng.bytes(16))),
            signal=np.clip(np.cumsum(rng.integers(-300, 300, k)) + 500, -32768, 32767).astype(np.int16),
            calibration_offset=float(rng.uniform(-260, -200)),
            calibration_scale=float(rng.uniform(0.1, 0.3)),
            channel=int(rng.integers(1, 513)),
            well=int(rng.integers(1, 5)),
            end_reason=("signal_positive", "unblock_mux_change")[i % 2],
            num_minknow_events=int(rng.integers(0, 5000)),
        )
        for i, k in enumerate(lengths)
    ]


@pytest.mark.parametrize("n", [1, 2, 255, 256, 4099])
def test_vbz_roundtrip_equals_jax(n):
    sig = np.random.default_rng(n).integers(-2000, 2000, n).astype(np.int16)
    sig[::7] = 30000  # two-byte deltas
    payload = vbz.encode(sig)
    assert payload == jax_vbz.encode(sig)
    np.testing.assert_array_equal(vbz.decode(payload, n), sig)
    np.testing.assert_array_equal(vbz.decode(payload, n), jax_vbz.decode(payload, n))


def test_pod5_reads_back_equal_through_both_readers(tmp_path):
    reads = _reads()
    path = write_pod5(tmp_path / "a.pod5", reads)
    port, ref = list(Pod5Reader(path).reads()), list(JaxPod5Reader(path).reads())
    assert len(port) == len(ref) == len(reads)
    for p, r, want in zip(port, ref, reads):
        for field in ("read_id", "num_samples", "channel", "well", "end_reason", "num_minknow_events",
                      "calibration_offset", "calibration_scale"):
            assert getattr(p, field) == getattr(r, field), field
        assert p.read_id == want["read_id"] and p.num_minknow_events == want["num_minknow_events"]
        np.testing.assert_array_equal(p.signal_adc(), want["signal"])
        np.testing.assert_array_equal(p.signal_pa, r.signal_pa)
    sel = [reads[3]["read_id"], reads[7]["read_id"]]
    assert [p.read_id for p in Pod5Reader(path).reads(selection=sel)] == sel
    assert Pod5Reader(path).sample_rate == JaxPod5Reader(path).sample_rate
    (tmp_path / "b.pod5").write_bytes(b"not a container")
    with pytest.raises(ValueError, match="not a pod5 file"):
        Pod5Reader(tmp_path / "b.pod5")


def _watch(balancer_cls, config_cls, balance_type, watch_dir, files, accepted):
    """Stats of a watcher balancer that accepted `accepted` (read id ->
    barcode) before the pod5 files appeared in its directory."""
    b = balancer_cls(4, config_cls(balance_type=balance_type, pod5_watch_dir=str(watch_dir),
                                   pod5_check_interval=0.02))
    try:
        for read_id, bc in accepted.items():
            b.record_classified(read_id, bc, True)
        b.record_classified("rejected-read", 1, False)
        for i, src in enumerate(files):
            os.replace(src, watch_dir / f"{i}.pod5")  # appears whole
        deadline = time.time() + 20
        while len(b._watched_files) < len(files) and time.time() < deadline:
            time.sleep(0.02)
        b.stop()  # the watcher finishes the pass it is in, then ends
        assert not b._watcher.is_alive()
        return b.stats.copy()
    finally:
        b.stop()


@pytest.mark.parametrize("balance_type", ["read_count", "base_normalization"])
def test_watcher_counts_the_same_statistics(tmp_path, balance_type):
    reads = _reads(12, seed=1) + _reads(10, seed=2)
    accepted = {r["read_id"]: i % 4 for i, r in enumerate(reads) if i % 3}
    stats = []
    for name, cls, cfg in (("port", BarcodeBalancer, BalancerConfig), ("jax", JaxBarcodeBalancer, JaxBalancerConfig)):
        staging, watch = tmp_path / f"{name}_staging", tmp_path / f"{name}_watch"
        staging.mkdir()
        watch.mkdir()
        files = [write_pod5(staging / "x.pod5", reads[:12]), write_pod5(staging / "y.pod5", reads[12:])]
        stats.append(_watch(cls, cfg, balance_type, watch, files, accepted))
    np.testing.assert_array_equal(stats[0], stats[1])
    if balance_type == "read_count":
        np.testing.assert_array_equal(stats[0], np.bincount(list(accepted.values()), minlength=4))
    else:
        want = np.zeros(4)
        for r in reads:
            if r["read_id"] in accepted:
                want[accepted[r["read_id"]]] += max(r["num_minknow_events"] - 100, 0) / 1000.0
        np.testing.assert_allclose(stats[0], want)
