"""The live lane on the port: the flows of tests/test_live.py (gates,
caches, unblock escalation, balancer rules, a whole replay session, the
live config) through warpdemux_tpu_torch on the CPU."""

import csv

import numpy as np
import pytest

from warpdemux_tpu_torch.detect.streaming import (
    RealRangeConfig,
    StreamingConfig,
    mean_var_shift_polya_detect,
    real_range_check,
)
from warpdemux_tpu_torch.live.balancer import BalancerConfig, BarcodeBalancer, BarcodeBalancers
from warpdemux_tpu_torch.live.caches import AccumulatingCache, LiveRead, ReadCache
from warpdemux_tpu_torch.live.dummy import DummyClient, synth_barcoded_read, synth_live_read
from warpdemux_tpu_torch.live.session import ChannelRepeatedUnblockDuration, Session, SessionConfig
from warpdemux_tpu_torch.models.registry import load_model

MODEL = "WDX4_rna004_v1_0"


@pytest.fixture(scope="module")
def model():
    return load_model(MODEL, "cpu")


def _session(client, model, tmp_path, balance_type="none", **kw):
    cfg = SessionConfig(model_name=MODEL, save_path=str(tmp_path), run_id="t", **kw)
    balancers = BarcodeBalancers.from_configs(4, [BalancerConfig(balance_type=balance_type)], [1.0], n_channels=126)
    return Session(client, cfg, balancers, model=model, device="cpu")


def test_streaming_polya_detect():
    sig = synth_live_read(np.random.default_rng(0), adapter_len=4000, polya_len=2000)
    cfg = StreamingConfig()
    assert mean_var_shift_polya_detect(sig[:2000], cfg) == 0  # not enough signal yet
    loc = mean_var_shift_polya_detect(sig[:7000], cfg)
    assert abs(loc - 4000) < 400, loc


def test_real_range_check():
    sig = synth_live_read(np.random.default_rng(1), adapter_len=4000)
    assert real_range_check(sig[:4000], RealRangeConfig())
    assert not real_range_check(np.full(4000, 80.0), RealRangeConfig())


def test_caches():
    c = ReadCache(size=2)
    r = lambda ch, num: LiveRead(ch, f"id{ch}-{num}", num, np.zeros(10))
    c.set(1, r(1, 0))
    c.set(2, r(2, 0))
    c.set(3, r(3, 0))  # evicts channel 1
    assert len(c) == 2 and c.missed == 1

    a = AccumulatingCache(size=4, max_raw_signal=25)
    a.set(1, LiveRead(1, "x", 0, np.arange(10.0)))
    a.set(1, LiveRead(1, "x", 0, np.arange(10.0)))
    assert dict(a.pop_all())[1].signal.size == 20
    a.set(1, LiveRead(1, "y", 1, np.arange(30.0)))
    a.set(1, LiveRead(1, "y", 1, np.arange(30.0)))
    assert dict(a.pop_all())[1].signal.size == 25  # capped


def test_unblock_escalation():
    crud = ChannelRepeatedUnblockDuration(durations=(0.1, 0.5, 2.0), window_s=10)
    assert [crud.duration(5) for _ in range(4)] == [0.1, 0.5, 2.0, 2.0]  # stays at max
    assert crud.duration(6) == 0.1  # other channels independent


def test_balancer_decision_rule():
    b = BarcodeBalancer(4, BalancerConfig(balance_type="adapter_count", balance_threshold=0.4, min_stat=5))
    assert b.decide(0)  # cold start: below min_stat -> accept everything
    b.stats[:] = [20, 10, 10, 10]
    # mean 12.5; bc0: 20-12.5 = 7.5 > 0.4*12.5 -> reject
    assert not b.decide(0)
    assert b.decide(1)
    b2 = BarcodeBalancer(4, BalancerConfig(balance_type="adapter_count", barcodes_blacklist=(2,),
                                           barcodes_ignorelist=(3,)))
    assert not b2.decide(2)
    assert b2.decide(3)
    b3 = BarcodeBalancer(4, BalancerConfig(balance_type="adapter_count", max_stats={1: 5}))
    b3.stats[1] = 5
    assert not b3.decide(1)


@pytest.mark.parametrize("balance_type, accepts", [("none", True), ("reject_all", False)])
def test_reject_all_and_none(balance_type, accepts):
    assert BarcodeBalancer(4, BalancerConfig(balance_type=balance_type)).decide(0) == accepts


def test_dummy_session_end_to_end(model, tmp_path):
    """Replayed reads whose adapters embed support-vector fingerprints are
    classified with confidence; reject_all unblocks every classified read."""
    rng = np.random.default_rng(2)
    X_sv = model.X_sv.numpy()
    signals = [synth_barcoded_read(rng, X_sv[i]) for i in range(0, 240, 10)]
    client = DummyClient(n_reads=24, chunk_size=1500, seed=3, signals=signals)
    session = _session(client, model, tmp_path, "reject_all", check_real_range=False, max_batch=8)
    session.run(batch_size=32, warmup=False)

    assert len(client.stopped) + len(client.unblocked) > 0
    with open(tmp_path / "barcode_balancing_t.csv", newline="") as fh:
        rows = list(csv.DictReader(fh))
    assert len(rows) > 0
    classified = [r for r in rows if r["outcome"] == "classified"]
    assert len(classified) >= len(rows) * 0.3
    assert all(r["decision"] == "reject" for r in classified)
    assert len(client.unblocked) >= len(classified)
    assert "classification" in session.reporter.latency_stats()


def test_live_config_parser(tmp_path):
    from warpdemux_tpu_torch.live.config_parser import parse_live_config

    cfg_file = tmp_path / "live.toml"
    cfg_file.write_text(f"""
[model]
model_name = "WDX4_rna004_v1_0"
[flowcell]
flowcell_type = "flongle"
[[balancers]]
balance_type = "adapter_count"
balance_threshold = 0.3
channel_frac = 1.0
[balancing]
pred_conf_threshold = 0.25
[reporting]
save_path = "{tmp_path}"
""")
    scfg, bcfgs, fracs, n_channels = parse_live_config(cfg_file)
    assert scfg.pred_conf_threshold == 0.25
    assert n_channels == 126
    assert bcfgs[0].balance_type == "adapter_count"
    assert fracs == [1.0]


class _Client:
    is_running = False

    def __init__(self):
        self.stopped = []

    def stop_receiving_read(self, channel, read_number):
        self.stopped.append((channel, read_number))


def test_missed_start_gate_uses_start_sample(model, tmp_path):
    """The gate fires on chunk_start - start_sample (samples missed before
    the first captured chunk), not on the absolute chunk_start."""
    client = _Client()
    session = _session(client, model, tmp_path, max_missed_start_offset=400)
    sig = np.zeros(1200, np.float32)
    session._handle_chunk(1, LiveRead(1, "late", 1, sig, chunk_start=5000, start_sample=1000))
    assert session.skip_stats["missed_reads"] == 1
    assert session.skip_stats["missed_obs_last"] == 4000
    assert client.stopped == [(1, 1)]
    session._handle_chunk(2, LiveRead(2, "ok", 2, sig, chunk_start=5000, start_sample=4900))
    assert session.skip_stats["missed_reads"] == 1
    assert session.skip_stats["missed_obs_last"] == 100
    assert client.stopped == [(1, 1)]


def test_negative_missed_obs_trims_leading_samples(model, tmp_path):
    """A read that starts inside its first captured chunk loses the leading
    samples before any gate sees it."""
    session = _session(_Client(), model, tmp_path, max_chunk_size=1000)
    sig = np.zeros(1500, np.float32)
    session._handle_chunk(1, LiveRead(1, "in", 1, sig, chunk_start=1000, start_sample=1600))
    assert session.skip_stats["missed_obs_last"] == -600
    assert session.skip_stats["too_long_reads"] == 0  # 900 samples left
    session._handle_chunk(2, LiveRead(2, "full", 2, sig, chunk_start=1000, start_sample=1000))
    assert session.skip_stats["too_long_reads"] == 1


def test_session_defaults_to_the_gpu_and_checks_the_model_device(model, tmp_path, monkeypatch):
    import torch

    balancers = BarcodeBalancers.from_configs(4, [BalancerConfig()], [1.0], n_channels=4)
    cfg = SessionConfig(save_path=str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session(_Client(), cfg, balancers, model=model)
    with pytest.raises(ValueError, match="the session runs on"):
        Session(_Client(), cfg, balancers, model=model, device="meta")
