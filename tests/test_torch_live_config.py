"""The live TOML schema on the port: the flows of tests/test_live_config.py
(the seven reference TOML shapes, the validation errors, the channel
assignment, the per-balancer reject_duration on the wire) through
warpdemux_tpu_torch, plus the parsed configuration and the model's live
chemistry overlay against the JAX package's, and `build_session`'s device."""

import dataclasses

import numpy as np
import pytest
import torch

from warpdemux_tpu.live.config_parser import _live_chemistry_overlay as jax_overlay
from warpdemux_tpu.live.config_parser import parse_live_config_full as jax_parse
from warpdemux_tpu_torch.live.balancer import BalancerConfig, BarcodeBalancers
from warpdemux_tpu_torch.live.config_parser import (
    _live_chemistry_overlay,
    build_session,
    parse_live_config_full,
)
from warpdemux_tpu_torch.live.session import ReadObject, Session, SessionConfig
from warpdemux_tpu_torch.models.registry import load_model


def _write(tmp_path, body, name="live.toml"):
    p = tmp_path / name
    p.write_text(body)
    return p


BASE = """
[model]
model_name = "WDX12_rna002_v0_4_4"

[flowcell]
flowcell_type = "flongle"

[processing]
nproc_segmentation = 2
nproc_classification = 4

[acquisition]
max_missed_start_offset = 400
max_chunk_size = 12000

[balancing]
pred_conf_threshold = 0.2

[reporting]
save_every_sec = 5
save_path = "results"
"""

MULTIPLE = """
[[balancers]]
balance_threshold = 0.05
min_stat = 100
balance_type = "adapter_count"
name = "adapter_count1"
channel_frac = 0.4
blacklist_barcode08 = true
watch_barcode00 = false

[[balancers]]
balance_threshold = 0.05
min_stat = 30
balance_type = "adapter_count"
name = "adapter_count2"
channel_frac = 0.4
blacklist_barcode03 = true
watch_for_missing = false
max_barcode01 = 40

[[balancers]]
balance_threshold = 0.05
min_stat = 100
balance_type = "none"
channel_frac = 0.1
blacklist_barcode03 = true
watch_for_missing = false
"""


# ---- the 7 reference TOML shapes ------------------------------------------

def test_shape_only_none(tmp_path):
    pc = parse_live_config_full(_write(tmp_path, BASE + """
[[balancers]]
balance_threshold = 0.05
min_stat = 100
balance_type = "none"
"""))
    assert pc.n_channels == 126  # flongle
    assert pc.session.nproc_segmentation == 2
    assert pc.session.nproc_classification == 4
    assert pc.session.save_every_sec == 5
    assert pc.session.max_chunk_size == 12000
    assert pc.balancers[0].balance_type == "none"
    assert pc.balancers[0].name == "none"


def test_shape_only_reject_all(tmp_path):
    pc = parse_live_config_full(_write(tmp_path, BASE + """
[[balancers]]
balance_threshold = 0.05
min_stat = 100
balance_type = "reject_all"
"""))
    assert pc.balancers[0].balance_type == "reject_all"


def test_shape_only_adapter_count(tmp_path):
    b = parse_live_config_full(_write(tmp_path, BASE + """
[[balancers]]
balance_threshold = 0.05
min_stat = 100
balance_type = "adapter_count"

blacklist_barcode08 = true
watch_barcode00 = false
""")).balancers[0]
    assert b.barcodes_blacklist == (8,)
    assert b.barcodes_ignorelist == (0,)
    assert b.balance_threshold == 0.05
    assert b.min_stat == 100


@pytest.mark.parametrize("balance_type, frac", [("read_count", 0.95), ("base_normalization", 0.9)])
def test_shape_watcher_balancers(tmp_path, balance_type, frac):
    b = parse_live_config_full(_write(tmp_path, BASE + f"""
[[balancers]]
balance_threshold = 0.4
min_stat = 10
balance_type = "{balance_type}"
pod5_watch_dir = "{tmp_path}"
pod5_check_interval = 0.5
channel_frac = {frac}
""")).balancers[0]
    assert b.balance_type == balance_type
    assert b.pod5_watch_dir == str(tmp_path)
    assert b.pod5_check_interval == 0.5
    assert b.channel_frac == frac


def test_shape_multiple_adapter_count(tmp_path):
    pc = parse_live_config_full(_write(tmp_path, BASE.replace("flongle", "minion") + MULTIPLE))
    assert pc.n_channels == 512  # minion
    b0, b1, b2 = pc.balancers
    assert (b0.name, b1.name, b2.name) == ("adapter_count1", "adapter_count2", "none")
    assert b1.max_stats == {1: 40.0}
    assert b1.watch_for_missing is False
    assert b0.watch_for_missing is True
    assert b1.barcodes_blacklist == (3,)
    # 40% + 40% + 10%; the leftover 10% folds into the first 'none' balancer
    bb = BarcodeBalancers.from_configs(12, pc.balancers, n_channels=pc.n_channels)
    counts = np.bincount([bb.channel_map[c] for c in range(1, 513)], minlength=3)
    assert counts[0] == int(0.4 * 512)
    assert counts[1] == int(0.4 * 512)
    assert counts[2] == 512 - counts[0] - counts[1]
    assert len(bb.balancers) == 3  # no extra balancer created


def test_shape_multiple_with_reject_durations(tmp_path):
    pc = parse_live_config_full(_write(tmp_path, BASE + """
[[balancers]]
balance_type = "adapter_count"
name = "adapter_count1"
channel_frac = 0.4
reject_duration = 0.1

[[balancers]]
balance_type = "adapter_count"
name = "adapter_count2"
channel_frac = 0.4
reject_duration = 0.2

[[balancers]]
balance_type = "none"
channel_frac = 0.1
reject_duration = 0.3
"""))
    assert [b.reject_duration for b in pc.balancers] == [0.1, 0.2, 0.3]
    p2 = _write(tmp_path, BASE + """
[[balancers]]
balance_type = "adapter_count"
""", name="live2.toml")
    assert parse_live_config_full(p2).balancers[0].reject_duration is None  # the global one applies


# ---- validation errors ------------------------------------------------------

@pytest.mark.parametrize(
    "body, match",
    [
        ('\n[model]\nmodel_name = "WDX4_rna004_v1_0"\n', "[Ff]lowcell"),
        (BASE + '\n[[balancers]]\nbalance_type = "none"\nnot_a_real_knob = 3\n', "Unknown key"),
        (BASE.replace("max_chunk_size = 12000", "max_chunk_size = 12000\nbogus = 1"), "Unknown key"),
        (BASE.replace("max_chunk_size = 12000", "max_chunk_size = 1000\nmin_chunk_size = 2000"), "min_chunk_size"),
        (BASE + '\n[[balancers]]\nbalance_type = "none"\nchannel_frac = 0.5\nchannel_num = 10\n',
         "channel_frac and channel_num"),
        (BASE + '\n[[balancers]]\nbalance_type = "adapter_count"\nblacklist_barcode02 = true\nwatch_barcode02 = false\n',
         "blacklisted and ignored"),
        (BASE + '\n[[balancers]]\nbalance_type = "read_count"\n', "pod5_watch_dir"),
        (BASE + '\n[[balancers]]\nbalance_type = "adapter_count"\nchannel_frac = 0.5\n'
                '\n[[balancers]]\nbalance_type = "adapter_count"\nchannel_frac = 0.5\n', "[Dd]uplicate"),
        (BASE.replace('flowcell_type = "flongle"', 'flowcell_type = "flongle"\nmax_channel = 500'), "max_channel"),
    ],
    ids=["flowcell required", "unknown balancer key", "unknown section key", "min > max chunk",
         "channel_frac xor channel_num", "blacklist and ignore", "watcher needs a directory",
         "duplicate names", "max_channel above the flowcell"],
)
def test_invalid_config_rejected(tmp_path, body, match):
    with pytest.raises(ValueError, match=match):
        parse_live_config_full(_write(tmp_path, body))


# ---- channel assignment -----------------------------------------------------

def test_explicit_channel_list(tmp_path):
    pc = parse_live_config_full(_write(tmp_path, BASE + """
[[balancers]]
balance_type = "reject_all"
channels = [1, 2, 3]

[[balancers]]
balance_type = "none"
channel_frac = 0.5
"""))
    assert pc.balancers[0].channels == (1, 2, 3)
    bb = BarcodeBalancers.from_configs(4, pc.balancers, n_channels=pc.n_channels)
    assert all(bb.channel_map[c] == 0 for c in (1, 2, 3))
    assert sum(1 for i in bb.channel_map.values() if i == 0) == 3  # in no other draw


def test_channel_num_assignment(tmp_path):
    pc = parse_live_config_full(_write(tmp_path, BASE + """
[[balancers]]
balance_type = "reject_all"
channel_num = 10

[[balancers]]
balance_type = "none"
channel_frac = 0.5
"""))
    bb = BarcodeBalancers.from_configs(4, pc.balancers, n_channels=pc.n_channels)
    assert sum(1 for i in bb.channel_map.values() if i == 0) == 10


def test_min_max_channel_bounds(tmp_path):
    pc = parse_live_config_full(_write(tmp_path, BASE.replace(
        'flowcell_type = "flongle"', 'flowcell_type = "flongle"\nmin_channel = 50\nmax_channel = 60')))
    bb = BarcodeBalancers.from_configs(
        4, pc.balancers or [BalancerConfig(channel_frac=1.0)], n_channels=pc.n_channels,
        min_channel=pc.min_channel, max_channel=pc.max_channel,
    )
    assert set(bb.channel_map) == set(range(50, 61))


def test_promethion_channel_count(tmp_path):
    assert parse_live_config_full(_write(tmp_path, BASE.replace("flongle", "promethion"))).n_channels == 2675


# ---- the same parse, and the same chemistry overlay, as the JAX package ----

@pytest.mark.parametrize("model_name", ["WDX12_rna002_v0_4_4", "WDX4_rna004_v1_0"])
def test_parse_and_overlay_equal_jax(tmp_path, model_name):
    """WDX12 has an spc_live overlay ([streaming], [real_range]); WDX4 none."""
    p = _write(tmp_path, BASE.replace("WDX12_rna002_v0_4_4", model_name).replace("flongle", "minion") + MULTIPLE)
    pc, jpc = parse_live_config_full(p), jax_parse(p)
    assert [dataclasses.asdict(b) for b in pc.balancers] == [dataclasses.asdict(b) for b in jpc.balancers]
    assert (pc.n_channels, pc.min_channel, pc.max_channel, pc.flowcell_type) == (
        jpc.n_channels, jpc.min_channel, jpc.max_channel, jpc.flowcell_type)
    got, want = _live_chemistry_overlay(pc.session), jax_overlay(jpc.session)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.streaming != SessionConfig().streaming) == (model_name == "WDX12_rna002_v0_4_4")


def test_build_session_defaults_to_the_gpu(tmp_path, monkeypatch):
    p = _write(tmp_path, BASE.replace("WDX12_rna002_v0_4_4", "WDX4_rna004_v1_0").replace(
        'save_path = "results"', f'save_path = "{tmp_path}"') + '\n[[balancers]]\nbalance_type = "none"\n')
    session = build_session(p, client=object(), device="cpu")
    assert session.device == torch.device("cpu") and session.model.X_sv.device.type == "cpu"
    session.reporter.close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_session(p, client=object())


# ---- per-balancer reject_duration drives the unblock call ------------------

class _Client:
    is_running = False

    def __init__(self):
        self.unblocked = []
        self.stopped = []

    def stop_receiving_read(self, ch, num):
        self.stopped.append((ch, num))

    def unblock_read(self, ch, num, duration):
        self.unblocked.append((ch, num, duration))


def test_reject_duration_reaches_unblock(tmp_path):
    """Two balancers with different reject_durations give different unblock
    durations on the wire (reference worker.py:196-205)."""
    cfg = SessionConfig(model_name="WDX4_rna004_v1_0", save_path=str(tmp_path), run_id="rd",
                        reject_duration=0.05, max_signal_after_polya=10_000)
    balancers = BarcodeBalancers.from_configs(4, [
        BalancerConfig(balance_type="reject_all", name="fast", reject_duration=0.15, channels=(1,)),
        BalancerConfig(balance_type="reject_all", name="slow", reject_duration=0.45, channels=(2,)),
        BalancerConfig(balance_type="reject_all", name="default", channels=(3,)),
    ], n_channels=4)
    client = _Client()
    session = Session(client, cfg, balancers, model=load_model("WDX4_rna004_v1_0", "cpu"), device="cpu")
    for ch in (1, 2, 3):
        session._decide_and_act(ReadObject(
            channel=ch, read_id=f"r{ch}", read_number=ch, signal=np.zeros(1000, np.float32),
            polya_start=900, barcode=0, outcome="classified",
        ))
    session.reporter.close()
    durations = {ch: d for ch, _, d in client.unblocked}
    assert durations == {1: 0.15, 2: 0.45, 3: 0.05}  # 3: the global [balancing] reject_duration
