"""Live-balancing TOML configuration (a copy of
warpdemux_tpu/live/config_parser.py; `build_session` takes the device).

Full schema parity with the reference parser
(warpdemux/live_balancing/config_parser.py): sections [model], [flowcell]
(required; flongle/minion/promethion channel counts, min/max_channel),
[processing] (worker counts), [acquisition] (chunk-size bounds, missed-start
offset, repeated-unblock escalation), [balancing] (global confidence
threshold, reject_duration, max_signal_after_polya), [reporting]
(save_path, save_every_sec), and [[balancers]] entries with
name / balance_type / balance_threshold / min_stat / channel_frac XOR
channel_num XOR explicit channels / per-balancer reject_duration and
pred_conf_threshold / watch_for_missing / wait_to_see / pod5 watcher knobs /
per-barcode blacklist_barcodeNN, watch_barcodeNN, max_barcodeNN keys.

Unknown keys raise (reference _check_for_unknown_keys); min/max chunk and
channel bounds are validated; leftover channels are folded into a 'none'
balancer by BarcodeBalancers.from_configs.
"""

from __future__ import annotations

import tomllib
from pathlib import Path

from warpdemux_tpu_torch.live.balancer import BalancerConfig, BarcodeBalancers
from warpdemux_tpu_torch.live.session import SessionConfig

# reference config_parser.py FlowcellConfig.channel_num_dict
FLOWCELL_CHANNELS = {"flongle": 126, "minion": 512, "promethion": 2675}

# reference _defaults.py
DEFAULT_MAX_CHUNK_SIZE = 15000
DEFAULT_MIN_CHUNK_SIZE = 2500
DEFAULT_MAX_MISSED_START_OFFSET = 400
DEFAULT_PRED_CONF_THRESHOLD = 0.2
DEFAULT_REJECT_DURATION = 0.1
DEFAULT_REPEATED_UNBLOCK_TIME_WINDOW = 1.5
DEFAULT_REPEATED_UNBLOCK_DURATION_2 = 0.5
DEFAULT_REPEATED_UNBLOCK_DURATION_3 = 2.0
DEFAULT_MAX_SIGNAL_AFTER_POLYA = 1500
DEFAULT_SAVE_EVERY_SEC = 30
DEFAULT_NPROC_SEGMENTATION = 2
DEFAULT_NPROC_CLASSIFICATION = 4
DEFAULT_BALANCE_THRESHOLD = 0.05
DEFAULT_MIN_STAT = 100
DEFAULT_BALANCE_TYPE = "adapter_count"
DEFAULT_WATCH_FOR_MISSING = True
DEFAULT_WAIT_TO_SEE = 900
DEFAULT_POD5_CHECK_INTERVAL = 1.0

_SECTION_KEYS = {
    "model": {"model_name"},
    "flowcell": {"flowcell_type", "min_channel", "max_channel"},
    "processing": {"nproc_segmentation", "nproc_classification"},
    "acquisition": {
        "max_missed_start_offset",
        "max_chunk_size",
        "min_chunk_size",
        "min_adapter_length",
        "repeated_unblock_time_window",
        "repeated_unblock_duration_2",
        "repeated_unblock_duration_3",
    },
    "balancing": {
        "pred_conf_threshold",
        "reject_duration",
        "max_signal_after_polya",
    },
    "reporting": {"save_path", "save_every_sec"},
}

_BALANCER_KEYS = {
    "name",
    "balance_type",
    "balance_threshold",
    "min_stat",
    "pred_conf_threshold",
    "channel_frac",
    "channel_num",
    "channels",
    "reject_duration",
    "watch_for_missing",
    "wait_to_see",
    "pod5_watch_dir",
    "pod5_check_interval",
}


def _check_unknown(section: str, d: dict, allowed: set):
    for k in d:
        if k not in allowed:
            raise ValueError(f"Unknown key {k!r} in config [{section}].")


class ParsedLiveConfig:
    """Everything parse_live_config extracts, in one place."""

    def __init__(self, session, balancers, n_channels, min_channel,
                 max_channel, flowcell_type):
        self.session = session
        self.balancers = balancers
        self.n_channels = n_channels
        self.min_channel = min_channel
        self.max_channel = max_channel
        self.flowcell_type = flowcell_type


def parse_live_config_full(path: str | Path) -> ParsedLiveConfig:
    with open(path, "rb") as f:
        d = tomllib.load(f)

    for section, allowed in _SECTION_KEYS.items():
        _check_unknown(section, d.get(section, {}), allowed)
    known_top = set(_SECTION_KEYS) | {"balancers"}
    _check_unknown("<top level>", {k: v for k, v in d.items()}, known_top)

    model_name = d.get("model", {}).get("model_name", "WDX4_rna004_v1_0")

    # [flowcell] — required in the reference (config_parser.py:388-391)
    fcd = d.get("flowcell")
    if not fcd or "flowcell_type" not in fcd:
        raise ValueError("Flowcell section / flowcell_type missing in config.")
    fc = fcd["flowcell_type"]
    if fc not in FLOWCELL_CHANNELS:
        raise ValueError(
            f"Unknown flowcell type {fc!r}. Supported: "
            f"{sorted(FLOWCELL_CHANNELS)}."
        )
    n_channels = FLOWCELL_CHANNELS[fc]
    min_channel = int(fcd.get("min_channel", 1))
    max_channel = int(fcd.get("max_channel", n_channels))
    if min_channel < 1:
        raise ValueError(f"min_channel {min_channel} can't be smaller than 1.")
    if max_channel > n_channels:
        raise ValueError(
            f"max_channel {max_channel} can't be larger than channel_num "
            f"{n_channels} (flowcell {fc})."
        )

    proc = d.get("processing", {})
    acq = d.get("acquisition", {})
    bal = d.get("balancing", {})
    rep = d.get("reporting", {})

    max_chunk = int(acq.get("max_chunk_size", DEFAULT_MAX_CHUNK_SIZE))
    min_chunk = int(acq.get("min_chunk_size", DEFAULT_MIN_CHUNK_SIZE))
    if min_chunk > max_chunk:
        raise ValueError(
            f"min_chunk_size {min_chunk} can't be larger than "
            f"max_chunk_size {max_chunk}. Please check your config."
        )

    session_cfg = SessionConfig(
        model_name=model_name,
        max_chunk_size=max_chunk,
        min_chunk_size=min_chunk,
        min_adapter_length=int(acq.get("min_adapter_length", min_chunk)),
        max_missed_start_offset=int(
            acq.get("max_missed_start_offset", DEFAULT_MAX_MISSED_START_OFFSET)
        ),
        repeated_unblock_time_window=float(
            acq.get(
                "repeated_unblock_time_window",
                DEFAULT_REPEATED_UNBLOCK_TIME_WINDOW,
            )
        ),
        repeated_unblock_duration_2=float(
            acq.get(
                "repeated_unblock_duration_2",
                DEFAULT_REPEATED_UNBLOCK_DURATION_2,
            )
        ),
        repeated_unblock_duration_3=float(
            acq.get(
                "repeated_unblock_duration_3",
                DEFAULT_REPEATED_UNBLOCK_DURATION_3,
            )
        ),
        pred_conf_threshold=float(
            bal.get("pred_conf_threshold", DEFAULT_PRED_CONF_THRESHOLD)
        ),
        reject_duration=float(
            bal.get("reject_duration", DEFAULT_REJECT_DURATION)
        ),
        max_signal_after_polya=int(
            bal.get("max_signal_after_polya", DEFAULT_MAX_SIGNAL_AFTER_POLYA)
        ),
        nproc_segmentation=int(
            proc.get("nproc_segmentation", DEFAULT_NPROC_SEGMENTATION)
        ),
        nproc_classification=int(
            proc.get("nproc_classification", DEFAULT_NPROC_CLASSIFICATION)
        ),
        save_every_sec=float(rep.get("save_every_sec", DEFAULT_SAVE_EVERY_SEC)),
        save_path=str(rep.get("save_path", "results")),
    )

    balancer_cfgs = []
    names = []
    for b in d.get("balancers", []):
        b = dict(b)
        # per-barcode key forms: blacklist_barcodeNN / watch_barcodeNN /
        # max_barcodeNN (reference config_parser.py:295-320)
        blacklist, ignorelist, max_stats = [], [], {}
        for k in list(b):
            if k.startswith("blacklist_barcode"):
                if bool(b.pop(k)):
                    blacklist.append(int(k[len("blacklist_barcode"):]))
            elif k.startswith("watch_barcode"):
                if not bool(b.pop(k)):
                    ignorelist.append(int(k[len("watch_barcode"):]))
            elif k.startswith("max_barcode"):
                max_stats[int(k[len("max_barcode"):])] = float(b.pop(k))
        _check_unknown("balancers", b, _BALANCER_KEYS)
        both = set(blacklist) & set(ignorelist)
        if both:
            raise ValueError(
                f"Barcode {sorted(both)[0]} can't be both blacklisted and "
                "ignored. Please check your config."
            )
        if b.get("channel_num") is not None and b.get("channel_frac") is not None:
            raise ValueError(
                "Only one of channel_frac and channel_num can be specified."
            )
        btype = str(b.get("balance_type", DEFAULT_BALANCE_TYPE))
        name = str(b.get("name", btype))
        names.append(name)
        if btype in ("read_count", "base_normalization") and not b.get(
            "pod5_watch_dir"
        ):
            raise ValueError(f"pod5_watch_dir is required for mode {btype}")
        rd = b.get("reject_duration")
        pct = b.get("pred_conf_threshold")
        balancer_cfgs.append(
            BalancerConfig(
                balance_type=btype,
                name=name,
                balance_threshold=float(
                    b.get("balance_threshold", DEFAULT_BALANCE_THRESHOLD)
                ),
                min_stat=float(b.get("min_stat", DEFAULT_MIN_STAT)),
                reject_duration=None if rd is None else float(rd),
                pred_conf_threshold=None if pct is None else float(pct),
                watch_for_missing=bool(
                    b.get("watch_for_missing", DEFAULT_WATCH_FOR_MISSING)
                ),
                wait_to_see=float(b.get("wait_to_see", DEFAULT_WAIT_TO_SEE)),
                channel_frac=(
                    float(b["channel_frac"]) if "channel_frac" in b else None
                ),
                channel_num=(
                    int(b["channel_num"]) if "channel_num" in b else None
                ),
                channels=tuple(int(c) for c in b.get("channels", ())),
                barcodes_blacklist=tuple(blacklist),
                barcodes_ignorelist=tuple(ignorelist),
                max_stats=max_stats,
                pod5_watch_dir=str(b.get("pod5_watch_dir", "")),
                pod5_check_interval=float(
                    b.get("pod5_check_interval", DEFAULT_POD5_CHECK_INTERVAL)
                ),
            )
        )
    if len(names) != len(set(names)):
        raise ValueError(
            f"Duplicate balancer found in config: {names}. When using "
            "multiple balancers of the same balance_type, give each a "
            "unique name."
        )
    if not balancer_cfgs:
        balancer_cfgs = [BalancerConfig(channel_frac=1.0)]
    return ParsedLiveConfig(
        session_cfg, balancer_cfgs, n_channels, min_channel, max_channel, fc
    )


def parse_live_config(path: str | Path):
    """Legacy tuple API: (session_cfg, balancer_cfgs, fracs, n_channels)."""
    pc = parse_live_config_full(path)
    fracs = [
        c.channel_frac if c.channel_frac is not None else 1.0
        for c in pc.balancers
    ]
    return pc.session, pc.balancers, fracs, pc.n_channels


def _live_chemistry_overlay(session_cfg):
    """Resolve the model's spc_live chemistry overlay ([streaming] +
    [real_range]; reference config/utils.py:58-65) into the session config.
    Models without an spc_live entry keep the session defaults."""
    from dataclasses import replace

    from warpdemux_tpu_torch.config.utils import load_chemistry_dict, model_config
    from warpdemux_tpu_torch.detect.streaming import RealRangeConfig, StreamingConfig

    try:
        spc_live = model_config(session_cfg.model_name).get("spc_live")
    except KeyError:
        return session_cfg
    if not spc_live:
        return session_cfg
    d = load_chemistry_dict(spc_live)
    st, rr, core = d.get("streaming", {}), d.get("real_range", {}), d.get(
        "core", {}
    )

    def rng(v, default):
        return default if v is None else tuple(float(x) for x in v)

    streaming = StreamingConfig(
        min_obs_adapter=int(core.get("min_obs_adapter", 1500)),
        search_increment_step=int(st.get("search_increment_step", 200)),
        polya_window=int(st.get("polyA_window", 200)),
        pA_var_window=int(st.get("pA_var_window", 500)),
        pA_var_max=float(rng(st.get("pA_var_range"), (0.0, 30.0))[1]),
        min_obs_post_loc=int(st.get("min_obs_post_loc", 100)),
    )
    real_range = RealRangeConfig(
        local_range=rng(rr.get("local_range"), (7.0, 35.0)),
        adapter_mad_range=rng(rr.get("adapter_mad_range"), (3.0, 12.0)),
        mean_window=int(rr.get("mean_window", 300)),
        max_obs_local_range=int(rr.get("max_obs_local_range", 5000)),
    )
    return replace(session_cfg, streaming=streaming, real_range=real_range)


def build_session(config_file: str | Path, client=None, model=None, device=None):
    """Assemble a Session from a live TOML (dummy client by default) on
    `device`: the CUDA GPU unless another is named (RuntimeError without
    one), as `load_model`."""
    from warpdemux_tpu_torch._cuda import resolve_device
    from warpdemux_tpu_torch.models.registry import load_model

    device = resolve_device(device)
    pc = parse_live_config_full(config_file)
    session_cfg = _live_chemistry_overlay(pc.session)
    if model is None:
        model = load_model(session_cfg.model_name, device)
    balancers = BarcodeBalancers.from_configs(
        model.n_classes - 1,
        pc.balancers,
        n_channels=pc.n_channels,
        min_channel=pc.min_channel,
        max_channel=pc.max_channel,
    )
    if client is None:
        from warpdemux_tpu_torch.live.dummy import DummyClient

        client = DummyClient()
    from warpdemux_tpu_torch.live.session import Session

    return Session(client, session_cfg, balancers, model=model, device=device)
