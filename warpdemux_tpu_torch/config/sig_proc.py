"""Signal-processing configuration: chemistry TOML -> stage configs.

JAX-free copies of the JAX package's frozen config dataclasses
(`DetectConfig` from detect/boundaries.py, `FingerprintConfig` from
ops/fingerprint.py, `SegmentationExtra` and `SigProcConfig` from
config/sig_proc.py), with the same fields, defaults and TOML parsing, so
that loading a chemistry config never imports jax.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DetectConfig:
    # primary method: "llr" | "start_peak" | "cnn"
    method: str = "llr"
    # [core]
    max_obs_trace: int = 10000
    min_obs_adapter: int = 2000
    max_obs_adapter: int = 6000
    min_obs_polya: int = 100
    downscale_factor: int = 10
    # poly(A) validation ([mvs_polya])
    polya_scale: float = 1.3
    mean_window: int = 200
    var_window: int = 500
    polya_var_max: float = 30.0
    median_shift_min: float = 5.0
    # candidate search thresholds (default to the validation values)
    search_scale: float = 1.3
    search_var_max: float = 30.0
    llr_refine_window: int = 400
    mvs_detect_check: bool = True
    # [real_range]
    real_signal_check: bool = False
    local_range: tuple = (7.0, 35.0)
    adapter_mad_range: tuple = (3.0, 12.0)
    local_range_window: int = 300
    max_obs_local_range: int = 5000
    detect_open_pores: bool = False
    open_pore_pa: float = 195.0
    # [med_shift]
    detect_med_shift: bool = False
    med_shift_window: int = 10000
    med_shift_min: float = 5.0
    # [rna_start_peak]
    start_peak_max_idx: int = 150
    sp_offset1: int = 10
    sp_offset2: int = 100
    min_start_peak_pa: float = 83.0
    sp_polya_scale: float = 1.3
    min_len_polya: int = 10
    sp_detect_polya: bool = True
    # [cnn_boundaries]
    cnn_polya_cand_k: int = 5
    # the CNN region prior sees only the first cnn_input_cap samples
    # (0 disables the cap)
    cnn_input_cap: int = 7168
    # reads the primary method fails are re-detected with the LLR method
    fallback_to_llr: bool = False


@dataclass(frozen=True)
class FingerprintConfig:
    # [sig_extract]
    padding: int = 100
    extract_normalization: str = "none"
    # [core]
    sig_norm_outlier_thresh: float = 5.0
    max_obs_adapter: int = 6000
    # [segmentation]
    num_events: int = 110
    min_obs_per_base: int = 6
    running_stat_width: int = 12
    normalization: str = "mean"
    barcode_num_events: int = 25
    accept_less_cpts: bool = False

    @property
    def buffer_len(self) -> int:
        # max adapter + padding at both ends, rounded up to a multiple of 128
        raw = self.max_obs_adapter + 2 * self.padding
        return -(-raw // 128) * 128


@dataclass(frozen=True)
class SegmentationExtra:
    """Consensus-refinement knobs (the tRNA path)."""

    consensus_refinement: bool = False
    consensus_model: str = ""
    consensus_subseq_match_normalization: str = "mean"
    consensus_subseq_match_penalty: float = 1.5
    consensus_subseq_match_psi: tuple = (5, 0, 40, 0)
    consensus_subseq_match_ub_start: int = 18
    consensus_subseq_match_lb_end: int = 69
    consensus_subseq_match_ub_end: int = 97
    refinement_optimal_cpts: bool = False
    barcode_seg_num_events: int = 25


@dataclass(frozen=True)
class SigProcConfig:
    """Aggregated, hashable signal-processing configuration."""

    detect: DetectConfig = DetectConfig()
    fingerprint: FingerprintConfig = FingerprintConfig()
    seg_extra: SegmentationExtra = SegmentationExtra()
    primary_method: str = "llr"  # llr | cnn | start_peak
    sig_preload_size: int = 10000
    cnn_model_name: str = ""
    cnn_polya_cand_k: int = 5

    @classmethod
    def from_dict(cls, d: dict) -> "SigProcConfig":
        core = d.get("core", {})
        seg = d.get("segmentation", {})
        sx = d.get("sig_extract", {})
        mvs = d.get("mvs_polya", {})
        rr = d.get("real_range", {})
        ms = d.get("med_shift", {})
        sp = d.get("rna_start_peak", {})
        cnn = d.get("cnn_boundaries", {})

        def rng(v, default):
            if v is None:
                return default
            return tuple(float(x) for x in v)

        if bool(cnn.get("cnn_detect", False)):
            primary = "cnn"
        elif bool(sp.get("detect_rna_start_peak", False)):
            primary = "start_peak"
        else:
            primary = "llr"

        scale_rng = mvs.get("pA_mean_adapter_med_scale_range")
        polya_scale = float(
            scale_rng[0]
            if scale_rng
            else sp.get("adapter_med_polya_mean_scale", 1.3)
        )
        var_rng = rng(mvs.get("pA_var_range"), (float("-inf"), 30.0))
        if primary == "cnn":
            fallback = bool(cnn.get("fallback_to_llr", True))
        elif primary == "start_peak":
            fallback = bool(sp.get("fallback_to_llr", False))
        else:
            fallback = False
        detect = DetectConfig(
            method=primary,
            max_obs_trace=int(core.get("max_obs_trace", 10000)),
            min_obs_adapter=int(core.get("min_obs_adapter", 2000)),
            max_obs_adapter=int(core.get("max_obs_adapter", 6000)),
            min_obs_polya=int(core.get("min_obs_polya", 100)),
            downscale_factor=int(core.get("downscale_factor", 10)),
            polya_scale=polya_scale,
            polya_var_max=float(var_rng[1]),
            median_shift_min=float(
                rng(mvs.get("median_shift_range"), (5.0, float("inf")))[0]
            ),
            search_scale=float(mvs.get("search_scale", polya_scale)),
            search_var_max=float(
                rng(mvs.get("search_var_range"), var_rng)[1]
            ),
            mvs_detect_check=bool(mvs.get("mvs_detect_check", True)),
            real_signal_check=bool(rr.get("real_signal_check", False)),
            local_range=rng(rr.get("local_range"), (7.0, 35.0)),
            adapter_mad_range=rng(rr.get("adapter_mad_range"), (3.0, 12.0)),
            local_range_window=int(rr.get("mean_window", 300)),
            max_obs_local_range=int(rr.get("max_obs_local_range", 5000)),
            detect_open_pores=bool(rr.get("detect_open_pores", False)),
            open_pore_pa=float(sp.get("open_pore_pa", 195.0)),
            detect_med_shift=bool(ms.get("detect_med_shift", False)),
            med_shift_window=int(ms.get("med_shift_window", 10000)),
            med_shift_min=float(
                rng(ms.get("med_shift_range"), (5.0, float("inf")))[0]
            ),
            start_peak_max_idx=int(sp.get("start_peak_max_idx", 150)),
            sp_offset1=int(sp.get("offset1", 10)),
            sp_offset2=int(sp.get("offset2", 100)),
            min_start_peak_pa=float(sp.get("min_start_peak_pa", 83.0)),
            sp_polya_scale=float(
                sp.get("adapter_med_polya_mean_scale", 1.3)
            ),
            min_len_polya=int(sp.get("min_len_polya", 10)),
            sp_detect_polya=bool(sp.get("detect_polya", True)),
            cnn_polya_cand_k=int(cnn.get("polya_cand_k", 5)),
            cnn_input_cap=int(cnn.get("input_cap", 7168)),
            fallback_to_llr=fallback,
        )

        bne = seg.get("barcode_num_events", 25)
        if isinstance(bne, (list, tuple)):
            barcode_seg_num_events, barcode_num_events = int(bne[0]), int(bne[1])
        else:
            barcode_seg_num_events = barcode_num_events = int(bne)

        fingerprint = FingerprintConfig(
            padding=int(sx.get("padding", 100)),
            extract_normalization=str(sx.get("normalization", "none")),
            sig_norm_outlier_thresh=float(
                core.get("sig_norm_outlier_thresh", 5.0)
            ),
            max_obs_adapter=detect.max_obs_adapter,
            num_events=int(seg.get("num_events", 110)),
            min_obs_per_base=int(seg.get("min_obs_per_base", 6)),
            running_stat_width=int(seg.get("running_stat_width", 12)),
            normalization=str(seg.get("normalization", "mean")),
            barcode_num_events=barcode_num_events,
            accept_less_cpts=bool(seg.get("accept_less_cpts", False)),
        )

        seg_extra = SegmentationExtra(
            consensus_refinement=bool(seg.get("consensus_refinement", False)),
            consensus_model=str(seg.get("consensus_model", "")),
            consensus_subseq_match_normalization=str(
                seg.get("consensus_subseq_match_normalization", "mean")
            ),
            consensus_subseq_match_penalty=float(
                seg.get("consensus_subseq_match_penalty", 1.5)
            ),
            consensus_subseq_match_psi=tuple(
                seg.get("consensus_subseq_match_psi", (5, 0, 40, 0))
            ),
            consensus_subseq_match_ub_start=int(
                seg.get("consensus_subseq_match_ub_start", 18)
            ),
            consensus_subseq_match_lb_end=int(
                seg.get("consensus_subseq_match_lb_end", 69)
            ),
            consensus_subseq_match_ub_end=int(
                seg.get("consensus_subseq_match_ub_end", 97)
            ),
            refinement_optimal_cpts=bool(
                seg.get("refinement_optimal_cpts", False)
            ),
            barcode_seg_num_events=barcode_seg_num_events,
        )

        return cls(
            detect=detect,
            fingerprint=fingerprint,
            seg_extra=seg_extra,
            primary_method=primary,
            sig_preload_size=detect.max_obs_trace,
            cnn_model_name=str(
                cnn.get("model_name", "rna004_cnn_synth_v1")
            ),
            cnn_polya_cand_k=int(cnn.get("polya_cand_k", 5)),
        )
