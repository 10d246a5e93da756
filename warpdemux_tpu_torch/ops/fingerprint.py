"""Detect results -> barcode fingerprints, batched.

Port of warpdemux_tpu/ops/fingerprint.py `fingerprints_from_boundaries`
(the consensus-refined tRNA path is not ported):

1. adapter extraction with padding into a fixed (B, buffer_len) buffer
   (kernel K5 on CUDA),
2. outlier clipping to median +/- thresh * MAD (kernel K4),
3. event segmentation into num_events changepoints (kernels K2, K3),
4. mean/std normalization of the event means,
5. fingerprint = the last barcode_num_events normalized event means,
6. adapter event statistics.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from warpdemux_tpu_torch.config.sig_proc import FingerprintConfig
from warpdemux_tpu_torch.ops.normalize import (
    clip_outliers_prefix,
    masked_mad,
    masked_median,
    mean_std,
)
from warpdemux_tpu_torch.ops.segmentation import segment_signal_batch
from warpdemux_tpu_torch.ops.window_gather import shift_rows


class FingerprintArrays(NamedTuple):
    """Batched fingerprint results; (B, ...) tensors."""

    ok: torch.Tensor  # bool: segmentation + normalization succeeded
    fpt: torch.Tensor  # (B, barcode_num_events) float32
    dwell: torch.Tensor  # (B, barcode_num_events) int32
    adapter_dt_med: torch.Tensor
    adapter_dt_mad: torch.Tensor
    adapter_event_mean: torch.Tensor
    adapter_event_std: torch.Tensor
    adapter_event_med: torch.Tensor
    adapter_event_mad: torch.Tensor


def extract_adapter_batch(
    signals, in_lens, adapter_start, adapter_end, padding: int, buffer_len: int
):
    """Copy [max(0, start - pad), min(len, end + pad)) into a fixed buffer.

    Returns (buffer (B, buffer_len), lengths (B,)). The buffer is zero past
    a row's length and where the window leaves the signal: the gather
    fills those itself (`shift_rows` with lengths)."""
    start = torch.clamp_min(adapter_start - padding, 0)
    end = torch.minimum(in_lens, adapter_end + padding)
    length = (end - start).clamp(0, buffer_len)
    return shift_rows(signals, start, buffer_len, length), length


def fingerprints_from_boundaries(
    signals: torch.Tensor,
    in_lens: torch.Tensor,
    adapter_start: torch.Tensor,
    adapter_end: torch.Tensor,
    cfg: FingerprintConfig = FingerprintConfig(),
) -> FingerprintArrays:
    if cfg.extract_normalization != "none":
        raise NotImplementedError(
            "sig_extract.normalization other than 'none' is not ported"
        )
    adapter, a_len = extract_adapter_batch(
        signals,
        in_lens.to(torch.int32),
        adapter_start.to(torch.int32),
        adapter_end.to(torch.int32),
        cfg.padding,
        cfg.buffer_len,
    )
    B, A = adapter.shape
    amask = torch.arange(A, device=signals.device)[None, :] < a_len[:, None]
    adapter = clip_outliers_prefix(adapter, a_len, cfg.sig_norm_outlier_thresh)
    adapter = torch.where(amask, adapter, torch.zeros_like(adapter))

    means, dwell, seg_ok, _, _, _ = segment_signal_batch(
        adapter,
        a_len,
        cfg.num_events,
        cfg.min_obs_per_base,
        cfg.running_stat_width,
    )
    all_mask = torch.ones_like(means, dtype=torch.bool)

    # normalize event means over ALL events, keep the last
    # barcode_num_events as the fingerprint
    ev_mean, ev_std = mean_std(means)
    norm_ok = ev_std > 0
    norm_means = (means - ev_mean[:, None]) / torch.where(
        norm_ok, ev_std, torch.ones_like(ev_std)
    )[:, None]
    k = cfg.barcode_num_events
    dwell_f = dwell.to(torch.float32)
    dt_med = masked_median(dwell_f, all_mask)
    ev_med = masked_median(means, all_mask)
    return FingerprintArrays(
        ok=seg_ok & norm_ok,
        fpt=norm_means[:, -k:],
        dwell=dwell[:, -k:],
        adapter_dt_med=dt_med,
        adapter_dt_mad=masked_mad(dwell_f, all_mask, dt_med),
        adapter_event_mean=ev_mean,
        adapter_event_std=ev_std,
        adapter_event_med=ev_med,
        adapter_event_mad=masked_mad(means, all_mask, ev_med),
    )
