"""Batched adapter / poly(A) boundary detection.

Port of warpdemux_tpu/detect/boundaries.py for the `llr` and `cnn`
methods and the per-read LLR fallback, as the decision lane runs them
(gate statistics only; the region summary statistics are output columns
of the full step and are not computed). RNA004 reads traverse the pore
adapter -> poly(A) -> RNA; detection:

1. forward rolling mean / variance of the calibrated signal (kernel K6),
2. poly(A) candidates: elevated mean (>= adapter-level proxy *
   search_scale) and low variance, sustained for min_obs_polya samples
   (run sums: kernel K7), optionally gated by the CNN region prior,
3. the first sustained candidate gives the adapter -> poly(A) boundary,
   the run's lapse gives poly(A) -> RNA,
4. both are refined to the sample with an exact two-segment Gaussian
   changepoint scan in a local window (window copy: kernel K5),
5. gate medians (kernel K4) and the [mvs_polya] check give the fail codes.

First-index semantics (argmax / argmin) are written out explicitly. The
start_peak method, resolve_limit, [real_range] and [med_shift] gates are
not ported and raise NotImplementedError.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from warpdemux_tpu_torch import _cuda
from warpdemux_tpu_torch.config.sig_proc import DetectConfig
from warpdemux_tpu_torch.detect import cnn as cnn_mod
from warpdemux_tpu_torch.detect.containers import DetectArrays
from warpdemux_tpu_torch.ops.numerics import BLOCK, fma, prefix_sums
from warpdemux_tpu_torch.ops.select import range_median_mad
from warpdemux_tpu_torch.ops.window_gather import shift_rows


def _window_mean_var(c1, c2, w: int, L: int):
    """Mean/var over [t, min(t+w, L)) from (B, L+1) prefix sums."""
    t = torch.arange(L, device=c1.device)
    hi = torch.clamp_max(t + w, L)
    n = (hi - t).to(torch.float32)[None, :]
    s1 = c1[:, hi] - c1[:, :L]
    s2 = c2[:, hi] - c2[:, :L]
    mean = s1 / n
    var = fma(-mean, mean, s2 / n)
    return mean, torch.where(var < 0, torch.zeros_like(var), var)


def rolling_mean_var_plain(xz: torch.Tensor, w_mean: int, w_var: int):
    L = xz.shape[1]
    c1 = prefix_sums(xz)
    c2 = prefix_sums(xz * xz)
    mean_f, var_f = _window_mean_var(c1, c2, w_mean, L)
    _, var_w = _window_mean_var(c1, c2, w_var, L)
    return mean_f, var_f, var_w


def rolling_mean_var(xz: torch.Tensor, w_mean: int, w_var: int):
    """(mean[w_mean], var[w_mean], var[w_var]) over forward windows
    [t, min(t+w, L)) of the validity-zeroed signal; K6 on CUDA."""
    if not _cuda.on_cuda(xz):
        return rolling_mean_var_plain(xz, w_mean, w_var)
    B, L = xz.shape
    xz = xz.contiguous()
    _cuda.check(xz, torch.float32, 2, "rolling_mean_var x")
    # every level of the blocked scan: L + L/16 + L/256 + ... floats a row
    scratch_len, n = L, L
    while n > BLOCK:
        n = -(-n // BLOCK)
        scratch_len += n
    scratch = torch.empty((2, B, scratch_len), dtype=torch.float32, device=xz.device)
    out = torch.empty((3, B, L), dtype=torch.float32, device=xz.device)
    _cuda.launch(
        "wdx_rolling_mean_var", xz.device, xz.data_ptr(), scratch[0].data_ptr(),
        scratch[1].data_ptr(), scratch_len, out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), B, L, int(w_mean), int(w_var),
    )
    return out[0], out[1], out[2]


def run_sum_plain(mask: torch.Tensor, w: int) -> torch.Tensor:
    L = mask.shape[1]
    c = torch.cumsum(mask.to(torch.int32), dim=1, dtype=torch.int32)
    c = torch.cat([c.new_zeros((mask.shape[0], 1)), c], dim=1)
    hi = torch.clamp_max(torch.arange(L, device=mask.device) + w, L)
    return c[:, hi] - c[:, :L]


def run_sum(mask: torch.Tensor, w: int) -> torch.Tensor:
    """int32 count of True in mask[t : min(t+w, L)); K7 on CUDA."""
    if not _cuda.on_cuda(mask):
        return run_sum_plain(mask, w)
    B, L = mask.shape
    mask = mask.contiguous()
    _cuda.check(mask, torch.bool, 2, "run_sum mask")
    out = torch.empty((B, L), dtype=torch.int32, device=mask.device)
    _cuda.launch(
        "wdx_run_sum", mask.device, mask.data_ptr(), out.data_ptr(), B, L, int(w)
    )
    return out


def _first_true(mask: torch.Tensor, default: int):
    """Per-row index of the FIRST True (int32), else `default`."""
    L = mask.shape[1]
    pos = torch.arange(L, device=mask.device, dtype=torch.int32)[None, :]
    idx = torch.where(mask, pos, torch.full_like(pos, L)).amin(1)
    any_ = mask.any(1)
    return torch.where(any_, idx, torch.full_like(idx, default)), any_


def _first_argmin(cost: torch.Tensor) -> torch.Tensor:
    """Per-row index of the FIRST minimum (int32)."""
    W = cost.shape[1]
    pos = torch.arange(W, device=cost.device, dtype=torch.int32)[None, :]
    is_min = cost == cost.amin(1, keepdim=True)
    return torch.where(is_min, pos, torch.full_like(pos, W)).amin(1)


def _llr_refine(x, coarse, radius: int, lo, hi):
    """Exact two-segment Gaussian changepoint in [coarse - radius,
    coarse + radius): minimizes n1*log(var1) + n2*log(var2) over the split,
    clamped to [lo, hi]."""
    B, L = x.shape
    W = 2 * radius
    start = torch.clamp(coarse - radius, min=0)
    start = torch.clamp_max(start, max(L - W, 0))
    win = shift_rows(x, start, W)
    c1 = prefix_sums(win)
    c2 = prefix_sums(win * win)
    n1 = torch.arange(1, W, device=x.device, dtype=torch.float32)[None, :]
    n2 = W - n1
    s1, s2 = c1[:, 1:W], c2[:, 1:W]
    q1 = s1 / n1
    v1 = torch.clamp_min(fma(-q1, q1, s2 / n1), 1e-6)
    sT1 = c1[:, W : W + 1] - s1
    sT2 = c2[:, W : W + 1] - s2
    q2 = sT1 / n2
    v2 = torch.clamp_min(fma(-q2, q2, sT2 / n2), 1e-6)
    cost = n1 * torch.log(v1) + n2 * torch.log(v2)
    refined = start + _first_argmin(cost) + 1
    return torch.minimum(torch.maximum(refined, lo), hi)


def cnn_region_mask(xz, in_lens, cfg: DetectConfig, cnn, L: int) -> torch.Tensor:
    """CNN region prior as a float32 0/1 (B, L) mask. Prefix-causal: input,
    validity and normalization are capped at cnn_input_cap samples."""
    ds = cfg.downscale_factor
    if cfg.cnn_input_cap and cfg.cnn_input_cap < L:
        cap = cfg.cnn_input_cap
        W_cnn = -(-cap // ds) * ds
        pos = torch.arange(W_cnn, device=xz.device)[None, :]
        x_cnn = torch.where(pos < cap, xz[:, :W_cnn], torch.zeros_like(xz[:, :W_cnn]))
        lens_cnn = torch.clamp_max(in_lens, cap)
    else:
        x_cnn, lens_cnn = xz, in_lens
    xn, valid_ds = cnn_mod.preprocess(x_cnn, lens_cnn, ds)
    pa_ds = cnn_mod.polya_mask_from_logits(cnn(xn), valid_ds)
    region = pa_ds.repeat_interleave(ds, dim=1).to(torch.float32)
    if region.shape[1] < L:
        region = torch.nn.functional.pad(region, (0, L - region.shape[1]))
    return region


def detect_boundaries_batch(
    signals: torch.Tensor,
    in_lens: torch.Tensor,
    cfg: DetectConfig = DetectConfig(),
    cnn=None,
    cnn_region: torch.Tensor | None = None,
) -> DetectArrays:
    """Detect adapter / poly(A) / RNA boundaries for a (B, L) minibatch
    with the cfg.method detector ("llr" or "cnn"), gate statistics only.

    `cnn`: the BoundaryCNN module (method "cnn"), or a precomputed
    `cnn_region` (B, L) 0/1 mask from cnn_region_mask."""
    if cfg.method not in ("llr", "cnn"):
        raise NotImplementedError(f"detect method {cfg.method!r} is not ported")
    if cfg.real_signal_check or cfg.detect_med_shift:
        raise NotImplementedError(
            "the [real_range] and [med_shift] gates are not ported"
        )
    x = signals.to(torch.float32)
    B, L = x.shape
    dev = x.device
    in_lens = in_lens.to(torch.int32)
    pos = torch.arange(L, device=dev, dtype=torch.int32)[None, :]
    valid = pos < in_lens[:, None]
    xz = torch.where(valid, x, torch.zeros_like(x))

    region_mask = None
    if cfg.method == "cnn":
        if cnn_region is None:
            if cnn is None:
                raise ValueError("method='cnn' requires the BoundaryCNN module")
            cnn_region = cnn_region_mask(xz, in_lens, cfg, cnn, L)
        region_mask = cnn_region > 0

    # adapter level proxy: median of the first min_obs_adapter samples
    adapter_proxy_med = range_median_mad(
        x,
        torch.zeros((1, B), dtype=torch.int32, device=dev),
        torch.clamp_max(in_lens, cfg.min_obs_adapter)[None],
        with_mad=False,
    )[0][0]

    # poly(A) candidates: elevated + flat + fully inside the valid region
    thr = cfg.search_scale * adapter_proxy_med[:, None]
    W = cfg.min_obs_polya
    win_ok = (pos + W) <= in_lens[:, None]
    mean_f, var_f, var_w = rolling_mean_var(xz, cfg.mean_window, cfg.var_window)
    cand = (mean_f > thr) & (var_w < cfg.search_var_max) & valid & win_ok
    if region_mask is not None:
        cand = cand & region_mask
    sustained = (run_sum(cand, W) == W) & cand
    coarse_ps, found = _first_true(sustained, 0)

    sust_prev = torch.cat([torch.zeros_like(sustained[:, :1]), sustained[:, :-1]], 1)
    polya_candidates = (sustained & ~sust_prev).sum(1).to(torch.int32)

    # poly(A) end: first position past the run where the region stops being
    # both elevated and flat
    flat_high = (mean_f > thr) & (var_f <= cfg.search_var_max) & valid
    lapse = ~flat_high & (pos >= coarse_ps[:, None] + W)
    pe_first, has_end = _first_true(lapse, 0)
    coarse_pe = torch.where(has_end, pe_first, in_lens)
    coarse_pe = torch.minimum(coarse_pe + cfg.mean_window // 2, in_lens)

    zero_i = torch.zeros_like(in_lens)
    polya_start = _llr_refine(xz, coarse_ps, cfg.llr_refine_window, zero_i, in_lens)
    polya_end = _llr_refine(xz, coarse_pe, cfg.llr_refine_window, polya_start, in_lens)
    polya_start = torch.where(found, polya_start, zero_i)
    polya_end = torch.where(found, polya_end, zero_i)

    # adapter start: first sub-open-pore sample (usually 0)
    adapter_start, _ = _first_true((mean_f < cfg.open_pore_pa) & valid, 0)
    adapter_end = polya_start
    rna_start = polya_end

    # gate medians of the adapter and poly(A) regions (0 when empty)
    starts = torch.stack([adapter_start, polya_start])
    ends = torch.stack([adapter_end, polya_end])
    gmeds, _ = range_median_mad(x, starts, ends, with_mad=False)
    gmeds = torch.where(ends <= starts, torch.zeros_like(gmeds), torch.nan_to_num(gmeds))
    ad_med, pa_med = gmeds[0], gmeds[1]

    # fail taxonomy (lower code = earlier gate)
    adapter_len = adapter_end - adapter_start
    fail = torch.zeros(B, dtype=torch.int32, device=dev)

    def set_fail(fail, cond, code):
        return torch.where((fail == 0) & cond, torch.full_like(fail, code), fail)

    fail = set_fail(fail, in_lens < (cfg.min_obs_adapter + cfg.min_obs_polya), 1)
    fail = set_fail(fail, ~found, 2)
    fail = set_fail(fail, found & (adapter_len < cfg.min_obs_adapter), 3)
    fail = set_fail(fail, found & (adapter_len > cfg.max_obs_adapter), 4)

    mvs_shift_val = torch.zeros(B, dtype=torch.float32, device=dev)
    mvs_minvar_val = torch.zeros(B, dtype=torch.float32, device=dev)
    if cfg.mvs_detect_check:
        # [mvs_polya] validation of the detected region: median shift
        # adapter -> poly(A), the flattest var_window inside the poly(A),
        # poly(A) mean / adapter median
        med_shift = pa_med - ad_med
        pa_var_mask = (pos >= polya_start[:, None]) & (
            pos + cfg.var_window <= polya_end[:, None]
        )
        min_pa_var = torch.where(
            pa_var_mask, var_w, torch.full_like(var_w, float("inf"))
        ).amin(1)
        min_pa_var = torch.where(
            torch.isfinite(min_pa_var), min_pa_var, torch.zeros_like(min_pa_var)
        )
        pa_mask = (pos >= polya_start[:, None]) & (pos < polya_end[:, None])
        pa_sum = torch.where(pa_mask, x, torch.zeros_like(x)).sum(1, dtype=torch.float64)
        pa_mean_x = pa_sum.to(torch.float32) / torch.clamp_min(pa_mask.sum(1), 1)
        mvs_bad = (
            (med_shift < cfg.median_shift_min)
            | (min_pa_var > cfg.polya_var_max)
            | (pa_mean_x < cfg.polya_scale * ad_med)
        )
        fail = set_fail(fail, mvs_bad, 5)
        mvs_shift_val, mvs_minvar_val = med_shift, min_pa_var

    if cfg.detect_open_pores:
        op_mask = (pos >= adapter_start[:, None]) & (pos < adapter_end[:, None])
        n_open = (op_mask & (x > cfg.open_pore_pa)).sum(1).to(torch.float32)
        frac_open = n_open / torch.clamp_min(op_mask.sum(1), 1)
        fail = set_fail(fail, frac_open > 0.5, 8)

    return DetectArrays(
        success=fail == 0,
        fail_code=fail,
        adapter_start=adapter_start,
        adapter_end=adapter_end,
        polya_start=polya_start,
        polya_end=polya_end,
        polya_candidates=polya_candidates,
        adapter_med=ad_med,
        polya_med=pa_med,
        rna_start=rna_start,
        rna_len=in_lens - rna_start,
        used_llr_fallback=torch.zeros(B, dtype=torch.bool, device=dev),
        mvs_med_shift=mvs_shift_val,
        mvs_min_polya_var=mvs_minvar_val,
        prim_adapter_start=adapter_start,
        prim_adapter_end=adapter_end,
        prim_polya_start=polya_start,
        prim_polya_end=polya_end,
        prim_fail=fail,
        llr_adapter_start=adapter_start,
        llr_adapter_end=adapter_end,
        llr_polya_start=polya_start,
        llr_polya_end=polya_end,
        llr_fail=fail,
    )


def detect_boundaries_with_fallback(
    signals: torch.Tensor,
    in_lens: torch.Tensor,
    cfg: DetectConfig = DetectConfig(),
    cnn=None,
) -> DetectArrays:
    """Primary detect + per-read LLR fallback.

    The LLR detector runs on the whole minibatch beside the primary and is
    selected row-wise wherever the primary failed. The CNN region prior is
    computed once and handed to both passes."""
    if cfg.method == "llr" or not cfg.fallback_to_llr:
        return detect_boundaries_batch(signals, in_lens, cfg, cnn)
    cnn_region = None
    if cfg.method == "cnn" and cnn is not None:
        x32 = signals.to(torch.float32)
        L = x32.shape[1]
        lens32 = in_lens.to(torch.int32)
        pos = torch.arange(L, device=x32.device)[None, :]
        xz = torch.where(pos < lens32[:, None], x32, torch.zeros_like(x32))
        cnn_region = cnn_region_mask(xz, lens32, cfg, cnn, L)
    primary = detect_boundaries_batch(signals, in_lens, cfg, cnn, cnn_region)
    llr = detect_boundaries_batch(
        signals, in_lens, replace(cfg, method="llr", fallback_to_llr=False),
        cnn_region=cnn_region,
    )
    use_llr = ~primary.success
    merged = DetectArrays(
        *[torch.where(use_llr, l, p) for p, l in zip(primary, llr)]
    )
    return merged._replace(
        used_llr_fallback=use_llr,
        prim_adapter_start=primary.adapter_start,
        prim_adapter_end=primary.adapter_end,
        prim_polya_start=primary.polya_start,
        prim_polya_end=primary.polya_end,
        prim_fail=primary.fail_code,
        llr_adapter_start=llr.adapter_start,
        llr_adapter_end=llr.adapter_end,
        llr_polya_start=llr.polya_start,
        llr_polya_end=llr.polya_end,
        llr_fail=llr.fail_code,
    )
