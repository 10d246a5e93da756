"""Batched adapter / poly(A) boundary detection.

Port of warpdemux_tpu/detect/boundaries.py: the `llr`, `cnn` and
`start_peak` methods, the per-read LLR fallback and every fail gate
([mvs_polya], [real_range], [med_shift], open pores). RNA004 reads
traverse the pore adapter -> poly(A) -> RNA; detection (llr / cnn):

1. adapter-level proxy: the median of the first min_obs_adapter samples
   (kernel K8 over the int16 ADC preimage when the feed has one, else K4),
2. forward rolling mean / variance of the calibrated signal (kernel K6),
3. poly(A) candidates: elevated mean (>= proxy * search_scale) and low
   variance, sustained for min_obs_polya samples (run sums: kernel K7),
   optionally gated by the CNN region prior; with `fused_rolling`, kernel
   K9 computes the statistics and both run sums in one launch,
4. the first sustained candidate gives the adapter -> poly(A) boundary,
   the run's lapse gives poly(A) -> RNA,
5. both are refined to the sample with an exact two-segment Gaussian
   changepoint scan in a local window (window copy: kernel K5; the cost
   of every split and its first argmin: kernel K14),
6. gate medians (K8 or K4) and the gates give the fail codes,
7. with_stats: mean / std / median / MAD of the adapter, poly(A) and RNA
   regions (medians and MADs: kernel K4).

The start_peak method (the tRNA chemistry) anchors the adapter on the
capture spike at the read's head, found on the signal downscaled by
downscale_factor; the adapter-level proxy is the median of the window
after it; a short poly(A) is searched as above (K6, K7, K5), and without
one the adapter ends at the best two-segment split of the max_obs_adapter
window after its start (one more K5 window and K14 launch).

The JAX package relies on XLA's common-subexpression elimination to run
the proxy median and the rolling statistics once for the fallback pair;
here detect_boundaries_with_fallback computes them once and hands them to
both passes. First-index semantics (argmax / argmin) are written out
explicitly.

`resolve_limit` (the two-stage wire, pipeline/step.make_twostage_decision_
step) adds the (B,) bool `resolved`: True where the row is provably what
detection over the whole preload returns when the caller shipped only the
first resolve_limit samples and padded the rest with the last one. The
predicate is the JAX package's, conservative: a read that fits the prefix
is the same program input; otherwise an llr / cnn pass must have found the
poly(A) and its end, with the adapter start, the run's end and every
rolling, refine and gate window they imply inside the prefix, and have
passed or failed a gate that reads only those regions (codes 3, 4, 5, 6,
8). start_peak and [med_shift] read up to in_len: only whole reads
resolve there.
"""

from __future__ import annotations

import os
from dataclasses import replace
from typing import NamedTuple

import torch

from warpdemux_tpu_torch import _cuda
from warpdemux_tpu_torch.config.sig_proc import DetectConfig
from warpdemux_tpu_torch.detect import cnn as cnn_mod
from warpdemux_tpu_torch.detect.containers import DetectArrays
from warpdemux_tpu_torch.ops.normalize import sorted_median
from warpdemux_tpu_torch.ops.numerics import BLOCK, fma, prefix_sums, xla_log_plain
from warpdemux_tpu_torch.ops.rowstats import range_mean_std
from warpdemux_tpu_torch.ops.select import range_median_mad, range_medians_adc
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


MAX_SHARED_BYTES = _cuda.MAX_SHARED_BYTES


def _scan_row_len(L: int, padded: bool) -> int:
    """Floats a row's prefix buffer needs for every level of the blocked
    scan, L + L/16 + L/256 + ...; `padded`: level 0 at index i + i // 16
    (the shared-memory layout of csrc/rolling.cu)."""
    row_len, n = L, L
    if padded and L > 0:
        row_len += (L - 1) // BLOCK
    while n > BLOCK:
        n = -(-n // BLOCK)
        row_len += n
    return row_len


def _scan_buffers(B: int, L: int, device, extra_shared: int = 0, static_shared: int = 0):
    """(row_len, shared_bytes, scratch) of a K6 / K9 launch over (B, L).

    Both prefix-sum arrays of a row (and `extra_shared` bytes more) go into
    the block's shared memory where they fit beside the kernel's
    `static_shared` bytes: then scratch is None. Longer rows get
    shared_bytes 0 and a (2, B, row_len) scratch tensor."""
    row_len = _scan_row_len(L, padded=True)
    shared_bytes = 2 * 4 * row_len + extra_shared
    if shared_bytes <= MAX_SHARED_BYTES - static_shared:
        return row_len, shared_bytes, None
    row_len = _scan_row_len(L, padded=False)
    return row_len, 0, torch.empty((2, B, row_len), dtype=torch.float32, device=device)


def rolling_mean_var(xz: torch.Tensor, w_mean: int, w_var: int):
    """(mean[w_mean], var[w_mean], var[w_var]) over forward windows
    [t, min(t+w, L)) of the validity-zeroed signal; K6 on CUDA."""
    if not _cuda.on_cuda(xz):
        return rolling_mean_var_plain(xz, w_mean, w_var)
    B, L = xz.shape
    xz = xz.contiguous()
    _cuda.check(xz, torch.float32, 2, "rolling_mean_var x")
    row_len, shared_bytes, scratch = _scan_buffers(B, L, xz.device)
    c1, c2 = (0, 0) if scratch is None else (scratch[0].data_ptr(), scratch[1].data_ptr())
    out = torch.empty((3, B, L), dtype=torch.float32, device=xz.device)
    _cuda.launch(
        "wdx_rolling_mean_var", xz.device, xz.data_ptr(), c1, c2, row_len, shared_bytes,
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), B, L,
        int(w_mean), int(w_var),
    )
    return out[0], out[1], out[2]


def run_sum_plain(mask: torch.Tensor, w: int) -> torch.Tensor:
    L = mask.shape[1]
    c = torch.cumsum(mask.to(torch.int32), dim=1, dtype=torch.int32)
    c = torch.cat([c.new_zeros((mask.shape[0], 1)), c], dim=1)
    hi = torch.clamp_max(torch.arange(L, device=mask.device) + w, L)
    return c[:, hi] - c[:, :L]


# static shared memory of K7 and K9 (the scan's warp totals), rounded up
_RUN_SUM_STATIC_BYTES = 1024
_RUN_SUM_MAX_LEN = 65535  # K7's prefix counts are uint16


def _run_sum_shared_bytes(L: int) -> int:
    """Dynamic shared memory of a K7 launch over rows of L samples: the
    row's L + 1 uint16 prefix counts (in whole 16-byte vectors), or 0 where
    a count would not fit: then the direct kernel runs."""
    if L > _RUN_SUM_MAX_LEN:
        return 0
    return -(-(L + 1) * 2 // 16) * 16  # at most 131,072: it fits a block


def run_sum(mask: torch.Tensor, w: int) -> torch.Tensor:
    """int32 count of True in mask[t : min(t+w, L)); K7 on CUDA."""
    if not _cuda.on_cuda(mask):
        return run_sum_plain(mask, w)
    B, L = mask.shape
    mask = mask.contiguous()
    _cuda.check(mask, torch.bool, 2, "run_sum mask")
    out = torch.empty((B, L), dtype=torch.int32, device=mask.device)
    _cuda.launch(
        "wdx_run_sum", mask.device, mask.data_ptr(), out.data_ptr(), B, L, int(w),
        _run_sum_shared_bytes(L),
    )
    return out


def rolling_detect_plain(xz, region, thr, in_lens, w_mean, w_var, w_run, var_max):
    mean_f, var_f, var_w = rolling_mean_var_plain(xz, w_mean, w_var)
    pos = torch.arange(xz.shape[1], device=xz.device)[None, :]
    lens = in_lens[:, None]
    base = (
        (mean_f > thr[:, None]) & (var_w < var_max) & (pos < lens) & (pos + w_run <= lens)
    )
    masked = base & (region > 0)
    return mean_f, var_f, var_w, run_sum_plain(base, w_run), run_sum_plain(masked, w_run)


def rolling_detect(
    xz: torch.Tensor,
    region: torch.Tensor,
    thr: torch.Tensor,
    in_lens: torch.Tensor,
    w_mean: int,
    w_var: int,
    w_run: int,
    var_max: float,
):
    """Rolling statistics and both poly(A) candidate run sums in one pass.

    Returns (mean_f, var_f, var_w) as rolling_mean_var, and the int32 run
    sums over [t, min(t + w_run, L)) of the candidate mask
    base = (mean_f > thr) & (var_w < var_max) & (t < len) & (t + w_run <= len)
    (rs_plain) and of base & (region > 0) (rs_masked). `region` is the
    (B, L) float32 CNN region prior, `thr` the (B,) float32 level threshold
    and `in_lens` the (B,) valid lengths. K9 on CUDA."""
    in_lens = in_lens.to(torch.int32)
    if not _cuda.on_cuda(xz, region, thr, in_lens):
        return rolling_detect_plain(xz, region, thr, in_lens, w_mean, w_var, w_run, var_max)
    B, L = xz.shape
    xz, region = xz.contiguous(), region.contiguous()
    thr, in_lens = thr.contiguous(), in_lens.contiguous()
    _cuda.check(xz, torch.float32, 2, "rolling_detect x")
    _cuda.check(region, torch.float32, 2, "rolling_detect region")
    _cuda.check(thr, torch.float32, 1, "rolling_detect thr")
    if region.shape != (B, L) or thr.shape != (B,) or in_lens.shape != (B,):
        raise ValueError("rolling_detect: region must be (B, L), thr and in_lens (B,)")
    # the candidate byte row rides in shared memory with the prefix sums,
    # padded to the 16-byte chunks its run sums are counted in
    row_len, shared_bytes, scratch = _scan_buffers(
        B, L, xz.device, extra_shared=-(-L // 16) * 16, static_shared=_RUN_SUM_STATIC_BYTES
    )
    if scratch is None:
        c1 = c2 = base = 0
    else:
        base_row = torch.empty((B, L), dtype=torch.uint8, device=xz.device)
        c1, c2, base = scratch[0].data_ptr(), scratch[1].data_ptr(), base_row.data_ptr()
    stats = torch.empty((3, B, L), dtype=torch.float32, device=xz.device)
    sums = torch.empty((2, B, L), dtype=torch.int32, device=xz.device)
    _cuda.launch(
        "wdx_rolling_detect", xz.device, xz.data_ptr(), region.data_ptr(),
        thr.data_ptr(), in_lens.data_ptr(), c1, c2, row_len, shared_bytes, base,
        stats[0].data_ptr(), stats[1].data_ptr(), stats[2].data_ptr(),
        sums[0].data_ptr(), sums[1].data_ptr(), B, L, int(w_mean), int(w_var),
        int(w_run), float(var_max),
    )
    return stats[0], stats[1], stats[2], sums[0], sums[1]


def _first_true(mask: torch.Tensor, default: int):
    """Per-row index of the FIRST True (int32), else `default`."""
    L = mask.shape[1]
    pos = torch.arange(L, device=mask.device, dtype=torch.int32)[None, :]
    idx = torch.where(mask, pos, torch.full_like(pos, L)).amin(1)
    any_ = mask.any(1)
    return torch.where(any_, idx, torch.full_like(idx, default)), any_


def _first_argmin(cost: torch.Tensor) -> torch.Tensor:
    """Per-row index (int32) of the FIRST NaN, else of the FIRST minimum:
    what jnp.argmin gives (-0.0 ties 0.0; a row of inf gives 0)."""
    W = cost.shape[1]
    pos = torch.arange(W, device=cost.device, dtype=torch.int32)[None, :]
    is_min = (cost == cost.amin(1, keepdim=True)) | cost.isnan()
    return torch.where(is_min, pos, torch.full_like(pos, W)).amin(1)


def _llr_refine(x, coarse, radius: int):
    """Exact two-segment Gaussian changepoints near K boundaries per row.

    coarse: (K, B) positions. For each, the split of the window
    [coarse - radius, coarse + radius) (moved inside the row) minimizing
    n1*log(var1) + n2*log(var2); returns (K, B) absolute positions, not
    clamped. All K * B windows go through one batch of ops; window k * B + b
    is read from row b of x (`shift_rows` with K times as many starts)."""
    K, B = coarse.shape
    L = x.shape[1]
    W = 2 * radius
    start = torch.clamp(coarse - radius, min=0)
    start = torch.clamp_max(start, max(L - W, 0)).reshape(K * B)
    win = shift_rows(x, start, W)
    return (start + llr_split(prefix_sums(win), prefix_sums(win * win))).reshape(K, B)


def _llr_cost(win):
    """(B, W - 1) cost of the splits 1..W-1 of (B, W) windows: the LLR
    refinement's `_llr_cost_from_sums` over the windows' prefix sums."""
    return _llr_cost_from_sums(prefix_sums(win), prefix_sums(win * win))


def _llr_cost_from_sums(c1, c2, weff=None, min_split: int = 1):
    """(R, W - 1) cost n1*log(var1) + n2*log(var2) of the splits 1..W-1,
    from the (R, W + 1) prefix sums c1 of the windows and c2 of their
    squares, rounded as XLA:CPU rounds the JAX expression: fused
    multiply-adds where it contracts, its own log. The two ends of a window
    can tie to the last bit, so the argmin depends on every rounding.

    weff None: the second segment runs to the window's end W. weff (R,):
    it runs to the row's own end weff in [1, W] (count clamped to 1), and
    the splits before min_split or at weff and past it cost inf."""
    W = c1.shape[1] - 1
    n1 = torch.arange(1, W, device=c1.device, dtype=torch.float32)[None, :]
    s1, s2 = c1[:, 1:W], c2[:, 1:W]
    q1 = s1 / n1
    v1 = torch.clamp_min(fma(-q1, q1, s2 / n1), 1e-6)
    if weff is None:
        n2 = W - n1
        cT1, cT2 = c1[:, W : W + 1], c2[:, W : W + 1]
    else:
        n2 = torch.clamp_min(weff.to(torch.float32)[:, None] - n1, 1.0)
        idx = weff.to(torch.int64)[:, None]
        cT1, cT2 = torch.gather(c1, 1, idx), torch.gather(c2, 1, idx)
    sT1 = cT1 - s1
    sT2 = cT2 - s2
    q2 = sT1 / n2
    v2 = torch.clamp_min(fma(-q2, q2, sT2 / n2), 1e-6)
    log_v1, log_v2 = xla_log_plain(torch.stack([v1, v2]))
    cost = fma(n1, log_v1, n2 * log_v2)
    if weff is None:
        return cost
    tpos = torch.arange(1, W, device=c1.device)[None, :]
    ok = (tpos >= min_split) & (tpos < weff[:, None])
    return torch.where(ok, cost, torch.full_like(cost, float("inf")))


def llr_split_plain(c1, c2, weff=None, min_split: int = 1) -> torch.Tensor:
    """The plain version of `llr_split` (any device)."""
    return _first_argmin(_llr_cost_from_sums(c1, c2, weff, min_split)) + 1


def llr_split(c1, c2, weff=None, min_split: int = 1) -> torch.Tensor:
    """(R,) int32 best split in 1..W-1 of each of R windows of W samples:
    the first argmin of `_llr_cost_from_sums` plus one, from the (R, W + 1)
    float32 prefix sums c1 / c2 (`numerics.prefix_sums` of the windows and
    of their squares); `weff` (R,) and `min_split` as there. Kernel K14
    (csrc/xlalog.cu, `wdx_llr_split`) on CUDA: the whole cost and its first
    argmin in one launch."""
    tensors = (c1, c2) if weff is None else (c1, c2, weff)
    if not _cuda.on_cuda(*tensors):
        return llr_split_plain(c1, c2, weff, min_split)
    c1, c2 = c1.contiguous(), c2.contiguous()
    _cuda.check(c1, torch.float32, 2, "llr_split c1")
    _cuda.check(c2, torch.float32, 2, "llr_split c2")
    R, W = c1.shape[0], c1.shape[1] - 1
    if c2.shape != c1.shape or W < 2:
        raise ValueError(f"llr_split: prefix sums {tuple(c1.shape)} / {tuple(c2.shape)}, want (R, W + 1) with W >= 2")
    if weff is not None:
        weff = weff.to(torch.int32).contiguous()
        if weff.shape != (R,):
            raise ValueError(f"llr_split: weff {tuple(weff.shape)} for {R} windows")
    out = torch.empty(R, dtype=torch.int32, device=c1.device)
    if R:
        _cuda.launch(
            "wdx_llr_split", c1.device, c1.data_ptr(), c2.data_ptr(),
            None if weff is None else weff.data_ptr(), out.data_ptr(), R, W, int(min_split),
        )
    return out


def _llr_split_window(xz, start, W: int, min_split: int, n_valid):
    """Two-segment Gaussian split of the window [start, start + W), for
    splits at min_split or later that leave both segments inside n_valid;
    returns the absolute position, clamped to [0, n_valid]. The window
    reads zeros past the row (K5 with lengths). The cost is rounded as
    _llr_cost's, with the second segment's sums and count taken at the
    row's own window end."""
    L = xz.shape[1]
    start = start.clamp(0, max(L - 1, 0))
    win = shift_rows(xz, start, W, torch.full_like(start, W))
    weff = (n_valid - start).clamp(1, W)
    split = llr_split(prefix_sums(win), prefix_sums(win * win), weff, min_split)
    return torch.minimum(torch.clamp_min(start + split, 0), n_valid)


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


def fused_rolling_default() -> bool:
    """The `fused_rolling` default: the WDX_FUSED_ROLLING environment
    variable ("1" turns K9 on), as in the JAX package."""
    return os.environ.get("WDX_FUSED_ROLLING", "0") == "1"


METHODS = ("llr", "cnn", "start_peak")


def check_supported(cfg: DetectConfig) -> None:
    """Raise ValueError for a detect method that does not exist."""
    if cfg.method not in METHODS:
        raise ValueError(f"detect method must be one of {METHODS}, got {cfg.method!r}")


def _range_medians(x, starts, ends, adc=None):
    """Median-only ranged medians: over the int16 ADC preimage when the feed
    has one (K8), else over the float keys (K4). Bit-identical."""
    if adc is not None:
        return range_medians_adc(x, adc, starts, ends)
    return range_median_mad(x, starts, ends, with_mad=False)[0]


def _region_stats(sig, starts, ends, given_meds=None, given=()):
    """(means, stds, medians, MADs), each (R, B), of R [start, end) ranges;
    0 for empty ranges. Medians and MADs in one K4 launch, means and stds
    in one K11 launch; `given` ranges take their median from given_meds and
    only search the MAD."""
    x = sig.x
    meds, mads = range_median_mad(
        x, starts, ends, with_mad=True, given_meds=given_meds, given=given,
        calibration=sig.calibration,
    )
    means, stds = range_mean_std(x, starts, ends, calibration=sig.calibration)
    empty = ends <= starts

    def fix(a):
        return torch.where(empty, torch.zeros_like(a), a)

    return (
        fix(means),
        fix(stds),
        fix(torch.nan_to_num(meds)),
        fix(torch.nan_to_num(mads)),
    )


class _Signal(NamedTuple):
    """A minibatch as every detect pass reads it."""

    x: torch.Tensor  # (B, L) float32 calibrated signal
    in_lens: torch.Tensor  # (B,) int32
    pos: torch.Tensor  # (1, L) int32 sample index
    valid: torch.Tensor  # (B, L) bool
    xz: torch.Tensor  # x zeroed past in_lens
    adc: torch.Tensor | None  # (B, L) int16 ADC preimage of x, if any
    calibration: tuple | None  # (adc, offset, scale) when x was calibrated here


def _signal(signals, in_lens, adc, calibration) -> _Signal:
    x = signals.to(torch.float32)
    in_lens = in_lens.to(torch.int32)
    pos = torch.arange(x.shape[1], device=x.device, dtype=torch.int32)[None, :]
    valid = pos < in_lens[:, None]
    xz = torch.where(valid, x, torch.zeros_like(x))
    if adc is not None:
        adc = adc.to(torch.int16)
    if calibration is not None:
        if adc is None:
            raise ValueError("calibration needs the adc preimage")
        calibration = (adc, *calibration)
    return _Signal(x, in_lens, pos, valid, xz, adc, calibration)


class _Rolling(NamedTuple):
    """What both passes of a fallback pair read: the adapter-level proxy
    (None where no pass of the pair is llr or cnn) and the rolling
    statistics, plus K9's run sums when fused."""

    proxy_med: torch.Tensor | None  # (B,)
    mean_f: torch.Tensor
    var_f: torch.Tensor
    var_w: torch.Tensor
    rs_plain: torch.Tensor | None
    rs_masked: torch.Tensor | None


def _rolling(sig: _Signal, cfg: DetectConfig, cnn_region, fused: bool) -> _Rolling:
    B = sig.x.shape[0]
    proxy = None
    if cfg.method != "start_peak" or cfg.fallback_to_llr:
        # adapter level proxy: median of the first min_obs_adapter samples
        proxy = _range_medians(
            sig.x,
            torch.zeros((1, B), dtype=torch.int32, device=sig.x.device),
            torch.clamp_max(sig.in_lens, cfg.min_obs_adapter)[None],
            sig.adc,
        )[0]
    if fused and cnn_region is not None:
        return _Rolling(proxy, *rolling_detect(
            sig.xz, cnn_region, cfg.search_scale * proxy, sig.in_lens,
            cfg.mean_window, cfg.var_window, cfg.min_obs_polya, cfg.search_var_max,
        ))
    stats = rolling_mean_var(sig.xz, cfg.mean_window, cfg.var_window)
    return _Rolling(proxy, *stats, None, None)


def detect_boundaries_batch(
    signals: torch.Tensor,
    in_lens: torch.Tensor,
    cfg: DetectConfig = DetectConfig(),
    cnn=None,
    cnn_region: torch.Tensor | None = None,
    *,
    with_stats: bool = True,
    adc: torch.Tensor | None = None,
    calibration: tuple | None = None,
    fused_rolling: bool | None = None,
    resolve_limit: int = 0,
) -> DetectArrays:
    """Detect adapter / poly(A) / RNA boundaries for a (B, L) minibatch
    with the cfg.method detector ("llr", "cnn" or "start_peak").

    `cnn`: the BoundaryCNN module (method "cnn"), or a precomputed
    `cnn_region` (B, L) 0/1 mask from cnn_region_mask.
    with_stats=False skips the region summary statistics (their fields are
    0); only the gate medians (and the adapter MAD of [real_range]) are
    computed.
    `adc`: the int16 ADC preimage of `signals` (adc and vbz feeds); the
    median-only launches then bisect it (K8).
    `calibration`: (offset (B,), scale (B,)) when the caller computed
    signals = (adc + offset) * scale in the same step; the region MADs
    then round their deviations as XLA:CPU does when it fuses the two
    (range_median_mad).
    fused_rolling: run K9 in place of K6 + K7 when a CNN region prior is
    present (None: fused_rolling_default()).
    resolve_limit: when nonzero, also set `resolved` (module docstring;
    ValueError as check_resolve_limit)."""
    check_supported(cfg)
    sig = _signal(signals, in_lens, adc, calibration)
    if cfg.method == "cnn" and cnn_region is None:
        if cnn is None:
            raise ValueError("method='cnn' requires the BoundaryCNN module")
        cnn_region = cnn_region_mask(sig.xz, sig.in_lens, cfg, cnn, sig.x.shape[1])
    if fused_rolling is None:
        fused_rolling = fused_rolling_default()
    rolled = _rolling(sig, cfg, cnn_region, fused_rolling)
    return _detect_pass(sig, cfg, cnn_region, rolled, with_stats, resolve_limit)


class _Boundaries(NamedTuple):
    """One method's boundaries, before the statistics and the gates."""

    adapter_start: torch.Tensor
    adapter_end: torch.Tensor
    polya_start: torch.Tensor
    polya_end: torch.Tensor
    polya_candidates: torch.Tensor
    found: torch.Tensor  # poly(A) found (always True for start_peak)
    sp_fail: torch.Tensor | None  # start_peak: no capture spike
    xds: torch.Tensor | None  # the downscaled signal, where computed
    # llr / cnn: (coarse poly(A) start, first lapse, has_end), what
    # resolve_limit's predicate reads; None for start_peak
    horizon: tuple | None = None


def _polya_search(sig: _Signal, cfg: DetectConfig, rolled: _Rolling, cand, thr, W: int, var_max: float,
                  runs=None):
    """(coarse poly(A) start, found, candidate runs, coarse end, (first
    lapse, has_end)) from the candidate mask: the first run of W sustained
    candidates, and the first position W or more past it where the signal
    stops being elevated and flat (variance at most var_max; the coarse end
    is that lapse, or in_len without one, plus mean_window / 2). `runs`:
    the run sums where K9 counted them, else K7 counts them here."""
    if runs is None:
        runs = run_sum(cand, W)
    sustained = (runs == W) & cand
    coarse_ps, found = _first_true(sustained, 0)
    sust_prev = torch.cat([torch.zeros_like(sustained[:, :1]), sustained[:, :-1]], 1)
    polya_candidates = (sustained & ~sust_prev).sum(1).to(torch.int32)
    flat_high = (rolled.mean_f > thr) & (rolled.var_f <= var_max) & sig.valid
    lapse = ~flat_high & (sig.pos >= coarse_ps[:, None] + W)
    pe_first, has_end = _first_true(lapse, 0)
    coarse_pe = torch.where(has_end, pe_first, sig.in_lens)
    coarse_pe = torch.minimum(coarse_pe + cfg.mean_window // 2, sig.in_lens)
    return coarse_ps, found, polya_candidates, coarse_pe, (pe_first, has_end)


def _refine_polya(sig: _Signal, cfg: DetectConfig, coarse_ps, coarse_pe):
    """Both coarse poly(A) boundaries refined in one batch of windows (one
    K5 launch), clamped to [0, len] and [start, len]."""
    ps, pe = _llr_refine(sig.xz, torch.stack([coarse_ps, coarse_pe]), cfg.llr_refine_window)
    polya_start = torch.minimum(torch.clamp_min(ps, 0), sig.in_lens)
    polya_end = torch.minimum(torch.maximum(pe, polya_start), sig.in_lens)
    return polya_start, polya_end


def _llr_boundaries(sig: _Signal, cfg: DetectConfig, cnn_region, rolled: _Rolling) -> _Boundaries:
    """[llr_boundaries] / [cnn_boundaries]: the sustained elevated, flat
    region is the poly(A); the adapter runs from the first sub-open-pore
    sample to its start."""
    W = cfg.min_obs_polya
    thr = cfg.search_scale * rolled.proxy_med[:, None]
    win_ok = (sig.pos + W) <= sig.in_lens[:, None]
    cand = (rolled.mean_f > thr) & (rolled.var_w < cfg.search_var_max) & sig.valid & win_ok
    if cfg.method == "cnn":
        cand = cand & (cnn_region > 0)
    runs = rolled.rs_masked if cfg.method == "cnn" else rolled.rs_plain
    coarse_ps, found, polya_candidates, coarse_pe, (pe_first, has_end) = _polya_search(
        sig, cfg, rolled, cand, thr, W, cfg.search_var_max, runs
    )
    polya_start, polya_end = _refine_polya(sig, cfg, coarse_ps, coarse_pe)
    zero_i = torch.zeros_like(sig.in_lens)
    polya_start = torch.where(found, polya_start, zero_i)
    polya_end = torch.where(found, polya_end, zero_i)
    # adapter start: first sub-open-pore sample (usually 0)
    adapter_start, _ = _first_true((rolled.mean_f < cfg.open_pore_pa) & sig.valid, 0)
    return _Boundaries(
        adapter_start, polya_start, polya_start, polya_end, polya_candidates, found, None, None,
        (coarse_ps, pe_first, has_end),
    )


def _start_peak_boundaries(sig: _Signal, cfg: DetectConfig, rolled: _Rolling) -> _Boundaries:
    """[rna_start_peak] (tRNA): the adapter starts sp_offset1 downscaled
    positions past the capture spike at the head of the read; a poly(A)
    of min_len_polya downscaled positions is searched from sp_offset2 past
    it; without one, the adapter ends at the strongest two-segment split of
    the max_obs_adapter window after its start (at min_obs_adapter or
    later). A missing poly(A) is no failure here."""
    in_lens = sig.in_lens
    ds = cfg.downscale_factor
    xds = cnn_mod.downscale_mean(sig.xz, ds)
    Lds = xds.shape[1]
    pds = torch.arange(Lds, device=xds.device)[None, :]
    left = torch.cat([xds[:, :1], xds[:, :-1]], 1)
    right = torch.cat([xds[:, 1:], xds[:, -1:]], 1)
    is_pk = (
        (xds >= left)
        & (xds > right)
        & (xds >= cfg.min_start_peak_pa)
        & (xds < cfg.open_pore_pa)
        & (pds >= 1)
        & (pds < cfg.start_peak_max_idx)
        & ((pds + 1) * ds <= in_lens[:, None])
    )
    pk_idx, pk_found = _first_true(is_pk, 0)
    adapter_start = torch.minimum((pk_idx + cfg.sp_offset1) * ds, in_lens)

    # adapter level: the median of the window right after the start
    proxy = _range_medians(
        sig.x, adapter_start[None],
        torch.minimum(adapter_start + cfg.min_obs_adapter, in_lens)[None], sig.adc,
    )[0]
    search_from = (pk_idx + cfg.sp_offset2) * ds
    thr = cfg.sp_polya_scale * proxy[:, None]
    Wp = cfg.min_len_polya * ds
    win_ok = (sig.pos + Wp) <= in_lens[:, None]
    cand = (
        (rolled.mean_f > thr)
        & (rolled.var_w < cfg.polya_var_max)
        & sig.valid
        & win_ok
        & (sig.pos >= search_from[:, None])
    )
    coarse_ps, found, polya_candidates, coarse_pe, _ = _polya_search(
        sig, cfg, rolled, cand, thr, Wp, cfg.polya_var_max
    )
    polya_start, polya_end = _refine_polya(sig, cfg, coarse_ps, coarse_pe)

    split_end = _llr_split_window(
        sig.xz, adapter_start, cfg.max_obs_adapter, cfg.min_obs_adapter, in_lens
    )
    adapter_end = torch.where(found & cfg.sp_detect_polya, polya_start, split_end)
    polya_start = torch.where(found, polya_start, adapter_end)
    polya_end = torch.where(found, polya_end, adapter_end)
    return _Boundaries(
        adapter_start, adapter_end, polya_start, polya_end, polya_candidates,
        torch.ones_like(found), ~pk_found, xds,
    )


def _local_range_median(xds, adapter_start, adapter_end, cfg: DetectConfig):
    """[real_range]: the median, over the windows of local_range_window //
    downscale_factor downscaled positions that lie inside the adapter (cut
    at max_obs_local_range), of each window's max - min (NaN where no
    window fits)."""
    ds = cfg.downscale_factor
    B, Lds = xds.shape
    pds = torch.arange(Lds, device=xds.device)[None, :]
    lim = torch.clamp_max(adapter_end, cfg.max_obs_local_range) // ds
    admask = (pds >= (adapter_start // ds)[:, None]) & (pds < lim[:, None])
    wds = max(cfg.local_range_window // ds, 2)
    if Lds < wds:
        return torch.full((B,), float("nan"), dtype=xds.dtype, device=xds.device)
    ninf = torch.full_like(xds, float("-inf"))
    pool = lambda a: torch.nn.functional.max_pool1d(a[:, None], wds, stride=1)[:, 0]
    hi = pool(torch.where(admask, xds, ninf))
    lo = -pool(torch.where(admask, -xds, ninf))
    ok = admask[:, : hi.shape[1]] & admask[:, wds - 1 :]
    local = torch.where(ok, hi - lo, torch.full_like(hi, float("nan"))).nan_to_num(nan=0.0)
    return sorted_median(local, ok)


def check_resolve_limit(cfg: DetectConfig, limit: int) -> None:
    """Raise ValueError where an llr / cnn pass cannot bound its windows by
    `limit` samples: a CNN that reads past it (cnn_input_cap not in
    (0, limit]) or a limit shorter than the adapter-level proxy window plus
    the rolling variance window. start_peak and [med_shift] resolve whole
    reads only and take any limit."""
    if cfg.method == "start_peak" or cfg.detect_med_shift:
        return
    if cfg.method == "cnn" and not (0 < cfg.cnn_input_cap <= limit):
        raise ValueError(
            "resolve_limit with method='cnn' requires a prefix-causal CNN: "
            f"cnn_input_cap in (0, {limit}], got {cfg.cnn_input_cap}"
        )
    if limit < cfg.min_obs_adapter + cfg.var_window:
        raise ValueError(
            "resolve_limit must cover the adapter-level proxy window plus the rolling margin"
        )


def _resolved(cfg: DetectConfig, bnd: _Boundaries, fail, in_lens, limit: int):
    """The pass's rows provably unchanged by the samples past `limit`."""
    whole = in_lens <= limit
    if bnd.horizon is None or cfg.detect_med_shift:
        return whole
    check_resolve_limit(cfg, limit)
    # the rolling statistics at q are the whole preload's where
    # q + var_window <= limit; the poly(A) end's refinement reads up to
    # its lapse + mean_window / 2 + llr_refine_window: one margin for both
    margin = max(cfg.var_window, cfg.mean_window // 2 + cfg.llr_refine_window)
    coarse_ps, pe_first, has_end = bnd.horizon
    bound_ok = (
        bnd.found
        & has_end
        & (coarse_ps + cfg.min_obs_polya + margin <= limit)
        & (pe_first + margin <= limit)
        & (bnd.adapter_start + margin <= limit)
    )
    # a pass, or a fail of a gate that read only the adapter and poly(A):
    # "no polyA found" (2) could change with more signal
    gate_fail = (fail == 3) | (fail == 4) | (fail == 5) | (fail == 6) | (fail == 8)
    return whole | (bound_ok & ((fail == 0) | gate_fail))


def _detect_pass(
    sig: _Signal, cfg: DetectConfig, cnn_region, rolled: _Rolling, with_stats: bool,
    resolve_limit: int = 0,
) -> DetectArrays:
    x, in_lens, pos = sig.x, sig.in_lens, sig.pos
    B = x.shape[0]
    dev = x.device
    if cfg.method == "start_peak":
        bnd = _start_peak_boundaries(sig, cfg, rolled)
    else:
        bnd = _llr_boundaries(sig, cfg, cnn_region, rolled)
    adapter_start, adapter_end = bnd.adapter_start, bnd.adapter_end
    polya_start, polya_end, found = bnd.polya_start, bnd.polya_end, bnd.found
    rna_start = polya_end
    starts = [adapter_start, polya_start]
    ends = [adapter_end, polya_end]
    if with_stats:
        starts.append(rna_start)
        ends.append(in_lens)
    if cfg.detect_med_shift:  # the [med_shift] window of the RNA
        starts.append(rna_start)
        ends.append(torch.minimum(rna_start + cfg.med_shift_window, in_lens))
    starts, ends = torch.stack(starts), torch.stack(ends)

    zero_f = torch.zeros(B, dtype=torch.float32, device=dev)
    if with_stats:
        means, stds, meds, mads = _region_stats(sig, starts, ends)
        rna_med_w = meds[3] if cfg.detect_med_shift else None
    else:
        # gate medians (0 for empty ranges); the adapter MAD only where
        # [real_range] reads it
        empty = ends <= starts
        means = stds = mads = zero_f.expand(3, B)
        if cfg.real_signal_check:
            gmeds, gmads = range_median_mad(x, starts, ends, with_mad=True, calibration=sig.calibration)
            ad_mad = torch.where(empty[0], zero_f, torch.nan_to_num(gmads[0]))
            mads = torch.stack([ad_mad, zero_f, zero_f])
        else:
            gmeds = _range_medians(x, starts, ends, sig.adc)
        gmeds = torch.where(empty, torch.zeros_like(gmeds), torch.nan_to_num(gmeds))
        rna_med_w = gmeds[2] if cfg.detect_med_shift else None
        meds = torch.cat([gmeds[:2] if cfg.detect_med_shift else gmeds, zero_f[None]])
    ad_med, pa_med = meds[0], meds[1]

    # fail taxonomy (lower code = earlier gate)
    adapter_len = adapter_end - adapter_start
    fail = torch.zeros(B, dtype=torch.int32, device=dev)

    def set_fail(fail, cond, code):
        return torch.where((fail == 0) & cond, torch.full_like(fail, code), fail)

    fail = set_fail(fail, in_lens < (cfg.min_obs_adapter + cfg.min_obs_polya), 1)
    if bnd.sp_fail is not None:
        fail = set_fail(fail, bnd.sp_fail, 9)  # rna start peak not found
    fail = set_fail(fail, ~found, 2)
    fail = set_fail(fail, found & (adapter_len < cfg.min_obs_adapter), 3)
    fail = set_fail(fail, found & (adapter_len > cfg.max_obs_adapter), 4)

    mvs_shift_val = mvs_minvar_val = zero_f
    if cfg.mvs_detect_check:
        # [mvs_polya] validation of the detected region: median shift
        # adapter -> poly(A), the flattest var_window inside the poly(A),
        # poly(A) mean / adapter median
        var_w = rolled.var_w
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
        pa_mean_x = range_mean_std(
            x, polya_start[None], polya_end[None], with_std=False, calibration=sig.calibration
        )[0][0]
        mvs_bad = (
            (med_shift < cfg.median_shift_min)
            | (min_pa_var > cfg.polya_var_max)
            | (pa_mean_x < cfg.polya_scale * ad_med)
        )
        fail = set_fail(fail, mvs_bad, 5)
        mvs_shift_val, mvs_minvar_val = med_shift, min_pa_var

    if cfg.real_signal_check:
        # local range plausibility on the downscaled adapter region, and
        # the adapter MAD
        xds = bnd.xds if bnd.xds is not None else cnn_mod.downscale_mean(sig.xz, cfg.downscale_factor)
        med_rng = _local_range_median(xds, adapter_start, adapter_end, cfg)
        ad_mad = mads[0]
        rr_bad = (
            (med_rng < cfg.local_range[0])
            | (med_rng > cfg.local_range[1])
            | (ad_mad < cfg.adapter_mad_range[0])
            | (ad_mad > cfg.adapter_mad_range[1])
        )
        fail = set_fail(fail, rr_bad, 6)

    if cfg.detect_med_shift:
        fail = set_fail(fail, (rna_med_w - ad_med) < cfg.med_shift_min, 7)

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
        polya_candidates=bnd.polya_candidates,
        adapter_mean=means[0],
        adapter_std=stds[0],
        adapter_med=ad_med,
        adapter_mad=mads[0],
        polya_mean=means[1],
        polya_std=stds[1],
        polya_med=pa_med,
        polya_mad=mads[1],
        rna_start=rna_start,
        rna_len=in_lens - rna_start,
        rna_mean=means[2],
        rna_std=stds[2],
        rna_med=meds[2],
        rna_mad=mads[2],
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
        resolved=_resolved(cfg, bnd, fail, in_lens, resolve_limit) if resolve_limit else None,
    )


def detect_boundaries_with_fallback(
    signals: torch.Tensor,
    in_lens: torch.Tensor,
    cfg: DetectConfig = DetectConfig(),
    cnn=None,
    *,
    with_stats: bool = True,
    adc: torch.Tensor | None = None,
    calibration: tuple | None = None,
    fused_rolling: bool | None = None,
    resolve_limit: int = 0,
) -> DetectArrays:
    """Primary detect + per-read LLR fallback.

    The LLR detector runs on the whole minibatch beside the primary and is
    selected row-wise wherever the primary failed. The CNN region prior,
    the adapter-level proxy and the rolling statistics (K9's run sums when
    fused) are computed once and handed to both passes, which skip the
    region statistics; with_stats computes them once on the merged
    boundaries, reusing the passes' gate medians. `adc`, `calibration`,
    fused_rolling and resolve_limit as in detect_boundaries_batch; a merged
    row is resolved where the primary pass is and either it passed or the
    LLR row that replaces it is resolved too."""
    if cfg.method == "llr" or not cfg.fallback_to_llr:
        return detect_boundaries_batch(
            signals, in_lens, cfg, cnn, with_stats=with_stats, adc=adc,
            calibration=calibration, fused_rolling=fused_rolling,
            resolve_limit=resolve_limit,
        )
    check_supported(cfg)
    sig = _signal(signals, in_lens, adc, calibration)
    cnn_region = None
    if cfg.method == "cnn":
        if cnn is None:
            raise ValueError("method='cnn' requires the BoundaryCNN module")
        cnn_region = cnn_region_mask(sig.xz, sig.in_lens, cfg, cnn, sig.x.shape[1])
    if fused_rolling is None:
        fused_rolling = fused_rolling_default()
    rolled = _rolling(sig, cfg, cnn_region, fused_rolling)
    llr_cfg = replace(cfg, method="llr", fallback_to_llr=False)
    primary = _detect_pass(sig, cfg, cnn_region, rolled, False, resolve_limit)
    llr = _detect_pass(sig, llr_cfg, cnn_region, rolled, False, resolve_limit)
    use_llr = ~primary.success
    merged = DetectArrays(
        *[None if p is None else torch.where(use_llr, l, p) for p, l in zip(primary, llr)]
    )
    if resolve_limit:
        merged = merged._replace(resolved=primary.resolved & (primary.success | llr.resolved))
    merged = merged._replace(
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
    if not with_stats:
        return merged
    # the gate passes already bisected the adapter and poly(A) medians over
    # the same ranges: only their MADs and the RNA region are searched
    zero_f = torch.zeros_like(merged.adapter_med)
    means, stds, meds, mads = _region_stats(
        sig,
        torch.stack([merged.adapter_start, merged.polya_start, merged.rna_start]),
        torch.stack([merged.adapter_end, merged.polya_end, sig.in_lens]),
        given_meds=torch.stack([merged.adapter_med, merged.polya_med, zero_f]),
        given=(True, True, False),
    )
    return merged._replace(
        adapter_mean=means[0],
        adapter_std=stds[0],
        adapter_med=meds[0],
        adapter_mad=mads[0],
        polya_mean=means[1],
        polya_std=stds[1],
        polya_med=meds[1],
        polya_mad=mads[1],
        rna_mean=means[2],
        rna_std=stds[2],
        rna_med=meds[2],
        rna_mad=mads[2],
    )
