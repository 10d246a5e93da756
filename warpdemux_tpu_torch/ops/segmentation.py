"""Batched event segmentation of the extracted adapter signal.

Port of warpdemux_tpu/ops/segmentation.py:

- `windowed_t_test`: for each position p < n_valid - 2w, the adjacent
  windows [p, p+w) and [p+w, p+2w) give score |m1 - m2| / sqrt(ssd1 + ssd2)
  (ssd = sum of squared deviations; 0 where ssd1 + ssd2 == 0), computed as
  the jitted JAX function computes it on the CPU: |m1 - m2| times XLA's
  rsqrt (`numerics.xla_rsqrt`). CUDA tensors go to kernel K2
  (csrc/ttest.cu); CPU tensors go to the plain version, which runs the jnp
  path's shifted accumulation passes.
- `segment_means`: per-segment means from a centered prefix sum.
- `segment_signal_batch`: the reference segmentation contract with the
  per-read adaptation of min_obs and the window width.
"""

from __future__ import annotations

import torch

from warpdemux_tpu_torch import _cuda
from warpdemux_tpu_torch.ops.numerics import prefix_sums, rsqrt_table, xla_rsqrt, xla_sum
from warpdemux_tpu_torch.ops.peaks import find_peaks_batch, select_top_peaks


def windowed_t_test_plain(x, n_valid, w, w_max: int) -> torch.Tensor:
    B, L = x.shape
    n_valid = n_valid.to(torch.int32)
    w = w.to(torch.int32)
    wf = w.to(x.dtype)[:, None]
    pos = torch.arange(L, device=x.device)[None, :]
    xz = torch.where(pos < n_valid[:, None], x, torch.zeros_like(x))
    zero = torch.zeros_like(xz)

    def shifted(a, k):  # a[:, p + k], wrapped lanes are masked below
        return torch.roll(a, -k, dims=1)

    s1 = torch.zeros_like(xz)
    for idx in range(w_max):
        s1 = s1 + torch.where((idx < w)[:, None], shifted(xz, idx), zero)
    m1 = s1 / wf
    v1 = torch.zeros_like(xz)
    for idx in range(w_max):
        d1 = shifted(xz, idx) - m1
        v1 = v1 + torch.where((idx < w)[:, None], d1 * d1, zero)

    # second window = first window shifted by w (per row)
    m2 = torch.zeros_like(xz)
    v2 = torch.zeros_like(xz)
    for k in range(1, w_max + 1):
        take = (w == k)[:, None]
        m2 = torch.where(take, shifted(m1, k), m2)
        v2 = torch.where(take, shifted(v1, k), v2)

    n_scores = torch.clamp_min(n_valid - 2 * w, 0)
    vsum = v1 + v2
    scores = torch.where(
        vsum > 0, (m1 - m2).abs() * xla_rsqrt(torch.clamp_min(vsum, 0.0)), zero
    )
    return torch.where(pos < n_scores[:, None], scores, zero)


def windowed_t_test(x, n_valid, w, w_max: int):
    """Windowed t-statistic scores per row.

    Args:
      x: (B, L) float32 signal, garbage past n_valid.
      n_valid: (B,) valid length per row.
      w: (B,) window width per row (1 <= w <= w_max).
      w_max: static bound on w.
    Returns:
      scores (B, L), 0 at and past n_valid - 2w; n_scores (B,).
    """
    if not _cuda.on_cuda(x, n_valid, w):
        n_scores = torch.clamp_min(n_valid.to(torch.int32) - 2 * w.to(torch.int32), 0)
        return windowed_t_test_plain(x, n_valid, w, w_max), n_scores
    B, L = x.shape
    x = x.contiguous()
    nv = n_valid.to(torch.int32).contiguous()
    wi = w.to(torch.int32).contiguous()
    _cuda.check(x, torch.float32, 2, "windowed_t_test x")
    if nv.shape != (B,) or wi.shape != (B,):
        raise ValueError("n_valid and w must be (B,) for x of shape (B, L)")
    out = torch.empty_like(x)
    if L == 0:  # no launch: n_scores by the plain expression
        return out, torch.clamp_min(nv - 2 * wi, 0)
    n_scores = torch.empty_like(nv)  # the kernel writes it beside the scores
    _cuda.launch(
        "wdx_ttest", x.device, x.data_ptr(), nv.data_ptr(), wi.data_ptr(),
        rsqrt_table(x.device).data_ptr(), out.data_ptr(), n_scores.data_ptr(),
        B, L, int(w_max),
    )
    return out, n_scores


def segment_means(x, boundaries, n_valid) -> torch.Tensor:
    """Mean of x between consecutive boundaries (B, E+1) -> (B, E).

    The centering sum and the prefix sum take XLA:CPU's float32 order
    (`xla_sum`, `blocked_cumsum`), so CPU and CUDA give the JAX package's
    sums."""
    B, L = x.shape
    pos = torch.arange(L, device=x.device)[None, :]
    valid = pos < n_valid[:, None]
    zero = torch.zeros_like(x)
    nf = torch.clamp_min(n_valid, 1).to(x.dtype)
    center = xla_sum(torch.where(valid, x, zero)) / nf
    xc = torch.where(valid, x - center[:, None], zero)
    cpad = prefix_sums(xc)
    b = boundaries.clamp(0, L).to(torch.int64)
    g = torch.gather(cpad, 1, b)
    seg_sum = g[:, 1:] - g[:, :-1]
    seg_len = (b[:, 1:] - b[:, :-1]).to(x.dtype)
    means = torch.where(
        seg_len > 0, seg_sum / torch.clamp_min(seg_len, 1.0), torch.zeros_like(seg_sum)
    )
    return means + center[:, None]


def segment_signal_batch(
    x: torch.Tensor,
    n_valid: torch.Tensor,
    num_events: int,
    min_obs_per_base: int,
    running_stat_width: int,
):
    """Segment each row into num_events + 1 events.

    min_obs = min(cfg, round(n / num_events / 2)), w = min(cfg,
    round(n / num_events)) per read (round half to even, as np.round).

    Returns (event_means (B, E+1), dwell (B, E+1) int32, ok (B,),
    scores (B, L), n_scores (B,), boundaries (B, E+2))."""
    B, L = x.shape
    n_valid = n_valid.to(torch.int32)
    nf = n_valid.to(torch.float32)
    min_obs = torch.clamp_max(
        torch.round(nf / num_events / 2.0).to(torch.int32), min_obs_per_base
    )
    w = torch.clamp_max(
        torch.round(nf / num_events).to(torch.int32), running_stat_width
    )
    w = torch.clamp_min(w, 1)

    scores, n_scores = windowed_t_test(x, n_valid, w, running_stat_width)
    keep_mask, peak_count = find_peaks_batch(
        scores, n_scores, torch.clamp_min(min_obs, 1),
        max_distance=min_obs_per_base + 1,
    )
    sel_pos, ok = select_top_peaks(scores, keep_mask, peak_count, num_events)
    ok = ok & (min_obs >= 1) & (n_scores > 0)

    cpts = torch.sort(sel_pos, dim=1).values + w[:, None]
    boundaries = torch.cat(
        [torch.zeros((B, 1), dtype=torch.int32, device=x.device), cpts, n_valid[:, None]],
        dim=1,
    )
    event_means = segment_means(x, boundaries, n_valid)
    dwell = boundaries[:, 1:] - boundaries[:, :-1]
    return event_means, dwell, ok, scores, n_scores, boundaries
