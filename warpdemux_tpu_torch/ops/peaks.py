"""Batched peak picking with scipy.signal.find_peaks(distance=...) parity.

Port of warpdemux_tpu/ops/peaks.py:

1. `peak_mask_batch`: plateau-aware local maxima (scipy `_local_maxima_1d`):
   a maximal run x[s..e] of equal values with x[s-1] < v and x[e+1] < v,
   s >= 1, e <= n - 2, marked at its midpoint (s + e) // 2. With a
   per-row slice origin `min_pos`, only runs with s >= min_pos + 1 count:
   the peaks of scores[min_pos:n] at their positions in the row (the tRNA
   path re-segments the scores from the barcode start on).
2. `suppress_by_distance`: scipy `_select_by_peak_distance` as a priority
   fixpoint (priority = score, the later position winning ties). CUDA
   tensors go to kernel K3 (csrc/peaks.cu): a block a row runs the fixpoint
   over bit words in shared memory, following the alive peaks; a
   max_distance above 32, or a row whose bit words do not fit shared
   memory, runs the kernel with byte flags in device memory. CPU tensors go
   to the plain fixpoint, the jnp version's rounds.
3. `select_top_peaks`: the num_events highest kept peaks, ties going to
   the later position, as np.argsort(scores)[-k:] does: torch.topk runs on
   unique int64 keys (score order key, position), so no two candidates tie.
   On rows of 1024 positions or more (and at least 4 x num_events) the
   candidates are the JAX package's: the better of each pair of positions
   (2j, 2j + 1). Kept peaks are never adjacent, so where a row has
   num_events peaks this changes nothing; where it has fewer, the filler
   positions are the ones JAX picks, and the fingerprint statistics it
   writes for failed reads are JAX's.
"""

from __future__ import annotations

import torch

from warpdemux_tpu_torch import _cuda
from warpdemux_tpu_torch.ops.select import order_keys


def peak_mask_batch(scores: torch.Tensor, n_scores: torch.Tensor, min_pos=None):
    """(B, L) local-maxima mask at plateau midpoints, and (B,) counts.

    min_pos: optional (B,) slice origin; a plateau counts only if it starts
    at min_pos + 1 or later."""
    B, L = scores.shape
    pos = torch.arange(L, device=scores.device, dtype=torch.int64)[None, :]
    neg1 = torch.full((B, L), -1, dtype=torch.int64, device=scores.device)

    # left side: the most recent change at or before p is the start s of
    # p's plateau; its low bit says whether x[s-1] < x[s] (a rise)
    xl = torch.cat([scores[:, :1], scores[:, :-1]], dim=1)
    changed_l = scores != xl
    changed_l[:, 0] = False
    key_l = torch.where(changed_l, pos * 2 + (scores > xl).to(torch.int64), neg1)
    kl = torch.cummax(key_l, dim=1).values
    s = kl >> 1
    rose = (kl >= 0) & ((kl & 1) == 1)

    # right side: the nearest change at or after p is the end e of the
    # run; its low bit says whether x[e] > x[e+1] (a fall)
    xr = torch.cat([scores[:, 1:], scores[:, -1:]], dim=1)
    changed_r = scores != xr
    changed_r[:, -1] = False
    key_r = torch.where(
        changed_r, (L - 1 - pos) * 2 + (scores > xr).to(torch.int64), neg1
    )
    kr = torch.cummax(key_r.flip(1), dim=1).values.flip(1)
    e = (L - 1) - (kr >> 1)
    fell = (kr >= 0) & ((kr & 1) == 1)

    is_peak = (
        rose
        & fell
        & (e <= n_scores.to(torch.int64)[:, None] - 2)
        & (pos == torch.div(s + e, 2, rounding_mode="floor"))
    )
    if min_pos is not None:
        is_peak = is_peak & (s >= min_pos.to(torch.int64)[:, None] + 1)
    return is_peak, is_peak.sum(1).to(torch.int32)


# the widest reach (min(distance, max_distance)) K3's 64-bit neighbour
# windows hold
_SUPPRESS_MAX_REACH = 32


def _suppress_shared_bytes(L: int, max_distance: int) -> int:
    """Shared memory a row of a K3 launch: the bit words alive and win (a
    zero word on both sides of each) and keep, 32 positions a word, in whole
    16-byte vectors; or 0 where max_distance exceeds the 64-bit windows or
    the words do not fit a block: then the byte-flag kernel runs."""
    row_bytes = -(-(3 * -(-L // 32) + 4) // 4) * 16
    fits = max_distance <= _SUPPRESS_MAX_REACH and row_bytes <= _cuda.MAX_SHARED_BYTES
    return row_bytes if fits else 0


def suppress_by_distance_plain(scores, is_peak, distance, max_distance: int, count_rounds=False):
    """Plain version of suppress_by_distance; with count_rounds also the
    (B,) number of rounds each row was alive for."""
    B, L = scores.shape
    W = max(int(max_distance), 1)
    d_col = distance.to(torch.int64)[:, None]
    ninf = torch.tensor(float("-inf"), dtype=scores.dtype, device=scores.device)
    alive = is_peak.clone()
    keep = torch.zeros_like(is_peak)
    rounds = torch.zeros(B, dtype=torch.int32, device=scores.device)
    while bool(alive.any()):
        rounds += alive.any(1)
        s_alive = torch.where(alive, scores, ninf)
        spad = torch.nn.functional.pad(s_alive, (W, W), value=float("-inf"))
        dom = torch.zeros_like(alive)
        for o in range(1, W):
            within = o < d_col
            right = spad[:, W + o : W + o + L]  # neighbour at p + o
            left = spad[:, W - o : W - o + L]  # neighbour at p - o
            # later position wins ties: right dominates on >=, left on >
            dom = dom | (within & (right >= s_alive)) | (within & (left > s_alive))
        winner = alive & ~dom
        keep = keep | winner
        wpad = torch.nn.functional.pad(winner, (W, W))
        killed = torch.zeros_like(alive)
        for o in range(1, W):
            within = o < d_col
            killed = killed | (
                within & (wpad[:, W + o : W + o + L] | wpad[:, W - o : W - o + L])
            )
        alive = alive & ~winner & ~killed
    return (keep, rounds) if count_rounds else keep


def suppress_by_distance(scores, is_peak, distance, max_distance: int):
    """Keep mask of scipy `_select_by_peak_distance` (per-row distance,
    offsets below min(distance, max_distance)); K3 on CUDA.

    A dead or out-of-row neighbour counts as a score of -inf, so a peak
    that scores -inf is dominated by any such neighbour to its right and
    lives until a winner within reach kills it; where none does, the plain
    version never ends and K3 leaves the peak out."""
    if not _cuda.on_cuda(scores, is_peak, distance):
        return suppress_by_distance_plain(scores, is_peak, distance, max_distance)
    B, L = scores.shape
    scores = scores.contiguous()
    peaks = is_peak.contiguous()
    dist = distance.to(torch.int32).contiguous()
    _cuda.check(scores, torch.float32, 2, "suppress scores")
    _cuda.check(peaks, torch.bool, 2, "suppress is_peak")
    if peaks.shape != (B, L) or dist.shape != (B,):
        raise ValueError("is_peak must be (B, L) and distance (B,) for scores (B, L)")
    W = max(int(max_distance), 1)
    shared_bytes = _suppress_shared_bytes(L, W)
    keep = torch.empty((B, L), dtype=torch.bool, device=scores.device)
    # the byte-flag kernel's alive and win; the bit-word kernel needs none
    scratch = [] if shared_bytes else [torch.empty_like(keep), torch.empty_like(keep)]
    _cuda.launch(
        "wdx_suppress", scores.device, scores.data_ptr(), peaks.data_ptr(),
        dist.data_ptr(), *([t.data_ptr() for t in scratch] or [None, None]),
        keep.data_ptr(), B, L, W, shared_bytes,
    )
    return keep


def find_peaks_batch(scores, n_scores, distance, max_distance: int = 32, min_pos=None):
    """scipy.signal.find_peaks(row, distance=distance_row) per row; with
    min_pos, of the slice scores[min_pos:n_scores] at row positions.

    Returns (keep_mask (B, L) bool, peak_count (B,) int32)."""
    is_peak, _ = peak_mask_batch(scores, n_scores, min_pos)
    keep = suppress_by_distance(scores, is_peak, distance, max_distance)
    return keep, keep.sum(1).to(torch.int32)


def select_top_peaks(scores, keep_mask, peak_count, num_events: int):
    """Positions (B, num_events) int32 of the num_events highest kept peaks
    (equal scores prefer the later peak) and ok (B,) = count >= num_events.

    Rows with ok=False carry positions of non-peaks; callers mask them."""
    B, L = scores.shape
    masked = torch.where(keep_mask, scores, torch.full_like(scores, float("-inf")))
    pairs = L >= 4 * num_events and L >= 1024
    if pairs:  # an odd row ends in a -inf pad, as in JAX
        masked = torch.nn.functional.pad(masked, (0, L % 2), value=float("-inf"))
    pos = torch.arange(masked.shape[1], device=scores.device, dtype=torch.int64)[None, :]
    key = order_keys(masked).to(torch.int64) * (2**32) + pos
    if pairs:
        key = key.view(B, -1, 2).amax(dim=2)
    top = torch.topk(key, num_events, dim=1).values
    sel_pos = torch.remainder(top, 2**32).to(torch.int32)
    return sel_pos, peak_count >= num_events
