"""Per-row windowed extraction: out[r, j] = x[r mod B_x, start[r] + j].

Port of warpdemux_tpu/ops/window_gather.py `shift_rows_auto`. Used for the
LLR refinement windows (detect/boundaries.py) and the adapter extraction
(ops/fingerprint.py). Two things the JAX callers do around the gather are
part of the function here, so that neither costs a copy of the signal:

- `starts` may have K times as many rows as `x`: output row r reads source
  row r mod B_x (the K windows of a read share its one signal; the JAX
  package gathers each from the signal again).
- with `lengths`, out[r, j] is 0 for j >= lengths[r] and wherever
  start[r] + j lies outside the row, and nothing is read there (the JAX
  package gathers from a zero-padded copy and masks the result).

Without `lengths` indices are clamped to [0, L - 1] like the JAX package's
gather path. CUDA tensors go to kernel K5 (csrc/window_gather.cu); CPU
tensors go to torch.gather.
"""

from __future__ import annotations

import torch

from warpdemux_tpu_torch import _cuda


def _check_rows(x, starts, lengths):
    B_x, B_out = x.shape[0], starts.shape[0]
    if starts.dim() != 1 or B_x == 0 or B_out % B_x != 0:
        raise ValueError("starts must be (K * B,) for x of shape (B, L)")
    if lengths is not None and lengths.shape != (B_out,):
        raise ValueError("lengths must have the shape of starts")
    return B_x, B_out


def shift_rows_plain(x, starts, out_len: int, lengths=None):
    B_x, B_out = _check_rows(x, starts, lengths)
    L, K = x.shape[1], B_out // B_x
    j = torch.arange(out_len, device=x.device)[None, :]
    src = starts.to(torch.int64)[:, None] + j
    idx = src.clamp(0, L - 1)
    if K == 1:
        out = torch.gather(x, 1, idx)
    else:  # row k * B_x + b reads x[b]: gather the K windows of a row side by side
        idx = idx.view(K, B_x, out_len).transpose(0, 1).reshape(B_x, K * out_len)
        out = torch.gather(x, 1, idx).view(B_x, K, out_len).transpose(0, 1).reshape(B_out, out_len)
    if lengths is None:
        return out
    keep = (j < lengths[:, None]) & (src >= 0) & (src < L)
    return torch.where(keep, out, torch.zeros_like(out))


def shift_rows(x, starts, out_len: int, lengths=None) -> torch.Tensor:
    """(B, L) x, (K * B,) starts [, (K * B,) lengths] -> (K * B, out_len)
    windows; K5 on CUDA."""
    tensors = (x, starts) if lengths is None else (x, starts, lengths)
    if not _cuda.on_cuda(*tensors):
        return shift_rows_plain(x, starts, out_len, lengths)
    B_x, B_out = _check_rows(x, starts, lengths)
    x = x.contiguous()
    starts = starts.to(torch.int32).contiguous()
    _cuda.check(x, torch.float32, 2, "shift_rows x")
    if lengths is not None:
        lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty((B_out, out_len), dtype=torch.float32, device=x.device)
    _cuda.launch(
        "wdx_shift_rows", x.device, x.data_ptr(), starts.data_ptr(),
        None if lengths is None else lengths.data_ptr(), out.data_ptr(),
        B_x, B_out, x.shape[1], int(out_len),
    )
    return out
