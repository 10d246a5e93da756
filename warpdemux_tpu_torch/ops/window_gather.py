"""Per-row windowed extraction: out[b, j] = x[b, start[b] + j].

Port of warpdemux_tpu/ops/window_gather.py `shift_rows_auto`. Used for the
LLR refinement windows (detect/boundaries.py) and the adapter extraction
(ops/fingerprint.py). Indices are clamped to [0, L - 1] like the JAX
package's gather path. CUDA tensors go to kernel K5
(csrc/window_gather.cu); CPU tensors go to torch.gather.
"""

from __future__ import annotations

import torch

from warpdemux_tpu_torch import _cuda


def shift_rows_plain(x: torch.Tensor, starts: torch.Tensor, out_len: int):
    L = x.shape[1]
    j = torch.arange(out_len, device=x.device)
    idx = (starts.to(torch.int64)[:, None] + j[None, :]).clamp(0, L - 1)
    return torch.gather(x, 1, idx)


def shift_rows(x: torch.Tensor, starts: torch.Tensor, out_len: int) -> torch.Tensor:
    """(B, L) x, (B,) starts -> (B, out_len) windows; K5 on CUDA."""
    if not _cuda.on_cuda(x, starts):
        return shift_rows_plain(x, starts, out_len)
    B, L = x.shape
    x = x.contiguous()
    starts = starts.to(torch.int32).contiguous()
    _cuda.check(x, torch.float32, 2, "shift_rows x")
    if starts.shape != (B,):
        raise ValueError("starts must be (B,)")
    out = torch.empty((B, out_len), dtype=torch.float32, device=x.device)
    _cuda.launch(
        "wdx_shift_rows", x.device, x.data_ptr(), starts.data_ptr(),
        out.data_ptr(), B, L, int(out_len),
    )
    return out
