"""Detection result container and the fail taxonomy.

Port of warpdemux_tpu/detect/containers.py: one struct of (B,) tensors per
minibatch, with the JAX package's fields in its order; fail reasons are
integer codes mapped to strings on the host. Where the region summary
statistics are skipped (with_stats=False, the decision lane) their fields
hold zeros. The CSV summary frame (to_summary_frame, pandas) is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Integer fail codes (0 = success), the same taxonomy as the JAX package.
FAIL_REASONS = [
    "",  # 0: success
    "signal too short",  # 1
    "no polyA found",  # 2
    "adapter too short",  # 3
    "adapter too long",  # 4
    "mvs polya check failed",  # 5
    "real signal check failed",  # 6
    "med shift check failed",  # 7
    "open pore signal",  # 8
    "rna start peak not found",  # 9
    "event segmentation failed",  # 10
    "signal normalization failed",  # 11
    "segment normalization failed",  # 12
    "consensus query outlier",  # 13
]


def fail_code_to_reason(codes: np.ndarray) -> list[str]:
    return [FAIL_REASONS[int(c)] for c in codes]


class DetectArrays(NamedTuple):
    """Batched detection results; every field is a (B,) tensor."""

    success: torch.Tensor  # bool
    fail_code: torch.Tensor  # int32 into FAIL_REASONS
    adapter_start: torch.Tensor  # int32 sample index
    adapter_end: torch.Tensor  # int32
    polya_start: torch.Tensor  # int32
    polya_end: torch.Tensor  # int32
    polya_candidates: torch.Tensor  # int32 distinct sustained runs
    # region statistics (0 for empty regions); the medians double as the
    # gate medians
    adapter_mean: torch.Tensor
    adapter_std: torch.Tensor
    adapter_med: torch.Tensor
    adapter_mad: torch.Tensor
    polya_mean: torch.Tensor
    polya_std: torch.Tensor
    polya_med: torch.Tensor
    polya_mad: torch.Tensor
    rna_start: torch.Tensor  # int32
    rna_len: torch.Tensor  # int32
    rna_mean: torch.Tensor
    rna_std: torch.Tensor
    rna_med: torch.Tensor
    rna_mad: torch.Tensor
    used_llr_fallback: torch.Tensor  # bool
    mvs_med_shift: torch.Tensor  # [mvs_polya] check values
    mvs_min_polya_var: torch.Tensor
    # per-method results before the fallback merge (prim_* = the primary
    # method, llr_* = the LLR pass)
    prim_adapter_start: torch.Tensor
    prim_adapter_end: torch.Tensor
    prim_polya_start: torch.Tensor
    prim_polya_end: torch.Tensor
    prim_fail: torch.Tensor
    llr_adapter_start: torch.Tensor
    llr_adapter_end: torch.Tensor
    llr_polya_start: torch.Tensor
    llr_polya_end: torch.Tensor
    llr_fail: torch.Tensor
