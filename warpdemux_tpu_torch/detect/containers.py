"""Detection result container and the fail taxonomy.

Port of warpdemux_tpu/detect/containers.py: one struct of (B,) tensors per
minibatch, with the JAX package's fields in its order; fail reasons are
integer codes mapped to strings on the host. Where the region summary
statistics are skipped (with_stats=False, the decision lane) their fields
hold zeros. `to_summary_frame` builds the boundaries / failed-reads rows
as an io/writers.Table (no pandas), with the JAX frame's columns in its
order.
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
    """Batched detection results; every field is a (B,) tensor (`resolved`
    None unless asked for)."""

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
    # two-stage wire (detect resolve_limit): True where this row is what
    # detection over the whole preload returns, because the read fit the
    # stage-1 prefix or every window the decision read lies inside it;
    # None unless a resolve_limit was given
    resolved: torch.Tensor | None = None

    def to_summary_frame(self, read_ids, full_lengths, in_lengths, primary_method: str = "llr"):
        """Rows for the detected_boundaries / failed_reads CSVs from host
        (numpy) fields: the JAX `to_summary_frame`'s columns in its order,
        the per-method `<primary>_*` / `llr_*` columns where the detect pass
        recorded them (`llr_fail` not None), prefixed with the configured
        primary method's name."""
        from warpdemux_tpu_torch.io.writers import Table

        g = np.asarray
        B = len(read_ids)
        zf = lambda a: g(a) if a is not None else np.zeros(B, np.float32)
        cols = {
            "read_id": list(read_ids),
            "signal_len": g(full_lengths),
            "preloaded": g(in_lengths),
            "adapter_start": g(self.adapter_start),
            "adapter_end": g(self.adapter_end),
            "adapter_len": g(self.adapter_end) - g(self.adapter_start),
            "adapter_mean": g(self.adapter_mean),
            "adapter_std": g(self.adapter_std),
            "adapter_med": g(self.adapter_med),
            "adapter_mad": g(self.adapter_mad),
            "polya_start": g(self.polya_start),
            "polya_end": g(self.polya_end),
            "polya_len": g(self.polya_end) - g(self.polya_start),
            "polya_mean": g(self.polya_mean),
            "polya_std": g(self.polya_std),
            "polya_med": g(self.polya_med),
            "polya_mad": g(self.polya_mad),
            "polya_candidates": g(self.polya_candidates),
            "rna_preloaded_start": g(self.rna_start),
            "rna_preloaded_len": g(self.rna_len),
            "rna_preloaded_mean": g(self.rna_mean),
            "rna_preloaded_std": g(self.rna_std),
            "rna_preloaded_med": g(self.rna_med),
            "rna_preloaded_mad": g(self.rna_mad),
            "used_llr_fallback": (
                g(self.used_llr_fallback)
                if self.used_llr_fallback is not None
                else np.zeros(B, bool)
            ),
            "mvs_med_shift": zf(self.mvs_med_shift),
            "mvs_min_polya_var": zf(self.mvs_min_polya_var),
        }
        if self.llr_fail is not None:
            methods = [
                ("llr", self.llr_adapter_start, self.llr_adapter_end,
                 self.llr_polya_start, self.llr_polya_end, self.llr_fail),
            ]
            if primary_method != "llr" and self.prim_fail is not None:
                methods.insert(0, (
                    primary_method, self.prim_adapter_start, self.prim_adapter_end,
                    self.prim_polya_start, self.prim_polya_end, self.prim_fail,
                ))
            for name, a0, a1, p0, p1, fc in methods:
                cols[f"{name}_adapter_start"] = g(a0)
                cols[f"{name}_adapter_end"] = g(a1)
                cols[f"{name}_polya_start"] = g(p0)
                cols[f"{name}_polya_end"] = g(p1)
                cols[f"{name}_fail_reason"] = fail_code_to_reason(g(fc))
        cols["fail_reason"] = fail_code_to_reason(g(self.fail_code))
        return Table(cols)
