"""The per-minibatch decision step: raw signal -> barcode calls.

Port of warpdemux_tpu/pipeline/step.py `make_demux_step` for the decision
lane (outputs="decision") with the "pa" and "adc" feeds:

    calibrate (adc feed) -> detect_boundaries_with_fallback
        -> fingerprints_from_boundaries -> DTW -> exp kernel -> SVM proba
        -> argmax / margin / thresholds

On CUDA tensors every kernel of the chain is a hand-written kernel from
csrc/ (K1-K7); on CPU tensors each takes its plain PyTorch version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from warpdemux_tpu_torch.config.sig_proc import SigProcConfig
from warpdemux_tpu_torch.detect.boundaries import detect_boundaries_with_fallback
from warpdemux_tpu_torch.models.registry import load_cnn
from warpdemux_tpu_torch.ops.fingerprint import fingerprints_from_boundaries


class DecisionStepOutput(NamedTuple):
    """Decision-lane outputs: barcode call + confidence + fail taxonomy."""

    pred: torch.Tensor  # (B,) int32 barcode (-1 noise; valid where success)
    conf: torch.Tensor  # (B,) float32
    fail_code: torch.Tensor  # (B,) int32 merged detect + fingerprint codes
    success: torch.Tensor  # (B,) bool
    probs: torch.Tensor  # (B, k) float32 per-class probabilities


def make_demux_step(
    model,
    spc: SigProcConfig,
    input_format: str = "pa",
    outputs: str = "decision",
    device="cpu",
):
    """Build the decision step on `device`.

    `model` is a DTWSVMModel (moved to `device`).

    input_format:
      "pa":  step(signals (B, L) float32 picoamps, in_lens (B,))
      "adc": step(adc (B, L) int16, offset (B,) float32, scale (B,) float32,
             in_lens (B,)); the calibration (adc + offset) * scale runs on
             `device`.
    Inputs may be numpy arrays or tensors; the step returns a
    DecisionStepOutput of tensors on `device`.
    """
    if input_format not in ("pa", "adc"):
        raise NotImplementedError(f"input_format {input_format!r} is not ported")
    if outputs != "decision":
        raise NotImplementedError(f"outputs {outputs!r} is not ported")
    if spc.seg_extra.consensus_refinement:
        raise NotImplementedError("consensus-refined fingerprints are not ported")
    device = torch.device(device)
    dcfg, fcfg = spc.detect, spc.fingerprint
    model = model.to(device)
    cnn = load_cnn(spc.cnn_model_name, device) if dcfg.method == "cnn" else None

    def as_t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=device)

    @torch.inference_mode()
    def step(*args) -> DecisionStepOutput:
        if input_format == "adc":
            adc, offset, scale, in_lens = args
            offset = as_t(offset, torch.float32)
            scale = as_t(scale, torch.float32)
            signals = (as_t(adc, torch.int16).to(torch.float32) + offset[:, None]) * scale[:, None]
        else:
            signals, in_lens = args
            signals = as_t(signals, torch.float32)
        in_lens = as_t(in_lens, torch.int32)

        det = detect_boundaries_with_fallback(signals, in_lens, dcfg, cnn)
        fpt = fingerprints_from_boundaries(
            signals, in_lens, det.adapter_start, det.adapter_end, fcfg
        )
        # detect failures win; any other fingerprint failure is "event
        # segmentation failed" (10)
        fail = torch.where(
            (det.fail_code == 0) & ~fpt.ok,
            torch.full_like(det.fail_code, 10),
            det.fail_code,
        )
        success = fail == 0
        fpts = torch.where(success[:, None], fpt.fpt, torch.zeros_like(fpt.fpt))
        pred, conf, probs = model(fpts)
        return DecisionStepOutput(pred, conf, fail, success, probs)

    return step
