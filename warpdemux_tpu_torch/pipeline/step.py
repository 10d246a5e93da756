"""The per-minibatch demux step: raw signal -> barcode calls.

Port of warpdemux_tpu/pipeline/step.py: `make_demux_step` with the "pa",
"adc" and "vbz" feeds and both output modes, and the two-stage wire of the
decision lane (`make_twostage_decision_step`):

    [vbz decode] -> calibrate (adc, vbz) -> detect_boundaries_with_fallback
        -> fingerprints_from_boundaries (fingerprints_consensus_refined
           where the chemistry asks for consensus refinement: the tRNA path)
        -> DTW -> exp kernel -> SVM proba -> argmax / margin / thresholds
        -> pack (outputs="full")

On CUDA tensors every kernel of the chain is a hand-written kernel from
csrc/ (K1-K8, K9 in place of K6 + K7 with fused_rolling, K10 on the tRNA
path); on CPU tensors each takes its plain PyTorch version.

The two-stage wire ships each read's first stage1_len samples, runs the
decision chain on them with the detect `resolved` bit, and ships and runs
again only the tails of a minibatch whose rows are not all resolved; the
merged decisions equal the one-shot step's bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from warpdemux_tpu_torch._cuda import resolve_device
from warpdemux_tpu_torch.config.sig_proc import SigProcConfig
from warpdemux_tpu_torch.detect.boundaries import (
    check_resolve_limit,
    check_supported,
    detect_boundaries_with_fallback,
    fused_rolling_default,
)
from warpdemux_tpu_torch.detect.containers import DetectArrays
from warpdemux_tpu_torch.models.consensus_data import CONSENSUS
from warpdemux_tpu_torch.models.dtw_svm import DTWSVMModel
from warpdemux_tpu_torch.models.registry import load_cnn
from warpdemux_tpu_torch.ops.fingerprint import (
    FingerprintArrays,
    fingerprints_consensus_refined,
    fingerprints_from_boundaries,
)
from warpdemux_tpu_torch.ops.vbz_device import pack_tails_host, vbz_decode_batch
from warpdemux_tpu_torch.pipeline.schema import PackSchema

INPUT_FORMATS = ("pa", "adc", "vbz")
OUTPUTS = ("full", "decision")


class ConsensusView(NamedTuple):
    """Consensus-match columns of the tRNA path (host view)."""

    seg_query_start: np.ndarray
    seg_query_end: np.ndarray
    sig_barcode_start: np.ndarray


class DemuxStepOutput(NamedTuple):
    """Host view of a full step's outputs (numpy arrays)."""

    detect: DetectArrays
    fpt: FingerprintArrays
    fail_code: np.ndarray  # (B,) int32 merged detect + fingerprint codes
    success: np.ndarray  # (B,) bool
    pred: np.ndarray  # (B,) int32 barcode (-1 noise; valid where success)
    conf: np.ndarray  # (B,)
    probs: np.ndarray  # (B, k)
    consensus: ConsensusView | None = None  # the tRNA path's columns


class PackedStepOutput(NamedTuple):
    """Device outputs of one full step, packed into (B, C) buffers laid
    out by pipeline/schema.PackSchema; pred/conf/success stay separate so
    the decision fetch is small."""

    big_i: torch.Tensor  # (B, C_i) int32
    big_f: torch.Tensor  # (B, C_f) float32
    cons_i: torch.Tensor | None  # (B, 3) int32: ConsensusView's columns (tRNA path)
    success: torch.Tensor  # (B,) bool
    pred: torch.Tensor  # (B,) int32
    conf: torch.Tensor  # (B,) float32

    @property
    def probs(self) -> torch.Tensor:
        schema = PackSchema.from_buffers(self.big_i, self.big_f)
        return self.big_f[:, schema.float_slices["probs"]]

    def unpack(self) -> DemuxStepOutput:
        """Copy to the host and split the buffers into named columns."""
        big_i = self.big_i.cpu().numpy()
        big_f = self.big_f.cpu().numpy()
        schema = PackSchema.from_buffers(big_i, big_f)
        ci = schema.unpack(big_i, np.int32)
        cf = schema.unpack(big_f, np.float32)
        cols = {**ci, **cf}
        det = DetectArrays(**{
            **{f: cols[f] for f in DetectArrays._fields if f in cols},
            "success": ci["det_fail"] == 0,
            "fail_code": ci["det_fail"],
            "used_llr_fallback": ci["used_llr_fallback"].astype(bool),
        })
        fpt = FingerprintArrays(**{
            **{f: cols[f] for f in FingerprintArrays._fields if f in cols},
            "ok": ci["fpt_ok"].astype(bool),
        })
        cons = None
        if self.cons_i is not None:
            cons = ConsensusView(*self.cons_i.cpu().numpy().T)
        return DemuxStepOutput(
            detect=det,
            fpt=fpt,
            fail_code=ci["merged_fail"],
            success=self.success.cpu().numpy(),
            pred=self.pred.cpu().numpy(),
            conf=self.conf.cpu().numpy(),
            probs=cf["probs"],
            consensus=cons,
        )


class DecisionStepOutput(NamedTuple):
    """Decision-lane outputs: barcode call + confidence + fail taxonomy."""

    pred: torch.Tensor  # (B,) int32 barcode (-1 noise; valid where success)
    conf: torch.Tensor  # (B,) float32
    fail_code: torch.Tensor  # (B,) int32 merged detect + fingerprint codes
    success: torch.Tensor  # (B,) bool
    probs: torch.Tensor  # (B, k) float32 per-class probabilities


def _pack(det: DetectArrays, fpt: FingerprintArrays, cons, fail, success, pred, conf, probs):
    schema = PackSchema(k=fpt.fpt.shape[1], kc=probs.shape[1])
    int_vals = {f: getattr(det, f) for f in DetectArrays._fields}
    int_vals.update(
        det_fail=det.fail_code, fpt_ok=fpt.ok, merged_fail=fail, dwell=fpt.dwell
    )
    float_vals = {f: getattr(det, f) for f in DetectArrays._fields}
    float_vals.update(fpt._asdict(), probs=probs)
    return PackedStepOutput(
        big_i=schema.pack(int_vals, torch.int32),
        big_f=schema.pack(float_vals, torch.float32),
        cons_i=None if cons is None else torch.stack(
            [cons.seg_query_start, cons.seg_query_end, cons.sig_barcode_start], dim=1
        ).to(torch.int32),
        success=success,
        pred=pred.to(torch.int32),
        conf=conf.to(torch.float32),
    )


def make_demux_step(
    model,
    spc: SigProcConfig,
    *,
    with_predict: bool = True,
    input_format: str = "pa",
    outputs: str = "full",
    fused_rolling: bool | None = None,
    device=None,
    resolve_limit: int = 0,
):
    """Build the demux step on `device`: by default the CUDA GPU
    (RuntimeError where there is none); `device="cpu"` runs the plain
    PyTorch path on the CPU.

    `model` is a DTWSVMModel (moved to `device`; any other family raises
    ValueError, as the JAX step cannot take one), or None for a run without
    classification; with_predict=False skips it too. Without it
    pred is -1, conf 0 and probs zeros of shape (B, 1).

    input_format:
      "pa":  step(signals (B, L) float32 picoamps, in_lens (B,))
      "adc": step(adc (B, L) int16, offset (B,) float32, scale (B,) float32,
             in_lens (B,)); the calibration (adc + offset) * scale runs on
             `device` and the detect medians bisect the int16 counts (K8).
      "vbz": step(keys (B, L/8) uint8, data (B, D) uint8, offset, scale,
             in_lens): the VBZ inner layout, decoded on `device`
             (ops/vbz_device), then as "adc".
    outputs:
      "full":     a PackedStepOutput: every boundary, region-statistics and
                  fingerprint column in the PackSchema layout.
      "decision": a DecisionStepOutput (no region statistics computed).
    fused_rolling: detect with kernel K9 in place of K6 + K7 (None: the
      WDX_FUSED_ROLLING environment variable).
    resolve_limit (stage 1 of the two-stage wire; "adc" feed and "decision"
      outputs only): the step returns (DecisionStepOutput, resolved), the
      detect `resolved` bit of each row (detect/boundaries.py). The adc may
      then be narrower than max_obs_trace: each row is padded with its
      last sample, which is what the VBZ decode of the whole wire gives a
      read that fits the prefix (its trailing deltas are zero).
    Inputs may be numpy arrays or tensors; outputs are tensors on `device`.
    """
    if input_format not in INPUT_FORMATS:
        raise ValueError(f"input_format must be one of {INPUT_FORMATS}, got {input_format!r}")
    if outputs not in OUTPUTS:
        raise ValueError(f"outputs must be one of {OUTPUTS}, got {outputs!r}")
    check_supported(spc.detect)
    if resolve_limit:
        if input_format != "adc" or outputs != "decision":
            raise ValueError("resolve_limit requires input_format='adc', outputs='decision'")
        check_resolve_limit(spc.detect, resolve_limit)
    device = resolve_device(device)
    dcfg, fcfg, sx = spc.detect, spc.fingerprint, spc.seg_extra
    query = None
    if sx.consensus_refinement:
        query = torch.as_tensor(
            np.asarray(CONSENSUS[sx.consensus_model], np.float32), device=device
        )
    classify = with_predict and model is not None
    if classify and not isinstance(model, DTWSVMModel):
        # the JAX step reads the SVM's support vectors and parameters
        # (warpdemux_tpu/pipeline/step.py:279-281); the other families
        # classify through `model.predict` (the predict run, the live lane)
        raise ValueError(
            f"make_demux_step classifies with a DTWSVMModel only, got {type(model).__name__}"
        )
    if classify:
        model = model.to(device)
    cnn = load_cnn(spc.cnn_model_name, device) if dcfg.method == "cnn" else None
    if fused_rolling is None:
        fused_rolling = fused_rolling_default()
    full = outputs == "full"

    def as_t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=device)

    @torch.inference_mode()
    def step(*args):
        adc = calibration = None
        if input_format == "vbz":
            keys, data, offset, scale, in_lens = args
            keys = as_t(keys, torch.uint8)
            adc = vbz_decode_batch(keys, as_t(data, torch.uint8), keys.shape[1] * 8)
            adc = adc.to(torch.int16)
        elif input_format == "adc":
            adc, offset, scale, in_lens = args
            adc = as_t(adc, torch.int16)
            width = dcfg.max_obs_trace
            if resolve_limit and adc.shape[1] < width:
                adc = torch.cat([adc, adc[:, -1:].expand(-1, width - adc.shape[1])], 1)
        else:
            signals, in_lens = args
            signals = as_t(signals, torch.float32)
        if adc is not None:
            offset = as_t(offset, torch.float32)
            scale = as_t(scale, torch.float32)
            signals = (adc.to(torch.float32) + offset[:, None]) * scale[:, None]
            calibration = (offset, scale)
        in_lens = as_t(in_lens, torch.int32)

        det = detect_boundaries_with_fallback(
            signals, in_lens, dcfg, cnn, with_stats=full, adc=adc,
            calibration=calibration, fused_rolling=fused_rolling, resolve_limit=resolve_limit,
        )
        cons = None
        if query is not None:
            cons = fingerprints_consensus_refined(
                signals, in_lens, det.adapter_start, det.adapter_end, query, fcfg, sx
            )
            fpt = cons.base
        else:
            fpt = fingerprints_from_boundaries(
                signals, in_lens, det.adapter_start, det.adapter_end, fcfg
            )
        # detect failures win; then "consensus query outlier" (13); any
        # other fingerprint failure is "event segmentation failed" (10)
        passed = det.fail_code == 0
        fail = torch.where(passed & ~fpt.ok, torch.full_like(det.fail_code, 10), det.fail_code)
        if cons is not None:
            fail = torch.where(passed & cons.outlier, torch.full_like(fail, 13), fail)
        success = fail == 0
        if classify:
            fpts = torch.where(success[:, None], fpt.fpt, torch.zeros_like(fpt.fpt))
            pred, conf, probs = model(fpts)
        else:
            B = signals.shape[0]
            pred = torch.full((B,), -1, dtype=torch.int32, device=device)
            conf = torch.zeros(B, dtype=torch.float32, device=device)
            probs = torch.zeros((B, 1), dtype=torch.float32, device=device)
        if full:
            return _pack(det, fpt, cons, fail, success, pred, conf, probs)
        out = DecisionStepOutput(pred, conf, fail, success, probs)
        return (out, det.resolved) if resolve_limit else out

    return step


def assemble_preload(adc1, rows, keys_t, data_t, n_samples: int) -> torch.Tensor:
    """(B, n_samples) int16: the stage-1 prefix adc1 (B, L1) of every row
    held at its last sample, and in the rows `rows` (int64, the sentinel B
    dropped) their tails (keys_t, data_t from ops/vbz_device.
    pack_tails_host), which decode to deltas from the row's last stage-1
    sample. The sentinel rows write into an extra row B, cut off after."""
    B, L1 = adc1.shape
    last = adc1[:, -1]
    base = torch.cat([last, last.new_zeros(1)])[rows].to(torch.int32)
    tail = vbz_decode_batch(keys_t, data_t, n_samples - L1)
    full = torch.cat([adc1, last[:, None].expand(B, n_samples - L1)], 1)
    full = torch.cat([full, full.new_zeros((1, n_samples))])
    full[rows, L1:] = (tail + base[:, None]).to(torch.int16)
    return full[:B]


class TwoStageHandle(NamedTuple):
    """A minibatch on the device after stage 1 of the two-stage wire."""

    adc1: torch.Tensor  # (B, stage1_len) int16, the decoded prefix
    offset: torch.Tensor  # (B,) float32
    scale: torch.Tensor  # (B,) float32
    in_lens: torch.Tensor  # (B,) int32
    out1: DecisionStepOutput
    resolved: torch.Tensor  # (B,) bool


def make_twostage_decision_step(model, spc: SigProcConfig, stage1_len: int = 7168, *, device=None):
    """The decision lane's two-stage wire on `device` (default: the CUDA
    GPU; `device="cpu"` the plain path).

    Stage 1 decodes the first `stage1_len` samples of each read (the VBZ
    wire cut by ops/vbz_device.split_wire_host) and runs the adc decision
    chain on them, each row padded with its last sample, with the read's
    true length; each row's `resolved` bit says its decision provably
    equals the whole preload's. Stage 2 takes the tails of the unresolved
    rows (ops/vbz_device.pack_tails_host), rebuilds the whole preload,
    runs the full-width adc decision chain and merges row-wise: resolved
    rows keep stage 1's outputs. Returns (stage1, stage2):

      stage1(keys1, data1, offset, scale, in_lens) -> TwoStageHandle
      stage2(handle, rows, keys_t, data_t) -> DecisionStepOutput

    Rows with the sentinel index B (the row ladder's padding) are dropped.
    Skip stage 2 where every row is resolved: handle.out1 is the answer.
    ValueError for a stage1_len outside (0, max_obs_trace) or not a
    multiple of 8, and for a CNN that reads past it (cnn_input_cap)."""
    dcfg = spc.detect
    L = dcfg.max_obs_trace
    L1 = int(stage1_len)
    if not (0 < L1 < L) or L1 % 8:
        raise ValueError(f"stage1_len must be in (0, {L}) and 8-aligned")
    if dcfg.method == "cnn" and not (0 < dcfg.cnn_input_cap <= L1):
        raise ValueError(
            "two-stage needs a prefix-causal CNN: set "
            f"cnn_boundaries.input_cap <= {L1} (got {dcfg.cnn_input_cap})"
        )
    device = resolve_device(device)
    kw = dict(input_format="adc", outputs="decision", device=device)
    chain1 = make_demux_step(model, spc, resolve_limit=L1, **kw)
    chain2 = make_demux_step(model, spc, **kw)

    def as_t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=device)

    @torch.inference_mode()
    def stage1(keys1, data1, offset, scale, in_lens) -> TwoStageHandle:
        adc1 = vbz_decode_batch(as_t(keys1, torch.uint8), as_t(data1, torch.uint8), L1).to(torch.int16)
        offset, scale = as_t(offset, torch.float32), as_t(scale, torch.float32)
        in_lens = as_t(in_lens, torch.int32)
        out1, resolved = chain1(adc1, offset, scale, in_lens)
        return TwoStageHandle(adc1, offset, scale, in_lens, out1, resolved)

    @torch.inference_mode()
    def stage2(handle: TwoStageHandle, rows, keys_t, data_t) -> DecisionStepOutput:
        full = assemble_preload(
            handle.adc1, as_t(rows, torch.int64), as_t(keys_t, torch.uint8), as_t(data_t, torch.uint8), L
        )
        out2 = chain2(full, handle.offset, handle.scale, handle.in_lens)

        def sel(a, b):
            cond = handle.resolved.reshape((-1,) + (1,) * (a.dim() - 1))
            return torch.where(cond, a, b)

        return DecisionStepOutput(*(sel(a, b) for a, b in zip(handle.out1, out2)))

    return stage1, stage2


def twostage_stage2(stage2, handle: TwoStageHandle, resolved, host_wire, n: int, n_samples: int, put=None):
    """Stage 2 of a two-stage minibatch, given stage 1's `resolved` read back
    to the host ((B,) bool) and the whole wire kept there (keys, data,
    in_lens and split_wire_host's off1): the tails of the unresolved rows
    among the first n (the rest is padding) packed on the host
    (ops/vbz_device.pack_tails_host), handed through `put` (the copy to the
    device; None: as they are) and stage 2 launched on them. Returns
    (stage 2's DecisionStepOutput, the packed tails), or (None, None) where
    every row resolved: handle.out1 is then the answer. The run loop, its
    tests and chip_smoke.py take each minibatch through this one protocol."""
    rows = np.nonzero(~np.asarray(resolved)[:n])[0]
    if not rows.size:
        return None, None
    keys, data, in_lens, off1 = host_wire
    tails = pack_tails_host(keys, data, in_lens, off1, rows, handle.adc1.shape[1], n_samples)
    return stage2(handle, *(tails if put is None else put(tails))), tails
