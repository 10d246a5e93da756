"""Time of each stage of the demux step, with the inputs on the device.

Port of tools/profile_stages.py: the stages of the WDX4 step run one by
one as the vbz full step chains them (pipeline/step.py), each timed over
REPS = 8 calls after a warm-up, between two torch.cuda.synchronize() on the
card, on utils/synthetic.synth_minibatch(default_rng(0), B, 10000):

- vbz decode (ops/vbz_device, the reads packed with its numpy helpers),
  detect (with the step's adc and calibration), fingerprint, dtw (B x 851),
  svm proba (the exp kernel, the decision values and the probabilities);
- the fingerprint's sub-operations: extract_adapter_batch,
  clip_outliers_prefix, windowed_t_test, peak_mask_batch,
  suppress_by_distance, select_top_peaks, segment_means;
- the SVM's decision_values (K12) and probabilities (K13). The port's
  coupling takes the decision values, where the JAX tool times
  multiclass_probability on the pairwise matrix r built from them: the
  Platt sigmoid and the matrix are inside K13.

Each row gives ms a call, reads/s and the launches a call of the port's
kernels. The chain's pred, conf, probs and fingerprints are those of the
vbz full step on the same reads (tests/test_torch_profile_tools.py).

Usage:
    python -m warpdemux_tpu_torch.tools.profile_stages [B] [--reps 8] [--device cpu]

Runs on the CUDA GPU unless `--device` names another, and raises without
one. `stage_table` is the same run as a function.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import NamedTuple

import torch

from warpdemux_tpu_torch import _cuda
from warpdemux_tpu_torch.tools import _trace

REPS = 8


class Stage(NamedTuple):
    name: str
    ms: float  # a call
    launches: dict  # kernel entry point -> launches a call (those launched)


class StageTable(NamedTuple):
    device: str  # the card's name and power limit, or "cpu"
    B: int
    stages: list[Stage]
    outputs: dict  # the chain's pred, conf, probs, fpt, fpt_ok, success

    def table(self) -> list[str]:
        lines = ["| stage | ms/minibatch | reads/s | launches/call |", "|---|---|---|---|"]
        for s in self.stages:
            if s.name == "---":
                lines.append("|---|---|---|---|")
                continue
            launches = ", ".join(f"{k} {v:g}" for k, v in s.launches.items())
            lines.append(f"| {s.name} | {s.ms:8.3f} | {self.B / s.ms * 1e3:10.0f} | {launches} |")
        return lines


@torch.inference_mode()
def stage_table(B: int = 1000, device=None, reps: int = REPS) -> StageTable:
    """Each stage of the WDX4 vbz full step timed on `device` (the GPU unless
    named) over `reps` calls."""
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.detect.boundaries import detect_boundaries_with_fallback
    from warpdemux_tpu_torch.models.registry import load_cnn, load_model
    from warpdemux_tpu_torch.ops import svm
    from warpdemux_tpu_torch.ops.dtw import dtw_distance_matrix
    from warpdemux_tpu_torch.ops.fingerprint import extract_adapter_batch, fingerprints_from_boundaries
    from warpdemux_tpu_torch.ops.normalize import clip_outliers_prefix
    from warpdemux_tpu_torch.ops.peaks import peak_mask_batch, select_top_peaks, suppress_by_distance
    from warpdemux_tpu_torch.ops.segmentation import segment_means, windowed_t_test
    from warpdemux_tpu_torch.ops.vbz_device import vbz_decode_batch

    device = _cuda.resolve_device(device)
    spc = get_model_spc_config(_trace.MODEL)
    dcfg, fcfg = spc.detect, spc.fingerprint
    model = load_model(_trace.MODEL, device)
    cnn = load_cnn(spc.cnn_model_name, device) if dcfg.method == "cnn" else None
    adc_np, offset, scale, lens = _trace.bench_minibatch(B)
    keys, data = (torch.as_tensor(a, device=device) for a in _trace.vbz_pack(adc_np))
    offset, scale = (torch.as_tensor(a, device=device) for a in (offset, scale))
    in_lens = torch.as_tensor(lens, dtype=torch.int32, device=device)
    stages: list[Stage] = []

    def timeit(name, fn, *args):
        out = fn(*args)
        _trace.synchronize(device)
        before = dict(_cuda.launches)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        _trace.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3 / reps
        launched = {k: (n - before[k]) / reps for k, n in _cuda.launches.items() if n != before[k]}
        stages.append(Stage(name, ms, launched))
        return out

    # the step's stages, chained as the vbz full step chains them
    adc = timeit("vbz decode", lambda: vbz_decode_batch(keys, data, keys.shape[1] * 8).to(torch.int16))
    signals = (adc.to(torch.float32) + offset[:, None]) * scale[:, None]
    det = timeit("detect", lambda: detect_boundaries_with_fallback(
        signals, in_lens, dcfg, cnn, with_stats=True, adc=adc, calibration=(offset, scale)))
    fpt = timeit("fingerprint", fingerprints_from_boundaries, signals, in_lens, det.adapter_start,
                 det.adapter_end, fcfg)
    passed = det.fail_code == 0
    fail = torch.where(passed & ~fpt.ok, torch.full_like(det.fail_code, 10), det.fail_code)
    success = fail == 0
    fpts = torch.where(success[:, None], fpt.fpt, torch.zeros_like(fpt.fpt))
    D = timeit(f"dtw (B x {model.X_sv.shape[0]})", dtw_distance_matrix, fpts, model.X_sv, model.window,
               model.penalty)
    probs = timeit("svm proba", lambda D: svm.predict_proba(svm.pdist_kernel(D, model.gamma, model.pwr_dist),
                                                            model.params), D)
    pred, conf = svm.process_probs(probs, model.label_map, model.thresholds)

    # the fingerprint's sub-operations, on what the stage hands each
    stages.append(Stage("---", 0.0, {}))
    a0, a1 = det.adapter_start.to(torch.int32), det.adapter_end.to(torch.int32)
    adapter, a_len = timeit("  extract_adapter_batch", extract_adapter_batch, signals, in_lens, a0, a1,
                            fcfg.padding, fcfg.buffer_len)
    amask = torch.arange(adapter.shape[1], device=device)[None, :] < a_len[:, None]
    clipped = timeit("  clip_outliers_prefix", clip_outliers_prefix, adapter, a_len, fcfg.sig_norm_outlier_thresh)
    clipped = torch.where(amask, clipped, torch.zeros_like(clipped))
    nf = a_len.to(torch.float32)
    min_obs = torch.clamp_max(torch.round(nf / fcfg.num_events / 2.0).to(torch.int32), fcfg.min_obs_per_base)
    w = torch.clamp_min(torch.clamp_max(torch.round(nf / fcfg.num_events).to(torch.int32),
                                        fcfg.running_stat_width), 1)
    scores, n_scores = timeit("  windowed_t_test", windowed_t_test, clipped, a_len, w, fcfg.running_stat_width)
    is_peak, _ = timeit("  peak_mask_batch", peak_mask_batch, scores, n_scores)
    keep = timeit("  suppress_by_distance", suppress_by_distance, scores, is_peak, torch.clamp_min(min_obs, 1),
                  fcfg.min_obs_per_base + 1)
    count = keep.sum(1).to(torch.int32)
    sel_pos, _ = timeit("  select_top_peaks", select_top_peaks, scores, keep, count, fcfg.num_events)
    cpts = torch.sort(sel_pos, dim=1).values + w[:, None]
    bounds = torch.cat([torch.zeros((B, 1), dtype=torch.int32, device=device), cpts, a_len[:, None]], dim=1)
    timeit("  segment_means", segment_means, clipped, bounds, a_len)

    # the SVM's two kernels
    stages.append(Stage("---", 0.0, {}))
    K = svm.pdist_kernel(D, model.gamma, model.pwr_dist)
    dec = timeit("  svm decision_values", svm.decision_values, K, model.params)
    timeit("  svm probabilities", svm.probabilities, dec, model.params)
    outputs = dict(pred=pred, conf=conf, probs=probs, fpt=fpt.fpt, fpt_ok=fpt.ok, success=success)
    return StageTable(_trace.device_name(device), B, stages, outputs)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("B", nargs="?", type=int, default=1000, help="reads a minibatch")
    p.add_argument("--reps", type=int, default=REPS, help="calls timed (and traced)")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA GPU)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    t = stage_table(args.B, args.device, args.reps)
    print(f"# device={t.device} B={t.B} L={_trace.L} reps={args.reps}")
    print("\n".join(t.table()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
