#!/usr/bin/env python3
"""Smoke test of the PyTorch port (warpdemux_tpu_torch) on one CUDA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

1. Print the card's name and power limit (nvidia-smi) and build the CUDA
   kernels of csrc/ from source.
2. For each kernel K1-K7, on numpy-seeded inputs at the decision step's
   shapes (B=1000 reads, L=10000 samples, A=6272 adapter samples, N=851 and
   2601 support vectors), compare the kernel with its plain PyTorch version
   on the card and time both.
3. Build the WDX4 decision step with the adc feed on the GPU, run the first
   256 reads of bench.synth_minibatch(default_rng(0), 1000, 10000) through
   it with every launch count at 0 beforehand, and check that every kernel
   ran; run the same reads through the plain path on the CPU and require
   (success, fail_code, pred) to agree on at least 255 of 256 rows and the
   CPU result to hit the repository's pins.
4. Time three B=1000 minibatches after one warm-up.

The line before last is a JSON object with per-kernel results; the last
line is {"ok": true, "device": {...}}. Exits non-zero without a CUDA device.
"""

import json
import subprocess
import sys
import time
from collections import Counter

MODEL = "WDX4_rna004_v1_0"
B, L = 1000, 10000
N_ROWS = 256  # rows held against the CPU path and the pins
PINS = (237, {-1: 236, 7: 1}, {2: 15, 5: 4})  # tests/test_bench_population.py
ULP_REL = 2.0**-23

KERNELS = {  # launch-count key -> (name, source, TPU kernel it replaces)
    "wdx_dtw": ("K1 dtw", "dtw.cu", "warpdemux_tpu/ops/dtw_pallas.py:94"),
    "wdx_ttest": ("K2 ttest", "ttest.cu", "warpdemux_tpu/ops/ttest_pallas.py:77"),
    "wdx_suppress": ("K3 peak suppression", "peaks.cu", "warpdemux_tpu/ops/peaks_pallas.py:79"),
    "wdx_range_median_mad": ("K4 range median/MAD", "select.cu", "warpdemux_tpu/ops/select_pallas.py:123"),
    "wdx_shift_rows": ("K5 window gather", "window_gather.cu", "warpdemux_tpu/ops/window_gather.py:36"),
    "wdx_rolling_mean_var": ("K6 rolling mean/var", "rolling.cu", "warpdemux_tpu/ops/rolling_pallas.py:77"),
    "wdx_run_sum": ("K7 rolling run-sum", "rolling.cu", "warpdemux_tpu/ops/rolling_pallas.py:123"),
}


def time_ms(fn, reps=10):
    """Mean device time of fn() in ms (CUDA events, after two warm-ups)."""
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs(a, b):
    import torch

    a, b = a.double(), b.double()
    both_nan = torch.isnan(a) & torch.isnan(b)
    d = torch.where(both_nan, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def check_kernels(dev):
    """Phase 2: kernel vs plain version on the card, at the step's shapes."""
    import numpy as np
    import torch

    from bench import synth_minibatch
    from warpdemux_tpu_torch.detect import boundaries as bd
    from warpdemux_tpu_torch.models.registry import load_model_arrays
    from warpdemux_tpu_torch.ops import dtw, peaks, segmentation, select, window_gather

    rng = np.random.default_rng(1)
    t = lambda a: torch.as_tensor(a, device=dev)
    results = {}

    def record(key, err, ms, plain_ms):
        results[key] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        print(f"{KERNELS[key][0]}: max_abs_err={err!r} kernel_ms={ms!r} plain_ms={plain_ms!r}")

    # K1: banded DTW against WDX4 (N=851) and WDX10 (N=2601) support vectors
    X = t(rng.normal(0, 1, (B, 25)).astype(np.float32))
    for model in ("WDX10_rna004_v1_0", MODEL):  # WDX4 last: its numbers are kept
        Y = t(load_model_arrays(model)["X_sv"].astype(np.float32))
        k = dtw.dtw_distance_matrix(X, Y, 15, 0.1)
        p = dtw.dtw_distance_matrix_plain(X, Y, 15, 0.1)
        rel = float(((k - p).abs() / p.abs().clamp_min(1e-30)).max())
        require(rel <= 4 * ULP_REL, f"K1 N={Y.shape[0]}: rel err {rel}")
        print(f"K1 N={Y.shape[0]}: max_rel_err={rel!r}")
    record(
        "wdx_dtw", max_abs(k, p),
        time_ms(lambda: dtw.dtw_distance_matrix(X, Y, 15, 0.1)),
        time_ms(lambda: dtw.dtw_distance_matrix_plain(X, Y, 15, 0.1), reps=2),
    )

    # K2: t-test scores over (B, 6272) adapter buffers
    A = 6272
    xa = t(rng.normal(80, 12, (B, A)).astype(np.float32))
    n_valid = t(rng.integers(1000, A + 1, B).astype(np.int32))
    w = torch.clamp(torch.round(n_valid.float() / 110).int(), 1, 12)
    k, _ = segmentation.windowed_t_test(xa, n_valid, w, 12)
    p = segmentation.windowed_t_test_plain(xa, n_valid, w, 12)
    rel = float(((k - p).abs() / p.abs().clamp_min(1e-30)).max())
    require(rel <= 4 * ULP_REL, f"K2: rel err {rel}")
    record(
        "wdx_ttest", max_abs(k, p),
        time_ms(lambda: segmentation.windowed_t_test(xa, n_valid, w, 12)),
        time_ms(lambda: segmentation.windowed_t_test_plain(xa, n_valid, w, 12)),
    )

    # K3: distance suppression of the t-score peaks
    scores = p
    is_peak, _ = peaks.peak_mask_batch(scores, torch.clamp_min(n_valid - 2 * w, 0))
    dist = torch.clamp(torch.round(n_valid.float() / 220).int(), 1, 6)
    k = peaks.suppress_by_distance(scores, is_peak, dist, 7)
    p = peaks.suppress_by_distance_plain(scores, is_peak, dist, 7)
    require(torch.equal(k, p), "K3: keep masks differ")
    record(
        "wdx_suppress", max_abs(k.int(), p.int()),
        time_ms(lambda: peaks.suppress_by_distance(scores, is_peak, dist, 7)),
        time_ms(lambda: peaks.suppress_by_distance_plain(scores, is_peak, dist, 7)),
    )

    # K4: gate medians (R=2 over L=10000, empty ranges included) and the
    # outlier-clip median + MAD (R=1 over A=6272)
    adc, off, sc, _ = synth_minibatch(np.random.default_rng(2), B, L)
    x = (t(adc).float() + t(off)[:, None]) * t(sc)[:, None]
    starts = t(np.stack([np.zeros(B), rng.integers(0, L, B)]).astype(np.int32))
    ends = t(np.stack([rng.integers(0, 6000, B), rng.integers(0, L + 1, B)]).astype(np.int32))
    a_len = n_valid[None]
    zero = torch.zeros_like(a_len)
    errs = []
    for args in ((x, starts, ends, False), (xa, zero, a_len, True)):
        km, kd = select.range_median_mad(*args)
        pm, pd = select.range_median_mad_plain(*args)
        errs += [max_abs(km, pm)] + ([max_abs(kd, pd)] if args[3] else [])
        require(torch.equal(km.isnan(), pm.isnan()), "K4: NaN pattern differs")
    require(max(errs) == 0.0, f"K4: errors {errs}")
    record(
        "wdx_range_median_mad", max(errs),
        time_ms(lambda: select.range_median_mad(x, starts, ends, False)),
        time_ms(lambda: select.range_median_mad_plain(x, starts, ends, False)),
    )

    # K5: LLR refine windows (800 of 10000) and adapter extraction
    # (6272 of 16272)
    s800 = t(rng.integers(0, L - 800, B).astype(np.int32))
    xpad = torch.cat([x, torch.zeros((B, A), device=dev)], 1)
    sA = t(rng.integers(0, L, B).astype(np.int32))
    errs = []
    for src, st, n in ((x, s800, 800), (xpad, sA, A)):
        k = window_gather.shift_rows(src, st, n)
        p = window_gather.shift_rows_plain(src, st, n)
        require(torch.equal(k, p), f"K5: out_len {n} differs")
        errs.append(max_abs(k, p))
    record(
        "wdx_shift_rows", max(errs),
        time_ms(lambda: window_gather.shift_rows(xpad, sA, A)),
        time_ms(lambda: window_gather.shift_rows_plain(xpad, sA, A)),
    )

    # K6: rolling mean/var of the calibrated signal (w 200 and 500)
    k = bd.rolling_mean_var(x, 200, 500)
    p = bd.rolling_mean_var_plain(x, 200, 500)
    err = max(max_abs(a, b) for a, b in zip(k, p))
    # tests/test_detect.py:106 tolerance (prefix-sum rounding)
    torch.testing.assert_close(k[0], p[0], rtol=5e-4, atol=0.05)
    for a, b, win in ((k[1], p[1], 200), (k[2], p[2], 500)):
        torch.testing.assert_close(a[:, : L - win], b[:, : L - win], rtol=3e-3, atol=0.1)
        torch.testing.assert_close(a[:, L - win :], b[:, L - win :], rtol=0, atol=5.0)
    record(
        "wdx_rolling_mean_var", err,
        time_ms(lambda: bd.rolling_mean_var(x, 200, 500)),
        time_ms(lambda: bd.rolling_mean_var_plain(x, 200, 500)),
    )

    # K7: sustained-run counts of a candidate mask (w 100)
    mask = t(rng.random((B, L)) < 0.4)
    k, p = bd.run_sum(mask, 100), bd.run_sum_plain(mask, 100)
    require(torch.equal(k, p), "K7 differs")
    record(
        "wdx_run_sum", max_abs(k, p),
        time_ms(lambda: bd.run_sum(mask, 100)),
        time_ms(lambda: bd.run_sum_plain(mask, 100)),
    )
    return results


def run_main_path(dev):
    """Phase 3: the decision step on the GPU, held against the CPU path."""
    import numpy as np
    import torch

    from bench import synth_minibatch
    from warpdemux_tpu_torch import _cuda
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    spc = get_model_spc_config(MODEL)
    gpu_step = make_demux_step(load_model(MODEL), spc, "adc", device=dev)
    cpu_step = make_demux_step(load_model(MODEL), spc, "adc", device="cpu")
    adc, off, sc, lens = synth_minibatch(np.random.default_rng(0), B, L)
    rows = (adc[:N_ROWS], off[:N_ROWS], sc[:N_ROWS], lens[:N_ROWS])

    _cuda.reset_launches()
    out = gpu_step(*rows)
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    print(f"launches in the main-path run: {launches}")
    for key, n in launches.items():
        require(n > 0, f"{key} was never launched by the main path")

    ref = cpu_step(*rows)
    probs = out.probs.cpu()
    require(probs.shape == (N_ROWS, 5), f"probs shape {tuple(probs.shape)}")
    require(bool(torch.isfinite(probs).all()), "non-finite probabilities")
    same = (
        (out.success.cpu() == ref.success)
        & (out.fail_code.cpu() == ref.fail_code)
        & (out.pred.cpu() == ref.pred)
    )
    print(f"rows agreeing GPU vs CPU on (success, fail_code, pred): {int(same.sum())}/{N_ROWS}")
    require(int(same.sum()) >= N_ROWS - 1, "GPU and CPU decisions disagree")
    for name, r in (("gpu", out), ("cpu", ref)):
        succ = r.success.cpu().numpy()
        pred, fail = r.pred.cpu().numpy(), r.fail_code.cpu().numpy()
        counts = (
            int(succ.sum()),
            dict(Counter(pred[succ].tolist())),
            dict(Counter(fail[~succ].tolist())),
        )
        print(f"{name}: passes={counts[0]} calls={counts[1]} fails={counts[2]}")
        if name == "cpu":
            require(counts == PINS, f"CPU path misses the pins {PINS}")
    print(f"max |probs gpu - cpu| = {float((probs - ref.probs).abs().max())!r}")
    return gpu_step, launches


def time_throughput(gpu_step, card):
    """Phase 4: reads/s over three B=1000 minibatches after one warm-up."""
    import numpy as np
    import torch

    from bench import synth_minibatch

    rng = np.random.default_rng(0)
    batches = [synth_minibatch(rng, B, L) for _ in range(4)]
    gpu_step(*batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches[1:]:
        gpu_step(*batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"decision step: {3 * B / dt!r} reads/s ({dt / 3 * 1e3!r} ms per B={B} batch) on {card}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from warpdemux_tpu_torch import _cuda  # fails outside the repository

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _cuda.library()
    print(f"kernel build + load: {time.perf_counter() - t0:.1f} s")

    results = check_kernels(dev)
    gpu_step, launches = run_main_path(dev)
    time_throughput(gpu_step, card)

    kernels = []
    for key, (name, source, replaces) in KERNELS.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"warpdemux_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": launches[key],
            **results[key],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
