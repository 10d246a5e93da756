#!/usr/bin/env python3
"""Tile-size sweep of kernels K1 (csrc/dtw.cu), K6 / K9 and K7
(csrc/rolling.cu), K4 and K8 (csrc/select.cu), K3 (csrc/peaks.cu), K2
(csrc/ttest.cu), K5 (csrc/window_gather.cu) and K11 (csrc/rowstats.cu) on one
CUDA GPU.

    python3 tune_kernels.py

Each variant is the kernel library built by `_cuda.build` with other values
of the sources' tile macros, six builds at a time:

- K1: WDX_DTW_THREADS references and WDX_DTW_TQ queries a tile;
- K6 / K9: WDX_ROLLING_THREADS a row;
- K7: WDX_RUNSUM_THREADS a row;
- K4: WDX_SELECT_THREADS a range, WDX_SELECT_MIN_BLOCKS an SM,
  WDX_SELECT_BITS a digit, WDX_SELECT_PREFIX the common-prefix pass,
  WDX_SELECT_SPREAD the first round's eight copies of a bin;
- K8: WDX_ADC_THREADS a range, WDX_ADC_MIN_BLOCKS an SM, and K4's
  WDX_SELECT_PREFIX and WDX_SELECT_SPREAD (the selection is shared);
- K3: WDX_SUPPRESS_THREADS a row (the block; 32 is a warp a row);
- K2: WDX_TTEST_THREADS a block, WDX_TTEST_RUN positions a thread,
  WDX_TTEST_TILE positions a block (6272: the whole adapter buffer);
- K5: WDX_GATHER_THREADS a block, WDX_GATHER_VECTORS 16-byte vectors a thread;
- K11: WDX_ROWSTATS_BLOCK_WARPS a block (a row) of the block kernel and
  WDX_ROWSTATS_MIN_BLOCKS blocks an SM its registers are held to,
  WDX_ROWSTATS_IN_FLIGHT 16-byte loads a thread in flight while staging.

`python3 tune_kernels.py K11` sweeps K11 alone.

`python3 tune_kernels.py SVM [--against DIR]` sweeps K12 (csrc/svmdot.cu:
WDX_SVMDOT_RT2_WIDTH the product width from which a summing thread takes
two rows, 0 for always and 1000000 for never, WDX_SVMDOT_MIN_THREADS a block,
WDX_SVMDOT_KT terms a chunk, WDX_SVMDOT_WHOLE_SMEM = 0 to chunk always,
WDX_SVMDOT_BLOCKS a full minibatch is cut into) and K13 (csrc/svmprob.cu:
WDX_SVMPROB_WARPS rows a block) alone at the models' shapes, K13 also with
its passes cut to 0 (what the sigmoids and the launch cost) and at the
default build's division latency. With --against, DIR holds another tree's
svmdot.cu, svmprob.cu and common.cuh (the parent commit's, unpacked with
`git archive`): its two kernels are built apart and timed in turns with
this tree's default build (theirs, ours, ours, theirs).

For each variant the script prints what ptxas reported for the kernel
(registers, spills), checks the wrapper's output bit for bit against the
plain PyTorch version, and prints the mean time of 20 launches (CUDA
events, after 2 warm-ups, the launches queued behind a spin kernel so that
the host's time to enqueue them does not count) at the step's shapes: B=1000
fingerprints against the 851 WDX4 and the 2601 WDX10 support vectors;
B=1000 reads of L=10000 samples; for K4 the outlier clip (R=1 over 6272
samples, median and MAD), the region statistics of the full output (R=3
over L=10000, two medians given, calibrated MADs) and the gate medians
(R=2, medians only); for K8 the gate medians and the adapter-level proxy
(R=1 over the first 2000 samples); for K3 the (1000, 6272) t-scores of the
adapter buffers, which K2 computes; for K5 the refine windows (2 x 800 of a
read's 10000 samples), the adapter extraction (6272 of 10000, with lengths)
and the gather from a zero-padded copy. The first variant of a kernel is the committed
default. K2 is probed with no valid sample (zeros only) and on full rows
by width; K4 is then probed on rows of crafted keys (equal, two values, 256
values, a read's samples) and on 1 to 4000 ranges, K8 on rows of crafted
counts. The last line names the
card and its power limit.
"""

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import chip_smoke

B, L = 1000, 10000
time_ms = partial(chip_smoke.time_ms, reps=20, queued=True)  # the device's time alone

K1_VARIANTS = [(), *[(f"-DWDX_DTW_THREADS={t}", f"-DWDX_DTW_TQ={q}") for t, q in ((128, 1), (128, 8), (64, 4), (256, 4))]]
K6_VARIANTS = [(), ("-DWDX_ROLLING_THREADS=256",), ("-DWDX_ROLLING_THREADS=1024",)]
K7_VARIANTS = [(), *[(f"-DWDX_RUNSUM_THREADS={n}",) for n in (128, 512, 1024)]]
K4_VARIANTS = [
    (),  # 256 threads, 4 blocks an SM, 8-bit digits, common-prefix pass, spread first round
    ("-DWDX_SELECT_MIN_BLOCKS=6",),
    ("-DWDX_SELECT_MIN_BLOCKS=8",),
    ("-DWDX_SELECT_THREADS=128", "-DWDX_SELECT_MIN_BLOCKS=12"),
    ("-DWDX_SELECT_THREADS=512", "-DWDX_SELECT_MIN_BLOCKS=3"),
    ("-DWDX_SELECT_BITS=11",),
    ("-DWDX_SELECT_PREFIX=0",),
    ("-DWDX_SELECT_SPREAD=0",),
]
K8_VARIANTS = [
    (),  # 128 threads, 8 blocks an SM; K4's selection as committed
    *[(f"-DWDX_ADC_THREADS={t}", f"-DWDX_ADC_MIN_BLOCKS={m}") for t, m in ((64, 16), (128, 12), (256, 4), (256, 6), (256, 8), (512, 3))],
    *K4_VARIANTS[-2:],
]
K3_VARIANTS = [(), *[(f"-DWDX_SUPPRESS_THREADS={n}",) for n in (32, 64, 128, 192, 512)]]  # default: 256
K2_VARIANTS = [
    (),  # 128 threads, 2 positions a thread, tiles of 1024 positions
    *[(f"-DWDX_TTEST_THREADS={t}", f"-DWDX_TTEST_RUN={r}", f"-DWDX_TTEST_TILE={n}")
      for t in (128, 256, 512) for r in (2, 4, 8) for n in (512, 1024, 2048, 6272) if (t, r, n) != (128, 2, 1024)],
]
K5_VARIANTS = [(), *[(f"-DWDX_GATHER_THREADS={t}", f"-DWDX_GATHER_VECTORS={v}") for t in (64, 128, 256) for v in (1, 2, 4) if (t, v) != (128, 2)]]
K11_VARIANTS = [  # default: 4 warps, registers for 8 blocks an SM, 4 loads in flight
    (), *[(f"-DWDX_ROWSTATS_BLOCK_WARPS={n}", f"-DWDX_ROWSTATS_MIN_BLOCKS={m}") for n, m in ((2, 16), (6, 8), (8, 8), (8, 4))],
    *[(f"-DWDX_ROWSTATS_IN_FLIGHT={n}",) for n in (2, 8)],
]


def sweep_k11(dev, ptxas):
    """K11's block kernel by variant at the three step shapes (the region
    statistics, calibrated, R = 3 with stds; the gate, calibrated, R = 1;
    the float feed, R = 3 with stds), bit for bit against the plain version,
    beside the warp kernel of the default build."""
    import numpy as np
    import torch

    from warpdemux_tpu_torch import _cuda
    from warpdemux_tpu_torch.ops import rowstats

    rng = np.random.default_rng(12)
    t = lambda a: torch.as_tensor(a, device=dev)
    cal = (t(rng.integers(-1500, 2500, (B, L)).astype(np.int16)), t(rng.uniform(-5, 20, B).astype(np.float32)),
           t(rng.uniform(0.1, 0.3, B).astype(np.float32)))
    x = (cal[0].float() + cal[1][:, None]) * cal[2][:, None]
    st, en = (t(a) for a in chip_smoke.k11_step_ranges(rng, B, L))
    shapes = {"region statistics": (x, st, en, True, cal), "gate": (x, st[1:2], en[1:2], False, cal),
              "pa feed": (x, st, en, True, None)}
    want = {name: rowstats.range_mean_std_plain(*args) for name, args in shapes.items()}

    def exact(got, plain):
        return all(a is b or torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(got, plain))

    for defines in K11_VARIANTS:
        _cuda.defines = defines
        row = [f"K11 {' '.join(defines) or 'default'}"]
        for name, args in shapes.items():
            run = lambda: rowstats.range_mean_std(*args, variant="block")
            row.append(f"{name}: exact={exact(run(), want[name])} ms={time_ms(run)!r}")
        print(" | ".join(row), "|", ptxas(defines, "wdx_rowstats_block_kernelILb1"))
    _cuda.defines = ()
    row = ["K11 warp kernel, default build"]
    for name, args in shapes.items():
        run = lambda: rowstats.range_mean_std(*args, variant="warp")
        row.append(f"{name}: exact={exact(run(), want[name])} ms={time_ms(run)!r}")
    print(" | ".join(row), "|", ptxas((), "wdx_rowstats_kernel"))


SVM_VARIANTS = [(), ("-DWDX_SVMDOT_RT2_WIDTH=0",), ("-DWDX_SVMDOT_RT2_WIDTH=1000000",), ("-DWDX_SVMDOT_MIN_THREADS=256",),
                ("-DWDX_SVMDOT_MIN_THREADS=1024",), ("-DWDX_SVMDOT_KT=32",), ("-DWDX_SVMDOT_WHOLE_SMEM=0",),
                ("-DWDX_SVMDOT_BLOCKS=264",), ("-DWDX_SVMPROB_WARPS=2",), ("-DWDX_SVMPROB_WARPS=8",)]
SVM_SHAPES = (("WDX4_rna004_v1_0", 1000), ("WDX4_rna004_v1_0", 16), ("WDX4_rna004_v1_0", 32),
              ("WDX4_tRNA_rna004_v1_0", 1000), ("WDX6_rna004_v1_0", 1000), ("WDX10_rna004_v1_0", 1000),
              ("WDX12_rna002_v0_4_4", 1000))


def sweep_svm(dev, ptxas, against=None):
    """K12 and K13 by variant at SVM_SHAPES (kernel rows exp(-U(0, 8)) from
    a seed against the models' coefficients, K13 on their decision
    values), each bit for bit against its plain version; then K13's cost
    without passes; then, with `against`, another tree's K12 and K13 in
    turns with this tree's."""
    import ctypes
    from pathlib import Path

    import numpy as np
    import torch

    from warpdemux_tpu_torch import _cuda
    from warpdemux_tpu_torch.models.registry import load_model
    from warpdemux_tpu_torch.ops import numerics, svm

    models = {name: load_model(name, dev) for name, _ in SVM_SHAPES}
    cases = []
    for name, b in SVM_SHAPES:
        m = models[name]
        K = torch.as_tensor(np.exp(-np.random.default_rng(b).uniform(0, 8, (b, m.coef.shape[0]))).astype(np.float32),
                            device=dev)
        cases.append((name, b, m, K, svm.decision_values_plain(K, m.params)))
    for defines in SVM_VARIANTS:
        _cuda.defines = defines
        row = [f"K12/K13 {' '.join(defines) or 'default'}"]
        for name, b, m, K, dec in cases:
            k12 = lambda: svm.decision_values(K, m.params)
            k13 = lambda: svm.probabilities(dec, m.params)
            exact = torch.equal(k12(), dec) and torch.equal(k13(), svm.probabilities_plain(dec, m.params))
            row.append(f"{name} B={b}: exact={exact} K12 ms={time_ms(k12)!r} K13 ms={time_ms(k13)!r}")
        print(" | ".join(row), "|", ptxas(defines, "svm"))
    _cuda.defines = ()
    lib = _cuda.library()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def probs_call(fn, dec, m, out, passes=None):
        B, k = dec.shape[0], m.n_classes
        return lambda: fn(dec.data_ptr(), m.probA.data_ptr(), m.probB.data_ptr(), out.data_ptr(), B, k, 1e-7,
                          1 - 1e-7, 0.005 / k, max(100, k) if passes is None else passes, svm.xla_vector_rows(B),
                          stream)

    def dot_call(fn, K, m, out):
        B, N = K.shape
        P = m.coef.shape[1]
        mode, kc = numerics.dot_order(B, N, P)
        return lambda: fn(K.data_ptr(), m.coef.data_ptr(), m.intercept.data_ptr(), out.data_ptr(), B, N, P, mode, kc,
                          stream)

    div_ns = chip_smoke.division_ns(dev)
    for name, b, m, K, dec in cases:
        out = torch.empty((b, m.n_classes), device=dev)
        most = chip_smoke.k13_work(dec, m.params)[2]
        print(f"K13 {name} B={b}: no pass ms={time_ms(probs_call(lib.wdx_svm_probs, dec, m, out, 0))!r}, "
              f"all ms={time_ms(probs_call(lib.wdx_svm_probs, dec, m, out))!r}, largest row {most} passes; "
              f"a division that waits for the last {div_ns!r} ns")
    if against is None:
        return
    theirs_path = _cuda.BUILD_DIR / "against" / "libwdx_svm_against.so"
    _cuda.compile_library([Path(against, "svmdot.cu"), Path(against, "svmprob.cu")], theirs_path)
    theirs = ctypes.CDLL(str(theirs_path))
    for fname in ("wdx_svm_dot", "wdx_svm_probs"):
        getattr(theirs, fname).argtypes = [*_cuda.SIGNATURES[fname], ctypes.c_void_p]
    for name, b, m, K, dec in cases:
        d_out, p_out = torch.empty_like(dec), torch.empty((b, m.n_classes), device=dev)
        row = [f"{name} B={b}, {against} / this tree in turns"]
        for kernel, calls in (("K12", (dot_call(theirs.wdx_svm_dot, K, m, d_out), dot_call(lib.wdx_svm_dot, K, m, d_out))),
                              ("K13", (probs_call(theirs.wdx_svm_probs, dec, m, p_out),
                                       probs_call(lib.wdx_svm_probs, dec, m, p_out)))):
            times = [time_ms(calls[i]) for i in (0, 1, 1, 0)]
            row.append(f"{kernel} ms {times!r}")
        if m.coef.dtype == torch.float32:
            row.append(f"torch.addmm ms={time_ms(lambda: torch.addmm(m.intercept, K, m.coef))!r}")
        print(" | ".join(row))


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def main(argv) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("tune_kernels: no CUDA device", file=sys.stderr)
        return 1
    from warpdemux_tpu_torch.utils.synthetic import synth_minibatch
    from warpdemux_tpu_torch import _cuda
    from warpdemux_tpu_torch.detect import boundaries as bd
    from warpdemux_tpu_torch.models.registry import load_model_arrays
    from warpdemux_tpu_torch.ops import dtw, peaks, segmentation, select, window_gather

    dev = torch.device("cuda", 0)
    t = lambda a: torch.as_tensor(a, device=dev)
    if argv[:1] == ["SVM"]:
        against = argv[2] if argv[1:2] == ["--against"] else None
        with ThreadPoolExecutor(6) as pool:
            logs = dict(zip(SVM_VARIANTS, pool.map(lambda d: _cuda.build_log(_cuda.build(d)).read_text(), SVM_VARIANTS)))
        sweep_svm(dev, lambda defines, kernel: "; ".join(
            line for line in _cuda.ptxas_summary(logs[defines]) if kernel in line), against)
        print(card_line())
        return 0
    only_k11 = argv == ["K11"]
    variants = K11_VARIANTS if only_k11 else list(dict.fromkeys(
        K1_VARIANTS + K6_VARIANTS[1:] + K7_VARIANTS[1:] + K4_VARIANTS[1:] + K8_VARIANTS[1:] + K3_VARIANTS[1:]
        + K2_VARIANTS[1:] + K5_VARIANTS[1:] + K11_VARIANTS[1:]
    ))
    with ThreadPoolExecutor(6) as pool:
        logs = dict(zip(variants, pool.map(lambda d: _cuda.build_log(_cuda.build(d)).read_text(), variants)))

    def ptxas(defines, kernel):
        return "; ".join(line for line in _cuda.ptxas_summary(logs[defines]) if kernel in line)

    sweep_k11(dev, ptxas)
    if only_k11:
        print(card_line())
        return 0

    X = t(np.random.default_rng(1).normal(0, 1, (B, 25)).astype(np.float32))
    refs = [t(load_model_arrays(m)["X_sv"].astype(np.float32)) for m in ("WDX4_rna004_v1_0", "WDX10_rna004_v1_0")]
    want = [dtw.dtw_distance_matrix_plain(X, Y, 15, 0.1) for Y in refs]
    for defines in K1_VARIANTS:
        _cuda.defines = defines
        row = [f"K1 {' '.join(defines) or 'default'}"]
        for Y, w in zip(refs, want):
            run = lambda: dtw.dtw_distance_matrix(X, Y, 15, 0.1)
            row.append(f"N={Y.shape[0]}: exact={torch.equal(run(), w)} ms={time_ms(run)!r}")
        print(" | ".join(row), "|", ptxas(defines, "wdx_dtw_kernelILi25"))

    adc, off, sc, _ = synth_minibatch(np.random.default_rng(2), B, L)
    x = (t(adc).float() + t(off)[:, None]) * t(sc)[:, None]
    rng = np.random.default_rng(1)
    region = t(np.repeat(rng.random((B, L // 500)) < 0.5, 500, axis=1).astype(np.float32))
    lens = t(rng.integers(3000, L + 1, B).astype(np.int32))
    args = (x, region, 1.3 * x[:, :2000].median(1).values, lens, 200, 500, 100, 30.0)
    want = bd.rolling_detect_plain(*args)
    for defines in K6_VARIANTS:
        _cuda.defines = defines
        k6 = lambda: bd.rolling_mean_var(x, 200, 500)
        k9 = lambda: bd.rolling_detect(*args)
        exact6 = all(torch.equal(a, b) for a, b in zip(k6(), want))
        exact9 = all(torch.equal(a, b) for a, b in zip(k9(), want))
        print(f"K6/K9 {' '.join(defines) or 'default'} | K6 exact={exact6} ms={time_ms(k6)!r} | "
              f"K9 exact={exact9} ms={time_ms(k9)!r} | {ptxas(defines, 'wdx_rolling')}")
    mask = t(rng.random((B, L)) < 0.4)
    want = bd.run_sum_plain(mask, 100)
    for defines in K7_VARIANTS:
        _cuda.defines = defines
        run = lambda: bd.run_sum(mask, 100)
        print(f"K7 {' '.join(defines) or 'default'} | exact={torch.equal(run(), want)} ms={time_ms(run)!r} |",
              ptxas(defines, "wdx_run_sum_prefix_kernelILb1"))

    # K4 on chip_smoke.py's inputs: heavy ties in the first 3000 samples
    A = 6272
    adc16 = t(adc)
    adc16[:, :3000] = adc16[:, :3000] // 16 * 16
    off, sc = t(off), t(sc)
    x = (adc16.float() + off[:, None]) * sc[:, None]
    xa = t(rng.normal(80, 12, (B, A)).astype(np.float32))
    n_valid = t(rng.integers(1000, A + 1, B).astype(np.int32))[None]
    starts = t(np.stack([np.zeros(B), rng.integers(0, L, B)]).astype(np.int32))
    ends = t(np.stack([rng.integers(0, 6000, B), rng.integers(0, L + 1, B)]).astype(np.int32))
    s3, e3 = torch.cat([starts, starts[1:]]), torch.cat([ends, torch.full_like(ends[1:], L)])
    _cuda.defines = ()
    meds3 = select.range_median_mad(x, s3, e3, False)[0]
    shapes = {
        "clip": (xa, torch.zeros_like(n_valid), n_valid, True),
        "region statistics": (x, s3, e3, True, meds3, (True, True, False), (adc16, off, sc)),
        "gate medians": (x, starts, ends, False),
    }
    want = {name: select.range_median_mad_plain(*args) for name, args in shapes.items()}

    def same(got, plain):
        return all(
            a is b or torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(got, plain)
        )

    for defines in K4_VARIANTS:
        _cuda.defines = defines
        row = [f"K4 {' '.join(defines) or 'default'}"]
        for name, args in shapes.items():
            run = lambda: select.range_median_mad(*args)
            row.append(f"{name}: exact={same(run(), want[name])} ms={time_ms(run)!r}")
        print(" | ".join(row), "|", ptxas(defines, "wdx_range_median_mad_staged"))
    # K8 on the same reads: the gate medians and the adapter-level proxy
    proxy = (torch.zeros((1, B), dtype=torch.int32, device=dev), torch.full((1, B), 2000, dtype=torch.int32, device=dev))
    k8_shapes = {"gate medians R=2": (x, adc16, starts, ends), "proxy R=1": (x, adc16, *proxy)}
    want = {name: select.range_medians_adc_plain(*args) for name, args in k8_shapes.items()}
    for defines in K8_VARIANTS:
        _cuda.defines = defines
        row = [f"K8 {' '.join(defines) or 'default'}"]
        for name, args in k8_shapes.items():
            run = lambda: select.range_medians_adc(*args)
            row.append(f"{name}: exact={same([run()], [want[name]])} ms={time_ms(run)!r}")
        print(" | ".join(row), "|", ptxas(defines, "wdx_range_median_adc_staged"))
    # K8 probes, medians of the first 2000 samples of 1000 rows of crafted
    # counts: what staging costs (equal keys: no round, no position pass),
    # one round (two values; 256 values), two rounds (a read's samples)
    _cuda.defines = ()
    counts = {
        "equal keys": np.full((B, L), 500),
        "two values": 500 + rng.integers(0, 2, (B, L)),
        "256 values": 500 + rng.integers(0, 256, (B, L)),
        "a read's samples": adc,
    }
    row = [f"K8 probe default, medians of 2000 samples of {B} rows"]
    for name, values in counts.items():
        ar = t(values.astype(np.int16))
        xr = (ar.float() + off[:, None]) * sc[:, None]
        row.append(f"{name}: ms={time_ms(lambda: select.range_medians_adc(xr, ar, *proxy))!r}")
    print(" | ".join(row))
    # K3 on the t-scores of the adapter buffers, as chip_smoke.py makes them
    _cuda.defines = ()
    n_adapter = n_valid[0]
    w = torch.clamp(torch.round(n_adapter.float() / 110).int(), 1, 12)
    scores, _ = segmentation.windowed_t_test(xa, n_adapter, w, 12)
    is_peak, _ = peaks.peak_mask_batch(scores, torch.clamp_min(n_adapter - 2 * w, 0))
    dist = torch.clamp(torch.round(n_adapter.float() / 220).int(), 1, 6)
    want = peaks.suppress_by_distance_plain(scores, is_peak, dist, 7)
    for defines in K3_VARIANTS:
        _cuda.defines = defines
        run = lambda: peaks.suppress_by_distance(scores, is_peak, dist, 7)
        print(f"K3 {' '.join(defines) or 'default'} | exact={torch.equal(run(), want)} ms={time_ms(run)!r} |",
              ptxas(defines, "wdx_suppress_words"))
    # K2 on the same adapter buffers, by threads a block, positions a thread
    # and positions a tile (6272: the whole row)
    want = segmentation.windowed_t_test_plain(xa, n_adapter, w, 12)
    for defines in K2_VARIANTS:
        _cuda.defines = defines
        run = lambda: segmentation.windowed_t_test(xa, n_adapter, w, 12)[0]
        print(f"K2 {' '.join(defines) or 'default'} | exact={same([run()], [want])} ms={time_ms(run)!r} |",
              ptxas(defines, "wdx_ttest_kernel"))
    # K2 probes: what the launch and the zeros cost (no valid sample: 25 MB
    # of zeros written, beside torch's own fill of the same buffer), and
    # full rows by width (13: outside the unrolled instances)
    _cuda.defines = ()
    full = torch.full_like(n_adapter, A)
    buffer = torch.empty_like(xa)
    row = [f"K2 probe default, {B} rows: zero_() of a scores buffer ms={time_ms(lambda: buffer.zero_())!r}"]
    for name, n, width in (("n_valid=0", torch.zeros_like(full), 12), ("full rows w=1", full, 1), ("full rows w=6", full, 6),
                           ("full rows w=12", full, 12), ("full rows w=13 of w_max=16", full, 13)):
        wp = torch.full_like(w, width)
        row.append(f"{name}: ms={time_ms(lambda: segmentation.windowed_t_test(xa, n, wp, 16 if width > 12 else 12))!r}")
    print(" | ".join(row))
    # K5 at the step's shapes: the refine windows (800 of 10000, two a read
    # from the one signal) and the adapter extraction (6272 of 10000 with
    # lengths), and the unfused gather from a padded copy
    starts = t(rng.integers(0, L - 800, 2 * B).astype(np.int32))
    a_start = t(rng.integers(0, L, B).astype(np.int32))
    a_len = torch.minimum(n_adapter, L - a_start)
    xpad = torch.cat([x, torch.zeros((B, A), device=dev)], 1)
    k5_shapes = {
        "refine 2B x 800": (x, starts, 800),
        "adapter with lengths": (x, a_start, A, a_len),
        "adapter, padded copy": (xpad, a_start, A),
    }
    want = {name: window_gather.shift_rows_plain(*args) for name, args in k5_shapes.items()}
    for defines in K5_VARIANTS:
        _cuda.defines = defines
        row = [f"K5 {' '.join(defines) or 'default'}"]
        for name, args in k5_shapes.items():
            run = lambda: window_gather.shift_rows(*args)
            row.append(f"{name}: exact={torch.equal(run(), want[name])} ms={time_ms(run)!r}")
        print(" | ".join(row), "|", ptxas(defines, "wdx_shift_rows_kernelILb1"))
    _cuda.defines = ()
    # K4 probes, medians (and medians + MADs) of whole rows of 6271 samples:
    # what a round costs by how the digits fall (no round for equal keys,
    # one round of two bins or of 256, three rounds for a read's samples),
    # with and without the first round's copies, and how the time grows
    # with the number of ranges (latency of one block, then throughput)
    base = np.float32(80.0).view(np.int32)
    rows = {
        "equal keys": np.full((B, A), 80.0, np.float32),
        "two values": (base + rng.integers(0, 2, (B, A))).astype(np.int32).view(np.float32),
        "256 values": (base + rng.integers(0, 256, (B, A))).astype(np.int32).view(np.float32),
        "normal(80, 12)": rng.normal(80, 12, (B, A)).astype(np.float32),
    }
    whole = lambda n_rows: (torch.zeros((1, n_rows), dtype=torch.int32, device=dev),
                            torch.full((1, n_rows), A - 1, dtype=torch.int32, device=dev))
    for defines in ((), ("-DWDX_SELECT_SPREAD=0",)):
        _cuda.defines = defines
        row = [f"K4 probe {' '.join(defines) or 'default'}, medians of {B} rows"]
        st, en = whole(B)
        for name, values in rows.items():
            xr = t(values)
            row.append(f"{name}: ms={time_ms(lambda: select.range_median_mad(xr, st, en, False))!r}")
        print(" | ".join(row))
    _cuda.defines = ()
    for n_rows in (1, 132, 528, 1000, 4000):
        xr = t(rng.normal(80, 12, (n_rows, A)).astype(np.float32))
        st, en = whole(n_rows)
        print(f"K4 probe default, {n_rows} rows of normal(80, 12): "
              f"median ms={time_ms(lambda: select.range_median_mad(xr, st, en, False))!r} | "
              f"median + MAD ms={time_ms(lambda: select.range_median_mad(xr, st, en, True))!r}")
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
