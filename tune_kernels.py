#!/usr/bin/env python3
"""Tile-size sweep of kernels K1 (csrc/dtw.cu) and K6 / K9 (csrc/rolling.cu)
on one CUDA GPU.

    python3 tune_kernels.py

Each variant is the kernel library built by `_cuda.build` with other values
of the sources' tile macros (K1: WDX_DTW_THREADS references and WDX_DTW_TQ
queries a tile; K6 / K9: WDX_ROLLING_THREADS a row), all builds started
together. For each variant the script prints what ptxas reported for the
kernel (registers, spills), checks the wrapper's output bit for bit against
the plain PyTorch version, and prints the mean time of 20 launches (CUDA
events, after 2 warm-ups) at the step's shapes: B=1000 fingerprints against
the 851 WDX4 and the 2601 WDX10 support vectors; B=1000 reads of L=10000
samples. The first variant of a kernel is the committed default. The last
line names the card and its power limit.
"""

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import chip_smoke

B, L = 1000, 10000
time_ms = partial(chip_smoke.time_ms, reps=20)

K1_VARIANTS = [(), *[(f"-DWDX_DTW_THREADS={t}", f"-DWDX_DTW_TQ={q}") for t, q in ((128, 1), (128, 8), (64, 4), (256, 4))]]
K6_VARIANTS = [(), ("-DWDX_ROLLING_THREADS=256",), ("-DWDX_ROLLING_THREADS=1024",)]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("tune_kernels: no CUDA device", file=sys.stderr)
        return 1
    from bench import synth_minibatch
    from warpdemux_tpu_torch import _cuda
    from warpdemux_tpu_torch.detect import boundaries as bd
    from warpdemux_tpu_torch.models.registry import load_model_arrays
    from warpdemux_tpu_torch.ops import dtw

    dev = torch.device("cuda", 0)
    t = lambda a: torch.as_tensor(a, device=dev)
    variants = K1_VARIANTS + K6_VARIANTS[1:]
    with ThreadPoolExecutor(len(variants)) as pool:
        logs = dict(zip(variants, pool.map(lambda d: _cuda.build_log(_cuda.build(d)).read_text(), variants)))

    def ptxas(defines, kernel):
        return "; ".join(line for line in _cuda.ptxas_summary(logs[defines]) if kernel in line)

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
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
