"""Search float32 inputs for a log whose multiply-adds round differently.

`ops/numerics.xla_log_plain` evaluates XLA:CPU's float32 log with eleven
fused multiply-adds, each rounded once (`numerics.fma`). Computed as a
float64 sum rounded to float32, a multiply-add rounds twice, and differs
where that sum lands on a float32 half-way point. This script evaluates the
log both ways on every positive normal float32 (or on the binades given)
and prints the inputs whose results differ; subnormals, zero, infinities and
NaN take XLA's special values either way. The polynomial in the mantissa is
evaluated once for all 2**23 mantissas, then each binade's exponent terms.

    python -m warpdemux_tpu_torch.tools.xla_log_ties            # all 254 binades, ~150 s on 4 threads
    python -m warpdemux_tpu_torch.tools.xla_log_ties 126 127    # the binades [0.5, 1) and [1, 2)

Exit status 0 when no input differs, 1 otherwise.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from warpdemux_tpu_torch.ops import numerics

BINADES = range(1, 255)  # the biased exponents of the positive normal float32


def _rounded_twice(a, b, c):
    """float32 a*b + c as a float64 sum rounded to float32."""
    return (a.double() * b + c).to(torch.float32)


def _rounded_once(a, b, c):
    full = lambda v: v if torch.is_tensor(v) else torch.full_like(a, v)
    return numerics.fma(a, full(b), full(c))


def search(binades=BINADES, log=print) -> list[int]:
    """The bit patterns of the positive float32 in `binades` (biased
    exponents) whose log differs between the two roundings."""
    mantissa = torch.arange(1 << 23, dtype=torch.int32)
    m = (mantissa | 0x3F000000).view(torch.float32)  # [0.5, 1), as xla_log_plain reduces
    small = m < numerics._SQRT_HALF
    m = torch.where(small, (m - 1.0) + m, m - 1.0)
    x2 = m * m
    x3 = m * x2
    poly = {}
    for name, fma in (("twice", _rounded_twice), ("once", _rounded_once)):
        p = numerics._LOG_P
        A = fma(fma(m, p[0], p[1]), m, p[2])
        B = fma(fma(m, p[3], p[4]), m, p[5])
        C = fma(fma(m, p[6], p[7]), m, p[8])
        poly[name] = (fma(fma(A, x3, B), x3, C), fma(x2, -0.5, m), fma)
    found = []
    for E in binades:
        e = torch.full_like(m, E - 126.0) - small.to(torch.float32)
        r = {}
        for name, (y, u, fma) in poly.items():
            t = fma(y, x3, e * numerics._LOG_Q1)
            r[name] = fma(e, numerics._LOG_Q2, u + t)
        differ = r["twice"].view(torch.int32) != r["once"].view(torch.int32)
        if bool(differ.any()):
            hits = ((E << 23) | mantissa[differ]).tolist()
            found += hits
            log(f"binade {E}: {len(hits)} inputs differ, first {[hex(h) for h in hits[:8]]}")
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("binades", nargs="*", type=int, help="biased exponents (1-254); all by default")
    ap.add_argument("--threads", type=int, default=4, help="torch CPU threads")
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    t0 = time.perf_counter()
    binades = args.binades or BINADES
    found = search(binades)
    print(f"{len(found)} positive float32 inputs of {len(binades)} binades whose log differs between "
          f"once- and twice-rounded multiply-adds ({time.perf_counter() - t0:.1f} s)")
    return 1 if found else 0


if __name__ == "__main__":
    sys.exit(main())
