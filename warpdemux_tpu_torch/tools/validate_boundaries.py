"""Boundary-detection validation on pod5 reads.

Port of tools/validate_boundaries.py: the detect methods of WDX4's detect
config (`llr`, `cnn` and `start_peak` without the LLR fallback, and the
production `cnn+fb`, the CNN with the per-read LLR fallback) over the
reads of the pod5 files, then per-method pass rates, fail reasons by code,
the `llr` failures against read length, the no-poly(A) reads with a
relaxed poly(A)-like window, cnn vs llr boundary deltas and, through the
fingerprint, the DTW and the SVM (`predict_proba`, `process_probs`), the
barcode-call agreement of `cnn` and `cnn+fb` with `llr` and each method's
prediction distribution: the JAX tool's tables, line for line.

`validate(batches, spc, model, cnn)` computes the tables from
`(sigs, in_lens, full_lens, read_ids)` minibatches; `main` reads them from
the pod5 files (io/pod5.yield_signal_batches, 200 reads a minibatch at
the 10,000-sample preload; it needs pyarrow, which the card's machine
lacks, so `main` is a CPU host's, and the card takes `validate`).

Usage:
    python -m warpdemux_tpu_torch.tools.validate_boundaries [--fixtures GLOB] [--limit N]
        [--cnn-model NAME] [--device cpu]

--fixtures defaults to small_pod5_*.pod5 in the directory WDX_FIXTURE_DIR
names. Runs on the CUDA GPU unless `--device` names another, and raises
without one.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from dataclasses import replace
from typing import NamedTuple

import numpy as np
import torch

from warpdemux_tpu_torch import _cuda

MODEL = "WDX4_rna004_v1_0"
L = 10000
FIXTURE_GLOB = "small_pod5_*.pod5"


def default_fixtures() -> str:
    """The glob of the fixtures: small_pod5_*.pod5 in WDX_FIXTURE_DIR."""
    return os.path.join(os.environ.get("WDX_FIXTURE_DIR", ""), FIXTURE_GLOB)


def load_batches(files, limit=None, batch=200):
    """(sigs, in_lens, full_lens, read_ids) minibatches of `files`, file by
    file, until `limit` reads."""
    from warpdemux_tpu_torch.io.pod5 import yield_signal_batches

    out = []
    total = 0
    for f in files:
        for sigs, in_lens, full_lens, read_ids in yield_signal_batches(
            [str(f)], None, None, batch_size=batch, preload_size=L
        ):
            out.append((sigs, in_lens, full_lens, read_ids))
            total += len(read_ids)
            if limit and total >= limit:
                return out
    return out


class Validation(NamedTuple):
    """Per method: success, fail, ps (poly(A) start), pe, ae (adapter end)
    over every read; preds: the barcode call of the fingerprinted methods
    (-2 where a read was not fingerprinted); the tables as text lines."""

    res: dict[str, dict[str, np.ndarray]]
    preds: dict[str, np.ndarray]
    lines: list[str]


def configs(spc, cnn) -> dict:
    """method -> (DetectConfig, CNN or None), as the JAX tool builds them."""
    dcfg = spc.detect
    return {
        "llr": (replace(dcfg, method="llr", fallback_to_llr=False), None),
        "cnn": (replace(dcfg, method="cnn", fallback_to_llr=False), cnn),
        "start_peak": (replace(dcfg, method="start_peak", fallback_to_llr=False), None),
        # the production mRNA path: cnn primary + per-read LLR fallback
        "cnn+fb": (replace(dcfg, method="cnn", fallback_to_llr=True), cnn),
    }


@torch.inference_mode()
def validate(batches, spc, model, cnn) -> Validation:
    """The tables over `batches`, on the device of `model` (a DTWSVMModel)
    and `cnn` (the BoundaryCNN of the `cnn` methods)."""
    from warpdemux_tpu_torch.detect.boundaries import detect_boundaries_batch, detect_boundaries_with_fallback
    from warpdemux_tpu_torch.ops import svm as svm_ops
    from warpdemux_tpu_torch.ops.dtw import dtw_distance_matrix
    from warpdemux_tpu_torch.ops.fingerprint import fingerprints_from_boundaries

    device = model.X_sv.device
    cfgs = configs(spc, cnn)
    full_lens_all = np.concatenate([b[2] for b in batches])
    res = {k: {"success": [], "fail": [], "ps": [], "pe": [], "ae": []} for k in cfgs}
    preds = {}
    host = lambda t: t.cpu().numpy()  # noqa: E731
    for name, (cfg, net) in cfgs.items():
        pred_rows = []
        for sigs, in_lens, _full_lens, _read_ids in batches:
            detect_fn = detect_boundaries_with_fallback if cfg.fallback_to_llr else detect_boundaries_batch
            x = torch.as_tensor(np.asarray(sigs, np.float32), device=device)
            n = torch.as_tensor(np.asarray(in_lens, np.int32), device=device)
            det = detect_fn(x, n, cfg, net)
            res[name]["success"].append(host(det.success))
            res[name]["fail"].append(host(det.fail_code))
            res[name]["ps"].append(host(det.polya_start))
            res[name]["pe"].append(host(det.polya_end))
            res[name]["ae"].append(host(det.adapter_end))
            if name in ("llr", "cnn", "cnn+fb"):
                fpt = fingerprints_from_boundaries(x, n, det.adapter_start, det.adapter_end, spc.fingerprint)
                ok = det.success & fpt.ok
                f = torch.where(ok[:, None], fpt.fpt, torch.zeros_like(fpt.fpt)).to(torch.float32)
                D = dtw_distance_matrix(f, model.X_sv, model.window, model.penalty)
                probs = svm_ops.predict_proba(svm_ops.pdist_kernel(D, model.gamma, model.pwr_dist), model.params)
                p, _c = svm_ops.process_probs(probs, model.label_map, model.thresholds)
                p = host(p).copy()
                p[~host(ok)] = -2
                pred_rows.append(p)
        if pred_rows:
            preds[name] = np.concatenate(pred_rows)
        for k in ("success", "fail", "ps", "pe", "ae"):
            res[name][k] = np.concatenate(res[name][k])
    sigs_all = np.concatenate([b[0] for b in batches])
    lens_all = np.concatenate([b[1] for b in batches])
    return Validation(res, preds, tables(list(cfgs), res, preds, full_lens_all, sigs_all, lens_all))


def relaxed_polya_count(sigs_all, lens_all, rows) -> int:
    """Of `rows`, the reads with any window of 200 samples above 1.15x the
    median level of their first 2,000 samples at a variance below 60 pA^2
    (host numpy, as the JAX tool computes it)."""
    relaxed = 0
    for i in rows:
        n = int(lens_all[i])
        x = sigs_all[i, :n]
        if n < 600:
            continue
        w = 200
        c = np.cumsum(np.insert(x.astype(np.float64), 0, 0))
        c2 = np.cumsum(np.insert((x.astype(np.float64)) ** 2, 0, 0))
        mean = (c[w:] - c[:-w]) / w
        var = np.maximum((c2[w:] - c2[:-w]) / w - mean**2, 0)
        med = np.median(x[: min(2000, n)])
        # relaxed contract: 1.15x level, 60 pA^2 variance
        if np.any((mean > 1.15 * med) & (var < 60.0)):
            relaxed += 1
    return relaxed


def tables(methods, res, preds, full_lens_all, sigs_all, lens_all) -> list[str]:
    """The JAX tool's printed tables, as lines (blank lines included)."""
    from warpdemux_tpu_torch.detect.containers import FAIL_REASONS

    out = ["", "| method | pass rate | notes |", "|---|---|---|"]
    for name in methods:
        s = res[name]["success"]
        out.append(f"| {name} | {s.mean():.3f} ({s.sum()}/{len(s)}) | |")

    out += ["", "| fail reason | " + " | ".join(methods) + " |", "|---|" + "---|" * len(methods)]
    seen_codes = sorted(set(int(c) for name in methods for c in np.unique(res[name]["fail"])))
    for code in seen_codes:
        row = [str(int((res[name]["fail"] == code).sum())) for name in methods]
        label = FAIL_REASONS[code] if code else "(pass)"
        out.append(f"| {code}: {label} | " + " | ".join(row) + " |")

    fail_llr = res["llr"]["fail"]
    s_llr = res["llr"]["success"]
    out += ["", "# llr fail diagnostics vs read length",
            "| group | n | median full_len | median preload trunc? | note |", "|---|---|---|---|---|"]
    for label, m in [
        ("pass", s_llr),
        ("no polyA (2)", fail_llr == 2),
        ("mvs failed (5)", fail_llr == 5),
        ("adapter too short (3)", fail_llr == 3),
        ("adapter too long (4)", fail_llr == 4),
    ]:
        if m.sum() == 0:
            continue
        fl = full_lens_all[m]
        out.append(f"| {label} | {m.sum()} | {np.median(fl):.0f} | {(fl <= L).mean():.2f} ended within preload | |")

    no_pa = fail_llr == 2
    if no_pa.sum():
        relaxed = relaxed_polya_count(sigs_all, lens_all, np.where(no_pa)[0])
        out += ["", f"# no-polyA reads with a relaxed-contract polyA-like window: "
                    f"{relaxed}/{no_pa.sum()} (rest show no elevated+flat region at "
                    f"all -> genuinely unusable for adapter demux)"]

    both = res["llr"]["success"] & res["cnn"]["success"]
    d_ps = np.abs(res["cnn"]["ps"][both] - res["llr"]["ps"][both])
    d_ae = np.abs(res["cnn"]["ae"][both] - res["llr"]["ae"][both])
    out += ["", f"# cnn vs llr, both-pass reads: {both.sum()}"]
    for tol in (10, 50, 200):
        out.append(f"| polya_start within {tol} samples | {(d_ps <= tol).mean():.3f} |")
    out.append(f"| median |polya_start delta| | {np.median(d_ps):.0f} samples |")
    out.append(f"| median |adapter_end delta| | {np.median(d_ae):.0f} samples |")

    for other in ("cnn", "cnn+fb"):
        pl, pc = preds["llr"], preds[other]
        both_ok = (pl >= -1) & (pc >= -1)
        agree = (pl[both_ok] == pc[both_ok]).mean()
        out += ["", f"# barcode-call agreement ({other} vs llr, both fingerprinted):",
                f"| agreement | {agree:.4f} ({both_ok.sum()} reads) |"]
        hard = ((pl[both_ok] != pc[both_ok]) & (pl[both_ok] >= 0) & (pc[both_ok] >= 0)).sum()
        out.append(f"| hard disagreements (different real barcodes, not -1) | {hard} |")
    for name in ("llr", "cnn", "cnn+fb"):
        p = preds[name]
        vals, counts = np.unique(p[p >= -1], return_counts=True)
        out.append(f"| {name} pred distribution | {dict(zip(vals.tolist(), counts.tolist()))} |")
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--fixtures", default=None,
                   help="glob of the pod5 files (default: small_pod5_*.pod5 in WDX_FIXTURE_DIR)")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--cnn-model", default=None, help="override the config's CNN weights (detect/cnn_files/<name>)")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA GPU)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.models.registry import load_cnn, load_model

    device = _cuda.resolve_device(args.device)
    spc = get_model_spc_config(MODEL)
    model = load_model(MODEL, device)
    cnn = load_cnn(args.cnn_model or spc.cnn_model_name, device)
    files = sorted(glob.glob(args.fixtures or default_fixtures()))
    batches = load_batches(files, args.limit)
    n_total = sum(len(b[3]) for b in batches)
    print(f"# {n_total} real reads from {len(files)} pod5 files")
    if not batches:
        print(f"no reads: no pod5 file matches {args.fixtures or default_fixtures()!r}", file=sys.stderr)
        return 1
    print("\n".join(validate(batches, spc, model, cnn).lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
