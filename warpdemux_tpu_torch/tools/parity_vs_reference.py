"""Reference-differential parity harness.

Port of tools/parity_vs_reference.py: runs the same pod5 files through
(a) the upstream WarpDemuX command line (a checkout of it and an
interpreter of its pinned environment, given by --reference-repo /
WDX_REFERENCE_REPO and --reference-python / WDX_REFERENCE_PYTHON) and (b)
`python -m warpdemux_tpu_torch.cli demux --device ...`, then diffs the
per-read outputs of the two run directories:

  - `predicted_barcode` (the north star: equal assignments)
  - `confidence_score` (the reference rounds it to 3 decimals)
  - the per-class probability columns (4 decimals)
  - the pass / fail split and the fail reasons

with the JAX tool's report keys (`tpu_*` names the port's side).
`diff_runs` reads the gzip'd CSV shards with the standard library's csv
and gzip (the card's machine has no pandas) and returns the report the
JAX tool's pandas version returns. `--check-only` says whether the
interpreter can import the reference stack; `--diff-only REF RUN` diffs
two finished run directories.

Usage:
    python -m warpdemux_tpu_torch.tools.parity_vs_reference --pod5 reads.pod5 \\
        --reference-python /path/to/wdx-env/bin/python --reference-repo /path/to/warpdemux \\
        [--model WDX4_rna004_v1_0] [--workdir DIR] [--device cpu]

Exit codes: 0 = equal barcode assignments; 2 = disagreements (report
printed); 3 = reference environment unavailable. The port's run goes on
the CUDA GPU unless `--device cpu`, and raises without one.
"""

from __future__ import annotations

import argparse
import csv
import glob
import gzip
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np


class _Frame:
    """The rows of a run's CSV shards, as pandas.concat of their read_csv
    frames holds them: the union of the columns, a missing or empty cell
    None."""

    def __init__(self, rows: list[dict], columns: list[str]):
        self.rows, self.columns = rows, columns

    def __len__(self) -> int:
        return len(self.rows)

    def column(self, name: str) -> list:
        return [row.get(name) for row in self.rows]


def _load_csvs(run_dir: str, subdir: str) -> _Frame:
    rows, columns = [], []
    for f in sorted(glob.glob(os.path.join(run_dir, subdir, "*.csv.gz"))):
        with gzip.open(f, "rt", encoding="utf-8", newline="") as fh:
            reader = csv.reader(fh)
            header = next(reader, [])
            columns += [c for c in header if c not in columns]
            for cells in reader:
                rows.append({c: v for c, v in zip(header, cells) if v != ""})
    return _Frame(rows, columns)


def _find_run_dir(out_dir: str) -> str:
    """Both CLIs create one timestamped run dir under the output dir."""
    entries = [p for p in glob.glob(os.path.join(out_dir, "*")) if os.path.isdir(p)]
    if len(entries) == 1:
        return entries[0]
    if not entries and os.path.isdir(os.path.join(out_dir, "predictions")):
        return out_dir  # --no-create_subdir style layout
    raise FileNotFoundError(f"expected exactly one run dir under {out_dir}, found {entries}")


def _id_column(frame: _Frame) -> str:
    return "#read_id" if "#read_id" in frame.columns else "read_id"


def _floats(values) -> np.ndarray:
    return np.array([np.nan if v is None else float(v) for v in values], np.float64)


def _ints(values) -> np.ndarray:
    return np.array([int(float(v)) for v in values], np.int64)


def _rows_by_id(frame: _Frame, id_col: str, ids: list[str]) -> list[dict]:
    """The rows of each id in `ids` in turn (every row of a repeated id),
    as pandas' set_index(id_col).loc[ids] gives them."""
    by_id: dict[str, list[dict]] = {}
    for row in frame.rows:
        by_id.setdefault(row.get(id_col), []).append(row)
    return [row for i in ids for row in by_id[i]]


def diff_runs(ref_run_dir: str, tpu_run_dir: str) -> dict:
    """Diff two completed demux run dirs (reference layout: predictions/
    + failed_reads/ csv.gz shards). Returns the parity report dict."""
    ref_pred = _load_csvs(ref_run_dir, "predictions")
    tpu_pred = _load_csvs(tpu_run_dir, "predictions")
    ref_fail = _load_csvs(ref_run_dir, "failed_reads")
    tpu_fail = _load_csvs(tpu_run_dir, "failed_reads")

    rid, tid = _id_column(ref_pred), _id_column(tpu_pred)
    report: dict = {
        "ref_predicted": len(ref_pred),
        "tpu_predicted": len(tpu_pred),
        "ref_failed": len(ref_fail),
        "tpu_failed": len(tpu_fail),
    }

    ref_ids = set(ref_pred.column(rid)) if len(ref_pred) else set()
    tpu_ids = set(tpu_pred.column(tid)) if len(tpu_pred) else set()
    report["pass_only_in_ref"] = sorted(ref_ids - tpu_ids)
    report["pass_only_in_tpu"] = sorted(tpu_ids - ref_ids)

    both = sorted(ref_ids & tpu_ids)
    if both:
        r = _rows_by_id(ref_pred, rid, both)
        t = _rows_by_id(tpu_pred, tid, both)
        r_bc = _ints(row["predicted_barcode"] for row in r)
        t_bc = _ints(row["predicted_barcode"] for row in t)
        r_conf = _floats(row.get("confidence_score") for row in r)
        t_conf = _floats(row.get("confidence_score") for row in t)
        bc_match = r_bc == t_bc
        report["n_compared"] = len(both)
        report["barcode_agreement"] = float(bc_match.mean())
        report["barcode_disagreements"] = [
            {"read_id": row[rid], "ref": int(rv), "tpu": int(tv), "ref_conf": float(rc), "tpu_conf": float(tc)}
            for row, rv, tv, rc, tc, same in zip(r, r_bc, t_bc, r_conf, t_conf, bc_match)
            if not same
        ]
        dconf = np.abs(r_conf - t_conf)
        report["conf_max_abs_delta"] = float(dconf.max())
        report["conf_mean_abs_delta"] = float(dconf.mean())
        pcols = [c for c in ref_pred.columns if c != rid and c.startswith("p") and c[1:].lstrip("-").isdigit()]
        shared_pcols = [c for c in pcols if c in tpu_pred.columns]
        if shared_pcols:
            rp = np.stack([_floats(row.get(c) for row in r) for c in shared_pcols], 1)
            tp = np.stack([_floats(row.get(c) for row in t) for c in shared_pcols], 1)
            report["prob_max_abs_delta"] = float(np.abs(rp - tp).max())
    else:
        report["n_compared"] = 0

    # fail-reason cross-tab over reads failed in both
    if len(ref_fail) and len(tpu_fail):
        maps = []
        for frame in (ref_fail, tpu_fail):
            fid = _id_column(frame)
            # no fail_reason column: pandas' frame.get gives "", which zips to nothing
            reasons = ["nan" if v is None else v for v in frame.column("fail_reason")] \
                if "fail_reason" in frame.columns else []
            maps.append(dict(zip(frame.column(fid), reasons)))
        rmap, tmap = maps
        cross: dict = {}
        for i in set(rmap) & set(tmap):
            key = f"{rmap[i]} -> {tmap[i]}"
            cross[key] = cross.get(key, 0) + 1
        report["fail_reason_crosstab"] = dict(sorted(cross.items(), key=lambda kv: -kv[1]))
    return report


def check_reference_env(python: str, repo: str | None) -> tuple[bool, str]:
    """Can `python` import the full reference stack from `repo`?"""
    if not repo:
        return False, "no reference checkout given (--reference-repo or WDX_REFERENCE_REPO)"
    probe = (
        "import warpdemux, dtaidistance, pod5, sklearn, torch;"
        "from warpdemux.models.utils import available_models;"
        "print(','.join(available_models()))"
    )
    env = dict(os.environ, PYTHONPATH=repo)
    try:
        out = subprocess.run([python, "-c", probe], env=env, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        return False, str(e)
    if out.returncode != 0:
        return False, out.stderr.strip().splitlines()[-1] if out.stderr else "?"
    return True, out.stdout.strip()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pod5", nargs="+", help="input pod5 file(s)")
    ap.add_argument("--reference-python", default=os.environ.get("WDX_REFERENCE_PYTHON", sys.executable),
                    help="python interpreter of the reference (WDX conda) env")
    ap.add_argument("--reference-repo", default=os.environ.get("WDX_REFERENCE_REPO"),
                    help="checkout of the upstream WarpDemuX (default: WDX_REFERENCE_REPO)")
    ap.add_argument("--model", default="WDX4_rna004_v1_0")
    ap.add_argument("--ncores", type=int, default=4)
    ap.add_argument("--workdir", default=None, help="where both runs write (default: a new temporary directory)")
    ap.add_argument("--check-only", action="store_true", help="only verify the reference environment is runnable")
    ap.add_argument("--diff-only", nargs=2, metavar=("REF_RUN_DIR", "TPU_RUN_DIR"),
                    help="skip both runs; diff two existing run dirs")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="torch device of the port's run (default: the CUDA GPU)")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)

    if args.diff_only:
        report = diff_runs(*args.diff_only)
        print(json.dumps(report, indent=2))
        return 0 if report.get("barcode_agreement") == 1.0 else 2

    ok, msg = check_reference_env(args.reference_python, args.reference_repo)
    if args.check_only:
        print(f"reference env {'OK' if ok else 'UNAVAILABLE'}: {msg}")
        return 0 if ok else 3
    if not ok:
        print(f"reference environment unavailable ({msg}); supply a working env via --reference-python "
              f"(pins: {args.reference_repo or '<reference checkout>'}/environment.yml)", file=sys.stderr)
        return 3
    if not args.pod5:
        ap.error("--pod5 is required unless --check-only/--diff-only")
    from warpdemux_tpu_torch import _cuda

    device = _cuda.resolve_device(args.device)

    workdir = args.workdir or tempfile.mkdtemp(prefix="wdx_parity_")
    ref_out = os.path.join(workdir, "ref")
    tpu_out = os.path.join(workdir, "tpu")
    os.makedirs(ref_out, exist_ok=True)
    os.makedirs(tpu_out, exist_ok=True)

    env = dict(os.environ, PYTHONPATH=args.reference_repo)
    subprocess.run(
        [args.reference_python, "-m", "warpdemux.main", "demux", "-i", *args.pod5, "-o", ref_out,
         "-m", args.model, "-j", str(args.ncores)],
        env=env, check=True,
    )
    repo_root = Path(__file__).resolve().parents[2]  # where warpdemux_tpu_torch imports from
    subprocess.run(
        [sys.executable, "-m", "warpdemux_tpu_torch.cli", "demux", "-i", *args.pod5, "-o", tpu_out,
         "-m", args.model, "--device", device.type],
        cwd=repo_root, check=True,
    )

    report = diff_runs(_find_run_dir(ref_out), _find_run_dir(tpu_out))
    print(json.dumps(report, indent=2))
    agree = report.get("barcode_agreement")
    print(f"# barcode agreement: {agree} over {report.get('n_compared')} reads; "
          f"conf max |delta| {report.get('conf_max_abs_delta')}", file=sys.stderr)
    return 0 if agree == 1.0 else 2


if __name__ == "__main__":
    sys.exit(main())
