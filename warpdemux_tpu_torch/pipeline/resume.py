"""Resume support: scan a previous run's outputs into an exclude set and the
next shard indices.

Port of warpdemux_tpu/pipeline/resume.py, reading the CSV shards with
`gzip` and `csv` instead of pandas.
"""

from __future__ import annotations

import csv
import gzip
import re
from pathlib import Path

import numpy as np


def _max_bidx(files: list[Path], pattern: str) -> int:
    mx = -1
    for f in files:
        m = re.match(pattern, f.name)
        if m:
            mx = max(mx, int(m.group(1)))
    return mx


def _csv_column(path: Path, names: tuple[str, ...]) -> list[str]:
    """The cells of the first of `names` that the CSV's header has."""
    with gzip.open(path, "rt", encoding="utf-8", newline="") as fh:
        reader = csv.reader(fh)
        header = next(reader, [])
        col = next(header.index(n) for n in names if n in header)
        return [row[col] for row in reader]


def scan_processed_reads(run_dir: str, result_type: str = "predictions"):
    """Returns (processed_ids: set, next_bidx_pass, next_bidx_fail,
    next_bidx_predict)."""
    run = Path(run_dir)
    processed: set[str] = set()

    pred_files = sorted((run / "predictions").glob("barcode_predictions_*.csv.gz"))
    fail_files = sorted((run / "failed_reads").glob("failed_reads_*.csv.gz"))
    fpt_files = sorted((run / "fingerprints").glob("barcode_fpts_*.npz"))
    bound_files = sorted((run / "boundaries").glob("detected_boundaries_*.csv.gz"))

    if result_type == "predictions":
        for f in pred_files:
            processed.update(_csv_column(f, ("#read_id", "read_id")))
    else:
        for f in fpt_files:
            with np.load(f, allow_pickle=True) as z:
                processed.update(str(r) for r in z["read_ids"])
    for f in fail_files:
        processed.update(_csv_column(f, ("read_id",)))

    bidx_pass = (
        max(
            _max_bidx(bound_files, r"detected_boundaries_(?:h\d+_)?(\d+)\.csv\.gz"),
            _max_bidx(fpt_files, r"barcode_fpts_(?:h\d+_)?(\d+)\.npz"),
        )
        + 1
    )
    bidx_fail = _max_bidx(fail_files, r"failed_reads_(?:h\d+_)?(\d+)\.csv\.gz") + 1
    bidx_predict = _max_bidx(pred_files, r"barcode_predictions_(?:h\d+_)?(\d+)\.csv\.gz") + 1
    return processed, bidx_pass, bidx_fail, bidx_predict
