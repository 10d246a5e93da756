"""Sharded output writers, without pandas.

Port of warpdemux_tpu/io/writers.py. Output layout:
  <run>/predictions/barcode_predictions_<bidx>.csv.gz   (#read_id first col)
  <run>/failed_reads/failed_reads_<bidx>.csv.gz
  <run>/boundaries/detected_boundaries_<bidx>.csv.gz
  <run>/fingerprints/barcode_fpts_<bidx>.npz            (num_reads, read_ids,
                                                         signals[, dwell_times])

A table is a `Table`: named numpy columns of one length, in order. Its CSV
text is what pandas' `DataFrame.to_csv(index=False)` writes for the same
columns: floats as numpy's shortest repr of their own dtype (float32
0.27 -> "0.27"), NaN as an empty cell, bools as True / False, strings
quoted only where they hold a comma, a quote or a line break, lines ended
by "\\n". The card's machine has no pandas, and the run loop needs none.
"""

from __future__ import annotations

import csv
import gzip
from pathlib import Path

import numpy as np

# Boundary / failed-read summary columns (the reference's ADAPTed
# save_detected_boundaries contract)
BOUNDARY_COLUMNS = [
    "read_id",
    "signal_len",
    "preloaded",
    "adapter_start",
    "adapter_end",
    "adapter_len",
    "adapter_mean",
    "adapter_std",
    "adapter_med",
    "adapter_mad",
    "polya_start",
    "polya_end",
    "polya_len",
    "polya_mean",
    "polya_std",
    "polya_med",
    "polya_mad",
    "polya_candidates",
    "rna_preloaded_start",
    "rna_preloaded_len",
    "rna_preloaded_mean",
    "rna_preloaded_std",
    "rna_preloaded_med",
    "rna_preloaded_mad",
    "adapter_dt_med",
    "adapter_dt_mad",
    "adapter_event_mean",
    "adapter_event_std",
    "adapter_event_med",
    "adapter_event_mad",
]


def _column(values) -> np.ndarray:
    """A 1-D column: numpy arrays keep their dtype; lists (of strings)
    become object arrays."""
    if isinstance(values, np.ndarray):
        return values.reshape(-1)
    out = np.empty(len(values), object)
    out[:] = list(values)
    return out


def _cells(a: np.ndarray) -> list:
    """One column's cells as pandas' CSV writer hands them to csv.writer."""
    if a.dtype.kind == "f":
        cells = a.astype(str).astype(object)
        cells[np.isnan(a)] = ""
        return cells.tolist()
    if a.dtype == object:
        return ["" if v is None or (isinstance(v, float) and v != v) else v for v in a]
    return a.tolist()


class Table:
    """Named equal-length numpy columns, in insertion order. Assigning an
    existing name replaces that column in place; a new name appends."""

    def __init__(self, columns: dict | None = None):
        self.columns: dict[str, np.ndarray] = {}
        for name, values in (columns or {}).items():
            self[name] = values

    def __len__(self) -> int:
        return len(next(iter(self.columns.values()))) if self.columns else 0

    def __contains__(self, name) -> bool:
        return name in self.columns

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]

    def __setitem__(self, name: str, values) -> None:
        col = _column(values)
        if self.columns and len(col) != len(self):
            raise ValueError(f"column {name!r} has {len(col)} rows, the table {len(self)}")
        self.columns[name] = col

    @property
    def names(self) -> list[str]:
        return list(self.columns)

    def rows(self, index) -> "Table":
        """The rows selected by a boolean mask, a slice or indices."""
        return Table({k: v[index] for k, v in self.columns.items()})

    def drop(self, *names: str) -> "Table":
        return Table({k: v for k, v in self.columns.items() if k not in names})

    @staticmethod
    def concat(tables: list["Table"]) -> "Table":
        """Rows of `tables` one after another (the first table's columns)."""
        names = tables[0].names
        return Table({k: np.concatenate([t[k] for t in tables]) for k in names})

    def csv_rows(self):
        """The header and the rows, as lists of cells for csv.writer."""
        yield self.names
        yield from zip(*(_cells(v) for v in self.columns.values()))

    def to_csv_gz(self, path: str | Path) -> Path:
        with gzip.open(path, "wt", encoding="utf-8", newline="") as fh:
            csv.writer(fh, lineterminator="\n", quoting=csv.QUOTE_MINIMAL).writerows(
                self.csv_rows()
            )
        return Path(path)


def save_predictions(table: Table, out_dir: str | Path, bidx: int, tag: str = "") -> Path:
    return table.to_csv_gz(Path(out_dir) / f"barcode_predictions_{tag}{bidx}.csv.gz")


def save_boundaries(
    rows: Table,
    out_dir: str | Path,
    bidx: int,
    failed: bool = False,
    tag: str = "",
) -> Path:
    name = "failed_reads" if failed else "detected_boundaries"
    return rows.to_csv_gz(Path(out_dir) / f"{name}_{tag}{bidx}.csv.gz")


def save_fingerprints(
    read_ids: np.ndarray,
    fpts: np.ndarray,
    out_dir: str | Path,
    bidx: int,
    dwell_times: np.ndarray | None = None,
    tag: str = "",
) -> Path:
    path = Path(out_dir) / f"barcode_fpts_{tag}{bidx}.npz"
    arrays = dict(
        num_reads=len(read_ids),
        read_ids=np.asarray(read_ids),
        signals=np.asarray(fpts),
    )
    if dwell_times is not None:
        arrays["dwell_times"] = np.asarray(dwell_times)
    np.savez(path, **arrays)
    return path
