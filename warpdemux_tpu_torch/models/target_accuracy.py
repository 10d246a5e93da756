"""Target-performance filtering: per-barcode calibrated confidence
thresholds at chosen precision targets.

Port of warpdemux_tpu/models/target_accuracy.py without pandas. The
calibration tables (warpdemux_tpu/models/target_accuracy_thresholds/*.csv,
read by path: one row per barcode, one column per precision target 95.0
.. 99.9) give, for each barcode, the confidence below which a call is
demoted to -1 (unclassified) to reach that precision. The models' own
`thresholds` are the 99% operating point, applied at predict time
(ops/svm.process_probs); this module filters a predictions table for
another target.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass

import numpy as np

from warpdemux_tpu_torch.config.utils import DATA_ROOT

ASSET_DIR = DATA_ROOT / "models" / "target_accuracy_thresholds"


@dataclass(frozen=True)
class Calibration:
    """One calibration table: `values[i, j]` is the threshold of barcode
    `barcodes[i]` at precision target `targets[j]` (in percent)."""

    name: str
    barcodes: tuple[int, ...]
    targets: tuple[float, ...]
    values: np.ndarray  # (len(barcodes), len(targets)) float64


def available_calibrations() -> list[str]:
    return sorted(p.stem for p in ASSET_DIR.glob("*.csv"))


def load_calibration(name: str) -> Calibration:
    """The named calibration table; its columns `95_0`, `99_9`, ... become
    the targets 95.0, 99.9, ..."""
    path = ASSET_DIR / f"{name}.csv"
    if not path.exists():
        raise FileNotFoundError(
            f"calibration {name!r} not found; available: {available_calibrations()}"
        )
    with open(path, newline="") as f:
        header, *rows = list(csv.reader(f))
    if header[0] != "true_barcode":
        raise ValueError(f"{path}: the first column must be true_barcode, got {header[0]!r}")
    return Calibration(
        name=name,
        barcodes=tuple(int(r[0]) for r in rows),
        targets=tuple(float(c.replace("_", ".")) for c in header[1:]),
        values=np.array([[float(v) for v in r[1:]] for r in rows], np.float64),
    )


def calibration_for_model(model_name: str) -> Calibration:
    """The calibration of a model, by prefix on the registry's naming
    scheme (WDX4_rna004_v1_0 -> WDX4_rna004__3_4_5_7@v0.4.4)."""
    base = model_name.rsplit("_v", 1)[0]
    for name in available_calibrations():
        if name.startswith(base):
            return load_calibration(name)
    raise FileNotFoundError(
        f"no calibration table for model {model_name!r}; available: {available_calibrations()}"
    )


def thresholds_at(calibration: Calibration, target: float) -> dict[int, float]:
    """Per-barcode thresholds for a precision target (an exact column)."""
    if target not in calibration.targets:
        raise KeyError(
            f"target {target} not calibrated; available: {list(calibration.targets)}"
        )
    j = calibration.targets.index(target)
    return {bc: float(calibration.values[i, j]) for i, bc in enumerate(calibration.barcodes)}


def apply_target_performance(pred, conf, thresholds: dict[int, float]) -> np.ndarray:
    """A copy of `pred` with the calls whose confidence is below their
    barcode's threshold demoted to -1; barcodes without a threshold are
    kept."""
    pred = np.asarray(pred).copy()
    conf = np.asarray(conf)
    for bc, thr in thresholds.items():
        pred[(pred == bc) & (conf < thr)] = -1
    return pred


def filter_predictions_table(table, model_name: str, target: float):
    """A copy of a predictions `io/writers.Table` (the demux / predict runs'
    CSV rows) with `predicted_barcode` filtered at `target`."""
    from warpdemux_tpu_torch.io.writers import Table

    thr = thresholds_at(calibration_for_model(model_name), target)
    out = Table(dict(table.columns))
    out["predicted_barcode"] = apply_target_performance(
        table["predicted_barcode"], table["confidence_score"], thr
    )
    return out
