"""The port's target-performance filtering (warpdemux_tpu_torch/models/
target_accuracy.py, pandas-free): the twin of tests/test_target_accuracy.py,
and the port's tables against the JAX package's."""

import numpy as np
import pytest

from warpdemux_tpu.models import target_accuracy as jax_ta
from warpdemux_tpu_torch.io.writers import Table
from warpdemux_tpu_torch.models import target_accuracy as ta


def test_calibration_loads_and_matches_reference_values():
    cal = ta.load_calibration("WDX4_rna004__3_4_5_7@v0.4.4")
    assert list(cal.barcodes) == [3, 4, 5, 7]
    assert 99.0 in cal.targets and 99.9 in cal.targets
    assert ta.thresholds_at(cal, 99.0)[3] == 0.17
    assert ta.thresholds_at(cal, 99.9)[7] == 0.99


def test_calibration_for_model_prefix_match():
    cal = ta.calibration_for_model("WDX4_rna004_v1_0")
    assert list(cal.barcodes) == [3, 4, 5, 7]
    with pytest.raises(FileNotFoundError):
        ta.calibration_for_model("WDX99_nope_v1_0")


def test_apply_target_performance():
    pred = np.array([3, 4, 5, 7, 3, -1])
    conf = np.array([0.5, 0.1, 0.9, 0.46, 0.1, 0.99])
    thr = ta.thresholds_at(
        ta.load_calibration("WDX4_rna004__3_4_5_7@v0.4.4"), 99.0
    )
    out = ta.apply_target_performance(pred, conf, thr)
    # 3@0.5 >= 0.17 keep; 4@0.1 < 0.28 -> -1; 5@0.9 keep;
    # 7@0.46 < 0.47 -> -1; 3@0.1 < 0.17 -> -1; -1 untouched
    np.testing.assert_array_equal(out, [3, -1, 5, -1, -1, -1])
    # original untouched
    assert pred[1] == 4


def test_filter_predictions_table():
    table = Table(
        {
            "#read_id": ["a", "b"],
            "predicted_barcode": np.array([7, 7]),
            "confidence_score": np.array([0.99, 0.5]),
        }
    )
    out = ta.filter_predictions_table(table, "WDX4_rna004_v1_0", 99.9)
    assert list(out["predicted_barcode"]) == [7, -1]
    assert list(table["predicted_barcode"]) == [7, 7]  # the input untouched
    assert out.names == table.names


def test_unknown_target_raises():
    cal = ta.load_calibration("WDX4_rna004__3_4_5_7@v0.4.4")
    with pytest.raises(KeyError):
        ta.thresholds_at(cal, 42.0)


@pytest.mark.parametrize("name", jax_ta.available_calibrations())
def test_every_calibration_equals_the_jax_packages(name):
    assert ta.available_calibrations() == jax_ta.available_calibrations()
    cal, want = ta.load_calibration(name), jax_ta.load_calibration(name)
    assert list(cal.barcodes) == list(want.index)
    assert list(cal.targets) == list(want.columns)
    np.testing.assert_array_equal(cal.values, want.to_numpy(np.float64))
    for target in cal.targets:
        assert ta.thresholds_at(cal, target) == jax_ta.thresholds_at(want, target)


def test_filter_equals_the_jax_packages_on_a_predictions_table():
    import pandas as pd

    rng = np.random.default_rng(0)
    pred = rng.choice([3, 4, 5, 7, -1], 200)
    conf = np.round(rng.random(200), 3)
    cols = {"#read_id": [f"r{i}" for i in range(200)], "predicted_barcode": pred, "confidence_score": conf}
    for target in (95.0, 99.0, 99.5):
        got = ta.filter_predictions_table(Table(cols), "WDX4_rna004_v1_0", target)
        want = jax_ta.filter_predictions_df(pd.DataFrame(cols), "WDX4_rna004_v1_0", target)
        np.testing.assert_array_equal(got["predicted_barcode"], want["predicted_barcode"].to_numpy())
        assert (got["predicted_barcode"] == -1).sum() > (pred == -1).sum()
