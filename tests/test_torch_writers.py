"""Port parity: the pandas-free writers, tables, resume scan and config
helpers of the offline run against the JAX package's pandas ones.

- `io/writers.Table`'s CSV text equals `DataFrame.to_csv(index=False)` of
  the same columns, case by case (float32, float64, ints, bools, NaN,
  quoted strings, an empty table), after gunzip, byte for byte;
- the shard writers and the run loop's shard accumulator write the JAX
  writers' text (and the same npz arrays);
- `DetectArrays.to_summary_frame` and `DTWSVMModel.predictions_to_table`
  write the JAX frames' text, columns in the same order;
- `scan_processed_reads`, `dump_toml`, `parse_export_overrides`,
  `resolve_model_chemistry_dict` and `command.json` equal the JAX results.
"""

import gzip
import json
import uuid

import numpy as np
import pandas as pd
import pytest

from warpdemux_tpu.config import utils as jax_utils
from warpdemux_tpu.io import writers as jax_writers
from warpdemux_tpu.pipeline import resume as jax_resume
from warpdemux_tpu_torch.config import utils
from warpdemux_tpu_torch.io import writers
from warpdemux_tpu_torch.io.writers import Table
from warpdemux_tpu_torch.pipeline import resume

MODEL = "WDX4_rna004_v1_0"


def _gunzip(path):
    with gzip.open(path, "rb") as fh:
        return fh.read()


def _ids(rng, n):
    return [str(uuid.UUID(bytes=rng.bytes(16))) for _ in range(n)]


def _cases():
    rng = np.random.default_rng(0)
    f32 = rng.normal(80, 12, 7).astype(np.float32)
    f32[[1, 2, 3]] = [0.27, 3.0, 1e-7]
    f64 = rng.normal(0, 1e6, 7)
    f64[[0, 1]] = [0.1 + 0.2, 1e-300]
    with_nan = f32.copy()
    with_nan[[0, 4]] = np.nan
    return {
        "float32": {"x": f32, "r3": np.round(f32 / 97, 3), "r4": np.round(f32 / 89, 4)},
        "float64": {"x": f64, "inf": np.array([np.inf, -np.inf, 0.0, -0.0, 1e16, 5e-5, 2.5])},
        "ints": {
            "i32": rng.integers(-2**31, 2**31, 7, dtype=np.int64).astype(np.int32),
            "i64": rng.integers(-2**62, 2**62, 7),
            "u8": rng.integers(0, 256, 7).astype(np.uint8),
        },
        "bools": {"b": rng.random(7) < 0.5, "all_true": np.ones(7, bool)},
        "nan": {"f32": with_nan, "f64": with_nan.astype(np.float64), "all": np.full(7, np.nan, np.float32)},
        "quoted strings": {
            "s": ["plain", "a,b", 'say "hi"', "two\nlines", "", "cr\rhere", "tab\there"],
            "id": _ids(rng, 7),
        },
        "mixed": {
            "#read_id": _ids(rng, 7), "n": np.arange(7, dtype=np.int32), "f": f32,
            "ok": rng.random(7) < 0.5, "why": ["", "no polyA found", "", "", "x", "", ""],
        },
        "empty table": {"read_id": [], "x": np.zeros(0, np.float32), "n": np.zeros(0, np.int32)},
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_table_csv_text_equals_pandas(tmp_path, case):
    cols = _cases()[case]
    pd.DataFrame(cols).to_csv(tmp_path / "pandas.csv.gz", index=False, compression="gzip")
    Table(cols).to_csv_gz(tmp_path / "port.csv.gz")
    assert _gunzip(tmp_path / "port.csv.gz") == _gunzip(tmp_path / "pandas.csv.gz")


def test_table_rows_concat_drop_follow_pandas():
    cols = _cases()["mixed"]
    t, df = Table(cols), pd.DataFrame(cols)
    mask = t["ok"]
    # rows, then concat of like tables, then drop; each as pandas does it
    got = Table.concat([t.rows(mask), t.rows(slice(2, 5))]).drop("why")
    want = pd.concat([df[mask], df.iloc[2:5]], ignore_index=True).drop(columns=["why"])
    assert got.names == list(want.columns)
    for name in got.names:
        assert got[name].tolist() == want[name].tolist()
    t["n"] = np.arange(7, dtype=np.int32) * 2  # replaces in place
    t["new"] = np.zeros(7, np.float32)  # appends
    assert t.names == ["#read_id", "n", "f", "ok", "why", "new"]
    with pytest.raises(ValueError):
        t["short"] = np.zeros(3)


def _summary_inputs(rng, n):
    from warpdemux_tpu.detect.containers import DetectArrays as JaxDetect
    from warpdemux_tpu_torch.detect.containers import DetectArrays

    i32 = lambda lo, hi: rng.integers(lo, hi, n).astype(np.int32)
    f32 = lambda: rng.normal(80, 12, n).astype(np.float32)
    fields = {}
    for f in DetectArrays._fields:
        if f in ("success", "used_llr_fallback"):
            fields[f] = rng.random(n) < 0.6
        elif f.endswith("fail") or f == "fail_code":
            fields[f] = i32(0, 14)
        elif f.endswith(("_start", "_end", "_len", "candidates")):
            fields[f] = i32(0, 10000)
        else:
            fields[f] = f32()
    fields["adapter_std"][0] = np.nan
    args = (_ids(rng, n), i32(100, 30000), i32(100, 10000))
    return DetectArrays(**fields), JaxDetect(**fields), args


@pytest.mark.parametrize("primary", ["cnn", "llr"])
def test_summary_frame_text_equals_jax(tmp_path, primary):
    det, jax_det, args = _summary_inputs(np.random.default_rng(1), 9)
    table = det.to_summary_frame(*args, primary_method=primary)
    frame = jax_det.to_summary_frame(*args, primary_method=primary)
    assert table.names == list(frame.columns)
    assert ("cnn_fail_reason" in table) == (primary == "cnn")
    writers.save_boundaries(table, tmp_path, 0, failed=True)
    (tmp_path / "j").mkdir()
    jax_writers.save_boundaries(frame, tmp_path / "j", 0, failed=True)
    assert _gunzip(tmp_path / "failed_reads_0.csv.gz") == _gunzip(tmp_path / "j" / "failed_reads_0.csv.gz")


def test_summary_frame_without_per_method_columns_equals_jax():
    """No per-method columns where the detect pass recorded none."""
    det, jax_det, args = _summary_inputs(np.random.default_rng(2), 4)
    none = {f: None for f in det._fields if f.startswith(("prim_", "llr_"))}
    table = det._replace(**none).to_summary_frame(*args, primary_method="cnn")
    frame = jax_det._replace(**none).to_summary_frame(*args, primary_method="cnn")
    assert table.names == list(frame.columns)
    assert not any(n.startswith(("cnn_", "llr_")) for n in table.names)


def test_predictions_table_text_equals_jax(tmp_path):
    from warpdemux_tpu.models.registry import load_model as jax_load_model
    from warpdemux_tpu_torch.models.registry import load_model

    rng = np.random.default_rng(3)
    n = 50
    probs = rng.dirichlet(np.ones(5), n).astype(np.float32)
    probs[:5] = np.float32([0.00005, 0.99995, 0.12345, 0.5, 0.0])  # rounding ties
    conf = rng.random(n).astype(np.float32)
    conf[:3] = np.float32([0.0005, 0.9995, 0.1235])
    pred = rng.choice([3, 4, 5, 7, -1], n).astype(np.int32)
    ids = np.asarray(_ids(rng, n), object)
    table = load_model(MODEL, "cpu").predictions_to_table(ids, pred, conf, probs)
    frame = jax_load_model(MODEL).predictions_to_df(ids, pred, conf, probs)
    writers.save_predictions(table, tmp_path, 3)
    (tmp_path / "j").mkdir()
    jax_writers.save_predictions(frame, tmp_path / "j", 3)
    text = _gunzip(tmp_path / "barcode_predictions_3.csv.gz")
    assert text == _gunzip(tmp_path / "j" / "barcode_predictions_3.csv.gz")
    assert text.splitlines()[0] == b"#read_id,predicted_barcode,confidence_score,p03,p04,p05,p07,p-1"


def test_shard_accumulator_writes_the_jax_shards(tmp_path):
    """The run loop's re-chunking into batch_size_output-row shards."""
    from warpdemux_tpu.pipeline.run import _ShardAccumulator as JaxAccumulator
    from warpdemux_tpu_torch.pipeline.run import _ShardAccumulator

    rng = np.random.default_rng(4)
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    port = _ShardAccumulator(lambda t, b: writers.save_predictions(t, tmp_path / "p", b, tag="h001_"), 7, 2)
    ref = JaxAccumulator(lambda d, b: jax_writers.save_predictions(d, tmp_path / "j", b, tag="h001_"), 7, 2)
    for n in (3, 0, 9, 1, 6, 2):
        cols = {"#read_id": _ids(rng, n), "x": rng.random(n).astype(np.float32), "k": np.arange(n)}
        port.add(Table(cols))
        ref.add(pd.DataFrame(cols))
    port.close()
    ref.close()
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "p").iterdir())
    assert names[0] == "barcode_predictions_h001_2.csv.gz" and len(names) == 3
    for name in names:
        assert _gunzip(tmp_path / "p" / name) == _gunzip(tmp_path / "j" / name)


@pytest.mark.parametrize("dwell", [False, True])
def test_save_fingerprints_equals_jax(tmp_path, dwell):
    rng = np.random.default_rng(5)
    ids = np.asarray(_ids(rng, 6), object)
    fpts = rng.normal(0, 1, (6, 25)).astype(np.float32)
    dw = rng.integers(1, 400, (6, 25)).astype(np.int32) if dwell else None
    a = writers.save_fingerprints(ids, fpts, tmp_path, 4, dwell_times=dw)
    (tmp_path / "j").mkdir()
    b = jax_writers.save_fingerprints(ids, fpts, tmp_path / "j", 4, dwell_times=dw)
    assert a.name == b.name
    with np.load(a, allow_pickle=True) as za, np.load(b, allow_pickle=True) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype
            np.testing.assert_array_equal(za[k], zb[k])


def test_scan_processed_reads_equals_jax(tmp_path):
    rng = np.random.default_rng(6)
    for sub in ("predictions", "failed_reads", "fingerprints", "boundaries"):
        (tmp_path / sub).mkdir()
    for b in (0, 1, 4):
        writers.save_predictions(Table({"#read_id": _ids(rng, 3), "p": np.ones(3)}), tmp_path / "predictions", b)
    writers.save_boundaries(Table({"read_id": _ids(rng, 2), "fail_reason": ["a,b", "x"]}), tmp_path / "failed_reads", 2, failed=True)
    writers.save_boundaries(Table({"read_id": _ids(rng, 2), "fail_reason": ["", "y"]}), tmp_path / "failed_reads", 3, failed=True, tag="h002_")
    writers.save_boundaries(Table({"read_id": _ids(rng, 2)}), tmp_path / "boundaries", 6)
    writers.save_fingerprints(np.asarray(_ids(rng, 2), object), np.zeros((2, 25), np.float32), tmp_path / "fingerprints", 7)
    for kind in ("predictions", "fingerprints"):
        got = resume.scan_processed_reads(str(tmp_path), kind)
        want = jax_resume.scan_processed_reads(str(tmp_path), kind)
        assert got == want
    assert got[1:] == (8, 4, 5)
    assert resume.scan_processed_reads(str(tmp_path / "none")) == (set(), 0, 0, 0)


@pytest.mark.parametrize(
    "pairs",
    [
        [],
        ["core.max_obs_trace=8000", "cnn_boundaries.cnn_detect=False", "mvs_polya.polya_scale=1.25"],
        ["a.b=hello", "x.y=[1, 2]", "x.z=not python", "top=3", "x.f=1e-3"],
    ],
)
def test_export_overrides_and_config_snapshot_equal_jax(pairs):
    over = utils.parse_export_overrides(pairs)
    assert over == jax_utils.parse_export_overrides(pairs)
    if all(p.startswith(("core.", "cnn_", "mvs_")) for p in pairs):
        d = utils.resolve_model_chemistry_dict(MODEL, over)
        assert d == jax_utils.resolve_model_chemistry_dict(MODEL, over)
        assert utils.dump_toml(d) == jax_utils.dump_toml(d)  # the config.toml bytes
    else:
        assert utils.dump_toml(over) == jax_utils.dump_toml(over)


def test_export_override_file_and_bad_pair(tmp_path):
    path = tmp_path / "over.toml"
    path.write_text('[core]\nmax_obs_trace = 9000\n[extra]\nname = "q\\"x"\nvals = [1.5, inf]\n')
    assert utils.parse_export_overrides([str(path), "core.min_obs_adapter=1500"]) == (
        jax_utils.parse_export_overrides([str(path), "core.min_obs_adapter=1500"])
    )
    d = utils.parse_export_overrides([str(path)])
    assert utils.dump_toml(d) == jax_utils.dump_toml(d)
    with pytest.raises(ValueError):
        utils.parse_export_overrides(["no_equals_sign"])


def test_command_json_equals_jax(tmp_path):
    from warpdemux_tpu.config import config as jax_config
    from warpdemux_tpu.config.utils import get_model_spc_config as jax_spc
    from warpdemux_tpu_torch.config import config

    def build(mod, spc, out):
        return mod.Config(
            input=mod.InputConfig(files=["a.pod5", "b.pod5"]),
            output=mod.OutputConfig(output_dir=str(out), save_fpts=True, save_boundaries=True),
            batch=mod.BatchConfig(minibatch_size=48, batch_size_output=40, wire="adc"),
            task=mod.TaskConfig(command="prep", predict=False),
            classif=mod.ClassifConfig(model_name=MODEL),
            sig_proc=spc,
        )

    port = build(config, utils.get_model_spc_config(MODEL), tmp_path / "run")
    ref = build(jax_config, jax_spc(MODEL), tmp_path / "run")
    for cfg, name in ((port, "port.json"), (ref, "jax.json")):
        cfg.write_command_json(["prep", "-i", "a.pod5"])
        (tmp_path / "run" / "command.json").rename(tmp_path / name)
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads((tmp_path / "jax.json").read_text())
    assert sorted(p.name for p in (tmp_path / "run").iterdir()) == [
        "boundaries", "failed_reads", "fingerprints", "predictions",
    ]
