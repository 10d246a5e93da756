"""Port parity: the live lane's one device program a micro-batch
(`Session._classify_on_device`) against the JAX lane's two
(`Session._fingerprint_batch`, then `model.predict` on the kept rows packed
to the front of a zero (max_batch, 25) array), on the CPU.

Input: the first 16 of the 64 replay reads of chip_smoke.py's live phase,
cut at poly(A) plus padding as the session cuts them, in each of the six
signal-length buckets, at max_batch 8 and 32. `ok`, `pred`, `fpt` (the
fingerprint's sums take XLA's order), `conf` and `probs` (the SVM's
product, exp, sigmoid and coupling in the jitted JAX operations,
ops/numerics.xla_dot / xla_exp, ops/svm.py) exactly.

The JAX side is jitted, so its t-scores carry this host's rsqrt estimate:
the tests skip where that is not the table the port carries (as
tests/test_torch_xla_rsqrt.py does).
"""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import live_bucket_batches, live_lane_reads  # noqa: E402
from warpdemux_tpu.live.balancer import BalancerConfig as JaxBalancerConfig  # noqa: E402
from warpdemux_tpu.live.balancer import BarcodeBalancers as JaxBarcodeBalancers  # noqa: E402
from warpdemux_tpu.live.session import Session as JaxSession  # noqa: E402
from warpdemux_tpu.live.session import SessionConfig as JaxSessionConfig  # noqa: E402
from warpdemux_tpu.models.registry import load_model as jax_load_model  # noqa: E402
from warpdemux_tpu_torch import _cuda  # noqa: E402
from warpdemux_tpu_torch.live.balancer import BalancerConfig, BarcodeBalancers  # noqa: E402
from warpdemux_tpu_torch.live.session import Session, SessionConfig  # noqa: E402
from warpdemux_tpu_torch.models.registry import load_model  # noqa: E402
from test_torch_xla_rsqrt import table_host  # noqa: E402,F401 (a fixture)

MODEL = "WDX4_rna004_v1_0"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One CPU thread for torch here: the test workers share the machine's
    cores, and this file's many small operations gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lane(tmp_path_factory):
    """(reads, {max_batch: (JAX session, port session)}) on the CPU."""
    save = tmp_path_factory.mktemp("lane")
    jax_model, model = jax_load_model(MODEL), load_model(MODEL, "cpu")
    sessions = {}
    for max_batch in (8, 32):
        jax_session = JaxSession(
            None, JaxSessionConfig(model_name=MODEL, save_path=str(save), run_id=f"jax{max_batch}", max_batch=max_batch),
            JaxBarcodeBalancers.from_configs(4, [JaxBalancerConfig()], [1.0], n_channels=4), model=jax_model,
        )
        session = Session(
            None, SessionConfig(model_name=MODEL, save_path=str(save), run_id=f"port{max_batch}", max_batch=max_batch),
            BarcodeBalancers.from_configs(4, [BalancerConfig()], [1.0], n_channels=4), model=model, device="cpu",
        )
        sessions[max_batch] = (jax_session, session)
    return live_lane_reads(model.X_sv.numpy())[:16], sessions


def jax_lane(session, signals):
    """The JAX lane's device half: (fpt, ok, pred, conf, probs)."""
    fpt, ok = session._fingerprint_batch(signals)
    packed = np.zeros((session.config.max_batch, fpt.shape[1]), np.float32)
    packed[: ok.sum()] = fpt[ok]
    return (fpt, ok, *session.model.predict(packed))


@pytest.mark.parametrize("max_batch", [8, 32])
@pytest.mark.parametrize("bucket", Session._LEN_BUCKETS)
def test_lane_program_equals_the_jax_lane(table_host, lane, bucket, max_batch):
    reads, sessions = lane
    jax_session, session = sessions[max_batch]
    kept = 0
    for signals in live_bucket_batches(reads, bucket, max_batch):
        sigs, _ = session._pad(signals)
        assert sigs.shape == (max_batch, bucket)
        fpt, ok, pred, conf, probs = jax_lane(jax_session, signals)
        got = session._classify_on_device(signals)
        np.testing.assert_array_equal(got.ok, ok)
        np.testing.assert_array_equal(got.fpt[ok], fpt[ok])
        np.testing.assert_array_equal(got.pred, pred)
        np.testing.assert_array_equal(got.conf, conf)
        np.testing.assert_array_equal(got.probs, probs)
        kept += int(ok.sum())
    assert kept >= len(reads) - 1


def test_lane_program_launches_each_kernel_of_its_path_once(monkeypatch, tmp_path):
    """On CUDA tensors each of K5, K4, K2, K3 and K1 is launched once a
    micro-batch; seen here through the wrappers' dispatch with a stand-in
    for each kernel that runs the plain version."""
    from warpdemux_tpu_torch.ops import dtw, peaks, segmentation, select, window_gather

    calls = []

    def spy(name, plain):
        def wrapper(*args, **kwargs):
            calls.append(name)
            return plain(*args, **kwargs)
        return wrapper

    monkeypatch.setattr("warpdemux_tpu_torch.ops.fingerprint.shift_rows",
                        spy("wdx_shift_rows", window_gather.shift_rows_plain))
    # the module: the package exports the function `normalize` under its name
    monkeypatch.setattr(importlib.import_module("warpdemux_tpu_torch.ops.normalize"), "range_median_mad",
                        spy("wdx_range_median_mad", select.range_median_mad_plain))
    monkeypatch.setattr(segmentation, "windowed_t_test",
                        spy("wdx_ttest", lambda *a: (segmentation.windowed_t_test_plain(*a),
                                                      torch.clamp_min(a[1] - 2 * a[2], 0))))
    monkeypatch.setattr(peaks, "suppress_by_distance", spy("wdx_suppress", peaks.suppress_by_distance_plain))
    monkeypatch.setattr("warpdemux_tpu_torch.models.dtw_svm.dtw_kernel_matrix",
                        spy("wdx_dtw", dtw.dtw_kernel_matrix_plain))
    session = Session(
        None, SessionConfig(model_name=MODEL, save_path=str(tmp_path), run_id="spy", max_batch=8),
        BarcodeBalancers.from_configs(4, [BalancerConfig()], [1.0], n_channels=4),
        model=load_model(MODEL, "cpu"), device="cpu",
    )
    reads = live_lane_reads(session.model.X_sv.numpy(), n=3)
    session._classify_on_device([cut for _, cut in reads])
    assert sorted(calls) == sorted(["wdx_shift_rows", "wdx_range_median_mad", "wdx_ttest", "wdx_suppress", "wdx_dtw"])
    assert set(calls) <= set(_cuda.SIGNATURES)


def test_model_predict_takes_and_gives_numpy_as_the_jax_model():
    """The port model's numpy API beside its forward: `predict` on (n, 25)
    and (25,) fingerprints, `fingerprint_len`. Nine rows exactly; one row
    `pred` exactly, `conf` and `probs` within rtol 1e-5, atol 1e-6: the
    jitted JAX product of one row by the model's constant coefficients
    sums in an order not found (ROADMAP queue 3, item C)."""
    jax_model, model = jax_load_model(MODEL), load_model(MODEL, "cpu")
    assert model.fingerprint_len == jax_model.fingerprint_len == 25
    fpts = np.random.default_rng(3).normal(0, 1, (9, 25)).astype(np.float32)
    fpts[:4] = model.X_sv.numpy()[[0, 300, 600, 850]]
    for x in (fpts, fpts[0]):
        got, want = model.predict(x), jax_model.predict(x)
        assert all(isinstance(a, np.ndarray) for a in got)
        np.testing.assert_array_equal(got[0], want[0])
        for g, w in zip(got[1:], want[1:]):
            if x.ndim == 2:
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
