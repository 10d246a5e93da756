"""The port's boundary-CNN trainer (warpdemux_tpu_torch/tools/train_cnn.py
and the trainable half of detect/cnn.py) against the JAX trainer
(tools/train_cnn.py, loaded by path) on the CPU.

Exact: the He initialization for ARCH and ARCH_WIDE (and the Generator's
state after it), the synthetic batches and their labels, the poly(A)
candidates from given logits (ties among them), the Adam update given
equal gradients (moments and parameters), the LLR-labeled fixture reads,
the printed eval line.

Within a tolerance, because the convolutions and their gradients sum in
oneDNN's order here and in XLA:CPU's there (the forward logits carry the
same tolerance, ROADMAP.md queue 3):
- the step-0 loss: rtol 1e-6 (seen: 8e-8); its accuracy exact;
- each parameter's gradient: max |difference| <= 1e-5 x max |gradient|
  (seen: 5e-7);
- after 3 Adam steps of 4 reads (`main --steps 3 --batch 4`, default,
  --wide and --input-cap 0): every weight and bias within 1e-6 (seen:
  3.4e-7; a step moves a weight by at most lr = 1e-3, so an update of
  the opposite sign would show as ~2e-3) and the printed losses within
  2e-4 (two roundings to 4 decimals and the difference).
"""

import importlib.util
import pathlib
import re
import sys
import uuid
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from warpdemux_tpu.detect import cnn as jax_cnn  # noqa: E402
from warpdemux_tpu_torch.config import utils as config_utils  # noqa: E402
from warpdemux_tpu_torch.detect import cnn  # noqa: E402
from warpdemux_tpu_torch.tools import train_cnn  # noqa: E402

CAP = 7168
STEP_LINE = re.compile(r"^step (\d+): loss ([0-9.]+) acc ([0-9.]+)$", re.M)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One CPU thread for torch here: the test workers share the machine's
    cores, and this file's many small operations gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def jax_in_32_bits():
    """The JAX trainer runs as a script, without the x64 mode that
    tests/conftest.py switches on (under it the accuracy and optax's bias
    corrections would be float64)."""
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="module")
def jax_trainer():
    """tools/train_cnn.py as a module (it is a script, not a package)."""
    spec = importlib.util.spec_from_file_location("jax_train_cnn", REPO / "tools" / "train_cnn.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["ARCH", "ARCH_WIDE"])
def test_init_params_equal_jax(arch):
    r_jax, r_port = np.random.default_rng(7), np.random.default_rng(7)
    want = jax_cnn.init_params(r_jax, getattr(jax_cnn, arch))
    got = cnn.init_params(r_port, getattr(cnn, arch), "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert r_port.bit_generator.state == r_jax.bit_generator.state


def test_make_batch_equals_jax(jax_trainer):
    want = jax_trainer.make_batch(np.random.default_rng(0), 4)
    got = train_cnn.make_batch(np.random.default_rng(0), 4)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert set(np.unique(got[2])) <= {-1, 0, 1, 2}


def _jax_loss(cap):
    """The JAX trainer's loss_fn (tools/train_cnn.py:176-201), jitted as
    there with its gradients."""

    def capped(x, lens):
        if not cap:
            return x, lens
        pos = jnp.arange(x.shape[1])[None, :]
        return jnp.where(pos < cap, x, 0.0), jnp.minimum(lens, cap)

    def loss_fn(params, x, lens, labels):
        xn, _valid = jax_cnn.preprocess(*capped(x, lens), train_cnn.DS)
        logits = jax_cnn.apply(params, xn)
        mask = labels >= 0
        if cap:
            lane = jnp.arange(labels.shape[1])[None, :]
            mask = mask & (lane * train_cnn.DS < cap)
        lab = jnp.maximum(labels, 0)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, lab)
        acc = jnp.sum(jnp.where(mask & (jnp.argmax(logits, -1) == lab), 1.0, 0.0)) / jnp.maximum(jnp.sum(mask), 1)
        return jnp.sum(jnp.where(mask, ce, 0.0)) / jnp.maximum(jnp.sum(mask), 1), acc

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.mark.parametrize("cap", [CAP, 0])
def test_step0_loss_and_gradients_match_jax(cap):
    sigs, lens, labels = train_cnn.make_batch(np.random.default_rng(1), 8)
    want_params = jax_cnn.init_params(np.random.default_rng(0))
    params = cnn.init_params(np.random.default_rng(0), device="cpu")
    (want_loss, want_acc), want_grads = _jax_loss(cap)(
        want_params, jnp.asarray(sigs), jnp.asarray(lens), jnp.asarray(labels)
    )
    for p in params.values():
        p.requires_grad_(True)
    loss, acc = train_cnn.loss_fn(params, *map(torch.from_numpy, (sigs, lens, labels)), cap)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-6)
    assert float(acc) == float(want_acc)
    for k, g in grads.items():
        w = np.asarray(want_grads[k])
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max(), k


def test_adam_equals_optax_given_equal_gradients():
    """The update alone, bit for bit: moments and parameters over the
    trainer's default 400 steps (optax's bias corrections take XLA's pow
    of the step count, the port's numpy's), of gradients spanning nine
    decades."""
    rng = np.random.default_rng(3)
    shapes = {"w0": (32, 16, 7), "b0": (32,)}
    start = {k: rng.normal(0, 0.3, s).astype(np.float32) for k, s in shapes.items()}
    tx = optax.adam(1e-3)
    want = {k: jnp.asarray(v) for k, v in start.items()}
    state = tx.init(want)
    got = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    opt = train_cnn.Adam(got, 1e-3)

    @jax.jit
    def update(params, state, grads):
        updates, state = tx.update(grads, state)
        return optax.apply_updates(params, updates), state

    for _ in range(train_cnn.build_parser().get_default("steps")):
        g = {k: (rng.normal(0, 1, s) * 10.0 ** rng.integers(-9, 1, s)).astype(np.float32) for k, s in shapes.items()}
        want, state = update(want, state, {k: jnp.asarray(v) for k, v in g.items()})
        opt.step(got, {k: torch.from_numpy(v) for k, v in g.items()})
        for k in shapes:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
            np.testing.assert_array_equal(opt.mu[k].numpy(), np.asarray(state[0].mu[k]))
            np.testing.assert_array_equal(opt.nu[k].numpy(), np.asarray(state[0].nu[k]))


@pytest.mark.parametrize("flags", [[], ["--wide"], ["--input-cap", "0"]], ids=["default", "wide", "input_cap_0"])
def test_main_three_steps_matches_jax(flags, jax_trainer, tmp_path, monkeypatch, capsys):
    argv = ["--steps", "3", "--batch", "4", "--out", "w", *flags]
    monkeypatch.setattr(jax_cnn, "CNN_DIR", tmp_path / "jax")
    monkeypatch.setattr(config_utils, "CNN_DIR", tmp_path / "port")
    monkeypatch.setattr(sys, "argv", ["train_cnn.py", *argv])
    jax_trainer.main()
    want_out = capsys.readouterr().out
    params, history = train_cnn.main([*argv, "--device", "cpu"])
    got_out = capsys.readouterr().out

    want_steps, got_steps = STEP_LINE.findall(want_out), STEP_LINE.findall(got_out)
    assert [s for s, _, _ in got_steps] == [s for s, _, _ in want_steps] == ["0", "2"]
    for (_, wl, wa), (step, gl, ga) in zip(want_steps, got_steps):
        assert abs(float(gl) - float(wl)) <= 2e-4
        assert abs(float(gl) - float(history.losses[int(step)])) <= 5e-5
        assert ga == wa
    assert f"saved {tmp_path / 'port' / 'w.npz'}" in got_out
    assert want_out.splitlines()[-1] == got_out.splitlines()[-1]  # the eval line
    assert got_out.splitlines()[-1].startswith("eval: polyA reads ")

    want = np.load(tmp_path / "jax" / "w.npz")
    got = np.load(tmp_path / "port" / "w.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(got[k], params[k].numpy())


def _logits_with_runs(rng, B, Lds):
    """Logits whose argmax draws poly(A) runs of repeated lengths (ties
    among the runs and among the zeros of the other positions)."""
    cls = np.zeros((B, Lds), np.int64)
    for b in range(B):
        p = int(rng.integers(0, 20))
        while p < Lds:
            n = int(rng.choice([3, 8, 8, 12, 12, 12, 40]))
            cls[b, p : p + n] = 1
            cls[b, p + n : p + n + 6] = 2 if rng.random() < 0.5 else 0
            p += n + 6 + int(rng.integers(0, 30))
    cls[0] = 0  # a row without poly(A): every candidate length 0
    logits = rng.normal(0, 0.1, (B, Lds, 3)).astype(np.float32)
    np.put_along_axis(logits, cls[..., None], 5.0, axis=-1)
    return logits


@pytest.mark.parametrize("close_gap", [2, 0])
def test_polya_candidates_equal_jax(close_gap):
    rng = np.random.default_rng(5)
    B, Lds = 12, 700
    logits = _logits_with_runs(rng, B, Lds)
    valid = np.arange(Lds)[None, :] < rng.integers(300, Lds + 1, B)[:, None]
    for k in (5, 16):
        want_s, want_l = jax_cnn.polya_candidates_from_logits(jnp.asarray(logits), jnp.asarray(valid), k, close_gap)
        got_s, got_l = cnn.polya_candidates_from_logits(torch.from_numpy(logits), torch.from_numpy(valid), k, close_gap)
        assert got_s.dtype == got_l.dtype == torch.int32
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert (np.asarray(want_l)[:, 1:] == np.asarray(want_l)[:, :-1]).any()  # ties were ranked


def test_serving_forward_builds_no_graph_and_trained_bundle_detects(tmp_path, monkeypatch):
    """A bundle the trainer wrote loads through cnn_from_arrays (weights
    without gradient), and the CNN detector runs with it: the same
    boundaries as the JAX detector given the same bundle, on 32 bench
    rows."""
    from bench import synth_minibatch
    from warpdemux_tpu.config.utils import get_model_spc_config as jax_spc
    from warpdemux_tpu.detect.boundaries import detect_boundaries_batch as jax_detect
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.detect.boundaries import detect_boundaries_batch
    from warpdemux_tpu_torch.models.registry import cnn_from_arrays

    monkeypatch.setattr(config_utils, "CNN_DIR", tmp_path)
    monkeypatch.setattr(jax_cnn, "CNN_DIR", tmp_path)
    train_cnn.main(["--steps", "2", "--batch", "4", "--out", "w", "--device", "cpu"])
    with np.load(tmp_path / "w.npz") as z:
        module = cnn_from_arrays(dict(z), "cpu")
    assert not any(b.requires_grad for b in module.buffers())
    adc, off, sc, lens = synth_minibatch(np.random.default_rng(0), 32, 10000)
    x = ((adc.astype(np.float32) + off[:, None]) * sc[:, None]).astype(np.float32)
    xn, _ = cnn.preprocess(torch.from_numpy(x), torch.from_numpy(lens), 10)
    assert module(xn).grad_fn is None

    cfg = get_model_spc_config("WDX4_rna004_v1_0").detect
    got = detect_boundaries_batch(torch.from_numpy(x), torch.from_numpy(lens), cfg, module, with_stats=False)
    want = jax_detect(jnp.asarray(x), jnp.asarray(lens), jax_spc("WDX4_rna004_v1_0").detect,
                      jax_cnn.load_params("w"), with_stats=False)
    for f in ("success", "fail_code", "adapter_start", "adapter_end", "polya_start", "polya_end"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)


def test_load_params_reads_the_weights_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(config_utils, "CNN_DIR", tmp_path)
    with pytest.raises(FileNotFoundError, match="CNN weights 'absent' not found"):
        cnn.load_params("absent", "cpu")
    params = cnn.init_params(np.random.default_rng(0), cnn.ARCH, "cpu")
    cnn.save_params(params, tmp_path / "w.npz")
    for k, v in cnn.load_params("w", "cpu").items():
        assert torch.equal(v, params[k]), k


def test_load_real_labeled_equals_jax(jax_trainer, tmp_path, monkeypatch):
    """The LLR-labeled fixture reads, on a pod5 set of the port's writer
    (two files, 24 seed-0 bench reads each) in place of the reference's
    fixtures, with max_obs_adapter 6000 (the default) and 9000."""
    pytest.importorskip("pyarrow")
    from bench import synth_minibatch
    from warpdemux_tpu_torch.io.pod5_writer import write_pod5

    adc, off, sc, lens = synth_minibatch(np.random.default_rng(0), 48, 10000)
    rng = np.random.default_rng(1)
    for k in range(2):
        write_pod5(tmp_path / f"small_pod5_{k}.pod5", [
            dict(read_id=str(uuid.UUID(bytes=rng.bytes(16))), signal=adc[i, : lens[i]],
                 calibration_offset=float(off[i]), calibration_scale=float(sc[i]))
            for i in range(24 * k, 24 * k + 24)
        ])
    real_path = pathlib.Path

    def fixture_path(p, *rest):  # the JAX trainer names the reference's fixture directory
        return real_path(tmp_path) if str(p).endswith("test_data/live_balancing") else real_path(p, *rest)

    for bound in (None, 9000):
        with monkeypatch.context() as m:
            m.setattr(pathlib, "Path", fixture_path)
            want = jax_trainer.load_real_labeled(max_obs_adapter=bound)
        got = train_cnn.load_real_labeled(tmp_path, max_obs_adapter=bound, device="cpu")
        assert len(got[0]) > 24
        for w, g in zip(want, got):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    got = train_cnn.load_real_labeled(tmp_path, limit=5, device="cpu")
    assert [a.shape[0] for a in got] == [5, 5, 5]


def test_real_reads_need_a_fixture_directory(tmp_path, capsys):
    """--real-frac names no default place: without --fixture-dir the CLI
    exits 2 before it reads anything, and a directory without fixtures is
    an error, not an empty batch."""
    with pytest.raises(SystemExit) as exit_info:
        train_cnn.main(["--steps", "1", "--real-frac", "0.5", "--device", "cpu"])
    assert exit_info.value.code == 2
    assert "--real-frac needs --fixture-dir" in capsys.readouterr().err
    with pytest.raises(FileNotFoundError, match="no small_pod5"):
        train_cnn.load_real_labeled(tmp_path, device="cpu")


def test_trainer_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cnn.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cnn.init_params(np.random.default_rng(0))
