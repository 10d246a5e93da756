"""Train the boundary CNN on synthetic RNA004 squiggles.

Port of tools/train_cnn.py: the same reads from the same seed (utils/
synthetic.synth_read), per-position 3-class labels on the downscaled grid
(0=adapter, 1=polyA, 2=RNA; -1, masked out of the loss, past the read's
end and, with an input cap, past the cap), the same He initialization,
loss and Adam update, and the same printed lines. The gradients come from
autograd; the whole step runs in full float32 (no TF32) with cuDNN's
deterministic algorithms, so two runs of one seed on the card give the
same weights bit for bit.

Usage:
    python -m warpdemux_tpu_torch.tools.train_cnn [--steps 400] [--out NAME] [--device cpu]

Writes <weights directory>/<NAME>.npz (config/utils.CNN_DIR, the JAX
package's detect/cnn_files/), which models/registry.load_cnn serves. The
run goes on the CUDA GPU unless `--device` names another, and raises
without one.
"""

from __future__ import annotations

import argparse
import contextlib
import time
from dataclasses import replace
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from warpdemux_tpu_torch._cuda import resolve_device
from warpdemux_tpu_torch.config import utils as config_utils
from warpdemux_tpu_torch.detect import cnn
from warpdemux_tpu_torch.ops.numerics import exact_sqrt, fma, full_float32
from warpdemux_tpu_torch.utils.synthetic import synth_read

DS = 10
L = 10000


def make_batch(rng, B):
    """Varied synthetic reads + per-ds-position labels (-1 = masked)."""
    sigs = np.zeros((B, L), np.float32)
    lens = np.zeros(B, np.int32)
    labels = np.full((B, L // DS), -1, np.int32)
    for b in range(B):
        has_polya = rng.random() < 0.8
        adapter_len = int(rng.integers(2200, 5800))
        polya_len = int(rng.integers(600, 3200)) if has_polya else 0
        open_pore = int(rng.integers(0, 300)) if rng.random() < 0.2 else 0
        adapter_level = float(rng.normal(75, 6))
        polya_level = adapter_level * float(rng.uniform(1.32, 1.55))
        rna_level = adapter_level * float(rng.uniform(1.1, 1.45))
        sig, truth = synth_read(
            rng,
            adapter_len=adapter_len,
            polya_len=polya_len,
            rna_len=int(rng.integers(2000, 9000)),
            adapter_level=adapter_level,
            polya_level=polya_level,
            rna_level=rna_level,
            open_pore_len=open_pore,
            noise=float(rng.uniform(1.2, 2.6)),
            adapter_spread=float(rng.uniform(8, 14)),
        )
        n = min(L, sig.size)
        sigs[b, :n] = sig[:n]
        lens[b] = n
        g = np.arange(L // DS) * DS
        lab = np.where(
            g < truth["polya_start"],
            0,
            np.where(g < truth["polya_end"], 1, 2),
        )
        if not has_polya:
            lab = np.where(g < truth["adapter_end"], 0, 2)
        lab[g >= n] = -1
        labels[b] = lab
    return sigs, lens, labels


def load_real_labeled(fixture_dir, limit=None, max_obs_adapter=None, device=None):
    """Real fixture reads (<fixture_dir>/small_pod5_*.pod5, the reference
    WarpDemuX checkout's test_data/live_balancing) labeled by the
    port's LLR detector, the reference's most sensitive method and its
    fallback target; reads it fails are masked out entirely. With
    `max_obs_adapter` raised past the contract default (6000) the
    long-adapter population still yields training labels: the CNN is a
    boundary proposer, and the contract's gates apply the bound again at
    detect time. Returns (sigs, lens, labels) like make_batch. Needs the
    pod5 reader's pyarrow and zstandard."""
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.detect.boundaries import detect_boundaries_batch
    from warpdemux_tpu_torch.io.pod5 import yield_signal_batches

    device = resolve_device(device)
    dcfg = replace(
        get_model_spc_config("WDX4_rna004_v1_0").detect,
        method="llr",
        fallback_to_llr=False,
    )
    if max_obs_adapter:
        dcfg = replace(dcfg, max_obs_adapter=max_obs_adapter)
    files = sorted(Path(fixture_dir).glob("small_pod5_*.pod5"))
    if not files:
        raise FileNotFoundError(f"no small_pod5_*.pod5 fixtures in {fixture_dir}")
    all_s, all_n, all_l = [], [], []
    for f in files:
        for sigs, in_lens, _fl, _ids in yield_signal_batches(
            [str(f)], None, None, batch_size=200, preload_size=L
        ):
            det = detect_boundaries_batch(
                torch.as_tensor(sigs, device=device), torch.as_tensor(in_lens, device=device), dcfg
            )
            ok = det.success.cpu().numpy()
            ps = det.polya_start.cpu().numpy()
            pe = det.polya_end.cpu().numpy()
            g = np.arange(L // DS)[None, :] * DS
            lab = np.where(
                g < ps[:, None], 0, np.where(g < pe[:, None], 1, 2)
            ).astype(np.int32)
            lab[g >= in_lens[:, None]] = -1
            lab[~ok] = -1
            all_s.append(sigs[ok])
            all_n.append(in_lens[ok])
            all_l.append(lab[ok])
    s = np.concatenate(all_s)
    n = np.concatenate(all_n)
    l = np.concatenate(all_l)
    if limit:
        s, n, l = s[:limit], n[:limit], l[:limit]
    return s, n, l


@contextlib.contextmanager
def training_numerics():
    """The trainer's numerics on the GPU: full float32 (cuDNN's gradient
    convolutions would otherwise take TF32) and cuDNN's deterministic
    algorithms with its benchmark off (some backward-weight algorithms add
    with atomics). The cuDNN switches are restored on leaving, so nothing
    that runs after the trainer inherits them."""
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        with full_float32():
            yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def capped(x, lens, cap):
    """The prefix-causal CNN input of detect/boundaries.py: the input zeroed
    and the lengths cut at `cap` samples (0: no cap)."""
    if not cap:
        return x, lens
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    return torch.where(pos < cap, x, torch.zeros_like(x)), torch.clamp_max(lens, cap)


def softmax_cross_entropy(logits, labels):
    """optax.softmax_cross_entropy_with_integer_labels: logsumexp (shifted
    by the row's maximum, as jax.nn.logsumexp) minus the label's logit."""
    m = logits.detach().amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    lse = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
    return lse - torch.gather(logits, -1, labels[..., None].long())[..., 0]


def loss_fn(params, x, lens, labels, cap):
    """(loss, accuracy): the mean cross entropy and argmax accuracy over the
    labeled positions (labels >= 0) within the cap."""
    xn, _valid = cnn.preprocess(*capped(x, lens, cap), DS)
    logits = cnn.apply(params, xn)
    mask = labels >= 0
    if cap:
        lane = torch.arange(labels.shape[1], device=labels.device)[None, :]
        mask = mask & (lane * DS < cap)
    lab = torch.clamp_min(labels, 0)
    ce = softmax_cross_entropy(logits, lab)
    count = torch.clamp_min(mask.sum(), 1)
    hit = mask & (torch.argmax(logits, -1) == lab)
    acc = torch.where(hit, 1.0, 0.0).sum() / count
    return torch.where(mask, ce, torch.zeros_like(ce)).sum() / count, acc


class Adam:
    """optax.adam(lr) on a dict of float32 tensors, rounded as the jitted
    optax update rounds on XLA:CPU: mu = fma(1-b1, g, b1 mu) and
    nu = fma(1-b2, g g, b2 nu) (XLA contracts each moment into one FMA),
    the bias corrections c = 1 - b^count in float32, the update
    mu / (c1 (sqrt(nu / c2) + eps)) (XLA folds optax's (mu / c1) / d into
    one division), and the parameter fma(update, -lr, p). Given the same
    gradients it writes optax's moments and parameters bit for bit
    (torch.optim.Adam rounds in another order)."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params, grads):
        self.count += 1
        one = np.float32(1)
        dev = next(iter(params.values())).device
        # device tensors: CUDA divides by a host scalar as a product with
        # its reciprocal
        c1, c2 = (torch.tensor(one - np.float32(b) ** np.float32(self.count), device=dev)
                  for b in (self.b1, self.b2))
        for k, p in params.items():
            g = grads[k]
            self.mu[k] = fma(torch.full_like(g, 1 - self.b1), g, self.b1 * self.mu[k])
            self.nu[k] = fma(torch.full_like(g, 1 - self.b2), g * g, self.b2 * self.nu[k])
            update = self.mu[k] / (c1 * (exact_sqrt(self.nu[k] / c2) + self.eps))
            p.copy_(fma(update, torch.full_like(p, -self.lr), p))


class History(NamedTuple):
    losses: np.ndarray  # (steps,) float32
    accs: np.ndarray  # (steps,) float32
    seconds: float  # the loop's time on the host clock, the device synchronised
    batch_seconds: float  # of which make_batch's (the host's synthesis of the reads)


def train(params, rng, steps, batch, lr=1e-3, input_cap=7168, real=None, real_frac=0.0, log=print):
    """`steps` Adam steps of `batch` reads from `rng` on the device of
    `params` (trained in place); with `real` (load_real_labeled's arrays),
    the first round(real_frac * batch) rows of each batch are real reads.
    Prints the JAX trainer's `step i: ...` lines through `log`."""
    dev = next(iter(params.values())).device
    for p in params.values():
        p.requires_grad_(True)
    opt = Adam(params, lr)
    losses, accs = [], []
    batch_seconds = 0.0
    t0 = time.perf_counter()
    with training_numerics():
        for step in range(steps):
            tb = time.perf_counter()
            sigs, lens, labels = make_batch(rng, batch)
            batch_seconds += time.perf_counter() - tb
            if real is not None:
                k = int(round(real_frac * batch))
                if k:
                    idx = rng.integers(0, len(real[0]), k)
                    sigs[:k] = real[0][idx]
                    lens[:k] = real[1][idx]
                    labels[:k] = real[2][idx]
            x, n, lab = (torch.as_tensor(a, device=dev) for a in (sigs, lens, labels))
            loss, acc = loss_fn(params, x, n, lab, input_cap)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            opt.step(params, grads)
            losses.append(loss.detach())
            accs.append(acc)
            if step % 50 == 0 or step == steps - 1:
                log(f"step {step}: loss {float(loss.detach()):.4f} acc {float(acc):.4f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    for p in params.values():
        p.requires_grad_(False)
    return History(torch.stack(losses).cpu().numpy(), torch.stack(accs).cpu().numpy(), seconds, batch_seconds)


def evaluate(params, rng, input_cap, n=64):
    """The quick candidate-quality check: the top poly(A) candidate's start
    against the truth on `n` fresh reads. Returns the printed line."""
    dev = next(iter(params.values())).device
    sigs, lens, labels = make_batch(rng, n)
    with torch.no_grad(), training_numerics():
        x, ln = capped(torch.as_tensor(sigs, device=dev), torch.as_tensor(lens, device=dev), input_cap)
        xn, valid = cnn.preprocess(x, ln, DS)
        starts, _ = cnn.polya_candidates_from_logits(cnn.apply(params, xn), valid, 5)
    has_pa = (labels == 1).any(axis=1)
    true_start = np.where(has_pa, np.argmax(labels == 1, axis=1), -1)
    err = np.abs(starts[:, 0].cpu().numpy() - true_start)[has_pa]
    return (
        f"eval: polyA reads {has_pa.sum()}/{n}, top-candidate start err "
        f"median {np.median(err):.1f} ds (p90 {np.percentile(err, 90):.1f})"
    )


def build_parser():
    ap = argparse.ArgumentParser(description="Train the boundary CNN on synthetic RNA004 squiggles.")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="rna004_cnn_synth_v1")
    ap.add_argument(
        "--real-frac", type=float, default=0.0,
        help="fraction of each batch drawn from LLR-labeled real fixture "
             "reads (0 = synthetic only); needs --fixture-dir",
    )
    ap.add_argument(
        "--fixture-dir", default=None,
        help="directory of the real small_pod5_*.pod5 fixtures that "
             "--real-frac draws from (the reference WarpDemuX checkout's "
             "test_data/live_balancing)",
    )
    ap.add_argument(
        "--real-max-adapter", type=int, default=0,
        help="label real reads with this max_obs_adapter bound (0 = the "
             "contract default 6000; 9000 recovers the long-adapter "
             "population as extra training labels)",
    )
    ap.add_argument(
        "--wide", action="store_true",
        help="ARCH_WIDE: dilations to 32 (~3.8k-sample receptive field)",
    )
    ap.add_argument(
        "--input-cap", type=int, default=7168,
        help="train with the production prefix cap (DetectConfig."
             "cnn_input_cap): input zeroed, validity and labels masked past "
             "the cap. 0 = full-window (legacy v1-v3 weights)",
    )
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="torch device of the run (default: the CUDA GPU)")
    return ap


def main(argv=None):
    """Train, write the bundle, print the eval line; returns (params, History)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.real_frac > 0 and not args.fixture_dir:
        ap.error("--real-frac needs --fixture-dir")
    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    real = None
    if args.real_frac > 0:
        real = load_real_labeled(
            args.fixture_dir, max_obs_adapter=args.real_max_adapter or None, device=device
        )
        print(f"loaded {len(real[0])} LLR-labeled real reads")
    params = cnn.init_params(rng, cnn.ARCH_WIDE if args.wide else cnn.ARCH, device)
    history = train(params, rng, args.steps, args.batch, args.lr, args.input_cap, real, args.real_frac)
    out = config_utils.CNN_DIR / f"{args.out}.npz"
    out.parent.mkdir(parents=True, exist_ok=True)
    cnn.save_params(params, out)
    print(f"saved {out}")
    print(evaluate(params, rng, args.input_cap))
    return params, history


if __name__ == "__main__":
    main()
