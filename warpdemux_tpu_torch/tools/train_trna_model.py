"""Train the stand-in tRNA classification model.

Port of tools/train_trna_model.py. The reference registers two tRNA models
(WDX4_tRNA / WDX4b_tRNA) whose joblib artifacts are missing upstream, so
the repository ships stand-ins of the form of every reference model:
SVC(kernel='precomputed', probability=True, class_weight='balanced',
random_state=9) over K = exp(-DTW) (window 15, penalty 0.1), fitted on the
consensus-refined fingerprints that the port's own tRNA prep step makes
from synthetic barcoded tRNA reads (utils/synthetic.
synth_trna_barcoded_read), plus a trained noise class.

The device half runs on the card: the prep step (make_demux_step without
a model, the pa feed, full outputs, in chunks of 128 reads) and the Gram
matrix (ops/dtw.dtw_distance_matrix, kernel K1). The SVC fit is
sklearn's, on the host. At its default arguments the trainer writes the
shipped WDX4_tRNA_rna004_v1_0.npz array for array, bit for bit.

Usage:
    python -m warpdemux_tpu_torch.tools.train_trna_model [--per-bc 150] [--out WDX4_tRNA_rna004_v1_0] [--device cpu]

Writes <model directory>/<out>.npz (models/registry.MODEL_DIR, read when
the trainer is called), then predicts two holdout families through
registry.load_model. The run goes on the CUDA GPU unless `--device` names
another, and raises without one. Needs sklearn.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from warpdemux_tpu_torch._cuda import resolve_device
from warpdemux_tpu_torch.utils.synthetic import (
    REAL_ADAPTER_STATS as RS,
    real_dwell_sampler,
    synth_trna_barcoded_read,
)

L = 10000
CHUNK = 128  # reads a prep step
# registry which_barcodes per model (models/model_files/config.toml)
MODEL_BARCODES = {
    "WDX4_tRNA_rna004_v1_0": [3, 4, 5, 7],
    "WDX4b_tRNA_rna004_v1_0": [4, 5, 7, 11],
}


def prep_step(name, device=None):
    """The tRNA prep step of model `name`'s chemistry: no model, the pa
    feed, full outputs, on `device`."""
    from warpdemux_tpu_torch.config.utils import get_model_spc_config
    from warpdemux_tpu_torch.pipeline.step import make_demux_step

    return make_demux_step(None, get_model_spc_config(name), with_predict=False, device=resolve_device(device))


def patterns(name):
    """The barcodes' event signatures of model `name`: a seed a model;
    WDX4 keeps the original seed 77 (tests/test_trna_demux_e2e.py
    regenerates its reads from it)."""
    from warpdemux_tpu_torch.utils.synthetic import trna_barcode_patterns

    return trna_barcode_patterns(
        n_barcodes=len(MODEL_BARCODES[name]), n_events=25, seed=77 + list(MODEL_BARCODES).index(name)
    )


def make_fingerprints(rng, per_bc, noise_n, step, pats, barcodes, family="real"):
    """Synthesize reads and run them through the prep step.

    `per_bc` reads of each of the `barcodes` (class i has signature
    pats[i]) and `noise_n` reads of a random signature (class
    len(barcodes)), shuffled, each drawn from
    family="real": per-read parameters drawn from the distributions
    measured on the 800 real fixture reads' detected adapters
    (utils/synthetic.REAL_ADAPTER_STATS: log-normal dwell, level
    N(74.1, 4.0), event MAD N(9.2, 1.6), pore noise N(1.84, 0.18)), or
    family="legacy": the hand-tuned generator of narrow uniform dwell
    18-32, the holdout family the model is not trained on.
    Returns (fingerprints (n, 25) float64 of the reads the step passed,
    their classes (n,) int64)."""
    sig_rows = []
    for ci in range(len(barcodes)):
        for _ in range(per_bc):
            sig_rows.append((pats[ci], ci))
    for _ in range(noise_n):
        sig_rows.append((rng.normal(0, 1, pats.shape[1]).astype(np.float32), len(barcodes)))
    rng.shuffle(sig_rows)

    if family == "real":
        dwell = real_dwell_sampler()

        def draw_params(r):
            return dict(
                adapter_mean=float(r.normal(RS["level_mean"], RS["level_sd"])),
                adapter_sd=float(np.clip(r.normal(RS["spread_mean"], RS["spread_sd"]), 5, 14)),
                noise=float(np.clip(r.normal(RS["noise_mean"], RS["noise_sd"]), 1.2, 2.5)),
                dwell=dwell,
            )

    else:  # legacy

        def draw_params(r):
            return dict(
                adapter_mean=float(r.normal(68, 2.5)),
                adapter_sd=float(r.uniform(6, 8.5)),
                noise=float(r.uniform(1.2, 2.2)),
            )

    fpts, labs = [], []
    for i in range(0, len(sig_rows), CHUNK):
        chunk = sig_rows[i : i + CHUNK]
        sigs = np.zeros((len(chunk), L), np.float32)
        lens = np.zeros(len(chunk), np.int32)
        for b, (pat, _lab) in enumerate(chunk):
            sig, _ = synth_trna_barcoded_read(rng, pat, **draw_params(rng))
            n = min(L, sig.size)
            sigs[b, :n] = sig[:n]
            lens[b] = n
        out = step(sigs, lens).unpack()
        ok = out.success
        fpts.append(out.fpt.fpt[ok].astype(np.float64))
        labs.extend(lab for (_p, lab), o in zip(chunk, ok) if o)
    return np.concatenate(fpts), np.asarray(labs, np.int64)


def gram_distances(X, device, window=15, penalty=0.1):
    """The float32 fingerprints' DTW distances to each other (K1 on the
    card), as float64 on the host."""
    from warpdemux_tpu_torch.ops.dtw import dtw_distance_matrix

    Xf = torch.as_tensor(X.astype(np.float32), device=device)
    return dtw_distance_matrix(Xf, Xf, window, penalty).cpu().numpy().astype(np.float64)


def build_parser():
    ap = argparse.ArgumentParser(description="Train the stand-in tRNA classification model.")
    ap.add_argument("--per-bc", type=int, default=150)
    ap.add_argument("--noise-n", type=int, default=120)
    ap.add_argument("--holdout-per-bc", type=int, default=30)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--out", default="WDX4_tRNA_rna004_v1_0", choices=tuple(MODEL_BARCODES))
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="torch device of the run (default: the CUDA GPU)")
    return ap


def main(argv=None):
    """Fit, write the bundle, predict the holdouts; returns the arrays."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    from sklearn.svm import SVC

    from warpdemux_tpu_torch.models import registry
    from warpdemux_tpu_torch.models.importer import arrays_from_svc

    barcodes = MODEL_BARCODES[args.out]
    rng = np.random.default_rng(args.seed)
    pats = patterns(args.out)
    step = prep_step(args.out, device)

    X, y = make_fingerprints(rng, args.per_bc, args.noise_n, step, pats, barcodes)
    print(f"training fingerprints: {X.shape}, labels {np.bincount(y)}")

    K = np.exp(-gram_distances(X, device))
    svc = SVC(
        kernel="precomputed",
        C=1.0,
        probability=True,
        class_weight="balanced",
        random_state=9,
    )
    svc.fit(K, y)

    label_mapper = {i: bc for i, bc in enumerate(barcodes)}
    label_mapper[len(barcodes)] = -1  # trained noise class
    arrays = arrays_from_svc(svc, X, label_mapper, thresholds=np.zeros(len(barcodes) + 1))
    arrays["model_type"] = np.str_("dtw_svm")
    # synthetic-trained replacement for a missing upstream blob: mark it so
    # load_model warns and users can't mistake it for published weights
    arrays["stand_in"] = np.array(True)
    out_path = registry.MODEL_DIR / f"{args.out}.npz"
    np.savez_compressed(out_path, **arrays)
    print(f"saved {out_path} (X_sv {arrays['X_sv'].shape})")

    # holdout through the full predict path, on both generator families:
    # "real" = the trained (measured) family, a fresh seed; "legacy" = the
    # hand-tuned family the model was not trained on
    model = registry.load_model(args.out, device)
    for family in ("real", "legacy"):
        Xh, yh = make_fingerprints(
            np.random.default_rng(args.seed + 1),
            args.holdout_per_bc,
            args.holdout_per_bc,
            step,
            pats,
            barcodes,
            family=family,
        )
        pred, conf, probs = model.predict(Xh.astype(np.float32))
        want = np.array([label_mapper[int(c)] for c in yh])
        acc = (pred == want).mean()
        bc_mask = yh < len(barcodes)
        print(
            f"holdout[{family}]: n={len(yh)} overall acc {acc:.3f}; "
            f"barcode reads {(pred[bc_mask] == want[bc_mask]).mean():.3f}; "
            f"noise recall {(pred[~bc_mask] == -1).mean():.3f}"
        )
    return arrays


if __name__ == "__main__":
    main()
