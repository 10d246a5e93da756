"""Synthetic RNA004-style squiggles with known boundaries (numpy only).

Copy of warpdemux_tpu/utils/synthetic.py: the same generators draw the
same numbers from the same numpy Generator, so a seed gives the JAX
package's reads. The tRNA generators build the reads that chip_smoke.py
drives through the tRNA step on a machine without JAX.
"""

import numpy as np


def synth_read(
    rng,
    adapter_len=4000,
    polya_len=2000,
    rna_len=8000,
    adapter_level=75.0,
    polya_level=105.0,
    rna_level=95.0,
    open_pore_len=0,
    event_len=(15, 60),
    noise=1.8,
    adapter_spread=12.0,
):
    """Returns (signal_pa f32, truth dict)."""
    parts = []
    if open_pore_len:
        parts.append(np.full(open_pore_len, 220.0) + rng.normal(0, 2, open_pore_len))
    def events(total, level, spread):
        seg = []
        while sum(map(len, seg)) < total:
            seg.append(np.full(rng.integers(*event_len), level + rng.normal(0, spread)))
        return np.concatenate(seg)[:total] if seg else np.zeros(0)

    # adapter: event-structured, wide level range (high variance region)
    if adapter_len:
        parts.append(events(adapter_len, adapter_level, adapter_spread))
    # polyA: flat elevated
    if polya_len:
        parts.append(np.full(polya_len, polya_level) + rng.normal(0, 1.0, polya_len))
    # RNA: event-structured around rna_level
    if rna_len:
        parts.append(events(rna_len, rna_level, 14))
    sig = np.concatenate(parts).astype(np.float32)
    sig += rng.normal(0, noise, sig.size).astype(np.float32)
    a0 = open_pore_len
    truth = dict(
        adapter_start=a0,
        adapter_end=a0 + adapter_len,
        polya_start=a0 + adapter_len,
        polya_end=a0 + adapter_len + polya_len,
    )
    return sig, truth


def synth_trna_read(
    rng,
    adapter_len=3000,
    polya_len=0,
    trna_len=2500,
    spike_idx=300,
    spike_height=110.0,
    adapter_level=68.0,
    polya_level=100.0,
    trna_level=92.0,
    noise=1.8,
    adapter_spread=4.0,
):
    """tRNA-style read: capture spike near the head, adapter, optional short
    polyA, structured tRNA body. The adapter stays below the
    min_start_peak_pa spike threshold (83 pA), as real RNA004 adapters do.
    Returns (signal f32, truth dict)."""
    sig, truth = synth_read(
        rng,
        adapter_len=adapter_len,
        polya_len=polya_len,
        rna_len=trna_len,
        adapter_level=adapter_level,
        polya_level=polya_level,
        rna_level=trna_level,
        noise=noise,
        adapter_spread=adapter_spread,
    )
    if spike_idx is not None:
        w = 40
        s = max(0, spike_idx - w // 2)
        sig[s : s + w] = spike_height + rng.normal(0, 2, min(w, sig.size - s))
        truth["spike_idx"] = spike_idx
    return sig, truth


def synth_batch(rng, B, L=10000, **kw):
    """(signals (B, L) float32, lengths (B,) int32, truths): B mRNA reads
    of synth_read with adapters of 2,500-5,499 and poly(A) tails of
    500-2,999 samples, cut at L and zero-padded."""
    sigs = np.zeros((B, L), np.float32)
    lens = np.zeros(B, np.int32)
    truths = []
    for b in range(B):
        adapter_len = int(rng.integers(2500, 5500))
        polya_len = int(rng.integers(500, 3000))
        sig, truth = synth_read(rng, adapter_len=adapter_len, polya_len=polya_len, **kw)
        n = min(L, sig.size)
        sigs[b, :n] = sig[:n]
        lens[b] = n
        truths.append(truth)
    return sigs, lens, truths


def trna_barcode_patterns(n_barcodes=4, n_events=30, seed=77):
    """Fixed per-barcode z-score event patterns for synthetic tRNA reads.

    Stand-in barcode signatures: the real WDX tRNA barcode squiggles are
    not part of the repository."""
    rng = np.random.default_rng(seed)
    return rng.normal(0.0, 1.0, size=(n_barcodes, n_events)).astype(
        np.float32
    )


# Adapter statistics of real RNA004 reads' detected adapters (the JAX
# package's tools/validate_boundaries.py detections): per-event dwell is heavy-tailed
# log-normal (median 24 samples, p5/p95 = 6/107 -> sigma_ln ~ 0.91);
# per-read adapter level ~ N(74.1, 4.0) pA; per-event spread (MAD)
# ~ N(9.2, 1.6) pA; within-event pore noise ~ N(1.84, 0.18) pA.
REAL_ADAPTER_STATS = dict(
    dwell_ln_mu=3.18,
    dwell_ln_sigma=0.91,
    dwell_clip=(4, 200),
    level_mean=74.1,
    level_sd=4.0,
    spread_mean=9.2,
    spread_sd=1.6,
    noise_mean=1.84,
    noise_sd=0.18,
)


def real_dwell_sampler(stats=None):
    """Per-event dwell sampler fitted to the real adapter dwell
    distribution (log-normal; REAL_ADAPTER_STATS). Pass as the `dwell`
    argument of synth_trna_barcoded_read."""
    s = stats or REAL_ADAPTER_STATS

    def draw(rng):
        d = int(round(np.exp(rng.normal(s["dwell_ln_mu"], s["dwell_ln_sigma"]))))
        return int(np.clip(d, *s["dwell_clip"]))

    return draw


def synth_trna_barcoded_read(
    rng,
    barcode_z,
    spike_idx=300,
    spike_height=110.0,
    adapter_mean=68.0,
    adapter_sd=7.0,
    dwell=(18, 32),
    polya_len=600,
    trna_len=2500,
    noise=1.6,
):
    """tRNA read whose adapter = capture spike -> consensus-shaped event
    sequence -> barcode event sequence -> short polyA -> tRNA body.

    The consensus section realizes the 82-event RNA004 consensus query
    (models/consensus_data.py) scaled into pA so the subsequence-DTW
    refinement (ops/fingerprint.fingerprints_consensus_refined) locates the barcode start; `barcode_z` is the
    per-barcode z-score event pattern realized after it.
    """
    from warpdemux_tpu_torch.models.consensus_data import CONSENSUS

    cons = np.asarray(CONSENSUS["rna004_130bps_v1_0"], np.float64)

    draw_dwell = dwell if callable(dwell) else (
        lambda r: int(r.integers(*dwell))
    )

    def render(z_events):
        segs = [
            np.full(draw_dwell(rng), adapter_mean + adapter_sd * z)
            for z in z_events
        ]
        return np.concatenate(segs)

    head = np.full(spike_idx - 20, adapter_mean) + rng.normal(
        0, 2, spike_idx - 20
    )
    spike = spike_height + rng.normal(0, 2, 40)
    lead_in = np.full(80, adapter_mean) + rng.normal(0, 2, 80)
    adapter = np.concatenate(
        [render(cons), render(np.asarray(barcode_z, np.float64))]
    )
    polya = np.full(polya_len, adapter_mean * 1.45) + rng.normal(
        0, 1.0, polya_len
    )
    body_ev = []
    while sum(map(len, body_ev)) < trna_len:
        body_ev.append(
            np.full(rng.integers(15, 60), 92.0 + rng.normal(0, 10))
        )
    body = np.concatenate(body_ev)[:trna_len]
    sig = np.concatenate([head, spike, lead_in, adapter, polya, body])
    sig = (sig + rng.normal(0, noise, sig.size)).astype(np.float32)
    truth = dict(
        spike_idx=spike_idx,
        adapter_start=spike_idx + 100,
        adapter_end=spike_idx + 100 + adapter.size,
        polya_len=polya_len,
    )
    return sig, truth
