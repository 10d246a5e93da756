"""Port parity: the live lane's streaming gates (detect/streaming.py) equal
the JAX package's exactly: the poly(A) start at every chunk prefix a
replay client delivers, the real-range verdict on every adapter region
found, and the edge lengths of the detector."""

import numpy as np
import pytest

from warpdemux_tpu.detect import streaming as jax_streaming
from warpdemux_tpu.live.dummy import synth_live_read
from warpdemux_tpu_torch.detect import streaming

CHUNK = 1500  # DummyClient's chunk_size in the live tests


@pytest.fixture(scope="module")
def reads():
    rng = np.random.default_rng(11)
    return [synth_live_read(rng) for _ in range(200)]


@pytest.mark.parametrize("part", range(4))
def test_polya_detect_and_real_range_equal_jax_at_every_chunk_prefix(reads, part):
    cfg, jcfg = streaming.StreamingConfig(), jax_streaming.StreamingConfig()
    rr, jrr = streaming.RealRangeConfig(), jax_streaming.RealRangeConfig()
    found = 0
    for sig in reads[part::4]:
        for end in range(CHUNK, sig.size + CHUNK, CHUNK):
            prefix = sig[:end]
            loc = streaming.mean_var_shift_polya_detect(prefix, cfg)
            assert loc == jax_streaming.mean_var_shift_polya_detect(prefix, jcfg)
            if loc:
                found += 1
                assert streaming.real_range_check(prefix[:loc], rr) == jax_streaming.real_range_check(
                    prefix[:loc], jrr
                )
    assert found > 0


@pytest.mark.parametrize("n", [0, 1, 1599, 1600, 1601, 1799, 1800, 1801, 2000])
def test_polya_detect_at_edge_lengths(n):
    """Below min_obs_adapter + min_obs_polya, at it, and past the window and
    post-location minimums."""
    sig = synth_live_read(np.random.default_rng(n), adapter_len=1500, polya_len=2000)[:n]
    cfg = streaming.StreamingConfig()
    got = streaming.mean_var_shift_polya_detect(sig, cfg)
    assert got == jax_streaming.mean_var_shift_polya_detect(sig, jax_streaming.StreamingConfig())
    if n < cfg.min_obs_adapter + cfg.min_obs_polya:
        assert got == 0


@pytest.mark.parametrize(
    "name, sig",
    [
        ("no candidate: flat below the threshold", np.full(8000, 80.0, np.float32)),
        ("candidates too noisy", np.r_[np.full(2000, 80.0), 104 + 20 * np.random.default_rng(0).normal(size=6000)]),
        ("a run shorter than min_obs_polya", np.r_[np.full(2000, 80.0), np.full(250, 110.0), np.full(6000, 80.0)]),
        ("a run at the very end", np.r_[np.full(7700, 80.0), np.full(300, 110.0)]),
    ],
)
def test_polya_detect_without_a_candidate_run(name, sig):
    sig = np.asarray(sig, np.float32)
    cfg = streaming.StreamingConfig()
    assert streaming.mean_var_shift_polya_detect(sig, cfg) == jax_streaming.mean_var_shift_polya_detect(
        sig, jax_streaming.StreamingConfig()
    )


@pytest.mark.parametrize("n", [0, 299, 300, 319, 320, 5000, 9000])
def test_real_range_check_at_edge_lengths(n):
    sig = synth_live_read(np.random.default_rng(n + 1), adapter_len=9000)[:n]
    for s in (sig, np.full(n, 80.0, np.float32)):
        assert streaming.real_range_check(s, streaming.RealRangeConfig()) == jax_streaming.real_range_check(
            s, jax_streaming.RealRangeConfig()
        )
