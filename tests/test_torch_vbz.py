"""Port parity: the VBZ inner-layout decode and its numpy wire helpers
against the JAX package (tests/test_vbz_device.py's inputs). Integer
arithmetic throughout: exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from warpdemux_tpu.ops import vbz_device as jax_vbz
from warpdemux_tpu_torch.ops import vbz_device as vbz


def _walks(rng, B, n, step):
    """Random walks with deltas up to `step`, kept inside int16."""
    return [
        np.clip(np.cumsum(rng.integers(-step, step, size=n)), -30000, 30000).astype(np.int16)
        for _ in range(B)
    ]


@pytest.mark.parametrize("B, n, step", [(5, 4096, 120), (3, 10000, 2000)])
def test_decode_matches_jax_and_the_source(B, n, step):
    sigs = _walks(np.random.default_rng(n), B, n, step)
    bodies = [vbz.inner_layout_from_adc(s) for s in sigs]
    width = max(len(b) - (n + 7) // 8 for b in bodies) + 16
    keys, data = vbz.pack_inner_host(bodies, n, width)
    got = vbz.vbz_decode_batch(torch.from_numpy(keys), torch.from_numpy(data), n)
    assert got.dtype == torch.int32
    want = np.asarray(jax_vbz.vbz_decode_batch(jnp.asarray(keys), jnp.asarray(data), n))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().astype(np.int16), np.stack(sigs))


def test_decode_wide_values():
    """Deltas crossing the 1-byte / 2-byte split in both directions."""
    sig = np.array([0, 1, 200, 100, -2000, -2001, 2047], np.int16)
    body = vbz.inner_layout_from_adc(sig)
    keys, data = vbz.pack_inner_host([body], sig.size, len(body))
    got = vbz.vbz_decode_batch(torch.from_numpy(keys), torch.from_numpy(data), sig.size)
    np.testing.assert_array_equal(got.numpy()[0].astype(np.int16), sig)
    want = jax_vbz.vbz_decode_batch(jnp.asarray(keys), jnp.asarray(data), sig.size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_host_helpers_are_byte_identical_to_jax():
    rng = np.random.default_rng(3)
    sigs = _walks(rng, 6, 1003, 400)  # n not a multiple of 8
    for s in sigs:
        assert vbz.inner_layout_from_adc(s) == jax_vbz.inner_layout_from_adc(s)
    bodies = [vbz.inner_layout_from_adc(s) for s in sigs] + [None]
    for width in (900, 4000):  # truncating and padding
        got = vbz.pack_inner_host(bodies, 1003, width)
        want = jax_vbz.pack_inner_host(bodies, 1003, width)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        vbz.inner_layout_from_adc(np.array([-32768, 32767], np.int16))
