"""Port parity: the two callers of the window gather that no longer copy the
signal for it, against their JAX counterparts, exactly.

- `extract_adapter_batch` (ops/fingerprint.py): the JAX function gathers
  from a zero-padded copy of the signal and masks the result; the port's
  gather zero-fills by the lengths.
- `_llr_refine` (detect/boundaries.py): the JAX function refines one
  boundary a call; the port reads the K windows of a read from its one
  signal in one call.
"""

import jax
import numpy as np
import pytest
import torch

from warpdemux_tpu.detect.boundaries import _llr_refine as jax_llr_refine
from warpdemux_tpu.ops.fingerprint import extract_adapter_batch as jax_extract
from warpdemux_tpu_torch.detect import boundaries as bd
from warpdemux_tpu_torch.ops import fingerprint


@pytest.mark.parametrize("L, buffer_len, padding", [(10000, 6272, 50), (3000, 640, 0), (500, 640, 20)])
def test_extract_adapter_batch_equals_jax(L, buffer_len, padding):
    rng = np.random.default_rng(L)
    B = 12
    x = rng.normal(80, 12, (B, L)).astype(np.float32)
    in_lens = rng.integers(L // 2, L + 1, B).astype(np.int32)
    start = rng.integers(0, L // 2, B).astype(np.int32)
    end = start + rng.integers(-10, L, B).astype(np.int32)
    start[0], end[0] = 0, L  # the whole read
    start[1], end[1] = 5, 5  # empty
    in_lens[2] = L
    end[2] = L + 100  # past the read
    t = torch.from_numpy
    got, got_len = fingerprint.extract_adapter_batch(t(x), t(in_lens), t(start), t(end), padding, buffer_len)
    want, want_len = jax_extract(x, in_lens, start, end, padding, buffer_len)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (B, buffer_len) and got_len.dtype == torch.int32


def test_extract_adapter_batch_makes_no_padded_copy(monkeypatch):
    """One gather on the signal itself, with the lengths."""
    calls = []

    def spy(x, starts, out_len, lengths=None):
        calls.append((x.shape, out_len, lengths is not None))
        return torch.zeros((starts.shape[0], out_len))

    monkeypatch.setattr(fingerprint, "shift_rows", spy)
    x = torch.zeros((3, 1000))
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)
    fingerprint.extract_adapter_batch(x, i32([1000] * 3), i32([10, 20, 30]), i32([500] * 3), 50, 640)
    assert calls == [((3, 1000), 640, True)]


@pytest.mark.parametrize("K", [1, 2])
def test_llr_refine_equals_jax(K):
    rng = np.random.default_rng(7 + K)
    B, L, radius = 9, 4000, 400
    x = rng.normal(90, 6, (B, L)).astype(np.float32)
    steps = rng.integers(300, L - 300, (K, B))
    for k in range(K):
        for b in range(B):
            x[b, steps[k, b]:] += 12.0 * (k + 1)
    coarse = (steps + rng.integers(-150, 150, (K, B))).astype(np.int32)
    coarse[0, 0], coarse[-1, 1] = 3, L - 2  # windows moved inside the row
    got = bd._llr_refine(torch.from_numpy(x), torch.from_numpy(coarse), radius).numpy()
    refine = jax.jit(jax_llr_refine, static_argnums=2)
    for k in range(K):
        want = np.asarray(refine(x, coarse[k], radius, 0, L))
        np.testing.assert_array_equal(got[k], want)


def test_llr_refine_reads_the_one_signal(monkeypatch):
    """K * B starts against the (B, L) signal: no repeated copy."""
    seen = []
    real = bd.shift_rows

    def spy(x, starts, out_len, lengths=None):
        seen.append((tuple(x.shape), tuple(starts.shape)))
        return real(x, starts, out_len, lengths)

    monkeypatch.setattr(bd, "shift_rows", spy)
    x = torch.from_numpy(np.random.default_rng(0).normal(90, 6, (5, 2000)).astype(np.float32))
    coarse = torch.tensor([[500] * 5, [1500] * 5], dtype=torch.int32)
    out = bd._llr_refine(x, coarse, 400)
    assert seen == [((5, 2000), (10,))] and out.shape == (2, 5)
