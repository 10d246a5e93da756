"""Port parity: the packed step-output layout (pipeline/schema.PackSchema)
equals the JAX package's, and pack / unpack round-trip."""

import numpy as np
import pytest
import torch

from warpdemux_tpu.pipeline import schema as jax_schema
from warpdemux_tpu_torch.pipeline import schema


@pytest.mark.parametrize("k, kc", [(25, 5), (25, 1), (40, 11)])
def test_layout_matches_jax(k, kc):
    got, want = schema.PackSchema(k, kc), jax_schema.PackSchema(k, kc)
    assert schema.INT_COLS == jax_schema.INT_COLS
    assert schema.FLOAT_COLS == jax_schema.FLOAT_COLS
    for attr in ("int_spec", "float_spec", "int_slices", "float_slices", "int_width", "float_width"):
        assert getattr(got, attr) == getattr(want, attr), attr
    bi, bf = np.zeros((2, got.int_width), np.int32), np.zeros((2, got.float_width), np.float32)
    back = schema.PackSchema.from_buffers(bi, bf)
    assert (back.k, back.kc) == (k, kc)


def test_pack_unpack_round_trip():
    s = schema.PackSchema(k=25, kc=5)
    rng = np.random.default_rng(0)
    B = 7
    ints = {n: torch.from_numpy(rng.integers(-9, 9, (B,) if w == 1 else (B, w)).astype(np.int32))
            for n, w in s.int_spec}
    ints["fpt_ok"] = ints["fpt_ok"] > 0  # bools pack as 0/1
    floats = {n: torch.from_numpy(rng.normal(0, 1, (B,) if w == 1 else (B, w)).astype(np.float32))
              for n, w in s.float_spec}
    floats["adapter_med"] = floats["adapter_med"][:, None]  # (B, 1) scalars pack too
    big_i, big_f = s.pack(ints, torch.int32), s.pack(floats, torch.float32)
    assert big_i.shape == (B, s.int_width) and big_f.dtype == torch.float32
    ci, cf = s.unpack(big_i.numpy(), np.int32), s.unpack(big_f.numpy(), np.float32)
    for cols, vals, dtype in ((ci, ints, np.int32), (cf, floats, np.float32)):
        for n, v in vals.items():
            want = v.numpy().astype(dtype).reshape(cols[n].shape)
            np.testing.assert_array_equal(cols[n], want, err_msg=n)
    with pytest.raises(ValueError):
        s.pack({**ints, "dwell": ints["dwell"][:, :3]}, torch.int32)
    with pytest.raises(ValueError):
        s.unpack(big_i.numpy()[:, 1:], np.int32)
