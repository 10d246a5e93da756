"""The port's native host codec (warpdemux_tpu_torch/native): the twin of
tests/test_native.py's codec tests, and the port's library against the JAX
package's on the same inputs.

- VBZ round trip; native against the port's numpy codec at n = 1, 7, 8,
  100, 9999 and 65536 (both directions); the payloads each package's
  encoder writes decode to the same samples in the other's decoder, and
  the encoders write the same bytes;
- the library is built under build/native/ and nowhere in a package.

Skipped only where g++ or zstd.h is missing.
"""

import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from warpdemux_tpu_torch import native  # noqa: E402
from warpdemux_tpu_torch.io import vbz  # noqa: E402

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None or not Path("/usr/include/zstd.h").exists(),
    reason="no g++ or zstd.h",
)


def signal(seed, n, step=200):
    """A random walk of n int16 samples, held inside the int16 range (a
    wrapped sample would make a delta the codec cannot hold)."""
    walk = np.cumsum(np.random.default_rng(seed).integers(-step, step, size=n))
    return np.clip(walk, -32768, 32767).astype(np.int16)


def numpy_decode(payload, n):
    """The port's numpy decode path (io/vbz.decode without the library)."""
    import zstandard

    raw = zstandard.ZstdDecompressor().decompress(payload, max_output_size=4 * n + 16)
    keylen = (n + 7) // 8
    keys = np.frombuffer(raw, np.uint8, count=keylen)
    data = np.frombuffer(raw, np.uint8, offset=keylen)
    bits = np.unpackbits(keys, bitorder="little", count=n)
    offs = np.concatenate([[0], np.cumsum(bits.astype(np.int64) + 1)[:-1]])
    lo = data[offs].astype(np.int32)
    hi = np.where(bits == 1, data[np.minimum(offs + 1, len(data) - 1)].astype(np.int32), 0)
    vals = lo | (hi << 8)
    return np.cumsum((vals >> 1) ^ -(vals & 1), dtype=np.int32).astype(np.int16)


def test_library_builds_under_build_native_only():
    assert native.available()
    path = native.library_path()
    assert path.exists()
    assert path.parent == REPO / "build" / "native"
    assert path.name.startswith("libwdx_native-") and path.suffix == ".so"
    assert not list((REPO / "warpdemux_tpu_torch").rglob("*.so"))
    # the JAX package's library is never the one loaded
    assert str(REPO / "warpdemux_tpu" / "native") not in str(native._lib._name)
    assert Path(native._lib._name) == path


def test_vbz_roundtrip_native():
    sig = signal(0, 5000, 40)
    np.testing.assert_array_equal(native.vbz_decode(native.vbz_encode(sig), sig.size), sig)


@pytest.mark.parametrize("n", [1, 7, 8, 100, 9999, 65536])
def test_vbz_native_matches_numpy_codec(n):
    sig = signal(1 + n, n)
    # the port's numpy encode -> native decode
    np.testing.assert_array_equal(native.vbz_decode(vbz.encode(sig), n), sig)
    # native encode -> the numpy decode path
    np.testing.assert_array_equal(numpy_decode(native.vbz_encode(sig), n), sig)
    # io/vbz.decode (native) of the numpy encoder's payload
    np.testing.assert_array_equal(vbz.decode(vbz.encode(sig), n), sig)


@pytest.mark.parametrize("n", [1, 7, 8, 100, 9999, 65536])
def test_vbz_native_matches_the_jax_packages_native(n):
    from warpdemux_tpu import native as jax_native

    if not jax_native.available():
        pytest.skip("the JAX package's native library does not build here")
    sig = signal(2 + n, n)
    assert native.vbz_encode(sig) == jax_native.vbz_encode(sig)
    for payload in (native.vbz_encode(sig), jax_native.vbz_encode(sig), vbz.encode(sig)):
        got, want = native.vbz_decode(payload, n), jax_native.vbz_decode(payload, n)
        assert got.dtype == want.dtype == np.int16
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="vbz_decode failed"):
        native.vbz_decode(b"not a zstd frame", n)

