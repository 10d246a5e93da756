"""The port's multi-process helpers (parallel/multihost.py) in one process:
the twins of tests/test_multihost.py, each also held against the JAX
function on the same input."""

import numpy as np
import pytest

from warpdemux_tpu.parallel import multihost as jax_mh
from warpdemux_tpu_torch.parallel import multihost as mh


def test_shard_files_partition():
    files = [f"f{i}.pod5" for i in range(10)]
    shards = [mh.shard_files(files, pi, 3) for pi in range(3)]
    # disjoint, complete, deterministic
    assert sorted(f for s in shards for f in s) == sorted(files)
    assert len(set(map(tuple, shards))) == 3
    assert shards == [jax_mh.shard_files(files, pi, 3) for pi in range(3)]
    # one process: every file
    assert mh.shard_files(files) == files == jax_mh.shard_files(files)


@pytest.mark.parametrize("pi", [0, 7, 42])
def test_host_shard_tag(pi):
    assert mh.host_shard_tag(pi) == f"h{pi:03d}" == jax_mh.host_shard_tag(pi)


def test_host_shard_tag_of_this_process():
    assert mh.host_shard_tag() == "h000" == jax_mh.host_shard_tag()


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_global_counts_single_process_identity(dtype):
    c = np.array([5, 3, 2, 0, 1], dtype)
    out = mh.global_class_counts(c)
    assert out.dtype == c.dtype
    np.testing.assert_array_equal(out, c)
    np.testing.assert_array_equal(out, jax_mh.global_class_counts(c))


def test_init_distributed_single_host():
    assert mh.init_distributed() == (0, 1) == jax_mh.init_distributed()
    assert mh.init_distributed(None, 4, 2) == (0, 1)
