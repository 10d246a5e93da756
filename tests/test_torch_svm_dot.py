"""The SVM's float32 arithmetic in XLA:CPU's order (ops/numerics.py
`xla_dot`, `xla_exp`; ops/svm.py `decision_values`, `probabilities`)
against the *jitted* JAX functions, bit for bit.

`xla_dot` reproduces the order XLA:CPU sums a (B, N) x (N, P) dot in at
the shapes `xla_dot_order` knows (four interleaved FMA chains, or one FMA
chain over blocks of k); the Wu-Lin coupling takes the jitted function's
FMAs and sums, and XLA's Cephes exp. These orders are those of the XLA
build that jax 0.9.0 carries on an x86 host with AVX-512; where this host's
XLA sums the pinned probe in another order, the tests skip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpdemux_tpu.models.registry import load_model as jax_load_model
from warpdemux_tpu.ops import svm as jax_svm
from warpdemux_tpu_torch.models.registry import load_model
from warpdemux_tpu_torch.ops import numerics, svm

jit_dot = jax.jit(jnp.dot)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Several test workers share this host's cores, and the emulated
    products' many small operations gain nothing from more threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _operands(B, N, P, seed):
    rng = np.random.default_rng(seed)
    K = np.exp(-rng.uniform(0, 8, (B, N))).astype(np.float32)
    C = rng.normal(size=(N, P)).astype(np.float32)
    return K, C


def _port_dot(K, C):
    return numerics.xla_dot(torch.from_numpy(K), torch.from_numpy(C)).numpy()


@pytest.fixture(scope="module")
def xla_order_host():
    """Skips unless this host's jitted dot sums the pinned probes (the
    lanes at (2, 851) x (851, 10), the chain at (16, 851) x (851, 21)) as
    recorded."""
    for B, P in ((2, 10), (16, 21)):
        K, C = _operands(B, 851, P, 0)
        if not np.array_equal(_bits(jit_dot(K, C)), _bits(_port_dot(K, C))):
            pytest.skip("this host's XLA:CPU sums the dot in another order")


@pytest.mark.parametrize("P", [6, 10, 16])
@pytest.mark.parametrize("N", [495, 713, 851])
@pytest.mark.parametrize("B", [2, 16, 32, 65, 1000])
def test_xla_dot_equals_the_jitted_dot(xla_order_host, B, N, P):
    K, C = _operands(B, N, P, B * 7 + N + P)
    assert numerics.xla_dot_order(B, N, P) == (numerics.LANES, N)
    np.testing.assert_array_equal(_bits(_port_dot(K, C)), _bits(jit_dot(K, C)))


@pytest.mark.parametrize(
    "B, N, P",
    [(16, 1368, 21), (50, 1414, 21), (51, 1368, 21), (1000, 1368, 21), (51, 2601, 55), (200, 2968, 55)],
)
def test_xla_dot_equals_the_jitted_dot_beyond_sixteen_pairs(xla_order_host, B, N, P):
    """Seven classes (P = 21: one chain below 51 rows, the four lanes from
    51 on), eleven classes from 51 rows (one chain a block of 512 terms)."""
    K, C = _operands(B, N, P, B + N + P)
    np.testing.assert_array_equal(_bits(_port_dot(K, C)), _bits(jit_dot(K, C)))


def _summed_in(K, C, mode, kc):
    """K C summed in K12's order `mode` (lanes or chain blocks of kc), term
    by term with `numerics.fma`: the reference `xla_dot` is held to."""
    B, N = K.shape
    P = C.shape[1]
    if mode == numerics.CHAIN:
        out = K.new_zeros((B, P))
        for lo in range(0, N, kc):
            acc = K.new_zeros((B, P))
            for k in range(lo, min(N, lo + kc)):
                acc = numerics.fma(K[:, k, None].expand(B, P), C[k].expand(B, P), acc)
            out = out + acc
        return out
    m = N - N % 4
    lanes = [K.new_zeros((B, P)) for _ in range(4)]
    for k in range(m):
        lanes[k % 4] = numerics.fma(K[:, k, None].expand(B, P), C[k].expand(B, P), lanes[k % 4])
    tail = K.new_zeros((B, P))
    for k in range(m, N):
        tail = tail + K[:, k, None] * C[k]
    return ((lanes[0] + lanes[1]) + (lanes[2] + lanes[3])) + tail


@pytest.mark.parametrize("B, P", [(1, 10), (16, 36), (1000, 78), (50, 55), (32, 100)])
def test_unsolved_shapes_keep_torch_matmul(B, P):
    """Where XLA's order was not found, xla_dot sums in one fixed order for
    the shape (XLA's at the same width for a full minibatch: chain blocks of
    512 for eleven classes; the lanes elsewhere), the order K12 takes there
    too, and the decision values take it. Its distance from the jitted dot
    is a float32 dot's rounding: within 8 float32 ulps of 1 times the sum
    of the terms' magnitudes, sum |K| |C| (the models' probabilities stay
    within rtol 1e-5, atol 1e-6 of JAX's, ROADMAP queue 3, item C:
    tests/test_torch_live_lane.py and test_torch_rna002.py)."""
    assert numerics.xla_dot_order(B, 851, P) is None
    order = numerics.dot_order(B, 851, P)
    assert order == ((numerics.CHAIN, 512) if P == 55 else (numerics.LANES, 851))
    K, C = _operands(B, 851, P, 3)
    got = _port_dot(K, C)
    Kt, Ct = torch.from_numpy(K), torch.from_numpy(C)
    np.testing.assert_array_equal(_bits(got), _bits(_summed_in(Kt, Ct, *order).numpy()))
    magnitude = np.abs(K).astype(np.float64) @ np.abs(C).astype(np.float64)
    assert (np.abs(got - np.asarray(jit_dot(K, C))) <= 8 * 2.0**-23 * magnitude).all()
    intercept = torch.from_numpy(np.random.default_rng(4).normal(size=P).astype(np.float32))
    params = svm.SVMParams(Ct, intercept, torch.zeros(P), torch.zeros(P), 0)
    np.testing.assert_array_equal(_bits(svm.decision_values(Kt, params).numpy()),
                                  _bits(got + intercept.numpy()))


def test_xla_exp_equals_the_jitted_exp():
    rng = np.random.default_rng(1)
    x = np.concatenate([
        -rng.uniform(0, 8, 100000), -rng.uniform(0, 90, 50000), rng.uniform(-20, 20, 50000),
        [0.0, -0.0, 1e-40, -1e-40, np.inf, -np.inf, np.nan, 88.7, 88.8, 89.0, -87.33, -87.34, -87.8, -104.0],
    ]).astype(np.float32)
    got = numerics.xla_exp(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jnp.exp)(x))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("name", ["WDX4_rna004_v1_0", "WDX4_tRNA_rna004_v1_0", "WDX6_rna004_v1_0"])
@pytest.mark.parametrize("B", [2, 16, 65, 1000])
def test_probabilities_equal_the_jitted_jax_svm(xla_order_host, name, B):
    """Kernel values, decision values and probabilities of the shipped
    five- and seven-class models on distances from a seed, against
    jax.jit of the JAX package's functions."""
    jm, tm = jax_load_model(name), load_model(name, "cpu")
    N = tm.coef.shape[0]
    D = np.random.default_rng(B).uniform(0, 8, (B, N)).astype(np.float32)

    def jax_side(D):
        K = jax_svm.pdist_kernel(D, jm.gamma, jm.pwr_dist)
        return K, jax_svm.decision_values(K, jm.params), jax_svm.predict_proba(K, jm.params)

    want = [np.asarray(a) for a in jax.jit(jax_side)(D)]
    K = svm.pdist_kernel(torch.from_numpy(D), tm.gamma, tm.pwr_dist)
    got = [K.numpy(), svm.decision_values(K, tm.params).numpy(), svm.predict_proba(K, tm.params).numpy()]
    for what, g, w in zip(("kernel", "decision values", "probabilities"), got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=what)


@pytest.mark.parametrize("B", [1, 2, 4, 8, 9, 12, 16, 19, 20, 23, 33, 47, 48, 52, 63, 65, 100, 257])
def test_probabilities_equal_the_jitted_coupling_at_every_batch_shape(xla_order_host, B):
    """The rows that the jitted coupling sums p Q p for in vectors, and
    those of its scalar loop (an FMA chain), at batch sizes on both sides
    of each switch of `xla_vector_rows`: decision values from a seed."""
    k, P = 5, 10
    rng = np.random.default_rng(B)
    dec = rng.normal(0, 3, (B, P)).astype(np.float32)
    A, Bp = rng.normal(-2, 0.5, P).astype(np.float32), rng.normal(0, 0.3, P).astype(np.float32)
    params = svm.SVMParams(None, None, torch.from_numpy(A), torch.from_numpy(Bp), k)
    jparams = jax_svm.SVMParams(None, None, A, Bp, k)

    def jax_side(dec):
        rp = jnp.clip(jax_svm.sigmoid_predict(dec, jparams.probA, jparams.probB), 1e-7, 1 - 1e-7)
        pairs = jax_svm.pair_index(k)
        i, j = np.array([a for a, _ in pairs]), np.array([b for _, b in pairs])
        r = jnp.zeros((B, k, k), rp.dtype).at[:, i, j].set(rp).at[:, j, i].set(1.0 - rp)
        return jax_svm.multiclass_probability(r, k)

    want = np.asarray(jax.jit(jax_side)(dec))
    np.testing.assert_array_equal(_bits(svm.probabilities(torch.from_numpy(dec), params).numpy()), _bits(want))


def test_the_rows_after_the_last_vector_take_the_fma_sum(xla_order_host, monkeypatch):
    """At B = 65 the 65th row runs the scalar loop: summed as the vector
    rows are, it moves, and the others do not."""
    jm, tm = jax_load_model("WDX4_rna004_v1_0"), load_model("WDX4_rna004_v1_0", "cpu")
    rng = np.random.default_rng(0)
    K = np.exp(-rng.uniform(0, 8, (65, 851))).astype(np.float32)
    want = np.asarray(jax.jit(lambda K: jax_svm.predict_proba(K, jm.params))(K))
    got = svm.predict_proba(torch.from_numpy(K), tm.params).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    monkeypatch.setattr(svm, "xla_vector_rows", lambda B: B)
    moved = svm.predict_proba(torch.from_numpy(K), tm.params).numpy()
    assert not np.array_equal(_bits(moved[64]), _bits(want[64]))
    np.testing.assert_array_equal(_bits(moved[:64]), _bits(want[:64]))
