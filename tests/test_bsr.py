"""BSR block-format ops vs scipy (MXU-aligned dense tiles)."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from spla_tpu.formats import bsr_from_csr_host, csr_from_scipy
from spla_tpu.ops.bsr import bsr_spmm, bsr_spmv


@pytest.mark.parametrize("block", [32, 128])
def test_bsr_spmv(block):
    rng = np.random.default_rng(1)
    n = 500
    d = np.zeros((n, n), np.float32)
    for k in (-2, 0, 3):  # banded: block-friendly
        d += np.diag(rng.random(n - abs(k)).astype(np.float32), k)
    a = sp.csr_matrix(d)
    B = bsr_from_csr_host(csr_from_scipy(a), block=block)
    x = rng.random(n, dtype=np.float32)
    y = np.asarray(bsr_spmv(B, jnp.asarray(x)))
    # tolerance: f32 sums vs the float64 scipy reference; their order
    # differs (and changes from run to run under GPU atomics)
    np.testing.assert_allclose(y, d @ x, rtol=1e-4, atol=1e-5)


def test_bsr_spmv_random_sparse():
    a = sp.random(300, 260, density=0.05, random_state=3, dtype=np.float32)
    B = bsr_from_csr_host(csr_from_scipy(a), block=64)
    x = np.random.default_rng(3).random(260, dtype=np.float32)
    y = np.asarray(bsr_spmv(B, jnp.asarray(x)))
    # tolerance: f32 sums vs the float64 scipy reference; their order
    # differs (and changes from run to run under GPU atomics)
    np.testing.assert_allclose(y, a @ x, rtol=1e-4, atol=1e-5)


def test_bsr_spmm():
    a = sp.random(200, 150, density=0.08, random_state=5, dtype=np.float32)
    B = bsr_from_csr_host(csr_from_scipy(a), block=64)
    X = np.random.default_rng(5).random((150, 17), dtype=np.float32)
    Y = np.asarray(bsr_spmm(B, jnp.asarray(X)))
    # tolerance: f32 sums vs the float64 scipy reference; their order
    # differs (and changes from run to run under GPU atomics)
    np.testing.assert_allclose(Y, a @ X, rtol=1e-4, atol=1e-5)


def test_bsr_generalized_mul():
    a = sp.random(100, 100, density=0.1, random_state=6, dtype=np.float32)
    B = bsr_from_csr_host(csr_from_scipy(a), block=32)
    x = np.random.default_rng(6).random(100, dtype=np.float32)
    # op_mul = max(a, x) with PLUS accumulation over STORED entries only:
    # note BSR stores whole blocks; zeros inside a stored block contribute
    # op_mul(0, x) — document via the test (block semantics)
    y = np.asarray(bsr_spmv(B, jnp.asarray(x), op_mul=lambda av, xv: av * 2 * xv))
    # tolerance: f32 sums vs the float64 scipy reference; their order
    # differs (and changes from run to run under GPU atomics)
    np.testing.assert_allclose(y, 2 * (a @ x), rtol=1e-4, atol=1e-5)


def test_bsr_spmv_rejects_non_plus_accumulator():
    from spla_tpu import op
    from spla_tpu.formats import bsr_from_csr_host, csr_from_scipy
    import scipy.sparse as sp

    A = bsr_from_csr_host(
        csr_from_scipy(sp.identity(8, np.float32, format="csr")), block=8
    )
    x = jnp.ones(8, jnp.float32)
    with pytest.raises(AssertionError):
        bsr_spmv(A, x, op_add=op.MIN_FLOAT)
    # PLUS (or None) passes
    # tolerance: f32 sums vs the float64 scipy reference; their order
    # differs (and changes from run to run under GPU atomics)
    np.testing.assert_allclose(
        np.asarray(bsr_spmv(A, x, op_add=op.PLUS_FLOAT)), np.ones(8)
    )
