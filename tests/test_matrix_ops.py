"""Matrix op tests (model: reference test_matrix.cpp, test_kron.cpp)."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from spla_tpu import op, formats as F
from spla_tpu.ops import (
    kron,
    m_eadd,
    m_emult,
    m_extract_column,
    m_extract_row,
    m_reduce,
    m_reduce_by_column,
    m_reduce_by_row,
    m_transpose,
)


def rand_csr(m, n, density, seed, dtype=np.float32):
    a = sp.random(m, n, density=density, random_state=seed, dtype=dtype)
    return a, F.csr_from_scipy(a)


def test_m_eadd_vs_scipy(rng):
    a, ac = rand_csr(20, 15, 0.2, 1)
    b, bc = rand_csr(20, 15, 0.2, 2)
    r = m_eadd(ac, bc, op.PLUS_FLOAT)
    # tolerance: one f32 operation, compared at numpy's default rtol
    np.testing.assert_allclose(
        np.asarray(F.csr_to_dense(r)), (a + b).toarray(), rtol=1e-6
    )


def test_m_eadd_drops_fill_results():
    # values that combine to fill are dropped (cpu_m_eadd.hpp)
    ac = F.csr_from_entries((3, 3), [0, 1], [0, 1], [5.0, 2.0], fill=0.0)
    bc = F.csr_from_entries((3, 3), [0, 2], [0, 2], [-5.0, 1.0], fill=0.0)
    r = m_eadd(ac, bc, op.PLUS_FLOAT)
    assert int(r.nnz) == 2  # (0,0) cancels to 0 == fill → dropped
    d = np.asarray(F.csr_to_dense(r))
    assert d[0, 0] == 0 and d[1, 1] == 2.0 and d[2, 2] == 1.0


def test_m_emult_vs_scipy(rng):
    a, ac = rand_csr(20, 15, 0.3, 3)
    b, bc = rand_csr(20, 15, 0.3, 4)
    r = m_emult(ac, bc, op.MULT_FLOAT)
    # tolerance: one f32 operation, compared at numpy's default rtol
    np.testing.assert_allclose(
        np.asarray(F.csr_to_dense(r)), (a.multiply(b)).toarray(), rtol=1e-6
    )


def test_m_reduce():
    a, ac = rand_csr(10, 10, 0.3, 5)
    got = float(m_reduce(0.0, ac, op.PLUS_FLOAT).value)
    # tolerance: f32 sums vs the float64 scipy reference; their order
    # differs (and changes from run to run under GPU atomics)
    np.testing.assert_allclose(got, a.sum(), rtol=1e-5)


def test_m_reduce_by_row_and_col():
    a, ac = rand_csr(12, 9, 0.3, 6)
    r = m_reduce_by_row(ac, op.PLUS_FLOAT, 0.0)
    # tolerance: f32 sums vs the float64 scipy reference; their order
    # differs (and changes from run to run under GPU atomics)
    np.testing.assert_allclose(
        np.asarray(r.values), np.asarray(a.sum(axis=1)).ravel(), rtol=1e-5
    )
    c = m_reduce_by_column(ac, op.PLUS_FLOAT, 0.0)
    # tolerance: f32 sums vs the float64 scipy reference; their order
    # differs (and changes from run to run under GPU atomics)
    np.testing.assert_allclose(
        np.asarray(c.values), np.asarray(a.sum(axis=0)).ravel(), rtol=1e-5
    )


def test_m_reduce_by_row_min_init():
    ac = F.csr_from_entries((3, 4), [0, 0, 2], [1, 3, 0], [5.0, 2.0, -1.0], fill=0.0)
    r = m_reduce_by_row(ac, op.MIN_FLOAT, 100.0)
    np.testing.assert_array_equal(np.asarray(r.values), [2.0, 100.0, -1.0])


def test_m_transpose():
    a, ac = rand_csr(8, 13, 0.25, 7)
    r = m_transpose(ac, op.IDENTITY_FLOAT)
    # exact: elementwise copies/negation of f32 values, no arithmetic
    np.testing.assert_allclose(np.asarray(F.csr_to_dense(r)), a.toarray().T)
    r2 = m_transpose(ac, op.AINV_FLOAT)
    # exact: elementwise copies/negation of f32 values, no arithmetic
    np.testing.assert_allclose(np.asarray(F.csr_to_dense(r2)), -a.toarray().T)


def test_m_extract_row_col():
    a, ac = rand_csr(10, 10, 0.3, 8)
    row = m_extract_row(ac, 4, op.IDENTITY_FLOAT)
    # exact: elementwise copies/negation of f32 values, no arithmetic
    np.testing.assert_allclose(
        np.asarray(F.sparse_to_dense_vec(row).values), a.toarray()[4], rtol=1e-6
    )
    col = m_extract_column(ac, 7, op.IDENTITY_FLOAT)
    # exact: elementwise copies/negation of f32 values, no arithmetic
    np.testing.assert_allclose(
        np.asarray(F.sparse_to_dense_vec(col).values), a.toarray()[:, 7], rtol=1e-6
    )


def test_kron_vs_scipy():
    a, ac = rand_csr(4, 3, 0.5, 9)
    b, bc = rand_csr(3, 5, 0.5, 10)
    r = kron(ac, bc, op.MULT_FLOAT)
    # tolerance: one f32 operation, compared at numpy's default rtol
    np.testing.assert_allclose(
        np.asarray(F.csr_to_dense(r)), sp.kron(a, b).toarray(), rtol=1e-6
    )
