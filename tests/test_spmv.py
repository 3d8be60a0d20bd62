"""Masked SpMV tests with ASCII-art fixtures (model: reference
``tests/test_vxm.cpp:33-89`` / ``test_mxv.cpp``)."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from spla_tpu import op, formats as F
from spla_tpu.containers import DenseVec, SparseVec
from spla_tpu.ops import masked_spmv_structural, mxv_masked, vxm_masked


def dv(vals, fill=0, dtype=np.int32):
    return DenseVec(jnp.asarray(np.asarray(vals, dtype)), jnp.asarray(fill, dtype))


#   matrix A (4x4):          mask:        v:
#   . 1 . 1                  1 0 1 1
#   1 . 1 .                                [1 0 2 0]
#   . 1 . .
#   1 . . 1
A_ROWS = [0, 0, 1, 1, 2, 3, 3]
A_COLS = [1, 3, 0, 2, 1, 0, 3]
A_VALS = [1, 1, 1, 1, 1, 1, 1]


def make_A(dtype=np.int32):
    return F.csr_from_entries((4, 4), A_ROWS, A_COLS, A_VALS, fill=0, dtype=dtype)


def test_mxv_masked_hand_case():
    # pull: r[i] = sum_j A[i,j]*v[j] where mask[i] != 0, else init
    A = make_A()
    v = dv([1, 0, 2, 0])
    mask = dv([1, 0, 1, 1])
    r = mxv_masked(mask, A, v, op.MULT_INT, op.PLUS_INT, op.NQZERO_INT, 0)
    # row0: v[1]+v[3] = 0; row1 masked out; row2: v[1]=0; row3: v[0]+v[3]=1
    np.testing.assert_array_equal(np.asarray(r.values), [0, 0, 0, 1])


def test_mxv_masked_init_nonzero():
    A = make_A()
    v = dv([1, 0, 2, 0])
    mask = dv([1, 1, 1, 1])
    r = mxv_masked(mask, A, v, op.MULT_INT, op.PLUS_INT, op.ALWAYS_INT, 100)
    # sum starts at init (reference cpu_mxv.hpp: sum = sum_init)
    np.testing.assert_array_equal(np.asarray(r.values), [100, 103, 100, 101])


def test_vxm_masked_hand_case():
    # push: r[j] = sum over stored i of v: v[i]*A[i,j], select(mask[j])
    A = make_A()
    At = F.csr_transpose_host(A)
    v = F.sparse_vec_from_entries(4, [0, 2], [1, 2], fill=0, dtype=np.int32)
    mask = dv([1, 1, 1, 0])
    r = vxm_masked(mask, v, At, op.MULT_INT, op.PLUS_INT, op.NQZERO_INT, 0)
    # products: v0*A[0,:] = cols 1,3; v2*A[2,:] = col 1 (x2)
    # r[1] = 1+2 = 3; r[3] masked out
    dense = np.asarray(F.sparse_to_dense_vec(r).values)
    np.testing.assert_array_equal(dense, [0, 3, 0, 0])
    assert int(r.nnz) == 1


def test_vxm_stored_entries_may_equal_init():
    # a selected product summing to init is still stored (cpu_vxm.hpp map)
    A = F.csr_from_entries((2, 2), [0, 1], [1, 1], [1, -1], fill=0, dtype=np.int32)
    At = F.csr_transpose_host(A)
    v = F.sparse_vec_from_entries(2, [0, 1], [1, 1], fill=0, dtype=np.int32)
    mask = dv([1, 1])
    r = vxm_masked(mask, v, At, op.MULT_INT, op.PLUS_INT, op.ALWAYS_INT, 0)
    # r[1] = 1*1 + 1*(-1) = 0 == init but stored
    assert int(r.nnz) == 1
    assert int(r.indices[0]) == 1 and int(r.values[0]) == 0


def test_vxm_respects_stored_not_value():
    # dense v: stored = != fill; value 0 with fill=5 IS stored
    A = make_A()
    At = F.csr_transpose_host(A)
    v = DenseVec(jnp.asarray([0, 5, 5, 5], jnp.int32), jnp.int32(5))
    mask = dv([1, 1, 1, 1])
    r = vxm_masked(mask, v, At, op.MULT_INT, op.PLUS_INT, op.ALWAYS_INT, 0)
    dense = np.asarray(F.sparse_to_dense_vec(r).values)
    # only v[0]=0 stored: products 0*A[0,1], 0*A[0,3] → values 0, stored
    assert int(r.nnz) == 2
    np.testing.assert_array_equal(dense, [0, 0, 0, 0])


def test_bool_semiring_band_bor():
    # BFS semiring over generic (non-scatter) path
    A = make_A()
    At = F.csr_transpose_host(A)
    depths = dv([1, 0, 0, 0])  # v: visited
    front = F.sparse_vec_from_entries(4, [0], [1], fill=0, dtype=np.int32)
    r = vxm_masked(depths, front, At, op.BAND_INT, op.BOR_INT, op.EQZERO_INT, 0)
    dense = np.asarray(F.sparse_to_dense_vec(r).values)
    # from node 0 reach 1, 3; both unvisited (v==0)
    np.testing.assert_array_equal(dense, [0, 1, 0, 1])


def test_min_plus_semiring_inf_fill():
    # SSSP semiring
    inf = np.float32(np.inf)
    A = F.csr_from_entries(
        (3, 3), [0, 0, 1], [1, 2, 2], [5.0, 2.0, 1.0], fill=0.0
    )
    v = DenseVec(jnp.asarray([0.0, inf, inf], jnp.float32), jnp.float32(inf))
    mask = DenseVec(jnp.zeros(3, jnp.float32), jnp.float32(0))
    At = F.csr_transpose_host(A)
    r = vxm_masked(mask, v, At, op.PLUS_FLOAT, op.MIN_FLOAT, op.ALWAYS_FLOAT, inf)
    dense = np.asarray(F.sparse_to_dense_vec(r).values)
    np.testing.assert_array_equal(dense, [inf, 5.0, 2.0])


def test_structural_traversal():
    A = make_A()
    active = jnp.asarray([True, False, False, False])
    unvisited = jnp.asarray([False, True, True, True])
    # push over A^T == pull over A^T rows; undirected-ish fixture
    At = F.csr_transpose_host(A)
    reached = masked_spmv_structural(At, active, unvisited)
    np.testing.assert_array_equal(np.asarray(reached), [False, True, False, True])


@pytest.mark.parametrize("seed", [0, 1])
def test_mxv_random_vs_scipy(rng, seed):
    a = sp.random(64, 48, density=0.15, random_state=seed, dtype=np.float32)
    ac = F.csr_from_scipy(a)
    x = rng.normal(size=48).astype(np.float32)
    v = DenseVec(jnp.asarray(x), jnp.float32(0))
    mask = DenseVec(jnp.ones(64, jnp.float32), jnp.float32(0))
    r = mxv_masked(mask, ac, v, op.MULT_FLOAT, op.PLUS_FLOAT, op.ALWAYS_FLOAT, 0.0)
    # tolerance: f32 sums vs the float64 scipy reference; their order
    # differs (and changes from run to run under GPU atomics)
    np.testing.assert_allclose(np.asarray(r.values), a @ x, rtol=1e-4, atol=1e-5)


def test_vxm_masked_dense_equals_densified_sparse(rng):
    """vxm_masked_dense == sparse_to_dense(vxm_masked) — the equivalence
    the facade fast path relies on (a dense container cannot represent
    stored-slots-equal-to-fill)."""
    from spla_tpu.formats import sparse_to_dense_vec
    from spla_tpu.ops import vxm_masked, vxm_masked_dense

    m = n = 120
    rows = rng.integers(0, m, 500).astype(np.int32)
    cols = rng.integers(0, n, 500).astype(np.int32)
    vals = rng.random(500).astype(np.float32)
    A = F.csr_from_entries((m, n), rows, cols, vals, dtype=np.float32)
    At = F.csr_transpose_host(A)
    mask = DenseVec(jnp.asarray((rng.random(m) > 0.3).astype(np.float32)),
                    jnp.float32(0))
    idx = np.sort(rng.choice(n, 25, replace=False)).astype(np.int32)
    sv = SparseVec(n=n, indices=jnp.asarray(idx),
                   values=jnp.asarray(rng.random(25).astype(np.float32)),
                   nnz=jnp.int32(25), fill=jnp.float32(0))
    for op_mul, op_add, sel, init in (
        (op.MULT_FLOAT, op.PLUS_FLOAT, op.GEZERO_FLOAT, 0.0),
        (op.PLUS_FLOAT, op.MIN_FLOAT, op.NQZERO_FLOAT, float("inf")),
    ):
        dense = vxm_masked_dense(mask, sv, At, op_mul, op_add, sel, init)
        sparse = vxm_masked(mask, sv, At, op_mul, op_add, sel, init)
        # tolerance: the two push SpMVs fold the same f32 products (GPU
        # atomics may order them differently from run to run)
        np.testing.assert_allclose(
            np.asarray(dense.values),
            np.asarray(sparse_to_dense_vec(sparse).values),
            rtol=1e-6,
        )
