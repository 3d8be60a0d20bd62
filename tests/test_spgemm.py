"""SpGEMM tests (model: reference test_mxm.cpp / test_mxmT.cpp)."""

import numpy as np
import pytest
import scipy.sparse as sp

from spla_tpu import op, formats as F
from spla_tpu.ops import count_mxm_products, m_reduce, mxm, mxmT_masked


def rand_csr(m, n, density, seed, dtype=np.float32):
    a = sp.random(m, n, density=density, random_state=seed, dtype=dtype)
    return a, F.csr_from_scipy(a)


def test_mxm_vs_scipy():
    a, ac = rand_csr(20, 30, 0.15, 1)
    b, bc = rand_csr(30, 25, 0.15, 2)
    r = mxm(ac, bc, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
    # tolerance: f32 sums vs the float64 scipy reference; their order
    # differs (and changes from run to run under GPU atomics)
    np.testing.assert_allclose(
        np.asarray(F.csr_to_dense(r)), (a @ b).toarray(), rtol=1e-4, atol=1e-6
    )


def test_mxm_identity_sparsification():
    # accumulated values == init are not stored (cpu_mxm.hpp R_tmp[j] != I)
    a = F.csr_from_entries((2, 2), [0, 0], [0, 1], [1.0, -1.0], fill=0.0)
    b = F.csr_from_entries((2, 2), [0, 1], [0, 0], [1.0, 1.0], fill=0.0)
    r = mxm(a, b, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
    # R[0,0] = 1 - 1 = 0 == init → dropped
    assert int(r.nnz) == 0


def test_mxm_min_plus():
    # tropical semiring SpGEMM (all-pairs-shortest-path step)
    inf = np.float32(np.inf)
    a = F.csr_from_entries((2, 2), [0, 1], [1, 0], [3.0, 4.0], fill=inf)
    r = mxm(a, a, op.PLUS_FLOAT, op.MIN_FLOAT, inf)
    d = np.asarray(F.csr_to_dense(r))
    assert d[0, 0] == 7.0 and d[1, 1] == 7.0
    assert int(r.nnz) == 2


def test_mxm_explicit_caps():
    a, ac = rand_csr(10, 10, 0.3, 3)
    cap = count_mxm_products(ac, ac)
    r = mxm(ac, ac, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0, products_cap=cap + 17)
    # tolerance: f32 sums vs the float64 scipy reference; their order
    # differs (and changes from run to run under GPU atomics)
    np.testing.assert_allclose(
        np.asarray(F.csr_to_dense(r)), (a @ a).toarray(), rtol=1e-4, atol=1e-6
    )


def test_mxmT_masked_vs_dense():
    a, ac = rand_csr(15, 12, 0.25, 4)
    b, bc = rand_csr(15, 12, 0.25, 5)
    mask, mc = rand_csr(15, 15, 0.3, 6)
    r = mxmT_masked(mc, ac, bc, op.MULT_FLOAT, op.PLUS_FLOAT, op.GTZERO_FLOAT, 0.0)
    full = (a @ b.T).toarray()
    sel = mask.toarray() > 0
    expect = np.where(sel, full, 0.0)
    # tolerance: f32 sums vs the float64 scipy reference; their order
    # differs (and changes from run to run under GPU atomics)
    np.testing.assert_allclose(
        np.asarray(F.csr_to_dense(r)), expect, rtol=1e-4, atol=1e-6
    )


def test_triangle_counting_semantics():
    # triangle: 0-1-2; plus dangling edge 2-3
    edges = [(0, 1), (0, 2), (1, 2), (2, 3)]
    rows = [e[0] for e in edges] + [e[1] for e in edges]
    cols = [e[1] for e in edges] + [e[0] for e in edges]
    A = F.csr_from_entries((4, 4), rows, cols, np.ones(8, np.int32), fill=0, dtype=np.int32)
    B = mxmT_masked(A, A, A, op.MULT_INT, op.PLUS_INT, op.GTZERO_INT, 0)
    total = int(m_reduce(0, B, op.PLUS_INT).value)
    # undirected full-adjacency count = 6 * n_triangles
    assert total == 6


def test_mxmT_masked_nonscatter_monoid():
    # regression: BOR (generic scan path) must not be fed dump-routed
    # unsorted segment ids
    import scipy.sparse as sp

    from spla_tpu import formats as F, op
    from spla_tpu.formats import csr_to_dense
    from spla_tpu.ops.spgemm import mxmT_masked

    a = sp.random(30, 30, density=0.15, random_state=3, dtype=np.float32)
    a.data[:] = np.random.default_rng(3).integers(1, 8, a.nnz)
    A = F.csr_from_scipy(a.astype(np.int32), dtype=np.int32)
    R = mxmT_masked(A, A, A, op.MULT_INT, op.BOR_INT, op.GTZERO_INT, 0)
    got = np.asarray(csr_to_dense(R))
    d = a.toarray().astype(np.int64)
    mask = d > 0
    ref = np.zeros_like(d)
    for i in range(30):
        for j in range(30):
            if mask[i, j]:
                acc = 0
                for k in range(30):
                    if d[i, k] and d[j, k]:
                        acc |= int(d[i, k] * d[j, k])
                ref[i, j] = acc
    np.testing.assert_array_equal(got, ref)


# -- row/product-blocked numeric phase (O(block + output) memory) -----------


@pytest.mark.parametrize("blk", [256, 1024, 5000])
def test_mxm_blocked_matches_unblocked(blk):
    rng = np.random.default_rng(31)
    a = sp.random(120, 90, density=0.15, random_state=31, dtype=np.float32)
    b = sp.random(90, 110, density=0.12, random_state=32, dtype=np.float32)
    Ac = F.csr_from_scipy(a)
    Bc = F.csr_from_scipy(b)
    from spla_tpu.ops.spgemm import count_mxm_products
    total = count_mxm_products(Ac, Bc)
    assert total > blk  # the block loop must actually trigger
    R = mxm(Ac, Bc, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0, block_products=blk)
    ref = (a @ b).toarray()
    got = np.zeros_like(ref)
    nnz = int(np.asarray(R.nnz))
    rows = np.asarray(R.row_ids)[:nnz]
    cols = np.asarray(R.cols)[:nnz]
    vals = np.asarray(R.values)[:nnz]
    got[rows, cols] = vals
    # tolerance: f32 sums; blocking folds the products in another order
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_mxm_blocked_minplus():
    # non-PLUS monoid across window boundaries (straddling rows fold by MIN)
    a = sp.random(60, 60, density=0.2, random_state=33, dtype=np.float32)
    a.data += 0.1
    Ac = F.csr_from_scipy(a)
    R = mxm(Ac, Ac, op.PLUS_FLOAT, op.MIN_FLOAT, float("inf"),
            block_products=128)
    d = np.where(a.toarray() != 0, a.toarray(), np.inf)
    ref = np.full((60, 60), np.inf, np.float32)
    for i in range(60):
        for j in range(60):
            ref[i, j] = np.min(d[i] + d[:, j])
    nnz = int(np.asarray(R.nnz))
    got = np.full((60, 60), np.inf, np.float32)
    got[np.asarray(R.row_ids)[:nnz], np.asarray(R.cols)[:nnz]] = (
        np.asarray(R.values)[:nnz])
    finite = np.isfinite(ref)
    # tolerance: the same f32 additions as the oracle's; rtol guards
    # against a compiler contracting or reordering them
    np.testing.assert_allclose(got[finite], ref[finite], rtol=1e-5)
    assert np.all(np.isinf(got[~finite]))
