"""Container + format conversion tests (model: reference test_vector.cpp /
test_matrix.cpp get/set + StorageManager conversions, vs scipy.sparse)."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from spla_tpu import formats as F
from spla_tpu.containers import CsrMatrix, DenseVec, SparseVec


def test_sparse_vec_build_dedup_default_last():
    # duplicate indices: default keeps last (reference SECOND default)
    v = F.sparse_vec_from_entries(10, [3, 1, 3], [7, 5, 9], fill=0, dtype=np.int32)
    assert int(v.nnz) == 2
    np.testing.assert_array_equal(np.asarray(v.indices)[:2], [1, 3])
    np.testing.assert_array_equal(np.asarray(v.values)[:2], [5, 9])


def test_sparse_vec_build_dedup_reduce():
    # set_reduce semantics (reference src/core/tvector.hpp:145-156)
    v = F.sparse_vec_from_entries(
        10, [3, 1, 3], [7, 5, 9], fill=0, dtype=np.int32, reduce_fn=lambda a, b: a + b
    )
    np.testing.assert_array_equal(np.asarray(v.values)[:2], [5, 16])


def test_vec_roundtrip_dense_sparse():
    v = F.sparse_vec_from_entries(8, [1, 4, 6], [2.0, -1.0, 3.5], fill=0.0, capacity=5)
    d = F.sparse_to_dense_vec(v)
    np.testing.assert_array_equal(
        np.asarray(d.values), [0, 2.0, 0, 0, -1.0, 0, 3.5, 0]
    )
    s2 = F.dense_to_sparse_vec(d, capacity=8)
    assert int(s2.nnz) == 3
    np.testing.assert_array_equal(np.asarray(s2.indices)[:3], [1, 4, 6])
    np.testing.assert_array_equal(np.asarray(s2.values)[:3], [2.0, -1.0, 3.5])


def test_nonzero_fill_stored_semantics():
    # GraphBLAS fill != 0 (SSSP uses +inf, reference src/algorithm.cpp:176-178)
    inf = np.float32(np.inf)
    d = DenseVec(jnp.asarray([inf, 2.0, inf, 0.0], jnp.float32), jnp.float32(inf))
    s = F.dense_to_sparse_vec(d, capacity=4)
    assert int(s.nnz) == 2
    np.testing.assert_array_equal(np.asarray(s.indices)[:2], [1, 3])


def test_csr_build_vs_scipy(rng):
    m, n, nnz = 50, 40, 300
    r = rng.integers(0, m, nnz)
    c = rng.integers(0, n, nnz)
    x = rng.normal(size=nnz).astype(np.float32)
    ref = sp.coo_matrix((x, (r, c)), shape=(m, n)).tocsr()
    ref.sum_duplicates()
    ours = F.csr_from_entries(
        (m, n), r, c, x, fill=0.0, reduce_fn=lambda a, b: a + b, capacity=nnz
    )
    got = np.asarray(F.csr_to_dense(ours))
    # tolerance: f32 sums taken in another order than the reference's
    np.testing.assert_allclose(got, ref.toarray(), rtol=1e-5)


def test_csr_coo_roundtrip(rng):
    a = sp.random(30, 20, density=0.2, random_state=1, dtype=np.float32)
    csr = F.csr_from_scipy(a)
    coo = F.csr_to_coo(csr)
    back = F.coo_to_csr(coo)
    np.testing.assert_array_equal(np.asarray(back.indptr), np.asarray(csr.indptr))
    # exact: elementwise copies/negation of f32 values, no arithmetic
    np.testing.assert_allclose(
        np.asarray(F.csr_to_dense(back)), a.toarray(), rtol=1e-6
    )


def test_csr_with_padding_capacity(rng):
    a = sp.random(10, 10, density=0.3, random_state=2, dtype=np.float32)
    csr = F.csr_from_scipy(a, capacity=256)
    assert csr.capacity == 256
    # exact: elementwise copies/negation of f32 values, no arithmetic
    np.testing.assert_allclose(np.asarray(F.csr_to_dense(csr)), a.toarray())
    # pad rows are the dump row m
    nnz = int(csr.nnz)
    assert np.all(np.asarray(csr.row_ids)[nnz:] == 10)


def test_csr_transpose_host(rng):
    a = sp.random(15, 9, density=0.25, random_state=3, dtype=np.float32)
    at = F.csr_transpose_host(F.csr_from_scipy(a))
    # exact: elementwise copies/negation of f32 values, no arithmetic
    np.testing.assert_allclose(np.asarray(F.csr_to_dense(at)), a.toarray().T)


def test_bsr_from_csr(rng):
    a = sp.random(20, 20, density=0.1, random_state=4, dtype=np.float32)
    csr = F.csr_from_scipy(a)
    bsr = F.bsr_from_csr_host(csr, block=8)
    # reassemble dense from blocks
    dense = np.zeros((24, 24), np.float32)
    nnzb = int(bsr.nnzb)
    brows = np.asarray(bsr.row_ids)[:nnzb]
    bcols = np.asarray(bsr.cols)[:nnzb]
    blocks = np.asarray(bsr.blocks)[:nnzb]
    for t in range(nnzb):
        dense[brows[t] * 8 : brows[t] * 8 + 8, bcols[t] * 8 : bcols[t] * 8 + 8] = blocks[t]
    # exact: elementwise copies/negation of f32 values, no arithmetic
    np.testing.assert_allclose(dense[:20, :20], a.toarray())


def test_weak_id_cache_finalizer_evicts():
    """Dead key objects evict their cache entries promptly (round-1
    advisor: lazy eviction pinned O(nnz) data forever)."""
    import gc

    from spla_tpu.formats import WeakIdCache

    class K:  # weakref-able key stand-in
        pass

    cache = WeakIdCache()
    k = K()
    cache.put(k, "payload", ("a",))
    cache.put(k, "payload2", ("b",))
    assert cache.get(k, ("a",)) == "payload"
    del k
    gc.collect()
    assert not cache._data  # finalizer removed every entry for that id


def test_host_data_finalizer_evicts():
    import gc

    import jax.numpy as jnp
    import numpy as np

    from spla_tpu import formats as F

    v = jnp.arange(4.0)
    key = id(v)
    F.register_host_arrays(v, np.zeros(1), np.zeros(1), np.zeros(1))
    assert key in F._HOST_DATA
    del v
    gc.collect()
    assert key not in F._HOST_DATA
