"""Algorithms, masked SpGEMM and the distributed XLA paths on the graph
classes a GraphBLAS serves: skewed (zipf hubs) and road grids (thousands
of near-empty levels at scale), against scipy/numpy oracles in float64.

Exact results (BFS depths, triangle counts, MIN folds of one f32 add,
integer folds) are compared exactly; float sums with a stated tolerance.
"""

import numpy as np
import pytest
import scipy.sparse as sp
from scipy.sparse import csgraph

import jax

from spla_tpu import algorithms as alg
from spla_tpu import formats as F
from spla_tpu import op
from spla_tpu.ops import mxmT_masked
from spla_tpu.parallel import (
    dist_bfs,
    dist_masked_spmv,
    dist_pagerank,
    dist_sssp,
    make_device_mesh,
    shard_csr_by_rows,
    shard_csr_by_rows_balanced,
    shard_vector_by_rows,
)


def zipf_graph(n, seed):
    """Symmetric zipf-2.1 graph: hub vertices with degree up to n/4."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(2.1, n) * 2, n // 4)
    r = np.repeat(np.arange(n), deg)
    c = rng.integers(0, n, r.size)
    keep = r != c
    A = sp.coo_matrix((np.ones(keep.sum(), np.float32), (r[keep], c[keep])),
                      shape=(n, n))
    return ((A + A.T) > 0).astype(np.float32).tocsr()


def road_grid(side):
    """Morton-ordered side x side grid (side a power of two): ~2*side BFS
    levels of tiny frontiers, locality-preserving vertex order."""

    def spread(v):
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    def morton(x, y):
        return spread(x) | (spread(y) << 1)

    xs, ys = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    rows, cols = [], []
    for dx, dy in ((1, 0), (0, 1)):
        x2, y2 = xs[: side - dx, : side - dy], ys[: side - dx, : side - dy]
        a = morton(x2.ravel(), y2.ravel())
        b = morton((x2 + dx).ravel(), (y2 + dy).ravel())
        rows += [a, b]
        cols += [b, a]
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    n = side * side
    return sp.csr_matrix((np.ones(r.size, np.float32), (r, c)), shape=(n, n))


GRAPHS = {
    "zipf": lambda: zipf_graph(400, 3),
    "road": lambda: road_grid(32),
}


def weighted(A, seed):
    """Symmetric positive weights on A's pattern."""
    rng = np.random.default_rng(seed)
    W = A.copy().tocsr()
    W.data = rng.uniform(0.1, 2.0, W.nnz).astype(np.float32)
    return W.maximum(W.T).tocsr()


def bfs_depths(A, src):
    d = csgraph.shortest_path(A, unweighted=True, indices=src)
    return np.where(np.isfinite(d), d + 1, 0).astype(np.int32)


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_bfs_graph_class(graph):
    A = GRAPHS[graph]()
    Ac = F.csr_from_scipy(A.astype(np.int32))
    v = np.asarray(alg.bfs(Ac, 0, At=Ac).values)
    np.testing.assert_array_equal(v, bfs_depths(A, 0))


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_sssp_graph_class(graph):
    W = weighted(GRAPHS[graph](), 5)
    Wc = F.csr_from_scipy(W)
    got = np.asarray(alg.sssp(Wc, 0).values)
    want = csgraph.dijkstra(W.astype(np.float64), indices=0)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    # tolerance: f32 path sums vs float64 Dijkstra
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_tc_graph_class(graph):
    A = GRAPHS[graph]()
    L = sp.tril(A, k=-1).tocsr()
    want = int((L @ L).multiply(L).sum()) * 6
    assert alg.tc(F.csr_from_scipy(A.astype(np.int32))) == want


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_pr_graph_class(graph):
    A = GRAPHS[graph]()
    outdeg = np.asarray(A.sum(axis=0)).ravel()
    outdeg[outdeg == 0] = 1
    S = A.multiply(0.85 / outdeg).tocsr()
    eps = 1e-6
    got = np.asarray(alg.pr(F.csr_from_scipy(S.astype(np.float32)), 0.85,
                            eps).values)
    n = A.shape[0]
    p = np.full(n, 1.0 / n)
    while True:
        q = S @ p + 0.15 / n
        err = np.sqrt(((q - p) ** 2).sum())
        p = q
        if err <= eps:
            break
    # tolerance: f32 iteration stopped at the same eps as the float64 one
    assert np.abs(got - p).sum() <= 1e-4


def heavy_rows(seed):
    """n=200 with three rows of degree ~120 among degree-4 rows."""
    rng = np.random.default_rng(seed)
    n = 200
    r = np.concatenate([np.repeat([5, 90, 170], 120), rng.integers(0, n, 800)])
    c = rng.integers(0, n, r.size)
    keep = r != c
    A = sp.coo_matrix((np.ones(keep.sum()), (r[keep], c[keep])), shape=(n, n))
    return ((A + A.T) > 0).astype(np.float32).tocsr()


MXMT = {
    # name: (mul, add, select, init, dtype, numpy fold)
    "plus_times_f32": (op.MULT_FLOAT, op.PLUS_FLOAT, op.GTZERO_FLOAT, 0.0,
                       np.float32, np.add),
    "min_plus_f32": (op.PLUS_FLOAT, op.MIN_FLOAT, op.GTZERO_FLOAT, np.inf,
                     np.float32, np.minimum),
    "plus_i32": (op.MULT_INT, op.PLUS_INT, op.GTZERO_INT, 0, np.int32, np.add),
}


@pytest.mark.parametrize("semiring", list(MXMT))
def test_mxmT_masked_heavy_rows(semiring):
    mul, add, sel, init, dtype, np_fold = MXMT[semiring]
    P = heavy_rows(2)
    rng = np.random.default_rng(4)
    A = P.copy()
    A.data = rng.integers(1, 9, A.nnz).astype(dtype)
    A = A.astype(dtype)
    mask = F.csr_from_scipy(P.astype(dtype))
    Ac = F.csr_from_scipy(A)
    R = mxmT_masked(mask, Ac, Ac, mul, add, sel, init)
    nnz = int(R.nnz)
    got = {}
    for i, j, x in zip(np.asarray(R.row_ids)[:nnz], np.asarray(R.cols)[:nnz],
                       np.asarray(R.values)[:nnz]):
        got[(int(i), int(j))] = x
    want = {}
    Pc = P.tocoo()
    for i, j in zip(Pc.row, Pc.col):
        ci, cj = A.indices[A.indptr[i]:A.indptr[i + 1]], \
            A.indices[A.indptr[j]:A.indptr[j + 1]]
        common = np.intersect1d(ci, cj)
        if common.size == 0:
            continue
        ai = dict(zip(ci, A.data[A.indptr[i]:A.indptr[i + 1]]))
        aj = dict(zip(cj, A.data[A.indptr[j]:A.indptr[j + 1]]))
        prods = np.asarray([mul.fn(ai[k], aj[k]) for k in common], dtype)
        folded = np_fold.reduce(np.concatenate([[dtype(init)], prods]))
        if folded != init:
            want[(int(i), int(j))] = folded
    assert got.keys() == want.keys()
    g = np.asarray([got[k] for k in sorted(want)])
    w = np.asarray([want[k] for k in sorted(want)])
    # exact: the values are small integers, so f32 sums are exact in any
    # order, and MIN folds and int32 sums are exact anyway
    np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_device_mesh(8)


@pytest.fixture(scope="module")
def balanced_zipf(mesh):
    A = zipf_graph(400, 9)
    bal, old_of_new, new_of_old = shard_csr_by_rows_balanced(
        F.csr_from_scipy(A), 8, mesh)
    return A, bal, new_of_old


@pytest.mark.parametrize("frontier_cap", [0, None, 4])
def test_dist_bfs_balanced(mesh, balanced_zipf, frontier_cap):
    """Dense, tiered and single-tier exchange on the degree-balanced
    sharding give the single-device depths."""
    A, bal, new_of_old = balanced_zipf
    src = 7
    v = np.asarray(dist_bfs(mesh, bal, int(new_of_old[src]),
                            frontier_cap=frontier_cap)).ravel()
    np.testing.assert_array_equal(v[new_of_old], bfs_depths(A, src))


def test_dist_sssp_balanced(mesh):
    W = weighted(zipf_graph(400, 9), 6)
    bal, _, new_of_old = shard_csr_by_rows_balanced(F.csr_from_scipy(W), 8,
                                                     mesh)
    src = 7
    v = np.asarray(dist_sssp(mesh, bal, int(new_of_old[src]))).ravel()
    got = v[new_of_old]
    want = csgraph.dijkstra(W.astype(np.float64), indices=src)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    # tolerance: f32 path sums vs float64 Dijkstra
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)


def test_dist_pagerank_balanced(mesh):
    A = zipf_graph(400, 9)
    outdeg = np.asarray(A.sum(axis=0)).ravel()
    outdeg[outdeg == 0] = 1
    S = A.multiply(0.85 / outdeg).tocsr().astype(np.float32)
    bal, _, new_of_old = shard_csr_by_rows_balanced(F.csr_from_scipy(S), 8,
                                                     mesh)
    p = np.asarray(dist_pagerank(mesh, bal, 0.85, 1e-6)).ravel()[new_of_old]
    p1 = np.asarray(alg.pr(F.csr_from_scipy(S), 0.85, 1e-6).values)
    # tolerance: the same f32 recurrence with per-shard partial sums
    assert np.abs(p - p1).sum() <= 1e-5


def test_dist_spmv_balanced(mesh):
    A = zipf_graph(400, 9)
    rng = np.random.default_rng(3)
    A.data = rng.random(A.nnz).astype(np.float32)
    bal, old_of_new, new_of_old = shard_csr_by_rows_balanced(
        F.csr_from_scipy(A), 8, mesh)
    x = rng.random(A.shape[0]).astype(np.float32)
    xs = shard_vector_by_rows(x[old_of_new], 8, bal.mloc, mesh)
    r = np.asarray(dist_masked_spmv(mesh, bal, xs, op.MULT_FLOAT,
                                    op.PLUS_FLOAT, 0.0)).ravel()
    # tolerance: f32 sums vs float64 scipy; the order differs
    np.testing.assert_allclose(r[new_of_old], A.astype(np.float64) @ x,
                               rtol=1e-5, atol=1e-6)


def test_balanced_matches_plain_sharding(mesh):
    """Balanced and plain sharding of the same graph give the same BFS."""
    A = zipf_graph(400, 9)
    Ac = F.csr_from_scipy(A)
    plain = np.asarray(dist_bfs(mesh, shard_csr_by_rows(Ac, 8, mesh), 0))
    bal, _, new_of_old = shard_csr_by_rows_balanced(Ac, 8, mesh)
    v = np.asarray(dist_bfs(mesh, bal, int(new_of_old[0]))).ravel()
    np.testing.assert_array_equal(v[new_of_old], plain.ravel()[:400])
