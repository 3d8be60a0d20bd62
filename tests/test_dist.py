"""Distributed layer tests on a virtual 8-device CPU mesh (what the
reference never had — SURVEY §2.8/§4: multi-node testing none)."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax

from spla_tpu import op, formats as F
from spla_tpu.algorithms import bfs_naive, sssp_naive
from spla_tpu.parallel import (
    dist_bfs,
    dist_masked_spmv,
    dist_pagerank,
    dist_sssp,
    make_device_mesh,
    shard_csr_by_rows,
    shard_vector_by_rows,
)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_device_mesh(8)


def random_undirected(n, avg_deg, seed, weighted=False):
    rng = np.random.default_rng(seed)
    m = n * avg_deg // 2
    r = rng.integers(0, n, m)
    c = rng.integers(0, n, m)
    keep = r != c
    r, c = r[keep], c[keep]
    rows = np.concatenate([r, c])
    cols = np.concatenate([c, r])
    if weighted:
        w = rng.uniform(0.1, 2.0, r.size).astype(np.float32)
        vals = np.concatenate([w, w])
    else:
        vals = np.ones(rows.size, np.float32)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
    A.sum_duplicates()
    if not weighted:
        A.data[:] = 1
    return A.tocsr()


def test_dist_spmv_matches_single(mesh):
    n = 203  # deliberately not divisible by 8
    A = random_undirected(n, 6, 0)
    Ac = F.csr_from_scipy(A)
    sc = shard_csr_by_rows(Ac, 8, mesh)
    x = np.random.default_rng(1).normal(size=n).astype(np.float32)
    xs = shard_vector_by_rows(x, 8, sc.mloc, mesh)
    r = dist_masked_spmv(mesh, sc, xs, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
    got = np.asarray(r).ravel()[:n]
    # tolerance: f32 sums vs the float64 scipy reference; their order
    # differs (and changes from run to run under GPU atomics)
    np.testing.assert_allclose(got, A @ x, rtol=1e-4, atol=1e-5)


def test_dist_pagerank_matches_naive(mesh):
    n = 120
    A = random_undirected(n, 5, 2).astype(np.float32)
    alpha, eps = 0.85, 1e-5
    outdeg = np.asarray(A.sum(axis=0)).ravel()
    outdeg[outdeg == 0] = 1.0
    As = A.multiply(alpha / outdeg).tocsr().astype(np.float32)
    sc = shard_csr_by_rows(F.csr_from_scipy(As), 8, mesh)
    p = np.asarray(dist_pagerank(mesh, sc, alpha, eps)).ravel()[:n]
    # single-device reference
    from spla_tpu.algorithms import pr

    p1 = np.asarray(pr(F.csr_from_scipy(As), alpha, eps).values)
    # tolerance: the same f32 recurrence with per-shard partial sums
    np.testing.assert_allclose(p, p1, rtol=1e-4, atol=1e-8)


def test_dist_bfs_matches_naive(mesh):
    n = 150
    A = random_undirected(n, 6, 3)
    adj = [A.indices[A.indptr[i] : A.indptr[i + 1]].tolist() for i in range(n)]
    sc = shard_csr_by_rows(F.csr_from_scipy(A.astype(np.int32)), 8, mesh)
    v = np.asarray(dist_bfs(mesh, sc, 0)).ravel()[:n]
    np.testing.assert_array_equal(v, bfs_naive(adj, 0))


def test_dist_sssp_matches_naive(mesh):
    n = 100
    A = random_undirected(n, 6, 4, weighted=True)
    adj = [A.indices[A.indptr[i] : A.indptr[i + 1]].tolist() for i in range(n)]
    w = [A.data[A.indptr[i] : A.indptr[i + 1]].tolist() for i in range(n)]
    sc = shard_csr_by_rows(F.csr_from_scipy(A), 8, mesh)
    v = np.asarray(dist_sssp(mesh, sc, 0)).ravel()[:n]
    expect = sssp_naive(adj, w, 0)
    finite = np.isfinite(expect)
    # tolerance: f32 path sums in another order than the oracle's
    np.testing.assert_allclose(v[finite], expect[finite], rtol=1e-5)
    assert np.all(np.isinf(v[~finite]))


# ---------------------------------------------------------------------------
# distributed SpGEMM (ring-rotated row-merge)
# ---------------------------------------------------------------------------


def _to_dense_sharded(R, n):
    """Assemble a dense matrix from a row-sharded CSR result."""
    S, cap = np.asarray(R.cols).shape
    out = np.zeros((R.n_shards * R.mloc, n), np.float64)
    rows = np.asarray(R.row_ids)
    cols = np.asarray(R.cols)
    vals = np.asarray(R.values)
    nnz = np.asarray(R.nnz)
    for s in range(S):
        k = int(nnz[s])
        r = rows[s, :k] + s * R.mloc
        out[r, cols[s, :k]] += vals[s, :k]
    return out[: R.shape[0]]


def test_dist_mxm_matches_scipy(mesh):
    from spla_tpu.parallel import dist_mxm

    n = 117
    A = random_undirected(n, 5, 7, weighted=True)
    B = random_undirected(n, 4, 8, weighted=True)
    As = shard_csr_by_rows(F.csr_from_scipy(A), 8, mesh)
    Bs = shard_csr_by_rows(F.csr_from_scipy(B), 8, mesh)
    R = dist_mxm(mesh, As, Bs, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
    got = _to_dense_sharded(R, n)
    ref = (A @ B).toarray()
    # tolerance: f32 sums vs the float64 scipy reference; their order
    # differs (and changes from run to run under GPU atomics)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_dist_mxm_rectangular(mesh):
    from spla_tpu.parallel import dist_mxm

    rng = np.random.default_rng(11)
    A = sp.random(90, 140, density=0.06, random_state=1, dtype=np.float32)
    B = sp.random(140, 75, density=0.08, random_state=2, dtype=np.float32)
    As = shard_csr_by_rows(F.csr_from_scipy(A), 8, mesh)
    Bs = shard_csr_by_rows(F.csr_from_scipy(B), 8, mesh)
    R = dist_mxm(mesh, As, Bs, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
    got = _to_dense_sharded(R, 75)
    # tolerance: f32 sums vs the float64 scipy reference; their order
    # differs (and changes from run to run under GPU atomics)
    np.testing.assert_allclose(got, (A @ B).toarray(), rtol=1e-4, atol=1e-5)


def test_dist_tc_matches_naive(mesh):
    from spla_tpu.algorithms import tc_naive
    from spla_tpu.parallel import dist_tc

    n = 96
    A = random_undirected(n, 8, 9).astype(np.float32)
    As = shard_csr_by_rows(F.csr_from_scipy(A), 8, mesh)
    got = dist_tc(mesh, As)
    adj = [A.indices[A.indptr[i] : A.indptr[i + 1]].tolist() for i in range(n)]
    assert got == tc_naive(adj)


def test_dist_bfs_sparse_exchange_stats(mesh):
    """Capped-sparse frontier exchange (round-4): a path graph runs many
    near-empty levels — the sparse gather must cut comm volume by orders
    of magnitude while producing identical depths."""
    n = 160  # path: n-1 levels of frontier size 1
    rows = np.arange(n - 1)
    cols = np.arange(1, n)
    A = sp.coo_matrix(
        (np.ones(2 * (n - 1), np.float32),
         (np.concatenate([rows, cols]), np.concatenate([cols, rows]))),
        shape=(n, n),
    ).tocsr()
    sc = shard_csr_by_rows(F.csr_from_scipy(A), 8, mesh)
    v_dense, st_dense = dist_bfs(mesh, sc, 0, frontier_cap=0,
                                 with_stats=True)
    v_sparse, st_sparse = dist_bfs(mesh, sc, 0, frontier_cap=4,
                                   with_stats=True)
    np.testing.assert_array_equal(np.asarray(v_sparse), np.asarray(v_dense))
    assert st_sparse["sparse_levels"] == st_sparse["levels"]
    assert st_dense["sparse_levels"] == 0
    # path frontier = 1 vertex: sparse gather is S*cap*4 = 128 B/level vs
    # S*mloc = 160 B/level dense — and the gap grows with n while the
    # sparse side stays constant
    assert st_sparse["comm_bytes"] < st_dense["comm_bytes"]


def test_dist_bfs_sparse_cap_overflow_fallback(mesh):
    """When a level overflows the cap every chip must fall back to the
    dense gather in lockstep and the result must be unchanged (a star
    graph has one huge level)."""
    n = 120
    hub = 0
    spokes = np.arange(1, n)
    A = sp.coo_matrix(
        (np.ones(2 * (n - 1), np.float32),
         (np.concatenate([np.full(n - 1, hub), spokes]),
          np.concatenate([spokes, np.full(n - 1, hub)]))),
        shape=(n, n),
    ).tocsr()
    adj = [A.indices[A.indptr[i]: A.indptr[i + 1]].tolist()
           for i in range(n)]
    sc = shard_csr_by_rows(F.csr_from_scipy(A.astype(np.int32)), 8, mesh)
    v, st = dist_bfs(mesh, sc, 0, frontier_cap=2, with_stats=True)
    np.testing.assert_array_equal(
        np.asarray(v).ravel()[:n], bfs_naive(adj, 0)
    )
    assert st["sparse_levels"] < st["levels"]  # the big level went dense


def test_dist_sssp_sparse_exchange_matches(mesh):
    n = 100
    A = random_undirected(n, 6, 11, weighted=True)
    adj = [A.indices[A.indptr[i]: A.indptr[i + 1]].tolist()
           for i in range(n)]
    w = [A.data[A.indptr[i]: A.indptr[i + 1]].tolist() for i in range(n)]
    sc = shard_csr_by_rows(F.csr_from_scipy(A), 8, mesh)
    v_dense = np.asarray(dist_sssp(mesh, sc, 0, frontier_cap=0)).ravel()[:n]
    v_sp, st = dist_sssp(mesh, sc, 0, frontier_cap=6, with_stats=True)
    v_sp = np.asarray(v_sp).ravel()[:n]
    # tolerance: same f32 relaxations, exchanged in another order
    np.testing.assert_allclose(v_sp, v_dense, rtol=1e-6)
    expect = sssp_naive(adj, w, 0)
    # tolerance: f32 path sums in another order than the oracle's
    np.testing.assert_allclose(v_sp, expect, rtol=1e-5)
    assert st["sparse_rounds"] >= 1


def test_balanced_sharding_skewed_graph(mesh):
    """Degree-balanced relabeled sharding: per-shard nnz equalized on a
    hub graph and BFS depths survive the round trip through the
    permutation."""
    from spla_tpu.parallel import shard_csr_by_rows_balanced

    n = 160
    rng = np.random.default_rng(5)
    # clustered heavy rows (degree-sorted input, the common SuiteSparse
    # layout): contiguous blocks put all of them on shard 0
    heavy = np.repeat(np.arange(16), 24)  # rows 0..15, 24 edges each
    r = np.concatenate([heavy, rng.integers(16, n, 150)])
    c = np.concatenate([rng.integers(0, n, heavy.size),
                        rng.integers(0, n, 150)])
    keep = r != c
    A = sp.coo_matrix((np.ones(keep.sum(), np.float32), (r[keep], c[keep])),
                      shape=(n, n))
    A = ((A + A.T) > 0).astype(np.float32).tocsr()
    Ac = F.csr_from_scipy(A.astype(np.int32))
    naive = shard_csr_by_rows(Ac, 8, mesh)
    bal, old_of_new, new_of_old = shard_csr_by_rows_balanced(Ac, 8, mesh)
    nnz_naive = np.asarray(naive.nnz)
    nnz_bal = np.asarray(bal.nnz)
    # clustered heavy rows dominate one naive shard; dealing spreads them
    assert nnz_bal.max() < 0.7 * nnz_naive.max()
    assert nnz_bal.max() - nnz_bal.min() <= nnz_bal.mean() * 0.5 + 8

    adj = [A.indices[A.indptr[i]: A.indptr[i + 1]].tolist()
           for i in range(n)]
    src = 3
    v_new = np.asarray(
        dist_bfs(mesh, bal, int(new_of_old[src]))
    ).ravel()
    v_old = v_new[new_of_old]
    np.testing.assert_array_equal(v_old, bfs_naive(adj, src))


def test_dist_pagerank_overlap_matches(mesh):
    """Diagonal/off-diagonal split PageRank (gather overlapped with the
    communication-free diagonal product) matches the plain version."""
    from spla_tpu.parallel import dist_pagerank_overlap, shard_csr_split_diag

    n = 130
    A = random_undirected(n, 5, 21).astype(np.float32)
    outdeg = np.asarray(A.sum(axis=0)).ravel()
    outdeg[outdeg == 0] = 1.0
    As = F.csr_from_scipy(A.multiply(0.85 / outdeg).tocsr().astype(np.float32))
    sc = shard_csr_by_rows(As, 8, mesh)
    diag, off = shard_csr_split_diag(As, 8, mesh)
    # split preserves the edge mass
    assert int(np.asarray(diag.nnz).sum() + np.asarray(off.nnz).sum()) \
        == int(np.asarray(As.nnz))
    p0 = np.asarray(dist_pagerank(mesh, sc, 0.85, 1e-6)).ravel()
    p1 = np.asarray(dist_pagerank_overlap(mesh, diag, off, 0.85, 1e-6)).ravel()
    # tolerance: the same f32 recurrence with per-shard partial sums
    np.testing.assert_allclose(p1, p0, rtol=1e-5, atol=1e-9)


def test_dist_bfs_tiered_caps_lockstep(mesh):
    """Tiered cap ladder (r4 verdict item 8): a lollipop graph (clique +
    long path) transitions dense -> big tier -> small tier in lockstep
    across the mesh, results identical to the dense run, and the ladder
    ships less volume than either single tier."""
    # clique of 48 + path of 112: first levels are clique-sized (dense /
    # big tier), the tail is frontier-size-1 (small tier)
    k, n = 48, 160
    ci, cj = np.meshgrid(np.arange(k), np.arange(k))
    keep = ci.ravel() != cj.ravel()
    rows = [ci.ravel()[keep]]
    cols = [cj.ravel()[keep]]
    pr_, pc_ = np.arange(k - 1, n - 1), np.arange(k, n)
    rows += [pr_, pc_]
    cols += [pc_, pr_]
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    A = sp.coo_matrix((np.ones(rows.size, np.float32), (rows, cols)),
                      shape=(n, n)).tocsr()
    adj = [A.indices[A.indptr[i]: A.indptr[i + 1]].tolist()
           for i in range(n)]
    sc = shard_csr_by_rows(F.csr_from_scipy(A), 8, mesh)

    v_dense, st_dense = dist_bfs(mesh, sc, 0, frontier_cap=0,
                                 with_stats=True)
    v_big, st_big = dist_bfs(mesh, sc, 0, frontier_cap=8, with_stats=True)
    v_tier, st_tier = dist_bfs(mesh, sc, 0, frontier_cap=(1, 8),
                               with_stats=True)
    for v in (v_dense, v_big, v_tier):
        np.testing.assert_array_equal(np.asarray(v).ravel()[:n],
                                      bfs_naive(adj, 0))
    # the path tail runs the 1-entry tier: ladder beats the single tier
    # and dense (at this toy mloc=20 the 8-cap tier alone does NOT beat
    # dense — 8 shards*8*4=256 B vs 160 B — which is exactly why the
    # ladder exists)
    assert st_tier["comm_bytes"] < st_big["comm_bytes"]
    assert st_tier["comm_bytes"] < st_dense["comm_bytes"]
    assert st_tier["sparse_levels"] == st_big["sparse_levels"]


def test_dist_sssp_tiered_caps(mesh):
    n = 100
    A = random_undirected(n, 6, 11, weighted=True)
    adj = [A.indices[A.indptr[i]: A.indptr[i + 1]].tolist()
           for i in range(n)]
    w = [A.data[A.indptr[i]: A.indptr[i + 1]].tolist() for i in range(n)]
    sc = shard_csr_by_rows(F.csr_from_scipy(A), 8, mesh)
    v_dense = np.asarray(dist_sssp(mesh, sc, 0, frontier_cap=0)).ravel()[:n]
    v_t, st = dist_sssp(mesh, sc, 0, frontier_cap=(2, 8), with_stats=True)
    # tolerance: same f32 relaxations, exchanged in another order
    np.testing.assert_allclose(np.asarray(v_t).ravel()[:n], v_dense,
                               rtol=1e-6)
    # tolerance: f32 path sums in another order than the oracle's
    np.testing.assert_allclose(np.asarray(v_t).ravel()[:n],
                               sssp_naive(adj, w, 0), rtol=1e-5)
    assert st["sparse_rounds"] >= 1


def test_dist_default_cap_is_ladder():
    from spla_tpu.parallel.dist_ops import _normalize_caps

    assert _normalize_caps(None, 16384) == (64, 1024)
    assert _normalize_caps(0, 16384) == ()
    assert _normalize_caps(7, 16384) == (7,)
    assert _normalize_caps((32, 4, 32), 16384) == (4, 32)
