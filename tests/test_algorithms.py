"""Algorithm validation vs naive sequential oracles (model: reference
examples' spla-vs-naive ``verify_exact`` pattern, ``examples/bfs.cpp:113-122``)."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from spla_tpu import formats as F
from spla_tpu.algorithms import (
    bfs,
    bfs_naive,
    pr,
    pr_naive,
    sssp,
    sssp_naive,
    tc,
    tc_naive,
)


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
        w = rng.uniform(0.1, 2.0, rows.size // 2).astype(np.float32)
        vals = np.concatenate([w, w])
    else:
        vals = np.ones(rows.size, np.int32)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
    A.sum_duplicates()
    # re-binarize after duplicate summing
    if not weighted:
        A.data[:] = 1
    return A.tocsr()


def to_adj(A):
    A = A.tocsr()
    return [A.indices[A.indptr[i] : A.indptr[i + 1]].tolist() for i in range(A.shape[0])], [
        A.data[A.indptr[i] : A.indptr[i + 1]].tolist() for i in range(A.shape[0])
    ]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bfs_vs_naive(seed):
    A = random_undirected(120, 6, seed)
    adj, _ = to_adj(A)
    Ac = F.csr_from_scipy(A.astype(np.int32))
    got = np.asarray(bfs(Ac, 0).values)
    expect = bfs_naive(adj, 0)
    np.testing.assert_array_equal(got, expect)


def test_bfs_disconnected():
    # two components; unreachable stay 0
    rows = [0, 1, 2, 3]
    cols = [1, 0, 3, 2]
    A = sp.coo_matrix((np.ones(4, np.int32), (rows, cols)), shape=(5, 5)).tocsr()
    Ac = F.csr_from_scipy(A)
    got = np.asarray(bfs(Ac, 0).values)
    np.testing.assert_array_equal(got, [1, 2, 0, 0, 0])


@pytest.mark.parametrize("seed", [0, 1])
def test_sssp_vs_naive(seed):
    A = random_undirected(100, 6, seed, weighted=True)
    adj, w = to_adj(A)
    Ac = F.csr_from_scipy(A, dtype=np.float32)
    got = np.asarray(sssp(Ac, 0).values)
    expect = sssp_naive(adj, w, 0)
    finite = np.isfinite(expect)
    # tolerance: f32 path sums in another order than the oracle's
    np.testing.assert_allclose(got[finite], expect[finite], rtol=1e-5)
    assert np.all(np.isinf(got[~finite]))


def test_pr_vs_naive():
    n = 80
    A = random_undirected(n, 5, 3).astype(np.float32)
    alpha, eps = 0.85, 1e-5
    # reference examples scale A[i,j] = alpha / outdeg(j) before pr
    outdeg = np.asarray(A.sum(axis=0)).ravel()
    outdeg[outdeg == 0] = 1.0
    As = A.multiply(alpha / outdeg).tocsr().astype(np.float32)
    Ac = F.csr_from_scipy(As)
    got = np.asarray(pr(Ac, alpha, eps).values)
    adj_in, w_in = to_adj(As)
    expect = pr_naive(adj_in, w_in, alpha, eps)
    # tolerance: f32 power iteration stopped at eps; the sum order of
    # each step differs from the oracle's
    np.testing.assert_allclose(got, expect, rtol=1e-3, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1])
def test_tc_vs_naive(seed):
    A = random_undirected(60, 8, seed).astype(np.int32)
    Ac = F.csr_from_scipy(A)
    adj, _ = to_adj(A)
    assert tc(Ac) == tc_naive(adj)


# ---------------------------------------------------------------------------
# Directed graphs: the default At must be a true transpose, not A
# (round-3 fix: At=A silently walked reversed edges on directed inputs;
# reference bfs/sssp handle directed graphs with just A,
# ``src/algorithm.cpp:45-120,158-229``)
# ---------------------------------------------------------------------------


def random_directed(n, avg_deg, seed, weighted=False):
    rng = np.random.default_rng(seed)
    m = n * avg_deg
    r = rng.integers(0, n, m)
    c = rng.integers(0, n, m)
    keep = r != c
    r, c = r[keep], c[keep]
    vals = (rng.uniform(0.1, 2.0, r.size).astype(np.float32)
            if weighted else np.ones(r.size, np.int32))
    A = sp.coo_matrix((vals, (r, c)), shape=(n, n))
    A.sum_duplicates()
    if not weighted:
        A.data[:] = 1
    return A.tocsr()


@pytest.mark.parametrize("seed", [0, 1])
def test_bfs_directed_vs_naive(seed):
    A = random_directed(120, 5, seed)
    adj, _ = to_adj(A)
    Ac = F.csr_from_scipy(A.astype(np.int32))
    got = np.asarray(bfs(Ac, 0).values)  # no At: default must transpose
    expect = bfs_naive(adj, 0)
    np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize("seed", [0, 1])
def test_sssp_directed_vs_naive(seed):
    A = random_directed(110, 5, seed, weighted=True)
    adj, w = to_adj(A)
    Ac = F.csr_from_scipy(A, dtype=np.float32)
    got = np.asarray(sssp(Ac, 0).values)
    expect = sssp_naive(adj, w, 0)
    finite = np.isfinite(expect)
    # tolerance: f32 path sums in another order than the oracle's
    np.testing.assert_allclose(got[finite], expect[finite], rtol=1e-5)
    assert np.all(np.isinf(got[~finite]))


def test_default_At_symmetric_reuses_A():
    # symmetric input: the cached default At must be A itself so
    # packed-format caches keyed on A still hit
    from spla_tpu.algorithms import _default_At

    A = random_undirected(80, 5, 4, weighted=True)
    Ac = F.csr_from_scipy(A, dtype=np.float32)
    assert _default_At(Ac) is Ac
    # directed input: must be a real transpose, cached across calls
    D = random_directed(80, 5, 5, weighted=True)
    Dc = F.csr_from_scipy(D, dtype=np.float32)
    T1 = _default_At(Dc)
    assert T1 is not Dc
    assert _default_At(Dc) is T1
    got = sp.csr_matrix(
        (np.asarray(T1.values), np.asarray(T1.cols), np.asarray(T1.indptr)),
        shape=D.shape).toarray()
    # exact: elementwise copies/negation of f32 values, no arithmetic
    np.testing.assert_allclose(got, D.T.toarray())
