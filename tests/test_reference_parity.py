"""Cross-validation against the ACTUAL reference framework (spla).

North-star clause (BASELINE.json / BASELINE.md): "bit-exact vs reference
results on integer/boolean semirings; float tolerance on BFS/SSSP/
PageRank/TC".  These tests build the reference CPU-only from
``/root/reference`` (``cmake -DSPLA_BUILD_OPENCL=OFF``), run its public
algorithms (``include/spla/algorithm.hpp:54-175``) and exec ops (via its
own pyspla ctypes package) on shared generated graphs spanning the
published dataset's classes (BASELINE.md: uniform meshes, power-law
social graphs, road grids, scale-free RMAT), and compare raw outputs:

* BFS levels, triangle counts, INT exec ops — **bit-exact**;
* SSSP distances, PageRank — float tolerance (both frameworks iterate
  the same f32 recurrences; SSSP in practice agrees bitwise, asserted
  as allclose + identical reached sets).

Documented deliberate differences (asserted below, not papered over):

1. unreached SSSP slots: reference fills ``FLT_MAX``
   (``src/algorithm.cpp:166``), spla_tpu fills ``+inf`` — normalized by
   ``parity.unreached_mask``.
2. the reference's pull/adaptive traversal reads A's ROWS (outgoing
   edges: ``exec_mxv_masked(..., A, ...)``, ``src/algorithm.cpp:98``),
   which is wrong on directed graphs — its loader force-undirects by
   default and its dataset is undirected, so this never bites upstream.
   spla_tpu pulls over the cached transpose and is direction-correct;
   the parity runs therefore pin the reference to push mode
   (direction-correct on both), and `test_directed_pull_is_reference_
   limitation` pins the discrepancy itself.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import parity  # noqa: E402

from spla_tpu import algorithms as alg  # noqa: E402
from spla_tpu import formats as F  # noqa: E402

pytestmark = pytest.mark.skipif(
    not parity.try_build_reference(),
    reason="reference tree/toolchain unavailable (needs /root/reference)",
)

GRAPH_KEYS = list(parity.GRAPHS)


def _graph(key):
    return parity.GRAPHS[key]()


def _our_csr(n, rows, cols, vals):
    a = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    return F.csr_from_scipy(a)


def _mtx(tmp_path, key, n, rows, cols, vals=None):
    p = tmp_path / f"{key}.mtx"
    parity.write_mtx(p, n, rows, cols, vals)
    return p


@pytest.mark.parametrize("key", GRAPH_KEYS)
def test_bfs_levels_bitexact(key, tmp_path):
    n, rows, cols, _ = _graph(key)
    mtx = _mtx(tmp_path, key, n, rows, cols)
    ref = parity.run_reference("bfs", mtx, tmp_path / "ref.txt", source=0)
    ours = np.asarray(
        alg.bfs(_our_csr(n, rows, cols, np.ones(rows.size, np.float32)),
                0).values)
    np.testing.assert_array_equal(ours.astype(np.int64), ref)


@pytest.mark.parametrize("key", GRAPH_KEYS)
def test_sssp_distances(key, tmp_path):
    n, rows, cols, vals = _graph(key)
    mtx = _mtx(tmp_path, key, n, rows, cols, vals)
    ref, ref_bits = parity.run_reference("sssp", mtx, tmp_path / "ref.txt",
                                         source=0)
    ours = np.asarray(alg.sssp(_our_csr(n, rows, cols, vals), 0).values)
    m_ref = parity.unreached_mask(ref)
    m_our = parity.unreached_mask(ours)
    np.testing.assert_array_equal(m_our, m_ref)
    # tolerance: f32 path sums; the reference adds in another order
    np.testing.assert_allclose(ours[~m_our], ref[~m_ref], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("key", GRAPH_KEYS)
def test_pagerank(key, tmp_path):
    n, rows, cols, _ = _graph(key)
    mtx = _mtx(tmp_path, key, n, rows, cols)
    ref, _ = parity.run_reference("pr", mtx, tmp_path / "ref.txt")
    # the reference harness pre-normalizes A[i,j] = alpha/outdeg(i)
    # (examples/pr.cpp:82-89); build the identical f32 matrix here
    alpha = np.float32(0.85)
    deg = np.bincount(rows, minlength=n).astype(np.float32)
    scaled = (alpha / deg[rows]).astype(np.float32)
    ours = np.asarray(alg.pr(_our_csr(n, rows, cols, scaled),
                             alpha=0.85, eps=1e-6).values)
    # tolerance: f32 power iteration; the reference sums in another order
    assert abs(ours.sum() - ref.sum()) < 1e-3
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("key", GRAPH_KEYS)
def test_triangle_count_bitexact(key, tmp_path):
    n, rows, cols, _ = _graph(key)
    mtx = _mtx(tmp_path, key, n, rows, cols)
    (ref,) = parity.run_reference("tc", mtx, tmp_path / "ref.txt")
    # lower-triangle orientation, per the reference harness
    # (examples/tc.cpp:83-88)
    keep = rows > cols
    ours = alg.tc(_our_csr(n, rows[keep], cols[keep],
                           np.ones(int(keep.sum()), np.float32)))
    assert int(ours) == int(ref)


def test_directed_push_parity(tmp_path):
    """Directed graph, push mode on both sides: exact agreement."""
    n, rows, cols, vals = parity.gen_directed()
    mtx = _mtx(tmp_path, "directed", n, rows, cols, vals)
    ref = parity.run_reference("bfs", mtx, tmp_path / "b.txt", source=0,
                               mode="push")
    A = _our_csr(n, rows, cols, vals)
    ours = np.asarray(alg.bfs(A, 0).values)
    np.testing.assert_array_equal(ours.astype(np.int64), ref)
    refs, _ = parity.run_reference("sssp", mtx, tmp_path / "s.txt",
                                   source=0, mode="push")
    ourss = np.asarray(alg.sssp(A, 0).values)
    m = parity.unreached_mask(refs)
    np.testing.assert_array_equal(parity.unreached_mask(ourss), m)
    # tolerance: f32 path sums; the reference adds in another order
    np.testing.assert_allclose(ourss[~m], refs[~m], rtol=1e-6, atol=1e-6)


def test_directed_pull_is_reference_limitation(tmp_path):
    """Documented difference #2: reference pull-BFS on a DIRECTED graph
    traverses outgoing edges (undirected-only semantics); spla_tpu pulls
    over the transpose and matches the true (naive-oracle) levels."""
    n, rows, cols, vals = parity.gen_directed()
    mtx = _mtx(tmp_path, "directed", n, rows, cols, vals)
    ref_pull = parity.run_reference("bfs", mtx, tmp_path / "b.txt",
                                    source=0, mode="pull")
    A = _our_csr(n, rows, cols, vals)
    ours = np.asarray(alg.bfs(A, 0).values)
    adj = [[] for _ in range(n)]
    for r, c in zip(rows, cols):
        adj[r].append(c)
    oracle = alg.bfs_naive(adj, 0)
    np.testing.assert_array_equal(ours, oracle)  # we match the truth
    assert not np.array_equal(ref_pull, oracle)  # the reference doesn't


def _pyspla():
    os.environ.setdefault("SPLA_PATH", str(parity.REFLIB))
    sys.path.insert(0, str(parity.REF_SRC / "python"))
    import pyspla

    return pyspla


def test_exec_ops_int_bitexact():
    """Op-level INT parity via the reference's own pyspla package over
    the same built .so: mxv/vxm/eadd/emult/reduce bit-exact vs spla_tpu
    (the north star's integer-semiring clause at the exec layer)."""
    ps = _pyspla()
    from spla_tpu import op
    from spla_tpu.containers import DenseVec
    from spla_tpu.ops.matrix import m_reduce
    from spla_tpu.ops.spmv import mxv_masked, vxm_masked
    from spla_tpu.ops.vector import v_eadd, v_emult, v_reduce

    rng = np.random.default_rng(13)
    n = 64
    a = sp.random(n, n, density=0.12, random_state=3)
    a.data = rng.integers(1, 100, a.nnz).astype(np.float64)
    a = a.tocsr()
    a.sum_duplicates()
    coo = a.tocoo()
    I, J = coo.row.astype(int), coo.col.astype(int)
    V = coo.data.astype(np.int64)

    M_ref = ps.Matrix.from_lists(list(I), list(J), [int(v) for v in V],
                                 (n, n), ps.INT)
    xs = rng.integers(0, 50, n)
    x_ref = ps.Vector.from_lists(list(range(n)), [int(v) for v in xs], n,
                                 ps.INT)
    ones = ps.Vector.from_lists(list(range(n)), [1] * n, n, ps.INT)

    A_t = F.csr_from_scipy(sp.csr_matrix(
        (V.astype(np.int32), (I, J)), shape=(n, n)))
    x_t = DenseVec(jnp.asarray(xs.astype(np.int32)), jnp.int32(0))
    mask_t = DenseVec(jnp.asarray(np.ones(n, np.int32)), jnp.int32(0))

    # mxv over (MULT, PLUS) masked GTZERO
    r_ref = M_ref.mxv(ones, x_ref, ps.INT.MULT, ps.INT.PLUS,
                      ps.INT.GTZERO)
    ri, rv = r_ref.to_lists()
    dense_ref = np.zeros(n, np.int64)
    dense_ref[np.asarray(ri, int)] = np.asarray(rv, int)
    r_t = mxv_masked(mask_t, A_t, x_t, op.MULT_INT, op.PLUS_INT,
                     op.GTZERO_INT, 0)
    np.testing.assert_array_equal(np.asarray(r_t.values, np.int64),
                                  dense_ref)

    # vxm over (MULT, PLUS) masked GTZERO (push orientation)
    rv_ref = x_ref.vxm(ones, M_ref, ps.INT.MULT, ps.INT.PLUS,
                       ps.INT.GTZERO)
    ri2, rv2 = rv_ref.to_lists()
    At = F.csr_transpose_host(A_t)
    r2 = vxm_masked(mask_t, x_t, At, op.MULT_INT, op.PLUS_INT,
                    op.GTZERO_INT, 0)
    k = int(np.asarray(r2.nnz))
    got = dict(zip(np.asarray(r2.indices)[:k].tolist(),
                   np.asarray(r2.values)[:k].tolist()))
    want = dict(zip(np.asarray(ri2, int).tolist(),
                    np.asarray(rv2, int).tolist()))
    # stored-but-zero entries are representationally different between
    # the two (reference keeps products that sum to 0; so do we) —
    # compare as maps
    assert got == want

    # eadd / emult (PLUS / MULT)
    ys = rng.integers(0, 50, n)
    y_ref = ps.Vector.from_lists(list(range(n)), [int(v) for v in ys], n,
                                 ps.INT)
    y_t = DenseVec(jnp.asarray(ys.astype(np.int32)), jnp.int32(0))
    e_ref = x_ref.eadd(ps.INT.PLUS, y_ref)
    ei, ev = e_ref.to_lists()
    e_t = v_eadd(x_t, y_t, op.PLUS_INT)
    dense = np.zeros(n, np.int64)
    dense[np.asarray(ei, int)] = np.asarray(ev, int)
    np.testing.assert_array_equal(np.asarray(e_t.values, np.int64), dense)

    m_ref2 = x_ref.emult(ps.INT.MULT, y_ref)
    mi, mv = m_ref2.to_lists()
    m_t = v_emult(x_t, y_t, op.MULT_INT)
    dense = np.zeros(n, np.int64)
    dense[np.asarray(mi, int)] = np.asarray(mv, int)
    np.testing.assert_array_equal(np.asarray(m_t.values, np.int64), dense)

    # reductions (scalar get through each framework's own surface)
    s_ref = int(x_ref.reduce(ps.INT.PLUS).get())
    s_t = int(np.asarray(v_reduce(0, x_t, op.PLUS_INT).value))
    assert s_t == s_ref == int(xs.sum())

    mr_ref = int(M_ref.reduce(ps.INT.PLUS).get())
    mr_t = int(np.asarray(m_reduce(0, A_t, op.PLUS_INT).value))
    assert mr_t == mr_ref == int(V.sum())
