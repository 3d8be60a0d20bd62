#!/usr/bin/env python3
"""End-to-end smoke test of spla_tpu on one GPU.

Drives the public surface (``spla_tpu.ops``, ``spla_tpu.algorithms``,
``spla_tpu.facade``, the example CLIs and, with ``--four-cards``,
``spla_tpu.parallel``) once at graph sizes users of a GraphBLAS run,
and compares every result with an independent scipy/numpy reference in
float64:

* G1: uniform, n = 2^21, 16 stored entries per row (33.5M entries; the
  class of cit-Patents and soc-LiveJournal);
* G2: zipf-2.1 hub rows and columns, n = 2^18;
* G3: Morton-ordered road grid, 1024 x 1024 (2046 BFS levels);
* TC: uniform n = 2^20, 16 per row (halved while its product count does
  not fit the card).

Graphs are generated from ``--seed``.  Each phase prints one line per
check with its error beside its tolerance; any failed check or exception
ends the run with a non-zero exit.  The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

    python chip_smoke.py              # one card
    python chip_smoke.py --four-cards # spla_tpu.parallel on four cards

Float comparisons state their tolerance and its reason; MIN, MAX,
integer and boolean results are compared exactly.  The script refuses to
run without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import scipy.sparse as sp
from scipy.sparse import csgraph

INFO = "informational, not a benchmark metric"


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def check(phase, name, ok, detail):
    say(phase, f"{name}: {detail} -> {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{phase}/{name} failed: {detail}")


def check_close(phase, name, got, want, rel, reason):
    """max |got - want| <= rel * max |want| (the reference in float64)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    tol = rel * float(np.max(np.abs(want))) if want.size else 0.0
    check(phase, name, err <= tol,
          f"max abs err {err:.3e} <= {tol:.3e} ({rel:g} x max|ref|; {reason})")


def sum_rel_tol(terms):
    """Relative tolerance of an f32 sum of ``terms`` terms taken in an
    unknown order: 1e-5, or 4 ulps x sqrt(terms) where that is larger
    (rounding errors of a long sum grow as its square root)."""
    return max(1e-5, 4 * np.sqrt(terms) * 2.0 ** -24)


def check_equal(phase, name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    bad = int(np.count_nonzero(got != want)) if got.shape == want.shape else -1
    check(phase, name, bad == 0,
          f"{bad} of {want.size} differ (exact)" if bad >= 0
          else f"shape {got.shape} != {want.shape}")


def nvidia_smi():
    """Card name and power limit, read by a child that never imports JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


# ---------------------------------------------------------------------------
# graph generators (numpy rng.integers; scipy.sparse.random is not used)
# ---------------------------------------------------------------------------


def uniform_graph(n, deg, rng):
    """Symmetric 0/1 pattern, ~deg stored entries per row, no loops."""
    m = n * deg // 2
    r = rng.integers(0, n, m, dtype=np.int64)
    c = rng.integers(0, n, m, dtype=np.int64)
    keep = r != c
    r, c = r[keep], c[keep]
    A = sp.csr_matrix(
        (np.ones(2 * r.size, np.float32),
         (np.concatenate([r, c]), np.concatenate([c, r]))), shape=(n, n))
    A.sum_duplicates()
    A.data[:] = 1.0
    return A


def zipf_graph(n, rng):
    """zipf-2.1 out-degrees (x8, capped at n/4) with uniform targets,
    symmetrized: hub rows and hub columns."""
    deg = np.minimum(rng.zipf(2.1, n) * 8, n // 4).astype(np.int64)
    r = np.repeat(np.arange(n, dtype=np.int64), deg)
    c = rng.integers(0, n, r.size, dtype=np.int64)
    keep = r != c
    r, c = r[keep], c[keep]
    A = sp.csr_matrix(
        (np.ones(2 * r.size, np.float32),
         (np.concatenate([r, c]), np.concatenate([c, r]))), shape=(n, n))
    A.sum_duplicates()
    A.data[:] = 1.0
    return A


def road_grid(side):
    """Morton-ordered side x side 4-neighbour grid (side a power of two):
    ~2*side BFS levels of tiny frontiers."""

    def spread(v):
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    xs, ys = np.meshgrid(np.arange(side, dtype=np.int64),
                         np.arange(side, dtype=np.int64), indexing="ij")
    rows, cols = [], []
    for dx, dy in ((1, 0), (0, 1)):
        x2, y2 = xs[: side - dx, : side - dy], ys[: side - dx, : side - dy]
        a = spread(x2.ravel()) | (spread(y2.ravel()) << 1)
        b = spread((x2 + dx).ravel()) | (spread((y2 + dy).ravel()) << 1)
        rows += [a, b]
        cols += [b, a]
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    n = side * side
    return sp.csr_matrix((np.ones(r.size, np.float32), (r, c)), shape=(n, n))


def sym_weights(A):
    """Symmetric f32 weights in [0.1, 1.1) hashed from the unordered pair
    (a transpose-free way to weight a symmetric pattern)."""
    rows = np.repeat(np.arange(A.shape[0], dtype=np.int64), np.diff(A.indptr))
    cols = A.indices.astype(np.int64)
    lo, hi = np.minimum(rows, cols), np.maximum(rows, cols)
    W = A.copy()
    W.data = (0.1 + ((lo * 2654435761 + hi) % 1000) / 1000.0).astype(np.float32)
    return W


def pagerank_matrix(A, alpha=0.85):
    outdeg = np.asarray(A.sum(axis=0)).ravel()
    outdeg[outdeg == 0] = 1
    return (A @ sp.diags((alpha / outdeg).astype(np.float32))).tocsr()


def bfs_ref(A, src):
    """1-based BFS depths, 0 = unreachable (the library's convention)."""
    d = csgraph.shortest_path(A, unweighted=True, indices=src)
    return np.where(np.isfinite(d), d + 1, 0).astype(np.int64)


def pr_ref(S, alpha, eps):
    """float64 power iteration with the library's stopping rule."""
    n = S.shape[0]
    S64 = S.astype(np.float64)
    p = np.full(n, 1.0 / n)
    for _ in range(10_000):
        q = S64 @ p + (1.0 - alpha) / n
        err = np.sqrt(((q - p) ** 2).sum())
        p = q
        if err <= eps:
            break
    return p


def tc_ref(A):
    """Triangles x 6 (the library's convention for the full adjacency)."""
    L = sp.tril(A, k=-1).tocsr()
    return int((L @ L).multiply(L).sum()) * 6


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(jax):
    d = jax.devices()[0]
    say("device", f"platform={d.platform} kind={d.device_kind} "
                  f"count={len(jax.devices())}")
    card = nvidia_smi()
    print(card, flush=True)  # name, power.limit as nvidia-smi prints them
    return card.replace("\n", "; ")  # one line per card


def phase_spmv(G1, G2, rng):
    import jax.numpy as jnp

    from spla_tpu import formats as F
    from spla_tpu import op
    from spla_tpu.containers import DenseVec
    from spla_tpu.ops import mxv_masked, vxm_masked

    for name, A in (("G1", G1), ("G2", G2)):
        n = A.shape[0]
        W = A.copy()
        W.data = rng.random(W.nnz, dtype=np.float32)
        Ac = F.csr_from_scipy(W)
        x = rng.random(n, dtype=np.float32)
        ones = DenseVec(jnp.ones((n,), jnp.float32), jnp.float32(0))
        r = mxv_masked(ones, Ac, DenseVec(jnp.asarray(x), jnp.float32(0)),
                       op.MULT_FLOAT, op.PLUS_FLOAT, op.ALWAYS_FLOAT, 0.0)
        d_max = int(np.diff(W.indptr).max())
        check_close("spmv", f"{name} mxv_masked plus-times f32 (nnz={W.nnz})",
                    r.values, W.astype(np.float64) @ x, sum_rel_tol(d_max),
                    f"f32 sums of up to {d_max} terms in atomic order")

    # min-plus push from a 1% sparse frontier: exact (one f32 add per
    # product, MIN is order-free)
    n = G1.shape[0]
    Wt = sym_weights(G1)
    Wc = F.csr_from_scipy(Wt)
    front = np.sort(rng.choice(n, n // 100, replace=False))
    fvals = rng.random(front.size, dtype=np.float32)
    v = F.sparse_vec_from_entries(n, front, fvals, fill=np.inf,
                                  dtype=np.float32)
    mask = DenseVec(jnp.ones((n,), jnp.float32), jnp.float32(0))
    r = vxm_masked(mask, v, Wc, op.PLUS_FLOAT, op.MIN_FLOAT, op.ALWAYS_FLOAT,
                   np.inf)  # symmetric: the transpose is the matrix itself
    rows = np.repeat(np.arange(n), np.diff(Wt.indptr))
    xv = np.full(n, np.inf, np.float32)
    xv[front] = fvals
    live = np.isfinite(xv[rows])
    want = np.full(n, np.inf, np.float32)
    np.minimum.at(want, Wt.indices[live], xv[rows[live]] + Wt.data[live])
    got = np.asarray(F.sparse_to_dense_vec(r).values)
    check_equal("spmv", "G1 vxm_masked min-plus from 1% frontier", got, want)
    nnz = int(r.nnz)
    check_equal("spmv", "G1 vxm_masked stored set",
                np.asarray(r.indices)[:nnz], np.nonzero(np.isfinite(want))[0])

    # int32 PLUS-TIMES: exact (no overflow at these magnitudes)
    Wi = G1.copy().astype(np.int32)
    Wi.data = rng.integers(-100, 100, Wi.nnz).astype(np.int32)
    xi = rng.integers(-100, 100, n).astype(np.int32)
    ri = mxv_masked(DenseVec(jnp.ones((n,), jnp.int32), jnp.int32(0)),
                    F.csr_from_scipy(Wi), DenseVec(jnp.asarray(xi), jnp.int32(0)),
                    op.MULT_INT, op.PLUS_INT, op.ALWAYS_INT, 0)
    check_equal("spmv", "G1 mxv_masked int32 plus-times", ri.values,
                Wi.astype(np.int64) @ xi.astype(np.int64))

    # BAND/BOR (the reference BFS semiring) over a 0/1 pattern: exact
    P = G1.copy().astype(np.int32)
    xb = (rng.random(n) < 0.05).astype(np.int32)
    unvisited = (rng.random(n) < 0.5).astype(np.int32)
    rb = mxv_masked(DenseVec(jnp.asarray(unvisited), jnp.int32(0)),
                    F.csr_from_scipy(P), DenseVec(jnp.asarray(xb), jnp.int32(0)),
                    op.BAND_INT, op.BOR_INT, op.NQZERO_INT, 0)
    want_b = ((P.astype(np.int64) @ xb) > 0).astype(np.int64) * unvisited
    check_equal("spmv", "G1 mxv_masked BAND/BOR masked", rb.values, want_b)


def phase_algorithms(G1, G3, tc_n, rng, timings):
    """Checks each algorithm, adds a re-run of it to ``timings`` and
    returns the PageRank matrix and eps (for the memory analysis)."""
    from spla_tpu import algorithms as alg
    from spla_tpu import formats as F

    # one source for BFS and SSSP (a vertex with neighbours)
    src = int(np.argmax(np.diff(G1.indptr) > 0))
    A1 = F.csr_from_scipy(G1.astype(np.int32))
    for name, A, Ac in (("G1", G1, A1),
                        ("G3", G3, F.csr_from_scipy(G3.astype(np.int32)))):
        s = src if name == "G1" else 0
        lev = alg.bfs(Ac, s, At=Ac)  # symmetric
        check_equal("algorithms", f"{name} bfs levels", lev.values,
                    bfs_ref(A, s))
        timings[f"bfs {name}"] = lambda Ac=Ac, s=s: alg.bfs(Ac, s, At=Ac).values

    W = sym_weights(G1)
    Wc = F.csr_from_scipy(W)
    dist = np.asarray(alg.sssp(Wc, src, At=Wc).values)
    ref = csgraph.dijkstra(W.astype(np.float64), indices=src)
    check_equal("algorithms", "G1 sssp reachable set", np.isfinite(dist),
                np.isfinite(ref))
    fin = np.isfinite(ref)
    rel = float(np.max(np.abs(dist[fin] - ref[fin]) / np.maximum(ref[fin],
                                                                  1e-30)))
    check("algorithms", "G1 sssp vs float64 Dijkstra", rel <= 1e-5,
          f"max rel err {rel:.3e} <= 1e-5 (f32 path sums)")
    timings["sssp G1"] = lambda: alg.sssp(Wc, src, At=Wc).values

    # eps 1e-9: both iterations then stop within 1e-6 (L1) of their fixed
    # points; at eps 1e-6 a stop one step apart alone moves L1 by ~1e-3
    S = pagerank_matrix(G1)
    Sc = F.csr_from_scipy(S)
    eps = 1e-9
    p = np.asarray(alg.pr(Sc, 0.85, eps).values)
    l1 = float(np.abs(p - pr_ref(S, 0.85, eps)).sum())
    check("algorithms", "G1 pr vs float64 power iteration", l1 <= 1e-5,
          f"L1 diff {l1:.3e} <= 1e-5 (f32 sums in atomic order; eps={eps})")
    timings["pr G1"] = lambda: alg.pr(Sc, 0.85, eps).values

    T = uniform_graph(tc_n, 16, rng)
    Tc = F.csr_from_scipy(T.astype(np.int32))
    got = alg.tc(Tc)
    check("algorithms", f"tc n={tc_n} vs scipy (L@L).*L x6", got == tc_ref(T),
          f"{got} == {tc_ref(T)} (exact)")
    timings[f"tc n={tc_n}"] = lambda: alg.tc(Tc)
    return Sc, eps


def tc_size(n, mem_limit, bytes_per_product=64):
    """Largest n (halving from ``n``) whose masked-SpGEMM product count,
    at ``bytes_per_product`` bytes of device work arrays each, takes at
    most half the card's memory.  Returns (n, products, reason)."""
    while True:
        # E[sum_j deg(j)^2] for Poisson(16) degrees: n * (16^2 + 16)
        products = n * (16 * 16 + 16)
        need = products * bytes_per_product
        if need <= mem_limit // 2 or n <= 1 << 14:
            return n, products, (
                f"~{products / 1e6:.0f}M products x {bytes_per_product} B "
                f"= {need / 2**30:.1f} GiB <= half of "
                f"{mem_limit / 2**30:.1f} GiB")
        n //= 2


def phase_spgemm(rng, n_esc=1 << 16):
    from spla_tpu import formats as F
    from spla_tpu import op
    from spla_tpu.ops import count_mxm_products, mxm, mxmT_masked
    from spla_tpu.ops.spgemm import (
        MXM_BLOCK_THRESHOLD,
        MXM_DENSE_CAP,
        MXM_DENSE_MIN_PRODUCTS,
    )

    for n, deg in ((n_esc, 16), (4096, 16), (8192, 32)):
        A = uniform_graph(n, deg, rng)
        A.data = rng.random(A.nnz, dtype=np.float32)
        Ac = F.csr_from_scipy(A)
        prods = count_mxm_products(Ac, Ac)
        # the path mxm takes for this shape, by its own thresholds
        if prods >= MXM_DENSE_MIN_PRODUCTS and n * n <= MXM_DENSE_CAP:
            path = "dense"
        elif prods > MXM_BLOCK_THRESHOLD:
            path = "blocked ESC"
        else:
            path = "ESC"
        R = mxm(Ac, Ac, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
        nnz = int(R.nnz)
        got = sp.csr_matrix(
            (np.asarray(R.values)[:nnz],
             (np.asarray(R.row_ids)[:nnz], np.asarray(R.cols)[:nnz])),
            shape=(n, n))
        want = (A.astype(np.float64) @ A.astype(np.float64)).tocsr()
        check("spgemm", f"mxm n={n} {path} path ({prods} products) stored "
              "count", got.nnz == want.nnz, f"{got.nnz} == {want.nnz} (exact)")
        diff = abs(got - want)
        err = float(diff.max()) if diff.nnz else 0.0
        tol = 1e-5 * float(abs(want).max())
        check("spgemm", f"mxm n={n} {path} path values", err <= tol,
              f"max abs err {err:.3e} <= {tol:.3e} (1e-5 x max|ref|; f32 "
              "sums in another order; TF32 would miss by ~1e-3)")

    # masked A * A^T over min-plus: exact (one f32 add per product)
    A = uniform_graph(n_esc, 16, rng)
    W = sym_weights(A)
    Wc = F.csr_from_scipy(W)
    R = mxmT_masked(Wc, Wc, Wc, op.PLUS_FLOAT, op.MIN_FLOAT, op.ALWAYS_FLOAT,
                    np.inf)
    want_r, want_c, want_v = mxmT_minplus_ref(W)
    nnz = int(R.nnz)
    check_equal("spgemm", f"mxmT_masked min-plus n={n_esc} stored set",
                np.stack([np.asarray(R.row_ids)[:nnz],
                          np.asarray(R.cols)[:nnz]]),
                np.stack([want_r, want_c]))
    check_equal("spgemm", f"mxmT_masked min-plus n={n_esc} values",
                np.asarray(R.values)[:nnz], want_v)


def mxmT_minplus_ref(W):
    """For each stored (i, j) of W: min over k in row i and row j of
    W[i,k] + W[j,k]; entries with no common k are not stored."""
    n = W.shape[0]
    W = W.tocsr()
    W.sort_indices()
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(W.indptr))
    cols = W.indices.astype(np.int64)
    deg = np.diff(W.indptr).astype(np.int64)
    # expand each mask entry (i, j) over row j: k = W.indices[...]
    cnt = deg[cols]
    src = np.repeat(np.arange(cols.size), cnt)
    start = np.repeat(W.indptr[cols], cnt)
    local = np.arange(src.size) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    pos_j = start + local
    k = cols[pos_j]
    i = rows[src]
    keys = rows * n + cols  # sorted (CSR order, sorted indices)
    q = i * n + k
    at = np.searchsorted(keys, q)
    at_c = np.minimum(at, keys.size - 1)
    found = keys[at_c] == q
    prod = np.where(found, W.data[at_c] + W.data[pos_j], np.float32(np.inf))
    folded = np.full(cols.size, np.inf, np.float32)
    np.minimum.at(folded, src, prod.astype(np.float32))
    keep = np.isfinite(folded)
    return rows[keep], cols[keep], folded[keep]


def phase_facade_cli(rng, side=256):
    from spla_tpu import FLOAT
    from spla_tpu.facade import Matrix, Vector
    from spla_tpu.io import MtxLoader

    import examples.bfs
    import examples.pr
    from examples.common import acc_device

    n = 4096
    A = uniform_graph(n, 8, rng).tocoo()
    vals = rng.random(A.nnz, dtype=np.float32)
    M = Matrix.from_lists(A.row, A.col, vals, (n, n), FLOAT)
    x = rng.random(n, dtype=np.float32)
    v = Vector.from_lists(np.arange(n), x, n, FLOAT)
    mask = Vector.from_lists(np.arange(n), np.ones(n, np.float32), n, FLOAT)
    r = M.mxv(mask, v, FLOAT.MULT, FLOAT.PLUS, FLOAT.ALWAYS)
    ref = sp.csr_matrix((vals, (A.row, A.col)), shape=(n, n)).astype(
        np.float64) @ x
    check_close("facade", "Matrix.mxv plus-times", r.to_numpy(), ref, 1e-5,
                "f32 sums in atomic order")
    y = rng.random(n, dtype=np.float32)
    w = Vector.from_lists(np.arange(n), y, n, FLOAT)
    e = v.eadd(FLOAT.PLUS, w)
    check_equal("facade", "Vector.eadd plus", e.to_numpy(), x + y)

    dev = acc_device()
    check("facade", "examples acc_device() is the GPU", dev.platform == "gpu",
          f"platform={dev.platform}")
    G = road_grid(side).tocoo()
    loader = MtxLoader(verbose=False)
    loader.n_rows = loader.n_cols = side * side
    loader.rows, loader.cols = G.row.astype(np.int64), G.col.astype(np.int64)
    loader.vals = np.ones(G.nnz, np.float64)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "road.mtx")
        loader.save(path)
        common = ["--mtxpath", path, "--niters", "2", "--verbose", "false",
                  "--run-cpu", "false"]
        rc = examples.bfs.run(common + ["--source", "0"])
        check("facade", f"examples.bfs on road grid n={side * side}", rc == 0,
              f"rc={rc} (its own verify against bfs_naive)")
        rc = examples.pr.run(common)
        check("facade", f"examples.pr on road grid n={side * side}", rc == 0,
              f"rc={rc} (its own verify against pr_naive)")


def phase_cost(jax, card, timings, pr_matrix, eps):
    """Times after warm-up: every call below already ran once."""
    from spla_tpu import algorithms as alg

    tag = f"({INFO}; card: {card})"
    for name, fn in timings.items():
        fn()  # warm (compiled already; re-warm any host-side cache)
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready(out)
        say("cost", f"{name}: {(time.perf_counter() - t0) * 1e3:.3f} ms {tag}")
    pr_loop = jax.jit(lambda A: alg.pr(A, 0.85, eps).values)
    t0 = time.perf_counter()
    compiled = pr_loop.lower(pr_matrix).compile()
    say("cost", f"pr G1 loop compile: {time.perf_counter() - t0:.3f} s {tag}")
    say("cost", f"pr G1 loop memory_analysis: {compiled.memory_analysis()} "
                f"{tag}")
    stats = jax.devices()[0].memory_stats() or {}
    say("cost", f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')} {tag}")


def spmv_time(jax, A, iters=20):
    """Mean ms of one G1 plus-times ``mxv_masked``, back to back, after
    warm-up."""
    import jax.numpy as jnp

    from spla_tpu import op
    from spla_tpu.containers import DenseVec
    from spla_tpu.ops import mxv_masked

    n = A.shape[0]
    ones = DenseVec(jnp.ones((n,), jnp.float32), jnp.float32(0))
    x = DenseVec(jnp.ones((n,), jnp.float32), jnp.float32(0))

    def run():
        return mxv_masked(ones, A, x, op.MULT_FLOAT, op.PLUS_FLOAT,
                          op.ALWAYS_FLOAT, 0.0).values

    run().block_until_ready()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = run()
    out.block_until_ready()
    return (time.perf_counter() - t0) / iters * 1e3


def one_card(jax, seed, n1=1 << 21, n2=1 << 18, side3=1024, tc_n=1 << 20,
             n_esc=1 << 16, side_cli=256):
    from spla_tpu import formats as F

    rng = np.random.default_rng(seed)
    card = phase_device(jax)
    t0 = time.perf_counter()
    G1 = uniform_graph(n1, 16, rng)
    G2 = zipf_graph(n2, rng)
    G3 = road_grid(side3)
    say("graphs", f"G1 uniform n={n1} nnz={G1.nnz}; G2 zipf-2.1 n={n2} "
                  f"nnz={G2.nnz} max deg={np.diff(G2.indptr).max()}; G3 road "
                  f"n={side3 * side3} nnz={G3.nnz}; built in "
                  f"{time.perf_counter() - t0:.1f} s")
    phase_spmv(G1, G2, rng)
    stats = jax.devices()[0].memory_stats() or {}
    limit = int(stats.get("bytes_limit", 64 << 30))
    tc_n, prods, reason = tc_size(tc_n, limit)
    say("algorithms", f"tc uses n={tc_n}: {reason}")
    timings = {}
    pr_matrix, eps = phase_algorithms(G1, G3, tc_n, rng, timings)
    phase_spgemm(rng, n_esc)
    phase_facade_cli(rng, side_cli)
    W = G1.copy()
    W.data = rng.random(W.nnz, dtype=np.float32)
    ms = spmv_time(jax, F.csr_from_scipy(W))
    say("cost", f"G1 mxv_masked plus-times: {ms:.4f} ms per SpMV "
                f"({G1.nnz / ms / 1e6:.3f} G entries/s) ({INFO}; card: {card})")
    phase_cost(jax, card, timings, pr_matrix, eps)


# ---------------------------------------------------------------------------
# --four-cards: spla_tpu.parallel over a 1-D mesh of four cards
# ---------------------------------------------------------------------------


def assert_four_shards(phase, name, sc, devices):
    """Every array of a ShardedCsr has one shard on each mesh device."""
    counts = []
    for field in ("indptr", "cols", "values", "row_ids", "nnz"):
        shards = getattr(sc, field).addressable_shards
        counts.append((len(shards), len({s.device for s in shards}
                                        & set(devices))))
    check(phase, f"{name} sharding", all(c == (len(devices),) * 2
                                          for c in counts),
          f"(shards, devices) per array {counts}, want one shard on each "
          f"of {len(devices)} devices")


def dist_result_csr(R):
    """Sharded CSR result of dist_mxm -> scipy CSR in global ids."""
    rows, cols, vals = [], [], []
    nnz = np.asarray(R.nnz)
    rid, cid, val = (np.asarray(R.row_ids), np.asarray(R.cols),
                     np.asarray(R.values))
    for s in range(R.n_shards):
        k = int(nnz[s])
        rows.append(rid[s, :k] + s * R.mloc)
        cols.append(cid[s, :k])
        vals.append(val[s, :k])
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=R.shape)


def four_cards(jax, seed, n=1 << 23, n2=1 << 18, n_mxm=1 << 16,
               tc_n=1 << 20, n_devices=4):
    from spla_tpu import algorithms as alg
    from spla_tpu import formats as F
    from spla_tpu import op
    from spla_tpu.ops import mxm
    from spla_tpu.parallel import (
        dist_bfs,
        dist_mxm,
        dist_pagerank,
        dist_pagerank_overlap,
        dist_sssp,
        dist_tc,
        make_device_mesh,
        shard_csr_by_rows,
        shard_csr_by_rows_balanced,
        shard_csr_split_diag,
    )

    ph = "four-cards"
    rng = np.random.default_rng(seed)
    card = phase_device(jax)
    devices = jax.devices()[:n_devices]
    mesh = make_device_mesh(n_devices)
    t0 = time.perf_counter()
    G = uniform_graph(n, 16, rng)
    say(ph, f"uniform n={n} nnz={G.nnz} built in "
            f"{time.perf_counter() - t0:.1f} s; mesh {dict(mesh.shape)}")

    # PageRank: plain and overlapped split vs the single-card loop
    S = pagerank_matrix(G)
    Sc = F.csr_from_scipy(S)
    eps = 1e-9
    p1 = np.asarray(alg.pr(Sc, 0.85, eps).values)
    sc = shard_csr_by_rows(Sc, n_devices, mesh)
    assert_four_shards(ph, "pagerank matrix", sc, devices)
    p = np.asarray(dist_pagerank(mesh, sc, 0.85, eps)).ravel()[:n]
    l1 = float(np.abs(p - p1).sum())
    check(ph, "dist_pagerank vs single card", l1 <= 1e-5,
          f"L1 diff {l1:.3e} <= 1e-5 (per-shard f32 sums; eps={eps})")
    diag, off = shard_csr_split_diag(Sc, n_devices, mesh)
    assert_four_shards(ph, "overlap diag", diag, devices)
    assert_four_shards(ph, "overlap off", off, devices)
    p = np.asarray(dist_pagerank_overlap(mesh, diag, off, 0.85,
                                         eps)).ravel()[:n]
    l1 = float(np.abs(p - p1).sum())
    check(ph, "dist_pagerank_overlap vs single card", l1 <= 1e-5,
          f"L1 diff {l1:.3e} <= 1e-5 (split f32 sums; eps={eps})")
    del S, Sc, sc, diag, off

    # BFS: dense exchange and the tiered frontier_cap ladder
    src = int(np.argmax(np.diff(G.indptr) > 0))
    Gc = F.csr_from_scipy(G.astype(np.int32))
    lev1 = np.asarray(alg.bfs(Gc, src, At=Gc).values)
    sg = shard_csr_by_rows(Gc, n_devices, mesh)
    assert_four_shards(ph, "bfs matrix", sg, devices)
    for cap, label in ((0, "dense exchange"), (None, "tiered frontier_cap")):
        v = np.asarray(dist_bfs(mesh, sg, src, frontier_cap=cap)).ravel()[:n]
        check_equal(ph, f"dist_bfs {label} vs single card", v, lev1)
    del Gc, sg

    # SSSP
    W = sym_weights(G)
    Wc = F.csr_from_scipy(W)
    d1 = np.asarray(alg.sssp(Wc, src, At=Wc).values)
    sw = shard_csr_by_rows(Wc, n_devices, mesh)
    assert_four_shards(ph, "sssp matrix", sw, devices)
    d = np.asarray(dist_sssp(mesh, sw, src)).ravel()[:n]
    check_equal(ph, "dist_sssp reachable set", np.isfinite(d),
                np.isfinite(d1))
    fin = np.isfinite(d1)
    rel = float(np.max(np.abs(d[fin] - d1[fin]) / np.maximum(d1[fin], 1e-30)))
    check(ph, "dist_sssp vs single card", rel <= 1e-5,
          f"max rel err {rel:.3e} <= 1e-5 (f32 path sums)")
    del G, W, Wc, sw

    # degree-balanced sharding + BFS on the skewed graph
    G2 = zipf_graph(n2, rng)
    G2c = F.csr_from_scipy(G2.astype(np.int32))
    lev1 = np.asarray(alg.bfs(G2c, 0, At=G2c).values)
    bal, _, new_of_old = shard_csr_by_rows_balanced(G2c, n_devices, mesh)
    assert_four_shards(ph, "balanced G2", bal, devices)
    v = np.asarray(dist_bfs(mesh, bal, int(new_of_old[0]))).ravel()
    check_equal(ph, "balanced dist_bfs on G2 vs single card", v[new_of_old],
                lev1)

    # ring SpGEMM at the single-card SpGEMM shape
    A = uniform_graph(n_mxm, 16, rng)
    A.data = rng.random(A.nnz, dtype=np.float32)
    Ac = F.csr_from_scipy(A)
    R1 = mxm(Ac, Ac, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
    k = int(R1.nnz)
    r1 = sp.csr_matrix((np.asarray(R1.values)[:k],
                        (np.asarray(R1.row_ids)[:k], np.asarray(R1.cols)[:k])),
                       shape=A.shape)
    sa = shard_csr_by_rows(Ac, n_devices, mesh)
    assert_four_shards(ph, "mxm operand", sa, devices)
    r = dist_result_csr(dist_mxm(mesh, sa, sa, op.MULT_FLOAT, op.PLUS_FLOAT,
                                 0.0))
    check(ph, f"dist_mxm n={n_mxm} stored count", r.nnz == r1.nnz,
          f"{r.nnz} == {r1.nnz} (exact)")
    diff = abs(r - r1)
    err = float(diff.max()) if diff.nnz else 0.0
    tol = 1e-5 * float(abs(r1).max())
    check(ph, f"dist_mxm n={n_mxm} vs single card", err <= tol,
          f"max abs err {err:.3e} <= {tol:.3e} (1e-5 x max|ref|; f32 sums "
          "in another order)")

    # triangle counting
    stats = devices[0].memory_stats() or {}
    tc_n, _, reason = tc_size(tc_n, int(stats.get("bytes_limit", 64 << 30)))
    say(ph, f"tc uses n={tc_n}: {reason}")
    T = uniform_graph(tc_n, 16, rng)
    Tc = F.csr_from_scipy(T.astype(np.int32))
    t1 = alg.tc(Tc)
    st = shard_csr_by_rows(Tc, n_devices, mesh)
    assert_four_shards(ph, "tc matrix", st, devices)
    t4 = dist_tc(mesh, st)
    check(ph, f"dist_tc n={tc_n} vs single card", t4 == t1,
          f"{t4} == {t1} (exact)")

    for d in devices:
        s = d.memory_stats() or {}
        say(ph, f"{d}: peak_bytes_in_use={s.get('peak_bytes_in_use')} "
                f"({INFO}; card: {card})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run spla_tpu.parallel on four cards and nothing else")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke.py needs a GPU; JAX found {devs[0].platform!r}"
                 " devices")
    need = 4 if args.four_cards else 1
    if len(devs) < need:
        sys.exit(f"chip_smoke.py needs {need} GPUs; JAX found {len(devs)}")

    from spla_tpu.compile_cache import enable_compile_cache

    say("device", f"compile cache: {enable_compile_cache()}")
    t0 = time.perf_counter()
    if args.four_cards:
        four_cards(jax, args.seed)
    else:
        one_card(jax, args.seed)
    say("done", f"all checks passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
