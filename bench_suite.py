"""Extended benchmark suite: one JSON line per metric.

``bench.py`` prints the headline masked SpMV time; this suite adds BFS /
PageRank / SSSP wall times, SpMV on a large and on a skewed graph, and
SpGEMM throughput on synthetic graphs, all through the public ops and
algorithms.  Every timed region ends in ``block_until_ready`` (or a
host read of its result).  It refuses to run without a GPU.

Run:  python bench_suite.py [--small | --big]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def emit(metric, value, unit, **detail):
    print(json.dumps({"metric": metric, "value": round(float(value), 3),
                      "unit": unit, "detail": detail}), flush=True)


def random_graph(n, deg, seed=0):
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    m = n * deg // 2
    r = rng.integers(0, n, m)
    c = rng.integers(0, n, m)
    keep = r != c
    r, c = r[keep], c[keep]
    rows = np.concatenate([r, c])
    cols = np.concatenate([c, r])
    A = sp.coo_matrix(
        (np.ones(rows.size, np.float32), (rows, cols)), shape=(n, n)
    ).tocsr()
    A.sum_duplicates()
    A.data[:] = 1.0
    return A


def chained_spmv_ms(A, iters):
    """Mean time of one ``ops.mxv_masked`` plus-times SpMV over ``A``,
    chained (each output, renormalized, feeds the next)."""
    import jax
    import jax.numpy as jnp

    from spla_tpu import op as OP
    from spla_tpu.containers import DenseVec
    from spla_tpu.ops import mxv_masked

    n = A.shape[0]
    mask = DenseVec(jnp.ones((n,), jnp.float32), jnp.float32(0))

    @jax.jit
    def step(A, y, k):
        o = mxv_masked(mask, A, DenseVec(y, jnp.float32(0)), OP.MULT_FLOAT,
                       OP.PLUS_FLOAT, OP.ALWAYS_FLOAT, 0.0).values
        return o * ((1.0 + k * 1e-6) / (jnp.max(jnp.abs(o)) + jnp.float32(1e-30)))

    x = jnp.asarray(np.random.default_rng(1).random(n, dtype=np.float32))
    step(A, x, jnp.float32(0)).block_until_ready()  # warm-up
    y = x
    t0 = time.perf_counter()
    for k in range(iters):
        y = step(A, y, jnp.float32(k % 97))
    y.block_until_ready()
    return (time.perf_counter() - t0) / iters * 1e3


def bench_big_spmv():
    """Chained SpMV on 8.4M vertices / 134M edges (the reference's
    rgg_n_2_23 class; its README claims 1-billion-edge capability on 8 GB)."""
    import jax
    import jax.numpy as jnp

    from bench import build_graph
    from spla_tpu.containers import CsrMatrix

    n, deg = 1 << 23, 16
    indptr, rows, cols, vals = build_graph(n, deg)
    nnz = vals.size
    A = CsrMatrix(shape=(n, n), indptr=jnp.asarray(indptr),
                  cols=jnp.asarray(cols), values=jnp.asarray(vals),
                  row_ids=jnp.asarray(rows), nnz=jnp.int32(nnz),
                  fill=jnp.float32(0))
    ms = chained_spmv_ms(A, 30)
    emit("big_spmv_ms", ms, "ms", n=n, nnz=int(nnz),
         mnnz_per_s=round(nnz / ms / 1e3, 1),
         device=jax.devices()[0].device_kind)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true", help="tiny shapes (CI)")
    ap.add_argument("--big", action="store_true",
                    help="large SpMV entry only (134M edges)")
    args = ap.parse_args()
    import jax

    from spla_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("bench_suite.py needs a GPU; JAX found "
                         f"{jax.devices()[0].platform!r}")
    if args.big:
        bench_big_spmv()
        return

    import jax
    import jax.numpy as jnp

    from spla_tpu import algorithms as alg
    from spla_tpu import formats as F
    from spla_tpu import FLOAT as spla_FLOAT
    FLOAT_MULT = spla_FLOAT.MULT
    FLOAT_PLUS = spla_FLOAT.PLUS
    FLOAT_ALWAYS = spla_FLOAT.ALWAYS

    n = 1 << (16 if args.small else 20)
    deg = 16
    A = random_graph(n, deg)
    nnz = A.nnz
    dev = jax.devices()[0].device_kind

    # ---- BFS (levels on device) ----
    # CHAINED runs (next source depends on the previous result) with ONE
    # scalar materialization at the end
    Ac = F.csr_from_scipy(A.astype(np.int32))
    v = alg.bfs(Ac, 0, At=Ac)  # undirected by construction
    np.asarray(jnp.sum(v.values))  # warm-up compile
    reps = 10
    dt = float("inf")
    for _ in range(2):
        src = jnp.asarray(0, jnp.int32)
        t0 = time.perf_counter()
        for k in range(reps):
            v = alg.bfs(Ac, src, At=Ac)
            src = (jnp.min(v.values) * 0 + (k + 1) % 7).astype(jnp.int32)
        np.asarray(src)
        dt = min(dt, (time.perf_counter() - t0) / reps)
    emit("bfs_gteps", nnz / dt / 1e9, "GTEPS",
         n=n, nnz=int(nnz), ms=round(dt * 1e3, 1), device=dev)

    # ---- PageRank to eps=1e-6 ----
    outdeg = np.asarray(A.sum(axis=0)).ravel()
    outdeg[outdeg == 0] = 1
    Ap = F.csr_from_scipy(A.multiply(0.85 / outdeg).tocsr().astype(np.float32))
    p = alg.pr(Ap, 0.85, 1e-6)
    np.asarray(jnp.sum(p.values))  # warm-up
    preps = 5
    dt = float("inf")
    for _ in range(2):
        al = jnp.float32(0.85)
        t0 = time.perf_counter()
        for k in range(preps):
            p = alg.pr(Ap, al, 1e-6)
            # unique, device-dependent alpha: serializes the chain and
            # defeats identical-input elision; p[0]*0 == 0 exactly
            al = jnp.float32(0.85) + p.values[0] * 0 + jnp.float32(k * 1e-9)
        np.asarray(al)
        dt = min(dt, (time.perf_counter() - t0) / preps)
    emit("pagerank_ms", dt * 1e3, "ms", n=n, nnz=int(nnz), device=dev)

    # ---- SSSP (min-plus relaxation) ----
    rng = np.random.default_rng(2)
    wvals = rng.uniform(0.1, 2.0, A.nnz).astype(np.float32)
    Aw = A.copy()
    Aw.data = wvals
    Awc = F.csr_from_scipy(Aw, fill=np.float32(np.inf))
    v = alg.sssp(Awc, 0, At=Awc)
    np.asarray(jnp.sum(jnp.where(jnp.isfinite(v.values), v.values, 0)))
    dt = float("inf")
    for _ in range(2):
        src = jnp.asarray(0, jnp.int32)
        t0 = time.perf_counter()
        for k in range(preps):
            v = alg.sssp(Awc, src, At=Awc)
            src = (jnp.argmin(v.values) * 0 + (k + 1) % 7).astype(jnp.int32)
        np.asarray(src)
        dt = min(dt, (time.perf_counter() - t0) / preps)
    emit("sssp_ms", dt * 1e3, "ms", n=n, nnz=int(A.nnz), device=dev)

    # ---- road-network-class BFS (thousands of near-empty levels) ----
    # Morton-ordered 2D grid: locality-preserving vertex order, ~2*side
    # levels of tiny frontiers — the reference's road_central class.
    side = 1 << (7 if args.small else 10)
    nrd = side * side

    def morton(x, y):
        def spread(v):
            v = (v | (v << 8)) & 0x00FF00FF
            v = (v | (v << 4)) & 0x0F0F0F0F
            v = (v | (v << 2)) & 0x33333333
            v = (v | (v << 1)) & 0x55555555
            return v
        return (spread(x) | (spread(y) << 1)).astype(np.int64)

    import scipy.sparse as sp
    xs, ys = np.meshgrid(np.arange(side, dtype=np.int64),
                         np.arange(side, dtype=np.int64), indexing="ij")
    rows_l, cols_l = [], []
    for dx, dy in ((1, 0), (0, 1)):
        xs2, ys2 = xs[: side - dx, : side - dy], ys[: side - dx, : side - dy]
        a = morton(xs2.ravel(), ys2.ravel())
        b = morton((xs2 + dx).ravel(), (ys2 + dy).ravel())
        rows_l += [a, b]
        cols_l += [b, a]
    rr = np.concatenate(rows_l).astype(np.int32)
    cc = np.concatenate(cols_l).astype(np.int32)
    Ard = sp.csr_matrix((np.ones(rr.size, np.float32), (rr, cc)),
                        shape=(nrd, nrd))
    Ardc = F.csr_from_scipy(Ard)
    lev = alg.bfs(Ardc, 0, At=Ardc)  # grid graph: symmetric
    lv = np.asarray(lev.values)  # warm-up + level count
    rreps = 3
    dtr = float("inf")
    for _ in range(2):
        src = jnp.asarray(0, jnp.int32)
        t0 = time.perf_counter()
        for k in range(rreps):
            lev = alg.bfs(Ardc, src, At=Ardc)
            src = (jnp.min(lev.values) * 0 + k + 1).astype(jnp.int32)
        np.asarray(src)
        dtr = min(dtr, (time.perf_counter() - t0) / rreps)
    emit("road_bfs_gteps", Ard.nnz / dtr / 1e9, "GTEPS", n=nrd,
         nnz=int(Ard.nnz), levels=int(lv.max()), ms=round(dtr * 1e3, 1),
         device=dev)

    # ---- road_central-scale BFS ----
    if not args.small:
        side_b = 3 << 10  # 9.4M vertices, 37.7M directed edges
        nrb_ = side_b * side_b
        xsb, ysb = np.meshgrid(np.arange(side_b, dtype=np.int64),
                               np.arange(side_b, dtype=np.int64),
                               indexing="ij")

        def morton_b(x, y):
            def spread(v):
                v = (v | (v << 16)) & 0x0000FFFF0000FFFF
                v = (v | (v << 8)) & 0x00FF00FF00FF00FF
                v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0F
                v = (v | (v << 2)) & 0x3333333333333333
                v = (v | (v << 1)) & 0x5555555555555555
                return v
            return spread(x) | (spread(y) << 1)

        rows_b, cols_b = [], []
        for dx, dy in ((1, 0), (0, 1)):
            x2 = xsb[: side_b - dx, : side_b - dy]
            y2 = ysb[: side_b - dx, : side_b - dy]
            a_ = morton_b(x2.ravel(), y2.ravel())
            b_ = morton_b((x2 + dx).ravel(), (y2 + dy).ravel())
            rows_b += [a_, b_]
            cols_b += [b_, a_]
        rrb = np.concatenate(rows_b)
        ccb = np.concatenate(cols_b)
        # morton codes of a 3072-side grid are sparse in [0, 4096^2); use
        # the rank order to compact ids into [0, n)
        uniq = np.unique(rrb)
        rrb = np.searchsorted(uniq, rrb).astype(np.int32)
        ccb = np.searchsorted(uniq, ccb).astype(np.int32)
        Abig = sp.csr_matrix(
            (np.ones(rrb.size, np.float32), (rrb, ccb)), shape=(nrb_, nrb_))
        Abc = F.csr_from_scipy(Abig)
        levb = alg.bfs(Abc, 0, At=Abc)  # symmetric
        lvb = np.asarray(levb.values)
        dtb = float("inf")
        for _ in range(2):
            src = jnp.asarray(0, jnp.int32)
            t0 = time.perf_counter()
            for k in range(2):
                levb = alg.bfs(Abc, src, At=Abc)
                src = (jnp.min(levb.values) * 0 + k + 1).astype(jnp.int32)
            np.asarray(src)
            dtb = min(dtb, (time.perf_counter() - t0) / 2)
        emit("road_big_bfs_gteps", Abig.nnz / dtb / 1e9, "GTEPS", n=nrb_,
             nnz=int(Abig.nnz), levels=int(lvb.max()),
             ms=round(dtb * 1e3, 1), device=dev)

    # ---- road-class SSSP (~2*side relaxation rounds) ----
    side_s = 1 << (7 if args.small else 9)
    nrs = side_s * side_s
    sel = (rr < nrs) & (cc < nrs)
    wrng = np.random.default_rng(9)
    Wrd = sp.csr_matrix(
        (wrng.uniform(0.1, 1.0, int(sel.sum())).astype(np.float32),
         (rr[sel], cc[sel])), shape=(nrs, nrs))
    # symmetrize the WEIGHTS too (the structure already is): the two
    # directions of each edge drew independent values above, which would
    # make sssp's default A^T differ from A
    Wrd = Wrd.maximum(Wrd.T).tocsr()
    Wrdc = F.csr_from_scipy(Wrd)
    dist = alg.sssp(Wrdc, 0, At=Wrdc)
    np.asarray(dist.values)  # warm-up
    dts = float("inf")
    for _ in range(2):
        src = jnp.asarray(0, jnp.int32)
        t0 = time.perf_counter()
        for k in range(rreps):
            dist = alg.sssp(Wrdc, src, At=Wrdc)
            src = (jnp.argmin(dist.values) * 0 + k + 1).astype(jnp.int32)
        np.asarray(src)
        dts = min(dts, (time.perf_counter() - t0) / rreps)
    emit("road_sssp_ms", dts * 1e3, "ms", n=nrs, nnz=int(Wrd.nnz),
         device=dev)

    # ---- facade chained ops vs functional layer ----
    # device-resident facade criterion: a 10-op chained pipeline through
    # the pyspla-parity objects must stay within ~2x of the functional
    # layer (round-1 verdict item: no host round-trip per op)
    from spla_tpu import facade as FC

    nf = 1 << (14 if args.small else 18)
    Af = random_graph(nf, 8, seed=7)
    deg_f = np.asarray(Af.sum(axis=0)).ravel()
    Sf = (Af @ __import__("scipy.sparse", fromlist=["diags"]).diags(
        0.85 / np.maximum(deg_f, 1))).tocsr().astype(np.float32)
    Mf = FC.Matrix.from_scipy(Sf) if hasattr(FC.Matrix, "from_scipy") else None
    if Mf is None:
        coo_f = Sf.tocoo()
        Mf = FC.Matrix.from_lists(
            coo_f.row.tolist(), coo_f.col.tolist(), coo_f.data.tolist(),
            (nf, nf), spla_FLOAT)
    vf = FC.Vector.from_lists(list(range(0, nf, max(nf // 1024, 1))),
                              [1.0] * len(range(0, nf, max(nf // 1024, 1))),
                              nf, spla_FLOAT)
    maskf = FC.Vector(nf, spla_FLOAT)
    CH = 10

    def chain_facade():
        r = vf
        for _ in range(CH):
            r = r.vxm(maskf, Mf, FLOAT_MULT, FLOAT_PLUS, FLOAT_ALWAYS)
        return float(r.reduce(FLOAT_PLUS).get())

    chain_facade()  # warm-up
    t0 = time.perf_counter()
    tot = chain_facade()
    dtf = time.perf_counter() - t0

    from spla_tpu.ops import vxm_masked
    from spla_tpu import formats as F2

    Ac2 = F2.csr_from_scipy(Sf)
    At2 = F2.csr_transpose_host(Ac2)
    x0 = np.zeros(nf, np.float32)
    x0[:: max(nf // 1024, 1)] = 1.0

    # functional baseline rides the same SpMV the facade uses, so the
    # ratio measures facade overhead
    from spla_tpu import op as OPm
    from spla_tpu.ops.spmv import best_spmv_fn

    spmv_fn = best_spmv_fn(At2, OPm.MULT_FLOAT, OPm.PLUS_FLOAT,
                           jnp.float32(0))

    def chain_fn():
        import spla_tpu
        r = spla_tpu.DenseVec(jnp.asarray(x0), jnp.float32(0))
        for _ in range(CH):
            r = spla_tpu.DenseVec(spmv_fn(At2, r.values), jnp.float32(0))
        return float(np.asarray(jnp.sum(r.values)))

    chain_fn()
    t0 = time.perf_counter()
    tot2 = chain_fn()
    dtfn = time.perf_counter() - t0
    emit("facade_chain_ratio", dtf / max(dtfn, 1e-9), "x-functional",
         n=nf, facade_ms=round(dtf * 1e3, 1), functional_ms=round(dtfn * 1e3, 1),
         device=dev)

    # ---- exclusive prefix-scan micro-bench (reference publishes absolute
    # numbers: 500k ~= 1.35-1.52 ms, 1M ~= 2.65-2.93 ms on its GPU,
    # src/opencl/cl_prefix_sum.hpp:45-49) ----
    from spla_tpu.utils.primitives import prefix_sum

    for np_, label in ((500_000, "prefix_scan_500k_ms"),
                       (1_000_000, "prefix_scan_1m_ms")):
        xs = jnp.asarray(np.random.default_rng(1).random(np_, np.float32))

        @jax.jit
        def scan_chain(x0):
            def body(k, x):
                # scan the ORIGINAL input each lap (re-scanning the ramp
                # overflows f32 by lap 3 / decays to denormals when
                # rescaled); the dependence on the previous tail + the
                # per-lap k serialize the laps and defeat memoization
                return prefix_sum(
                    x0 * (1.0 + x[np_ - 1] * 1e-9 + k * 1e-9))
            return jax.lax.fori_loop(0, 50, body, x0)

        float(np.asarray(jnp.sum(scan_chain(xs))))  # warm-up
        t0 = time.perf_counter()
        float(np.asarray(jnp.sum(scan_chain(xs))))
        dtp = (time.perf_counter() - t0) / 50
        emit(label, dtp * 1e3, "ms", n=np_, device=dev)

    # ---- skewed-graph masked SpMV: zipf-2.1 out-degrees (hub rows) ----
    ns = 1 << (14 if args.small else 18)
    rngs = np.random.default_rng(7)
    degs = np.minimum(rngs.zipf(2.1, ns) * 8, ns // 4).astype(np.int64)
    srows = np.repeat(np.arange(ns, dtype=np.int32), degs)
    scols = rngs.integers(0, ns, srows.size, dtype=np.int32)
    svals = rngs.random(srows.size, np.float32)
    Sk = F.csr_from_entries((ns, ns), srows, scols, svals,
                            dtype=np.float32)
    snnz = int(np.asarray(Sk.nnz))
    ms = chained_spmv_ms(Sk, 50)
    emit("skewed_spmv_ms", ms, "ms", n=ns, nnz=snnz,
         mnnz_per_s=round(snnz / ms / 1e3, 1), device=dev)

    # ---- skewed-graph BFS ----
    from spla_tpu import algorithms as _alg

    Skt = F.csr_transpose_host(Sk)
    vb = _alg.bfs(Sk, 0, At=Skt)
    np.asarray(jnp.sum(vb.values))  # warm-up (packs + compiles)
    breps = 10
    dtb = float("inf")
    for _ in range(2):
        src = jnp.asarray(0, jnp.int32)
        t0 = time.perf_counter()
        for k in range(breps):
            vb = _alg.bfs(Sk, src, At=Skt)
            src = (jnp.min(vb.values) * 0 + (k + 1) % 7).astype(jnp.int32)
        np.asarray(src)
        dtb = min(dtb, (time.perf_counter() - t0) / breps)
    emit("skewed_bfs_gteps", snnz / dtb / 1e9, "GTEPS",
         n=ns, nnz=snnz, ms=round(dtb * 1e3, 1), device=dev)

    # ---- SpGEMM (masked mxmT, triangle counting core) ----
    nt = 1 << (12 if args.small else 15)
    At = random_graph(nt, 24, seed=3)
    Atc = F.csr_from_scipy(At.astype(np.int32))
    from spla_tpu.ops.spgemm import count_mxmT_products

    tri = alg.tc(Atc)  # warm-up: jit compile
    t0 = time.perf_counter()
    tri = alg.tc(Atc)
    dt = time.perf_counter() - t0
    prods = count_mxmT_products(Atc, Atc)

    # unmasked mxm (ESC / product-window-blocked numeric phase)
    from spla_tpu.ops import mxm as mxm_op
    from spla_tpu import op as OPS
    from spla_tpu.ops.spgemm import count_mxm_products
    nm = 1 << (11 if args.small else 13)
    Am = F.csr_from_scipy(random_graph(nm, 16, seed=5))
    from spla_tpu.containers import CsrMatrix as _Csr
    R = mxm_op(Am, Am, OPS.MULT_FLOAT, OPS.PLUS_FLOAT, 0.0)
    nnz_r = int(np.asarray(R.nnz))  # warm-up
    # CHAINED calls (B values derived from the previous result) with one
    # materialization, like every other entry.
    mreps = 6
    dtm = float("inf")
    for _ in range(2):
        s_k = jnp.float32(1.0)
        t0 = time.perf_counter()
        for k in range(mreps):
            Bk = _Csr(shape=Am.shape, indptr=Am.indptr, cols=Am.cols,
                      values=Am.values * s_k, row_ids=Am.row_ids,
                      nnz=Am.nnz, fill=Am.fill)
            R = mxm_op(Am, Bk, OPS.MULT_FLOAT, OPS.PLUS_FLOAT, 0.0)
            s_k = jnp.float32(1.0) + R.values[0] * 0 + jnp.float32(
                (k + 1) * 1e-9)
        np.asarray(s_k)
        dtm = min(dtm, (time.perf_counter() - t0) / mreps)
    prods_m = count_mxm_products(Am, Am)
    emit("mxm_mprod_s", prods_m / dtm / 1e6, "Mproducts/s", n=nm,
         nnz=int(np.asarray(Am.nnz)), out_nnz=nnz_r,
         ms=round(dtm * 1e3, 1), device=dev)

    emit("masked_spgemm_mprod_s", prods / dt / 1e6, "Mproducts/s",
         n=nt, nnz=int(At.nnz), triangles_x6=int(tri),
         ms=round(dt * 1e3, 1), device=dev)


if __name__ == "__main__":
    main()
