"""Distributed masked SpMV and graph algorithms over a device mesh.

1-D row decomposition: each chip owns ``mloc`` matrix rows (its output
slots); the input vector is gathered across the axis per step
(``lax.all_gather``, NCCL over NVLink between the cards of one host).  The
convergence loops run *inside* ``shard_map`` as ``lax.while_loop``s whose
carried count/error scalars are ``psum``-replicated — uniform loop exit
across chips with zero host round-trips per iteration (the reference
syncs a counter to the host every level, ``src/algorithm.cpp:112``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from .. import op as OP
from ..containers import CsrMatrix
from ..ops.spmv import masked_spmv, masked_spmv_structural
from .dist_matrix import ShardedCsr

__all__ = ["dist_masked_spmv", "dist_pagerank",
           "dist_pagerank_overlap", "dist_bfs", "dist_sssp"]


def _arrays(sc: ShardedCsr):
    return (sc.indptr, sc.cols, sc.values, sc.row_ids, sc.nnz, sc.fill)


_ARR_SPECS = (P("d"), P("d"), P("d"), P("d"), P("d"), P())


def _local(sc: ShardedCsr, arrs) -> CsrMatrix:
    """Assemble the local shard block inside shard_map (leading shard axis
    arrives with local size 1)."""
    indptr, cols, values, row_ids, nnz, fill = arrs
    padded_n = sc.n_shards * sc.mloc
    return CsrMatrix(
        shape=(sc.mloc, padded_n),
        indptr=indptr[0],
        cols=cols[0],
        values=values[0],
        row_ids=row_ids[0],
        nnz=nnz[0],
        fill=fill,
    )


def dist_masked_spmv(mesh: Mesh, A: ShardedCsr, x, op_mul, op_add, init, axis="d"):
    """r = A x over the (op_mul, op_add) semiring; x and r row-sharded
    [S, mloc].  The all-gather of x is the halo exchange."""

    def step(*args):
        *arrs, x_loc = args
        a = _local(A, arrs)
        x_full = lax.all_gather(x_loc[0], axis, tiled=True)
        out, _ = masked_spmv(a, x_full, op_mul, op_add, init)
        return out[None]

    f = jax.shard_map(
        step, mesh=mesh, in_specs=(*_ARR_SPECS, P(axis)), out_specs=P(axis)
    )
    return jax.jit(f)(*_arrays(A), x)


@partial(jax.jit, static_argnames=("mesh", "axis", "n", "mloc", "n_shards"))
def _dist_pagerank_impl(mesh, arrs, alpha, eps, n, mloc, n_shards, axis):
    def step(*arrs):
        a = CsrMatrix(
            shape=(mloc, n_shards * mloc),
            indptr=arrs[0][0], cols=arrs[1][0], values=arrs[2][0],
            row_ids=arrs[3][0], nnz=arrs[4][0], fill=arrs[5],
        )
        my = lax.axis_index(axis)
        addition = (1.0 - alpha) / n
        gids = my * mloc + jnp.arange(mloc, dtype=jnp.int32)
        live = gids < n
        p0 = jnp.where(live, jnp.full((mloc,), 1.0 / n, jnp.float32), 0.0)

        def cond(state):
            # iteration cap: f32 error can plateau above a tiny eps forever
            # (see the single-chip kernel) — an uncapped loop would hang
            # every chip in the mesh
            return (state[1] > eps) & (state[2] < 10_000)

        def body(state):
            p_prev, _, it = state
            p_full = lax.all_gather(p_prev, axis, tiled=True)
            ap, _ = masked_spmv(a, p_full, OP.MULT_FLOAT, OP.PLUS_FLOAT, jnp.float32(0))
            p = jnp.where(live, ap + addition, 0.0)
            err2 = lax.psum(jnp.sum((p - p_prev) ** 2), axis)
            return (p, jnp.sqrt(err2), it + 1)

        p, _, _ = lax.while_loop(
            cond, body, (p0, jnp.float32(eps) + 0.1, jnp.int32(0))
        )
        return p[None]

    f = jax.shard_map(step, mesh=mesh, in_specs=_ARR_SPECS, out_specs=P(axis))
    return f(*arrs)


def dist_pagerank(mesh: Mesh, A: ShardedCsr, alpha, eps, axis="d"):
    """Distributed PageRank (semantics of reference
    ``src/algorithm.cpp:278-335``; A pre-scaled alpha/outdeg); returns p
    row-sharded [S, mloc]."""
    return _dist_pagerank_impl(
        mesh, _arrays(A), jnp.float32(alpha), jnp.float32(eps),
        A.shape[0], A.mloc, A.n_shards, axis,
    )


@partial(jax.jit, static_argnames=("mesh", "axis", "n", "mloc", "n_shards"))
def _dist_pagerank_overlap_impl(mesh, d_arrs, o_arrs, alpha, eps, n, mloc,
                                n_shards, axis):
    def step(*arrs):
        d_arrs = arrs[:6]
        o_arrs = arrs[6:]
        a_diag = CsrMatrix(
            shape=(mloc, mloc),
            indptr=d_arrs[0][0], cols=d_arrs[1][0], values=d_arrs[2][0],
            row_ids=d_arrs[3][0], nnz=d_arrs[4][0], fill=d_arrs[5],
        )
        a_off = CsrMatrix(
            shape=(mloc, n_shards * mloc),
            indptr=o_arrs[0][0], cols=o_arrs[1][0], values=o_arrs[2][0],
            row_ids=o_arrs[3][0], nnz=o_arrs[4][0], fill=o_arrs[5],
        )
        my = lax.axis_index(axis)
        addition = (1.0 - alpha) / n
        gids = my * mloc + jnp.arange(mloc, dtype=jnp.int32)
        live = gids < n
        p0 = jnp.where(live, jnp.full((mloc,), 1.0 / n, jnp.float32), 0.0)

        def cond(state):
            return (state[1] > eps) & (state[2] < 10_000)

        def body(state):
            p_prev, _, it = state
            # the all-gather has no dependency on the DIAGONAL product:
            # XLA's latency-hiding scheduler runs the collective behind
            # the local compute (the north-star overlap; SURVEY §2.8)
            p_full = lax.all_gather(p_prev, axis, tiled=True)
            local, _ = masked_spmv(a_diag, p_prev, OP.MULT_FLOAT,
                                   OP.PLUS_FLOAT, jnp.float32(0))
            remote, _ = masked_spmv(a_off, p_full, OP.MULT_FLOAT,
                                    OP.PLUS_FLOAT, jnp.float32(0))
            p = jnp.where(live, local + remote + addition, 0.0)
            err2 = lax.psum(jnp.sum((p - p_prev) ** 2), axis)
            return (p, jnp.sqrt(err2), it + 1)

        p, _, _ = lax.while_loop(
            cond, body, (p0, jnp.float32(eps) + 0.1, jnp.int32(0))
        )
        return p[None]

    f = jax.shard_map(
        step, mesh=mesh, in_specs=(*_ARR_SPECS, *_ARR_SPECS),
        out_specs=P(axis),
    )
    return f(*d_arrs, *o_arrs)


def dist_pagerank_overlap(mesh: Mesh, diag: ShardedCsr, off: ShardedCsr,
                          alpha, eps, axis="d"):
    """PageRank over the diagonal/off-diagonal split
    (:func:`~spla_tpu.parallel.dist_matrix.shard_csr_split_diag`): the
    per-step all-gather overlaps the communication-free diagonal-block
    SpMV.  Result identical to :func:`dist_pagerank`."""
    assert diag.shape[0] == off.shape[0] and diag.mloc == off.mloc
    return _dist_pagerank_overlap_impl(
        mesh, _arrays(diag), _arrays(off), jnp.float32(alpha),
        jnp.float32(eps), off.shape[0], off.mloc, off.n_shards, axis,
    )


# -- sparse-frontier halo exchange ------------------------------------------
#
# The efficiency gap: a full all_gather moves O(n) bytes
# per level even when the frontier holds one vertex (road-class graphs run
# thousands of near-empty levels).  The exchange below is CAPPED-SPARSE:
# each shard compacts its frontier to <= cap (index, value) pairs and the
# mesh all-gathers S*cap pairs instead of the dense vector; when ANY shard
# overflows the cap (pmax-uniform predicate, so every chip takes the same
# branch), the level falls back to the dense gather — the comm-side analog
# of the reference's push/pull direction optimization over frontier
# density (``src/algorithm.cpp:93-100``).  Stats carries count logical
# gather bytes so the virtual mesh validates comm VOLUME even where its
# timings are meaningless.


def _bfs_sparse_exchange(front, my, mloc, cap, axis):
    """bool[mloc] -> bool[S*mloc] via an index all-gather of <= cap
    frontier vertices per shard."""
    n_pad_axis = lax.axis_size(axis) * mloc
    (idx,) = jnp.nonzero(front, size=cap, fill_value=mloc)
    gidx = jnp.where(idx < mloc, my * mloc + idx.astype(jnp.int32), n_pad_axis)
    all_idx = lax.all_gather(gidx.astype(jnp.int32), axis, tiled=True)
    return (
        jnp.zeros((n_pad_axis + 1,), jnp.bool_)
        .at[all_idx]
        .set(True, mode="drop")[:n_pad_axis]
    )


def _normalize_caps(frontier_cap, mloc) -> tuple:
    """Cap LADDER normalization (r4 verdict item 8): ``None`` = two-tier
    default (mloc/256, mloc/16) so near-empty levels — thousands of them
    on road-class graphs — ship ~frontier-sized payloads instead of the
    single mloc/16 cap; int = one tier; 0 = always dense; tuple = custom
    ascending ladder."""
    if frontier_cap is None:
        tiers = (max(mloc // 256, 32), max(mloc // 16, 32))
    elif isinstance(frontier_cap, tuple):
        tiers = frontier_cap
    elif frontier_cap == 0:
        return ()
    else:
        tiers = (int(frontier_cap),)
    return tuple(sorted(set(int(c) for c in tiers if c > 0)))


def _tiered_bytes(maxcnt, caps, dense_bytes, per_entry, n_shards):
    """Logical gather bytes for the level: the smallest admitting tier."""
    b = jnp.float32(dense_bytes)
    for c in sorted(caps, reverse=True):
        b = jnp.where(maxcnt <= c, jnp.float32(n_shards * c * per_entry), b)
    return b


@partial(jax.jit, static_argnames=("mesh", "axis", "n", "mloc", "n_shards",
                                   "caps"))
def _dist_bfs_impl(mesh, arrs, source, n, mloc, n_shards, axis, caps):
    def step(*arrs):
        a = CsrMatrix(
            shape=(mloc, n_shards * mloc),
            indptr=arrs[0][0], cols=arrs[1][0], values=arrs[2][0],
            row_ids=arrs[3][0], nnz=arrs[4][0], fill=arrs[5],
        )
        my = lax.axis_index(axis)
        gids = my * mloc + jnp.arange(mloc, dtype=jnp.int32)
        # mark the carry as device-varying for shard_map's vma typing
        v0 = lax.pcast(jnp.zeros((mloc,), jnp.int32), (axis,), to="varying")
        front0 = gids == source

        def cond(state):
            # depth can never exceed n; the cap guards against a stuck
            # mesh if an invariant is ever violated
            return (state[3] > 0) & (state[2] <= n)

        def body(state):
            v, front, depth, _, comm, sp = state
            v = jnp.where(front, depth, v)
            if caps:
                maxcnt = lax.pmax(jnp.sum(front).astype(jnp.int32), axis)
                # tier ladder: try the smallest cap first, fall through
                # tier by tier to dense (all pmax-uniform, so every chip
                # takes the same branch at every level)
                ex = lambda f: lax.all_gather(f, axis, tiled=True)  # noqa: E731
                for c in sorted(caps, reverse=True):
                    ex = (lambda f, c=c, inner=ex: lax.cond(
                        maxcnt <= c,
                        lambda g: _bfs_sparse_exchange(g, my, mloc, c, axis),
                        inner, f))
                front_full = ex(front)
                # float32 accumulator: int32 would overflow past ~2 GB
                comm = comm + _tiered_bytes(maxcnt, caps, n_shards * mloc,
                                            4, n_shards)
                sp = sp + (maxcnt <= max(caps)).astype(jnp.int32)
            else:
                front_full = lax.all_gather(front, axis, tiled=True)
                comm = comm + jnp.float32(n_shards * mloc)
            front_new = masked_spmv_structural(a, front_full, v == 0)
            count = lax.psum(jnp.sum(front_new).astype(jnp.int32), axis)
            return (v, front_new, depth + 1, count, comm, sp)

        v, _, depth, _, comm, sp = lax.while_loop(
            cond, body,
            (v0, front0, jnp.int32(1), jnp.int32(1), jnp.float32(0),
             jnp.int32(0)),
        )
        return v[None], comm[None], sp[None], (depth - 1)[None]

    f = jax.shard_map(
        step, mesh=mesh, in_specs=_ARR_SPECS,
        out_specs=(P(axis), P(axis), P(axis), P(axis)),
    )
    return f(*arrs)


def dist_bfs(mesh: Mesh, At: ShardedCsr, source, axis="d",
             frontier_cap: int | None = None, with_stats: bool = False):
    """Distributed BFS over the transpose-sharded adjacency: frontier
    exchanged per level via the capped-sparse index gather (halo
    exchange), dense gather past the cap; depths row-sharded.

    ``frontier_cap``: per-shard sparse-exchange capacity.  None = the
    TIERED default ladder (mloc/256, mloc/16): near-empty levels (road
    graphs run thousands) ship the small tier, denser fronts step up,
    and the dense gather is the final fallback — the index payload is
    4 B vs the dense gather's 1 B/vertex, so each tier must sit well
    under mloc/4 to save volume.  An int pins one tier; a tuple is a
    custom ladder; 0 = always dense.  ``with_stats``: also return
    ``{"comm_bytes", "sparse_levels", "levels"}`` (logical gather bytes)."""
    caps = _normalize_caps(frontier_cap, At.mloc)
    v, comm, sp, lev = _dist_bfs_impl(
        mesh, _arrays(At), jnp.asarray(source, jnp.int32),
        At.shape[0], At.mloc, At.n_shards, axis, caps,
    )
    if not with_stats:
        return v
    stats = {
        "comm_bytes": int(comm[0]),
        "sparse_levels": int(sp[0]),
        "levels": int(lev[0]),
    }
    return v, stats


def _sssp_sparse_exchange(v, changed, my, mloc, cap, axis, inf):
    """(f32[mloc], bool[mloc]) -> (f32[S*mloc], bool[S*mloc]) carrying
    only the <= cap CHANGED entries per shard (the feedback vector is the
    sparse payload; unchanged slots arrive as +inf, the min-plus
    absorbing input, so products from them cannot contribute)."""
    n_pad_axis = lax.axis_size(axis) * mloc
    (idx,) = jnp.nonzero(changed, size=cap, fill_value=mloc)
    live = idx < mloc
    gidx = jnp.where(live, my * mloc + idx.astype(jnp.int32), n_pad_axis)
    gval = jnp.where(live, v[jnp.clip(idx, 0, mloc - 1)], inf)
    all_idx = lax.all_gather(gidx.astype(jnp.int32), axis, tiled=True)
    all_val = lax.all_gather(gval, axis, tiled=True)
    v_full = (
        jnp.full((n_pad_axis + 1,), inf)
        .at[all_idx]
        .set(all_val, mode="drop")[:n_pad_axis]
    )
    valid_full = (
        jnp.zeros((n_pad_axis + 1,), jnp.bool_)
        .at[all_idx]
        .set(True, mode="drop")[:n_pad_axis]
    )
    return v_full, valid_full


@partial(jax.jit, static_argnames=("mesh", "axis", "n", "mloc", "n_shards",
                                   "caps"))
def _dist_sssp_impl(mesh, arrs, source, n, mloc, n_shards, axis, caps):
    inf = jnp.float32(jnp.inf)

    def step(*arrs):
        a = CsrMatrix(
            shape=(mloc, n_shards * mloc),
            indptr=arrs[0][0], cols=arrs[1][0], values=arrs[2][0],
            row_ids=arrs[3][0], nnz=arrs[4][0], fill=arrs[5],
        )
        my = lax.axis_index(axis)
        gids = my * mloc + jnp.arange(mloc, dtype=jnp.int32)
        is_src = gids == source
        v0 = jnp.where(is_src, 0.0, inf)

        def cond(state):
            # Bellman-Ford bound: at most n relaxation rounds
            return (state[2] > 0) & (state[3] <= n)

        def dense_exchange(v, changed):
            return (
                lax.all_gather(v, axis, tiled=True),
                lax.all_gather(changed, axis, tiled=True),
            )

        def body(state):
            v, fdb_valid, _, it, comm, sp = state
            if caps:
                maxcnt = lax.pmax(
                    jnp.sum(fdb_valid).astype(jnp.int32), axis
                )
                ex = dense_exchange
                for c in sorted(caps, reverse=True):
                    ex = (lambda vv, ch, c=c, inner=ex: lax.cond(
                        maxcnt <= c,
                        lambda v2, c2: _sssp_sparse_exchange(
                            v2, c2, my, mloc, c, axis, inf),
                        inner, vv, ch))
                v_full, valid_full = ex(v, fdb_valid)
                comm = comm + _tiered_bytes(maxcnt, caps,
                                            n_shards * mloc * 5, 8,
                                            n_shards)
                sp = sp + (maxcnt <= max(caps)).astype(jnp.int32)
            else:
                v_full, valid_full = dense_exchange(v, fdb_valid)
                comm = comm + jnp.float32(n_shards * mloc * 5)
            frontier, _ = masked_spmv(
                a, v_full, lambda aa, xx: xx + aa, OP.MIN_FLOAT, inf,
                x_valid=valid_full,
            )
            new_v = jnp.minimum(v, frontier)
            changed = new_v != v
            count = lax.psum(jnp.sum(changed).astype(jnp.int32), axis)
            return (new_v, changed, count, it + 1, comm, sp)

        v, _, _, it, comm, sp = lax.while_loop(
            cond, body,
            (v0, is_src, jnp.int32(1), jnp.int32(1), jnp.float32(0),
             jnp.int32(0)),
        )
        return v[None], comm[None], sp[None], (it - 1)[None]

    f = jax.shard_map(
        step, mesh=mesh, in_specs=_ARR_SPECS,
        out_specs=(P(axis), P(axis), P(axis), P(axis)),
    )
    return f(*arrs)


def dist_sssp(mesh: Mesh, At: ShardedCsr, source, axis="d",
              frontier_cap: int | None = None, with_stats: bool = False):
    """Distributed SSSP: min-plus relaxation; the feedback (changed)
    vector is exchanged per round via the capped-sparse (index, value)
    gather with the tiered cap ladder, dense past the top tier (see
    :func:`dist_bfs`)."""
    caps = _normalize_caps(frontier_cap, At.mloc)
    v, comm, sp, it = _dist_sssp_impl(
        mesh, _arrays(At), jnp.asarray(source, jnp.int32),
        At.shape[0], At.mloc, At.n_shards, axis, caps,
    )
    if not with_stats:
        return v
    stats = {
        "comm_bytes": int(comm[0]),
        "sparse_rounds": int(sp[0]),
        "rounds": int(it[0]),
    }
    return v, stats
