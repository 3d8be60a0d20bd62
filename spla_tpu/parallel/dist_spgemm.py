"""Distributed SpGEMM: row-merge mxm / masked mxmT over a device mesh.

New capability mandated by BASELINE.json's north star ("SpGEMM uses a
distributed row-merge with symbolic+numeric phases") — the reference is
single-device (SURVEY §2.8).  Scheme:

* A and B are block-row sharded (:class:`ShardedCsr`); R inherits A's
  row partition, so each chip owns the merge of its A rows.
* **Ring rotation**: the needed B rows live on other chips; instead of
  replicating B, its shard arrays rotate around the mesh axis with
  ``lax.ppermute`` (NCCL over NVLink).  At step s, chip p holds B shard
  ``(p + s) % P`` and expands exactly the products of its local A entries
  whose column falls in that shard — after P steps every product has been
  produced exactly once, with communication volume |B| per chip total
  (the minimum for row-merge without replication).
* **Symbolic phase** (host, numpy): exact per-(chip, step) product counts
  from the degree arrays; the max count is the static per-step expansion
  capacity XLA needs.  This replaces the reference's atomic-counter sizing
  pass (``kernels/vxm.cl:30-55``).
* **Numeric phase** (one jit program): per-step prefix-sum expansion +
  gather (no atomics), then ONE sort + segmented fold over the
  concatenated P-step product list per chip — the equivalent of
  the reference CPU SpGEMM's dense-row accumulator
  (``src/cpu/cpu_mxm.hpp:88-114``).

``dist_tc`` fuses the masked mxmT with the PLUS reduction (triangle
counting never materializes B = (A·A^T)⊙A; it only needs its sum), so the
per-chip state is one scalar and the final count is a single ``psum``.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from ..containers import CsrMatrix
from ..utils.search import rowwise_find
from ..utils.segments import segmented_scan_fold
from .dist_matrix import ShardedCsr

__all__ = [
    "dist_mxm",
    "dist_mxmT_masked_reduce",
    "dist_tc",
    "count_dist_mxm_cap",
    "count_dist_mxmT_cap",
]


def _np_shard_arrays(sc: ShardedCsr):
    return (
        np.asarray(sc.indptr),
        np.asarray(sc.cols),
        np.asarray(sc.nnz),
    )


def _expansion_cap(left: ShardedCsr, B: ShardedCsr) -> int:
    """Symbolic phase: max products any (chip, rotation step) pair expands
    — one slot per (left entry, element of the B row its column names);
    exact, from degree arrays (host numpy)."""
    l_indptr, l_cols, l_nnz = _np_shard_arrays(left)
    b_indptr, _, _ = _np_shard_arrays(B)
    P_ = left.n_shards
    deg_b = np.diff(b_indptr, axis=1)  # [S, mloc_b]
    cap = 1
    for p in range(P_):
        cols = l_cols[p, : l_nnz[p]]
        owner = np.clip(cols // B.mloc, 0, P_ - 1)
        local = cols - owner * B.mloc
        d = deg_b[owner, local]
        counts = np.bincount(owner, weights=d, minlength=P_)
        cap = max(cap, int(counts.max()))
    return cap


def count_dist_mxm_cap(A: ShardedCsr, B: ShardedCsr) -> int:
    return _expansion_cap(A, B)


def count_dist_mxmT_cap(mask: ShardedCsr, B: ShardedCsr) -> int:
    return _expansion_cap(mask, B)


def _expand(outer_deg, valid, cap):
    """Prefix-sum expansion (jit): outer entry e yields outer_deg[e] slots.
    Marker-scatter + cumsum (bandwidth) instead of per-slot binary search
    — see ops.spgemm._expand_schedule."""
    deg = jnp.where(valid, outer_deg, 0)
    ends = jnp.cumsum(deg)
    total = ends[-1] if ends.shape[0] else jnp.zeros((), deg.dtype)
    starts = ends - deg
    marks = (
        jnp.zeros((cap,), jnp.int32)
        .at[jnp.clip(starts, 0, cap)]
        .add(1, mode="drop")
    )
    src = jnp.cumsum(marks) - 1
    src_c = jnp.clip(src, 0, max(outer_deg.shape[0] - 1, 0))
    t = jnp.arange(cap, dtype=ends.dtype)
    local = t - starts[src_c]
    return src_c, local.astype(jnp.int32), t < total


@partial(
    jax.jit,
    static_argnames=("mesh", "axis", "cap", "out_cap", "op_mul", "op_add", "meta"),
)
def _dist_mxm_impl(mesh, a_arrs, b_arrs, init, cap, out_cap, op_mul, op_add, meta, axis):
    (m, n, mloc_a, mloc_b, n_shards, a_cap, b_cap) = meta

    def step_fn(a_indptr, a_cols, a_vals, a_rows, a_nnz, b_indptr, b_cols, b_vals):
        my = lax.axis_index(axis)
        a_indptr, a_cols, a_vals, a_rows, a_nnz = (
            a_indptr[0], a_cols[0], a_vals[0], a_rows[0], a_nnz[0]
        )
        bi, bc, bv = b_indptr[0], b_cols[0], b_vals[0]
        a_valid = jnp.arange(a_cap, dtype=jnp.int32) < a_nnz

        def rot_body(s, carry):
            bi, bc, bv, acc_i, acc_j, acc_v, acc_ok = carry
            src_shard = (my + s) % n_shards
            lo = src_shard * mloc_b
            in_range = a_valid & (a_cols >= lo) & (a_cols < lo + mloc_b)
            bl = jnp.clip(a_cols - lo, 0, mloc_b - 1)
            deg = bi[bl + 1] - bi[bl]
            src, local, slot_ok = _expand(deg, in_range, cap)
            b_pos = jnp.clip(bi[bl[src]] + local, 0, b_cap - 1)
            i = a_rows[src]  # local output row
            j = bc[b_pos]
            v = op_mul(a_vals[src], bv[b_pos])
            acc_i = lax.dynamic_update_slice(acc_i, jnp.where(slot_ok, i, mloc_a), (s * cap,))
            acc_j = lax.dynamic_update_slice(acc_j, jnp.where(slot_ok, j, 0), (s * cap,))
            acc_v = lax.dynamic_update_slice(acc_v, v, (s * cap,))
            acc_ok = lax.dynamic_update_slice(acc_ok, slot_ok, (s * cap,))
            # rotate B shard to the next chip (ring over the mesh axis)
            perm = [(p, (p - 1) % n_shards) for p in range(n_shards)]
            bi = lax.ppermute(bi, axis, perm)
            bc = lax.ppermute(bc, axis, perm)
            bv = lax.ppermute(bv, axis, perm)
            return (bi, bc, bv, acc_i, acc_j, acc_v, acc_ok)

        total = n_shards * cap
        # mark carries device-varying for shard_map's vma typing
        vary = lambda t: lax.pcast(t, (axis,), to="varying")
        acc_i = vary(jnp.full((total,), mloc_a, jnp.int32))
        acc_j = vary(jnp.zeros((total,), jnp.int32))
        acc_v = vary(jnp.zeros((total,), a_vals.dtype))
        acc_ok = vary(jnp.zeros((total,), jnp.bool_))
        _, _, _, acc_i, acc_j, acc_v, acc_ok = lax.fori_loop(
            0, n_shards, rot_body, (bi, bc, bv, acc_i, acc_j, acc_v, acc_ok)
        )

        # merge: sort by (i, j), segmented fold, drop values == init
        rows_k = jnp.where(acc_ok, acc_i, mloc_a)
        cols_k = jnp.where(acc_ok, acc_j, n)
        rows_k, cols_k, vv, ok = lax.sort((rows_k, cols_k, acc_v, acc_ok), num_keys=2)
        heads = jnp.concatenate(
            [jnp.ones((1,), jnp.bool_), (rows_k[1:] != rows_k[:-1]) | (cols_k[1:] != cols_k[:-1])]
        )
        scan_v, scan_h = segmented_scan_fold(vv, ok, heads, op_add)
        is_last = jnp.concatenate([heads[1:], jnp.ones((1,), jnp.bool_)])
        folded = op_add(jnp.full_like(scan_v, init), scan_v)
        keep = is_last & scan_h & (rows_k < mloc_a) & (folded != init)

        (pos,) = jnp.nonzero(keep, size=out_cap, fill_value=total)
        posc = jnp.clip(pos, 0, total - 1)
        got = pos < total
        r_rows = jnp.where(got, rows_k[posc], mloc_a).astype(jnp.int32)
        r_cols = jnp.where(got, cols_k[posc], 0).astype(jnp.int32)
        r_vals = jnp.where(got, folded[posc], init)
        # clamp: with a too-small out_capacity the compaction truncates;
        # nnz must never exceed the stored entry count
        r_nnz = jnp.minimum(jnp.sum(keep), out_cap).astype(jnp.int32)
        indptr = jnp.searchsorted(
            r_rows, jnp.arange(mloc_a + 1, dtype=jnp.int32), side="left"
        ).astype(jnp.int32)
        indptr = jnp.minimum(indptr, r_nnz)
        return (
            indptr[None], r_cols[None], r_vals[None], r_rows[None], r_nnz[None]
        )

    f = jax.shard_map(
        step_fn,
        mesh=mesh,
        in_specs=(P(axis),) * 5 + (P(axis),) * 3,
        out_specs=(P(axis),) * 5,
    )
    return f(*a_arrs, *b_arrs)


def dist_mxm(
    mesh: Mesh,
    A: ShardedCsr,
    B: ShardedCsr,
    op_mul,
    op_add,
    init,
    products_cap: int | None = None,
    out_capacity: int | None = None,
    axis: str = "d",
) -> ShardedCsr:
    """R = A * B over (op_mul, op_add); R row-sharded like A.

    Semantics match single-device :func:`spla_tpu.ops.mxm` (reference
    ``exec_mxm``, ``include/spla/exec.hpp:66-84``): accumulated values
    equal to ``init`` are not stored."""
    m, k = A.shape
    k2, n = B.shape
    assert k == k2, "dist_mxm shape mismatch"
    cap = products_cap if products_cap is not None else count_dist_mxm_cap(A, B)
    cap = max(cap, 1)
    out_cap = out_capacity if out_capacity is not None else cap * A.n_shards
    init_a = jnp.asarray(init, A.values.dtype)
    meta = (m, n, A.mloc, B.mloc, A.n_shards, A.capacity, B.capacity)
    a_arrs = (A.indptr, A.cols, A.values, A.row_ids, A.nnz)
    b_arrs = (B.indptr, B.cols, B.values)
    indptr, cols, vals, rows, nnz = _dist_mxm_impl(
        mesh, a_arrs, b_arrs, init_a, int(cap), int(out_cap),
        op_mul, op_add, meta, axis,
    )
    return ShardedCsr(
        shape=(m, n), n_shards=A.n_shards, mloc=A.mloc,
        indptr=indptr, cols=cols, values=vals, row_ids=rows, nnz=nnz,
        fill=init_a,
    )


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "axis", "cap", "op_mul", "op_add", "op_select", "meta", "steps"
    ),
)
def _dist_mxmT_reduce_impl(
    mesh, m_arrs, a_arrs, b_arrs, init, cap, op_mul, op_add, op_select, meta, axis,
    steps=32,
):
    (mloc_m, mloc_b, n_shards, m_cap, a_cap, b_cap, m_rows_total) = meta

    def step_fn(
        m_indptr, m_cols, m_vals, m_rows, m_nnz,
        a_indptr, a_cols, a_vals, a_nnz,
        b_indptr, b_cols, b_vals,
    ):
        my = lax.axis_index(axis)
        m_cols_, m_vals_, m_rows_, m_nnz_ = m_cols[0], m_vals[0], m_rows[0], m_nnz[0]
        ai, ac, av, a_nnz_ = a_indptr[0], a_cols[0], a_vals[0], a_nnz[0]
        bi, bc, bv = b_indptr[0], b_cols[0], b_vals[0]
        m_valid = jnp.arange(m_cap, dtype=jnp.int32) < m_nnz_
        sel = op_select(m_vals_)

        def rot_body(s, carry):
            bi, bc, bv, acc = carry
            src_shard = (my + s) % n_shards
            lo = src_shard * mloc_b
            in_range = m_valid & sel & (m_cols_ >= lo) & (m_cols_ < lo + mloc_b)
            bl = jnp.clip(m_cols_ - lo, 0, mloc_b - 1)
            deg = bi[bl + 1] - bi[bl]
            src, local, slot_ok = _expand(deg, in_range, cap)
            b_pos = jnp.clip(bi[bl[src]] + local, 0, b_cap - 1)
            kk = bc[b_pos]
            b_val = bv[b_pos]
            i = jnp.clip(m_rows_[src], 0, ai.shape[0] - 2)
            a_pos, found = rowwise_find(ac, ai[i], ai[i + 1], kk, steps=steps)
            a_val = av[jnp.clip(a_pos, 0, a_cap - 1)]
            prod = op_mul(a_val, b_val)
            ok = slot_ok & found
            # fold reduction directly (no materialized R)
            contrib = jnp.where(ok, prod, jnp.zeros((), prod.dtype))
            acc = acc + jnp.sum(contrib)
            perm = [(p, (p - 1) % n_shards) for p in range(n_shards)]
            bi = lax.ppermute(bi, axis, perm)
            bc = lax.ppermute(bc, axis, perm)
            bv = lax.ppermute(bv, axis, perm)
            return (bi, bc, bv, acc)

        acc0 = lax.pcast(jnp.zeros((), av.dtype), (axis,), to="varying")
        _, _, _, acc = lax.fori_loop(0, n_shards, rot_body, (bi, bc, bv, acc0))
        total = lax.psum(acc, axis)
        return total[None]

    f = jax.shard_map(
        step_fn,
        mesh=mesh,
        in_specs=(P(axis),) * 5 + (P(axis),) * 4 + (P(axis),) * 3,
        out_specs=P(axis),
    )
    return f(*m_arrs, *a_arrs, *b_arrs)


def dist_mxmT_masked_reduce(
    mesh: Mesh,
    mask: ShardedCsr,
    A: ShardedCsr,
    B: ShardedCsr,
    op_mul,
    op_add,
    op_select,
    init,
    products_cap: int | None = None,
    axis: str = "d",
):
    """PLUS-reduction of R = (A * B^T) ⊙ mask without materializing R.

    The per-chip partial is a scalar folded inside the rotation loop; the
    global result is one psum.  (Fusing the reduce is exact for PLUS;
    triangle counting is its only reference use —
    ``src/algorithm.cpp:380-414``.)"""
    if getattr(op_add, "name", None) not in (None, "PLUS"):
        raise NotImplementedError(
            "dist_mxmT_masked_reduce folds with PLUS only (the reduction is "
            f"fused into the rotation loop); got op_add={op_add.name}."
        )
    cap = products_cap if products_cap is not None else count_dist_mxmT_cap(mask, B)
    cap = max(int(cap), 1)
    from ..utils.search import bisect_steps

    max_deg_a = int(np.diff(np.asarray(A.indptr), axis=1).max(initial=0))
    steps = bisect_steps(max(max_deg_a, 1))
    init_a = jnp.asarray(init, A.values.dtype)
    meta = (
        mask.mloc, B.mloc, mask.n_shards,
        mask.capacity, A.capacity, B.capacity, mask.shape[0],
    )
    m_arrs = (mask.indptr, mask.cols, mask.values, mask.row_ids, mask.nnz)
    a_arrs = (A.indptr, A.cols, A.values, A.nnz)
    b_arrs = (B.indptr, B.cols, B.values)
    out = _dist_mxmT_reduce_impl(
        mesh, m_arrs, a_arrs, b_arrs, init_a, cap,
        op_mul, op_add, op_select, meta, axis, steps,
    )
    return np.asarray(out)[0] + np.asarray(init_a)


def dist_tc(mesh: Mesh, A: ShardedCsr, axis: str = "d") -> int:
    """Distributed triangle counting: reduce((A·A^T) ⊙ A, PLUS) — counts
    each triangle 6x on a full symmetric adjacency, matching the reference
    convention (``src/algorithm.cpp:380-414``)."""
    from .. import op as OP

    t = A.values.dtype
    mul = OP.lookup("MULT", _type_of(t))
    sel = OP.lookup("GTZERO", _type_of(t))
    add = OP.lookup("PLUS", _type_of(t))
    return int(
        dist_mxmT_masked_reduce(mesh, A, A, A, mul, add, sel, 0, axis=axis)
    )


def _type_of(dtype):
    from ..types import type_from_dtype

    return type_from_dtype(dtype)
