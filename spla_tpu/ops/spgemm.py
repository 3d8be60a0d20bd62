"""Generalized SpGEMM: mxm and masked mxmT (triangle counting driver).

JAX redesign of the reference pair:

* ``mxm`` (reference ``src/cpu/cpu_mxm.hpp:88-114`` — dense-row
  accumulator SpGEMM with identity-sparsification) is implemented as
  **expand-sort-compress** (ESC): expand all products with a prefix-sum
  schedule, 2-key ``lax.sort`` (replacing the OpenCL radix sort
  ``cl_sort_by_key.hpp:98+``), segmented fold by (row, col), drop
  values equal to init (the reference's ``R_tmp[j] != I`` sparsification),
  and compact.

* ``mxmT_masked`` (reference ``cpu_mxmT_masked.hpp:88-125``,
  ``cl_mxmT_masked.cl``) — for each mask entry (i, j), fold over the
  sorted intersection of A row i and B row j.  The sequential two-pointer
  merge becomes a vectorized expansion over B rows plus a row-windowed
  binary search into A (``utils.search.rowwise_find``).

Both phases are *symbolic+numeric in one pass* with a static product
capacity: the symbolic sizing (the reference's atomic-counter phase,
``kernels/vxm.cl:30-55``) runs eagerly on host prefix sums when
``products_cap`` is not supplied — XLA needs static shapes, and the eager
caller (facade) mirrors the reference's counter-readback sync anyway.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..containers import CooMatrix, CsrMatrix, Scalar
from ..formats import coo_to_csr
from ..utils.search import bisect_steps, rowwise_find
from ..utils.segments import segment_fold

__all__ = ["mxm", "mxmT_masked", "count_mxm_products", "count_mxmT_products"]


def _scalar(x, dtype):
    if isinstance(x, Scalar):
        return jnp.asarray(x.value, dtype)
    return jnp.asarray(x, dtype=dtype)


def count_mxm_products(A: CsrMatrix, B: CsrMatrix) -> int:
    """Host-side exact product count for mxm(A, B) (symbolic phase)."""
    nnz_a = int(np.asarray(A.nnz))
    a_cols = np.asarray(A.cols)[:nnz_a]
    deg_b = np.diff(np.asarray(B.indptr))
    return int(deg_b[a_cols].sum())


def count_mxmT_products(mask: CsrMatrix, B: CsrMatrix) -> int:
    """Host-side exact product count for mxmT_masked (one per (mask entry,
    B-row element) pair)."""
    nnz_m = int(np.asarray(mask.nnz))
    m_cols = np.asarray(mask.cols)[:nnz_m]
    deg_b = np.diff(np.asarray(B.indptr))
    return int(deg_b[m_cols].sum())


def _monotone_gather(x, starts, cap):
    """``x[src]`` where ``src`` is the run index of each slot (runs start
    at ``starts``, non-decreasing) — built by scattering value DELTAS at
    run starts and cumsum-ing.  Exact for any 32-bit dtype (int32-bitcast
    modular arithmetic: colliding zero-length-run deltas telescope), and
    O(n + cap) streaming instead of a full-width gather pass."""
    if x.dtype != jnp.int32:
        xi = lax.bitcast_convert_type(x, jnp.int32)
    else:
        xi = x
    d = jnp.concatenate([xi[:1], xi[1:] - xi[:-1]])
    marks = (
        jnp.zeros((cap,), jnp.int32)
        .at[jnp.clip(starts, 0, cap)]
        .add(d, mode="drop")
    )
    out = jnp.cumsum(marks)
    if x.dtype != jnp.int32:
        return lax.bitcast_convert_type(out, x.dtype)
    return out


def _run_fold_compact(rows, cols, prod, valid, op_add, init_a, cap, m,
                      out_cap, drop_init):
    """Fold duplicate (row, col) runs of a SORTED product stream and
    compact the run tails — one segmented scan + one compaction instead
    of segment_fold by run id.  Invalid slots carry
    rows == m and sort to the end, so runs are uniformly valid."""
    from ..utils.segments import segmented_scan_fold

    heads = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_),
         (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])]
    )
    scan_v, scan_h = segmented_scan_fold(prod, valid, heads, op_add)
    tails = jnp.concatenate([heads[1:], jnp.ones((1,), jnp.bool_)])
    folded = op_add(jnp.full_like(scan_v, init_a), scan_v)
    keep = tails & scan_h & (rows < m)
    if drop_init:
        keep &= folded != init_a
    (pos,) = jnp.nonzero(keep, size=out_cap, fill_value=cap)
    posc = jnp.clip(pos, 0, cap - 1)
    ok = pos < cap
    return (
        jnp.where(ok, rows[posc], m).astype(jnp.int32),
        jnp.where(ok, cols[posc], 0).astype(jnp.int32),
        jnp.where(ok, folded[posc], init_a),
        jnp.sum(keep).astype(jnp.int32),
    )


def _expand_entry_streams(row_ids, values, b_base_e, starts, s_clip, cap):
    """Expand the per-entry streams (row id, A value, B row base, run
    start) to per-product-slot streams via monotone delta-cumsum gathers.
    Non-4-byte value dtypes (bool) fall back to one scalar-gather pass."""
    i = _monotone_gather(row_ids.astype(jnp.int32), s_clip, cap)
    start_exp = _monotone_gather(starts.astype(jnp.int32), s_clip, cap)
    b_base = _monotone_gather(b_base_e.astype(jnp.int32), s_clip, cap)
    if values.dtype.itemsize == 4:
        a_val = _monotone_gather(values, s_clip, cap)
    else:
        marks = (
            jnp.zeros((cap,), jnp.int32).at[s_clip].add(1, mode="drop")
        )
        src = jnp.clip(jnp.cumsum(marks) - 1, 0,
                       max(values.shape[0] - 1, 0))
        a_val = values[src]
    return i, a_val, b_base, start_exp


def _expand_schedule(outer_deg, valid, products_cap):
    """Prefix-sum expansion: outer entry e contributes outer_deg[e] product
    slots.  Returns (src[e per slot], local[rank within e], slot_valid).

    src is built by scattering run-start markers and cumsum-ing — O(cap)
    streaming work instead of a 20-step binary search per slot (the
    searchsorted form costs ~20 full-width gather passes)."""
    deg = jnp.where(valid, outer_deg, 0)
    ends = jnp.cumsum(deg)  # inclusive
    total = ends[-1] if ends.shape[0] else jnp.zeros((), deg.dtype)
    starts = ends - deg
    # marker scatter: src[t] = (# runs starting at position <= t) - 1;
    # zero-length runs stack markers at one slot and are skipped naturally
    marks = (
        jnp.zeros((products_cap,), jnp.int32)
        .at[jnp.clip(starts, 0, products_cap)]
        .add(1, mode="drop")
    )
    src = jnp.cumsum(marks) - 1
    src_c = jnp.clip(src, 0, max(outer_deg.shape[0] - 1, 0))
    t = jnp.arange(products_cap, dtype=ends.dtype)
    local = t - starts[src_c]
    slot_valid = t < total
    return src_c, local.astype(jnp.int32), slot_valid


# above this many products the numeric phase runs in product-window
# blocks of MXM_BLOCK_P slots — memory O(block products + output), the
# equivalent of the reference's O(n)-per-row dense accumulator
# (``cpu_mxm.hpp:88-114``) instead of materializing every product.
# Not measured on the H100; the benchmark is to settle both sizes.
MXM_BLOCK_THRESHOLD = 1 << 24
MXM_BLOCK_P = 1 << 22


def mxm(
    A: CsrMatrix,
    B: CsrMatrix,
    op_mul,
    op_add,
    init,
    products_cap: int | None = None,
    out_capacity: int | None = None,
    block_products: int | None = None,
) -> CsrMatrix:
    """R = A * B over the (op_mul, op_add) semiring; entries whose
    accumulated value equals ``init`` are not stored (reference
    ``cpu_mxm.hpp:109-113``).  Result fill = init.

    Symbolic sizing runs host-side (the reference's atomic-counter pass);
    the numeric phase is ONE jitted program keyed on the static caps.
    Past ``MXM_BLOCK_THRESHOLD`` total products (or when
    ``block_products`` is given) the numeric phase runs per product
    window of that many slots, so device memory stays O(block + output)
    up to 2^31 products per multiply (int32 offset arithmetic)."""
    init_a = _scalar(init, A.values.dtype)
    if products_cap is None:  # the symbolic pass only when not supplied
        products_cap = max(count_mxm_products(A, B), 1)
    dense = _mxm_dense_try(A, B, op_mul, op_add, init, int(products_cap),
                           out_capacity)
    if dense is not None:
        return dense
    blk = block_products
    if blk is None and products_cap > MXM_BLOCK_THRESHOLD:
        blk = MXM_BLOCK_P
    if blk is not None and products_cap > blk:
        # product offsets are int32 on device (jax x64 is off)
        assert products_cap < (1 << 31), (
            "blocked mxm supports < 2^31 products per multiply; "
            "split A by rows for larger multiplies"
        )
        return _mxm_blocked(A, B, init_a, op_mul, op_add,
                            int(products_cap), int(blk))
    return _mxm_numeric(
        A, B, init_a, op_mul, op_add, int(products_cap),
        int(out_capacity) if out_capacity is not None else None,
    )


# dense fast path: the expand-sort-fold pipeline makes ~7 full-width
# gather passes over the product stream and one sort, while a dense f32
# matmul of operands that fit runs on the matrix units.  For plus-times
# f32 semirings, densify -> dot(precision=HIGHEST) -> compact is
# semantically identical (absent entries contribute 0 to a PLUS fold;
# accumulations equal to init are dropped in both paths).  HIGHEST keeps
# the product in full float32: the default precision may use TF32 on the
# GPU.  Reference analog: the CPU backend's dense-row accumulator
# (``cpu_mxm.hpp:88-114``) taken to the whole matrix.
MXM_DENSE_CAP = 1 << 27  # max dense elements per operand/result (512 MB)
# below this many products ESC is expected to win over the dense path's
# fixed costs (densify scatters + a full m*n compaction sweep).  Both
# thresholds are not measured on the H100; the benchmark is to settle them.
MXM_DENSE_MIN_PRODUCTS = 1 << 22


def _mxm_dense_try(A, B, op_mul, op_add, init, products_cap, out_capacity):
    m, k = A.shape
    _, n = B.shape
    if products_cap < MXM_DENSE_MIN_PRODUCTS:
        return None
    if (getattr(op_mul, "name", None) != "MULT"
            or getattr(op_add, "name", None) != "PLUS"):
        return None
    if A.values.dtype != jnp.float32 or B.values.dtype != jnp.float32:
        return None
    try:
        if float(np.asarray(init if not hasattr(init, "value") else
                            init.value)) != 0.0:
            return None
    except Exception:
        return None
    if max(m * k, k * n, m * n) > MXM_DENSE_CAP:
        return None
    cap = min(int(products_cap), m * n)
    if out_capacity is not None:
        cap = min(int(out_capacity), m * n)
    return _mxm_dense(A, B, cap)


@partial(jax.jit, static_argnames=("cap",))
def _mxm_dense(A, B, cap):
    m, k = A.shape
    _, n = B.shape
    # densify with EXPLICIT zero fill (absent entries must contribute
    # nothing to the PLUS fold, regardless of the containers' fill values)
    def dense0(M, rows, cols_n):
        base = jnp.zeros((rows + 1, cols_n + 1), jnp.float32)
        vals = jnp.where(M.valid_mask(), M.values, 0.0)
        cols = jnp.where(M.valid_mask(), M.cols, cols_n)
        return base.at[M.row_ids, cols].add(vals, mode="drop")[:rows, :cols_n]

    Ad = dense0(A, m, k)
    Bd = dense0(B, k, n)
    Rd = jnp.dot(Ad, Bd, precision=lax.Precision.HIGHEST)
    flat = Rd.reshape(-1)
    keep = flat != 0.0
    (pos,) = jnp.nonzero(keep, size=cap, fill_value=m * n)
    ok = pos < m * n
    posc = jnp.clip(pos, 0, m * n - 1)
    coo = CooMatrix(
        shape=(m, n),
        rows=jnp.where(ok, (posc // n).astype(jnp.int32), m),
        cols=jnp.where(ok, (posc % n).astype(jnp.int32), 0),
        values=jnp.where(ok, flat[posc], 0.0),
        nnz=jnp.sum(keep).astype(jnp.int32),
        fill=jnp.float32(0.0),
    )
    return coo_to_csr(coo)


@partial(jax.jit, static_argnames=("op_mul", "op_add", "cap"))
def _mxm_block_pass(A, B, init_a, ends, offset, op_mul, op_add, cap):
    """One product-window [offset, offset + cap) of the blocked numeric
    phase: expand, sort, fold duplicates WITHIN the window, compact.
    Returns (rows, cols, vals, count) padded to ``cap``; entries of a row
    straddling two windows appear in both and are merged by the caller's
    final fold."""
    m, k = A.shape
    _, n = B.shape
    deg_b = jnp.diff(B.indptr)
    a_cols = jnp.clip(A.cols, 0, max(k - 1, 0))
    deg = jnp.where(A.valid_mask(), deg_b[a_cols], 0)
    starts = ends - deg
    s_clip = jnp.clip(starts - offset, 0, cap)
    t = jnp.arange(cap, dtype=ends.dtype) + offset
    i, a_val, b_base, start_exp = _expand_entry_streams(
        A.row_ids, A.values, B.indptr[a_cols], starts, s_clip, cap)
    local = (t - start_exp).astype(jnp.int32)
    total = ends[-1] if ends.shape[0] else jnp.zeros((), ends.dtype)
    slot_valid = t < total

    b_pos = jnp.clip(b_base + local, 0, max(B.capacity - 1, 0))
    j = B.cols[b_pos]
    b_val = B.values[b_pos]
    prod = op_mul(a_val, b_val)

    rows = jnp.where(slot_valid, i, m).astype(jnp.int32)
    cols = jnp.where(slot_valid, j, n).astype(jnp.int32)
    rows, cols, prod = lax.sort((rows, cols, prod), num_keys=2)
    # init-sparsification deferred to the caller's cross-window merge
    return _run_fold_compact(rows, cols, prod, rows < m, op_add, init_a,
                             cap, m, cap, drop_init=False)


@partial(jax.jit, static_argnames=("op_add", "cap", "m", "n"))
def _mxm_merge(rows, cols, vals, init_a, op_add, cap, m, n):
    """Final cross-window merge: entries of rows straddling window
    boundaries are folded; init-valued results dropped (reference
    ``cpu_mxm.hpp:109-113``)."""
    rows, cols, vals = lax.sort((rows, cols, vals), num_keys=2)
    run_rows, run_cols, folded, count = _run_fold_compact(
        rows, cols, vals, rows < m, op_add, init_a, cap, m, cap,
        drop_init=True)
    coo = CooMatrix(
        shape=(m, n),
        rows=run_rows,
        cols=run_cols,
        values=folded,
        nnz=count,
        fill=init_a,
    )
    return coo_to_csr(coo)


def _mxm_blocked(A, B, init_a, op_mul, op_add, total, blk):
    """Product-window-blocked numeric phase (eager loop over windows, one
    compiled program reused for every window)."""
    m, k = A.shape
    _, n = B.shape
    deg_b = jnp.diff(B.indptr)
    a_cols = jnp.clip(A.cols, 0, max(k - 1, 0))
    ends = jnp.cumsum(jnp.where(A.valid_mask(), deg_b[a_cols], 0))
    nb = -(-total // blk)
    parts_r, parts_c, parts_v = [], [], []
    kept_total = 0
    for b in range(nb):
        r, c, v, cnt = _mxm_block_pass(
            A, B, init_a, ends, jnp.asarray(b * blk, ends.dtype),
            op_mul, op_add, blk,
        )
        cnt_i = int(np.asarray(cnt))
        # quantized trim keeps the eager slice shapes from exploding the
        # compile cache while transferring ~only the kept entries
        pad = min(-(-max(cnt_i, 1) // 65536) * 65536, blk)
        parts_r.append(r[:pad])
        parts_c.append(c[:pad])
        parts_v.append(v[:pad])
        kept_total += pad
    rows = jnp.concatenate(parts_r)
    cols = jnp.concatenate(parts_c)
    vals = jnp.concatenate(parts_v)
    return _mxm_merge(rows, cols, vals, init_a, op_add, int(kept_total),
                      m, n)


@partial(
    jax.jit, static_argnames=("op_mul", "op_add", "products_cap", "out_capacity")
)
def _mxm_numeric(A, B, init_a, op_mul, op_add, products_cap, out_capacity):
    m, k = A.shape
    k2, n = B.shape
    assert k == k2, "mxm shape mismatch"

    cap = products_cap
    deg_b = jnp.diff(B.indptr)
    a_cols = jnp.clip(A.cols, 0, max(k - 1, 0))
    deg = jnp.where(A.valid_mask(), deg_b[a_cols], 0)
    ends = jnp.cumsum(deg)
    starts = ends - deg
    s_clip = jnp.clip(starts, 0, cap)
    t = jnp.arange(cap, dtype=ends.dtype)
    i, a_val, b_base, start_exp = _expand_entry_streams(
        A.row_ids, A.values, B.indptr[a_cols], starts, s_clip, cap)
    local = (t - start_exp).astype(jnp.int32)
    total = ends[-1] if ends.shape[0] else jnp.zeros((), ends.dtype)
    slot_valid = t < total

    b_pos = jnp.clip(b_base + local, 0, max(B.capacity - 1, 0))
    j = B.cols[b_pos]
    b_val = B.values[b_pos]
    prod = op_mul(a_val, b_val)

    rows = jnp.where(slot_valid, i, m).astype(jnp.int32)
    cols = jnp.where(slot_valid, j, n).astype(jnp.int32)
    rows, cols, prod = lax.sort((rows, cols, prod), num_keys=2)
    out_cap = out_capacity if out_capacity is not None else cap
    run_rows, run_cols, folded, count = _run_fold_compact(
        rows, cols, prod, rows < m, op_add, init_a, cap, m, out_cap,
        drop_init=True)
    coo = CooMatrix(
        shape=(m, n),
        rows=run_rows,
        cols=run_cols,
        values=folded,
        nnz=count,
        fill=init_a,
    )
    return coo_to_csr(coo)


def mxmT_masked(
    mask: CsrMatrix,
    A: CsrMatrix,
    B: CsrMatrix,
    op_mul,
    op_add,
    op_select,
    init,
    products_cap: int | None = None,
    out_capacity: int | None = None,
    struct_only: bool = False,
) -> CsrMatrix:
    """R = (A * B^T) masked by `mask` (reference exec_mxmT_masked,
    ``include/spla/exec.hpp:104-131``): for each mask entry (i, j) with
    select(mask_x): R[i,j] = fold(add, init, mul(A[i,k], B[j,k]) over the
    column intersection); entries equal to init are dropped.

    ``struct_only`` (descriptor parity) treats all stored values as 1 and
    every mask entry as selected — products become intersection
    indicators, skipping three full-width value gathers.  Exact for
    triangle counting."""
    init_a = _scalar(init, A.values.dtype)
    if products_cap is None:
        products_cap = max(count_mxmT_products(mask, B), 1)
    # tight static bisection bound from A's max row degree: every extra
    # step is a full-width gather over all product slots
    max_deg_a = int(np.diff(np.asarray(A.indptr)).max(initial=0))
    steps = bisect_steps(max(max_deg_a, 1))
    return _mxmT_numeric(
        mask, A, B, init_a, op_mul, op_add, op_select, int(products_cap),
        int(out_capacity) if out_capacity is not None else None, steps,
        struct_only,
    )


@partial(
    jax.jit,
    static_argnames=(
        "op_mul", "op_add", "op_select", "products_cap", "out_capacity",
        "steps", "struct_only",
    ),
)
def _mxmT_numeric(
    mask, A, B, init_a, op_mul, op_add, op_select, products_cap, out_capacity,
    steps=32, struct_only=False,
):
    m, n = mask.shape
    deg_b = jnp.diff(B.indptr)
    mask_cols = jnp.clip(mask.cols, 0, max(B.shape[0] - 1, 0))
    src, local, slot_valid = _expand_schedule(
        deg_b[mask_cols], mask.valid_mask(), products_cap
    )
    i = mask.row_ids[src]  # output row
    b_pos = jnp.clip(B.indptr[mask_cols[src]] + local, 0, max(B.capacity - 1, 0))
    kk = B.cols[b_pos]
    # lookup A[i, kk]
    i_c = jnp.clip(i, 0, max(m - 1, 0))
    a_pos, found = rowwise_find(
        A.cols, A.indptr[i_c], A.indptr[i_c + 1], kk, steps=steps
    )
    if struct_only:
        prod = jnp.ones(found.shape, init_a.dtype)
        valid = slot_valid & found
    else:
        sel = op_select(mask.values[src])
        b_val = B.values[b_pos]
        a_val = A.values[jnp.clip(a_pos, 0, max(A.capacity - 1, 0))]
        prod = op_mul(a_val, b_val)
        valid = slot_valid & sel & found

    # fold per SOURCE MASK ENTRY (src is sorted by construction): the
    # scatter path of segment_fold applies for hardware monoids
    # (add/min/max/mul); others take the segmented-scan path
    mcap = mask.capacity
    # keep seg_ids = src UNCHANGED (sorted): routing invalid slots to a
    # dump id here would interleave mcap between sorted ids and break the
    # generic scan path's searchsorted; segment_fold's valid flags already
    # exclude them on every path
    folded, has = segment_fold(
        prod, src.astype(jnp.int32), valid, mcap, op_add, init_a
    )
    if struct_only:
        sel_e = mask.valid_mask()
    else:
        sel_e = op_select(mask.values) & mask.valid_mask()
    keep = has & sel_e & (folded != init_a)

    out_cap = out_capacity if out_capacity is not None else mcap
    (pos,) = jnp.nonzero(keep, size=out_cap, fill_value=mcap)
    posc = jnp.clip(pos, 0, mcap - 1)
    ok = pos < mcap
    coo = CooMatrix(
        shape=(m, n),
        rows=jnp.where(ok, mask.row_ids[posc], m).astype(jnp.int32),
        cols=jnp.where(ok, mask.cols[posc], 0).astype(jnp.int32),
        values=jnp.where(ok, folded[posc], init_a),
        nnz=jnp.sum(keep).astype(jnp.int32),
        fill=init_a,
    )
    return coo_to_csr(coo)
