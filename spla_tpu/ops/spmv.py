"""Masked generalized SpMV — the hottest ops (BFS/SSSP/PR inner step).

JAX redesign of the reference's pull/push SpMV pair:

* ``mxv_masked`` — pull SpMV with mask select + init (reference
  ``src/cpu/cpu_mxv.hpp:88-105``, OpenCL ``kernels/mxv.cl:44-81``).
* ``vxm_masked`` — push SpMV over a sparse frontier (reference
  ``src/cpu/cpu_vxm.hpp:92-132``, OpenCL 3-phase
  count/collect/sort/reduce-by-key pipeline ``cl_vxm.hpp:73-177``).

Both reduce to ONE primitive, :func:`masked_spmv`, evaluated over a CSR
matrix: push is pull over the transpose with a validity mask on the input
vector's stored entries.  The OpenCL atomics/sort/reduce-by-key machinery
is replaced by a segment reduction (scatter or segmented scan — see
``spla_tpu.utils.segments``), which XLA fuses with the gather and the
elementwise multiply.  On the GPU the gather and the scatter-fold lower
to hardware gathers and atomics; float PLUS folds therefore sum in an
order that changes from run to run (MIN/MAX and integer folds are exact).

Semantics (per reference): ``r[i] = select(mask[i]) ? fold(add, init,
mul(M[i,j], v[j]) for stored j) : init``; a result slot is *stored* iff the
mask selected it and >= 1 product contributed — a stored value may equal
``init``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..containers import CsrMatrix, DenseVec, Scalar, SparseVec
from ..utils.segments import segment_fold

__all__ = [
    "masked_spmv",
    "mxv_masked",
    "vxm_masked",
    "vxm_masked_dense",
    "masked_spmv_structural",
    "best_spmv_fn",
]


def _scalar(x, dtype):
    if isinstance(x, Scalar):
        return jnp.asarray(x.value, dtype)
    return jnp.asarray(x, dtype=dtype)


def masked_spmv(
    A: CsrMatrix,
    x_vals: jax.Array,
    op_mul,
    op_add,
    init,
    x_valid: jax.Array | None = None,
    mask_vals: jax.Array | None = None,
    op_select=None,
):
    """Core primitive: returns ``(vals [m], has [m])``.

    vals[i] = fold(op_add, init, op_mul(A[i,j], x[j]) for valid nnz j)
              where select(mask[i]), else init.
    has[i]  = structural stored-ness (selected and >=1 product).
    """
    m, n = A.shape
    init = _scalar(init, A.values.dtype)
    cols = jnp.clip(A.cols, 0, max(n - 1, 0))
    xg = x_vals[cols]
    valid = A.valid_mask()
    if x_valid is not None:
        valid = valid & x_valid[cols]
    prod = op_mul(A.values, xg)
    out, has = segment_fold(prod, A.row_ids, valid, m, op_add, init, sorted_ids=True)
    if mask_vals is not None and op_select is not None:
        sel = op_select(mask_vals)
        out = jnp.where(sel, out, init)
        has = has & sel
    return out, has


def masked_spmv_structural(
    A: CsrMatrix,
    x_active: jax.Array,
    mask_sel: jax.Array | None = None,
):
    """Structure-only traversal step (descriptor ``struct_only``,
    reference ``include/spla/descriptor.hpp:76-79`` + BFS usage
    ``src/algorithm.cpp:91-100``): out[i] = mask_sel[i] AND any j in row i
    with x_active[j].  Boolean in/out; values ignored entirely."""
    m, n = A.shape
    cols = jnp.clip(A.cols, 0, max(n - 1, 0))
    hit = (A.valid_mask() & x_active[cols]).astype(jnp.int32)
    seg = jnp.where(hit > 0, A.row_ids, m)
    reached = jnp.zeros((m + 1,), jnp.int32).at[seg].max(hit)[:m] > 0
    if mask_sel is not None:
        reached = reached & mask_sel
    return reached


def best_spmv_fn(A: CsrMatrix, op_mul, op_add, init):
    """Unmasked-SpMV callable ``f(A, x) -> vals`` for this semiring: the
    gather + segment-fold path of :func:`masked_spmv`, which XLA compiles
    for whatever device holds the operands."""

    def xla_fn(A, x):
        out, _ = masked_spmv(A, x, op_mul, op_add, init)
        return out

    return xla_fn


@partial(jax.jit, static_argnames=("op_mul", "op_add", "op_select", "desc"))
def mxv_masked(
    mask: DenseVec,
    M: CsrMatrix,
    v: DenseVec,
    op_mul,
    op_add,
    op_select,
    init,
    desc=None,
) -> DenseVec:
    """Pull SpMV: dense result over dense v (reference exec_mxv_masked,
    ``include/spla/exec.hpp:157-186``).  ``early_exit`` is advisory
    (results identical for idempotent accumulators)."""
    init_a = _scalar(init, M.values.dtype)
    out, _ = masked_spmv(
        M,
        v.values,
        op_mul,
        op_add,
        init_a,
        x_valid=None,
        mask_vals=mask.values,
        op_select=op_select,
    )
    return DenseVec(out, init_a)


def _vxm_products(mask, v, M_t, op_mul, op_add, op_select, init_a):
    """Shared body of the push SpMVs: densify ``v`` (unstored slots are
    invalid inputs) and run the pull primitive over ``M_t`` with the
    operand order swapped — masked_spmv computes ``mul(A_t[j,i], x[i])``
    but the reference computes ``mul(v[i], M[i,j])``."""
    n_in = M_t.shape[1]
    if isinstance(v, SparseVec):
        base = jnp.full((n_in + 1,), init_a, init_a.dtype)
        vals = jnp.where(v.valid_mask(), v.values, init_a)
        x_vals = base.at[v.indices].set(vals, mode="drop")[:n_in]
        x_valid = (
            jnp.zeros((n_in + 1,), jnp.bool_)
            .at[v.indices]
            .set(v.valid_mask(), mode="drop")[:n_in]
        )
    else:
        x_vals = v.values
        x_valid = v.stored_mask()
    return masked_spmv(
        M_t,
        x_vals,
        lambda a_val, x_val: op_mul(x_val, a_val),
        op_add,
        init_a,
        x_valid=x_valid,
        mask_vals=mask.values,
        op_select=op_select,
    )


@partial(jax.jit, static_argnames=("op_mul", "op_add", "op_select", "desc"))
def vxm_masked_dense(
    mask: DenseVec,
    v,
    M_t: CsrMatrix,
    op_mul,
    op_add,
    op_select,
    init,
    desc=None,
) -> DenseVec:
    """Dense-result push SpMV — the facade fast path.

    Value-equivalent to ``dense(vxm_masked(...))``: a dense container
    represents stored-slots-whose-value-equals-fill identically to
    unstored slots, so the sparse compaction is unobservable through it
    and is skipped."""
    init_a = _scalar(init, M_t.values.dtype)
    out, has = _vxm_products(mask, v, M_t, op_mul, op_add, op_select, init_a)
    return DenseVec(jnp.where(has, out, init_a), init_a)


@partial(jax.jit, static_argnames=("op_mul", "op_add", "op_select", "desc", "out_capacity"))
def vxm_masked(
    mask: DenseVec,
    v,
    M_t: CsrMatrix,
    op_mul,
    op_add,
    op_select,
    init,
    desc=None,
    out_capacity: int | None = None,
) -> SparseVec:
    """Push SpMV r = v x M, computed as pull over the *transpose* ``M_t``
    (CSR of M^T; the container layer keeps both orientations, analogous to
    the reference keeping multiple storage decorations alive).

    ``v`` may be a SparseVec (reference signature) or a DenseVec whose
    stored entries are those != fill.  Result is sparse; stored slots are
    exactly those with a selected product (value may equal init —
    reference ``cpu_vxm.hpp`` keeps them).  Every stored entry of ``M_t``
    is read whatever the frontier's density: the descriptor's push/pull
    modes are advisory.
    """
    init_a = _scalar(init, M_t.values.dtype)
    n_out = M_t.shape[0]
    out, has = _vxm_products(mask, v, M_t, op_mul, op_add, op_select, init_a)
    cap = out_capacity if out_capacity is not None else n_out
    (idx,) = jnp.nonzero(has, size=cap, fill_value=n_out)
    vals = jnp.where(idx < n_out, out[jnp.clip(idx, 0, n_out - 1)], init_a)
    nnz = jnp.minimum(jnp.sum(has).astype(jnp.int32), jnp.int32(cap))
    return SparseVec(n=n_out, indices=idx.astype(jnp.int32), values=vals, nnz=nnz, fill=init_a)
