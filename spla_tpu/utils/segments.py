"""Generalized segment reductions — the replacement for the reference's
sort/scan/reduce-by-key OpenCL pipeline (reference: ``src/opencl/
cl_reduce_by_key.hpp:43-90``, ``cl_prefix_sum.hpp:39-85``,
``cl_sort_by_key.hpp:44-95``).

Two paths:

* **scatter path** — when the combine op coincides with a hardware scatter
  combiner (add/mul/min/max, commutative monoids), use ``jnp.ndarray.at``
  scatter ops; XLA lowers these to native scatters (atomics on the GPU,
  so a float "add" fold sums in an order that changes from run to run;
  min/max and integer folds are exact and repeat).
* **generic path** — for any associative op (BOR, LOR, user ops, ...), a
  segmented inclusive scan via ``lax.associative_scan`` over
  (value, has, boundary-flag) triples.  Validity flags make skipped
  ("structurally absent") entries a first-class notion so no identity
  element is required of the op.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["segmented_scan_fold", "segment_fold", "combine_segments"]


def segmented_scan_fold(values, valid, heads, op):
    """Segmented inclusive fold with validity.

    Parameters
    ----------
    values : [k, ...] array of elements (garbage allowed where ~valid)
    valid  : [k] bool — elements to include in the fold
    heads  : [k] bool — True at the first element of each segment
    op     : associative binary combine on values

    Returns ``(scan_values, scan_has)`` where at the *last* position of each
    segment ``scan_values`` holds the left-to-right fold over that segment's
    valid elements and ``scan_has`` says whether any valid element existed.
    """

    def combine(a, b):
        av, ah, af = a
        bv, bh, bf = b
        both = ah & bh
        # op may produce garbage on invalid operands — discarded by where.
        merged = jnp.where(both, op(av, bv), jnp.where(bh, bv, av))
        v = jnp.where(bf, bv, merged)
        h = jnp.where(bf, bh, ah | bh)
        return (v, h, af | bf)

    out_v, out_h, _ = lax.associative_scan(combine, (values, valid, heads))
    return out_v, out_h


def segment_fold(values, seg_ids, valid, num_segments, op, init, sorted_ids=True):
    """Fold ``values`` grouped by ``seg_ids`` into ``num_segments`` buckets.

    Result[s] = fold(op, init, values of segment s in order); segments with
    no valid element get ``init`` (GraphBLAS identity/init semantics,
    reference ``src/cpu/cpu_mxv.hpp:88-105``).  Also returns a per-segment
    ``has`` mask (segment had >=1 valid element) — the structural
    "stored-ness" of the result, needed because a stored value may equal
    ``init`` (reference ``src/cpu/cpu_vxm.hpp`` keeps such entries).

    ``seg_ids`` must be in [0, num_segments]; id == num_segments is a dump
    slot.  ``sorted_ids=True`` (CSR order) enables the generic scan path;
    scatter path works either way.
    """
    k = values.shape[0]
    init = jnp.asarray(init, dtype=values.dtype)

    scatter = getattr(op, "scatter", None)
    if scatter is not None:
        # invalid entries go to the dump segment (only safe here: the
        # generic path below relies on seg_ids staying sorted)
        seg_ids = jnp.where(valid, seg_ids, num_segments)
        out = jnp.full((num_segments + 1,), init, dtype=values.dtype)
        safe_vals = _scatter_neutral(values, valid, scatter)
        if scatter == "add":
            out = out.at[seg_ids].add(safe_vals)
        elif scatter == "mul":
            out = out.at[seg_ids].multiply(safe_vals)
        elif scatter == "min":
            out = out.at[seg_ids].min(safe_vals)
        elif scatter == "max":
            out = out.at[seg_ids].max(safe_vals)
        else:  # pragma: no cover
            raise ValueError(f"unknown scatter kind {scatter}")
        has = jnp.zeros((num_segments + 1,), jnp.bool_).at[seg_ids].max(valid)
        return out[:num_segments], has[:num_segments]

    if not getattr(op, "associative", True):
        raise ValueError(
            f"op {getattr(op, 'name', op)} is not associative; cannot be used "
            "as a parallel reduction monoid"
        )
    if not sorted_ids:
        order = jnp.argsort(seg_ids, stable=True)
        seg_ids = seg_ids[order]
        values = values[order]
        valid = valid[order]
    heads = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), seg_ids[1:] != seg_ids[:-1]]
    )
    scan_v, scan_h = segmented_scan_fold(values, valid, heads, op)
    # last position of each segment: searchsorted right boundary - 1
    ends = jnp.searchsorted(seg_ids, jnp.arange(num_segments, dtype=seg_ids.dtype), side="right")
    starts = jnp.searchsorted(seg_ids, jnp.arange(num_segments, dtype=seg_ids.dtype), side="left")
    nonempty = ends > starts
    last = jnp.clip(ends - 1, 0, k - 1)
    has = nonempty & scan_h[last]
    folded = jnp.where(has, scan_v[last], init)
    out = jnp.where(has, op(jnp.full_like(folded, init), folded), init)
    return out.astype(values.dtype), has


def _scatter_neutral(values, valid, scatter):
    """Replace invalid lanes with values that cannot poison the scatter
    (NaN/inf propagate through min/max/add even into the dump row's
    neighbours is fine — but keep them finite for safety)."""
    if scatter == "mul":
        neutral = jnp.ones((), values.dtype)
    else:
        neutral = jnp.zeros((), values.dtype)
    return jnp.where(valid, values, neutral)


def combine_segments(values, has, init, op):
    """r = op(init, fold) where has else init — helper mirroring the
    reference's ``sum = init; sum = add(sum, ...)`` chain."""
    init_b = jnp.full_like(values, init)
    return jnp.where(has, op(init_b, values), init_b)
