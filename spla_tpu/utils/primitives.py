"""Parallel primitive parity wrappers.

Named equivalents of the reference's OpenCL device primitives — each maps
to ONE native XLA op, which is the whole point of the redesign:

* ``sort_by_key``   <- bitonic/radix ``cl_sort_by_key.hpp:44-95``
* ``reduce_by_key`` <- ``cl_reduce_by_key.hpp:43-90``
* ``prefix_sum``    <- recursive block scan ``cl_prefix_sum.hpp:39-85``
* ``exclusive_scan``/``inclusive_scan`` convenience forms
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from .segments import segment_fold

__all__ = [
    "sort_by_key",
    "reduce_by_key",
    "prefix_sum",
    "inclusive_scan",
    "exclusive_scan",
]


@jax.jit
def sort_by_key(keys, *values):
    """Stable ascending sort of (keys, values...) by keys (reference
    radix/bitonic sort-by-key; here ``lax.sort``)."""
    out = lax.sort((keys, *values), num_keys=1, is_stable=True)
    return out


@partial(jax.jit, static_argnames=("op", "num_segments", "init"))
def reduce_by_key(keys, values, op, num_segments, init=None):
    """Combine adjacent equal-key runs (keys sorted).  Returns dense
    ``(out[num_segments], has[num_segments])`` — out[k] = fold over key k.

    ``init`` defaults to the op's monoid identity; an op without one must
    be given an explicit init (a silent 0 would corrupt e.g. MIN folds).
    """
    valid = jnp.ones(keys.shape, jnp.bool_)
    if init is None:
        init = getattr(op, "identity", None)
        if init is None:
            raise ValueError(
                f"op {getattr(op, 'name', op)} has no identity; pass init="
            )
    init = jnp.asarray(init, values.dtype)
    return segment_fold(values, keys, valid, num_segments, op, init)


@jax.jit
def prefix_sum(x):
    """Exclusive prefix sum (the reference's cl_prefix_sum semantics)."""
    return jnp.cumsum(x) - x


@jax.jit
def inclusive_scan(x):
    return jnp.cumsum(x)


exclusive_scan = prefix_sum
