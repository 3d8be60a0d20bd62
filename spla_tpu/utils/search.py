"""Vectorized row-windowed binary search.

Used by masked SpGEMM-T (sorted-row intersection, reference
``src/cpu/cpu_mxmT_masked.hpp:88-125``) and column extraction
(``src/cpu/cpu_m_extract_column.hpp``): for each query q with a row window
[lo_q, hi_q) into a flat sorted-per-row column array, find the position of
``key_q`` if present.  Fixed 32-step binary search — fully vectorized,
static control flow (XLA-friendly).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

__all__ = ["rowwise_find"]


def rowwise_find(flat_sorted, lo, hi, keys, steps: int = 32):
    """For each query: search ``flat_sorted[lo:hi]`` (sorted asc) for key.

    Returns ``(pos, found)`` where pos is the index into ``flat_sorted`` of
    the match (undefined when not found).  ``steps`` (static) bounds the
    bisection: ``ceil(log2(max window + 1))`` suffices — each step is a
    full-width gather, so callers that know the max row degree should
    pass a tight bound (32 covers any int32 window).
    """
    lo = lo.astype(jnp.int32)
    hi = hi.astype(jnp.int32)

    def body(_, state):
        l, h = state
        mid = (l + h) // 2
        mid_c = jnp.clip(mid, 0, flat_sorted.shape[0] - 1)
        v = flat_sorted[mid_c]
        go_right = v < keys
        l = jnp.where(go_right, mid + 1, l)
        h = jnp.where(go_right, h, mid)
        return (l, h)

    l, _ = lax.fori_loop(0, steps, body, (lo, hi))
    pos = jnp.clip(l, 0, flat_sorted.shape[0] - 1)
    found = (l < hi) & (flat_sorted[pos] == keys)
    return pos, found


def bisect_steps(max_window: int) -> int:
    """Static step count covering windows up to ``max_window``."""
    s = 1
    while (1 << s) <= max_window:
        s += 1
    return s
