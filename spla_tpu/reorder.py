"""Host-side vertex relabeling for load balance.

Deals vertices heavy-first round-robin across the shards of the 1-D
block-row partition (``parallel/dist_matrix.py``), so every shard
receives an equal share of the stored entries on skewed graphs while
the uniform-partition invariant holds.

Reference role: the storage/format-conversion layer — choosing the
representation that makes the kernel fast (reference
``src/storage/storage_manager_matrix.hpp:54-158``); the reference itself
has no relabeling pass.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "relabel_degree_sorted",
]


def relabel_degree_sorted(rows, cols, m, n_shards: int, mloc: int):
    """Row permutation equalizing per-shard nnz for the 1-D block-row
    partition (``parallel/dist_matrix.py``): deal rows heavy-first
    round-robin across shards of ``mloc`` rows each.

    Returns ``(old_of_new, new_of_old)``."""
    deg = np.bincount(np.asarray(rows), minlength=m)
    order = np.argsort(-deg.astype(np.int64), kind="stable")
    # k-th heaviest row -> shard k % n_shards, local slot k // n_shards;
    # generate over the padded shard space, then drop slots >= m (a
    # bijection of the padded space restricted to live ids stays a
    # bijection)
    k = np.arange(n_shards * mloc, dtype=np.int64)
    tid = (k % n_shards) * mloc + k // n_shards
    tid = tid[tid < m]
    assert tid.size == m
    old_of_new = np.empty(m, np.int32)
    old_of_new[tid] = order
    new_of_old = np.empty(m, np.int32)
    new_of_old[order] = tid
    return old_of_new, new_of_old
