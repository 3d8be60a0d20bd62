"""Graph algorithms built purely from the library's own primitives.

JAX redesign of the reference algorithms layer
(``src/algorithm.cpp``): BFS (:45-120), SSSP (:158-229), PageRank
(:278-335), triangle counting (:380-414), plus the naive sequential
oracles (:122-152, :231-272, :337-374, :416-448) used for validation.

Key difference: the reference reads a frontier-count scalar back to
the host every iteration (``src/algorithm.cpp:112`` — a device→host sync
per level); here each loop is a single ``jax.lax.while_loop`` whose
convergence scalar stays on device, so a full BFS/SSSP/PageRank run is
ONE XLA program with zero host round-trips.

Traversal direction: the reference picks push (sparse frontier × matrix)
vs pull (matrix × dense vector) by frontier density
(``src/algorithm.cpp:93-100``).  Here every level evaluates the same
static-shape masked SpMV over all stored entries, with frontier sparsity
expressed through the validity mask; the descriptor's push/pull modes
and ``front_factor`` are accepted for API parity and change nothing.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from . import op as OP
from .containers import CsrMatrix, DenseVec
from .descriptor import Descriptor
from .formats import WeakIdCache, csr_transpose_host

_TC_PATTERN_CACHE = WeakIdCache()  # is-0/1-pattern verdicts, keyed on values
_AT_CACHE = WeakIdCache()  # default A^T per matrix (bfs/sssp pull kernels)
from .ops.spmv import masked_spmv, masked_spmv_structural


def _default_At(A: CsrMatrix) -> CsrMatrix:
    """A^T for the pull traversal kernels when the caller gave none.

    The reference traverses by PUSH over A's rows (vxm:
    ``r[j] = or/min_i f[i] (x) A[i,j]``, ``src/algorithm.cpp:97``); the
    pull kernels here compute ``mxv(At, f)``, which matches only when
    ``At = A^T``.  Directed graphs therefore need the transpose — an
    ``At=A`` default silently walks REVERSED edges on any non-symmetric
    matrix.  Cached per matrix.  Symmetric matrices (the benchmark
    graphs) return A itself, so no second copy is kept; callers that
    already know A is symmetric should pass ``At=A`` explicitly and skip
    this check.
    """
    hit = _AT_CACHE.get(A.values)
    if hit is not None:
        return hit
    T = csr_transpose_host(A)
    # T is canonical A^T; transposing again gives canonical A, so the
    # comparison is order-insensitive even when A's cols are unsorted.
    T2 = csr_transpose_host(T)
    if (np.array_equal(np.asarray(T2.indptr), np.asarray(T.indptr))
            and np.array_equal(np.asarray(T2.cols), np.asarray(T.cols))
            and np.array_equal(np.asarray(T2.values), np.asarray(T.values))):
        T = A
    _AT_CACHE.put(A.values, T)
    return T


__all__ = [
    "bfs",
    "sssp",
    "pr",
    "tc",
    "bfs_naive",
    "sssp_naive",
    "pr_naive",
    "tc_naive",
]


# ---------------------------------------------------------------------------
# BFS
# ---------------------------------------------------------------------------


@jax.jit
def _bfs_kernel(At: CsrMatrix, source):
    """v[i] = depth (1-based) of i from source; 0 = unreachable.

    Structure-only traversal (the reference BFS sets struct_only +
    early_exit and uses the BAND/BOR semiring over {0,1} values —
    ``src/algorithm.cpp:88-100``): frontier' = (A^T @ front != 0) & (v == 0).
    """
    n = At.shape[0]
    v0 = jnp.zeros((n,), jnp.int32)
    front0 = jnp.zeros((n,), jnp.bool_).at[source].set(True)

    def cond(state):
        _, _, _, count = state
        return count > 0

    def body(state):
        v, front, depth, _ = state
        v = jnp.where(front, depth, v)
        front_new = masked_spmv_structural(At, front, v == 0)
        return (v, front_new, depth + 1, jnp.sum(front_new).astype(jnp.int32))

    v, front, depth, count = lax.while_loop(
        cond, body, (v0, front0, jnp.int32(1), jnp.int32(1))
    )
    return v


def bfs(A: CsrMatrix, source: int, descriptor: Descriptor | None = None,
        At: CsrMatrix | None = None) -> DenseVec:
    """Reference signature: ``bfs(v, A, s, desc)`` — returns depth vector.

    ``At`` is the CSR of A^T, the orientation the pull kernels traverse;
    it defaults to a cached transpose of A (returned as A itself when A
    is symmetric — pass ``At=A`` explicitly for known-undirected graphs
    to skip the one-time symmetry check).  All traversal modes produce
    identical depths; the loop runs fully on device.
    """
    if At is None:
        At = _default_At(A)
    v = _bfs_kernel(At, jnp.asarray(source, jnp.int32))
    return DenseVec(v, jnp.int32(0))


def bfs_naive(adj: list, source: int) -> np.ndarray:
    """Sequential queue BFS oracle (reference ``src/algorithm.cpp:122-152``)."""
    from collections import deque

    n = len(adj)
    v = np.zeros(n, np.int32)
    visited = np.zeros(n, bool)
    q = deque([source])
    visited[source] = True
    v[source] = 1
    while q:
        i = q.popleft()
        for j in adj[i]:
            if not visited[j]:
                visited[j] = True
                v[j] = v[i] + 1
                q.append(j)
    return v


# ---------------------------------------------------------------------------
# SSSP
# ---------------------------------------------------------------------------


@jax.jit
def _sssp_kernel(At: CsrMatrix, source):
    """Min-plus relaxation with feedback vector (reference
    ``src/algorithm.cpp:158-229``): frontier = feedback x(PLUS,MIN) A;
    v' = min(v, frontier); feedback = changed entries; loop until empty."""
    n = At.shape[0]
    inf = jnp.float32(jnp.inf)
    v0 = jnp.full((n,), inf, jnp.float32).at[source].set(0.0)
    fdb_vals0 = v0
    fdb_valid0 = jnp.zeros((n,), jnp.bool_).at[source].set(True)

    def cond(state):
        return state[3] > 0

    def body(state):
        v, fdb_vals, fdb_valid, _ = state
        frontier, _ = masked_spmv(
            At,
            fdb_vals,
            lambda a, x: x + a,  # mul = PLUS (v[i] + w(i,j))
            OP.MIN_FLOAT,
            inf,
            x_valid=fdb_valid,
        )
        new_v = jnp.minimum(v, frontier)
        changed = new_v != v
        return (new_v, new_v, changed, jnp.sum(changed).astype(jnp.int32))

    v, _, _, _ = lax.while_loop(cond, body, (v0, fdb_vals0, fdb_valid0, jnp.int32(1)))
    return v


def sssp(A: CsrMatrix, source: int, descriptor: Descriptor | None = None,
         At: CsrMatrix | None = None) -> DenseVec:
    """Single-source shortest paths; fill/unreachable = +inf (reference
    sets fill_value=inf, ``src/algorithm.cpp:176-178``).

    ``At`` = CSR of A^T (see :func:`bfs`); defaults to a cached
    transpose so directed graphs relax along A's edges, not against
    them."""
    if At is None:
        At = _default_At(A)
    v = _sssp_kernel(At, jnp.asarray(source, jnp.int32))
    return DenseVec(v, jnp.float32(jnp.inf))


def sssp_naive(adj: list, w: list, source: int) -> np.ndarray:
    """SPFA/Bellman-Ford queue oracle (reference ``src/algorithm.cpp:231-272``)."""
    from collections import deque

    n = len(adj)
    dist = np.full(n, np.inf, np.float32)
    dist[source] = 0.0
    inq = np.zeros(n, bool)
    q = deque([source])
    inq[source] = True
    while q:
        i = q.popleft()
        inq[i] = False
        for j, wx in zip(adj[i], w[i]):
            nd = np.float32(dist[i] + wx)
            if nd < dist[j]:
                dist[j] = nd
                if not inq[j]:
                    q.append(j)
                    inq[j] = True
    return dist


# ---------------------------------------------------------------------------
# PageRank
# ---------------------------------------------------------------------------


@jax.jit
def _pr_kernel(A: CsrMatrix, alpha, eps):
    """p = A·p_prev + (1-alpha)/N until ||p - p_prev||_2 < eps (reference
    ``src/algorithm.cpp:278-335``).  A is expected pre-scaled by the
    caller; note the REFERENCE example scales by the row's own out-degree
    (A[i,j] = alpha/outdeg(i), ``examples/pr.cpp:87``) whereas classic
    PageRank uses the source column's (alpha/outdeg(j)) — this kernel is
    convention-agnostic, pick the scaling when building A."""
    n = A.shape[0]
    addition = (1.0 - alpha) / n
    p0 = jnp.full((n,), 1.0 / n, jnp.float32)

    def cond(state):
        # iteration cap: f32 error can plateau above a tiny eps forever
        return (state[1] > eps) & (state[2] < 10_000)

    def body(state):
        p_prev, _, it = state
        ap, _ = masked_spmv(A, p_prev, OP.MULT_FLOAT, OP.PLUS_FLOAT, jnp.float32(0))
        p = ap + addition
        err = jnp.sqrt(jnp.sum((p - p_prev) ** 2))
        return (p, err, it + 1)

    p, err, _ = lax.while_loop(cond, body, (p0, jnp.float32(eps) + 0.1, jnp.int32(0)))
    return p


def pr(A: CsrMatrix, alpha: float = 0.85, eps: float = 1e-6,
       descriptor: Descriptor | None = None) -> DenseVec:
    p = _pr_kernel(A, jnp.float32(alpha), jnp.float32(eps))
    return DenseVec(p, jnp.float32(0))


def pr_naive(adj_in: list, w_in: list, alpha: float, eps: float) -> np.ndarray:
    """Dense-loop oracle (reference ``src/algorithm.cpp:337-374``):
    adj_in[i] lists in-neighbours k with weight w_in[i][k]."""
    n = len(adj_in)
    p_prev = np.full(n, 1.0 / n, np.float32)
    p = np.zeros(n, np.float32)
    err = eps + 0.1
    while err > eps:
        for i in range(n):
            p[i] = sum(
                wx * p_prev[k] for k, wx in zip(adj_in[i], w_in[i])
            ) + (1.0 - alpha) / n
        err = float(np.sqrt(((p - p_prev) ** 2).sum()))
        p, p_prev = p_prev, p
    return p_prev


# ---------------------------------------------------------------------------
# Triangle counting
# ---------------------------------------------------------------------------


def tc(A: CsrMatrix, products_cap: int | None = None) -> int:
    """B = (A·A^T) ⊙ A via mxmT_masked(MULT, PLUS, GTZERO), then
    m_reduce(PLUS) (reference ``src/algorithm.cpp:380-414``).  For the
    full symmetric adjacency this counts each triangle 6 times, matching
    the reference convention.

    The struct_only fast path (values treated as 1, GTZERO select skipped)
    is only taken when A is verifiably a 0/1 pattern — otherwise explicit
    zeros / non-unit entries must go through the value path to match the
    reference semantics."""
    from .ops.spgemm import mxmT_masked
    from .ops.matrix import m_reduce

    is_pattern = _TC_PATTERN_CACHE.get(A.values, ("pat",))
    if is_pattern is None:
        is_pattern = bool(
            np.asarray(jnp.all(jnp.where(A.valid_mask(), A.values, 1) == 1))
        )
        _TC_PATTERN_CACHE.put(A.values, is_pattern, ("pat",))
    B = mxmT_masked(
        A, A, A, OP.MULT_INT, OP.PLUS_INT, OP.GTZERO_INT, 0,
        products_cap=products_cap, struct_only=is_pattern,
    )
    return int(np.asarray(m_reduce(0, B, OP.PLUS_INT).value))


def tc_naive(adj: list) -> int:
    """Sorted-intersection oracle (reference ``src/algorithm.cpp:416-448``)."""
    count = 0
    for row in adj:
        for nb in row:
            a = row
            b = adj[nb]
            i = j = 0
            while i < len(a) and j < len(b):
                if a[i] == b[j]:
                    count += 1
                    i += 1
                    j += 1
                elif a[i] < b[j]:
                    i += 1
                else:
                    j += 1
    return count
