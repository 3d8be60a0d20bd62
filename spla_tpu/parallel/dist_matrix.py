"""Block-row sharded CSR matrix.

Partitioning scheme: uniform contiguous row blocks of ``mloc =
ceil(m / P)`` rows per shard.  With a contiguous uniform partition the
padded-global index of vertex ``i`` equals ``i`` itself, so an
``all_gather`` of the per-shard dense vectors yields an array that local
column indices index directly — no index remapping on the hot path.
Load balance for skewed graphs is addressed by host-side vertex
relabeling (degree-sorted), which preserves the uniform-partition
invariant.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ..containers import CsrMatrix

__all__ = [
    "ShardedCsr",
    "shard_csr_by_rows",
    "shard_csr_by_rows_balanced",
    "shard_vector_by_rows",
]


@dataclass(frozen=True)
class ShardedCsr:
    """Per-shard CSR blocks stacked on a leading shard axis.

    Row ids are shard-local (pad = mloc, the local dump row); column ids
    stay global.  ``shape``/``n_shards``/``mloc`` are static.
    """

    shape: tuple  # static global (m, n)
    n_shards: int  # static
    mloc: int  # static rows per shard
    indptr: jax.Array  # [S, mloc+1]
    cols: jax.Array  # [S, cap]
    values: jax.Array  # [S, cap]
    row_ids: jax.Array  # [S, cap] local, pad = mloc
    nnz: jax.Array  # [S]
    fill: jax.Array  # 0-d

    @property
    def capacity(self) -> int:
        return self.cols.shape[1]

    def local_block(self, s_indptr, s_cols, s_values, s_row_ids, s_nnz) -> CsrMatrix:
        """Assemble the local shard's CsrMatrix inside shard_map (arrays
        arrive with the shard axis stripped)."""
        padded_n = self.n_shards * self.mloc
        return CsrMatrix(
            shape=(self.mloc, padded_n),
            indptr=s_indptr,
            cols=s_cols,
            values=s_values,
            row_ids=s_row_ids,
            nnz=s_nnz,
            fill=self.fill,
        )


jax.tree_util.register_dataclass(
    ShardedCsr,
    data_fields=["indptr", "cols", "values", "row_ids", "nnz", "fill"],
    meta_fields=["shape", "n_shards", "mloc"],
)


def shard_csr_by_rows(
    a: CsrMatrix, n_shards: int, mesh: Mesh | None = None, axis: str = "d"
) -> ShardedCsr:
    """Host-side partitioner: uniform contiguous row blocks, per-shard
    arrays padded to the max shard nnz (shard_map needs equal shapes)."""
    m, n = a.shape
    mloc = (m + n_shards - 1) // n_shards
    indptr = np.asarray(a.indptr).astype(np.int64)
    cols = np.asarray(a.cols)
    vals = np.asarray(a.values)
    nnz_total = int(np.asarray(a.nnz))

    starts = [min(s * mloc, m) for s in range(n_shards + 1)]
    shard_nnz = [int(indptr[starts[s + 1]] - indptr[starts[s]]) for s in range(n_shards)]
    cap = max(max(shard_nnz), 1)

    S_indptr = np.zeros((n_shards, mloc + 1), np.int32)
    S_cols = np.zeros((n_shards, cap), np.int32)
    S_vals = np.full((n_shards, cap), np.asarray(a.fill), vals.dtype)
    S_rows = np.full((n_shards, cap), mloc, np.int32)
    S_nnz = np.zeros((n_shards,), np.int32)

    for s in range(n_shards):
        r0, r1 = starts[s], starts[s + 1]
        e0, e1 = int(indptr[r0]), int(indptr[r1])
        k = e1 - e0
        local_ptr = (indptr[r0 : r1 + 1] - e0).astype(np.int32)
        S_indptr[s, : r1 - r0 + 1] = local_ptr
        S_indptr[s, r1 - r0 + 1 :] = local_ptr[-1]  # padded empty rows
        S_cols[s, :k] = cols[e0:e1]
        S_vals[s, :k] = vals[e0:e1]
        # local row ids
        S_rows[s, :k] = (
            np.repeat(np.arange(r1 - r0, dtype=np.int32), np.diff(local_ptr))
        )
        S_nnz[s] = k

    out = ShardedCsr(
        shape=(m, n),
        n_shards=n_shards,
        mloc=mloc,
        indptr=jnp.asarray(S_indptr),
        cols=jnp.asarray(S_cols),
        values=jnp.asarray(S_vals),
        row_ids=jnp.asarray(S_rows),
        nnz=jnp.asarray(S_nnz),
        fill=jnp.asarray(np.asarray(a.fill)),
    )
    if mesh is not None:
        out = _device_put_sharded(out, mesh, axis)
    return out


def shard_csr_by_rows_balanced(
    a: CsrMatrix, n_shards: int, mesh: Mesh | None = None, axis: str = "d"
):
    """Degree-balanced sharding for skewed square graphs: relabel
    vertices by the heavy-first shard dealing (``spla_tpu.reorder.
    relabel_degree_sorted``) so every shard receives an equal share of
    the edge mass, then block-row shard under the new labels.

    The SAME permutation applies to rows and columns (vertex identity),
    preserving traversal semantics.  Returns ``(sharded, old_of_new,
    new_of_old)``; translate sources with ``new_of_old[src]`` and read
    results back with ``v_old[i] = v_new_flat[new_of_old[i]]``."""
    import numpy as np

    from ..formats import csr_from_entries, host_coo
    from ..reorder import relabel_degree_sorted

    m, n = a.shape
    assert m == n, "balanced sharding relabels vertices: square graphs only"
    rows, cols, vals = host_coo(a)
    mloc = (m + n_shards - 1) // n_shards
    old_of_new, new_of_old = relabel_degree_sorted(rows, cols, m, n_shards,
                                                   mloc)
    ap = csr_from_entries(
        (m, n), new_of_old[rows], new_of_old[cols], vals,
        fill=np.asarray(a.fill), dtype=np.asarray(vals).dtype,
    )
    return (
        shard_csr_by_rows(ap, n_shards, mesh, axis),
        old_of_new,
        new_of_old,
    )


def _device_put_sharded(sc: ShardedCsr, mesh: Mesh, axis: str) -> ShardedCsr:
    shard = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())
    return ShardedCsr(
        shape=sc.shape,
        n_shards=sc.n_shards,
        mloc=sc.mloc,
        indptr=jax.device_put(sc.indptr, shard),
        cols=jax.device_put(sc.cols, shard),
        values=jax.device_put(sc.values, shard),
        row_ids=jax.device_put(sc.row_ids, shard),
        nnz=jax.device_put(sc.nnz, shard),
        fill=jax.device_put(sc.fill, repl),
    )


def shard_csr_split_diag(
    a: CsrMatrix, n_shards: int, mesh: Mesh | None = None, axis: str = "d"
):
    """Diagonal/off-diagonal split sharding for comm/compute overlap.

    Per shard s, the DIAGONAL block holds entries with columns in
    [s*mloc, (s+1)*mloc) re-based to local ids — its SpMV needs only the
    shard's own x, NO communication; the OFF-DIAGONAL block keeps global
    (padded) column ids and consumes the all-gathered x.  A step that
    computes ``diag @ x_local`` while the gather for ``off @ x_full`` is
    in flight lets XLA's latency-hiding scheduler overlap the collective
    with compute (the north-star "halo exchange overlapped
    with compute"; SURVEY §2.8).

    Returns ``(diag, off)`` ShardedCsr; diag.shape[1] == mloc (local)."""
    import numpy as np

    from ..formats import host_coo

    m, n = a.shape
    mloc = (m + n_shards - 1) // n_shards
    rows, cols, vals = host_coo(a)
    shard_of_row = np.minimum(rows // mloc, n_shards - 1)
    is_diag = (cols // mloc) == shard_of_row
    fill = np.asarray(a.fill)

    def build(sel, local_cols):
        from ..formats import csr_from_entries

        r, c, v = rows[sel], cols[sel], vals[sel]
        if local_cols:
            c = c - (np.minimum(r // mloc, n_shards - 1) * mloc)
        mat = csr_from_entries(
            (m, mloc if local_cols else n), r, c, v, fill=fill,
            dtype=vals.dtype,
        )
        return shard_csr_by_rows(mat, n_shards, mesh, axis)

    return build(is_diag, True), build(~is_diag, False)


def shard_vector_by_rows(
    x: np.ndarray, n_shards: int, mloc: int, mesh: Mesh | None = None, axis: str = "d"
):
    """Pad a global dense vector to [S, mloc] row shards."""
    x = np.asarray(x)
    padded = np.zeros((n_shards * mloc,), x.dtype)
    padded[: x.shape[0]] = x
    out = jnp.asarray(padded.reshape(n_shards, mloc))
    if mesh is not None:
        out = jax.device_put(out, NamedSharding(mesh, P(axis)))
    return out
