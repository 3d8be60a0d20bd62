"""Format builders and pure conversion functions.

Replaces the reference's StorageManager conversion graph
(``src/storage/storage_manager.hpp:128-204``, matrix/vector registrations in
``storage_manager_matrix.hpp:51-160`` / ``storage_manager_vector.hpp:51-172``)
with explicit pure functions: host-side numpy builders for construction
(with duplicate-reduce semantics, reference ``src/core/tvector.hpp:145-156``)
and jit-friendly device-side converters.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .containers import BsrMatrix, CooMatrix, CsrMatrix, DenseVec, SparseVec

__all__ = [
    "sparse_vec_from_entries",
    "dense_vec_from_entries",
    "csr_from_entries",
    "coo_from_entries",
    "csr_from_scipy",
    "csr_to_coo",
    "coo_to_csr",
    "dense_to_sparse_vec",
    "sparse_to_dense_vec",
    "csr_transpose_host",
    "csr_to_dense",
    "coo_to_dense",
    "bsr_from_csr_host",
    "round_up",
]


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# Host-side copies of device CSR arrays, keyed weakly by the device values
# array.  Host-side preprocessing (transposes, symbolic SpGEMM sizing,
# sharding) reads the whole matrix on host; without this cache it would
# pull it back from the device each time.  Populated automatically by
# the host-side builders.
import weakref

_HOST_ARRAYS: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()
_HOST_DATA: dict = {}


def _evict_host_data(key):
    # skip if a live object has since recycled the id (its entries
    # overwrote the dead object's under the same key)
    if _HOST_ARRAYS.get(key) is None:
        _HOST_DATA.pop(key, None)


def register_host_arrays(values_dev, rows, cols, vals) -> None:
    """Remember the numpy (rows, cols, vals) that produced a device CSR."""
    key = id(values_dev)
    _HOST_DATA[key] = (rows, cols, vals)
    try:
        _HOST_ARRAYS[key] = values_dev  # keeps key valid only while alive
        weakref.finalize(values_dev, _evict_host_data, key)
    except TypeError:  # pragma: no cover - object not weakref-able
        pass


def lookup_host_arrays(values_dev):
    key = id(values_dev)
    if key in _HOST_ARRAYS and _HOST_ARRAYS.get(key) is values_dev:
        return _HOST_DATA.get(key)
    _HOST_DATA.pop(key, None)
    return None


def host_coo(A, nnz=None, pattern=False):
    """Host (rows, cols, vals) of a CsrMatrix, via the registered host
    copies when available (avoids a device->host transfer).  With
    ``pattern=True`` values are all-ones f32."""
    if nnz is None:
        nnz = int(np.asarray(A.nnz))
    cached = lookup_host_arrays(A.values)
    if cached is not None:
        rows, cols, vals = (np.asarray(a[:nnz]) for a in cached)
    else:
        rows = np.asarray(A.row_ids)[:nnz]
        cols = np.asarray(A.cols)[:nnz]
        vals = np.asarray(A.values)[:nnz]
    if pattern:
        vals = np.ones(nnz, np.float32)
    return rows, cols, vals


class WeakIdCache:
    """id-keyed cache whose entries die with the key object (a plain
    id-keyed dict would silently alias recycled ids after GC)."""

    def __init__(self):
        self._alive = weakref.WeakValueDictionary()
        self._data = {}

    def _gc(self, oid):
        # fired by weakref.finalize when the key object dies; skip if a
        # live object has since recycled the id (its puts overwrote the
        # dead entries under the same keys)
        if self._alive.get(oid) is None:
            for k in [k for k in self._data if k[0] == oid]:
                self._data.pop(k, None)

    def get(self, obj, extra=()):
        key = (id(obj), *extra)
        if self._alive.get(id(obj)) is not obj:
            self._data.pop(key, None)
            return None
        return self._data.get(key)

    def contains(self, obj, extra=()):
        key = (id(obj), *extra)
        return self._alive.get(id(obj)) is obj and key in self._data

    def put(self, obj, value, extra=()):
        key = (id(obj), *extra)
        try:
            if self._alive.get(id(obj)) is not obj:
                self._alive[id(obj)] = obj
                weakref.finalize(obj, self._gc, id(obj))
        except TypeError:  # pragma: no cover - non-weakref-able
            pass
        self._data[key] = value


# ---------------------------------------------------------------------------
# Host-side builders (numpy): construction path with duplicate-reduce.
# ---------------------------------------------------------------------------


def _dedup_host(keys: np.ndarray, values: np.ndarray, reduce_fn):
    """Sort by key and combine duplicates left-to-right with reduce_fn.

    Matches the reference build semantics where later duplicates are folded
    into the stored value via the container's reduce op
    (``src/core/tvector.hpp:145-156``; default = keep last).
    """
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    values = values[order]
    if keys.size == 0:
        return keys, values
    heads = np.empty(keys.size, dtype=bool)
    heads[0] = True
    heads[1:] = keys[1:] != keys[:-1]
    if reduce_fn is None:
        # keep last duplicate (reference default SECOND)
        last = np.nonzero(np.append(heads[1:], True))[0]
        return keys[heads], values[last]
    out_idx = np.cumsum(heads) - 1
    uk = keys[heads]
    uv = values[heads].copy()
    # left-to-right fold of duplicates (rare path, host-side loop over dups)
    dup_pos = np.nonzero(~heads)[0]
    for p in dup_pos:
        o = out_idx[p]
        uv[o] = reduce_fn(uv[o], values[p])
    return uk, uv


def sparse_vec_from_entries(
    n: int,
    indices,
    values,
    fill=0,
    dtype=None,
    reduce_fn=None,
    capacity: int | None = None,
) -> SparseVec:
    indices = np.asarray(indices, dtype=np.int64)
    fillv = np.asarray(fill, dtype=dtype)
    values = np.asarray(values, dtype=fillv.dtype)
    idx, val = _dedup_host(indices, values, reduce_fn)
    nnz = int(idx.size)
    cap = capacity if capacity is not None else max(nnz, 1)
    assert cap >= nnz
    pidx = np.full(cap, n, dtype=np.int32)
    pval = np.full(cap, fillv, dtype=fillv.dtype)
    pidx[:nnz] = idx
    pval[:nnz] = val
    return SparseVec(
        n=n,
        indices=jnp.asarray(pidx),
        values=jnp.asarray(pval),
        nnz=jnp.asarray(nnz, jnp.int32),
        fill=jnp.asarray(fillv),
    )


def dense_vec_from_entries(n, indices, values, fill=0, dtype=None, reduce_fn=None) -> DenseVec:
    sv = sparse_vec_from_entries(n, indices, values, fill, dtype, reduce_fn)
    return sparse_to_dense_vec(sv)


def _matrix_entries_host(shape, rows, cols, values, fill, dtype, reduce_fn):
    m, n = shape
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    fillv = np.asarray(fill, dtype=dtype)
    values = np.asarray(values, dtype=fillv.dtype)
    keys = rows * n + cols
    k, v = _dedup_host(keys, values, reduce_fn)
    return (k // n).astype(np.int32), (k % n).astype(np.int32), v, fillv


def coo_from_entries(
    shape, rows, cols, values, fill=0, dtype=None, reduce_fn=None, capacity=None
) -> CooMatrix:
    m, n = shape
    r, c, v, fillv = _matrix_entries_host(shape, rows, cols, values, fill, dtype, reduce_fn)
    nnz = int(r.size)
    cap = capacity if capacity is not None else max(nnz, 1)
    pr = np.full(cap, m, np.int32)
    pc = np.zeros(cap, np.int32)
    pv = np.full(cap, fillv, fillv.dtype)
    pr[:nnz], pc[:nnz], pv[:nnz] = r, c, v
    return CooMatrix(
        shape=(m, n),
        rows=jnp.asarray(pr),
        cols=jnp.asarray(pc),
        values=jnp.asarray(pv),
        nnz=jnp.asarray(nnz, jnp.int32),
        fill=jnp.asarray(fillv),
    )


def csr_from_entries(
    shape, rows, cols, values, fill=0, dtype=None, reduce_fn=None, capacity=None
) -> CsrMatrix:
    m, n = shape
    r, c, v, fillv = _matrix_entries_host(shape, rows, cols, values, fill, dtype, reduce_fn)
    return _csr_from_sorted_host((m, n), r, c, v, fillv, capacity)


def _csr_from_sorted_host(shape, r, c, v, fillv, capacity=None) -> CsrMatrix:
    m, n = shape
    nnz = int(r.size)
    cap = capacity if capacity is not None else max(nnz, 1)
    assert cap >= nnz
    indptr = np.zeros(m + 1, np.int64)
    np.add.at(indptr, r + 1, 1)
    indptr = np.cumsum(indptr)
    pc = np.zeros(cap, np.int32)
    pv = np.full(cap, fillv, fillv.dtype)
    pr = np.full(cap, m, np.int32)
    pc[:nnz], pv[:nnz], pr[:nnz] = c, v, r
    values_dev = jnp.asarray(pv)
    register_host_arrays(values_dev, pr[:nnz], pc[:nnz], pv[:nnz])
    return CsrMatrix(
        shape=(m, n),
        indptr=jnp.asarray(indptr.astype(np.int32)),
        cols=jnp.asarray(pc),
        values=values_dev,
        row_ids=jnp.asarray(pr),
        nnz=jnp.asarray(nnz, jnp.int32),
        fill=jnp.asarray(fillv),
    )


def csr_from_scipy(sp, fill=0, dtype=None, capacity=None) -> CsrMatrix:
    """Build from a scipy.sparse matrix (test/IO convenience)."""
    sp = sp.tocsr()
    sp.sort_indices()
    fillv = np.asarray(fill, dtype=dtype if dtype is not None else sp.dtype)
    coo = sp.tocoo()
    return _csr_from_sorted_host(
        sp.shape,
        coo.row.astype(np.int32),
        coo.col.astype(np.int32),
        coo.data.astype(fillv.dtype),
        fillv,
        capacity,
    )


def csr_transpose_host(a: CsrMatrix, capacity=None) -> CsrMatrix:
    """Host-side transpose used at build time (e.g. to precompute A^T for
    push traversal).  Device-side transpose lives in ops.matrix.m_transpose."""
    m, n = a.shape
    nnz = int(np.asarray(a.nnz))
    r = np.asarray(a.row_ids)[:nnz]
    c = np.asarray(a.cols)[:nnz]
    v = np.asarray(a.values)[:nnz]
    order = np.lexsort((r, c))
    return _csr_from_sorted_host(
        (n, m), c[order], r[order], v[order], np.asarray(a.fill), capacity
    )


# ---------------------------------------------------------------------------
# Device-side pure converters (jit-friendly, static capacities).
# ---------------------------------------------------------------------------


def sparse_to_dense_vec(sv: SparseVec) -> DenseVec:
    """SparseVec -> DenseVec (reference AccCoo->AccDense converter,
    ``storage_manager_vector.hpp:159-170``)."""
    base = jnp.full((sv.n + 1,), sv.fill, dtype=sv.values.dtype)
    vals = jnp.where(sv.valid_mask(), sv.values, sv.fill)
    # pad indices = n land in the dump slot
    dense = base.at[sv.indices].set(vals, mode="drop")[: sv.n]
    return DenseVec(dense, sv.fill)


def dense_to_sparse_vec(dv: DenseVec, capacity: int | None = None) -> SparseVec:
    """DenseVec -> SparseVec keeping entries != fill.

    ``capacity`` must be static; defaults to n (exact-but-max bound).
    """
    cap = capacity if capacity is not None else dv.n
    mask = dv.stored_mask()
    (idx,) = jnp.nonzero(mask, size=cap, fill_value=dv.n)
    vals = jnp.where(idx < dv.n, dv.values[jnp.clip(idx, 0, dv.n - 1)], dv.fill)
    nnz = jnp.minimum(jnp.sum(mask).astype(jnp.int32), jnp.int32(cap))
    return SparseVec(n=dv.n, indices=idx.astype(jnp.int32), values=vals, nnz=nnz, fill=dv.fill)


def csr_to_coo(a: CsrMatrix) -> CooMatrix:
    return CooMatrix(
        shape=a.shape,
        rows=a.row_ids,
        cols=a.cols,
        values=a.values,
        nnz=a.nnz,
        fill=a.fill,
    )


def coo_to_csr(a: CooMatrix) -> CsrMatrix:
    """COO (entries sorted row-major, pads last) -> CSR via searchsorted."""
    m, n = a.shape
    indptr = jnp.searchsorted(a.rows, jnp.arange(m + 1, dtype=jnp.int32), side="left")
    indptr = jnp.minimum(indptr.astype(jnp.int32), a.nnz)
    return CsrMatrix(
        shape=a.shape,
        indptr=indptr,
        cols=a.cols,
        values=a.values,
        row_ids=a.rows,
        nnz=a.nnz,
        fill=a.fill,
    )


def csr_to_dense(a: CsrMatrix) -> jax.Array:
    m, n = a.shape
    base = jnp.full((m + 1, n + 1), a.fill, dtype=a.values.dtype)
    vals = jnp.where(a.valid_mask(), a.values, a.fill)
    cols = jnp.where(a.valid_mask(), a.cols, n)
    dense = base.at[a.row_ids, cols].set(vals, mode="drop")
    return dense[:m, :n]


def coo_to_dense(a: CooMatrix) -> jax.Array:
    return csr_to_dense(coo_to_csr(a))


def bsr_from_csr_host(a: CsrMatrix, block: int = 128, capacity=None) -> BsrMatrix:
    """Host-side CSR -> BSR tiling (dense ``block x block`` tiles)."""
    m, n = a.shape
    mb = (m + block - 1) // block
    nb = (n + block - 1) // block
    nnz = int(np.asarray(a.nnz))
    r = np.asarray(a.row_ids)[:nnz].astype(np.int64)
    c = np.asarray(a.cols)[:nnz].astype(np.int64)
    v = np.asarray(a.values)[:nnz]
    br, bc = r // block, c // block
    bkey = br * nb + bc
    order = np.argsort(bkey, kind="stable")
    bkey_s = bkey[order]
    heads = np.empty(nnz, dtype=bool)
    if nnz:
        heads[0] = True
        heads[1:] = bkey_s[1:] != bkey_s[:-1]
    ukeys = bkey_s[heads] if nnz else np.zeros(0, np.int64)
    nnzb = int(ukeys.size)
    cap = capacity if capacity is not None else max(nnzb, 1)
    blocks = np.full((cap, block, block), np.asarray(a.fill), dtype=v.dtype)
    blk_of = (np.cumsum(heads) - 1) if nnz else np.zeros(0, np.int64)
    lr = (r[order] % block).astype(np.int64)
    lc = (c[order] % block).astype(np.int64)
    blocks[blk_of, lr, lc] = v[order]
    bcols = np.zeros(cap, np.int32)
    brows = np.full(cap, mb, np.int32)
    bcols[:nnzb] = (ukeys % nb).astype(np.int32)
    brows[:nnzb] = (ukeys // nb).astype(np.int32)
    indptr = np.zeros(mb + 1, np.int64)
    np.add.at(indptr, brows[:nnzb] + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    return BsrMatrix(
        shape=(m, n),
        block=block,
        indptr=jnp.asarray(indptr),
        cols=jnp.asarray(bcols),
        blocks=jnp.asarray(blocks),
        row_ids=jnp.asarray(brows),
        nnzb=jnp.asarray(nnzb, jnp.int32),
        fill=jnp.asarray(np.asarray(a.fill)),
    )
