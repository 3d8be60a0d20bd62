"""Immutable pytree containers: Scalar, DenseVec, SparseVec, CooMatrix, CsrMatrix.

JAX replacement for the reference's mutable multi-format storage
engine (reference: ``src/core/tdecoration.hpp``, ``src/storage/
storage_manager.hpp:128-204`` and the format structs in
``src/cpu/cpu_formats.hpp:54-120``).  The reference keeps several live
representations per container and runs a BFS over a conversion graph;
here every container is a frozen pytree of (possibly sharded)
``jax.Array`` s and format conversion is a pure function (see
:mod:`spla_tpu.formats`).

Static-shape convention (XLA requires static shapes):

* every sparse container has a static ``capacity`` (array length) plus a
  traced 0-d ``nnz`` count;
* index arrays at positions ``>= nnz`` are *padding*: row/vector indices
  are guaranteed to equal the dimension size (``m`` resp. ``n`` — a
  "dump slot" one past the end, so scatters with an ``m+1``-sized target
  are self-masking and sorts keep padding last); column values of padding
  are unspecified but within ``[0, n]`` (gathers clamp);
* ``fill`` is the GraphBLAS fill value (identity), an explicit 0-d array —
  it is *not* always 0 (e.g. SSSP uses +inf, reference
  ``src/algorithm.cpp:176-178``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp

from .types import Type, type_from_dtype

__all__ = [
    "Scalar",
    "DenseVec",
    "SparseVec",
    "CooMatrix",
    "CsrMatrix",
    "BsrMatrix",
]


def _register(cls, data_fields, meta_fields):
    jax.tree_util.register_dataclass(cls, data_fields=data_fields, meta_fields=meta_fields)
    return cls


@dataclass(frozen=True)
class Scalar:
    """Typed 0-d value (reference ``include/spla/scalar.hpp``)."""

    value: jax.Array

    @staticmethod
    def of(v, dtype=None) -> "Scalar":
        return Scalar(jnp.asarray(v, dtype=dtype))

    @property
    def dtype(self):
        return self.value.dtype

    @property
    def type(self) -> Type:
        return type_from_dtype(self.dtype)

    def item(self):
        return np.asarray(self.value)[()]


_register(Scalar, ["value"], [])


@dataclass(frozen=True)
class DenseVec:
    """Dense n-vector with explicit fill value.

    Reference analog: ``CpuDenseVec`` (``src/cpu/cpu_formats.hpp``).
    "Stored" entries of a dense vector are those ``!= fill`` — matching the
    reference's dense→sparse conversion and ``v_count_mf`` dense path
    (``src/cpu/cpu_v_count_mf.hpp`` execute_dense).
    """

    values: jax.Array  # [n]
    fill: jax.Array  # 0-d

    @property
    def n(self) -> int:
        return self.values.shape[0]

    @property
    def dtype(self):
        return self.values.dtype

    @staticmethod
    def full(n: int, fill, dtype=None) -> "DenseVec":
        fill = jnp.asarray(fill, dtype=dtype)
        return DenseVec(jnp.full((n,), fill, dtype=fill.dtype), fill)

    def stored_mask(self) -> jax.Array:
        return self.values != self.fill


_register(DenseVec, ["values", "fill"], [])


@dataclass(frozen=True)
class SparseVec:
    """Sorted-COO sparse n-vector (reference ``CpuCooVec``).

    ``indices`` sorted ascending; padding positions hold index ``n``.
    """

    n: int  # static
    indices: jax.Array  # [cap] int32
    values: jax.Array  # [cap]
    nnz: jax.Array  # 0-d int32
    fill: jax.Array  # 0-d

    @property
    def capacity(self) -> int:
        return self.indices.shape[0]

    @property
    def dtype(self):
        return self.values.dtype

    def valid_mask(self) -> jax.Array:
        return jnp.arange(self.capacity, dtype=jnp.int32) < self.nnz

    @staticmethod
    def empty(n: int, capacity: int, fill, dtype=None) -> "SparseVec":
        fill = jnp.asarray(fill, dtype=dtype)
        return SparseVec(
            n=n,
            indices=jnp.full((capacity,), n, dtype=jnp.int32),
            values=jnp.full((capacity,), fill, dtype=fill.dtype),
            nnz=jnp.zeros((), jnp.int32),
            fill=fill,
        )


_register(SparseVec, ["indices", "values", "nnz", "fill"], ["n"])


@dataclass(frozen=True)
class CooMatrix:
    """COO matrix sorted row-major (reference ``CpuCoo``); pad rows = m."""

    shape: tuple  # static (m, n)
    rows: jax.Array  # [cap] int32
    cols: jax.Array  # [cap] int32
    values: jax.Array  # [cap]
    nnz: jax.Array  # 0-d int32
    fill: jax.Array  # 0-d

    @property
    def capacity(self) -> int:
        return self.rows.shape[0]

    @property
    def dtype(self):
        return self.values.dtype

    def valid_mask(self) -> jax.Array:
        return jnp.arange(self.capacity, dtype=jnp.int32) < self.nnz


_register(CooMatrix, ["rows", "cols", "values", "nnz", "fill"], ["shape"])


@dataclass(frozen=True)
class CsrMatrix:
    """CSR matrix (reference ``CpuCsr`` Ap/Aj/Ax) + precomputed COO row ids.

    ``row_ids`` is the expansion of ``indptr`` into per-entry row indices
    (pad = m); it feeds XLA segment/scatter ops directly.
    """

    shape: tuple  # static (m, n)
    indptr: jax.Array  # [m+1] int32
    cols: jax.Array  # [cap] int32
    values: jax.Array  # [cap]
    row_ids: jax.Array  # [cap] int32
    nnz: jax.Array  # 0-d int32
    fill: jax.Array  # 0-d

    @property
    def capacity(self) -> int:
        return self.cols.shape[0]

    @property
    def dtype(self):
        return self.values.dtype

    def valid_mask(self) -> jax.Array:
        return jnp.arange(self.capacity, dtype=jnp.int32) < self.nnz


_register(CsrMatrix, ["indptr", "cols", "values", "row_ids", "nnz", "fill"], ["shape"])


@dataclass(frozen=True)
class BsrMatrix:
    """Block-sparse (BSR) matrix of dense ``bs x bs`` tiles.

    Dense tiles let block SpMV / SpMM run as batched dense matmuls.  No
    reference
    analog (the reference's AccCsc/AccCoo formats were declared but
    unimplemented — ``include/spla/config.hpp:102-121``).
    """

    shape: tuple  # static (m, n) in elements
    block: int  # static block edge
    indptr: jax.Array  # [mb+1] int32 block-row pointers
    cols: jax.Array  # [bcap] int32 block-col ids
    blocks: jax.Array  # [bcap, block, block]
    row_ids: jax.Array  # [bcap] int32 block-row ids, pad = mb
    nnzb: jax.Array  # 0-d int32
    fill: jax.Array  # 0-d

    @property
    def block_shape(self) -> tuple:
        bs = self.block
        return ((self.shape[0] + bs - 1) // bs, (self.shape[1] + bs - 1) // bs)

    @property
    def capacity(self) -> int:
        return self.cols.shape[0]

    @property
    def dtype(self):
        return self.blocks.dtype


_register(
    BsrMatrix,
    ["indptr", "cols", "blocks", "row_ids", "nnzb", "fill"],
    ["shape", "block"],
)
