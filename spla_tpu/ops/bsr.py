"""BSR (block-sparse row) compute paths — dense block tiles.

The reference declared but never implemented device block formats
(``include/spla/config.hpp:102-121`` AccCsc/AccCoo enum stubs); BSR
stores dense ``bs x bs`` tiles so block SpMV/SpMM run as batched dense
matmuls.  Best for matrices with block structure (banded / FEM-like);
for scattered graphs use the CSR ops (``spla_tpu.ops.spmv``).

Both block products pass ``precision=HIGHEST``: in float32 the default
precision may run in TF32 on the GPU's tensor cores, which keeps only
10 mantissa bits.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from jax import lax

from ..containers import BsrMatrix, DenseVec

__all__ = ["bsr_spmv", "bsr_spmm"]


def _block_valid(A: BsrMatrix):
    return jnp.arange(A.capacity, dtype=jnp.int32) < A.nnzb


def bsr_spmv(A: BsrMatrix, x, op_mul=None, op_add=None, init=0.0) -> jax.Array:
    """y = A @ x over (op_mul, PLUS) with dense block tiles (full float32
    precision).

    Block-level gather of x (bs-sized rows — coarse enough for efficient
    XLA gathers), one batched matvec over all stored blocks, block-row
    segment sum.  General elementwise ``op_mul`` is applied inside the
    block product only when given (default: MULT, which maps straight to
    ``dot``)."""
    add_name = getattr(op_add, "name", None)
    assert op_add is None or add_name == "PLUS", (
        f"bsr_spmv accumulates PLUS only (got {add_name}); general "
        "monoids go through the CSR ops (spla_tpu.ops.mxv_masked)"
    )
    if isinstance(x, DenseVec):
        x = x.values
    m, n = A.shape
    bs = A.block
    mb, nb = A.block_shape
    init = jnp.asarray(init, A.blocks.dtype)
    xp = jnp.pad(x, (0, nb * bs - n)).reshape(nb, bs)
    cols = jnp.clip(A.cols, 0, nb - 1)
    xb = xp[cols]  # [bcap, bs]
    if op_mul is None or getattr(op_mul, "name", None) == "MULT":
        prod = jnp.einsum(
            "ebc,ec->eb", A.blocks, xb,
            preferred_element_type=A.blocks.dtype,
            precision=lax.Precision.HIGHEST,
        )
    else:
        prod = jnp.sum(op_mul(A.blocks, xb[:, None, :]), axis=2)
    prod = jnp.where(_block_valid(A)[:, None], prod, 0)
    rows = jnp.where(_block_valid(A), A.row_ids, mb)
    y = jax.ops.segment_sum(prod, rows, num_segments=mb + 1)[:mb]
    return (y.reshape(-1)[:m] + init).astype(A.blocks.dtype)


def bsr_spmm(A: BsrMatrix, X) -> jax.Array:
    """Y = A @ X for dense X [n, k] — batched block matmuls in full
    float32 precision with a block-row segment sum."""
    m, n = A.shape
    bs = A.block
    mb, nb = A.block_shape
    k = X.shape[1]
    Xp = jnp.pad(X, ((0, nb * bs - n), (0, 0))).reshape(nb, bs, k)
    cols = jnp.clip(A.cols, 0, nb - 1)
    Xb = Xp[cols]  # [bcap, bs, k]
    prod = jnp.einsum(
        "ebc,eck->ebk", A.blocks, Xb, preferred_element_type=A.blocks.dtype,
        precision=lax.Precision.HIGHEST,
    )
    prod = jnp.where(_block_valid(A)[:, None, None], prod, 0)
    rows = jnp.where(_block_valid(A), A.row_ids, mb)
    Y = jax.ops.segment_sum(prod, rows, num_segments=mb + 1)[:mb]
    return Y.reshape(mb * bs, k)[:m]
