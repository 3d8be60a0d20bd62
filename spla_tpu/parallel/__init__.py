"""Distributed layer: mesh setup, block-row sharded CSR, collective SpMV
and distributed graph algorithms.

The reference is single-process/single-device (SURVEY §2.8 — its only
"communication backend" is host↔device buffer copies inside format
converters).  This layer is new capability mandated by BASELINE.json's
north star: row-partitioned matrices per device, frontier/halo vectors
exchanged with ``jax.lax`` collectives (NCCL over NVLink between the
cards of one host), ``jax.sharding.Mesh`` + ``shard_map`` as the
first-class communication backend.
"""

from .mesh import make_device_mesh
from .dist_matrix import (
    ShardedCsr,
    shard_csr_by_rows,
    shard_csr_by_rows_balanced,
    shard_csr_split_diag,
    shard_vector_by_rows,
)
from .dist_ops import (
    dist_bfs,
    dist_masked_spmv,
    dist_pagerank,
    dist_pagerank_overlap,
    dist_sssp,
)
from .dist_spgemm import (
    count_dist_mxm_cap,
    count_dist_mxmT_cap,
    dist_mxm,
    dist_mxmT_masked_reduce,
    dist_tc,
)

__all__ = [
    "make_device_mesh",
    "ShardedCsr",
    "shard_csr_by_rows",
    "shard_csr_by_rows_balanced",
    "shard_csr_split_diag",
    "shard_vector_by_rows",
    "dist_masked_spmv",
    "dist_pagerank",
    "dist_pagerank_overlap",
    "dist_bfs",
    "dist_sssp",
    "dist_mxm",
    "dist_mxmT_masked_reduce",
    "dist_tc",
    "count_dist_mxm_cap",
    "count_dist_mxmT_cap",
]
