"""Functional op layer — JAX equivalents of the reference's 20
``exec_*`` operations (``include/spla/exec.hpp:53-519``).

Each op is a pure function over pytree containers, jax-traceable end to
end.  The reference's Schedule/Registry/Dispatcher machinery
(``src/exec.cpp``, ``src/core/dispatcher.cpp``) is subsumed by jit
tracing: an op *is* its dispatch key, and XLA's compilation cache replaces
the CLProgramCache.
"""

from .spmv import (
    masked_spmv,
    masked_spmv_structural,
    mxv_masked,
    vxm_masked,
    vxm_masked_dense,
)
from .vector import (
    v_assign_masked,
    v_count_mf,
    v_eadd,
    v_eadd_fdb,
    v_emult,
    v_map,
    v_reduce,
)
from .matrix import (
    kron,
    m_eadd,
    m_emult,
    m_extract_column,
    m_extract_row,
    m_reduce,
    m_reduce_by_column,
    m_reduce_by_row,
    m_transpose,
)
from .spgemm import count_mxm_products, count_mxmT_products, mxm, mxmT_masked
from .bsr import bsr_spmm, bsr_spmv

__all__ = [
    "masked_spmv",
    "masked_spmv_structural",
    "mxv_masked",
    "vxm_masked",
    "vxm_masked_dense",
    "v_eadd",
    "v_emult",
    "v_map",
    "v_reduce",
    "v_count_mf",
    "v_assign_masked",
    "v_eadd_fdb",
    "m_eadd",
    "m_emult",
    "m_reduce",
    "m_reduce_by_row",
    "m_reduce_by_column",
    "m_transpose",
    "m_extract_row",
    "m_extract_column",
    "kron",
    "mxm",
    "mxmT_masked",
    "count_mxm_products",
    "count_mxmT_products",
    "bsr_spmv",
    "bsr_spmm",
]

# reference exec_* naming aliases (include/spla/exec.hpp:53-519): the
# functional layer IS the exec layer; immediate execution, jit-traced
exec_mxm = mxm
exec_mxmT_masked = mxmT_masked
exec_kron = kron
exec_mxv_masked = mxv_masked
exec_vxm_masked = vxm_masked
exec_m_eadd = m_eadd
exec_m_emult = m_emult
exec_m_reduce = m_reduce
exec_m_reduce_by_row = m_reduce_by_row
exec_m_reduce_by_column = m_reduce_by_column
exec_m_transpose = m_transpose
exec_m_extract_row = m_extract_row
exec_m_extract_column = m_extract_column
exec_v_eadd = v_eadd
exec_v_emult = v_emult
exec_v_eadd_fdb = v_eadd_fdb
exec_v_assign_masked = v_assign_masked
exec_v_map = v_map
exec_v_reduce = v_reduce
exec_v_count_mf = v_count_mf

__all__ += [n for n in dir() if n.startswith("exec_")]
