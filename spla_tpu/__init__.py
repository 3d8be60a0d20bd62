"""spla_tpu — GraphBLAS-style generalized sparse linear algebra in JAX.

A from-scratch JAX/XLA framework with the capabilities of the
reference spla library (C++/OpenCL, see /root/reference): matrices,
vectors and scalars over parametrizable element types, operations
parametrized by arbitrary (multiply, add, select) semirings, masked
SpMV/SpMM/SpGEMM kernels, and graph algorithms (BFS, SSSP, PageRank,
triangle counting) built purely from the library's own primitives —
redesigned for accelerators: sharded ``jax.Array`` containers, XLA
kernels, ``lax.while_loop`` convergence (no host sync), and
``jax.sharding.Mesh`` + collectives for multi-chip scaling.
"""

from . import op, ops
from .containers import BsrMatrix, CooMatrix, CsrMatrix, DenseVec, Scalar, SparseVec
from .descriptor import Descriptor
from .library import Library, get_library
from .schedule import Schedule, ScheduleTask, make_schedule
from .types import BOOL, FLOAT, INT, UINT, Type, type_from_dtype


_LAZY_FACADE = ("Matrix", "Vector", "Array", "MemView", "Object",
                "FormatMatrix", "FormatVector")
_LAZY_OP = ("Op", "OpUnary", "OpBinary", "OpSelect")


def __getattr__(name):
    # heavier subsystems lazily (facade pulls in the whole op layer)
    import importlib

    if name in _LAZY_FACADE:
        facade = importlib.import_module(".facade", __name__)
        return getattr(facade, name)
    if name in _LAZY_OP:
        return getattr(op, name)
    if name == "MtxLoader":
        return importlib.import_module(".io", __name__).MtxLoader
    if name == "Timer":
        return importlib.import_module(".timer", __name__).Timer
    if name in ("algorithms", "parallel", "io", "profiling", "timer", "facade"):
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module 'spla_tpu' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))


__version__ = "0.1.0"

# reference pyspla exports a VERSIONS history list (python/pyspla/version.py)
VERSIONS = [__version__]

__all__ = [
    "op",
    "ops",
    "Scalar",
    "DenseVec",
    "SparseVec",
    "CooMatrix",
    "CsrMatrix",
    "BsrMatrix",
    "Descriptor",
    "Type",
    "BOOL",
    "INT",
    "UINT",
    "FLOAT",
    "type_from_dtype",
    "__version__",
    "VERSIONS",
    # lazy (module __getattr__): user-facing objects + op classes + subsystems
    "Matrix",
    "Vector",
    "Array",
    "MemView",
    "Object",
    "FormatMatrix",
    "FormatVector",
    "Op",
    "OpUnary",
    "OpBinary",
    "OpSelect",
    "MtxLoader",
    "Timer",
]
