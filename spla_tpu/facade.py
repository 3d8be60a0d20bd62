"""pyspla-compatible object API: Matrix, Vector, Scalar, Array.

Mirrors the reference Python package surface (``python/pyspla/matrix.py``,
``vector.py``, ``scalar.py``, ``array.py``): eager execution, the same
method names/signatures (mxm, mxmT, kron, kronpow, mxv, vxm, eadd, emult,
reduce*, transpose, extract*, assign, map, ...), from_lists/rand/dense/
diag constructors, and pretty-printers.

Architecture difference: instead of the reference's mutable
multi-format decoration storage with a BFS conversion graph
(``src/storage/storage_manager.hpp:128-204``), each object keeps

* a *host staging buffer* (numpy COO triplets) absorbing ``set``/``build``
  mutations — the analog of the CpuLil/CpuDok write formats
  (``src/core/tmatrix.hpp:160-173``), and
* a cached *device snapshot* (frozen pytree CSR / dense vec, plus the
  transpose orientation for push ops), rebuilt lazily on first compute
  after a mutation — the analog of the Cpu->Acc converters.

All compute dispatches to the functional op layer (``spla_tpu.ops``);
``jax.jit`` tracing replaces the reference's registry/dispatcher.
"""

from __future__ import annotations

import enum

import numpy as np

import jax
import jax.numpy as jnp

from . import op as OP
from .containers import CsrMatrix, DenseVec, Scalar as CoreScalar, SparseVec
from .descriptor import Descriptor
from . import formats as F
from . import ops as X
from .types import BOOL, FLOAT, INT, UINT, Type, type_from_dtype

__all__ = ["Matrix", "Vector", "Scalar", "Array", "MemView", "Object",
           "FormatMatrix", "FormatVector"]


class Object:
    """Base class of the user-facing objects (reference
    ``python/pyspla/object.py:34-76``).  The reference variant carries a
    native handle and a debug label; here device buffers are owned by
    jax.Arrays, so only the label survives — ``hnd`` is kept for
    introspection parity and is always ``None``."""

    label = None

    @property
    def hnd(self):
        return None


class FormatMatrix(enum.Enum):
    """Reference matrix storage-format enumeration
    (``python/pyspla/bridge.py:101-124``).  Device storage is implicit
    (host staging + device CSR snapshots chosen by the library);
    ``Matrix.set_format`` accepts these values as advisory hints."""

    CPU_LIL = 0
    CPU_DOK = 1
    CPU_COO = 2
    CPU_CSR = 3
    CPU_CSC = 4
    ACC_COO = 5
    ACC_CSR = 6
    ACC_CSC = 7
    COUNT = 8


class FormatVector(enum.Enum):
    """Reference vector storage-format enumeration
    (``python/pyspla/bridge.py:129-146``); advisory here (see
    :class:`FormatMatrix`)."""

    CPU_DOK = 0
    CPU_DENSE = 1
    CPU_COO = 2
    ACC_DENSE = 3
    ACC_COO = 4
    COUNT = 5


def _op_or_default(op, default):
    return default if op is None else op


def _zero(dtype):
    return np.zeros((), dtype)[()]


class Scalar(Object):
    """Typed scalar (reference ``python/pyspla/scalar.py``).

    Accepts both argument orders — ``Scalar(INT, 0)`` (pyspla README
    style) and ``Scalar(0, INT)``."""

    def __init__(self, value=None, dtype: Type = INT):
        if isinstance(value, Type):  # pyspla order: Scalar(dtype, value)
            value, dtype = (dtype if not isinstance(dtype, Type) else None), value
        self._dtype = dtype
        self._value = dtype.np_dtype.type(0 if value is None else value)

    @classmethod
    def make(cls, dtype: Type = INT, value=None):
        return cls(value, dtype)

    @classmethod
    def from_value(cls, value):
        """Create a scalar inferring the type from the Python value
        (reference ``scalar.py:142-166``)."""
        if isinstance(value, bool):
            return cls(int(value), INT)
        if isinstance(value, float):
            return cls(value, FLOAT)
        if isinstance(value, int):
            return cls(value, INT)
        raise Exception("cannot infer type")

    @property
    def n_vals(self):
        """Number of stored values — always 1 (reference ``scalar.py:128``)."""
        return 1

    @classmethod
    def make_int(cls, value=0):
        return cls(value, INT)

    @classmethod
    def make_uint(cls, value=0):
        return cls(value, UINT)

    @classmethod
    def make_float(cls, value=0.0):
        return cls(value, FLOAT)

    @property
    def dtype(self):
        return self._dtype

    @property
    def shape(self):
        return ()

    def set(self, value):
        self._value = self._dtype.np_dtype.type(value)

    def get(self):
        return self._value.item()

    def as_int(self):
        return int(self._value)

    def as_uint(self):
        return int(self._value)

    def as_float(self):
        return float(self._value)

    def as_bool(self):
        return bool(self._value)

    def __int__(self):
        return int(self._value)

    def __float__(self):
        return float(self._value)

    def __bool__(self):
        return bool(self._value)

    def __eq__(self, other):
        return self.get() == (other.get() if isinstance(other, Scalar) else other)

    def __add__(self, other):
        return Scalar(self.get() + _sval(other), self._dtype)

    def __sub__(self, other):
        return Scalar(self.get() - _sval(other), self._dtype)

    def __mul__(self, other):
        return Scalar(self.get() * _sval(other), self._dtype)

    def __truediv__(self, other):
        return Scalar(self.get() / _sval(other), self._dtype)

    def __repr__(self):
        return f"{self.get()}"

    __str__ = __repr__


def _sval(x):
    return x.get() if isinstance(x, Scalar) else x


class MemView(Object):
    """Non-owning view over host memory for zero-copy build/read
    (reference ``include/spla/memview.hpp:48-64``).  On a device the host
    buffer is necessarily copied at device upload; the view is the
    zero-copy HOST handle the bulk build/read APIs accept."""

    def __init__(self, array):
        self._np = np.asarray(array)

    @staticmethod
    def make(array) -> "MemView":
        return MemView(array)

    @property
    def size(self) -> int:
        return int(self._np.nbytes)

    def read(self, offset=0, size=None):
        flat = self._np.reshape(-1).view(np.uint8)
        end = len(flat) if size is None else offset + size
        return flat[offset:end]

    def write(self, offset, data):
        if not self._np.flags.c_contiguous:
            # reshape(-1) on a non-contiguous array copies, so the write
            # would silently land in the copy, not the caller's array;
            # read-only uses (read/to_numpy/build) stay permitted
            raise ValueError(
                "MemView.write requires a C-contiguous array "
                "(use np.ascontiguousarray)"
            )
        flat = self._np.reshape(-1).view(np.uint8)
        data = np.frombuffer(bytes(data), np.uint8)
        flat[offset : offset + data.size] = data

    @property
    def buffer(self):
        """Native pointer to the viewed memory (reference
        ``python/pyspla/memview.py:90`` returns the C buffer pointer).
        Here it is the numpy data pointer of the viewed host array."""
        return self._np.ctypes.data

    @property
    def is_mutable(self) -> bool:
        """True when the viewed buffer can be written through this view
        (reference ``python/pyspla/memview.py:109``)."""
        return bool(self._np.flags.writeable)

    def to_numpy(self):
        return self._np

    def __array__(self, dtype=None):
        return np.asarray(self._np, dtype=dtype)


class Array(Object):
    """Dense typed 1-D array for construction/inspection (reference
    ``python/pyspla/array.py``)."""

    def __init__(self, dtype: Type = INT, label=None):
        self._dtype = dtype
        self._data = np.zeros(0, dtype.np_dtype)
        self.label = label

    @classmethod
    def from_list(cls, values, dtype: Type = INT):
        a = cls(dtype)
        a._data = np.asarray(values, dtype.np_dtype)
        return a

    @classmethod
    def rand(cls, dtype: Type = INT, n=1, seed=None, dist=(0, 1)):
        rng = np.random.default_rng(seed)
        a = cls(dtype)
        if dtype.is_float():
            a._data = rng.uniform(dist[0], dist[1], n).astype(dtype.np_dtype)
        else:
            a._data = rng.integers(dist[0], dist[1] + 1, n).astype(dtype.np_dtype)
        return a

    @property
    def dtype(self):
        return self._dtype

    @property
    def n_values(self):
        return int(self._data.size)

    n_vals = n_values  # reference property name (``array.py:105``)

    @property
    def empty(self):
        return self._data.size == 0

    @property
    def shape(self):
        return (self.n_values, 1)

    def set(self, index, value):
        self._data[index] = value

    def get(self, index):
        return self._data[index].item()

    def resize(self, n):
        old = self._data
        self._data = np.zeros(n, self._dtype.np_dtype)
        self._data[: min(n, old.size)] = old[: min(n, old.size)]

    def clear(self):
        self._data = np.zeros(0, self._dtype.np_dtype)

    def to_list(self):
        return self._data.tolist()

    def to_numpy(self):
        return self._data.copy()

    def build(self, view: "MemView"):
        """Build the array content from a raw memory view (reference
        ``array.py:157-165``)."""
        raw = view.to_numpy()
        self._data = np.frombuffer(
            raw.tobytes(), dtype=self._dtype.np_dtype
        ).copy()

    def read(self) -> "MemView":
        """Read the content as a zero-copy MemView (reference
        ``array.py:167-176``)."""
        return MemView(self._data)

    def __iter__(self):
        return iter(self.to_list())

    def __repr__(self):
        return "[" + ", ".join(str(v) for v in self.to_list()) + "]"

    __str__ = __repr__


class Vector(Object):
    """Generalized n-vector (reference ``python/pyspla/vector.py``)."""

    def __init__(self, shape, dtype: Type = INT, label=None):
        n = shape[0] if isinstance(shape, (tuple, list)) else int(shape)
        self._n = int(n)
        self._dtype = dtype
        self._fill_np = _zero(dtype.np_dtype)
        self._idx = np.zeros(0, np.int64)
        self._val = np.zeros(0, dtype.np_dtype)
        self._reduce_fn = None
        self._dense_cache = None
        self._host_stale = False  # True = device snapshot is canonical
        self.label = label

    # -- properties ------------------------------------------------------
    @property
    def dtype(self):
        return self._dtype

    @property
    def n_rows(self):
        return self._n

    @property
    def shape(self):
        return (self._n, 1)

    @property
    def _fill(self):
        # after an op result adoption only the device snapshot is live;
        # pull the 4-byte fill scalar lazily instead of the whole vector
        if self._fill_np is None:
            self._fill_np = np.asarray(self._dense_cache.fill)[()].astype(
                self._dtype.np_dtype
            )
        return self._fill_np

    @_fill.setter
    def _fill(self, value):
        self._fill_np = value

    @property
    def fill_value(self):
        return Scalar(self._fill, self._dtype)

    def set_fill_value(self, value):
        self._sync_host()
        self._fill_np = self._dtype.np_dtype.type(_sval(value))
        self._dense_cache = None

    def set_format(self, fmt):  # storage hint — formats are implicit here
        pass

    def set_reduce(self, op):
        self._reduce_fn = op

    # -- mutation (host staging) ------------------------------------------
    def set(self, i, v):
        self._sync_host()  # appends need the current contents
        self._idx = np.append(self._idx, i)
        self._val = np.append(self._val, self._dtype.np_dtype.type(v))
        self._dense_cache = None

    def get(self, i):
        # single-element device read (not a full-vector D2H)
        return np.asarray(self._device().values[i])[()].item()

    def build(self, view_I, view_V):
        self._fill  # materialize from the device cache before dropping it
        self._idx = np.asarray(view_I, np.int64).copy()
        self._val = np.asarray(view_V, self._dtype.np_dtype).copy()
        self._dense_cache = None
        self._host_stale = False

    def read(self):
        if self._host_stale:
            self._sync_host()  # the full pull doubles as the lazy sync
            return self._idx.copy(), self._val.copy()
        d = np.asarray(self._device().values)
        idx = np.nonzero(d != self._fill)[0]
        return idx, d[idx]

    def clear(self):
        self._fill  # materialize from the device cache before dropping it
        self._idx = np.zeros(0, np.int64)
        self._val = np.zeros(0, self._dtype.np_dtype)
        self._dense_cache = None
        self._host_stale = False

    def fill_with(self, value):
        self.clear()
        self._fill_np = self._dtype.np_dtype.type(_sval(value))

    def fill_noize(self, seed=None):
        self._fill  # materialize from the device cache before dropping it
        rng = np.random.default_rng(seed)
        self._idx = np.arange(self._n)
        self._val = (
            rng.uniform(0, 1, self._n).astype(self._dtype.np_dtype)
            if self._dtype.is_float()
            # full non-negative range: callers hash these as seeds
            # (examples/pi.py) — a narrow range caps sample diversity
            else rng.integers(0, 2**31 - 1, self._n).astype(self._dtype.np_dtype)
        )
        self._dense_cache = None
        self._host_stale = False

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_lists(cls, I, V, shape, dtype: Type = INT, fill_value=0):
        v = cls(shape, dtype)
        v._fill = dtype.np_dtype.type(fill_value)
        v._idx = np.asarray(I, np.int64)
        v._val = np.asarray(V, dtype.np_dtype)
        return v

    @classmethod
    def rand(cls, shape, dtype: Type = INT, density=0.1, seed=None, dist=(0, 1)):
        n = shape[0] if isinstance(shape, (tuple, list)) else int(shape)
        rng = np.random.default_rng(seed)
        k = max(int(n * density), 0)
        idx = np.unique(rng.integers(0, n, k)) if k else np.zeros(0, np.int64)
        if dtype.is_float():
            vals = rng.uniform(dist[0], dist[1], idx.size)
        else:
            vals = rng.integers(dist[0], dist[1] + 1, idx.size)
        return cls.from_lists(idx, vals.astype(dtype.np_dtype), n, dtype)

    @classmethod
    def dense(cls, shape, dtype: Type = INT, fill_value=0):
        n = shape[0] if isinstance(shape, (tuple, list)) else int(shape)
        v = cls(n, dtype)
        v._idx = np.arange(n)
        v._val = np.full(n, fill_value, dtype.np_dtype)
        return v

    # -- device snapshot ----------------------------------------------------
    def _device(self) -> DenseVec:
        if self._dense_cache is None:
            reduce_fn = self._reduce_fn.fn if self._reduce_fn else None
            self._dense_cache = F.dense_vec_from_entries(
                self._n, self._idx, self._val, fill=self._fill,
                dtype=self._dtype.np_dtype, reduce_fn=reduce_fn,
            )
        return self._dense_cache

    def _adopt(self, dv: DenseVec):
        """Replace contents with a device vector.  The device snapshot
        stays canonical; host staging syncs lazily on read()/set() — the
        reference likewise keeps device decorations alive between ops
        (``storage_manager_matrix.hpp:138-142``) instead of reading back."""
        self._dense_cache = dv
        self._host_stale = True
        self._fill_np = None
        return self

    def _sync_host(self):
        """Materialize host staging from the device snapshot (lazy D2H)."""
        if not self._host_stale:
            return
        dv = self._dense_cache
        d = np.asarray(dv.values)
        self._fill_np = np.asarray(dv.fill)[()].astype(self._dtype.np_dtype)
        stored = np.nonzero(d != self._fill_np)[0]
        self._idx = stored
        self._val = d[stored].astype(self._dtype.np_dtype)
        self._host_stale = False

    def to_numpy(self):
        return np.asarray(self._device().values)

    def to_lists(self):
        i, v = self.read()
        return i.tolist(), v.tolist()

    def to_list(self):
        i, v = self.read()
        return list(zip(i.tolist(), v.tolist()))

    def to_string(self, format_string="{:>%s}", width=2, precision=2, skip_value=0):
        d = self.to_numpy()
        fmt = format_string % max(width, 1)
        return "".join(
            fmt.format(_fmt_val(x, precision)) for x in d
        )

    # -- compute ops (eager, functional core) -------------------------------
    def vxm(self, mask, M: "Matrix", op_mult, op_add, op_select,
            out=None, init=None, desc=None):
        init_v = _sval(init) if init is not None else _zero(self._dtype.np_dtype)
        # dense-result variant: the Vector container is dense, so the
        # sparse compaction + structural pass of vxm_masked are
        # unobservable here — one kernel instead of two (ops.spmv
        # docstring has the equivalence argument)
        r = X.vxm_masked_dense(
            mask._device(), self._device(), M._device_t(),
            op_mult, op_add, op_select, init_v, desc,
        )
        res = out if out is not None else Vector(M.n_cols, self._dtype)
        return res._adopt(r)

    def eadd(self, op_add, v: "Vector", out=None, desc=None):
        r = X.v_eadd(self._device(), v._device(), op_add)
        res = out if out is not None else Vector(self._n, self._dtype)
        return res._adopt(r if isinstance(r, DenseVec) else F.sparse_to_dense_vec(r))

    def emult(self, op_mult, v: "Vector", out=None, desc=None):
        r = X.v_emult(self._device(), v._device(), op_mult)
        res = out if out is not None else Vector(self._n, self._dtype)
        return res._adopt(r if isinstance(r, DenseVec) else F.sparse_to_dense_vec(r))

    def assign(self, mask, value, op_assign, op_select, desc=None):
        r = X.v_assign_masked(
            self._device(), mask._device(), _sval(value), op_assign, op_select
        )
        return self._adopt(r)

    def map(self, op_map, out=None, desc=None):
        r = X.v_map(self._device(), op_map)
        res = out if out is not None else Vector(self._n, self._dtype)
        return res._adopt(r)

    def reduce(self, op_reduce, out=None, init=None, desc=None):
        init_v = _sval(init) if init is not None else _zero(self._dtype.np_dtype)
        # reference sparse reduce folds stored entries only
        sv = F.dense_to_sparse_vec(self._device())
        r = X.v_reduce(init_v, sv, op_reduce)
        res = out if out is not None else Scalar(dtype=self._dtype)
        res.set(np.asarray(r.value)[()])
        return res

    def count_mf(self):
        return int(np.asarray(X.v_count_mf(self._device()).value))

    def __str__(self):
        return self.to_string()

    def __iter__(self):
        return iter(self.to_list())


def _fmt_val(x, precision):
    if isinstance(x, (np.floating, float)):
        return f"{x:.{precision}f}"
    return str(x)


class Matrix(Object):
    """Generalized M x N matrix (reference ``python/pyspla/matrix.py``)."""

    def __init__(self, shape, dtype: Type = INT, label=None):
        self._shape = (int(shape[0]), int(shape[1]))
        self._dtype = dtype
        self._fill_np = _zero(dtype.np_dtype)
        self._rows = np.zeros(0, np.int64)
        self._cols = np.zeros(0, np.int64)
        self._vals = np.zeros(0, dtype.np_dtype)
        self._reduce_fn = None
        self._csr_cache = None
        self._csr_t_cache = None
        self._host_stale = False  # True = device snapshot is canonical
        self.label = label

    # -- properties -------------------------------------------------------
    @property
    def dtype(self):
        return self._dtype

    @property
    def n_rows(self):
        return self._shape[0]

    @property
    def n_cols(self):
        return self._shape[1]

    @property
    def shape(self):
        return self._shape

    @property
    def _fill(self):
        if self._fill_np is None:
            self._fill_np = np.asarray(self._csr_cache.fill)[()].astype(
                self._dtype.np_dtype
            )
        return self._fill_np

    @_fill.setter
    def _fill(self, value):
        self._fill_np = value

    @property
    def fill_value(self):
        return Scalar(self._fill, self._dtype)

    def set_fill_value(self, value):
        self._sync_host()
        self._fill_np = self._dtype.np_dtype.type(_sval(value))
        self._invalidate()

    def set_format(self, fmt):
        pass

    def set_reduce(self, op):
        self._reduce_fn = op

    def _invalidate(self):
        if self._csr_cache is not None:
            self._fill  # materialize the fill value before the drop
        self._csr_cache = None
        self._csr_t_cache = None

    # -- mutation -----------------------------------------------------------
    def set(self, i, j, v):
        self._sync_host()  # appends need the current contents
        self._rows = np.append(self._rows, i)
        self._cols = np.append(self._cols, j)
        self._vals = np.append(self._vals, self._dtype.np_dtype.type(v))
        self._invalidate()

    set_int = set
    set_uint = set
    set_float = set

    def get(self, i, j):
        """Read one element via a CSR row-window search — O(row degree)
        transferred, never a densified matrix (reference reads via a DOK
        hash, ``src/core/tmatrix.hpp:179-210``)."""
        A = self._device()
        s = int(np.asarray(A.indptr[i]))
        e = int(np.asarray(A.indptr[i + 1]))
        if e > s:
            cols = np.asarray(A.cols[s:e])
            hit = np.nonzero(cols == j)[0]
            if hit.size:
                return np.asarray(A.values[s + int(hit[0])])[()].item()
        return self._fill.item() if hasattr(self._fill, "item") else self._fill

    def build(self, view_I, view_J, view_V):
        self._rows = np.asarray(view_I, np.int64).copy()
        self._cols = np.asarray(view_J, np.int64).copy()
        self._vals = np.asarray(view_V, self._dtype.np_dtype).copy()
        self._invalidate()
        self._host_stale = False

    def read(self):
        if self._host_stale:
            self._sync_host()  # the full pull doubles as the lazy sync
            return (
                self._rows.astype(np.int64),
                self._cols.astype(np.int64),
                self._vals.copy(),
            )
        A = self._device()
        nnz = int(np.asarray(A.nnz))
        return (
            np.asarray(A.row_ids)[:nnz],
            np.asarray(A.cols)[:nnz],
            np.asarray(A.values)[:nnz],
        )

    def clear(self):
        self._rows = np.zeros(0, np.int64)
        self._cols = np.zeros(0, np.int64)
        self._vals = np.zeros(0, self._dtype.np_dtype)
        self._invalidate()
        self._host_stale = False

    # -- constructors ---------------------------------------------------------
    @classmethod
    def from_lists(cls, I, J, V, shape, dtype: Type = INT):
        m = cls(shape, dtype)
        m._rows = np.asarray(I, np.int64)
        m._cols = np.asarray(J, np.int64)
        m._vals = np.asarray(V, dtype.np_dtype)
        return m

    @classmethod
    def rand(cls, shape, dtype: Type = INT, density=0.1, seed=None, dist=(0, 1)):
        rng = np.random.default_rng(seed)
        mr, nc = shape
        k = int(mr * nc * density)
        rows = rng.integers(0, mr, k)
        cols = rng.integers(0, nc, k)
        keys = np.unique(rows * nc + cols)
        rows, cols = keys // nc, keys % nc
        if dtype.is_float():
            vals = rng.uniform(dist[0], dist[1], rows.size)
        else:
            vals = rng.integers(dist[0], dist[1] + 1, rows.size)
        return cls.from_lists(rows, cols, vals.astype(dtype.np_dtype), shape, dtype)

    @classmethod
    def dense(cls, shape, dtype: Type = INT, fill_value=0):
        mr, nc = shape
        rows, cols = np.divmod(np.arange(mr * nc), nc)
        vals = np.full(mr * nc, fill_value, dtype.np_dtype)
        return cls.from_lists(rows, cols, vals, shape, dtype)

    @classmethod
    def diag(cls, shape, dtype: Type = INT, diag_value=1):
        k = min(shape)
        idx = np.arange(k)
        return cls.from_lists(
            idx, idx, np.full(k, diag_value, dtype.np_dtype), shape, dtype
        )

    # -- device snapshots -------------------------------------------------------
    def _device(self) -> CsrMatrix:
        if self._csr_cache is None:
            reduce_fn = self._reduce_fn.fn if self._reduce_fn else None
            self._csr_cache = F.csr_from_entries(
                self._shape, self._rows, self._cols, self._vals,
                fill=self._fill, dtype=self._dtype.np_dtype, reduce_fn=reduce_fn,
            )
        return self._csr_cache

    def _device_t(self) -> CsrMatrix:
        if self._csr_t_cache is None:
            self._csr_t_cache = F.csr_transpose_host(self._device())
        return self._csr_t_cache

    def _adopt(self, A: CsrMatrix):
        """Adopt a device result; host staging syncs lazily (the reference
        keeps device decorations live between ops rather than reading back,
        ``storage_manager_matrix.hpp:138-142``)."""
        self._csr_cache = A
        self._csr_t_cache = None
        self._host_stale = True
        self._fill_np = None
        self._shape = A.shape
        return self

    def _sync_host(self):
        """Materialize host staging from the device snapshot (lazy D2H)."""
        if not self._host_stale:
            return
        A = self._csr_cache
        nnz = int(np.asarray(A.nnz))
        self._rows = np.asarray(A.row_ids)[:nnz].astype(np.int64)
        self._cols = np.asarray(A.cols)[:nnz].astype(np.int64)
        self._vals = np.asarray(A.values)[:nnz].astype(self._dtype.np_dtype)
        self._fill_np = np.asarray(A.fill)[()].astype(self._dtype.np_dtype)
        self._host_stale = False

    def to_numpy(self):
        return np.asarray(F.csr_to_dense(self._device()))

    def to_lists(self):
        r, c, v = self.read()
        return r.tolist(), c.tolist(), v.tolist()

    def to_list(self):
        r, c, v = self.read()
        return list(zip(r.tolist(), c.tolist(), v.tolist()))

    def to_string(self, format_string="{:>%s}", width=2, precision=2,
                  skip_value=0, cell_sep=""):
        d = self.to_numpy()
        fmt = format_string % max(width, 1)
        lines = []
        for row in d:
            lines.append(
                cell_sep.join(fmt.format(_fmt_val(x, precision)) for x in row)
            )
        return "\n".join(lines) + "\n"

    # -- compute ops --------------------------------------------------------
    def mxm(self, M: "Matrix", op_mult, op_add, out=None, init=None, desc=None):
        init_v = _sval(init) if init is not None else _zero(self._dtype.np_dtype)
        r = X.mxm(self._device(), M._device(), op_mult, op_add, init_v)
        res = out if out is not None else Matrix((self.n_rows, M.n_cols), self._dtype)
        return res._adopt(r)

    def mxmT(self, mask: "Matrix", M: "Matrix", op_mult, op_add, op_select,
             out=None, init=None, desc=None):
        init_v = _sval(init) if init is not None else _zero(self._dtype.np_dtype)
        r = X.mxmT_masked(
            mask._device(), self._device(), M._device(),
            op_mult, op_add, op_select, init_v,
        )
        res = out if out is not None else Matrix((self.n_rows, M.n_rows), self._dtype)
        return res._adopt(r)

    def kron(self, M: "Matrix", op_mult, out=None, desc=None):
        r = X.kron(self._device(), M._device(), op_mult)
        res = out if out is not None else Matrix(
            (self.n_rows * M.n_rows, self.n_cols * M.n_cols), self._dtype
        )
        return res._adopt(r)

    def kronpow(self, exponent, op_mult=None):
        op_mult = _op_or_default(op_mult, OP.lookup("MULT", self._dtype))
        if exponent == 0:
            return Matrix.diag((1, 1), self._dtype, 1)
        if exponent == 1:
            # fresh object: returning self would alias mutations
            i, j, v = self.to_lists()
            return Matrix.from_lists(list(i), list(j), list(v),
                                     self.shape, self._dtype)
        r = self
        for _ in range(exponent - 1):
            r = r.kron(self, op_mult)
        return r

    def mxv(self, mask: Vector, v: Vector, op_mult, op_add, op_select,
            out=None, init=None, desc=None):
        init_v = _sval(init) if init is not None else _zero(self._dtype.np_dtype)
        r = X.mxv_masked(
            mask._device(), self._device(), v._device(),
            op_mult, op_add, op_select, init_v, desc,
        )
        res = out if out is not None else Vector(self.n_rows, self._dtype)
        return res._adopt(r)

    def eadd(self, op_add, M: "Matrix", out=None, desc=None):
        r = X.m_eadd(self._device(), M._device(), op_add)
        res = out if out is not None else Matrix(self._shape, self._dtype)
        return res._adopt(r)

    def emult(self, op_mult, M: "Matrix", out=None, desc=None):
        r = X.m_emult(self._device(), M._device(), op_mult)
        res = out if out is not None else Matrix(self._shape, self._dtype)
        return res._adopt(r)

    def reduce_by_row(self, op_reduce, out=None, init=None, desc=None):
        init_v = _sval(init) if init is not None else _zero(self._dtype.np_dtype)
        r = X.m_reduce_by_row(self._device(), op_reduce, init_v)
        res = out if out is not None else Vector(self.n_rows, self._dtype)
        return res._adopt(r)

    def reduce_by_column(self, op_reduce, out=None, init=None, desc=None):
        init_v = _sval(init) if init is not None else _zero(self._dtype.np_dtype)
        r = X.m_reduce_by_column(self._device(), op_reduce, init_v)
        res = out if out is not None else Vector(self.n_cols, self._dtype)
        return res._adopt(r)

    def reduce(self, op_reduce, out=None, init=None, desc=None):
        init_v = _sval(init) if init is not None else _zero(self._dtype.np_dtype)
        r = X.m_reduce(init_v, self._device(), op_reduce)
        res = out if out is not None else Scalar(dtype=self._dtype)
        res.set(np.asarray(r.value)[()])
        return res

    def transpose(self, out=None, op_apply=None, desc=None):
        op_apply = _op_or_default(op_apply, OP.lookup("IDENTITY", self._dtype))
        r = X.m_transpose(self._device(), op_apply)
        res = out if out is not None else Matrix(
            (self.n_cols, self.n_rows), self._dtype
        )
        return res._adopt(r)

    def extract_row(self, index, out=None, op_apply=None, desc=None):
        op_apply = _op_or_default(op_apply, OP.lookup("IDENTITY", self._dtype))
        r = X.m_extract_row(self._device(), index, op_apply)
        res = out if out is not None else Vector(self.n_cols, self._dtype)
        return res._adopt(F.sparse_to_dense_vec(r))

    def extract_column(self, index, out=None, op_apply=None, desc=None):
        op_apply = _op_or_default(op_apply, OP.lookup("IDENTITY", self._dtype))
        r = X.m_extract_column(self._device(), index, op_apply)
        res = out if out is not None else Vector(self.n_rows, self._dtype)
        return res._adopt(F.sparse_to_dense_vec(r))

    def __str__(self):
        return self.to_string()

    def __iter__(self):
        return iter(self.to_list())


# ---------------------------------------------------------------------------
# Profiling instrumentation: every eager-dispatch method opens a profiler
# scope (reference: every backend algo opens a TIME_PROFILE_SCOPE, e.g.
# ``cl_vxm.hpp:74``).  The scope blocks on the result so wall times mean
# device time, mirroring the reference's profiled-dispatch queue.finish()
# (``cl_debug.hpp:36-103``).
# ---------------------------------------------------------------------------


def _instrument(cls, names):
    import functools

    from .profiling import profiler

    for name in names:
        fn = getattr(cls, name)

        def make(fn, label):
            @functools.wraps(fn)
            def wrapped(*args, **kwargs):
                if not profiler.enabled:
                    return fn(*args, **kwargs)
                with profiler.scope(label):
                    out = fn(*args, **kwargs)
                    dev = (
                        getattr(out, "_dense_cache", None)
                        or getattr(out, "_csr_cache", None)
                    )
                    if dev is not None:
                        jax.block_until_ready(jax.tree_util.tree_leaves(dev))
                    return out

            return wrapped

        setattr(cls, name, make(fn, f"{cls.__name__.lower()}_{name}"))


_instrument(Matrix, [
    "mxm", "mxmT", "kron", "kronpow", "mxv", "eadd", "emult",
    "reduce_by_row", "reduce_by_column", "reduce", "transpose",
    "extract_row", "extract_column",
])
_instrument(Vector, ["vxm", "eadd", "emult", "assign", "map", "reduce", "count_mf"])
