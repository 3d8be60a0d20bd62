"""Runtime type objects (BOOL / INT / UINT / FLOAT).

JAX analog of the reference type system (reference:
``include/spla/type.hpp:46-65``, ``src/core/ttype.hpp:47-66``,
``src/type.cpp``).  Instead of carrying C++ source strings for runtime
OpenCL codegen, a Type simply wraps a jnp dtype — jax tracing *is* the
code generator.

Each Type instance also exposes the built-in operators registered for it
(e.g. ``INT.PLUS``, ``FLOAT.MIN``, ``UINT.NQZERO``) the same way pyspla
attaches op constants to its types (reference: ``python/pyspla/type.py:210-286``).
Those attributes are installed by :mod:`spla_tpu.op` at import time.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

__all__ = ["Type", "BOOL", "INT", "UINT", "FLOAT", "TYPES", "type_from_dtype"]


class Type:
    """A runtime element-type object.

    Attributes
    ----------
    name:  human readable name ("INT", ...)
    code:  single-char dispatch code (reference ``src/core/ttype.hpp``)
    dtype: canonical jnp dtype
    """

    __slots__ = ("name", "code", "dtype", "np_dtype", "_ops")

    def __init__(self, name: str, code: str, dtype):
        self.name = name
        self.code = code
        self.dtype = jnp.dtype(dtype)
        self.np_dtype = np.dtype(dtype)
        self._ops = {}

    # -- op-constant plumbing (filled in by spla_tpu.op.register_builtins) --
    def _attach_op(self, attr: str, op) -> None:
        self._ops[attr] = op

    def __getattr__(self, attr):
        try:
            return self._ops[attr]
        except KeyError:
            raise AttributeError(f"type {self.name} has no op or attribute {attr!r}") from None

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<spla_tpu.Type {self.name}>"

    def __eq__(self, other):
        return isinstance(other, Type) and other.name == self.name

    def __hash__(self):
        return hash((Type, self.name))

    # -- reference pyspla Type helper surface (python/pyspla/type.py:170-204) --
    def get_code(self) -> str:
        """Literal dispatch code of the type ('B'/'I'/'U'/'F')."""
        return self.code

    def cast_value(self, value):
        """Native (ctypes / numpy scalar / python) value -> python value
        of this type (reference ``type.py:177``)."""
        raw = getattr(value, "value", value)  # unwrap ctypes
        out = self.np_dtype.type(raw).item()
        return bool(out) if self.np_dtype == np.bool_ else out

    def format_value(self, value, width: int = 2, precision: int = 2) -> str:
        """Pretty-print a value of this type (reference ``type.py:189,357``:
        floats use width.precision, bools render as t/f)."""
        if self.np_dtype == np.bool_ or isinstance(value, bool):
            return f"{'t' if value else 'f':>{width}}"
        if self.is_float():
            return f"{value:>{width}.{precision}}"
        return f"{value:>{width}}"

    # convenience
    def is_float(self) -> bool:
        return jnp.issubdtype(self.dtype, jnp.floating)

    def is_integral(self) -> bool:
        return jnp.issubdtype(self.dtype, jnp.integer) or self.dtype == jnp.bool_


BOOL = Type("BOOL", "B", jnp.bool_)
INT = Type("INT", "I", jnp.int32)
UINT = Type("UINT", "U", jnp.uint32)
FLOAT = Type("FLOAT", "F", jnp.float32)

TYPES = (BOOL, INT, UINT, FLOAT)

_BY_DTYPE = {t.np_dtype: t for t in TYPES}


def type_from_dtype(dtype) -> Type:
    """Map a numpy/jnp dtype to the owning Type object."""
    key = np.dtype(dtype)
    # accept common widenings
    alias = {
        np.dtype(np.int64): np.dtype(np.int32),
        np.dtype(np.int16): np.dtype(np.int32),
        np.dtype(np.int8): np.dtype(np.int32),
        np.dtype(np.uint64): np.dtype(np.uint32),
        np.dtype(np.float64): np.dtype(np.float32),
        np.dtype(np.float16): np.dtype(np.float32),
    }
    key = alias.get(key, key)
    try:
        return _BY_DTYPE[key]
    except KeyError:
        raise TypeError(f"unsupported element dtype {dtype!r}") from None
