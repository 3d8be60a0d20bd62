"""Semiring building blocks: unary / binary / select operators.

JAX analog of the reference op system (reference:
``include/spla/op.hpp:47-210``, ``src/core/top.hpp:42-117``,
``src/op.cpp:157+``).  The reference carries *two* implementations per op —
a host ``std::function`` and an OpenCL C source string spliced into kernels
at runtime.  Here a single jax-traceable Python callable serves both roles:
it runs on CPU (reference backend) and is traced into XLA programs
for the accelerator.  User-defined ops are therefore plain Python functions
(reference custom-op API: ``OpUnary::make_int(name, cl_code, fn)``,
used e.g. by ``examples/pi.cpp:55-67``).

Binary ops additionally carry monoid metadata used by the kernel layer:

* ``identity`` — monoid identity value, when one exists;
* ``scatter`` — name of a hardware-native scatter combiner
  ("add" / "mul" / "min" / "max") when the op coincides with one, enabling
  the fast scatter path in segment reductions;
* ``associative`` / ``commutative`` flags gating the generic
  segmented-scan path and reduction reorderings.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .types import BOOL, FLOAT, INT, UINT, TYPES, Type

__all__ = [
    "Op",
    "OpUnary",
    "OpBinary",
    "OpSelect",
    "BUILTIN_OPS",
    "lookup",
]


@dataclass(frozen=True)
class Op:
    """Base operator: a named, typed, jax-traceable callable."""

    name: str
    type: Type
    fn: Callable = field(repr=False)

    @property
    def key(self) -> str:
        return f"{self.name}_{self.type.name}"

    # reference accessor surface (python/pyspla/op.py:79-192); ops are
    # same-typed T -> T here, as in every reference built-in
    @property
    def dtype_res(self) -> Type:
        return self.type

    @property
    def dtype_arg0(self) -> Type:
        return self.type

    def __call__(self, *args):
        return self.fn(*args)

    # hashing by identity-ish key keeps ops usable as static jit args
    def __hash__(self):
        return hash((self.__class__.__name__, self.name, self.type))

    def __eq__(self, other):
        return (
            isinstance(other, Op)
            and self.__class__ is other.__class__
            and self.name == other.name
            and self.type == other.type
        )


@dataclass(frozen=True, eq=False)
class OpUnary(Op):
    """T -> T elementwise operator (reference OpUnary, op.hpp:47-60)."""

    @staticmethod
    def make(name: str, type: Type, fn: Callable) -> "OpUnary":
        """User-defined unary op (reference OpUnary::make_*)."""
        return OpUnary(name=name, type=type, fn=fn)


@dataclass(frozen=True, eq=False)
class OpBinary(Op):
    """(T, T) -> T operator (reference OpBinary, op.hpp:62-77)."""

    identity: Optional[object] = None
    scatter: Optional[str] = None  # "add" | "mul" | "min" | "max"
    associative: bool = False
    commutative: bool = False

    @property
    def dtype_arg1(self) -> Type:
        """Second-argument type (reference op.py:188); (T, T) -> T."""
        return self.type

    @staticmethod
    def make(
        name: str,
        type: Type,
        fn: Callable,
        identity=None,
        scatter=None,
        associative=False,
        commutative=False,
    ) -> "OpBinary":
        """User-defined binary op (reference OpBinary::make_*)."""
        return OpBinary(
            name=name,
            type=type,
            fn=fn,
            identity=identity,
            scatter=scatter,
            associative=associative,
            commutative=commutative,
        )

    def identity_array(self):
        assert self.identity is not None, f"op {self.key} has no identity"
        return jnp.asarray(self.identity, dtype=self.type.dtype)


@dataclass(frozen=True, eq=False)
class OpSelect(Op):
    """T -> bool predicate (reference OpSelect, op.hpp:79-94)."""

    @staticmethod
    def make(name: str, type: Type, fn: Callable) -> "OpSelect":
        return OpSelect(name=name, type=type, fn=fn)


# ---------------------------------------------------------------------------
# Built-in registry (reference op list: include/spla/op.hpp:98-210, semantics
# defined by the DECL_OP_* lambda bodies in src/op.cpp).
# ---------------------------------------------------------------------------

BUILTIN_OPS: dict[str, Op] = {}


def _register(op: Op) -> Op:
    BUILTIN_OPS[op.key] = op
    op.type._attach_op(op.name, op)
    return op


def _num_types():
    return (INT, UINT, FLOAT)


def _int_types():
    return (INT, UINT)


def _limits(t: Type):
    if t.is_float():
        info = np.finfo(t.np_dtype)
        return np.float32(-np.inf), np.float32(np.inf)
    info = np.iinfo(t.np_dtype)
    return info.min, info.max


def _one(t: Type):
    return t.np_dtype.type(1)


def _zero(t: Type):
    return t.np_dtype.type(0)


def register_builtins() -> None:
    # ---- unary (reference op.hpp:98-133) ----
    for t in _num_types():
        d = t.dtype
        _register(OpUnary("IDENTITY", t, lambda a: a))
        # AINV: additive inverse; for UINT this is modular negation like C++
        _register(OpUnary("AINV", t, lambda a, d=d: (-a.astype(d)).astype(d)))
        _register(OpUnary("MINV", t, lambda a, d=d: (_ts(1, d) / a).astype(d)))
        _register(OpUnary("LNOT", t, lambda a, d=d: (a == 0).astype(d)))
        _register(OpUnary("UONE", t, lambda a, d=d: jnp.full_like(a, 1)))
        if t is UINT:
            _register(OpUnary("ABS", t, lambda a: a))
        else:
            _register(OpUnary("ABS", t, lambda a: jnp.abs(a)))
    for t in _int_types():
        _register(OpUnary("BNOT", t, lambda a: ~a))
    for fname, f in (
        ("SQRT", jnp.sqrt),
        ("LOG", jnp.log),
        ("EXP", jnp.exp),
        ("SIN", jnp.sin),
        ("COS", jnp.cos),
        ("TAN", jnp.tan),
        ("ASIN", jnp.arcsin),
        ("ACOS", jnp.arccos),
        ("ATAN", jnp.arctan),
        ("CEIL", jnp.ceil),
        ("FLOOR", jnp.floor),
        ("ROUND", jnp.round),
        ("TRUNC", jnp.trunc),
    ):
        _register(OpUnary(fname, FLOAT, f))

    # ---- binary (reference op.hpp:135-182) ----
    for t in _num_types():
        d = t.dtype
        lo, hi = _limits(t)
        _register(
            OpBinary("PLUS", t, lambda a, b: a + b, identity=_zero(t), scatter="add",
                     associative=True, commutative=True)
        )
        _register(OpBinary("MINUS", t, lambda a, b: a - b))
        _register(
            OpBinary("MULT", t, lambda a, b: a * b, identity=_one(t), scatter="mul",
                     associative=True, commutative=True)
        )
        if t.is_float():
            _register(OpBinary("DIV", t, lambda a, b: a / b))
        else:
            # C++ integer division truncates toward zero (lax.div), while
            # Python // floors — the reference host fn is C++, so use lax.div.
            _register(OpBinary("DIV", t, lambda a, b: lax.div(a, b)))
        _register(OpBinary("MINUS_POW2", t, lambda a, b: (a - b) * (a - b)))
        _register(OpBinary("FIRST", t, lambda a, b: a))
        _register(OpBinary("SECOND", t, lambda a, b: b, associative=True))
        _register(OpBinary("BONE", t, lambda a, b, d=d: _full_ones(a, b, d)))
        _register(
            OpBinary("MIN", t, lambda a, b: jnp.minimum(a, b), identity=hi, scatter="min",
                     associative=True, commutative=True)
        )
        _register(
            OpBinary("MAX", t, lambda a, b: jnp.maximum(a, b), identity=lo, scatter="max",
                     associative=True, commutative=True)
        )
        _register(
            OpBinary("LOR", t, lambda a, b, d=d: ((a != 0) | (b != 0)).astype(d),
                     identity=_zero(t), associative=True, commutative=True)
        )
        _register(
            OpBinary("LAND", t, lambda a, b, d=d: ((a != 0) & (b != 0)).astype(d),
                     associative=True, commutative=True)
        )
    for t in _int_types():
        ones = t.np_dtype.type(~t.np_dtype.type(0))
        _register(
            OpBinary("BOR", t, lambda a, b: a | b, identity=_zero(t),
                     associative=True, commutative=True)
        )
        _register(
            OpBinary("BAND", t, lambda a, b: a & b, identity=ones,
                     associative=True, commutative=True)
        )
        _register(
            OpBinary("BXOR", t, lambda a, b: a ^ b, identity=_zero(t),
                     associative=True, commutative=True)
        )

    # ---- select (reference op.hpp:184-210) ----
    for t in _num_types():
        _register(OpSelect("EQZERO", t, lambda a: a == 0))
        _register(OpSelect("NQZERO", t, lambda a: a != 0))
        _register(OpSelect("GTZERO", t, lambda a: a > 0))
        _register(OpSelect("GEZERO", t, lambda a: a >= 0))
        _register(OpSelect("LTZERO", t, lambda a: a < 0))
        _register(OpSelect("LEZERO", t, lambda a: a <= 0))
        _register(OpSelect("ALWAYS", t, lambda a: jnp.full(jnp.shape(a), True)))
        _register(OpSelect("NEVER", t, lambda a: jnp.full(jnp.shape(a), False)))


def _ts(v, dtype):
    return jnp.asarray(v, dtype=dtype)


def _full_ones(a, b, dtype):
    return jnp.full(jnp.broadcast_shapes(jnp.shape(a), jnp.shape(b)), 1, dtype=dtype)


def lookup(name: str, type: Type) -> Op:
    """Find a built-in op by GraphBLAS name + element type."""
    return BUILTIN_OPS[f"{name}_{type.name}"]


register_builtins()

# Module-level op constants mirroring the reference's globals
# (PLUS_INT, MIN_FLOAT, EQZERO_INT, ...).
for _key, _op in list(BUILTIN_OPS.items()):
    globals()[_key] = _op
    __all__.append(_key)
