"""Op system tests (model: reference ``tests/test_op.cpp``)."""

import numpy as np
import pytest

import jax.numpy as jnp

from spla_tpu import op as ops
from spla_tpu.types import BOOL, FLOAT, INT, UINT


def test_builtin_metadata():
    assert ops.PLUS_INT.name == "PLUS"
    assert ops.PLUS_INT.type is INT
    assert ops.PLUS_INT.key == "PLUS_INT"
    assert ops.lookup("MIN", FLOAT) is ops.MIN_FLOAT
    # op constants attach to types like pyspla (INT.PLUS etc.)
    assert INT.PLUS is ops.PLUS_INT
    assert FLOAT.MULT is ops.MULT_FLOAT
    assert UINT.BOR is ops.BOR_UINT


def test_builtin_count():
    # 3 types x 12 binary + 2 x 3 bitwise, 3 x 6 unary + 2 BNOT + 13 float
    # unary, 3 x 8 select — matches reference op.hpp:98-210 inventory
    unary = [o for o in ops.BUILTIN_OPS.values() if isinstance(o, ops.OpUnary)]
    binary = [o for o in ops.BUILTIN_OPS.values() if isinstance(o, ops.OpBinary)]
    select = [o for o in ops.BUILTIN_OPS.values() if isinstance(o, ops.OpSelect)]
    assert len(unary) == 3 * 6 + 2 + 13
    assert len(binary) == 3 * 12 + 2 * 3
    assert len(select) == 3 * 8


def test_arith_semantics():
    a = jnp.asarray([3, -4, 7], jnp.int32)
    b = jnp.asarray([2, 3, -2], jnp.int32)
    np.testing.assert_array_equal(ops.PLUS_INT(a, b), [5, -1, 5])
    np.testing.assert_array_equal(ops.MINUS_INT(a, b), [1, -7, 9])
    np.testing.assert_array_equal(ops.MULT_INT(a, b), [6, -12, -14])
    # C++ trunc division, not Python floor
    np.testing.assert_array_equal(ops.DIV_INT(a, b), [1, -1, -3])
    np.testing.assert_array_equal(ops.MINUS_POW2_INT(a, b), [1, 49, 81])
    np.testing.assert_array_equal(ops.FIRST_INT(a, b), a)
    np.testing.assert_array_equal(ops.SECOND_INT(a, b), b)
    np.testing.assert_array_equal(ops.BONE_INT(a, b), [1, 1, 1])
    np.testing.assert_array_equal(ops.MIN_INT(a, b), [2, -4, -2])
    np.testing.assert_array_equal(ops.MAX_INT(a, b), [3, 3, 7])
    np.testing.assert_array_equal(ops.LOR_INT(jnp.asarray([3, 0, 0]), jnp.asarray([5, 2, 0])), [1, 1, 0])
    np.testing.assert_array_equal(ops.LAND_INT(jnp.asarray([3, 0, 7]), jnp.asarray([5, 2, 0])), [1, 0, 0])
    np.testing.assert_array_equal(ops.BOR_INT(jnp.asarray([1, 4]), jnp.asarray([2, 4])), [3, 4])
    np.testing.assert_array_equal(ops.BAND_INT(jnp.asarray([3, 5]), jnp.asarray([1, 4])), [1, 4])
    np.testing.assert_array_equal(ops.BXOR_INT(jnp.asarray([3, 5]), jnp.asarray([1, 4])), [2, 1])


def test_unary_semantics():
    a = jnp.asarray([4.0, -9.0, 0.25], jnp.float32)
    np.testing.assert_array_equal(ops.IDENTITY_FLOAT(a), a)
    np.testing.assert_array_equal(ops.AINV_FLOAT(a), -a)
    # tolerance: one f32 operation, compared at numpy's default rtol
    np.testing.assert_allclose(ops.MINV_FLOAT(a), 1.0 / a)
    np.testing.assert_array_equal(ops.LNOT_FLOAT(jnp.asarray([0.0, 2.0])), [1.0, 0.0])
    np.testing.assert_array_equal(ops.UONE_FLOAT(a), [1.0, 1.0, 1.0])
    np.testing.assert_array_equal(ops.ABS_FLOAT(a), [4.0, 9.0, 0.25])
    np.testing.assert_array_equal(ops.BNOT_INT(jnp.asarray([0], jnp.int32)), [-1])
    # tolerance: one f32 operation, compared at numpy's default rtol
    np.testing.assert_allclose(ops.SQRT_FLOAT(jnp.asarray([4.0])), [2.0])
    # uint AINV is modular like C++
    assert int(ops.AINV_UINT(jnp.asarray([1], jnp.uint32))[0]) == 2**32 - 1


def test_select_semantics():
    a = jnp.asarray([-1, 0, 2], jnp.int32)
    np.testing.assert_array_equal(ops.EQZERO_INT(a), [False, True, False])
    np.testing.assert_array_equal(ops.NQZERO_INT(a), [True, False, True])
    np.testing.assert_array_equal(ops.GTZERO_INT(a), [False, False, True])
    np.testing.assert_array_equal(ops.GEZERO_INT(a), [False, True, True])
    np.testing.assert_array_equal(ops.LTZERO_INT(a), [True, False, False])
    np.testing.assert_array_equal(ops.LEZERO_INT(a), [True, True, False])
    np.testing.assert_array_equal(ops.ALWAYS_INT(a), [True, True, True])
    np.testing.assert_array_equal(ops.NEVER_INT(a), [False, False, False])


def test_custom_op():
    # user-defined op: plain Python function (reference custom-op API,
    # OpBinary::make_* / examples/pi.cpp:55-67)
    madd = ops.OpBinary.make(
        "MYADD", INT, lambda a, b: a + b + 1, identity=None, associative=True
    )
    assert madd.key == "MYADD_INT"
    np.testing.assert_array_equal(
        madd(jnp.asarray([1, 2]), jnp.asarray([3, 4])), [5, 7]
    )


def test_monoid_metadata():
    assert ops.PLUS_FLOAT.identity == 0
    assert ops.PLUS_FLOAT.scatter == "add"
    assert ops.MIN_FLOAT.identity == np.float32(np.inf)
    assert ops.MAX_INT.identity == np.iinfo(np.int32).min
    assert ops.BAND_UINT.identity == np.uint32(0xFFFFFFFF)
    assert ops.MINUS_INT.identity is None
    assert ops.BOR_INT.associative and ops.BOR_INT.scatter is None


def test_reference_accessor_surface():
    """Reference pyspla accessors (op.py:79-192, type.py:170-204)."""
    from spla_tpu.types import BOOL, FLOAT

    assert ops.PLUS_INT.name == "PLUS"
    assert ops.PLUS_INT.dtype_res is INT
    assert ops.PLUS_INT.dtype_arg0 is INT
    assert ops.PLUS_INT.dtype_arg1 is INT
    assert ops.ABS_FLOAT.dtype_arg0 is FLOAT
    assert INT.get_code() == "I" and BOOL.get_code() == "B"
    assert INT.cast_value(np.int64(7)) == 7
    assert BOOL.cast_value(1) is True
    assert FLOAT.format_value(1.5, width=4, precision=3) == " 1.5"
    assert BOOL.format_value(True) == " t"
    assert INT.format_value(42, width=4) == "  42"
