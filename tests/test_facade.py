"""pyspla-compatible API tests (model: reference tests/test_vector.cpp,
test_matrix.cpp and the pyspla examples in python/example.py)."""

import numpy as np
import pytest

from spla_tpu.facade import Array, Matrix, MemView, Scalar, Vector
from spla_tpu.types import FLOAT, INT, UINT


def test_scalar():
    s = Scalar.make_int(5)
    assert s.as_int() == 5 and s.as_float() == 5.0
    assert (s + 2).as_int() == 7
    assert Scalar.make_float(1.5).as_float() == 1.5


def test_array():
    a = Array.from_list([1, 2, 3], INT)
    assert a.n_values == 3 and a.get(1) == 2
    a.set(0, 9)
    assert a.to_list() == [9, 2, 3]
    a.resize(5)
    assert a.n_values == 5 and a.get(0) == 9
    assert not a.empty
    a.clear()
    assert a.empty


def test_vector_set_get_build():
    v = Vector(5, INT)
    v.set(1, 10)
    v.set(3, 30)
    assert v.get(1) == 10 and v.get(3) == 30 and v.get(0) == 0
    i, x = v.read()
    np.testing.assert_array_equal(i, [1, 3])
    v2 = Vector(4, FLOAT)
    v2.build([0, 2], [1.5, 2.5])
    assert v2.get(2) == 2.5


def test_vector_duplicates_reduce():
    v = Vector(4, INT)
    v.set_reduce(INT.PLUS)
    v.set(2, 5)
    v.set(2, 7)
    assert v.get(2) == 12


def test_vector_eadd_emult_map_reduce():
    u = Vector.from_lists([0, 2], [1, 2], 4, INT)
    v = Vector.from_lists([2, 3], [10, 20], 4, INT)
    r = u.eadd(INT.PLUS, v)
    assert r.to_numpy().tolist() == [1, 0, 12, 20]
    r2 = u.emult(INT.MULT, v)
    assert r2.to_numpy().tolist() == [0, 0, 20, 0]
    r3 = u.map(INT.AINV)
    assert r3.to_numpy().tolist() == [-1, 0, -2, 0]
    assert u.reduce(INT.PLUS).as_int() == 3
    assert u.reduce(INT.PLUS, init=Scalar.make_int(100)).as_int() == 103


def test_vector_assign_masked():
    v = Vector.dense(4, INT, 0)
    mask = Vector.from_lists([1, 3], [1, 1], 4, INT)
    v.assign(mask, Scalar.make_int(7), INT.SECOND, INT.NQZERO)
    assert v.to_numpy().tolist() == [0, 7, 0, 7]


def test_matrix_basics():
    M = Matrix((3, 3), INT)
    M.set(0, 1, 5)
    M.set(2, 0, 7)
    assert M.get(0, 1) == 5 and M.get(1, 1) == 0
    r, c, v = M.read()
    assert len(r) == 2


def test_matrix_mxv_and_vxm():
    #  A = [[0,1,0],[0,0,2],[3,0,0]]
    A = Matrix.from_lists([0, 1, 2], [1, 2, 0], [1, 2, 3], (3, 3), INT)
    v = Vector.from_lists([0, 1, 2], [1, 10, 100], 3, INT)
    mask = Vector.dense(3, INT, 1)
    r = A.mxv(mask, v, INT.MULT, INT.PLUS, INT.NQZERO)
    assert r.to_numpy().tolist() == [10, 200, 3]
    r2 = v.vxm(mask, A, INT.MULT, INT.PLUS, INT.NQZERO)
    assert r2.to_numpy().tolist() == [300, 1, 20]


def test_matrix_mxm():
    A = Matrix.from_lists([0, 1], [1, 0], [2.0, 3.0], (2, 2), FLOAT)
    r = A.mxm(A, FLOAT.MULT, FLOAT.PLUS)
    # tolerance: one f32 operation, compared at numpy's default rtol
    np.testing.assert_allclose(r.to_numpy(), [[6.0, 0.0], [0.0, 6.0]])


def test_matrix_kron_kronpow():
    I2 = Matrix.diag((2, 2), INT, 1)
    r = I2.kron(I2, INT.MULT)
    np.testing.assert_array_equal(r.to_numpy(), np.eye(4, dtype=int))
    r2 = I2.kronpow(3)
    assert r2.shape == (8, 8)


def test_matrix_reduce_transpose_extract():
    A = Matrix.from_lists([0, 0, 1], [0, 2, 1], [1, 2, 3], (2, 3), INT)
    assert A.reduce(INT.PLUS).as_int() == 6
    rr = A.reduce_by_row(INT.PLUS)
    assert rr.to_numpy().tolist() == [3, 3]
    rc = A.reduce_by_column(INT.PLUS)
    assert rc.to_numpy().tolist() == [1, 3, 2]
    T = A.transpose()
    assert T.shape == (3, 2) and T.get(2, 0) == 2
    row = A.extract_row(0)
    assert row.to_numpy().tolist() == [1, 0, 2]
    col = A.extract_column(1)
    assert col.to_numpy().tolist() == [0, 3]


def test_matrix_eadd_emult():
    A = Matrix.from_lists([0, 1], [0, 1], [1, 2], (2, 2), INT)
    B = Matrix.from_lists([0, 1], [1, 1], [5, 6], (2, 2), INT)
    np.testing.assert_array_equal(
        A.eadd(INT.PLUS, B).to_numpy(), [[1, 5], [0, 8]]
    )
    np.testing.assert_array_equal(
        A.emult(INT.MULT, B).to_numpy(), [[0, 0], [0, 12]]
    )


def test_matrix_mxmT_masked():
    A = Matrix.from_lists([0, 0, 1], [0, 1, 1], [1, 2, 3], (2, 2), INT)
    mask = Matrix.dense((2, 2), INT, 1)
    r = A.mxmT(mask, A, INT.MULT, INT.PLUS, INT.GTZERO)
    d = np.asarray(A.to_numpy())
    np.testing.assert_array_equal(r.to_numpy(), d @ d.T)


def test_pretty_print():
    A = Matrix.from_lists([0], [1], [7], (2, 2), INT)
    s = A.to_string(width=3)
    assert "7" in s
    v = Vector.from_lists([1], [3], 3, INT)
    assert "3" in str(v)


def test_rand_constructors():
    M = Matrix.rand((10, 10), FLOAT, density=0.3, seed=1)
    assert 0 < len(M.read()[0]) <= 100
    v = Vector.rand(10, INT, density=0.5, seed=1, dist=(1, 5))
    i, x = v.read()
    assert np.all((x >= 1) & (x <= 5))


def test_memview_roundtrip():
    import numpy as np

    from spla_tpu.facade import MemView

    a = np.arange(8, dtype=np.int32)
    v = MemView.make(a)
    assert v.size == 32
    raw = bytes(v.read())
    v.write(0, raw[4:8] + raw[0:4] + raw[8:])
    assert a[0] == 1 and a[1] == 0
    assert np.asarray(v).dtype == np.int32
    # reference property surface (python/pyspla/memview.py:90,109)
    assert v.buffer == a.ctypes.data
    assert v.is_mutable is True
    ro = np.arange(4, dtype=np.int32)
    ro.setflags(write=False)
    assert MemView.make(ro).is_mutable is False


def test_reference_readme_bfs_example():
    """The reference README's flagship pyspla snippet, near-verbatim
    (reference README.md:59-99)."""
    from spla_tpu.facade import Matrix, Scalar, Vector
    from spla_tpu.types import INT

    def bfs(s: int, A: Matrix):
        v = Vector(A.n_rows, INT)  # to store depths

        front = Vector.from_lists([s], [1], A.n_rows, INT)
        front_size = 1
        depth = Scalar(INT, 0)
        count = 0

        while front_size > 0:
            depth += 1
            count += front_size
            v.assign(front, depth, op_assign=INT.SECOND, op_select=INT.NQZERO)
            front = front.vxm(v, A, op_mult=INT.LAND, op_add=INT.LOR,
                              op_select=INT.EQZERO)
            front_size = front.reduce(op_reduce=INT.PLUS).get()

        return v, count, depth.get()

    I = [0, 1, 2, 2, 3]
    J = [1, 2, 0, 3, 2]
    V = [1, 1, 1, 1, 1]
    A = Matrix.from_lists(I, J, V, shape=(4, 4), dtype=INT)
    v, c, d = bfs(0, A)
    idx, vals = v.to_lists()
    assert list(idx) == [0, 1, 2, 3]
    assert list(vals) == [1, 2, 3, 4]
    assert c == 4
    assert d == 4


def test_vector_get_set_reduce_variants():
    # reference tests: get_set_reduce_{default,plus,mult} + sorting_naive
    from spla_tpu.facade import Vector
    from spla_tpu.types import INT

    # default = keep last duplicate (SECOND)
    v = Vector.from_lists([3, 1, 3], [10, 5, 7], (6,), INT)
    assert v.get(3) == 7 and v.get(1) == 5
    # build unsorted indices: must come back sorted (sorting_naive)
    idx, vals = v.to_lists()
    assert list(idx) == sorted(idx)
    # PLUS-reduce duplicates
    v2 = Vector((6,), INT)
    v2.set_reduce(INT.PLUS)
    for i, x in ((2, 3), (2, 4), (5, 1)):
        v2.set(i, x)
    assert v2.get(2) == 7 and v2.get(5) == 1
    # MULT-reduce duplicates
    v3 = Vector((6,), INT)
    v3.set_reduce(INT.MULT)
    for i, x in ((0, 3), (0, 4)):
        v3.set(i, x)
    assert v3.get(0) == 12


def test_matrix_get_set_reduce_variants():
    from spla_tpu.facade import Matrix
    from spla_tpu.types import INT

    M = Matrix((4, 4), INT)
    M.set_reduce(INT.PLUS)
    M.set(1, 2, 5)
    M.set(1, 2, 6)
    assert M.get(1, 2) == 11


def test_vector_fill_value_semantics():
    # reference test vector/fill_value: fill participates in dense reads
    from spla_tpu.facade import Vector
    from spla_tpu.types import FLOAT

    v = Vector.from_lists([1], [2.5], (4,), FLOAT, fill_value=-1.0)
    assert v.get(0) == -1.0  # unset slot reads the fill value
    assert v.get(1) == 2.5


def test_facade_device_resident_lazy_sync():
    """Op results stay device-resident; host staging syncs lazily and
    chained ops never round-trip to the host."""
    import numpy as np

    from spla_tpu import INT

    A = Matrix.from_lists([0, 1, 2], [1, 2, 0], [1, 2, 3], shape=(3, 3), dtype=INT)
    B = A.mxm(A, INT.MULT, INT.PLUS)
    assert B._host_stale and B._csr_cache is not None
    # chaining off a stale result works without a host sync
    C = B.mxm(A, INT.MULT, INT.PLUS)
    assert B._host_stale  # untouched by the chain
    # reads force the sync and agree with numpy
    a = np.zeros((3, 3)); a[0, 1], a[1, 2], a[2, 0] = 1, 2, 3
    np.testing.assert_array_equal(C.to_numpy(), (a @ a) @ a)
    r, c, v = B.read()
    assert B._host_stale is False
    np.testing.assert_array_equal(B.to_numpy(), a @ a)
    # mutation after adoption sees the synced contents
    B.set(0, 0, 7)
    assert B.get(0, 0) == 7


def test_matrix_get_no_densify():
    """Matrix.get reads one element via row-window search (never builds
    an m x n dense array)."""
    from spla_tpu import FLOAT

    A = Matrix.from_lists([0, 5, 9], [3, 5, 0], [1.5, 2.5, 3.5],
                          shape=(10, 10), dtype=FLOAT)
    assert A.get(0, 3) == 1.5
    assert A.get(5, 5) == 2.5
    assert A.get(9, 0) == 3.5
    assert A.get(4, 4) == 0.0  # absent -> fill
    A.set_fill_value(-1.0)
    assert A.get(4, 4) == -1.0


def test_vector_get_single_element():
    from spla_tpu import INT

    v = Vector.from_lists([1, 3], [10, 30], (5,), INT)
    assert v.get(1) == 10 and v.get(3) == 30 and v.get(0) == 0
    w = v.eadd(INT.PLUS, v)
    assert w._host_stale
    assert w.get(3) == 60
    assert w._host_stale  # get() is a point read, not a full sync


def test_memview_rejects_noncontiguous_write():
    # read-only views over non-contiguous memory are allowed (to_numpy /
    # build consume copies anyway); only write() would silently land in a
    # reshape copy, so only write() rejects
    import numpy as np
    import pytest

    a = np.arange(10)
    mv = MemView(a[::2])
    assert mv.to_numpy().tolist() == [0, 2, 4, 6, 8]
    with pytest.raises(ValueError):
        mv.write(0, b"\x01")


def test_op_result_survives_clear_and_rebuild():
    # regression: _adopt leaves _fill_np=None (device snapshot is the only
    # fill source); clear()/build()/set() must not lose the fill value
    from spla_tpu import FLOAT

    v = Vector.from_lists([0, 1], [1.0, 2.0], 4, FLOAT)
    m = Matrix.from_lists([0, 1], [1, 0], [1.0, 1.0], (4, 4), FLOAT)
    mask = Vector(4, FLOAT)
    r = v.vxm(mask, m, FLOAT.MULT, FLOAT.PLUS, FLOAT.ALWAYS)
    r.clear()
    r.set(0, 5.0)
    assert r.to_list() == [(0, 5.0)]
    B = m.mxm(m, FLOAT.MULT, FLOAT.PLUS)
    B.clear()
    B.set(0, 0, 2.0)
    assert B.get(0, 0) == 2.0


def test_reference_package_export_parity():
    """Every public name in the reference pyspla __all__ resolves on
    spla_tpu (python/pyspla/__init__.py:260-280)."""
    import re
    from pathlib import Path

    import spla_tpu

    ref_init = Path("/root/reference/python/pyspla/__init__.py")
    if not ref_init.exists():
        import pytest

        pytest.skip("reference checkout not present")
    m = re.search(r"__all__\s*=\s*\[(.*?)\]", ref_init.read_text(), re.S)
    names = {n for n in re.findall(r'"([A-Za-z_]\w*)"', m.group(1))
             if not n.startswith("_")}
    missing = {n for n in names if not hasattr(spla_tpu, n)}
    assert not missing, f"missing exports: {sorted(missing)}"
    assert names <= set(dir(spla_tpu))


def test_object_base_and_format_enums():
    from spla_tpu import FormatMatrix, FormatVector, Object
    from spla_tpu.facade import Array, Matrix, MemView, Scalar, Vector
    from spla_tpu.types import INT

    for obj in (Matrix((2, 2), INT), Vector((2,), INT), Scalar(1, INT),
                Array(INT), MemView.make(np.zeros(2, np.int32))):
        assert isinstance(obj, Object)
        assert obj.hnd is None
    assert FormatMatrix.ACC_CSR.value == 6 and FormatMatrix.COUNT.value == 8
    assert FormatVector.ACC_DENSE.value == 3 and FormatVector.COUNT.value == 5
    m = Matrix((2, 2), INT, label="lbl")
    assert m.label == "lbl"
