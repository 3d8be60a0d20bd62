"""MatrixMarket IO tests (reference MtxLoader semantics)."""

import numpy as np
import pytest

from spla_tpu.io import MtxLoader, _parse_python, load_mtx


MTX = """%%MatrixMarket matrix coordinate real general
% a comment
4 4 5
1 2 1.5
2 1 2.0
3 3 7.0
1 4 -1.0
4 4 3.0
"""

MTX_SYM_PATTERN = """%%MatrixMarket matrix coordinate pattern symmetric
3 3 2
2 1
3 2
"""


@pytest.fixture
def mtx_file(tmp_path):
    p = tmp_path / "t.mtx"
    p.write_text(MTX)
    return str(p)


def test_load_basic(mtx_file):
    l = load_mtx(mtx_file, make_undirected=False, remove_loops=False)
    assert (l.n_rows, l.n_cols, l.n_values) == (4, 4, 5)
    a = l.to_scipy().toarray()
    assert a[0, 1] == 1.5 and a[1, 0] == 2.0 and a[2, 2] == 7.0 and a[0, 3] == -1.0


def test_load_remove_loops(mtx_file):
    l = load_mtx(mtx_file, make_undirected=False, remove_loops=True)
    a = l.to_scipy().toarray()
    assert a[2, 2] == 0 and a[3, 3] == 0
    assert l.n_values == 3


def test_load_undirected(mtx_file):
    l = load_mtx(mtx_file, make_undirected=True, remove_loops=True)
    a = l.to_scipy().toarray()
    # duplicates resolve keep-LAST (like the reference examples' set()
    # loop): the mirrored (1,0)->(0,1)=2.0 overrides the original 1.5,
    # never a silent sum that would double undirected weights
    assert a[0, 1] == 2.0 and a[1, 0] == 1.5 and a[3, 0] == -1.0


def test_pattern_symmetric(tmp_path):
    p = tmp_path / "s.mtx"
    p.write_text(MTX_SYM_PATTERN)
    l = load_mtx(str(p), make_undirected=False)
    a = l.to_scipy().toarray()
    # symmetric header mirrors automatically; pattern values = 1
    assert a[1, 0] == 1 and a[0, 1] == 1 and a[2, 1] == 1 and a[1, 2] == 1


def test_native_matches_python(mtx_file):
    from spla_tpu.io import _parse_native

    nat = _parse_native(mtx_file)
    if nat is None:
        pytest.skip("native parser unavailable")
    py = _parse_python(mtx_file)
    for a, b in zip(nat, py):
        if isinstance(a, np.ndarray):
            # exact up to the default rtol: both parsers read the same decimal text
            np.testing.assert_allclose(a, b)
        else:
            assert a == b


def test_save_roundtrip(mtx_file, tmp_path):
    l = load_mtx(mtx_file, make_undirected=False, remove_loops=False)
    out = str(tmp_path / "o.mtx")
    l.save(out)
    l2 = load_mtx(out, make_undirected=False, remove_loops=False)
    # tolerance: values round-trip through the '%.9g' text format
    np.testing.assert_allclose(
        l.to_scipy().toarray(), l2.to_scipy().toarray()
    )


def test_stats(mtx_file):
    l = load_mtx(mtx_file, make_undirected=False, remove_loops=False)
    s = l.stats
    assert s["n_values"] == 5 and s["deg_max"] == 2 and s["deg_min"] == 1


def test_skew_symmetric_negates_mirror(tmp_path):
    """MatrixMarket skew-symmetric: A = -A^T, mirrored entries negated
    (round-4 parity fix; the header previously parsed as plain
    symmetric)."""
    p = tmp_path / "skew.mtx"
    p.write_text(
        "%%MatrixMarket matrix coordinate real skew-symmetric\n"
        "3 3 2\n"
        "2 1 5.0\n"
        "3 2 -2.0\n"
    )
    from spla_tpu.io import MtxLoader

    ld = MtxLoader(verbose=False).load(str(p))
    import scipy.sparse as sp

    A = sp.coo_matrix(
        (ld.vals, (ld.rows, ld.cols)), shape=(3, 3)
    ).toarray()
    assert A[1, 0] == 5.0 and A[0, 1] == -5.0
    assert A[2, 1] == -2.0 and A[1, 2] == 2.0
    np.testing.assert_array_equal(A, -A.T)
