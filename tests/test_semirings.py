"""Public masked SpMVs over every semiring class and graph class, against
a numpy oracle that folds the matrix's own stored entries.

``mxv_masked`` (pull over a dense vector) and ``vxm_masked`` (push from a
sparse frontier) are checked on each (semiring, graph) pair.  MIN, MAX,
integer and boolean folds are exact and compared exactly; float PLUS
folds are compared with a tolerance (see ``_check``).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from spla_tpu import formats as F
from spla_tpu import op
from spla_tpu.containers import DenseVec
from spla_tpu.ops import mxv_masked, vxm_masked

I32 = np.iinfo(np.int32)

# name: (op_mul, op_add, op_select, init, dtype, value sampler, numpy add)
SEMIRINGS = {
    "plus_times_f32": (op.MULT_FLOAT, op.PLUS_FLOAT, op.NQZERO_FLOAT, 0.0,
                       np.float32, lambda r, k: r.random(k), np.add),
    "min_plus_f32_inf": (op.PLUS_FLOAT, op.MIN_FLOAT, op.NQZERO_FLOAT, np.inf,
                         np.float32, lambda r, k: r.uniform(0.1, 2.0, k),
                         np.minimum),
    "max_times_f32": (op.MULT_FLOAT, op.MAX_FLOAT, op.NQZERO_FLOAT, -np.inf,
                      np.float32, lambda r, k: r.uniform(-1.0, 1.0, k),
                      np.maximum),
    "plus_i32": (op.MULT_INT, op.PLUS_INT, op.NQZERO_INT, 0, np.int32,
                 lambda r, k: r.integers(-50, 50, k), np.add),
    "min_i32": (op.PLUS_INT, op.MIN_INT, op.NQZERO_INT, I32.max, np.int32,
                lambda r, k: r.integers(0, 1000, k), np.minimum),
    "max_i32": (op.MULT_INT, op.MAX_INT, op.NQZERO_INT, I32.min, np.int32,
                lambda r, k: r.integers(-50, 50, k), np.maximum),
    "bor_band_i32": (op.BAND_INT, op.BOR_INT, op.NQZERO_INT, 0, np.int32,
                     lambda r, k: r.integers(0, 1 << 20, k), np.bitwise_or),
    "band_bor_i32": (op.BOR_INT, op.BAND_INT, op.NQZERO_INT, -1, np.int32,
                     lambda r, k: r.integers(0, 1 << 20, k), np.bitwise_and),
    "plus_u32": (op.MULT_UINT, op.PLUS_UINT, op.NQZERO_UINT, 0, np.uint32,
                 lambda r, k: r.integers(0, 100, k), np.add),
    "lor_land_bool": (op.LAND_INT, op.LOR_INT, op.NQZERO_INT, 0, np.int32,
                      lambda r, k: r.integers(0, 2, k), np.logical_or),
}

# numpy twins of the multiplies above (applied as mul(a, x))
NP_MUL = {
    "MULT": lambda a, x: a * x,
    "PLUS": lambda a, x: a + x,
    "BAND": lambda a, x: a & x,
    "BOR": lambda a, x: a | x,
    "LAND": lambda a, x: ((a != 0) & (x != 0)).astype(a.dtype),
}


def _entries(name, rng):
    """(n, rows, cols) of each graph class; values are drawn per semiring."""
    if name == "uniform":
        n = 256
        rows = rng.integers(0, n, 6 * n)
        cols = rng.integers(0, n, 6 * n)
    elif name == "zipf_hubs":
        # zipf-2.1 row degrees (hub rows) and zipf column ids (hub columns)
        n = 256
        deg = np.minimum(rng.zipf(2.1, n), n // 2)
        rows = np.repeat(np.arange(n), deg)
        cols = (rng.zipf(1.8, rows.size) - 1) % n
    elif name == "empty_rows":
        n = 256
        live = rng.permutation(n)[: n // 3]
        rows = rng.choice(live, 5 * n)
        cols = rng.integers(0, n, 5 * n)
    elif name == "empty":
        n = 64
        rows = cols = np.zeros(0, np.int64)
    elif name == "duplicate_heavy":
        # a few rows receive many entries on a handful of columns; the
        # duplicates are folded when the matrix is built
        n = 200
        rows = np.concatenate([np.repeat([3, 77, 150], 120),
                               rng.integers(0, n, 400)])
        cols = np.concatenate([rng.integers(0, 6, 360),
                               rng.integers(0, n, 400)])
    elif name == "n_301":  # not a multiple of 128
        n = 301
        rows = rng.integers(0, n, 5 * n)
        cols = rng.integers(0, n, 5 * n)
    else:  # pragma: no cover
        raise KeyError(name)
    return n, rows, cols


GRAPHS = ["uniform", "zipf_hubs", "empty_rows", "empty", "duplicate_heavy",
          "n_301"]


def _build(graph, semiring, seed):
    mul, add, sel, init, dtype, sample, _ = SEMIRINGS[semiring]
    rng = np.random.default_rng(seed)
    n, rows, cols = _entries(graph, rng)
    vals = sample(rng, rows.size).astype(dtype)
    reduce_fn = (lambda a, b: a + b) if graph == "duplicate_heavy" else None
    A = F.csr_from_entries((n, n), rows, cols, vals, fill=init, dtype=dtype,
                           reduce_fn=reduce_fn)
    x = sample(rng, n).astype(dtype)
    mask = (rng.random(n) < 0.8).astype(dtype)
    return rng, n, A, x, mask


def _fold(semiring, n, rows, cols, prods):
    """Oracle: out[r] = add-fold of prods over stored entries of row r."""
    _, _, _, init, dtype, _, np_add = SEMIRINGS[semiring]
    has = np.zeros(n, bool)
    has[rows] = True
    if np_add is np.logical_or:  # LOR over {0, 1}, init 0
        hits = np.zeros(n, bool)
        np.logical_or.at(hits, rows, prods != 0)
        return hits.astype(dtype), has
    out = np.full(n, init, dtype)
    with np.errstate(over="ignore"):
        np_add.at(out, rows, prods)
    return out, has


def _check(semiring, got, want):
    if semiring == "plus_times_f32":
        # tolerance: f32 sums folded in another order than numpy's (on the
        # GPU the scatter-add's atomic order changes from run to run)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        # MIN/MAX/integer/boolean folds are exact in any order
        np.testing.assert_array_equal(got, want)


def _mul_name(semiring):
    return SEMIRINGS[semiring][0].name


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("semiring", list(SEMIRINGS))
def test_mxv_masked_semiring_graph(semiring, graph):
    mul, add, sel, init, dtype, _, _ = SEMIRINGS[semiring]
    _, n, A, x, mask = _build(graph, semiring, seed=7)
    r = mxv_masked(DenseVec(jnp.asarray(mask), jnp.asarray(0, dtype)), A,
                   DenseVec(jnp.asarray(x), jnp.asarray(init, dtype)),
                   mul, add, sel, init)
    rows, cols, vals = F.host_coo(A)
    with np.errstate(over="ignore"):
        prods = NP_MUL[_mul_name(semiring)](vals, x[cols])
    want, _ = _fold(semiring, n, rows, cols, prods)
    want = np.where(mask != 0, want, np.asarray(init, dtype))
    _check(semiring, np.asarray(r.values), want)


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("semiring", list(SEMIRINGS))
def test_vxm_masked_sparse_frontier(semiring, graph):
    """Push from a 10% frontier: r[j] = fold over frontier i of
    mul(v[i], M[i, j]); stored iff selected and >= 1 product."""
    mul, add, sel, init, dtype, sample, _ = SEMIRINGS[semiring]
    rng, n, M, _, mask = _build(graph, semiring, seed=11)
    front = np.sort(rng.permutation(n)[: max(n // 10, 1)])
    fvals = sample(rng, front.size).astype(dtype)
    v = F.sparse_vec_from_entries(n, front, fvals, fill=init, dtype=dtype)
    Mt = F.csr_transpose_host(M)
    r = vxm_masked(DenseVec(jnp.asarray(mask), jnp.asarray(0, dtype)), v, Mt,
                   mul, add, sel, init)

    rows, cols, vals = F.host_coo(M)
    xv = np.full(n, init, dtype)
    xv[front] = fvals
    live = np.isin(rows, front)
    with np.errstate(over="ignore"):
        # reference product order: mul(v[i], M[i, j])
        prods = NP_MUL[_mul_name(semiring)](xv[rows[live]], vals[live])
    want, has = _fold(semiring, n, cols[live], rows[live], prods)
    has &= mask != 0
    got = np.asarray(F.sparse_to_dense_vec(r).values)
    nnz = int(r.nnz)
    np.testing.assert_array_equal(np.asarray(r.indices)[:nnz],
                                  np.nonzero(has)[0])
    _check(semiring, got, np.where(has, want, np.asarray(init, dtype)))
