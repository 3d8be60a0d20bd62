"""Public ops at real widths on the GPU, against scipy in float64.

Marked ``gpu``; they run only where ``SPLA_TEST_GPU=1`` leaves the
platform to JAX and JAX finds a GPU:

    SPLA_TEST_GPU=1 python -m pytest tests/test_gpu.py -m gpu -q

Elsewhere each test skips with the reason, decided in the ``gpu``
fixture (never while the module is imported).
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp
from scipy.sparse import csgraph

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if not os.environ.get("SPLA_TEST_GPU"):
        pytest.skip("GPU lane: set SPLA_TEST_GPU=1 to run on the card")
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip(f"no GPU: JAX found {jax.devices()[0].platform!r}")
    return jax.devices()[0]


def uniform(n, deg, seed):
    rng = np.random.default_rng(seed)
    m = n * deg // 2
    r = rng.integers(0, n, m)
    c = rng.integers(0, n, m)
    keep = r != c
    r, c = r[keep], c[keep]
    A = sp.csr_matrix((np.ones(2 * r.size, np.float32),
                       (np.concatenate([r, c]), np.concatenate([c, r]))),
                      shape=(n, n))
    A.sum_duplicates()
    A.data = rng.random(A.nnz, dtype=np.float32)
    return A


def test_mxv_masked_uniform_2_21(gpu):
    import jax.numpy as jnp

    from spla_tpu import formats as F
    from spla_tpu import op
    from spla_tpu.containers import DenseVec
    from spla_tpu.ops import mxv_masked

    n = 1 << 21
    A = uniform(n, 16, 0)
    x = np.random.default_rng(1).random(n, dtype=np.float32)
    ones = DenseVec(jnp.ones((n,), jnp.float32), jnp.float32(0))
    r = mxv_masked(ones, F.csr_from_scipy(A),
                   DenseVec(jnp.asarray(x), jnp.float32(0)),
                   op.MULT_FLOAT, op.PLUS_FLOAT, op.ALWAYS_FLOAT, 0.0)
    want = A.astype(np.float64) @ x
    err = np.max(np.abs(np.asarray(r.values, np.float64) - want))
    # tolerance: f32 sums over up to max-degree terms in atomic order
    assert err <= 1e-5 * np.max(np.abs(want))


def test_bfs_uniform_2_20(gpu):
    from spla_tpu import algorithms as alg
    from spla_tpu import formats as F

    A = uniform(1 << 20, 16, 2)
    Ac = F.csr_from_scipy(A.astype(np.int32))
    got = np.asarray(alg.bfs(Ac, 0, At=Ac).values)
    d = csgraph.shortest_path(A, unweighted=True, indices=0)
    np.testing.assert_array_equal(
        got, np.where(np.isfinite(d), d + 1, 0).astype(np.int32))


def test_mxm_dense_path_full_f32(gpu):
    """8192 x 8192 at 32 per row takes the dense path; a TF32 product
    would miss the tolerance by ~100x."""
    from spla_tpu import formats as F
    from spla_tpu import op
    from spla_tpu.ops import mxm

    n = 8192
    A = uniform(n, 32, 3)
    R = mxm(F.csr_from_scipy(A), F.csr_from_scipy(A), op.MULT_FLOAT,
            op.PLUS_FLOAT, 0.0)
    k = int(R.nnz)
    got = sp.csr_matrix((np.asarray(R.values)[:k],
                         (np.asarray(R.row_ids)[:k], np.asarray(R.cols)[:k])),
                        shape=(n, n))
    want = A.astype(np.float64) @ A.astype(np.float64)
    # tolerance: f32 sums of up to ~60 products in another order
    assert abs(got - want).max() <= 1e-5 * abs(want).max()


def test_bsr_spmm_full_f32(gpu):
    import jax.numpy as jnp

    from spla_tpu.formats import bsr_from_csr_host, csr_from_scipy
    from spla_tpu.ops import bsr_spmm

    A = uniform(4096, 64, 4)
    X = np.random.default_rng(5).random((4096, 64), dtype=np.float32)
    Y = np.asarray(bsr_spmm(bsr_from_csr_host(csr_from_scipy(A), block=128),
                            jnp.asarray(X)), np.float64)
    want = A.astype(np.float64) @ X.astype(np.float64)
    # tolerance: f32 sums in another order; TF32 would miss by ~100x
    assert np.max(np.abs(Y - want)) <= 1e-5 * np.max(np.abs(want))
