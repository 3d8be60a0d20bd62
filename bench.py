"""Headline benchmark: masked plus-times SpMV (the PageRank/BFS inner
step) through the public ``ops.mxv_masked`` on one GPU.

Graph: uniform random, n = 2^21 vertices, 16 stored entries per row
(33.5M entries).  Timing is CHAINED (each SpMV feeds the next) and ends
in ``block_until_ready``, so asynchronous dispatch cannot hide device
time.  The script refuses to run without a GPU: a CPU number is not a
device measurement.

The metrics, cells and the table of device peaks belong to the
benchmark proper; this script prints the time per SpMV and the stored
entries per second, with the device it ran on.

    python bench.py [--profile]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

_T0 = time.perf_counter()


def _log(msg):
    """Progress to stderr (stdout carries the JSON line only)."""
    print(f"[bench {time.perf_counter() - _T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def build_graph(n=1 << 21, deg=16, seed=0):
    """Uniform random graph, CSR, rows sorted (cols unsorted is fine)."""
    rng = np.random.default_rng(seed)
    nnz = n * deg
    rows = np.sort(rng.integers(0, n, nnz, dtype=np.int32))
    cols = rng.integers(0, n, nnz, dtype=np.int32)
    vals = rng.random(nnz, dtype=np.float32)
    counts = np.bincount(rows, minlength=n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr.astype(np.int32), rows, cols, vals


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a jax.profiler device trace of 10 chained "
                         "SpMVs to DIR")
    args = ap.parse_args()

    import jax

    from spla_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {dev.platform!r}")

    import jax.numpy as jnp

    from spla_tpu import op as OP
    from spla_tpu.containers import CsrMatrix, DenseVec
    from spla_tpu.ops import mxv_masked

    n, deg = 1 << 21, 16
    _log("building graph")
    indptr, rows, cols, vals = build_graph(n, deg)
    nnz = vals.size
    A = CsrMatrix(shape=(n, n), indptr=jnp.asarray(indptr),
                  cols=jnp.asarray(cols), values=jnp.asarray(vals),
                  row_ids=jnp.asarray(rows), nnz=jnp.int32(nnz),
                  fill=jnp.float32(0))
    x = jnp.asarray(np.random.default_rng(1).random(n, dtype=np.float32))
    mask = DenseVec(jnp.ones((n,), jnp.float32), jnp.float32(0))
    _log("graph on device")

    # Chained power iteration with a per-iteration scalar perturbation:
    # each SpMV feeds the next and every call's input is unique.
    @jax.jit
    def step(A, y, k):
        o = mxv_masked(mask, A, DenseVec(y, jnp.float32(0)), OP.MULT_FLOAT,
                       OP.PLUS_FLOAT, OP.ALWAYS_FLOAT, 0.0).values
        return o * ((1.0 + k * 1e-6) / (jnp.max(jnp.abs(o)) + jnp.float32(1e-30)))

    t0 = time.perf_counter()
    step(A, x, jnp.float32(0)).block_until_ready()
    compile_s = time.perf_counter() - t0
    _log(f"compiled + warm-up in {compile_s:.1f}s")

    iters = 100
    y = x
    t0 = time.perf_counter()
    for k in range(iters):
        y = step(A, y, jnp.float32(k % 97))
    y.block_until_ready()
    dt = (time.perf_counter() - t0) / iters
    assert bool(jnp.all(jnp.isfinite(y)))

    if args.profile:
        with jax.profiler.trace(args.profile):
            y = x
            for k in range(10):
                y = step(A, y, jnp.float32(k))
            y.block_until_ready()
        _log(f"device trace written to {args.profile}")

    print(json.dumps({
        "metric": "masked_spmv_ms",
        "value": dt * 1e3,
        "unit": "ms",
        "detail": {
            "n": n,
            "nnz": int(nnz),
            "mnnz_per_s": nnz / dt / 1e6,
            "compile_s": compile_s,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
        },
    }))


if __name__ == "__main__":
    main()
