"""Scaling study harness (BASELINE config 5).

Runs distributed PageRank/BFS over a ``jax.sharding.Mesh`` at the given
shard counts and reports per-step wall time and parallel efficiency.  On
four GPUs of one host (NVLink all to all) the times are device numbers:

    python bench_scaling.py --shards 1 2 4

On a virtual CPU mesh the program structure and the exchanged bytes are
meaningful, the times are not, and every row says so:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    JAX_PLATFORMS=cpu python bench_scaling.py --small
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--shards", type=int, nargs="*", default=[1, 2, 4, 8])
    args = ap.parse_args()

    import jax

    from spla_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    if len(jax.devices()) < max(args.shards):
        raise SystemExit(
            f"need {max(args.shards)} devices; run under "
            "XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu"
        )

    import jax.numpy as jnp

    from bench_suite import random_graph
    from spla_tpu import formats as F
    from spla_tpu.parallel import (
        dist_pagerank,
        make_device_mesh,
        shard_csr_by_rows,
    )

    n = 1 << (14 if args.small else 18)
    A = random_graph(n, 16)
    outdeg = np.asarray(A.sum(axis=0)).ravel()
    outdeg[outdeg == 0] = 1
    Ap = F.csr_from_scipy(A.multiply(0.85 / outdeg).tocsr().astype(np.float32))

    base = None
    for s in args.shards:
        mesh = make_device_mesh(s)
        sc = shard_csr_by_rows(Ap, s, mesh)
        p = dist_pagerank(mesh, sc, 0.85, 1e-5)
        np.asarray(jnp.sum(p))  # warm-up + force
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            p = dist_pagerank(mesh, sc, 0.85, 1e-5)
            np.asarray(jnp.sum(p))
        dt = (time.perf_counter() - t0) / reps
        if base is None:
            base = dt
        # strong scaling on a fixed graph: ideal time = base / s
        speedup = base / dt
        plat = jax.devices()[0].platform
        row = {
            "metric": "dist_pagerank_strong_scaling",
            "shards": s,
            "ms": round(dt * 1e3, 1),
            "speedup_vs_1": round(speedup, 2),
            "efficiency": round(speedup / s, 3),
            "n": n, "nnz": int(A.nnz),
            "device": plat,
        }
        if plat == "cpu":
            # a virtual mesh shares the host's cores — its wall time
            # carries NO scaling signal; only the program structure and
            # the comm-volume rows below are meaningful
            row["device"] = "cpu-virtual"
            row["timing_signal"] = ("none: virtual mesh on a shared host "
                                    "core; efficiency is NOT a hardware "
                                    "number")
        print(json.dumps(row), flush=True)

    # ---- comm VOLUME: sparse vs dense frontier exchange (road-class) ----
    # Per-level gather bytes are the same on any mesh.  A road-class
    # graph (2D grid: thousands of near-empty BFS levels) is the case the
    # capped-sparse exchange exists for.
    import scipy.sparse as sp

    from spla_tpu.parallel import dist_bfs

    side = 1 << (6 if args.small else 9)
    g = side * side
    ii = np.arange(g)
    right = ii[(ii % side) < side - 1]
    down = ii[ii < g - side]
    rr = np.concatenate([right, right + 1, down, down + side])
    cc = np.concatenate([right + 1, right, down + side, down])
    G = sp.coo_matrix((np.ones(rr.size, np.float32), (rr, cc)),
                      shape=(g, g)).tocsr()
    Gc = F.csr_from_scipy(G.astype(np.int32))
    s = max(args.shards)
    mesh = make_device_mesh(s)
    sc = shard_csr_by_rows(Gc, s, mesh)
    single_cap = max(sc.mloc // 16, 32)
    results = {}
    for cap, label in ((0, "dense"), (single_cap, "sparse_single_cap"),
                       (None, "sparse_tiered")):
        v, st = dist_bfs(mesh, sc, 0, frontier_cap=cap, with_stats=True)
        np.asarray(v)
        results[label] = st
        print(json.dumps({
            "metric": "dist_bfs_comm_bytes_per_level",
            "exchange": label,
            "shards": s,
            "levels": st["levels"],
            "sparse_levels": st["sparse_levels"],
            "comm_bytes_total": st["comm_bytes"],
            "bytes_per_level": round(st["comm_bytes"] / max(st["levels"], 1)),
            "n": g, "nnz": int(G.nnz),
        }), flush=True)
    if "sparse_single_cap" in results and "sparse_tiered" in results:
        print(json.dumps({
            "metric": "dist_bfs_tiered_cap_saving",
            "vs_single_cap_x": round(
                results["sparse_single_cap"]["comm_bytes"]
                / max(results["sparse_tiered"]["comm_bytes"], 1), 1),
            "vs_dense_x": round(
                results["dense"]["comm_bytes"]
                / max(results["sparse_tiered"]["comm_bytes"], 1), 1),
        }), flush=True)


if __name__ == "__main__":
    main()
