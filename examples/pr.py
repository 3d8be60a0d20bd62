"""PageRank example/benchmark (reference ``examples/pr.cpp``).

Matrix prepared exactly like the reference example: A[i,j] = alpha /
out_degree(i) for each edge (i, j) (``examples/pr.cpp:81-87``), then
``p = A p + (1 - alpha)/N`` until the L2 delta drops below eps.

NOTE: the reference scales by the ROW's own out-degree; classic textbook
PageRank scales by the source COLUMN's out-degree (A[i,j] =
alpha/outdeg(j), as ``bench.py``/``__graft_entry__`` do).  This example
keeps reference parity — its naive oracle uses the same convention, so
the verification checks the same quantity the reference computes.
"""

from __future__ import annotations

import sys

import numpy as np

import jax

from spla_tpu import algorithms
from spla_tpu.formats import csr_from_entries
from spla_tpu.timer import Timer

from .common import (
    acc_device,
    build_adjacency,
    cpu_device,
    env_info,
    load_graph,
    make_descriptor,
    print_timers,
    to_device,
    verify_close,
)
from .options import make_options


def run(argv=None) -> int:
    args = make_options("pr", "pr (page rank) with spla_tpu").parse_args(argv)

    total = Timer()
    t_cpu, t_acc, t_ref = Timer(), Timer(), Timer()
    total.start()

    loader = load_graph(args)
    print(f"env: {env_info()}")

    n = loader.n_rows
    deg = np.bincount(loader.rows, minlength=n).astype(np.float32)
    vals = args.alpha / deg[loader.rows]
    A = csr_from_entries((n, n), loader.rows, loader.cols, vals, dtype=np.float32)
    desc = make_descriptor(args)
    p_cpu = p_acc = None

    if args.run_cpu:
        A_c = to_device(A, cpu_device())
        for _ in range(args.niters):
            t_cpu.lap_begin()
            p_cpu = algorithms.pr(A_c, args.alpha, args.eps, desc)
            np.asarray(p_cpu.values)
            t_cpu.lap_end()

    if args.run_acc:
        A_a = to_device(A, acc_device(args.device))
        for _ in range(args.niters):
            t_acc.lap_begin()
            p_acc = algorithms.pr(A_a, args.alpha, args.eps, desc)
            np.asarray(p_acc.values)
            t_acc.lap_end()

    ok = True
    if args.run_ref:
        adj = build_adjacency(loader)
        w = [[float(args.alpha / deg[i])] * len(adj[i]) for i in range(n)]
        t_ref.lap_begin()
        ref = algorithms.pr_naive(adj, w, args.alpha, args.eps)
        t_ref.lap_end()
        if p_cpu is not None:
            ok &= verify_close("cpu", np.asarray(p_cpu.values), ref, atol=1e-4)
        if p_acc is not None:
            ok &= verify_close("acc", np.asarray(p_acc.values), ref, atol=1e-4)

    total.stop()
    print_timers(total, cpu=t_cpu, acc=t_acc, ref=t_ref)
    return 0 if ok else 1


if __name__ == "__main__":
    from spla_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    sys.exit(run())
