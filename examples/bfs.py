"""BFS example/benchmark (reference ``examples/bfs.cpp``).

Loads a MatrixMarket graph, runs BFS on the accelerator and on the CPU
backend for ``--niters`` laps, validates against the sequential queue
oracle, prints lap times.
"""

from __future__ import annotations

import sys

import numpy as np

import jax

from spla_tpu import algorithms
from spla_tpu.formats import csr_transpose_host
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
    verify_exact,
)
from .options import make_options


def run(argv=None) -> int:
    args = make_options("bfs", "bfs (breadth first search) with spla_tpu").parse_args(argv)

    total = Timer()
    t_cpu, t_acc, t_ref = Timer(), Timer(), Timer()
    total.start()

    loader = load_graph(args)
    print(f"env: {env_info()}")

    A = loader.to_csr(np.int32)
    At = csr_transpose_host(A)
    desc = make_descriptor(args)
    s = args.source
    v_cpu = v_acc = None

    if args.run_cpu:
        A_c, At_c = to_device((A, At), cpu_device())
        for _ in range(args.niters):
            t_cpu.lap_begin()
            v_cpu = algorithms.bfs(A_c, s, desc, At=At_c)
            np.asarray(v_cpu.values)
            t_cpu.lap_end()

    if args.run_acc:
        A_a, At_a = to_device((A, At), acc_device(args.device))
        for _ in range(args.niters):
            t_acc.lap_begin()
            v_acc = algorithms.bfs(A_a, s, desc, At=At_a)
            np.asarray(v_acc.values)
            t_acc.lap_end()

    ok = True
    if args.run_ref:
        adj = build_adjacency(loader)
        t_ref.lap_begin()
        ref = algorithms.bfs_naive(adj, s)
        t_ref.lap_end()
        if v_cpu is not None:
            ok &= verify_exact("cpu", np.asarray(v_cpu.values), ref)
        if v_acc is not None:
            ok &= verify_exact("acc", np.asarray(v_acc.values), ref)

    total.stop()
    print_timers(total, cpu=t_cpu, acc=t_acc, ref=t_ref)
    return 0 if ok else 1


if __name__ == "__main__":
    from spla_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    sys.exit(run())
