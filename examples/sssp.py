"""SSSP example/benchmark (reference ``examples/sssp.cpp``).

Min-plus relaxation over edge weights; unweighted graphs get weight 1.0
like the reference example.
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
    verify_close,
)
from .options import make_options


def run(argv=None) -> int:
    args = make_options("sssp", "sssp (single source shortest paths) with spla_tpu").parse_args(argv)

    total = Timer()
    t_cpu, t_acc, t_ref = Timer(), Timer(), Timer()
    total.start()

    loader = load_graph(args)
    print(f"env: {env_info()}")
    # reference uses weight 1.0 per edge (examples/sssp.cpp set_float(..., 1))
    loader.vals = np.ones_like(loader.vals)

    A = loader.to_csr(np.float32, fill=np.float32(np.inf))
    At = csr_transpose_host(A)
    desc = make_descriptor(args)
    s = args.source
    v_cpu = v_acc = None

    if args.run_cpu:
        At_c = to_device(At, cpu_device())
        for _ in range(args.niters):
            t_cpu.lap_begin()
            v_cpu = algorithms.sssp(At_c, s, desc, At=At_c)
            np.asarray(v_cpu.values)
            t_cpu.lap_end()

    if args.run_acc:
        At_a = to_device(At, acc_device(args.device))
        for _ in range(args.niters):
            t_acc.lap_begin()
            v_acc = algorithms.sssp(At_a, s, desc, At=At_a)
            np.asarray(v_acc.values)
            t_acc.lap_end()

    ok = True
    if args.run_ref:
        adj, w = build_adjacency(loader, weights=True)
        t_ref.lap_begin()
        ref = algorithms.sssp_naive(adj, w, s)
        t_ref.lap_end()
        if v_cpu is not None:
            ok &= verify_close("cpu", np.asarray(v_cpu.values), ref)
        if v_acc is not None:
            ok &= verify_close("acc", np.asarray(v_acc.values), ref)

    total.stop()
    print_timers(total, cpu=t_cpu, acc=t_acc, ref=t_ref)
    return 0 if ok else 1


if __name__ == "__main__":
    from spla_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    sys.exit(run())
