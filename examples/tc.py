"""Triangle counting example/benchmark (reference ``examples/tc.cpp``).

B = (A * A^T) masked by A via mxmT_masked(MULT, PLUS, GTZERO), then
reduce(PLUS); each triangle of the symmetric adjacency is counted 6
times, matching the reference convention.
"""

from __future__ import annotations

import sys

import numpy as np

import jax

from spla_tpu import algorithms
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
)
from .options import make_options


def run(argv=None) -> int:
    args = make_options("tc", "tc (triangles counting) with spla_tpu").parse_args(argv)

    total = Timer()
    t_cpu, t_acc, t_ref = Timer(), Timer(), Timer()
    total.start()

    loader = load_graph(args)
    print(f"env: {env_info()}")
    loader.vals = np.ones_like(loader.vals)

    A = loader.to_csr(np.int32)
    make_descriptor(args)
    n_cpu = n_acc = None

    if args.run_cpu:
        with jax.default_device(cpu_device()):
            A_c = to_device(A, cpu_device())
            for _ in range(args.niters):
                t_cpu.lap_begin()
                n_cpu = algorithms.tc(A_c)
                t_cpu.lap_end()

    if args.run_acc:
        dev = acc_device(args.device)
        with jax.default_device(dev):
            A_a = to_device(A, dev)
            for _ in range(args.niters):
                t_acc.lap_begin()
                n_acc = algorithms.tc(A_a)
                t_acc.lap_end()

    ok = True
    if args.run_ref:
        adj = build_adjacency(loader)
        t_ref.lap_begin()
        ref = algorithms.tc_naive(adj)
        t_ref.lap_end()
        for name, got in (("cpu", n_cpu), ("acc", n_acc)):
            if got is not None:
                good = got == ref
                ok &= good
                print(f"verify {name}: {'OK' if good else f'FAILED got={got} ref={ref}'}")

    print(f"n_triangles (x6): {n_acc if n_acc is not None else n_cpu}")
    total.stop()
    print_timers(total, cpu=t_cpu, acc=t_acc, ref=t_ref)
    return 0 if ok else 1


if __name__ == "__main__":
    from spla_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    sys.exit(run())
