"""Shared harness for the example benchmarks.

Replicates the reference example flow (``examples/bfs.cpp:85-140``): load
mtx -> build matrix -> run accelerator backend and CPU backend for
``niters`` laps -> run the sequential naive oracle -> ``verify_exact`` ->
print lap times.  The "two backends, same algorithm" trick is committed
device placement: the same jitted program runs on ``jax.devices('cpu')``
or on the GPU depending on where its inputs live.
"""

from __future__ import annotations

import sys

import numpy as np

import jax

from spla_tpu import Descriptor
from spla_tpu.containers import CsrMatrix
from spla_tpu.io import MtxLoader
from spla_tpu.timer import Timer

__all__ = [
    "load_graph",
    "build_adjacency",
    "cpu_device",
    "acc_device",
    "to_device",
    "make_descriptor",
    "verify_exact",
    "verify_close",
    "print_timers",
    "env_info",
]


def load_graph(args) -> MtxLoader:
    loader = MtxLoader(verbose=args.verbose)
    loader.load(
        args.mtxpath,
        offset_indexes=True,
        make_undirected=args.undirected,
        remove_loops=True,
    )
    # set-semantics like the reference examples' A->set_*(i, j, v) loop
    # (last duplicate wins); keeps the naive-oracle adjacency lists and the
    # CSR build consistent even for graphs with repeated edges.
    key = loader.rows.astype(np.int64) * loader.n_cols + loader.cols
    _, last = np.unique(key[::-1], return_index=True)
    keep = np.sort(key.size - 1 - last)
    loader.rows, loader.cols, loader.vals = (
        loader.rows[keep], loader.cols[keep], loader.vals[keep],
    )
    return loader


def build_adjacency(loader: MtxLoader, weights: bool = False):
    """Per-row neighbour (and weight) lists for the naive oracles."""
    n = loader.n_rows
    order = np.lexsort((loader.cols, loader.rows))
    rows = loader.rows[order]
    cols = loader.cols[order]
    vals = loader.vals[order]
    adj = [[] for _ in range(n)]
    w = [[] for _ in range(n)] if weights else None
    for k in range(rows.size):
        adj[rows[k]].append(int(cols[k]))
        if weights:
            w[rows[k]].append(float(vals[k]))
    return (adj, w) if weights else adj


def cpu_device():
    return jax.devices("cpu")[0]


def acc_device(index: int = 0):
    devs = jax.devices()
    if devs[0].platform == "cpu":
        print("note: no accelerator available, acc laps run on cpu", file=sys.stderr)
    return devs[min(index, len(devs) - 1)]


def to_device(tree, device):
    return jax.device_put(tree, device)


def make_descriptor(args) -> Descriptor:
    mode = args.push_pull
    return Descriptor(
        push_only=mode == 1,
        pull_only=mode == 2,
        push_pull=mode == 3,
        front_factor=args.front_factor,
    )


def verify_exact(name: str, got, ref) -> bool:
    got = np.asarray(got)
    ref = np.asarray(ref)
    ok = got.shape == ref.shape and bool(np.array_equal(got, ref))
    print(f"verify {name}: {'OK' if ok else 'FAILED'}")
    if not ok:
        if got.shape != ref.shape:
            print(f"  shape {got.shape} != {ref.shape}", file=sys.stderr)
        else:
            bad = np.nonzero(got != ref)[0][:10]
            for i in bad:
                print(f"  [{i}] got={got[i]} ref={ref[i]}", file=sys.stderr)
    return ok


def verify_close(name: str, got, ref, atol=1e-5, rtol=1e-4) -> bool:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    ok = got.shape == ref.shape and bool(
        np.allclose(got, ref, atol=atol, rtol=rtol, equal_nan=True)
    )
    print(f"verify {name}: {'OK' if ok else 'FAILED'}")
    if not ok:
        if got.shape != ref.shape:
            print(f"  shape {got.shape} != {ref.shape}", file=sys.stderr)
        else:
            err = np.abs(got - ref)
            print(f"  max abs err {np.nanmax(err):.3e}", file=sys.stderr)
    return ok


def print_timers(total: Timer, **named: Timer) -> None:
    print(f"total(ms): {total.get_elapsed_ms():.3f}")
    for name, t in named.items():
        print(f"{name}(ms): ", end="")
        t.print()
        print()


def env_info() -> str:
    from spla_tpu import get_library

    return get_library().get_accelerator_info()
