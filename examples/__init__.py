"""Runnable examples / CLI benchmarks.

Python equivalents of the reference example binaries (``examples/`` in the
reference: bfs, sssp, pr, tc, pi, convert — ``examples/options.hpp:34-66``):
each loads a MatrixMarket graph, runs the algorithm on the accelerator
(GPU) and on the CPU backend, validates against the sequential naive
oracle, and prints per-lap timings.

Run as modules::

    python -m examples.bfs --mtxpath graph.mtx --source 0
    python -m examples.pr  --mtxpath graph.mtx --alpha 0.85 --eps 1e-6
    python -m examples.pi  --n 1000000
    python -m examples.convert --in graph.mtx --out out.mtx --stats-only

``JAX_PLATFORMS=cpu`` runs them without an accelerator.
"""
