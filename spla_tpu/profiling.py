"""Time profiling: hierarchical scopes + per-op wall-ms table.

Equivalent of the reference TimeProfiler (``src/profiling/
time_profiler.hpp:44-100``: static labels with parent links + atomic
nanos, RAII scopes, dump/reset) and of the OpenCL event-profiling macros
(``src/opencl/cl_debug.hpp:36-103``).  On a device, per-kernel timing
comes from ``jax.profiler`` traces; this module provides the host-side
wall-clock scope tree every backend op opens (the reference opens one per
algo, e.g. ``cl_vxm.hpp:74``), with the same dump/reset lifecycle
(``Library::time_profile_dump/reset``, ``src/library.cpp:184-196``).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import jax

__all__ = ["TimeProfiler", "profiler", "time_profile_scope"]


@dataclass
class _Label:
    name: str
    parent: str | None = None
    total_ns: int = 0
    count: int = 0


class TimeProfiler:
    def __init__(self):
        self._labels: dict[str, _Label] = {}
        self._stack = threading.local()
        # Off by default: enabled scopes block on results (device sync),
        # defeating async dispatch — the reference likewise only blocks in
        # profiled debug builds (cl_debug.hpp).  Opt in via
        # Library.set_time_profiling(True) / profiler.enabled = True.
        self.enabled = False

    def _stk(self):
        if not hasattr(self._stack, "s"):
            self._stack.s = []
        return self._stack.s

    @contextmanager
    def scope(self, name: str):
        """RAII-style scope (reference TIME_PROFILE_SCOPE macro).  Also
        opens a jax named_scope so device traces carry the same names."""
        if not self.enabled:
            yield
            return
        stk = self._stk()
        parent = stk[-1] if stk else None
        lbl = self._labels.setdefault(name, _Label(name, parent))
        stk.append(name)
        t0 = time.perf_counter_ns()
        try:
            with jax.named_scope(name.replace("/", "_")):
                yield
        finally:
            lbl.total_ns += time.perf_counter_ns() - t0
            lbl.count += 1
            stk.pop()

    def dump(self) -> str:
        """Formatted per-scope table (reference time_profile_dump)."""
        lines = ["-- time profile --"]
        roots = [l for l in self._labels.values() if l.parent is None]

        def emit(lbl, depth):
            lines.append(
                f"{'  ' * depth}{lbl.name}: {lbl.total_ns / 1e6:.3f} ms "
                f"(x{lbl.count})"
            )
            for child in self._labels.values():
                if child.parent == lbl.name:
                    emit(child, depth + 1)

        for r in roots:
            emit(r, 1)
        return "\n".join(lines)

    def reset(self):
        self._labels.clear()

    def stats(self) -> dict:
        return {
            k: {"ms": v.total_ns / 1e6, "count": v.count, "parent": v.parent}
            for k, v in self._labels.items()
        }


profiler = TimeProfiler()


def time_profile_scope(name: str):
    return profiler.scope(name)
