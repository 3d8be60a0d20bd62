"""Per-op tuning descriptor (reference ``include/spla/descriptor.hpp:44-83``).

Plain dataclass of kwargs: traversal direction (push / pull / adaptive
push-pull with a frontier-density threshold), early-exit and
structure-only hints.  The traversal direction (``push_only``,
``pull_only``, ``push_pull``) and ``front_factor`` are advisory: every
traversal level runs the same masked SpMV over all stored entries, so
results are identical in every mode.  ``early_exit`` is advisory too
(results are identical for the idempotent accumulators the reference
pairs it with), and ``struct_only`` selects the boolean structure-only
traversal.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

__all__ = ["Descriptor"]


@dataclass(frozen=True)
class Descriptor:
    push_only: bool = False
    pull_only: bool = False
    push_pull: bool = False
    front_factor: float = 0.1
    early_exit: bool = False
    struct_only: bool = False

    def with_(self, **kw) -> "Descriptor":
        return replace(self, **kw)

    @staticmethod
    def make(**kw) -> "Descriptor":
        return Descriptor(**kw)
