"""Library-level state: backend info, logging, global configuration.

Equivalent of the reference Library singleton (``src/library.cpp:70-93,
218-238``: accelerator selection, force-no-acceleration, message
callback, profiling dump) re-expressed for JAX: the "accelerator" is the
jax backend; ``set_force_no_acceleration`` pins computation to CPU;
``get_accelerator_info`` reports the JAX devices instead of an OpenCL
device string.  :meth:`Library.is_accelerated` is the one place in the
package that names a platform.  Logging mirrors the reference Logger +
MessageCallback (``src/core/logger.hpp:48-81``) including the ``SPLA_DEBUG``-style env
switch (``python/pyspla/bridge.py:633-672``).
"""

from __future__ import annotations

import logging
import os
import sys

import jax

__all__ = [
    "Library",
    "get_library",
    "set_message_callback",
    "log_msg",
]

_logger = logging.getLogger("spla_tpu")
if os.environ.get("SPLA_DEBUG"):
    logging.basicConfig(stream=sys.stderr, level=logging.DEBUG)

_message_callback = None


def set_message_callback(cb) -> None:
    """cb(status, msg, file, function, line) — reference MessageCallback
    signature (``include/spla/config.hpp:154-158``)."""
    global _message_callback
    _message_callback = cb


def log_msg(status, msg, file="", function="", line=0) -> None:
    if _message_callback is not None:
        _message_callback(status, msg, file, function, line)
    else:
        _logger.debug("[%s] %s", status, msg)


class Library:
    """Global runtime state (singleton via :func:`get_library`)."""

    def __init__(self):
        self.force_no_acceleration = False
        self._platform = None

    # -- accelerator control (reference library.hpp:79-132) --
    def set_force_no_acceleration(self, value: bool) -> None:
        """Pin compute to CPU (the reference backend role)."""
        self.force_no_acceleration = bool(value)
        jax.config.update("jax_platforms", "cpu" if value else self._platform)

    def set_platform(self, index: int) -> None:
        # jax exposes one platform at a time; retained for API parity
        self._platform = None

    def set_device(self, index: int) -> None:
        self._device_index = index

    def set_queues_count(self, count: int) -> None:
        # no command queues to configure; XLA streams are implicit
        self._queues = count

    def get_accelerator_info(self) -> str:
        try:
            devs = jax.devices()
        except Exception:  # pragma: no cover
            return "no accelerator"
        d = devs[0]
        return (
            f"{d.platform} x{len(devs)}: {getattr(d, 'device_kind', str(d))}"
        )

    def is_accelerated(self) -> bool:
        """True when the default JAX device is a GPU and acceleration is
        not forced off."""
        return jax.devices()[0].platform == "gpu" and not self.force_no_acceleration

    # -- profiling passthrough (reference library.cpp:184-196) --
    def set_time_profiling(self, enabled: bool) -> None:
        """Opt into profiled dispatch: facade ops open scopes AND block on
        their results so wall times mean device time (the reference's
        profiled debug dispatch, ``cl_debug.hpp:36-103``).  Off by default
        because the blocking defeats async dispatch."""
        from .profiling import profiler

        profiler.enabled = bool(enabled)

    def time_profile_dump(self) -> str:
        from .profiling import profiler

        s = profiler.dump()
        print(s, file=sys.stderr)
        return s

    def time_profile_reset(self) -> None:
        from .profiling import profiler

        profiler.reset()

    def finalize(self) -> None:
        pass


_LIB = None


def get_library() -> Library:
    global _LIB
    if _LIB is None:
        _LIB = Library()
    return _LIB
