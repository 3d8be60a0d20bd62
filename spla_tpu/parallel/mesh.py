"""Device mesh setup.

Replaces the reference's accelerator selection (``Library::set_accelerator``
/ ``CLAccelerator`` platform+device pick, ``src/opencl/cl_accelerator.hpp:
65-131``) with a ``jax.sharding.Mesh``: the "device" is every card the
process sees.  1-D mesh over all cards.  The cards of one host are joined
all to all by NVLink, so the collectives (NCCL) cost the same between any
pair and the mesh follows the algorithm alone.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_device_mesh"]


def make_device_mesh(n_devices: int | None = None, axis: str = "d") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))
