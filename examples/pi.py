"""Monte-Carlo pi — user-defined op demo (reference ``examples/pi.cpp``).

The reference registers a custom ``OpUnary`` carrying both an OpenCL C
source string and a host lambda (``examples/pi.cpp:55-67``).  Here a user
op is ONE plain jax-traceable Python function — it runs on CPU and is
traced into the accelerator program, no dual-source needed.  The op hashes its
input seed into two uniforms and tests the unit circle.
"""

from __future__ import annotations

import argparse
import sys
import time

import jax.numpy as jnp

from spla_tpu import INT
from spla_tpu.facade import Vector
from spla_tpu.op import OpUnary, PLUS_INT


def is_in_unit_circle_fn(seed):
    """seed:int32 -> 1 if a hashed sample lands in the unit circle."""

    def fmix32(v):  # murmur3 finalizer: uniform avalanche mixing
        v = v ^ (v >> 16)
        v = v * jnp.uint32(0x85EBCA6B)
        v = v ^ (v >> 13)
        v = v * jnp.uint32(0xC2B2AE35)
        return v ^ (v >> 16)

    u = seed.astype(jnp.uint32)
    a = fmix32(u)
    b = fmix32(u ^ jnp.uint32(0x9E3779B9))
    # 24 high bits -> [-1, 1)
    x = (a >> 8).astype(jnp.float32) / (1 << 23) - 1.0
    y = (b >> 8).astype(jnp.float32) / (1 << 23) - 1.0
    return (x * x + y * y <= 1.0).astype(jnp.int32)


def run(argv=None) -> int:
    p = argparse.ArgumentParser("pi", description="compute pi with monte-carlo and spla_tpu")
    p.add_argument("--n", type=int, default=1_000_000, help="number of samples")
    p.add_argument("--cpu", action="store_true", help="force cpu backend")
    args = p.parse_args(argv)

    is_in_unit_circle = OpUnary.make("is_in_unit_circle", INT, is_in_unit_circle_fn)

    gen = Vector.dense((args.n,), INT)
    gen.fill_noize(seed=int(time.time()))

    if args.cpu:
        from spla_tpu import get_library

        get_library().set_force_no_acceleration(True)

    samples = gen.map(is_in_unit_circle)
    count = samples.reduce(PLUS_INT)

    pi = 4.0 * float(count.get()) / float(args.n)
    print(f"Pi is roughly {pi}")
    return 0


if __name__ == "__main__":
    from spla_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    sys.exit(run())
