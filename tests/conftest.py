"""Test configuration: CPU backend, 8 virtual devices, float64 parity mode.

The reference test-suite runs single-process on CPU in float64
(SURVEY §4).  We mirror that for bit-level parity, and additionally force
8 virtual CPU devices so multi-device sharding / halo-exchange paths can be
exercised without several GPUs (the standard JAX "fake backend" for
sharding tests).

``JAX_PLATFORMS`` picks another platform when it is set: the tests marked
``gpu`` run on the card with ``JAX_PLATFORMS=cuda``.

The persistent compile cache is off for the test session, so CPU
executables compiled here never land in the checkout's cache directory
(which a copy of the checkout carries to the machine with the card).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_enable_compilation_cache", False)
