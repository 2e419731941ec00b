"""Test configuration: force the CPU backend with 8 virtual devices (for
sharding tests) and enable float64 (validation-grade numerics).

XLA_FLAGS is read at first backend initialization, so the virtual device
count set here applies to the whole session.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "backend_optimization_level" not in flags:
    # the suite is compile-bound; O0 cuts wall time ~20 % with identical
    # assertions — correctness here is f64 allclose against independent
    # oracles, not fusion-dependent
    flags = (flags + " --xla_backend_optimization_level=0").strip()
os.environ["XLA_FLAGS"] = flags

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
