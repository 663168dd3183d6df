"""Test configuration.

Tests always run on CPU-jax with x64 enabled — numeric assertions are
against complex128 oracles, and sharding tests use a host-emulated 8-device
CPU mesh (the standard way to exercise pjit/shard_map collectives without
several accelerators).  The platform is pinned through jax.config before
any backend initialises; the GPU path is exercised by chip_smoke.py and
bench.py in a process of their own.
"""
import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
