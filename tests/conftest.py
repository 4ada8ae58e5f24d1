"""Test harness configuration.

Tests run on CPU with 8 virtual XLA devices so that every multi-device
sharding path (data-parallel psum allreduce, window-axis sharding) is
exercised without GPUs — the standard JAX trick via
``--xla_force_host_platform_device_count`` (see SURVEY.md §4e).  The
platform is also pinned through ``jax.config`` in case jax was imported
before this file ran.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
