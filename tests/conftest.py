"""Test harness config: run on a virtual 8-device CPU mesh with f64.

Multi-chip sharding is validated on host CPU devices
(`xla_force_host_platform_device_count`), the analog of a fake
distributed backend (SURVEY.md §4).
"""

import os

# Tests run on the CPU only, whatever accelerator the machine has.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"
os.environ["JAX_ENABLE_X64"] = "1"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# the matmul precision every entry point pins (xrslam_tpu.runtime), so
# tests trace the programs users run; nothing is written to the
# persistent compile cache from test processes
jax.config.update("jax_default_matmul_precision", "highest")
jax.config.update("jax_enable_compilation_cache", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running end-to-end pipeline tests"
    )
