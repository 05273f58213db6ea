"""Process-wide JAX settings shared by every entry point.

`configure()` is called by `api.XRSLAM`, `tools.run_dataset.main`,
`bench.py`, `bench_pipeline.py` and `chip_smoke.py`. It is idempotent.
"""

from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a fixed path: the directory is part of the cache key, so a path that
# moved between runs (a temporary name, a pid, a time) would never hit
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def configure() -> str:
    """Pin the process's compile cache and matmul precision.

    - Compile cache: `JAX_COMPILATION_CACHE_DIR` wins when set (JAX
      reads it itself and nothing else is set); otherwise the cache
      lives in `<repo>/.jax_cache`.
    - Matmul precision: f32 matrix products run at full f32 precision
      ("highest"). On GPUs the default may multiply in TF32 (~10
      mantissa bits), which the window solve, marginalization and the
      RANSAC/IMU linear algebra cannot afford in an f32 drive.

    Returns the compile-cache directory in use."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_default_matmul_precision", "highest")
    return jax.config.jax_compilation_cache_dir
