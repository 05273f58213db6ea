"""Device-mesh construction + multi-host initialization.

The reference has no distributed backend at all (SURVEY.md §2.3); this
is the scale-out layer: a (data, model) mesh where the `data` axis
shards independent sequences/windows and the `model` axis shards
landmark columns of the BA system. Every device reaches every other
(NVLink on one host), so the mesh shape follows the algorithm alone;
multi-host runs initialize `jax.distributed`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(n_devices: Optional[int] = None,
              shape: Optional[Tuple[int, int]] = None,
              devices=None) -> Mesh:
    """(data, model) mesh over the first `n_devices` devices. Default
    shape puts as much as possible on `data` (sequence throughput) with
    `model` = 2 when the count allows — callers solving single large
    windows should pass an explicit model-heavy shape."""
    devs = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if shape is None:
        shape = (n // 2, 2) if (n % 2 == 0 and n >= 4) else (n, 1)
    assert shape[0] * shape[1] == n, (shape, n)
    return Mesh(np.array(devs).reshape(shape), (DATA_AXIS, MODEL_AXIS))


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host initialization — jax.distributed. No-op when
    the process is already initialized; any real rendezvous failure
    propagates (a silently-single-host "distributed" run would compute
    wrong psums, so failing loud is the only safe behavior).

    On a CPU-only platform, cross-process collectives need jaxlib's
    gloo implementation; select it before the backend is instantiated."""
    # NB: inspect the *config* (not jax.default_backend(), which would
    # instantiate the backend before jax.distributed.initialize runs)
    platforms = str(jax.config.jax_platforms or "")
    if platforms.split(",") == ["cpu"]:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    try:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError as e:
        if "already initialized" not in str(e).lower():
            raise


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def data_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Leading axis over the data axis, rest replicated."""
    return NamedSharding(mesh, P(DATA_AXIS, *([None] * (ndim - 1))))
