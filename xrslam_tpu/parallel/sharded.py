"""Distributed sliding-window BA: landmark-column sharding + data
parallelism via shard_map.

The reference solves its BA single-threaded through Ceres SPARSE_SCHUR
(reference: xrslam/src/xrslam/estimation/solver.cpp:176-190) and has no
distributed path (SURVEY.md §2.3). Here the same Gauss-Newton/Schur
math (estimation/solver.py) runs SPMD:

  - `model` mesh axis: landmark columns of the system are sharded;
    each device assembles the reprojection normal equations for its
    landmark shard, the frame-block Hessian/gradient and the Schur
    reduction term Hfl·Hll⁻¹·Hflᵀ are psum-reduced over the mesh, the tiny
    reduced (K·15)² camera solve is replicated, and landmark
    back-substitution stays shard-local (zero communication).
  - `data` mesh axis: independent windows (multi-sequence evaluation,
    the EuRoC 11-sequence sweep) shard over the leading batch axis.

Entry points:
  solve_window_sharded(mesh, state, data, opts)    — one window
  solve_batch_sharded(mesh, states, datas, opts)   — batch of windows
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..estimation.solver import SolveOptions, solve_window_core
from ..estimation.window import MargPrior, WindowData, WindowState
from .mesh import DATA_AXIS, MODEL_AXIS


def state_pspec(batch: bool = False) -> WindowState:
    """PartitionSpec pytree for a WindowState: frames replicated,
    inverse depths sharded over the model axis."""
    lead = (DATA_AXIS,) if batch else ()
    r = P(*lead)
    return WindowState(q=r, p=r, v=r, bg=r, ba=r,
                       inv_depth=P(*lead, MODEL_AXIS))


def data_pspec(data: WindowData, batch: bool = False) -> WindowData:
    """PartitionSpec pytree for WindowData: landmark-indexed leaves
    shard over the model axis, frame-indexed leaves replicate."""
    lead = (DATA_AXIS,) if batch else ()
    r = P(*lead)
    preint_spec = jax.tree.map(lambda _: r, data.preint)
    return WindowData(
        q_bc=r, p_bc=r, q_bi=r, p_bi=r,
        bearings=P(*lead, None, MODEL_AXIS, None),
        obs_mask=P(*lead, None, MODEL_AXIS),
        ref_idx=P(*lead, MODEL_AXIS),
        sqrt_inv_cov2=r,
        preint=preint_spec, preint_mask=r, bg_lin=r, ba_lin=r,
        frame_mask=r, fix_pose=r, fix_motion=r,
        landmark_mask=P(*lead, MODEL_AXIS),
        fix_landmark=P(*lead, MODEL_AXIS),
        marg=MargPrior(sqrt_inv_cov=r, infovec=r, lin=state_pspec(batch)),
        use_marg=r,
    )


def _info_pspec(batch: bool = False):
    r = P(DATA_AXIS) if batch else P()
    return {"cost0": r, "cost": r, "cost_history": r, "lambda": r}


def shard_window(mesh, state: WindowState, data: WindowData):
    """Place a (state, data) pair onto the mesh with the solver's
    shardings (explicit device_put so the jitted solve does zero
    re-layout)."""
    s_sh = jax.tree.map(lambda sp: NamedSharding(mesh, sp), state_pspec(),
                        is_leaf=lambda x: isinstance(x, P))
    d_sh = jax.tree.map(lambda sp: NamedSharding(mesh, sp), data_pspec(data),
                        is_leaf=lambda x: isinstance(x, P))
    return jax.device_put(state, s_sh), jax.device_put(data, d_sh)


@partial(jax.jit, static_argnames=("opts", "mesh"))
def solve_window_sharded(mesh, state: WindowState, data: WindowData,
                         opts: SolveOptions = SolveOptions()):
    """One window, landmark columns sharded over the mesh's model axis.
    L must divide the model-axis size. Returns (state, info) with the
    input shardings preserved."""
    fn = jax.shard_map(
        lambda s, d: solve_window_core(s, d, opts, axis_name=MODEL_AXIS),
        mesh=mesh,
        in_specs=(state_pspec(), data_pspec(data)),
        out_specs=(state_pspec(), _info_pspec()),
    )
    return fn(state, data)


@partial(jax.jit, static_argnames=("opts", "mesh"))
def solve_batch_sharded(mesh, states: WindowState, datas: WindowData,
                        opts: SolveOptions = SolveOptions()):
    """Batch of independent windows (leading axis): batch shards over
    the data axis, landmarks over the model axis — the full 2D-mesh
    deployment (data-parallel sequences × model-parallel Schur)."""

    def local(s, d):
        return jax.vmap(
            lambda si, di: solve_window_core(si, di, opts,
                                             axis_name=MODEL_AXIS)
        )(s, d)

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(state_pspec(True), data_pspec(datas, True)),
        out_specs=(state_pspec(True), _info_pspec(True)),
    )
    return fn(states, datas)
