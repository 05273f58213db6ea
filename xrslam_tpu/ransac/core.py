"""Batched-hypothesis RANSAC: sample ALL hypotheses up front, solve the
minimal problems as one vmapped batch, score with masked reductions,
pick the best — replacing the reference's sequential adaptive loop
(reference: xrslam/src/xrslam/utility/ransac.h:44-81) with a
fixed-shape computation the XLA compiler can tile.

Determinism: counter-based `jax.random` keys replace the reference's
`LotBox` LCG (utility/random.h) and its `config->random()==648` seed
(config.cpp:66) — seeds are explicit everywhere.

The adaptive iteration bound (ransac.h:72-77) is a *latency* trick for
sequential hardware; here all hypotheses evaluate in parallel, so the
static hypothesis count plays the role of max_iteration. With the
reference's defaults (confidence .999, 5-dof model, inlier ratio ≥.5)
the adaptive bound is ≈ log(1e-3)/log(1-.5^5) ≈ 218, so the default 256
hypotheses dominate it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sample_minimal(key, n_hyp: int, n_points: int, dof: int, valid=None,
                   weights=None):
    """(n_hyp, dof) index sets, sampled without replacement per
    hypothesis via Gumbel top-k; invalid points never drawn (given ≥dof
    valid points). `weights` (N,) optionally biases sampling (PARSAC
    prior confidence)."""
    g = jax.random.gumbel(key, (n_hyp, n_points))
    logw = jnp.zeros((n_points,)) if weights is None else jnp.log(
        jnp.clip(weights, 1e-20, None))
    if valid is not None:
        logw = jnp.where(valid, logw, -jnp.inf)
    _, idx = jax.lax.top_k(g + logw[None, :], dof)
    return idx


def select_best(errors: jnp.ndarray, threshold, valid=None, scores=None):
    """Score hypotheses by inlier count (or externally supplied
    `scores` (H,)) and return (best_index, best_inlier_mask (N,),
    best_count). `errors` is (H, N)."""
    inl = errors <= threshold
    if valid is not None:
        inl = inl & valid[None, :]
    counts = jnp.sum(inl, axis=-1)
    s = counts if scores is None else scores
    best = jnp.argmax(s)
    return best, inl[best], counts[best]


def ransac(key, solver, evaluator, data, n_points: int, dof: int,
           threshold, n_hyp: int = 256, valid=None, weights=None):
    """Generic batched RANSAC.

    solver(idx (dof,), *data) -> model pytree (may have a leading
      hypothesis-variants axis, e.g. the up-to-10 essential roots);
    evaluator(model, *data) -> errors (N,) (or (V, N) for variant
      models).

    Returns (model, inlier_mask (N,), inlier_count).
    """
    idx = sample_minimal(key, n_hyp, n_points, dof, valid, weights)
    models = jax.vmap(lambda i: solver(i, *data))(idx)

    def eval_one(model):
        return evaluator(model, *data)

    errors = jax.vmap(eval_one)(models)  # (H, N) or (H, V, N)
    if errors.ndim == 3:
        H, V, N = errors.shape
        errors = errors.reshape(H * V, N)
        models = jax.tree.map(lambda m: m.reshape((H * V,) + m.shape[2:]), models)
    best, mask, count = select_best(errors, threshold, valid)
    model = jax.tree.map(lambda m: m[best], models)
    return model, mask, count
