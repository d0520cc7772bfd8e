"""Connected components as label propagation (jit-compiled, static shapes).

Static-shape rebuild of the reference's explicit-stack flood fills
(suppressPartNonMax / removeSmallPieces, RTree.cpp:126-321; BGSubtractor's
ffill, BGSubtractor.cpp:10-157).  Pixels propagate the minimum flat index of
their component across gated 4-neighbor edges; a pointer-jumping pass
(label <- label[label]) after each stencil sweep makes convergence roughly
logarithmic in component diameter.  The component id of a pixel is the flat
index of its first pixel in row-major scan order — exactly the reference's
discovery order, which makes downstream "component id" semantics match.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _shift(a, dy, dx, fill):
    """Shift a 2D array, filling vacated cells."""
    return jnp.roll(a, (dy, dx), (0, 1)).at[
        _edge_slice(dy, 0)].set(fill).at[_edge_slice(dx, 1)].set(fill)


def _edge_slice(d, axis):
    if d == 0:
        return (slice(0, 0),)  # no-op
    if axis == 0:
        return (slice(0, d) if d > 0 else slice(d, None),)
    return (slice(None), slice(0, d) if d > 0 else slice(d, None))


@functools.partial(jax.jit, static_argnames=("max_iters", "edge_gate_fn"))
def connected_components(active: jnp.ndarray, edge_gate_fn=None,
                         values: jnp.ndarray | None = None,
                         max_iters: int = 64) -> jnp.ndarray:
    """Label connected components of ``active`` pixels.

    Args:
      active: [H, W] bool mask of pixels to label.
      values: optional [H, W] array; when given, edges only connect pixels
        with equal values (the part-mask CC gate of suppressPartNonMax).
      edge_gate_fn: optional fn(values, shifted_values) -> bool mask gating
        edges (used for BGSubtractor's 3D-distance gate); overrides the
        equality gate.
      max_iters: propagation sweep cap (each sweep includes pointer jumping,
        so components of diameter up to ~2^max_iters converge).

    Returns [H, W] int32 labels = flat index of the component's first pixel
    in scan order; -1 for inactive pixels.
    """
    H, W = active.shape
    flat = jnp.arange(H * W, dtype=jnp.int32).reshape(H, W)
    big = jnp.int32(H * W)
    label = jnp.where(active, flat, big)

    def gate(dy, dx):
        nb_active = _shift(active, dy, dx, False)
        ok = active & nb_active
        if values is not None:
            nb_val = _shift(values, dy, dx, jnp.zeros((), values.dtype))
            if edge_gate_fn is not None:
                ok = ok & edge_gate_fn(values, nb_val)
            else:
                ok = ok & (values == nb_val)
        return ok

    gates = [(1, 0), (-1, 0), (0, 1), (0, -1)]
    gate_masks = [gate(dy, dx) for dy, dx in gates]

    def body(state):
        label, _, it = state
        new = label
        for (dy, dx), g in zip(gates, gate_masks):
            nb = _shift(label, dy, dx, big)
            new = jnp.where(g, jnp.minimum(new, nb), new)
        # pointer doubling: labels index pixels; one rebuilt-table chase per
        # sweep (random gathers are the expensive part, so more chases per
        # sweep lose — run CC on a coarse grid instead when speed matters)
        newf = new.reshape(-1)
        pad = jnp.concatenate([newf, jnp.asarray([big], jnp.int32)])
        newf = jnp.minimum(newf, pad[jnp.minimum(newf, big)])
        new = newf.reshape(H, W)
        changed = jnp.any(new != label)
        return new, changed, it + 1

    def cond(state):
        return state[1] & (state[2] < max_iters)

    # the initial flag derives from the data so its sharding/varying type
    # matches the body output under shard_map (an unvarying literal True
    # fails the carry check); an all-background grid legitimately skips
    # the propagation loop
    label, _, _ = jax.lax.while_loop(
        cond, body, (label, jnp.any(active), jnp.asarray(0, jnp.int32)))
    return jnp.where(active, label, -1)


def component_sizes(labels: jnp.ndarray) -> jnp.ndarray:
    """Scatter-add sizes into the root-index space: [H*W] sizes (0 where not
    a root)."""
    H, W = labels.shape
    flat = labels.reshape(-1)
    idx = jnp.where(flat >= 0, flat, H * W)
    return jnp.zeros(H * W + 1, jnp.int32).at[idx].add(1)[:-1]


def component_centroids(labels: jnp.ndarray):
    """Sum of (x, y) coords per root: returns ([H*W] sum_x, [H*W] sum_y)."""
    H, W = labels.shape
    yy, xx = jnp.mgrid[0:H, 0:W]
    flat = labels.reshape(-1)
    idx = jnp.where(flat >= 0, flat, H * W)
    sx = jnp.zeros(H * W + 1, jnp.float32).at[idx].add(
        xx.reshape(-1).astype(jnp.float32))[:-1]
    sy = jnp.zeros(H * W + 1, jnp.float32).at[idx].add(
        yy.reshape(-1).astype(jnp.float32))[:-1]
    return sx, sy
