"""Part-constrained nearest-neighbor correspondence + occlusion culling.

Rebuild of the reference's findNN (AvatarOptimizer.cpp:830-968, "invert"
mode used in production: every *data* point matches the nearest *visible
model* point with the same body-part label) and the backface occlusion cull
(AvatarOptimizer.cpp:1349-1387).

nanoflann kd-trees are replaced by a brute-force masked top-1 distance
search with static shapes, by one of two routes (``nn_route``):

  * ``find_nn_stats``: plain XLA.  The model axis is processed in chunks
    with a running (min, argmin) carried through a lax.scan; the cross term
    d . x^T is a matrix product.  It is the reference the kernel is tested
    against, and the CPU path.
  * ``find_nn_stats_planned``: both clouds sorted by part once per fit
    (``make_nn_plan``), then the part-ranged Pallas kernel of nn_pallas.py,
    which scans only the model chunks holding each data tile's parts.

Instead of returning variable-length correspondence lists (dynamic shapes),
we return *per-model-point sufficient statistics*:

    cnt[p]  = number of data points matched to model point p
    s[p]    = sum of matched data points            [P, 3]
    q       = sum of |d_n - centroid|^2 over matches (scalar)

which are all the optimizer needs to build exact Gauss-Newton normal
equations and exact costs (see gauss_newton.py) with fully static shapes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from avatar_tpu.optim.nn_pallas import CHUNK, TILE_N, UNMATCHABLE, \
    nn_argmin_ranges

# Python literal, NOT jnp.float32(...): a module-level jnp constant would
# initialize the backend at import time.
_INF = 3.0e38


def nn_route(backend: str | None = None) -> str:
    """The nearest-neighbor search the fit uses on ``backend`` (default:
    JAX's default backend): ``"triton"`` (the part-ranged Pallas kernel,
    GPU only) or ``"xla"`` (plain ``find_nn_stats``, the CPU path).  Any
    other backend is an error, not a silent fallback."""
    backend = jax.default_backend() if backend is None else backend
    if backend == "gpu":
        return "triton"
    if backend == "cpu":
        return "xla"
    raise ValueError(f"no nearest-neighbor route for backend {backend!r}")


class CorrStats(NamedTuple):
    cnt: jnp.ndarray      # [P] f32 match counts per model point
    s: jnp.ndarray        # [P, 3] sum of matched data points
    q: jnp.ndarray        # scalar: sum |d - centroid|^2 over matches
    n_matched: jnp.ndarray  # scalar: number of matched data points
    corr: jnp.ndarray     # [N] int32 model index per data point (-1 unmatched)


class NNPlan(NamedTuple):
    """Loop-invariant part-sorting plan for the part-ranged NN kernel.

    Both clouds are sorted by part label so a data tile only has to scan the
    model chunks covering its own labels.  Data labels are fixed for a whole
    fit, so the plan is built once and reused by every LM step.
    """
    dpts: jnp.ndarray     # [Nt, 3] data sorted by part (padding rows first;
    #                     N padded up to Nt, a multiple of tile_n)
    dpart: jnp.ndarray    # [Nt] sorted labels (< 0 = padding)
    mperm: jnp.ndarray | None  # [Pp] original model index per sorted slot;
    #                     None when the model axis is already part-sorted
    #                     (a part-sorted FitContext), which removes one
    #                     [P,3] + one [P] gather per LM step and the [N]
    #                     corr un-permutation gather
    mpart_s: jnp.ndarray  # [Pp] sorted model part (pad slots UNMATCHABLE)
    cstart: jnp.ndarray   # [Nt // tile_n] first model chunk per data tile
    cend: jnp.ndarray     # [Nt // tile_n] one-past-last model chunk per tile
    tile_n: int
    chunk: int


def make_nn_plan(data_pts: jnp.ndarray, data_part: jnp.ndarray,
                 model_part: jnp.ndarray, num_parts: int,
                 tile_n: int = TILE_N, chunk: int = CHUNK,
                 model_sorted: bool = False) -> NNPlan:
    """Build the part-sorting plan (one argsort of each cloud's labels).

    The data axis is padded with label -1 rows up to a multiple of
    ``tile_n``; callers that use ``plan.dpts`` / ``plan.dpart`` as their data
    cloud see the padded length.

    ``model_sorted=True`` asserts the model axis is ALREADY sorted by part
    (e.g. a part-sorted FitContext): the model permutation becomes identity
    and is dropped, so the per-step sorted-gather of the posed cloud and the
    corr un-permutation disappear from the fit loop.
    """
    P = model_part.shape[0]
    pad_n = (-data_pts.shape[0]) % tile_n
    if pad_n:
        data_pts = jnp.concatenate(
            [data_pts, jnp.zeros((pad_n, 3), data_pts.dtype)])
        data_part = jnp.concatenate(
            [data_part, jnp.full((pad_n,), -1, data_part.dtype)])
    N = data_pts.shape[0]

    order = jnp.argsort(data_part)
    dpts = data_pts[order]
    dpart = data_part[order]

    if model_sorted:
        mperm = None
        mpart_s = model_part.astype(jnp.int32)
    else:
        mperm = jnp.argsort(model_part).astype(jnp.int32)
        mpart_s = model_part[mperm].astype(jnp.int32)
    pad = (-P) % chunk
    if pad:
        # pad slots point at vertex 0 but carry an unmatchable part label
        if mperm is not None:
            mperm = jnp.concatenate([mperm, jnp.zeros((pad,), jnp.int32)])
        mpart_s = jnp.concatenate(
            [mpart_s, jnp.full((pad,), UNMATCHABLE, jnp.int32)])

    # model part -> [start, end) offsets in the sorted axis
    off = jnp.searchsorted(mpart_s[:P], jnp.arange(num_parts + 1)).astype(
        jnp.int32)
    T = N // tile_n
    dps = dpart.reshape(T, tile_n)
    p_lo = jnp.clip(dps[:, 0], 0, num_parts - 1)
    p_hi = dps[:, -1]
    p_hic = jnp.clip(p_hi, 0, num_parts - 1)
    empty = p_hi < 0  # tile is all padding
    # tiles containing WILDCARD points (label == num_parts, sorted last)
    # must scan the whole real model axis — wildcards match any part
    has_wild = p_hi >= num_parts
    n_real_chunks = (P + chunk - 1) // chunk
    cstart = jnp.where(empty, 0,
                       jnp.where(has_wild, 0, off[p_lo] // chunk)).astype(
        jnp.int32)
    cend = jnp.where(empty, 0,
                     jnp.where(has_wild, n_real_chunks,
                               (off[p_hic + 1] + chunk - 1) // chunk)).astype(
        jnp.int32)
    return NNPlan(dpts=dpts, dpart=dpart, mperm=mperm, mpart_s=mpart_s,
                  cstart=cstart, cend=cend, tile_n=tile_n, chunk=chunk)


def find_nn_stats_planned(plan: NNPlan, model_cloud: jnp.ndarray,
                          visible: jnp.ndarray,
                          with_stats: bool = False,
                          interpret: bool = False,
                          wild: int = -1000,
                          wild_gate2=None) -> CorrStats:
    """find_nn_stats over a prebuilt NNPlan (data already sorted by part),
    through the part-ranged Pallas kernel.

    Statistics come back in ORIGINAL model indexing; ``corr`` is aligned
    with the plan's sorted data order.  The fit loop re-derives
    robust-weighted statistics from ``corr`` itself, so the plain scatter
    here is skipped unless ``with_stats``.

    ``wild``: data label treated as a wildcard (matches any model part);
    ``wild_gate2``: squared distance cap for wildcard matches — label-free
    correspondences far from the model are noise, not support.
    ``interpret=True`` runs the kernel in the Pallas interpreter (the CPU
    tests' way to reach it).
    """
    P = model_cloud.shape[0]
    dtype = model_cloud.dtype
    center = jnp.mean(model_cloud, axis=0)
    if plan.mperm is None:
        pad = plan.mpart_s.shape[0] - P
        xs = model_cloud - center
        vis_s = visible
        if pad:
            xs = jnp.concatenate([xs, jnp.zeros((pad, 3), dtype)])
            vis_s = jnp.concatenate([vis_s, jnp.zeros((pad,), jnp.bool_)])
    else:
        xs = (model_cloud - center)[plan.mperm]      # sorted + recentered
        vis_s = visible[plan.mperm]
    dpts_c = plan.dpts - center
    # invisible columns become unmatchable: one label row instead of two
    mpart_vis = jnp.where(vis_s, plan.mpart_s, UNMATCHABLE)

    best_d, best_i = nn_argmin_ranges(
        dpts_c, plan.dpart, xs, mpart_vis, plan.cstart, plan.cend,
        tile_n=plan.tile_n, chunk=plan.chunk, wild=wild,
        interpret=interpret)

    matched = (best_i >= 0) & (plan.dpart >= 0)
    if wild_gate2 is not None:
        matched = matched & ((plan.dpart != wild) | (best_d <= wild_gate2))
    if plan.mperm is None:
        corr = jnp.where(matched, best_i, -1)
    else:
        corr = jnp.where(matched, plan.mperm[jnp.maximum(best_i, 0)], -1)
    wgt = matched.astype(dtype)
    if with_stats:
        idx = jnp.where(matched, corr, P)
        cnt = jnp.zeros(P + 1, dtype).at[idx].add(wgt)[:P]
        s = jnp.zeros((P + 1, 3), dtype).at[idx].add(
            plan.dpts * wgt[:, None])[:P]
        q = jnp.sum(jnp.sum(dpts_c * dpts_c, axis=-1) * wgt)
    else:
        cnt = jnp.zeros(P, dtype)
        s = jnp.zeros((P, 3), dtype)
        q = jnp.zeros((), dtype)
    return CorrStats(cnt=cnt, s=s, q=q, n_matched=jnp.sum(wgt), corr=corr)


def backface_visibility(cloud: jnp.ndarray, faces: jnp.ndarray) -> jnp.ndarray:
    """[P] bool: vertex belongs to at least one front-facing triangle.

    Reference AvatarOptimizer.cpp:1349-1387: front-facing iff
    ((p2 - p1) x (p1 - p3)).z > 1e-4.
    """
    p1 = cloud[faces[:, 0]]
    p2 = cloud[faces[:, 1]]
    p3 = cloud[faces[:, 2]]
    a = p2 - p1
    b = p1 - p3
    cz = a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]
    front = cz > 1e-4
    vis = jnp.zeros(cloud.shape[0], jnp.bool_)
    for k in range(3):
        vis = vis.at[faces[:, k]].max(front)
    return vis


@functools.partial(jax.jit, static_argnames=("chunk", "wild"))
def find_nn_stats(data_pts: jnp.ndarray, data_part: jnp.ndarray,
                  model_cloud: jnp.ndarray, model_part: jnp.ndarray,
                  visible: jnp.ndarray, chunk: int = 512,
                  wild: int = -1000, wild_gate2=None) -> CorrStats:
    """Match every valid data point to its nearest visible same-part model
    point; reduce to per-model-point sufficient statistics.  Plain XLA on
    every backend.

    Args:
      data_pts:  [N, 3] padded data cloud (padding rows arbitrary).
      data_part: [N] int32 body part per data point; < 0 marks padding.
      model_cloud: [P, 3] posed model vertices.
      model_part:  [P] int32 body part per model vertex.
      visible:     [P] bool visibility mask.
      chunk: model-axis tile size (P is padded up to a multiple internally).
    """
    N = data_pts.shape[0]
    P = model_cloud.shape[0]
    dtype = data_pts.dtype

    # Recenter both clouds before the distance computation: squared norms at
    # ~2.6 m from the camera are ~7 m^2, and the cross term's cancellation
    # would otherwise cost millimeter-scale argmins their f32 precision.
    # Recentering drops magnitudes ~35x; combined with HIGHEST precision
    # (no TF32) the argmin noise is far below sensor noise.
    center = jnp.mean(model_cloud, axis=0)
    data_pts_c = data_pts - center
    model_cloud = model_cloud - center

    pad = (-P) % chunk
    if pad:
        model_cloud = jnp.concatenate(
            [model_cloud, jnp.zeros((pad, 3), dtype)], axis=0)
        model_part = jnp.concatenate(
            [model_part, jnp.full((pad,), -2, model_part.dtype)], axis=0)
        visible = jnp.concatenate(
            [visible, jnp.zeros((pad,), jnp.bool_)], axis=0)
    Pp = model_cloud.shape[0]

    n_chunks = Pp // chunk
    mc = model_cloud.reshape(n_chunks, chunk, 3)
    mp = model_part.reshape(n_chunks, chunk)
    mv = visible.reshape(n_chunks, chunk)
    m_norm2 = jnp.sum(mc * mc, axis=-1)                 # [C, chunk]
    d_norm2c = jnp.sum(data_pts_c * data_pts_c, axis=-1)  # [N]

    def body(carry, chunk_in):
        best_d, best_i = carry
        xc, xp, xv, xn2, base = chunk_in
        # [N, chunk] squared distances via the cross term
        cross = jax.lax.dot_general(
            data_pts_c, xc, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST)
        d2 = d_norm2c[:, None] - 2.0 * cross + xn2[None, :]
        valid = ((xp[None, :] == data_part[:, None]) |
                 ((data_part[:, None] == wild) & (xp[None, :] >= 0))
                 ) & xv[None, :]
        d2 = jnp.where(valid, d2, _INF)
        cmin = jnp.min(d2, axis=1)
        carg = jnp.argmin(d2, axis=1).astype(jnp.int32) + base
        take = cmin < best_d
        return (jnp.where(take, cmin, best_d),
                jnp.where(take, carg, best_i)), None

    bases = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    init = (jnp.full((N,), _INF, jnp.float32),
            jnp.full((N,), -1, jnp.int32))
    (best_d, best_i), _ = jax.lax.scan(
        body, init, (mc, mp, mv, m_norm2, bases))

    matched = (best_i >= 0) & (data_part >= 0)
    if wild_gate2 is not None:
        matched = matched & ((data_part != wild) | (best_d <= wild_gate2))
    corr = jnp.where(matched, best_i, -1)
    wgt = matched.astype(dtype)

    # sufficient statistics (scatter-adds into the model axis)
    idx = jnp.where(matched, best_i, Pp)  # padding bucket
    cnt = jnp.zeros(Pp + 1, dtype).at[idx].add(wgt)[:P]
    s = jnp.zeros((Pp + 1, 3), dtype).at[idx].add(
        data_pts * wgt[:, None])[:P]
    q = jnp.sum(jnp.sum(data_pts_c * data_pts_c, axis=-1) * wgt)
    return CorrStats(cnt=cnt, s=s, q=q, n_matched=jnp.sum(wgt), corr=corr)
