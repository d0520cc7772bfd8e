"""Exact z-buffer triangle rasterization as a jitted XLA program.

Device-side replacement for the reference's CPU painter's-algorithm scanline
rasterizer (AvatarRenderer.cpp:39-101, AvatarHelpers.cpp:62-313).  Instead of
sorting faces by depth and painting back-to-front (approximate, serial), we
compute an exact z-buffer with static shapes:

  1. every face gets a clipped integer bbox;
  2. a fixed *sample budget* S is distributed over faces proportionally to
     bbox area via an exclusive scan — budget slot s maps to (face, dx, dy)
     with one searchsorted + div/mod;
  3. each slot computes barycentric coverage for its pixel and does a
     scatter-min of a packed int32 key (quantized depth << 14 | face id)
     into the flat image.

The pack keeps everything int32 (one atomic min per fragment): 17 bits of
depth over [0, z_max] (~0.15 mm at 20 m — below sensor noise) to rank
fragments, 14 bits of face id to identify the winner.  Exact interpolated
depth is then recomputed from the winning face id in a cheap per-pixel post
pass, so the output depth is full f32 precision; quantization only affects
which face wins within 0.15 mm — tighter than the painter's algorithm it replaces.

vmap over a leading batch axis for synthetic-data generation.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

FID_BITS = 14
FID_MASK = (1 << FID_BITS) - 1
Z_BITS = 17
Z_MAX_DEFAULT = 20.0  # matches RTree BACKGROUND_DEPTH (RTree.cpp:325)
_INT_MAX = jnp.iinfo(jnp.int32).max


class RasterOutput(NamedTuple):
    fid: jnp.ndarray      # [H, W] int32 winning face id, -1 = background
    depth: jnp.ndarray    # [H, W] f32 interpolated z, 0 = background
    bary: jnp.ndarray     # [H, W, 3] f32 barycentric weights of winner
    n_dropped: jnp.ndarray  # scalar int32: slots lost to budget overflow


def project_points(cloud: jnp.ndarray, fx, fy, cx, cy) -> jnp.ndarray:
    """Pinhole projection with the avatar renderer's y-flip:
    x = X fx / Z + cx,  y = -Y fy / Z + cy  (AvatarRenderer.cpp:14-22)."""
    z = cloud[..., 2]
    return jnp.stack(
        [cloud[..., 0] * fx / z + cx, -cloud[..., 1] * fy / z + cy], axis=-1)


def _barycentric(px, py, a, b, c):
    """Barycentric weights (w_a, w_b, w_c) of pixel (px, py) wrt 2D triangle
    a, b, c — same formulation as reference AvatarHelpers.cpp:84-108."""
    denom = (b[..., 0] - c[..., 0]) * (a[..., 1] - c[..., 1]) + (
        c[..., 1] - b[..., 1]) * (a[..., 0] - c[..., 0])
    denom = jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
    w1 = ((b[..., 0] - c[..., 0]) * (py - c[..., 1]) +
          (c[..., 1] - b[..., 1]) * (px - c[..., 0])) / denom
    w2 = ((c[..., 0] - a[..., 0]) * (py - c[..., 1]) +
          (a[..., 1] - c[..., 1]) * (px - c[..., 0])) / denom
    return w1, w2, 1.0 - w1 - w2


@functools.partial(jax.jit, static_argnames=("height", "width", "budget"))
def rasterize(proj: jnp.ndarray, z: jnp.ndarray, faces: jnp.ndarray,
              height: int, width: int, budget: int,
              z_max: float = Z_MAX_DEFAULT,
              face_valid: jnp.ndarray | None = None) -> RasterOutput:
    """Exact z-buffer raster of a triangle mesh.

    Args:
      proj:  [P, 2] projected vertex positions (pixels).
      z:     [P] camera-space vertex depths (> 0 in front of camera).
      faces: [F, 3] int vertex indices (F <= 2^14 per the int32 pack).
      budget: static total sample budget S.  Choose >= sum of face bbox
        areas; overflowing faces are dropped and counted in ``n_dropped``.
      face_valid: optional [F] bool; invalid faces are skipped (used for
        degenerate/edge-on face policies).

    Returns RasterOutput with exact interpolated depth.
    """
    F = faces.shape[0]
    fa = proj[faces[:, 0]]  # [F,2]
    fb = proj[faces[:, 1]]
    fc = proj[faces[:, 2]]
    za = z[faces[:, 0]]
    zb = z[faces[:, 1]]
    zc = z[faces[:, 2]]

    in_front = (za > 1e-6) & (zb > 1e-6) & (zc > 1e-6)
    if face_valid is not None:
        in_front = in_front & face_valid

    xmin = jnp.floor(jnp.minimum(jnp.minimum(fa[:, 0], fb[:, 0]), fc[:, 0]))
    xmax = jnp.ceil(jnp.maximum(jnp.maximum(fa[:, 0], fb[:, 0]), fc[:, 0]))
    ymin = jnp.floor(jnp.minimum(jnp.minimum(fa[:, 1], fb[:, 1]), fc[:, 1]))
    ymax = jnp.ceil(jnp.maximum(jnp.maximum(fa[:, 1], fb[:, 1]), fc[:, 1]))
    x0 = jnp.clip(xmin, 0, width - 1).astype(jnp.int32)
    x1 = jnp.clip(xmax, 0, width - 1).astype(jnp.int32)
    y0 = jnp.clip(ymin, 0, height - 1).astype(jnp.int32)
    y1 = jnp.clip(ymax, 0, height - 1).astype(jnp.int32)
    offscreen = (xmax < 0) | (xmin > width - 1) | (ymax < 0) | (ymin > height - 1)
    ok = in_front & ~offscreen

    bw = jnp.where(ok, x1 - x0 + 1, 0)
    bh = jnp.where(ok, y1 - y0 + 1, 0)
    areas = (bw * bh).astype(jnp.int32)                     # [F]
    ends = jnp.cumsum(areas)                                # inclusive scan
    starts = ends - areas
    total = ends[-1]
    n_dropped = jnp.maximum(total - budget, 0)

    # Map each budget slot -> (face, dx, dy)
    s_idx = jnp.arange(budget, dtype=jnp.int32)
    face_of = jnp.searchsorted(ends, s_idx, side="right").astype(jnp.int32)
    face_of = jnp.minimum(face_of, F - 1)
    live = s_idx < total
    r = s_idx - starts[face_of]
    bw_f = jnp.maximum(bw[face_of], 1)
    dx = r % bw_f
    dy = r // bw_f
    px = x0[face_of] + dx
    py = y0[face_of] + dy

    w1, w2, w3 = _barycentric(
        px.astype(proj.dtype), py.astype(proj.dtype),
        fa[face_of], fb[face_of], fc[face_of])
    # small epsilon: count edge pixels on both sides (matches the reference's
    # floor/ceil-expanded scanlines more closely than strict > 0)
    eps = -1e-6
    inside = (w1 >= eps) & (w2 >= eps) & (w3 >= eps) & live

    zi = w1 * za[face_of] + w2 * zb[face_of] + w3 * zc[face_of]
    inside = inside & (zi > 0)
    zq = jnp.clip(zi / z_max * float(1 << Z_BITS), 1,
                  float((1 << Z_BITS) - 1)).astype(jnp.int32)
    packed = (zq << FID_BITS) | (face_of & FID_MASK)

    flat_pix = jnp.where(inside, py * width + px, height * width)
    zbuf = jnp.full(height * width + 1, _INT_MAX, jnp.int32)
    zbuf = zbuf.at[flat_pix].min(packed, mode="drop")
    zbuf = zbuf[:-1]

    hit = zbuf != _INT_MAX
    fid = jnp.where(hit, zbuf & FID_MASK, -1).reshape(height, width)

    # Post pass: exact interpolated depth + bary of the winning face
    yy = jnp.arange(height, dtype=proj.dtype)[:, None]
    xx = jnp.arange(width, dtype=proj.dtype)[None, :]
    f_safe = jnp.maximum(fid, 0)
    pa, pb, pc = fa[f_safe], fb[f_safe], fc[f_safe]
    v1, v2, v3 = _barycentric(xx, yy, pa, pb, pc)
    depth = v1 * za[f_safe] + v2 * zb[f_safe] + v3 * zc[f_safe]
    depth = jnp.where(fid >= 0, jnp.clip(depth, 0.0, z_max), 0.0)
    bary = jnp.stack([v1, v2, v3], axis=-1)
    bary = jnp.where((fid >= 0)[..., None], bary, 0.0)
    return RasterOutput(fid=fid, depth=depth.astype(proj.dtype), bary=bary,
                        n_dropped=n_dropped)


def default_budget(height: int, width: int, n_faces: int) -> int:
    """Sample budget heuristic: bbox-area sum is ~4x the covered silhouette
    (front+back faces x bbox slack); a full-frame close-up is the worst
    case.  Capped below by 8 samples/face."""
    return max(height * width, 8 * n_faces)
