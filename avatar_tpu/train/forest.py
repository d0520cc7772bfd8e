"""Random-forest training on the device (breadth-first, tensorized).

Rebuild of the reference's three trainer generations (RTree.cpp:551-2948).
The reference's production path is AvatarTrainerV3 (recursive, node at a
time, histogram-bucket threshold search, all rendered frames held in RAM as
run-length images).  This redesign adopts the *breadth-first frontier*
formulation of TrainerV2 (RTree.cpp:1396-2335) — already "tensor-shaped"
(its count tensors are Eigen::Tensor<float,4>) — and keeps V3's
histogram-bucket threshold search (optimalInformationGain3,
RTree.cpp:2782-2850):

  per level, per frontier-node chunk:
    pass 1: feature scores of every (sample, feature) -> segment min/max
    pass 2: bucket scores into T bins -> scatter-add counts
            [node, feature, bucket, part]
    gains:  entropy sweep over bucket prefix sums (one fused jnp program)
    split:  best (feature, threshold) per node; samples reassigned by one
            more scoring pass

Synthetic frames render on the fly (deterministically from image id, like
V3's xorKey resume trick, RTree.cpp:447-540) and are optionally cached in
HBM.  Multi-chip: image batches shard over a device mesh and the min/max /
count scatters reduce with pmin/pmax/psum — the exact analogue of the
reference's per-thread accumulate-then-mutex-reduce (RTree.cpp:1700-1704).

Checkpoint/resume: the full trainer state (tree arrays, per-sample node
assignment, level index) saves as an npz via atomic rename every level and
on SIGINT (the reference's RTREE_V2/RTREE_V3 panic-save, RTree.cpp:2950-2957),
"""

from __future__ import annotations

import functools
import os
import signal
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from avatar_tpu.io import formats
from avatar_tpu.train import synth

BACKGROUND_DEPTH = 20.0


@functools.partial(jax.jit, donate_argnums=(0,))
def _cache_write(cache: jnp.ndarray, slab: jnp.ndarray,
                 start: jnp.ndarray) -> jnp.ndarray:
    """In-place fill of one batch slab into the preallocated uint16-mm
    frame cache.  Donating the cache keeps peak HBM at one cache copy —
    a list-of-chunks + concatenate peaks at 2x (15 GB at 4096x720x1280),
    which OOMs a 16 GB chip."""
    return jax.lax.dynamic_update_slice(cache, slab, (start, 0, 0))


class Samples(NamedTuple):
    """Per-image fixed-size pixel samples ([N_img, S] each)."""
    x: jnp.ndarray      # int32
    y: jnp.ndarray      # int32
    part: jnp.ndarray   # int32 (ground-truth body part)
    valid: jnp.ndarray  # bool


# ---------------------------------------------------------------------------
# jitted level passes
# ---------------------------------------------------------------------------


def _feature_scores(depth, sx, sy, valid, fu, fv, node_local=None):
    """Depth-probe scores for every (sample, feature).

    depth [B,H,W]; sx/sy/valid [B,S]; fu/fv either [F,2] (feature pool
    shared by all nodes) or [NC,F,2] (per-node feature sets selected by the
    TrainerV2 filter stage, gathered through node_local [B,S]) ->
    scores [B,S,F].  Probe semantics: getDepth with image bounds
    (RTree.cpp:40-68).
    """
    B, H, W = depth.shape
    flat = depth.reshape(B, H * W)
    z = jnp.take_along_axis(flat, (sy * W + sx), axis=1)       # [B,S]
    z = jnp.where(valid & (z > 0), z, 1.0)

    def probe(off):  # off [B,S,F,2]
        px = sx[..., None] + off[..., 0]
        py = sy[..., None] + off[..., 1]
        inside = (px >= 0) & (px < W) & (py >= 0) & (py < H)
        idx = jnp.clip(py * W + px, 0, H * W - 1)
        pz = jnp.take_along_axis(flat, idx.reshape(B, -1),
                                 axis=1).reshape(idx.shape)
        pz = jnp.where(pz == 0.0, BACKGROUND_DEPTH, pz)
        return jnp.where(inside, pz, BACKGROUND_DEPTH)

    if fu.ndim == 3:
        nl = jnp.clip(node_local, 0, fu.shape[0] - 1)          # [B,S]
        fu_s = fu[nl]                                          # [B,S,F,2]
        fv_s = fv[nl]
    else:
        fu_s = fu[None, None]
        fv_s = fv[None, None]
    u_off = jnp.round(fu_s / z[..., None, None]).astype(jnp.int32)
    v_off = jnp.round(fv_s / z[..., None, None]).astype(jnp.int32)
    return probe(u_off) - probe(v_off)                          # [B,S,F]


@functools.partial(jax.jit, static_argnames=("n_chunk",))
def pass_minmax(depth, sx, sy, valid, node_local, fu, fv, n_chunk: int):
    """Per (chunk-node, feature) score min/max for one image batch.

    fu/fv: [F,2] shared pool or [NC,F,2] per-node feature sets.
    """
    F = fu.shape[-2]
    s = _feature_scores(depth, sx, sy, valid, fu, fv, node_local)  # [B,S,F]
    in_chunk = (node_local >= 0) & valid
    nl = jnp.where(in_chunk, node_local, n_chunk)
    idx = (nl[..., None] * F + jnp.arange(F)[None, None]).reshape(-1)
    sf = s.reshape(-1)
    big = jnp.float32(3e38)
    sf_min = jnp.where(in_chunk[..., None], s, big).reshape(-1)
    sf_max = jnp.where(in_chunk[..., None], s, -big).reshape(-1)
    smin = jnp.full((n_chunk + 1) * F, big).at[idx].min(sf_min)
    smax = jnp.full((n_chunk + 1) * F, -big).at[idx].max(sf_max)
    return (smin[: n_chunk * F].reshape(n_chunk, F),
            smax[: n_chunk * F].reshape(n_chunk, F))


@functools.partial(jax.jit, static_argnames=("n_chunk", "n_buckets",
                                             "n_parts"))
def pass_counts(depth, sx, sy, part, valid, node_local, fu, fv, smin, smax,
                n_chunk: int, n_buckets: int, n_parts: int):
    """Histogram counts [n_chunk, F, n_buckets, n_parts] for one batch.

    fu/fv: [F,2] shared pool or [NC,F,2] per-node feature sets.
    """
    F = fu.shape[-2]
    s = _feature_scores(depth, sx, sy, valid, fu, fv, node_local)  # [B,S,F]
    in_chunk = (node_local >= 0) & valid
    nl = jnp.where(in_chunk, node_local, n_chunk)
    rng = smax - smin                                           # [NC,F]
    nl_safe = jnp.minimum(nl, n_chunk - 1)
    mn = smin[nl_safe]                                          # [B,S,F]
    rg = rng[nl_safe]
    bucket = jnp.clip(((s - mn) / jnp.maximum(rg, 1e-6) *
                       n_buckets).astype(jnp.int32), 0, n_buckets - 1)
    f_ids = jnp.arange(F, dtype=jnp.int32)[None, None]
    idx = ((nl[..., None] * F + f_ids) * n_buckets + bucket) * n_parts + \
        part[..., None]
    idx = jnp.where(in_chunk[..., None], idx,
                    n_chunk * F * n_buckets * n_parts)
    counts = jnp.zeros(n_chunk * F * n_buckets * n_parts + 1, jnp.float32)
    counts = counts.at[idx.reshape(-1)].add(1.0)
    return counts[:-1].reshape(n_chunk, F, n_buckets, n_parts)


@functools.partial(jax.jit, static_argnames=())
def pass_assign(depth, sx, sy, valid, node, best_u, best_v, best_thresh,
                lchild, rchild, is_split):
    """Reassign samples to children through their node's chosen split.

    node [B,S] global node ids; best_* indexed by global node id.
    """
    fu = best_u[node]                                           # [B,S,2]
    fv = best_v[node]
    th = best_thresh[node]
    B, H, W = depth.shape
    flat = depth.reshape(B, H * W)
    z = jnp.take_along_axis(flat, (sy * W + sx), axis=1)
    z = jnp.where(valid & (z > 0), z, 1.0)

    def probe(off):
        px = sx + off[..., 0]
        py = sy + off[..., 1]
        inside = (px >= 0) & (px < W) & (py >= 0) & (py < H)
        idx = jnp.clip(py * W + px, 0, H * W - 1)
        pz = jnp.take_along_axis(flat, idx, axis=1)
        pz = jnp.where(pz == 0.0, BACKGROUND_DEPTH, pz)
        return jnp.where(inside, pz, BACKGROUND_DEPTH)

    u_off = jnp.round(fu / z[..., None]).astype(jnp.int32)
    v_off = jnp.round(fv / z[..., None]).astype(jnp.int32)
    s = probe(u_off) - probe(v_off)
    child = jnp.where(s < th, lchild[node], rchild[node])
    return jnp.where(is_split[node] & valid, child, node)


@functools.partial(jax.jit, static_argnames=("S", "num_parts"))
def sample_pixels_device(depth, mask, S: int, num_parts: int, balance,
                         key):
    """Weighted foreground pixel sampling fully on device.

    Gumbel top-k draws S pixels per image without replacement from the
    blended uniform/inverse-part-frequency distribution of _sample_pixels
    (so no [B,H,W] frame ever crosses the host link during sample init).
    Returns (x, y, part, valid), each [B, S].
    """
    B, H, W = depth.shape
    fg = (mask != 255) & (depth > 0)
    lab = jnp.where(fg, mask, num_parts).astype(jnp.int32).reshape(B, -1)
    b_idx = jnp.arange(B, dtype=jnp.int32)[:, None]
    cnt = jnp.zeros((B, num_parts + 1), jnp.float32).at[
        b_idx, lab].add(1.0)                             # [B, P+1]
    n_fg = jnp.sum(cnt[:, :num_parts], axis=1)           # [B]
    present = (cnt[:, :num_parts] > 0).astype(jnp.float32)
    n_present = jnp.maximum(jnp.sum(present, axis=1), 1.0)
    inv = jnp.where(cnt[:, :num_parts] > 0, 1.0 / cnt[:, :num_parts], 0.0)
    inv = jnp.concatenate([inv, jnp.zeros((B, 1))], axis=1)
    w = ((1.0 - balance) / jnp.maximum(n_fg, 1.0)[:, None] +
         balance * jnp.take_along_axis(inv, lab, axis=1) /
         n_present[:, None])                              # [B, HW]
    logw = jnp.where(fg.reshape(B, -1), jnp.log(jnp.maximum(w, 1e-30)),
                     -jnp.inf)
    g = -jnp.log(-jnp.log(
        jax.random.uniform(key, logw.shape, minval=1e-10, maxval=1.0)))
    _, idx = jax.lax.top_k(logw + g, S)                   # [B, S]
    x = (idx % W).astype(jnp.int32)
    y = (idx // W).astype(jnp.int32)
    part = jnp.take_along_axis(mask.reshape(B, -1), idx,
                               axis=1).astype(jnp.int32)
    valid = jnp.take_along_axis(fg.reshape(B, -1), idx, axis=1)
    # images with fewer foreground pixels than S still get S indices from
    # top_k (-inf rows): gate on the gathered fg mask and zero the part so
    # downstream scatter indices stay in range
    part = jnp.where(valid, part, 0)
    return x, y, part, valid


# ---------------------------------------------------------------------------
# sample-major ("flat") level passes
#
# The batch-major passes above scan every cached image for every node chunk,
# so a level with C chunks costs C full sweeps even though each sample
# belongs to exactly one chunk.  The flat passes instead gather the chunk's
# LIVE samples (host-selected positions into the [N_img, S] sample arrays)
# and probe the flattened HBM frame cache directly: per-level cost is
# live_samples x features, independent of frontier size — the deep levels
# that dominate a depth-17+ tree cost the same as level 0.  Counts are
# integer-valued f32 scatter-adds, so flat and batch-major dense passes
# produce bitwise-identical histograms (addition of exact integers is
# order-independent), hence identical split decisions.
# ---------------------------------------------------------------------------


def _flat_scores(cache_flat, H: int, W: int, pos, sx, sy, live, fu, fv):
    """Depth-probe scores for selected samples: [M, F].

    cache_flat: [N_img*H*W] uint16 millimeters (or f32 meters); pos [M]
    flat image index (sample's image id * H*W); sx/sy [M]; live [M] bool;
    fu/fv [F,2] shared pool or [NC,F,2] per-node sets gathered through
    node_local (pass node_local via ``live``'s companion below).
    """
    HW = H * W

    def rd(idx):
        v = cache_flat[idx]
        if v.dtype == jnp.uint16:
            v = v.astype(jnp.float32) * 1e-3
        return v

    z = rd(pos + sy * W + sx)                                   # [M]
    z = jnp.where(live & (z > 0), z, 1.0)

    def probe(off):                                             # [M,F,2]
        px = sx[:, None] + off[..., 0]
        py = sy[:, None] + off[..., 1]
        inside = (px >= 0) & (px < W) & (py >= 0) & (py < H)
        idx = pos[:, None] + jnp.clip(py * W + px, 0, HW - 1)
        pz = rd(idx)
        pz = jnp.where(pz == 0.0, BACKGROUND_DEPTH, pz)
        return jnp.where(inside, pz, BACKGROUND_DEPTH)

    u_off = jnp.round(fu / z[:, None, None]).astype(jnp.int32)
    v_off = jnp.round(fv / z[:, None, None]).astype(jnp.int32)
    return probe(u_off) - probe(v_off)                          # [M,F]


@functools.partial(jax.jit, static_argnames=("H", "W", "n_chunk"))
def pass_minmax_flat(cache_flat, pos, sx, sy, node_local, fu, fv,
                     H: int, W: int, n_chunk: int):
    """Per (chunk-node, feature) score min/max over selected samples."""
    F = fu.shape[-2]
    live = node_local >= 0
    if fu.ndim == 3:
        nl = jnp.clip(node_local, 0, fu.shape[0] - 1)
        fu = fu[nl]                                             # [M,F,2]
        fv = fv[nl]
    s = _flat_scores(cache_flat, H, W, pos, sx, sy, live, fu, fv)
    nl = jnp.where(live, node_local, n_chunk)
    idx = (nl[:, None] * F + jnp.arange(F)[None]).reshape(-1)
    big = jnp.float32(3e38)
    s_min = jnp.where(live[:, None], s, big).reshape(-1)
    s_max = jnp.where(live[:, None], s, -big).reshape(-1)
    smin = jnp.full((n_chunk + 1) * F, big).at[idx].min(s_min)
    smax = jnp.full((n_chunk + 1) * F, -big).at[idx].max(s_max)
    return (smin[: n_chunk * F].reshape(n_chunk, F),
            smax[: n_chunk * F].reshape(n_chunk, F))


@functools.partial(jax.jit, static_argnames=("H", "W", "n_chunk",
                                             "n_buckets", "n_parts"))
def pass_counts_flat(cache_flat, pos, sx, sy, part, node_local, fu, fv,
                     smin, smax, H: int, W: int, n_chunk: int,
                     n_buckets: int, n_parts: int):
    """Histogram counts [n_chunk, F, n_buckets, n_parts] over selected
    samples."""
    F = fu.shape[-2]
    live = node_local >= 0
    if fu.ndim == 3:
        nlc = jnp.clip(node_local, 0, fu.shape[0] - 1)
        fu = fu[nlc]
        fv = fv[nlc]
    s = _flat_scores(cache_flat, H, W, pos, sx, sy, live, fu, fv)
    nl = jnp.where(live, node_local, n_chunk)
    nl_safe = jnp.minimum(nl, n_chunk - 1)
    mn = smin[nl_safe]                                          # [M,F]
    rg = (smax - smin)[nl_safe]
    bucket = jnp.clip(((s - mn) / jnp.maximum(rg, 1e-6) *
                       n_buckets).astype(jnp.int32), 0, n_buckets - 1)
    f_ids = jnp.arange(F, dtype=jnp.int32)[None]
    idx = ((nl[:, None] * F + f_ids) * n_buckets + bucket) * n_parts + \
        part[:, None]
    idx = jnp.where(live[:, None], idx, n_chunk * F * n_buckets * n_parts)
    counts = jnp.zeros(n_chunk * F * n_buckets * n_parts + 1, jnp.float32)
    counts = counts.at[idx.reshape(-1)].add(1.0)
    return counts[:-1].reshape(n_chunk, F, n_buckets, n_parts)


@functools.partial(jax.jit, static_argnames=("H", "W"))
def pass_assign_flat(cache_flat, pos, sx, sy, node, best_u, best_v,
                     best_thresh, lchild, rchild, is_split,
                     H: int, W: int):
    """Route selected samples through their node's chosen split: [M]."""
    nd = jnp.maximum(node, 0)
    fu = best_u[nd][:, None]                                    # [M,1,2]
    fv = best_v[nd][:, None]
    live = node >= 0
    s = _flat_scores(cache_flat, H, W, pos, sx, sy, live, fu, fv)[:, 0]
    child = jnp.where(s < best_thresh[nd], lchild[nd], rchild[nd])
    return jnp.where(is_split[nd] & live, child, node)


@functools.partial(jax.jit, static_argnames=("n_buckets",))
def split_decide(counts, smin, smax, n_buckets: int):
    """Per-node best split, fully on device.

    Downloading the full [NC, F, T, P] count tensor to pick one (feature,
    threshold) per node costs ~400 MB of link traffic per sweep at
    node_chunk 4096; this reduces it to a handful of [NC]-sized vectors.
    Returns (gain, f_best, thresh, score_range, n, part_hist).
    """
    gains, _ = split_gains(counts)                              # [NC,F,T-1]
    NC, F, Tm1 = gains.shape
    flat = gains.reshape(NC, F * Tm1)
    best = jnp.argmax(flat, axis=1)
    gain = jnp.take_along_axis(flat, best[:, None], 1)[:, 0]
    f_best = (best // Tm1).astype(jnp.int32)
    t_best = (best % Tm1).astype(jnp.int32)
    mn = jnp.take_along_axis(smin, f_best[:, None], 1)[:, 0]
    mx = jnp.take_along_axis(smax, f_best[:, None], 1)[:, 0]
    thresh = mn + (mx - mn) * (t_best + 1).astype(jnp.float32) / n_buckets
    part_hist = counts.sum(axis=(1, 2)) / F                     # [NC,P]
    n = part_hist.sum(axis=1)
    return gain, f_best, thresh, mx - mn, n, part_hist


@functools.partial(jax.jit, static_argnames=())
def split_gains(counts):
    """Entropy info gain over bucket prefix sums.

    counts [NC, F, T, P] -> (gains [NC, F, T-1], totals [NC, P]).
    Matches optimalInformationGain3's sweep (RTree.cpp:2782-2850): candidate
    thresholds are the T-1 bucket boundaries; gain is the (unnormalized)
    reduction n*H(total) - nl*H(l) - nr*H(r).
    """
    left = jnp.cumsum(counts, axis=2)[:, :, :-1]                # [NC,F,T-1,P]
    total = jnp.sum(counts, axis=2)                             # [NC,F,P]
    right = total[:, :, None] - left

    def ent(c):  # unnormalized: n*H = n log n - sum c log c
        n = jnp.sum(c, -1)
        return n * jnp.log(jnp.maximum(n, 1e-12)) - jnp.sum(
            c * jnp.log(jnp.maximum(c, 1e-12)), -1)

    gains = ent(total[:, :, None]) - ent(left) - ent(right)
    return gains, total[:, 0]                                   # totals same per f


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------


class _TreeBuilder:
    """Host-side growing node arrays."""

    def __init__(self, num_parts: int):
        self.u = []
        self.v = []
        self.thresh = []
        self.lnode = []
        self.rnode = []
        self.leafid = []
        self.leaf_data = []
        self.num_parts = num_parts

    def add_node(self) -> int:
        self.u.append((0.0, 0.0))
        self.v.append((0.0, 0.0))
        self.thresh.append(0.0)
        self.lnode.append(-1)
        self.rnode.append(-1)
        self.leafid.append(-1)
        return len(self.thresh) - 1

    def make_leaf(self, nid: int, dist: np.ndarray) -> None:
        tot = dist.sum()
        self.leaf_data.append(dist / tot if tot > 0 else
                              np.full_like(dist, 1.0 / len(dist)))
        self.leafid[nid] = len(self.leaf_data) - 1

    def make_split(self, nid: int, u, v, thresh) -> Tuple[int, int]:
        self.u[nid] = tuple(np.asarray(u, np.float64))
        self.v[nid] = tuple(np.asarray(v, np.float64))
        self.thresh[nid] = float(thresh)
        l = self.add_node()
        r = self.add_node()
        self.lnode[nid] = l
        self.rnode[nid] = r
        return l, r

    def to_forest(self) -> formats.ForestData:
        n = len(self.thresh)
        leaf_data = (np.stack(self.leaf_data) if self.leaf_data
                     else np.zeros((0, self.num_parts), np.float32))
        return formats.ForestData(
            np.asarray(self.u, np.float32).reshape(n, 2),
            np.asarray(self.v, np.float32).reshape(n, 2),
            np.asarray(self.thresh, np.float32),
            np.asarray(self.lnode, np.int32),
            np.asarray(self.rnode, np.int32),
            np.asarray(self.leafid, np.int32),
            leaf_data.astype(np.float32), self.num_parts)


def _sample_pixels(depth: np.ndarray, mask: np.ndarray, S: int,
                   rng: np.random.Generator,
                   balance: float = 0.5) -> Tuple[np.ndarray, ...]:
    """Choose up to S foreground pixels of one rendered frame.

    ``balance`` blends uniform-over-foreground sampling (0.0, the
    reference's strategy) with equal-per-part sampling (1.0).  Small parts
    (hands, feet) cover <1% of foreground pixels; uniformly sampled trees
    never accumulate enough of their samples to split them out and score
    ~0% recall on extremities — exactly the parts the tracker needs most.
    """
    fg = (mask != 255) & (depth > 0)
    ys, xs = np.nonzero(fg)
    n = len(ys)
    if n == 0:
        z = np.zeros(S, np.int32)
        return z, z, z, np.zeros(S, bool)
    labels = mask[ys, xs].astype(np.int64)
    parts, counts = np.unique(labels, return_counts=True)
    # per-pixel weight: (1-b) * uniform + b * (1 / part frequency)
    inv = 1.0 / counts.astype(np.float64)
    wmap = {p: (1.0 - balance) / n + balance * inv[i] / len(parts)
            for i, p in enumerate(parts)}
    w = np.asarray([wmap[l] for l in labels])
    w /= w.sum()
    take = min(S, n)
    idx = rng.choice(n, size=take, replace=False, p=w)
    x = np.zeros(S, np.int32)
    y = np.zeros(S, np.int32)
    p = np.zeros(S, np.int32)
    val = np.zeros(S, bool)
    x[:take] = xs[idx]
    y[:take] = ys[idx]
    p[:take] = mask[ys[idx], xs[idx]]
    val[:take] = True
    return x, y, p, val


class FileFrameSource:
    """Depth + part-mask frame pairs read from two directories.

    Rebuild of the reference's FileDataSource (RTree.cpp:351-420): both
    directories are listed and sorted; pair i is (depth_paths[i],
    mask_paths[i]).  Depth frames may be .exr / .depth (formats.read_depth)
    or any OpenCV-readable image (integer images are taken as millimeters);
    part masks are 8-bit grayscale with 255 = background.
    """

    def __init__(self, depth_dir: str, part_mask_dir: str):
        self.depth_paths = sorted(
            os.path.join(depth_dir, f) for f in os.listdir(depth_dir))
        self.mask_paths = sorted(
            os.path.join(part_mask_dir, f) for f in os.listdir(part_mask_dir))
        if len(self.depth_paths) != len(self.mask_paths):
            raise ValueError(
                f"depth/part-mask count mismatch: {len(self.depth_paths)} vs "
                f"{len(self.mask_paths)}")
        if not self.depth_paths:
            raise ValueError(f"no depth frames found in {depth_dir}")

    def size(self) -> int:
        return len(self.depth_paths)

    def _read_depth(self, path: str) -> np.ndarray:
        if path.endswith(".exr") or path.endswith(".depth"):
            m = formats.read_depth(path)
            return m[..., 2] if m.ndim == 3 else m
        import cv2

        m = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_GRAYSCALE)
        if m is None:
            raise FileNotFoundError(path)
        if np.issubdtype(m.dtype, np.integer):
            return m.astype(np.float32) * 1e-3  # millimeters -> meters
        return np.asarray(m, np.float32)

    def _read_mask(self, path: str) -> np.ndarray:
        import cv2

        m = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if m is None:
            raise FileNotFoundError(path)
        return np.asarray(m, np.uint8)

    def image_size(self):
        d = self._read_depth(self.depth_paths[0])
        return d.shape[:2]

    def load_batch(self, ids: np.ndarray):
        depth = np.stack([self._read_depth(self.depth_paths[i])
                          for i in ids]).astype(np.float32)
        mask = np.stack([self._read_mask(self.mask_paths[i]) for i in ids])
        return depth, mask


class ForestTrainer:
    """Breadth-first forest trainer (synthetic renders or file frames).

    Key hyperparameters follow rtree-train defaults (rtree-train.cpp:26-52):
    num_images, num_points_per_image, num_features, max_probe_offset,
    min_samples, max_tree_depth, threshes (buckets).
    """

    def __init__(self, model, intrin, image_size, num_parts: int,
                 part_map=None, pose_seq=None, num_images: int = 500,
                 num_points_per_image: int = 1000, num_features: int = 128,
                 max_probe_offset: float = 170.0, min_samples: int = 64,
                 max_tree_depth: int = 13, n_buckets: int = 16,
                 image_batch: int = 16, node_chunk: int = 512,
                 seed: int = 0, verbose: bool = False,
                 checkpoint_path: str = "", mesh: Optional[object] = None,
                 frame_source: Optional[FileFrameSource] = None,
                 num_features_filtered: int = 0,
                 filter_subsample: int = 4, filter_buckets: int = 8,
                 feature_block: int = 256, sample_balance: float = 0.5,
                 pass_mode: str = "auto"):
        self.model = model
        self.H, self.W = image_size
        self.num_parts = num_parts
        self.num_images = num_images
        self.S = num_points_per_image
        self.F = num_features
        # TrainerV2's two-stage feature selection (RTree.cpp:1396-2335,
        # proposal ~1455-1550; rtree-train.cpp:33-35): propose num_features,
        # score them SPARSELY (every filter_subsample-th image batch,
        # filter_buckets-bin histograms), keep the top num_features_filtered
        # PER NODE, then dense-count only the survivors.  0 disables the
        # filter stage (single-stage, shared pool).
        self.F_filtered = (num_features_filtered
                           if 0 < num_features_filtered < num_features else 0)
        self.filter_subsample = max(filter_subsample, 1)
        self.T_sparse = filter_buckets
        self.Fb = feature_block
        self.max_probe = max_probe_offset
        self.min_samples = min_samples
        self.max_depth = max_tree_depth
        self.T = n_buckets
        self.B = image_batch
        self.node_chunk = node_chunk
        self.seed = seed
        self.verbose = verbose
        self.checkpoint_path = checkpoint_path
        self.mesh = mesh
        self.frame_source = frame_source
        self.sample_balance = sample_balance
        if frame_source is None:
            self.src = synth.make_source(model, intrin, part_map, pose_seq,
                                         n_images=num_images, seed=seed)
        else:
            self.src = None
            self.num_images = min(num_images, frame_source.size()) \
                if num_images else frame_source.size()
        self._rng = np.random.default_rng(seed)
        self._panic = False
        # pass_mode: "flat" (sample-major, single-device; deep levels cost
        # the same as level 0) / "batch" (image-major; shards over a mesh)
        # / "auto" (flat unless a mesh is given).  The flat passes index
        # the flattened cache with int32, so huge caches fall back.
        if pass_mode == "auto":
            pass_mode = "batch" if mesh is not None else "flat"
        if (pass_mode == "flat" and
                self.num_images * self.H * self.W >= 2 ** 31):
            pass_mode = "batch"
        if mesh is not None and pass_mode == "flat":
            raise ValueError("mesh training requires pass_mode='batch' "
                             "(image batches shard over the mesh)")
        self.pass_mode = pass_mode
        if mesh is not None:
            # every shard_map call splits the image batch across devices
            n_dev = int(np.prod(list(mesh.shape.values())))
            self.B = -(-self.B // n_dev) * n_dev
        # sample-block sizes for the flat passes (scores [BLK, F] and the
        # probe index tensors bound peak memory)
        self._blk_dense = 1 << 17
        self._blk_filter = 1 << 16

    # -- data -----------------------------------------------------------------

    def _render_batch(self, ids: np.ndarray):
        if self.frame_source is not None:
            return self.frame_source.load_batch(ids)
        depth, mask, _ = synth.render_batch(
            self.src, self.model.parents, jnp.asarray(ids, jnp.int32),
            self.seed, self.H, self.W, self.model.num_shape_keys())
        return depth, mask

    def _init_samples(self):
        """Render every image once, sample S foreground pixels each
        (AvatarTrainerV3::initTraining, RTree.cpp:2424-2497).

        For device-rendered synthetic frames, the frame cache AND the
        weighted pixel sampling stay on device end to end (no [B,H,W]
        downloads over the link); host frame sources use the host sampler.
        """
        on_device = self.frame_source is None
        xs, ys, ps, vs = [], [], [], []
        cache = []
        if on_device:
            # preallocated + donated in-place fill: one cache copy is the
            # HBM ceiling for training scale (uint16 mm = camera-native
            # 1 mm precision at half the bytes of f32)
            self._depth_cache = jnp.zeros(
                (self.num_images, self.H, self.W), jnp.uint16)
        key = jax.random.PRNGKey(self.seed ^ 0x5EED)
        for start in range(0, self.num_images, self.B):
            ids = np.arange(start, min(start + self.B, self.num_images))
            ids_pad = np.pad(ids, (0, self.B - len(ids)), mode="edge")
            depth, mask = self._render_batch(ids_pad)
            if on_device:
                bx, by, bp, bv = sample_pixels_device(
                    depth, mask, self.S, self.num_parts,
                    jnp.asarray(self.sample_balance, jnp.float32),
                    jax.random.fold_in(key, start))
                xs.append(bx[: len(ids)])
                ys.append(by[: len(ids)])
                ps.append(bp[: len(ids)])
                vs.append(bv[: len(ids)])
                slab = jnp.round(
                    depth[: len(ids)] * 1000.0).astype(jnp.uint16)
                self._depth_cache = _cache_write(
                    self._depth_cache, slab, jnp.int32(start))
            else:
                depth_np = np.asarray(depth)
                mask_np = np.asarray(mask)
                cache.append(np.round(
                    depth_np[: len(ids)] * 1000.0).astype(np.uint16))
                for k in range(len(ids)):
                    x, y, p, v = _sample_pixels(
                        depth_np[k], mask_np[k], self.S, self._rng,
                        self.sample_balance)
                    xs.append(x)
                    ys.append(y)
                    ps.append(p)
                    vs.append(v)
            if self.verbose and (start // self.B) % 8 == 0:
                print(f"[forest] rendered {start + len(ids)}"
                      f"/{self.num_images} images")
        if on_device:
            self.samples = Samples(
                x=jnp.concatenate(xs), y=jnp.concatenate(ys),
                part=jnp.concatenate(ps), valid=jnp.concatenate(vs))
        else:
            self._set_depth_cache(np.concatenate(cache, axis=0))
            self.samples = Samples(
                x=jnp.asarray(np.stack(xs)), y=jnp.asarray(np.stack(ys)),
                part=jnp.asarray(np.stack(ps)),
                valid=jnp.asarray(np.stack(vs)))
        self.node_of = np.zeros((self.num_images, self.S), np.int32)
        self.node_of[~np.asarray(self.samples.valid)] = -1

    # -- checkpointing (RTREE_V2/V3-style resumable state) ---------------------

    def save_checkpoint(self, path: Optional[str] = None) -> None:
        path = path or self.checkpoint_path
        if not path:
            return
        fd = self.tree.to_forest()
        tmp = path + ".partial"
        np.savez(
            tmp, u=fd.u, v=fd.v, thresh=fd.thresh, lnode=fd.lnode,
            rnode=fd.rnode, leafid=fd.leafid, leaf_data=fd.leaf_data,
            num_parts=fd.num_parts, node_of=self.node_of,
            frontier=np.asarray(self.frontier, np.int32),
            frontier_depth=np.asarray(self.frontier_depth, np.int32),
            level=self.level, seed=self.seed,
            sx=np.asarray(self.samples.x), sy=np.asarray(self.samples.y),
            spart=np.asarray(self.samples.part),
            svalid=np.asarray(self.samples.valid))
        os.replace(tmp + ".npz", path)
        if self.verbose:
            print(f"[forest] checkpoint saved to {path}")

    def load_checkpoint(self, path: str) -> None:
        z = np.load(path)
        self.tree = _TreeBuilder(int(z["num_parts"]))
        self.tree.u = [tuple(r) for r in z["u"]]
        self.tree.v = [tuple(r) for r in z["v"]]
        self.tree.thresh = list(z["thresh"])
        self.tree.lnode = list(z["lnode"])
        self.tree.rnode = list(z["rnode"])
        self.tree.leafid = list(z["leafid"])
        self.tree.leaf_data = [z["leaf_data"][i]
                               for i in range(len(z["leaf_data"]))]
        self.node_of = z["node_of"]
        self.frontier = list(z["frontier"])
        self.frontier_depth = list(z["frontier_depth"])
        self.level = int(z["level"])
        self.samples = Samples(
            x=jnp.asarray(z["sx"]), y=jnp.asarray(z["sy"]),
            part=jnp.asarray(z["spart"]), valid=jnp.asarray(z["svalid"]))
        # regenerate the depth cache deterministically (xorKey-style resume)
        self._depth_cache = None

    # -- main loop --------------------------------------------------------------

    def train(self, resume_from: str = "") -> formats.ForestData:
        if resume_from and os.path.exists(resume_from):
            self.load_checkpoint(resume_from)
            self._rebuild_depth_cache()
        else:
            self._init_samples()
            self.tree = _TreeBuilder(self.num_parts)
            root = self.tree.add_node()
            self.frontier = [root]
            self.frontier_depth = [self.max_depth]
            self.level = 0

        old_handler = signal.signal(signal.SIGINT, self._sigint)
        try:
            while self.frontier:
                self._train_level()
                self.level += 1
                self.save_checkpoint()
                if self._panic:
                    break
        finally:
            signal.signal(signal.SIGINT, old_handler)
        return self.tree.to_forest()

    def _sigint(self, signum, frame):
        # cooperative panic-save (reference RTree.cpp:2950-2957)
        print("[forest] SIGINT: saving checkpoint after this level...")
        self._panic = True

    def _set_depth_cache(self, cache_np: np.ndarray) -> None:
        """Pin the rendered frame cache in device HBM when it fits.

        Every level makes O(features/feature_block * batches) scoring calls
        over the same frames; host-resident frames would re-upload ~30 MB
        per call.  The reference's
        analogue is V3 keeping all frames in RAM as SparseImages
        (RTree.cpp:2941) — HBM plays that role here.
        """
        if cache_np.nbytes <= 6 << 30:
            self._depth_cache = jnp.asarray(cache_np)
        else:  # fall back to host memory + per-call upload
            self._depth_cache = cache_np

    def _rebuild_depth_cache(self):
        on_device = self.frame_source is None
        caches = []
        if on_device:
            self._depth_cache = jnp.zeros(
                (self.num_images, self.H, self.W), jnp.uint16)
        for start in range(0, self.num_images, self.B):
            ids = np.arange(start, min(start + self.B, self.num_images))
            ids_pad = np.pad(ids, (0, self.B - len(ids)), mode="edge")
            depth, _ = self._render_batch(ids_pad)
            if on_device:
                # keep the slab on device: a f32 [B,H,W] download + uint16
                # re-upload per batch is ~2 GB of needless host traffic at
                # 512 imgs
                slab = jnp.round(
                    depth[: len(ids)] * 1000.0).astype(jnp.uint16)
                self._depth_cache = _cache_write(
                    self._depth_cache, slab, jnp.int32(start))
            else:
                caches.append(np.round(
                    np.asarray(depth)[: len(ids)] * 1000.0)
                    .astype(np.uint16))
            if self.verbose and (start // self.B) % 8 == 0:
                print(f"[forest] re-rendered {start + len(ids)}"
                      f"/{self.num_images} images (resume)")
        if not on_device:
            self._set_depth_cache(np.concatenate(caches, axis=0))

    def _cache_slab(self, sl) -> jnp.ndarray:
        """Device f32-meter view of a cached frame slab (decodes the
        uint16-mm cache; uploads host-resident slabs)."""
        slab = self._depth_cache[sl]
        slab = jnp.asarray(slab)
        if slab.dtype == jnp.uint16:
            slab = slab.astype(jnp.float32) * 1e-3
        return slab

    # -- mesh dispatch: image batches shard over the devices --------------
    #
    # With a mesh, every level pass runs as a shard_map over the image
    # axis: per-chip partial min/max/counts reduce with pmin/pmax/psum over
    # ICI — the all-reduce analogue of the reference's per-thread
    # accumulate-then-mutex-add (RTree.cpp:1700-1704).  Counts are
    # integer-valued f32, so the psum is exact and the trained tree is
    # IDENTICAL to the single-device one (tests/test_parallel.py).

    def _pad_b(self, a, fill=0):
        """Pad a batch-leading array to the fixed image batch B (mesh mode
        needs every shard_map call divisible by the mesh size)."""
        n = a.shape[0]
        if n == self.B:
            return a
        pad = [(0, self.B - n)] + [(0, 0)] * (a.ndim - 1)
        return jnp.pad(a, pad, constant_values=fill)

    def _p_minmax(self, slab, sx, sy, valid, nl, fu, fv, NC: int):
        if self.mesh is None:
            return pass_minmax(slab, sx, sy, valid, nl, fu, fv, NC)
        from avatar_tpu.parallel import training as ptrain

        return ptrain.sharded_pass_minmax(
            self.mesh, self._pad_b(slab), self._pad_b(sx), self._pad_b(sy),
            self._pad_b(valid), self._pad_b(nl, -1), fu, fv, NC)

    def _p_counts(self, slab, sx, sy, part, valid, nl, fu, fv, smin, smax,
                  NC: int, T: int, P: int):
        if self.mesh is None:
            return pass_counts(slab, sx, sy, part, valid, nl, fu, fv,
                               smin, smax, NC, T, P)
        from avatar_tpu.parallel import training as ptrain

        return ptrain.sharded_pass_counts(
            self.mesh, self._pad_b(slab), self._pad_b(sx), self._pad_b(sy),
            self._pad_b(part), self._pad_b(valid), self._pad_b(nl, -1),
            fu, fv, smin, smax, NC, T, P)

    def _p_assign(self, slab, sx, sy, valid, node, bu, bv, bt, bl, br,
                  isp):
        n = slab.shape[0]
        if self.mesh is None:
            return pass_assign(slab, sx, sy, valid, node, bu, bv, bt,
                               bl, br, isp)
        from avatar_tpu.parallel import training as ptrain

        out = ptrain.sharded_pass_assign(
            self.mesh, self._pad_b(slab), self._pad_b(sx), self._pad_b(sy),
            self._pad_b(valid), self._pad_b(node), bu, bv, bt, bl, br, isp)
        return out[:n]

    def _train_level(self):
        frontier = self.frontier
        depths = self.frontier_depth
        if self.verbose:
            import time as _time

            t0 = _time.time()
            print(f"[forest] level {self.level}: {len(frontier)} nodes, "
                  f"{int((self.node_of >= 0).sum())} live samples")
        new_frontier = []
        new_depths = []
        process = (self._process_chunk_flat if self.pass_mode == "flat"
                   else self._process_chunk)
        for c0 in range(0, len(frontier), self.node_chunk):
            chunk = frontier[c0:c0 + self.node_chunk]
            chunk_depths = depths[c0:c0 + self.node_chunk]
            process(chunk, chunk_depths, new_frontier, new_depths)
        self.frontier = new_frontier
        self.frontier_depth = new_depths
        if self.verbose:
            print(f"[forest] level {self.level} took "
                  f"{_time.time() - t0:.0f}s")

    def _filter_features(self, node_local_np, fu_pool, fv_pool,
                         NC: int) -> np.ndarray:
        """Sparse scoring pass: approximate info gain of every pool feature
        on a subsample of image batches, returning the per-node indices of
        the top F_filtered features (TrainerV2's filter,
        RTree.cpp:1455-1550).

        Memory is bounded by scoring the pool in feature blocks of self.Fb
        with self.T_sparse histogram buckets.
        """
        F = fu_pool.shape[0]
        Ff = self.F_filtered
        Ts, P = self.T_sparse, self.num_parts
        sub = self.filter_subsample
        gains_pool = np.zeros((NC, F), np.float32)
        batch_starts = list(range(0, self.num_images, self.B))[::sub]
        big = np.float32(3e38)
        node_local = jnp.asarray(node_local_np)
        for fb in range(0, F, self.Fb):
            fu_b = jnp.asarray(fu_pool[fb:fb + self.Fb])
            fv_b = jnp.asarray(fv_pool[fb:fb + self.Fb])
            Fb = fu_b.shape[0]
            # all accumulation on device: the count tensor is ~50 MB per
            # call and must never cross to the host
            smin = jnp.full((NC, Fb), big)
            smax = jnp.full((NC, Fb), -big)
            for start in batch_starts:
                sl = slice(start, min(start + self.B, self.num_images))
                mn, mx = self._p_minmax(
                    self._cache_slab(sl),
                    self.samples.x[sl], self.samples.y[sl],
                    self.samples.valid[sl], node_local[sl],
                    fu_b, fv_b, NC)
                smin = jnp.minimum(smin, mn[:NC])
                smax = jnp.maximum(smax, mx[:NC])
            counts = jnp.zeros((NC, Fb, Ts, P))
            for start in batch_starts:
                sl = slice(start, min(start + self.B, self.num_images))
                counts = counts + self._p_counts(
                    self._cache_slab(sl),
                    self.samples.x[sl], self.samples.y[sl],
                    self.samples.part[sl], self.samples.valid[sl],
                    node_local[sl], fu_b, fv_b,
                    smin, smax, NC, Ts, P)
            g, _ = split_gains(counts)                          # [NC,Fb,Ts-1]
            gains_pool[:, fb:fb + Fb] = np.asarray(jnp.max(g, axis=2))
        # top-Ff per node by sparse gain
        top = np.argsort(-gains_pool, axis=1)[:, :Ff]           # [NC, Ff]
        return top

    def _process_chunk(self, chunk, chunk_depths, new_frontier, new_depths):
        NC = len(chunk)
        F, T, P = self.F, self.T, self.num_parts
        # map global node id -> local slot (one gather; a per-node boolean
        # scan is O(chunk * samples) and dominated deep levels)
        gmap = np.full(len(self.tree.thresh) + 1, -1, np.int32)
        gmap[np.asarray(chunk, np.int32)] = np.arange(NC, dtype=np.int32)
        node_local_np = gmap[np.maximum(self.node_of, 0)]
        node_local_np[self.node_of < 0] = -1

        # per-level random feature pool (V3 samples per node; a shared pool
        # per chunk is the tensor-friendly equivalent).  Keyed on
        # (seed, level, chunk) rather than drawn from stateful RNG so a
        # checkpoint-resumed run proposes the same features as an
        # uninterrupted one (the reference's xorKey-seeded resume is
        # deterministic the same way, RTree.cpp:2649-2702)
        frng = np.random.default_rng(
            (self.seed, self.level, int(chunk[0])))
        fu_pool = frng.uniform(-self.max_probe, self.max_probe,
                               (F, 2)).astype(np.float32)
        fv_pool = frng.uniform(-self.max_probe, self.max_probe,
                               (F, 2)).astype(np.float32)

        if self.F_filtered:
            # --- TrainerV2 filter stage: sparse info-gain over the pool,
            # top num_features_filtered survivors per node ---------------
            top = self._filter_features(node_local_np, fu_pool, fv_pool, NC)
            fu = fu_pool[top]                            # [NC, Ff, 2]
            fv = fv_pool[top]
            F = self.F_filtered
        else:
            fu, fv = fu_pool, fv_pool
        fu_j = jnp.asarray(fu)
        fv_j = jnp.asarray(fv)

        big = np.float32(3e38)
        node_local = jnp.asarray(node_local_np)
        smin_j = jnp.full((NC, F), big)
        smax_j = jnp.full((NC, F), -big)
        for start in range(0, self.num_images, self.B):
            sl = slice(start, min(start + self.B, self.num_images))
            mn, mx = self._p_minmax(
                self._cache_slab(sl),
                self.samples.x[sl], self.samples.y[sl],
                self.samples.valid[sl], node_local[sl],
                fu_j, fv_j, NC)
            smin_j = jnp.minimum(smin_j, mn[:NC])
            smax_j = jnp.maximum(smax_j, mx[:NC])

        counts_j = jnp.zeros((NC, F, T, P))
        for start in range(0, self.num_images, self.B):
            sl = slice(start, min(start + self.B, self.num_images))
            counts_j = counts_j + self._p_counts(
                self._cache_slab(sl),
                self.samples.x[sl], self.samples.y[sl],
                self.samples.part[sl], self.samples.valid[sl],
                node_local[sl], fu_j, fv_j,
                smin_j, smax_j, NC, T, P)

        split = self._decide_splits(chunk, chunk_depths, counts_j, smin_j,
                                    smax_j, fu, fv, new_frontier, new_depths)
        if split is None:
            return
        bu, bv, bt, bl, br, is_split = split

        # reassignment pass
        for start in range(0, self.num_images, self.B):
            sl = slice(start, min(start + self.B, self.num_images))
            node = jnp.asarray(np.maximum(self.node_of[sl], 0))
            new_node = self._p_assign(
                self._cache_slab(sl),
                self.samples.x[sl], self.samples.y[sl],
                self.samples.valid[sl], node,
                jnp.asarray(bu), jnp.asarray(bv), jnp.asarray(bt),
                jnp.asarray(bl), jnp.asarray(br), jnp.asarray(is_split))
            upd = np.asarray(new_node)
            live = self.node_of[sl] >= 0
            block = self.node_of[sl]
            block[live] = upd[live]

    # -- sample-major (flat) chunk processing -------------------------------

    def _flat_sample_arrays(self):
        if (getattr(self, "_sxf", None) is None or
                self._sxf.shape[0] != self.samples.x.size):
            self._sxf = self.samples.x.reshape(-1)
            self._syf = self.samples.y.reshape(-1)
            self._spf = self.samples.part.reshape(-1)
        return self._sxf, self._syf, self._spf

    def _flat_blocks(self, sel, nl, pos, blk: int):
        """Fixed-size device blocks of the chunk's selected samples.

        Padding keeps shapes static (one XLA program per block size);
        padded rows carry node_local -1 and are masked inside the kernels.
        """
        sxf, syf, spf = self._flat_sample_arrays()
        out = []
        M = len(sel)
        for b0 in range(0, M, blk):
            b1 = min(b0 + blk, M)
            n = b1 - b0
            pad = blk - n
            sidx = jnp.asarray(np.pad(sel[b0:b1], (0, pad)), jnp.int32)
            nl_b = jnp.asarray(np.pad(nl[b0:b1], (0, pad),
                                      constant_values=-1))
            pos_b = jnp.asarray(np.pad(pos[b0:b1], (0, pad)))
            out.append((pos_b, sxf[sidx], syf[sidx], spf[sidx], nl_b,
                        n, slice(b0, b1)))
        return out

    def _filter_features_flat(self, cache_flat, blocks, NC: int):
        """TrainerV2 filter stage over the flat sample blocks (sparse
        score pass at 1/filter_subsample of the selected samples)."""
        F = self._fu_pool.shape[0]
        Ff = self.F_filtered
        Ts, P = self.T_sparse, self.num_parts
        # cap the feature block so the sparse count tensor stays < ~0.5 GB
        Fb_cap = max(32, min(self.Fb, (1 << 27) // max(1, NC * Ts * P)))
        gains_pool = np.zeros((NC, F), np.float32)
        big = np.float32(3e38)
        for fb in range(0, F, Fb_cap):
            fu_b = jnp.asarray(self._fu_pool[fb:fb + Fb_cap])
            fv_b = jnp.asarray(self._fv_pool[fb:fb + Fb_cap])
            Fb = fu_b.shape[0]
            smin = jnp.full((NC, Fb), big)
            smax = jnp.full((NC, Fb), -big)
            for pos_b, sx_b, sy_b, _, nl_b, _, _ in blocks:
                mn, mx = pass_minmax_flat(
                    cache_flat, pos_b, sx_b, sy_b, nl_b, fu_b, fv_b,
                    self.H, self.W, NC)
                smin = jnp.minimum(smin, mn)
                smax = jnp.maximum(smax, mx)
            counts = jnp.zeros((NC, Fb, Ts, P))
            for pos_b, sx_b, sy_b, part_b, nl_b, _, _ in blocks:
                counts = counts + pass_counts_flat(
                    cache_flat, pos_b, sx_b, sy_b, part_b, nl_b, fu_b,
                    fv_b, smin, smax, self.H, self.W, NC, Ts, P)
            g, _ = split_gains(counts)
            gains_pool[:, fb:fb + Fb] = np.asarray(jnp.max(g, axis=2))
        return np.argsort(-gains_pool, axis=1)[:, :Ff]

    def _process_chunk_flat(self, chunk, chunk_depths, new_frontier,
                            new_depths):
        if isinstance(self._depth_cache, np.ndarray):
            # host-resident cache: no device array to flatten
            return self._process_chunk(chunk, chunk_depths, new_frontier,
                                       new_depths)
        NC = len(chunk)
        F, T, P = self.F, self.T, self.num_parts
        gmap = np.full(len(self.tree.thresh) + 1, -1, np.int32)
        gmap[np.asarray(chunk, np.int32)] = np.arange(NC, dtype=np.int32)
        node_local_np = gmap[np.maximum(self.node_of, 0)]
        node_local_np[self.node_of < 0] = -1

        nl_flat = node_local_np.ravel()
        sel = np.nonzero(nl_flat >= 0)[0].astype(np.int32)
        nl = nl_flat[sel].astype(np.int32)
        pos = ((sel // self.S).astype(np.int64) *
               (self.H * self.W)).astype(np.int32)
        cache_flat = self._depth_cache.reshape(-1)

        # same keyed feature pools as the batch path (checkpoint-resume
        # determinism; see _process_chunk)
        frng = np.random.default_rng(
            (self.seed, self.level, int(chunk[0])))
        self._fu_pool = frng.uniform(-self.max_probe, self.max_probe,
                                     (F, 2)).astype(np.float32)
        self._fv_pool = frng.uniform(-self.max_probe, self.max_probe,
                                     (F, 2)).astype(np.float32)

        if self.F_filtered:
            fblocks = self._flat_blocks(sel[::self.filter_subsample],
                                        nl[::self.filter_subsample],
                                        pos[::self.filter_subsample],
                                        self._blk_filter)
            top = self._filter_features_flat(cache_flat, fblocks, NC)
            del fblocks
            fu = self._fu_pool[top]                       # [NC, Ff, 2]
            fv = self._fv_pool[top]
            F = self.F_filtered
        else:
            fu, fv = self._fu_pool, self._fv_pool
        fu_j = jnp.asarray(fu)
        fv_j = jnp.asarray(fv)

        blocks = self._flat_blocks(sel, nl, pos, self._blk_dense)
        big = np.float32(3e38)
        smin_j = jnp.full((NC, F), big)
        smax_j = jnp.full((NC, F), -big)
        for pos_b, sx_b, sy_b, _, nl_b, _, _ in blocks:
            mn, mx = pass_minmax_flat(cache_flat, pos_b, sx_b, sy_b, nl_b,
                                      fu_j, fv_j, self.H, self.W, NC)
            smin_j = jnp.minimum(smin_j, mn)
            smax_j = jnp.maximum(smax_j, mx)
        counts_j = jnp.zeros((NC, F, T, P))
        for pos_b, sx_b, sy_b, part_b, nl_b, _, _ in blocks:
            counts_j = counts_j + pass_counts_flat(
                cache_flat, pos_b, sx_b, sy_b, part_b, nl_b, fu_j, fv_j,
                smin_j, smax_j, self.H, self.W, NC, T, P)

        split = self._decide_splits(chunk, chunk_depths, counts_j, smin_j,
                                    smax_j, fu, fv, new_frontier, new_depths)
        if split is None:
            return
        bu, bv, bt, bl, br, is_split = split
        bu_j, bv_j, bt_j = (jnp.asarray(bu), jnp.asarray(bv),
                            jnp.asarray(bt))
        bl_j, br_j, isp_j = (jnp.asarray(bl), jnp.asarray(br),
                             jnp.asarray(is_split))
        node_sel = self.node_of.ravel()[sel]
        out = np.empty(len(sel), np.int32)
        blkd = self._blk_dense
        for pos_b, sx_b, sy_b, _, nl_b, n, sl_ in blocks:
            node_b = jnp.asarray(np.pad(node_sel[sl_], (0, blkd - n),
                                        constant_values=-1))
            child = pass_assign_flat(cache_flat, pos_b, sx_b, sy_b, node_b,
                                     bu_j, bv_j, bt_j, bl_j, br_j, isp_j,
                                     self.H, self.W)
            out[sl_] = np.asarray(child)[:n]
        self.node_of.reshape(-1)[sel] = out

    def _decide_splits(self, chunk, chunk_depths, counts_j, smin_j, smax_j,
                       fu, fv, new_frontier, new_depths):
        """Pick per-node best splits (device argmax via split_decide, tiny
        downloads) and update the host-side tree; returns the split arrays
        for the reassignment pass or None when every node became a leaf."""
        gain_j, fbest_j, thresh_j, rng_j, n_j, hist_j = split_decide(
            counts_j, smin_j, smax_j, self.T)
        gain = np.asarray(gain_j)
        f_best = np.asarray(fbest_j)
        thresh_a = np.asarray(thresh_j)
        rngs = np.asarray(rng_j)
        totals = np.asarray(n_j)
        part_hist = np.asarray(hist_j)

        # arrays indexed by global node id for reassignment
        n_nodes_upper = len(self.tree.thresh) + 2 * len(chunk) + 2
        bu = np.zeros((n_nodes_upper, 2), np.float32)
        bv = np.zeros((n_nodes_upper, 2), np.float32)
        bt = np.zeros(n_nodes_upper, np.float32)
        bl = np.zeros(n_nodes_upper, np.int32)
        br = np.zeros(n_nodes_upper, np.int32)
        is_split = np.zeros(n_nodes_upper, bool)

        for i, gid in enumerate(chunk):
            depth_left = chunk_depths[i]
            # leaf criteria (RTree.cpp:2506-2521 + zero-gain rule)
            if (depth_left <= 1 or totals[i] <= self.min_samples or
                    gain[i] <= 1e-6 or rngs[i] < 1e-9):
                self.tree.make_leaf(gid, part_hist[i].astype(np.float64))
                continue
            fu_i = fu[i, f_best[i]] if fu.ndim == 3 else fu[f_best[i]]
            fv_i = fv[i, f_best[i]] if fv.ndim == 3 else fv[f_best[i]]
            l, r = self.tree.make_split(gid, fu_i, fv_i, thresh_a[i])
            bu[gid] = fu_i
            bv[gid] = fv_i
            bt[gid] = thresh_a[i]
            bl[gid] = l
            br[gid] = r
            is_split[gid] = True
            new_frontier.extend([l, r])
            new_depths.extend([depth_left - 1, depth_left - 1])

        if not is_split.any():
            return None
        return bu, bv, bt, bl, br, is_split


# ---------------------------------------------------------------------------
# RTree-facing entry points (reference trainFromAvatar / trainTransfer / train)
# ---------------------------------------------------------------------------


def train_from_avatar(rtree, avatar_model, pose_seq, intrin, image_size,
                      num_threads: int = 0, verbose: bool = False,
                      num_images: int = 500, num_points_per_image: int = 1000,
                      num_features: int = 128, num_features_filtered: int = 0,
                      max_probe_offset: float = 170.0, min_samples: int = 64,
                      max_tree_depth: int = 13,
                      min_samples_per_feature: int = 0,
                      frac_samples_per_feature: float = 0.0,
                      threshes_per_feature: int = 16, part_map=None,
                      max_images_loaded: int = 0, mem_limit_mb: int = 0,
                      train_partial_save_path: str = "",
                      seed: int = 0, devices: int = 0) -> None:
    """Train rtree from synthetic renders (reference RTree.cpp:3292-3330).

    num_features_filtered > 0 enables TrainerV2's two-stage feature
    selection (sparse-score the num_features pool, dense-count only the
    per-node top survivors; RTree.cpp:1396-2335).  Thread/memory arguments
    (num_threads, max_images_loaded, mem_limit_mb) are accepted for CLI
    parity and ignored: XLA schedules compute and the image cache is
    device-resident by design.
    """
    if max_images_loaded or mem_limit_mb:
        import logging

        logging.getLogger(__name__).warning(
            "max_images_loaded/mem_limit_mb are ignored (the frame "
            "cache is managed by XLA); got %s/%s",
            max_images_loaded, mem_limit_mb)
    # frac_samples_per_feature (V2's sparse-scoring sample fraction,
    # rtree-train.cpp:37-39) maps to the filter stage's image subsample
    # rate; min_samples_per_feature's histogram-sizing role is covered by
    # the fixed threshes_per_feature buckets.
    filter_subsample = (max(1, round(1.0 / frac_samples_per_feature))
                        if frac_samples_per_feature > 0 else 4)
    mesh = None
    if devices:
        from avatar_tpu.parallel.training import make_mesh

        mesh = make_mesh(devices)
    trainer = ForestTrainer(
        avatar_model, intrin, image_size, rtree.num_parts,
        part_map=part_map, pose_seq=pose_seq, num_images=num_images,
        num_points_per_image=num_points_per_image, num_features=num_features,
        max_probe_offset=max_probe_offset, min_samples=min_samples,
        max_tree_depth=max_tree_depth, n_buckets=threshes_per_feature,
        seed=seed, verbose=verbose,
        checkpoint_path=train_partial_save_path,
        num_features_filtered=num_features_filtered,
        filter_subsample=filter_subsample, mesh=mesh)
    fd = trainer.train(resume_from=train_partial_save_path)
    rtree.set_forest(fd)
    rtree.part_map = list(part_map) if part_map is not None else []


def train_transfer(rtree, avatar_model, pose_seq, intrin, image_size,
                   num_threads: int = 0, verbose: bool = False,
                   num_images: int = 100, seed: int = 0) -> None:
    """Re-estimate leaf distributions on freshly rendered frames
    (reference RTree.cpp:3332-3420): run the frozen tree over every
    foreground pixel, histogram (part, leaf) visits, renormalize;
    unvisited leaves keep their old distributions."""
    src = synth.make_source(avatar_model, intrin, rtree.part_map, pose_seq,
                            n_images=num_images, seed=seed)
    H, W = image_size
    n_leafs = rtree.forest.leaf_data.shape[0]
    counts = np.zeros((n_leafs, rtree.num_parts), np.float64)
    B = 8
    for start in range(0, num_images, B):
        ids = np.arange(start, min(start + B, num_images))
        ids_pad = np.pad(ids, (0, B - len(ids)), mode="edge")
        depth, mask, _ = synth.render_batch(
            src, avatar_model.parents, jnp.asarray(ids_pad, jnp.int32),
            seed, H, W, avatar_model.num_shape_keys())
        for k in range(len(ids)):
            d = np.asarray(depth[k])
            m = np.asarray(mask[k])
            from avatar_tpu.perception.rtree import forest_walk

            leaf = np.asarray(forest_walk(
                rtree._tree, jnp.asarray(d), rtree._max_depth, 1,
                jnp.asarray([0, 0]), jnp.asarray([W - 1, H - 1])))
            fg = (m != 255) & (leaf >= 0)
            np.add.at(counts, (leaf[fg], m[fg].astype(np.int64)), 1.0)
    new_leaf = rtree.forest.leaf_data.copy()
    visited = counts.sum(1) > 0
    new_leaf[visited] = (counts[visited] /
                         counts[visited].sum(1, keepdims=True))
    if verbose and (~visited).any():
        print(f"[transfer] {int((~visited).sum())} leaves unvisited, "
              "keeping old weights")
    fd = rtree.forest
    rtree.set_forest(formats.ForestData(
        fd.u, fd.v, fd.thresh, fd.lnode, fd.rnode, fd.leafid,
        new_leaf.astype(np.float32), fd.num_parts))


def train_from_files(rtree, depth_dir: str, part_mask_dir: str,
                     num_threads: int = 0, verbose: bool = False,
                     num_images: int = 0, num_points_per_image: int = 1000,
                     num_features: int = 128, num_features_filtered: int = 0,
                     max_probe_offset: float = 170.0, min_samples: int = 64,
                     max_tree_depth: int = 13,
                     min_samples_per_feature: int = 0,
                     frac_samples_per_feature: float = 0.0,
                     threshes_per_feature: int = 16,
                     max_images_loaded: int = 0, mem_limit_mb: int = 0,
                     train_partial_save_path: str = "",
                     seed: int = 0) -> None:
    """Train rtree from recorded depth + part-mask frame pairs on disk
    (reference RTree::train with FileDataSource, RTree.cpp:3264-3290).

    Both directories are listed and sorted; frame i pairs depth_paths[i]
    with mask_paths[i].  Frames are held in the host-side depth cache like
    the reference's max_images_loaded LRU (ignored here: the cache is dense).
    """
    src = FileFrameSource(depth_dir, part_mask_dir)
    image_size = src.image_size()
    trainer = ForestTrainer(
        None, None, image_size, rtree.num_parts,
        num_images=num_images or src.size(),
        num_points_per_image=num_points_per_image,
        num_features=num_features, max_probe_offset=max_probe_offset,
        min_samples=min_samples, max_tree_depth=max_tree_depth,
        n_buckets=threshes_per_feature, seed=seed, verbose=verbose,
        checkpoint_path=train_partial_save_path, frame_source=src,
        num_features_filtered=num_features_filtered)
    fd = trainer.train(resume_from=train_partial_save_path)
    rtree.set_forest(fd)
