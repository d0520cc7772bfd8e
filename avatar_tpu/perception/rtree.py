"""Random-forest body-part segmentation (Shotton-style depth probes).

Rebuild of reference RTree (RTree.h, RTree.cpp:3122-3262 inference,
3422-3463 postprocess, 2967-3120 serialization).  The per-pixel recursive
tree walk becomes a vectorized iterative walk over the whole (strided) pixel
grid: every step gathers node parameters by per-pixel node index, evaluates
the depth-probe feature

    f = depth(pix + u / d(pix)) - depth(pix + v / d(pix))

with out-of-ROI / zero depth mapping to BACKGROUND_DEPTH = 20 m
(RTree.cpp:40-68, 3224-3237), and branches left/right; leaves self-loop.
Tree depth <= ~20 so the walk is a short fori_loop — embarrassingly parallel
over pixels.

Post-processing (part-blob filtering with center-of-mass tracking) uses the
label-propagation connected-components kernel in cc.py instead of explicit-
stack flood fill.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from avatar_tpu.io import formats
from avatar_tpu.perception import cc

BACKGROUND_DEPTH = 20.0  # meters (RTree.cpp:325)


class TreeTensors(NamedTuple):
    u: jnp.ndarray        # [N, 2]
    v: jnp.ndarray        # [N, 2]
    thresh: jnp.ndarray   # [N]
    lnode: jnp.ndarray    # [N]
    rnode: jnp.ndarray    # [N]
    leafid: jnp.ndarray   # [N] (-1 internal)
    leaf_data: jnp.ndarray  # [L, num_parts]
    leaf_best: jnp.ndarray  # [L] uint8 argmax part
    leaf_conf: jnp.ndarray  # [L] f32 max leaf probability


def _tree_depth(lnode, rnode, leafid) -> int:
    depth = np.zeros(len(lnode), np.int32)
    maxd = 1
    # nodes are in topological order neither guaranteed; BFS from root
    stack = [(0, 1)]
    while stack:
        n, d = stack.pop()
        maxd = max(maxd, d)
        if leafid[n] < 0:
            stack.append((int(lnode[n]), d + 1))
            stack.append((int(rnode[n]), d + 1))
    return maxd


def walk_pixels(tree: TreeTensors, ys, xs, z, fg, probe_flat,
                probe_shape, max_depth: int, top_left,
                bot_right) -> jnp.ndarray:
    """Tree walk over an arbitrary set of pixels (any shape).

    ys/xs: pixel coordinates in probe-image space; z: their depths (>0
    foreground); fg: bool validity; probe_flat: flattened probe image.
    Returns leaf ids (-1 where not fg).  This is the core of forest_walk,
    exposed separately so callers can walk a *compacted* foreground subset
    instead of a dense grid (the walk is gather-bound: cost scales with
    pixel count, and a tracked window is ~85% background).
    """
    Hp, Wp = probe_shape
    tlx, tly = top_left[0], top_left[1]
    brx, bry = bot_right[0], bot_right[1]
    zsafe = jnp.where(fg, z, 1.0)

    def probe(off):
        px = xs + off[..., 0]
        py = ys + off[..., 1]
        inside = (px >= tlx) & (px <= brx) & (py >= tly) & (py <= bry)
        pz = probe_flat[jnp.clip(py * Wp + px, 0, Hp * Wp - 1)]
        pz = jnp.where(pz == 0.0, BACKGROUND_DEPTH, pz)
        return jnp.where(inside, pz, BACKGROUND_DEPTH)

    as_f = lambda a: jax.lax.bitcast_convert_type(a, jnp.float32)
    packed = jnp.concatenate(
        [tree.u, tree.v, tree.thresh[:, None], as_f(tree.lnode)[:, None],
         as_f(tree.rnode)[:, None], as_f(tree.leafid)[:, None]], axis=1)

    def step(_, node):
        row = packed[node]           # [..., 8] one row gather
        uu = row[..., 0:2]
        vv = row[..., 2:4]
        th = row[..., 4]
        as_i = lambda a: jax.lax.bitcast_convert_type(a, jnp.int32)
        is_leaf = as_i(row[..., 7]) >= 0
        u_off = jnp.round(uu / zsafe[..., None]).astype(jnp.int32)
        v_off = jnp.round(vv / zsafe[..., None]).astype(jnp.int32)
        f = probe(u_off) - probe(v_off)
        nxt = jnp.where(f < th, as_i(row[..., 5]), as_i(row[..., 6]))
        return jnp.where(is_leaf, node, nxt)

    node = jnp.zeros(ys.shape, jnp.int32)
    node = jax.lax.fori_loop(0, max_depth, step, node)
    leaf = tree.leafid[node]
    return jnp.where(fg, leaf, -1)


@functools.partial(jax.jit, static_argnames=("max_depth", "interval"))
def forest_walk(tree: TreeTensors, depth_img: jnp.ndarray, max_depth: int,
                interval: int, top_left, bot_right,
                probe_img: jnp.ndarray | None = None,
                origin=None) -> jnp.ndarray:
    """Per-pixel leaf index over the strided grid.

    depth_img: [H, W] f32; pixels with depth == 0 are background.
    top_left/bot_right: dynamic (x, y) ROI bounds, inclusive; probes outside
    the ROI read BACKGROUND_DEPTH (reference RTree.cpp:3224-3237).
    probe_img/origin: when walking a cropped window of a larger image, pass
    the full image here plus the window's (x, y) origin so probes can reach
    outside the window (ROI bounds are then in probe_img coordinates).
    Returns [H_s, W_s] int32 leaf ids (-1 for background pixels), where the
    strided grid samples pixels (y, x) = origin + (i, j) * interval.
    """
    H, W = depth_img.shape
    Hs = (H + interval - 1) // interval
    Ws = (W + interval - 1) // interval
    if probe_img is None:
        probe_img = depth_img
    if origin is None:
        origin = (jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32))
    Hp, Wp = probe_img.shape
    ys = (jnp.arange(Hs) * interval)[:, None] + origin[1]
    xs = (jnp.arange(Ws) * interval)[None, :] + origin[0]
    tlx, tly = top_left[0], top_left[1]
    brx, bry = bot_right[0], bot_right[1]

    flatw = depth_img.reshape(-1)
    ys_l = (jnp.arange(Hs) * interval)[:, None]
    xs_l = (jnp.arange(Ws) * interval)[None, :]
    z = flatw[jnp.minimum(ys_l * W + xs_l, H * W - 1)]
    fg = (z > 0) & (xs >= tlx) & (xs <= brx) & (ys >= tly) & (ys <= bry)
    ys_b = jnp.broadcast_to(ys, (Hs, Ws))
    xs_b = jnp.broadcast_to(xs, (Hs, Ws))
    return walk_pixels(tree, ys_b, xs_b, z, fg, probe_img.reshape(-1),
                       (Hp, Wp), max_depth, top_left, bot_right)


@functools.partial(jax.jit, static_argnames=("interval",))
def upscale_grid(image: jnp.ndarray, interval: int, top_left, bot_right):
    """Fill stride gaps by repeating the top-left sample of each cell within
    the ROI (reference upscaleGrid, RTree.cpp:70-99)."""
    if interval == 1:
        return image
    H, W = image.shape
    yy = jnp.arange(H)[:, None]
    xx = jnp.arange(W)[None, :]
    src_y = (yy // interval) * interval
    src_x = (xx // interval) * interval
    vals = image[src_y, src_x]
    tlx, tly = top_left[0], top_left[1]
    brx, bry = bot_right[0], bot_right[1]
    inroi = (xx >= tlx) & (xx <= brx) & (yy >= tly) & (yy <= bry)
    # reference only fills cells whose anchor is in the ROI
    anchor_in = (src_x >= tlx) & (src_x <= brx) & (src_y >= tly) & (src_y <= bry)
    return jnp.where(inroi & anchor_in, vals, image)


@functools.partial(jax.jit, static_argnames=("num_parts", "interval"))
def suppress_part_nonmax(strided: jnp.ndarray, com_pre: jnp.ndarray,
                         num_parts: int, interval: int,
                         dist_to_pre_weight: float,
                         origin) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Keep the best-scoring connected blob per part; erase the rest.

    strided: [Hs, Ws] uint8 part labels at stride positions (255 = bg).
    com_pre: [2, num_parts] previous centers of mass in FULL-image pixels
      (x; y), x < 0 marking "unknown".
    origin: (x0, y0) full-image coordinates of strided[0, 0].
    Score = size - dist^2(com, com_pre) * weight  (RTree.cpp:126-210).
    Returns (filtered strided image, new com_pre).
    """
    Hs, Ws = strided.shape
    active = strided != 255
    labels = cc.connected_components(active, values=strided)
    sizes = cc.component_sizes(labels)                      # [Hs*Ws]
    sx, sy = cc.component_centroids(labels)

    flat_lab = labels.reshape(-1)
    root = jnp.where(flat_lab >= 0, flat_lab, Hs * Ws)
    part_of_root = jnp.full(Hs * Ws + 1, 255, jnp.int32).at[root].set(
        strided.reshape(-1).astype(jnp.int32))[:-1]

    szf = sizes.astype(jnp.float32)
    cx = jnp.where(szf > 0, sx / jnp.maximum(szf, 1.0), 0.0)
    cy = jnp.where(szf > 0, sy / jnp.maximum(szf, 1.0), 0.0)
    # convert strided-grid centroids to full-image pixel coordinates
    cx_full = cx * interval + origin[0]
    cy_full = cy * interval + origin[1]

    part_idx = jnp.where(sizes > 0, part_of_root, num_parts)
    prev_x = com_pre[0][jnp.minimum(part_idx, num_parts - 1)]
    prev_y = com_pre[1][jnp.minimum(part_idx, num_parts - 1)]
    has_prev = prev_x >= 0
    d2 = (cx_full - prev_x) ** 2 + (cy_full - prev_y) ** 2
    score = szf - jnp.where(has_prev, d2 * dist_to_pre_weight, 0.0)
    score = jnp.where(sizes > 0, score, -jnp.inf)

    # per-part best root: scatter-max scores, then match
    best = jnp.full(num_parts + 1, -jnp.inf, jnp.float32).at[part_idx].max(
        score)[:num_parts]
    is_best = (score == best[jnp.minimum(part_idx, num_parts - 1)]) & (
        sizes > 0)
    # tie-break by smallest root index
    root_ids = jnp.arange(Hs * Ws, dtype=jnp.int32)
    best_root = jnp.full(num_parts + 1, Hs * Ws, jnp.int32).at[
        jnp.where(is_best, part_idx, num_parts)].min(root_ids)[:num_parts]

    # erase pixels whose component root is not the winner of its part
    pix_root = jnp.where(flat_lab >= 0, flat_lab, 0)
    pix_part = strided.reshape(-1).astype(jnp.int32)
    keep = (flat_lab >= 0) & (
        pix_root == best_root[jnp.minimum(pix_part, num_parts - 1)])
    out = jnp.where(keep, strided.reshape(-1),
                    jnp.uint8(255)).reshape(Hs, Ws)

    # new com_pre: winner centroid per part, or x = -1 if absent
    found = best_root < Hs * Ws
    new_x = jnp.where(found, cx_full[jnp.minimum(best_root, Hs * Ws - 1)], -1.0)
    new_y = jnp.where(found, cy_full[jnp.minimum(best_root, Hs * Ws - 1)], 0.0)
    return out, jnp.stack([new_x, new_y])


@functools.partial(jax.jit, static_argnames=("num_parts", "interval"))
def remove_small_pieces(strided: jnp.ndarray, num_parts: int, interval: int,
                        image_hw, thresh: float = 0.0005) -> jnp.ndarray:
    """Erase connected blobs below thresh * (H*W / interval^2) pixels
    (reference removeSmallPieces, RTree.cpp:245-321)."""
    Hs, Ws = strided.shape
    active = strided != 255
    labels = cc.connected_components(active, values=strided)
    sizes = cc.component_sizes(labels)
    scaled = (image_hw[0] * image_hw[1]).astype(jnp.float32) / (
        interval * interval) * thresh
    flat_lab = labels.reshape(-1)
    sz_of_pix = sizes[jnp.maximum(flat_lab, 0)]
    keep = (flat_lab >= 0) & (sz_of_pix.astype(jnp.float32) >= scaled)
    return jnp.where(keep, strided.reshape(-1), jnp.uint8(255)).reshape(Hs, Ws)


class RTree:
    """Public forest API mirroring the reference class (RTree.h:13-183)."""

    def __init__(self, path_or_parts):
        self.part_map: list = []
        self.partmap_type: int = -1
        self._tree: Optional[TreeTensors] = None
        self._max_depth = 0
        self.num_parts = 0
        self.forest: Optional[formats.ForestData] = None
        if isinstance(path_or_parts, int):
            self.num_parts = path_or_parts
        else:
            self.load_file(str(path_or_parts))

    # -- serialization --------------------------------------------------------

    def load_file(self, path: str) -> bool:
        fd = formats.read_srtr(path)
        self.set_forest(fd)
        import os

        pm_path = path + ".partmap"
        if os.path.exists(pm_path):
            self.part_map, _, self.partmap_type = formats.read_partmap(pm_path)
        return True

    loadFile = load_file

    def load_trainer_checkpoint(self, path: str):
        """Load a reference RTREE_V2/V3 resumable trainer checkpoint
        (RTree.cpp:1964-2130, 2649-2779) as a usable forest.  Frontier
        nodes not yet split get uniform leaf distributions.  Returns the
        parsed state (data source, sample lists, level info) for
        inspection or conversion."""
        with open(path, "rb") as f:
            head = f.read(9)
        if head == b"RTREE_V3 ":
            state = formats.read_rtree_v3(path)
        elif head == b"RTREE_V2 ":
            state = formats.read_rtree_v2(path)
        else:
            raise ValueError(f"{path}: not an RTREE_V2/V3 checkpoint")
        self.set_forest(formats.trainer_checkpoint_to_forest(state))
        return state

    def export_file(self, path: str) -> bool:
        formats.write_srtr(path, self.forest)
        return True

    exportFile = export_file

    def set_forest(self, fd: formats.ForestData) -> None:
        self.forest = fd
        self.num_parts = fd.num_parts
        # leaves self-loop so the fixed-depth walk can't escape them
        n = fd.num_nodes
        self_idx = np.arange(n, dtype=np.int32)
        is_leaf = fd.leafid >= 0
        lnode = np.where(is_leaf, self_idx, fd.lnode)
        rnode = np.where(is_leaf, self_idx, fd.rnode)
        self._max_depth = _tree_depth(fd.lnode, fd.rnode, fd.leafid)
        self._tree = TreeTensors(
            u=jnp.asarray(fd.u), v=jnp.asarray(fd.v),
            thresh=jnp.asarray(fd.thresh),
            lnode=jnp.asarray(lnode, jnp.int32),
            rnode=jnp.asarray(rnode, jnp.int32),
            leafid=jnp.asarray(fd.leafid, jnp.int32),
            leaf_data=jnp.asarray(fd.leaf_data),
            leaf_best=jnp.asarray(np.argmax(fd.leaf_data, axis=1), jnp.uint8),
            leaf_conf=jnp.asarray(
                fd.leaf_data.max(axis=1) if fd.leaf_data.size else
                np.zeros(0), jnp.float32),
        )

    # -- inference -------------------------------------------------------------

    def _roi(self, depth_shape, top_left, bot_right):
        H, W = depth_shape
        if top_left is None:
            top_left = (0, 0)
        if bot_right is None or bot_right[0] == -1:
            bot_right = (W - 1, H - 1)
        return (jnp.asarray(top_left, jnp.int32),
                jnp.asarray(bot_right, jnp.int32))

    def predict_best(self, depth, num_threads: int = 0, interval: int = 1,
                     top_left=None, bot_right=None,
                     fill_in_gaps: bool = True) -> np.ndarray:
        """Best part per pixel: [H, W] uint8 with 255 = background
        (reference RTree.cpp:3184-3262).  num_threads ignored (XLA)."""
        depth = jnp.asarray(depth, jnp.float32)
        tl, br = self._roi(depth.shape, top_left, bot_right)
        leaf = forest_walk(self._tree, depth, self._max_depth, interval,
                           tl, br)
        best = jnp.where(leaf >= 0,
                         self._tree.leaf_best[jnp.maximum(leaf, 0)],
                         jnp.uint8(255))
        out = _strided_to_full(best, depth.shape, interval)
        if fill_in_gaps and interval > 1:
            out = upscale_grid(out, interval, tl, br)
        return np.asarray(out)

    predictBest = predict_best

    def predict(self, depth, interval: int = 1, top_left=None,
                bot_right=None, fill_in_gaps: bool = True) -> np.ndarray:
        """Full leaf distributions: [H, W, num_parts] f32 (zeros at
        background), always at FULL image resolution like predict_best
        (reference RTree.cpp:3156-3182).  With interval > 1, stride gaps are
        filled by repeating each cell's top-left sample (fill_in_gaps=True,
        default) or left as zeros (False)."""
        depth = jnp.asarray(depth, jnp.float32)
        tl, br = self._roi(depth.shape, top_left, bot_right)
        leaf = forest_walk(self._tree, depth, self._max_depth, interval,
                           tl, br)
        dist = self._tree.leaf_data[jnp.maximum(leaf, 0)]
        dist = jnp.where((leaf >= 0)[..., None], dist, 0.0)
        if interval == 1:
            return np.asarray(dist)
        H, W = depth.shape
        Hs, Ws = dist.shape[:2]
        if fill_in_gaps:
            full = jnp.repeat(jnp.repeat(dist, interval, 0), interval, 1)[
                :H, :W]
        else:
            full = jnp.zeros((H, W, dist.shape[-1]), dist.dtype)
            full = full.at[::interval, ::interval].set(dist[:Hs, :Ws])
        return np.asarray(full)

    def post_process(self, image: np.ndarray, com_pre: np.ndarray,
                     interval: int = 1, num_threads: int = 0,
                     top_left=None, bot_right=None,
                     dist_to_pre_weight: float = 0.001) -> np.ndarray:
        """Blob filtering + gap fill (reference RTree.cpp:3422-3450).

        image: [H, W] uint8 labels (modified semantics: returns the result
        instead of in-place).  com_pre: [2, num_parts] float array, updated
        in place like the reference.
        """
        H, W = image.shape
        tl, br = self._roi(image.shape, top_left, bot_right)
        if com_pre.shape != (2, self.num_parts):
            com_pre.resize((2, self.num_parts), refcheck=False)
            com_pre[0, :] = -1.0
            com_pre[1, :] = 0.0
        # The strided grid is anchored at image (0, 0) — consistent with
        # predict_best — with out-of-ROI samples masked to background.  (The
        # reference anchors at top_left instead; the grids differ by a
        # sub-interval offset.)
        strided = np.array(image[::interval, ::interval])
        ys = np.arange(strided.shape[0]) * interval
        xs = np.arange(strided.shape[1]) * interval
        inroi = ((xs[None, :] >= int(tl[0])) & (xs[None, :] <= int(br[0])) &
                 (ys[:, None] >= int(tl[1])) & (ys[:, None] <= int(br[1])))
        strided[~inroi] = 255
        strided = jnp.asarray(strided)
        if self.partmap_type == formats.PARTMAP_CONTIGUOUS:
            filtered, new_com = suppress_part_nonmax(
                strided, jnp.asarray(com_pre, jnp.float32), self.num_parts,
                interval, dist_to_pre_weight,
                jnp.asarray([0, 0], jnp.int32))
            com_pre[:] = np.asarray(new_com)
        else:
            filtered = remove_small_pieces(
                strided, self.num_parts, interval,
                jnp.asarray([H, W], jnp.int32))
        out = np.asarray(image).copy()
        filt = np.asarray(filtered)
        out[::interval, ::interval] = np.where(
            inroi, filt, out[::interval, ::interval])
        if interval > 1:
            out = np.asarray(upscale_grid(jnp.asarray(out), interval, tl, br))
        return out

    postProcess = post_process

    @staticmethod
    def read_part_map(path_or_stream):
        return formats.read_partmap(path_or_stream)

    readPartMap = read_part_map

    # Training entry points live in avatar_tpu.train.forest; thin wrappers
    # are provided there to keep this module inference-only.
    def train_from_avatar(self, *args, **kwargs):
        from avatar_tpu.train.forest import train_from_avatar

        return train_from_avatar(self, *args, **kwargs)

    trainFromAvatar = train_from_avatar

    def train_transfer(self, *args, **kwargs):
        from avatar_tpu.train.forest import train_transfer

        return train_transfer(self, *args, **kwargs)

    trainTransfer = train_transfer

    def train(self, *args, **kwargs):
        from avatar_tpu.train.forest import train_from_files

        return train_from_files(self, *args, **kwargs)


def _strided_to_full(strided, full_shape, interval):
    """Place strided samples back into a full-size image (255 elsewhere)."""
    if interval == 1:
        return strided
    H, W = full_shape
    out = jnp.full((H, W), 255, strided.dtype)
    Hs, Ws = strided.shape
    return out.at[::interval, ::interval].set(strided[:Hs, :Ws])
