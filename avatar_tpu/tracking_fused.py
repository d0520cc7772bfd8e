"""Fully-fused on-device tracking: one jit-compiled program per frame.

The host-orchestrated Tracker (tracking.py) mirrors the reference's stage
structure but pays a host<->device round trip per stage.  This module fuses
the entire frame into a single XLA program:

    XYZ frame -> background-subtraction stencil + gated connected components
    -> forest part segmentation (stride-2 grid) -> per-part blob suppression
    with center-of-mass tracking -> stride-12 sample gather -> fused ICP/LM
    fit

so the only per-frame host traffic is the frame upload and the ~100-float
parameter download.  All shapes are static: the data cloud is the full
stride grid with background samples labeled -1 (the correspondence kernel
masks them), so no dynamic gathers exist anywhere.

The reinitialization state machine stays on the host (it is control flow on
"tracking lost", which needs a host decision anyway); a lost frame costs one
extra fused call after the host resets the pose.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from avatar_tpu.core.model import Avatar, AvatarModel
from avatar_tpu.optim.gauss_newton import FitContext, PriorData, Theta, \
    _forward, extrapolate, fit, fit_refine
from avatar_tpu.perception import cc
from avatar_tpu.perception.rtree import TreeTensors, suppress_part_nonmax
from avatar_tpu.utils import StageTimer


class FrameOut(NamedTuple):
    theta: Theta
    com_pre: jnp.ndarray     # [2, num_parts] (device-chained to next frame)
    labels_strided: jnp.ndarray  # [Hs, Ws] uint8 (diagnostics / viz)
    # ALL host-read diagnostics packed into ONE f32 vector so the host pays
    # a single device->host copy per frame (each separate copy is its own
    # synchronizing transfer):
    #   [0] n_points  [1] cost  [2] n_matched
    #   [3 : 3+G]            part_counts
    #   [3+G : 3+3G]         com_pre (2, G)
    #   [3+3G : 3+8G]        model_com (G, 5): px, py, X, Y, Z at theta0
    #   [3+8G]               root_jump (m)
    #   [3+8G+1]             n_fg (body-gated foreground, data-grid units)
    #   [3+8G+2]             hard_overflow (selective-walk bucket overflow
    #                        fraction; 0 when sel_walk is off)
    host_diag: jnp.ndarray


class HostDiag(NamedTuple):
    n_points: int
    cost: float
    n_matched: int
    part_counts: np.ndarray   # [G]
    com_pre: np.ndarray       # [2, G]
    model_com: np.ndarray     # [G, 5]
    root_jump: float = 0.0    # |delta root| this frame (m)
    n_fg: float = 0.0         # body-gated fg count (data-grid units)
    hard_overflow: float = 0.0  # selective-walk bucket overflow fraction


def unpack_diag(vec, num_parts: int) -> HostDiag:
    a = np.asarray(vec)
    G = num_parts
    return HostDiag(
        n_points=int(a[0]), cost=float(a[1]), n_matched=int(a[2]),
        part_counts=a[3:3 + G],
        com_pre=a[3 + G:3 + 3 * G].reshape(2, G),
        model_com=a[3 + 3 * G:3 + 8 * G].reshape(G, 5),
        root_jump=float(a[3 + 8 * G]) if a.shape[0] > 3 + 8 * G else 0.0,
        n_fg=float(a[3 + 8 * G + 1]) if a.shape[0] > 3 + 8 * G + 1 else 0.0,
        hard_overflow=float(a[3 + 8 * G + 2])
        if a.shape[0] > 3 + 8 * G + 2 else 0.0)


def _bg_subtract(xyz_s, bg_s, nn_t, nb_t, min_pts, cc_sub: int = 4,
                 body_z=None, body_gate=None):
    """Strided background subtraction -> foreground mask [Hs, Ws].

    The per-pixel stencil test runs at full (strided) resolution; the
    component min-size filter runs on a cc_sub-times coarser subgrid (random
    gathers inside the label-propagation loop dominate its cost, and they
    scale with the CC grid size).  min_pts is in coarse-grid pixels.

    When ``body_gate > 0`` (traced scalar, meters), components whose mean
    depth is farther than body_gate from ``body_z`` (the tracked root's
    camera depth) are also rejected.  This is the blob-sanity role the
    reference's per-part CoM tracking plays (live-demo.cpp:250-422): an
    occluder entering the scene is a new foreground component at the wrong
    depth, and without the gate its points capture the ICP fit wholesale
    (measured: 1030 mm joint error in the eval_long occluded phase).  The
    gate is disabled during (re)init, when no valid prior pose exists.
    """
    from avatar_tpu.perception.bgsub import _foreground_mask

    fg = _foreground_mask(bg_s, xyz_s, nn_t)
    if cc_sub <= 1:
        fg_c = fg
        xyz_c = xyz_s
    else:
        fg_c = fg[::cc_sub, ::cc_sub]
        xyz_c = xyz_s[::cc_sub, ::cc_sub]

    def gate(vals, shifted):
        return jnp.sum((vals - shifted) ** 2, axis=-1) <= nb_t * cc_sub

    labels = cc.connected_components(fg_c, values=xyz_c, edge_gate_fn=gate)
    sizes = cc.component_sizes(labels)
    flat = labels.reshape(-1)
    keep_c = (flat >= 0) & (sizes[jnp.maximum(flat, 0)] >= min_pts)
    if body_gate is not None and body_z is not None:
        Hc, Wc = fg_c.shape
        idx = jnp.where(flat >= 0, flat, Hc * Wc)
        zsum = jnp.zeros(Hc * Wc + 1, xyz_c.dtype).at[idx].add(
            xyz_c[..., 2].reshape(-1))[:-1]
        zmean = zsum / jnp.maximum(sizes.astype(xyz_c.dtype), 1)
        near = jnp.abs(zmean - body_z) <= body_gate
        keep_c &= (body_gate <= 0) | near[jnp.maximum(flat, 0)]
    keep_c = keep_c.reshape(fg_c.shape)
    if cc_sub <= 1:
        return keep_c & fg
    keep = jnp.repeat(jnp.repeat(keep_c, cc_sub, 0), cc_sub, 1)
    keep = keep[: fg.shape[0], : fg.shape[1]]
    return keep & fg


def _fused_frame_impl(ctx: FitContext, ctx_fit: Optional[FitContext],
                      tree: Optional[TreeTensors],
                      parents: Tuple[int, ...], depth: jnp.ndarray,
                      labels_full: jnp.ndarray, bg_depth: jnp.ndarray,
                      intrin4: jnp.ndarray, theta0: Theta, com_pre,
                      beta_pose, beta_shape, nn_t, nb_t, min_cc_pts,
                      dist_to_pre_weight, seg_stride: int,
                      data_substride: int,
                      n_steps: int, num_parts: int, max_depth: int,
                      use_forest: bool, use_bgsub: bool, use_jsr: bool,
                      pad_n: int, seg_window=None,
                      conf_thresh=0.0,  # [num_parts] per-group gate vector
                      point_weight: float = 1.0,
                      plane_weight: float = 0.0,
                      huber_k: float = 1.5,
                      robust_per_part: bool = False,
                      use_render_labels: bool = False,
                      render_tau: float = 0.06,
                      beta_temp: float = 0.0,
                      clamp_angle: float = 0.0,
                      boost_n: int = 0,
                      boost_groups: Tuple[int, ...] = (),
                      freeze_shape: bool = False,
                      fit_sorted: bool = False,
                      wild_n: int = 0,
                      wild_gate: float = 0.12,
                      wild_weight: float = 1.0,
                      sel_walk: float = 0.0,
                      body_gate=0.0,
                      ring_faces=None,
                      refine_steps: int = 0,
                      refine_beta=0.1,
                      theta_prev: Optional[Theta] = None,
                      extrap=0.0) -> FrameOut:
    """One tracked frame, fully on device.

    depth [H, W] f32 meters (or uint16 millimeters — converted here), so the
    per-frame host->device upload is minimal; the XYZ map is reconstructed
    on device and only on the strided grid.  labels_full [H, W] uint8 oracle
    labels (used when use_forest=False); bg_depth [H, W] background depth
    (used when use_bgsub); intrin4 = [fx, fy, cx, cy].
    data samples are taken every seg_stride * data_substride pixels.
    """
    H, W = depth.shape[:2]
    fx, fy, cx, cy = intrin4[0], intrin4[1], intrin4[2], intrin4[3]

    # constant-velocity warm start (see gauss_newton.extrapolate).  The
    # root-jump divergence detector below keeps measuring against the
    # PREVIOUS FITTED pose (theta_in), not the prediction -- the detector
    # guards what the fit did, not what the extrapolation guessed.
    theta_in = theta0
    if theta_prev is not None:
        theta0 = extrapolate(theta0, theta_prev, extrap)

    def strided_xyz(d_full):
        d_s = d_full[::seg_stride, ::seg_stride]
        # convert after striding: u16mm -> f32m on the full grid costs ~7 ms
        if d_s.dtype == jnp.uint16:
            d_s = d_s.astype(jnp.float32) * 0.001
        Hs, Ws = d_s.shape
        xs = (jnp.arange(Ws, dtype=d_s.dtype) * seg_stride)[None, :]
        ys = (jnp.arange(Hs, dtype=d_s.dtype) * seg_stride)[:, None]
        return jnp.stack([(xs - cx) * d_s / fx, (ys - cy) * d_s / fy, d_s],
                         axis=-1)

    xyz_s = strided_xyz(depth)                          # [Hs, Ws, 3]
    depth_s = xyz_s[..., 2]

    if use_bgsub:
        # named scopes land in profiler op metadata (tf_op), giving
        # profiling.trace_attribution exact stage buckets
        with jax.named_scope("bgsub"):
            bg_s = strided_xyz(bg_depth)
            # theta0.p is in model space = camera space with y negated
            # (see FusedTracker reinit centroid), so its z IS camera depth
            fg = _bg_subtract(xyz_s, bg_s, nn_t, nb_t, min_cc_pts,
                              body_z=theta0.p[2], body_gate=body_gate)
            depth_s = jnp.where(fg, depth_s, 0.0)
            xyz_s = jnp.where(fg[..., None], xyz_s, 0.0)
    # segmentation on the strided grid
    if use_forest:
        Hs, Ws = depth_s.shape
        tl = jnp.asarray([0, 0], jnp.int32)
        br = jnp.asarray([Ws - 1, Hs - 1], jnp.int32)
        multi = tree.u.ndim == 3          # stacked [T, ...] bagged forest
        # probes/thresholds were trained on full-res pixel units; the strided
        # grid just changes the offsets' pixel scale
        tree_scaled = tree._replace(u=tree.u / seg_stride,
                                    v=tree.v / seg_stride)

        from avatar_tpu.perception.rtree import walk_pixels

        # selective-walk observability: fraction of hard (low-confidence)
        # pixels that overflowed the K/3 bucket and silently degraded to
        # the gated tree-0 label (advisor finding: overflow was invisible)
        diag_cells = {"hard_overflow": jnp.zeros((), jnp.float32)}

        def walk_set(pys, pxs, pz, pfg, pflat, pshape, ptl, pbr):
            """Conf-gated best label over an arbitrary pixel set; probes
            read ``pflat`` (full grid, or the window slab on the windowed
            path — a small gather target instead of the whole frame)."""
            if not multi:
                leaf = walk_pixels(tree_scaled, pys, pxs, pz, pfg,
                                   pflat, pshape, max_depth, ptl, pbr)
                best1 = tree.leaf_best[jnp.maximum(leaf, 0)]
                keep = (leaf >= 0) & (
                    tree.leaf_conf[jnp.maximum(leaf, 0)] >=
                    conf_thresh[best1.astype(jnp.int32)])
                return jnp.where(keep, best1, jnp.uint8(255))
            axes = TreeTensors(*([0] * len(TreeTensors._fields)))
            if sel_walk > 0.0:
                # Selective ensemble walk: the walk is the gather-bound
                # stage (cost ~ trees x pixels x depth) but tree votes only
                # disagree where the problem is hard.  Walk tree 0
                # everywhere; pixels whose tree-0 confidence clears
                # ``sel_walk`` keep the (gated) single-tree label, and only
                # the low-confidence remainder — compacted into a K/3
                # bucket — pays for the full ensemble.  Easy pixels are
                # torso interiors where all trees agree anyway; the hard
                # bucket is exactly the extremity/boundary set that needs
                # the vote.  Overflow past the bucket degrades to the gated
                # tree-0 label (what a single-tree forest would produce).
                first = jax.tree_util.tree_map(lambda a: a[0], tree_scaled)
                leaf0 = walk_pixels(first, pys, pxs, pz, pfg,
                                    pflat, pshape, max_depth, ptl, pbr)
                l0 = jnp.maximum(leaf0, 0)
                best0 = tree.leaf_best[0][l0]
                conf0 = jnp.where(leaf0 >= 0, tree.leaf_conf[0][l0], 0.0)
                easy = (leaf0 >= 0) & (conf0 >= sel_walk)
                K = leaf0.shape[0]
                K2 = max(-(-(K // 3) // 128) * 128, 128)
                hard = pfg & jnp.logical_not(easy)
                n_hard = jnp.sum(hard.astype(jnp.float32))
                diag_cells["hard_overflow"] = (
                    jnp.maximum(n_hard - min(K2, K), 0.0) /
                    jnp.maximum(n_hard, 1.0))
                tie2 = ((jnp.arange(K, dtype=jnp.uint32) *
                         jnp.uint32(2654435761)) &
                        jnp.uint32(0xFFFF)).astype(jnp.float32) / 65536.0
                _, hsel = jax.lax.top_k(
                    hard.astype(jnp.float32) * 2.0 + tie2, min(K2, K))
                hard_sel = hard[hsel]
                rest = jax.tree_util.tree_map(lambda a: a[1:], tree_scaled)
                leafs_h = jax.vmap(
                    lambda tt: walk_pixels(tt, pys[hsel], pxs[hsel],
                                           pz[hsel], hard_sel, pflat,
                                           pshape, max_depth, ptl, pbr),
                    in_axes=(axes,))(rest)             # [T-1, K2]
                dist_h = jax.vmap(lambda lf, ld: jnp.where(
                    (lf >= 0)[..., None], ld[jnp.maximum(lf, 0)], 0.0))(
                    leafs_h, tree.leaf_data[1:])       # [T-1, K2, P]
                lf0_h = leaf0[hsel]
                d0_h = jnp.where((lf0_h >= 0)[..., None],
                                 tree.leaf_data[0][jnp.maximum(lf0_h, 0)],
                                 0.0)
                votes_h = (jnp.sum((leafs_h >= 0).astype(d0_h.dtype), 0)
                           + (lf0_h >= 0))
                dsum_h = jnp.sum(dist_h, axis=0) + d0_h
                conf_h = jnp.max(dsum_h, -1) / jnp.maximum(votes_h, 1.0)
                best_h = jnp.argmax(dsum_h, -1).astype(jnp.uint8)
                keep_h = hard_sel & (votes_h > 0) & (
                    conf_h >= conf_thresh[best_h.astype(jnp.int32)])
                lab_h = jnp.where(keep_h, best_h, jnp.uint8(255))
                keep0 = (leaf0 >= 0) & (
                    conf0 >= conf_thresh[best0.astype(jnp.int32)])
                lab = jnp.where(keep0, best0, jnp.uint8(255))
                return lab.at[hsel].set(
                    jnp.where(hard_sel, lab_h, lab[hsel]))
            # multi-tree: average leaf distributions over trees
            # (rtree-run.cpp:92-121), then argmax + confidence gate
            leafs = jax.vmap(
                lambda tt: walk_pixels(tt, pys, pxs, pz, pfg,
                                       pflat, pshape, max_depth, ptl, pbr),
                in_axes=(axes,))(tree_scaled)          # [T, K]
            dist = jax.vmap(lambda lf, ld: jnp.where(
                (lf >= 0)[..., None], ld[jnp.maximum(lf, 0)], 0.0))(
                leafs, tree.leaf_data)                 # [T, K, P]
            votes = jnp.sum((leafs >= 0).astype(dist.dtype), axis=0)
            dsum = jnp.sum(dist, axis=0)               # [K, P]
            conf = jnp.max(dsum, -1) / jnp.maximum(votes, 1.0)
            best = jnp.argmax(dsum, -1).astype(jnp.uint8)
            keep = (votes > 0) & (conf >= conf_thresh[best.astype(jnp.int32)])
            return jnp.where(keep, best, jnp.uint8(255))

        if seg_window is not None:
            # restrict the walk to a tracked window centered on the
            # previous frame's part centers.  Probes still read the full
            # grid.
            wh, ww = seg_window
            has_com = com_pre[0] >= 0
            n_com = jnp.maximum(jnp.sum(has_com.astype(depth_s.dtype)), 1.0)
            ccx = jnp.sum(jnp.where(has_com, com_pre[0], 0.0)) / n_com
            ccy = jnp.sum(jnp.where(has_com, com_pre[1], 0.0)) / n_com
            any_com = jnp.any(has_com)
            ccx = jnp.where(any_com, ccx / seg_stride, Ws / 2.0)
            ccy = jnp.where(any_com, ccy / seg_stride, Hs / 2.0)
            oy = jnp.clip(ccy.astype(jnp.int32) - wh // 2, 0, Hs - wh)
            ox = jnp.clip(ccx.astype(jnp.int32) - ww // 2, 0, Ws - ww)
            win = jax.lax.dynamic_slice(depth_s, (oy, ox), (wh, ww))
            region, roy, rox, rw = win, oy, ox, ww
        else:
            region, roy, rox, rw = depth_s, 0, 0, Ws
        # Compact the region's foreground pixels into a static bucket and
        # walk only those: the walk is gather-bound (cost ~ pixel count)
        # and even a tracked window is ~85% background.  A person at stride
        # 3 covers ~2-3k pixels; overflow beyond the bucket drops pixels
        # pseudo-randomly (hash-noise tiebreak).
        # the walk is probe-gather-bound: cost scales with WALK_K x trees.
        # A person at stride 3 covers ~2-3k pixels; the tracked window can
        # use a tighter bucket than the full frame (overflow drops pixels
        # pseudo-randomly, degrading like slightly sparser sampling).
        WALK_K = 3072 if seg_window is not None else 4096
        rflat = region.reshape(-1)
        rfg = rflat > 0
        hidx2 = jnp.arange(rflat.shape[0], dtype=jnp.uint32)
        tie = ((hidx2 * jnp.uint32(2654435761)) &
               jnp.uint32(0xFFFF)).astype(jnp.float32) / 65536.0
        _, sel = jax.lax.top_k(rfg.astype(jnp.float32) * 2.0 + tie,
                               min(WALK_K, rflat.shape[0]))
        fg_sel = rfg[sel]
        z_sel = rflat[sel]
        ys_sel = roy + sel // rw
        xs_sel = rox + sel % rw
        with jax.named_scope("forest_walk"):
            if seg_window is not None:
                # probes read the window slab (window-local coordinates).
                # Out-of-window probes return BACKGROUND_DEPTH — exact
                # whenever the tracked foreground lies inside the window
                # (the windowed-path assumption); bgsub already zeroed
                # non-foreground depth, which probe() maps to BACKGROUND
                # anyway, so only stray out-of-window foreground differs.
                wtl = jnp.asarray([0, 0], jnp.int32)
                wbr = jnp.asarray([rw - 1, region.shape[0] - 1], jnp.int32)
                lab_sel = walk_set(sel // rw, sel % rw, z_sel, fg_sel,
                                   rflat, (region.shape[0], rw), wtl, wbr)
            else:
                lab_sel = walk_set(ys_sel, xs_sel, z_sel, fg_sel,
                                   depth_s.reshape(-1), (Hs, Ws), tl, br)
        if seg_window is not None:
            # WINDOW-LOCAL label image: every downstream consumer (blob
            # suppression, render-label fusion, data/boost sampling) reads
            # only inside the tracked window, so none of them should pay
            # full-grid cost — the blob CC loop + its scatter cluster alone
            # are ~2.4 ms/frame on the full 720p stride-3 grid vs ~0.7 ms
            # on the window.  The full-grid image for viz is recreated by
            # one dynamic_update_slice at the end.
            Hl, Wl = seg_window
            pos = jnp.where(fg_sel, sel, Hl * Wl)
            lab_oy, lab_ox = roy, rox
        else:
            Hl, Wl = Hs, Ws
            pos = jnp.where(fg_sel, ys_sel * Ws + xs_sel, Hs * Ws)
            lab_oy, lab_ox = 0, 0
        labels_s = jnp.full(Hl * Wl + 1, 255, jnp.uint8).at[pos].set(
            lab_sel, mode="drop")[:-1].reshape(Hl, Wl)
        depth_l = region if seg_window is not None else depth_s
    else:
        labels_s = labels_full[::seg_stride, ::seg_stride]
        labels_s = jnp.where(depth_s > 0, labels_s, jnp.uint8(255))
        lab_oy, lab_ox = 0, 0
        depth_l = depth_s

    model_com = jnp.full((num_parts, 5), -1.0, depth_s.dtype)
    if use_forest:
        # per-part model centroids at theta0 (for mis-aim detection in the
        # host-side limb recovery)
        from avatar_tpu.render.raster import project_points as _pp

        x_prev0 = _forward(ctx, parents, theta0, use_jsr)[0]
        proj0 = _pp(x_prev0, fx, fy, cx, cy)
        gacc = jnp.zeros((num_parts + 1, 6), depth_s.dtype).at[
            jnp.clip(ctx.model_part, 0, num_parts)].add(
            jnp.concatenate([proj0, x_prev0,
                             jnp.ones_like(proj0[:, :1])], axis=1))
        gn = jnp.maximum(gacc[:num_parts, 5:], 1.0)
        model_com = jnp.where(gacc[:num_parts, 5:] > 0,
                              gacc[:num_parts, :5] / gn, -1.0)

    if use_render_labels:
        # Model-predicted labels: splat the previous pose's vertices into a
        # strided-grid z-buffer (one scatter-min over P points + a 3x3
        # min-pool dilation -- ~10x cheaper than the exact triangle raster,
        # and label coverage only needs vertex density, not exact facets;
        # the reference disabled its analogous CPU render path as too slow,
        # AvatarOptimizer.cpp:1371-1385) and trust the splatted label
        # wherever the measured depth agrees within render_tau.  The forest
        # stays authoritative where the model and data disagree, so drift
        # is still corrected by the independent per-frame signal.
        Hl, Wl = labels_s.shape
        Z_BITS_MAX = float((1 << 17) - 1)
        zq = jnp.clip(x_prev0[:, 2] / 20.0 * float(1 << 17), 1.0,
                      Z_BITS_MAX).astype(jnp.int32)
        key = (zq << 8) | ctx.model_part.astype(jnp.int32)
        # splat into the (possibly window-local) label grid
        px = jnp.round(proj0[:, 0]).astype(jnp.int32) - lab_ox
        py = jnp.round(proj0[:, 1]).astype(jnp.int32) - lab_oy
        ok_v = (px >= 0) & (px < Wl) & (py >= 0) & (py < Hl) & (
            x_prev0[:, 2] > 1e-6)
        flat = jnp.where(ok_v, py * Wl + px, Hl * Wl)
        IMAX = jnp.iinfo(jnp.int32).max
        zbuf = jnp.full(Hl * Wl + 1, IMAX, jnp.int32).at[flat].min(
            key, mode="drop")[:-1].reshape(Hl, Wl)
        # 3x3 min-pool: nearest-depth vertex label wins in each nbhd
        zp = jnp.pad(zbuf, 1, constant_values=IMAX)
        pooled = zbuf
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                if dy == 1 and dx == 1:
                    continue
                pooled = jnp.minimum(
                    pooled, zp[dy:dy + Hl, dx:dx + Wl])
        hit = pooled != IMAX
        rl = jnp.where(hit, (pooled & 0xFF).astype(jnp.uint8),
                       jnp.uint8(255))
        rd = jnp.where(hit, (pooled >> 8).astype(depth_s.dtype) *
                       (20.0 / float(1 << 17)), 0.0)
        agree = (depth_l > 0) & hit & (jnp.abs(depth_l - rd) < render_tau)
        labels_s = jnp.where(agree, rl, labels_s)

    # blob suppression + CoM tracking (contiguous part maps) on a 2x coarser
    # subgrid (CC cost scales with grid size; part blobs are large).  On the
    # windowed path labels_s is window-local; the origin argument keeps the
    # returned CoMs in full-grid pixel coordinates.
    blob_sub = 2
    lab_c = labels_s[::blob_sub, ::blob_sub]
    with jax.named_scope("blob_suppress"):
        filt_c, com_new = suppress_part_nonmax(
            lab_c, com_pre, num_parts, seg_stride * blob_sub,
            dist_to_pre_weight,
            jnp.stack([jnp.asarray(lab_ox, jnp.int32) * seg_stride,
                       jnp.asarray(lab_oy, jnp.int32) * seg_stride]))
    filt_up = jnp.repeat(jnp.repeat(filt_c, blob_sub, 0), blob_sub, 1)[
        : labels_s.shape[0], : labels_s.shape[1]]
    labels_s = jnp.where(filt_up == labels_s, labels_s, jnp.uint8(255))

    # stride-sampled data cloud: every data_substride-th strided sample.
    # With a tracked window active, everything outside it is background by
    # construction — labels_s is already the window slice, and the XYZ grid
    # is sliced to match, so the fit's static bucket (and the NN search) is
    # ~4x smaller.
    if use_forest and seg_window is not None:
        xyz_src = jax.lax.dynamic_slice(
            xyz_s, (oy, ox, jnp.asarray(0, oy.dtype)),
            (seg_window[0], seg_window[1], 3))
        lab_src = labels_s
    else:
        xyz_src = xyz_s
        lab_src = labels_s
    sub_xyz = xyz_src[::data_substride, ::data_substride]
    sub_lab = lab_src[::data_substride, ::data_substride]
    pts = sub_xyz.reshape(-1, 3)
    pts = jnp.stack([pts[:, 0], -pts[:, 1], pts[:, 2]], axis=1)
    parts = sub_lab.reshape(-1).astype(jnp.int32)
    parts = jnp.where((sub_xyz[..., 2] > 0).reshape(-1), parts, -1)
    parts = jnp.where(parts == 255, -1, parts)

    if boost_n:
        # Extremity-dense sampling: thin structures (forearms, hands, feet)
        # get a handful of samples on the coarse data grid, so their joints
        # are fit from ~5 points while the torso gets hundreds.  Gather up
        # to boost_n extra samples of the boosted groups at FULL (un-
        # substrided) segmentation resolution via a static top-k (priority =
        # group membership + a hash-noise tiebreak so the picks spread over
        # the limb instead of clustering at low indices).
        flat_lab = lab_src.reshape(-1).astype(jnp.int32)
        flat_z = xyz_src[..., 2].reshape(-1)
        is_b = jnp.zeros(flat_lab.shape, jnp.bool_)
        for g in boost_groups:
            is_b = is_b | (flat_lab == g)
        is_b = is_b & (flat_z > 0)
        hidx = jnp.arange(flat_lab.shape[0], dtype=jnp.uint32)
        noise = ((hidx * jnp.uint32(2654435761)) &
                 jnp.uint32(0xFFFF)).astype(jnp.float32) / 65536.0
        _, top = jax.lax.top_k(is_b.astype(jnp.float32) * 2.0 + noise,
                               boost_n)
        bx = xyz_src.reshape(-1, 3)[top]
        bl = jnp.where(is_b[top], flat_lab[top], -1)
        pts = jnp.concatenate(
            [pts, jnp.stack([bx[:, 0], -bx[:, 1], bx[:, 2]], axis=1)])
        parts = jnp.concatenate([parts, bl])

    if wild_n and use_forest:
        # Wildcard channel: foreground pixels whose forest label was
        # confidence-gated to background become label-free ICP support
        # (part id == num_parts; see gauss_newton.fit wild_gate docs).
        # Same static-top-k sampling as the extremity boost.
        flat_lab_w = lab_src.reshape(-1).astype(jnp.int32)
        flat_z_w = xyz_src[..., 2].reshape(-1)
        is_w = (flat_lab_w == 255) & (flat_z_w > 0)
        hidx_w = jnp.arange(flat_lab_w.shape[0], dtype=jnp.uint32)
        noise_w = ((hidx_w * jnp.uint32(2246822519)) &
                   jnp.uint32(0xFFFF)).astype(jnp.float32) / 65536.0
        _, topw = jax.lax.top_k(is_w.astype(jnp.float32) * 2.0 + noise_w,
                                wild_n)
        wx = xyz_src.reshape(-1, 3)[topw]
        wl = jnp.where(is_w[topw], num_parts, -1)
        pts = jnp.concatenate(
            [pts, jnp.stack([wx[:, 0], -wx[:, 1], wx[:, 2]], axis=1)])
        parts = jnp.concatenate([parts, wl])

    n_points = jnp.sum(((parts >= 0) & (parts < num_parts)).astype(
        jnp.int32))
    # body-consistent foreground count in data-grid units: the presence
    # signal for loss detection.  Labeled-point count alone starves under
    # partial occlusion (the occluder hides the torso, the forest's
    # extremity labels are conf-gated, and a healthy fit gets declared
    # lost); the reference's reinitCnz counts foreground nonzeros too.
    # Post-body-gate, fg is body-consistent by construction; 0 when bgsub
    # is off (label count is then the only presence signal).
    if use_bgsub:
        n_fg = (jnp.sum((depth_s > 0).astype(jnp.float32)) /
                float(data_substride * data_substride))
    else:
        n_fg = jnp.zeros((), jnp.float32)

    # pad to the static bucket
    N = pts.shape[0]
    if N < pad_n:
        pts = jnp.concatenate([pts, jnp.zeros((pad_n - N, 3), pts.dtype)])
        parts = jnp.concatenate(
            [parts, jnp.full((pad_n - N,), -1, jnp.int32)])

    with jax.named_scope("fit"):
        theta, diag = fit(ctx_fit if ctx_fit is not None else ctx, parents,
                          pts, parts, theta0, beta_pose,
                          beta_shape, n_steps=n_steps, use_jsr=use_jsr,
                          num_parts=num_parts, point_weight=point_weight,
                          plane_weight=plane_weight, huber_k=huber_k,
                          robust_per_part=robust_per_part,
                          beta_temp=beta_temp, clamp_angle=clamp_angle,
                          freeze_shape=freeze_shape,
                          model_sorted=fit_sorted and ctx_fit is not None,
                          wild_gate=wild_gate, wild_weight=wild_weight)
    if refine_steps > 0 and ring_faces is not None:
        # Optional per-frame exactness stage: re-fit the SAME data bucket
        # against the mesh SURFACE (point-to-triangle, optim/surface.py)
        # starting from the tracked pose.  The main fit's point-to-vertex
        # optimum carries a vertex-spacing bias of a few millimeters; this
        # removes it on the product path, not just in the offline probe.
        # Priors are scaled down by refine_beta (exactness is the goal;
        # the tracking regularizers deliberately bias toward the prior).
        with jax.named_scope("refine"):
            theta, _ = fit_refine(
                ctx, parents, ring_faces, pts, parts, theta,
                beta_pose * refine_beta, beta_shape * refine_beta,
                n_steps=refine_steps, num_parts=num_parts,
                wild=num_parts, wild_gate2=wild_gate * wild_gate,
                freeze_shape=freeze_shape)
    host_diag = jnp.concatenate([
        n_points[None].astype(depth_s.dtype),
        diag.cost[None].astype(depth_s.dtype),
        diag.n_matched[None].astype(depth_s.dtype),
        diag.part_counts.astype(depth_s.dtype),
        com_new.astype(depth_s.dtype).reshape(-1),
        model_com.astype(depth_s.dtype).reshape(-1),
        # root translation this frame (meters): the host's divergence
        # detector (TrackerConfig.max_root_jump) reads it for free from
        # the one packed diag copy
        jnp.linalg.norm(theta.p - theta_in.p)[None].astype(depth_s.dtype),
        n_fg[None].astype(depth_s.dtype),
        (diag_cells["hard_overflow"] if use_forest
         else jnp.zeros((), jnp.float32))[None].astype(depth_s.dtype)])
    if use_forest and seg_window is not None:
        # recreate the full-grid label image for viz/diagnostics (one cheap
        # window-sized copy; everything outside the window is background)
        labels_out = jax.lax.dynamic_update_slice(
            jnp.full((Hs, Ws), 255, jnp.uint8), labels_s, (oy, ox))
    else:
        labels_out = labels_s
    return FrameOut(theta=theta, com_pre=com_new,
                    labels_strided=labels_out, host_diag=host_diag)


fused_frame = functools.partial(jax.jit, static_argnames=(
    "parents", "seg_stride", "data_substride", "n_steps", "num_parts",
    "max_depth", "use_forest", "use_bgsub", "use_jsr", "pad_n",
    "seg_window", "robust_per_part", "use_render_labels", "boost_n",
    "boost_groups", "freeze_shape", "fit_sorted", "wild_n",
    "sel_walk", "refine_steps"))(_fused_frame_impl)


@functools.partial(
    jax.jit,
    static_argnames=("parents", "seg_stride", "data_substride", "n_steps",
                     "num_parts", "max_depth", "use_forest", "use_bgsub",
                     "use_jsr", "pad_n", "seg_window", "robust_per_part",
                     "use_render_labels", "boost_n", "boost_groups",
                     "freeze_shape", "fit_sorted", "wild_n",
                     "sel_walk", "refine_steps"))
def fused_frames_batch(ctx, ctx_fit, tree, parents, depth_b, labels_b,
                       bg_depth, intrin4, theta0: Theta, com_pre,
                       beta_pose, beta_shape, nn_t, nb_t, min_cc_pts,
                       dist_to_pre_weight, seg_stride: int,
                       data_substride: int, n_steps: int, num_parts: int,
                       max_depth: int, use_forest: bool, use_bgsub: bool,
                       use_jsr: bool, pad_n: int, seg_window=None,
                       conf_thresh=0.0, point_weight: float = 1.0,
                       plane_weight: float = 0.0, huber_k: float = 1.5,
                       robust_per_part: bool = False,
                       use_render_labels: bool = False,
                       render_tau: float = 0.06, beta_temp: float = 0.0,
                       clamp_angle: float = 0.0, boost_n: int = 0,
                       boost_groups: Tuple[int, ...] = (),
                       freeze_shape: bool = False,
                       fit_sorted: bool = False,
                       wild_n: int = 0, wild_gate: float = 0.12,
                       wild_weight: float = 1.0,
                       sel_walk: float = 0.0, body_gate=0.0,
                       ring_faces=None, refine_steps: int = 0,
                       refine_beta=0.1, theta_prev0: Optional[Theta] = None,
                       extrap=0.0):
    """Track a whole BATCH of consecutive frames in one dispatch.

    A lax.scan over _fused_frame_impl carrying (theta, com_pre): one upload
    + one execute per N frames instead of per frame removes N-1 dispatches
    and transfers even though the device work is identical.
    Returns (thetas stacked [B, ...], host_diag [B, D]); the per-frame
    label images are not materialized (viz uses the single-frame path).
    """
    def step(carry, inp):
        th, th_prev, com = carry
        d_i, l_i = inp
        out = _fused_frame_impl(
            ctx, ctx_fit, tree, parents, d_i, l_i, bg_depth, intrin4,
            th, com, beta_pose, beta_shape, nn_t, nb_t, min_cc_pts,
            dist_to_pre_weight, seg_stride, data_substride, n_steps,
            num_parts, max_depth, use_forest, use_bgsub, use_jsr, pad_n,
            seg_window, conf_thresh, point_weight, plane_weight, huber_k,
            robust_per_part, use_render_labels, render_tau, beta_temp,
            clamp_angle, boost_n, boost_groups, freeze_shape, fit_sorted,
            wild_n, wild_gate, wild_weight,
            sel_walk=sel_walk, body_gate=body_gate,
            ring_faces=ring_faces, refine_steps=refine_steps,
            refine_beta=refine_beta, theta_prev=th_prev, extrap=extrap)
        return ((out.theta, th, out.com_pre),
                (out.theta, out.host_diag))

    tp0 = theta0 if theta_prev0 is None else theta_prev0
    (theta_f, theta_prev_f, com_f), (thetas, diags) = jax.lax.scan(
        step, (theta0, tp0, com_pre), (depth_b, labels_b))
    return thetas, diags, theta_f, com_f, theta_prev_f


def _group_tree(t: TreeTensors, lut: np.ndarray, ng: int) -> TreeTensors:
    """Fold a tree's leaf part distributions into matching groups (argmax
    and confidence recomputed group-wise; see perception/partgroups.py)."""
    from avatar_tpu.perception.partgroups import fold_leaf_data

    ld = np.asarray(t.leaf_data)
    if ld.size == 0:
        return t
    gld = fold_leaf_data(ld, lut, ng)
    return t._replace(
        leaf_data=jnp.asarray(gld),
        leaf_best=jnp.asarray(gld.argmax(1).astype(np.uint8)),
        leaf_conf=jnp.asarray(gld.max(1).astype(np.float32)))


def _reweight_tree(t: TreeTensors, alpha: float) -> TreeTensors:
    """Inference-side class rebalancing: scale leaf distributions by
    inverse class frequency^alpha and renormalize.

    Rare classes (hands, feet — a few hundred pixels vs the torso's tens
    of thousands) lose the leaf argmax to their large neighbors even when
    the leaf clearly separates them.  Reweighting at inference shifts the
    decision boundary toward rare classes WITHOUT retraining, and unlike
    training-time balanced sampling (which moves the learned split
    structure itself) it is continuously tunable and reversible.  The
    class prior is estimated from the forest's own leaves (mean leaf
    distribution — a proxy for the training pixel distribution)."""
    ld = np.asarray(t.leaf_data)
    if ld.size == 0 or alpha <= 0:
        return t
    freq = ld.mean(axis=0)
    freq = freq / max(freq.sum(), 1e-12)
    w = np.power(np.maximum(freq, 1e-6), -alpha)
    g = ld * w
    g = g / np.maximum(g.sum(axis=1, keepdims=True), 1e-12)
    g = g.astype(np.float32)
    return t._replace(
        leaf_data=jnp.asarray(g),
        leaf_best=jnp.asarray(g.argmax(axis=1).astype(np.uint8)),
        leaf_conf=jnp.asarray(g.max(axis=1)))


def _stack_trees(trees, stride: int) -> TreeTensors:
    """Stack per-tree tensors into [T, ...] arrays (node/leaf axes padded
    to the largest tree; padding nodes self-loop and padding leaves carry
    zero distributions, so they never influence the vote)."""
    Nmax = max(t.u.shape[0] for t in trees)
    Lmax = max(t.leaf_data.shape[0] for t in trees)

    def pad_nodes(a, n, fill):
        pad = Nmax - n
        if pad == 0:
            return a
        shape = (pad,) + tuple(a.shape[1:])
        return jnp.concatenate([a, jnp.full(shape, fill, a.dtype)])

    stacked = []
    for t in trees:
        n = t.u.shape[0]
        ld = t.leaf_data
        lpad = Lmax - ld.shape[0]
        if lpad:
            ld = jnp.concatenate(
                [ld, jnp.zeros((lpad, ld.shape[1]), ld.dtype)])
        self_idx = jnp.arange(n, Nmax, dtype=jnp.int32)
        lnode = jnp.concatenate([t.lnode, self_idx]) if n < Nmax else t.lnode
        rnode = jnp.concatenate([t.rnode, self_idx]) if n < Nmax else t.rnode
        lb = t.leaf_best
        lc = t.leaf_conf
        if lpad:
            lb = jnp.concatenate([lb, jnp.zeros(lpad, lb.dtype)])
            lc = jnp.concatenate([lc, jnp.zeros(lpad, lc.dtype)])
        stacked.append(TreeTensors(
            u=pad_nodes(t.u / stride, n, 0.0),
            v=pad_nodes(t.v / stride, n, 0.0),
            thresh=pad_nodes(t.thresh, n, 0.0),
            lnode=lnode, rnode=rnode,
            leafid=pad_nodes(t.leafid, n, -1),
            leaf_data=ld, leaf_best=lb, leaf_conf=lc))
    return TreeTensors(*[jnp.stack([getattr(s, f) for s in stacked])
                         for f in TreeTensors._fields])


class FusedTracker:
    """Drop-in high-performance tracker (same semantics as tracking.Tracker
    with contiguous part maps; forest or oracle labels)."""

    def __init__(self, model: AvatarModel, intrin, image_size, rtree=None,
                 config=None):
        """rtree: an RTree, or a sequence of RTrees for a bagged forest
        whose leaf distributions are averaged at inference (the reference
        ships 3-tree releases; rtree-run.cpp:92-121)."""
        from avatar_tpu.tracking import TrackerConfig

        self.model = model
        self.intrin = intrin
        self.image_size = tuple(image_size)
        self.config = config or TrackerConfig()
        rtrees = (list(rtree) if isinstance(rtree, (list, tuple))
                  else ([rtree] if rtree is not None else []))
        self.rtrees = rtrees
        rtree = rtrees[0] if rtrees else None
        self.rtree = rtree
        self.ava = Avatar(model)
        self.timer = StageTimer()

        num_parts = rtree.num_parts if rtree is not None else model.num_joints()
        part_map = (np.asarray(rtree.part_map, np.int32)
                    if rtree is not None and len(rtree.part_map)
                    else np.arange(model.num_joints(), dtype=np.int32))
        model_part = part_map[model.main_joint]
        # group-level correspondence (perception/partgroups.py): fold part
        # labels -- model-side, forest leaves, and oracle masks -- through
        # the group LUT so matching happens at group granularity
        self._glut = None
        tree_grouped = False
        if self.config.part_groups is not None:
            self._glut = np.asarray(self.config.part_groups, np.int32)
            ng = int(self._glut.max()) + 1
            # a forest trained directly in group space ships the group LUT
            # as its .partmap sidecar (the reference's part-map mechanism,
            # RTree.h:150-166); its leaves need no folding and model_part
            # is already group-valued via part_map above.  Mixed bags
            # (grouped + ungrouped trees) are handled per tree below.
            tree_grouped = (rtree is not None and
                            np.array_equal(part_map[:len(self._glut)],
                                           self._glut))
            if not tree_grouped:
                model_part = self._glut[model_part]
            num_parts = ng
        self._tree_grouped = tree_grouped
        self.num_parts = num_parts
        if model.pose_prior is None:
            raise ValueError("FusedTracker requires a model pose prior")
        self._ctx = FitContext(
            lbs=model.params,
            anc_mask=jnp.asarray(model.ancestor_mask, model.dtype),
            faces=jnp.asarray(model.faces, jnp.int32),
            model_part=jnp.asarray(model_part, jnp.int32),
            prior=PriorData(model.pose_prior.means,
                            model.pose_prior.prec_cho,
                            model.pose_prior.consts_log),
        )
        # vertex-subset fit context (see TrackerConfig.fit_vertex_stride):
        # every k-th vertex, with rest-pose normals precomputed on the FULL
        # mesh (subset vertices don't form a mesh) at w=0 -- shape-key
        # normal deviation is negligible for occlusion/plane purposes
        fvs = max(1, int(getattr(self.config, "fit_vertex_stride", 1)))
        self._ctx_fit = None
        self._fit_sorted = False
        # Dedicated fit context: every fvs-th vertex, PART-SORTED so the
        # NN plan's model permutation is identity (drops one [P,3] + one
        # [P] gather per LM step and the corr un-permutation), with
        # rest-pose normals precomputed on the FULL mesh (subset vertices
        # don't form a mesh) at w=0.
        # Non-JSR models regress joints from the full vertex set: a strict
        # subset would corrupt them, but a pure permutation (fvs == 1)
        # reorders the regressor columns consistently, so sorting is
        # always legal at fvs == 1.
        if fvs == 1 or model.use_joint_shape_regressor:
            lp = model.params
            vt = np.asarray(lp.v_template)
            fc = np.asarray(model.faces)
            fn = np.cross(vt[fc[:, 1]] - vt[fc[:, 0]],
                          vt[fc[:, 2]] - vt[fc[:, 0]])
            n0 = np.zeros_like(vt)
            for k in range(3):
                np.add.at(n0, fc[:, k], fn)
            n0 /= np.maximum(np.linalg.norm(n0, axis=1, keepdims=True),
                             1e-12)
            sel = np.arange(0, vt.shape[0], fvs)
            mp_sel = np.asarray(self._ctx.model_part)[sel]
            idx = sel[np.argsort(mp_sel, kind="stable")]
            from avatar_tpu.core.lbs import LBSParams

            lbs_sub = LBSParams(
                v_template=jnp.asarray(vt[idx], model.dtype),
                shapedirs=jnp.asarray(np.asarray(lp.shapedirs)[idx],
                                      model.dtype),
                weights=jnp.asarray(np.asarray(lp.weights)[idx],
                                    model.dtype),
                joint_reg=jnp.asarray(np.asarray(lp.joint_reg)[:, idx],
                                      model.dtype),
                joint_shape_reg_base=lp.joint_shape_reg_base,
                joint_shape_reg=lp.joint_shape_reg)
            self._ctx_fit = self._ctx._replace(
                lbs=lbs_sub,
                model_part=jnp.asarray(
                    np.asarray(self._ctx.model_part)[idx], jnp.int32),
                n_rest=jnp.asarray(n0[idx], model.dtype))
            self._fit_sorted = True
        self._max_depth = (max(t._max_depth for t in rtrees)
                           if rtrees else 0)
        self._use_bgsub = False
        self.com_pre = jnp.asarray(
            np.concatenate([np.full((1, num_parts), -1.0),
                            np.zeros((1, num_parts))]), model.dtype)
        self.reinit = True
        self.first_init = True
        self._lost_count = 0      # consecutive coasted (root-jump) frames
        self._lost_frames = 0     # frames since tracking was lost
        self._last_root_z = None  # last-known body camera depth (m)
        self._frame_no = 0        # steady-state frame counter (refine cadence)
        # countdown to the one-shot post-reinit shape refit (None = no
        # refit pending; armed on every successful (re)init when
        # config.shape_refit_after > 0)
        self._shape_refit_in: Optional[int] = None
        if self.config.refine_every > 0:
            from avatar_tpu.optim.surface import vertex_face_rings

            self._ring = jnp.asarray(vertex_face_rings(
                np.asarray(model.faces), model.num_points()))
        else:
            self._ring = None
        self.limb_recoveries: dict = {}   # group id -> recovery event count
        self._theta = Theta(
            p=jnp.zeros(3, model.dtype),
            rots=jnp.asarray(np.tile(np.eye(3), (model.num_joints(), 1, 1)),
                             model.dtype),
            w=jnp.zeros(model.num_shape_keys(), model.dtype))
        # one frame behind self._theta: the constant-velocity warm start's
        # finite-difference anchor (equal to _theta == zero velocity
        # whenever the pose chain restarts: init, reinit, rejected frames)
        self._theta_prev = self._theta

        c = self.config
        H, W = self.image_size
        ss = c.rtree_interval
        # nothing downstream reads finer than the segmentation stride, so
        # the host pre-strides every frame before upload (1.8 MB -> ~0.2 MB
        # at stride 3) and the device pipeline runs on the strided grid with
        # correspondingly scaled intrinsics and forest probe offsets
        self._host_stride = ss
        self._proc_size = ((H + ss - 1) // ss, (W + ss - 1) // ss)
        self._seg_stride = 1
        self._intrin4 = jnp.asarray(
            [intrin.fx / ss, intrin.fy / ss, intrin.cx / ss, intrin.cy / ss],
            model.dtype)
        trees_t = []
        for rt in rtrees:
            t = rt._tree
            if (self._glut is not None and
                    rt.num_parts == len(self._glut)):
                t = _group_tree(t, self._glut, self.num_parts)
            elif self._glut is not None and rt.num_parts != self.num_parts:
                raise ValueError(
                    f"tree with {rt.num_parts} parts fits neither the "
                    f"source ({len(self._glut)}) nor group "
                    f"({self.num_parts}) label space")
            if c.label_class_balance > 0:
                t = _reweight_tree(t, c.label_class_balance)
            trees_t.append(t)
        if len(trees_t) > 1:
            self._tree = _stack_trees(trees_t, ss)
        elif trees_t:
            t = trees_t[0]
            self._tree = t._replace(u=t.u / ss, v=t.v / ss)
        else:
            self._tree = None
        self._bg = jnp.zeros(self._proc_size, model.dtype)
        dsub = max(c.data_interval // ss, 1)
        self._data_substride = dsub
        self._boost_cfg = (c.extremity_boost_n
                           if self._glut is not None else 0)
        self._wild_cfg = (c.wild_n if self._glut is not None
                          and self._tree is not None else 0)
        Hs, Ws = self._proc_size
        n_data = ((Hs + dsub - 1) // dsub) * ((Ws + dsub - 1) // dsub)
        (self._pad_n, self._boost_n,
         self._wild_n) = self._fit_bucket(n_data)

    def _fit_bucket(self, n_data: int) -> Tuple[int, int, int]:
        """(pad_n, boost_n, wild_n) for a fit over ``n_data`` grid samples.

        pad_n is the power-of-two static bucket.  The extremity boost and
        the wildcard channel are clamped into the bucket's slack when
        crossing a power-of-two boundary would be mostly padding: doubling
        pad_n doubles every data-axis op in the NN kernel and fit loop,
        which is never worth a handful of extra samples.
        """
        want_b = self._boost_cfg
        want_w = self._wild_cfg
        pad = 1024
        while pad < n_data:
            pad *= 2
        slack = pad - n_data
        want = want_b + want_w
        if want > slack and slack < want // 2:
            pad *= 2
            slack = pad - n_data
        boost_n = min(want_b, slack)
        return pad, boost_n, min(want_w, slack - boost_n)

    def _pre_stride(self, arr: np.ndarray) -> np.ndarray:
        s = self._host_stride
        return arr if s == 1 else np.ascontiguousarray(arr[::s, ::s])

    def _zero_labels(self):
        z = getattr(self, "_zero_labels_arr", None)
        if z is None:
            z = self._zero_labels_arr = jnp.zeros(self._proc_size, jnp.uint8)
        return z

    def _map_labels(self, labels: np.ndarray) -> np.ndarray:
        """Host-side part->group mapping of an oracle label image."""
        if self._glut is None:
            return labels
        from avatar_tpu.perception.partgroups import group_label_lut

        lut = getattr(self, "_label_lut", None)
        if lut is None:
            lut = self._label_lut = group_label_lut(self._glut)
        return lut[labels]

    def set_background(self, background_xyz: np.ndarray) -> None:
        """Accepts an XYZ map [H, W, 3] or a depth map [H, W]."""
        bg = np.asarray(background_xyz)
        if bg.ndim == 3:
            bg = bg[..., 2]
        self._bg = jnp.asarray(self._pre_stride(bg), self.model.dtype)
        self._use_bgsub = True

    def _consts(self):
        """Per-config device scalars, cached: converting ~10 scalars per
        call costs ~8 ms/frame of host dispatch overhead (profiled)."""
        consts = getattr(self, "_run_consts", None)
        if consts is None:
            c = self.config
            H, W = self.image_size
            hs = self._host_stride
            scale = 1200000.0 / (H * W)
            min_cc = max(H * W // 1000, 100) // (hs * hs * 16)
            dt = self.model.dtype
            consts = self._run_consts = dict(
                beta_pose=jnp.asarray(c.beta_pose, dt),
                beta_shape=jnp.asarray(c.beta_shape, dt),
                nn_t=jnp.asarray(scale * c.nn_dist_thresh_rel, dt),
                nb_t=jnp.asarray(scale * c.neighb_thresh_rel, dt),
                min_cc=jnp.asarray(min_cc, jnp.int32),
                d2p=jnp.asarray(c.dist_to_pre_weight, dt),
                point_weight=jnp.asarray(c.point_weight, dt),
                plane_weight=jnp.asarray(c.plane_weight, dt),
                huber_k=jnp.asarray(c.huber_k, dt),
                render_tau=jnp.asarray(c.render_label_tau, dt),
                beta_temp=jnp.asarray(c.beta_temp, dt),
                clamp_angle=jnp.asarray(c.pose_clamp_angle, dt),
                wild_gate=jnp.asarray(c.wild_gate, dt),
                wild_weight=jnp.asarray(c.wild_weight, dt),
                body_gate=jnp.asarray(c.body_gate, dt),
                refine_beta=jnp.asarray(c.refine_beta, dt),
                extrap=jnp.asarray(c.extrapolate_pose, dt),
                zero=jnp.asarray(0.0, dt))
            # per-group confidence gate: relaxed for the diffuse extremity
            # groups (see TrackerConfig.label_conf_low); group ids only
            # mean anything when group matching is on
            cv = np.full(self.num_parts, c.label_conf_thresh, np.float32)
            if self._glut is not None:
                for g in c.label_conf_low_groups:
                    if 0 <= g < self.num_parts:
                        cv[g] = c.label_conf_low
            consts["conf_vec"] = jnp.asarray(cv)
        return consts

    def _run(self, xyz, labels, n_steps, **kw):
        """Dispatch one fused frame (see _frame_args for ``kw``)."""
        args, kwargs = self._frame_args(xyz, labels, n_steps, **kw)
        return fused_frame(*args, **kwargs)

    def lower_frame(self, xyz, labels, n_steps, **kw):
        """The fused frame program _run would dispatch, lowered (not run):
        ``.as_text()`` shows the program, ``.compile()`` its executable."""
        args, kwargs = self._frame_args(xyz, labels, n_steps, **kw)
        return fused_frame.lower(*args, **kwargs)

    def _frame_args(self, xyz, labels, n_steps, use_window=True,
                    render_labels=True, is_reinit=False, reinit_gated=False,
                    refine=False, fit_shape=False):
        """(args, kwargs) of fused_frame for one frame in the current
        tracking state."""
        c = self.config
        hs = self._host_stride
        window = None
        pad_n, boost_n, wild_n = (self._pad_n, self._boost_n,
                                  self._wild_n)
        if (use_window and c.seg_window is not None and
                self.rtree is not None):
            Hs, Ws = self._proc_size
            window = (min(c.seg_window[0] // hs, Hs),
                      min(c.seg_window[1] // hs, Ws))
            dsub = self._data_substride
            n_data = (-(-window[0] // dsub)) * (-(-window[1] // dsub))
            pad_n, boost_n, wild_n = self._fit_bucket(n_data)
        consts = self._consts()
        args = (self._ctx, self._ctx_fit, self._tree,
                self.model.parents, xyz, labels, self._bg,
                self._intrin4, self._theta, self.com_pre,
                consts["beta_pose"], consts["beta_shape"],
                consts["nn_t"], consts["nb_t"], consts["min_cc"],
                consts["d2p"])
        return args, dict(
            seg_stride=self._seg_stride, data_substride=self._data_substride,
            n_steps=n_steps, num_parts=self.num_parts,
            max_depth=self._max_depth,
            use_forest=self.rtree is not None,
            use_bgsub=self._use_bgsub,
            use_jsr=self.model.use_joint_shape_regressor,
            pad_n=pad_n, seg_window=window,
            conf_thresh=consts["conf_vec"],
            point_weight=consts["point_weight"],
            plane_weight=consts["plane_weight"],
            huber_k=consts["huber_k"],
            robust_per_part=c.robust_per_part,
            use_render_labels=(render_labels and c.render_labels and
                               self.rtree is not None),
            render_tau=consts["render_tau"],
            # the temporal prior anchors to theta0 == the artificial reset
            # pose during reinit, which would fight the exploration the
            # reinit fit exists to do
            beta_temp=consts["zero"] if is_reinit else consts["beta_temp"],
            clamp_angle=(consts["zero"] if is_reinit
                         else consts["clamp_angle"]),
            boost_n=boost_n,
            boost_groups=tuple(c.extremity_boost_groups),
            # steady-state frames solve in the reduced [dp | dr] tangent;
            # shape keys are fit during (re)init frames and the one-shot
            # post-reinit refit frame (config.shape_refit_after) only
            freeze_shape=not (is_reinit or fit_shape),
            fit_sorted=self._fit_sorted,
            wild_n=wild_n, wild_gate=consts["wild_gate"],
            wild_weight=consts["wild_weight"],
            sel_walk=float(c.selective_walk),
            # no valid prior pose during a cold (re)init -> gate off; a
            # GATED reinit (recent loss, last-known depth trusted) keeps
            # it, anchored at the gated centroid the caller seeded
            # theta0.p with.  Traced scalar: toggling does not recompile.
            body_gate=(consts["body_gate"] if (not is_reinit or
                                               reinit_gated)
                       else consts["zero"]),
            ring_faces=self._ring if refine else None,
            refine_steps=c.refine_steps if refine else 0,
            refine_beta=consts["refine_beta"],
            # during reinit the pose chain restarted at an artificial seed;
            # _theta IS the seed, so anchoring the velocity to itself
            # degenerates the extrapolation to identity
            theta_prev=self._theta if is_reinit else self._theta_prev,
            extrap=consts["extrap"])

    # the small per-frame tracking state warmup() must leave untouched
    _WARM_STATE = ("_theta", "_theta_prev", "com_pre", "reinit",
                   "_frame_no", "_lost_count", "_lost_frames",
                   "_shape_refit_in", "_last_root_z", "_starve",
                   "_metrics_file", "_metrics_frame")

    def warmup(self, frame, labels_override=None, batch: int = 0) -> None:
        """Pre-compile every XLA program variant the tracking loop can
        dispatch — reinit, steady-state, periodic surface refine
        (config.refine_every), the one-shot post-reinit shape refit
        (config.shape_refit_after), and optionally the batch program —
        so no deployment frame pays a mid-stream jit compile (the
        shape-refit variant alone is a multi-second first-use compile; a
        real-time loop cannot absorb that at its first reinit).  Runs the
        real tracker on ``frame`` and then restores the per-frame tracking
        state, so warmup is invisible to the state machine and to the
        metrics log.  ``batch`` > 0 additionally compiles the
        batch-dispatch program at that batch size (batch programs are
        shape-specialized per batch size).  Call after set_background().
        """
        import copy as _copy
        c = self.config
        snap = {k: _copy.copy(getattr(self, k, None))
                for k in self._WARM_STATE}
        self._metrics_file = None        # keep warmup out of the log
        try:
            self.reinit = True
            self.track(frame, labels_override)        # reinit variant
            self.reinit = False
            self._shape_refit_in = None
            self._frame_no = 1 if c.refine_every > 1 else 0
            self.track(frame, labels_override)        # steady-state
            if c.shape_refit_after > 0:
                self._shape_refit_in = 0
                self._frame_no = 1 if c.refine_every > 1 else 0
                self.track(frame, labels_override)    # shape-refit
                self._shape_refit_in = None
            if c.refine_every > 0:
                self._frame_no = c.refine_every - 1
                self.track(frame, labels_override)    # periodic refine
            if batch > 0:
                self.track_batch(
                    [frame] * batch,
                    None if labels_override is None
                    else [labels_override] * batch)
        finally:
            for k, v in snap.items():
                setattr(self, k, v)

    def track(self, frame, labels_override: Optional[np.ndarray] = None):
        """Track one frame.  ``frame`` is an XYZ map [H, W, 3], a float
        depth map [H, W] in meters, or a uint16 depth map in millimeters
        (cheapest to upload).  Returns a tracking.TrackResult-compatible
        object."""
        from avatar_tpu.tracking import TrackResult

        c = self.config
        H, W = self.image_size
        frame = np.asarray(frame)
        depth_np = frame[..., 2] if frame.ndim == 3 else frame
        depth_np = self._pre_stride(depth_np)
        if depth_np.dtype == np.uint16:
            xyz = jnp.asarray(depth_np)
        else:
            xyz = jnp.asarray(depth_np, self.model.dtype)
        if labels_override is None:
            labels = self._zero_labels()
        else:
            labels = jnp.asarray(self._map_labels(self._pre_stride(
                np.asarray(labels_override))), jnp.uint8)

        min_needed = c.min_points / (c.data_interval ** 2)
        reinitialized = False
        if self.reinit:
            # a failed attempt must leave the tracker coasting on the last
            # good pose, not on the artificial reset seed the attempt
            # planted in self._theta (consumers — and the long-eval's
            # error metric — read _theta even for ok=False frames)
            theta_keep, com_keep = self._theta, self.com_pre
            theta_prev_keep = self._theta_prev
            # host-side reinit: recenter at the (approximate) cloud centroid
            # and run a full-image (no window) fit with extra iterations
            with self.timer.stage("reinit"):
                dsub = self._data_substride
                d_sub = depth_np[::dsub, ::dsub]
                d_sub = (d_sub.astype(np.float32) * 1e-3
                         if d_sub.dtype == np.uint16 else d_sub)
                hs = self._host_stride
                ys = np.arange(0, d_sub.shape[0]) * dsub * hs
                xs = np.arange(0, d_sub.shape[1]) * dsub * hs
                i = self.intrin
                sub = np.stack([(xs[None, :] - i.cx) * d_sub / i.fx,
                                (ys[:, None] - i.cy) * d_sub / i.fy,
                                d_sub], -1)
                fg = sub[..., 2] > 0
                if labels_override is not None:
                    lab = np.asarray(labels_override)[
                        ::dsub * hs, ::dsub * hs][
                        : fg.shape[0], : fg.shape[1]]
                    fg &= lab != 255
                # GATED reinit: while the loss is recent, trust the
                # last-known body depth — restrict the centroid (and,
                # below, the device fg) to pixels near it, so an occluder
                # still in frame cannot capture the reinit.  Falls back to
                # a cold (ungated) reinit after lost_gated_frames, which
                # also covers a person re-entering at a different depth.
                gated = (c.body_gate > 0 and not self.first_init and
                         self._last_root_z is not None and
                         self._lost_frames < c.lost_gated_frames)
                if gated:
                    fg &= np.abs(sub[..., 2] - self._last_root_z) <= \
                        c.body_gate
                    if not fg.any():
                        self._lost_frames += 1
                        self._theta, self.com_pre = theta_keep, com_keep
                        self._theta_prev = theta_prev_keep
                        return TrackResult(ok=False, n_points=0)
                centroid = (sub[fg] * np.array([1, -1, 1])).mean(axis=0) \
                    if fg.any() else np.array([0.0, 0.0, 2.5])
                J = self.model.num_joints()
                rots = np.tile(np.eye(3), (J, 1, 1))
                rots[0] = np.diag([-1.0, 1.0, -1.0])
                # multi-seed reinit: rest pose plus the heaviest GMM
                # component means (a poor initial arm/leg configuration is
                # a local minimum the fit never escapes; the prior's modes
                # are the likeliest true configurations)
                seeds = [rots]
                if (c.reinit_seeds > 1 and
                        self.model.pose_prior is not None):
                    from avatar_tpu.core import rotation as _rot

                    wts = np.asarray(self.model.pose_prior.weights)
                    means = np.asarray(self.model.pose_prior.means)
                    for ci in np.argsort(wts)[::-1][: c.reinit_seeds - 1]:
                        aa = means[ci].reshape(J - 1, 3)
                        R = np.asarray(_rot.so3_exp(
                            jnp.asarray(aa, jnp.float32)))
                        seeds.append(np.concatenate([rots[:1], R], axis=0))
                com0 = jnp.asarray(np.concatenate(
                    [np.full((1, self.num_parts), -1.0),
                     np.zeros((1, self.num_parts))]), self.model.dtype)
                steps = (c.initial_icp_iters if self.first_init
                         else c.reinit_icp_iters) * c.iters_per_icp
                best = None
                for sd in seeds:
                    self._theta = Theta(
                        p=jnp.asarray(centroid, self.model.dtype),
                        rots=jnp.asarray(sd, self.model.dtype),
                        w=jnp.zeros(self.model.num_shape_keys(),
                                    self.model.dtype))
                    self.com_pre = com0
                    out_s = self._run(xyz, labels, steps, use_window=False,
                                      render_labels=False, is_reinit=True,
                                      reinit_gated=gated)
                    diag_s = unpack_diag(out_s.host_diag, self.num_parts)
                    score = diag_s.cost / max(diag_s.n_matched, 1)
                    if best is None or score < best[0]:
                        best = (score, out_s, diag_s)
                _, out, diag = best
                n_points = diag.n_points
            if n_points < min_needed:
                self._lost_frames += 1
                self._theta, self.com_pre = theta_keep, com_keep
                self._theta_prev = theta_prev_keep
                return TrackResult(ok=False, n_points=n_points)
            self.reinit = False
            self.first_init = False
            reinitialized = True
            self._shape_refit_in = (c.shape_refit_after
                                    if c.shape_refit_after > 0 else None)
        else:
            n_steps = c.frame_icp_iters * c.iters_per_icp
            self._frame_no += 1
            refine = (c.refine_every > 0 and
                      self._frame_no % c.refine_every == 0)
            fit_shape = self._shape_refit_due()
            with self.timer.stage("frame"):
                out = self._run(xyz, labels, n_steps, refine=refine,
                                fit_shape=fit_shape)
                diag = unpack_diag(out.host_diag, self.num_parts)
                n_points = diag.n_points
            if (n_points < min_needed and
                    diag.n_fg < max(2.0, min_needed * c.absent_fg_frac)):
                # person absent or fully occluded: neither labeled points
                # nor body-gated foreground.  (Labeled count alone is NOT
                # loss evidence: under partial occlusion the visible
                # strips are mostly conf-gated extremities; and even a
                # QUARTER of the normal foreground — a visible arm — is
                # worth fitting, because the temporal prior + per-joint
                # clamp + root-jump detector bound what a sparse fit can
                # do, while it keeps following gross motion.)  Coast and
                # reinitialize — gated first (see the reinit branch), so
                # an occluder still in frame cannot capture it.
                self.reinit = True
                self._lost_count = 0
                self._lost_frames += 1
                return TrackResult(ok=False, n_points=n_points)
            if (c.max_root_jump > 0 and
                    diag.root_jump > c.max_root_jump):
                # the fit teleported: something captured the ICP.  Reject
                # the frame — coast on the previous pose — and only do a
                # full reinit after repeated failures, like the
                # reference's tracking-loss state machine
                # (live-demo.cpp:250-422).
                self._lost_count += 1
                self._lost_frames += 1
                if self._lost_count >= c.lost_reinit_frames:
                    self.reinit = True
                    self._lost_count = 0
                return TrackResult(ok=False, n_points=n_points)
            self._lost_count = 0

        if not reinitialized:
            # post-reinit shape-refit countdown: the refit frame clears it,
            # ordinary accepted frames count it down
            if fit_shape:
                self._shape_refit_in = None
            elif self._shape_refit_in is not None:
                self._shape_refit_in -= 1
        # velocity anchor: the previous fitted pose in steady state; the
        # new pose itself right after a reinit (the chain restarted, so
        # the finite difference across the restart is meaningless)
        self._theta_prev = out.theta if reinitialized else self._theta
        self._theta = out.theta
        self.com_pre = out.com_pre
        self._lost_frames = 0
        # last-known body depth, free from the packed diag: mean camera-z
        # of the visible model part centroids at theta0 (1-frame lag)
        mz = diag.model_com[:, 4]
        if np.any(mz > 0):
            self._last_root_z = float(np.mean(mz[mz > 0]))
        if not reinitialized:
            self._limb_recovery(diag, depth_np)
        res = TrackResult(ok=True, reinitialized=reinitialized,
                          n_points=n_points,
                          fit_info=self._fit_info(diag))
        self._log_metrics(res)
        return res

    def _shape_refit_due(self) -> bool:
        """True when the one-shot post-reinit shape refit should run on
        the next steady-state frame (see TrackerConfig.shape_refit_after)."""
        return (self._shape_refit_in is not None and
                self._shape_refit_in <= 0)

    def _run_batch(self, xyz_b, labels_b, n_steps):
        """Dispatch a whole frame batch (see fused_frames_batch)."""
        c = self.config
        consts = self._consts()
        window = None
        pad_n, boost_n, wild_n = (self._pad_n, self._boost_n,
                                  self._wild_n)
        if c.seg_window is not None and self.rtree is not None:
            Hs, Ws = self._proc_size
            hs = self._host_stride
            window = (min(c.seg_window[0] // hs, Hs),
                      min(c.seg_window[1] // hs, Ws))
            dsub = self._data_substride
            n_data = (-(-window[0] // dsub)) * (-(-window[1] // dsub))
            pad_n, boost_n, wild_n = self._fit_bucket(n_data)
        return fused_frames_batch(
            self._ctx, self._ctx_fit, self._tree, self.model.parents,
            xyz_b, labels_b, self._bg, self._intrin4, self._theta,
            self.com_pre,
            consts["beta_pose"], consts["beta_shape"],
            consts["nn_t"], consts["nb_t"], consts["min_cc"], consts["d2p"],
            seg_stride=self._seg_stride,
            data_substride=self._data_substride,
            n_steps=n_steps, num_parts=self.num_parts,
            max_depth=self._max_depth,
            use_forest=self.rtree is not None,
            use_bgsub=self._use_bgsub,
            use_jsr=self.model.use_joint_shape_regressor,
            pad_n=pad_n, seg_window=window,
            conf_thresh=consts["conf_vec"],
            point_weight=consts["point_weight"],
            plane_weight=consts["plane_weight"],
            huber_k=consts["huber_k"],
            robust_per_part=c.robust_per_part,
            use_render_labels=(c.render_labels and self.rtree is not None),
            render_tau=consts["render_tau"],
            beta_temp=consts["beta_temp"],
            clamp_angle=consts["clamp_angle"],
            boost_n=boost_n,
            boost_groups=tuple(c.extremity_boost_groups),
            # the batch path is steady-state by construction (reinit runs
            # through the synchronous path first)
            freeze_shape=True,
            fit_sorted=self._fit_sorted,
            wild_n=wild_n, wild_gate=consts["wild_gate"],
            wild_weight=consts["wild_weight"],
            sel_walk=float(c.selective_walk),
            body_gate=consts["body_gate"],
            # batch frames share one compiled scan: refine every frame
            # (refine_every == 1) or not at all
            ring_faces=self._ring if c.refine_every == 1 else None,
            refine_steps=c.refine_steps if c.refine_every == 1 else 0,
            refine_beta=consts["refine_beta"],
            theta_prev0=self._theta_prev, extrap=consts["extrap"])

    def track_batch(self, frames, labels_override=None):
        """Track a list of consecutive frames in ONE device dispatch.

        Max-throughput offline mode: batching N frames into a single upload
        + execute removes the per-frame dispatch and transfer overhead.
        Reinitialization cannot
        happen mid-batch: if the batch starts lost, the first frame runs
        through the synchronous path and the rest as a batch; if tracking
        is lost inside a batch, the remaining frames' results are still
        produced (the reinit happens on the next call).

        Returns a list of TrackResult.  Per-frame poses are stacked on
        device in ``self.batch_thetas`` (a Theta pytree with a leading
        batch axis).
        """
        if not frames:
            return []
        if self.reinit or self._shape_refit_due():
            # reinit and the one-shot shape refit both need the sync path
            # (freeze_shape is static inside the batch scan program)
            head = self.track(frames[0], labels_override[0]
                              if labels_override is not None else None)
            head_theta = self._theta
            rest = self.track_batch(
                frames[1:], labels_override[1:]
                if labels_override is not None else None)
            # keep batch_thetas aligned with the returned results: the
            # sync head frame's pose leads the recursive batch's stack
            if rest:
                self.batch_thetas = jax.tree.map(
                    lambda h, b: jnp.concatenate([h[None], b]),
                    head_theta, self.batch_thetas)
            else:
                self.batch_thetas = jax.tree.map(lambda h: h[None],
                                                 head_theta)
            return [head] + rest
        pending = self._batch_dispatch(frames, labels_override)
        results, self.batch_thetas = self._batch_resolve(pending)
        return results

    def _batch_dispatch(self, frames, labels_override):
        """Upload + dispatch one frame batch; returns a pending record.

        The device-side pose chain (self._theta) advances immediately with
        the dispatched batch's final pose, so the NEXT batch can be
        dispatched before this one finishes — the core of the pipelined
        mode (reference analogue: the capture thread's producer/consumer
        double buffer, DepthCamera.cpp:24-95,142-187, generalized to whole
        batches in flight).
        """
        c = self.config
        deps = []
        labs = []
        for i, f in enumerate(frames):
            f = np.asarray(f)
            deps.append(self._pre_stride(f[..., 2] if f.ndim == 3 else f))
            if labels_override is None:
                labs.append(None)
            else:
                labs.append(self._map_labels(self._pre_stride(
                    np.asarray(labels_override[i]))))
        dep_b = jnp.asarray(np.stack(deps)) \
            if deps[0].dtype == np.uint16 else jnp.asarray(
                np.stack(deps), self.model.dtype)
        lab_b = (jnp.zeros((len(frames),) + self._proc_size, jnp.uint8)
                 if labels_override is None
                 else jnp.asarray(np.stack(labs), jnp.uint8))
        n_steps = c.frame_icp_iters * c.iters_per_icp
        if self._shape_refit_in is not None:
            # batch frames all run shape-frozen; an expiring countdown is
            # picked up at the next batch boundary (track_batch head split)
            self._shape_refit_in -= len(frames)
        (thetas, diags, theta_f, com_f,
         theta_prev_f) = self._run_batch(dep_b, lab_b, n_steps)
        self._theta = theta_f
        self._theta_prev = theta_prev_f
        self.com_pre = com_f
        # start the packed device->host diagnostics copy now so resolving
        # this batch later (after the next batch is already in flight)
        # does not wait on the device
        if hasattr(diags, "copy_to_host_async"):
            diags.copy_to_host_async()
        return dict(diags=diags, thetas=thetas, dep_last=deps[-1])

    def _batch_resolve(self, pending):
        """Host-side result processing for one dispatched batch."""
        from avatar_tpu.tracking import TrackResult

        c = self.config
        dn = np.asarray(pending["diags"])       # ONE device->host copy
        results = []
        min_needed = c.min_points / (c.data_interval ** 2)
        for b in range(dn.shape[0]):
            diag = unpack_diag(dn[b], self.num_parts)
            ok = (diag.n_points >= min_needed or
                  diag.n_fg >= max(2.0, min_needed * c.absent_fg_frac)) \
                and (c.max_root_jump <= 0 or
                     diag.root_jump <= c.max_root_jump)
            if not ok:
                # loss inside a batch: the remaining frames' results are
                # still produced (documented above); reinit on next call
                self.reinit = True
                self._lost_frames += 1
            else:
                self._lost_frames = 0
                mz = diag.model_com[:, 4]
                if np.any(mz > 0):
                    self._last_root_z = float(np.mean(mz[mz > 0]))
            results.append(TrackResult(
                ok=ok, n_points=diag.n_points,
                fit_info=self._fit_info(diag)))
            self._log_metrics(results[-1])
        if not self.reinit:
            self._limb_recovery(unpack_diag(dn[-1], self.num_parts),
                                pending["dep_last"])
        return results, pending["thetas"]

    def track_batch_async(self, frames, labels_override=None):
        """Pipelined track_batch: dispatch THIS batch, resolve the
        PREVIOUS one.

        Steady-state cost per batch is max(host prep + upload, device
        compute) instead of their sum: while batch k computes on device,
        batch k+1's frames stride, stack, and stream up the link.  Returns
        a list of (results, thetas) pairs for every batch resolved by this
        call — usually one (the previous batch), empty on the first call,
        and possibly two when a tracking loss forces the pipeline to drain
        and reinitialize synchronously.  Loss detection lags one batch
        (exactly like track_async's one-frame lag); ``flush_batches()``
        drains the final batch.
        """
        if not frames:
            return []
        q = getattr(self, "_batch_q", None)
        if q is None:
            q = self._batch_q = []
        resolved = []
        if self.reinit or self._shape_refit_due():
            # drain the pipeline, then run the reinit (or one-shot shape
            # refit head frame) path synchronously
            resolved.extend(self.flush_batches())
            res = self.track_batch(frames, labels_override)
            resolved.append((res, self.batch_thetas))
            return resolved
        q.append(self._batch_dispatch(frames, labels_override))
        if len(q) > 1:
            resolved.append(self._batch_resolve(q.pop(0)))
        return resolved

    def flush_batches(self):
        """Resolve all in-flight batches from track_batch_async; returns
        their (results, thetas) pairs."""
        q = getattr(self, "_batch_q", None)
        out = []
        while q:
            out.append(self._batch_resolve(q.pop(0)))
        return out

    def track_async(self, frame, labels_override: Optional[np.ndarray] = None):
        """Throughput-mode tracking: dispatches this frame immediately
        (chained device-side off the previous frame's pose) and returns the
        *previous* frame's TrackResult (None for the first call).  Loss
        detection therefore lags one frame — the following call runs the
        reinitialization path, exactly like the reference's next-frame
        reinit.  Host, upload and device work fully overlap; steady-state
        cost is max(upload, device) instead of their sum."""
        from avatar_tpu.tracking import TrackResult

        c = self.config
        if self.reinit:
            # flush the pipeline and run a synchronous reinit frame
            self._pending_q = []
            res = self.track(frame, labels_override)
            return res

        depth_np = np.asarray(frame)
        if depth_np.ndim == 3:
            depth_np = depth_np[..., 2]
        depth_np = self._pre_stride(depth_np)
        xyz = jnp.asarray(depth_np) if depth_np.dtype == np.uint16 else \
            jnp.asarray(depth_np, self.model.dtype)
        labels = (self._zero_labels()
                  if labels_override is None
                  else jnp.asarray(self._map_labels(self._pre_stride(
                      np.asarray(labels_override))), jnp.uint8))
        n_steps = c.frame_icp_iters * c.iters_per_icp
        fit_shape = self._shape_refit_due()
        if fit_shape:
            self._shape_refit_in = None
        elif self._shape_refit_in is not None:
            self._shape_refit_in -= 1
        out = self._run(xyz, labels, n_steps,      # async dispatch
                        fit_shape=fit_shape)
        self._theta_prev = self._theta
        self._theta = out.theta                    # device-side chain
        self.com_pre = out.com_pre

        pending = getattr(self, "_pending_q", None)
        if pending is None:
            pending = self._pending_q = []
        pending.append(out)
        # start the single packed device->host diagnostic copy now, so
        # reading it next frame does not wait on a transfer (one copy per
        # frame, not one per field)
        if hasattr(out.host_diag, "copy_to_host_async"):
            out.host_diag.copy_to_host_async()
        if len(pending) < max(1, c.pipeline_depth) + 1:
            return None
        prev = pending.pop(0)
        # recovery decisions read the PREVIOUS frame's (already finished)
        # diagnostics so the just-dispatched frame stays in flight; a
        # triggered recovery syncs once, which is fine for a rare event
        diag = unpack_diag(prev.host_diag, self.num_parts)
        self._limb_recovery(diag, depth_np)
        n_points = diag.n_points                   # prev has long finished
        if n_points < c.min_points / (c.data_interval ** 2):
            self.reinit = True
            res = TrackResult(ok=False, n_points=n_points)
        else:
            res = TrackResult(ok=True, n_points=n_points,
                              fit_info=self._fit_info(diag))
        self._log_metrics(res)
        return res

    def flush(self):
        """Resolve the in-flight frame from track_async (returns its
        TrackResult or None)."""
        from avatar_tpu.tracking import TrackResult

        pending = getattr(self, "_pending_q", None)
        if not pending:
            return None
        prev = pending[-1]
        self._pending_q = []
        diag = unpack_diag(prev.host_diag, self.num_parts)
        return TrackResult(ok=True, n_points=diag.n_points,
                           fit_info=self._fit_info(diag))

    @staticmethod
    def _fit_info(diag: HostDiag) -> dict:
        return dict(cost=diag.cost, n_matched=diag.n_matched,
                    part_counts=diag.part_counts.astype(int).tolist(),
                    hard_overflow=diag.hard_overflow)

    # -- structured per-frame metrics (SURVEY §5.5) -------------------------

    def open_metrics(self, path: str) -> None:
        """Start appending one JSON line per tracked frame to ``path``:
        frame index, ok/reinit flags, matched point counts (total and per
        part), fit cost, and the most recent stage wall times."""
        import json

        self._metrics_file = open(path, "w")
        self._metrics_json = json
        self._metrics_frame = 0

    def close_metrics(self) -> None:
        f = getattr(self, "_metrics_file", None)
        if f is not None:
            f.close()
            self._metrics_file = None

    def _log_metrics(self, res) -> None:
        f = getattr(self, "_metrics_file", None)
        if f is None:
            return
        rec = dict(frame=self._metrics_frame, ok=res.ok,
                   reinit=res.reinitialized, n_points=res.n_points)
        if res.fit_info:
            rec.update(res.fit_info)
        for k, v in self.timer.stats.items():
            if v:
                rec[f"{k}_ms"] = round(v[-1], 3)
        f.write(self._metrics_json.dumps(rec) + "\n")
        self._metrics_frame += 1

    # -- per-limb recovery (SURVEY §5.3) ------------------------------------

    def _limb_recovery(self, diag: HostDiag, depth_np: np.ndarray) -> None:
        """Re-aim starved extremity chains at their forest blobs.

        A limb that loses correspondence never recovers on its own: the fit
        has no residuals for it and the temporal prior holds it in place.
        The forest, however, usually still sees the limb's blob (com_pre).
        After ``limb_recovery_frames`` consecutive zero-match frames for a
        recoverable group, rotate its chain-root joint so the limb's
        centroid points at the blob's backprojection; the next frame's fit
        refines from there.  The reference's only tool here is whole-body
        reinitialization (live-demo.cpp 'r' key / lost-track path).
        """
        c = self.config
        if (not c.limb_recovery or self._glut is None
                or self.rtree is None):
            return
        from avatar_tpu.perception.partgroups import SMPL24_GROUP_CHAIN_ROOT

        pc = diag.part_counts
        com = diag.com_pre
        starve = getattr(self, "_starve", None)
        if starve is None:
            starve = self._starve = np.zeros(self.num_parts, np.int32)
        mp = np.asarray(self._ctx.model_part)
        parents = self.model.parents
        i = self.intrin
        hs = self._host_stride
        rots = None
        changed = False
        mcom = diag.model_com
        Hp, Wp = depth_np.shape[:2]

        def blob_target(g):
            """Backproject group g's blob CoM (median depth patch)."""
            if com[0, g] < 0:
                return None
            ix, iy = int(com[0, g]), int(com[1, g])   # proc-space pixels
            if not (0 <= ix < Wp and 0 <= iy < Hp):
                return None
            patch = depth_np[max(iy - 2, 0): iy + 3,
                             max(ix - 2, 0): ix + 3].astype(np.float32)
            vals = patch[patch > 0]
            if vals.size == 0:
                return None
            z = float(np.median(vals))
            if depth_np.dtype == np.uint16:
                z *= 1e-3
            return np.array([(ix * hs - i.cx) * z / i.fx,
                             -(iy * hs - i.cy) * z / i.fy, z])

        for g, root in SMPL24_GROUP_CHAIN_ROOT.items():
            if g >= self.num_parts:
                continue
            target = blob_target(g)
            misaimed = (target is not None and mcom[g, 0] >= 0 and
                        float(np.linalg.norm(target - mcom[g, 2:5]))
                        > c.limb_recovery_m)
            if pc[g] > 0 and not misaimed:
                starve[g] = 0
                continue
            starve[g] += 1
            if starve[g] < c.limb_recovery_frames or target is None:
                continue
            if rots is None:
                ava = self.sync_avatar()
                verts, joints = ava.cloud, ava.joint_pos
                rots = np.asarray(self._theta.rots, np.float64).copy()
                J = len(parents)
                Rg = np.zeros((J, 3, 3))
                Rg[0] = rots[0]
                for j in range(1, J):
                    Rg[j] = Rg[parents[j]] @ rots[j]
            sel = mp == g
            if not sel.any():
                continue
            v_cur = verts[sel].mean(0) - joints[root]
            v_new = target - joints[root]
            n1 = np.linalg.norm(v_cur)
            n2 = np.linalg.norm(v_new)
            if n1 < 1e-6 or n2 < 1e-6:
                continue
            # anatomical reach gate: a blob the limb cannot physically
            # reach from its chain root is a mislabel, not a target
            if not (0.4 * n1 <= n2 <= 1.6 * n1):
                starve[g] = 0
                continue
            cosang = float(np.clip(v_cur @ v_new / (n1 * n2), -1.0, 1.0))
            ang = float(np.arccos(cosang))
            if ang < 0.15:            # already aimed; let the fit handle it
                continue
            axis = np.cross(v_cur, v_new)
            na = np.linalg.norm(axis)
            if na < 1e-9:
                continue
            k = axis / na
            K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]],
                          [-k[1], k[0], 0]])
            A = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)
            C = Rg[parents[root]] if parents[root] >= 0 else np.eye(3)
            rots[root] = C.T @ A @ C @ rots[root]
            starve[g] = 0
            changed = True
            # observability: per-group recovery event counter (SURVEY §5.5)
            self.limb_recoveries[g] = self.limb_recoveries.get(g, 0) + 1
        if changed:
            self._theta = Theta(
                p=self._theta.p,
                rots=jnp.asarray(rots, self.model.dtype),
                w=self._theta.w)
            # the re-aim is a host-side jump, not motion: zero the velocity
            # so the warm start doesn't extrapolate the teleport
            self._theta_prev = self._theta

    def sync_avatar(self) -> Avatar:
        """Materialize the device-side pose into self.ava (host)."""
        self.ava.p = np.asarray(self._theta.p, np.float64)
        self.ava.r = np.asarray(self._theta.rots, np.float64)
        self.ava.w = np.asarray(self._theta.w, np.float64)
        self.ava.update()
        return self.ava
