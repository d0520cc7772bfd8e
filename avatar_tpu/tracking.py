"""End-to-end tracking driver: the demo / live-demo frame loop.

Rebuild of the reference pipeline (demo.cpp:153-334, live-demo.cpp:264-530):

    XYZ frame -> background subtraction -> foreground depth -> random-forest
    part segmentation (stride 2) -> blob postprocess (CoM tracking) ->
    stride-sampled labeled point cloud -> reinit state machine ->
    AvatarOptimizer fit -> (optional) Lambert overlay.

The tracking-loss / reinitialization state machine is preserved exactly
(live-demo.cpp:250-422): reinit recenters the avatar at the cloud centroid,
zeroes the shape, faces the camera (root rotation = pi about +y) and runs
more ICP iterations; tracking is declared lost when the foreground pixel
count falls below min_points / interval^2.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from avatar_tpu.core.model import Avatar, AvatarModel
from avatar_tpu.optim.optimizer import AvatarOptimizer
from avatar_tpu.perception.bgsub import BGSubtractor
from avatar_tpu.utils import StageTimer


@dataclasses.dataclass
class TrackerConfig:
    """Tuned operating point.  Structure mirrors the reference demos
    (demo.cpp:44-73, live-demo.cpp:60-120); values retuned for this
    tracker where they differ (beta_pose 0.05 -> 0.03: with the
    point-to-plane term and per-part robust scaling on, the GMM prior at
    0.05 drags fast-moving extremities toward the dataset mean)."""
    beta_pose: float = 0.03
    beta_shape: float = 0.12
    data_interval: int = 12       # stride for optimization samples
    rtree_interval: int = 2       # stride for forest inference
    # steady-state LM budget = frame_icp_iters * iters_per_icp (the fused
    # fit re-matches every step, so the reference's outer-ICP/inner-solver
    # split collapses into one budget; gauss_newton.fit docstring).  2
    # outer iters since the constant-velocity warm start (extrapolate_pose
    # below): the fit starts near the optimum and stall-exits, so a third
    # outer round buys little accuracy for a full round of device time.
    frame_icp_iters: int = 2
    reinit_icp_iters: int = 6
    initial_icp_iters: int = 7    # live-demo first init
    iters_per_icp: int = 10
    min_points: int = 1000        # reinitCnz
    dist_to_pre_weight: float = 0.001
    # Occlusion resilience (FusedTracker; the blob-sanity role of the
    # reference's per-part CoM tracking + tracking-loss state machine,
    # live-demo.cpp:250-422):
    # body_gate: foreground components whose mean depth differs from the
    # tracked root's camera depth by more than this (meters) are rejected
    # before segmentation/fit — an occluder entering the scene is a new
    # blob at the wrong depth, and without the gate its points capture the
    # ICP wholesale.  Scope (tests/test_tracking_regression.py occlusion
    # gate): with a well-tracked entry pose the gate holds the occluded
    # phase to a few centimeters through a 1.6 m slab, where the ungated
    # tracker loses the body entirely.  If the
    # tracker ENTERS occlusion already mistracked (e.g. after a fast-limb
    # phase), the stale root depth can gate out the true body and the
    # recovery path dominates the phase error instead — the long eval
    # reports both regimes per phase.  Disabled during (re)init when no
    # prior pose exists.  0 = off.
    body_gate: float = 0.6
    # max_root_jump: a steady-state frame whose fit moved the root by more
    # than this (meters) is rejected (coast on the previous pose); a full
    # reinit happens only after lost_reinit_frames consecutive rejections
    # (reinit drops the body gate, so reinitializing while an occluder is
    # in frame risks locking onto it).  0 = off.
    max_root_jump: float = 0.45
    lost_reinit_frames: int = 5
    # absent_fg_frac: fraction of the min_points presence bar that
    # body-gated foreground alone (labels all conf-gated, e.g. only an
    # arm visible past an occluder) must clear for the frame to still be
    # fit rather than declared lost.
    absent_fg_frac: float = 0.25
    # lost_gated_frames: for this many frames after a loss, reinit
    # attempts stay body-gated at the last-known depth (an occluder still
    # in frame cannot capture them); after that, cold ungated reinit
    # (covers a person re-entering at a different depth).
    lost_gated_frames: int = 45
    # Per-frame surface-exactness refine (FusedTracker): every
    # refine_every-th steady-state frame, re-fit the frame's data bucket
    # against the mesh SURFACE (point-to-triangle ICP, optim/surface.py,
    # refine_steps LM steps) starting from the tracked pose, with the
    # priors scaled by refine_beta.  Removes the point-to-vertex fit's
    # vertex-spacing bias on the PRODUCT path (the BASELINE "<1 mm" bar is
    # a property of the fit the system ships, not an offline probe).
    # 0 disables.
    # ACCURACY MODE: refine_every=1, refine_steps=2 trades throughput for
    # lower joint error and vertex RMSE; its cost on the GPU is not
    # measured yet.  Refine does NOT substitute for main-fit budget (fewer
    # main steps plus refine steps tracked worse), and sparse refine
    # (refine_every=2, refine_steps=1) was worse on both axes than the
    # default: a single refine step doesn't reach the surface-bias floor,
    # so pay for 2+ steps every frame (accuracy mode) or skip refine.
    refine_every: int = 0
    refine_steps: int = 4
    refine_beta: float = 0.1
    # One-shot shape refit (FusedTracker): shape keys are fit only on
    # (re)init frames and frozen in steady state, so a poor reinit-frame
    # shape estimate (coupled to the cold-seed pose it was fit with) is
    # locked in for the whole sequence.  shape_refit_after > 0 runs ONE
    # steady-state frame with shape keys unfrozen this many frames after
    # each successful (re)init — by then the pose has locked in, so the
    # shape solve is clean.  Costs one synchronous frame per (re)init
    # (batch/async paths route that single frame through the sync path)
    # plus one extra compiled program variant.  0 = off.  On by default:
    # it lowered joint error, vertex RMSE and the rest-shape delta of the
    # forest-label bench sequence at unchanged steady-state cost.
    shape_refit_after: int = 12
    nn_dist_thresh_rel: float = 0.005
    neighb_thresh_rel: float = 0.005
    bgsub_stride: int = 2         # subtraction grid stride (downstream
                                  # stages never read finer than stride 2)
    # fused-tracker extras: forest label confidence gate and a tracked
    # static-size segmentation window (full-res pixels; None = full image)
    label_conf_thresh: float = 0.5
    # Per-group gate relaxation (requires part_groups): hand/foot leaves
    # are inherently diffuse (tiny parts, depth probes can't isolate them),
    # so a flat gate discards essentially ALL extremity labels — measured
    # on the bench forest: 100% of true-hand pixels and ~90% of true-foot
    # pixels gated to background at 0.55, which starves those groups of
    # correspondences entirely (cf. the reference's per-part starvation
    # printout, AvatarOptimizer.cpp:946-949).  Groups listed here gate at
    # label_conf_low instead; blob suppression + group matching bound the
    # damage from the extra false positives.
    label_conf_low: float = 0.3
    label_conf_low_groups: tuple = ()  # measured net-negative on the bench
    # Wildcard (label-free) correspondence channel (FusedTracker, requires
    # part_groups): up to wild_n foreground samples whose forest label was
    # confidence-gated away are matched to the nearest visible model vertex
    # of ANY part, gated at wild_gate meters and weighted wild_weight.
    # Rationale: the forest localizes hands/feet so poorly that their true
    # pixels are almost all gated to background (measured: 100% of true-hand
    # pixels at 0.55 on the bench forest), so those limbs otherwise drift on
    # the temporal prior alone; classic label-free ICP support pulls them
    # back without trusting unreliable labels.
    # wild_n=992 fills the bench window's pad-bucket slack exactly (pad 8192,
    # n_data 7200) with the boost off: measured 10.0mm joint error vs 22.6mm
    # at the old (boost 1024, wild 512) split, at identical device cost —
    # crossing into the next bucket (wild 1024 + boost 1024, pad 16384) is
    # WORSE (12.1mm) and doubles every data-axis op of the fit.
    wild_n: int = 992
    wild_gate: float = 0.2
    wild_weight: float = 0.7
    # (Two knobs deleted in round 4 after being measured net-negative in
    # every tried configuration: reverse model->data matching for starved
    # groups, and geodesic extremity anchors.  The wildcard channel above
    # covers their failure mode more robustly; see git history for the
    # implementations and measurements.)
    # selective ensemble walk (FusedTracker, multi-tree forests): walk
    # tree 0 on every foreground pixel; only pixels whose tree-0 leaf
    # confidence is below this threshold — compacted into a K/3 bucket —
    # are walked through the remaining trees and ensemble-averaged.  The
    # forest walk is the gather-bound segmentation stage and scales with
    # trees x pixels, but tree votes only disagree on the hard
    # (extremity/boundary) pixels; torso interiors clear the gate from one
    # tree alone.  0 disables (all trees walk every pixel).  Default 0.75:
    # accuracy-neutral on the bench sequence while the walk stage does
    # ~40% less work — only pixels the ensemble could actually flip pay
    # for the ensemble.
    selective_walk: float = 0.75
    # inference-side class rebalancing of forest leaf distributions:
    # multiply by (class frequency)^-alpha and renormalize, shifting the
    # argmax toward rare classes (hands/feet) without retraining.  0 = off.
    # Default 0.5: train-stride pixel starvation leaves hands/feet at
    # ~0.1-0.3% leaf sample mass, so the plain argmax never emits them;
    # alpha=0.5 lifts held-out foot pixel accuracy 0.16->0.49 / 0.39->0.50
    # at -0.8% overall (scripts/leaf_reweight_probe.py) and is tracking-
    # neutral on the bench sequence.  alpha=1.0 over-corrects (wrists
    # 0.45->0.27).
    label_class_balance: float = 0.5
    seg_window: Optional[tuple] = (576, 448)
    enable_occlusion: bool = True
    point_weight: float = 1.0
    plane_weight: float = 2.0     # point-to-plane term upweighted 2x (at
                                  # 1.0 the oracle-label joint error is
                                  # ~13 mm on the bench sequence, at 2.0
                                  # ~8 mm; halves forest-label error too)
    robust: bool = True
    huber_k: float = 3.0          # Huber delta = huber_k * robust scale
    robust_per_part: bool = True  # per-body-part robust scale (see
                                  # gauss_newton.fit) instead of global
    # optional part->group LUT (tuple of num_parts ints) for group-level
    # correspondence; see perception/partgroups.py.  None = strict per-part
    # matching like the reference (AvatarOptimizer.cpp:889-949)
    part_groups: Optional[tuple] = None
    # model-predicted labels (FusedTracker only): render the previous
    # pose's part mask on device and override forest labels where measured
    # depth agrees with the render within render_label_tau meters
    render_labels: bool = True
    render_label_tau: float = 0.03
    # temporal pose prior weight (FusedTracker): damps per-joint rotation
    # change from the frame-start pose; joints without data support follow
    # their parent instead of free-wheeling.  Same sqrt(n)/15 scaling as
    # beta_pose
    beta_temp: float = 0.3
    # extremity-dense sampling (FusedTracker, requires part_groups): up to
    # extremity_boost_n extra data samples of the listed groups at full
    # segmentation resolution, so thin limbs aren't starved by the coarse
    # data_interval grid.  Group ids are in part_groups space (the default
    # groups listed are calves/feet/forearms/hands of SMPL24_GROUP_LUT).
    # Default 0: the wildcard channel subsumes it — boosted samples carry
    # the forest's own unreliable extremity labels, and measured tracking
    # is strictly better spending the pad-bucket slack on wildcard support
    # instead (10.0mm vs 12.1mm joint error on the 24-frame eval)
    extremity_boost_n: int = 0
    extremity_boost_groups: tuple = (4, 5, 6, 7, 10, 11, 12, 13)
    # per-limb recovery (FusedTracker, requires part_groups): when an
    # extremity group matched zero data points for limb_recovery_frames
    # consecutive frames while the forest still sees its blob, re-aim the
    # limb chain at the blob's backprojection (SURVEY §5.3 resilience; the
    # reference can only do whole-body reinit)
    limb_recovery: bool = True
    limb_recovery_frames: int = 3
    # mis-aim threshold: blob-backprojection vs model-centroid 3D distance
    # (meters) that also counts as a starved frame
    limb_recovery_m: float = 0.12
    # per-joint motion clamp (FusedTracker): max rotation change per frame
    # for joints whose subtree matched almost no data (gauss_newton.fit);
    # 0 disables
    pose_clamp_angle: float = 0.25
    # reinitialization seeds (FusedTracker): rest pose + the (n-1)
    # heaviest GMM pose-prior component means; the lowest-cost fit wins.
    # Escapes bad arm/leg local minima at initialization
    reinit_seeds: int = 3
    # track_async frames in flight: diagnostics (loss detection, limb
    # recovery) read the result from pipeline_depth frames ago, hiding the
    # device->host link round trip at the cost of detection lag
    pipeline_depth: int = 2
    # fit on every k-th model vertex (FusedTracker): halves the fit's
    # per-step tensor work at stride 2 for ~5mm extra joint error on the
    # bench.  The reference's nnStep=20 uses 1/20th of vertices
    # (AvatarOptimizer.h:30-33).  1 = full accuracy (default)
    fit_vertex_stride: int = 1
    # constant-velocity warm start (FusedTracker): start each steady-state
    # fit from the previous pose advanced by extrapolate_pose x its
    # one-frame velocity (clamped; optim/gauss_newton.extrapolate).  The
    # LM loop stall-exits, so a closer start directly removes accepted
    # re-linearization steps -- the dominant per-frame device cost.
    # The reference warm-starts from the raw previous pose
    # (AvatarOptimizer.cpp:1246-1263).  0 = off.
    # Default 0.8: on the forest-label bench sequence it lowered joint
    # error and tracking vertex RMSE at unchanged device work -- the fit
    # spends its stall-exit budget converging from a closer start instead
    # of crossing the frame's motion gap.
    extrapolate_pose: float = 0.8


@dataclasses.dataclass
class TrackResult:
    ok: bool
    reinitialized: bool = False
    n_points: int = 0
    part_mask: Optional[np.ndarray] = None
    fit_info: Optional[dict] = None


class Tracker:
    def __init__(self, model: AvatarModel, intrin, image_size,
                 rtree=None, config: Optional[TrackerConfig] = None):
        self.model = model
        self.intrin = intrin
        self.image_size = tuple(image_size)  # (H, W)
        self.rtree = rtree
        self.config = config or TrackerConfig()
        self.ava = Avatar(model)

        num_parts = rtree.num_parts if rtree is not None else model.num_joints()
        part_map = rtree.part_map if rtree is not None else None
        self.optimizer = AvatarOptimizer(
            self.ava, intrin, image_size, num_parts, part_map)
        c = self.config
        self.optimizer.beta_pose = c.beta_pose
        self.optimizer.beta_shape = c.beta_shape
        self.optimizer.max_iters_per_icp = c.iters_per_icp
        self.optimizer.enable_occlusion = c.enable_occlusion
        self.optimizer.point_weight = c.point_weight
        self.optimizer.plane_weight = c.plane_weight
        self.optimizer.robust = c.robust
        self.optimizer.huber_k = c.huber_k
        self.optimizer.robust_per_part = c.robust_per_part

        self.bgsub: Optional[BGSubtractor] = None
        self.com_pre = np.full((2, num_parts), -1.0)
        self.com_pre[1, :] = 0.0
        self.reinit = True
        self.first_init = True
        self.timer = StageTimer()

    def set_background(self, background_xyz: np.ndarray) -> None:
        self.bgsub = BGSubtractor(np.asarray(background_xyz, np.float32),
                                  stride=self.config.bgsub_stride)
        self.bgsub.nn_dist_thresh_rel = self.config.nn_dist_thresh_rel
        self.bgsub.neighb_thresh_rel = self.config.neighb_thresh_rel

    def track(self, xyz_map: np.ndarray,
              labels_override: Optional[np.ndarray] = None) -> TrackResult:
        """Process one frame.

        xyz_map: [H, W, 3] camera-space XYZ (z == 0 invalid).
        labels_override: optional precomputed [H, W] uint8 part labels
          (255 = background) replacing forest inference — used by synthetic
          benchmarks and the `--rtree-only`-style tooling.
        """
        c = self.config
        H, W = xyz_map.shape[:2]
        depth = np.ascontiguousarray(xyz_map[..., 2]).copy()

        # --- background subtraction (demo.cpp:179-193) ---------------------
        with self.timer.stage("bg_subtraction"):
            if self.bgsub is not None:
                sub = self.bgsub.run(xyz_map)
                depth[sub >= 254] = 0.0
                tl, br = self.bgsub.top_left, self.bgsub.bot_right
            else:
                tl, br = (0, 0), (W - 1, H - 1)

        # --- part segmentation (demo.cpp:195-204) --------------------------
        with self.timer.stage("segmentation"):
            if labels_override is not None:
                part_mask = np.where(depth > 0, labels_override,
                                     np.uint8(255))
            elif self.rtree is not None:
                part_mask = self.rtree.predict_best(
                    depth, interval=c.rtree_interval, top_left=tl,
                    bot_right=br)
                part_mask = self.rtree.post_process(
                    part_mask, self.com_pre, interval=c.rtree_interval,
                    top_left=tl, bot_right=br,
                    dist_to_pre_weight=c.dist_to_pre_weight)
            else:
                raise ValueError("need an rtree or labels_override")

        # --- gather labeled cloud at stride (demo.cpp:215-250) -------------
        with self.timer.stage("gather"):
            iv = c.data_interval
            ys = np.arange(tl[1], br[1] + 1, iv)
            xs = np.arange(tl[0], br[0] + 1, iv)
            if len(ys) == 0 or len(xs) == 0:
                self.reinit = True
                return TrackResult(ok=False)
            sub_mask = part_mask[np.ix_(ys, xs)]
            sub_xyz = xyz_map[np.ix_(ys, xs)]
            fg = (sub_mask != 255) & (sub_xyz[..., 2] > 0)
            n_points = int(fg.sum())
            if n_points < c.min_points / (iv * iv):
                self.reinit = True
                return TrackResult(ok=False, n_points=n_points,
                                   part_mask=part_mask)
            pts = sub_xyz[fg]
            pts = np.stack([pts[:, 0], -pts[:, 1], pts[:, 2]], 1)
            labels = sub_mask[fg].astype(np.int32)

        # --- reinit state machine (demo.cpp:251-266) ------------------------
        reinitialized = False
        icp_iters = c.frame_icp_iters
        if self.reinit:
            centroid = pts.mean(axis=0)
            self.ava.p = centroid
            self.ava.w[:] = 0.0
            self.ava.r = np.tile(np.eye(3), (self.model.num_joints(), 1, 1))
            self.ava.r[0] = np.array([
                [-1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, -1.0]])
            self.ava.update()
            icp_iters = (c.initial_icp_iters if self.first_init
                         else c.reinit_icp_iters)
            self.reinit = False
            self.first_init = False
            reinitialized = True

        # --- fit (demo.cpp:267-268) ----------------------------------------
        with self.timer.stage("optimize"):
            info = self.optimizer.optimize(pts, labels, icp_iters=icp_iters)

        res = TrackResult(ok=True, reinitialized=reinitialized,
                          n_points=n_points, part_mask=part_mask,
                          fit_info=info)
        self._log_metrics(res)
        return res

    # -- structured per-frame metrics (SURVEY §5.5) -------------------------

    def open_metrics(self, path: str) -> None:
        """Append one JSON line per tracked frame to ``path`` (frame index,
        ok/reinit, matched counts incl. per part, fit cost, stage ms)."""
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

    def render_overlay(self, rgb: Optional[np.ndarray] = None) -> np.ndarray:
        """Lambert-shaded avatar blended over RGB (demo.cpp:275-307)."""
        from avatar_tpu.render.renderer import AvatarRenderer

        rend = AvatarRenderer(self.ava, self.intrin)
        lam = rend.render_lambert(self.image_size)
        if rgb is None:
            return lam
        out = rgb.copy()
        m = lam > 0
        blend = (rgb[m].astype(np.int32) // 5 * 2 +
                 np.stack([lam[m]] * 3, -1).astype(np.int32) // 5 * 3)
        out[m] = blend.astype(np.uint8)
        return out
