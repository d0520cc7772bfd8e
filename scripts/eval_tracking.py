"""Tracking-quality evaluation harness (CPU- or GPU-runnable).

Runs the FusedTracker over the bench's synthetic ground-truth sequence and
reports mean/max joint error plus the worst joints — the metric that actually
matters for forest/config comparisons (pixel accuracy is a poor proxy: a
forest with better overall accuracy can track worse if extremity recall or
label *placement* degrades).

Usage:
  python scripts/eval_tracking.py --frames 24 \
      --forest data/bench_forest.srtr --set beta_temp=0.3
  python scripts/eval_tracking.py --oracle            # oracle-label floor
  (add --cpu to force the host platform)
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_sequence(model, intrin, H, W, n_frames, bg):
    """The bench.py ground-truth sequence (bench.py:77-118)."""
    import jax.numpy as jnp

    from avatar_tpu.core import rotation
    from avatar_tpu.core.model import Avatar
    from avatar_tpu.render.renderer import AvatarRenderer

    gt = Avatar(model)
    gt.randomize(seed=77)
    gt.w *= 0.3
    gt.p = np.array([0.0, 0.1, 2.6])
    gt.r[0] = np.diag([-1.0, 1.0, -1.0])
    rng = np.random.default_rng(8)
    amp = rng.normal(0, 0.10, (24, 3))
    freq = rng.uniform(0.15, 0.5, (24, 3))
    phase = rng.uniform(0, 2 * np.pi, (24, 3))
    base_r = gt.r.copy()
    base_p = gt.p.copy()
    frames, masks, gts = [], [], []
    for t in range(n_frames):
        gt.update()
        rend = AvatarRenderer(gt, intrin)
        d = np.asarray(rend.render_depth((H, W)))
        frames.append((np.where(d > 0, d, bg) * 1000).astype(np.uint16))
        masks.append(np.asarray(rend.render_part_mask((H, W))))
        gts.append(gt.joint_pos.copy())
        wig = amp * np.sin(freq * (t + 1) + phase)
        step = np.asarray(rotation.so3_exp(jnp.asarray(wig, jnp.float32)))
        gt.r = np.einsum("jab,jbc->jac", step, base_r)
        gt.p = base_p + np.array([0.25 * np.sin(0.2 * (t + 1)), 0.0,
                                  0.15 * np.sin(0.13 * (t + 1))])
    return frames, masks, gts


def run_long(args):
    """Long-horizon stress eval (SURVEY §5.3 resilience; VERDICT r2 item 8).

    Streams a 500-frame synthetic sequence through the tracker one frame at
    a time (no frame storage) with five phases:
      normal(0-149) -> fast limbs(150-199) -> partial occlusion(200-239)
      -> person absent(240-259) -> normal again(260-end).
    Reports per-phase joint error, drift (late-normal vs early-normal),
    whole-body reinit count, per-limb recovery events, and the recovery
    latency after the occluder disappears / the person returns.  Writes a
    JSON report (--json-out, default data/eval_long.json).
    """
    import json

    import jax.numpy as jnp

    from avatar_tpu.core import rotation
    from avatar_tpu.core.lbs import lbs
    from avatar_tpu.core.model import Avatar
    from avatar_tpu.io.calibration import CameraIntrin
    from avatar_tpu.perception.partgroups import SMPL24_GROUP_LUT
    from avatar_tpu.perception.rtree import RTree
    from avatar_tpu.render.renderer import AvatarRenderer
    from avatar_tpu.testing import synthetic_model
    from avatar_tpu.tracking import TrackerConfig
    from avatar_tpu.tracking_fused import FusedTracker

    H, W = 720, 1280
    intrin = CameraIntrin(fx=606.438, fy=606.351, cx=637.294, cy=366.992)
    model = synthetic_model(detail=6)
    bg = np.full((H, W), 4.0, np.float32)
    n_frames = args.frames if args.frames > 24 else 500

    PHASES = [("normal", 0, min(150, n_frames)),
              ("fast_limbs", 150, min(200, n_frames)),
              ("occluded", 200, min(240, n_frames)),
              ("absent", 240, min(260, n_frames)),
              ("normal2", 260, n_frames)]

    gt = Avatar(model)
    gt.randomize(seed=77)
    gt.w *= 0.3
    gt.p = np.array([0.0, 0.1, 2.6])
    gt.r[0] = np.diag([-1.0, 1.0, -1.0])
    rng = np.random.default_rng(8)
    amp = rng.normal(0, 0.10, (24, 3))
    freq = rng.uniform(0.15, 0.5, (24, 3))
    phase = rng.uniform(0, 2 * np.pi, (24, 3))
    base_r = gt.r.copy()
    base_p = gt.p.copy()
    ARM = np.zeros((24, 3))
    ARM[16:24] = 1.0         # shoulders..hands
    ARM[[4, 5, 7, 8]] = 0.6  # plus legs, for fast-kick coverage

    tree = None
    if not args.oracle:
        trees = [RTree(p) for p in args.forest.split(",")]
        for t in trees:
            t.partmap_type = 0
        tree = trees if len(trees) > 1 else trees[0]
    cfg_kw = dict(data_interval=6, min_points=1000, frame_icp_iters=2,
                  reinit_icp_iters=6, initial_icp_iters=7, iters_per_icp=4,
                  label_conf_thresh=0.55, rtree_interval=3,
                  part_groups=None if args.no_part_groups
                  else tuple(SMPL24_GROUP_LUT))
    for ov in args.set:
        k, v = ov.split("=", 1)
        try:
            v = eval(v)
        except Exception:
            pass
        cfg_kw[k] = v
    tracker = FusedTracker(model, intrin, (H, W), rtree=tree,
                           config=TrackerConfig(**cfg_kw))
    tracker.set_background(bg)

    errs = np.full(n_frames, np.nan)
    reinits = []
    hov_phase = {}
    t0 = time.time()
    for t in range(n_frames):
        ph = next(name for name, a, b in PHASES if a <= t < b)
        absent = ph == "absent"
        fast = ph == "fast_limbs"
        if not absent:
            gt.update()
            rend = AvatarRenderer(gt, intrin)
            d = np.asarray(rend.render_depth((H, W)))
            scene = np.where(d > 0, d, bg)
            if ph == "occluded":
                # vertical slab at 1.6 m covering the body's left image half
                # (the occluder hides ~40% of foreground pixels)
                scene[:, 560:720] = 1.6
            frame = (scene * 1000).astype(np.uint16)
            mask = (np.asarray(rend.render_part_mask((H, W)))
                    if args.oracle else None)
        else:
            frame = (bg * 1000).astype(np.uint16)
            mask = (np.full((H, W), 255, np.uint8) if args.oracle else None)
        res = tracker.track(frame, labels_override=mask)
        if res.reinitialized:
            reinits.append(t)
        if res.fit_info:
            # selective-walk hard-bucket overflow, tracked per phase: the
            # K/3 bucket silently degrades overflowing low-confidence
            # pixels, and occlusion phases are where overflow would occur
            hov_phase.setdefault(ph, []).append(
                res.fit_info.get("hard_overflow", 0.0))
        if not absent:
            th = tracker._theta
            _, joints, _, _ = lbs(model.params, model.parents, th.w, th.p,
                                  th.rots)
            errs[t] = np.linalg.norm(np.asarray(joints) - gt.joint_pos,
                                     axis=1).mean()
        # advance GT motion
        sc = 1.0 + 2.0 * ARM * fast
        wig = amp * sc * np.sin(freq * (1.0 + 1.0 * fast) * (t + 1) + phase)
        step = np.asarray(rotation.so3_exp(jnp.asarray(wig, jnp.float32)))
        gt.r = np.einsum("jab,jbc->jac", step, base_r)
        drift = 0.3 * np.sin(2 * np.pi * (t + 1) / n_frames)
        gt.p = base_p + np.array([0.25 * np.sin(0.2 * (t + 1)) + drift, 0.0,
                                  0.15 * np.sin(0.13 * (t + 1))])
        if t % 50 == 49:
            print(f"[eval-long] frame {t + 1}/{n_frames} ({ph}) "
                  f"err {errs[t] * 1e3 if errs[t] == errs[t] else -1:.0f}mm "
                  f"reinits {len(reinits)} ({time.time() - t0:.0f}s)",
                  file=sys.stderr)

    def seg_mean(a, b):
        seg = errs[a:b]
        seg = seg[np.isfinite(seg)]
        return float(np.mean(seg) * 1e3) if seg.size else None

    # recovery latency: frames from phase re-entry until err < 60 mm
    def recovery_latency(start):
        for t in range(start, n_frames):
            if np.isfinite(errs[t]) and errs[t] < 0.060:
                return t - start
        return None

    report = {
        "frames": n_frames,
        "labels": "oracle" if args.oracle else "forest",
        "per_phase_joint_err_mm": {
            name: seg_mean(max(a, 1), b) for name, a, b in PHASES},
        "drift_mm": (None if n_frames < 500 else round(
            seg_mean(400, 500) - seg_mean(50, 150), 2)),
        "reinit_frames": reinits,
        "n_reinits": len(reinits),
        "limb_recovery_events": {int(k): int(v) for k, v in
                                 tracker.limb_recoveries.items()},
        "hard_overflow_frac_per_phase": {
            ph: round(float(np.mean(v)), 4) for ph, v in hov_phase.items()},
        "occlusion_recovery_frames": recovery_latency(240) if n_frames > 240
        else None,
        "return_recovery_frames": recovery_latency(260) if n_frames > 260
        else None,
        "wall_s": round(time.time() - t0, 1),
    }
    line = json.dumps(report, indent=1)
    print(line)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(line + "\n")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--forest", default="data/bench_forest.srtr")
    ap.add_argument("--oracle", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--no-part-groups", action="store_true")
    ap.add_argument("--long", action="store_true",
                    help="500-frame streaming stress eval (occlusion, "
                    "fast limbs, scene exit) with a JSON report")
    ap.add_argument("--json-out", default="data/eval_long.json")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VAL", help="TrackerConfig override "
                    "(repeatable), e.g. --set beta_temp=0.5")
    args = ap.parse_args()
    if args.cpu:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    global jnp
    import jax.numpy as jnp

    if args.long:
        run_long(args)
        return

    from avatar_tpu.core.lbs import lbs
    from avatar_tpu.io.calibration import CameraIntrin
    from avatar_tpu.perception.partgroups import SMPL24_GROUP_LUT
    from avatar_tpu.perception.rtree import RTree
    from avatar_tpu.testing import synthetic_model
    from avatar_tpu.tracking import TrackerConfig
    from avatar_tpu.tracking_fused import FusedTracker

    H, W = 720, 1280
    intrin = CameraIntrin(fx=606.438, fy=606.351, cx=637.294, cy=366.992)
    model = synthetic_model(detail=6)
    bg = np.full((H, W), 4.0, np.float32)
    frames, masks, gts = build_sequence(model, intrin, H, W, args.frames, bg)
    print(f"[eval] {args.frames} frames rendered", file=sys.stderr)

    tree = None
    if not args.oracle:
        trees = [RTree(p) for p in args.forest.split(",")]
        for t in trees:
            t.partmap_type = 0
        tree = trees if len(trees) > 1 else trees[0]
    cfg_kw = dict(data_interval=6, min_points=1000, frame_icp_iters=2,
                  reinit_icp_iters=6, initial_icp_iters=7, iters_per_icp=4,
                  label_conf_thresh=0.55, rtree_interval=3,
                  part_groups=None if args.no_part_groups
                  else tuple(SMPL24_GROUP_LUT))
    for ov in args.set:
        k, v = ov.split("=", 1)
        try:
            v = eval(v)  # numeric / tuple literals
        except Exception:
            pass
        cfg_kw[k] = v
    tracker = FusedTracker(model, intrin, (H, W), rtree=tree,
                           config=TrackerConfig(**cfg_kw))
    tracker.set_background(bg)

    errs, perj = [], []
    t0 = time.time()
    for i, f in enumerate(frames):
        tracker.track(f, labels_override=masks[i] if args.oracle else None)
        th = tracker._theta
        _, joints, _, _ = lbs(model.params, model.parents, th.w, th.p,
                              th.rots)
        d = np.linalg.norm(np.asarray(joints) - gts[i], axis=1)
        errs.append(d.mean())
        perj.append(d)
    mean_mm = float(np.mean(errs[1:]) * 1e3)
    print(f"[eval] joint_err mean(skip0) {mean_mm:.1f}mm "
          f"max {np.max(errs[1:]) * 1e3:.0f}mm  ({time.time() - t0:.0f}s)")
    pj = np.mean(np.stack(perj[1:]), 0) * 1e3
    worst = np.argsort(pj)[::-1][:8]
    print("[eval] worst joints: " +
          " ".join(f"j{j}={pj[j]:.0f}" for j in worst))


if __name__ == "__main__":
    main()
