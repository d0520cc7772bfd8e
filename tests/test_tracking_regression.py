"""Tracking-accuracy regression gates (VERDICT r2 item 6).

Runs the fused tracker over the quick benchmark configuration (the same
synthetic ground-truth sequence bench.py --quick uses) with oracle labels
and asserts joint-error / vertex-RMSE ceilings, so an accuracy regression
in the fit, correspondence, or tracking state machine fails CI loudly
instead of only drifting the bench numbers.  Reference anchor: the
optim.cpp round-trip idea (optim.cpp:18-156) extended to a sequence.

Measured baseline at this configuration (CPU f32): joint_err ~20.9 mm,
vertex_rmse ~32.8 mm (re-measured round 4; the config's operating point
moved when the full-bench defaults were retuned in round 3 — plane_weight
2.0 / beta_temp 0.3 are each individually optimal here too, verified by
single-knob reversion probes, reproducible via
scripts/probe_quick_reversions.py: tuned 21.5 mm joint / 34.2 mm vertex
vs 25.1 (plane_weight=1.0), 30.7 (beta_temp=0.0), 31.8 (both) mm joint).
Ceilings are ~1.15x measured, so a real
regression fails CI while f32 platform noise does not.  The production
operating point (1280x720, forest labels) is gated on the GPU by
chip_smoke.py's joint-error bound.
"""

import numpy as np
import pytest


@pytest.mark.slow
def test_quick_sequence_joint_error_ceiling():
    import jax.numpy as jnp

    from avatar_tpu.core import rotation
    from avatar_tpu.core.lbs import lbs
    from avatar_tpu.core.model import Avatar
    from avatar_tpu.io.calibration import CameraIntrin
    from avatar_tpu.render.renderer import AvatarRenderer
    from avatar_tpu.testing import synthetic_model
    from avatar_tpu.tracking import TrackerConfig
    from avatar_tpu.tracking_fused import FusedTracker

    H, W = 256, 256
    intrin = CameraIntrin(fx=220.0, fy=220.0, cx=128.0, cy=128.0)
    model = synthetic_model(detail=2)
    bg = np.full((H, W), 4.0, np.float32)

    # bench.py --quick ground-truth sequence (bench.py:86-127)
    gt = Avatar(model)
    gt.randomize(seed=77)
    gt.w *= 0.3
    gt.p = np.array([0.0, 0.1, 2.6])
    gt.r[0] = np.diag([-1.0, 1.0, -1.0])
    rng = np.random.default_rng(8)
    amp = rng.normal(0, 0.10, (24, 3))
    freq = rng.uniform(0.15, 0.5, (24, 3))
    phase = rng.uniform(0, 2 * np.pi, (24, 3))
    base_r, base_p = gt.r.copy(), gt.p.copy()

    cfg = TrackerConfig(data_interval=4, min_points=200, frame_icp_iters=3,
                        reinit_icp_iters=6, initial_icp_iters=7,
                        iters_per_icp=4, rtree_interval=2)
    tracker = FusedTracker(model, intrin, (H, W), config=cfg)
    tracker.set_background(bg)

    errs, vrms = [], []
    for t in range(8):
        gt.update()
        rend = AvatarRenderer(gt, intrin)
        d = np.asarray(rend.render_depth((H, W)))
        frame = (np.where(d > 0, d, bg) * 1000).astype(np.uint16)
        mask = np.asarray(rend.render_part_mask((H, W)))
        res = tracker.track(frame, labels_override=mask)
        assert res.ok
        th = tracker._theta
        verts, joints, _, _ = lbs(model.params, model.parents, th.w, th.p,
                                  th.rots)
        errs.append(np.linalg.norm(np.asarray(joints) - gt.joint_pos,
                                   axis=1).mean())
        vrms.append(np.sqrt(np.mean(np.sum(
            (np.asarray(verts) - gt.cloud) ** 2, axis=1))))
        wig = amp * np.sin(freq * (t + 1) + phase)
        step = np.asarray(rotation.so3_exp(jnp.asarray(wig, jnp.float32)))
        gt.r = np.einsum("jab,jbc->jac", step, base_r)
        gt.p = base_p + np.array([0.25 * np.sin(0.2 * (t + 1)), 0.0,
                                  0.15 * np.sin(0.13 * (t + 1))])

    joint_err_mm = float(np.mean(errs[1:]) * 1e3)
    vertex_rmse_mm = float(np.mean(vrms[1:]) * 1e3)
    print(f"\n[gate] joint_err={joint_err_mm:.2f}mm "
          f"vertex_rmse={vertex_rmse_mm:.2f}mm")
    assert joint_err_mm < 24.0, f"joint error regressed: {joint_err_mm:.1f}mm"
    assert vertex_rmse_mm < 38.0, \
        f"vertex RMSE regressed: {vertex_rmse_mm:.1f}mm"


@pytest.mark.slow
def test_occlusion_phase_error_ceiling():
    """Occlusion-resilience gate (VERDICT r4 item 4): a vertical occluder
    slab at 1.6 m (body at ~2.6 m) covers the body's left image half for
    four frames.  Without the body-depth foreground gate (f25c1ba) the
    occluder's points — which carry stale oracle body labels exactly like
    a forest would mislabel them — drag the fit meters away (the stale
    round-3 long-eval recorded 1030 mm in this phase).  With the gate the
    pose must stay within a bounded multiple of the unoccluded error and
    recover immediately when the occluder leaves.  Mirrors the occlusion
    phase of scripts/eval_tracking.py --long on the quick config."""
    import jax.numpy as jnp

    from avatar_tpu.core import rotation
    from avatar_tpu.core.lbs import lbs
    from avatar_tpu.core.model import Avatar
    from avatar_tpu.io.calibration import CameraIntrin
    from avatar_tpu.render.renderer import AvatarRenderer
    from avatar_tpu.testing import synthetic_model
    from avatar_tpu.tracking import TrackerConfig
    from avatar_tpu.tracking_fused import FusedTracker

    H, W = 256, 256
    intrin = CameraIntrin(fx=220.0, fy=220.0, cx=128.0, cy=128.0)
    model = synthetic_model(detail=2)
    bg = np.full((H, W), 4.0, np.float32)

    gt = Avatar(model)
    gt.randomize(seed=77)
    gt.w *= 0.3
    gt.p = np.array([0.0, 0.1, 2.6])
    gt.r[0] = np.diag([-1.0, 1.0, -1.0])
    rng = np.random.default_rng(8)
    amp = rng.normal(0, 0.06, (24, 3))
    freq = rng.uniform(0.15, 0.5, (24, 3))
    phase = rng.uniform(0, 2 * np.pi, (24, 3))
    base_r, base_p = gt.r.copy(), gt.p.copy()

    cfg = TrackerConfig(data_interval=4, min_points=200, frame_icp_iters=3,
                        reinit_icp_iters=6, initial_icp_iters=7,
                        iters_per_icp=4, rtree_interval=2)
    tracker = FusedTracker(model, intrin, (H, W), config=cfg)
    tracker.set_background(bg)

    errs = []
    for t in range(12):
        gt.update()
        rend = AvatarRenderer(gt, intrin)
        d = np.asarray(rend.render_depth((H, W)))
        scene = np.where(d > 0, d, bg)
        mask = np.asarray(rend.render_part_mask((H, W)))
        if 4 <= t < 8:
            # slab in front of the body's left image half; oracle labels
            # deliberately NOT updated (the occluder keeps body labels at
            # the wrong depth, the same failure mode forest labels produce)
            scene[:, 112:144] = 1.6
        frame = (scene * 1000).astype(np.uint16)
        res = tracker.track(frame, labels_override=mask)
        assert res.ok
        th = tracker._theta
        _, joints, _, _ = lbs(model.params, model.parents, th.w, th.p,
                              th.rots)
        errs.append(np.linalg.norm(np.asarray(joints) - gt.joint_pos,
                                   axis=1).mean())
        wig = amp * np.sin(freq * (t + 1) + phase)
        step = np.asarray(rotation.so3_exp(jnp.asarray(wig, jnp.float32)))
        gt.r = np.einsum("jab,jbc->jac", step, base_r)
        gt.p = base_p + np.array([0.1 * np.sin(0.2 * (t + 1)), 0.0, 0.0])

    normal_mm = float(np.mean(errs[1:4]) * 1e3)
    occl_mm = float(np.mean(errs[4:8]) * 1e3)
    after_mm = float(np.mean(errs[8:]) * 1e3)
    print(f"\n[gate-occl] normal={normal_mm:.1f}mm occluded={occl_mm:.1f}mm "
          f"after={after_mm:.1f}mm")
    # the gated tracker holds the occluded phase bounded (the ungated
    # failure mode is >1000 mm); measured 27.3 / 15.8 mm — the 40 mm
    # ceiling CI-holds the "<40 mm with the gate" claim (tracking.py)
    assert occl_mm < 40.0, f"occluded-phase error blew up: {occl_mm:.1f}mm"
    assert after_mm < 30.0, f"post-occlusion recovery failed: {after_mm:.1f}mm"
