"""Per-stage device timing of the fused frame pipeline (bench config).

Times each stage as its own jitted program on the active backend (forest
walk, background subtraction + CC, blob suppression, GN/LM fit and its
sub-pieces, full fused frame) so the device budget is attributable.  Each
figure is the median of blocking calls (host clock, dispatch included).
Run on the GPU for real numbers:

    python scripts/profile_frame.py [--window]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--forest", default="data/bench_forest.srtr")
    ap.add_argument("--window", action="store_true",
                    help="time the tracked-window configuration")
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args()
    if args.cpu:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from avatar_tpu.core.model import Avatar
    from avatar_tpu.io.calibration import CameraIntrin
    from avatar_tpu.perception.partgroups import SMPL24_GROUP_LUT
    from avatar_tpu.perception.rtree import RTree, forest_walk, \
        suppress_part_nonmax
    from avatar_tpu.profiling import time_jitted
    from avatar_tpu.render.renderer import AvatarRenderer
    from avatar_tpu.testing import synthetic_model
    from avatar_tpu.tracking import TrackerConfig
    from avatar_tpu.tracking_fused import FusedTracker

    IT = args.iters

    H, W = 720, 1280
    intrin = CameraIntrin(fx=606.438, fy=606.351, cx=637.294, cy=366.992)
    model = synthetic_model(detail=6)
    gt = Avatar(model)
    gt.randomize(seed=77)
    gt.w *= 0.3
    gt.p = np.array([0.0, 0.1, 2.6])
    gt.r[0] = np.diag([-1.0, 1.0, -1.0])
    gt.update()
    rend = AvatarRenderer(gt, intrin)
    depth = np.asarray(rend.render_depth((H, W)))
    scene = np.where(depth > 0, depth, 4.0).astype(np.float32)

    paths = [args.forest]
    k = 1
    while os.path.exists(args.forest.replace(".srtr", f"_{k}.srtr")):
        paths.append(args.forest.replace(".srtr", f"_{k}.srtr"))
        k += 1
    trees = [RTree(p) for p in paths]
    for t in trees:
        t.partmap_type = 0
    cfg = TrackerConfig(data_interval=6, min_points=1000, frame_icp_iters=3,
                        iters_per_icp=4, label_conf_thresh=0.55,
                        rtree_interval=3, beta_temp=0.3,
                        render_label_tau=0.03,
                        part_groups=tuple(SMPL24_GROUP_LUT),
                        seg_window=(576, 448) if args.window else None)
    tracker = FusedTracker(model, intrin, (H, W),
                           rtree=trees if len(trees) > 1 else trees[0],
                           config=cfg)
    tracker.set_background(np.full((H, W), 4.0, np.float32))

    ss = tracker._host_stride
    d_s = jnp.asarray(scene[::ss, ::ss])
    u16 = jnp.asarray((np.asarray(d_s) * 1000).astype(np.uint16))
    lab0 = jnp.zeros(tracker._proc_size, jnp.uint8)

    def t(name, fn, *a, **kw):
        r = time_jitted(fn, *a, iters=IT, **kw)
        print(f"{name:<28}: {r['p50_ms']:7.3f} ms")
        return r["p50_ms"]

    # -- fused frame at several step budgets --------------------------------
    # n_steps=0 skips the LM loop entirely: pure segmentation+assembly cost.
    full12 = t("fused_frame 12 steps", lambda: tracker._run(u16, lab0, 12))
    seg0 = t("fused_frame 0 steps (seg)", lambda: tracker._run(u16, lab0, 0))
    full6 = t("fused_frame 6 steps", lambda: tracker._run(u16, lab0, 6))
    print(f"{'  -> fit (12-0 delta)':<28}: {full12 - seg0:7.3f} ms"
          f"   per-step {(full12 - full6) / 6.0:.3f}")

    # -- stage pieces --------------------------------------------------------
    Hs, Ws = d_s.shape
    tl = jnp.asarray([0, 0], jnp.int32)
    br = jnp.asarray([Ws - 1, Hs - 1], jnp.int32)
    md = tracker._max_depth
    tt = tracker._tree
    if tt is not None and tt.u.ndim == 2:
        t(f"forest_walk full {Hs}x{Ws}",
          lambda: forest_walk(tt, d_s, md, 1, tl, br))

    from avatar_tpu.tracking_fused import _bg_subtract

    xyz = jnp.stack([d_s, d_s, d_s], axis=-1)
    bg = jnp.stack([tracker._bg] * 3, axis=-1)
    f_bg = jax.jit(lambda a, b: _bg_subtract(a, b, 0.02, 0.02, 10))
    t(f"bgsub+cc {Hs}x{Ws}", f_bg, xyz, bg)

    lab = jnp.zeros((Hs // 2, Ws // 2), jnp.uint8)
    com = jnp.zeros((2, tracker.num_parts), jnp.float32)
    t("blob_suppress", lambda: suppress_part_nonmax(
        lab, com, tracker.num_parts, ss * 2, 0.001,
        jnp.asarray([0, 0], jnp.int32)))

    # -- fit sub-pieces ------------------------------------------------------
    from avatar_tpu.optim.gauss_newton import Theta, _forward, \
        _icp_jacobian, _prior_terms, fit
    from avatar_tpu.optim import correspond

    ctx = tracker._ctx_fit if tracker._ctx_fit is not None else tracker._ctx
    P = ctx.lbs.weights.shape[0]
    rng = np.random.default_rng(0)
    npts = 4096
    pad = 8192
    idx = rng.choice(model.num_points(), npts, replace=False)
    mp = np.asarray(tracker._ctx.model_part)
    pts = np.zeros((pad, 3), np.float32)
    pts[:npts] = gt.cloud[idx] + rng.normal(0, 0.002, (npts, 3))
    parts = np.full(pad, -1, np.int32)
    parts[:npts] = mp[idx]
    ptsj = jnp.asarray(pts)
    partsj = jnp.asarray(parts)
    th = tracker._theta
    bp = jnp.asarray(0.05, jnp.float32)
    bs = jnp.asarray(0.12, jnp.float32)

    for steps in (12, 8, 1):
        t(f"fit {steps} steps pad{pad}",
          lambda s=steps: fit(ctx, model.parents, ptsj, partsj, th, bp, bs,
                              n_steps=s, num_parts=tracker.num_parts))

    fwd_fn = jax.jit(lambda th_: _forward(ctx, model.parents, th_, True),
                     static_argnums=())
    fwd = fwd_fn(th)
    jax.block_until_ready(fwd)
    t("  _forward", fwd_fn, th)
    jac_fn = jax.jit(
        lambda th_, f: _icp_jacobian(ctx, model.parents, th_, f))
    t("  _icp_jacobian", jac_fn, th, fwd)

    Jm = jac_fn(th, fwd)

    def gram(J):
        Jw = J * jnp.sqrt(jnp.ones(J.shape[0]))[:, None, None]
        return jax.lax.dot_general(Jw, Jw, (((0, 1), (0, 1)), ((), ())),
                                   precision=jax.lax.Precision.HIGHEST)

    gram_fn = jax.jit(gram)
    t("  gram JtJ", gram_fn, Jm)
    JtJ = gram_fn(Jm)

    def solve(M):
        cho = jax.scipy.linalg.cho_factor(
            M + 1e-2 * jnp.eye(M.shape[0], dtype=M.dtype))
        return jax.scipy.linalg.cho_solve(cho, M[:, 0])

    t("  cho_factor+solve 85", jax.jit(solve), JtJ)
    pr_fn = jax.jit(lambda th_, Rg: _prior_terms(
        ctx, model.parents, th_, Rg, bp, bs))
    t("  _prior_terms", pr_fn, th, fwd[3])

    x = fwd[0]
    vis = jnp.ones(P, bool)
    nn_fn = jax.jit(lambda d, dp, x_: correspond.find_nn_stats(
        d, dp, x_, ctx.model_part, vis, chunk=512))
    t("  find_nn (unplanned)", nn_fn, ptsj, partsj, x)
    if correspond.nn_route() == "triton":
        plan = correspond.make_nn_plan(ptsj, partsj, ctx.model_part,
                                       num_parts=tracker.num_parts)
        nnp_fn = jax.jit(lambda x_: correspond.find_nn_stats_planned(
            plan, x_, vis))
        t("  find_nn (planned)", nnp_fn, x)


if __name__ == "__main__":
    main()
