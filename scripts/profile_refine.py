"""Component-level timing of fit_refine on the live backend.

The in-tracker surface refine step costs several times the main fit's
step, so this probe times each candidate in isolation (NN,
surface_correspond, median, cho_factor, forward, whole fit_refine at
several budgets) to find where the time actually goes.
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")


def t(label, fn, n=20):
    import jax
    fn()  # compile
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    ms = (time.perf_counter() - t0) / n * 1e3
    print(f"{label:44s} {ms:8.3f} ms")
    return ms


def main():
    import jax
    import jax.numpy as jnp

    from avatar_tpu.optim import correspond
    from avatar_tpu.optim.gauss_newton import (FitContext, PriorData, Theta,
                                               _forward, _icp_jacobian,
                                               fit, fit_refine)
    from avatar_tpu.optim.surface import surface_correspond, \
        vertex_face_rings
    from avatar_tpu.testing import synthetic_model

    model = synthetic_model(detail=6)
    P = model.num_points()
    J = model.num_joints()
    prior = PriorData.from_model(model) if hasattr(PriorData, "from_model") \
        else None
    from avatar_tpu.tracking_fused import FusedTracker
    from avatar_tpu.io.calibration import CameraIntrin

    intrin = CameraIntrin(fx=606.438, fy=606.351, cx=637.294, cy=366.992)
    tracker = FusedTracker(model, intrin, (720, 1280))
    ctx = tracker._ctx
    print(f"P={P} J={J} backend={jax.default_backend()}")

    rng = np.random.default_rng(0)
    N = 8192
    from avatar_tpu.core.lbs import lbs
    av_w = jnp.zeros(model.num_shape_keys(), jnp.float32)
    av_p = jnp.asarray([0.0, 0.0, 2.2], jnp.float32)
    av_r = jnp.asarray(np.tile(np.eye(3), (J, 1, 1)), jnp.float32)
    theta = Theta(p=av_p, rots=av_r, w=av_w)
    verts, _, _, _ = lbs(model.params, model.parents, av_w, av_p, av_r)
    pick = rng.integers(0, P, N)
    pts = jnp.asarray(np.asarray(verts)[pick] +
                      rng.normal(0, 0.004, (N, 3)).astype(np.float32))
    parts = jnp.asarray(np.asarray(ctx.model_part)[pick].astype(np.int32))
    ring = jnp.asarray(vertex_face_rings(np.asarray(model.faces), P))
    parents = model.parents

    bp = jnp.asarray(0.003, jnp.float32)
    bs = jnp.asarray(0.012, jnp.float32)

    # whole fit_refine at several budgets -> per-step slope
    for ns in (1, 2, 4, 8):
        t(f"fit_refine n_steps={ns}",
          jax.jit(lambda pts=pts, ns=ns: fit_refine(
              ctx, parents, ring, pts, parts, theta, bp, bs, n_steps=ns,
              num_parts=tracker.num_parts, freeze_shape=True)[0].p))

    # main fit at same budgets for comparison
    for ns in (1, 4, 8):
        t(f"fit        n_steps={ns}",
          jax.jit(lambda pts=pts, ns=ns: fit(
              ctx, parents, pts, parts, theta, bp, bs, n_steps=ns,
              num_parts=tracker.num_parts, freeze_shape=True)[0].p))

    # components
    fwd = _forward(ctx, parents, theta, True)
    x = fwd[0]
    vis = jnp.ones(P, jnp.bool_)

    if correspond.nn_route() == "triton":
        plan = correspond.make_nn_plan(
            pts, parts, ctx.model_part, num_parts=tracker.num_parts)
        t("make_nn_plan (once per fit)",
          jax.jit(lambda: correspond.make_nn_plan(
              pts, parts, ctx.model_part,
              num_parts=tracker.num_parts).dpts))
        st = correspond.find_nn_stats_planned(plan, x, vis)
        t("find_nn_stats_planned (per step)",
          jax.jit(lambda: correspond.find_nn_stats_planned(
              plan, x, vis).corr))
    else:
        st = correspond.find_nn_stats(pts, parts, x, ctx.model_part, vis)
        t("find_nn_stats xla (per step)",
          jax.jit(lambda: correspond.find_nn_stats(
              pts, parts, x, ctx.model_part, vis).corr))

    corr = st.corr
    t("surface_correspond (per step)",
      jax.jit(lambda: surface_correspond(
          pts, corr, x, ctx.faces, ring)[1]))

    dist = jnp.asarray(rng.random(N).astype(np.float32))
    t("nanmedian[8192] (per step)",
      jax.jit(lambda: jnp.nanmedian(jnp.where(dist > 0.5, dist, jnp.nan))))

    D = 3 + 3 * J + model.num_shape_keys()
    M = jnp.asarray(np.eye(D, dtype=np.float32) * 4.0 +
                    rng.random((D, D)).astype(np.float32) * 0.01)
    import jax.scipy.linalg as jsl
    t(f"cho_factor+solve [{D}x{D}] (per step)",
      jax.jit(lambda: jsl.cho_solve(jsl.cho_factor(M),
                                    jnp.ones(D, jnp.float32))))

    t("_forward (per step, trial)",
      jax.jit(lambda: _forward(ctx, parents, theta, True)[0]))
    t("_icp_jacobian full-D (per step)",
      jax.jit(lambda: _icp_jacobian(ctx, parents, theta, fwd)))


if __name__ == "__main__":
    main()
