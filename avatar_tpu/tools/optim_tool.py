"""Synthetic ground-truth optimizer validator.

Rebuild of reference optim.cpp:18-156 (disabled there after API drift; fully
working here): render a randomized ground-truth avatar to depth, back-project
the foreground to a labeled point cloud, perturb a copy of the avatar, fit it
back, and report pose/vertex recovery errors.

    python -m avatar_tpu.tools.optim_tool --synthetic-model 2
"""

from __future__ import annotations

import argparse

import numpy as np

from avatar_tpu.core.model import Avatar
from avatar_tpu.io.calibration import CameraIntrin
from avatar_tpu.optim.optimizer import AvatarOptimizer
from avatar_tpu.render.renderer import AvatarRenderer
from avatar_tpu.tools.common import add_model_args, load_model
from avatar_tpu.utils import enable_compile_cache


def main(argv=None):
    enable_compile_cache()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--size", default="512x512")
    ap.add_argument("--interval", type=int, default=4,
                    help="data sampling stride")
    ap.add_argument("--icp-iters", type=int, default=10)
    ap.add_argument("--perturb-rot", type=float, default=0.06,
                    help="per-joint axis-angle perturbation stddev (rad)")
    ap.add_argument("--perturb-pos", type=float, default=0.03)
    ap.add_argument("--betapose", type=float, default=0.05)
    ap.add_argument("--betashape", type=float, default=0.12)
    add_model_args(ap)
    args = ap.parse_args(argv)

    import jax.numpy as jnp

    from avatar_tpu.core import rotation

    model = load_model(args)
    H, W = (int(x) for x in args.size.split("x"))
    intrin = CameraIntrin(fx=0.8 * W, fy=0.8 * W, cx=W / 2, cy=H / 2)

    gt = Avatar(model)
    gt.randomize(seed=args.seed)
    gt.w *= 0.3
    gt.p = np.array([0.0, 0.0, 2.5])
    gt.r[0] = np.diag([-1.0, 1.0, -1.0])
    gt.update()
    rend = AvatarRenderer(gt, intrin)
    depth = rend.render_depth((H, W))
    mask = rend.render_part_mask((H, W))

    iv = args.interval
    ys, xs = np.nonzero((depth > 0) & (mask != 255))
    sel = (ys % iv == 0) & (xs % iv == 0)
    ys, xs = ys[sel], xs[sel]
    z = depth[ys, xs]
    data = np.stack([(xs - intrin.cx) * z / intrin.fx,
                     -((ys - intrin.cy) * z / intrin.fy), z], 1)
    labels = mask[ys, xs].astype(np.int32)

    rng = np.random.default_rng(args.seed + 1)
    ava = Avatar(model)
    ava.p = gt.p + rng.normal(0, args.perturb_pos, 3)
    pert = rng.normal(0, args.perturb_rot, (model.num_joints(), 3))
    ava.r = np.einsum("jab,jbc->jac", np.asarray(
        rotation.so3_exp(jnp.asarray(pert, jnp.float32))), gt.r)
    ava.update()

    pre = np.sqrt(((ava.cloud - gt.cloud) ** 2).sum(1).mean())
    opt = AvatarOptimizer(ava, intrin, (H, W))
    opt.beta_pose = args.betapose
    opt.beta_shape = args.betashape
    opt.max_iters_per_icp = 1
    info = opt.optimize(data, labels, icp_iters=args.icp_iters * 10)
    post = np.sqrt(((ava.cloud - gt.cloud) ** 2).sum(1).mean())
    jerr = np.linalg.norm(ava.joint_pos - gt.joint_pos, axis=1).mean()
    print(f"data points: {len(data)}")
    print(f"vertex RMSE: {pre * 1e3:.2f} mm -> {post * 1e3:.2f} mm")
    print(f"mean joint error: {jerr * 1e3:.2f} mm")
    print(f"fit: {info}")
    return post


if __name__ == "__main__":
    main()
