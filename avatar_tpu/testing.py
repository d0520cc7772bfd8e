"""Deterministic synthetic humanoid models for tests and benchmarks.

The reference consumes the licensed SMPL ``model.npz`` (not redistributable),
so the test-suite and benchmarks run on a procedurally generated SMPL-like
humanoid with the same structure: 24 joints with the SMPL kinematic tree,
tube-mesh body with smooth LBS weights, shape blendshapes, joint regressor,
GMM pose prior, and a mocap-style pose bank.  All generation is seeded.

Use ``synthetic_model(detail=...)`` for an in-memory AvatarModel, or
``write_synthetic_model_npz`` to materialize a ``model.npz`` +
``pose_prior.txt`` directory that exercises the real loading path.
"""

from __future__ import annotations

import os

import numpy as np

from avatar_tpu.core.model import AvatarModel, SmplJoint
from avatar_tpu.core.pose_prior import GaussianMixture

# Rest-pose joint positions for an SMPL-like skeleton (meters, T-pose-ish,
# y up, pelvis at origin).  Indexed by SmplJoint ids.
_REST_JOINTS = np.array([
    [0.000, 0.000, 0.000],    # 0 pelvis
    [0.090, -0.085, 0.000],   # 1 l_hip
    [-0.090, -0.085, 0.000],  # 2 r_hip
    [0.000, 0.110, -0.010],   # 3 spine1
    [0.105, -0.480, 0.000],   # 4 l_knee
    [-0.105, -0.480, 0.000],  # 5 r_knee
    [0.000, 0.250, -0.015],   # 6 spine2
    [0.090, -0.870, -0.020],  # 7 l_ankle
    [-0.090, -0.870, -0.020], # 8 r_ankle
    [0.000, 0.310, -0.005],   # 9 spine3
    [0.110, -0.930, 0.110],   # 10 l_foot
    [-0.110, -0.930, 0.110],  # 11 r_foot
    [0.000, 0.450, -0.010],   # 12 neck
    [0.075, 0.390, -0.010],   # 13 l_collar
    [-0.075, 0.390, -0.010],  # 14 r_collar
    [0.000, 0.550, 0.010],    # 15 head
    [0.180, 0.410, -0.010],   # 16 l_shoulder
    [-0.180, 0.410, -0.010],  # 17 r_shoulder
    [0.440, 0.400, -0.010],   # 18 l_elbow
    [-0.440, 0.400, -0.010],  # 19 r_elbow
    [0.690, 0.395, -0.010],   # 20 l_wrist
    [-0.690, 0.395, -0.010],  # 21 r_wrist
    [0.780, 0.390, -0.010],   # 22 l_hand
    [-0.780, 0.390, -0.010],  # 23 r_hand
])

_PARENTS = np.array([-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
                     16, 17, 18, 19, 20, 21], np.int32)

# Tube radius per bone (indexed by child joint id), meters.
_BONE_RADIUS = {
    1: 0.075, 2: 0.075, 3: 0.105, 4: 0.062, 5: 0.062, 6: 0.115, 7: 0.045,
    8: 0.045, 9: 0.110, 10: 0.040, 11: 0.040, 12: 0.048, 13: 0.070,
    14: 0.070, 15: 0.075, 16: 0.052, 17: 0.052, 18: 0.042, 19: 0.042,
    20: 0.034, 21: 0.034, 22: 0.030, 23: 0.030,
}


def _smoothstep(t):
    t = np.clip(t, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def synthetic_arrays(detail: int = 1, n_keys: int = 10, seed: int = 7) -> dict:
    """Build the raw model arrays.  detail=1 -> ~1.1k verts (tests);
    detail=3 -> ~6.6k verts (bench, SMPL-scale)."""
    rng = np.random.default_rng(seed)
    n_seg = 6 + 2 * detail          # vertices per ring
    n_rings = 4 + 2 * detail        # rings per bone
    J = 24
    joints = _REST_JOINTS.copy()

    verts = []
    weights = []
    faces = []

    for child in range(1, J):
        par = int(_PARENTS[child])
        a, b = joints[par], joints[child]
        axis = b - a
        length = np.linalg.norm(axis)
        if length < 1e-9:
            continue
        axis_n = axis / length
        # orthonormal frame
        up = np.array([0.0, 0.0, 1.0]) if abs(axis_n[2]) < 0.9 else np.array(
            [1.0, 0.0, 0.0])
        e1 = np.cross(axis_n, up)
        e1 /= np.linalg.norm(e1)
        e2 = np.cross(axis_n, e1)
        radius = _BONE_RADIUS[child]
        base = len(verts)
        for ri in range(n_rings):
            t = ri / (n_rings - 1.0)
            # taper the tube slightly toward the child end
            r = radius * (1.0 - 0.25 * t)
            center = a + axis * t
            for si in range(n_seg):
                ang = 2 * np.pi * si / n_seg
                pnt = center + r * (np.cos(ang) * e1 + np.sin(ang) * e2)
                verts.append(pnt)
                wrow = np.zeros(J)
                # blend parent-controlled bone toward child joint near its end
                s = _smoothstep((t - 0.55) / 0.45)
                wrow[par] = 1.0 - s
                wrow[child] = s
                weights.append(wrow)
        for ri in range(n_rings - 1):
            for si in range(n_seg):
                v00 = base + ri * n_seg + si
                v01 = base + ri * n_seg + (si + 1) % n_seg
                v10 = base + (ri + 1) * n_seg + si
                v11 = base + (ri + 1) * n_seg + (si + 1) % n_seg
                # winding chosen so face normals point outward (SMPL
                # convention; the optimizer's backface cull and the
                # renderer's Lambert visibility both assume it)
                faces.append([v00, v01, v10])
                faces.append([v01, v11, v10])

    verts = np.asarray(verts)
    weights = np.asarray(weights)
    faces = np.asarray(faces, np.int32)
    P = verts.shape[0]

    # Joint regressor: joints from nearby verts (inverse-distance over the
    # k closest vertices), normalized rows.
    joint_reg = np.zeros((J, P))
    for j in range(J):
        d = np.linalg.norm(verts - joints[j], axis=1)
        k = min(24, P)
        idx = np.argsort(d)[:k]
        wv = 1.0 / (d[idx] + 0.02)
        joint_reg[j, idx] = wv / wv.sum()
    # Correct the template so J_reg @ v_template == joints exactly:
    # add a rank-J correction spread over the regressor support.
    err = joints - joint_reg @ verts  # [J, 3]
    # lstsq correction: verts += joint_reg^T @ pinv(joint_reg joint_reg^T) err
    G = joint_reg @ joint_reg.T
    corr = joint_reg.T @ np.linalg.solve(G + 1e-9 * np.eye(J), err)
    verts = verts + corr

    # Shape keys: smooth low-frequency displacement fields.  Key 0 is a
    # global widen/scale direction (so shape optimization has signal).
    shapedirs = np.zeros((P, 3, n_keys))
    center = verts.mean(axis=0)
    shapedirs[:, :, 0] = (verts - center) * 0.031  # ~"PC1" overall size
    for k in range(1, n_keys):
        freq = rng.uniform(1.0, 3.0, size=(3, 3))
        phase = rng.uniform(0, 2 * np.pi, size=(3, 3))
        amp = rng.uniform(0.002, 0.01, size=(3,))
        field = np.zeros((P, 3))
        for c in range(3):
            field[:, c] = amp[c] * np.sin(verts @ freq[c] + phase[c, 0])
        shapedirs[:, :, k] = field

    return dict(v_template=verts, parent=_PARENTS.copy(), faces=faces,
                joint_reg=joint_reg, weights=weights, shapedirs=shapedirs,
                use_jsr=True)


def synthetic_pose_prior(n_joints: int = 24, n_comps: int = 4,
                         seed: int = 11) -> GaussianMixture:
    """GMM pose prior over (J-1)*3 axis-angle dims, centered near rest pose."""
    rng = np.random.default_rng(seed)
    D = (n_joints - 1) * 3
    weights = rng.uniform(0.5, 1.5, n_comps)
    weights /= weights.sum()
    means = rng.normal(0.0, 0.12, size=(n_comps, D))
    covs = np.zeros((n_comps, D, D))
    for c in range(n_comps):
        A = rng.normal(0.0, 0.05, size=(D, D))
        covs[c] = A @ A.T * 0.05 + np.eye(D) * 0.04
    return GaussianMixture(weights, means, covs)


def synthetic_model(detail: int = 1, n_keys: int = 10, seed: int = 7,
                    with_prior: bool = True, dtype=None) -> AvatarModel:
    import jax.numpy as jnp

    arrays = synthetic_arrays(detail, n_keys, seed)
    prior = synthetic_pose_prior(24, seed=seed + 1) if with_prior else None
    return AvatarModel(arrays=arrays, pose_prior=prior,
                       dtype=dtype or jnp.float32)


def synthetic_pose_sequence(path: str, n_frames: int = 64, n_joints: int = 24,
                            seed: int = 13) -> None:
    """Write a mocap-style .dat/.txt pose bank of smooth random poses."""
    from avatar_tpu.core.sequence import AvatarPoseSequence

    rng = np.random.default_rng(seed)
    # Smooth trajectories: random walk in axis-angle space, low-pass filtered
    aa = np.cumsum(rng.normal(0, 0.02, size=(n_frames, n_joints, 3)), axis=0)
    aa += rng.normal(0, 0.1, size=(1, n_joints, 3))
    aa[:, 0, :] = 0.0  # root rotation stored separately below
    pos = np.cumsum(rng.normal(0, 0.01, size=(n_frames, 3)), axis=0)
    pos += np.array([0.0, 0.0, 2.8])
    # convert to quats (x, y, z, w)
    import jax.numpy as jnp

    from avatar_tpu.core import rotation

    mats = np.asarray(rotation.so3_exp(jnp.asarray(aa.reshape(-1, 3)))).reshape(
        n_frames, n_joints, 3, 3)
    quats = np.asarray(rotation.mat_to_quat(jnp.asarray(mats)))
    AvatarPoseSequence.write(path, pos, quats)


def write_synthetic_model_dir(out_dir: str, detail: int = 1, n_keys: int = 10,
                              seed: int = 7) -> str:
    """Materialize model.npz + pose_prior.txt in ``out_dir`` (exercises the
    real npz loading path of AvatarModel)."""
    os.makedirs(out_dir, exist_ok=True)
    arrays = synthetic_arrays(detail, n_keys, seed)
    J = arrays["parent"].shape[0]
    kintree = np.stack([
        np.where(arrays["parent"] < 0, np.uint32(0xFFFFFFFF),
                 arrays["parent"].astype(np.uint32)),
        np.arange(J, dtype=np.uint32),
    ])
    np.savez(
        os.path.join(out_dir, "model.npz"),
        v_template=arrays["v_template"],
        kintree_table=kintree,
        f=arrays["faces"].astype(np.uint32),
        J_regressor=arrays["joint_reg"],
        weights=arrays["weights"],
        shapedirs=arrays["shapedirs"],
    )
    synthetic_pose_prior(J, seed=seed + 1).save(
        os.path.join(out_dir, "pose_prior.txt"))
    return out_dir


# --- the benchmark scene (shared by bench.py and chip_smoke.py) -----------

# Azure Kinect 1280x720 depth intrinsics as the reference's live demo sets
# them (live-demo.cpp:179-184)
K4A_INTRIN = dict(fx=606.438, fy=606.351, cx=637.294, cy=366.992)


def bench_sequence(model: AvatarModel, intrin, size, n_frames: int) -> dict:
    """A ground-truth avatar moving smoothly in front of a wall 4 m away,
    rendered on device to uint16 millimeter depth frames (the camera-native
    format).

    Returns dict(frames=[(depth_u16 [H, W], part_mask [H, W])],
    joints=[J, 3] per frame, verts=[P, 3] per frame, theta0=(w, p, r) of
    frame 0, background=[H, W] float depth of the empty scene).
    """
    import jax.numpy as jnp

    from avatar_tpu.core import rotation
    from avatar_tpu.core.model import Avatar
    from avatar_tpu.render.renderer import AvatarRenderer

    H, W = size
    gt = Avatar(model)
    gt.randomize(seed=77)
    gt.w *= 0.3
    gt.p = np.array([0.0, 0.1, 2.6])
    gt.r[0] = np.diag([-1.0, 1.0, -1.0])
    rng = np.random.default_rng(8)
    # bounded sinusoidal joint motion around the base pose (a random walk
    # drifts into contortions no human performs)
    amp = rng.normal(0, 0.10, (24, 3))
    freq = rng.uniform(0.15, 0.5, (24, 3))
    phase = rng.uniform(0, 2 * np.pi, (24, 3))
    base_r = gt.r.copy()
    base_p = gt.p.copy()
    background = np.full((H, W), 4.0, np.float32)
    out = dict(frames=[], joints=[], verts=[], theta0=None,
               background=background)
    for t in range(n_frames):
        gt.update()
        rend = AvatarRenderer(gt, intrin)
        depth = rend.render_depth((H, W))
        mask = rend.render_part_mask((H, W))
        scene = np.where(depth > 0, depth, background)
        out["frames"].append(((scene * 1000).astype(np.uint16), mask))
        out["joints"].append(gt.joint_pos.copy())
        out["verts"].append(gt.cloud.copy())
        if t == 0:
            out["theta0"] = (gt.w.copy(), gt.p.copy(), gt.r.copy())
        wig = amp * np.sin(freq * (t + 1) + phase)
        step = np.asarray(rotation.so3_exp(jnp.asarray(wig, jnp.float32)))
        gt.r = np.einsum("jab,jbc->jac", step, base_r)
        gt.p = base_p + np.array([0.25 * np.sin(0.2 * (t + 1)), 0.0,
                                  0.15 * np.sin(0.13 * (t + 1))])
    return out


def bench_tracker_kwargs(quick: bool = False,
                         part_groups: bool = True) -> dict:
    """TrackerConfig overrides of the benchmark operating point (the
    reference's production settings, live-demo.cpp:60-120, at this
    tracker's tuned LM budget)."""
    from avatar_tpu.perception.partgroups import SMPL24_GROUP_LUT

    return dict(data_interval=4 if quick else 6,
                min_points=200 if quick else 1000,
                # 2 x 4 = 8 LM steps/frame: with the constant-velocity
                # warm start the fit stall-exits near the optimum
                frame_icp_iters=2, reinit_icp_iters=6,
                initial_icp_iters=7, iters_per_icp=4,
                label_conf_thresh=0.55,
                rtree_interval=2 if quick else 3,
                part_groups=tuple(SMPL24_GROUP_LUT) if part_groups else None)


def load_forest(path: str):
    """The tree at ``path`` plus its bagged siblings (``_1``, ``_2``, ...
    beside it): a list of RTrees, or one RTree when it has no siblings."""
    from avatar_tpu.perception.rtree import RTree

    paths = [path]
    k = 1
    while os.path.exists(path.replace(".srtr", f"_{k}.srtr")):
        paths.append(path.replace(".srtr", f"_{k}.srtr"))
        k += 1
    trees = [RTree(p) for p in paths]
    for t in trees:
        t.partmap_type = 0  # contiguous body parts
    return trees if len(trees) > 1 else trees[0]


def converged_fit_rmse_mm(tracker, model: AvatarModel, intrin, frame,
                          mask, theta0, verts0, data_interval: int) -> float:
    """Converged-fit exactness (BASELINE.md "<1 mm fitted-mesh vertex
    RMSE"): fit one frame's oracle-labeled stride samples with fit_refine
    (point-to-MESH ICP, optim/surface.py) from the ground-truth pose, with
    near-zero priors, and return the fitted mesh's vertex RMSE against the
    true mesh in millimeters.  The probe isolates solver + correspondence
    exactness from the motion budget and the tracking regularizers."""
    import jax.numpy as jnp

    from avatar_tpu.core.lbs import lbs
    from avatar_tpu.optim.gauss_newton import Theta, fit_refine
    from avatar_tpu.optim.surface import vertex_face_rings

    w0, p0, r0 = theta0
    theta_gt = Theta(p=jnp.asarray(p0, jnp.float32),
                     rots=jnp.asarray(r0, jnp.float32),
                     w=jnp.asarray(w0, jnp.float32))
    s = data_interval
    d0 = frame[::s, ::s].astype(np.float32) * 1e-3
    m0 = np.asarray(mask)[::s, ::s]
    ys = np.arange(d0.shape[0]) * s
    xs = np.arange(d0.shape[1]) * s
    sub = np.stack([(xs[None, :] - intrin.cx) * d0 / intrin.fx,
                    -(ys[:, None] - intrin.cy) * d0 / intrin.fy, d0], -1)
    fg = (m0 != 255) & (d0 > 0)
    n0 = int(fg.sum())
    bucket = 1024
    while bucket < n0:
        bucket *= 2
    pts = np.zeros((bucket, 3), np.float32)
    pts[:n0] = sub[fg]
    parts = np.full(bucket, -1, np.int32)
    parts[:n0] = m0[fg]
    if tracker._glut is not None:
        # the fit matches in group space; fold the oracle labels to match
        parts[:n0] = np.asarray(tracker._glut)[parts[:n0]]
    ring = jnp.asarray(vertex_face_rings(np.asarray(model.faces),
                                         model.num_points()))
    out = fit_refine(tracker._ctx, model.parents, ring, jnp.asarray(pts),
                     jnp.asarray(parts), theta_gt,
                     jnp.asarray(1e-4, jnp.float32),
                     jnp.asarray(1e-4, jnp.float32), n_steps=20,
                     num_parts=tracker.num_parts)
    verts, _, _, _ = lbs(model.params, model.parents, out[0].w, out[0].p,
                         out[0].rots)
    return float(np.sqrt(np.mean(np.sum(
        (np.asarray(verts) - verts0) ** 2, axis=1))) * 1e3)
