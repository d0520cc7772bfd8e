"""Fused on-device ICP + Levenberg-Marquardt avatar fit.

This module replaces the reference's Ceres BFGS solve (AvatarOptimizer.cpp:
1246-1517: per ICP iteration, build a Ceres problem over ~85 parameters with
analytic Jacobians and run <=10 line-search iterations, ~35 ms on CPU) with a
single jitted program per fit:

  LBS forward -> backface visibility -> tiled NN correspondence ->
  analytic Jacobian assembly -> normal equations as matrix products ->
  damped LM inner loop with exact cost re-evaluation.

Parameterization.  The optimization tangent is
    delta = [ dp (3) | dr_0..dr_{J-1} (3 each, *global-frame* so(3)) | dw (K) ]
with retraction  rot_j <- C_j^T exp(dr_j^) C_j rot_j  where C_j is the global
rotation of j's parent frozen at the linearization point.  This is an
orthonormal reparameterization of the reference's local-frame quaternion
tangent (FakeQuaternionParameterization, AvatarOptimizer.cpp:110-153), chosen
because it collapses the per-point rotation Jacobian to a single
cross-product matrix:

    d resid_p / d dr_j = -skew( a_pj - b_pj * t_j )

(a_pj = weighted posed contribution of joint j's subtree to point p, b_pj the
corresponding weight mass, t_j the posed joint position) instead of the
reference's quaternion pseudo-Jacobian chain (AvatarOptimizer.cpp:546-565);
Gauss-Newton steps are identical under orthonormal tangent changes.

Normal equations via sufficient statistics.  Correspondences (every data
point -> nearest visible same-part model point) are reduced to per-model-
point statistics cnt_p (robust-weight mass) and s_p (weighted data sums), so

    J^T J = sum_p cnt_p J_p^T J_p      (one [P,3,D] x [P,3,D] contraction)
    J^T r = sum_p J_p^T (cnt_p x_p - s_p)

never touch the data axis.  The *cost* used for LM accept/reject is NOT
computed from these statistics: the expansion sum cnt|x|^2 - 2 x.s + q
catastrophically cancels in float32 (magnitudes ~1e3 vs true costs ~1e-4),
so costs gather actual residuals x[corr] - d per data point instead.

Residual terms (reference weights and scaling preserved):
  * point-to-point ICP (AvatarICPCostFunctor, AvatarOptimizer.cpp:609-644),
    optionally robustified by Huber IRLS weights (improvement over the
    reference's unweighted least squares) and mixed with a point-to-plane
    term (plane_weight > 0) that converges much faster under large motion;
  * GMM pose prior on non-root joints, scaled by
    betaPose * sqrt(n_matched) / 15 (AvatarOptimizer.cpp:1453-1458,647-696),
    with the exact d(axis-angle)/d(tangent) = J_l^{-1}(theta) C^T chain where
    the reference approximates identity;
  * L2 shape prior scaled by betaShape * sqrt(n_matched) / 15
    (AvatarOptimizer.cpp:700-726).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from avatar_tpu.core import rotation
from avatar_tpu.core.lbs import LBSParams, fk, shape_fwd
from avatar_tpu.optim import correspond

_HI = jax.lax.Precision.HIGHEST


class PriorData(NamedTuple):
    """GMM pose prior tensors (from GaussianMixture)."""
    means: jnp.ndarray       # [C, D69]
    prec_cho: jnp.ndarray    # [C, D69, D69] lower
    consts_log: jnp.ndarray  # [C]


class FitContext(NamedTuple):
    """Per-model tensors consumed by the fit program (a frozen pytree)."""
    lbs: LBSParams
    anc_mask: jnp.ndarray    # [J, J] anc[j, k] = 1 iff j ancestor-or-self of k
    faces: jnp.ndarray       # [F, 3] int32
    model_part: jnp.ndarray  # [P] int32 body part per model vertex
    prior: PriorData
    # optional NN-candidate mask [P] (None = all vertices): the static-shape
    # analogue of the reference's nnStep vertex subsampling
    # (AvatarOptimizer.h:30-33)
    cand_mask: jnp.ndarray | None = None
    # optional precomputed rest-pose vertex normals [P, 3]; when set, the
    # fit skips the per-fit face-normal accumulation (lets a vertex-subset
    # context drop faces entirely -- subset vertices don't form a mesh)
    n_rest: jnp.ndarray | None = None


class Theta(NamedTuple):
    p: jnp.ndarray      # [3]
    rots: jnp.ndarray   # [J, 3, 3] local joint rotations
    w: jnp.ndarray      # [K]


def extrapolate(theta: Theta, theta_prev: Theta, gamma,
                max_ang: float = 0.25, max_dp: float = 0.10) -> Theta:
    """Constant-velocity pose prediction: advance ``theta`` by ``gamma``
    times its one-frame velocity (finite difference vs ``theta_prev``).

    Used as the fit's warm start: the LM loop terminates on a stall
    (function tolerance + stable correspondences), so starting closer to
    the optimum directly removes accepted re-linearization steps -- the
    dominant per-frame device cost.  The reference starts every optimize()
    from the raw previous pose (AvatarOptimizer.cpp:1246-1263); on fast
    motion that start is a full frame of motion away from the optimum.

    Rotation velocity is the per-joint relative rotation
    ``R_t R_{t-1}^T`` taken to the ``gamma`` power through the so(3)
    log/exp maps; translation is linear.  Both are clamped (``max_ang``
    rad/joint, ``max_dp`` meters) so a jittery estimate cannot launch the
    warm start past the data basin -- extrapolation must never be able to
    *cause* a tracking loss, only shrink solve time.  ``gamma`` is a
    traced scalar: 0 reproduces ``theta`` exactly (toggling does not
    recompile)."""
    dt = theta.p.dtype
    g = jnp.asarray(gamma, dt)
    dp = (theta.p - theta_prev.p) * g
    dpn = jnp.linalg.norm(dp)
    dp = dp * jnp.minimum(1.0, max_dp / jnp.maximum(dpn, 1e-9))
    aa = rotation.so3_log(jnp.einsum(
        "jab,jcb->jac", theta.rots, theta_prev.rots,
        precision=_HI)) * g                                       # [J,3]
    ang = jnp.linalg.norm(aa, axis=-1, keepdims=True)
    aa = aa * jnp.minimum(1.0, max_ang / jnp.maximum(ang, 1e-9))
    rots = jnp.einsum("jab,jbc->jac", rotation.so3_exp(aa), theta.rots,
                      precision=_HI)
    return Theta(p=theta.p + dp, rots=rots, w=theta.w)


class FitDiag(NamedTuple):
    cost: jnp.ndarray        # final cost
    n_matched: jnp.ndarray   # matches in last ICP iteration
    inner_iters: jnp.ndarray  # LM steps accepted (last ICP iteration)
    # matched data points per body part in the final correspondence set
    # (the reference prints these from findNN, AvatarOptimizer.cpp:946-949;
    # starved parts are the first thing to check when tracking drifts)
    part_counts: jnp.ndarray  # [num_parts] int32


def _forward(ctx: FitContext, parents, theta: Theta, use_jsr: bool):
    """LBS forward with all intermediates the Jacobians need."""
    shaped, j_init = shape_fwd(ctx.lbs, theta.w, use_jsr)
    Rg, tg = fk(parents, theta.rots, theta.p, j_init)
    J = len(parents)
    A = jnp.einsum("pj,jk->pk", ctx.lbs.weights, Rg.reshape(J, 9),
                   precision=_HI).reshape(-1, 3, 3)
    t_eff = tg - jnp.einsum("jab,jb->ja", Rg, j_init, precision=_HI)
    b = jnp.einsum("pj,jc->pc", ctx.lbs.weights, t_eff, precision=_HI)
    x = jnp.einsum("pab,pb->pa", A, shaped, precision=_HI) + b
    return x, shaped, j_init, Rg, tg, A


def _vertex_normals(x: jnp.ndarray, faces: jnp.ndarray) -> jnp.ndarray:
    fn = jnp.cross(x[faces[:, 1]] - x[faces[:, 0]],
                   x[faces[:, 2]] - x[faces[:, 0]])
    vn = jnp.zeros_like(x)
    for k in range(3):
        vn = vn.at[faces[:, k]].add(fn)
    return vn / jnp.linalg.norm(vn, axis=-1, keepdims=True).clip(1e-12)


def _icp_jacobian(ctx: FitContext, parents, theta: Theta, fwd,
                  with_shape: bool = True):
    """Analytic d(posed point)/d(delta) for every model point: [P, 3, D].

    ``with_shape=False`` drops the shape-key columns (D = 3 + 3J): the
    steady-state tracking fit freezes shape outside reinit frames — the
    [P,3,K] shape-Jacobian einsums are ~12% of the fit step and shape keys
    barely move frame to frame once fit.
    """
    x, shaped, j_init, Rg, tg, A = fwd
    W = ctx.lbs.weights
    P = W.shape[0]
    J = len(parents)
    K = ctx.lbs.shapedirs.shape[2]
    dtype = x.dtype

    # --- rotation blocks: -skew(a_pj - b_pj t_j) ---------------------------
    Rs = jnp.einsum("kab,pb->pka", Rg, shaped, precision=_HI)     # [P,J,3]
    t_eff = tg - jnp.einsum("jab,jb->ja", Rg, j_init, precision=_HI)
    c = W[:, :, None] * (Rs + t_eff[None, :, :])                  # [P,J,3]
    a = jnp.einsum("jk,pkc->pjc", ctx.anc_mask, c, precision=_HI)  # [P,J,3]
    b = jnp.einsum("pk,jk->pj", W, ctx.anc_mask, precision=_HI)    # [P,J]
    g = a - b[:, :, None] * tg[None, :, :]                        # [P,J,3]
    # -skew(g) assembled directly in [P, 3(resid), J, 3(tangent)] order:
    # a moveaxis of the [P,J,3,3] skew stack is a 7 MB physical transpose
    # per step; stacking rows on axis 1 keeps the layout
    gx, gy, gz = g[..., 0], g[..., 1], g[..., 2]
    zz = jnp.zeros_like(gx)
    r0 = jnp.stack([zz, gz, -gy], axis=-1)                        # [P,J,3]
    r1 = jnp.stack([-gz, zz, gx], axis=-1)
    r2 = jnp.stack([gy, -gx, zz], axis=-1)
    Jrot = jnp.stack([r0, r1, r2], axis=1).reshape(P, 3, 3 * J)

    Jpos = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (P, 3, 3))
    if not with_shape:
        return jnp.concatenate([Jpos, Jrot], axis=2)              # [P,3,3+3J]

    # --- shape block: A_p D_p - W (Rg_k S_k - H_k) -------------------------
    S = ctx.lbs.joint_shape_reg                                   # [J,3,K]
    Sp = [jnp.zeros((3, K), dtype)]
    for j in range(1, J):
        Sp.append(S[j] - S[parents[j]])
    H = [jnp.zeros((3, K), dtype)] * J
    for j in range(1, J):
        H[j] = jnp.matmul(Rg[parents[j]], Sp[j], precision=_HI) + H[parents[j]]
    H = jnp.stack(H)                                              # [J,3,K]
    M = jnp.einsum("jab,jbk->jak", Rg, S, precision=_HI) - H      # [J,3,K]
    Jshape = jnp.einsum("pab,pbk->pak", A, ctx.lbs.shapedirs,
                        precision=_HI) - jnp.einsum(
        "pj,jak->pak", W, M, precision=_HI)                       # [P,3,K]
    return jnp.concatenate([Jpos, Jrot, Jshape], axis=2)          # [P,3,D]


def _prior_terms(ctx: FitContext, parents, theta: Theta, Rg, beta_pose,
                 beta_shape):
    """Pose + shape prior J^T J, J^T r contributions (D x D, D)."""
    J = len(parents)
    K = theta.w.shape[0]
    dtype = theta.w.dtype
    aa = rotation.so3_log(theta.rots[1:])                         # [J-1,3]
    flat = aa.reshape(-1)
    diff = flat[None, :] - ctx.prior.means                        # [C, 69]
    wh = jnp.einsum("cdk,cd->ck", ctx.prior.prec_cho, diff,
                    precision=_HI) * jnp.sqrt(jnp.asarray(0.5, dtype))
    energies = jnp.sum(wh * wh, axis=-1) - ctx.prior.consts_log
    comp = jnp.argmin(energies)
    r_head = wh[comp] * beta_pose                                 # [69]
    L = ctx.prior.prec_cho[comp]                                  # [69, 69]

    # d(aa_i)/d(dr_i) = J_l^{-1}(aa_i) C_i^T,  C_i = Rg[parent(i)]
    Jl = rotation.so3_left_jacobian_inv(aa)                       # [J-1,3,3]
    C = Rg[jnp.asarray([parents[i] for i in range(1, J)])]        # [J-1,3,3]
    chain = jnp.einsum("iab,icb->iac", Jl, C, precision=_HI)      # Jl @ C^T
    Lt_blocks = jnp.transpose(
        L.reshape(J - 1, 3, 3 * (J - 1)), (0, 2, 1))              # [J-1,69,3]
    Jblocks = jnp.einsum("iqa,iab->iqb", Lt_blocks, chain,
                         precision=_HI) * (
        jnp.sqrt(jnp.asarray(0.5, dtype)) * beta_pose)            # [J-1,69,3]

    D = 3 + 3 * J + K
    JtJ = jnp.zeros((D, D), dtype)
    Jtr = jnp.zeros((D,), dtype)
    G = jnp.einsum("iqb,jqc->ibjc", Jblocks, Jblocks,
                   precision=_HI).reshape(3 * (J - 1), 3 * (J - 1))
    JtJ = JtJ.at[6:3 + 3 * J, 6:3 + 3 * J].add(G)
    gr = jnp.einsum("iqb,q->ib", Jblocks, r_head,
                    precision=_HI).reshape(-1)
    Jtr = Jtr.at[6:3 + 3 * J].add(gr)

    # shape prior: resid = beta_shape * w
    JtJ = JtJ.at[3 + 3 * J:, 3 + 3 * J:].add(
        jnp.eye(K, dtype=dtype) * beta_shape ** 2)
    Jtr = Jtr.at[3 + 3 * J:].add(beta_shape ** 2 * theta.w)
    return JtJ, Jtr


def _prior_cost(ctx: FitContext, theta: Theta, beta_pose, beta_shape):
    aa = rotation.so3_log(theta.rots[1:]).reshape(-1)
    diff = aa[None, :] - ctx.prior.means
    wh = jnp.einsum("cdk,cd->ck", ctx.prior.prec_cho, diff,
                    precision=_HI) * jnp.sqrt(jnp.asarray(0.5, aa.dtype))
    energies = jnp.sum(wh * wh, axis=-1) - ctx.prior.consts_log
    comp = jnp.argmin(energies)
    c = jnp.sum(wh[comp] ** 2) - ctx.prior.consts_log[comp]
    return 0.5 * (beta_pose ** 2 * c + beta_shape ** 2 * jnp.sum(theta.w ** 2))


def _retract(theta: Theta, delta: jnp.ndarray, Rg, parents) -> Theta:
    """theta (+) delta with parent frames C frozen at the linearization."""
    J = len(parents)
    dp = delta[:3]
    dr = delta[3:3 + 3 * J].reshape(J, 3)
    dw = delta[3 + 3 * J:]
    E = rotation.so3_exp(dr)                                      # [J,3,3]
    parent_idx = [parents[j] if parents[j] >= 0 else 0 for j in range(J)]
    C = Rg[jnp.asarray(parent_idx)]
    C = C.at[0].set(jnp.eye(3, dtype=theta.rots.dtype))           # root: C = I
    new_rots = jnp.einsum("jba,jbc,jcd,jde->jae", C, E, C, theta.rots,
                          precision=_HI)                          # C^T E C R
    return Theta(p=theta.p + dp, rots=new_rots, w=theta.w + dw)


@functools.partial(
    jax.jit,
    static_argnames=("parents", "use_jsr", "n_steps", "enable_occlusion",
                     "chunk", "robust", "num_parts", "robust_per_part",
                     "freeze_shape", "model_sorted"))
def fit(ctx: FitContext, parents: Tuple[int, ...], data_pts: jnp.ndarray,
        data_part: jnp.ndarray, theta0: Theta, beta_pose: jnp.ndarray,
        beta_shape: jnp.ndarray, n_steps: int,
        use_jsr: bool = True, enable_occlusion: bool = True,
        chunk: int = 512, robust: bool = True,
        plane_weight: jnp.ndarray | float = 0.0,
        point_weight: jnp.ndarray | float = 1.0,
        function_tolerance: float = 1e-4,
        num_parts: int = 0,
        huber_k: jnp.ndarray | float = 1.5,
        robust_per_part: bool = False,
        beta_temp: jnp.ndarray | float = 0.0,
        clamp_angle: jnp.ndarray | float = 0.0,
        clamp_support: jnp.ndarray | float = 10.0,
        freeze_shape: bool = False,
        model_sorted: bool = False,
        wild_gate: jnp.ndarray | float = 0.15,
        wild_weight: jnp.ndarray | float = 1.0) -> Tuple[Theta, FitDiag]:
    """Full avatar fit (the reference's AvatarOptimizer::optimize) as one
    jitted program.

    Scheduling: the reference amortized its expensive kd-tree rebuilds over
    <=10 Ceres iterations per ICP round.  Here the correspondence search
    is a brute-force device kernel with no tree to rebuild, so every LM
    step re-matches —
    this converges strictly better per unit work than solving stale
    correspondence sets tightly (over-solving wrong matches drags the pose
    into their local minimum).  ``n_steps`` therefore plays the role of the
    reference's icp_iters x maxItersPerICP budget.  A relative
    function-tolerance of 1e-4 stops early (reference
    AvatarOptimizer.cpp:1333) when two consecutive accepted re-matched steps
    are both tiny.

    data_pts [N,3] / data_part [N] are padded; padding marked by
    data_part < 0.  Points labeled ``num_parts`` are WILDCARDS: they match
    the nearest visible model vertex of ANY part, gated at ``wild_gate``
    meters and weighted by ``wild_weight`` — the label-free support channel
    for foreground whose forest labels were confidence-gated away (hands
    and feet; see TrackerConfig.wild_n).
    """
    dtype = data_pts.dtype
    P = ctx.lbs.weights.shape[0]
    w_pt = jnp.asarray(point_weight, dtype)
    w_pl = jnp.asarray(plane_weight, dtype)
    w_tmp = jnp.asarray(beta_temp, dtype)

    # renormalize the incoming rotations (the reference's quaternion
    # round-trip does this implicitly each optimize() call,
    # AvatarOptimizer.cpp:1249-1254); prevents orthogonality drift across
    # long tracked sequences
    theta0 = Theta(
        p=theta0.p,
        rots=rotation.quat_to_mat(rotation.mat_to_quat(theta0.rots)),
        w=theta0.w)

    # Rest-pose surface normals, computed ONCE per fit.  Per LM step they
    # are rotated by the per-point blended rotation A_p (already produced by
    # the forward pass) instead of re-accumulating face normals: the three
    # scatter-adds of _vertex_normals and the scatter-max of
    # backface_visibility are far costlier per step than one rotation.
    # Visibility becomes a normal test (vn_z below a small margin == faces
    # the camera), matching the reference's front-face-incidence rule
    # (AvatarOptimizer.cpp:1349-1387: front iff ((p2-p1)x(p1-p3)).z > 1e-4,
    # i.e. accumulated CCW normal z < 0) up to silhouette-grazing vertices,
    # which the margin keeps inclusive.
    if ctx.n_rest is not None:
        n_rest = ctx.n_rest
    else:
        shaped0, _ = shape_fwd(ctx.lbs, theta0.w, use_jsr)
        n_rest = _vertex_normals(shaped0, ctx.faces)
    occ_margin = jnp.asarray(0.2, dtype)

    # temporal-prior constants (frame-start rotations + tangent-dim mask)
    rots0 = theta0.rots
    J_all = len(parents)
    K_all = ctx.lbs.shapedirs.shape[2]
    D_all = 3 + 3 * J_all + K_all
    # freeze_shape: solve in the reduced tangent [dp | dr] (D = 3 + 3J) and
    # keep w fixed -- the steady-state tracker's shape is already fit, and
    # the [P,3,K] shape-Jacobian einsums + wider gram are ~12% of the step
    D_fit = 3 + 3 * J_all if freeze_shape else D_all
    rot_dims = jnp.zeros(D_fit, dtype).at[3:3 + 3 * J_all].set(1.0)
    parent_arr = jnp.asarray(
        [parents[j] if parents[j] >= 0 else 0 for j in range(J_all)])

    # Part-sorted NN plan (loop-invariant): both clouds sorted by part label
    # so each data tile of the Pallas kernel scans only the model chunks
    # covering its own parts.  Data labels never change within a fit, so
    # one argsort amortizes over every step.
    use_plan = correspond.nn_route() == "triton"
    if use_plan:
        plan = correspond.make_nn_plan(
            data_pts, data_part, ctx.model_part,
            num_parts=num_parts or len(parents), model_sorted=model_sorted)
        data_pts = plan.dpts
        data_part = plan.dpart

    # Per-part one-hot matrix (loop-invariant): the per-part robust scale
    # needs sums of |r| and counts grouped by data label every step: a
    # [N, NP]^T x [N, 2] matrix product instead of a scatter-add (no
    # colliding atomic updates).  Invalid/padding rows are all-zero.
    # (Built after the plan so rows align with the sorted data order.)
    NP_w = num_parts or len(parents)   # wildcard label id
    w_wild = jnp.asarray(wild_weight, dtype)
    wild_gate2 = jnp.asarray(wild_gate, dtype) ** 2
    if robust and robust_per_part:
        NP_r = num_parts or len(parents)
        # one extra column: wildcards get their own robust-scale bucket
        # instead of polluting the last real part's
        part_oh = (jax.nn.one_hot(jnp.clip(data_part, 0, NP_r), NP_r + 1,
                                  dtype=dtype)
                   * (data_part >= 0).astype(dtype)[:, None])   # [N, NP+1]

    def cost_at(th, xf, cidx, wgt, vn, bp, bs, bt):
        rr = xf[cidx] - data_pts
        c_pt = 0.5 * jnp.sum(wgt * jnp.sum(rr * rr, -1))
        c_pl = 0.5 * jnp.sum(wgt * jnp.sum(vn[cidx] * rr, -1) ** 2)
        aa_t = rotation.so3_log(jnp.einsum(
            "jab,jcb->jac", th.rots, rots0, precision=_HI))
        c_t = 0.5 * bt ** 2 * jnp.sum(aa_t * aa_t)
        return (w_pt ** 2 * c_pt + w_pl ** 2 * c_pl + c_t +
                _prior_cost(ctx, th, bp, bs))

    def linearize(theta, fwd, corr_prev):
        """Everything that depends only on the current iterate: NN
        correspondence, robust weights, sufficient statistics, Jacobian,
        gram/gradient, and the cost at theta.  On an LM-REJECTED step the
        iterate is unchanged — only the damping lambda moves — so the
        while-loop below reuses the carried result instead of recomputing
        (the reference pays the same rebuild every Ceres inner iteration;
        Ceres itself reuses the residual/jacobian evaluation on rejected
        trust-region steps, which this mirrors)."""
        x, shaped, j_init, Rg, tg, A = fwd
        vn = jnp.einsum("pab,pb->pa", A, n_rest, precision=_HI)
        vn = vn / jnp.linalg.norm(vn, axis=-1, keepdims=True).clip(1e-12)
        if enable_occlusion:
            vis = vn[:, 2] < occ_margin
        else:
            vis = jnp.ones(P, jnp.bool_)
        if ctx.cand_mask is not None:
            vis = vis & ctx.cand_mask
        if use_plan:
            st = correspond.find_nn_stats_planned(
                plan, x, vis, wild=NP_w, wild_gate2=wild_gate2)
        else:
            st = correspond.find_nn_stats(
                data_pts, data_part, x, ctx.model_part, vis, chunk=chunk,
                wild=NP_w, wild_gate2=wild_gate2)
        valid = st.corr >= 0
        cidx = jnp.maximum(st.corr, 0)

        # robust (Huber) IRLS weights from current NN distances
        if robust:
            r0 = x[cidx] - data_pts
            dist = jnp.sqrt(jnp.sum(r0 * r0, -1) + 1e-12)
            if robust_per_part:
                # Per-part scale: a single global median downweights
                # exactly the fast-moving extremities (their residuals sit
                # in the global tail even when they are the part's norm),
                # so hands/feet lag the data.  Group the scale by body part
                # via the precomputed one-hot matmul (not a scatter).
                vw = valid.astype(dtype)
                acc = jax.lax.dot_general(
                    part_oh, jnp.stack([dist * vw, vw], axis=1),
                    (((0,), (0,)), ((), ())), precision=_HI)      # [NP, 2]
                mean_p = acc[:, 0] / jnp.maximum(acc[:, 1], 1.0)
                delta_h = jnp.maximum(
                    huber_k * jnp.einsum("np,p->n", part_oh, mean_p,
                                         precision=_HI), 1e-3)
            else:
                big = jnp.where(valid, dist, jnp.nan)
                med = jnp.nan_to_num(jnp.nanmedian(big), nan=0.01)
                delta_h = jnp.maximum(huber_k * med, 1e-3)
            wgt = jnp.where(valid, jnp.minimum(1.0, delta_h / dist), 0.0)
        else:
            wgt = valid.astype(dtype)
        # label-free wildcard matches carry reduced weight: they are
        # support, not evidence of part identity
        wgt = wgt * jnp.where(data_part == NP_w, w_wild, 1.0)

        # weighted sufficient statistics (one fused scatter for cnt and s)
        idx = jnp.where(valid, cidx, P)
        cs = jnp.zeros((P + 1, 4), dtype).at[idx].add(
            jnp.concatenate([wgt[:, None], data_pts * wgt[:, None]],
                            axis=1))[:-1]
        cnt = cs[:, 0]
        s = cs[:, 1:]

        n_matched = jnp.sum(valid.astype(dtype))
        scale = jnp.sqrt(jnp.maximum(n_matched, 1.0)) / 15.0
        bp = beta_pose * scale
        bs = beta_shape * scale
        bt = w_tmp * scale

        cost = cost_at(theta, x, cidx, wgt, vn, bp, bs, bt)
        Jm = _icp_jacobian(ctx, parents, theta, fwd,
                           with_shape=not freeze_shape)           # [P,3,D]
        rhs = cnt[:, None] * x - s                                # [P,3]
        # weighted gram: contract (P, resid) of [P,3,D] x [P,3,D] in one
        # dot_general — an explicit reshape + .T materializes two 7 MB
        # layout copies per step (the 'p,pci,pcj->ij' einsum form is worse
        # still, ~10x)
        Jw = Jm * jnp.sqrt(jnp.maximum(cnt, 0.0))[:, None, None]
        JtJ = w_pt ** 2 * jax.lax.dot_general(
            Jw, Jw, (((0, 1), (0, 1)), ((), ())), precision=_HI)
        Jtr = w_pt ** 2 * jax.lax.dot_general(
            Jm, rhs, (((0, 1), (0, 1)), ((), ())), precision=_HI)
        Jpl = jnp.einsum("pc,pci->pi", vn, Jm, precision=_HI)     # [P,D]
        Jplw = Jpl * jnp.sqrt(jnp.maximum(cnt, 0.0))[:, None]
        JtJ = JtJ + w_pl ** 2 * jax.lax.dot_general(
            Jplw, Jplw, (((0,), (0,)), ((), ())), precision=_HI)
        Jtr = Jtr + w_pl ** 2 * jax.lax.dot_general(
            Jpl, jnp.sum(vn * rhs, -1), (((0,), (0,)), ((), ())),
            precision=_HI)
        pJtJ, pJtr = _prior_terms(ctx, parents, theta, Rg, bp, bs)
        # the shape prior occupies exactly the trailing K x K block, so the
        # frozen-shape slice removes it and nothing else
        JtJ = JtJ + pJtJ[:D_fit, :D_fit]
        Jtr = Jtr + pJtr[:D_fit]
        # temporal pose prior: residual log(R_j R_j0^T) per joint, Jacobian
        # C_j^T wrt the global-frame tangent (block-diagonal) -- damps
        # joints the data does not constrain toward the frame-start pose
        # instead of letting them free-wheel under the GMM prior alone
        aa_t = rotation.so3_log(jnp.einsum(
            "jab,jcb->jac", theta.rots, rots0, precision=_HI))   # [J,3]
        J_ = len(parents)
        JtJ = JtJ + bt ** 2 * jnp.diag(rot_dims)
        Cmat = Rg[parent_arr].at[0].set(jnp.eye(3, dtype=dtype))
        Jtr = Jtr.at[3:3 + 3 * J_].add(
            bt ** 2 * jnp.einsum("jab,jb->ja", Cmat, aa_t,
                                 precision=_HI).reshape(-1))
        # correspondence stability vs the previous linearization point —
        # part of the convergence test (see step below)
        corr_stable = jnp.all(st.corr == corr_prev)
        return (JtJ, Jtr, cost, n_matched, st.corr, cidx, wgt, vn,
                jnp.stack([bp, bs, bt]), corr_stable)

    def step(state):
        theta, fwd, lam, it, accepted, small_cnt, need_lin, _, lin = state
        # Re-linearize only when the iterate moved (last trial accepted, or
        # first iteration).  On a rejected LM step theta is unchanged — NN
        # matching, robust weights, Jacobian, grams and priors are all pure
        # functions of theta, so the carried bundle is bitwise what a
        # recompute would produce; correspondences are trivially stable.
        lin = jax.lax.cond(
            need_lin,
            lambda: linearize(theta, fwd, lin[4]),
            lambda: lin[:9] + (jnp.asarray(True),))
        (JtJ, Jtr, cost, n_matched, corr, cidx, wgt, vn, b3,
         corr_stable) = lin
        bp, bs, bt = b3[0], b3[1], b3[2]
        x, shaped, j_init, Rg, tg, A = fwd
        # Marquardt damping with a diagonal floor: dimensions the data does
        # not constrain (e.g. shape keys of occluded parts) have ~zero
        # curvature AND ~zero gradient; pure diag-scaling leaves them
        # undamped and the solve free-wheels arbitrarily large steps there.
        d = jnp.diagonal(JtJ)
        d = jnp.maximum(d, 1e-3 * jnp.max(d))
        M = JtJ + lam * jnp.diag(d) + 1e-8 * jnp.eye(
            JtJ.shape[0], dtype=dtype)
        cho = jax.scipy.linalg.cho_factor(M)
        delta = -jax.scipy.linalg.cho_solve(cho, Jtr)
        if freeze_shape:
            delta = jnp.concatenate([delta, jnp.zeros(K_all, dtype)])
        trial = _retract(theta, delta, Rg, parents)
        trial_fwd = _forward(ctx, parents, trial, use_jsr)
        trial_cost = cost_at(trial, trial_fwd[0], cidx, wgt, vn, bp, bs, bt)

        accept = trial_cost < cost
        th_new = jax.tree.map(
            lambda a_, b_: jnp.where(accept, a_, b_), trial, theta)
        # carry the accepted iterate's forward pass into the next step (the
        # old loop re-ran _forward at the top of every step)
        fwd_new = jax.tree.map(
            lambda a_, b_: jnp.where(accept, a_, b_), trial_fwd, fwd)
        lam_new = jnp.where(accept, jnp.maximum(lam * 0.33, 1e-7),
                            jnp.minimum(lam * 6.0, 1e6))
        rel = jnp.abs(cost - trial_cost) / jnp.maximum(cost, 1e-12)
        # converged only when the cost stagnates AND the correspondence
        # assignment is stable — cost stagnation alone also occurs at stale
        # local optima that the next re-matching step would escape.  Stalls
        # count whether the trial was accepted or rejected: at the optimum
        # LM rejects every trial (cost is already minimal), which must
        # terminate like Ceres' function_tolerance, not spin the full budget
        small = (rel < function_tolerance) & corr_stable
        small_cnt_new = jnp.where(small, small_cnt + 1, 0)
        return (th_new, fwd_new, lam_new, it + 1,
                accepted + accept.astype(jnp.int32), small_cnt_new,
                accept, jnp.where(accept, trial_cost, cost), lin)

    def cond(state):
        it = state[3]
        small_cnt = state[5]
        return (it < n_steps) & (small_cnt < 2)

    fwd0 = _forward(ctx, parents, theta0, use_jsr)
    N_d = data_pts.shape[0]
    lin0 = (jnp.zeros((D_fit, D_fit), dtype), jnp.zeros(D_fit, dtype),
            jnp.asarray(jnp.inf, dtype), jnp.asarray(0.0, dtype),
            jnp.full(N_d, -2, jnp.int32), jnp.zeros(N_d, jnp.int32),
            jnp.zeros(N_d, dtype), jnp.zeros((P, 3), dtype),
            jnp.zeros(3, dtype), jnp.asarray(False))
    init = (theta0, fwd0, jnp.asarray(1e-2, dtype),
            jnp.asarray(0, jnp.int32),
            jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
            jnp.asarray(True), jnp.asarray(jnp.inf, dtype), lin0)
    (theta, _, lam, it, accepted, _, _, cost,
     lin_f) = jax.lax.while_loop(cond, step, init)
    n_matched = lin_f[3]
    corr_final = lin_f[4]
    NP = num_parts or len(parents)
    matched_f = corr_final >= 0
    # wildcard matches (label == NP) are excluded: the starvation
    # diagnostics must keep seeing which LABELED groups found support
    pidx = jnp.where(matched_f & (data_part < NP),
                     jnp.clip(data_part, 0, NP - 1), NP)
    part_counts = jnp.zeros(NP + 1, jnp.int32).at[pidx].add(1)[:NP]

    # Per-joint motion clamp: joints whose subtree matched almost no data
    # points must not rotate more than clamp_angle from the frame-start
    # pose in one fit -- a handful of mislabels plus the pose prior can
    # otherwise swing a whole unobserved limb in a single frame.  Observed
    # joints are untouched.
    w_clamp = jnp.asarray(clamp_angle, dtype)
    if True:  # cheap; w_clamp == 0 degenerates to identity below
        cidx_f = jnp.maximum(corr_final, 0)
        vcnt = jnp.zeros(P + 1, dtype).at[
            jnp.where(matched_f, cidx_f, P)].add(1.0)[:-1]        # [P]
        subtree_w = jnp.einsum("pk,jk->pj", ctx.lbs.weights, ctx.anc_mask,
                               precision=_HI)                    # [P,J]
        support = jnp.einsum("p,pj->j", vcnt, subtree_w,
                             precision=_HI)                      # [J]
        aa_rel = rotation.so3_log(jnp.einsum(
            "jab,jcb->jac", theta.rots, theta0.rots, precision=_HI))
        ang = jnp.linalg.norm(aa_rel, axis=-1, keepdims=True)
        lim = jnp.where((support[:, None] < clamp_support) & (w_clamp > 0),
                        jnp.minimum(1.0, w_clamp / jnp.maximum(ang, 1e-9)),
                        1.0)
        rots_c = jnp.einsum("jab,jbc->jac", rotation.so3_exp(aa_rel * lim),
                            theta0.rots, precision=_HI)
        theta = Theta(p=theta.p, rots=rots_c, w=theta.w)
    return theta, FitDiag(cost=cost, n_matched=n_matched,
                          inner_iters=accepted, part_counts=part_counts)


@functools.partial(
    jax.jit,
    static_argnames=("parents", "use_jsr", "n_steps", "enable_occlusion",
                     "chunk", "num_parts", "wild", "freeze_shape"))
def fit_refine(ctx: FitContext, parents: Tuple[int, ...],
               ring_faces: jnp.ndarray, data_pts: jnp.ndarray,
               data_part: jnp.ndarray, theta0: Theta,
               beta_pose: jnp.ndarray, beta_shape: jnp.ndarray,
               n_steps: int = 10, use_jsr: bool = True,
               enable_occlusion: bool = True, chunk: int = 512,
               num_parts: int = 0,
               plane_weight: jnp.ndarray | float = 1.0,
               point_weight: jnp.ndarray | float = 0.2,
               function_tolerance: float = 1e-7,
               huber_k: jnp.ndarray | float = 4.0,
               trim_k: jnp.ndarray | float = 20.0,
               wild: int = -1000,
               wild_gate2=None,
               freeze_shape: bool = False) -> Tuple[Theta, FitDiag]:
    """High-exactness avatar fit: point-to-MESH ICP with per-datum Jacobians.

    The tracking fit (``fit``) matches data to the nearest model vertex and
    reduces matches to per-vertex sufficient statistics — fast, but its
    converged optimum carries a bias floor of a few millimeters set by the
    vertex spacing (data points live on triangle interiors; see
    optim/surface.py).  This solver matches each data point to the closest
    point ON the mesh surface (vertex NN -> one-ring closest triangle,
    barycentric) and builds exact normal equations over per-datum residuals

        r_n = sum_i b_i x_{v_i} - d_n          (point-to-point)
        r_n^pl = n_f . r_n                      (point-to-plane, face normal)

    with Jacobian  J_n = sum_i b_i J_{v_i}  gathered from the analytic
    per-vertex Jacobian.  At the true pose every residual equals sensor
    quantization, so the converged vertex RMSE is sub-millimeter — the
    BASELINE acceptance bar the reference states as "<1 mm vs the CPU
    reference fit" (this repo measures the strictly harder "vs ground
    truth", bench.py).

    Intended for the converged-exactness probe and offline high-quality
    refits; the per-frame tracker keeps the sufficient-statistics ``fit``.
    ``ring_faces`` comes from surface.vertex_face_rings (host precompute).
    """
    from avatar_tpu.optim.surface import surface_correspond

    dtype = data_pts.dtype
    P = ctx.lbs.weights.shape[0]
    N = data_pts.shape[0]
    w_pt = jnp.asarray(point_weight, dtype)
    w_pl = jnp.asarray(plane_weight, dtype)

    theta0 = Theta(
        p=theta0.p,
        rots=rotation.quat_to_mat(rotation.mat_to_quat(theta0.rots)),
        w=theta0.w)
    if ctx.n_rest is not None:
        n_rest = ctx.n_rest
    else:
        shaped0, _ = shape_fwd(ctx.lbs, theta0.w, use_jsr)
        n_rest = _vertex_normals(shaped0, ctx.faces)
    occ_margin = jnp.asarray(0.2, dtype)

    # Part-sorted NN plan, exactly as in ``fit``: the plain XLA search scans
    # every model point for every datum; the planned Pallas kernel scans
    # only same-part chunks.
    use_plan = correspond.nn_route() == "triton"
    if use_plan:
        plan = correspond.make_nn_plan(
            data_pts, data_part, ctx.model_part,
            num_parts=num_parts or len(parents))
        data_pts = plan.dpts
        data_part = plan.dpart
    N = data_pts.shape[0]

    def cost_at(th, xf, tri_idx, bary, fnrm, wgt, bp, bs):
        rr = jnp.sum(bary[..., None] * xf[tri_idx], axis=1) - data_pts
        c_pt = 0.5 * jnp.sum(wgt * jnp.sum(rr * rr, -1))
        c_pl = 0.5 * jnp.sum(wgt * jnp.sum(fnrm * rr, -1) ** 2)
        return (w_pt ** 2 * c_pt + w_pl ** 2 * c_pl +
                _prior_cost(ctx, th, bp, bs))

    def linearize(theta, fwd, corr_prev):
        """Pure function of the current iterate (cf. ``fit.linearize``):
        on an LM-rejected step theta is unchanged, so the carried bundle
        is reused instead of recomputed."""
        x, shaped, j_init, Rg, tg, A = fwd
        vn = jnp.einsum("pab,pb->pa", A, n_rest, precision=_HI)
        vn = vn / jnp.linalg.norm(vn, axis=-1, keepdims=True).clip(1e-12)
        if enable_occlusion:
            vis = vn[:, 2] < occ_margin
            front = occ_margin
        else:
            vis = jnp.ones(P, jnp.bool_)
            front = None
        if ctx.cand_mask is not None:
            vis = vis & ctx.cand_mask
        if use_plan:
            st = correspond.find_nn_stats_planned(
                plan, x, vis, wild=wild, wild_gate2=wild_gate2)
        else:
            st = correspond.find_nn_stats(
                data_pts, data_part, x, ctx.model_part, vis, chunk=chunk,
                wild=wild, wild_gate2=wild_gate2)
        tri_idx, bary, fnrm, valid = surface_correspond(
            data_pts, st.corr, x, ctx.faces, ring_faces,
            front_margin=front)
        # Robust weighting against correspondence outliers.  Even at the
        # true pose a few percent of matches are bad — silhouette-straddling
        # pixels, part-boundary points whose same-part NN vertex's ring
        # misses the true triangle, thin-part wrong-sheet matches — with
        # residuals 10-100x the quantization floor.  An unweighted LS would
        # let this tail bias the optimum by millimeters: Huber-IRLS on the
        # current match distances (delta = huber_k * median) plus a hard
        # trim at trim_k * median removes it.
        r_cur = jnp.sum(bary[..., None] * x[tri_idx], axis=1) - data_pts
        dist = jnp.sqrt(jnp.sum(r_cur * r_cur, -1) + 1e-16)
        # Robust scale WITHOUT a median: a sort of 8k floats per LM step
        # was the single largest refine cost (scripts/profile_refine.py
        # measures it) while every other stage is vector work.  A
        # one-round trimmed mean is sort-free and serves the same role:
        # m0 = mean |r| over matches, then the mean over |r| < 3 m0
        # discards the outlier tail's pull.  For |r| ~ half-normal the
        # trimmed mean sits within ~25% of the median — well inside the
        # slack of huber_k=4 / trim_k=20.
        vw = valid.astype(dtype)
        nv = jnp.maximum(jnp.sum(vw), 1.0)
        m0 = jnp.sum(dist * vw) / nv
        keep = vw * (dist < 3.0 * m0).astype(dtype)
        med = jnp.sum(dist * keep) / jnp.maximum(jnp.sum(keep), 1.0)
        med = jnp.where(med > 0, med, 1e-3)
        delta_h = jnp.maximum(jnp.asarray(huber_k, dtype) * med, 2e-4)
        wgt = jnp.where(valid, jnp.minimum(1.0, delta_h / dist), 0.0)
        wgt = jnp.where(dist > jnp.asarray(trim_k, dtype) * med, 0.0, wgt)
        n_matched = jnp.sum((wgt > 0).astype(dtype))
        scale = jnp.sqrt(jnp.maximum(n_matched, 1.0)) / 15.0
        bp = beta_pose * scale
        bs = beta_shape * scale

        cost = cost_at(theta, x, tri_idx, bary, fnrm, wgt, bp, bs)
        Jm = _icp_jacobian(ctx, parents, theta, fwd)                # [P,3,D]
        r = r_cur                                                   # [N,3]
        rpl = jnp.sum(fnrm * r, -1)                                 # [N]

        # Normal equations WITHOUT the data axis (cf. the main fit's
        # sufficient statistics).  The naive per-datum form materializes
        # J_n = sum_i b_ni Jm[v_ni] as an [N,3,3,D] gather (~25 MB of
        # fine-grained random access per LM step, several times the whole
        # main-fit step).  Instead:
        #   gradient (EXACT):  J^T r = sum_p Jm[p]^T G[p],
        #       G[p] = sum_n w_n b_np (wpt^2 r_n + wpl^2 n_f rpl_n)
        #   gram (mass-lumped): J^T J ~= sum_p Jm[p]^T W_p Jm[p],
        #       W_p = wpt^2 m_p I + wpl^2 sum_n w_n b_np n_f n_f^T
        # The lumping drops intra-face cross terms (i != j) of the exact
        # gram — a classic FEM mass-lumping.  Any positive-definite gram
        # still yields a descent direction, and LM's accept/reject keeps
        # the cost monotone, so the CONVERGED optimum (gradient = 0, which
        # uses the exact G) is unchanged; only the step shape differs.
        # All per-datum work reduces to ONE fused [3N,13] scatter-add.
        nn6 = jnp.stack([fnrm[:, 0] * fnrm[:, 0], fnrm[:, 1] * fnrm[:, 1],
                         fnrm[:, 2] * fnrm[:, 2], fnrm[:, 0] * fnrm[:, 1],
                         fnrm[:, 0] * fnrm[:, 2], fnrm[:, 1] * fnrm[:, 2]],
                        axis=-1)                                    # [N,6]
        payload = jnp.concatenate(
            [jnp.ones_like(wgt)[:, None], r, fnrm * rpl[:, None], nn6],
            axis=-1)                                                # [N,13]
        bw = (bary * wgt[:, None]).reshape(-1)                      # [3N]
        idxf = tri_idx.reshape(-1)                                  # [3N]
        acc = jnp.zeros((P, 13), dtype).at[idxf].add(
            bw[:, None] * jnp.repeat(payload, 3, axis=0),
            mode="drop")                                            # [P,13]
        m_pt = acc[:, 0]
        G = w_pt ** 2 * acc[:, 1:4] + w_pl ** 2 * acc[:, 4:7]       # [P,3]
        a_, b_, c_, d_, e_, f_ = (acc[:, 7], acc[:, 8], acc[:, 9],
                                  acc[:, 10], acc[:, 11], acc[:, 12])
        Npp = jnp.stack([a_, d_, e_, d_, b_, f_, e_, f_, c_],
                        axis=-1).reshape(-1, 3, 3)                  # [P,3,3]
        eye3 = jnp.eye(3, dtype=dtype)
        W_p = (w_pt ** 2 * m_pt[:, None, None] * eye3 +
               w_pl ** 2 * Npp)                                     # [P,3,3]
        JmW = jnp.einsum("pab,pbd->pad", W_p, Jm, precision=_HI)    # [P,3,D]
        JtJ = jax.lax.dot_general(
            Jm, JmW, (((0, 1), (0, 1)), ((), ())), precision=_HI)
        Jtr = jax.lax.dot_general(
            Jm, G, (((0, 1), (0, 1)), ((), ())), precision=_HI)
        pJtJ, pJtr = _prior_terms(ctx, parents, theta, Rg, bp, bs)
        JtJ = JtJ + pJtJ
        Jtr = Jtr + pJtr
        corr_stable = jnp.all(st.corr == corr_prev)
        return (JtJ, Jtr, cost, n_matched, st.corr, tri_idx, bary, fnrm,
                wgt, jnp.stack([bp, bs]), corr_stable)

    def step(state):
        theta, fwd, lam, it, accepted, small_cnt, need_lin, _, lin = state
        lin = jax.lax.cond(
            need_lin,
            lambda: linearize(theta, fwd, lin[4]),
            lambda: lin[:10] + (jnp.asarray(True),))
        (JtJ, Jtr, cost, n_matched, corr, tri_idx, bary, fnrm, wgt, b2,
         corr_stable) = lin
        bp, bs = b2[0], b2[1]
        x, shaped, j_init, Rg, tg, A = fwd

        d = jnp.diagonal(JtJ)
        d = jnp.maximum(d, 1e-3 * jnp.max(d))
        M = JtJ + lam * jnp.diag(d) + 1e-8 * jnp.eye(
            JtJ.shape[0], dtype=dtype)
        if freeze_shape:
            # in-tracker refine: shape keys are fit at (re)init only, like
            # the main fit's reduced tangent — pin the shape block with a
            # dominant diagonal penalty so delta_w ~ 0
            Dd = M.shape[0]
            nk = Dd - (3 + 3 * len(parents))
            if nk > 0:
                fmask = jnp.concatenate(
                    [jnp.zeros(Dd - nk, dtype), jnp.ones(nk, dtype)])
                M = M + jnp.diag(fmask * (1e6 * jnp.max(d)))
        cho = jax.scipy.linalg.cho_factor(M)
        delta = -jax.scipy.linalg.cho_solve(cho, Jtr)
        trial = _retract(theta, delta, Rg, parents)
        trial_fwd = _forward(ctx, parents, trial, use_jsr)
        trial_cost = cost_at(trial, trial_fwd[0], tri_idx, bary, fnrm,
                             wgt, bp, bs)

        accept = trial_cost < cost
        th_new = jax.tree.map(
            lambda a_, b_: jnp.where(accept, a_, b_), trial, theta)
        fwd_new = jax.tree.map(
            lambda a_, b_: jnp.where(accept, a_, b_), trial_fwd, fwd)
        lam_new = jnp.where(accept, jnp.maximum(lam * 0.33, 1e-9),
                            jnp.minimum(lam * 6.0, 1e6))
        rel = jnp.abs(cost - trial_cost) / jnp.maximum(cost, 1e-20)
        small = (rel < function_tolerance) & corr_stable
        small_cnt_new = jnp.where(small, small_cnt + 1, 0)
        return (th_new, fwd_new, lam_new, it + 1,
                accepted + accept.astype(jnp.int32), small_cnt_new,
                accept, jnp.where(accept, trial_cost, cost), lin)

    def cond(state):
        return (state[3] < n_steps) & (state[5] < 2)

    fwd0 = _forward(ctx, parents, theta0, use_jsr)
    J_all = len(parents)
    D_all = 3 + 3 * J_all + ctx.lbs.shapedirs.shape[2]
    lin0 = (jnp.zeros((D_all, D_all), dtype), jnp.zeros(D_all, dtype),
            jnp.asarray(jnp.inf, dtype), jnp.asarray(0.0, dtype),
            jnp.full(N, -2, jnp.int32), jnp.zeros((N, 3), jnp.int32),
            jnp.zeros((N, 3), dtype), jnp.zeros((N, 3), dtype),
            jnp.zeros(N, dtype), jnp.zeros(2, dtype), jnp.asarray(False))
    init = (theta0, fwd0, jnp.asarray(1e-4, dtype),
            jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
            jnp.asarray(0, jnp.int32), jnp.asarray(True),
            jnp.asarray(jnp.inf, dtype), lin0)
    (theta, _, lam, it, accepted, _, _, cost,
     lin_f) = jax.lax.while_loop(cond, step, init)
    n_matched = lin_f[3]
    corr_final = lin_f[4]
    NP = num_parts or len(parents)
    matched_f = corr_final >= 0
    pidx = jnp.where(matched_f, jnp.clip(data_part, 0, NP - 1), NP)
    part_counts = jnp.zeros(NP + 1, jnp.int32).at[pidx].add(1)[:NP]
    return theta, FitDiag(cost=cost, n_matched=n_matched,
                          inner_iters=accepted, part_counts=part_counts)
