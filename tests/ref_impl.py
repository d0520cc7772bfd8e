"""Independent numpy float64 reference implementations used as test oracles.

These deliberately follow the *structure* of the reference C++ (3x4 affine
accumulation, per-point 12-dim blended transforms — Avatar.cpp:22-75) rather
than the device formulation, so transcription errors in either would surface.
"""

import numpy as np


def lbs_reference(model, w, p, rots):
    """Reference Avatar::update.  Returns (cloud [P,3], joint_pos [J,3])."""
    P = model.num_points()
    J = model.num_joints()
    shaped = model.v_template + model.shapedirs @ w  # [P,3]
    if model.use_joint_shape_regressor:
        joints = model.joint_shape_reg_base + np.einsum(
            "jck,k->jc", model.joint_shape_reg, w)
    else:
        joints = model.joint_reg_np @ shaped

    # 3x4 affine accumulation (Avatar.cpp:43-57)
    T = np.zeros((J, 3, 4))
    T[0, :, :3] = rots[0]
    T[0, :, 3] = p
    for i in range(1, J):
        par = model.parent[i]
        Ti = np.zeros((3, 4))
        Ti[:, :3] = rots[i]
        Ti[:, 3] = joints[i] - joints[par]
        # mulAffine: T[i] = T[par] * Ti
        T[i, :, :3] = T[par, :, :3] @ Ti[:, :3]
        T[i, :, 3] = T[par, :, :3] @ Ti[:, 3] + T[par, :, 3]

    # rebase (Avatar.cpp:59-64)
    joint_pos = T[:, :, 3].copy()
    for i in range(J):
        T[i, :, 3] = T[i, :, 3] - T[i, :, :3] @ joints[i]

    # blend point transforms (Avatar.cpp:66-73)
    Tflat = T.reshape(J, 12)                      # per joint 3x4
    PT = model.weights_np @ Tflat                 # [P, 12]
    PT = PT.reshape(P, 3, 4)
    cloud = np.einsum("pab,pb->pa", PT[:, :, :3], shaped) + PT[:, :, 3]
    return cloud, joint_pos


def gmm_pdf_reference(weights, means, covs, x):
    """Mixture pdf with the reference's minDet normalization
    (GaussianMixture.cpp:12-93)."""
    C, D = means.shape
    chos = np.linalg.cholesky(covs)
    dets = np.array([np.prod(np.diag(chos[i])) for i in range(C)])
    min_det = dets.min()
    log_norm = D * 0.5 * np.log(2 * np.pi)
    total = 0.0
    for i in range(C):
        prec = np.linalg.inv(covs[i])
        L = np.linalg.cholesky(prec)
        r = L.T @ (x - means[i])
        const = weights[i] / np.exp(log_norm) / dets[i] * min_det
        total += const * np.exp(-0.5 * r @ r)
    return total
