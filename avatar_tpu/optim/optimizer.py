"""AvatarOptimizer: public pose/shape fitting API.

Mirrors the reference class (AvatarOptimizer.h:11-61): construct with an
Avatar, camera intrinsics, image size, body-part count and joint->part map;
call ``optimize(data_cloud, data_part_labels, icp_iters)`` to fit the
avatar's (p, r, w) to a labeled point cloud.  ``num_threads`` is accepted
for API parity and ignored (XLA owns intra-op parallelism).

Data clouds are padded to power-of-two buckets so recompilation only happens
when the bucket changes, not every frame.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax.numpy as jnp
import numpy as np

from avatar_tpu.optim.gauss_newton import (FitContext, PriorData, Theta, fit)


def _bucket(n: int, lo: int = 1024) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class AvatarOptimizer:
    def __init__(self, ava, intrin=None, image_size=None, num_parts: int = 0,
                 part_map: Optional[Sequence[int]] = None):
        self.ava = ava
        self.intrin = intrin
        self.image_size = image_size
        model = ava.model
        self.num_parts = num_parts or model.num_joints()

        # tuned defaults (AvatarOptimizer.h:27-39; demos use betaPose=0.05,
        # betaShape=0.12 — demo.cpp:54-57)
        self.beta_pose = 0.1
        self.beta_shape = 1.0
        # Reference nnStep (AvatarOptimizer.h:30-33) subsampled the model
        # vertices entering NN correspondence.  Here it builds the fit's
        # candidate mask (FitContext.cand_mask): 1 keeps every vertex
        # (default; the reference's production invert mode also matches
        # against all visible vertices), k > 1 keeps every k-th vertex.
        self.nn_step = 1
        self.max_iters_per_icp = 10
        self.enable_occlusion = True
        # extras of this rebuild (not in the reference): Huber IRLS robust
        # weighting and an optional point-to-plane residual mix.
        self.robust = True
        self.point_weight = 1.0
        self.plane_weight = 0.0
        self.huber_k = 1.5
        self.robust_per_part = False

        if part_map is None or len(part_map) == 0:
            part_map_arr = np.arange(model.num_joints(), dtype=np.int32)
        else:
            part_map_arr = np.asarray(part_map, np.int32)
        self.part_map = part_map_arr
        # body part of each model vertex = part_map[main assigned joint]
        # (reference AvatarOptimizer.cpp:1307-1311)
        model_part = part_map_arr[model.main_joint]

        if model.pose_prior is None:
            raise ValueError("AvatarOptimizer requires a model pose prior")
        prior = PriorData(
            means=model.pose_prior.means,
            prec_cho=model.pose_prior.prec_cho,
            consts_log=model.pose_prior.consts_log,
        )
        self._ctx = FitContext(
            lbs=model.params,
            anc_mask=jnp.asarray(model.ancestor_mask, model.dtype),
            faces=jnp.asarray(model.faces, jnp.int32),
            model_part=jnp.asarray(model_part, jnp.int32),
            prior=prior,
        )
        self._dtype = model.dtype

    # C++-style attribute aliases
    @property
    def betaPose(self):
        return self.beta_pose

    @betaPose.setter
    def betaPose(self, v):
        self.beta_pose = v

    @property
    def betaShape(self):
        return self.beta_shape

    @betaShape.setter
    def betaShape(self, v):
        self.beta_shape = v

    @property
    def maxItersPerICP(self):
        return self.max_iters_per_icp

    @maxItersPerICP.setter
    def maxItersPerICP(self, v):
        self.max_iters_per_icp = v

    def optimize(self, data_cloud: np.ndarray, data_part_labels: np.ndarray,
                 icp_iters: int = 1, num_threads: int = 0) -> dict:
        """Fit the avatar to a labeled data cloud; updates ``self.ava``
        in place (including a final Avatar.update()).

        data_cloud: [N, 3] (or reference-style [3, N]) points in avatar
          space (x, -y_image, z).
        data_part_labels: [N] int body parts from the RTree.
        """
        data_cloud = np.asarray(data_cloud, np.float64)
        if data_cloud.ndim != 2:
            raise ValueError("data_cloud must be 2D")
        if data_cloud.shape[0] == 3 and data_cloud.shape[1] != 3:
            data_cloud = data_cloud.T
        labels = np.asarray(data_part_labels, np.int32).reshape(-1)
        if labels.shape[0] != data_cloud.shape[0]:
            raise ValueError("labels length must match point count")

        N = data_cloud.shape[0]
        B = _bucket(N)
        pts = np.zeros((B, 3), np.float64)
        pts[:N] = data_cloud
        parts = np.full(B, -1, np.int32)
        parts[:N] = labels

        ctx = self._ctx
        if self.nn_step and self.nn_step > 1:
            n_model = self._ctx.lbs.weights.shape[0]
            mask = (np.arange(n_model) % int(self.nn_step)) == 0
            ctx = ctx._replace(cand_mask=jnp.asarray(mask))

        ava = self.ava
        theta0 = Theta(
            p=jnp.asarray(ava.p, self._dtype),
            rots=jnp.asarray(ava.r, self._dtype),
            w=jnp.asarray(ava.w, self._dtype),
        )
        # The reference's compute budget was icp_iters NN updates x
        # maxItersPerICP solver iterations; our fit re-matches every LM step
        # (no kd-tree to rebuild), so the equivalent step budget is the
        # product.
        n_steps = int(icp_iters) * int(self.max_iters_per_icp)
        theta, diag = fit(
            ctx, ava.model.parents,
            jnp.asarray(pts, self._dtype), jnp.asarray(parts, jnp.int32),
            theta0,
            jnp.asarray(self.beta_pose, self._dtype),
            jnp.asarray(self.beta_shape, self._dtype),
            n_steps=n_steps,
            use_jsr=ava.model.use_joint_shape_regressor,
            enable_occlusion=bool(self.enable_occlusion),
            robust=bool(self.robust),
            plane_weight=float(self.plane_weight),
            point_weight=float(self.point_weight),
            num_parts=int(self.num_parts),
            huber_k=float(self.huber_k),
            robust_per_part=bool(self.robust_per_part),
        )
        ava.p = np.asarray(theta.p, np.float64)
        ava.r = np.asarray(theta.rots, np.float64)
        ava.w = np.asarray(theta.w, np.float64)
        ava.update()
        return dict(cost=float(diag.cost), n_matched=int(diag.n_matched),
                    inner_iters=int(diag.inner_iters),
                    part_counts=np.asarray(diag.part_counts).tolist())
