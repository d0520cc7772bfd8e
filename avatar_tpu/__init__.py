"""avatar_tpu — a real-time depth-to-avatar fitting framework on the GPU.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of the OpenARK
avatar system (reference: sxyu/avatar, C++/Ceres/OpenCV): fitting a SMPL-family
body model to depth-camera point clouds in real time, plus the full offline
toolchain (synthetic depth-data generation, random-forest body-part
segmentation training, model surgery, dataset recording/playback).

Design principles (built for an accelerator, not a port):
  * All per-frame compute (LBS forward, rasterization, correspondence search,
    Gauss-Newton solve, decision-forest inference, connected components) runs
    as jit-compiled XLA programs with static shapes; hot inner kernels have
    Pallas implementations.
  * The Ceres/BFGS CPU optimizer of the reference is replaced by a fused
    on-device Levenberg-Marquardt ICP iteration with analytic Jacobians.
  * nanoflann kd-trees are replaced by brute-force masked top-1 distance
    search (a part-ranged Pallas kernel on the GPU, plain XLA elsewhere).
  * Multi-chip scaling uses `jax.sharding.Mesh` + `shard_map` (data-parallel
    synthetic rendering and forest training with `psum` count reduction).

Public API mirrors the reference's class names (AvatarModel, Avatar,
AvatarOptimizer, AvatarRenderer, RTree, BGSubtractor, CameraIntrin,
GaussianMixture, AvatarPoseSequence) so users of the reference can switch.
"""

from avatar_tpu.core.model import AvatarModel, Avatar, SmplJoint
from avatar_tpu.core.pose_prior import GaussianMixture
from avatar_tpu.core.sequence import AvatarPoseSequence
from avatar_tpu.io.calibration import CameraIntrin

__version__ = "0.1.0"

__all__ = [
    "AvatarModel",
    "Avatar",
    "SmplJoint",
    "GaussianMixture",
    "AvatarPoseSequence",
    "CameraIntrin",
]


def __getattr__(name):
    # Lazy imports keep `import avatar_tpu` light and avoid pulling the
    # renderer/optimizer stacks for IO-only users.
    if name == "AvatarRenderer":
        from avatar_tpu.render.renderer import AvatarRenderer
        return AvatarRenderer
    if name == "AvatarOptimizer":
        from avatar_tpu.optim.optimizer import AvatarOptimizer
        return AvatarOptimizer
    if name == "RTree":
        from avatar_tpu.perception.rtree import RTree
        return RTree
    if name == "BGSubtractor":
        from avatar_tpu.perception.bgsub import BGSubtractor
        return BGSubtractor
    raise AttributeError(f"module 'avatar_tpu' has no attribute {name!r}")
