"""Mocap pose bank (CMU ``cmu-mocap.dat`` binary + ``.txt`` metadata).

Rebuild of reference AvatarPoseSequence (Avatar.h:223-257,
AvatarPoseSequence.cpp).  A frame is ``frame_size`` float64s: 3 root-position
values then one quaternion per joint in Eigen coeffs order (x, y, z, w).

The whole bank memory-maps as one [F, frame_size] array; ``pose_avatar``
writes a frame into an Avatar, and ``frames_as_arrays`` exposes the bank as
(positions [F,3], rotations [F,J,3,3]) for batched on-device sampling during
forest training.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import jax.numpy as jnp
import numpy as np

from avatar_tpu.core import rotation
from avatar_tpu.utils import resolve_root_path


class AvatarPoseSequence:
    def __init__(self, pose_sequence_path: str = ""):
        seq_path = pose_sequence_path or resolve_root_path(
            "data/avatar-mocap/cmu-mocap.dat")
        meta_path = seq_path + ".txt"
        self.sequence_path = seq_path
        self.subsequences: Dict[str, int] = {}
        self.num_frames = 0
        self.frame_size = 0
        self._data: Optional[np.ndarray] = None
        if not (os.path.exists(seq_path) and os.path.exists(meta_path)):
            return
        with open(meta_path, "r") as f:
            toks = f.read().split()
        n_subseq, self.num_frames, frame_size_bytes = (
            int(toks[0]), int(toks[1]), int(toks[2]))
        pos = 3
        for _ in range(n_subseq):
            start = int(toks[pos])
            name = toks[pos + 1]
            pos += 2
            self.subsequences[name] = start // frame_size_bytes
        self.frame_size = frame_size_bytes // 8

    def preload(self) -> None:
        self._data = np.fromfile(self.sequence_path, dtype="<f8").reshape(
            -1, self.frame_size)[: self.num_frames]

    def get_frame(self, frame_id: int) -> np.ndarray:
        if self._data is not None:
            return self._data[frame_id]
        with open(self.sequence_path, "rb") as f:
            f.seek(frame_id * self.frame_size * 8)
            return np.frombuffer(f.read(self.frame_size * 8), dtype="<f8")

    def pose_avatar(self, ava, frame_id: int) -> None:
        """Set avatar pose from a frame (reference AvatarPoseSequence.cpp:47-64)."""
        frame = self.get_frame(frame_id)
        ava.p = frame[:3].copy()
        n_joints = ava.model.num_joints()
        quats = frame[3:3 + n_joints * 4].reshape(n_joints, 4)  # (x, y, z, w)
        ava.r = np.asarray(rotation.quat_to_mat(jnp.asarray(quats)))

    poseAvatar = pose_avatar

    def frames_as_arrays(self, dtype=jnp.float32):
        """Whole bank as (pos [F,3], rots [F,J,3,3]) jnp arrays for batched
        on-device pose sampling (the device equivalent of per-thread poseAvatar
        calls in the reference trainers)."""
        if self._data is None:
            self.preload()
        pos = jnp.asarray(self._data[:, :3], dtype)
        n_joints = (self.frame_size - 3) // 4
        quats = self._data[:, 3:3 + n_joints * 4].reshape(-1, n_joints, 4)
        rots = rotation.quat_to_mat(jnp.asarray(quats, dtype))
        return pos, rots

    @staticmethod
    def write(path: str, positions: np.ndarray, quats: np.ndarray,
              subsequences: Optional[Dict[str, int]] = None) -> None:
        """Write a pose bank: positions [F,3], quats [F,J,4] (x,y,z,w)."""
        F = positions.shape[0]
        frame_size = 3 + quats.shape[1] * 4
        data = np.concatenate(
            [positions.reshape(F, 3), quats.reshape(F, -1)], axis=1
        ).astype("<f8")
        data.tofile(path)
        subsequences = subsequences or {"all": 0}
        with open(path + ".txt", "w") as f:
            f.write(f"{len(subsequences)} {F} {frame_size * 8}\n")
            for name, start in subsequences.items():
                f.write(f"{start * frame_size * 8} {name}\n")
