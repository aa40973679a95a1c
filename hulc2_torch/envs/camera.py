"""Pinhole camera model: intrinsics and pose of the fake env's cameras.

Role of calvin_env's camera objects (consumed at reference:
hulc2/agents/lmp_agent.py:174-194 ``cameras[0].deproject`` and the label
mining back-projection, hulc2/affordance/dataset_creation/data_labeler.py) and
of the real camera calibration (affordance/dataset_creation/core/
real_cameras.py). Pure NumPy, host-side.

Conventions: intrinsics K (3x3); ``T_world_cam`` (4x4) maps camera-frame
points into world frame; pixels are (u, v) = (col, row); depth is the +z
distance along the camera axis.

The port's copy of the part of ``hulc2_tpu/envs/camera.py`` that the renderers
use; projection and deprojection belong to the hierarchical mode, not ported.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PinholeCamera:
    width: int
    height: int
    K: np.ndarray  # (3, 3)
    T_world_cam: np.ndarray  # (4, 4)
    name: str = "static"

    @classmethod
    def from_params(cls, width, height, fx, fy, cx, cy, T_world_cam=None, name="static"):
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
        T = np.eye(4) if T_world_cam is None else np.asarray(T_world_cam, np.float64)
        return cls(width, height, K, T, name)

    @property
    def T_cam_world(self) -> np.ndarray:
        R = self.T_world_cam[:3, :3]
        t = self.T_world_cam[:3, 3]
        inv = np.eye(4)
        inv[:3, :3] = R.T
        inv[:3, 3] = -R.T @ t
        return inv
