"""Pinhole camera model: project / deproject between pixels and world points.

Role of calvin_env's camera objects (consumed at reference:
hulc2/agents/lmp_agent.py:174-194 ``cameras[0].deproject`` and the label
mining back-projection, hulc2/affordance/dataset_creation/data_labeler.py) and
of the real camera calibration (affordance/dataset_creation/core/
real_cameras.py). Pure NumPy, host-side.

Conventions: intrinsics K (3x3); ``T_world_cam`` (4x4) maps camera-frame
points into world frame; pixels are (u, v) = (col, row); depth is the +z
distance along the camera axis.

The port's copy of ``hulc2_tpu/envs/camera.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

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

    @classmethod
    def from_gl_matrices(cls, width, height, projection_matrix, view_matrix, name="static"):
        """Build from OpenGL/pybullet camera matrices (calvin_env cameras
        carry ``projectionMatrix``/``viewMatrix`` as column-major float
        lists). The GL camera (y-up, -z forward) is converted to the CV
        convention used here (y-down, +z forward), which matches pybullet's
        top-to-bottom image row order."""
        P = np.asarray(projection_matrix, np.float64).reshape(4, 4, order="F")
        V = np.asarray(view_matrix, np.float64).reshape(4, 4, order="F")
        fx = P[0, 0] * width / 2.0
        fy = P[1, 1] * height / 2.0
        cx = (1.0 - P[0, 2]) * width / 2.0
        cy = (1.0 + P[1, 2]) * height / 2.0
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
        T_cam_world = np.diag([1.0, -1.0, -1.0, 1.0]) @ V  # GL cam -> CV cam
        return cls(width, height, K, np.linalg.inv(T_cam_world), name)

    def to_params(self) -> Dict:
        """Keyword arguments that rebuild the camera."""
        return {"width": self.width, "height": self.height, "K": self.K,
                "T_world_cam": self.T_world_cam, "name": self.name}

    @property
    def T_cam_world(self) -> np.ndarray:
        R = self.T_world_cam[:3, :3]
        t = self.T_world_cam[:3, 3]
        inv = np.eye(4)
        inv[:3, :3] = R.T
        inv[:3, 3] = -R.T @ t
        return inv

    def project(self, point_world) -> np.ndarray:
        """World point (3,) or homogeneous (4,) -> pixel (u, v)."""
        p = np.asarray(point_world, np.float64)
        if p.shape[-1] == 3:
            p = np.append(p, 1.0)
        pc = self.T_cam_world @ p
        uvw = self.K @ pc[:3]
        return np.array([uvw[0] / uvw[2], uvw[1] / uvw[2]])

    def deproject(self, pixel, depth_map: np.ndarray, homogeneous: bool = False) -> np.ndarray:
        """Pixel (u, v) + depth map (H, W) -> world point (3,). The depth is
        looked up at the integer pixel; the ray uses the exact coordinates."""
        ui = int(np.clip(int(pixel[0]), 0, self.width - 1))
        vi = int(np.clip(int(pixel[1]), 0, self.height - 1))
        return self.deproject_single_depth(pixel, float(depth_map[vi, ui]), homogeneous)

    def deproject_single_depth(self, pixel, depth: float, homogeneous: bool = False) -> np.ndarray:
        u, v = float(pixel[0]), float(pixel[1])
        fx, fy = self.K[0, 0], self.K[1, 1]
        cx, cy = self.K[0, 2], self.K[1, 2]
        pw = self.T_world_cam @ np.array([(u - cx) * depth / fx, (v - cy) * depth / fy, depth, 1.0])
        return pw if homogeneous else pw[:3]
