"""The real robot's action scaling and proprio layout (numpy only).

The part of ``hulc2_tpu/tools/preprocess_real_data.py`` (reference:
hulc2/utils/preprocess_real_data.py:40-170) that the real-robot wrapper
(``envs/panda_wrapper.py``) needs: the largest per-step displacements a
relative action of 1 stands for at 15 Hz, the quaternion to XYZ Euler
conversion, and the 15-d robot_obs layout. The recording-to-npz conversion
and its CLI are not part of the port yet.
"""
from __future__ import annotations

import numpy as np

MAX_REL_POS = 0.02  # meters per 15Hz step
MAX_REL_ORN = 0.05  # radians per 15Hz step


def quat_to_euler_xyz(q: np.ndarray) -> np.ndarray:
    """(x, y, z, w) quaternion -> XYZ euler (matching scipy 'XYZ' intrinsic)."""
    x, y, z, w = q
    m = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    b = np.arcsin(np.clip(m[0, 2], -1, 1))
    a = np.arctan2(-m[1, 2], m[2, 2])
    c = np.arctan2(-m[0, 1], m[0, 0])
    return np.array([a, b, c])


def build_robot_obs(tcp_pos, tcp_orn, gripper_width, joint_positions, gripper_action) -> np.ndarray:
    """[tcp_pos (3), tcp_orn (3), gripper width, joint positions (7), gripper action]."""
    return np.concatenate([tcp_pos, tcp_orn, [gripper_width], joint_positions, [gripper_action]])
