"""XYZ euler <-> rotation matrix math in fp32 (counterpart of ``ops/rotations.py``).

Conventions match pytorch3d and the JAX package: ``euler_angles_to_matrix``
returns Rx(a) @ Ry(b) @ Rz(c); ``matrix_to_euler_angles`` inverts it with the
``asin`` argument clamped. Only what ``world_to_tcp_frame`` needs is ported.
"""
from __future__ import annotations

import math

import torch


def euler_angles_to_matrix(euler: torch.Tensor) -> torch.Tensor:
    """(..., 3) XYZ euler angles -> (..., 3, 3), closed form, elementwise only."""
    euler = euler.float()
    a, b, c = euler[..., 0], euler[..., 1], euler[..., 2]
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    cc, sc = torch.cos(c), torch.sin(c)
    row0 = torch.stack([cb * cc, -cb * sc, sb], dim=-1)
    row1 = torch.stack([ca * sc + sa * sb * cc, ca * cc - sa * sb * sc, -sa * cb], dim=-1)
    row2 = torch.stack([sa * sc - ca * sb * cc, sa * cc + ca * sb * sc, ca * cb], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def matrix_to_euler_angles(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrices -> (..., 3) XYZ euler angles."""
    m = matrix.float()
    b = torch.asin(m[..., 0, 2].clamp(-1.0, 1.0))
    a = torch.atan2(-m[..., 1, 2], m[..., 2, 2])
    c = torch.atan2(-m[..., 0, 1], m[..., 0, 0])
    return torch.stack([a, b, c], dim=-1)


def wrap_angle(x: torch.Tensor) -> torch.Tensor:
    """One 2 pi correction in each direction, as the reference does."""
    x = torch.where(x < -math.pi, x + 2 * math.pi, x)
    return torch.where(x > math.pi, x - 2 * math.pi, x)
