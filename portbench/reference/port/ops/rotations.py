"""XYZ euler <-> rotation matrix math in fp32 (counterpart of ``ops/rotations.py``).

Conventions match pytorch3d and the JAX package: ``euler_angles_to_matrix``
returns Rx(a) @ Ry(b) @ Rz(c); ``matrix_to_euler_angles`` inverts it with the
``asin`` argument clamped. ``matrix_to_quaternion`` and
``quaternion_to_matrix`` use (w, x, y, z) with w >= 0.
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


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrices -> (..., 4) unit quaternions (w, x, y, z).

    Shepperd's method without branches: all four candidates are formed and
    the one with the largest denominator is kept per matrix."""
    m = matrix.float()
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    mags = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 + m11 - m00 - m22,
                        1.0 + m22 - m00 - m11], dim=-1)
    cands = torch.stack([
        torch.stack([mags[..., 0], m21 - m12, m02 - m20, m10 - m01], dim=-1),  # w largest
        torch.stack([m21 - m12, mags[..., 1], m01 + m10, m02 + m20], dim=-1),  # x largest
        torch.stack([m02 - m20, m01 + m10, mags[..., 2], m12 + m21], dim=-1),  # y largest
        torch.stack([m10 - m01, m02 + m20, m12 + m21, mags[..., 3]], dim=-1),  # z largest
    ], dim=-2)
    best = mags.argmax(dim=-1)
    q = torch.take_along_dim(cands, best[..., None, None].expand(*best.shape, 1, 4), dim=-2)[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def quaternion_to_matrix(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) unit quaternions (w, x, y, z) -> (..., 3, 3) rotation matrices."""
    w, x, y, z = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1)
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def wrap_angle(x: torch.Tensor) -> torch.Tensor:
    """One 2 pi correction in each direction, as the reference does."""
    x = torch.where(x < -math.pi, x + 2 * math.pi, x)
    return torch.where(x > math.pi, x - 2 * math.pi, x)
