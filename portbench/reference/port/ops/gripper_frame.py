"""World <-> TCP (tool-center-point) frame conversion of relative actions, fp32.

Counterpart of ``hulc2_tpu/ops/gripper_frame.py:65, :84``. Actions are 7-d:
rel_pos(3), rel_orn_euler(3) scaled by 100, gripper(1); ``robot_obs`` dims 3:6
hold the TCP orientation in the world frame. The math runs with autocast off
and its 3x3 products are written elementwise, so neither bf16 nor TF32 can
reach it (the JAX package pins these products to HIGHEST precision).
"""
from __future__ import annotations

import torch

from portbench.reference.port.ops.rotations import euler_angles_to_matrix, matrix_to_euler_angles, wrap_angle

_ORN_SCALE = 0.01  # euler actions -> pseudo-infinitesimal rotations


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, k) as an elementwise product and sum."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def world_to_tcp_frame(action: torch.Tensor, robot_obs: torch.Tensor) -> torch.Tensor:
    """Relative world-frame actions (..., 7) -> TCP frame, in fp32."""
    with torch.autocast(device_type=action.device.type, enabled=False):
        action = action.float()
        orn_world = robot_obs[..., 3:6].float()
        world_T_tcp = euler_angles_to_matrix(orn_world)
        tcp_T_world = world_T_tcp.transpose(-1, -2)
        pos_tcp_rel = _matmul3(tcp_T_world, action[..., :3, None])[..., 0]
        orn_w_rel = action[..., 3:6] * _ORN_SCALE
        world_T_tcp_new = euler_angles_to_matrix(orn_world + orn_w_rel)
        tcp_new_T_tcp_old = _matmul3(world_T_tcp_new.transpose(-1, -2), world_T_tcp)
        orn_tcp_rel = wrap_angle(matrix_to_euler_angles(tcp_new_T_tcp_old)) / _ORN_SCALE
        return torch.cat([pos_tcp_rel, orn_tcp_rel, action[..., -1:]], dim=-1)


def tcp_to_world_frame(action: torch.Tensor, robot_obs: torch.Tensor) -> torch.Tensor:
    """Relative TCP-frame actions (..., 7) -> world frame, in fp32."""
    with torch.autocast(device_type=action.device.type, enabled=False):
        action = action.float()
        orn_world = robot_obs[..., 3:6].float()
        world_T_tcp = euler_angles_to_matrix(orn_world)
        pos_w_rel = _matmul3(world_T_tcp, action[..., :3, None])[..., 0]
        orn_tcp_rel = action[..., 3:6] * _ORN_SCALE
        tcp_new_T_tcp_old = euler_angles_to_matrix(orn_tcp_rel)
        world_T_tcp_new = _matmul3(world_T_tcp, tcp_new_T_tcp_old.transpose(-1, -2))
        orn_w_new = matrix_to_euler_angles(world_T_tcp_new)
        orn_w_rel = wrap_angle(orn_w_new - orn_world) / _ORN_SCALE
        return torch.cat([pos_w_rel, orn_w_rel, action[..., -1:]], dim=-1)
