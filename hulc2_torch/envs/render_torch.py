"""The fake env's renderer on the device: K envs' frames from their 39 state floats.

Counterpart of ``hulc2_tpu/envs/render_jax.py``. The fake env's frames are a
pure function of ``(scene_obs, robot_obs)``, so the evaluator ships K x 39
floats per step and the policy's fused step renders all K envs next to the
policy, instead of the host rendering K frames and shipping ~30 KiB per env.

The math is that of the host renderer (``envs/render.py``) op for op in
float32, batched over a leading env dimension: the same ray grids (computed
by the host code in float32 and copied to the device once), the same box list
in the order of ``render.scene_boxes``, the same slab test with the 1e-12
guard, the nearest hit by first-occurrence argmin (``torch.argmin``
documents the same rule as the host loop's strict ``<`` update), the same
Lambert shading, and colours clamped and truncated to uint8. The drawer's
cavity floor, which the host adds only when the drawer is open, is a box
parked at z = -10 when closed, so every env has the same box count. The host
rounds some intermediates through float64, so a few pixels may differ by one
LSB: ``tests/test_torch_port_rollout.py`` holds the frames to the bounds of
``tests/test_render_jax.py``.

Plain PyTorch: it is not a TPU kernel (XLA fused it on the TPU). Its device
time per dispatch is in ``PERF.md``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hulc2_torch.envs import scene_layout as L
from hulc2_torch.envs.render import _LIGHT, _ray_grid
from hulc2_torch.evaluation.tasks import COLORS
from hulc2_torch.utils.device import resolve_device

# box list (the order of render.scene_boxes): 0 table, 1 shelf, 2 wall,
# 3 button base, 4 led, 5 lever track, 6 bulb, 7 door, 8 door handle, 9 drawer
# panel, 10 drawer handle, 11 cavity floor (parked when closed), 12 lever,
# 13..15 blocks, 16 finger-, 17 finger+, 18 wrist
N_BOXES = 13 + len(COLORS) + 3
_HIDDEN_Z = -10.0  # parked far below the floor: the slab test never hits it
_LIGHT32 = [float(x) for x in _LIGHT.astype(np.float32)]
_GRIP_OFFSET = (0.0, 0.0, 0.16)  # the wrist camera above the TCP (fake_env._gripper_camera)
_LED, _BULB, _CAVITY = 4, 6, 11


def camera_dirs(camera) -> Tuple[np.ndarray, np.ndarray]:
    """World-frame ray directions (H, W, 3) with camera-z component 1, and
    the camera's origin (3,), float32, computed by the host renderer's code."""
    T = camera.T_world_cam.astype(np.float32)
    return (np.asarray(_ray_grid(camera) @ T[:3, :3].T.astype(np.float32), np.float32),
            np.asarray(T[:3, 3], np.float32))


def _f32(x) -> float:
    """A constant as the float32 value that the f32 arithmetic uses."""
    return float(np.float32(x))


def _static_boxes() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(centers (7, 3), halves (N, 3), colours (N, 3)) float32: the fixed
    fixtures' centres, every box's half extents (none depends on the state)
    and every box's colour (the LED's and the bulb's are set per env)."""
    centers = [
        [0.0, (L.TABLE_Y[0] + L.TABLE_Y[1]) / 2, L.TABLE_Z - 0.015],
        [0.0, (L.SHELF_Y_MIN + L.TABLE_Y[1]) / 2, L.SHELF_Z - 0.012],
        [0.0, L.TABLE_Y[1] - 0.01, 0.55],
        L.BUTTON_POS - [0, 0, L.BUTTON_HALF[2]],
        L.BUTTON_POS + [0, 0, L.LED_HALF[2] - 0.002],
        [L.SWITCH_X, L.SWITCH_Y + 0.01, (L.SWITCH_Z0 + 0.60) / 2],
        L.LIGHTBULB_POS,
    ]
    halves = [
        [L.TABLE_X_HALF, (L.TABLE_Y[1] - L.TABLE_Y[0]) / 2, 0.015],
        [L.TABLE_X_HALF, (L.TABLE_Y[1] - L.SHELF_Y_MIN) / 2, 0.012],
        [L.TABLE_X_HALF, 0.01, 0.10], L.BUTTON_HALF, L.LED_HALF, [0.006, 0.006, 0.07],
        L.LIGHTBULB_HALF, L.DOOR_HALF, L.HANDLE_HALF, L.DRAWER_PANEL_HALF,
        L.DRAWER_HANDLE_HALF, [L.DRAWER_X_HALF - 0.01, L.DRAWER_DEPTH / 2, 0.005],
        L.SWITCH_HALF, *[L.BLOCK_HALF] * len(COLORS), L.EE_FINGER_HALF, L.EE_FINGER_HALF,
        L.EE_WRIST_HALF,
    ]
    colors = [
        L.COLOR_TABLE, L.COLOR_SHELF, L.COLOR_SHELF * 0.8, L.COLOR_BUTTON, L.COLOR_LED_OFF,
        L.COLOR_SWITCH * 1.5, L.COLOR_BULB_OFF, L.COLOR_DOOR, L.COLOR_HANDLE, L.COLOR_DRAWER,
        L.COLOR_HANDLE, L.COLOR_DRAWER * 0.7, L.COLOR_SWITCH,
        *[L.BLOCK_COLORS[c] for c in COLORS], L.COLOR_EE, L.COLOR_EE, L.COLOR_EE * 1.8,
    ]
    return tuple(np.asarray([np.asarray(r, np.float64) for r in rows]).astype(np.float32)
                 for rows in (centers, halves, colors))


class SceneConstants:
    """What the box list needs that does not depend on the state, on one
    device, made once: building it per call would copy from host memory on
    every dispatch, and such a copy synchronises the stream."""

    def __init__(self, device):
        centers, halves, colors = _static_boxes()
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
        self.static_centers = t(centers)
        self.halves = t(halves)
        self.colors = t(colors)
        self.led = t([L.COLOR_LED_OFF, L.COLOR_LED_ON])
        self.bulb = t([L.COLOR_BULB_OFF, L.COLOR_BULB_ON])
        self.background = t(L.COLOR_BG)


def build_boxes(s: torch.Tensor, r: torch.Tensor, const: SceneConstants):
    """scene_obs (K, 24), robot_obs (K, 15) float32 -> centers (K, N, 3),
    halves (N, 3), colors (K, N, 3), yaws (K, N); ``render_jax.build_boxes``
    batched over K."""
    k = s.shape[0]

    def col(v: float) -> torch.Tensor:
        return torch.full((k,), _f32(v), dtype=torch.float32, device=s.device)

    door_x = L.DOOR_X0 + s[:, 0]
    fy = L.DRAWER_FRONT_Y0 - s[:, 1]
    cav_z = torch.where(s[:, 1] > 0.02, _f32(L.DRAWER_FLOOR_Z - 0.005), _f32(_HIDDEN_Z))
    moving = [
        torch.stack([door_x, col(L.DOOR_Y), col(L.DOOR_Z)], -1),
        torch.stack([door_x + L.HANDLE_OFFSET_X, col(L.DOOR_Y), col(L.HANDLE_Z)], -1),
        torch.stack([col(L.DRAWER_X), fy, col(L.DRAWER_PANEL_Z)], -1),
        torch.stack([col(L.DRAWER_X), fy - 0.02, col(L.DRAWER_HANDLE_Z)], -1),
        torch.stack([col(L.DRAWER_X), fy + L.DRAWER_DEPTH / 2, cav_z], -1),
        torch.stack([col(L.SWITCH_X), col(L.SWITCH_Y), L.SWITCH_Z0 + s[:, 3]], -1),
    ]
    block_yaws = []
    for i in range(len(COLORS)):
        b = s[:, 6 + 6 * i: 12 + 6 * i]
        moving.append(torch.stack([b[:, 0], b[:, 1], b[:, 2] + 0.012], -1))
        block_yaws.append(b[:, 5])
    ee, yaw = r[:, :3], r[:, 5]
    gap = torch.where(r[:, 14] < 0, _f32(L.EE_FINGER_GAP_CLOSED), _f32(L.EE_FINGER_GAP_OPEN))
    fx, fy_ = torch.cos(yaw) * gap / 2, torch.sin(yaw) * gap / 2
    fz = _f32(L.EE_FINGER_HALF[2] - 0.01)
    moving += [
        torch.stack([ee[:, 0] - fx, ee[:, 1] - fy_, ee[:, 2] + fz], -1),
        torch.stack([ee[:, 0] + fx, ee[:, 1] + fy_, ee[:, 2] + fz], -1),
        torch.stack([ee[:, 0], ee[:, 1], ee[:, 2] + L.EE_WRIST_LIFT], -1),
    ]
    centers = torch.cat([const.static_centers.expand(k, -1, -1), torch.stack(moving, 1)], 1)

    colors = const.colors.expand(k, -1, -1).clone()
    colors[:, _LED] = const.led[(s[:, 5] >= 0.5).long()]
    colors[:, _BULB] = const.bulb[(s[:, 4] >= 0.5).long()]

    zero = torch.zeros_like(yaw)
    yaws = torch.stack([zero] * 13 + block_yaws + [yaw, yaw, zero], 1)
    return centers, const.halves, colors, yaws


def raycast(dirs: torch.Tensor, t0: torch.Tensor, centers: torch.Tensor, halves: torch.Tensor,
            colors: torch.Tensor, yaws: torch.Tensor,
            background: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab-test every pixel ray of K envs against every box; Lambert-shade
    the nearest hit. dirs (H, W, 3), t0 (K, 3), centers (K, N, 3), halves
    (N, 3), colors (K, N, 3), yaws (K, N), background (3,) -> (rgb uint8
    (K, H, W, 3), depth float32 (K, H, W)); ``render_jax.raycast`` batched
    over K."""
    k, n = yaws.shape
    h, w = dirs.shape[:2]
    o = t0[:, None, :] - centers                                       # (K, N, 3)
    cy, sy = torch.cos(-yaws), torch.sin(-yaws)                        # (K, N)
    o_r = torch.stack([cy * o[..., 0] - sy * o[..., 1],
                       sy * o[..., 0] + cy * o[..., 1], o[..., 2]], -1)
    cyb, syb = cy[:, :, None, None], sy[:, :, None, None]
    d_r = torch.stack([cyb * dirs[..., 0] - syb * dirs[..., 1],
                       syb * dirs[..., 0] + cyb * dirs[..., 1],
                       dirs[..., 2].expand(k, n, h, w)], -1)           # (K, N, H, W, 3)
    safe = torch.where(d_r.abs() < 1e-12, 1e-12, d_r)
    orr = o_r[:, :, None, None, :]
    hf = halves[None, :, None, None, :]
    ta = (-hf - orr) / safe
    tb = (hf - orr) / safe
    lo = torch.minimum(ta, tb)
    hi = torch.maximum(ta, tb)
    tmin = lo.amax(-1)                                                 # (K, N, H, W)
    tmax = hi.amin(-1)
    valid = (tmax >= tmin) & (tmin > 1e-6)
    t = torch.where(valid, tmin, float("inf"))
    best = t.argmin(1)                                                 # (K, H, W), first minimum
    hit = valid.gather(1, best[:, None])[:, 0]
    bt = t.gather(1, best[:, None])[:, 0]
    best3 = best[:, None, :, :, None].expand(k, 1, h, w, 3)
    axis = lo.gather(1, best3)[:, 0].argmax(-1)                        # (K, H, W), first maximum
    d_b = d_r.gather(1, best3)[:, 0]
    d_ax = d_b.gather(-1, axis[..., None])[..., 0]
    sign = torch.where(d_ax > 0, -1.0, 1.0)

    # normal along the hit slab axis, rotated to world by the box yaw
    nb = F.one_hot(axis, 3).to(torch.float32) * sign[..., None]
    yb = yaws.gather(1, best.reshape(k, -1)).reshape(k, h, w)
    cb, sb = torch.cos(yb), torch.sin(yb)
    nx = cb * nb[..., 0] - sb * nb[..., 1]
    ny = sb * nb[..., 0] + cb * nb[..., 1]
    lam = (nx * _LIGHT32[0] + ny * _LIGHT32[1] + nb[..., 2] * _LIGHT32[2]).clamp(0, 1)
    shade = 0.55 + 0.45 * lam

    col_b = colors.gather(1, best.reshape(k, -1, 1).expand(k, h * w, 3)).reshape(k, h, w, 3)
    rgb = torch.where(hit[..., None], col_b * shade[..., None], background)
    depth = torch.where(hit, bt, 0.0)
    rgb8 = (rgb * 255.0).clamp(0, 255).to(torch.uint8)
    return rgb8, depth


def make_render_obs_fn(static_hw: int, gripper_hw: int, with_depth: bool = True,
                       device=None) -> Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]:
    """fn(scene_obs (K, 24), robot_obs (K, 15) float32 on ``device``, the
    card unless ``"cpu"`` is asked for) ->
    {"rgb_static": (K, H, W, 3) uint8, "rgb_gripper": (K, h, w, 3) uint8
    [, "depth_static": (K, H, W) float32]}, with the cameras of
    ``FakeCalvinEnv`` at these sizes. The gripper view leaves out the wrist
    box, as the host path does."""
    from hulc2_torch.envs.fake_env import FakeCalvinEnv

    device = resolve_device(device)
    env = FakeCalvinEnv(static_hw=static_hw, gripper_hw=gripper_hw)
    static_dirs, static_t0 = camera_dirs(env.cameras[0])
    grip_dirs, _ = camera_dirs(env._gripper_camera())  # its origin follows the TCP
    const = SceneConstants(device)
    static_dirs = torch.as_tensor(static_dirs, device=device)
    static_t0 = torch.as_tensor(static_t0, device=device)
    grip_dirs = torch.as_tensor(grip_dirs, device=device)
    grip_offset = torch.tensor(_GRIP_OFFSET, dtype=torch.float32, device=device)

    def render(scene_obs: torch.Tensor, robot_obs: torch.Tensor) -> Dict[str, torch.Tensor]:
        c, h, col, y = build_boxes(scene_obs, robot_obs, const)
        k = scene_obs.shape[0]
        rgb_s, depth_s = raycast(static_dirs, static_t0.expand(k, 3), c, h, col, y,
                                 const.background)
        t0g = robot_obs[:, :3] + grip_offset
        rgb_g, _ = raycast(grip_dirs, t0g, c[:, :-1], h[:-1], col[:, :-1], y[:, :-1],
                           const.background)
        out = {"rgb_static": rgb_s, "rgb_gripper": rgb_g}
        if with_depth:
            out["depth_static"] = depth_s
        return out

    return render
