"""Interactive symbolic CALVIN env: solvable without PyBullet.

The port's copy of ``hulc2_tpu/envs/fake_env.py`` (numpy only, no torch), held
equal to it by ``tests/test_torch_port_eval_host.py``. Left out, since nothing
of the port uses them yet: ``perform(task)`` (dataset tooling), absolute
(pos, orn, gripper) actions and the camera parameters (the hierarchical mode),
the emulated step delay and the non-interactive mode (benchmark tooling).

Role: the integration-test and learning-loop backend (SURVEY.md §4's
"fake/synthetic backend" gap, extended per VERDICT r3 Missing #1 from an
oracle-scripted state machine into an env a *policy can actually solve*):

- ``step(action)`` has action-dependent scene dynamics for every CALVIN task
  family: the LED button toggles when pressed, the lightbulb lever follows
  the EE, the slider door and drawer follow a grasped handle, blocks can be
  pushed, grasped, lifted, rotated, carried and released onto whatever
  support lies below (table / shelf / drawer cavity / another block).
- ``get_obs()`` renders scene-dependent static + gripper RGB frames and an
  exact static depth map via ``envs.render`` (a pure function of state — no
  noise), so vision carries the full task-relevant state.
- the same 24-d ``scene_obs`` layout and task-completion geometry as
  ``SceneObsTaskOracle``, so oracle scoring, the annotator, and the chain
  generator all work unchanged.

Reference counterpart: the calvin_env PyBullet simulator consumed at
hulc2/wrappers/hulc2_wrapper.py:16 and the task oracle at
hulc2/rollout/rollout.py:375 — here both sides are host-CPU NumPy so the
full training→rollout→success loop closes with zero native sim deps.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from hulc2_torch.envs import scene_layout as L
from hulc2_torch.envs import task_oracle as oz
from hulc2_torch.evaluation.initial_states import (
    DRAWER_OPEN,
    NEUTRAL_ROBOT_OBS,
    SLIDER_OPEN_LEFT,
    SWITCH_ON,
)
from hulc2_torch.evaluation.tasks import COLORS


class FakeCalvinEnv:
    def __init__(self, static_hw: int = 200, gripper_hw: int = 84, render_obs: bool = True):
        self.static_hw = static_hw
        self.gripper_hw = gripper_hw
        # render_obs=False: get_obs returns only the 39 state floats — for the
        # device-render eval path, where the frames are rendered on the card
        # next to the policy (envs/render_torch.py) and the host render is
        # skipped entirely
        self.render_obs = render_obs
        self.robot_obs = NEUTRAL_ROBOT_OBS.copy()
        self.scene_obs = np.zeros(24)
        self._held: Optional[str] = None
        self._button_armed = True  # LED button edge trigger

    # ---- cameras -------------------------------------------------------- #
    @property
    def cameras(self):
        """Overhead static camera (role of calvin_env's camera objects,
        consumed at reference lmp_agent.py:174-194). Positioned so the whole
        playtable — open drawer to back shelf — is in frame, and pixel↔world
        project/deproject round-trips are exact against the rendered depth."""
        from hulc2_torch.envs.camera import PinholeCamera

        hw = self.static_hw
        T = np.eye(4)
        T[:3, :3] = np.diag([1.0, -1.0, -1.0])  # cam +z points world-down
        T[:3, 3] = [0.0, -0.12, 1.50]
        return [PinholeCamera.from_params(hw, hw, fx=1.15 * hw, fy=1.15 * hw,
                                          cx=hw / 2, cy=hw / 2,
                                          T_world_cam=T, name="static")]

    def _gripper_camera(self):
        """Wrist camera: looks straight down from above the TCP so the
        fingers and the local workspace fill the frame."""
        from hulc2_torch.envs.camera import PinholeCamera

        hw = self.gripper_hw
        T = np.eye(4)
        T[:3, :3] = np.diag([1.0, -1.0, -1.0])
        T[:3, 3] = self.robot_obs[:3] + [0.0, 0.0, 0.16]
        return PinholeCamera.from_params(hw, hw, fx=hw * 0.9, fy=hw * 0.9,
                                         cx=hw / 2, cy=hw / 2, T_world_cam=T,
                                         name="gripper")

    # ---- calvin_env-compatible surface --------------------------------- #
    def reset(self, robot_obs=None, scene_obs=None):
        if robot_obs is not None:
            self.robot_obs = np.asarray(robot_obs, np.float64).copy()
        if scene_obs is not None:
            self.scene_obs = np.asarray(scene_obs, np.float64).copy()
        self._held = None
        self._button_armed = True
        return self.get_obs()

    def step(self, action):
        """A flat 7-d relative action [dpos, dorn, gripper] (the calvin_env
        relative format): integrate the EE, then the scene's response."""
        prev = self.robot_obs.copy()
        a = np.asarray(action, np.float64).reshape(-1)
        self.robot_obs[:3] += np.clip(a[:3], -1, 1) * L.POS_STEP
        self.robot_obs[3:6] += np.clip(a[3:6], -1, 1) * L.ORN_STEP
        self.robot_obs[14] = 1.0 if a[-1] > 0 else -1.0
        self._simulate(prev)
        return self.get_obs(), 0.0, False, self.get_info()

    def get_info(self) -> Dict:
        return {"scene_obs": self.scene_obs.copy(), "robot_obs": self.robot_obs.copy()}

    def get_obs(self) -> Dict:
        from hulc2_torch.envs.render import render, scene_boxes

        if not self.render_obs:
            return {
                "robot_obs": self.robot_obs.copy(),
                "scene_obs": self.scene_obs.copy(),
            }
        boxes, n_static = scene_boxes(self.scene_obs, self.robot_obs, self._held)
        # the fixed static camera replays the fixtures' raycast from cache;
        # the gripper camera moves every frame, so no caching there
        rgb_static, depth_static = render(self.cameras[0], boxes,
                                          n_static=n_static, cache_key="static")
        # the wrist box (last) is the gripper camera's own mount — invisible
        # to it, exactly like a real wrist cam
        rgb_gripper, _ = render(self._gripper_camera(), boxes[:-1])
        return {
            "rgb_obs": {"rgb_static": rgb_static, "rgb_gripper": rgb_gripper},
            "depth_obs": {"depth_static": depth_static},
            "robot_obs": self.robot_obs.copy(),
            "scene_obs": self.scene_obs.copy(),
        }

    # ---- interactive dynamics ------------------------------------------ #
    def _bpos(self, color: str) -> np.ndarray:
        sl = self._bslice(color)
        return self.scene_obs[sl.start : sl.start + 3]

    def _simulate(self, prev: np.ndarray) -> None:
        """Scene response to the EE move from ``prev`` to ``self.robot_obs``."""
        s = self.scene_obs
        ee = self.robot_obs[:3]
        # workspace + support clamps for the EE itself
        ee[0] = np.clip(ee[0], *L.WORKSPACE_X)
        ee[1] = np.clip(ee[1], *L.WORKSPACE_Y)
        if ee[1] > oz.DRAWER_ZONE_Y:  # table top incl. the front lip
            zmin = L.EE_MIN_Z_TABLE
        elif L.in_drawer_cavity(ee[0], ee[1], s[1]):
            zmin = L.EE_MIN_Z_DRAWER
        else:
            zmin = L.EE_MIN_Z_FREE
        ee[2] = np.clip(ee[2], zmin, L.WORKSPACE_Z_MAX)

        prev_ee = prev[:3]
        delta = ee - prev_ee
        dyaw = self.robot_obs[5] - prev[5]
        grip_now, grip_prev = self.robot_obs[14], prev[14]
        closed = grip_now < 0
        close_edge = closed and grip_prev >= 0
        open_edge = (not closed) and grip_prev < 0

        # LED button: edge-triggered press toggles scene[5]
        if (np.linalg.norm(ee[:2] - L.BUTTON_POS[:2]) < L.BUTTON_PRESS_R
                and ee[2] < L.BUTTON_PRESS_Z):
            if self._button_armed:
                s[5] = 0.0 if s[5] >= 0.5 else 1.0
                self._button_armed = False
            s[2] = 0.02  # transient joint depression
        else:
            s[2] = 0.0
            if ee[2] > L.BUTTON_RELEASE_Z or np.linalg.norm(
                    ee[:2] - L.BUTTON_POS[:2]) > 2 * L.BUTTON_PRESS_R:
                self._button_armed = True

        # lightbulb lever: EE in contact drags the lever joint with its dz
        if np.linalg.norm(ee - L.switch_lever_pos(s[3])) < L.SWITCH_GRIP_R:
            s[3] = float(np.clip(s[3] + delta[2], 0.0, SWITCH_ON))
            s[4] = 1.0 if s[3] > SWITCH_ON / 2 else 0.0

        # slider door: grasped handle drags scene[0] with the EE's dx
        if closed and self._held is None and np.linalg.norm(
                ee - L.slider_handle_pos(s[0])) < L.SLIDER_GRIP_R:
            s[0] = float(np.clip(s[0] + delta[0], 0.0, SLIDER_OPEN_LEFT))

        # drawer: grasped handle drags scene[1] with the EE's -dy; resting
        # blocks inside the cavity translate with it
        if closed and self._held is None and np.linalg.norm(
                ee - L.drawer_handle_pos(s[1])) < L.DRAWER_GRIP_R:
            d_new = float(np.clip(s[1] - delta[1], 0.0, DRAWER_OPEN))
            dd = d_new - s[1]
            if dd:
                for c in COLORS:
                    if c != self._held and oz._in_drawer(self._bpos(c)):
                        self._bpos(c)[1] -= dd
            s[1] = d_new

        # grasp: on the close edge, pick the nearest block within reach
        if close_edge and self._held is None:
            cands = [(np.linalg.norm(self._bpos(c) - ee), c) for c in COLORS]
            d, c = min(cands)
            if d < L.GRASP_R:
                self._held = c

        if self._held is not None:
            b = self._bpos(self._held)
            b[:] = ee  # carried block rides the TCP
            self.scene_obs[self._bslice(self._held).start + 5] += dyaw
            if open_edge:
                b[2] = self._support_z(b[0], b[1], exclude=self._held)
                self._held = None

        # push: sustained-low EE contact shoves free blocks along its motion.
        # A pushed block SLIDES — it may keep its height or drop, never climb
        # (below_z), so sweeping a stacked pair moves it coherently instead of
        # teleport-swapping the pair (each block would otherwise re-settle on
        # the other). Ascending-z order settles supports before riders.
        if (delta[0] or delta[1]):
            for c in sorted((c for c in COLORS if c != self._held),
                            key=lambda c: self._bpos(c)[2]):
                b = self._bpos(c)
                if (np.linalg.norm(ee[:2] - b[:2]) < L.PUSH_R
                        and ee[2] < b[2] + L.PUSH_Z_MARGIN
                        and prev_ee[2] < b[2] + L.PUSH_Z_MARGIN):
                    b[0] += delta[0]
                    b[1] += delta[1]
                    b[2] = self._support_z(b[0], b[1], exclude=c,
                                           below_z=b[2] + 1e-6)

    def _support_z(self, x: float, y: float, exclude: Optional[str] = None,
                   below_z: Optional[float] = None) -> float:
        """Resting height for a block released/pushed to (x, y). With
        ``below_z`` the result may not exceed it (pushed blocks slide or
        drop, only a released block can land ON another)."""
        s = self.scene_obs
        for c in COLORS:  # stack onto another block?
            if c == exclude or c == self._held:
                continue
            b = self._bpos(c)
            rest = float(b[2] + 2 * L.BLOCK_HALF[2])
            if (np.linalg.norm([x - b[0], y - b[1]]) < 0.035 and b[2] < 0.55
                    and (below_z is None or rest <= below_z)):
                return rest
        if y < oz.DRAWER_ZONE_Y:  # past the front lip: drawer cavity or lost
            if L.in_drawer_cavity(x, y, s[1]):
                return L.DRAWER_BLOCK_Z
            return L.FLOOR_Z
        if y > L.SHELF_Y_MIN:
            return L.SHELF_Z
        return oz.TABLE_Z

    def _bslice(self, color: str) -> slice:
        return slice(6 + 6 * COLORS.index(color), 12 + 6 * COLORS.index(color))
