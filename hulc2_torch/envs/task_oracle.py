"""Task oracle: decide which CALVIN tasks occurred between two env states.

The reference delegates this to the calvin_env submodule's oracle
(`tasks.get_task_info_for_set`, consumed at
hulc2/rollout/rollout.py:375 and evaluation/manager_aff_lmp.py:58-74; the
submodule itself is not checked out in the reference either). This module
provides:

- ``SceneObsTaskOracle`` — a self-contained oracle over (start, end)
  scene_obs vectors, with zone geometry calibrated to the CALVIN playtable
  (slot anchors shared with evaluation/initial_states.py). Used by the fake
  env tests and by batched eval when calvin_env is unavailable.

The port's copy of ``hulc2_tpu/envs/task_oracle.py`` with the heuristic
oracle only: the adapter over calvin_env's native oracle belongs to the real
simulator, which the port does not drive yet.

scene_obs layout (24,): [slider, drawer, button, switch, lightbulb, led,
red(x,y,z,rx,ry,rz), blue(6), pink(6)].
"""
from __future__ import annotations

from typing import Dict, Sequence, Set

import numpy as np

from hulc2_torch.evaluation.initial_states import (
    BLOCK_SLIDER_LEFT,
    BLOCK_SLIDER_RIGHT,
    DRAWER_OPEN,
    SLIDER_OPEN_LEFT,
)
from hulc2_torch.evaluation.tasks import COLORS

_BLOCK_SLICES = {c: slice(6 + 6 * i, 12 + 6 * i) for i, c in enumerate(COLORS)}

TABLE_Z = 0.4599
LIFT_DZ = 0.03  # raised by 3 cm counts as lifted
YAW_EPS = np.pi / 16  # minimum rotation for rotate_* tasks
PUSH_EPS = 0.025  # minimum y-lateral travel for push_* tasks
DRAWER_ZONE_Y = -0.35  # blocks with y below this are in the drawer
DRAWER_ZONE_Z = 0.42
SLIDER_ZONE_Z = (0.45, 0.48)
STACK_DZ = 0.04


def _block(scene: np.ndarray, color: str) -> np.ndarray:
    return scene[_BLOCK_SLICES[color]]


def _in_slider(pos: np.ndarray) -> bool:
    near_left = np.linalg.norm(pos[:2] - BLOCK_SLIDER_LEFT[:2]) < 0.1
    near_right = np.linalg.norm(pos[:2] - BLOCK_SLIDER_RIGHT[:2]) < 0.1
    return bool((near_left or near_right) and SLIDER_ZONE_Z[0] < pos[2] < SLIDER_ZONE_Z[1])


DRAWER_ZONE_Z_MIN = 0.30  # below: fallen to the floor, NOT in the drawer


def _in_drawer(pos: np.ndarray) -> bool:
    # the cavity floor holds blocks at ~0.38; a block released past the table
    # front but outside the cavity drops to FLOOR_Z=0.10 — it is lost, not
    # stowed (and permanently ungraspable: the EE z-clamp stops at 0.30), so
    # it must not satisfy place_in_drawer or count as a drawer-origin lift
    return bool(pos[1] < DRAWER_ZONE_Y and DRAWER_ZONE_Z_MIN < pos[2] < DRAWER_ZONE_Z)


def _on_floor(pos: np.ndarray) -> bool:
    return bool(pos[2] <= DRAWER_ZONE_Z_MIN)


def _on_table(pos: np.ndarray) -> bool:
    return bool(abs(pos[2] - TABLE_Z) < 0.02 and not _in_drawer(pos) and not _in_slider(pos))


def _stacked_on(top: np.ndarray, bottom: np.ndarray) -> bool:
    return bool(
        np.linalg.norm(top[:2] - bottom[:2]) < 0.04 and STACK_DZ < (top[2] - bottom[2]) < 0.09
    )


def symbolic_state_from_scene(scene_obs: np.ndarray, held=None) -> Dict:
    """Physical scene_obs -> symbolic StateDict (evaluation/tasks.py keys).

    The expert-data generator chains tasks by symbolic successor states; with
    execution noise the physical scene drifts from that bookkeeping (a noisy
    place can land a block outside the slider zone, a push can graze a stack),
    and a symbolically-feasible task then crashes the expert's physical
    planner. Re-deriving the symbolic state from the scene after every task
    keeps feasibility grounded in what the robot can actually do — the same
    zone predicates the oracle scores with, so generator, expert, and oracle
    agree by construction."""
    s = np.asarray(scene_obs, np.float64)
    state: Dict = {
        "slider": "left" if s[0] > SLIDER_OPEN_LEFT / 2 else "right",
        "drawer": "open" if s[1] > DRAWER_OPEN / 2 else "closed",
        "lightbulb": int(s[4] >= 0.5),
        "led": int(s[5] >= 0.5),
        "grasped": int(held is not None),
    }
    pos = {c: _block(s, c)[:3] for c in COLORS}
    slots: Dict[str, str] = {}
    for top in COLORS:
        for bot in COLORS:
            if top != bot and _stacked_on(pos[top], pos[bot]):
                slots[top] = "stacked_top"
                slots[bot] = "stacked_bottom"
    for c in COLORS:
        if held == c:
            slots[c] = "grasped"
        elif c in slots:
            pass
        elif _in_slider(pos[c]):
            near_left = np.linalg.norm(pos[c][:2] - BLOCK_SLIDER_LEFT[:2]) < 0.1
            slots[c] = "slider_left" if near_left else "slider_right"
        elif _in_drawer(pos[c]):
            slots[c] = "drawer"
        elif _on_floor(pos[c]):
            slots[c] = "floor"  # lost: below the EE z-clamp, ungraspable
        else:
            slots[c] = "table"  # incl. off-zone shelf strays: reachable
        state[f"{c}_block"] = slots[c]
    return state


class SceneObsTaskOracle:
    """Detect completed tasks from a (start_scene, end_scene) pair."""

    def get_task_info_for_set(self, start_info: Dict, end_info: Dict, tasks: Sequence[str]) -> Set[str]:
        s = np.asarray(start_info["scene_obs"], np.float64)
        e = np.asarray(end_info["scene_obs"], np.float64)
        return {t for t in tasks if self._check(s, e, t)}

    # ------------------------------------------------------------------ #
    def _check(self, s: np.ndarray, e: np.ndarray, task: str) -> bool:
        if task == "move_slider_left":
            return s[0] < SLIDER_OPEN_LEFT / 2 and e[0] > SLIDER_OPEN_LEFT / 2
        if task == "move_slider_right":
            return s[0] > SLIDER_OPEN_LEFT / 2 and e[0] < SLIDER_OPEN_LEFT / 2
        if task == "open_drawer":
            return s[1] < DRAWER_OPEN / 2 and e[1] > DRAWER_OPEN / 2
        if task == "close_drawer":
            return s[1] > DRAWER_OPEN / 2 and e[1] < DRAWER_OPEN / 2
        if task == "turn_on_lightbulb":
            return s[4] < 0.5 <= e[4]
        if task == "turn_off_lightbulb":
            return s[4] >= 0.5 > e[4]
        if task == "turn_on_led":
            return s[5] < 0.5 <= e[5]
        if task == "turn_off_led":
            return s[5] >= 0.5 > e[5]

        parts = task.split("_")
        if parts[0] in ("rotate", "push") and parts[1] in COLORS and task != "push_into_drawer":
            color, direction = parts[1], parts[-1]
            b0, b1 = _block(s, color), _block(e, color)
            if not (_on_table(b0[:3]) and _on_table(b1[:3])):
                return False
            if parts[0] == "rotate":
                dyaw = _wrap(b1[5] - b0[5])
                return dyaw > YAW_EPS if direction == "left" else dyaw < -YAW_EPS
            dy = b1[0] - b0[0]  # lateral table axis
            return dy > PUSH_EPS if direction == "right" else dy < -PUSH_EPS

        if parts[0] == "lift" and parts[1] in COLORS:
            color, where = parts[1], parts[-1]
            b0, b1 = _block(s, color), _block(e, color)
            lifted = b1[2] - b0[2] > LIFT_DZ
            origin_ok = {
                "table": _on_table(b0[:3]),
                "slider": _in_slider(b0[:3]),
                "drawer": _in_drawer(b0[:3]),
            }[where]
            return bool(lifted and origin_ok)

        if task == "place_in_slider":
            return any(
                not _in_slider(_block(s, c)[:3]) and _in_slider(_block(e, c)[:3]) for c in COLORS
            )
        if task == "place_in_drawer":
            # "was held": resting on no support at start (distinguishes place
            # from push_into_drawer, whose block starts ON the table). A plain
            # z>TABLE threshold misses blocks lifted out of the drawer itself,
            # whose floor sits below the table plane.
            return any(
                not _in_drawer(_block(s, c)[:3])
                and not _on_table(_block(s, c)[:3])
                and not _in_slider(_block(s, c)[:3])
                and _in_drawer(_block(e, c)[:3])
                for c in COLORS
            )
        if task == "push_into_drawer":
            return any(
                _on_table(_block(s, c)[:3]) and _in_drawer(_block(e, c)[:3]) for c in COLORS
            )
        if task == "stack_block":
            return any(
                not _stacked_on(_block(s, t)[:3], _block(s, b)[:3])
                and _stacked_on(_block(e, t)[:3], _block(e, b)[:3])
                for t in COLORS
                for b in COLORS
                if t != b
            )
        if task == "unstack_block":
            return any(
                _stacked_on(_block(s, t)[:3], _block(s, b)[:3])
                and not _stacked_on(_block(e, t)[:3], _block(e, b)[:3])
                for t in COLORS
                for b in COLORS
                if t != b
            )
        raise KeyError(f"unknown task {task}")


def _wrap(a: float) -> float:
    return (a + np.pi) % (2 * np.pi) - np.pi
