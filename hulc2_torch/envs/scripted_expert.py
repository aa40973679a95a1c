"""Scripted expert: solves every CALVIN task family through the interactive
fake env's ``step()``.

Role: the teleoperator. The reference's play data comes from human
teleoperation (reference README "collected by human demonstrators"); this
expert produces the same kind of data — continuous play sequences of
oracle-verified task completions — against the interactive
``FakeCalvinEnv``, so behavior cloning has something real to clone
(VERDICT r3 next-round #1).

Plans are short waypoint programs over the shared ``envs.scene_layout``
geometry, executed as CALVIN-convention flat 7-d relative actions
([dpos/0.02, dorn/0.05, gripper]) — i.e. exactly the ``rel_actions`` the
datasets store and the policy is trained to emit. Privileged state (the
24-d scene_obs) is read once at plan time; execution is open-loop
proportional waypoint tracking with optional exploration noise.

The port's copy of ``hulc2_tpu/envs/scripted_expert.py``, unchanged but for
its imports (numpy only).
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np

from hulc2_torch.envs import scene_layout as L
from hulc2_torch.envs import task_oracle as oz
from hulc2_torch.evaluation.initial_states import DRAWER_OPEN, SLIDER_OPEN_LEFT
from hulc2_torch.evaluation.tasks import COLORS

# op kinds: ("move", xyz target), ("grip", ±1, hold_steps), ("yaw", delta)
Op = Tuple


class InfeasibleTask(RuntimeError):
    """Plan-time: the physical scene does not support the task (e.g.
    unstack with nothing stacked). ``solve`` treats it as a clean failure so
    one infeasible draw never kills a whole dataset-generation run."""


class ScriptedExpert:
    def __init__(self, env, rng: Optional[np.random.Generator] = None,
                 noise: float = 0.0):
        self.env = env
        self.rng = rng or np.random.default_rng(0)
        self.noise = float(noise)
        self.oracle = oz.SceneObsTaskOracle()

    # ------------------------------------------------------------------ #
    def solve(self, task: str, recorder=None, max_steps: int = 400) -> bool:
        """Plan + execute ``task``; returns the oracle's verdict.
        ``recorder(obs, action, info)`` is called after every env step."""
        start_info = self.env.get_info()
        n = 0
        try:
            for a in self.actions(task):
                obs, _, _, info = self.env.step(a)
                if recorder is not None:
                    recorder(obs, a, info)
                n += 1
                if n >= max_steps:
                    break
        except InfeasibleTask:
            return False
        done = self.oracle.get_task_info_for_set(start_info, self.env.get_info(), [task])
        return task in done

    def actions(self, task: str) -> Iterator[np.ndarray]:
        """Flat 7-d relative actions executing ``task`` from the current state."""
        grip = 1.0 if self.env.robot_obs[14] > 0 else -1.0
        for op in self.plan(task):
            kind = op[0]
            if kind == "grip":
                grip = float(op[1])
                for _ in range(op[2]):
                    yield self._action(np.zeros(3), 0.0, grip)
            elif kind == "yaw":
                rem = float(op[1])
                while abs(rem) > 1e-3:
                    dy = float(np.clip(rem / L.ORN_STEP, -1, 1))
                    rem -= dy * L.ORN_STEP
                    yield self._action(np.zeros(3), dy, grip)
            elif kind == "move":
                target = np.asarray(op[1], np.float64)
                for _ in range(250):
                    ee = self.env.robot_obs[:3]
                    err = target - ee
                    if np.linalg.norm(err) < 0.006:
                        break
                    yield self._action(np.clip(err / L.POS_STEP, -1, 1), 0.0, grip)
            else:
                raise KeyError(kind)

    def _action(self, dpos, dyaw: float, grip: float) -> np.ndarray:
        a = np.zeros(7)
        a[:3] = dpos
        a[5] = dyaw
        if self.noise:
            a[:3] += self.rng.normal(0, self.noise, 3)
            a[5] += self.rng.normal(0, self.noise)
        a[:6] = np.clip(a[:6], -1, 1)
        a[6] = grip
        return a

    # ------------------------------------------------------------------ #
    def plan(self, task: str) -> List[Op]:
        s = self.env.scene_obs
        parts = task.split("_")

        if task in ("turn_on_led", "turn_off_led"):
            above = np.array([*L.BUTTON_POS[:2], 0.58])
            press = np.array([*L.BUTTON_POS[:2], 0.462])
            return [("move", above), ("move", press), ("move", above)]

        if task in ("turn_on_lightbulb", "turn_off_lightbulb"):
            lever = L.switch_lever_pos(s[3])
            end_z = L.SWITCH_Z0 + (0.15 if task == "turn_on_lightbulb" else -0.05)
            # exit LATERALLY: a vertical retreat would drag the lever back
            exit_wp = np.array([lever[0], lever[1] - 0.14, end_z])
            return [("move", [lever[0], lever[1], lever[2] + 0.12]),
                    ("move", lever),
                    ("move", [lever[0], lever[1], end_z]),
                    ("move", exit_wp)]

        if task in ("move_slider_left", "move_slider_right"):
            handle = L.slider_handle_pos(s[0])
            target0 = SLIDER_OPEN_LEFT if task == "move_slider_left" else 0.0
            dx = (target0 - s[0]) * 1.05  # slight overshoot; env clamps
            return [("move", handle + [0, 0, 0.12]), ("grip", 1, 1),
                    ("move", handle), ("grip", -1, 2),
                    ("move", handle + [dx, 0, 0]), ("grip", 1, 2),
                    ("move", handle + [dx, 0, 0.14])]

        if task in ("open_drawer", "close_drawer"):
            handle = L.drawer_handle_pos(s[1])
            target1 = DRAWER_OPEN if task == "open_drawer" else 0.0
            dy = -(target1 - s[1]) * 1.05
            return [("move", handle + [0, 0, 0.14]), ("grip", 1, 1),
                    ("move", handle), ("grip", -1, 2),
                    ("move", handle + [0, dy, 0]), ("grip", 1, 2),
                    ("move", handle + [0, dy, 0.14])]

        if parts[0] == "push" and task != "push_into_drawer":
            b = self._block(parts[1])
            sgn = 1.0 if parts[-1] == "right" else -1.0
            standoff = np.array([b[0] - sgn * (L.PUSH_R + 0.035), b[1], b[2]])
            through = np.array([b[0] + sgn * 0.012, b[1], b[2]])
            return [("move", [standoff[0], standoff[1], 0.58]), ("grip", -1, 1),
                    ("move", standoff), ("move", through),
                    ("move", [through[0], through[1], 0.58])]

        if parts[0] == "rotate":
            b = self._block(parts[1])
            dyaw = np.pi / 6 if parts[-1] == "left" else -np.pi / 6
            return [("move", [b[0], b[1], 0.58]), ("grip", 1, 1),
                    ("move", b), ("grip", -1, 2), ("yaw", dyaw),
                    ("grip", 1, 2), ("move", [b[0], b[1], 0.58])]

        if parts[0] == "lift":
            b = self._block(parts[1])
            return [("move", [b[0], b[1], b[2] + 0.15]), ("grip", 1, 1),
                    ("move", b), ("grip", -1, 2),
                    ("move", [b[0], b[1], b[2] + 0.18])]

        if task == "place_in_slider":
            slot = (np.array([-0.24, L.SHELF_Y, L.SHELF_Z])
                    if s[0] > SLIDER_OPEN_LEFT / 2
                    else np.array([0.07, L.SHELF_Y, L.SHELF_Z]))
            # occupied slot: drop beside it (still inside the oracle's
            # 0.1-radius slider zone) instead of stacking out of the zone
            held = self._held_color()
            for c in COLORS:
                if c != held and np.linalg.norm(self._block(c)[:2] - slot[:2]) < 0.05:
                    slot = slot + np.array([0.06, 0.0, 0.0])
                    break
            return [("move", [slot[0], slot[1], 0.62]),
                    ("move", [slot[0], slot[1], 0.50]), ("grip", 1, 2),
                    ("move", [slot[0], slot[1], 0.62])]

        if task == "place_in_drawer":
            x = float(np.clip(self.env.robot_obs[0], L.DRAWER_X - 0.08, L.DRAWER_X + 0.08))
            tgt = np.array([x, -0.42, 0.42])
            held = self._held_color()
            for c in COLORS:  # don't drop onto a block already in the drawer
                if c != held and np.linalg.norm(self._block(c)[:2] - tgt[:2]) < 0.05:
                    tgt[0] = L.DRAWER_X + (0.07 if x <= L.DRAWER_X else -0.07)
                    break
            return [("move", [tgt[0], tgt[1], 0.58]), ("move", tgt), ("grip", 1, 2),
                    ("move", [tgt[0], tgt[1], 0.58])]

        if task == "push_into_drawer":
            b = self._on_table_block()
            # push diagonally so the block lands inside the cavity's x-range
            # even when earlier pushes moved it sideways off the drawer line
            tx = float(np.clip(b[0], L.DRAWER_X - 0.08, L.DRAWER_X + 0.08))
            tgt = np.array([tx, -0.365])
            dirv = tgt - b[:2]
            dirv = dirv / np.linalg.norm(dirv)
            behind = np.array([*(b[:2] - dirv * (L.PUSH_R + 0.035)), b[2]])
            through = np.array([*tgt, b[2]])  # block rides ~0.05 ahead, past the lip
            return [("move", [behind[0], behind[1], 0.58]), ("grip", -1, 1),
                    ("move", behind), ("move", through),
                    ("move", [through[0], through[1], 0.58])]

        if task == "stack_block":
            top = self._held_color()
            if top is None:  # grasp a free table block first
                cands = [c for c in COLORS if oz._on_table(self._block(c))]
                if len(cands) < 2:
                    raise InfeasibleTask("stack_block: <2 free table blocks")
                top = cands[0]
                b = self._block(top)
                pre = [("move", [b[0], b[1], 0.58]), ("grip", 1, 1),
                       ("move", b), ("grip", -1, 2),
                       ("move", [b[0], b[1], 0.58])]
                bot = self._block(cands[1])
            else:
                pre = []
                bots = [self._block(c) for c in COLORS
                        if c != top and oz._on_table(self._block(c))]
                if not bots:
                    raise InfeasibleTask("stack_block: no table block to stack onto")
                bot = bots[0]
            return pre + [("move", [bot[0], bot[1], 0.62]),
                          ("move", [bot[0], bot[1], 0.53]), ("grip", 1, 2),
                          ("move", [bot[0], bot[1], 0.62])]

        if task == "unstack_block":
            for t in COLORS:
                for bcol in COLORS:
                    if t != bcol and oz._stacked_on(self._block(t), self._block(bcol)):
                        top = self._block(t)
                        spot = self._free_table_spot()
                        return [("move", [top[0], top[1], top[2] + 0.15]),
                                ("grip", 1, 1), ("move", top), ("grip", -1, 2),
                                ("move", [top[0], top[1], 0.60]),
                                ("move", [spot[0], spot[1], 0.60]),
                                ("move", [spot[0], spot[1], 0.48]), ("grip", 1, 2),
                                ("move", [spot[0], spot[1], 0.60])]
            raise InfeasibleTask("unstack_block: nothing stacked")

        raise KeyError(task)

    # ------------------------------------------------------------------ #
    def _block(self, color: str) -> np.ndarray:
        i = COLORS.index(color)
        return self.env.scene_obs[6 + 6 * i : 9 + 6 * i].copy()

    def _held_color(self) -> Optional[str]:
        return getattr(self.env, "_held", None)

    def _on_table_block(self) -> np.ndarray:
        for c in COLORS:
            b = self._block(c)
            if oz._on_table(b):
                return b
        raise InfeasibleTask("no block on the table")

    def _free_table_spot(self) -> np.ndarray:
        others = [self._block(c)[:2] for c in COLORS]
        for x in (-0.10, 0.14, -0.20, 0.26):
            spot = np.array([x, -0.16])
            if all(np.linalg.norm(spot - o) > 0.09 for o in others):
                return spot
        return np.array([-0.10, -0.22])
