"""Symbolic initial condition -> concrete CALVIN env state vectors.

Behavior-identical to the reference mapping
(reference: hulc2/evaluation/utils.py:147-215): the same fixed neutral
15-d robot state, the same block slot coordinates, and the same
FNV1-32-seeded per-condition randomization (table-slot shuffle + block yaw
draws) so env resets are bit-reproducible across frameworks.

scene_obs layout (24,): [slider, drawer, button, switch(lightbulb lever),
lightbulb, led, red_block(x,y,z,rx,ry,rz), blue_block(6), pink_block(6)].

The port's copy of ``hulc2_tpu/evaluation/initial_states.py``, unchanged but for its imports.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from hulc2_torch.evaluation.sequences import temp_seed
from hulc2_torch.ops.fnv import fnv1_32

NEUTRAL_ROBOT_OBS = np.array(
    [
        0.02586889, -0.2313129, 0.5712808,
        3.09045411, -0.02908596, 1.50013585,
        0.07999963,
        -1.21779124, 1.03987629, 2.11978254, -2.34205014, -0.87015899, 1.64119093,
        0.55344928,
        1.0,
    ]
)

BLOCK_SLIDER_LEFT = np.array([-2.40851662e-01, 9.24044687e-02, 4.60990009e-01])
BLOCK_SLIDER_RIGHT = np.array([7.03416330e-02, 9.24044687e-02, 4.60990009e-01])
BLOCK_TABLE_SLOTS = [
    np.array([5.00000896e-02, -1.20000177e-01, 4.59990009e-01]),
    np.array([2.29995412e-01, -1.19995140e-01, 4.59990010e-01]),
]
BLOCK_YAW_RANGE = (np.pi / 2 - np.pi / 8, np.pi / 2 + np.pi / 8)

SLIDER_OPEN_LEFT = 0.28
DRAWER_OPEN = 0.22
SWITCH_ON = 0.088


def initial_condition_seed(initial_condition: Dict) -> int:
    """The reference hashes ``str(dict.values())`` — a dict_values repr like
    "dict_values([0, 1, 'right', ...])" — with FNV1-32 (utils.py:175)."""
    return fnv1_32(str(initial_condition.values()).encode())


def get_env_state_for_initial_condition(initial_condition: Dict) -> Tuple[np.ndarray, np.ndarray]:
    if "robot_obs" in initial_condition:
        # explicit recorded state (dataset-derived single-step protocol —
        # reference evaluate_policy_singlestep.py:40 resets from the
        # validation episode's state_info instead of a sampled condition)
        return (np.asarray(initial_condition["robot_obs"], np.float64),
                np.asarray(initial_condition["scene_obs"], np.float64))
    table = [s.copy() for s in BLOCK_TABLE_SLOTS]
    with temp_seed(initial_condition_seed(initial_condition)):
        np.random.shuffle(table)

        scene = np.zeros(24)
        if initial_condition["slider"] == "left":
            scene[0] = SLIDER_OPEN_LEFT
        if initial_condition["drawer"] == "open":
            scene[1] = DRAWER_OPEN
        if initial_condition["lightbulb"] == 1:
            scene[3] = SWITCH_ON
        scene[4] = initial_condition["lightbulb"]
        scene[5] = initial_condition["led"]

        def place(slot_name, fallback):
            if slot_name == "slider_right":
                return BLOCK_SLIDER_RIGHT
            if slot_name == "slider_left":
                return BLOCK_SLIDER_LEFT
            return fallback

        scene[6:9] = place(initial_condition["red_block"], table[0])
        scene[11] = np.random.uniform(*BLOCK_YAW_RANGE)
        # the reference keys the blue block's table slot off where the *red*
        # block went (utils.py:201-204) — preserved verbatim for parity
        blue_fallback = table[1] if initial_condition["red_block"] == "table" else table[0]
        scene[12:15] = place(initial_condition["blue_block"], blue_fallback)
        scene[17] = np.random.uniform(*BLOCK_YAW_RANGE)
        scene[18:21] = place(initial_condition["pink_block"], table[1])
        scene[23] = np.random.uniform(*BLOCK_YAW_RANGE)

    return NEUTRAL_ROBOT_OBS.copy(), scene
