"""Playtable geometry shared by the interactive fake env, its renderer, and
the scripted expert.

One source of truth for where every fixture lives in the world frame, sized
to be consistent with the oracle zones in ``envs/task_oracle.py`` and the
state anchors in ``evaluation/initial_states.py`` (which themselves mirror
the reference's CALVIN playtable constants, reference:
hulc2/evaluation/utils.py:147-215). The renderer draws these boxes; the
dynamics use the same positions for contact checks; the expert plans
waypoints against them — so "what you see is what you can touch".

World frame: x lateral (+right), y depth (+back), z up. The static camera
looks straight down from above the table.

The port's copy of ``hulc2_tpu/envs/scene_layout.py``, unchanged but for its imports.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from hulc2_torch.evaluation.initial_states import DRAWER_OPEN, SLIDER_OPEN_LEFT, SWITCH_ON

# ---- table ---------------------------------------------------------------- #
TABLE_Z = 0.4599                      # table top == oracle TABLE_Z
TABLE_X_HALF = 0.38
TABLE_Y = (-0.32, 0.26)               # front / back edge
FLOOR_Z = 0.10                        # where lost blocks land

# ---- blocks ---------------------------------------------------------------- #
BLOCK_HALF = np.array([0.02, 0.02, 0.025])   # half extents; height 5 cm so the
# stack offset (+0.05) used by the oracle's STACK_DZ window lands on the top face
BLOCK_COLORS: Dict[str, np.ndarray] = {
    "red": np.array([0.80, 0.12, 0.12]),
    "blue": np.array([0.15, 0.25, 0.85]),
    "pink": np.array([0.95, 0.45, 0.75]),
}

# ---- slider (cabinet door on the back shelf) ------------------------------- #
# scene_obs[0] in [0, SLIDER_OPEN_LEFT]. perform()/place_in_slider treat
# scene[0] > 0.14 as "LEFT slot reachable", so the door must cover the RIGHT
# slot at scene[0]=0.28 and the LEFT slot at 0: door_x = scene[0] - 0.21.
# (CALVIN's x axis points the other way, hence the "left" task name moving
# the door toward +x here; the protocol semantics are unchanged.)
SHELF_Y = 0.0924                      # block slots' y (initial_states anchors)
SHELF_Z = 0.46099                     # slot resting z (inside oracle SLIDER_ZONE_Z)
SHELF_Y_MIN = 0.03                    # y beyond which the shelf plane applies
DOOR_X0 = -0.21                       # door center at scene[0] == 0
DOOR_HALF = np.array([0.155, 0.008, 0.07])
DOOR_Y = 0.035                        # door plane (in front of the slots)
DOOR_Z = 0.53
HANDLE_OFFSET_X = -0.13               # handle on the door's left edge
HANDLE_HALF = np.array([0.012, 0.012, 0.03])
HANDLE_Z = 0.52
SLIDER_GRIP_R = 0.06                  # EE-to-handle contact radius


def slider_door_x(scene0: float) -> float:
    return DOOR_X0 + float(scene0)


def slider_handle_pos(scene0: float) -> np.ndarray:
    return np.array([slider_door_x(scene0) + HANDLE_OFFSET_X, DOOR_Y, HANDLE_Z])


# ---- drawer ----------------------------------------------------------------- #
# scene_obs[1] in [0, DRAWER_OPEN]; front panel slides toward -y as it opens.
# The cavity floor is below the oracle's DRAWER_ZONE_Z=0.42 so resting blocks
# (z = 0.38) register as _in_drawer.
DRAWER_X = 0.15
DRAWER_X_HALF = 0.12
DRAWER_FRONT_Y0 = -0.33               # front panel y when closed
DRAWER_DEPTH = 0.20                   # cavity span behind the front panel
DRAWER_FLOOR_Z = 0.365
DRAWER_BLOCK_Z = DRAWER_FLOOR_Z + 0.015  # resting block center (== 0.38)
DRAWER_PANEL_HALF = np.array([DRAWER_X_HALF, 0.01, 0.04])
DRAWER_PANEL_Z = 0.40
DRAWER_HANDLE_HALF = np.array([0.03, 0.012, 0.012])
DRAWER_HANDLE_Z = 0.42
DRAWER_GRIP_R = 0.06


def drawer_front_y(scene1: float) -> float:
    return DRAWER_FRONT_Y0 - float(scene1)


def drawer_handle_pos(scene1: float) -> np.ndarray:
    return np.array([DRAWER_X, drawer_front_y(scene1) - 0.02, DRAWER_HANDLE_Z])


def in_drawer_cavity(x: float, y: float, scene1: float) -> bool:
    """Horizontal test: over the pulled-out drawer cavity."""
    fy = drawer_front_y(scene1)
    return bool(abs(x - DRAWER_X) < DRAWER_X_HALF and fy < y < fy + DRAWER_DEPTH)


# ---- LED button ------------------------------------------------------------- #
BUTTON_POS = np.array([-0.12, -0.26, 0.468])  # top face of the button base
BUTTON_PRESS_R = 0.05                 # xy radius for a press
BUTTON_PRESS_Z = 0.486                # EE tip below this == pressed
BUTTON_RELEASE_Z = 0.52               # EE above this re-arms the button
BUTTON_HALF = np.array([0.025, 0.025, 0.008])
LED_HALF = np.array([0.014, 0.014, 0.010])

# ---- lightbulb switch (lever) ------------------------------------------------ #
# scene_obs[3] in [0, SWITCH_ON]; the lever handle rides z = SWITCH_Z0 + scene[3].
SWITCH_X = 0.22
SWITCH_Y = 0.032
SWITCH_Z0 = 0.51
SWITCH_GRIP_R = 0.06
SWITCH_HALF = np.array([0.012, 0.012, 0.02])
LIGHTBULB_POS = np.array([0.22, 0.10, 0.70])  # indicator bulb on a pole
LIGHTBULB_HALF = np.array([0.03, 0.03, 0.03])


def switch_lever_pos(scene3: float) -> np.ndarray:
    return np.array([SWITCH_X, SWITCH_Y, SWITCH_Z0 + float(scene3)])


# ---- end effector ------------------------------------------------------------ #
EE_FINGER_HALF = np.array([0.007, 0.007, 0.035])
EE_FINGER_GAP_OPEN = 0.055            # finger separation (open / closed)
EE_FINGER_GAP_CLOSED = 0.018
EE_WRIST_HALF = np.array([0.02, 0.02, 0.03])
EE_WRIST_LIFT = 0.085                 # wrist box sits above the TCP
GRASP_R = 0.05                        # block within this of the TCP can be grasped
PUSH_R = 0.05                         # horizontal contact radius for pushing
PUSH_Z_MARGIN = 0.03                  # EE counts as "low" within block_z + margin

# EE z clamps (the "physics" floor): fingers can reach block-center height over
# the table, deeper over the open drawer cavity, anywhere off the table
EE_MIN_Z_TABLE = 0.452
EE_MIN_Z_DRAWER = 0.372
EE_MIN_Z_FREE = 0.30
WORKSPACE_X = (-0.45, 0.45)
WORKSPACE_Y = (-0.60, 0.24)
WORKSPACE_Z_MAX = 1.00

# integration scales (flat 7-d relative action -> state delta, matching the
# CALVIN rel-action convention the datasets store)
POS_STEP = 0.02
ORN_STEP = 0.05

# ---- colors (renderer) -------------------------------------------------------- #
COLOR_TABLE = np.array([0.55, 0.52, 0.48])
COLOR_SHELF = np.array([0.42, 0.38, 0.34])
COLOR_DOOR = np.array([0.25, 0.45, 0.50])
COLOR_HANDLE = np.array([0.10, 0.10, 0.12])
COLOR_DRAWER = np.array([0.48, 0.34, 0.22])
COLOR_BUTTON = np.array([0.30, 0.05, 0.05])
COLOR_LED_ON = np.array([0.10, 0.95, 0.20])
COLOR_LED_OFF = np.array([0.05, 0.25, 0.08])
COLOR_SWITCH = np.array([0.15, 0.15, 0.18])
COLOR_BULB_ON = np.array([1.00, 0.90, 0.25])
COLOR_BULB_OFF = np.array([0.35, 0.34, 0.30])
COLOR_EE = np.array([0.12, 0.12, 0.15])
COLOR_BG = np.array([0.72, 0.74, 0.78])
