"""The real-world hierarchical agent.

The port's copy of ``hulc2_tpu/agents/real_world_agent.py:19-48``
(reference: hulc2/agents/real_world_agent.py:19, AffHULCAgent): the
``Hulc2Agent`` with a calibrated static camera (``T_world_cam``
extrinsics) for the affordance deprojection, and the approach's targets
clipped to the robot's workspace.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from hulc2_torch.agents.hulc2_agent import Hulc2Agent
from hulc2_torch.envs.camera import PinholeCamera
from hulc2_torch.envs.panda_wrapper import DEFAULT_WORKSPACE


class RealWorldAgent(Hulc2Agent):
    def __init__(self, *args, static_camera: Optional[PinholeCamera] = None,
                 workspace: Optional[Dict] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.static_camera = static_camera
        self.workspace = workspace or DEFAULT_WORKSPACE

    def _host_camera(self):
        """The calibrated static camera when one was given (the real
        ``PandaLfpWrapper`` has no ``get_camera_params()``), else the env's."""
        if self.static_camera is not None:
            return self.static_camera
        return super()._host_camera()

    def get_aff_pred(self, caption: str):
        """``Hulc2Agent.get_aff_pred`` with the target clipped to the workspace."""
        target, pixel = super().get_aff_pred(caption)
        return np.clip(target, self.workspace["low"], self.workspace["high"]), pixel

    def move_to(self, target_pos, target_orn=None, gripper_action=None):
        target_pos = np.clip(np.asarray(target_pos), self.workspace["low"], self.workspace["high"])
        return super().move_to(target_pos, target_orn, gripper_action)
