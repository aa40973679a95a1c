"""Deproject and move-to sanity check.

The port's copy of ``hulc2_tpu/affordance/test_move_to_pt.py:26-74``
(reference: hulc2/affordance/test_move_to_pt.py): deproject a pixel at a
depth through the camera model to a world point, drive the agent's staged
``move_to`` there in the fake env, and report the final TCP position error.
It checks the camera convention, the project/deproject round trip and the
motion primitive end to end, without a learned model. Host only.

    python -m hulc2_torch.affordance.test_move_to_pt [--px 120 90] [--depth 1.7] [--max-err 0.02]
"""
from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

logger = logging.getLogger(__name__)


def default_static_camera(hw: int = 200):
    """A CALVIN-like static camera above the table, looking down (rot_x(pi)
    turns the optical axis to world -z)."""
    from hulc2_torch.envs.camera import PinholeCamera

    T = np.eye(4)
    T[:3, :3] = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float64)
    T[:3, 3] = [0.0, 0.0, 2.2]
    return PinholeCamera.from_params(hw, hw, fx=hw * 1.2, fy=hw * 1.2,
                                     cx=hw / 2, cy=hw / 2, T_world_cam=T)


def run(px=(100, 100), depth: float = 1.7, max_err: float = 0.02, env=None, camera=None):
    """(final TCP error in meters, whether it is within ``max_err``)."""
    from hulc2_torch.agents.base_agent import BaseAgent
    from hulc2_torch.envs.fake_env import FakeCalvinEnv

    env = env or FakeCalvinEnv()
    env.reset()
    camera = camera or default_static_camera()

    target = camera.deproject_single_depth(px, depth)
    roundtrip = camera.project(target)
    logger.info("pixel %s + depth %.3f -> world %s (reproject %s)",
                tuple(px), depth, np.round(target, 4), np.round(roundtrip, 2))
    if not np.allclose(roundtrip, np.asarray(px, np.float64), atol=1e-6):
        raise AssertionError("project(deproject(px)) must round-trip")

    BaseAgent(env).move_to(target)
    tcp_pos = env.get_info()["robot_obs"][:3]
    err = float(np.linalg.norm(tcp_pos - target))
    logger.info("final TCP %s, target %s, err %.4f m", np.round(tcp_pos, 4),
                np.round(target, 4), err)
    return err, err <= max_err


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--px", type=int, nargs=2, default=(100, 100))
    p.add_argument("--depth", type=float, default=1.7)
    p.add_argument("--max-err", type=float, default=0.02)
    args = p.parse_args(argv)
    err, ok = run(tuple(args.px), args.depth, args.max_err)
    print(f"move_to_pt: err={err:.4f} m -> {'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    sys.exit(main(sys.argv[1:]))
