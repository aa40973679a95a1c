"""Real-robot teleop recordings -> per-frame training npz (numpy only).

    python -m hulc2_torch.tools.preprocess_real_data REC_DIR... --out-dir OUT
        [--low-freq-factor 2]

The port's copy of ``hulc2_tpu/tools/preprocess_real_data.py`` (reference:
hulc2/utils/preprocess_real_data.py:40-170): raw robot_io frames
(``frame_XXXX.npz`` with the TCP pose, gripper, joint positions and cameras)
become ``episode_XXXXXXX.npz`` frames with the world-frame relative action
between consecutive frames, scaled by the largest per-step displacement a
relative action of 1 stands for at 15 Hz (``MAX_REL_POS``, ``MAX_REL_ORN``)
and clipped, and the 15-d robot_obs; ``render_low_freq`` keeps every
``factor``-th frame and sums the motions in between (30 Hz -> 15 Hz). The
real-robot wrapper (``envs/panda_wrapper.py``) uses the constants,
``quat_to_euler_xyz`` and ``build_robot_obs``.
"""
from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Dict, List

import numpy as np

logger = logging.getLogger(__name__)

MAX_REL_POS = 0.02  # meters per 15Hz step
MAX_REL_ORN = 0.05  # radians per 15Hz step


def quat_to_euler_xyz(q: np.ndarray) -> np.ndarray:
    """(x, y, z, w) quaternion -> XYZ euler (matching scipy 'XYZ' intrinsic)."""
    x, y, z, w = q
    m = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    b = np.arcsin(np.clip(m[0, 2], -1, 1))
    a = np.arctan2(-m[1, 2], m[2, 2])
    c = np.arctan2(-m[0, 1], m[0, 0])
    return np.array([a, b, c])


def build_robot_obs(tcp_pos, tcp_orn, gripper_width, joint_positions, gripper_action) -> np.ndarray:
    """[tcp_pos (3), tcp_orn (3), gripper width, joint positions (7), gripper action]."""
    return np.concatenate([tcp_pos, tcp_orn, [gripper_width], joint_positions, [gripper_action]])


def wrap_angle(x):
    return (x + np.pi) % (2 * np.pi) - np.pi


def relative_action(tcp_pos, tcp_orn, next_pos, next_orn, gripper_action) -> np.ndarray:
    """World-frame relative action, scaled to [-1, 1] by the max per-step
    displacement (reference: preprocess_real_data.py:64-76)."""
    rel_pos = (next_pos - tcp_pos) / MAX_REL_POS
    rel_orn = wrap_angle(next_orn - tcp_orn) / MAX_REL_ORN
    return np.concatenate([rel_pos, rel_orn, [gripper_action]])


def frame_from_raw(prev: Dict, cur: Dict) -> Dict[str, np.ndarray]:
    """One training frame from two consecutive raw teleop frames."""
    rs_p, rs_c = prev["robot_state"], cur["robot_state"]
    orn_p = quat_to_euler_xyz(np.asarray(rs_p["tcp_orn"])) if len(rs_p["tcp_orn"]) == 4 else np.asarray(rs_p["tcp_orn"])
    orn_c = quat_to_euler_xyz(np.asarray(rs_c["tcp_orn"])) if len(rs_c["tcp_orn"]) == 4 else np.asarray(rs_c["tcp_orn"])
    gripper_action = float(cur["action"]["motion"][-1])
    rel = relative_action(
        np.asarray(rs_p["tcp_pos"]), orn_p, np.asarray(rs_c["tcp_pos"]), orn_c, gripper_action
    )
    robot_obs = build_robot_obs(
        np.asarray(rs_c["tcp_pos"]), orn_c, rs_c["gripper_opening_width"],
        np.asarray(rs_c["joint_positions"]), gripper_action,
    )
    out = {
        "robot_obs": robot_obs.astype(np.float32),
        "rel_actions": np.clip(rel, -1, 1).astype(np.float32),
        "actions": np.concatenate(
            [rs_c["tcp_pos"], orn_c, [gripper_action]]
        ).astype(np.float32),
    }
    for cam in ("rgb_static", "rgb_gripper", "depth_static", "depth_gripper"):
        if cam in cur:
            out[cam] = cur[cam]
    return out


def render_low_freq(frames: List[Dict], factor: int = 2) -> List[Dict]:
    """30Hz -> 15Hz: keep every ``factor``-th frame, summing relative motions
    so the action still reaches the kept frame's pose."""
    out = []
    for i in range(0, len(frames) - factor + 1, factor):
        f = dict(frames[i + factor - 1])
        rel = sum(np.asarray(frames[i + k]["rel_actions"][:6]) for k in range(factor))
        f["rel_actions"] = np.concatenate(
            [np.clip(rel, -1, 1), frames[i + factor - 1]["rel_actions"][-1:]]
        ).astype(np.float32)
        out.append(f)
    return out


def preprocess_recording(recording_dir, out_dir, start_idx: int = 0, low_freq_factor: int = 0) -> int:
    """Convert a raw recording directory (frame_XXXX.npz with robot_state /
    action / camera keys) into episode_XXXXXXX.npz training frames."""
    recording_dir, out_dir = Path(recording_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    raw_files = sorted(recording_dir.glob("frame_*.npz"))
    frames = []
    for prev_f, cur_f in zip(raw_files[:-1], raw_files[1:]):
        prev = dict(np.load(prev_f, allow_pickle=True))
        cur = dict(np.load(cur_f, allow_pickle=True))
        prev = {k: (v[()] if v.dtype == object else v) for k, v in prev.items()}
        cur = {k: (v[()] if v.dtype == object else v) for k, v in cur.items()}
        frames.append(frame_from_raw(prev, cur))
    if low_freq_factor:
        frames = render_low_freq(frames, low_freq_factor)
    for i, frame in enumerate(frames):
        np.savez(out_dir / f"episode_{start_idx + i:07d}.npz", **frame)
    logger.info("%s: wrote %d frames", recording_dir.name, len(frames))
    return start_idx + len(frames)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("recording_dirs", nargs="+")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--low-freq-factor", type=int, default=0, help="e.g. 2 for 30Hz->15Hz")
    args = p.parse_args(argv)
    idx = 0
    ep_ids = []
    for rec in args.recording_dirs:
        start = idx
        idx = preprocess_recording(rec, args.out_dir, idx, args.low_freq_factor)
        ep_ids.append([start, idx - 1])
    np.save(Path(args.out_dir) / "ep_start_end_ids.npy", np.asarray(ep_ids))


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
