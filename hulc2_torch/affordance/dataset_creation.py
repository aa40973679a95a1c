"""Affordance label mining: play data -> labelled (frame, pixel, depth, instruction)
(``hulc2_tpu/affordance/dataset_creation.py:48-208``).

    python -m hulc2_torch.affordance.dataset_creation DATASET --out-dir AFF_DATA \\
        [--cam-params cam.json] [--canonical-lang] [--holdout-paraphrases K]

Replays a dataset's recorded frames (the layout ``python -m
hulc2_torch.tools.make_expert_dataset`` writes), finds the gripper's
open->close events, projects the TCP's world position at each event into the
static camera of the ``HIST_FRAMES`` frames before it (so a label teaches
where to go, not where the arm is), attaches the annotation of the task the
scene-obs oracle sees completed around the event, and writes one npz per
labelled frame plus ``episodes_split.json`` with the depth statistics.
Without ``--cam-params`` the camera is the fake env's static camera at the
dataset's frame size. Numpy only. Given a simulator (``mine_labels(env=...)``,
a calvin_env env with its ``robot``), each event is kept only when pybullet
reports a contact of the robot after a reset to the event's recorded state
(``contact_verified``; pybullet is imported only then); without one, the
gripper signal is taken as the contact.

One fault of the original is repaired: it names a label's episode dir
``episode_XX`` in both splits, and the splits' frame ids both start at 0, so
validation labels overwrote training labels of the same name (and training
read them). Episodes of other splits than training are named
``<split>_episode_XX`` here.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from hulc2_torch.data.episode_index import load_ep_start_end_ids
from hulc2_torch.data.frame_store import NpzFrameStore
from hulc2_torch.envs.camera import PinholeCamera
from hulc2_torch.envs.task_oracle import SceneObsTaskOracle
from hulc2_torch.evaluation.tasks import TASK_NAMES
from hulc2_torch.tools.annotations import sample_annotation

logger = logging.getLogger(__name__)

GRIPPER_CLOSED = -1.0
HIST_FRAMES = 8  # how many past frames receive each interaction label


def detect_interactions(gripper_actions: np.ndarray) -> List[int]:
    """Frame indices of open->close transitions (grasp starts)."""
    g = np.sign(np.asarray(gripper_actions))
    return [int(i) for i in np.where((g[1:] == GRIPPER_CLOSED) & (g[:-1] != GRIPPER_CLOSED))[0] + 1]


def contact_verified(frame: Dict, env=None) -> bool:
    """Whether the robot touches something in ``frame``'s recorded state:
    ``env`` is reset to it and pybullet's contact points are searched for the
    robot's body (reference: data_labeler_lang.py:28-44). Without a
    simulator the gripper-closure signal is accepted."""
    if env is None:
        return True
    import pybullet as p  # type: ignore

    env.reset(robot_obs=frame["robot_obs"], scene_obs=frame["scene_obs"])
    pts = np.array(p.getContactPoints())
    return len(pts) > 0 and bool((pts[:, 1] == env.robot.robot_uid).any())


def mine_labels(data_dir, out_dir, camera: PinholeCamera, split: str = "training",
                hist_frames: int = HIST_FRAMES, lang_window: int = 32, env=None, seed: int = 0,
                canonical_lang: bool = False, holdout_k: int = 0) -> Dict:
    """Labelled static-camera frames of one split, written under ``out_dir``;
    returns {"episodes": {ep: [file, ...]}, "depths": [...]}. With ``env``,
    an event whose contact ``contact_verified`` does not find is dropped."""
    data_dir, out_dir = Path(data_dir), Path(out_dir)
    store = NpzFrameStore(data_dir, ["rgb_static", "robot_obs", "scene_obs"])
    ep_ids = load_ep_start_end_ids(data_dir, split)
    oracle = SceneObsTaskOracle()
    rng = np.random.default_rng(seed)

    episodes: Dict[str, List[str]] = defaultdict(list)
    depths: List[float] = []
    for ep_i, (start, end) in enumerate(ep_ids):
        frames = [store.load_frame(i) for i in range(int(start), int(end) + 1)]
        grip = np.array([f["robot_obs"][-1] for f in frames])
        for t in detect_interactions(grip):
            if not contact_verified(frames[t], env):
                continue
            tcp_world = np.asarray(frames[t]["robot_obs"][:3], np.float64)
            # the task the oracle sees completed around the interaction
            t_end = min(t + lang_window, len(frames) - 1)
            done = oracle.get_task_info_for_set({"scene_obs": frames[max(t - 4, 0)]["scene_obs"]},
                                                {"scene_obs": frames[t_end]["scene_obs"]},
                                                TASK_NAMES)
            lang_ann = (sample_annotation(sorted(done)[0], rng, validation=canonical_lang,
                                          holdout_k=holdout_k) if done else "")
            for k in range(max(t - hist_frames, 0), t):
                fk = frames[k]
                uv = camera.project(tcp_world)
                u, v = int(round(uv[0])), int(round(uv[1]))
                h, w = fk["rgb_static"].shape[:2]
                if not (0 <= u < w and 0 <= v < h):
                    continue
                depth = float((camera.T_cam_world @ np.append(tcp_world, 1.0))[2])
                ep_name = f"episode_{ep_i:02d}" if split == "training" else f"{split}_episode_{ep_i:02d}"
                fname = f"frame_{int(start) + k:07d}"
                fdir = out_dir / ep_name / "data" / "static_cam"
                fdir.mkdir(parents=True, exist_ok=True)
                np.savez(fdir / f"{fname}.npz", frame=fk["rgb_static"], centers=np.array([[0, v, u]]),
                         depth=np.float32(depth), lang_ann=lang_ann, tcp_pos_world_frame=tcp_world)
                episodes[ep_name].append(fname)
                depths.append(depth)
    logger.info("%s: mined %d labels from %d episodes", split, len(depths), len(ep_ids))
    return {"episodes": dict(episodes), "depths": depths}


def create_split_file(out_dir, mined: Dict[str, Dict], val_fraction: float = 0.1) -> Dict:
    """Write ``episodes_split.json`` with the depth normalization values. With
    no validation split mined, the last training episodes become one (never
    all of them)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    info: Dict = {"training": {}, "validation": {}}
    all_depths: List[float] = []
    for split, data in mined.items():
        for ep, files in data["episodes"].items():
            info[split][ep] = {"static_cam": files}
        all_depths.extend(data["depths"])
    if not info["validation"] and len(info["training"]) > 1:
        eps = sorted(info["training"])
        n_val = min(max(1, int(len(eps) * val_fraction)), len(eps) - 1)
        for ep in eps[-n_val:]:
            info["validation"][ep] = info["training"].pop(ep)
    d = np.asarray(all_depths) if all_depths else np.asarray([0.0, 1.0])
    info["norm_values"] = {
        "depth": {"static_cam": {"mean": float(d.mean()), "std": float(max(d.std(), 1e-6))}}
    }
    (out_dir / "episodes_split.json").write_text(json.dumps(info, indent=1))
    return info


def dataset_camera(data_dir: Path) -> Optional[PinholeCamera]:
    """The fake env's static camera at the size of the dataset's frames (its
    intrinsics scale with the frame size), or None without frames."""
    from hulc2_torch.envs.fake_env import FakeCalvinEnv

    for split in ("training", "validation"):
        d = data_dir / split
        frames = sorted(d.glob("episode_*.npz")) if d.is_dir() else []
        if frames:
            with np.load(frames[0]) as z:
                hw = int(z["rgb_static"].shape[0])
            cam = FakeCalvinEnv(static_hw=hw, gripper_hw=hw).cameras[0]
            logger.info("camera derived from %dpx dataset frames: fx=%.1f", hw, cam.K[0, 0])
            return cam
    return None


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("data_dir", help="play dataset root (training/ + validation/)")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--cam-params", default=None,
                   help="json with width, height, fx, fy, cx, cy, T_world_cam")
    p.add_argument("--canonical-lang", action="store_true",
                   help="pin labels to each task's canonical phrasing")
    p.add_argument("--holdout-paraphrases", type=int, default=0,
                   help="leave the last K paraphrases of each task out of the labels")
    args = p.parse_args(argv)
    data_dir = Path(args.data_dir)
    if args.cam_params:
        cam = PinholeCamera.from_params(**json.loads(Path(args.cam_params).read_text()))
    else:
        cam = dataset_camera(data_dir) or PinholeCamera.from_params(200, 200, 200.0, 200.0,
                                                                    100.0, 100.0)
    mined = {split: mine_labels(data_dir / split, args.out_dir, cam, split,
                                canonical_lang=args.canonical_lang,
                                holdout_k=args.holdout_paraphrases)
             for split in ("training", "validation") if (data_dir / split).is_dir()}
    return create_split_file(args.out_dir, mined)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    main(sys.argv[1:])
