"""Tiny on-disk datasets in the CALVIN layout for the port's tests (numpy
only, so the card's torch-only tests can use them too).

``write_calvin_dir``: two training episodes and one validation episode of
random frames, language annotations over real task names and one unknown
task, and the generated datasets' ``statistics.yaml``. Built like the fixture
of ``tests/test_device_store.py``. ``write_expert_dir``: a small dataset of
the port's scripted expert, whose scene states the task oracle can read.
"""
from pathlib import Path

import numpy as np

from hulc2_torch.tools.make_expert_dataset import STATS_YAML

SPLITS = {
    "training": {"ranges": [(0, 60), (100, 155)],
                 "ann": [((1, 38), "open_drawer", "pull the drawer open"),
                         ((20, 58), "turn_on_led", "turn on the led"),
                         ((101, 140), "push_button", "push the button")]},
    "validation": {"ranges": [(200, 250)],
                   "ann": [((201, 240), "open_drawer", "open the drawer"),
                           ((205, 248), "turn_on_led", "turn on the led")]},
}


def write_calvin_dir(root: Path, static_hw: int = 16, gripper_hw: int = 16, seed: int = 3) -> Path:
    rng = np.random.default_rng(seed)
    for split, spec in SPLITS.items():
        d = Path(root) / split
        d.mkdir(parents=True)
        np.save(d / "ep_start_end_ids.npy", np.asarray(spec["ranges"]))
        for start, end in spec["ranges"]:
            for i in range(start, end + 1):
                act = np.clip(rng.standard_normal(7) * 0.5, -1, 1).astype(np.float32)
                act[-1] = 1.0 if rng.random() > 0.5 else -1.0
                np.savez(
                    d / f"episode_{i:07d}.npz",
                    rgb_static=rng.integers(0, 256, (static_hw, static_hw, 3), np.uint8),
                    rgb_gripper=rng.integers(0, 256, (gripper_hw, gripper_hw, 3), np.uint8),
                    robot_obs=(rng.standard_normal(15) * 0.3).astype(np.float32),
                    rel_actions=act,
                )
        ann = {
            "language": {"ann": [a[2] for a in spec["ann"]], "task": [a[1] for a in spec["ann"]],
                         "emb": rng.standard_normal((len(spec["ann"]), 1, 32)).astype(np.float32)},
            "info": {"episodes": [], "indx": [a[0] for a in spec["ann"]]},
        }
        (d / "lang_annotations").mkdir()
        np.save(d / "lang_annotations" / "auto_lang_ann.npy", ann, allow_pickle=True)
        (d / "statistics.yaml").write_text(STATS_YAML)
    return Path(root)


def dm_cfg(root, load_lang_embeddings: bool = False, batch_vis: int = 3, batch_lang: int = 2,
           min_window: int = 10, max_window: int = 16, transforms: str = "rand_shift_96") -> dict:
    """A datamodule config over ``write_calvin_dir``'s dataset, in the layout
    of the flagship's ``datamodule`` section."""
    return {
        "root_data_dir": str(root),
        "batch_size_vis": batch_vis,
        "batch_size_lang": batch_lang,
        "min_window_size": min_window,
        "max_window_size": max_window,
        "skip_frames": 1,
        "frame_skip": None,
        "pad": True,
        "lang_folder": "lang_annotations",
        "aux_lang_loss_window": 8,
        "data_percent": 1.0,
        "load_lang_embeddings": load_lang_embeddings,
        "num_workers": 2,
        "device_store": True,
        "loader_isolation": "none",
        "shuffle_val": False,
        "observation_space": {
            "rgb_obs": ["rgb_static", "rgb_gripper"],
            "depth_obs": [],
            "state_obs": ["robot_obs"],
            "actions": ["rel_actions"],
            "language": ["language"],
        },
        "proprioception_dims": {"n_state_obs": 8, "keep_indices": [[0, 7], [14, 15]],
                                "robot_orientation_idx": [3, 6], "normalize": True,
                                "normalize_robot_orientation": True},
        "transforms": transforms,
    }


def host_fused_batches(dm, epoch: int):
    """``device_store.host_fused_batches`` for the training datasets of the
    port's datamodule ``dm``, which must not have uploaded its frames."""
    from hulc2_torch.data.device_store import host_fused_batches as plain

    return plain(dm.datasets["vis_training"], dm.datasets["lang_training"],
                 dm.cfg["batch_size_vis"], dm.cfg["batch_size_lang"], dm.seed, epoch)


# one training episode of 2 tasks and one validation episode of 8, token
# annotations with the held-out paraphrases: the validation split has five
# oracle-detected task windows at the annotator's default window (64 frames)
EXPERT_KW = dict(episodes=1, tasks_per_episode=2, val_episodes=1, val_tasks_per_episode=8,
                 seed=1, lang_tokens=True, holdout_paraphrases=4)


def write_expert_dir(root: Path) -> Path:
    """A small expert dataset from the port's generator (``EXPERT_KW``)."""
    from hulc2_torch.tools.make_expert_dataset import make_expert_dataset

    return Path(make_expert_dataset(root, **EXPERT_KW))
