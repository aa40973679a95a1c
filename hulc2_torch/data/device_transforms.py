"""On-device batch transform: raw uint8 windows -> model batch (``data/device_transforms.py``).

The RGB pipelines of two presets are ported: ``rand_shift`` (static 200 px
with pad 10, gripper 84 px with pad 4; ``cfg_low_level``'s) and
``rand_shift_96`` (96 px with pad 4, 64 px with pad 3; the flagship's). Per
RGB camera a size check (the ``resize`` op, which must be a no-op here: the
dataset and the renderer both produce the preset's sizes), then the
RandomShift crop and the scale/normalize, fused into one launch of the
shift_normalize kernel (``ops.preprocess.random_shift_normalize``). Crop offsets, one per frame, come
from the step's generator unless the caller hands them in. The val pipelines
have no crop: their scale/normalize is the same kernel at pad 0 with zero
offsets, which computes exactly ``scale_and_normalize``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from hulc2_torch.data.statistics import DatasetStatistics
from hulc2_torch.ops import preprocess

# the keys of a language window that the model reads as they are
LANG_KEYS = ("lang", "use_for_aux_lang_loss", "lang_task_id")

TRANSFORM_PRESETS = {
    "rand_shift": {
        "train": {
            "rgb_static": [
                {"op": "resize", "size": 200},
                {"op": "random_shift", "pad": 10},
                {"op": "scale_normalize", "mean": [0.5], "std": [0.5]},
            ],
            "rgb_gripper": [
                {"op": "resize", "size": 84},
                {"op": "random_shift", "pad": 4},
                {"op": "scale_normalize", "mean": [0.5], "std": [0.5]},
            ],
        },
        "val": {
            "rgb_static": [
                {"op": "resize", "size": 200},
                {"op": "scale_normalize", "mean": [0.5], "std": [0.5]},
            ],
            "rgb_gripper": [
                {"op": "resize", "size": 84},
                {"op": "scale_normalize", "mean": [0.5], "std": [0.5]},
            ],
        },
    },
    "rand_shift_96": {
        "train": {
            "rgb_static": [
                {"op": "resize", "size": 96},
                {"op": "random_shift", "pad": 4},
                {"op": "scale_normalize", "mean": [0.5], "std": [0.5]},
            ],
            "rgb_gripper": [
                {"op": "resize", "size": 64},
                {"op": "random_shift", "pad": 3},
                {"op": "scale_normalize", "mean": [0.5], "std": [0.5]},
            ],
        },
        "val": {
            "rgb_static": [
                {"op": "resize", "size": 96},
                {"op": "scale_normalize", "mean": [0.5], "std": [0.5]},
            ],
            "rgb_gripper": [
                {"op": "resize", "size": 64},
                {"op": "scale_normalize", "mean": [0.5], "std": [0.5]},
            ],
        },
    },
}


def _fused_ops(pipeline: list) -> tuple:
    """[resize, random_shift, scale_normalize] -> (size, pad, mean, std);
    [resize, scale_normalize] -> (size, None, mean, std)."""
    kinds = [op["op"] for op in pipeline]
    if kinds == ["resize", "random_shift", "scale_normalize"]:
        size, shift, norm = pipeline
        return size["size"], shift["pad"], norm["mean"], norm["std"]
    if kinds == ["resize", "scale_normalize"]:
        size, norm = pipeline
        return size["size"], None, norm["mean"], norm["std"]
    raise NotImplementedError(f"transform pipeline {kinds} is not ported")


def camera_sizes(transforms_name: str = "rand_shift_96") -> Dict[str, int]:
    """Image size per RGB camera that the preset expects."""
    train = TRANSFORM_PRESETS[transforms_name]["train"]
    return {cam: _fused_ops(ops)[0] for cam, ops in train.items()}


def draw_offsets(n: int, pad: int, generator: torch.Generator, device) -> torch.Tensor:
    """(n, 2) int32 crop offsets, uniform in [0, 2 pad]^2."""
    return torch.randint(0, 2 * pad + 1, (n, 2), generator=generator, device=device,
                         dtype=torch.int32)


def _robot_obs_stats(stats: DatasetStatistics, device: torch.device, cache: Optional[Dict]):
    """(mean, std) of robot_obs as fp32 tensors on ``device``. ``cache`` maps
    a device to the pair already copied there; the batch transform keeps one,
    because a copy from pageable memory on every step would synchronise the
    stream."""
    if cache is None:
        cache = {}
    if device not in cache:
        cache[device] = tuple(torch.as_tensor(np.asarray(a, np.float32)).to(device)
                              for a in (stats.robot_obs_mean, stats.robot_obs_std))
    return cache[device]


def process_proprio(robot_obs_raw: torch.Tensor, proprio_cfg: dict,
                    stats: Optional[DatasetStatistics] = None,
                    cache: Optional[Dict] = None) -> torch.Tensor:
    """Normalize robot_obs with the dataset statistics, then slice it by
    ``keep_indices`` (``device_transforms.py:320-348``): with
    ``normalize_robot_orientation`` false the orientation dims stay raw, with
    ``normalize`` false nothing is normalized. Without statistics (or without
    robot_obs statistics in them) the normalization is the identity.
    ``cache`` (device -> (mean, std) tensors) keeps the statistics' device
    copies between calls. scene_obs is not in the flagship's state_obs and is
    not ported."""
    normed = robot_obs_raw
    if stats is not None and stats.robot_obs_mean is not None:
        mean, std = _robot_obs_stats(stats, robot_obs_raw.device, cache)
        normed = preprocess.normalize_vector(robot_obs_raw, mean, std)
    if (not proprio_cfg.get("normalize_robot_orientation", True)
            and "robot_orientation_idx" in proprio_cfg):
        lo, hi = proprio_cfg["robot_orientation_idx"]
        normed = torch.cat([normed[..., :lo], robot_obs_raw[..., lo:hi], normed[..., hi:]], dim=-1)
    if not proprio_cfg.get("normalize", True):
        normed = robot_obs_raw
    return torch.cat([normed[..., lo:hi] for lo, hi in proprio_cfg["keep_indices"]], dim=-1)


def make_batch_transform(observation_space: dict, proprio_cfg: dict,
                         transforms_name: str = "rand_shift_96",
                         dtype: torch.dtype = torch.float32, train: bool = True,
                         stats: Optional[DatasetStatistics] = None) -> Callable:
    """fn(raw, generator, offsets=None) -> model batch. ``raw`` holds
    (B, S, H, W, C) uint8 frames per camera, ``robot_obs_raw`` and
    ``actions``; ``offsets`` optionally maps each camera to its (B*S, 2)
    int32 crop offsets. Images come out NHWC in ``dtype``; robot_obs is
    normalized with ``stats`` (the split's ``statistics.yaml``); the language
    keys of a lang batch pass through. With ``train=False`` the val pipelines
    run: no crop, no draws."""
    pipelines = TRANSFORM_PRESETS[transforms_name]["train" if train else "val"]
    cams = {cam: _fused_ops(pipelines[cam]) for cam in observation_space["rgb_obs"]}
    if observation_space.get("depth_obs"):
        raise NotImplementedError("depth cameras are not ported")
    if "scene_obs" in observation_space.get("state_obs", ()):
        raise NotImplementedError("scene_obs proprioception is not ported")
    # the val pipelines' zero offsets, made once per (frames, device): a fresh
    # tensor per call would be an allocation and a fill on every dispatch;
    # likewise robot_obs's mean and std, copied once per device
    zero_offsets: Dict = {}
    proprio_stats: Dict = {}

    def no_shift(n: int, device) -> torch.Tensor:
        key = (n, device)
        if key not in zero_offsets:
            zero_offsets[key] = torch.zeros((n, 2), dtype=torch.int32, device=device)
        return zero_offsets[key]

    def transform(raw: Dict[str, torch.Tensor], generator: Optional[torch.Generator],
                  offsets: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
        out: Dict = {"rgb_obs": {}}
        for cam, (size, pad, mean, std) in cams.items():
            imgs = raw[cam]
            b, s, h, w, c = imgs.shape
            if (h, w) != (size, size):
                raise ValueError(f"{cam}: the {transforms_name!r} preset expects {size}x{size} "
                                 f"frames, got {h}x{w} (its resize op is not ported)")
            frames = imgs.reshape(b * s, h, w, c).contiguous()
            if pad is None:
                pad, off = 0, no_shift(b * s, imgs.device)
            else:
                off = (offsets or {}).get(cam)
                if off is None:
                    off = draw_offsets(b * s, pad, generator, imgs.device)
            res = preprocess.random_shift_normalize(frames, off, pad, mean, std, dtype)
            out["rgb_obs"][cam] = res.reshape(b, s, h, w, c)
        out["robot_obs"] = process_proprio(raw["robot_obs_raw"], proprio_cfg, stats, proprio_stats)
        out["robot_obs_raw"] = raw["robot_obs_raw"]
        out["actions"] = raw["actions"]
        for k in LANG_KEYS:
            if k in raw:
                out[k] = raw[k]
        return out

    return transform
