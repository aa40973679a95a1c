"""On-device batch transform: raw uint8 windows -> model batch (``data/device_transforms.py``).

Only the ``rand_shift_96`` pipelines are ported: per RGB camera a size check
(the ``resize`` op, which must be a no-op here), then the RandomShift crop and
the scale/normalize, fused into one launch of the shift_normalize kernel
(``ops.preprocess.random_shift_normalize``). Crop offsets, one per frame, come
from the step's generator unless the caller hands them in. The val pipelines
have no crop: their scale/normalize is the same kernel at pad 0 with zero
offsets, which computes exactly ``scale_and_normalize``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from hulc2_torch.ops import preprocess

TRANSFORM_PRESETS = {
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


def process_proprio(robot_obs_raw: torch.Tensor, proprio_cfg: dict) -> torch.Tensor:
    """Slice the proprioceptive state by ``keep_indices``
    (``device_transforms.py:320``, without scene_obs). The JAX function also
    normalizes with the dataset statistics; synthetic windows have none, and
    without them its normalization is the identity. The statistics come with
    the on-disk datamodule, which is not ported yet."""
    return torch.cat([robot_obs_raw[..., lo:hi] for lo, hi in proprio_cfg["keep_indices"]], dim=-1)


def make_batch_transform(observation_space: dict, proprio_cfg: dict,
                         transforms_name: str = "rand_shift_96",
                         dtype: torch.dtype = torch.float32, train: bool = True) -> Callable:
    """fn(raw, generator, offsets=None) -> model batch. ``raw`` holds
    (B, S, H, W, C) uint8 frames per camera, ``robot_obs_raw`` and
    ``actions``; ``offsets`` optionally maps each camera to its (B*S, 2)
    int32 crop offsets. Images come out NHWC in ``dtype``. With
    ``train=False`` the val pipelines run: no crop, no draws."""
    pipelines = TRANSFORM_PRESETS[transforms_name]["train" if train else "val"]
    cams = {cam: _fused_ops(pipelines[cam]) for cam in observation_space["rgb_obs"]}
    if observation_space.get("depth_obs"):
        raise NotImplementedError("depth cameras are not ported")
    # the val pipelines' zero offsets, made once per (frames, device): a fresh
    # tensor per call would be an allocation and a fill on every dispatch
    zero_offsets: Dict = {}

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
                raise ValueError(f"{cam}: expected {size}x{size} frames, got {h}x{w} "
                                 "(resize is not ported)")
            frames = imgs.reshape(b * s, h, w, c).contiguous()
            if pad is None:
                pad, off = 0, no_shift(b * s, imgs.device)
            else:
                off = (offsets or {}).get(cam)
                if off is None:
                    off = draw_offsets(b * s, pad, generator, imgs.device)
            res = preprocess.random_shift_normalize(frames, off, pad, mean, std, dtype)
            out["rgb_obs"][cam] = res.reshape(b, s, h, w, c)
        out["robot_obs"] = process_proprio(raw["robot_obs_raw"], proprio_cfg)
        out["robot_obs_raw"] = raw["robot_obs_raw"]
        out["actions"] = raw["actions"]
        return out

    return transform
