"""The FLOPs a frame of a frozen image trunk, for ``vision.frozen_trunk_mfu``.

The trunk is the one the cells that list the metric configure: each cell's
camera encoder whose config sets ``freeze_backbone``, built by the
reference (``reference/port/models/build.build_camera_encoder``) for the
camera's side after the train transform (224 for the ``clip`` preset's
static camera) on the meta device, and its ``embed`` (the trunk, under
``no_grad``) counted over one frame (``counts.count_flops``: products
only). The cells must agree on one such trunk; where they do not, or a
cell has none or two, there is no count.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from portbench.harness import counts, spec

ROOT = spec.HERE.parent


def trunk_flops(encoder_cfg: dict, side: int) -> int:
    """FLOPs of the reference encoder's trunk on one frame of ``side``."""
    from portbench.reference.port.models.build import build_camera_encoder

    with torch.device("meta"):
        encoder = build_camera_encoder(encoder_cfg, side)
    x = torch.empty(1, 3, side, side, device="meta")
    return counts.count_flops(lambda: encoder.embed(x), "meta")["flops"]


def frozen_trunk(cfg: dict) -> Optional[tuple]:
    """(the camera's encoder config, the camera's side) of the one camera
    of the run config ``cfg`` whose encoder freezes its trunk, or None."""
    from portbench.reference.port.data.device_transforms import camera_sizes

    cameras = [(cam, enc) for cam, enc in cfg["model"]["perceptual_encoder"].items()
               if isinstance(enc, dict) and enc.get("freeze_backbone")]
    if len(cameras) != 1:
        return None
    cam, enc = cameras[0]
    return enc, camera_sizes(cfg["datamodule"]["transforms"])[cam]


@functools.lru_cache(maxsize=None)
def flops_per_frame(metric: str) -> Optional[int]:
    """FLOPs a frame of the frozen trunk of the cells that list ``metric``
    in ``BENCHMARK.json``, or None."""
    bench = spec.load_benchmark(ROOT)
    entry = next((m for m in bench.get("per_layer", []) if m["name"] == metric), None)
    if entry is None or not entry.get("workloads"):
        return None
    trunks = [frozen_trunk(spec.load_cell(bench, name)["config"]["config"])
              for name in entry["workloads"]]
    if None in trunks or any(t != trunks[0] for t in trunks):
        return None
    return trunk_flops(*trunks[0])
