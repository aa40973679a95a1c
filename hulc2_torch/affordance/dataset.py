"""Affordance labelled dataset: (frame, target pixel, depth, instruction)
(``hulc2_tpu/affordance/dataset.py:32-131``).

The on-disk layout that ``affordance/dataset_creation.py`` writes:

    <data_dir>/episodes_split.json       {"training": {ep: {"static_cam": [...]}},
                                          "validation": {...},
                                          "norm_values": {"depth": {"static_cam":
                                              {"mean": m, "std": s}}}}
    <data_dir>/<ep>/data/<cam>_cam/<file>.npz
        frame (H, W, 3) uint8, centers (N, 3) [label, row, col],
        depth float, lang_ann str, tcp_pos_world_frame

Items carry the raw uint8 frame (resized on the device in the train step) and
the pixel label at the training resolution; with ``label_type="mask"`` also a
float32 binary mask at the training resolution: the npz's ``mask``, or a
disc of radius H // 20 around the labelled pixel, resized nearest.
``jitter_label_and_image`` is the RandomShift that moves the image and its
pixel label together, ``jitter_mask_and_image`` the same with the mask as a
fourth channel (thresholded at 0.5 after the crop); their offsets are an
input.
"""
from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from hulc2_torch.affordance.depth_heads import DepthNorm

logger = logging.getLogger(__name__)


def resize_pixel(pixel, old_shape, new_shape) -> np.ndarray:
    """Map a (row, col) label between resolutions."""
    c = np.asarray(new_shape, np.float64) / np.asarray(old_shape, np.float64)
    return (np.asarray(pixel) * c).astype(np.int64)


class AffordanceDataset:
    def __init__(self, data_dir, split: str = "training", cam: str = "static",
                 img_resize: int = 224, data_percent: float = 1.0,
                 episodes_file: str = "episodes_split.json",
                 lang_embedder: Optional[Callable[[str], np.ndarray]] = None,
                 label_type: str = "pixel"):
        """``lang_embedder`` maps an annotation to the model's language input
        (token ids for the token-tower detector, a sentence embedding
        otherwise); without it items carry the annotation string under
        ``lang_ann``. ``label_type`` is ``pixel`` or ``mask``."""
        if label_type not in ("pixel", "mask"):
            raise ValueError(f"label_type {label_type!r}: pixel or mask")
        self.label_type = label_type
        self.data_dir = Path(data_dir)
        self.split = split
        self.cam = cam
        self.img_resize = img_resize
        self.lang_embedder = lang_embedder
        info = json.loads((self.data_dir / episodes_file).read_text())
        norm = info["norm_values"]["depth"][f"{cam}_cam"]
        self.depth_norm = DepthNorm(float(norm["mean"]), float(norm["std"]))
        files: List[str] = []
        for ep, content in info[split].items():
            files.extend(f"{ep}/{f}" for f in content[f"{cam}_cam"])
        if split == "training" and data_percent < 1.0:
            files = files[: max(1, int(len(files) * data_percent))]
        self.files = files
        logger.info("%s: %d affordance frames", split, len(files))

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        ep, filename = self.files[idx].rsplit("/", 1)
        path = self.data_dir / ep / "data" / f"{self.cam}_cam" / f"{filename}.npz"
        with np.load(path, allow_pickle=True) as z:
            frame = z["frame"]
            centers = z["centers"]
            depth = float(z["depth"]) if "depth" in z.files else 0.0
            lang_ann = str(z["lang_ann"]) if "lang_ann" in z.files else ""
            stored_mask = np.asarray(z["mask"], np.float32) if "mask" in z.files else None
        px = resize_pixel(centers[0, 1:], frame.shape[:2], (self.img_resize, self.img_resize))
        out = {
            "frame": frame,
            "px": px.astype(np.int32),
            "depth": np.float32(depth),
            "normalized_depth": np.float32(self.depth_norm.normalize(depth)),
            "idx": np.int64(idx),
        }
        if self.label_type == "mask":
            out["mask"] = self._mask(stored_mask, frame.shape[:2], centers[0, 1:])
        if self.lang_embedder is not None:
            lang = np.asarray(self.lang_embedder(lang_ann))
            out["lang"] = lang if np.issubdtype(lang.dtype, np.integer) else lang.astype(np.float32)
        else:
            out["lang_ann"] = lang_ann
        return out


    def _mask(self, stored: Optional[np.ndarray], hw, center) -> np.ndarray:
        """The stored mask, or a disc of radius H // 20 around ``center`` (row,
        col), resized nearest to ``img_resize``."""
        mask = stored
        if mask is None:
            mask = np.zeros(hw, np.float32)
            yy, xx = np.ogrid[: hw[0], : hw[1]]
            r, c = center
            mask[(yy - r) ** 2 + (xx - c) ** 2 <= (hw[0] // 20) ** 2] = 1.0
        n = self.img_resize
        if mask.shape != (n, n):
            rows = (np.arange(n) * mask.shape[0] / n).astype(int)
            cols = (np.arange(n) * mask.shape[1] / n).astype(int)
            mask = mask[np.ix_(rows, cols)]
        return mask


def _moved(px, offsets, pad: int, h: int, w: int):
    import torch

    moved = px + pad - offsets.to(px.dtype)
    return torch.stack([moved[:, 0].clamp(0, h - 1), moved[:, 1].clamp(0, w - 1)], dim=-1)


def jitter_label_and_image(imgs, px, offsets, pad: int):
    """imgs (B, H, W, C), px (B, 2) (row, col) and offsets (B, 2) in [0, 2 pad]
    -> the edge-clamped crop of each image by its offsets (a clamped-index
    gather) and the label moved with it, clamped into the image."""
    from hulc2_torch.ops.preprocess import shift_from_offsets

    _, h, w, _ = imgs.shape
    return shift_from_offsets(offsets, imgs, pad), _moved(px, offsets, pad, h, w)


def jitter_mask_and_image(imgs, mask, px, offsets, pad: int):
    """``jitter_label_and_image`` with the (B, H, W) mask riding along as a
    fourth channel through the same crop -> (images, the mask thresholded at
    0.5 in the mask's dtype, the moved label)."""
    import torch

    from hulc2_torch.ops.preprocess import shift_from_offsets

    _, h, w, _ = imgs.shape
    stacked = torch.cat([imgs, mask[..., None].to(imgs.dtype)], dim=-1)
    shifted = shift_from_offsets(offsets, stacked, pad)
    return (shifted[..., :-1], (shifted[..., -1] > 0.5).to(mask.dtype),
            _moved(px, offsets, pad, h, w))
