"""Host-side image helpers for the viewers and the affordance preview.

The port's copy of ``hulc2_tpu/utils/img_utils.py`` (reference roles:
hulc2/utils/img_utils.py add_img_text :66, blend_imgs, resize_pixel :200):
numpy and cv2, pixel for pixel the JAX package's images. cv2 and matplotlib
are imported inside the functions that draw.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from hulc2_torch.affordance.dataset import resize_pixel

__all__ = ["resize_pixel", "add_img_text", "blend_imgs", "heatmap_overlay", "draw_marker",
           "unnormalize_image"]


def add_img_text(img: np.ndarray, text: str, bottom: bool = True) -> np.ndarray:
    """Append a black caption bar of 36 rows with the text centred."""
    import cv2

    h, w = img.shape[:2]
    bar = np.zeros((36, w, 3), img.dtype)
    scale = max(0.4, 0.5 * w / 300)
    (tw, th), _ = cv2.getTextSize(text, cv2.FONT_HERSHEY_DUPLEX, scale, 1)
    val = 1.0 if img.dtype in (np.float32, np.float64) else 255
    cv2.putText(bar, text, ((w - tw) // 2, (36 + th) // 2), cv2.FONT_HERSHEY_DUPLEX,
                scale, (val, val, val), 1, cv2.LINE_AA)
    return np.vstack([img, bar] if bottom else [bar, img])


def blend_imgs(base: np.ndarray, overlay: np.ndarray, alpha: float = 0.8) -> np.ndarray:
    base = base.astype(np.float32)
    overlay = overlay.astype(np.float32)
    return (base * (1 - alpha) + overlay * alpha).astype(np.uint8)


def heatmap_overlay(img_uint8: np.ndarray, heat: np.ndarray, alpha: float = 0.7) -> np.ndarray:
    """Blend a (H', W') probability map, coloured with viridis and resized to
    the image, onto the image."""
    import cv2
    import matplotlib

    cm = matplotlib.colormaps["viridis"]
    h = heat / max(float(heat.max()), 1e-9)
    colored = (cm(h)[..., :3] * 255).astype(np.uint8)
    colored = cv2.resize(colored, img_uint8.shape[:2][::-1])
    return blend_imgs(img_uint8, colored, alpha)


def draw_marker(img: np.ndarray, pixel_xy: Tuple[int, int], size: int = 12) -> np.ndarray:
    """A black cross at (x, y) on a copy of the image."""
    import cv2

    out = img.copy()
    cv2.drawMarker(out, (int(pixel_xy[0]), int(pixel_xy[1])), (0, 0, 0),
                   markerType=cv2.MARKER_CROSS, markerSize=size, thickness=2,
                   line_type=cv2.LINE_AA)
    return out


def unnormalize_image(t: np.ndarray, mean: float = 0.5, std: float = 0.5) -> np.ndarray:
    """Normalised float image -> uint8."""
    return np.clip((t * std + mean) * 255, 0, 255).astype(np.uint8)
