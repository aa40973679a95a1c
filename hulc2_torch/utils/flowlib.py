"""Optical-flow colour coding with the Middlebury colour wheel.

The port's copy of ``hulc2_tpu/utils/flowlib.py`` (reference:
hulc2/affordance/utils/flowlib.py): a 2-D vector field becomes an RGB image
whose hue is the direction and whose saturation is the magnitude. numpy only.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def make_color_wheel() -> np.ndarray:
    """(55, 3) RGB colour wheel in six segments: RY, YG, GC, CB, BM, MR."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((ry + yg + gc + cb + bm + mr, 3))
    col = 0
    segs = [
        (ry, [255, None, 0], lambda i, n: 255 * i / n),          # R->Y: G ramps up
        (yg, [None, 255, 0], lambda i, n: 255 - 255 * i / n),    # Y->G: R ramps down
        (gc, [0, 255, None], lambda i, n: 255 * i / n),          # G->C: B ramps up
        (cb, [0, None, 255], lambda i, n: 255 - 255 * i / n),    # C->B: G ramps down
        (bm, [None, 0, 255], lambda i, n: 255 * i / n),          # B->M: R ramps up
        (mr, [255, 0, None], lambda i, n: 255 - 255 * i / n),    # M->R: B ramps down
    ]
    for n, base, ramp in segs:
        i = np.arange(n)
        for ch, v in enumerate(base):
            wheel[col: col + n, ch] = ramp(i, n) if v is None else v
        col += n
    return wheel


_WHEEL = make_color_wheel()


def flow_to_color(flow: np.ndarray, max_rad: Optional[float] = None) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8 colour coding; ``max_rad`` defaults
    to the largest magnitude in the field."""
    u, v = flow[..., 0].astype(np.float64), flow[..., 1].astype(np.float64)
    rad = np.sqrt(u**2 + v**2)
    max_rad = max_rad or max(float(rad.max()), 1e-9)
    u, v = u / max_rad, v / max_rad
    rad = np.sqrt(u**2 + v**2)

    n = len(_WHEEL)
    angle = np.arctan2(-v, -u) / np.pi  # [-1, 1]
    fk = (angle + 1.0) / 2.0 * (n - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % n
    f = (fk - k0)[..., None]
    col = (1 - f) * _WHEEL[k0] / 255.0 + f * _WHEEL[k1] / 255.0
    # desaturated by magnitude inside the unit circle, darkened outside
    inside = rad <= 1
    col = np.where(inside[..., None], 1 - rad[..., None] * (1 - col), col * 0.75)
    return (col * 255).astype(np.uint8)
