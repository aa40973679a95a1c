"""Image preprocessing, plain PyTorch: the frozen copy of the port's ``ops/preprocess.py``
with the kernel's wrapper replaced by its plain version (the clamped crop, the fp32
multiply-add, one cast).

Counterpart of ``hulc2_tpu/ops/preprocess.py``. Images are NHWC uint8, as the
data pipeline delivers them. ``random_shift_normalize`` is the train
transform's hot op: on a CUDA tensor it launches the hand-written kernel
``csrc/shift_normalize.cu`` (the port of the TPU kernel
``hulc2_tpu/ops/pallas_shift.py:52``); on a CPU tensor it runs the plain
version below. There is no fallback from the one to the other.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple, Union

import torch


Stat = Union[float, Sequence[float]]
_OUT_DTYPES = (torch.float32, torch.bfloat16)

def _affine(mean: Stat, std: Stat, channels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (scale, shift) per channel on the CPU: x/255 normalized as
    x * 1/(255 std) - mean/std, one multiply-add."""
    mean_t = torch.broadcast_to(torch.as_tensor(mean, dtype=torch.float32), (channels,))
    std_t = torch.broadcast_to(torch.as_tensor(std, dtype=torch.float32), (channels,))
    return 1.0 / (255.0 * std_t), -mean_t / std_t


def _stat_key(stat: Stat) -> Tuple[float, ...]:
    try:
        return tuple(float(x) for x in stat)
    except TypeError:  # a scalar
        return (float(stat),)


@functools.lru_cache(maxsize=64)
def _affine_on(mean: Tuple[float, ...], std: Tuple[float, ...], channels: int,
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_affine`` on ``device``, copied there once: a copy from pageable host
    memory on every call would synchronise the stream."""
    scale, shift = _affine(mean, std, channels)
    return scale.to(device), shift.to(device)


def scale_and_normalize(imgs: torch.Tensor, mean: Stat, std: Stat) -> torch.Tensor:
    """uint8 [0, 255] (..., C) -> ((x / 255) - mean) / std, folded into one fp32
    multiply-add (``preprocess.py:25-34``)."""
    scale, shift = _affine_on(_stat_key(mean), _stat_key(std), imgs.shape[-1], imgs.device)
    return imgs.float() * scale + shift


def normalize_vector(x: torch.Tensor, mean, std) -> torch.Tensor:
    """(x - mean) / std with zero-std dims treated as std = 1."""
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    std = torch.where(std == 0.0, torch.ones_like(std), std)
    return (x - mean) / std


def shift_from_offsets(offsets: torch.Tensor, imgs: torch.Tensor, pad: int) -> torch.Tensor:
    """Edge-padded integer crop for given per-frame ``offsets`` (N, 2), rows
    then columns, each in [0, 2 pad]: a gather with clamped indices, in the
    input's dtype. Same function as ``preprocess.shift_from_offsets`` without
    the TPU's one-hot matmuls."""
    n, h, w, _ = imgs.shape
    offsets = offsets.to(imgs.device, torch.long)
    rows = (offsets[:, 0:1] + torch.arange(h, device=imgs.device) - pad).clamp(0, h - 1)
    cols = (offsets[:, 1:2] + torch.arange(w, device=imgs.device) - pad).clamp(0, w - 1)
    frame = torch.arange(n, device=imgs.device)[:, None, None]
    return imgs[frame, rows[:, :, None], cols[:, None, :]]


@functools.lru_cache(maxsize=32)
def _resize_weights(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """(in_size, out_size) fp32 weights of ``jax.image.resize``'s linear
    kernel: sample points at half-pixel centres, the triangle kernel widened
    by the downscale factor (antialiasing), each column renormalized over the
    inputs it covers."""
    inv_scale = torch.tensor(in_size / out_size, dtype=torch.float32)
    sample = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs()
    w = torch.clamp(1.0 - x / torch.clamp(inv_scale, min=1.0), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def resize(imgs: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of NHWC float images with ``jax.image.resize``'s
    semantics (``preprocess.py:118-124``), up or down; the input itself when
    the size already matches. Each spatial dim is one matmul with its weight
    matrix."""
    n, h, w, c = imgs.shape
    if (h, w) == (out_h, out_w):
        return imgs
    x = imgs.float()
    if h != out_h:
        x = torch.einsum("nhwc,hH->nHwc", x, _resize_weights(h, out_h, x.device))
    if w != out_w:
        x = torch.einsum("nhwc,wW->nhWc", x, _resize_weights(w, out_w, x.device))
    return x


def shorter_edge_hw(h: int, w: int, size: int) -> Tuple[int, int]:
    """torchvision ``Resize(int)``'s output size (``preprocess.py:127-134``):
    the shorter edge scaled to ``size``, the longer by the same factor, rounded."""
    if h <= w:
        return size, max(1, round(w * size / h))
    return max(1, round(h * size / w)), size


def resize_shorter_edge(imgs: torch.Tensor, size: int) -> torch.Tensor:
    """``Resize(int)`` of NHWC frames; the input itself when it has that
    size already."""
    return resize(imgs, *shorter_edge_hw(imgs.shape[1], imgs.shape[2], size))


def random_crop(imgs: torch.Tensor, offsets: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Per-frame crop of (out_h, out_w) at ``offsets`` (N, 2), rows then
    columns, each in [0, H - out_h] and [0, W - out_w] (``preprocess.py:137-147``)."""
    offsets = offsets.to(imgs.device, torch.long)
    rows = offsets[:, 0:1] + torch.arange(out_h, device=imgs.device)
    cols = offsets[:, 1:2] + torch.arange(out_w, device=imgs.device)
    frame = torch.arange(imgs.shape[0], device=imgs.device)[:, None, None]
    return imgs[frame, rows[:, :, None], cols[:, None, :]]


def add_gaussian_noise(x: torch.Tensor, noise: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    """x + noise * std + mean, ``noise`` standard normal of x's shape
    (``preprocess.py:104-106``)."""
    return x + noise.to(x.dtype) * std + mean


def add_depth_noise(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """Multiplicative depth noise: one scalar ``gamma`` (a Gamma(shape) draw
    divided by the rate) for the whole call (``preprocess.py:109-113``)."""
    return gamma.to(x.device, x.dtype) * x


# YIQ <-> RGB of the jitter's hue rotation (``preprocess.py:177-182``)
RGB2YIQ = ((0.299, 0.587, 0.114), (0.596, -0.274, -0.322), (0.211, -0.523, 0.312))
YIQ2RGB = ((1.0, 0.956, 0.621), (1.0, -0.272, -0.647), (1.0, -1.106, 1.703))


def color_jitter(imgs: torch.Tensor, uniforms: torch.Tensor, brightness: float = 0.3,
                 contrast: float = 0.3, hue: float = 0.3, prob: float = 0.3) -> torch.Tensor:
    """The batch-wide colour jitter of float frames in [0, 1]
    (``preprocess.py:150-191``). ``uniforms`` holds four U[0, 1) draws: the
    coin (the whole batch is jittered when it is below ``prob``), the
    brightness and contrast factors' and the hue angle's. Brightness and
    contrast scale by factors in [1 - f, 1 + f] (contrast about each frame's
    mean over all its pixels and channels); the hue rotates the chroma plane
    of YIQ by an angle in [-hue, hue] x 2 pi; the result is clipped to [0, 1]."""
    u = uniforms.to(imgs.device, torch.float32)
    b = u[1] * (2 * brightness) + (1.0 - brightness)
    c = u[2] * (2 * contrast) + (1.0 - contrast)
    theta = (u[3] * (2 * hue) - hue) * 2.0 * math.pi
    out = imgs * b.to(imgs.dtype)
    mean = out.mean(dim=(-3, -2, -1), keepdim=True)
    out = mean + (out - mean) * c.to(imgs.dtype)
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(theta), torch.ones_like(theta)
    rot = torch.stack([torch.stack([one, zero, zero]), torch.stack([zero, cos_t, -sin_t]),
                       torch.stack([zero, sin_t, cos_t])])
    m = (torch.tensor(YIQ2RGB, device=imgs.device) @ rot
         @ torch.tensor(RGB2YIQ, device=imgs.device)).to(imgs.dtype)
    out = torch.clamp(out @ m.T, 0.0, 1.0)
    return torch.where(u[0] < prob, out, imgs)


def shift_normalize_plain(imgs: torch.Tensor, offsets: torch.Tensor, pad: int, mean: Stat,
                          std: Stat, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The plain PyTorch version of the kernel: clamped gather, then the fp32
    multiply-add, then one cast to ``out_dtype``."""
    x = shift_from_offsets(offsets, imgs, pad)
    return scale_and_normalize(x, mean, std).to(out_dtype)


def random_shift_normalize(imgs: torch.Tensor, offsets: torch.Tensor, pad: int, mean: Stat,
                           std: Stat, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Fused RandomShift crop + scale/normalize: (N, H, W, 3) uint8 -> (N, H, W, 3)
    ``out_dtype``, on every device by ``shift_normalize_plain``."""
    if imgs.dtype != torch.uint8 or imgs.dim() != 4 or imgs.shape[-1] != 3:
        raise ValueError(f"imgs must be (N, H, W, 3) uint8, got {tuple(imgs.shape)} {imgs.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {_OUT_DTYPES}, got {out_dtype}")
    return shift_normalize_plain(imgs, offsets, pad, mean, std, out_dtype)
