"""Image preprocessing: the RandomShift+normalize kernel wrapper and its plain version.

Counterpart of ``hulc2_tpu/ops/preprocess.py``. Images are NHWC uint8, as the
data pipeline delivers them. ``random_shift_normalize`` is the train
transform's hot op: on a CUDA tensor it launches the hand-written kernel
``csrc/shift_normalize.cu`` (the port of the TPU kernel
``hulc2_tpu/ops/pallas_shift.py:52``); on a CPU tensor it runs the plain
version below. There is no fallback from the one to the other.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Sequence, Tuple, Union

import torch

from hulc2_torch import kernels
from hulc2_torch.core import trace
from hulc2_torch.kernels import build

Stat = Union[float, Sequence[float]]
_OUT_DTYPES = (torch.float32, torch.bfloat16)

# The kernel's tiling (``csrc/shift_normalize.cu``): one block per tile, a
# tile being one frame and a band of output rows whose source rows come to
# about STAGE_BYTES, staged in shared memory by one bulk copy.
STAGE_BYTES = 32 * 1024
ALIGN = 16  # a bulk copy's address and size granule
MAX_SMEM = 232448  # shared memory one block may use on Hopper (227 KB)


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
def _affine_c(mean: Tuple[float, ...], std: Tuple[float, ...], channels: int) -> tuple:
    """``_affine`` as the two ctypes float arrays the kernel's entry point
    takes, built once per (mean, std, channels)."""
    scale, shift = _affine(mean, std, channels)
    return (ctypes.c_float * channels)(*scale.tolist()), (ctypes.c_float * channels)(*shift.tolist())


@functools.lru_cache(maxsize=64)
def _affine_on(mean: Tuple[float, ...], std: Tuple[float, ...], channels: int,
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_affine`` on ``device``, copied there once: a copy from pageable host
    memory on every call would synchronise the stream. The card's copy goes
    through pinned memory, so that the first call does not synchronise
    either."""
    pair = _affine(mean, std, channels)
    if device.type == "cuda":
        return tuple(t.pin_memory().to(device, non_blocking=True) for t in pair)
    return tuple(t.to(device) for t in pair)


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


class ShiftTiling(NamedTuple):
    band_rows: int  # output rows per band; the last band of a frame may have fewer
    bands: int  # bands per frame
    blocks: int  # the grid: one block per (frame, band)
    stage_bytes: int  # shared memory per block: a band's source rows plus alignment room


def shift_tiling(n: int, h: int, w: int) -> ShiftTiling:
    """The kernel's launch geometry for ``n`` frames of (h, w, 3) uint8.
    Bands are as even as the ~STAGE_BYTES target allows, so a 96x96 or 64x64
    frame is one band and a 224x224 frame five bands of 45 rows."""
    if min(n, h, w) < 1:
        raise ValueError(f"empty frames: n={n} h={h} w={w}")
    row_bytes = w * 3
    bands = -(-h // max(1, min(h, STAGE_BYTES // row_bytes)))
    band_rows = -(-h // bands)
    bands = -(-h // band_rows)
    # the band's bytes start up to 15 bytes into the stage's first 16; the
    # kernel reads whole 4-byte words, up to 4 bytes past the last one
    stage = -(-(band_rows * row_bytes + ALIGN - 1) // ALIGN) * ALIGN + ALIGN
    if stage > MAX_SMEM:
        raise ValueError(f"a row of {row_bytes} bytes does not fit one block's shared memory")
    return ShiftTiling(band_rows, bands, n * bands, stage)


class BandStage(NamedTuple):
    rows: range  # output rows of the band
    src_rows: range  # source rows it stages
    lo: int  # staged device bytes [lo, hi)
    hi: int
    bulk: range  # the 16-byte-aligned part that one bulk copy moves; empty when none
    stage_end: int  # one past the last byte of its stage written


def band_stage(tiling: ShiftTiling, h: int, w: int, pad: int, frame: int, band: int,
               row_offset: int, base: int = 0) -> BandStage:
    """What block (frame, band) stages, computed as the kernel computes it
    (``tile_of`` and ``split_of`` in ``csrc/shift_normalize.cu``); ``base`` is
    the device address of the images and ``row_offset`` the frame's row offset."""
    row_bytes = w * 3
    i0 = band * tiling.band_rows
    rows = range(i0, min(i0 + tiling.band_rows, h))
    dy = min(max(row_offset - pad, -h), h)
    r0 = min(max(rows.start + dy, 0), h - 1)
    r1 = min(max(rows.stop - 1 + dy, 0), h - 1)
    lo = base + (frame * h + r0) * row_bytes
    hi = base + (frame * h + r1 + 1) * row_bytes
    bulk_lo, bulk_hi = -(-lo // ALIGN) * ALIGN, hi // ALIGN * ALIGN
    if bulk_hi <= bulk_lo:
        bulk_lo = bulk_hi = hi
    return BandStage(rows, range(r0, r1 + 1), lo, hi, range(bulk_lo, bulk_hi, ALIGN),
                     hi - lo // ALIGN * ALIGN)


def _check(imgs: torch.Tensor, offsets: torch.Tensor, pad: int, out_dtype: torch.dtype) -> None:
    if imgs.dtype != torch.uint8 or imgs.dim() != 4:
        raise ValueError(f"imgs must be (N, H, W, C) uint8, got {tuple(imgs.shape)} {imgs.dtype}")
    if imgs.shape[-1] != 3:
        raise ValueError(f"RGB (3-channel) frames only, got {imgs.shape[-1]} channels")
    if not imgs.is_contiguous():
        raise ValueError("imgs must be contiguous NHWC")
    if offsets.dtype != torch.int32 or tuple(offsets.shape) != (imgs.shape[0], 2):
        raise ValueError(f"offsets must be ({imgs.shape[0]}, 2) int32, got "
                         f"{tuple(offsets.shape)} {offsets.dtype}")
    if not offsets.is_contiguous() or offsets.device != imgs.device:
        raise ValueError("offsets must be contiguous and on the images' device")
    if pad < 0:
        raise ValueError(f"pad must be >= 0, got {pad}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {_OUT_DTYPES}, got {out_dtype}")


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = build.load("shift_normalize").shift_normalize_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, *[ctypes.c_int] * 7,
                   ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


SPAN = "shift_normalize"  # the launch's span: ``SPAN n=N h=H w=W out=bfloat16`` while traced


def random_shift_normalize(imgs: torch.Tensor, offsets: torch.Tensor, pad: int, mean: Stat,
                           std: Stat, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Fused RandomShift crop + scale/normalize: (N, H, W, 3) uint8 -> (N, H, W, 3)
    ``out_dtype``. ``offsets`` is (N, 2) int32, column 0 rows and column 1
    columns, each in [0, 2 pad]. CUDA tensors go through the kernel, CPU
    tensors through ``shift_normalize_plain``."""
    _check(imgs, offsets, pad, out_dtype)
    if imgs.device.type == "cpu":
        return shift_normalize_plain(imgs, offsets, pad, mean, std, out_dtype)
    if imgs.device.type != "cuda":
        raise ValueError(f"unsupported device {imgs.device}")
    n, h, w, c = imgs.shape
    tiling = shift_tiling(n, h, w)
    scale_c, shift_c = _affine_c(_stat_key(mean), _stat_key(std), c)
    out = torch.empty((n, h, w, c), dtype=out_dtype, device=imgs.device)
    fn = _launch_fn()
    # the ctypes launch has no aten op whose shapes the profiler would record:
    # its span's label carries them, which ``tools/roofline.py`` reads
    with torch.cuda.device(imgs.device), trace.span(SPAN, n=n, h=h, w=w,
                                                    out=str(out_dtype).replace("torch.", "")):
        stream = torch.cuda.current_stream(imgs.device).cuda_stream
        err = fn(imgs.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                 int(out_dtype == torch.bfloat16), n, h, w, pad, tiling.band_rows,
                 tiling.stage_bytes, scale_c, shift_c, stream)
    if err != 0:
        raise RuntimeError(f"shift_normalize launch failed with cudaError {err}")
    kernels.LAUNCHES["shift_normalize"] += 1
    return out
