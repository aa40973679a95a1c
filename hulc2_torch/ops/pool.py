"""The 2x2, stride-2 average pool of channels_last activations: the kernel
wrapper and its plain version.

``avg_pool2x2`` is ``F.avg_pool2d(x, 2)`` (floor mode) of an (N, C, H, W)
bf16 or fp32 tensor in channels_last memory, where no gradient is needed:
the frozen CLIP trunk's pools (``models/clip_resnet``). On a CUDA tensor it
launches the hand-written kernel ``csrc/avg_pool2x2.cu``, which replaces no
TPU kernel (the JAX tower's ``nn.avg_pool`` is XLA's) and gives the same
bits as ATen's pool; on a CPU tensor it runs the plain version. There is no
fallback from the one to the other: a tensor the kernel does not take raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from hulc2_torch import kernels
from hulc2_torch.core import trace
from hulc2_torch.kernels import build

VEC_BYTES = 16  # a thread's load and store: 8 bf16 or 4 fp32 channels
_DTYPES = (torch.float32, torch.bfloat16)
SPAN = "avg_pool2x2"  # the launch's span: ``SPAN n=N h=H w=W c=C dtype=bfloat16`` while traced
COUNTER = "ops.avg_pool2x2_launches"


def avg_pool2x2_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel."""
    return F.avg_pool2d(x, 2)


def _problem(x: torch.Tensor) -> Optional[str]:
    """Why the kernel does not take ``x``, or None."""
    if x.dim() != 4:
        return f"x must be (N, C, H, W), got {tuple(x.shape)}"
    if x.dtype not in _DTYPES:
        return f"x must be one of {_DTYPES}, got {x.dtype}"
    if not x.is_contiguous(memory_format=torch.channels_last):
        return "x must be contiguous in channels_last memory"
    n, c, h, w = x.shape
    if h < 2 or w < 2:
        return f"a 2x2 pool needs H and W of at least 2, got {h}x{w}"
    if c * x.element_size() % VEC_BYTES:
        return f"C x {x.element_size()} bytes must be a multiple of {VEC_BYTES}, got C={c}"
    if x.data_ptr() % VEC_BYTES:
        return f"x must start on a {VEC_BYTES}-byte boundary"
    if max(n, c, h, w) >= 2 ** 31:
        return f"sizes must fit 32 bits, got {tuple(x.shape)}"
    if n * (h // 2) * (w // 2) * (c * x.element_size() // VEC_BYTES) >= 2 ** 31:
        return f"the output must hold fewer than 2^31 {VEC_BYTES}-byte groups, got {tuple(x.shape)}"
    return None


def _check(x: torch.Tensor) -> None:
    problem = _problem(x)
    if problem is not None:
        raise ValueError(problem)
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError("avg_pool2x2 has no backward: call it under no_grad or on a tensor "
                         "that requires no gradient")


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = build.load("avg_pool2x2").avg_pool2x2_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, *[ctypes.c_int] * 5, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def avg_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """``F.avg_pool2d(x, 2)`` of an (N, C, H, W) bf16 or fp32 tensor in
    channels_last memory, C x the element size a multiple of 16 bytes, with
    no gradient: (N, C, H // 2, W // 2) in channels_last memory. CUDA
    tensors go through the kernel, CPU tensors through
    ``avg_pool2x2_plain``; any other tensor raises ValueError."""
    _check(x)
    if x.device.type == "cpu":
        return avg_pool2x2_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, c, h, w = x.shape
    out = torch.empty((n, c, h // 2, w // 2), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    if n == 0:
        return out
    fn = _launch_fn()
    # the ctypes launch has no aten op whose shapes the profiler would record:
    # its span's label carries them
    with torch.cuda.device(x.device), trace.span(SPAN, n=n, h=h, w=w, c=c,
                                                 dtype=str(x.dtype).replace("torch.", "")):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16), n, h, w, c, stream)
    if err != 0:
        raise RuntimeError(f"avg_pool2x2 launch failed with cudaError {err}")
    kernels.LAUNCHES["avg_pool2x2"] += 1
    trace.count(COUNTER)
    return out
