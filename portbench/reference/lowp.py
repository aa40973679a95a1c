"""The control: the reference computed in a lower precision.

The configurations compute in bf16 mixed precision (autocast). The step
below is fp8 mixed precision, as fp8 training runs it: the same bf16
autocast, with every matrix product and convolution (and attention's
products) taking its operands rounded to float8 with one scale per tensor:
e4m3 (largest magnitude to 448) in the forward, e5m2 (to 57344) in the
backward, as fp8 training's hybrid format does. ``fp8()`` is that
context on the CUDA device (on the CPU, where autocast has no bf16 path
for every op, the products' rounding alone)."""
from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten
PRODUCTS = {aten.mm.default: (0, 1), aten.addmm.default: (1, 2), aten.bmm.default: (0, 1),
            aten.baddbmm.default: (1, 2), aten.convolution.default: (0, 1),
            aten.convolution_backward.default: (0, 1, 2)}
FORMATS = {"forward": (torch.float8_e4m3fn, 448.0), "backward": (torch.float8_e5m2, 57344.0)}


def round_fp8(x: torch.Tensor, pass_: str = "forward") -> torch.Tensor:
    dtype, top = FORMATS[pass_]
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / top
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _Fp8(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        which = PRODUCTS.get(func)
        if which is not None:
            pass_ = "forward" if torch._C._current_autograd_node() is None else "backward"
            args = tuple(round_fp8(a, pass_) if i in which and isinstance(a, torch.Tensor) else a
                         for i, a in enumerate(args))
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def fp8(model=None, device_type: str = "cuda"):
    """A context in which the products run on fp8-rounded operands, inside
    bf16 autocast on the card."""
    with torch.autocast(device_type="cuda", dtype=torch.bfloat16,
                        enabled=device_type == "cuda" and torch.cuda.is_available()), _Fp8():
        yield
