"""Weights from the seed, made on the device in one draw and handed to both
the program and the reference.

Every leaf takes its values from one ``torch.rand`` of all the leaves'
elements (a generator on the device seeded with the run's seed), cut in
the order of the names, then mapped: a weight of two or more dimensions to
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with fan_in its elements over its first
dimension (torch's default for linear and convolution layers), a
one-dimensional ``weight`` (a norm's scale) and a BatchNorm's ``running_var``
to 1 + U(-0.1, 0.1), any other
leaf (biases, scalars) to U(-0.05, 0.05). ``logit_scale`` is log(1 / 0.07),
CLIP's initial temperature, as the model makes it.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

LOGIT_SCALE = math.log(1.0 / 0.07)


def make_weights(shapes: Iterable[Tuple[str, torch.Size]], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: fp32 tensor on ``device``} for the (name, shape) pairs."""
    shapes = sorted((name, tuple(shape)) for name, shape in shapes)
    total = sum(math.prod(s) for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0  # U(-1, 1)
    out, at = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        u = flat[at:at + n].view(shape)
        at += n
        if name.endswith("logit_scale"):
            w = torch.full(shape, LOGIT_SCALE, device=device)
        elif name.endswith("running_var"):
            w = 1.0 + 0.1 * u
        elif len(shape) >= 2:
            w = u / math.sqrt(n // shape[0])
        elif name.endswith("weight"):
            w = 1.0 + 0.1 * u
        else:
            w = 0.05 * u
        out[name] = w.contiguous()
    return out


def param_shapes(model: torch.nn.Module):
    return [(name, p.shape) for name, p in model.named_parameters()]
