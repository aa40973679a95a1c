"""FLOPs of one whole policy train step, and with ``--measure`` its share of
the card's peak.

    python -m hulc2_torch.tools.flops_probe [--config-name cfg_low_level|flagship|...]
        [--batch 32] [--device cpu] [--measure [--steps 5] [--warmup 5]
        [--peak-tflops T]] [key=value ...]

The counterpart of ``hulc2_tpu/tools/flops_probe.py``, which reads XLA's cost
analysis of the ``cfg_low_level`` step. Here ``torch.utils.flop_counter``'s
``FlopCounterMode`` counts one train step of the named config (default
``cfg_low_level``, as JAX's probe; ``--config-name`` and the overrides as
in ``profile_train``) at ``--batch`` windows per modality (32 + 32) of the
config's ``max_window_size`` (32): forward, backward and the optimizer. Only
products carry FLOPs: matrix products, convolutions and attention, each
2 x M x N x K. Elementwise ops, reductions, the optimizer's update and the
``shift_normalize`` kernel count 0. The count is a function of the shapes
only: the batch is made on the host from a seed and moved to the device,
so the card and the CPU count the same FLOPs.

``FlopCounterMode`` has no formula for cuDNN's recurrences
(``aten._cudnn_rnn`` and its backward, the GRU and LSTM of the recurrent
variants): ``RNN_FLOPS`` registers one that counts what the CPU's unfused
recurrence computes, so the two devices agree. On the CPU the count runs
with oneDNN off, whose fused LSTM (``aten.mkldnn_rnn_layer``) has no
formula. Any other op that looks like a product and has no formula raises,
naming the op: a count that leaves out a GEMM is never printed.

With ``--measure`` (the card only) it also times the step as
``profile_train`` does (the median wall of ``--steps`` steps after
``--warmup``, then the device-busy time of ``--steps`` profiled steps) and
prints the achieved TFLOP/s and ``mfu``: the FLOPs over the device-busy time
over the card's published dense peak for the step's compute dtype
(``PEAK_TFLOPS``, NVIDIA's H100 SXM data sheet; another card needs
``--peak-tflops``), and ``mfu_wall``, the same over the wall time, beside
the card's name and power limit.

Prints one JSON line: ``flops``, ``batch``, ``window``, ``config``,
``compute_dtype``, ``flops_by_op``, ``device`` and, with ``--measure``,
``card``, ``wall_ms``, ``busy_ms``, ``achieved_tflops``, ``peak_tflops``,
``mfu`` and ``mfu_wall``.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import re
import statistics
import sys
from collections import Counter
from typing import Dict, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from hulc2_torch.configs.flagship import flagship_config
from hulc2_torch.core.config import compose, options
from hulc2_torch.tools import profiling
from hulc2_torch.training import SyntheticRun

# dense peak TFLOP/s by device name and compute dtype (NVIDIA H100 SXM data
# sheet, at its 700 W limit; fp32 is outside the tensor cores)
PEAK_TFLOPS = {"NVIDIA H100 80GB HBM3": {"bfloat16": 989.0, "tf32": 495.0, "float32": 67.0}}

# cuDNN's RNN modes -> gate blocks per step: RNN_RELU, RNN_TANH, LSTM, GRU
_GATES = {0: 1, 1: 1, 2: 4, 3: 3}


def _rnn_layers(input, mode, hidden_size, proj_size, num_layers, batch_first, bidirectional):
    """(steps, batch, gate width, [(layer, input width) per layer and
    direction]) of a cuDNN recurrence, from its input shape."""
    if proj_size:
        raise NotImplementedError("the FLOP formula of a projected LSTM (proj_size > 0)")
    t, b = (input[1], input[0]) if batch_first else (input[0], input[1])
    dirs = 2 if bidirectional else 1
    g = _GATES[mode] * hidden_size
    units = [(layer, input[2] if layer == 0 else dirs * hidden_size)
             for layer in range(num_layers) for _ in range(dirs)]
    return t, b, g, units


def cudnn_rnn_flop(input, weight, weight_stride0, weight_buf, hx, cx, mode, hidden_size,
                   proj_size, num_layers, batch_first, dropout, train, bidirectional,
                   batch_sizes, dropout_state, out_shape=None) -> int:
    """Forward of ``aten._cudnn_rnn``: per layer and direction, the input
    projection of all steps and the hidden projection of every step."""
    t, b, g, units = _rnn_layers(input, mode, hidden_size, proj_size, num_layers, batch_first,
                                 bidirectional)
    return sum(2 * t * b * g * (i + hidden_size) for _, i in units)


def cudnn_rnn_backward_flop(input, weight, weight_stride0, weight_buf, hx, cx, output,
                            grad_output, grad_hy, grad_cy, mode, hidden_size, proj_size,
                            num_layers, batch_first, dropout, train, bidirectional, batch_sizes,
                            dropout_state, reserve, output_mask, out_shape=None) -> int:
    """Backward of ``aten._cudnn_rnn`` as autograd runs it through the
    unfused recurrence: the weight gradients of both projections (when the
    weights need them); the input projection's input gradient, except in the
    first layer when the input needs none; the hidden gradient of every step
    but the first, and of the first when the initial state needs one."""
    t, b, g, units = _rnn_layers(input, mode, hidden_size, proj_size, num_layers, batch_first,
                                 bidirectional)
    grad_input, grad_hx, _, grad_weight = output_mask
    h = hidden_size
    total = 0
    for layer, i in units:
        if grad_weight:
            total += 2 * t * b * g * (i + h)
        if layer > 0 or grad_input:
            total += 2 * t * b * g * i
        total += 2 * (t - 1 + int(grad_hx)) * b * g * h
    return total


RNN_FLOPS = {torch.ops.aten._cudnn_rnn: cudnn_rnn_flop,
             torch.ops.aten._cudnn_rnn_backward: cudnn_rnn_backward_flop}

# op names that are products (or hold them); an op among them without a
# formula makes the count refuse
PRODUCT = re.compile(r"(^|_)(a?b?mm|addbmm|baddbmm|addmv|mv|v?dot|matmul|linear|einsum|tensordot"
                      r"|conv\w*|\w*rnn\w*|\w*lstm\w*|\w*gru\w*|\w*attention\w*)($|_)")
# ops whose names match but carry no product
_NOT_PRODUCTS = {"_cudnn_rnn_flatten_weight"}


class _OpNames(TorchDispatchMode):
    """Counts every aten op dispatched under it, by overload packet."""

    def __init__(self):
        super().__init__()
        self.ops: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func._overloadpacket] += 1
        return func(*args, **(kwargs or {}))


def uncounted_products(ops: Counter, registry) -> Dict[str, int]:
    """{op name: calls} of the ops that look like products and have no formula."""
    out = {}
    for op, n in ops.items():
        name = op.__name__
        if op not in registry and name not in _NOT_PRODUCTS and PRODUCT.search(name):
            out[str(op)] = n
    return out


def config_for(name: Optional[str], overrides: Sequence[str] = (), batch: Optional[int] = None) -> dict:
    """The named root (``flagship`` or None: the flagship preset) with the
    overrides and ``batch`` windows per modality."""
    overrides = list(overrides) + ([f"datamodule.batch_size_vis={batch}",
                                    f"datamodule.batch_size_lang={batch}"] if batch else [])
    if name in (None, "flagship"):
        return flagship_config(overrides)
    return compose(name, overrides)


def host_batch(run: SyntheticRun, seed: int = 0) -> dict:
    """One synthetic batch of ``run``'s shapes, drawn on the host from
    ``seed`` and moved to ``run``'s device: the same batch on every device."""
    data = copy.copy(run.data)
    data.device, data.generator = torch.device("cpu"), torch.Generator().manual_seed(seed)
    return {mod: {k: v.to(run.device) for k, v in window.items()}
            for mod, window in data.next_batch().items()}


def compute_dtype(run: SyntheticRun) -> str:
    if run.model.compute_dtype == torch.bfloat16 and run.device.type == "cuda":
        return "bfloat16"
    if run.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        return "tf32"
    return "float32"


@contextlib.contextmanager
def _unfused_cpu_rnn():
    """oneDNN off: the CPU runs GRU and LSTM as their unfused recurrence,
    since oneDNN's fused LSTM (``aten.mkldnn_rnn_layer``) has no formula."""
    enabled = torch._C._get_mkldnn_enabled()
    torch._C._set_mkldnn_enabled(False)
    try:
        yield
    finally:
        torch._C._set_mkldnn_enabled(enabled)


def count_step(run: SyntheticRun, raw: dict) -> dict:
    """FLOPs of ``run.step(raw)``: {"flops", "flops_by_op"}; raises, naming
    them, when ops that look like products have no formula."""
    counter = FlopCounterMode(display=False, custom_mapping=RNN_FLOPS)
    names = _OpNames()
    with _unfused_cpu_rnn() if run.device.type == "cpu" else contextlib.nullcontext(), \
            counter, names:
        run.step(raw)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    missing = uncounted_products(names.ops, counter.flop_registry)
    if missing:
        raise NotImplementedError(f"no FLOP formula for the product ops {missing}: the count "
                                  "would leave them out")
    by_op = {str(k): int(v) for k, v in counter.get_flop_counts()["Global"].items()}
    return {"flops": int(counter.get_total_flops()), "flops_by_op": by_op}


def peak_tflops(device: torch.device, dtype: str, given: Optional[float] = None) -> float:
    if given:
        return given
    name = torch.cuda.get_device_name(device)
    try:
        return PEAK_TFLOPS[name][dtype]
    except KeyError:
        raise ValueError(f"no published peak for {name!r} in {dtype}: pass --peak-tflops") from None


def measure(run: SyntheticRun, flops: int, steps: int, warmup: int,
            peak: Optional[float] = None) -> dict:
    """The step's wall and device-busy time on the card, the achieved
    TFLOP/s and the shares of the peak over both."""
    if run.device.type != "cuda":
        raise ValueError("--measure times the step on the card: it needs a CUDA device")
    profiling.wall_ms(run.step, warmup, run.device, run.next_batch)
    wall_ms = statistics.median(profiling.wall_ms(run.step, steps, run.device, run.next_batch))
    _, _, _, busy_ms = profiling.profile_steps(run, steps)
    dtype = compute_dtype(run)
    peak = peak_tflops(run.device, dtype, peak)
    achieved = flops / (busy_ms * 1e-3) / 1e12
    return {"card": profiling.card_line(), "wall_ms": wall_ms, "busy_ms": busy_ms,
            "achieved_tflops": achieved, "peak_tflops": peak, "mfu": achieved / peak,
            "mfu_wall": flops / (wall_ms * 1e-3) / 1e12 / peak}


def probe(config_name: Optional[str], overrides: Sequence[str] = (), batch: int = 32,
          device=None, seed: int = 0) -> tuple:
    """(the run, its count): one train step of the config counted on ``device``."""
    cfg = config_for(config_name, overrides, batch)
    run = SyntheticRun(cfg, device)
    count = count_step(run, host_batch(run, seed))
    dm = cfg["datamodule"]
    return run, {**count, "batch": dm["batch_size_vis"], "window": dm["max_window_size"],
                 "config": config_name or "flagship", "compute_dtype": compute_dtype(run),
                 "device": str(run.device),
                 "not_counted": "elementwise ops, reductions, the optimizer's update and the "
                                "shift_normalize kernel (0 FLOPs)"}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config-name", default="cfg_low_level", choices=options("root") + ["flagship"])
    p.add_argument("--batch", type=int, default=32, help="windows per modality")
    p.add_argument("--device", default=None, help="where the step runs (default: the card)")
    p.add_argument("--measure", action="store_true", help="also time the step on the card")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--peak-tflops", type=float, default=None,
                   help="the card's dense peak for the step's dtype, where PEAK_TFLOPS lacks it")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)
    run, out = probe(args.config_name, args.overrides, args.batch, args.device)
    if args.measure:
        out.update(measure(run, out["flops"], args.steps, args.warmup, args.peak_tflops))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
