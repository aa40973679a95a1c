"""What the work costs, from shapes alone: the FLOPs of a step, counted by
``FlopCounterMode`` over the benchmark's own reference step, and the bytes
that the shift-and-normalize kernel must move.

Only products carry FLOPs (2 x M x N x K for matrix products, convolutions
and attention); elementwise ops, reductions and the optimizer's update
count 0. cuDNN's recurrences have no formula in torch; ``RNN_FLOPS`` counts
what the unfused recurrence computes (the port's ``tools/flops_probe.py``,
copied). An op that looks like a product and has no formula makes the count
raise, so that no count leaves out a product.
"""
from __future__ import annotations

import contextlib
import re
from collections import Counter
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

_GATES = {0: 1, 1: 1, 2: 4, 3: 3}  # cuDNN's RNN modes: RNN_RELU, RNN_TANH, LSTM, GRU


def _rnn_layers(input, mode, hidden_size, proj_size, num_layers, batch_first, bidirectional):
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
    t, b, g, units = _rnn_layers(input, mode, hidden_size, proj_size, num_layers, batch_first,
                                 bidirectional)
    return sum(2 * t * b * g * (i + hidden_size) for _, i in units)


def cudnn_rnn_backward_flop(input, weight, weight_stride0, weight_buf, hx, cx, output,
                            grad_output, grad_hy, grad_cy, mode, hidden_size, proj_size,
                            num_layers, batch_first, dropout, train, bidirectional, batch_sizes,
                            dropout_state, reserve, output_mask, out_shape=None) -> int:
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
_PRODUCT = re.compile(r"(^|_)(a?b?mm|addbmm|baddbmm|addmv|mv|v?dot|matmul|linear|einsum|tensordot"
                      r"|conv\w*|\w*rnn\w*|\w*lstm\w*|\w*gru\w*|\w*attention\w*)($|_)")
_NOT_PRODUCTS = {"_cudnn_rnn_flatten_weight"}


class _OpNames(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func._overloadpacket] += 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _unfused_cpu_rnn(device: torch.device):
    """oneDNN off on the CPU, whose fused LSTM has no formula."""
    if device.type != "cpu":
        yield
        return
    enabled = torch._C._get_mkldnn_enabled()
    torch._C._set_mkldnn_enabled(False)
    try:
        yield
    finally:
        torch._C._set_mkldnn_enabled(enabled)


def count_flops(fn: Callable[[], object], device) -> Dict[str, object]:
    """{"flops", "flops_by_op"} of ``fn()``."""
    counter = FlopCounterMode(display=False, custom_mapping=RNN_FLOPS)
    names = _OpNames()
    with _unfused_cpu_rnn(torch.device(device)), counter, names:
        fn()
    missing = {str(op): n for op, n in names.ops.items()
               if op not in counter.flop_registry and op.__name__ not in _NOT_PRODUCTS
               and _PRODUCT.search(op.__name__)}
    if missing:
        raise NotImplementedError(f"no FLOP formula for the product ops {missing}")
    return {"flops": int(counter.get_total_flops()),
            "flops_by_op": {str(k): int(v) for k, v in counter.get_flop_counts()["Global"].items()}}


def shift_normalize_bytes(n: int, h: int, w: int, out_bytes: int) -> int:
    """Bytes one launch must move on (n, h, w, 3) uint8 frames: each input
    byte read once, each output element written once, and the (n, 2) int32
    offsets (``tools/bench_shift_normalize.launch_bytes``, copied)."""
    return n * h * w * 3 * (1 + out_bytes) + n * 2 * 4


H100_BF16_FLOPS = 989e12  # dense, NVIDIA H100 SXM data sheet, 700 W
H100_HBM_BYTES_PER_S = 3.35e12


def batch_shapes(dm_cfg: dict, frame_hw: dict) -> dict:
    """{key: (shape, dtype)} of a fused training batch of the config: the
    vis rows, then the lang rows, windows padded to ``max_window_size``."""
    bv, bl, s = dm_cfg["batch_size_vis"], dm_cfg["batch_size_lang"], dm_cfg["max_window_size"]
    n = bv + bl
    out = {cam: ((n, s, *frame_hw[cam], 3), torch.uint8) for cam in dm_cfg["observation_space"]["rgb_obs"]}
    out["robot_obs_raw"] = ((n, s, 15), torch.float32)
    out["actions"] = ((n, s, 7), torch.float32)
    out["lang"] = (((bl, 384), torch.float32) if dm_cfg["load_lang_embeddings"]
                   else ((bl, 77), torch.int32))
    out["use_for_aux_lang_loss"] = ((bl,), torch.bool)
    out["lang_task_id"] = ((bl,), torch.int32)
    return out


def train_step_flops(cfg: dict, frame_hw: dict) -> int:
    """FLOPs of one reference train step of ``cfg`` at its batch's shapes,
    counted on the meta device: forward, loss and backward. The optimizer's
    update is elementwise and adds none."""
    from portbench.reference.train_step import ReferenceTrainStep

    ref = ReferenceTrainStep(cfg, None, None, "meta")
    batch = {k: torch.empty(shape, dtype=dtype, device="meta")
             for k, (shape, dtype) in batch_shapes(cfg["datamodule"], frame_hw).items()}
    generator = torch.Generator().manual_seed(0)

    def step():
        ref.loss(batch, generator, 0.01).backward()

    with _meta_autocast():
        return count_flops(step, "meta")["flops"]


@contextlib.contextmanager
def _meta_autocast():
    """``torch.autocast`` with ``device_type="meta"`` (which torch refuses)
    as a no-op: the reference's fp32 regions are fp32 anyway."""
    real = torch.autocast

    def autocast(device_type, *args, **kwargs):
        return contextlib.nullcontext() if device_type == "meta" else real(device_type, *args,
                                                                            **kwargs)

    torch.autocast = autocast
    try:
        yield
    finally:
        torch.autocast = real
