"""Building blocks with the JAX package's semantics (``hulc2_tpu/models/layers.py``).

Every module that holds randomly initialised weights has an
``init_weights(generator)`` method; ``init_weights_(model, generator)`` walks
a model and calls them, so one ``torch.Generator`` decides the whole init.
Dropout takes its mask from an explicit generator as well.

The GRU and LSTM are torch's ``nn.GRU``/``nn.LSTM`` (cuDNN on the card): the
JAX package runs the same cells as ``lax.scan`` loops, outside any Pallas
kernel. They run in fp32 whatever the autocast: under a bf16 autocast torch
hands cuDNN's RNN fp16 (measured on the H100, ``PERF.md`` §6, PR 8), whose
gradients would go unscaled through fp16; JAX keeps these recurrences in
fp32. ``gru_plain``/``lstm_plain`` are the loops in plain PyTorch, the
reference the card's tests hold the library against.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from hulc2_torch.parallel.batch_shard import draw_rows


def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every module of ``model`` that defines ``init_weights``, in
    ``model.modules()`` order. Each such method draws only the parameters that
    no descendant's ``init_weights`` covers, so the order of the walk fixes
    the draws."""
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "init_weights"):
                m.init_weights(generator)
    return model


def _torch_uniform_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    t.uniform_(-bound, bound, generator=generator)


class Dense(nn.Linear):
    """nn.Linear with the torch default init, U(+-1/sqrt(fan_in)) for weight
    and bias, drawn from the given generator (``layers.py:35``)."""

    def init_weights(self, generator: torch.Generator) -> None:
        _torch_uniform_(self.weight, self.in_features, generator)
        if self.bias is not None:
            _torch_uniform_(self.bias, self.in_features, generator)


class Conv(nn.Conv2d):
    """VALID nn.Conv2d with the torch default init (``layers.py:55``)."""

    def init_weights(self, generator: torch.Generator) -> None:
        fan_in = self.in_channels * self.kernel_size[0] * self.kernel_size[1]
        _torch_uniform_(self.weight, fan_in, generator)
        _torch_uniform_(self.bias, fan_in, generator)


ACTIVATIONS = {
    "ReLU": nn.ReLU,
    "ELU": nn.ELU,
    # jax.nn.gelu defaults to the tanh approximation
    "GELU": lambda: nn.GELU(approximate="tanh"),
    "Tanh": nn.Tanh,
    "SiLU": nn.SiLU,
}


def get_activation(name: str) -> nn.Module:
    """A module of the activation ``name`` (``hulc2_tpu/models/layers.py:87``)."""
    try:
        return ACTIVATIONS[name]()
    except KeyError:
        raise KeyError(f"unknown activation {name!r}; known: {sorted(ACTIVATIONS)}") from None


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) over the last dim (``hulc2_tpu/models/vision.py:36``)."""
    return x / x.norm(dim=-1, keepdim=True).clamp(min=eps)


class MLP(nn.Sequential):
    """Dense layers with the activation between them, not after the last
    (``layers.py:97``); indices 0, 2, ... are the linears."""

    def __init__(self, in_features: int, hidden: Sequence[int], activation: str = "ReLU"):
        layers = []
        for i, h in enumerate(hidden):
            layers.append(Dense(in_features if i == 0 else hidden[i - 1], h))
            if i < len(hidden) - 1:
                layers.append(get_activation(activation))
        super().__init__(*layers)


def dropout(x: torch.Tensor, p: float, deterministic: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout whose mask comes from ``generator``."""
    if deterministic or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout with p > 0 needs a generator unless deterministic")
    keep = draw_rows(lambda s: torch.rand(s, generator=generator, device=x.device), x.shape,
                     x.device) >= p
    return x * keep.to(x.dtype) * (1.0 / (1.0 - p))


class MultiHeadAttention(nn.Module):
    """Self-attention with torch nn.MultiheadAttention's parameters (packed
    q|k|v ``in_proj_weight``, ``out_proj``) and the JAX package's numerics:
    scores scaled by 1/sqrt(head_dim), softmax in fp32, no dropout on the
    attention weights (``layers.py:115``)."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} not divisible by num_heads {num_heads}")
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def init_weights(self, generator: torch.Generator) -> None:
        e = self.out_proj.in_features
        bound = math.sqrt(6.0 / (e + 3 * e))  # xavier_uniform of the (E, 3E) kernel
        self.in_proj_weight.uniform_(-bound, bound, generator=generator)
        self.in_proj_bias.zero_()
        _torch_uniform_(self.out_proj.weight, e, generator)
        self.out_proj.bias.zero_()

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, s, e = x.shape
        h = self.num_heads
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (t.reshape(b, s, h, e // h).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(e // h)
        if attn_mask is not None:
            scores = scores + attn_mask
        attn = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b, s, e)
        return self.out_proj(out)


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer with a ReLU feed-forward, torch's parameter
    names (``layers.py:152``)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, dropout_p: float):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.linear1 = Dense(d_model, dim_feedforward)
        self.linear2 = Dense(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout_p = dropout_p

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        p = self.dropout_p
        a = dropout(self.self_attn(x), p, deterministic, generator)
        x = self.norm1(x + a)
        f = dropout(F.relu(self.linear1(x)), p, deterministic, generator)
        f = dropout(self.linear2(f), p, deterministic, generator)
        return self.norm2(x + f)


class ReluRNN(nn.Module):
    """torch nn.RNN(nonlinearity='relu', batch_first=True) with its parameter
    names, written as plain PyTorch: the input projection of each layer is one
    GEMM over all steps, the recurrence a loop (``layers.py:215``)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        for k in range(num_layers):
            fan = input_size if k == 0 else hidden_size
            setattr(self, f"weight_ih_l{k}", nn.Parameter(torch.empty(hidden_size, fan)))
            setattr(self, f"weight_hh_l{k}", nn.Parameter(torch.empty(hidden_size, hidden_size)))
            setattr(self, f"bias_ih_l{k}", nn.Parameter(torch.empty(hidden_size)))
            setattr(self, f"bias_hh_l{k}", nn.Parameter(torch.empty(hidden_size)))

    def init_weights(self, generator: torch.Generator) -> None:
        for p in self.parameters(recurse=False):
            _torch_uniform_(p, self.hidden_size, generator)

    def forward(self, x: torch.Tensor, h0: Optional[torch.Tensor] = None):
        """x (B, S, F), from ``h0`` (L, B, H) or a zero state -> outputs
        (B, S, H), h_n (L, B, H)."""
        h_last = []
        for k in range(self.num_layers):
            w_hh, b_hh = getattr(self, f"weight_hh_l{k}"), getattr(self, f"bias_hh_l{k}")
            x_proj = F.linear(x, getattr(self, f"weight_ih_l{k}"), getattr(self, f"bias_ih_l{k}"))
            h = x_proj.new_zeros(x.shape[0], self.hidden_size) if h0 is None else h0[k]
            outs = []
            for t in range(x.shape[1]):
                h = F.relu(x_proj[:, t] + F.linear(h, w_hh, b_hh))
                outs.append(h)
            x = torch.stack(outs, dim=1)
            h_last.append(h)
        return x, torch.stack(h_last)


def _init_rnn_(module: nn.Module, generator: torch.Generator) -> None:
    """torch's RNN init, U(+-1/sqrt(H)) for every weight and bias, drawn from
    ``generator`` in parameter order."""
    for p in module.parameters(recurse=False):
        _torch_uniform_(p, module.hidden_size, generator)


class _Fp32Recurrence:
    """The library's recurrence in fp32, outside any autocast; outputs and
    states come back in fp32."""

    init_weights = _init_rnn_

    def forward(self, x: torch.Tensor, hx=None):
        with torch.autocast(device_type=x.device.type, enabled=False):
            if hx is not None:
                hx = tuple(h.float() for h in hx) if isinstance(hx, tuple) else hx.float()
            return super().forward(x.float(), hx)


class GRU(_Fp32Recurrence, nn.GRU):
    """torch nn.GRU(batch_first=True): gates (r, z, n), the n-gate
    ``tanh(x_n + r * (h W_hn + b_hn))`` (``layers.py:240``)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int):
        super().__init__(input_size, hidden_size, num_layers, batch_first=True)


class LSTM(_Fp32Recurrence, nn.LSTM):
    """torch nn.LSTM(batch_first=True): gates (i, f, g, o); the state is an
    (h, c) pair of (L * directions, B, H) (``layers.py:272``)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int,
                 bidirectional: bool = False):
        super().__init__(input_size, hidden_size, num_layers, batch_first=True,
                         bidirectional=bidirectional)


def _layer_weights(rnn: nn.RNNBase, name: str):
    return tuple(getattr(rnn, f"{w}_{name}") for w in ("weight_ih", "weight_hh", "bias_ih",
                                                       "bias_hh"))


def _scan_plain(rnn: nn.RNNBase, x: torch.Tensor, state0, cell: Callable):
    """The stacked, optionally bidirectional recurrence of ``rnn`` as a loop:
    each layer's input projection one GEMM over all steps, then the cell per
    step. ``state0`` is a tuple of (L * D, B, H) tensors or None."""
    d = 2 if rnn.bidirectional else 1
    n_state = 2 if isinstance(rnn, nn.LSTM) else 1
    finals = []
    for layer in range(rnn.num_layers):
        outs = []
        for k in range(d):
            w_ih, w_hh, b_ih, b_hh = _layer_weights(rnn, f"l{layer}" + ("_reverse" if k else ""))
            seq = x.flip(1) if k else x
            proj = F.linear(seq, w_ih, b_ih)
            if state0 is None:
                state = tuple(x.new_zeros(x.shape[0], rnn.hidden_size) for _ in range(n_state))
            else:
                state = tuple(s[layer * d + k] for s in state0)
            ys = []
            for t in range(seq.shape[1]):
                state = cell(proj[:, t], F.linear(state[0], w_hh, b_hh), state)
                ys.append(state[0])
            y = torch.stack(ys, dim=1)
            outs.append(y.flip(1) if k else y)
            finals.append(state)
        x = torch.cat(outs, dim=-1)
    return x, tuple(torch.stack([f[i] for f in finals]) for i in range(n_state))


def _gru_cell(xp, hp, state):
    xr, xz, xn = xp.chunk(3, dim=-1)
    hr, hz, hn = hp.chunk(3, dim=-1)
    r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return ((1 - z) * n + z * state[0],)


def _lstm_cell(xp, hp, state):
    i, f, g, o = (xp + hp).chunk(4, dim=-1)
    c = torch.sigmoid(f) * state[1] + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def gru_plain(rnn: nn.GRU, x: torch.Tensor, h0: Optional[torch.Tensor] = None):
    """``rnn(x, h0)`` as a plain loop -> (outputs, h_n)."""
    out, (h,) = _scan_plain(rnn, x, None if h0 is None else (h0,), _gru_cell)
    return out, h


def lstm_plain(rnn: nn.LSTM, x: torch.Tensor,
               state0: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """``rnn(x, (h0, c0))`` as a plain loop -> (outputs, (h_n, c_n))."""
    return _scan_plain(rnn, x, state0, _lstm_cell)
