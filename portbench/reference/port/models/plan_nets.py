"""Plan proposal (prior) and plan recognition (posterior) networks (``models/plan_nets.py``).

All return the fp32 plan state, as the JAX package pins it; the posteriors
return (state, seq_feat), ``seq_features`` wide. Reference names: ``fc_model.{0,2,4,6}`` +
``fc_state.0`` for the proposal; ``position_embeddings``,
``transformer_encoder.layers.{i}``, ``fc`` and ``fc_state.0`` for the
recognition transformer; ``bilstm`` (an ``nn.LSTM``) for the BiLSTM
posterior, ``fwd{l}``/``bwd{l}`` (one-layer ReLU RNNs) for the BiRNN one.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from portbench.reference.port.models.layers import LSTM, Dense, ReluRNN, TransformerEncoderLayer, dropout


class PlanProposalNetwork(nn.Module):
    """Prior p(z | s0, goal): 4 ReLU layers on (s0 embedding ++ goal); the
    JAX factory never passes the config's activation to it."""

    def __init__(self, in_features: int, state_dim: int, hidden_size: int = 2048):
        super().__init__()
        layers = []
        for i in range(4):
            layers += [Dense(in_features if i == 0 else hidden_size, hidden_size), nn.ReLU()]
        self.fc_model = nn.Sequential(*layers)
        self.fc_state = nn.Sequential(Dense(hidden_size, state_dim))

    def forward(self, initial_percep_emb: torch.Tensor, latent_goal: torch.Tensor) -> torch.Tensor:
        x = self.fc_model(torch.cat([initial_percep_emb, latent_goal], dim=-1))
        return self.fc_state(x).float()


class _Encoder(nn.Module):
    """Holder that gives the layers torch nn.TransformerEncoder's names."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class PlanRecognitionTransformer(nn.Module):
    """Posterior q(z | s_1..T): the features zero-padded to a multiple of
    the heads, learned positions [, LayerNorm], post-norm encoder layers
    [, LayerNorm], fc, mean over the window, fc_state (``plan_nets.py:44``).
    Returns (state, seq_feat)."""

    def __init__(self, in_features: int, state_dim: int, num_heads: int = 8, num_layers: int = 2,
                 encoder_hidden_size: int = 2048, fc_hidden_size: int = 4096,
                 max_position_embeddings: int = 32, dropout_p: float = 0.1,
                 encoder_normalize: bool = False, positional_normalize: bool = False):
        super().__init__()
        self.pad = (-in_features) % num_heads
        width = in_features + self.pad
        self.dropout_p = dropout_p
        self.position_embeddings = nn.Embedding(max_position_embeddings, width)
        self.pos_ln = nn.LayerNorm(width, eps=1e-5) if positional_normalize else None
        self.transformer_encoder = _Encoder([
            TransformerEncoderLayer(width, num_heads, encoder_hidden_size, dropout_p)
            for _ in range(num_layers)
        ])
        self.final_ln = nn.LayerNorm(width, eps=1e-5) if encoder_normalize else None
        self.fc = Dense(width, fc_hidden_size)
        self.fc_state = nn.Sequential(Dense(fc_hidden_size, state_dim))
        self.seq_features = fc_hidden_size

    def init_weights(self, generator: torch.Generator) -> None:
        self.position_embeddings.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, perceptual_emb: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        s = perceptual_emb.shape[1]
        x = perceptual_emb
        if self.pad:
            x = torch.cat([x, x.new_zeros(*x.shape[:2], self.pad)], dim=-1)
        x = x + self.position_embeddings.weight[:s]
        if self.pos_ln is not None:
            x = self.pos_ln(x)
        x = dropout(x, self.dropout_p, deterministic, generator)
        for layer in self.transformer_encoder.layers:
            x = layer(x, deterministic, generator)
        if self.final_ln is not None:
            x = self.final_ln(x)
        seq_feat = self.fc(x).mean(dim=1)
        return self.fc_state(seq_feat).float(), seq_feat


class PlanRecognitionBiLSTM(nn.Module):
    """Posterior over a bidirectional LSTM's outputs: seq_feat is the last
    step of both directions' outputs (``plan_nets.py:88``), 2 x hidden wide."""

    def __init__(self, in_features: int, state_dim: int, hidden_size: int = 2048,
                 num_layers: int = 2):
        super().__init__()
        self.bilstm = LSTM(in_features, hidden_size, num_layers, bidirectional=True)
        self.fc_state = nn.Sequential(Dense(2 * hidden_size, state_dim))
        self.seq_features = 2 * hidden_size

    def forward(self, perceptual_emb: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        x, _ = self.bilstm(perceptual_emb)
        seq_feat = x[:, -1]
        return self.fc_state(seq_feat).float(), seq_feat


class PlanRecognitionBiRNN(nn.Module):
    """Posterior over stacked pairs of one-layer ReLU RNNs, one forward and
    one over the reversed window, their outputs concatenated per layer
    (``plan_nets.py:108``)."""

    def __init__(self, in_features: int, state_dim: int, hidden_size: int = 2048,
                 num_layers: int = 2):
        super().__init__()
        self.num_layers = num_layers
        for layer in range(num_layers):
            fan = in_features if layer == 0 else 2 * hidden_size
            setattr(self, f"fwd{layer}", ReluRNN(fan, hidden_size, 1))
            setattr(self, f"bwd{layer}", ReluRNN(fan, hidden_size, 1))
        self.fc_state = nn.Sequential(Dense(2 * hidden_size, state_dim))
        self.seq_features = 2 * hidden_size

    def forward(self, perceptual_emb: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        x = perceptual_emb
        for layer in range(self.num_layers):
            fwd, _ = getattr(self, f"fwd{layer}")(x)
            bwd, _ = getattr(self, f"bwd{layer}")(x.flip(1))
            x = torch.cat([fwd, bwd.flip(1)], dim=-1)
        seq_feat = x[:, -1]
        return self.fc_state(seq_feat).float(), seq_feat
