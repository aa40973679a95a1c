"""Plan proposal (prior) and plan recognition (posterior) networks (``models/plan_nets.py``).

Both return fp32 plan logits, as the JAX package pins them. Reference names:
``fc_model.{0,2,4,6}`` + ``fc_state.0`` for the proposal;
``position_embeddings``, ``transformer_encoder.layers.{i}``, ``fc`` and
``fc_state.0`` for the recognition transformer.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from hulc2_torch.models.layers import Dense, TransformerEncoderLayer, dropout


class PlanProposalNetwork(nn.Module):
    """Prior p(z | s0, goal): 4 ReLU layers on (s0 embedding ++ goal)."""

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
    """Posterior q(z | s_1..T): learned positions, post-norm encoder layers,
    fc, mean over the window, fc_state. Returns (logits, seq_feat)."""

    def __init__(self, in_features: int, state_dim: int, num_heads: int = 8, num_layers: int = 2,
                 encoder_hidden_size: int = 2048, fc_hidden_size: int = 4096,
                 max_position_embeddings: int = 32, dropout_p: float = 0.1,
                 encoder_normalize: bool = False, positional_normalize: bool = False):
        super().__init__()
        if encoder_normalize or positional_normalize:
            raise NotImplementedError("encoder/positional LayerNorms are not ported")
        if in_features % num_heads:
            raise NotImplementedError(
                f"feature width {in_features} must divide by num_heads {num_heads}")
        self.dropout_p = dropout_p
        self.position_embeddings = nn.Embedding(max_position_embeddings, in_features)
        self.transformer_encoder = _Encoder([
            TransformerEncoderLayer(in_features, num_heads, encoder_hidden_size, dropout_p)
            for _ in range(num_layers)
        ])
        self.fc = Dense(in_features, fc_hidden_size)
        self.fc_state = nn.Sequential(Dense(fc_hidden_size, state_dim))

    def init_weights(self, generator: torch.Generator) -> None:
        self.position_embeddings.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, perceptual_emb: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        s = perceptual_emb.shape[1]
        x = perceptual_emb + self.position_embeddings.weight[:s]
        x = dropout(x, self.dropout_p, deterministic, generator)
        for layer in self.transformer_encoder.layers:
            x = layer(x, deterministic, generator)
        seq_feat = self.fc(x).mean(dim=1)
        return self.fc_state(seq_feat).float(), seq_feat
