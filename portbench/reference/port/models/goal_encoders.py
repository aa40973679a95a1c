"""Goal encoders and the trainable language MLP (``hulc2_tpu/models/goal_encoders.py``).

Reference names: ``mlp.{0,2,4}`` + ``ln`` for the visual encoder and
``mlp.{1,3,5}`` + ``ln`` for the language one and ``mlp.{1,3,5}`` for
``LanguageEncoderMLP``, whose Sequentials open with their word dropout: an
inverted dropout on the sentence embedding, its mask from the given
generator. ``l2_normalize_goal_embeddings`` normalises the last linear's
output before the LayerNorm. The goal encoders are ReLU MLPs: the JAX
factory passes them no activation; ``lang_mlp`` takes its config's.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from portbench.reference.port.models.layers import Dense, dropout, get_activation, l2_normalize


def _mlp3(in_features: int, hidden: int, out: int, activation: str) -> list:
    return [Dense(in_features, hidden), get_activation(activation), Dense(hidden, hidden),
            get_activation(activation), Dense(hidden, out)]


class VisualGoalEncoder(nn.Module):
    """Last frame's perceptual embedding -> latent goal + LayerNorm."""

    def __init__(self, in_features: int, hidden_size: int = 2048, latent_goal_features: int = 32,
                 l2_normalize_goal_embeddings: bool = False):
        super().__init__()
        self.l2_normalize = l2_normalize_goal_embeddings
        self.mlp = nn.Sequential(*_mlp3(in_features, hidden_size, latent_goal_features, "ReLU"))
        self.ln = nn.LayerNorm(latent_goal_features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.mlp(x)
        return self.ln(l2_normalize(x) if self.l2_normalize else x)


class _WordDropoutMLP(nn.Module):
    """Word dropout, then a 3-layer MLP (index 0 is the dropout's slot)."""

    def __init__(self, in_features: int, hidden_size: int, out_features: int,
                 word_dropout_p: float, activation_function: str):
        super().__init__()
        self.word_dropout_p = word_dropout_p
        self.mlp = nn.Sequential(nn.Identity(), *_mlp3(in_features, hidden_size, out_features,
                                                       activation_function))

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.mlp(dropout(x, self.word_dropout_p, deterministic, generator))


class LanguageGoalEncoder(_WordDropoutMLP):
    """Sentence embedding -> latent goal + LayerNorm."""

    def __init__(self, in_features: int = 384, hidden_size: int = 2048,
                 latent_goal_features: int = 32, l2_normalize_goal_embeddings: bool = False,
                 word_dropout_p: float = 0.0):
        super().__init__(in_features, hidden_size, latent_goal_features, word_dropout_p, "ReLU")
        self.l2_normalize = l2_normalize_goal_embeddings
        self.ln = nn.LayerNorm(latent_goal_features, eps=1e-5)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = super().forward(x, deterministic, generator)
        return self.ln(l2_normalize(x) if self.l2_normalize else x)


class LanguageEncoderMLP(_WordDropoutMLP):
    """``lang_mlp``: a trainable MLP over precomputed sentence embeddings
    (``goal_encoders.py:59-75``); the goal encoder takes its output."""

    def __init__(self, in_features: int = 384, out_features: int = 256, hidden_size: int = 2048,
                 word_dropout_p: float = 0.0, activation_function: str = "ReLU"):
        super().__init__(in_features, hidden_size, out_features, word_dropout_p,
                         activation_function)
