"""Visual and language goal encoders (``hulc2_tpu/models/goal_encoders.py``).

Reference names: ``mlp.{0,2,4}`` + ``ln`` for the visual encoder and
``mlp.{1,3,5}`` + ``ln`` for the language one, whose Sequential opens with its
word dropout.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from hulc2_torch.models.layers import Dense


def _mlp3(in_features: int, hidden: int, out: int) -> list:
    return [Dense(in_features, hidden), nn.ReLU(), Dense(hidden, hidden), nn.ReLU(),
            Dense(hidden, out)]


def _check_options(l2_normalize_goal_embeddings: bool, activation_function: str) -> None:
    if l2_normalize_goal_embeddings or activation_function != "ReLU":
        raise NotImplementedError(
            "only l2_normalize_goal_embeddings=false and activation_function=ReLU are ported")


class VisualGoalEncoder(nn.Module):
    """Last frame's perceptual embedding -> latent goal + LayerNorm."""

    def __init__(self, in_features: int, hidden_size: int = 2048, latent_goal_features: int = 32,
                 l2_normalize_goal_embeddings: bool = False, activation_function: str = "ReLU"):
        super().__init__()
        _check_options(l2_normalize_goal_embeddings, activation_function)
        self.mlp = nn.Sequential(*_mlp3(in_features, hidden_size, latent_goal_features))
        self.ln = nn.LayerNorm(latent_goal_features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln(self.mlp(x))


class LanguageGoalEncoder(nn.Module):
    """Sentence embedding -> latent goal + LayerNorm. Word dropout is not
    ported (the flagship sets it to 0); index 0 keeps the reference's slot."""

    def __init__(self, in_features: int = 384, hidden_size: int = 2048,
                 latent_goal_features: int = 32, l2_normalize_goal_embeddings: bool = False,
                 word_dropout_p: float = 0.0, activation_function: str = "ReLU"):
        super().__init__()
        _check_options(l2_normalize_goal_embeddings, activation_function)
        if word_dropout_p != 0.0:
            raise NotImplementedError("word dropout is not ported")
        self.mlp = nn.Sequential(nn.Identity(), *_mlp3(in_features, hidden_size, latent_goal_features))
        self.ln = nn.LayerNorm(latent_goal_features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln(self.mlp(x))
