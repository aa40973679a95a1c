"""Auxiliary-loss heads (``hulc2_tpu/models/aux_nets.py``)."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from portbench.reference.port.models.layers import Dense


class ProjVisLang(nn.Module):
    """Projections of the posterior's sequence features and the language goal
    into one space for the CLIP-style loss (the JAX factory always projects
    both sides, whatever ``proj_lang`` says). Reference names
    ``mlp_im.{0,2}``, ``mlp_lang.{0,2}``."""

    def __init__(self, vis_features: int, lang_features: int, output_dim: int = 32):
        super().__init__()
        self.mlp_im = nn.Sequential(Dense(vis_features, 128), nn.ReLU(), Dense(128, output_dim))
        self.mlp_lang = nn.Sequential(Dense(lang_features, 128), nn.ReLU(), Dense(128, output_dim))

    def forward(self, vis_emb: torch.Tensor, lang_emb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.mlp_im(vis_emb), self.mlp_lang(lang_emb)


class _TwoLayer(nn.Module):
    """fc0, ReLU, fc1."""

    def __init__(self, in_features: int, hidden_size: int, out_features: int):
        super().__init__()
        self.fc0 = Dense(in_features, hidden_size)
        self.fc1 = Dense(hidden_size, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc1(torch.relu(self.fc0(x)))


class StateDecoder(_TwoLayer):
    """Proprioceptive state from the perceptual embedding (``aux_nets.py:38``)."""

    def __init__(self, in_features: int, n_state_obs: int = 8, hidden_size: int = 256):
        super().__init__(in_features, hidden_size, n_state_obs)


class BCZLangDecoder(_TwoLayer):
    """The language embedding from the posterior's sequence features
    (BC-Z, ``aux_nets.py:52``)."""

    def __init__(self, in_features: int, lang_dim: int = 384, hidden_size: int = 512):
        super().__init__(in_features, hidden_size, lang_dim)


class MIALangDiscriminator(_TwoLayer):
    """One logit of whether sequence features and a language embedding
    belong together (MIA, ``aux_nets.py:66``)."""

    def __init__(self, vis_features: int, lang_features: int, hidden_size: int = 512):
        super().__init__(vis_features + lang_features, hidden_size, 1)

    def forward(self, vis_feat: torch.Tensor, lang_emb: torch.Tensor) -> torch.Tensor:
        return super().forward(torch.cat([vis_feat, lang_emb], dim=-1))


class LangTaskHead(nn.Module):
    """Task classifier on the language tower's output (training only); its
    output layer runs in fp32 as in the JAX package."""

    def __init__(self, in_features: int, n_tasks: int = 34, hidden_size: int = 256):
        super().__init__()
        self.fc0 = Dense(in_features, hidden_size)
        self.fc1 = Dense(hidden_size, n_tasks)

    def forward(self, lang_emb: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.fc0(lang_emb))
        with torch.autocast(device_type=x.device.type, enabled=False):
            return self.fc1(x.float())


class ClipProj(nn.Module):
    """A linear projection of CLIP features (``aux_nets.py:105``; the
    reference's ``decoders/clip_proj.py``). No policy of either package
    builds it."""

    def __init__(self, in_features: int, output_dim: int = 512):
        super().__init__()
        self.proj = Dense(in_features, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)
