"""CLIP text transformer, the in-graph language tower (``hulc2_tpu/models/clip_text.py``).

OpenAI CLIP's parameter names (``token_embedding``, ``positional_embedding``,
``transformer.resblocks.{i}.{ln_1,attn,ln_2,mlp.c_fc,mlp.c_proj}``,
``ln_final``, ``text_projection``): pre-LN causal blocks with QuickGELU MLPs,
pooling at the EOT token (the highest id of each row). The JAX package runs
the tower in fp32 inside its bf16 model, so this one runs with autocast off.
"""
from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn as nn

from portbench.reference.port.models.layers import MultiHeadAttention


class QuickGELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(1.702 * x)


class LecunDense(nn.Linear):
    """nn.Linear with flax.linen.Dense's default init: normal(0, 1/sqrt(fan_in)), zero bias."""

    def init_weights(self, generator: torch.Generator) -> None:
        self.weight.normal_(0.0, self.in_features ** -0.5, generator=generator)
        self.bias.zero_()


class ClipAttention(MultiHeadAttention):
    """Causal self-attention; flax holds q, k and v as separate lecun-normal
    (E, E) kernels, packed here into ``in_proj_weight``."""

    def init_weights(self, generator: torch.Generator) -> None:
        e = self.out_proj.in_features
        self.in_proj_weight.normal_(0.0, e ** -0.5, generator=generator)
        self.in_proj_bias.zero_()
        self.out_proj.weight.normal_(0.0, e ** -0.5, generator=generator)
        self.out_proj.bias.zero_()


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = ClipAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", LecunDense(width, 4 * width)),
            ("gelu", QuickGELU()),
            ("c_proj", LecunDense(4 * width, width)),
        ]))

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), attn_mask)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList([ResidualAttentionBlock(width, heads) for _ in range(layers)])


class ClipTextTransformer(nn.Module):
    """tokens (B, L) integer ids -> sentence embedding (B, output_dim), fp32."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77, width: int = 512,
                 heads: int = 8, layers: int = 12, output_dim: int = 1024, frozen: bool = True):
        super().__init__()
        self.frozen = frozen
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        self.transformer = Transformer(width, layers, heads)
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.empty(width, output_dim))

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX tower's init distributions for the tower's own parameters:
        flax's default embedding init, normal(0.01) positions, normal(width^-0.5)
        projection (the blocks initialise themselves)."""
        width = self.ln_final.normalized_shape[0]
        self.token_embedding.weight.normal_(0.0, width ** -0.5, generator=generator)
        self.positional_embedding.normal_(0.0, 0.01, generator=generator)
        self.text_projection.normal_(0.0, width ** -0.5, generator=generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        with torch.autocast(device_type=tokens.device.type, enabled=False):
            l = tokens.shape[1]
            x = self.token_embedding(tokens) + self.positional_embedding[:l]
            causal = torch.full((l, l), float("-inf"), device=tokens.device).triu(1)
            for block in self.transformer.resblocks:
                x = block(x, causal)
            x = self.ln_final(x)
            eot = tokens.argmax(dim=-1)
            pooled = x[torch.arange(x.shape[0], device=x.device), eot]
            out = pooled @ self.text_projection
        return out.detach() if self.frozen else out
