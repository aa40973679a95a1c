"""Pixel affordance + depth detector, the high level of the hierarchy
(``hulc2_tpu/affordance/detector.py:37-270``).

``AffordanceDetector`` is the ``rn18_tokens_pixel`` detector: a CLIP-BPE text
tower embeds the instruction's token ids, the LingUNet stream gives one logit
per pixel and its bottleneck, and the Gaussian head a depth distribution on
the pooled bottleneck ++ language. Images enter NHWC in [0, 1], as in the
JAX package. The loss is ``aff * CE(softmax over H*W, target pixel) + depth *
Gaussian NLL`` (0.1 / 0.9).

``AffordancePredictor`` is the evaluation's interface: uint8 frames and token
ids (or captions through ``lang_table``) -> per frame the argmax pixel as (x,
y) at the frame's resolution, a depth sampled from standard normal draws, and
the softmax heatmap. The frames go to the device as uint8 and are resized
there; the batch runs as one forward. Unlike the JAX predictor it does not pad
the batch to a power of two: no compile is saved by it here, and each row's
result is the same.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from hulc2_torch.affordance.depth_heads import DepthNorm, GaussianDepthHead
from hulc2_torch.affordance.lingunet import LingUNet
from hulc2_torch.models.clip_text import ClipTextTransformer
from hulc2_torch.ops.preprocess import resize

LOSS_WEIGHTS = {"aff": 0.1, "depth": 0.9}


class AffordanceOutput(NamedTuple):
    aff_logits: torch.Tensor  # (B, H*W) fp32
    depth_pred: Tuple[torch.Tensor, torch.Tensor]  # (mu, sigma), each (B, 1)
    hw: Tuple[int, int]


class AffordanceDetector(nn.Module):
    def __init__(self, decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 fusion_type: str = "mult", lang_embed_dim: int = 384, normalize_depth: bool = True,
                 tower_width: int = 256, tower_heads: int = 4, tower_layers: int = 2):
        super().__init__()
        self.lang_embed_dim = lang_embed_dim
        self.normalize_depth = normalize_depth
        self.lang_tower = ClipTextTransformer(width=tower_width, heads=tower_heads,
                                              layers=tower_layers, output_dim=lang_embed_dim,
                                              frozen=False)
        self.aff_stream = LingUNet(decoder_channels, fusion_type, lang_embed_dim)
        self.depth_stream = GaussianDepthHead(LingUNet.bottleneck_channels, lang_embed_dim)

    def forward(self, img: torch.Tensor, tokens: torch.Tensor) -> AffordanceOutput:
        """img (B, H, W, 3) float in [0, 1], tokens (B, 77) integer ids."""
        if tokens.is_floating_point():
            raise TypeError(f"the token-tower detector takes integer token ids, got {tokens.dtype}")
        b, h, w, _ = img.shape
        lang = self.lang_tower(tokens)
        logits, bottleneck = self.aff_stream(img.permute(0, 3, 1, 2).contiguous(), lang)
        if tuple(logits.shape[2:]) != (h, w):
            raise ValueError(f"decoder output {tuple(logits.shape[2:])} != input {(h, w)}: "
                             "decoder_channels needs one block more than the encoder's 4 skips")
        depth_pred = self.depth_stream(bottleneck.mean(dim=(2, 3)), lang)
        return AffordanceOutput(logits.reshape(b, h * w), depth_pred, (h, w))

    @staticmethod
    def compute_loss(out: AffordanceOutput, target_px: torch.Tensor, target_depth: torch.Tensor,
                     loss_weights: Dict[str, float] = LOSS_WEIGHTS):
        """target_px (B, 2) (row, col); target_depth (B,) -> (total, metrics)."""
        h, w = out.hw
        flat_idx = (target_px[:, 0] * w + target_px[:, 1]).long()
        logp = F.log_softmax(out.aff_logits, dim=-1)
        aff_loss = -logp.gather(1, flat_idx[:, None]).mean()
        depth_loss = GaussianDepthHead.loss(out.depth_pred, target_depth.reshape(-1, 1))
        total = loss_weights["aff"] * aff_loss + loss_weights["depth"] * depth_loss
        return total, {"aff_loss": aff_loss, "depth_loss": depth_loss, "total_loss": total}

    def predict_from_output(self, out: AffordanceOutput, normal: torch.Tensor,
                            depth_norm: Optional[DepthNorm]):
        """(argmax pixel (B, 2) (row, col), depth (B, 1) from the normal draws
        ``normal`` (B, 1), softmax heatmap (B, H, W))."""
        h, w = out.hw
        probs = torch.softmax(out.aff_logits, dim=-1)
        flat = probs.argmax(dim=-1)
        px = torch.stack([flat // w, flat % w], dim=-1)
        depth = GaussianDepthHead.sample(normal, out.depth_pred,
                                         depth_norm if self.normalize_depth else None)
        return px, depth, probs.reshape(-1, h, w)


class AffordancePredictor:
    def __init__(self, model: AffordanceDetector, depth_norm: Optional[DepthNorm] = None,
                 input_hw: Tuple[int, int] = (224, 224), seed: int = 0,
                 lang_table: Optional[Dict[str, np.ndarray]] = None):
        """``model`` lives on the device the predictor runs on; its normal
        draws come from a generator there, seeded by ``seed``."""
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.depth_norm = depth_norm or DepthNorm()
        self.input_hw = tuple(input_hw)
        self.lang_table = lang_table or {}
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _resolve_lang(self, lang) -> np.ndarray:
        if isinstance(lang, str):
            try:
                lang = self.lang_table[lang]
            except KeyError:
                raise KeyError(f"no affordance token ids for caption {lang!r}: provide a "
                               "lang_table (caption -> token ids) to AffordancePredictor") from None
        return np.asarray(lang)

    def predict(self, img_uint8: np.ndarray, lang) -> Dict:
        return self.predict_batch([img_uint8], [lang])[0]

    def _frames(self, imgs: Sequence[np.ndarray]) -> torch.Tensor:
        """uint8 (H, W, 3) frames -> (N, h, w, 3) float in [0, 1] at input_hw on
        the device; frames of mixed shapes are resized one by one."""
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device).float() / 255.0

        if len({im.shape for im in imgs}) > 1:
            return torch.cat([resize(dev(im[None]), *self.input_hw) for im in imgs])
        return resize(dev(np.stack(imgs)), *self.input_hw)

    def predict_batch(self, imgs_uint8: Sequence[np.ndarray], langs: Sequence,
                      normal: Optional[torch.Tensor] = None) -> list:
        """N (frame, instruction) pairs in one forward. ``normal`` (N, 1)
        overrides the depth's standard normal draws."""
        n = len(imgs_uint8)
        if n == 0:
            return []
        imgs = [np.asarray(im) for im in imgs_uint8]
        tokens = torch.from_numpy(np.stack([self._resolve_lang(e) for e in langs])).to(self.device)
        if normal is None:
            normal = torch.randn((n, 1), generator=self.generator, device=self.device)
        with torch.inference_mode():
            out = self.model(self._frames(imgs), tokens)
            px, depth, heat = self.model.predict_from_output(out, normal.to(self.device),
                                                             self.depth_norm)
            px, depth, heat = px.cpu().numpy(), depth.reshape(n).cpu().numpy(), heat.cpu().numpy()
        outs = []
        for i in range(n):
            # back to the frame's resolution; (row, col) -> (x, y)
            sy = imgs[i].shape[0] / self.input_hw[0]
            sx = imgs[i].shape[1] / self.input_hw[1]
            outs.append({"pixel": (int(px[i, 1] * sx), int(px[i, 0] * sy)), "softmax": heat[i],
                         "depth": float(depth[i])})
        return outs
