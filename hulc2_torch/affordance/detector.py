"""Pixel affordance + depth detector, the high level of the hierarchy
(``hulc2_tpu/affordance/detector.py:37-270``).

``AffordanceDetector`` builds every ``aff_detection`` group: the LingUNet
stream (any encoder, fuser and decoder precision, ``lingunet.py``) gives one
logit per pixel and its bottleneck, and the depth head (``gaussian``,
``logistic`` or none) a depth distribution on the pooled bottleneck ++
language. The language is either integer CLIP-BPE token ids that the
detector's own text tower embeds (``text_tower``), or (B, E) float sentence
embeddings; each kind is refused where the other is expected. Images enter
NHWC in [0, 1], as in the JAX package. ``compute_loss`` is ``aff * CE(softmax
over H*W, target pixel) + depth * NLL`` (0.1 / 0.9), ``compute_mask_loss``
the mask labels' ``aff * (BCE + dice) / 2 + depth * NLL``; without a depth
head there is no depth term. The word fusers are refused at build: the
decoder hands every fuser the (B, E) sentence, and JAX's detector fails on
them too.

``AffordancePredictor`` is the evaluation's interface: uint8 frames and the
model's language input (or captions through ``lang_table``) -> per frame
the argmax pixel as (x, y) at the frame's resolution, a depth sampled from
the head's draws, and the softmax heatmap. The frames go to the device as
uint8 and are resized there; the batch runs as one forward. Unlike the JAX
predictor it does not pad the batch to a power of two: no compile is saved
by it here, and each row's result is the same.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from hulc2_torch.affordance.depth_heads import DEPTH_HEADS, DepthNorm
from hulc2_torch.affordance.fusion import WORD_FUSERS
from hulc2_torch.affordance.lingunet import LingUNet
from hulc2_torch.affordance.losses import mask_criterion
from hulc2_torch.models.clip_text import ClipTextTransformer
from hulc2_torch.ops.preprocess import resize

LOSS_WEIGHTS = {"aff": 0.1, "depth": 0.9}


class AffordanceOutput(NamedTuple):
    aff_logits: torch.Tensor  # (B, H*W) fp32
    depth_pred: Optional[tuple]  # the head's outputs, None without a head
    hw: Tuple[int, int]


class AffordanceDetector(nn.Module):
    def __init__(self, decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 fusion_type: str = "mult", lang_embed_dim: int = 384, normalize_depth: bool = True,
                 tower_width: int = 256, tower_heads: int = 4, tower_layers: int = 2,
                 encoder_name: str = "resnet18", depth_dist: Optional[str] = "gaussian",
                 freeze_encoder: bool = True, compute_dtype: Optional[str] = None,
                 text_tower: bool = True, input_hw: int = 224):
        super().__init__()
        if fusion_type in WORD_FUSERS:
            raise NotImplementedError(
                f"fusion {fusion_type!r} takes per-word features (B, T, E), and the decoder hands "
                "every fuser the (B, E) sentence: the JAX detector cannot run it either")
        if depth_dist not in (None, *DEPTH_HEADS):
            raise ValueError(f"depth_dist {depth_dist!r}: one of {sorted(DEPTH_HEADS)} or none")
        self.lang_embed_dim = lang_embed_dim
        self.normalize_depth = normalize_depth
        self.text_tower = text_tower
        if text_tower:
            self.lang_tower = ClipTextTransformer(width=tower_width, heads=tower_heads,
                                                  layers=tower_layers, output_dim=lang_embed_dim,
                                                  frozen=False)
        self.aff_stream = LingUNet(decoder_channels, fusion_type, lang_embed_dim,
                                   encoder_name=encoder_name, freeze_encoder=freeze_encoder,
                                   compute_dtype=getattr(torch, compute_dtype) if compute_dtype
                                   else None, input_hw=input_hw)
        self.depth_stream = None
        if depth_dist:
            kw = {"normalized": normalize_depth} if depth_dist == "logistic" else {}
            self.depth_stream = DEPTH_HEADS[depth_dist](self.aff_stream.bottleneck_channels,
                                                        lang_embed_dim, **kw)

    def forward(self, img: torch.Tensor, lang: torch.Tensor) -> AffordanceOutput:
        """img (B, H, W, 3) float in [0, 1]; lang (B, 77) integer token ids with
        the text tower, else (B, E) float sentence embeddings."""
        if self.text_tower and lang.is_floating_point():
            raise TypeError(f"the token-tower detector takes integer token ids, got {lang.dtype}")
        if not self.text_tower and not lang.is_floating_point():
            raise TypeError(f"the detector without a text tower takes float sentence "
                            f"embeddings, got {lang.dtype}")
        b, h, w, _ = img.shape
        if self.text_tower:
            lang = self.lang_tower(lang)
        logits, bottleneck = self.aff_stream(img.permute(0, 3, 1, 2).contiguous(), lang)
        if tuple(logits.shape[2:]) != (h, w):
            raise ValueError(f"decoder output {tuple(logits.shape[2:])} != input {(h, w)}: "
                             "decoder_channels needs one block more than the encoder's 4 skips")
        depth_pred = None
        if self.depth_stream is not None:
            depth_pred = self.depth_stream(bottleneck.mean(dim=(2, 3)), lang)
        return AffordanceOutput(logits.reshape(b, h * w), depth_pred, (h, w))

    def _depth_term(self, out: AffordanceOutput, total: torch.Tensor, metrics: dict,
                    target_depth: Optional[torch.Tensor], loss_weights: Dict[str, float]):
        if out.depth_pred is not None and target_depth is not None:
            depth_loss = self.depth_stream.loss(out.depth_pred, target_depth.reshape(-1, 1))
            total = total + loss_weights["depth"] * depth_loss
            metrics["depth_loss"] = depth_loss
        metrics["total_loss"] = total
        return total, metrics

    def compute_loss(self, out: AffordanceOutput, target_px: torch.Tensor,
                     target_depth: Optional[torch.Tensor],
                     loss_weights: Dict[str, float] = LOSS_WEIGHTS):
        """target_px (B, 2) (row, col); target_depth (B,) -> (total, metrics)."""
        h, w = out.hw
        flat_idx = (target_px[:, 0] * w + target_px[:, 1]).long()
        logp = F.log_softmax(out.aff_logits, dim=-1)
        aff_loss = -logp.gather(1, flat_idx[:, None]).mean()
        return self._depth_term(out, loss_weights["aff"] * aff_loss, {"aff_loss": aff_loss},
                                target_depth, loss_weights)

    def compute_mask_loss(self, out: AffordanceOutput, mask: torch.Tensor,
                          target_depth: Optional[torch.Tensor] = None,
                          loss_weights: Dict[str, float] = LOSS_WEIGHTS):
        """mask (B, H, W) binary -> (total, metrics with mask_bce, dice_loss, miou)."""
        aff_loss, metrics = mask_criterion(out.aff_logits, mask)
        return self._depth_term(out, loss_weights["aff"] * aff_loss, metrics, target_depth,
                                loss_weights)

    def depth_draws(self, n: int, generator: torch.Generator, device):
        """The depth head's sampler draws for ``n`` rows (None without a head)."""
        return None if self.depth_stream is None else self.depth_stream.draws(n, generator, device)

    def predict_from_output(self, out: AffordanceOutput, draws, depth_norm: Optional[DepthNorm]):
        """(argmax pixel (B, 2) (row, col), depth (B, 1) from the head's
        ``draws`` (None without a head), softmax heatmap (B, H, W))."""
        h, w = out.hw
        probs = torch.softmax(out.aff_logits, dim=-1)
        flat = probs.argmax(dim=-1)
        px = torch.stack([flat // w, flat % w], dim=-1)
        depth = None
        if out.depth_pred is not None:
            depth = self.depth_stream.sample(draws, out.depth_pred,
                                             depth_norm if self.normalize_depth else None)
        return px, depth, probs.reshape(-1, h, w)


def _to(draws, device):
    if draws is None:
        return None
    return tuple(d.to(device) for d in draws) if isinstance(draws, tuple) else draws.to(device)


class AffordancePredictor:
    def __init__(self, model: AffordanceDetector, depth_norm: Optional[DepthNorm] = None,
                 input_hw: Tuple[int, int] = (224, 224), seed: int = 0,
                 lang_table: Optional[Dict[str, np.ndarray]] = None):
        """``model`` lives on the device the predictor runs on; its depth draws
        come from a generator there, seeded by ``seed``."""
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.depth_norm = depth_norm or DepthNorm()
        self.input_hw = tuple(input_hw)
        self.lang_table = lang_table or {}
        self.uses_tokens = model.text_tower
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _resolve_lang(self, lang) -> np.ndarray:
        if isinstance(lang, str):
            try:
                lang = self.lang_table[lang]
            except KeyError:
                raise KeyError(f"no affordance language input for caption {lang!r}: provide a "
                               "lang_table (caption -> token ids or embedding) to "
                               "AffordancePredictor") from None
        lang = np.asarray(lang)
        return lang if np.issubdtype(lang.dtype, np.integer) else lang.astype(np.float32)

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
                      draws=None) -> list:
        """N (frame, instruction) pairs in one forward. ``draws`` overrides the
        depth head's draws (``AffordanceDetector.depth_draws``)."""
        n = len(imgs_uint8)
        if n == 0:
            return []
        imgs = [np.asarray(im) for im in imgs_uint8]
        lang = torch.from_numpy(np.stack([self._resolve_lang(e) for e in langs])).to(self.device)
        if draws is None:
            draws = self.model.depth_draws(n, self.generator, self.device)
        with torch.inference_mode():
            out = self.model(self._frames(imgs), lang)
            px, depth, heat = self.model.predict_from_output(out, _to(draws, self.device),
                                                             self.depth_norm)
            px, heat = px.cpu().numpy(), heat.cpu().numpy()
            depth = None if depth is None else depth.reshape(n).cpu().numpy()
        outs = []
        for i in range(n):
            # back to the frame's resolution; (row, col) -> (x, y)
            sy = imgs[i].shape[0] / self.input_hw[0]
            sx = imgs[i].shape[1] / self.input_hw[1]
            res = {"pixel": (int(px[i, 1] * sx), int(px[i, 0] * sy)), "softmax": heat[i]}
            if depth is not None:
                res["depth"] = float(depth[i])
            outs.append(res)
        return outs
