"""Frozen language towers with one interface (``hulc2_tpu/models/language.py``).

Counterparts of the reference's language encoders (reference:
hulc2/models/encoders/language_network.py:13 SBert,
hulc2/models/encoders/clip_lang_encoder.py:9 LangClip,
hulc2/affordance/models/language_encoders/{sbert,bert,distilbert,clip}_lang_encoder.py).
``encode_text(sentences)`` returns ``(sentence (B, E), tokens (B, T, E) |
None, mask (B, T) | None)`` as tensors on the encoder's device; calling an
encoder gives the sentence embedding, and ``embed(sentences)`` gives it as a
float32 numpy array, the ``embed_fn`` of ``tools/auto_lang_annotator.py``.

- ``PrecomputedLangEmbeddings``: a sentence -> embedding table from an
  ``embeddings.npy`` (the reference's ``load_lang_embeddings`` path), numpy.
- ``OfflineClipTextEncoder``: the port's CLIP text tower
  (``models/clip_text.py``, OpenAI's parameter names) with the repo's BPE
  tokenizer, loading the text keys of an OpenAI ``state_dict`` ``.pt``
  directly; without a file it runs from a seeded random init.
- ``SBertEncoder`` (mask-weighted mean of the last hidden states),
  ``ClipTextEncoder`` (the projected ``text_embeds``) and ``BertEncoder``
  (the CLS state) over ``transformers``' PyTorch models, from a local
  directory only: nothing is downloaded, and a missing directory raises
  naming it. ``transformers`` is imported when one is built.

Every encoder is an ``nn.Module`` on the card unless ``device="cpu"``.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from hulc2_torch.models.clip_text import ClipTextTransformer
from hulc2_torch.models.layers import init_weights_
from hulc2_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


class PrecomputedLangEmbeddings:
    """Sentence -> embedding lookup built from embeddings.npy (numpy)."""

    def __init__(self, table: Dict[str, np.ndarray]):
        self.table = {k: np.asarray(v, np.float32).squeeze() for k, v in table.items()}
        self.dim = next(iter(self.table.values())).shape[-1] if table else 0

    @classmethod
    def from_embeddings_npy(cls, path) -> "PrecomputedLangEmbeddings":
        data = np.load(path, allow_pickle=True).item()
        return cls({v["ann"][0]: v["emb"] for v in data.values()})

    def encode_text(self, sentences: Sequence[str]):
        emb = np.stack([self.table[s] for s in sentences])
        return emb, None, None

    def __call__(self, sentences):
        return self.encode_text(sentences)[0]


class _TextEncoder(nn.Module):
    """``forward`` is the sentence embedding; ``embed`` the same on the host."""

    def forward(self, sentences: Sequence[str]) -> torch.Tensor:
        return self.encode_text(sentences)[0]

    def embed(self, sentences: Sequence[str]) -> np.ndarray:
        return self(list(sentences)).float().cpu().numpy()


def _local_dir(model_path) -> str:
    if not Path(model_path).is_dir():
        raise FileNotFoundError(
            f"{model_path}: no such local model directory; the port loads HuggingFace "
            "checkpoints from disk only and downloads nothing")
    return str(model_path)


class _HFEncoder(_TextEncoder):
    """A tokenizer and a frozen ``transformers`` model from a local directory."""

    def __init__(self, model_path, model_cls: str, device=None):
        super().__init__()
        import transformers

        path = _local_dir(model_path)
        self.device = resolve_device(device)
        self.tokenizer = transformers.AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.model = getattr(transformers, model_cls).from_pretrained(
            path, local_files_only=True).to(self.device).eval()
        self.model.requires_grad_(False)

    def _run(self, sentences: Sequence[str]):
        toks = self.tokenizer(list(sentences), padding=True, truncation=True, return_tensors="pt")
        toks = {k: v.to(self.device) for k, v in toks.items()}
        with torch.no_grad():
            return self.model(**toks), toks["attention_mask"]


class SBertEncoder(_HFEncoder):
    """sentence-transformers (MiniLM, 384-d): a BERT backbone and the
    attention-masked mean of its last hidden states."""

    def __init__(self, model_path: str, device=None):
        super().__init__(model_path, "AutoModel", device)

    def encode_text(self, sentences: Sequence[str]):
        out, mask = self._run(sentences)
        hidden = out.last_hidden_state  # (B, T, E)
        m = mask[..., None].to(hidden.dtype)
        pooled = (hidden * m).sum(dim=1) / (m.sum(dim=1)).clamp_min(1e-9)
        return pooled, hidden, mask.bool()


class ClipTextEncoder(_HFEncoder):
    """HuggingFace's CLIP text tower: the projected embedding (1024-d for RN50
    checkpoints, 512-d for ViT-B/32)."""

    def __init__(self, model_path: str, device=None):
        super().__init__(model_path, "CLIPTextModelWithProjection", device)

    def encode_text(self, sentences: Sequence[str]):
        out, mask = self._run(sentences)
        return out.text_embeds, out.last_hidden_state, mask.bool()


class BertEncoder(_HFEncoder):
    """BERT or DistilBERT: the CLS token's last hidden state."""

    def __init__(self, model_path: str, device=None):
        super().__init__(model_path, "AutoModel", device)

    def encode_text(self, sentences: Sequence[str]):
        out, mask = self._run(sentences)
        hidden = out.last_hidden_state
        return hidden[:, 0], hidden, mask.bool()


def clip_text_shapes(sd: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """The tower's sizes from an OpenAI CLIP ``state_dict``'s text keys, as
    the JAX package's ``convert_clip_text`` reads them (heads: width / 64)."""
    width = sd["ln_final.weight"].shape[0]
    layers = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("transformer.resblocks."))
    return dict(vocab_size=sd["token_embedding.weight"].shape[0],
                context_length=sd["positional_embedding"].shape[0], width=width,
                heads=max(1, width // 64), layers=layers,
                output_dim=sd["text_projection"].shape[1])


class OfflineClipTextEncoder(_TextEncoder):
    """The CLIP text tower with the repo's BPE tokenizer: the text keys of an
    OpenAI CLIP checkpoint (a ``state_dict`` ``.pt``, the ``visual.`` keys
    and ``logit_scale`` ignored; a missing text key raises), or without one
    a random init from ``seed`` (shapes and smoke runs only)."""

    def __init__(self, ckpt_path: Optional[str] = None, device=None, seed: int = 0,
                 **tower_kwargs):
        super().__init__()
        from hulc2_torch.utils.clip_tokenizer import default_tokenizer

        self.tokenizer = default_tokenizer()
        self.device = resolve_device(device)
        if ckpt_path is not None:
            sd = torch.load(ckpt_path, map_location="cpu", weights_only=False)
            sd = sd.get("state_dict", sd)
            sd = {k: v for k, v in sd.items() if not k.startswith("visual.")}
            self.model = ClipTextTransformer(**{**clip_text_shapes(sd), **tower_kwargs})
            own = self.model.state_dict()
            missing = sorted(set(own) - set(sd))
            if missing:
                raise KeyError(f"{ckpt_path}: the CLIP text tower's keys {missing} are missing")
            self.model.load_state_dict({k: sd[k] for k in own})
        else:
            self.model = ClipTextTransformer(**tower_kwargs)
            init_weights_(self.model, torch.Generator().manual_seed(seed))
        self.model.to(self.device).eval()
        self.model.requires_grad_(False)

    def encode_text(self, sentences: Sequence[str]):
        toks = self.tokenizer(list(sentences), self.model.positional_embedding.shape[0])
        with torch.no_grad():
            emb = self.model(torch.as_tensor(np.asarray(toks), dtype=torch.long,
                                             device=self.device))
        return emb, None, None


def build_lang_encoder(kind: str, model_path: Optional[str] = None, embeddings_path=None,
                       device=None):
    """One of the reference's language encoders by name; the HuggingFace
    kinds default to the hub names the JAX package uses, which must be
    local directories here."""
    if kind == "precomputed":
        return PrecomputedLangEmbeddings.from_embeddings_npy(embeddings_path)
    if kind == "sbert":
        return SBertEncoder(model_path or "sentence-transformers/paraphrase-MiniLM-L3-v2",
                            device=device)
    if kind == "clip":
        return ClipTextEncoder(model_path or "openai/clip-vit-base-patch32", device=device)
    if kind == "clip_offline":
        return OfflineClipTextEncoder(model_path, device=device)
    if kind in ("bert", "distilbert"):
        return BertEncoder(model_path or ("distilbert-base-uncased" if kind == "distilbert"
                                          else "bert-base-uncased"), device=device)
    raise ValueError(kind)
