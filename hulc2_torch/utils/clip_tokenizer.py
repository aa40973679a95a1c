"""CLIP byte-pair-encoding tokenizer (self-contained, no HuggingFace assets).

Clean-room implementation of OpenAI CLIP's published BPE tokenization
algorithm (reference behavior: hulc2/utils/simple_tokenizer.py,
hulc2/utils/clip_tokenizer.py — both vendored from openai/CLIP, MIT). The
merges table ``assets/bpe_simple_vocab_16e6.txt.gz`` is OpenAI's public
vocabulary artifact. Token ids are compatible with OpenAI CLIP checkpoints
(vocab size 49408, ``<|startoftext|>`` = 49406, ``<|endoftext|>`` = 49407).

Differences from the vendored original: ``ftfy`` text normalization is not
applied (the package is not a dependency here; it is the identity for the
clean ASCII instruction strings this framework tokenizes). HTML entities are
still unescaped twice like the original.

The port's copy of ``hulc2_tpu/utils/clip_tokenizer.py``, unchanged but for its
imports; the port carries its own copy of the asset in ``hulc2_torch/assets``.
"""
from __future__ import annotations

import gzip
import html
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

try:  # \p{L}/\p{N} unicode classes need the third-party regex module
    import regex as _re

    _WORD_PATTERN = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )
except ImportError:  # ASCII fallback (sufficient for CALVIN/TACO annotations)
    import re as _re
    import warnings

    warnings.warn(
        "the 'regex' package is unavailable — CLIP tokenization falls back to "
        "an ASCII-only word pattern; non-ASCII text will tokenize differently "
        "from OpenAI CLIP (install 'regex' to match checkpoints exactly)",
        stacklevel=2,
    )
    _WORD_PATTERN = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-z]+|[0-9]|[^\sa-z0-9]+""",
        _re.IGNORECASE,
    )

ASSET_PATH = Path(__file__).resolve().parent.parent / "assets" / "bpe_simple_vocab_16e6.txt.gz"
CONTEXT_LENGTH = 77  # CLIP's fixed text context
VOCAB_SIZE = 49408
SOT = "<|startoftext|>"
EOT = "<|endoftext|>"


@lru_cache()
def _byte_to_unicode() -> Dict[int, str]:
    """GPT-2-style reversible byte<->printable-unicode mapping: printable
    latin bytes map to themselves, everything else to code points >= 256."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    mapping = {b: chr(b) for b in printable}
    offset = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + offset)
            offset += 1
    return mapping


def _normalize(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return " ".join(text.split()).strip().lower()


class ClipTokenizer:
    """Encode text to CLIP BPE token ids."""

    def __init__(self, bpe_path=ASSET_PATH):
        self._b2u = _byte_to_unicode()
        lines = gzip.open(bpe_path).read().decode("utf-8").split("\n")
        # line 0 is a version banner; the usable merge list is capped so the
        # final vocab is exactly 49408 = 256 bytes + 256 '</w>' + merges + 2
        merges: List[Tuple[str, str]] = [
            tuple(line.split()) for line in lines[1 : 49152 - 256 - 2 + 1]
        ]
        self._merge_rank = {pair: i for i, pair in enumerate(merges)}
        tokens = list(self._b2u.values())
        tokens += [t + "</w>" for t in tokens]
        tokens += ["".join(pair) for pair in merges]
        tokens += [SOT, EOT]
        self.encoder: Dict[str, int] = {t: i for i, t in enumerate(tokens)}
        self.sot_id = self.encoder[SOT]
        self.eot_id = self.encoder[EOT]
        self._bpe_cache: Dict[str, List[str]] = {}

    # ---- BPE ----------------------------------------------------------- #
    def _bpe_parts(self, word: str) -> List[str]:
        """Merge the characters of one whitespace-free word (with the
        word-final marker) by repeatedly applying the lowest-rank merge."""
        cached = self._bpe_cache.get(word)
        if cached is not None:
            return cached
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            candidates = [
                (self._merge_rank[pair], pair)
                for pair in set(zip(parts, parts[1:]))
                if pair in self._merge_rank
            ]
            if not candidates:
                break
            _, (first, second) = min(candidates)
            # merge every (first, second) occurrence left-to-right
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if i + 1 < len(parts) and parts[i] == first and parts[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        self._bpe_cache[word] = parts
        return parts

    # ---- public API ---------------------------------------------------- #
    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in _WORD_PATTERN.findall(_normalize(text)):
            mapped = "".join(self._b2u[b] for b in word.encode("utf-8"))
            ids.extend(self.encoder[part] for part in self._bpe_parts(mapped))
        return ids

    def __call__(self, texts, context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        """Batch-tokenize with SOT/EOT framing, zero padding and truncation:
        (B, context_length) int32 — the array CLIP text towers consume."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for row, text in enumerate(texts):
            ids = [self.sot_id] + self.encode(text) + [self.eot_id]
            if len(ids) > context_length:  # keep EOT as the final token
                ids = ids[: context_length - 1] + [self.eot_id]
            out[row, : len(ids)] = ids
        return out


@lru_cache()
def default_tokenizer() -> ClipTokenizer:
    return ClipTokenizer()


def tokenize(texts, context_length: int = CONTEXT_LENGTH) -> np.ndarray:
    return default_tokenizer()(texts, context_length)
