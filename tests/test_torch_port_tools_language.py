"""The port's language encoders (``hulc2_torch/models/language.py``) against the JAX package's.

``OfflineClipTextEncoder`` on both sides loads one tiny random OpenAI-format
CLIP ``state_dict`` saved to a ``.pt``; the HuggingFace kinds load one tiny
random BERT (and CLIP text model) saved with a small vocabulary, JAX's Flax
model through ``from_pt=True`` and the port's PyTorch model directly. The
outputs must agree to rel 1e-5. Also: the embeddings table, the random
init, and the errors for a missing key or a missing local directory.
"""
import numpy as np
import pytest
import torch

from hulc2_torch.models import language
from hulc2_torch.tools.auto_lang_annotator import hash_embed

SENTENCES = ["open the drawer", "push the red block to the left", "lift the pink block"]


def rel_close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-6)


def clip_state_dict(width=128, layers=2, out=48, seed=0) -> dict:
    """A random OpenAI CLIP state_dict's text keys (and two it ignores)."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale=0.05):
        return torch.randn(*shape, generator=g) * scale

    sd = {"token_embedding.weight": r(49408, width, scale=0.02),
          "positional_embedding": r(77, width, scale=0.01),
          "ln_final.weight": 1 + r(width), "ln_final.bias": r(width),
          "text_projection": r(width, out), "logit_scale": torch.tensor(4.6),
          "visual.conv1.weight": r(8, 3, 2, 2)}
    for i in range(layers):
        p = f"transformer.resblocks.{i}"
        sd.update({f"{p}.ln_1.weight": 1 + r(width), f"{p}.ln_1.bias": r(width),
                   f"{p}.ln_2.weight": 1 + r(width), f"{p}.ln_2.bias": r(width),
                   f"{p}.attn.in_proj_weight": r(3 * width, width),
                   f"{p}.attn.in_proj_bias": r(3 * width),
                   f"{p}.attn.out_proj.weight": r(width, width),
                   f"{p}.attn.out_proj.bias": r(width),
                   f"{p}.mlp.c_fc.weight": r(4 * width, width), f"{p}.mlp.c_fc.bias": r(4 * width),
                   f"{p}.mlp.c_proj.weight": r(width, 4 * width),
                   f"{p}.mlp.c_proj.bias": r(width)})
    return sd


def test_offline_clip_encoder_matches_jax(tmp_path):
    from hulc2_tpu.models.language import OfflineClipTextEncoder as JaxEncoder

    ckpt = tmp_path / "clip.pt"
    torch.save(clip_state_dict(), ckpt)
    port = language.OfflineClipTextEncoder(str(ckpt), device="cpu")
    assert port.model.transformer.resblocks[0].attn.num_heads == 2  # width / 64, as JAX reads it
    want = JaxEncoder(str(ckpt)).encode_text(SENTENCES)[0]
    sentence, tokens, mask = port.encode_text(SENTENCES)
    assert tokens is None and mask is None and sentence.device.type == "cpu"
    rel_close(sentence, want)
    rel_close(port.embed(SENTENCES), want)
    rel_close(port(SENTENCES), want)


def test_offline_clip_encoder_refuses_a_missing_text_key(tmp_path):
    sd = clip_state_dict(layers=1)
    del sd["transformer.resblocks.0.mlp.c_fc.bias"]
    torch.save({"state_dict": sd}, tmp_path / "clip.pt")
    with pytest.raises(KeyError, match="c_fc.bias"):
        language.OfflineClipTextEncoder(str(tmp_path / "clip.pt"), device="cpu")


def test_offline_clip_random_init_is_seeded():
    kw = dict(width=64, heads=2, layers=1, output_dim=24, device="cpu")
    a = language.OfflineClipTextEncoder(**kw).embed(SENTENCES)
    assert a.shape == (3, 24) and a.dtype == np.float32 and np.isfinite(a).all()
    np.testing.assert_array_equal(a, language.OfflineClipTextEncoder(**kw).embed(SENTENCES))
    assert not np.array_equal(a, language.OfflineClipTextEncoder(seed=1, **kw).embed(SENTENCES))


def test_precomputed_table_matches_jax(tmp_path):
    from hulc2_tpu.models.language import PrecomputedLangEmbeddings as JaxTable

    table = {f"t{i}": {"ann": [s], "emb": hash_embed([s], 12)} for i, s in enumerate(SENTENCES)}
    np.save(tmp_path / "embeddings.npy", table)
    port = language.build_lang_encoder("precomputed", embeddings_path=tmp_path / "embeddings.npy")
    jax_table = JaxTable.from_embeddings_npy(tmp_path / "embeddings.npy")
    assert port.dim == jax_table.dim == 12
    np.testing.assert_array_equal(port.encode_text(SENTENCES[::-1])[0],
                                  jax_table.encode_text(SENTENCES[::-1])[0])
    np.testing.assert_array_equal(port(SENTENCES), jax_table(SENTENCES))


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    d = tmp_path_factory.mktemp("bert")
    words = sorted({w for s in SENTENCES for w in s.split()} | {"block", "blue"})
    (d / "vocab.txt").write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *words])
                                 + "\n")
    transformers.BertTokenizer(str(d / "vocab.txt")).save_pretrained(d)
    torch.manual_seed(0)
    cfg = transformers.BertConfig(vocab_size=5 + len(words), hidden_size=32, num_hidden_layers=2,
                                  num_attention_heads=2, intermediate_size=64,
                                  max_position_embeddings=32)
    transformers.BertModel(cfg).eval().save_pretrained(d, safe_serialization=False)
    return d


@pytest.mark.parametrize("kind", ["sbert", "bert"])
def test_hf_bert_kinds_match_jax(bert_dir, kind):
    from hulc2_tpu.models import language as jax_language

    jax_enc = jax_language.build_lang_encoder(kind, str(bert_dir))
    port = language.build_lang_encoder(kind, str(bert_dir), device="cpu")
    want = jax_enc.encode_text(SENTENCES)
    got = port.encode_text(SENTENCES)
    for g, w in zip(got[:2], want[:2]):
        rel_close(g, w)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    rel_close(port.embed(SENTENCES), want[0])


def test_hf_clip_kind_matches_jax(tmp_path):
    transformers = pytest.importorskip("transformers")
    import json

    from transformers.models.clip.tokenization_clip import bytes_to_unicode

    from hulc2_tpu.models import language as jax_language

    chars = list(bytes_to_unicode().values())
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for c in chars:
        vocab.setdefault(c, len(vocab))
        vocab.setdefault(c + "</w>", len(vocab))
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n")
    transformers.CLIPTokenizer(str(tmp_path / "vocab.json"),
                               str(tmp_path / "merges.txt")).save_pretrained(tmp_path)
    torch.manual_seed(1)
    cfg = transformers.CLIPTextConfig(vocab_size=len(vocab), hidden_size=32, intermediate_size=64,
                                      num_hidden_layers=2, num_attention_heads=2,
                                      max_position_embeddings=40, projection_dim=16,
                                      bos_token_id=0, eos_token_id=1, pad_token_id=1)
    transformers.CLIPTextModelWithProjection(cfg).eval().save_pretrained(
        tmp_path, safe_serialization=False)
    want = jax_language.build_lang_encoder("clip", str(tmp_path)).encode_text(SENTENCES)
    got = language.build_lang_encoder("clip", str(tmp_path), device="cpu").encode_text(SENTENCES)
    assert got[0].shape == (3, 16)
    for g, w in zip(got[:2], want[:2]):
        rel_close(g, w)


@pytest.mark.parametrize("kind", ["sbert", "clip", "bert", "distilbert"])
def test_hf_kinds_need_a_local_directory(tmp_path, kind):
    pytest.importorskip("transformers")
    with pytest.raises(FileNotFoundError, match="no such local model directory"):
        language.build_lang_encoder(kind, device="cpu")
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "absent")):
        language.build_lang_encoder(kind, str(tmp_path / "absent"), device="cpu")
