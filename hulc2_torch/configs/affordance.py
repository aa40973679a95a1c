"""The affordance detector's config groups and training root, as the port's own
copy (``hulc2_tpu/configs/affordance.py:4-156``).

Importing the module registers the twelve ``aff_detection`` groups and the
``train_affordance`` root in the port's registry (``core/config.py``), key
for key as the JAX package registers them; a test holds every composition
equal to JAX's. ``compose("train_affordance")`` gives JAX's root default,
``rn18_pixel``. ``affordance_config`` is what the port's entry points
compose: the same root with ``rn18_tokens_pixel`` as its default group (the
recipe's detector; kept on purpose), then ``aff_detection=<group>`` to pick
any other group and dotted ``key=value`` overrides. An unknown group or key
raises; ``aff_detection.compute_dtype`` may be created (``CREATABLE``).
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

from hulc2_torch.core.config import compose, options, register

GROUP = "rn18_tokens_pixel"


def _dataset(data_dir: str = "data/calvin_lang_MoCEndPt", label_type=None) -> dict:
    ds = {"data_dir": data_dir, "cam": "static", "data_percent": 1.0}
    if label_type is not None:
        ds["label_type"] = label_type
    ds["img_resize"] = {"static": 224, "gripper": 96, "all": 100}
    return ds


def _group(encoder_name: str, depth_dist: str = "gaussian", freeze_encoder: bool = True,
           decoder_channels=(256, 128, 64, 32, 16), lang_embed_dim: int = 1024,
           dataset: dict = None) -> dict:
    return {
        "encoder_name": encoder_name,
        "decoder_channels": list(decoder_channels),
        "fusion_type": "mult",
        "lang_embed_dim": lang_embed_dim,
        "depth_dist": depth_dist,  # gaussian | logistic | none
        "normalize_depth": True,
        "freeze_encoder": freeze_encoder,
        "optimizer": {"kind": "adam", "lr": 1e-4},
        "loss_weights": {"aff": 0.1, "depth": 0.9},
        "dataset": dataset or _dataset(),
    }


register("aff_detection", "rn18_pixel", _group("resnet18"))
register("aff_detection", "rn50_pixel", _group("resnet50", depth_dist="logistic"))
register("aff_detection", "rn50_clip_pixel", _group("clip_rn50"))
# the real-robot stream: R3M's ResNet18 (stem to layer3 always frozen, layer4
# trains when freeze_encoder is false) with a wider decoder
register("aff_detection", "r3m_pixel", _group(
    "r3m_rn18", freeze_encoder=False, decoder_channels=(512, 256, 128, 64, 32),
    dataset=_dataset("data/real_world_lang_MoCEndPt")))


def _variant(encoder_name: str, lang_dim: int, label_type: str = "pixel", **extra) -> dict:
    """A stream x language x label-type variant; the sentence encoder sets the
    embedding width (CLIP 1024, BERT 768, SBERT 384)."""
    cfg = _group(encoder_name, lang_embed_dim=lang_dim, dataset=_dataset(label_type=label_type))
    cfg.update(extra)
    return cfg


register("aff_detection", "rn18_bert_pixel", _variant("resnet18", 768))
# the in-graph CLIP-BPE token tower: no sentence-embedding table anywhere
register("aff_detection", "rn18_tokens_pixel", _variant(
    "resnet18", 384, text_tower=True, tower_width=256, tower_heads=4, tower_layers=2))
register("aff_detection", "rn18_clip_pixel", _variant("resnet18", 1024))
register("aff_detection", "rn18_sbert_pixel", _variant("resnet18", 384))
register("aff_detection", "rn50_bert_pixel", _variant("resnet50", 768))
register("aff_detection", "rn18_bert_mask", _variant("resnet18", 768, "mask"))
register("aff_detection", "rn18_clip_mask", _variant("resnet18", 1024, "mask"))
register("aff_detection", "clip", _variant("clip_rn50", 1024))

register("root", "train_affordance", {
    "_defaults_": [("aff_detection", "rn18_pixel")],
    "batch_size": 32,
    "num_workers": 4,
    "max_epochs": 30,
    "seed": 42,
    "log_dir": "runs/affordance",
    "rand_shift_pad": 8,
})


def affordance_config(overrides: Sequence[str] = ()) -> Dict[str, Any]:
    """The ``train_affordance`` root with ``aff_detection=rn18_tokens_pixel``,
    then ``overrides`` in order, e.g. ``aff_detection=rn18_pixel``,
    ``aff_detection.decoder_channels=[32,16,8,8,8]`` or ``batch_size=8``."""
    for ov in overrides:
        key, _, val = ov.partition("=")
        if key == "aff_detection" and val not in options("aff_detection"):
            raise KeyError(f"override {ov!r}: unknown group; known: {options('aff_detection')}")
    return compose("train_affordance", [f"aff_detection={GROUP}", *overrides])
