"""The affordance detector's training configuration, as the port's own copy.

Equal, key for key, to the JAX package's composition
``compose("train_affordance", ["aff_detection=rn18_tokens_pixel"])``
(``hulc2_tpu/configs/affordance.py:103-156``, frozen in
``docs/runs/r5_flagship/aff_config.json``); a test holds the two together.
Only the ``rn18_tokens_pixel`` group is ported: a frozen ResNet18 encoder, a
``mult``-fusion U-Net decoder, a Gaussian depth head and an in-graph CLIP-BPE
text tower. ``affordance_config`` applies dotted ``key=value`` overrides
with the registry's ``apply_overrides`` (``core/config.py``);
``aff_detection=rn18_tokens_pixel`` names the group and is accepted, any
other group raises.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Sequence

from hulc2_torch.core.config import apply_overrides

GROUP = "rn18_tokens_pixel"

TRAIN_AFFORDANCE: Dict[str, Any] = {
    "aff_detection": {
        "encoder_name": "resnet18",
        "decoder_channels": [256, 128, 64, 32, 16],
        "fusion_type": "mult",
        "lang_embed_dim": 384,
        "depth_dist": "gaussian",
        "normalize_depth": True,
        "freeze_encoder": True,
        "optimizer": {"kind": "adam", "lr": 1e-4},
        "loss_weights": {"aff": 0.1, "depth": 0.9},
        "dataset": {
            "data_dir": "data/calvin_lang_MoCEndPt",
            "cam": "static",
            "data_percent": 1.0,
            "label_type": "pixel",
            "img_resize": {"static": 224, "gripper": 96, "all": 100},
        },
        "text_tower": True,
        "tower_width": 256,
        "tower_heads": 4,
        "tower_layers": 2,
    },
    "batch_size": 32,
    "num_workers": 4,
    "max_epochs": 30,
    "seed": 42,
    "log_dir": "runs/affordance",
    "rand_shift_pad": 8,
}


def affordance_config(overrides: Sequence[str] = ()) -> Dict[str, Any]:
    """A fresh copy of ``TRAIN_AFFORDANCE`` with dotted ``key=value`` overrides,
    e.g. ``aff_detection.decoder_channels=[32,16,8,8,8]`` or ``batch_size=8``."""
    rest = []
    for ov in overrides:
        if ov.startswith("aff_detection="):
            if ov != f"aff_detection={GROUP}":
                raise KeyError(f"override {ov!r}: only aff_detection={GROUP} is ported")
        else:
            rest.append(ov)
    return apply_overrides(copy.deepcopy(TRAIN_AFFORDANCE), rest)
