"""The flagship policy configuration, as the port's own copy.

Equal, for every key it carries, to the JAX package's composition
``cfg_low_level`` with the overrides in ``FLAGSHIP_OVERRIDES`` (the round-5
flagship recipe, ``docs/runs/r5_flagship/policy_config.json``); a test holds
the two together. Of the ``callbacks`` group only the checkpoint retention
and the KL schedule are carried: the rollout and t-SNE callbacks are not
ported. ``datamodule.root_data_dir`` names the dataset the trainer reads
(``python -m hulc2_torch.tools.make_expert_dataset`` writes one).
"""
from __future__ import annotations

import copy
import json
from typing import Any, Dict, Sequence

FLAGSHIP_OVERRIDES = (
    "datamodule.device_store=true",
    "datamodule.transforms=rand_shift_96",
    "datamodule.load_lang_embeddings=false",
    "model/language_encoder=clip_scratch",
    "model.use_lang_task_auxiliary_loss=true",
)

_BOUNDS_MAX = [1.0] * 7
_BOUNDS_MIN = [-1.0] * 7

FLAGSHIP: Dict[str, Any] = {
    "datamodule": {
        "root_data_dir": "data/calvin_debug_dataset",
        "action_space": 7,
        "action_max": _BOUNDS_MAX,
        "action_min": _BOUNDS_MIN,
        "batch_size_vis": 32,
        "batch_size_lang": 32,
        "min_window_size": 20,
        "max_window_size": 32,
        "skip_frames": 1,
        "frame_skip": None,
        "pad": True,
        "lang_folder": "lang_annotations",
        "aux_lang_loss_window": 8,
        "data_percent": 1.0,
        "load_lang_embeddings": False,
        "num_workers": 8,
        "device_store": True,
        "loader_isolation": "none",
        "shuffle_val": False,
        "observation_space": {
            "rgb_obs": ["rgb_static", "rgb_gripper"],
            "depth_obs": [],
            "state_obs": ["robot_obs"],
            "actions": ["rel_actions"],
            "language": ["language"],
        },
        "proprioception_dims": {
            "n_state_obs": 8,
            "keep_indices": [[0, 7], [14, 15]],
            "robot_orientation_idx": [3, 6],
            "normalize": True,
            "normalize_robot_orientation": True,
        },
        "transforms": "rand_shift_96",
    },
    "model": {
        "perceptual_encoder": {
            "rgb_static": {
                "_name_": "vision_network",
                "visual_features": 64,
                "activation_function": "ReLU",
                "dropout_vis_fc": 0.0,
                "l2_normalize_output": False,
                "use_sinusoid": False,
                "spatial_softmax_temp": 1.0,
            },
            "rgb_gripper": {
                "_name_": "vision_network_gripper",
                "visual_features": 64,
                "conv_encoder": "nature_cnn",
                "activation_function": "ReLU",
                "dropout_vis_fc": 0.0,
                "l2_normalize_output": False,
            },
            "depth_static": None,
            "depth_gripper": None,
            "tactile": None,
            "proprio": None,
        },
        "plan_proposal": {"hidden_size": 2048, "activation_function": "ReLU"},
        "plan_recognition": {
            "kind": "transformers",
            "num_heads": 8,
            "num_layers": 2,
            "encoder_hidden_size": 2048,
            "fc_hidden_size": 4096,
            "dropout_p": 0.1,
            "encoder_normalize": False,
            "positional_normalize": False,
            "position_embedding": True,
            "max_position_embeddings": 32,
        },
        "distribution": {"dist": "discrete", "category_size": 32, "class_size": 32},
        "visual_goal": {
            "hidden_size": 2048,
            "latent_goal_features": 32,
            "l2_normalize_goal_embeddings": False,
        },
        "language_goal": {
            "in_features": 384,
            "hidden_size": 2048,
            "latent_goal_features": 32,
            "l2_normalize_goal_embeddings": False,
            "word_dropout_p": 0.0,
        },
        "language_encoder": {
            "_name_": "clip_text",
            "width": 256,
            "heads": 4,
            "layers": 2,
            "output_dim": 384,
            "vocab_size": 49408,
            "context_length": 77,
            "frozen": False,
        },
        "action_decoder": {
            "kind": "logistic",
            "n_mixtures": 10,
            "hidden_size": 2048,
            "out_features": 7,
            "log_scale_min": -7.0,
            "act_max_bound": _BOUNDS_MAX,
            "act_min_bound": _BOUNDS_MIN,
            "num_classes": 10,
            "gripper_alpha": 1.0,
            "perceptual_emb_slice": [64, 128],
            "policy_rnn_dropout_p": 0.0,
            "num_layers": 2,
            "rnn_model": "rnn_decoder",
            "gripper_control": True,
            "discrete_gripper": True,
        },
        "optimizer": {"kind": "adam", "lr": 0.0002},
        "lr_scheduler": {"kind": "constant"},
        "proj_vis_lang": {"output_dim": 32, "proj_lang": True},
        "kl_beta": 0.01,
        "kl_balancing_mix": 0.8,
        "replan_freq": 30,
        "use_clip_auxiliary_loss": True,
        "clip_auxiliary_loss_beta": 3.0,
        "use_lang_task_auxiliary_loss": True,
        "lang_task_classes": 34,
        "use_plan": True,
        "compute_dtype": "bfloat16",
    },
    "loss": {
        "kl_beta": 0.01,
        "kl_balancing_mix": 0.8,
        "clip_auxiliary_loss_beta": 3.0,
        "state_recon_beta": 0.5,
        "bc_z_auxiliary_loss_beta": 1.0,
        "mia_auxiliary_loss_beta": 1.0,
        "lang_task_auxiliary_loss_beta": 1.0,
    },
    "training": {"lr": 0.0002, "max_epochs": 100, "precision": "bf16", "seed": 42},
    "trainer": {
        "max_epochs": 100,
        "log_every_n_steps": 50,
        "val_check_interval": 1.0,
        "limit_train_batches": None,
        "limit_val_batches": None,
    },
    "callbacks": {
        "checkpoint": {"save_top_k": -1, "monitor": None, "every_n_epochs": 1},
        "kl_schedule": {"kind": "constant", "kl_beta": 0.01},
    },
    "seed": 42,
}


def flagship_config(overrides: Sequence[str] = ()) -> Dict[str, Any]:
    """A fresh copy of ``FLAGSHIP`` with dotted ``key=value`` overrides applied
    (values parsed as JSON where they parse), e.g. ``model.plan_proposal.hidden_size=64``."""
    return apply_overrides(copy.deepcopy(FLAGSHIP), overrides)


def apply_overrides(cfg: Dict[str, Any], overrides: Sequence[str]) -> Dict[str, Any]:
    """``cfg`` with dotted ``key=value`` overrides applied in place; a key the
    config does not have raises."""
    for ov in overrides:
        key, sep, raw = ov.partition("=")
        if not sep:
            raise ValueError(f"override {ov!r} must be key=value")
        try:
            value = json.loads(raw)
        except json.JSONDecodeError:
            value = raw
        node = cfg
        *parents, leaf = key.split(".")
        for k in parents:
            if not isinstance(node.get(k), dict):
                raise KeyError(f"override {ov!r}: no config section {k!r}")
            node = node[k]
        if leaf not in node:
            raise KeyError(f"override {ov!r}: unknown key {leaf!r}; known: {sorted(node)}")
        node[leaf] = value
    return cfg
