"""Policy-training config groups (``hulc2_tpu/configs/policy.py``).

The port's own copy of the JAX package's registry, group for group and root
for root: ``cfg_low_level`` (the default of ``python -m hulc2_torch.training
--config-name``), ``cfg_gcbc`` and ``cfg_low_level_rw``. It is data: every
option is registered, also those ``models.build.build_policy`` refuses by
name. Mirrors the reference's Hydra group structure and defaults
(reference: conf/cfg_low_level.yaml, conf/model/calvin_hulc++.yaml and its
subgroups) as registered Python dicts. Values are the CALVIN defaults.
"""
from hulc2_torch.core.config import register

# --------------------------------------------------------------------------- #
# model / perceptual_encoder                                                   #
# --------------------------------------------------------------------------- #
VISION_STATIC = {
    "_name_": "vision_network",
    "visual_features": 64,
    "activation_function": "ReLU",
    "dropout_vis_fc": 0.0,
    "l2_normalize_output": False,
    "use_sinusoid": False,
    "spatial_softmax_temp": 1.0,
}
VISION_GRIPPER = {
    "_name_": "vision_network_gripper",
    "visual_features": 64,
    "conv_encoder": "nature_cnn",
    "activation_function": "ReLU",
    "dropout_vis_fc": 0.0,
    "l2_normalize_output": False,
}
DEPTH_STATIC = {**VISION_STATIC}
DEPTH_GRIPPER = {**VISION_GRIPPER}
PROPRIO_IDENTITY = {"n_state_obs": 8}

register(
    "model/perceptual_encoder",
    "gripper_cam",  # CALVIN HULC default: static + gripper RGB, no proprio
    {
        "rgb_static": VISION_STATIC,
        "rgb_gripper": VISION_GRIPPER,
        "depth_static": None,
        "depth_gripper": None,
        "tactile": None,
        "proprio": None,
    },
)
register(
    "model/perceptual_encoder",
    "static_rgb",
    {
        "rgb_static": VISION_STATIC,
        "rgb_gripper": None,
        "depth_static": None,
        "depth_gripper": None,
        "tactile": None,
        "proprio": PROPRIO_IDENTITY,
    },
)
VISION_R3M = {"_name_": "vision_r3m", "visual_features": 64, "resnet_model": "resnet18", "freeze_backbone": True}
VISION_CLIP = {"_name_": "vision_clip", "visual_features": 64, "model_name": "RN50",
               "freeze_backbone": True}
VISION_RESNET = {"_name_": "vision_resnet", "visual_features": 64, "freeze_backbone": False}
TACTILE = {"_name_": "tactile_encoder", "visual_features": 64, "freeze_backbone": True}

register(
    "model/perceptual_encoder",
    "gripper_cam_r3m",  # hulc2 real-world default: frozen R3M static stream
    {
        "rgb_static": VISION_R3M,
        "rgb_gripper": VISION_GRIPPER,
        "depth_static": None,
        "depth_gripper": None,
        "tactile": None,
        "proprio": None,
    },
)
register(
    "model/perceptual_encoder",
    "static_clip",  # frozen CLIP image tower on the static cam (pair with
    # datamodule/transforms=clip for 224-px inputs + CLIP channel stats);
    # model_name switches RN50 <-> ViT-B/32 (reference vision_clip.py:10)
    {
        "rgb_static": VISION_CLIP,
        "rgb_gripper": VISION_GRIPPER,
        "depth_static": None,
        "depth_gripper": None,
        "tactile": None,
        "proprio": None,
    },
)
register(
    "model/perceptual_encoder",
    "static_rgb_tactile",
    {
        "rgb_static": VISION_STATIC,
        "rgb_gripper": None,
        "depth_static": None,
        "depth_gripper": None,
        "tactile": TACTILE,
        "proprio": PROPRIO_IDENTITY,
    },
)
register(
    "model/perceptual_encoder",
    "rgbd_both",
    {
        "rgb_static": VISION_STATIC,
        "rgb_gripper": VISION_GRIPPER,
        "depth_static": DEPTH_STATIC,
        "depth_gripper": DEPTH_GRIPPER,
        "tactile": None,
        "proprio": None,
    },
)

# --------------------------------------------------------------------------- #
# model subgroups                                                              #
# --------------------------------------------------------------------------- #
register("model/distribution", "discrete", {"dist": "discrete", "category_size": 32, "class_size": 32})
register("model/distribution", "continuous", {"dist": "continuous", "plan_features": 256})

register("model/plan_proposal", "default", {"hidden_size": 2048, "activation_function": "ReLU"})
register(
    "model/plan_recognition",
    "transformers",
    {
        "kind": "transformers",
        "num_heads": 8,
        "num_layers": 2,
        "encoder_hidden_size": 2048,
        "fc_hidden_size": 4096,
        "dropout_p": 0.1,
        "encoder_normalize": False,
        "positional_normalize": False,
        "position_embedding": True,
        "max_position_embeddings": "${datamodule.max_window_size}",
    },
)
register("model/plan_recognition", "bilstm", {"kind": "bilstm"})
register("model/plan_recognition", "birnn", {"kind": "birnn"})

register(
    "model/visual_goal",
    "default",
    {"hidden_size": 2048, "latent_goal_features": 32, "l2_normalize_goal_embeddings": False},
)
# reference group: conf/model/language_encoder/{default,sbert,none}.yaml —
# "none" feeds precomputed sentence embeddings straight to the goal encoder
# (our default; identical outputs to the reference's frozen sbert tower),
# "mlp" is the reference default.yaml trainable MLP over embeddings, "clip"
# is the in-graph CLIP text transformer over BPE token ids with gradients
# flowing through the tower (pair with datamodule.load_lang_embeddings=false)
register("model/language_encoder", "none", {"_name_": "none"})
# reference sbert.yaml freezes the backbone (freeze_backbone: True), so the
# tower computes exactly the embeddings the annotator precomputed — served
# from auto_lang_ann.npy without re-running BERT every step
register("model/language_encoder", "sbert", {"_name_": "none"})
register(
    "model/language_encoder",
    "mlp",
    {
        "_name_": "lang_mlp",
        "out_features": 256,
        "hidden_size": 2048,
        "word_dropout_p": 0.0,
        "activation_function": "ReLU",
    },
)
register(
    "model/language_encoder",
    "clip",
    {
        "_name_": "clip_text",
        "width": 512,
        "heads": 8,
        "layers": 12,
        "output_dim": 1024,
        "vocab_size": 49408,
        "context_length": 77,
        "frozen": False,
    },
)
# from-scratch in-graph tower: CLIP-base is 38M params — far too big to train
# from scratch on a ~400-sentence annotation bank; this small trainable tower
# (2 layers x 256) learns compositional sentence embeddings jointly with the
# policy (the reference's load_lang_embeddings=false role,
# hulc2/models/hulc2.py:87-89 + npz_dataset.py:178-181) and generalizes to
# held-out paraphrases through shared token embeddings
register(
    "model/language_encoder",
    "clip_scratch",
    {
        "_name_": "clip_text",
        "width": 256,
        "heads": 4,
        "layers": 2,
        "output_dim": 384,
        "vocab_size": 49408,
        "context_length": 77,
        "frozen": False,
    },
)

register(
    "model/language_goal",
    "default",
    {
        "in_features": 384,
        "hidden_size": 2048,
        "latent_goal_features": 32,
        "l2_normalize_goal_embeddings": False,
        "word_dropout_p": 0.0,
    },
)
register(
    "model/action_decoder",
    "logistic_decoder_rnn_calvin",
    {
        "kind": "logistic",
        "n_mixtures": 10,
        "hidden_size": 2048,
        "out_features": "${datamodule.action_space}",
        "log_scale_min": -7.0,
        "act_max_bound": "${datamodule.action_max}",
        "act_min_bound": "${datamodule.action_min}",
        "num_classes": 10,
        "gripper_alpha": 1.0,
        "perceptual_emb_slice": [64, 128],
        "policy_rnn_dropout_p": 0.0,
        "num_layers": 2,
        "rnn_model": "rnn_decoder",
        "gripper_control": True,
        "discrete_gripper": True,
    },
)
register(
    "model/action_decoder",
    "deterministic",
    {
        "kind": "deterministic",
        "hidden_size": 2048,
        "out_features": "${datamodule.action_space}",
        "perceptual_emb_slice": [64, 128],
        "policy_rnn_dropout_p": 0.0,
        "num_layers": 2,
        "rnn_model": "rnn_decoder",
        "criterion": "HuberLoss",
        "gripper_control": False,
    },
)

register("model/optimizer", "adam", {"kind": "adam", "lr": "${training.lr}"})
register("model/optimizer", "adamw", {"kind": "adamw", "lr": "${training.lr}", "weight_decay": 1e-6})
register("model/optimizer", "sgd", {"kind": "sgd", "lr": "${training.lr}", "momentum": 0.9})
register("model/lr_scheduler", "constant", {"kind": "constant"})
register(
    "model/lr_scheduler",
    "linear_warmup",
    {"kind": "linear_warmup", "num_warmup_steps": 0.1, "num_training_steps": -1},
)
register(  # reference: conf/model/lr_scheduler/cosine_schedule_with_warmup.yaml
    "model/lr_scheduler",
    "cosine_warmup",
    {"kind": "cosine", "num_warmup_steps": 0.1, "num_training_steps": -1},
)
register("model/proj_vis_lang", "default", {"output_dim": 32, "proj_lang": True})

# --------------------------------------------------------------------------- #
# per-camera perceptual subgroups — the reference's
# conf/model/perceptual_encoder/{rgb_static,rgb_gripper,...}/ option dirs;
# selected via e.g. `model/perceptual_encoder/rgb_static=r3m` (any subgroup
# also accepts `=none`). The composites above remain the common presets.
# --------------------------------------------------------------------------- #
VISION_CONV = {  # reference: rgb_static/vision_conv.yaml
    "_name_": "vision_conv",
    "visual_features": 64,
    "activation_function": "ReLU",
    "dropout_vis_fc": 0.0,
    "l2_normalize_output": False,
}
VISION_RESNET_AFF = {  # reference: rgb_static/resnet_aff.yaml (depth-3 trunk)
    "_name_": "vision_resnet_aff",
    "visual_features": 64,
    "freeze_backbone": True,
    "depth": 3,
}
for _cam, _default in (("rgb_static", VISION_STATIC), ("rgb_gripper", VISION_GRIPPER)):
    _g = f"model/perceptual_encoder/{_cam}"
    register(_g, "default", dict(_default))
    register(_g, "r3m", dict(VISION_R3M))
    register(_g, "resnet", dict(VISION_RESNET))
    register(_g, "resnet_aff", dict(VISION_RESNET_AFF))
register("model/perceptual_encoder/rgb_static", "clip", dict(VISION_CLIP))
register("model/perceptual_encoder/rgb_static", "vision_conv", VISION_CONV)
register("model/perceptual_encoder/depth_static", "default", dict(DEPTH_STATIC))
register("model/perceptual_encoder/depth_gripper", "default", dict(DEPTH_GRIPPER))
register("model/perceptual_encoder/tactile", "default", dict(TACTILE))
register("model/perceptual_encoder/proprio", "identity", dict(PROPRIO_IDENTITY))

# --------------------------------------------------------------------------- #
# model composites                                                             #
# --------------------------------------------------------------------------- #
register(
    "model",
    "calvin_hulc",
    {
        "_defaults_": [
            ("model/perceptual_encoder", "gripper_cam"),
            ("model/plan_proposal", "default"),
            ("model/plan_recognition", "transformers"),
            ("model/distribution", "discrete"),
            ("model/visual_goal", "default"),
            ("model/language_goal", "default"),
            ("model/language_encoder", "none"),
            ("model/action_decoder", "logistic_decoder_rnn_calvin"),
            ("model/optimizer", "adam"),
            ("model/lr_scheduler", "constant"),
            ("model/proj_vis_lang", "default"),
        ],
        "kl_beta": "${loss.kl_beta}",
        "kl_balancing_mix": "${loss.kl_balancing_mix}",
        "replan_freq": 30,
        "use_clip_auxiliary_loss": True,
        "clip_auxiliary_loss_beta": "${loss.clip_auxiliary_loss_beta}",
        # task-CE supervision on the language tower (aux_nets.LangTaskHead):
        # required for task-separable embeddings when the tower trains from
        # scratch (language_encoder=clip_scratch) — the reference gets this
        # separability for free from frozen SBERT (language_network.py:13)
        "use_lang_task_auxiliary_loss": False,
        "lang_task_classes": 34,
        "use_plan": True,
        "compute_dtype": "bfloat16",
    },
)
register(
    "model",
    "gcbc",
    {
        "_defaults_": [
            ("model/perceptual_encoder", "gripper_cam"),
            ("model/plan_proposal", "default"),
            ("model/plan_recognition", "transformers"),
            ("model/distribution", "discrete"),
            ("model/visual_goal", "default"),
            ("model/language_goal", "default"),
            ("model/language_encoder", "none"),
            ("model/action_decoder", "logistic_decoder_rnn_calvin"),
            ("model/optimizer", "adam"),
            ("model/lr_scheduler", "constant"),
            ("model/proj_vis_lang", "default"),
        ],
        "kl_beta": 0.0,
        "kl_balancing_mix": "${loss.kl_balancing_mix}",
        "replan_freq": 30,
        "use_clip_auxiliary_loss": True,
        "clip_auxiliary_loss_beta": "${loss.clip_auxiliary_loss_beta}",
        "use_plan": False,
        "compute_dtype": "bfloat16",
    },
)

# --------------------------------------------------------------------------- #
# loss / training / trainer / datamodule groups                                #
# --------------------------------------------------------------------------- #
register(
    "loss",
    "default",
    {
        "kl_beta": 0.01,
        "kl_balancing_mix": 0.8,
        "clip_auxiliary_loss_beta": 3.0,
        "state_recon_beta": 0.5,
        "bc_z_auxiliary_loss_beta": 1.0,
        "mia_auxiliary_loss_beta": 1.0,
        "lang_task_auxiliary_loss_beta": 1.0,
    },
)
register(
    "training",
    "default_training",
    {"lr": 2e-4, "max_epochs": 100, "precision": "bf16", "seed": 42},
)
register(
    "trainer",
    "play_trainer",
    {
        "max_epochs": "${training.max_epochs}",
        "log_every_n_steps": 50,
        "val_check_interval": 1.0,
        "limit_train_batches": None,
        "limit_val_batches": None,
    },
)
# datamodule/datasets — modality selection (reference: conf/datamodule/
# datasets/{vision_lang,vision_only,lang_only}[_shm].yaml). The _shm aliases
# exist for CLI parity; the shm cache here is the --shm-cache flag / the
# datamodule's use_shm_cache, orthogonal to modality choice.
for _n, _mods in (("vision_lang", {"vis": True, "lang": True}),
                  ("vision_only", {"vis": True, "lang": False}),
                  ("lang_only", {"vis": False, "lang": True})):
    register("datamodule/datasets", _n, dict(_mods))
    register("datamodule/datasets", _n + "_shm", dict(_mods))

# datamodule/frame_skip — within-window temporal subsampling (the reference's
# ShmDatasetSkip, hulc2/datasets/shm_dataset_skip.py; selected upstream by
# overriding the dataset _target_). Effective windows default to half the raw
# 20-32 range (the class docstring's "half of original window size").
# `datamodule/frame_skip=none` (the built-in null option) switches it off.
register(
    "datamodule/frame_skip",
    "random",
    {
        "strategy": "random",
        "effective_min_ws": 10,
        "effective_max_ws": 16,
        "min_skip_ratio": 0.0,
        "max_skip_ratio": 0.3,
    },
)
register(
    "datamodule/frame_skip",
    "diff",
    {
        "strategy": "diff",
        "effective_min_ws": 10,
        "effective_max_ws": 16,
        "pos_threshold": 0.99,
        "orn_threshold": 0.08,
        "min_skip_ratio": 0.0,
    },
)

register(
    "datamodule",
    "calvin_default",
    {
        "root_data_dir": "data/calvin_debug_dataset",
        "action_space": 7,
        "action_max": [1.0] * 7,
        "action_min": [-1.0] * 7,
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
        "load_lang_embeddings": True,
        "num_workers": 8,
        "device_store": False,
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
        "transforms": "rand_shift",
    },
)

register(
    "callbacks",
    "calvin_default",
    {
        "checkpoint": {"save_top_k": -1, "monitor": None, "every_n_epochs": 1},
        "kl_schedule": {"kind": "constant", "kl_beta": "${loss.kl_beta}"},
        "rollout": None,
        "rollout_lh": None,
        "tsne_plot": None,
    },
)

# --------------------------------------------------------------------------- #
# top-level composites                                                         #
# --------------------------------------------------------------------------- #
register(
    "root",
    "cfg_low_level",
    {
        "_defaults_": [
            ("callbacks", "calvin_default"),
            ("datamodule", "calvin_default"),
            ("model", "calvin_hulc"),
            ("loss", "default"),
            ("training", "default_training"),
            ("trainer", "play_trainer"),
        ],
        "data_percent": 1.0,
        "seed": 42,
        "log_dir": "runs",
        "logger": "jsonl",
    },
)
register(
    "root",
    "cfg_gcbc",
    {
        "_defaults_": [
            ("callbacks", "calvin_default"),
            ("datamodule", "calvin_default"),
            ("model", "gcbc"),
            ("loss", "default"),
            ("training", "default_training"),
            ("trainer", "play_trainer"),
        ],
        "data_percent": 1.0,
        "seed": 42,
        "log_dir": "runs",
        "logger": "jsonl",
    },
)


# --------------------------------------------------------------------------- #
# real-world (TACO teleop) composites                                          #
# (reference: conf/cfg_low_level_rw.yaml, conf/model/real_world_hulc++.yaml,   #
#  conf/datamodule/real_world_default.yaml)                                    #
# --------------------------------------------------------------------------- #
register(
    "model/action_decoder",
    "logistic_decoder_rnn_real_world",
    {
        "kind": "logistic",
        "n_mixtures": 10,
        "hidden_size": 2048,
        "out_features": "${datamodule.action_space}",
        "log_scale_min": -7.0,
        "act_max_bound": "${datamodule.action_max}",
        "act_min_bound": "${datamodule.action_min}",
        "num_classes": 10,
        "gripper_alpha": 1.0,
        "perceptual_emb_slice": [0, 128],  # full visual emb (rw decoder)
        "policy_rnn_dropout_p": 0.0,
        "num_layers": 2,
        "rnn_model": "rnn_decoder",
        "gripper_control": False,
        "discrete_gripper": True,
    },
)
register(
    "model",
    "real_world_hulc",
    {
        "_defaults_": [
            ("model/perceptual_encoder", "gripper_cam_r3m"),
            ("model/plan_proposal", "default"),
            ("model/plan_recognition", "transformers"),
            ("model/distribution", "discrete"),
            ("model/visual_goal", "default"),
            ("model/language_goal", "default"),
            ("model/language_encoder", "none"),
            ("model/action_decoder", "logistic_decoder_rnn_real_world"),
            ("model/optimizer", "adam"),
            ("model/lr_scheduler", "constant"),
            ("model/proj_vis_lang", "default"),
        ],
        "kl_beta": "${loss.kl_beta}",
        "kl_balancing_mix": "${loss.kl_balancing_mix}",
        "replan_freq": 30,
        "use_clip_auxiliary_loss": False,
        "clip_auxiliary_loss_beta": "${loss.clip_auxiliary_loss_beta}",
        "use_plan": True,
        "compute_dtype": "bfloat16",
    },
)
register(
    "datamodule",
    "real_world_default",
    {
        "root_data_dir": "data/taco_play",
        "action_space": 7,
        "action_max": [1.0] * 7,
        "action_min": [-1.0] * 7,
        "batch_size_vis": 32,
        "batch_size_lang": 32,
        "min_window_size": 20,
        "max_window_size": 32,
        "skip_frames": 1,
        "frame_skip": None,
        "pad": True,
        "lang_folder": "lang_paraphrase-MiniLM-L3-v2",
        "aux_lang_loss_window": 8,
        "data_percent": 1.0,
        "load_lang_embeddings": True,
        "num_workers": 8,
        "device_store": False,
        "loader_isolation": "none",
        "shuffle_val": False,
        "observation_space": {
            "rgb_obs": ["rgb_static", "rgb_gripper"],
            "depth_obs": [],
            "state_obs": ["robot_obs"],
            "actions": ["rel_actions_gripper"],
            "language": ["language"],
        },
        "proprioception_dims": {
            "n_state_obs": 8,
            "keep_indices": [[0, 7], [14, 15]],
            "robot_orientation_idx": [3, 6],
            "normalize": True,
            "normalize_robot_orientation": True,
        },
        "transforms": "real_world_r3m",
    },
)
register(
    "root",
    "cfg_low_level_rw",
    {
        "_defaults_": [
            ("callbacks", "calvin_default"),
            ("datamodule", "real_world_default"),
            ("model", "real_world_hulc"),
            ("loss", "default"),
            ("training", "default_training"),
            ("trainer", "play_trainer"),
        ],
        "data_percent": 1.0,
        "seed": 42,
        "log_dir": "runs",
        "logger": "jsonl",
    },
)


# --------------------------------------------------------------------------- #
# datamodule/observation_space — the reference's 16 modality/action presets
# (reference: conf/datamodule/observation_space/*.yaml), generated rather than
# spelled out: the name encodes language-conditioning, cameras, depth and the
# action representation.
# --------------------------------------------------------------------------- #
def _obs_space(rgb, depth=(), state=("robot_obs",), actions="actions", language=True):
    d = {
        "rgb_obs": list(rgb),
        "depth_obs": list(depth),
        "state_obs": list(state),
        "actions": [actions],
    }
    if language:
        d["language"] = ["language"]
    return d


_SG = ("rgb_static", "rgb_gripper")
_OBS_SPACES = {
    "lang_rgb_static_abs_act": _obs_space(("rgb_static",)),
    "lang_rgb_static_rel_act": _obs_space(("rgb_static",), actions="rel_actions"),
    "lang_rgb_static_gripper_abs_act": _obs_space(_SG),
    "lang_rgb_static_gripper_rel_act": _obs_space(_SG, actions="rel_actions"),
    "lang_rgb_static_gripper_rel_gripper_act": _obs_space(_SG, actions="rel_actions_gripper"),
    "lang_rgb_static_robot_scene_abs_act": _obs_space(("rgb_static",), state=("robot_obs", "scene_obs")),
    "lang_rgb_static_tactile_abs_act": _obs_space(("rgb_static", "rgb_tactile")),
    "lang_rgbd_both_abs_act": _obs_space(_SG, ("depth_static", "depth_gripper")),
    "lang_rgbd_both_rel_act": _obs_space(_SG, ("depth_static", "depth_gripper"), actions="rel_actions"),
    "lang_rgbd_static_gripper_rel_act": _obs_space(_SG, ("depth_gripper",), actions="rel_actions"),
    "lang_rgbd_static_robot_abs_act": _obs_space(("rgb_static",), ("depth_static",)),
    "all_mods_abs_act": _obs_space(
        ("rgb_static", "rgb_gripper", "rgb_tactile"),
        ("depth_static", "depth_gripper", "depth_tactile"),
        ("robot_obs", "scene_obs"),
    ),
    "rgb_static_abs_act": _obs_space(("rgb_static",), language=False),
    "rgb_static_gripper_rel_gripper_act": _obs_space(_SG, actions="rel_actions_gripper", language=False),
    "rgb_static_robot_scene_abs_act": _obs_space(
        ("rgb_static",), state=("robot_obs", "scene_obs"), language=False
    ),
    "state_only": _obs_space((), ()),
}
for _name, _val in _OBS_SPACES.items():
    register("datamodule/observation_space", _name, _val)


# --------------------------------------------------------------------------- #
# datamodule/proprioception_dims — the reference's 5 proprio slicing presets
# (reference: conf/datamodule/proprioception_dims/*.yaml)
# --------------------------------------------------------------------------- #
def _proprio(n, keep, normalize=True):
    return {
        "n_state_obs": n,
        "keep_indices": keep,
        "robot_orientation_idx": [3, 6],
        "normalize": normalize,
        "normalize_robot_orientation": normalize,
    }


for _name, _val in {
    "none": _proprio(0, [[0, 0]], normalize=False),
    "robot_full": _proprio(15, [[0, 15]]),
    "robot_no_joints": _proprio(8, [[0, 7], [14, 15]]),
    "robot_no_joints_no_gripper_width": _proprio(7, [[0, 6], [14, 15]]),
    "robot_scene": _proprio(54, [[0, 54]]),
}.items():
    register("datamodule/proprioception_dims", _name, _val)


# --------------------------------------------------------------------------- #
# callbacks/checkpoint — retention/monitor presets
# (reference: conf/callbacks/checkpoint/*.yaml); callbacks/kl_schedule —
# KL-beta annealing presets (reference: conf/callbacks/kl_schedule/*.yaml)
# --------------------------------------------------------------------------- #
register("callbacks/checkpoint", "all", {"save_top_k": -1, "monitor": None, "every_n_epochs": 1})
for _name, (_monitor, _mode) in {
    "val_action": ("val/action_loss_pp", "min"),
    "kl": ("val/kl_loss", "min"),
    "clip_loss": ("val/val_pred_clip_loss", "min"),
    "state_recon": ("val/proprio_loss", "min"),
    "task_sr": ("tasks/average_sr", "max"),
    "lh_sr": ("eval_lh/avg_seq_len", "max"),
}.items():
    register("callbacks/checkpoint", _name,
             {"save_top_k": 3, "monitor": _monitor, "mode": _mode, "every_n_epochs": 1})

register("callbacks/kl_schedule", "constant", {"kind": "constant", "kl_beta": "${loss.kl_beta}"})
register("callbacks/kl_schedule", "linear",
         {"kind": "linear", "kl_beta": "${loss.kl_beta}", "start_epoch": 10, "end_epoch": 50})
register("callbacks/kl_schedule", "sigmoid",
         {"kind": "sigmoid", "kl_beta": "${loss.kl_beta}", "start_epoch": 10, "end_epoch": 50})
