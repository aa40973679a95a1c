"""Model config dict -> the port's ``Hulc2`` (``hulc2_tpu/models/build.py:57-297``),
cut to what the benchmark's configurations build.

Option for option as the JAX factory builds them: discrete or continuous
plans; the transformer, BiLSTM or BiRNN posterior; the logistic decoder
over a ReLU RNN, GRU, LSTM or MLP, with or without a discrete gripper; the
language side the CLIP text tower over token ids, ``lang_mlp`` over
precomputed embeddings, or none; GCBC (``use_plan=false``); the CLIP aux
loss and the state, BC-Z, MIA and task-CE heads; the identity proprio
slice. The embedding's width counts each encoder's ``visual_features``
(``perceptual_latent_size``). The depth and tactile cameras and the
deterministic decoder of the port are not copied, and this factory refuses
them.

Each RGB camera's encoder is found by the ``_name_`` of its config
(``build_camera_encoder``): ``encoders/<_name_>.py`` builds it from the
config and the camera's frame side after the train transform. The static
camera's ``vision_network`` and the gripper camera's
``vision_network_gripper`` (nature_cnn, cnn_3_layers or cnn_4_layers
trunk; activation, dropout, L2, sinusoid and temperature options) are the
first two; another encoder is another file there. A name with no file is
refused.

flax infers every input width at init; the port sizes its layers from the
real widths: the proprio slice is ``robot_obs[..., :n_state_obs]`` of the
processed robot_obs (39 wide with ``robot_scene``, whatever ``n_state_obs``
says), and the decoder's ``perceptual_emb_slice`` is cut at the embedding's
width as a slice is.

Where the JAX factory ignores a key, so does the port: the plan proposal's
``activation_function``, the transformer's ``position_embedding`` (positions
are always added), the BiLSTM/BiRNN posteriors' widths (2048, 2 layers),
``proj_vis_lang.proj_lang`` (always projected) and ``policy_rnn_dropout_p``.
"""
from __future__ import annotations

import importlib
import re
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from portbench.reference.port.models.aux_nets import (BCZLangDecoder, LangTaskHead, MIALangDiscriminator,
                                         ProjVisLang, StateDecoder)
from portbench.reference.port.models.clip_text import ClipTextTransformer
from portbench.reference.port.models.decoders import LogisticPolicyDecoder
from portbench.reference.port.models.distributions import make_distribution
from portbench.reference.port.models.goal_encoders import (LanguageEncoderMLP, LanguageGoalEncoder,
                                              VisualGoalEncoder)
from portbench.reference.port.models.hulc2 import Hulc2
from portbench.reference.port.models.layers import init_weights_
from portbench.reference.port.models.perceptual import ConcatEncoders
from portbench.reference.port.models.plan_nets import (PlanProposalNetwork, PlanRecognitionBiLSTM,
                                          PlanRecognitionBiRNN, PlanRecognitionTransformer)

ROBOT_OBS_DIM, SCENE_OBS_DIM = 15, 24

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _without(cfg: dict, *keys: str) -> dict:
    return {k: v for k, v in cfg.items() if k not in keys}


ENCODERS = "portbench.reference.port.models.encoders"  # the package of the camera encoders
MODULE_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def build_camera_encoder(cfg: dict, hw: int) -> nn.Module:
    """The camera encoder that ``cfg["_name_"]`` names: ``build(cfg, hw)`` of
    ``encoders/<_name_>.py``, ``hw`` the camera's frame side after the train
    transform. Raises ``ValueError`` naming the missing file."""
    name = cfg["_name_"]
    if not isinstance(name, str) or not MODULE_NAME.match(name):
        raise ValueError(f"camera encoder {name!r} is not a module name")
    path = Path(__file__).resolve().parent / "encoders" / f"{name}.py"
    try:
        module = importlib.import_module(f"{ENCODERS}.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"{ENCODERS}.{name}":
            raise
        raise ValueError(f"camera encoder {name!r} is not copied into the reference: "
                         f"no file {path}") from None
    return module.build(cfg, hw)


def robot_obs_width(dm_cfg: dict) -> int:
    """The width of the processed robot_obs the datamodule config gives:
    its ``keep_indices`` slices of robot_obs [++ scene_obs, when the
    observation space names it] (``data/device_transforms.process_proprio``;
    none with null proprioception dims)."""
    if dm_cfg["proprioception_dims"] is None:
        return 0
    total = ROBOT_OBS_DIM
    if "scene_obs" in dm_cfg["observation_space"].get("state_obs", ()):
        total += SCENE_OBS_DIM
    return sum(len(range(total)[lo:hi]) for lo, hi in dm_cfg["proprioception_dims"]["keep_indices"])


def build_perceptual_encoder(pe_cfg: dict, camera_hw: Dict[str, int],
                             robot_obs_dim: Optional[int]) -> Tuple[ConcatEncoders, int]:
    """(``ConcatEncoders``, the embedding's width); ``camera_hw`` is each RGB
    camera's frame side after the train transform."""
    for cam in ("depth_static", "depth_gripper", "tactile"):
        if pe_cfg.get(cam) is not None:
            raise ValueError(f"the {cam} camera is not copied into the reference")
    static = build_camera_encoder(pe_cfg["rgb_static"], camera_hw["rgb_static"])
    width = pe_cfg["rgb_static"]["visual_features"]
    kw = {}
    if pe_cfg.get("rgb_gripper") is not None:
        kw["rgb_gripper"] = build_camera_encoder(pe_cfg["rgb_gripper"], camera_hw["rgb_gripper"])
        width += pe_cfg["rgb_gripper"]["visual_features"]
    proprio = pe_cfg.get("proprio")
    if proprio:
        n = int(proprio["n_state_obs"])
        kw["proprio_dim"] = n
        width += n if robot_obs_dim is None else min(n, robot_obs_dim)
    return ConcatEncoders(static, **kw), width


def build_plan_recognition(pr_cfg: dict, in_features: int, state_dim: int):
    kind = pr_cfg.get("kind", "transformers")
    if kind == "transformers":
        return PlanRecognitionTransformer(
            in_features, state_dim, num_heads=pr_cfg.get("num_heads", 8),
            num_layers=pr_cfg.get("num_layers", 2),
            encoder_hidden_size=pr_cfg.get("encoder_hidden_size", 2048),
            fc_hidden_size=pr_cfg.get("fc_hidden_size", 4096),
            max_position_embeddings=pr_cfg.get("max_position_embeddings", 32),
            dropout_p=pr_cfg.get("dropout_p", 0.1),
            encoder_normalize=pr_cfg.get("encoder_normalize", False),
            positional_normalize=pr_cfg.get("positional_normalize", False))
    # the JAX factory builds both recurrent posteriors at their defaults, 2048 x 2
    if kind == "bilstm":
        return PlanRecognitionBiLSTM(in_features, state_dim)
    if kind == "birnn":
        return PlanRecognitionBiRNN(in_features, state_dim)
    raise ValueError(f"unknown plan_recognition kind {kind!r}")


def build_action_decoder(ad_cfg: dict, in_features: int):
    kind = ad_cfg.get("kind", "logistic")
    common = dict(
        out_features=ad_cfg.get("out_features", 7),
        hidden_size=ad_cfg.get("hidden_size", 2048),
        num_layers=ad_cfg.get("num_layers", 2),
        rnn_model=ad_cfg.get("rnn_model", "rnn_decoder"),
        policy_rnn_dropout_p=ad_cfg.get("policy_rnn_dropout_p", 0.0),
        perceptual_emb_slice=tuple(ad_cfg.get("perceptual_emb_slice", (64, 128))),
        gripper_control=ad_cfg.get("gripper_control", True),
    )
    if kind == "logistic":
        return LogisticPolicyDecoder(
            in_features, n_mixtures=ad_cfg.get("n_mixtures", 10),
            log_scale_min=ad_cfg.get("log_scale_min", -7.0),
            num_classes=ad_cfg.get("num_classes", 10),
            gripper_alpha=ad_cfg.get("gripper_alpha", 1.0),
            discrete_gripper=ad_cfg.get("discrete_gripper", True),
            act_max_bound=tuple(ad_cfg.get("act_max_bound", (1.0,) * 7)),
            act_min_bound=tuple(ad_cfg.get("act_min_bound", (-1.0,) * 7)), **common)
    raise ValueError(f"unknown action_decoder kind {kind!r}")


def build_lang_net(le_cfg: Optional[dict], in_features: int):
    """``model.language_encoder`` -> (network or None, its output width, or
    ``in_features`` without one)."""
    name = (le_cfg or {}).get("_name_")
    if name in (None, "none"):
        return None, in_features
    if name == "lang_mlp":
        net = LanguageEncoderMLP(in_features, out_features=le_cfg.get("out_features", 256),
                                 hidden_size=le_cfg.get("hidden_size", 2048),
                                 word_dropout_p=le_cfg.get("word_dropout_p", 0.0),
                                 activation_function=le_cfg.get("activation_function", "ReLU"))
        return net, le_cfg.get("out_features", 256)
    if name == "clip_text":
        return ClipTextTransformer(**_without(le_cfg, "_name_")), le_cfg["output_dim"]
    raise ValueError(f"unknown language_encoder {name!r}")


def build_policy(model_cfg: dict, camera_hw: Dict[str, int], seed: int = 42,
                 robot_obs_dim: Optional[int] = None) -> Hulc2:
    """The policy on the CPU, initialised from ``torch.Generator().manual_seed(seed)``;
    the caller moves it to its device. ``camera_hw`` is each RGB camera's
    frame side after the train transform (``camera_sizes``), which an
    encoder may be built for; ``robot_obs_dim`` is the processed
    robot_obs's width (``robot_obs_width``), by default the proprio
    encoder's ``n_state_obs``."""
    pe_cfg = model_cfg["perceptual_encoder"]
    perceptual, emb_dim = build_perceptual_encoder(pe_cfg, camera_hw, robot_obs_dim)
    dist = make_distribution(model_cfg["distribution"])
    use_plan = bool(model_cfg.get("use_plan", True))
    use_clip = bool(model_cfg.get("use_clip_auxiliary_loss", True))
    vg_cfg, lg_cfg, pr_cfg = model_cfg["visual_goal"], model_cfg["language_goal"], \
        model_cfg["plan_recognition"]
    latent = vg_cfg.get("latent_goal_features", 32)
    lang_net, lang_dim = build_lang_net(model_cfg.get("language_encoder"),
                                        lg_cfg.get("in_features", 384))
    ad_cfg = model_cfg["action_decoder"]
    slice_lo, slice_hi = ad_cfg.get("perceptual_emb_slice", (64, 128))
    slice_width = len(range(emb_dim)[slice_lo:slice_hi])
    plan_width = dist.plan_features if use_plan else 0
    plan_recognition = build_plan_recognition(pr_cfg, emb_dim, dist.state_dim)
    seq_dim = plan_recognition.seq_features

    model = Hulc2(
        perceptual_encoder=perceptual,
        plan_proposal=PlanProposalNetwork(emb_dim + latent, dist.state_dim,
                                          model_cfg["plan_proposal"].get("hidden_size", 2048)),
        plan_recognition=plan_recognition,
        visual_goal=VisualGoalEncoder(
            emb_dim, hidden_size=vg_cfg.get("hidden_size", 2048), latent_goal_features=latent,
            l2_normalize_goal_embeddings=vg_cfg.get("l2_normalize_goal_embeddings", False)),
        language_goal=LanguageGoalEncoder(
            lang_dim, hidden_size=lg_cfg.get("hidden_size", 2048),
            latent_goal_features=lg_cfg.get("latent_goal_features", 32),
            l2_normalize_goal_embeddings=lg_cfg.get("l2_normalize_goal_embeddings", False),
            word_dropout_p=lg_cfg.get("word_dropout_p", 0.0)),
        action_decoder=build_action_decoder(ad_cfg, plan_width + slice_width + latent),
        proj_vis_lang=(ProjVisLang(seq_dim, latent,
                                   (model_cfg.get("proj_vis_lang") or {}).get("output_dim", 32))
                       if use_clip else None),
        dist=dist,
        lang_net=lang_net,
        lang_task_head=(LangTaskHead(lang_dim, int(model_cfg.get("lang_task_classes", 34)))
                        if model_cfg.get("use_lang_task_auxiliary_loss") else None),
        kl_balancing_mix=model_cfg.get("kl_balancing_mix", 0.8),
        replan_freq=int(model_cfg.get("replan_freq", 30)),
        use_plan=use_plan,
        state_decoder=(StateDecoder(emb_dim, (pe_cfg.get("proprio") or {}).get("n_state_obs", 8))
                       if model_cfg.get("use_state_recons") else None),
        bcz_lang_decoder=(BCZLangDecoder(seq_dim, lang_dim)
                          if model_cfg.get("use_bc_z_auxiliary_loss") else None),
        mia_discriminator=(MIALangDiscriminator(seq_dim, lang_dim)
                           if model_cfg.get("use_mia_auxiliary_loss") else None),
    )
    model.compute_dtype = COMPUTE_DTYPES[model_cfg.get("compute_dtype", "float32")]
    return init_weights_(model, torch.Generator().manual_seed(seed))


def build_policy_for(cfg: dict, seed: Optional[int] = None) -> Hulc2:
    """``build_policy`` of a run config (``model`` and ``datamodule``): the
    cameras' sizes from its transform preset, the robot_obs width from its
    observation space and proprioception dims."""
    from portbench.reference.port.data.device_transforms import camera_sizes

    dm_cfg = cfg["datamodule"]
    return build_policy(cfg["model"], camera_sizes(dm_cfg["transforms"]),
                        seed=cfg["seed"] if seed is None else seed,
                        robot_obs_dim=robot_obs_width(dm_cfg))
