"""Model config dict -> the port's ``Hulc2`` (``hulc2_tpu/models/build.py:219``).

Ported: VisionNetwork static + nature_cnn gripper encoders, transformer
posterior, discrete plans, logistic ReLU-RNN decoder, the CLIP aux loss; the
language side either the CLIP text tower over token ids (the flagship) or
none (``cfg_low_level``: precomputed sentence embeddings of
``language_goal.in_features`` go straight into the goal MLP); the task-CE
head on the language embedding with ``use_lang_task_auxiliary_loss``.
Anything else (``lang_mlp`` among them) raises by name.
"""
from __future__ import annotations

import torch

from hulc2_torch.models.aux_nets import LangTaskHead, ProjVisLang
from hulc2_torch.models.clip_text import ClipTextTransformer
from hulc2_torch.models.decoders import LogisticPolicyDecoder
from hulc2_torch.models.distributions import DiscretePlanDistribution
from hulc2_torch.models.goal_encoders import LanguageGoalEncoder, VisualGoalEncoder
from hulc2_torch.models.hulc2 import Hulc2
from hulc2_torch.models.layers import init_weights_
from hulc2_torch.models.perceptual import ConcatEncoders
from hulc2_torch.models.plan_nets import PlanProposalNetwork, PlanRecognitionTransformer
from hulc2_torch.models.vision import VisionNetwork, VisionNetworkGripper

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _without(cfg: dict, *keys: str) -> dict:
    return {k: v for k, v in cfg.items() if k not in keys}


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise NotImplementedError(f"{what} is not ported")


def build_policy(model_cfg: dict, gripper_hw: int = 64, seed: int = 42) -> Hulc2:
    """The policy on the CPU, initialised from ``torch.Generator().manual_seed(seed)``;
    the caller moves it to its device. ``gripper_hw`` is the gripper camera's
    image size (it fixes the nature_cnn flatten width)."""
    pe_cfg = model_cfg["perceptual_encoder"]
    _require(pe_cfg["rgb_static"]["_name_"] == "vision_network", "this static encoder")
    _require(pe_cfg["rgb_gripper"]["_name_"] == "vision_network_gripper", "this gripper encoder")
    _require(all(pe_cfg.get(k) is None for k in ("depth_static", "depth_gripper", "tactile",
                                                  "proprio")), "a depth/tactile/proprio encoder")
    d_cfg, pr_cfg = model_cfg["distribution"], model_cfg["plan_recognition"]
    _require(d_cfg["dist"] == "discrete", "the continuous plan distribution")
    _require(pr_cfg.get("kind", "transformers") == "transformers", f"posterior {pr_cfg.get('kind')}")
    _require(model_cfg.get("use_plan", True), "GCBC (use_plan=false)")
    _require(model_cfg.get("use_clip_auxiliary_loss", True), "use_clip_auxiliary_loss=false")
    _require(not any(model_cfg.get(k) for k in ("use_state_recons", "use_bc_z_auxiliary_loss",
                                                 "use_mia_auxiliary_loss")), "that aux loss")
    le_cfg = model_cfg.get("language_encoder") or {}
    tower = le_cfg.get("_name_") == "clip_text"
    _require(tower or le_cfg.get("_name_") in (None, "none"),
             f"language encoder {le_cfg.get('_name_')}")
    task_head = bool(model_cfg.get("use_lang_task_auxiliary_loss", False))
    ad_cfg = model_cfg["action_decoder"]
    _require(ad_cfg.get("kind", "logistic") == "logistic", "the deterministic decoder")

    static = VisionNetwork(**_without(pe_cfg["rgb_static"], "_name_"))
    gripper = VisionNetworkGripper(gripper_hw, **_without(pe_cfg["rgb_gripper"], "_name_"))
    emb_dim = pe_cfg["rgb_static"]["visual_features"] + pe_cfg["rgb_gripper"]["visual_features"]
    dist = DiscretePlanDistribution(d_cfg["category_size"], d_cfg["class_size"])
    vg_cfg, lg_cfg = model_cfg["visual_goal"], model_cfg["language_goal"]
    latent = vg_cfg["latent_goal_features"]
    lang_net = ClipTextTransformer(**_without(le_cfg, "_name_")) if tower else None
    # the goal MLP takes the tower's output, or the dataset's embeddings
    lang_dim = le_cfg["output_dim"] if tower else lg_cfg["in_features"]
    pp_cfg = model_cfg["plan_proposal"]
    _require(pp_cfg.get("activation_function", "ReLU") == "ReLU", "that activation")
    _require(pr_cfg.get("position_embedding", True), "a posterior without position embeddings")
    slice_lo, slice_hi = ad_cfg["perceptual_emb_slice"]

    model = Hulc2(
        perceptual_encoder=ConcatEncoders(static, gripper),
        plan_proposal=PlanProposalNetwork(emb_dim + latent, dist.plan_features,
                                          pp_cfg["hidden_size"]),
        plan_recognition=PlanRecognitionTransformer(
            emb_dim, dist.plan_features,
            **_without(pr_cfg, "kind", "position_embedding")),
        visual_goal=VisualGoalEncoder(emb_dim, **vg_cfg),
        language_goal=LanguageGoalEncoder(lang_dim, **_without(lg_cfg, "in_features")),
        action_decoder=LogisticPolicyDecoder(
            dist.plan_features + (slice_hi - slice_lo) + latent, **_without(ad_cfg, "kind")),
        proj_vis_lang=ProjVisLang(pr_cfg["fc_hidden_size"], latent,
                                  **model_cfg.get("proj_vis_lang", {})),
        dist=dist,
        lang_net=lang_net,
        lang_task_head=(LangTaskHead(lang_dim, int(model_cfg.get("lang_task_classes", 34)))
                        if task_head else None),
        kl_balancing_mix=model_cfg.get("kl_balancing_mix", 0.8),
        replan_freq=int(model_cfg.get("replan_freq", 30)),
    )
    model.compute_dtype = COMPUTE_DTYPES[model_cfg.get("compute_dtype", "float32")]
    return init_weights_(model, torch.Generator().manual_seed(seed))
