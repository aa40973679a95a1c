"""HULC++ low-level policy: training forward and rollout step (``hulc2_tpu/models/hulc2.py``).

One fused pass over [vis rows; lang rows]: visual goals come from the last
frame of the vis rows, language goals from the CLIP text tower on the lang
rows. The discrete plan is a straight-through sample of the posterior; the
KL is balanced with ``.detach()`` on alternating sides; the action loss is the
logistic-mixture NLL on TCP-frame targets plus the gripper CE; the CLIP aux
loss is the static-shape masked form; the task CE head supervises the tower.
The losses run in fp32 whatever the compute dtype.

``policy_step`` (``hulc2.py:358-407``) is one rollout step of a batch of envs
with a per-env carry: replanning every ``replan_freq`` steps is a branchless
per-env masked select, and the random draws (the plan's Gumbel noise, the
mixture's uniforms) can be handed in as ``PolicyDraws``.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from hulc2_torch.models.aux_nets import LangTaskHead, ProjVisLang
from hulc2_torch.models.clip_text import ClipTextTransformer
from hulc2_torch.models.decoders import DecoderOutput, LogisticPolicyDecoder
from hulc2_torch.models.distributions import DiscretePlanDistribution
from hulc2_torch.models.goal_encoders import LanguageGoalEncoder, VisualGoalEncoder
from hulc2_torch.models.perceptual import ConcatEncoders
from hulc2_torch.models.plan_nets import PlanProposalNetwork, PlanRecognitionTransformer
from hulc2_torch.ops.gripper_frame import world_to_tcp_frame
from hulc2_torch.ops.logistic import logistic_mixture_log_prob


class PolicyCarry(NamedTuple):
    """Device-resident rollout state of a batch of envs (``hulc2.py:41``)."""

    plan: torch.Tensor  # (B, plan_features)
    latent_goal: torch.Tensor  # (B, goal_features)
    hidden: torch.Tensor  # (L, B, H) decoder RNN state
    step: torch.Tensor  # (B,) int32 rollout step counters


class PolicyDraws(NamedTuple):
    """The random numbers of one ``policy_step``, for tests that feed both
    frameworks the same draws."""

    plan_gumbel: torch.Tensor  # (B, categories, classes)
    u_sel: torch.Tensor  # (B, 1, A-1, K) component-selection uniforms
    u: torch.Tensor  # (B, 1, A-1) inversion uniforms


class Hulc2(nn.Module):
    def __init__(self, perceptual_encoder: ConcatEncoders, plan_proposal: PlanProposalNetwork,
                 plan_recognition: PlanRecognitionTransformer, visual_goal: VisualGoalEncoder,
                 language_goal: LanguageGoalEncoder, action_decoder: LogisticPolicyDecoder,
                 proj_vis_lang: ProjVisLang, dist: DiscretePlanDistribution,
                 lang_net: ClipTextTransformer, lang_task_head: LangTaskHead,
                 kl_balancing_mix: float = 0.8, replan_freq: int = 30):
        super().__init__()
        self.perceptual_encoder = perceptual_encoder
        self.plan_proposal = plan_proposal
        self.plan_recognition = plan_recognition
        self.visual_goal = visual_goal
        self.language_goal = language_goal
        self.action_decoder = action_decoder
        self.proj_vis_lang = proj_vis_lang
        self.lang_net = lang_net
        self.lang_task_head = lang_task_head
        self.dist = dist
        self.kl_balancing_mix = kl_balancing_mix
        self.replan_freq = replan_freq
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))

    def forward(self, batch: Dict, kl_beta: float, n_vis: int, deterministic: bool = False,
                generator: Optional[torch.Generator] = None,
                gumbel: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Fused [vis; lang] batch -> metrics dict (``fused_n_vis`` form of the
        JAX ``__call__``, with both modalities). ``batch`` holds ``rgb_obs``
        {cam: (B, S, H, W, C)}, ``actions``, ``robot_obs_raw`` and, for the
        lang rows, ``lang`` token ids, ``use_for_aux_lang_loss`` and
        ``lang_task_id``. ``gumbel`` (B, categories, classes) replaces the
        plan sampler's draw."""
        actions, robot_obs_raw = batch["actions"], batch["robot_obs_raw"]
        splits = {"vis": (0, n_vis), "lang": (n_vis, actions.shape[0])}

        emb = self.perceptual_encoder(batch["rgb_obs"], deterministic, generator)
        lang_emb = self.lang_net(batch["lang"])
        latent_goal = torch.cat([self.visual_goal(emb[:n_vis, -1]), self.language_goal(lang_emb)])

        pp_logits = self.plan_proposal(emb[:, 0], latent_goal)
        pr_logits, seq_feat = self.plan_recognition(emb, deterministic, generator)
        plan = self.dist.rsample(pr_logits, gumbel, generator)
        kl = self.balanced_kl_per_sample(pp_logits, pr_logits)

        dec_out = self.action_decoder(plan, emb, latent_goal)
        act = self.action_loss_per_sample(dec_out, actions, robot_obs_raw)

        metrics: Dict[str, torch.Tensor] = {}
        for m, (lo, hi) in splits.items():
            metrics[f"kl_loss_{m}"] = kl_beta * kl[lo:hi].mean()
            metrics[f"action_loss_{m}"] = act[lo:hi].mean()
        kl_loss = sum(metrics[f"kl_loss_{m}"] for m in splits) / len(splits)
        action_loss = sum(metrics[f"action_loss_{m}"] for m in splits) / len(splits)
        metrics["lang_clip_loss"] = self.clip_auxiliary_loss(
            seq_feat[n_vis:], latent_goal[n_vis:], batch["use_for_aux_lang_loss"])
        metrics.update(self.lang_task_metrics(lang_emb, batch["lang_task_id"]))
        metrics.update(kl_loss=kl_loss, action_loss=action_loss, total_loss=kl_loss + action_loss)
        return metrics

    def balanced_kl_per_sample(self, pp_logits: torch.Tensor, pr_logits: torch.Tensor) -> torch.Tensor:
        alpha = self.kl_balancing_mix
        lhs = self.dist.kl_divergence(pr_logits.detach(), pp_logits)
        rhs = self.dist.kl_divergence(pr_logits, pp_logits.detach())
        return alpha * lhs + (1 - alpha) * rhs

    def action_loss_per_sample(self, dec_out: DecoderOutput, actions: torch.Tensor,
                               robot_obs_raw: torch.Tensor) -> torch.Tensor:
        """Mixture NLL summed over action dims plus the gripper CE, each
        meaned over the window -> (B,)."""
        dec = self.action_decoder
        with torch.autocast(device_type=actions.device.type, enabled=False):
            if dec.gripper_control:
                actions = world_to_tcp_frame(actions, robot_obs_raw)
            amin, amax = dec.bounds(actions.device)
            lp = logistic_mixture_log_prob(
                dec_out.logit_probs, dec_out.log_scales, dec_out.means, actions[..., :-1],
                amin, amax, dec.num_classes, dec.log_scale_min)
            nll = -lp.sum(dim=-1).mean(dim=-1)
            labels = (actions[..., -1] > 0).long()
            logp = torch.log_softmax(dec_out.gripper_logits, dim=-1)
            ce = -logp.gather(-1, labels[..., None])[..., 0].mean(dim=-1)
        return nll + dec.gripper_alpha * ce

    def clip_auxiliary_loss(self, seq_vis_feat: torch.Tensor, encoded_lang: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
        """Contrastive loss over the valid lang rows, with invalid columns
        masked to -1e9 (``hulc2.py:262-282``)."""
        img, txt = self.proj_vis_lang(seq_vis_feat, encoded_lang)
        with torch.autocast(device_type=img.device.type, enabled=False):
            img = img.float() / img.float().norm(dim=-1, keepdim=True)
            txt = txt.float() / txt.float().norm(dim=-1, keepdim=True)
            logits = torch.exp(self.logit_scale) * (img @ txt.T)
            mask = mask.bool()
            neg = torch.full_like(logits, -1e9)
            masked = torch.where(mask[None, :], logits, neg)
            row_ce = torch.logsumexp(masked, dim=-1) - torch.diagonal(masked)
            masked_t = torch.where(mask[None, :], logits.T, neg)
            col_ce = torch.logsumexp(masked_t, dim=-1) - torch.diagonal(masked_t)
            zero = torch.zeros_like(row_ce)
            n_valid = mask.sum().clamp(min=1)
            loss = (torch.where(mask, row_ce, zero).sum()
                    + torch.where(mask, col_ce, zero).sum()) / (2 * n_valid)
            return torch.where(mask.any(), loss, torch.zeros_like(loss))

    def lang_task_metrics(self, lang_emb: torch.Tensor, task_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Task CE (and accuracy) over rows whose id is >= 0."""
        logits = self.lang_task_head(lang_emb)
        valid = (task_ids >= 0).float()
        labels = task_ids.clamp(min=0).long()
        ce = -torch.log_softmax(logits, dim=-1).gather(-1, labels[:, None])[:, 0]
        denom = valid.sum().clamp(min=1.0)
        acc = (logits.argmax(dim=-1) == labels).float()
        return {"lang_task_loss": (ce * valid).sum() / denom,
                "lang_task_acc": (acc * valid).sum() / denom}

    def init_carry(self, batch_size: int, device=None) -> PolicyCarry:
        """A zero carry for ``batch_size`` envs, fp32, whose first step replans."""
        dec = self.action_decoder
        zeros = functools.partial(torch.zeros, dtype=torch.float32, device=device)
        return PolicyCarry(
            plan=zeros((batch_size, self.dist.plan_features)),
            latent_goal=zeros((batch_size, self.visual_goal.ln.normalized_shape[0])),
            hidden=zeros((dec.rnn.num_layers, batch_size, dec.rnn.hidden_size)),
            step=torch.zeros((batch_size,), dtype=torch.int32, device=device),
        )

    def policy_step(self, rgb_obs: Dict[str, torch.Tensor], robot_obs_raw: torch.Tensor,
                    goal: Dict, carry: PolicyCarry, generator: Optional[torch.Generator] = None,
                    draws: Optional[PolicyDraws] = None) -> Tuple[torch.Tensor, PolicyCarry]:
        """One rollout step for B envs -> (world-frame action (B, 7), new carry).

        ``rgb_obs`` holds transformed single frames (B, 1, H, W, C) per camera
        and ``robot_obs_raw`` (B, 1, 15). ``goal`` is {"lang": token ids
        (B, 77)}, which pass through the text tower on every step as in the
        JAX package, or {"rgb_obs": goal frames} for visual goals. A new plan
        and both action samples are drawn on every step; envs whose step
        counter is a multiple of ``replan_freq`` take the new plan and goal and
        restart the decoder from a zero state (``hulc2.py:394-400``)."""
        emb = self.perceptual_encoder(rgb_obs)
        if "lang" in goal:
            latent_goal = self.language_goal(self.lang_net(goal["lang"]))
        else:
            latent_goal = self.visual_goal(self.perceptual_encoder(goal["rgb_obs"])[:, -1])
        pp_logits = self.plan_proposal(emb[:, 0], latent_goal)
        new_plan = self.dist.sample(pp_logits.float(), None if draws is None else draws.plan_gumbel,
                                    generator)

        replan = (carry.step % self.replan_freq) == 0  # (B,)
        m = replan[:, None]
        plan = torch.where(m, new_plan.to(carry.plan.dtype), carry.plan)
        latent_goal = torch.where(m, latent_goal.to(carry.latent_goal.dtype), carry.latent_goal)
        hidden = torch.where(replan[None, :, None], 0.0, carry.hidden)

        dec = self.action_decoder
        dec_out = dec(plan, emb, latent_goal, h0=hidden)
        action = dec.sample_actions(dec_out, robot_obs_raw,
                                    None if draws is None else draws.u_sel,
                                    None if draws is None else draws.u, generator)
        new_carry = PolicyCarry(plan, latent_goal, dec_out.hidden.to(carry.hidden.dtype),
                                carry.step + 1)
        return action[:, -1], new_carry
