"""HULC++ low-level policy: training forward and rollout step (``hulc2_tpu/models/hulc2.py``).

One fused pass over [vis rows; lang rows]: visual goals come from the last
frame of the vis rows, language goals from the lang rows' sentence: through
the CLIP text tower from its token ids, through the trainable ``lang_mlp``
from its precomputed embedding, or, for a policy without a language network
(``language_encoder: none``), from that embedding as it is. The plan is a
straight-through (discrete) or reparameterized (continuous) sample of the
posterior; the KL is balanced with ``.detach()`` on alternating sides; GCBC
(``use_plan=False``) feeds the decoder a (B, 0) plan and has no KL. The
action loss is the logistic-mixture NLL on TCP-frame targets plus, with a
discrete gripper, the gripper CE; the CLIP aux loss (``use_clip_auxiliary_loss``)
is the static-shape masked form; the optional aux heads add the state
reconstruction (``proprio_loss``), BC-Z (``lang_pred_loss``), MIA
(``lang_contrastive_loss``) and task CE (``lang_task_loss``) metrics, each
weighted by its beta in the train step. The losses run in fp32 whatever the
compute dtype.

``policy_step`` (``hulc2.py:358-407``) is one rollout step of a batch of envs
with a per-env carry: replanning every ``replan_freq`` steps is a branchless
per-env masked select, and the random draws (the plan's Gumbel or normal
noise, the mixture's uniforms) can be handed in as ``PolicyDraws``. The
carry's hidden state is the decoder's: a tensor, or the LSTM's (h, c) pair.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from hulc2_torch.core import trace
from hulc2_torch.models.decoders import DecoderOutput, DeterministicDecoder, Hidden
from hulc2_torch.models.distributions import DiscretePlanDistribution
from hulc2_torch.models.goal_encoders import (LanguageEncoderMLP, LanguageGoalEncoder,
                                              VisualGoalEncoder)
from hulc2_torch.models.layers import l2_normalize
from hulc2_torch.models.perceptual import ConcatEncoders
from hulc2_torch.models.plan_nets import PlanProposalNetwork
from hulc2_torch.ops.gripper_frame import world_to_tcp_frame
from hulc2_torch.ops.logistic import logistic_mixture_log_prob
from hulc2_torch.parallel.batch_shard import gather_rows, masked_mean, roll_rows


class PolicyCarry(NamedTuple):
    """Device-resident rollout state of a batch of envs (``hulc2.py:41``)."""

    plan: torch.Tensor  # (B, plan_features), (B, 0) for GCBC
    latent_goal: torch.Tensor  # (B, goal_features)
    hidden: Hidden  # the decoder's state: (L, B, H), or (h, c) for the LSTM
    step: torch.Tensor  # (B,) int32 rollout step counters


class PolicyDraws(NamedTuple):
    """The random numbers of one ``policy_step``, for tests that feed both
    frameworks the same draws."""

    plan_gumbel: Optional[torch.Tensor]  # (B, categories, classes), discrete plans
    u_sel: torch.Tensor  # (B, 1, M, K) component-selection uniforms
    u: torch.Tensor  # (B, 1, M) inversion uniforms
    plan_normal: Optional[torch.Tensor] = None  # (B, plan_features), continuous plans


def map_hidden(fn, hidden: Hidden) -> Hidden:
    """``fn`` on each tensor of a decoder state."""
    return tuple(fn(h) for h in hidden) if isinstance(hidden, tuple) else fn(hidden)


class Hulc2(nn.Module):
    def __init__(self, perceptual_encoder: ConcatEncoders, plan_proposal: PlanProposalNetwork,
                 plan_recognition: nn.Module, visual_goal: VisualGoalEncoder,
                 language_goal: LanguageGoalEncoder, action_decoder: nn.Module,
                 proj_vis_lang: Optional[nn.Module], dist,
                 lang_net: Optional[nn.Module] = None, lang_task_head: Optional[nn.Module] = None,
                 kl_balancing_mix: float = 0.8, replan_freq: int = 30, use_plan: bool = True,
                 state_decoder: Optional[nn.Module] = None,
                 bcz_lang_decoder: Optional[nn.Module] = None,
                 mia_discriminator: Optional[nn.Module] = None):
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
        self.state_decoder = state_decoder
        self.bcz_lang_decoder = bcz_lang_decoder
        self.mia_discriminator = mia_discriminator
        self.dist = dist
        self.kl_balancing_mix = kl_balancing_mix
        self.replan_freq = replan_freq
        self.use_plan = use_plan
        # the CLIP aux loss's temperature exists only with the loss, as in JAX
        if proj_vis_lang is not None:
            self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))

    @property
    def use_clip_auxiliary_loss(self) -> bool:
        return self.proj_vis_lang is not None

    def _decoder(self):
        """The action decoder, which the JAX ``Hulc2`` can train and roll out
        only as the logistic one."""
        if isinstance(self.action_decoder, DeterministicDecoder):
            raise NotImplementedError(
                "the deterministic action decoder: JAX's Hulc2 can neither train nor roll it out "
                "(its action loss reads the logistic decoder's bounds, hulc2.py:239-260)")
        return self.action_decoder

    def _plan(self, state: torch.Tensor, noise: Optional[torch.Tensor],
              generator: Optional[torch.Generator], rsample: bool) -> torch.Tensor:
        """A plan from ``state`` (the posterior's in training, straight-through
        or reparameterized), or the (B, 0) plan of GCBC."""
        if not self.use_plan:
            return state.new_zeros(state.shape[0], 0)
        return (self.dist.rsample if rsample else self.dist.sample)(state, noise, generator)

    def encode(self, obs: Dict, deterministic: bool = True,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The perceptual embedding (B, S, E) of a transformed batch's
        ``rgb_obs``, ``depth_obs`` and processed ``robot_obs``."""
        return self.perceptual_encoder(obs["rgb_obs"], obs.get("depth_obs"), obs.get("robot_obs"),
                                       deterministic, generator)

    def encode_goals(self, emb: torch.Tensor, lang_emb: Optional[torch.Tensor], n_vis: int,
                     deterministic: bool = True,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Visual goals of the first ``n_vis`` rows (their last frame), then
        the language goals of the rest (``hulc2.py:100-106``)."""
        goals = [self.visual_goal(emb[:n_vis, -1])] if n_vis else []
        if lang_emb is not None:
            goals.append(self.language_goal(lang_emb, deterministic, generator))
        return torch.cat(goals) if len(goals) > 1 else goals[0]

    def forward(self, batch: Dict, kl_beta: Union[float, torch.Tensor], n_vis: int,
                deterministic: bool = False,
                generator: Optional[torch.Generator] = None,
                gumbel: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Fused [vis; lang] batch -> metrics dict (``fused_n_vis`` form of the
        JAX ``__call__``). ``batch`` holds ``rgb_obs`` {cam: (B, S, H, W, C)},
        ``depth_obs`` {cam: (B, S, H, W)}, ``robot_obs``, ``actions``,
        ``robot_obs_raw`` and, for the lang rows, ``lang`` (token ids, or
        embeddings without a tower), ``use_for_aux_lang_loss`` and
        ``lang_task_id``. A single-modality batch has only vis rows (no
        ``lang``) or only lang rows (``n_vis`` 0), and only that modality's
        metrics, as JAX's ``mods``. ``kl_beta`` is a float or a float32
        scalar on the device. ``gumbel`` replaces the plan sampler's
        draw: Gumbel noise (B, categories, classes) for discrete plans,
        standard normal (B, plan_features) for continuous ones. Its parts are
        spans of ``core/trace`` while tracing is on: ``model.encode`` (the
        perceptual encoder), ``model.encode_lang`` (the language tower and the
        goals), ``model.plan`` (proposal, recognition, the sample, the KL),
        ``model.decode`` (the decoder and the action loss) and ``model.aux``
        (the CLIP, aux and task heads)."""
        dec = self._decoder()
        actions, robot_obs_raw = batch["actions"], batch["robot_obs_raw"]
        has_lang = "lang" in batch
        splits = {"vis": (0, n_vis)} if n_vis else {}
        if has_lang:
            splits["lang"] = (n_vis, actions.shape[0])

        with trace.span("model.encode"):
            emb = self.encode(batch, deterministic, generator)
        with trace.span("model.encode_lang"):
            lang_emb = (self.encode_lang(batch["lang"], deterministic, generator) if has_lang
                        else None)
            latent_goal = self.encode_goals(emb, lang_emb, n_vis, deterministic, generator)

        with trace.span("model.plan"):
            pp_state = self.plan_proposal(emb[:, 0], latent_goal)
            pr_state, seq_feat = self.plan_recognition(emb, deterministic, generator)
            plan = self._plan(pr_state, gumbel, generator, rsample=True)
            kl = (self.balanced_kl_per_sample(pp_state, pr_state) if self.use_plan
                  else pr_state.new_zeros(pr_state.shape[0]))

        with trace.span("model.decode"):
            dec_out = dec(plan, emb, latent_goal)
            act = self.action_loss_per_sample(dec_out, actions, robot_obs_raw)
            metrics: Dict[str, torch.Tensor] = {}
            for m, (lo, hi) in splits.items():
                kl_m = kl[lo:hi].mean()
                # a device-scalar beta (the replayed train step's) rounds as a float would
                metrics[f"kl_loss_{m}"] = (kl_beta * kl_m).to(kl_m.dtype)
                metrics[f"action_loss_{m}"] = act[lo:hi].mean()
            kl_loss = sum(metrics[f"kl_loss_{m}"] for m in splits) / len(splits)
            action_loss = sum(metrics[f"action_loss_{m}"] for m in splits) / len(splits)

        with trace.span("model.aux"):
            aux_mask = batch.get("use_for_aux_lang_loss")
            if self.use_clip_auxiliary_loss and has_lang:
                metrics["lang_clip_loss"] = self.clip_auxiliary_loss(
                    seq_feat[n_vis:], latent_goal[n_vis:], aux_mask)
            metrics.update(self.aux_metrics(emb, batch["robot_obs"], seq_feat[n_vis:], lang_emb,
                                            aux_mask))
            if self.lang_task_head is not None and has_lang and "lang_task_id" in batch:
                metrics.update(self.lang_task_metrics(lang_emb, batch["lang_task_id"]))
        metrics.update(kl_loss=kl_loss, action_loss=action_loss, total_loss=kl_loss + action_loss)
        return metrics

    def aux_metrics(self, emb: torch.Tensor, robot_obs: torch.Tensor, lang_seq_feat: torch.Tensor,
                    lang_emb: Optional[torch.Tensor],
                    aux_mask: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The GCBC aux heads' losses (``hulc2.py:200-215``): the proprio state
        from the embedding (MSE), and, with lang rows, the language embedding
        from their sequence features (1 - cosine, over the aux mask) and the
        MIA discriminator's BCE with ``roll(lang_emb, 1)`` as the negatives.
        In a data-parallel step the masked means divide by the global count
        and the roll runs over the global batch (``parallel/batch_shard.py``)."""
        out: Dict[str, torch.Tensor] = {}
        with torch.autocast(device_type=emb.device.type, enabled=False):
            if self.state_decoder is not None:
                recon = self.state_decoder(emb.float())
                out["proprio_loss"] = ((recon - robot_obs.float()) ** 2).mean()
            if lang_emb is None:
                return out
            mask = aux_mask.float()
            if self.bcz_lang_decoder is not None:
                pred = self.bcz_lang_decoder(lang_seq_feat.float())
                cos = (l2_normalize(pred, 1e-8) * l2_normalize(lang_emb.float(), 1e-8)).sum(-1)
                out["lang_pred_loss"] = masked_mean(1.0 - cos, mask)
            if self.mia_discriminator is not None:
                vis, lang = lang_seq_feat.float(), lang_emb.float()
                pos = self.mia_discriminator(vis, lang)[..., 0]
                neg = self.mia_discriminator(vis, roll_rows(lang, 1))[..., 0]
                bce = F.softplus(-pos) + F.softplus(neg)
                out["lang_contrastive_loss"] = masked_mean(bce, mask)
        return out

    def val_forward(self, batch: Dict[str, Dict], kl_beta: float,
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[Dict[str, PolicyDraws]] = None) -> Dict[str, torch.Tensor]:
        """Validation metrics of one {"vis": ..., "lang": ...} batch (or of one
        modality alone), each modality transformed on its own
        (``hulc2.py:287-337``): the decoder
        under a plan sampled from the proposal ("pp") and from the recognition
        network ("pr"), each with its action loss, the MAE of sampled actions
        (total, position, orientation) and the gripper success rate per
        modality; with plans, the balanced KL per modality; with the CLIP
        loss, that of the lang rows. No dropout. ``draws`` maps "pp" and "pr"
        to the plan's noise and the mixture's uniforms (B, S, M, K) and
        (B, S, M); without them the draws come from ``generator``."""
        dec = self._decoder()
        parts = [batch[m] for m in ("vis", "lang") if m in batch]

        def cat(values):
            return torch.cat(values) if len(values) > 1 else values[0]

        obs = {group: {k: cat([p[group][k] for p in parts]) for k in parts[0].get(group, {})}
               for group in ("rgb_obs", "depth_obs")}
        obs["robot_obs"] = cat([p["robot_obs"] for p in parts])
        actions = cat([p["actions"] for p in parts])
        robot_obs_raw = cat([p["robot_obs_raw"] for p in parts])
        n_vis = batch["vis"]["actions"].shape[0] if "vis" in batch else 0
        splits = {"vis": (0, n_vis)} if n_vis else {}
        lang_emb = None
        if "lang" in batch:
            splits["lang"] = (n_vis, actions.shape[0])
            lang_emb = self.encode_lang(batch["lang"]["lang"])

        emb = self.encode(obs)
        latent_goal = self.encode_goals(emb, lang_emb, n_vis)
        pp_state = self.plan_proposal(emb[:, 0], latent_goal)
        pr_state, seq_feat = self.plan_recognition(emb)

        metrics: Dict[str, torch.Tensor] = {}
        for tag, state in (("pp", pp_state), ("pr", pr_state)):
            d = None if draws is None else draws[tag]
            plan = self._plan(state.float(), self._plan_noise(d), generator, rsample=False)
            dec_out = dec(plan, emb, latent_goal)
            act_ps = self.action_loss_per_sample(dec_out, actions, robot_obs_raw)
            sampled = dec.sample_actions(dec_out, robot_obs_raw, None if d is None else d.u_sel,
                                         None if d is None else d.u, generator)
            with torch.autocast(device_type=actions.device.type, enabled=False):
                mae = (sampled[..., :-1] - actions[..., :-1]).abs().mean(dim=1)  # (B, A-1)
                grip_pred = torch.where(sampled[..., -1] > 0, 1.0, -1.0)
                grip_sr = (grip_pred == actions[..., -1]).float().mean(dim=-1)
            for m, (lo, hi) in splits.items():
                metrics[f"{m}_act_loss_{tag}"] = act_ps[lo:hi].mean()
                metrics[f"{m}_total_mae_{tag}"] = mae[lo:hi].mean()
                metrics[f"{m}_pos_mae_{tag}"] = mae[lo:hi, :3].mean()
                metrics[f"{m}_orn_mae_{tag}"] = mae[lo:hi, 3:6].mean()
                metrics[f"{m}_grip_sr_{tag}"] = grip_sr[lo:hi].mean()
        if self.use_plan:
            kl = self.balanced_kl_per_sample(pp_state, pr_state)
            for m, (lo, hi) in splits.items():
                metrics[f"{m}_kl_loss"] = kl_beta * kl[lo:hi].mean()
        if self.use_clip_auxiliary_loss and lang_emb is not None:
            metrics["val_pred_clip_loss"] = self.clip_auxiliary_loss(
                seq_feat[n_vis:], latent_goal[n_vis:], batch["lang"]["use_for_aux_lang_loss"])
        return metrics

    def _plan_noise(self, draws: Optional[PolicyDraws]) -> Optional[torch.Tensor]:
        if draws is None:
            return None
        return draws.plan_gumbel if isinstance(self.dist, DiscretePlanDistribution) \
            else draws.plan_normal

    def encode_lang(self, lang: torch.Tensor, deterministic: bool = True,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The language embedding of a "lang" value: the text tower over token
        ids, ``lang_mlp`` over the precomputed embedding, or that embedding
        itself for a policy without a language network (``hulc2.py:92-99``)."""
        if self.lang_net is None:
            return lang
        if isinstance(self.lang_net, LanguageEncoderMLP):
            return self.lang_net(lang, deterministic, generator)
        return self.lang_net(lang)

    def balanced_kl_per_sample(self, pp_state: torch.Tensor, pr_state: torch.Tensor) -> torch.Tensor:
        alpha = self.kl_balancing_mix
        lhs = self.dist.kl_divergence(pr_state.detach(), pp_state)
        rhs = self.dist.kl_divergence(pr_state, pp_state.detach())
        return alpha * lhs + (1 - alpha) * rhs

    def action_loss_per_sample(self, dec_out: DecoderOutput, actions: torch.Tensor,
                               robot_obs_raw: torch.Tensor) -> torch.Tensor:
        """Mixture NLL summed over the mixture's dims plus, with a discrete
        gripper, the gripper CE, each meaned over the window -> (B,)."""
        dec = self._decoder()
        with torch.autocast(device_type=actions.device.type, enabled=False):
            if dec.gripper_control:
                actions = world_to_tcp_frame(actions, robot_obs_raw)
            amin, amax = dec.bounds()
            lp = logistic_mixture_log_prob(
                dec_out.logit_probs, dec_out.log_scales, dec_out.means,
                actions[..., :dec.mixture_dims], amin, amax, dec.num_classes, dec.log_scale_min)
            nll = -lp.sum(dim=-1).mean(dim=-1)
            if not dec.discrete_gripper:
                return nll
            labels = (actions[..., -1] > 0).long()
            logp = torch.log_softmax(dec_out.gripper_logits, dim=-1)
            ce = -logp.gather(-1, labels[..., None])[..., 0].mean(dim=-1)
        return nll + dec.gripper_alpha * ce
    def clip_auxiliary_loss(self, seq_vis_feat: torch.Tensor, encoded_lang: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
        """Contrastive loss over the valid lang rows, with invalid columns
        masked to -1e9 (``hulc2.py:262-282``). In a data-parallel step every
        rank computes it over the lang rows of all ranks."""
        img, txt = self.proj_vis_lang(seq_vis_feat, encoded_lang)
        with torch.autocast(device_type=img.device.type, enabled=False):
            img = gather_rows(img.float() / img.float().norm(dim=-1, keepdim=True))
            txt = gather_rows(txt.float() / txt.float().norm(dim=-1, keepdim=True))
            mask = gather_rows(mask.float())
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
        """Task CE (and accuracy) over rows whose id is >= 0, over the global
        batch in a data-parallel step."""
        logits = self.lang_task_head(lang_emb)
        valid = (task_ids >= 0).float()
        labels = task_ids.clamp(min=0).long()
        ce = -torch.log_softmax(logits, dim=-1).gather(-1, labels[:, None])[:, 0]
        acc = (logits.argmax(dim=-1) == labels).float()
        return {"lang_task_loss": masked_mean(ce, valid),
                "lang_task_acc": masked_mean(acc, valid)}

    def init_carry(self, batch_size: int, device=None) -> PolicyCarry:
        """A zero carry for ``batch_size`` envs, fp32, whose first step replans
        (``hulc2.py:342-356``)."""
        plan_width = self.dist.plan_features if self.use_plan else 0
        return PolicyCarry(
            plan=torch.zeros((batch_size, plan_width), device=device),
            latent_goal=torch.zeros((batch_size, self.visual_goal.ln.normalized_shape[0]),
                                    device=device),
            hidden=self.action_decoder.zero_hidden(batch_size, torch.float32, device),
            step=torch.zeros((batch_size,), dtype=torch.int32, device=device),
        )

    def policy_step(self, rgb_obs: Dict[str, torch.Tensor], robot_obs_raw: torch.Tensor,
                    goal: Dict, carry: PolicyCarry, generator: Optional[torch.Generator] = None,
                    draws: Optional[PolicyDraws] = None,
                    depth_obs: Optional[Dict[str, torch.Tensor]] = None,
                    robot_obs: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, PolicyCarry]:
        """One rollout step for B envs -> (world-frame action (B, 7), new carry).

        ``rgb_obs`` holds transformed single frames (B, 1, H, W, C) per camera,
        ``depth_obs`` (B, 1, H, W) per depth camera, ``robot_obs_raw`` (B, 1,
        15) and ``robot_obs`` the processed proprio (B, 1, P) that a proprio
        encoder reads. ``goal`` is {"lang": token ids (B, 77)}, which pass
        through the text tower on every step as in the JAX package, or
        sentence embeddings (B, E) for a policy without a tower, or
        {"rgb_obs": goal frames[, "depth_obs", "robot_obs"]} for visual goals. A new plan (none
        for GCBC) and both action samples are drawn on every step; envs whose
        step counter is a multiple of ``replan_freq`` take the new plan and
        goal and restart the decoder from a zero state (``hulc2.py:394-400``)."""
        dec = self._decoder()
        emb = self.encode({"rgb_obs": rgb_obs, "depth_obs": depth_obs, "robot_obs": robot_obs})
        if "lang" in goal:
            latent_goal = self.language_goal(self.encode_lang(goal["lang"]))
        else:
            latent_goal = self.visual_goal(self.encode(goal)[:, -1])
        if self.use_plan:
            new_plan = self.dist.sample(self.plan_proposal(emb[:, 0], latent_goal).float(),
                                        self._plan_noise(draws), generator)
        else:
            new_plan = carry.plan

        replan = (carry.step % self.replan_freq) == 0  # (B,)
        m = replan[:, None]
        plan = torch.where(m, new_plan.to(carry.plan.dtype), carry.plan)
        latent_goal = torch.where(m, latent_goal.to(carry.latent_goal.dtype), carry.latent_goal)
        hidden = map_hidden(lambda h: torch.where(replan[None, :, None], 0.0, h), carry.hidden)

        dec_out = dec(plan, emb, latent_goal, h0=hidden)
        action = dec.sample_actions(dec_out, robot_obs_raw,
                                    None if draws is None else draws.u_sel,
                                    None if draws is None else draws.u, generator)
        # the carry keeps its dtype whatever the rnn ran in
        if isinstance(hidden, tuple):
            new_hidden = tuple(n.to(o.dtype) for n, o in zip(dec_out.hidden, carry.hidden))
        else:
            new_hidden = dec_out.hidden.to(carry.hidden.dtype)
        new_carry = PolicyCarry(plan, latent_goal, new_hidden, carry.step + 1)
        return action[:, -1], new_carry
