"""Logistic-mixture ReLU-RNN action decoder and its sampler (``models/decoders.py:48``).

Input per step: plan ++ perceptual_emb[slice] ++ goal; a 2-layer ReLU RNN,
from a given hidden state in a rollout; linear heads for mixture logits,
means and log-scales of the continuous dims and 2-way logits for the gripper.
The outputs are fp32, as the JAX package pins them. Reference names: ``rnn``,
``prob_fc``, ``mean_fc``, ``log_scale_fc``, ``gripper_fc``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from hulc2_torch.models.layers import Dense, ReluRNN
from hulc2_torch.ops.gripper_frame import tcp_to_world_frame
from hulc2_torch.ops.logistic import logistic_mixture_sample


class DecoderOutput(NamedTuple):
    logit_probs: torch.Tensor  # (B, S, A-1, K)
    log_scales: torch.Tensor
    means: torch.Tensor
    gripper_logits: torch.Tensor  # (B, S, 2)
    hidden: torch.Tensor  # (L, B, H) RNN state


class LogisticPolicyDecoder(nn.Module):
    def __init__(self, in_features: int, out_features: int = 7, n_mixtures: int = 10,
                 hidden_size: int = 2048, num_layers: int = 2, rnn_model: str = "rnn_decoder",
                 policy_rnn_dropout_p: float = 0.0,
                 perceptual_emb_slice: Tuple[int, int] = (64, 128), log_scale_min: float = -7.0,
                 num_classes: int = 10, gripper_alpha: float = 1.0, gripper_control: bool = True,
                 discrete_gripper: bool = True,
                 act_max_bound: Sequence[float] = (1.0,) * 7,
                 act_min_bound: Sequence[float] = (-1.0,) * 7):
        super().__init__()
        if rnn_model != "rnn_decoder" or not discrete_gripper or policy_rnn_dropout_p:
            raise NotImplementedError(
                "only rnn_decoder with a discrete gripper and no RNN dropout is ported")
        self.perceptual_emb_slice = tuple(perceptual_emb_slice)
        self.log_scale_min = log_scale_min
        self.num_classes = num_classes
        self.gripper_alpha = gripper_alpha
        self.gripper_control = gripper_control
        self.mixture_dims = out_features - 1
        self.n_mixtures = n_mixtures
        self.act_max_bound = tuple(act_max_bound)
        self.act_min_bound = tuple(act_min_bound)
        self.rnn = ReluRNN(in_features, hidden_size, num_layers)
        a_k = self.mixture_dims * n_mixtures
        self.prob_fc = Dense(hidden_size, a_k)
        self.mean_fc = Dense(hidden_size, a_k)
        self.log_scale_fc = Dense(hidden_size, a_k)
        self.gripper_fc = Dense(hidden_size, 2)
        # the gripper's two action values; a buffer, so that sampling makes no
        # host-to-device copy (which would synchronise the stream)
        self.register_buffer("gripper_bounds", torch.tensor(
            [self.act_min_bound[-1], self.act_max_bound[-1]], dtype=torch.float32), persistent=False)

    def bounds(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(act_min, act_max) of the continuous dims as (A-1, 1), broadcasting over K."""
        lo = torch.tensor(self.act_min_bound[:-1], dtype=torch.float32, device=device)[:, None]
        hi = torch.tensor(self.act_max_bound[:-1], dtype=torch.float32, device=device)[:, None]
        return lo, hi

    def forward(self, latent_plan: torch.Tensor, perceptual_emb: torch.Tensor,
                latent_goal: torch.Tensor, h0: Optional[torch.Tensor] = None) -> DecoderOutput:
        lo, hi = self.perceptual_emb_slice
        emb = perceptual_emb[..., lo:hi]
        b, s, _ = emb.shape
        plan = latent_plan[:, None, :].expand(b, s, latent_plan.shape[-1])
        goal = latent_goal[:, None, :].expand(b, s, latent_goal.shape[-1])
        x = torch.cat([plan, emb, goal], dim=-1)
        if h0 is not None:
            h0 = h0.to(x.dtype)
        x, h_n = self.rnn(x, h0)
        shape = (b, s, self.mixture_dims, self.n_mixtures)
        log_scales = self.log_scale_fc(x).float().reshape(shape).clamp(min=self.log_scale_min)
        return DecoderOutput(
            self.prob_fc(x).float().reshape(shape),
            log_scales,
            self.mean_fc(x).float().reshape(shape),
            self.gripper_fc(x).float(),
            h_n,
        )

    def sample_actions(self, out: DecoderOutput, robot_obs: torch.Tensor,
                       u_sel: Optional[torch.Tensor] = None, u: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """World-frame actions (B, S, 7) clamped to [-1, 1] (``decoders.py:135``):
        mixture sample of the continuous dims (uniforms ``u_sel``, ``u`` or
        from ``generator``), the gripper at the bound its argmax logit names,
        TCP frame to world frame."""
        with torch.autocast(device_type=robot_obs.device.type, enabled=False):
            cont = logistic_mixture_sample(out.logit_probs, out.log_scales, out.means, u_sel, u,
                                           generator)
            grip = self.gripper_bounds[torch.argmax(out.gripper_logits, dim=-1)]
            act = torch.cat([cont, grip[..., None]], dim=-1)
            if self.gripper_control:
                act = tcp_to_world_frame(act, robot_obs)
            return act.clamp(-1.0, 1.0)
