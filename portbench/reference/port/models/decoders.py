"""Action decoders and the logistic mixture's sampler (``models/decoders.py``).

Input per step: plan ++ perceptual_emb[slice] ++ goal (a GCBC plan is
(B, 0)); the ``rnn_model`` over it: a stacked ReLU RNN (``rnn_decoder``), GRU
or LSTM from a given state in a rollout, or a 3-layer MLP whose "state" is
zeros (``mlp_decoder``). The state is an (L, B, H) tensor, or an (h, c) pair
of them for the LSTM. The logistic decoder's linear heads give mixture
logits, means and log-scales of the continuous dims and, with a discrete
gripper, 2-way gripper logits; without one the mixture covers all A dims.
The outputs are fp32, as the JAX package pins them. Reference names: ``rnn``,
``prob_fc``, ``mean_fc``, ``log_scale_fc``, ``gripper_fc``; ``actions`` for
the deterministic decoder. ``policy_rnn_dropout_p`` is accepted and not
read, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.port.models.layers import GRU, LSTM, MLP, Dense, ReluRNN
from portbench.reference.port.ops.gripper_frame import tcp_to_world_frame, world_to_tcp_frame
from portbench.reference.port.ops.logistic import logistic_mixture_sample

Hidden = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]
RNN_MODELS = ("rnn_decoder", "gru_decoder", "lstm_decoder", "mlp_decoder")


class DecoderOutput(NamedTuple):
    logit_probs: torch.Tensor  # (B, S, M, K), M = A-1 with a discrete gripper, else A
    log_scales: torch.Tensor
    means: torch.Tensor
    gripper_logits: Optional[torch.Tensor]  # (B, S, 2) with a discrete gripper
    hidden: Hidden  # the rnn's state: (L, B, H), or (h, c) for the LSTM


class _RecurrentTrunk(nn.Module):
    """plan ++ emb[slice] ++ goal -> the ``rnn_model``'s outputs and state."""

    def __init__(self, in_features: int, hidden_size: int, num_layers: int, rnn_model: str,
                 perceptual_emb_slice: Tuple[int, int]):
        super().__init__()
        if rnn_model not in RNN_MODELS:
            raise ValueError(f"unknown rnn_model {rnn_model!r}; known: {RNN_MODELS}")
        self.rnn_model = rnn_model
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.perceptual_emb_slice = tuple(perceptual_emb_slice)
        if rnn_model == "mlp_decoder":
            self.rnn = MLP(in_features, [hidden_size] * 3)
        else:
            cls = {"rnn_decoder": ReluRNN, "gru_decoder": GRU, "lstm_decoder": LSTM}[rnn_model]
            self.rnn = cls(in_features, hidden_size, num_layers)

    def zero_hidden(self, batch: int, dtype=torch.float32, device=None) -> Hidden:
        """A zero state for ``batch`` rollouts (``hulc2.py:342-356``)."""
        z = lambda: torch.zeros((self.num_layers, batch, self.hidden_size), dtype=dtype,
                                device=device)
        return (z(), z()) if self.rnn_model == "lstm_decoder" else z()

    def trunk(self, latent_plan: torch.Tensor, perceptual_emb: torch.Tensor,
              latent_goal: torch.Tensor, h0: Optional[Hidden]) -> Tuple[torch.Tensor, Hidden]:
        lo, hi = self.perceptual_emb_slice
        emb = perceptual_emb[..., lo:hi]
        b, s, _ = emb.shape
        plan = latent_plan[:, None, :].expand(b, s, latent_plan.shape[-1])
        goal = latent_goal[:, None, :].expand(b, s, latent_goal.shape[-1])
        x = torch.cat([plan, emb, goal], dim=-1)
        if self.rnn_model == "mlp_decoder":
            return self.rnn(x), self.zero_hidden(b, x.dtype, x.device)
        if h0 is not None:
            h0 = tuple(h.to(x.dtype) for h in h0) if isinstance(h0, tuple) else h0.to(x.dtype)
        return self.rnn(x, h0)


class LogisticPolicyDecoder(_RecurrentTrunk):
    def __init__(self, in_features: int, out_features: int = 7, n_mixtures: int = 10,
                 hidden_size: int = 2048, num_layers: int = 2, rnn_model: str = "rnn_decoder",
                 policy_rnn_dropout_p: float = 0.0,
                 perceptual_emb_slice: Tuple[int, int] = (64, 128), log_scale_min: float = -7.0,
                 num_classes: int = 10, gripper_alpha: float = 1.0, gripper_control: bool = True,
                 discrete_gripper: bool = True,
                 act_max_bound: Sequence[float] = (1.0,) * 7,
                 act_min_bound: Sequence[float] = (-1.0,) * 7):
        super().__init__(in_features, hidden_size, num_layers, rnn_model, perceptual_emb_slice)
        self.discrete_gripper = discrete_gripper
        self.log_scale_min = log_scale_min
        self.num_classes = num_classes
        self.gripper_alpha = gripper_alpha
        self.gripper_control = gripper_control
        self.mixture_dims = out_features - 1 if discrete_gripper else out_features
        self.n_mixtures = n_mixtures
        self.act_max_bound = tuple(act_max_bound)
        self.act_min_bound = tuple(act_min_bound)
        a_k = self.mixture_dims * n_mixtures
        self.prob_fc = Dense(hidden_size, a_k)
        self.mean_fc = Dense(hidden_size, a_k)
        self.log_scale_fc = Dense(hidden_size, a_k)
        self.gripper_fc = Dense(hidden_size, 2) if discrete_gripper else None
        m = self.mixture_dims
        # the gripper's two action values and the continuous dims' bounds are
        # buffers, so that neither sampling nor the loss makes a host-to-device
        # copy (a copy from pageable memory synchronises the stream)
        self.register_buffer("gripper_bounds", torch.tensor(
            [self.act_min_bound[-1], self.act_max_bound[-1]], dtype=torch.float32), persistent=False)
        self.register_buffer("act_min", torch.tensor(
            self.act_min_bound[:m], dtype=torch.float32)[:, None], persistent=False)
        self.register_buffer("act_max", torch.tensor(
            self.act_max_bound[:m], dtype=torch.float32)[:, None], persistent=False)

    def bounds(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(act_min, act_max) of the mixture's dims as (M, 1), broadcasting
        over K, on the module's device."""
        return self.act_min, self.act_max

    def forward(self, latent_plan: torch.Tensor, perceptual_emb: torch.Tensor,
                latent_goal: torch.Tensor, h0: Optional[Hidden] = None) -> DecoderOutput:
        x, h_n = self.trunk(latent_plan, perceptual_emb, latent_goal, h0)
        b, s = x.shape[:2]
        shape = (b, s, self.mixture_dims, self.n_mixtures)
        log_scales = self.log_scale_fc(x).float().reshape(shape).clamp(min=self.log_scale_min)
        return DecoderOutput(
            self.prob_fc(x).float().reshape(shape),
            log_scales,
            self.mean_fc(x).float().reshape(shape),
            None if self.gripper_fc is None else self.gripper_fc(x).float(),
            h_n,
        )

    def sample_actions(self, out: DecoderOutput, robot_obs: torch.Tensor,
                       u_sel: Optional[torch.Tensor] = None, u: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """World-frame actions (B, S, 7) clamped to [-1, 1] (``decoders.py:135``):
        mixture sample of the mixture's dims (uniforms ``u_sel``, ``u`` or
        from ``generator``), with a discrete gripper the gripper at the bound
        its argmax logit names, TCP frame to world frame."""
        with torch.autocast(device_type=robot_obs.device.type, enabled=False):
            act = logistic_mixture_sample(out.logit_probs, out.log_scales, out.means, u_sel, u,
                                          generator)
            if self.discrete_gripper:
                grip = self.gripper_bounds[torch.argmax(out.gripper_logits, dim=-1)]
                act = torch.cat([act, grip[..., None]], dim=-1)
            if self.gripper_control:
                act = tcp_to_world_frame(act, robot_obs)
            return act.clamp(-1.0, 1.0)


class DeterministicDecoder(_RecurrentTrunk):
    """The rnn_model, then tanh of one linear head -> actions (B, S, A) in
    fp32, with a Huber (delta 1) or MSE loss (``decoders.py:159-198``). The
    JAX ``Hulc2`` can neither train nor roll out with it (its action loss
    reads the logistic decoder's bounds, its rollout samples a mixture), so
    the port's ``Hulc2`` refuses it by name there."""

    def __init__(self, in_features: int, out_features: int = 7, hidden_size: int = 2048,
                 num_layers: int = 2, rnn_model: str = "rnn_decoder",
                 policy_rnn_dropout_p: float = 0.0,
                 perceptual_emb_slice: Tuple[int, int] = (64, 128), criterion: str = "HuberLoss",
                 gripper_control: bool = False):
        super().__init__(in_features, hidden_size, num_layers, rnn_model, perceptual_emb_slice)
        if criterion not in ("HuberLoss", "MSELoss"):
            raise ValueError(f"unknown criterion {criterion!r}")
        self.criterion = criterion
        self.gripper_control = gripper_control
        self.actions = Dense(hidden_size, out_features)

    def forward(self, latent_plan: torch.Tensor, perceptual_emb: torch.Tensor,
                latent_goal: torch.Tensor, h0: Optional[Hidden] = None):
        x, h_n = self.trunk(latent_plan, perceptual_emb, latent_goal, h0)
        return torch.tanh(self.actions(x)).float(), h_n

    def compute_loss(self, pred_actions: torch.Tensor, actions: torch.Tensor,
                     robot_obs: torch.Tensor) -> torch.Tensor:
        target = world_to_tcp_frame(actions, robot_obs) if self.gripper_control else actions
        if self.criterion == "MSELoss":
            return F.mse_loss(pred_actions, target)
        return F.huber_loss(pred_actions, target, delta=1.0)
