"""The fused train step and the fused rollout steps (``hulc2_tpu/train/steps.py``).

Train step (``:24-88``): concatenate the raw uint8 vis and lang windows, run
the transform (one shift_normalize launch per RGB camera over all B*S
frames), the model forward under bf16 autocast, the loss with the CLIP and
aux betas, backward through autograd, and one Adam update. Returns the
metrics, ``loss`` and ``grad_norm`` included, as detached tensors on the
device.

Rollout steps (``:146``, ``:178``): one call per env step for a batch of envs,
under ``torch.inference_mode()``: [render the frames from the env states,]
the val transform (one shift_normalize launch at pad 0 per camera), the
policy step, then the gripper binarized to +-1. They return the device
action without waiting for it.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from hulc2_torch.models.hulc2 import Hulc2, PolicyCarry, PolicyDraws
from hulc2_torch.utils.device import resolve_device


def aux_betas_from_loss_cfg(loss_cfg: dict) -> Dict[str, float]:
    """Metric name -> beta, for the aux losses the ported model emits (the
    task CE; the JAX trainer's other aux betas have no metric here)."""
    return {"lang_task_loss": loss_cfg.get("lang_task_auxiliary_loss_beta", 1.0)}


def make_train_step(model: Hulc2, optimizer: torch.optim.Optimizer, transform: Callable,
                    clip_loss_beta: float = 3.0, aux_betas: Optional[Dict[str, float]] = None,
                    device=None) -> Callable:
    """fn(raw_batch, generator, kl_beta, offsets=None, gumbel=None) -> metrics.

    ``raw_batch`` is {"vis": window dict, "lang": window dict}; ``offsets``
    and ``gumbel`` replace the crop offsets and the plan sampler's draw (the
    parity tests hand in the same draws as the JAX side). Raises unless the
    model lives on ``device`` (CUDA unless ``device="cpu"`` is asked for).
    """
    device = resolve_device(device)
    param_device = next(model.parameters()).device
    if param_device.type != device.type:
        raise ValueError(f"model is on {param_device}, the step on {device}")
    use_autocast = device.type == "cuda" and getattr(model, "compute_dtype", None) == torch.bfloat16
    aux_betas = dict(aux_betas or {})

    def step(raw_batch: Dict[str, Dict[str, torch.Tensor]], generator: torch.Generator,
             kl_beta: float, offsets: Optional[Dict[str, torch.Tensor]] = None,
             gumbel: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        vis, lang = raw_batch["vis"], raw_batch["lang"]
        n_vis = vis["actions"].shape[0]
        # fuse BEFORE the transform: the uint8 concat moves a quarter of the bytes
        shared = [k for k in vis if k in lang]
        batch = transform({k: torch.cat([vis[k], lang[k]], dim=0) for k in shared},
                          generator, offsets)
        for k in ("lang", "use_for_aux_lang_loss", "lang_task_id"):
            if k in lang:
                batch[k] = lang[k]
        model.train()
        with torch.autocast(device_type=device.type, dtype=torch.bfloat16, enabled=use_autocast):
            metrics = model(batch, kl_beta, n_vis, deterministic=False, generator=generator,
                            gumbel=gumbel)
        loss = metrics["total_loss"]
        if "lang_clip_loss" in metrics:
            loss = loss + clip_loss_beta * metrics["lang_clip_loss"]
        for key, beta in aux_betas.items():
            if key in metrics:
                loss = loss + beta * metrics[key]
        metrics["loss"] = loss
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        metrics["grad_norm"] = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step


def _binarize_gripper(action: torch.Tensor) -> torch.Tensor:
    grip = torch.where(action[..., -1] > 0, 1.0, -1.0).to(action.dtype)
    return torch.cat([action[..., :-1], grip[..., None]], dim=-1)


def _autocast(model: Hulc2, device: torch.device):
    return torch.autocast(device_type=device.type, dtype=torch.bfloat16,
                          enabled=device.type == "cuda" and model.compute_dtype == torch.bfloat16)


def make_fused_policy_step(model: Hulc2, transform: Callable) -> Callable:
    """fn(raw, goal, carry, generator, draws=None) -> (action (B, 7), carry).

    ``raw`` holds (B, 1, H, W, 3) uint8 frames per camera and
    ``robot_obs_raw`` (B, 1, 15) on the model's device; ``goal`` is
    {"lang": token ids (B, 77)} or a visual goal (``Hulc2.policy_step``)."""
    device = next(model.parameters()).device

    def step(raw: Dict[str, torch.Tensor], goal: Dict, carry: PolicyCarry,
             generator: Optional[torch.Generator],
             draws: Optional[PolicyDraws] = None) -> Tuple[torch.Tensor, PolicyCarry]:
        with torch.inference_mode(), _autocast(model, device):
            tfd = transform(raw, generator)
            action, carry = model.policy_step(tfd["rgb_obs"], tfd["robot_obs_raw"], goal, carry,
                                              generator, draws)
            return _binarize_gripper(action), carry

    return step


def make_fused_render_policy_step(model: Hulc2, transform: Callable, render_fn: Callable,
                                  rgb_keys: Sequence[str]) -> Callable:
    """fn(state, goal, carry, generator, draws=None) -> (action (B, 7), carry),
    where ``state`` = {"robot_obs": (B, 15), "scene_obs": (B, 24)} float32 on
    the model's device: the frames are rendered on the device
    (``envs/render_torch.py``), then the step of ``make_fused_policy_step``."""
    device = next(model.parameters()).device
    policy_step = make_fused_policy_step(model, transform)

    def step(state: Dict[str, torch.Tensor], goal: Dict, carry: PolicyCarry,
             generator: Optional[torch.Generator],
             draws: Optional[PolicyDraws] = None) -> Tuple[torch.Tensor, PolicyCarry]:
        with torch.inference_mode():
            robot = state["robot_obs"].float()
            frames = render_fn(state["scene_obs"].float(), robot)
            raw = {k: frames[k][:, None] for k in rgb_keys}
            raw["robot_obs_raw"] = robot[:, None]
            raw["actions"] = torch.zeros((robot.shape[0], 1, 7), dtype=torch.float32,
                                         device=device)
            return policy_step(raw, goal, carry, generator, draws)

    return step
