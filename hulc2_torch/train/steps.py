"""The fused train step and the fused rollout steps (``hulc2_tpu/train/steps.py``).

Train step (``:24-88``): concatenate the raw uint8 vis and lang windows (a
single-modality batch is transformed alone), run the transform (one
shift_normalize launch per RGB camera over all B*S frames), the model
forward under bf16 autocast, the loss with the CLIP and
aux betas, backward through autograd, the gradients clipped by their global
norm where the config asks for it, and one optimizer update at the
schedule's learning rate. Returns the metrics, ``loss`` and ``grad_norm``
(before clipping, as in JAX) included, as detached tensors on the device.

Rollout steps (``:146``, ``:178``): one call per env step for a batch of envs,
under ``torch.inference_mode()``: [render the frames (and depth_static) from
the env states,] the val transform (one shift_normalize launch at pad 0 per
RGB camera), the policy step on the rgb and depth frames and the processed
robot_obs, then the gripper binarized to +-1. They return the device
action without waiting for it.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from hulc2_torch.data.device_transforms import LANG_KEYS
from hulc2_torch.models.hulc2 import Hulc2, PolicyCarry, PolicyDraws
from hulc2_torch.parallel import batch_shard
from hulc2_torch.parallel.batch_shard import BatchShard
from hulc2_torch.parallel.mesh import unwrap
from hulc2_torch.train.optim import clip_gradients_
from hulc2_torch.utils.device import resolve_device


def aux_betas_from_loss_cfg(loss_cfg: dict) -> Dict[str, float]:
    """Metric name -> beta of the aux losses (``hulc2_tpu/train/trainer.py:130-134``);
    a metric the model does not emit adds nothing."""
    return {
        "proprio_loss": loss_cfg.get("state_recon_beta", 0.5),
        "lang_pred_loss": loss_cfg.get("bc_z_auxiliary_loss_beta", 1.0),
        "lang_contrastive_loss": loss_cfg.get("mia_auxiliary_loss_beta", 1.0),
        "lang_task_loss": loss_cfg.get("lang_task_auxiliary_loss_beta", 1.0),
    }


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, transform: Callable,
                    clip_loss_beta: float = 3.0, aux_betas: Optional[Dict[str, float]] = None,
                    device=None, scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
                    gradient_clip_norm: Optional[float] = None) -> Callable:
    """fn(raw_batch, generator, kl_beta, gumbel=None, draws=None) -> metrics.

    ``raw_batch`` is {"vis": window dict, "lang": window dict}, or one batch
    with [vis; lang] rows already fused, as the device-store loader yields it
    (``hulc2_tpu/train/steps.py:41-47``: n_vis is its action rows less its
    lang rows), or a single modality's {"vis": ...} or {"lang": ...}.
    ``draws`` and ``gumbel`` replace the transform's draws (the crop
    offsets among them, ``data/device_transforms``) and the plan sampler's
    draw (the parity tests hand in the same draws as the JAX side). Raises unless the model lives on ``device`` (CUDA unless
    ``device="cpu"`` is asked for).

    ``model`` may be the policy wrapped for data parallelism
    (``parallel/mesh.wrap_model``): each rank then steps on its own rows, its
    draws and its batch-coupled losses taken over the global batch of all
    ranks' rows (``parallel/batch_shard.py``), the gradients averaged over
    the ranks before their norm and clipping, and the returned metrics are
    the ranks' mean: those of one process's step on the global batch.
    """
    device = resolve_device(device)
    core = unwrap(model)
    param_device = next(core.parameters()).device
    if param_device.type != device.type:
        raise ValueError(f"model is on {param_device}, the step on {device}")
    use_autocast = device.type == "cuda" and getattr(core, "compute_dtype", None) == torch.bfloat16
    aux_betas = dict(aux_betas or {})
    params = list(model.parameters())
    # optax decays every parameter, those without a gradient in this graph
    # (GCBC's plan heads) too; torch skips a parameter whose .grad is None
    zero_fill = any(g.get("weight_decay", 0.0) for g in optimizer.param_groups)
    world = dist.get_world_size() if model is not core or _sharded(model) else 1
    rank = dist.get_rank() if world > 1 else 0

    def step(raw_batch: Dict, generator: torch.Generator,
             kl_beta: float, gumbel: Optional[torch.Tensor] = None,
             draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        if "actions" in raw_batch:  # fused on the host or by the store's gather
            fused = raw_batch
            n_vis = fused["actions"].shape[0] - fused["lang"].shape[0]
        elif len(raw_batch) == 1:  # one modality (vision_only, lang_only)
            fused = raw_batch.get("vis", raw_batch.get("lang"))
            n_vis = fused["actions"].shape[0] if "vis" in raw_batch else 0
        else:
            vis, lang = raw_batch["vis"], raw_batch["lang"]
            n_vis = vis["actions"].shape[0]
            # fuse BEFORE the transform: the uint8 concat moves a quarter of the bytes
            fused = {k: torch.cat([vis[k], lang[k]], dim=0) for k in vis if k in lang}
            fused.update({k: lang[k] for k in LANG_KEYS if k in lang})
        shard = (BatchShard(rank, world, n_vis, fused["actions"].shape[0] - n_vis)
                 if world > 1 else None)
        model.train()
        with batch_shard.active(shard):
            batch = transform(fused, generator, draws)
            with torch.autocast(device_type=device.type, dtype=torch.bfloat16,
                                enabled=use_autocast):
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
        if zero_fill:
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params if p.grad is not None]
        metrics["grad_norm"] = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(_full(g).float()) for g in grads]))
        if gradient_clip_norm:
            clip_gradients_([_local(g) for g in grads], metrics["grad_norm"], gradient_clip_norm)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        metrics = {k: v.detach() for k, v in metrics.items()}
        return mean_over_ranks(metrics) if world > 1 else metrics

    return step


def _sharded(model: nn.Module) -> bool:
    """Whether FSDP2 shards the model's parameters."""
    return any(hasattr(p, "full_tensor") for p in model.parameters())


def _full(g: torch.Tensor) -> torch.Tensor:
    return g.full_tensor() if hasattr(g, "full_tensor") else g


def _local(g: torch.Tensor) -> torch.Tensor:
    return g.to_local() if hasattr(g, "to_local") else g


def mean_over_ranks(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each metric's mean over the process group's ranks, in one all-reduce."""
    names = sorted(metrics)
    values = torch.stack([metrics[k].float() for k in names])
    dist.all_reduce(values)
    values /= dist.get_world_size()
    return dict(zip(names, values.unbind()))


def make_val_step(model: Hulc2, transform: Callable) -> Callable:
    """fn(raw_batch, generator, kl_beta=0.01, draws=None) -> metrics
    (``hulc2_tpu/train/steps.py:91-99``): each modality of a {"vis": ...,
    "lang": ...} batch goes through the val ``transform`` on its own (the
    shift_normalize kernel at pad 0, one launch per camera), then
    ``Hulc2.val_forward`` without gradients. The JAX step leaves kl_beta at
    ``val_forward``'s default of 0.01, and so does the trainer here."""
    device = next(model.parameters()).device

    def step(raw_batch: Dict[str, Dict[str, torch.Tensor]], generator: Optional[torch.Generator],
             kl_beta: float = 0.01, draws: Optional[Dict[str, PolicyDraws]] = None
             ) -> Dict[str, torch.Tensor]:
        model.eval()
        with torch.no_grad(), _autocast(model, device):
            batch = {m: transform(raw_batch[m], None) for m in raw_batch}
            metrics = model.val_forward(batch, kl_beta, generator, draws)
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_plan_sampler(model: Hulc2, transform: Callable) -> Callable:
    """fn(raw_batch, generator, noise=None) -> (plans (B_total, P), modality
    ids (B_total,)) for the plan-space t-SNE (``hulc2_tpu/train/steps.py:102-127``):
    each modality of a {"vis": ..., "lang": ...} batch, in sorted order (lang
    0, vis 1), through the val ``transform``, the perceptual encoder and the
    posterior without dropout, and a plan sampled from it. ``noise`` maps a
    modality to its plan's draw (Gumbel noise or a standard normal, as
    ``Hulc2.forward``'s ``gumbel``); without it the draw comes from
    ``generator``."""
    device = next(model.parameters()).device

    def sample(raw_batch: Dict[str, Dict[str, torch.Tensor]],
               generator: Optional[torch.Generator],
               noise: Optional[Dict[str, torch.Tensor]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        model.eval()
        plans, labels = [], []
        with torch.no_grad(), _autocast(model, device):
            for i, mod in enumerate(sorted(raw_batch)):
                emb = model.encode(transform(raw_batch[mod], None))
                pr_state, _ = model.plan_recognition(emb)
                plan = model._plan(pr_state.float(), (noise or {}).get(mod), generator,
                                   rsample=False)
                plans.append(plan.float())
                labels.append(torch.full((plan.shape[0],), i, dtype=torch.int32,
                                         device=plan.device))
        return torch.cat(plans), torch.cat(labels)

    return sample


def _binarize_gripper(action: torch.Tensor) -> torch.Tensor:
    grip = torch.where(action[..., -1] > 0, 1.0, -1.0).to(action.dtype)
    return torch.cat([action[..., :-1], grip[..., None]], dim=-1)


def _autocast(model: Hulc2, device: torch.device):
    return torch.autocast(device_type=device.type, dtype=torch.bfloat16,
                          enabled=device.type == "cuda" and model.compute_dtype == torch.bfloat16)


def make_fused_policy_step(model: Hulc2, transform: Callable) -> Callable:
    """fn(raw, goal, carry, generator, draws=None) -> (action (B, 7), carry).

    ``raw`` holds (B, 1, H, W, 3) uint8 frames per camera, (B, 1, H, W)
    depth maps per depth camera, ``robot_obs_raw`` (B, 1, 15) and, when the
    observation space names it, ``scene_obs`` (B, 1, 24) on the model's
    device; ``goal`` is {"lang": token ids (B, 77)} or a visual goal
    (``Hulc2.policy_step``)."""
    device = next(model.parameters()).device

    def step(raw: Dict[str, torch.Tensor], goal: Dict, carry: PolicyCarry,
             generator: Optional[torch.Generator],
             draws: Optional[PolicyDraws] = None) -> Tuple[torch.Tensor, PolicyCarry]:
        with torch.inference_mode(), _autocast(model, device):
            tfd = transform(raw, generator)
            action, carry = model.policy_step(tfd["rgb_obs"], tfd["robot_obs_raw"], goal, carry,
                                              generator, draws, depth_obs=tfd["depth_obs"],
                                              robot_obs=tfd["robot_obs"])
            return _binarize_gripper(action), carry

    return step


def make_fused_render_policy_step(model: Hulc2, transform: Callable, render_fn: Callable,
                                  rgb_keys: Sequence[str], depth_keys: Sequence[str] = ()) -> Callable:
    """fn(state, goal, carry, generator, draws=None) -> (action (B, 7), carry),
    where ``state`` = {"robot_obs": (B, 15), "scene_obs": (B, 24)} float32 on
    the model's device: the frames of ``rgb_keys`` and the depth maps of
    ``depth_keys`` are rendered on the device (``envs/render_torch.py``;
    ``hulc2_tpu/train/steps.py:198-199``), then the step of
    ``make_fused_policy_step``. The state's scene_obs goes to the transform
    too, which reads it when the observation space names it; JAX's render
    step drops it (``:196-201``)."""
    device = next(model.parameters()).device
    policy_step = make_fused_policy_step(model, transform)

    def step(state: Dict[str, torch.Tensor], goal: Dict, carry: PolicyCarry,
             generator: Optional[torch.Generator],
             draws: Optional[PolicyDraws] = None) -> Tuple[torch.Tensor, PolicyCarry]:
        with torch.inference_mode():
            robot = state["robot_obs"].float()
            frames = render_fn(state["scene_obs"].float(), robot)
            raw = {k: frames[k][:, None] for k in list(rgb_keys) + list(depth_keys)}
            raw["robot_obs_raw"] = robot[:, None]
            raw["scene_obs"] = state["scene_obs"].float()[:, None]
            raw["actions"] = torch.zeros((robot.shape[0], 1, 7), dtype=torch.float32,
                                         device=device)
            return policy_step(raw, goal, carry, generator, draws)

    return step
