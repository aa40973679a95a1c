"""Optimizers, learning-rate schedules and gradient clipping (``hulc2_tpu/train/optim.py``).

The update rules of the JAX package's optax transforms, in torch:

- ``adam``: ``torch.optim.Adam`` with betas (0.9, 0.999) and eps 1e-8, as
  ``optax.adam``;
- ``adamw``: ``torch.optim.AdamW``, the decoupled decay of ``optax.adamw``
  (``p -= lr * (adam_update + weight_decay * p)``);
- ``sgd``: ``torch.optim.SGD`` with momentum and dampening 0, which is
  ``optax.sgd``'s trace (``t = g + momentum * t``, ``p -= lr * t``);
- ``gradient_clip_norm``: ``optax.clip_by_global_norm``, the gradients
  scaled by ``clip / norm`` when the global norm exceeds ``clip``
  (``clip_gradients_``; torch's ``clip_grad_norm_`` scales by
  ``clip / (norm + 1e-6)``).

Schedules (``make_schedule``) are functions of the update count: optax
evaluates the schedule at the count before the update, so update k uses
``schedule(k)`` and the first warm-up update uses lr 0. ``make_scheduler``
wraps one in a ``LambdaLR`` stepped after each update; its state goes into
the checkpoint, so a resumed run continues the schedule at its step.

On the card, Adam and AdamW are built ``fused`` (one multi-tensor update
launch) and ``capturable`` with the learning rate in a device scalar, which
the ``LambdaLR`` fills in place: the train step replays its update inside a
CUDA graph (``train/steps.py``), which reads the step count and the learning
rate from the device instead of baking them in at capture. A loaded state
dict's groups take those settings again, from a checkpoint of an eager-only
optimizer too.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Tuple

import torch


def compute_warmup(num_training_steps: int, num_warmup_steps, estimated_total: int) -> Tuple[int, int]:
    """Resolve -1 training steps and a fractional warm-up like the reference
    (``optim.py:14``)."""
    if num_training_steps < 0:
        num_training_steps = estimated_total
    if isinstance(num_warmup_steps, float) and num_warmup_steps <= 1.0:
        num_warmup_steps = num_warmup_steps * num_training_steps
    return int(num_training_steps), int(num_warmup_steps)


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """``optax.linear_schedule``: held at ``init`` when ``steps`` <= 0."""
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps) / steps) + end


def make_schedule(sched_cfg: Optional[dict], base_lr: float,
                  estimated_total: int = 100_000) -> Callable[[int], float]:
    """update count -> learning rate (``optim.py:25``): ``constant``,
    ``linear_warmup`` (0 to ``base_lr`` over the warm-up, then constant) or
    ``cosine`` (the same warm-up, then a cosine decay to 0 at the total)."""
    kind = (sched_cfg or {}).get("kind", "constant")
    if kind == "constant":
        return lambda count: base_lr
    if kind == "linear_warmup":
        _, warm = compute_warmup(sched_cfg.get("num_training_steps", -1),
                                 sched_cfg.get("num_warmup_steps", 0.1), estimated_total)
        return _linear(0.0, base_lr, warm)
    if kind == "cosine":
        total, warm = compute_warmup(sched_cfg.get("num_training_steps", -1),
                                     sched_cfg.get("num_warmup_steps", 0.0), estimated_total)
        decay = total - warm
        if decay <= 0:
            raise ValueError(f"the cosine schedule needs more training steps ({total}) than "
                             f"warm-up steps ({warm})")
        warmup = _linear(0.0, base_lr, warm)

        def cosine(count: int) -> float:
            if count < warm:
                return warmup(count)
            t = min(count - warm, decay)
            return base_lr * 0.5 * (1 + math.cos(math.pi * t / decay))

        return cosine
    raise ValueError(f"unknown lr_scheduler kind {kind!r}")


def schedule_value(opt_cfg: dict, sched_cfg: Optional[dict], step: int,
                   estimated_total: int = 100_000) -> float:
    """The learning rate at ``step`` (the reference's LearningRateMonitor)."""
    return float(make_schedule(sched_cfg, opt_cfg.get("lr", 2e-4), estimated_total)(step))


def make_optimizer(params, opt_cfg: dict) -> torch.optim.Optimizer:
    """The optimizer of ``model.optimizer`` at its base learning rate; the
    schedule is ``make_scheduler``'s. Adam and AdamW of parameters on the card
    are ``fused`` and ``capturable``, their learning rate a device scalar."""
    kind, lr = opt_cfg.get("kind", "adam"), opt_cfg.get("lr", 2e-4)
    if kind in ("adam", "adamw"):
        params = list(params)
        first = params[0]["params"][0] if isinstance(params[0], dict) else params[0]
        card = first.device if first.device.type == "cuda" else None
        opt_kw = {"lr": lr if card is None else torch.tensor(float(lr), device=card),
                  "betas": (0.9, 0.999), "eps": 1e-8}
        if card is not None:
            opt_kw.update(fused=True, capturable=True)
        if kind == "adam":
            optimizer = torch.optim.Adam(params, **opt_kw)
        else:
            optimizer = torch.optim.AdamW(params, weight_decay=opt_cfg.get("weight_decay", 1e-6),
                                          **opt_kw)
        if card is not None:
            # the fused update is the same launch whether it is captured or
            # not, so the warning that capturable=True slows an eager step
            # does not apply
            optimizer._warned_capturable_if_run_uncaptured = True
            optimizer.register_load_state_dict_pre_hook(
                lambda opt, state: _as_built(state, card))
        return optimizer
    if kind == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=opt_cfg.get("momentum", 0.9), dampening=0.0)
    raise ValueError(f"unknown optimizer kind {kind!r}")


def _as_built(state: dict, card: torch.device) -> dict:
    """A state dict to load into ``make_optimizer``'s Adam or AdamW on
    ``card``: each group fused and capturable, as built, and its learning
    rate a float32 scalar on the card (a state dict holds a float, or a
    tensor loaded to the host)."""
    groups = [{**g, "fused": True, "capturable": True,
               "lr": torch.tensor(float(g["lr"]), device=card)} for g in state["param_groups"]]
    return {**state, "param_groups": groups}


def make_scheduler(optimizer: torch.optim.Optimizer, opt_cfg: dict, sched_cfg: Optional[dict],
                   estimated_total: int = 100_000) -> torch.optim.lr_scheduler.LambdaLR:
    """A ``LambdaLR`` that sets update k's learning rate to ``schedule(k)``;
    step it once after each ``optimizer.step()``. A learning rate in a
    device scalar is filled in place, from the float base rate."""
    base_lr = opt_cfg.get("lr", 2e-4)
    schedule = make_schedule(sched_cfg, base_lr, estimated_total)
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group.setdefault("initial_lr", float(base_lr))
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda count: schedule(count) / base_lr if base_lr else 0.0)


def clip_gradients_(grads: Iterable[torch.Tensor], norm: torch.Tensor, max_norm: float) -> None:
    """``optax.clip_by_global_norm``: scale ``grads`` in place by
    ``max_norm / norm`` when their global ``norm`` is not below ``max_norm``,
    without a host sync."""
    grads = list(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale.to(grads[0].dtype))
