"""The plain reference of a HULC++ policy train step: fp32, TF32 off, no
autocast, no kernel.

The model is the frozen copy of the port's modules (``reference/port``),
built from the run's config with the benchmark's weights; the transform is
the copy's, whose crop is the plain clamped gather. One step: the fused
batch through the train transform (its draws from the step's generator, in
the program's order), the forward with dropout, the loss with the CLIP and
aux betas, backward, the global gradient norm and, where the config asks,
its clipping, and Adam (betas 0.9, 0.999, eps 1e-8) at the config's
learning rate. ``quantize`` (the control, ``reference/lowp.fp8``) is a
context in which the forward and the backward run in a lower precision.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

from portbench.reference.port.data.device_transforms import make_batch_transform
from portbench.reference.port.data.statistics import load_statistics
from portbench.reference.port.models.build import build_policy_for

AUX_BETAS = {"proprio_loss": "state_recon_beta", "lang_pred_loss": "bc_z_auxiliary_loss_beta",
             "lang_contrastive_loss": "mia_auxiliary_loss_beta",
             "lang_task_loss": "lang_task_auxiliary_loss_beta"}
AUX_DEFAULTS = {"state_recon_beta": 0.5}


@contextlib.contextmanager
def fp32_exact():
    """Matrix products and convolutions in full fp32 (no TF32)."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


class ReferenceTrainStep:
    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor], data_root, device,
                 quantize: Optional[Callable] = None):
        cfg = {**cfg, "model": {**cfg["model"], "compute_dtype": "float32"}}
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = build_policy_for(cfg, seed=0).to(self.device)
        if weights is not None:
            missing = set(dict(self.model.named_parameters())) - set(weights)
            if missing:
                raise KeyError(f"no weights for {sorted(missing)}")
            self.model.load_state_dict(weights, strict=False)
        self.quantize = quantize
        opt = cfg["model"]["optimizer"]
        if opt.get("kind", "adam") != "adam":
            raise NotImplementedError(f"the reference steps Adam only, not {opt['kind']!r}")
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=opt["lr"],
                                          betas=(0.9, 0.999), eps=1e-8, foreach=False)
        self.clip_norm = opt.get("gradient_clip_norm")
        dm = cfg["datamodule"]
        self.transform = make_batch_transform(dm["observation_space"], dm["proprioception_dims"],
                                              dm["transforms"], dtype=torch.float32, train=True,
                                              stats=None if data_root is None
                                              else load_statistics(f"{data_root}/training"))
        loss = cfg["loss"]
        self.clip_beta = loss["clip_auxiliary_loss_beta"]
        self.aux = {m: loss.get(k, AUX_DEFAULTS.get(k, 1.0)) for m, k in AUX_BETAS.items()}

    def loss(self, raw: Dict[str, torch.Tensor], generator: torch.Generator,
             kl_beta: float, gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
        n_vis = raw["actions"].shape[0] - raw["lang"].shape[0]
        self.model.train()
        with self._precision():
            batch = self.transform(raw, generator)
            metrics = self.model(batch, kl_beta, n_vis, deterministic=False, generator=generator,
                                 gumbel=gumbel)
        loss = metrics["total_loss"]
        if "lang_clip_loss" in metrics:
            loss = loss + self.clip_beta * metrics["lang_clip_loss"]
        for key, beta in self.aux.items():
            if key in metrics:
                loss = loss + beta * metrics[key]
        self.metrics = {k: v.detach() for k, v in metrics.items()}
        return loss

    @contextlib.contextmanager
    def _precision(self):
        with fp32_exact(), (self.quantize() if self.quantize else contextlib.nullcontext()):
            yield

    def step(self, raw: Dict[str, torch.Tensor], generator: torch.Generator,
             kl_beta: float, gumbel: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One update; returns the loss, each leaf's gradient (before
        clipping) and the metrics, detached. ``gumbel`` is the plan's draw."""
        loss = self.loss(raw, generator, kl_beta, gumbel)
        self.optimizer.zero_grad(set_to_none=True)
        with self._precision():
            loss.backward()
        grads = {n: p.grad.detach().clone() for n, p in self.model.named_parameters()
                 if p.grad is not None}
        if self.clip_norm:
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                         for g in grads.values()]))
            scale = torch.clamp(self.clip_norm / norm, max=1.0)
            for p in self.model.parameters():
                if p.grad is not None:
                    p.grad.mul_(scale)
        with fp32_exact():
            self.optimizer.step()
        return {"loss": loss.detach(), "grads": grads, "metrics": self.metrics}

    def params(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach() for n, p in self.model.named_parameters()}
