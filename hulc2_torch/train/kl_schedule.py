"""KL-beta annealing schedules.

(reference: hulc2/utils/kl_callbacks.py:9-63 — Constant / Linear / Sigmoid
schedules over epochs, conf/callbacks/kl_schedule/*.yaml). Pure functions of
the epoch; the trainer hands the value to each step of the epoch.

The port's copy of ``hulc2_tpu/train/kl_schedule.py``.
"""
from __future__ import annotations

import math


class KLSchedule:
    def __init__(self, kl_beta: float, **kwargs):
        self.kl_beta = kl_beta

    def __call__(self, epoch: int) -> float:
        raise NotImplementedError


class KLConstantSchedule(KLSchedule):
    def __call__(self, epoch: int) -> float:
        return self.kl_beta


class KLLinearSchedule(KLSchedule):
    def __init__(self, kl_beta: float, start_epoch: int = 10, end_epoch: int = 50, max_kl_beta: float = None, **kw):
        super().__init__(kl_beta)
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.max_kl_beta = max_kl_beta if max_kl_beta is not None else kl_beta

    def __call__(self, epoch: int) -> float:
        if epoch < self.start_epoch:
            return 0.0
        if epoch >= self.end_epoch:
            return self.max_kl_beta
        frac = (epoch - self.start_epoch) / max(self.end_epoch - self.start_epoch, 1)
        return self.max_kl_beta * frac


class KLSigmoidSchedule(KLLinearSchedule):
    def __call__(self, epoch: int) -> float:
        if epoch < self.start_epoch:
            return 0.0
        if epoch >= self.end_epoch:
            return self.max_kl_beta
        mid = (self.start_epoch + self.end_epoch) / 2
        scale = 10.0 / max(self.end_epoch - self.start_epoch, 1)
        return self.max_kl_beta / (1.0 + math.exp(-scale * (epoch - mid)))


def make_kl_schedule(cfg: dict) -> KLSchedule:
    kind = cfg.get("kind", "constant")
    cls = {"constant": KLConstantSchedule, "linear": KLLinearSchedule, "sigmoid": KLSigmoidSchedule}[kind]
    return cls(**{k: v for k, v in cfg.items() if k != "kind"})
