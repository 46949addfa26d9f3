"""Optimizer and learning-rate schedules (counterpart of
``mtd_gan_tpu/optim.py``; reference optimizers.py:4-14, schedulers.py:8-74).

AdamW with betas (0.9, 0.999), eps 1e-8 and decoupled weight decay 5e-4 is
``torch.optim.AdamW`` itself (``tests/test_optim_parity.py`` pins the JAX
trajectory against it). The schedule is stepped once per epoch.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch


def get_optimizer(name: str, params: Iterable, lr: float = 1e-4,
                  weight_decay: float = 5e-4) -> torch.optim.Optimizer:
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    if name == "adam":  # torch Adam folds the decay into the gradient
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    raise KeyError(f"unknown optimizer {name!r}")


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def poly_lr_factor(epoch: int, warmup_epochs: int, start_decay_epoch: float,
                   total_epochs: int, min_lr: float) -> float:
    """Linear warmup, then poly decay from ``start_decay_epoch``; the factor
    (not the lr) is floored at ``min_lr``, a reference quirk."""
    if epoch < warmup_epochs:
        return max(0.0, epoch / warmup_epochs)
    factor = 1.0 - max(0.0, epoch - start_decay_epoch) / (
        float(total_epochs) - start_decay_epoch)
    return min_lr if factor <= min_lr else factor


class CosineWarmRestarts:
    """Warm-restart cosine with a per-cycle decay of its peak (reference
    schedulers.py:21-74): within each cycle of length ``t_0 * t_mult**n``
    the lr ramps linearly from ``base_lr`` to the cycle's peak over ``t_up``
    epochs, then cosine-decays back to ``base_lr``; the peak starts at
    ``eta_max`` and shrinks by ``gamma`` each cycle. Gives absolute lrs."""

    def __init__(self, base_lr: float, t_0: int = 100, t_mult: int = 1,
                 eta_max: float = 1e-3, t_up: int = 10, gamma: float = 0.6):
        if t_0 <= 0 or t_mult < 1 or t_up < 0:
            raise ValueError("invalid cosine warm-restart config")
        self.base_lr, self.t_0, self.t_mult = base_lr, t_0, t_mult
        self.eta_max0, self.t_up, self.gamma = eta_max, t_up, gamma

    def __call__(self, epoch: int) -> float:
        if epoch < 0:
            return self.base_lr
        if self.t_mult == 1:
            cycle, t_cur = divmod(epoch, self.t_0)
            t_i = self.t_0
        elif epoch >= self.t_0:
            cycle = int(math.log(epoch / self.t_0 * (self.t_mult - 1) + 1, self.t_mult))
            t_cur = epoch - self.t_0 * (self.t_mult ** cycle - 1) / (self.t_mult - 1)
            t_i = self.t_0 * self.t_mult ** cycle
        else:
            cycle, t_cur, t_i = 0, epoch, self.t_0
        eta_max = self.eta_max0 * self.gamma ** cycle
        if t_cur < self.t_up:
            return (eta_max - self.base_lr) * t_cur / self.t_up + self.base_lr
        return self.base_lr + (eta_max - self.base_lr) * (
            1 + math.cos(math.pi * (t_cur - self.t_up) / (t_i - self.t_up))) / 2


def get_scheduler(name: str, base_lr: float, epochs: int, warmup_epochs: int = 10,
                  min_lr: float = 1e-5) -> Callable[[int], float]:
    """epoch -> absolute lr."""
    if name == "poly_lr":
        return lambda epoch: base_lr * poly_lr_factor(
            epoch, warmup_epochs, epochs / 10, epochs, min_lr)
    if name == "cosine_annealing_warm_restart":
        return CosineWarmRestarts(base_lr)
    raise KeyError(f"unknown scheduler {name!r}")
