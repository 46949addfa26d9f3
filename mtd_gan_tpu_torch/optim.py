"""Optimizer and learning-rate schedule (counterpart of
``mtd_gan_tpu/optim.py``; reference optimizers.py:4-14, schedulers.py:8-18).

AdamW with betas (0.9, 0.999), eps 1e-8 and decoupled weight decay 5e-4 is
``torch.optim.AdamW`` itself (``tests/test_optim_parity.py`` pins the JAX
trajectory against it). The schedule is stepped once per epoch.
"""

from __future__ import annotations

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


def get_scheduler(name: str, base_lr: float, epochs: int, warmup_epochs: int = 10,
                  min_lr: float = 1e-5) -> Callable[[int], float]:
    """epoch -> absolute lr."""
    if name == "poly_lr":
        return lambda epoch: base_lr * poly_lr_factor(
            epoch, warmup_epochs, epochs / 10, epochs, min_lr)
    raise NotImplementedError(
        f"scheduler {name!r} is not ported yet (ROADMAP.md queue 1, item 5); "
        f"ported: poly_lr")
