"""Loss functions of the MTD-GAN step (counterpart of
``mtd_gan_tpu/losses.py:24-54``; reference losses.py)."""

from __future__ import annotations

import torch

from mtd_gan_tpu_torch.ops.filters import laplacian_detail

Tensor = torch.Tensor


def l1(pred: Tensor, target: Tensor) -> Tensor:
    return (pred - target).abs().mean()


def l2(pred: Tensor, target: Tensor) -> Tensor:
    return ((pred - target) ** 2).mean()


def ls_gan(pred: Tensor, target: float) -> Tensor:
    """LSGAN objective: mean((pred - target)^2) for a scalar label."""
    return ((pred - target) ** 2).mean()


def nds_loss(pred: Tensor, target: float, diff: Tensor) -> Tensor:
    """Non-difference-suppression LSGAN: pixels where ``diff == 0`` (low and
    full dose agree) do not count."""
    mask = (diff.abs() != 0).to(pred.dtype)
    return (mask * (pred - target) ** 2).mean()


def charbonnier_loss(pred: Tensor, target: Tensor, eps: float = 1e-3) -> Tensor:
    diff = pred - target
    return torch.sqrt(diff * diff + eps * eps).mean()


def edge_loss(pred: Tensor, target: Tensor) -> Tensor:
    """Charbonnier distance between Laplacian-pyramid detail layers (NCHW)."""
    return charbonnier_loss(laplacian_detail(pred), laplacian_detail(target))


LOSSES = {"L1 Loss": l1, "L2 Loss": l2, "Charbonnier Loss": charbonnier_loss,
          "Edge Loss": edge_loss}


def get_loss(name: str):
    """Criterion by the reference's name (losses.py:186-197)."""
    if name not in LOSSES:
        raise KeyError(f"unknown loss {name!r}; known: {sorted(LOSSES)}")
    return LOSSES[name]
