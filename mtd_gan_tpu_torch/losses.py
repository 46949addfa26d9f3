"""Loss functions (counterpart of ``mtd_gan_tpu/losses.py``; reference
losses.py): those of the MTD-GAN step and EDCNN's compound loss."""

from __future__ import annotations

import torch

from mtd_gan_tpu_torch.ops.filters import laplacian_detail

Tensor = torch.Tensor


def l1(pred: Tensor, target: Tensor) -> Tensor:
    return (pred - target).abs().mean()


def l2(pred: Tensor, target: Tensor) -> Tensor:
    return ((pred - target) ** 2).mean()


mse = l2


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


def make_compound_loss(feature_fn=None, mse_weight: float = 1.0,
                       resnet_weight: float = 0.01, device=None):
    """EDCNN's CompoundLoss (reference losses.py:154-183): ``mse_weight *
    l2 + resnet_weight *`` the mean over the ResNet50 blocks of the l2
    between the features of ``pred`` and ``target``, NHWC in. The default
    ``feature_fn`` is ``features.get_resnet_feature_fn(device)``, taken at
    the first call: its parameters are frozen (no ``.grad``, in no
    optimizer) and it runs in fp32 with TF32 off; the gradient flows through
    ``pred``'s features."""
    def loss(pred: Tensor, target: Tensor) -> Tensor:
        nonlocal feature_fn
        if feature_fn is None:
            from mtd_gan_tpu_torch.features import get_resnet_feature_fn
            feature_fn = get_resnet_feature_fn(device)
        fp, ft = feature_fn(pred), feature_fn(target)
        feat = sum(l2(a, b) for a, b in zip(fp, ft)) / len(fp)
        return mse_weight * l2(pred, target) + resnet_weight * feat

    return loss


LOSSES = {"L1 Loss": l1, "L2 Loss": l2, "Charbonnier Loss": charbonnier_loss,
          "Edge Loss": edge_loss}


def get_loss(name: str):
    """Criterion by the reference's name (losses.py:186-197)."""
    if name not in LOSSES:
        raise KeyError(f"unknown loss {name!r}; known: {sorted(LOSSES)}")
    return LOSSES[name]
