"""Loss functions (counterpart of ``mtd_gan_tpu/losses.py``; reference
losses.py): those of the MTD-GAN step, the spectral L1 ``msfr_loss``, the
VGG19 perceptual loss and EDCNN's compound loss."""

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


def msfr_loss(pred: Tensor, target: Tensor) -> Tensor:
    """Mean of ``|rfftn(pred) - rfftn(target)|`` in float32 over ALL four
    axes of NHWC tensors, as ``jnp.fft.rfftn`` without ``axes`` takes them:
    a complex FFT over N, H and W and the real-to-complex half on the
    LAST axis, the channels (one bin for a gray slice). Give NHWC: on NCHW
    the half would fall on W and the mean would differ."""
    pf = torch.fft.rfftn(pred.float(), dim=tuple(range(pred.dim())))
    tf = torch.fft.rfftn(target.float(), dim=tuple(range(target.dim())))
    return (pf - tf).abs().mean()


VGG_LOSS_WEIGHTS = (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1.0)


def make_vgg_loss(feature_fn=None, device=None):
    """The 5-slice VGG19 perceptual loss (reference losses.py:49-63): the
    weights 1/32, 1/16, 1/8, 1/4 and 1 on the L1 of each slice, NHWC in.
    The target side is detached; the gradient flows through ``x``'s
    features. The default ``feature_fn`` is
    ``features.get_vgg_slices_fn(device)``, taken at the first call: its
    parameters are frozen (no ``.grad``, in no optimizer)."""
    def loss(x: Tensor, y: Tensor) -> Tensor:
        nonlocal feature_fn
        if feature_fn is None:
            from mtd_gan_tpu_torch.features import get_vgg_slices_fn
            feature_fn = get_vgg_slices_fn(device)
        fx, fy = feature_fn(x), feature_fn(y.detach())
        return sum(w * l1(a, b.detach()) for w, a, b in zip(VGG_LOSS_WEIGHTS, fx, fy))

    return loss


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
          "Edge Loss": edge_loss, "MSFR Loss": msfr_loss}


def get_loss(name: str):
    """Criterion by the reference's name (losses.py:186-197)."""
    if name not in LOSSES:
        raise KeyError(f"unknown loss {name!r}; known: {sorted(LOSSES)}")
    return LOSSES[name]
