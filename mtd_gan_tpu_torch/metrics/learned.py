"""Learned full-reference metrics LPIPS, DISTS and PieAPP (counterpart of
``mtd_gan_tpu/metrics/learned.py``; reference module/piq/perceptual.py:269-377
and module/piq/pieapp.py:20-206).

Their weights are external downloads (torchvision vgg16, lpips_weights.pt,
dists_weights.pt, PieAPPv0.1.pth; WEIGHTS.md), so they are arguments here,
as in the JAX package: LPIPS and DISTS take a VGG16 trunk
(:func:`mtd_gan_tpu_torch.features.vgg.vgg16_trunk`) and their per-channel
weights, PieAPP a :class:`PieAPP` module whose parameter names are those of
PieAPPv0.1.pth. Images are NHWC, gray or RGB, in [0, data_range].
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mtd_gan_tpu_torch.features.vgg import VGG16_LPIPS_ENDS, VGGTrunk

Tensor = torch.Tensor

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_EPS = 1e-10  # piq ContentLoss EPS


def _prep(x: Tensor) -> Tensor:
    """NHWC gray or RGB -> ImageNet-normalised 3-channel NCHW."""
    if x.shape[-1] == 1:
        x = x.expand(*x.shape[:-1], 3)
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def _channel_weights(ws: Sequence, like: Tensor) -> List[Tensor]:
    return [torch.as_tensor(np.asarray(w, np.float32).reshape(-1), device=like.device)
            .to(like.dtype).reshape(1, -1, 1, 1) for w in ws]


def lpips(pred: Tensor, target: Tensor, vgg16: VGGTrunk,
          layer_weights: Sequence[np.ndarray]) -> Tensor:
    """LPIPS distance (lower = more similar): per layer the unit-normalised
    feature difference squared, weighted per channel, averaged over the
    positions and summed over channels and layers; the batch mean."""
    fx = vgg16(_prep(pred), VGG16_LPIPS_ENDS, pool="max")
    fy = vgg16(_prep(target), VGG16_LPIPS_ENDS, pool="max")
    total = 0.0
    for x_l, y_l, w in zip(fx, fy, _channel_weights(layer_weights, pred)):
        ux = x_l / (torch.sqrt(torch.sum(x_l ** 2, dim=1, keepdim=True)) + _EPS)
        uy = y_l / (torch.sqrt(torch.sum(y_l ** 2, dim=1, keepdim=True)) + _EPS)
        total = total + torch.sum(torch.mean((ux - uy) ** 2 * w, dim=(2, 3)), dim=1)
    return torch.mean(total)


def dists(pred: Tensor, target: Tensor, vgg16: VGGTrunk,
          alpha: Sequence[np.ndarray], beta: Sequence[np.ndarray]) -> Tensor:
    """DISTS distance: 1 - the weighted structure and texture similarities
    of the input (layer 0) and the L2-pooled VGG16 features; alpha and beta
    per layer, channels (3, 64, 128, 256, 512, 512)."""
    eps = 1e-6
    px, pt = _prep(pred), _prep(target)
    fx = [px] + vgg16(px, VGG16_LPIPS_ENDS, pool="l2")
    fy = [pt] + vgg16(pt, VGG16_LPIPS_ENDS, pool="l2")
    structure, texture = [], []
    for x_l, y_l in zip(fx, fy):
        x_mean = x_l.mean(dim=(2, 3), keepdim=True)
        y_mean = y_l.mean(dim=(2, 3), keepdim=True)
        structure.append((2.0 * x_mean * y_mean + eps) / (x_mean ** 2 + y_mean ** 2 + eps))
        x_var = ((x_l - x_mean) ** 2).mean(dim=(2, 3), keepdim=True)
        y_var = ((y_l - y_mean) ** 2).mean(dim=(2, 3), keepdim=True)
        xy_cov = (x_l * y_l).mean(dim=(2, 3), keepdim=True) - x_mean * y_mean
        texture.append((2.0 * xy_cov + eps) / (x_var + y_var + eps))
    total = 0.0
    for d, w in zip(structure + texture, _channel_weights(list(alpha) + list(beta), pred)):
        total = total + torch.sum(torch.mean(d * w, dim=(2, 3)), dim=1)
    return torch.mean(1.0 - total)


# ---------------------------------------------------------------------------
# PieAPP (reference module/piq/pieapp.py)
# ---------------------------------------------------------------------------

_PIEAPP_CONVS = (("conv1", 3, 64), ("conv2", 64, 64), ("conv3", 64, 64),
                 ("conv4", 64, 128), ("conv5", 128, 128), ("conv6", 128, 128),
                 ("conv7", 128, 256), ("conv8", 256, 256), ("conv9", 256, 256),
                 ("conv10", 256, 512), ("conv11", 512, 512))
_PIEAPP_FCS = (("fc1_score", 120832, 512), ("fc2_score", 512, 1),
               ("fc1_weight", 2048, 512), ("fc2_weight", 512, 1),
               ("ref_score_subtract", 1, 1))


class PieAPP(nn.Module):
    """PieAPPv0.1's network: eleven 3x3 convs with ReLU and 2x2 max pools,
    the score and weight heads."""

    def __init__(self):
        super().__init__()
        for name, c_in, c_out in _PIEAPP_CONVS:
            self.add_module(name, nn.Conv2d(c_in, c_out, 3, padding=1))
        for name, n_in, n_out in _PIEAPP_FCS:
            self.add_module(name, nn.Linear(n_in, n_out))

    def features(self, patches: Tensor):
        """(P, 3, 64, 64) patches in [0, 255] -> (features, weight
        features), as ``PieAPPModel.forward`` (reference pieapp.py:56-82)."""
        c = lambda name, t: F.relu(getattr(self, name)(t))
        pool = lambda t: F.max_pool2d(t, 2, 2)
        x3 = c("conv3", pool(c("conv2", c("conv1", patches))))
        x5 = c("conv5", pool(c("conv4", x3)))
        x7 = c("conv7", pool(c("conv6", x5)))
        x9 = c("conv9", pool(c("conv8", x7)))
        x11 = c("conv11", pool(c("conv10", x9))).flatten(1)
        feats = torch.cat([x3.flatten(1), x5.flatten(1), x7.flatten(1), x9.flatten(1), x11],
                          dim=1)
        return feats, x11


def _crop(x: Tensor, size: int = 64, stride: int = 27) -> Tensor:
    """NCHW -> (N * P, C, size, size) patches in torch ``unfold``'s
    row-major order (reference functional/base.py:89-101)."""
    n, c = x.shape[:2]
    t = x.unfold(2, size, stride).unfold(3, size, stride)  # N, C, nh, nw, s, s
    return t.permute(0, 2, 3, 1, 4, 5).reshape(-1, c, size, size)


def pieapp(pred: Tensor, target: Tensor, model: PieAPP, data_range: float = 1.0,
           stride: int = 27) -> Tensor:
    """PieAPP score over NHWC batches (gray repeated to RGB), piq's
    patch-weighted score (reference pieapp.py:149-188)."""
    if pred.shape[-1] == 1:
        pred = pred.expand(*pred.shape[:-1], 3)
        target = target.expand(*target.shape[:-1], 3)
    n = pred.shape[0]
    xp = _crop(pred.float().permute(0, 3, 1, 2) / data_range * 255.0, stride=stride)
    xt = _crop(target.float().permute(0, 3, 1, 2) / data_range * 255.0, stride=stride)
    fp, wp = model.features(xp)
    ft, wt = model.features(xt)
    dist = 0.01 * model.fc2_score(F.relu(model.fc1_score(ft - fp)))
    dist = model.ref_score_subtract(dist)
    wgt = model.fc2_weight(F.relu(model.fc1_weight(wt - wp))) + 1e-6
    dist, wgt = dist.reshape(n, -1), wgt.reshape(n, -1)
    return torch.mean(torch.sum(dist * wgt, dim=1) / torch.sum(wgt, dim=1))
