"""The FID InceptionV3 to pool3 (counterpart of
``mtd_gan_tpu/features/inception.py``): pytorch-fid's port of TF-Slim
InceptionV3, as the vendored piq extractor of the reference uses it
(module/piq/feature_extractors/fid_inception.py): ``FIDInceptionA`` / ``C``
with ``count_include_pad=False`` average pools, ``FIDInceptionE_2``
(``Mixed_7c``) with a max pool, batch norm in eval with eps 1e-3.
Parameter names are those of ``pt_inception-2015-12-05-*.pth``
(``Mixed_5b.branch1x1.conv.weight``, ``… .bn.running_var``, ``fc.weight``).

Input: [0, 1] NHWC images of any size, 1 or 3 channels, resized to 299x299
by :func:`resize_299` and scaled to [-1, 1]; output: the 2048-d pool3
features.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class BasicConv2d(nn.Module):
    """conv (no bias) -> batch norm (eps 1e-3) -> ReLU."""

    def __init__(self, c_in: int, c_out: int, kernel, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel, stride=stride, padding=padding,
                              bias=False)
        self.bn = nn.BatchNorm2d(c_out, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avgpool(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, c_in: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(c_in, 64, 1)
        self.branch5x5_1 = BasicConv2d(c_in, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(c_in, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, bd, self.branch_pool(_avgpool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(c_in, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, c_in: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(c_in, 192, 1)
        self.branch7x7_1 = BasicConv2d(c_in, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(c_in, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(c_in, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avgpool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(c_in, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(c_in, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """``pool="max"`` is pytorch-fid's ``FIDInceptionE_2`` (``Mixed_7c``)."""

    def __init__(self, c_in: int, pool: str):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(c_in, 320, 1)
        self.branch3x3_1 = BasicConv2d(c_in, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(c_in, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(c_in, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = F.max_pool2d(x, 3, 1, 1) if self.pool == "max" else _avgpool(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class FIDInceptionV3(nn.Module):
    """pt_inception to pool3, with its 1008-class ``fc`` head (used only by
    :func:`inception_logits`)."""

    def __init__(self, num_classes: int = 1008):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW 299x299 in [-1, 1] -> (B, 2048) pool3 features."""
        h = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        h = F.max_pool2d(h, 3, 2)
        h = F.max_pool2d(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(h)), 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b",
                     "Mixed_6c", "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b",
                     "Mixed_7c"):
            h = getattr(self, name)(h)
        return h.mean(dim=(2, 3))


@torch.no_grad()
def init_he_normal_(model: FIDInceptionV3, generator: Optional[torch.Generator] = None
                    ) -> FIDInceptionV3:
    """The seeded fallback: He-normal conv kernels (std sqrt(2 / fan_in)),
    identity batch norms, an N(0, 0.02) ``fc`` with zero bias; drawn in
    module order on the CPU from ``generator``."""
    for m in model.modules():
        if isinstance(m, BasicConv2d):
            w = m.conv.weight
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            w.copy_(torch.randn(w.shape, generator=generator) * math.sqrt(2.0 / fan_in))
            m.bn.reset_parameters()
    model.fc.weight.copy_(torch.randn(model.fc.weight.shape, generator=generator) * 0.02)
    model.fc.bias.zero_()
    return model


def resize_299(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NCHW 299x299, bilinear with half-pixel centres and, when it
    shrinks, a triangle filter widened by the scale: the function
    ``jax.image.resize(..., method="bilinear")`` computes (plain
    ``F.interpolate`` without ``antialias`` differs by up to 0.5 at
    512 -> 299)."""
    return F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                         antialias=True)


def _prepare(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] NHWC, 1 or 3 channels -> NCHW 299x299 in [-1, 1]."""
    if x.shape[-1] == 1:
        x = x.expand(*x.shape[:-1], 3)
    return resize_299(x.permute(0, 3, 1, 2).contiguous()) * 2.0 - 1.0


def inception_pool3_features(model: FIDInceptionV3, x: torch.Tensor) -> torch.Tensor:
    """[0, 1] NHWC (any size, 1 or 3 channels) -> (B, 2048) pool3 features."""
    return model(_prepare(x))


def inception_logits(model: FIDInceptionV3, x: torch.Tensor) -> torch.Tensor:
    """[0, 1] NHWC -> (B, n_classes) raw classifier logits, the input of the
    Inception Score (reference module/piq/isc.py:20-42)."""
    return model.fc(inception_pool3_features(model, x))
