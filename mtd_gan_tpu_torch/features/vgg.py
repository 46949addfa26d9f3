"""VGG19 and VGG16 feature trunks (counterpart of
``mtd_gan_tpu/features/vgg.py``), as ``nn.Module``s whose parameters carry
torchvision's names (``features.N.weight`` / ``.bias``), so the ``features``
entries of a torchvision state dict load with ``strict=True``.

VGG19 feeds the PL and TML metrics (slice ends after relu1_1, relu2_1,
relu3_1, relu4_1 and relu5_1: sequential indices 1, 6, 11, 20, 29;
reference losses.py:17-63, metrics.py:93-168) and WGAN-VGG's extractor
(features[:35], through relu5_4). VGG16 feeds LPIPS (max pooling) and DISTS
(Hann L2 pooling). Inputs are NCHW with 3 channels; a gray slice is repeated
to 3 channels by the caller (reference losses.py:59).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

# torchvision's cfg 'E' (vgg19) and 'D' (vgg16); "M" is a 2x2 max pool
VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M")
VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")
VGG_SLICE_ENDS = (1, 6, 11, 20, 29)      # relu1_1 ... relu5_1
VGG16_LPIPS_ENDS = (3, 8, 15, 22, 29)    # relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
WGAN_VGG_END = 34                        # relu5_4


def _hann3(c: int, dtype, device) -> torch.Tensor:
    """piq's ``hann_filter(3)`` (the outer product of [0.5, 1, 0.5],
    normalised), one copy per channel: (c, 1, 3, 3)."""
    w = torch.tensor([0.5, 1.0, 0.5], dtype=torch.float64)
    k = torch.outer(w, w)
    return (k / k.sum()).to(dtype=dtype, device=device).expand(c, 1, 3, 3)


def l2pool(x: torch.Tensor) -> torch.Tensor:
    """L2 pooling with a 3x3 Hann window, stride 2, padding 1 (DISTS's
    replacement of max pooling; reference module/piq/functional/layers.py)."""
    c = x.shape[1]
    out = F.conv2d(x * x, _hann3(c, x.dtype, x.device), stride=2, padding=1, groups=c)
    return torch.sqrt(out + 1e-12)


class VGGTrunk(nn.Module):
    """The ``features`` part of a torchvision VGG: 3x3 convs (padding 1),
    in-place ReLUs and 2x2 max pools in torchvision's sequential order."""

    def __init__(self, cfg: Sequence = VGG19_CFG):
        super().__init__()
        layers: List[nn.Module] = []
        c_in = 3
        for v in cfg:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(c_in, v, 3, padding=1), nn.ReLU(inplace=True)]
                c_in = v
        self.features = nn.Sequential(*layers)

    def conv_layers(self) -> List[nn.Conv2d]:
        return [m for m in self.features if isinstance(m, nn.Conv2d)]

    def forward(self, x: torch.Tensor, ends: Sequence[int] = VGG_SLICE_ENDS,
                pool: str = "max") -> List[torch.Tensor]:
        """Activations after each sequential index in ``ends`` (inclusive).
        ``pool``: ``"max"`` or ``"l2"`` (every max pool replaced by
        :func:`l2pool`, as DISTS does)."""
        if pool not in ("max", "l2"):
            raise ValueError(f"pool must be 'max' or 'l2', got {pool!r}")
        outs = []
        h = x
        for idx in range(max(ends) + 1):
            layer = self.features[idx]
            if pool == "l2" and isinstance(layer, nn.MaxPool2d):
                h = l2pool(h)
            else:
                h = layer(h)
            if idx in ends:
                outs.append(h)
        return outs


def vgg19_trunk() -> VGGTrunk:
    return VGGTrunk(VGG19_CFG)


def vgg16_trunk() -> VGGTrunk:
    return VGGTrunk(VGG16_CFG)


@torch.no_grad()
def init_he_normal_(trunk: VGGTrunk, generator: Optional[torch.Generator] = None
                    ) -> VGGTrunk:
    """The seeded fallback: He-normal kernels (std sqrt(2 / (9 C_in))), zero
    biases, drawn in conv order on the CPU from ``generator``."""
    for conv in trunk.conv_layers():
        w = torch.randn(conv.weight.shape, generator=generator, dtype=torch.float32)
        conv.weight.copy_(w * math.sqrt(2.0 / (9 * conv.in_channels)))
        conv.bias.zero_()
    return trunk
