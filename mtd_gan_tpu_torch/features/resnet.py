"""ResNet50 trunk (counterpart of ``mtd_gan_tpu/features/resnet.py``): the
feature extractor of EDCNN's compound loss (reference losses.py:66-97,
arch/EDCNN/compound_loss.py), the feature maps after layer1 - layer4, batch
norm in eval. Parameter names are torchvision's (``conv1``, ``bn1``,
``layer1.0.conv1``, ``layer1.0.downsample.0``), so a torchvision resnet50
state dict, its ``fc`` head dropped, loads with ``strict=True``.

Padding follows the JAX package, which is what the port is held to: the
stem conv pads 3, the max pool pads with -inf, and every other conv pads
"SAME" in XLA's sense, which for the stride-2 3x3 convs on an even input is
(0, 1), not torchvision's (1, 1).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

# (blocks, in, mid, out, stride) per layer
RESNET50_LAYERS = ((3, 64, 64, 256, 1), (4, 256, 128, 512, 2),
                   (6, 512, 256, 1024, 2), (3, 1024, 512, 2048, 2))


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """XLA's "SAME" padding of ``x`` for a k x k kernel at stride s: the
    output is ceil(size / s), the extra pixel of an odd total at the end."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        total = max((math.ceil(size / s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


class Bottleneck(nn.Module):
    def __init__(self, c_in: int, mid: int, c_out: int, stride: int, downsample: bool):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(c_in, mid, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(mid)
        self.conv2 = nn.Conv2d(mid, mid, 3, stride=stride, bias=False)
        self.bn2 = nn.BatchNorm2d(mid)
        self.conv3 = nn.Conv2d(mid, c_out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(c_out)
        self.downsample = (nn.Sequential(nn.Conv2d(c_in, c_out, 1, stride=stride, bias=False),
                                         nn.BatchNorm2d(c_out)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(_same_pad(y, 3, self.stride))))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class ResNet50Trunk(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        for li, (blocks, c_in, mid, c_out, stride) in enumerate(RESNET50_LAYERS, 1):
            self.add_module(f"layer{li}", nn.Sequential(*[
                Bottleneck(c_in if bi == 0 else c_out, mid, c_out,
                           stride if bi == 0 else 1, downsample=bi == 0)
                for bi in range(blocks)]))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """NCHW 3-channel input -> [layer1, layer2, layer3, layer4] maps."""
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        feats = []
        for li in range(1, 5):
            h = getattr(self, f"layer{li}")(h)
            feats.append(h)
        return feats


def resnet50_block_features(model: ResNet50Trunk, x: torch.Tensor) -> List[torch.Tensor]:
    """NCHW 3-channel input -> the four block feature maps."""
    return model(x)


@torch.no_grad()
def init_he_normal_(model: ResNet50Trunk, generator: Optional[torch.Generator] = None
                    ) -> ResNet50Trunk:
    """The seeded fallback: He-normal conv kernels (std sqrt(2 / fan_in)),
    identity batch norms, drawn in module order on the CPU."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * math.sqrt(2.0 / fan_in))
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
            m.reset_running_stats()
    return model
