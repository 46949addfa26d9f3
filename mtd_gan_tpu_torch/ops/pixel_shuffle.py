"""The REC decoder's upsample block (counterpart of
``mtd_gan_tpu/ops/pixel_shuffle.py``; reference arch/Ours/networks.py:166-175):
a 1x1 conv to ``C * r * r`` channels, then ``nn.PixelShuffle(r)``. The JAX
package already uses torch's channel order (input channel ``c*r*r + i*r +
j`` goes to output channel ``c`` at offset ``(i, j)``)."""

from __future__ import annotations

import torch
from torch import nn

from mtd_gan_tpu_torch.ops.layers import Conv2d


class PixelShuffleUpsample(nn.Module):
    """State-dict names as the reference's: ``upsample.0`` is the 1x1 conv,
    computing in its input's type (the JAX block's conv has no dtype of its
    own)."""

    def __init__(self, features: int, scale: int = 2):
        super().__init__()
        self.upsample = nn.Sequential(Conv2d(features, features * scale ** 2, 1),
                                      nn.PixelShuffle(scale))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.upsample(x)
