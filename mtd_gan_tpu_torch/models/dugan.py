"""DU-GAN's generator (counterpart of ``REDCNNGenerator`` in
``mtd_gan_tpu/models/dugan.py``; reference
arch/DUGAN/REDCNN/REDCNN_wrapper.py:6-33), the generator of nine of the
ten MTD-GAN ablations. The rest of DU-GAN (its U-Net discriminators and
trainer) is not ported yet (ROADMAP.md queue 1, item 9).

L + 1 3x3 convs and L + 1 3x3 transposed convs (padding 1, 32 features),
the ModuleLists ``encoder.{i}`` / ``decoder.{i}`` of the reference (the
layout ``convert_dugan_generator`` of the JAX package reads). Unlike
RED-CNN proper, the residual is saved BEFORE each encoder conv; the
decoder runs deepest first and ``decoder.0`` maps back to ``in_channels``.
The reference init is N(0, 0.01) with zero biases. It reaches no Pallas
kernel in the JAX package and runs on cuDNN here. NCHW in and out.
"""

from __future__ import annotations

import torch
from torch import nn

Tensor = torch.Tensor


class REDCNNGenerator(nn.Module):
    def __init__(self, in_channels: int = 1, features: int = 32, num_layers: int = 10):
        super().__init__()
        f = features
        self.encoder = nn.ModuleList(
            [nn.Conv2d(in_channels if i == 0 else f, f, 3, padding=1)
             for i in range(num_layers + 1)])
        self.decoder = nn.ModuleList(
            [nn.ConvTranspose2d(f, in_channels if i == 0 else f, 3, padding=1)
             for i in range(num_layers + 1)])

    def forward(self, x: Tensor) -> Tensor:
        residuals = []
        h = x
        for conv in self.encoder:
            residuals.append(h)
            h = torch.relu(conv(h))
        for i in range(len(self.decoder) - 1, -1, -1):
            h = torch.relu(self.decoder[i](h) + residuals[i])
        return h
