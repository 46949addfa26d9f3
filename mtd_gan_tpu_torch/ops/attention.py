"""Attention-gated skip connections and squeeze-excitation (counterpart of
``mtd_gan_tpu/ops/attention.py``; reference module/skip_attention.py:4-53).
The reference pipeline does not use them; they are building blocks for
discriminator and decoder variants. NCHW; 1x1 convs with biases, under the
JAX package's names."""

from __future__ import annotations

import torch
from torch import nn

Tensor = torch.Tensor


class SkipAttentionBlock(nn.Module):
    """The additive attention gate of Attention-UNet: ``x * sigmoid(psi(relu(
    W_g g + W_x x)))``."""

    def __init__(self, x_channels: int, g_channels: int, inter_channels: int):
        super().__init__()
        self.W_g = nn.Conv2d(g_channels, inter_channels, 1)
        self.W_x = nn.Conv2d(x_channels, inter_channels, 1)
        self.psi = nn.Conv2d(inter_channels, 1, 1)

    def forward(self, x: Tensor, g: Tensor) -> Tensor:
        return x * torch.sigmoid(self.psi(torch.relu(self.W_g(g) + self.W_x(x))))


class SCSEModule(nn.Module):
    """Concurrent channel and spatial squeeze-excitation: ``x * sigmoid(
    fc2(relu(fc1(mean_hw x)))) + x * sigmoid(sse(x))``."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        hidden = max(channels // reduction, 1)
        self.cse_fc1 = nn.Conv2d(channels, hidden, 1)
        self.cse_fc2 = nn.Conv2d(hidden, channels, 1)
        self.sse = nn.Conv2d(channels, 1, 1)

    def forward(self, x: Tensor) -> Tensor:
        s = self.cse_fc2(torch.relu(self.cse_fc1(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(s) + x * torch.sigmoid(self.sse(x))
