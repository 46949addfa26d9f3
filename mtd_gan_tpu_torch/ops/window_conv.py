"""Learnable HU windowing: a 1x1 conv with a bounded activation, set to five
radiology presets (counterpart of ``mtd_gan_tpu/ops/window_conv.py``;
reference module/window_conv.py:7-72, "Practical Window Setting
Optimization", arXiv:1812.00572). The input is the [0, 1] normalised
slice; each output channel is a window ``w * x + b`` squashed to [0, 1]:

    brain          W 50.000  B -12.500
    subdural       W 31.250  B  -7.687
    stroke         W 45.455  B -11.682
    temporal bones W  1.464  B  -0.081
    soft tissues   W 11.628  B  -2.465
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

Tensor = torch.Tensor

WINDOW_PRESET_WEIGHTS = np.array([50.0, 31.25, 45.455, 1.464, 11.628], np.float32)
WINDOW_PRESET_BIASES = np.array([-12.5, -7.687, -11.682, -0.081, -2.465], np.float32)


class WindowConv2D(nn.Module):
    """NCHW ``(N, in, H, W)`` -> ``(N, out, H, W)``; ``weight`` ``(in, out)``
    and ``bias`` ``(out,)`` in the JAX package's layout, output channel ``o``
    at preset ``o % 5``. ``mode``: ``relu`` (clip to [0, 1]) or ``sigmoid``."""

    def __init__(self, in_channels: int = 1, out_channels: int = 5, mode: str = "relu"):
        super().__init__()
        if mode not in ("relu", "sigmoid"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        presets = np.arange(out_channels) % 5
        w = np.broadcast_to(WINDOW_PRESET_WEIGHTS[presets], (in_channels, out_channels))
        self.weight = nn.Parameter(torch.tensor(np.ascontiguousarray(w)))
        self.bias = nn.Parameter(torch.tensor(WINDOW_PRESET_BIASES[presets]))

    def forward(self, x: Tensor) -> Tensor:
        y = torch.einsum("nchw,co->nohw", x, self.weight) + self.bias[:, None, None]
        return y.clamp(0.0, 1.0) if self.mode == "relu" else torch.sigmoid(y)
