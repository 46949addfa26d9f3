"""EDCNN, the edge-enhanced dense CNN denoiser (counterpart of
``mtd_gan_tpu/models/edcnn.py``; reference arch/EDCNN/networks.py:9-161).

* ``SobelConv``: the fixed four-direction edge bank (horizontal, vertical,
  two diagonals, cycled over the output channels) times a trainable
  per-channel factor of the reference shape ``(C, 1, 1, 1)``, plus a
  trainable bias. The bank is the non-persistent buffer
  ``conv_sobel.sobel_weight``: no optimizer step, no decay, and not in the
  ``state_dict``, whose keys are those the JAX converter reads (it rebuilds
  the bank as this module does).
* Trunk: eight dense blocks ``conv_p{i}`` (1x1) -> ``conv_f{i}`` (3x3), each
  re-concatenating ``[x, sobel(x)]``; LeakyReLU(0.01) everywhere, the
  output included: ``lrelu(x + f8)``.
* Loss: the compound loss (MSE + 0.01 x the ResNet50-block feature MSE,
  ``losses.make_compound_loss``), or plain MSE with
  ``use_feature_loss=False``.

It reaches no Pallas kernel in the JAX package and runs on cuDNN here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mtd_gan_tpu_torch import losses
from mtd_gan_tpu_torch._device import DeviceLike
from mtd_gan_tpu_torch.models.base import SupervisedModel
from mtd_gan_tpu_torch.ops.layers import Conv2d, torch_init_

Tensor = torch.Tensor


def edcnn_sobel_bank(kernel_size: int, out_channels: int, in_channels: int) -> np.ndarray:
    """The fixed Sobel bank (OIHW), the reference fill pattern (:40-63)."""
    k = kernel_size
    mid = k // 2
    w = np.zeros((out_channels, in_channels, k, k), np.float32)
    for idx in range(out_channels):
        if idx % 4 == 0:
            w[idx, :, 0, :] = -1
            w[idx, :, 0, mid] = -2
            w[idx, :, -1, :] = 1
            w[idx, :, -1, mid] = 2
        elif idx % 4 == 1:
            w[idx, :, :, 0] = -1
            w[idx, :, mid, 0] = -2
            w[idx, :, :, -1] = 1
            w[idx, :, mid, -1] = 2
        elif idx % 4 == 2:
            w[idx, :, 0, 0] = -2
            for i in range(mid + 1):
                w[idx, :, mid - i, i] = -1
                w[idx, :, k - 1 - i, mid + i] = 1
            w[idx, :, -1, -1] = 2
        else:
            w[idx, :, -1, 0] = -2
            for i in range(mid + 1):
                w[idx, :, mid + i, i] = -1
                w[idx, :, i, mid + i] = 1
            w[idx, :, 0, -1] = 2
    return w


class SobelConv(nn.Module):
    def __init__(self, in_channels: int = 1, out_channels: int = 32, kernel_size: int = 3):
        super().__init__()
        self.padding = kernel_size // 2
        self.register_buffer("sobel_weight", torch.from_numpy(
            edcnn_sobel_bank(kernel_size, out_channels, in_channels)), persistent=False)
        self.sobel_factor = nn.Parameter(torch.ones(out_channels, 1, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: Tensor) -> Tensor:
        return F.conv2d(x, self.sobel_weight * self.sobel_factor, self.bias,
                        padding=self.padding)


class EDCNN(nn.Module):
    """NCHW in and out. ``dtype``: the 1x1 and 3x3 convs' compute type, as
    the JAX module's (``edcnn.py:90-101``); the Sobel conv follows its
    fp32 input, the dense concatenations of fp32 and bf16 parts promote to
    fp32, and the output, the last conv plus the input, is fp32."""

    def __init__(self, out_ch: int = 32, sobel_ch: int = 32,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv_sobel = SobelConv(1, sobel_ch)
        dense_in = 1 + sobel_ch
        for i in range(1, 9):
            setattr(self, f"conv_p{i}", Conv2d(dense_in if i == 1 else dense_in + out_ch,
                                               out_ch, 1, dtype=dtype))
            setattr(self, f"conv_f{i}", Conv2d(out_ch, 1 if i == 8 else out_ch, 3,
                                               padding=1, dtype=dtype))

    def forward(self, x: Tensor) -> Tensor:
        lrelu = lambda z: F.leaky_relu(z, 0.01)  # torch LeakyReLU default
        out_0 = torch.cat([x, self.conv_sobel(x)], dim=1)
        h = out_0
        for i in range(1, 8):
            f = getattr(self, f"conv_f{i}")(lrelu(getattr(self, f"conv_p{i}")(h)))
            h = torch.cat([out_0, lrelu(f)], dim=1)
        f8 = self.conv_f8(lrelu(self.conv_p8(h)))
        # the reference's `self.relu` is nn.LeakyReLU(): the output leaks too
        # (arch/EDCNN/networks.py:124,159)
        return lrelu(x + f8)


class EDCNNModel(SupervisedModel):
    """EDCNN with torch's default init (the Sobel factor 1, its bias 0)."""

    def __init__(self, out_ch: int = 32, sobel_ch: int = 32, feature_fn=None,
                 use_feature_loss: bool = True, device: DeviceLike = None, seed: int = 0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(EDCNN(out_ch, sobel_ch, dtype), device, seed, torch_init_)
        self.dtype = dtype
        self.criterion = (losses.make_compound_loss(feature_fn, device=self.device)
                          if use_feature_loss else losses.l2)
