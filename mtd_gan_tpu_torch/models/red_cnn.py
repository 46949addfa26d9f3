"""RED-CNN, the residual encoder-decoder CNN denoiser (counterpart of
``mtd_gan_tpu/models/red_cnn.py``; reference arch/RED_CNN/networks.py:7-47).

Five 5x5 VALID convs ``conv1..5`` and five 5x5 transposed convs
``tconv1..5`` (padding 0) of 96 channels, residual adds at the input, after
conv2 and after conv4, a final ReLU; the loss is MSE. The reference names
are the ``state_dict`` keys. It reaches no Pallas kernel in the JAX package
and runs on cuDNN here. The public functions take and give NHWC ``(N, H, W,
1)``; H and W must be at least 21 (five VALID 5x5 convs).
"""

from __future__ import annotations

import torch
from torch import nn

from mtd_gan_tpu_torch._device import DeviceLike
from mtd_gan_tpu_torch.models.base import SupervisedModel
from mtd_gan_tpu_torch.ops.layers import torch_init_

Tensor = torch.Tensor


class REDCNN(nn.Module):
    """NCHW in and out."""

    def __init__(self, out_ch: int = 96):
        super().__init__()
        for i in range(1, 6):
            setattr(self, f"conv{i}", nn.Conv2d(1 if i == 1 else out_ch, out_ch, 5))
        for i in range(1, 6):
            setattr(self, f"tconv{i}", nn.ConvTranspose2d(out_ch, 1 if i == 5 else out_ch, 5))

    def forward(self, x: Tensor) -> Tensor:
        relu = torch.relu
        residual_1 = x
        out = relu(self.conv2(relu(self.conv1(x))))
        residual_2 = out
        out = relu(self.conv4(relu(self.conv3(out))))
        residual_3 = out
        out = relu(self.conv5(out))
        out = self.tconv1(out) + residual_3
        out = self.tconv2(relu(out))
        out = self.tconv3(relu(out)) + residual_2
        out = self.tconv4(relu(out))
        out = self.tconv5(relu(out)) + residual_1
        return relu(out)


class REDCNNModel(SupervisedModel):
    """RED-CNN with torch's default init and the MSE loss (reference
    arch/RED_CNN/networks.py:25)."""

    def __init__(self, out_ch: int = 96, device: DeviceLike = None, seed: int = 0):
        super().__init__(REDCNN(out_ch), device, seed, torch_init_)
