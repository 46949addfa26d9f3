"""MAP-NN, the modularized adaptive processing network (counterpart of
``mtd_gan_tpu/models/map_nn.py``; reference arch/MAP_NN/networks.py).

* ``CPCE2D`` (:11-77): four VALID 3x3 convs of 32 channels
  (``encoder1..4``), decoders of a transposed 3x3 conv (``decoder5..7``),
  a skip concat and a 1x1 conv (``decoder5_..7_``), a transposed head down
  to one channel (``decoder8``); no biases, xavier-uniform weights; the
  output ``clamp(relu(x + out), 0, 1)``.
* ``MAPNNGenerator`` (:83-94): one ``CPCE_2D`` applied ``depth = 5`` times,
  its weights tied.
* ``MAPNNDiscriminator`` (:97-137): WGAN-VGG's critic under the names
  ``conv1..6``, ``fc1``, ``fc2``.
* ``MAPNNModel``: the WGAN-GP ``d_loss`` of ``models/wgan_vgg.py``; ``g_loss
  = adv + 50 * MSE + 50 * MSE(sobel(fake), sobel(y))``, the 1/4-scaled
  Sobel magnitude with ``eps = 1e-4`` (:139-205); 4 D updates a step.

Nothing here reaches a Pallas kernel in the JAX package: cuDNN and cuBLAS
run it. The public functions take and give NHWC ``(N, H, W, 1)``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from mtd_gan_tpu_torch._device import DeviceLike
from mtd_gan_tpu_torch.models.wgan_vgg import (CriticModel, WGANVGGDiscriminator,
                                               _critic_convs, _nchw)
from mtd_gan_tpu_torch.ops.filters import sobel_magnitude
from mtd_gan_tpu_torch.ops.layers import Conv2d, ConvTranspose2d, torch_init_

Tensor = torch.Tensor


class CPCE2D(nn.Module):
    """NCHW in and out; a 3x3 VALID conv takes 2 pixels per encoder and the
    transposed ones give them back. ``dtype``: the convs' compute type; the
    output, the input plus the last deconv, takes the input's type (fp32),
    as the JAX module's."""

    def __init__(self, features: int = 32, dtype: Optional[torch.dtype] = None):
        super().__init__()
        f = features
        for i in range(1, 5):
            setattr(self, f"encoder{i}",
                    Conv2d(1 if i == 1 else f, f, 3, bias=False, dtype=dtype))
        for i in range(5, 8):
            setattr(self, f"decoder{i}", ConvTranspose2d(f, f, 3, bias=False, dtype=dtype))
            setattr(self, f"decoder{i}_", Conv2d(2 * f, f, 1, bias=False, dtype=dtype))
        self.decoder8 = ConvTranspose2d(f, 1, 3, bias=False, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        relu = torch.relu
        x1 = self.encoder1(x)
        x2 = self.encoder2(relu(x1))
        x3 = self.encoder3(relu(x2))
        x4 = self.encoder4(relu(x3))
        h = self.decoder5(relu(x4))
        h = relu(self.decoder5_(relu(torch.cat([x3, h], 1))))
        h = self.decoder6(h)
        h = relu(self.decoder6_(relu(torch.cat([x2, h], 1))))
        h = self.decoder7(h)
        h = relu(self.decoder7_(relu(torch.cat([x1, h], 1))))
        return relu(x + self.decoder8(h)).clamp(0.0, 1.0)


class MAPNNGenerator(nn.Module):
    """One ``CPCE_2D`` module applied ``depth`` times (weight-tied)."""

    def __init__(self, depth: int = 5, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.depth = depth
        self.CPCE_2D = CPCE2D(dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        for _ in range(self.depth):
            x = self.CPCE_2D(x)
        return x


class MAPNNDiscriminator(WGANVGGDiscriminator):
    """WGAN-VGG's critic with MAP-NN's names ``conv1..6``."""

    model = "MAP_NN"

    def __init__(self, dtype: Optional[torch.dtype] = None):
        nn.Module.__init__(self)
        for i, conv in enumerate(_critic_convs(dtype), start=1):
            setattr(self, f"conv{i}", conv)
        self._head()

    def features(self, x: Tensor) -> Tensor:
        for i in range(1, 7):
            x = nn.functional.leaky_relu(getattr(self, f"conv{i}")(x), 0.2)
        return x


def xavier_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Xavier-uniform weights on every conv of ``module`` (none has a bias),
    drawn in ``module.modules()`` order (reference :11-77)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            nn.init.xavier_uniform_(m.weight, generator=generator)
    return module


class MAPNNModel(CriticModel):
    """MAP-NN with xavier-uniform generator weights and torch's default
    critic init, drawn from ``seed``."""

    name = "MAP_NN"

    def __init__(self, depth: int = 5, device: DeviceLike = None, seed: int = 0,
                 dtype: Optional[torch.dtype] = None):
        init = torch.Generator().manual_seed(seed)
        super().__init__(xavier_init_(MAPNNGenerator(depth, dtype), init),
                         torch_init_(MAPNNDiscriminator(dtype), init), device)
        self.dtype = dtype

    def g_loss_terms(self, fake: Tensor, x: Tensor, y: Tensor, update_stats: bool = True,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """``adv + 50 * MSE + 50 * edge`` given ``fake = G(x)`` (NHWC)."""
        adv = -self.critic(fake).mean()
        mse = ((fake - y) ** 2).mean()
        edge = ((sobel_magnitude(_nchw(fake), 1e-4) - sobel_magnitude(_nchw(y), 1e-4))
                ** 2).mean()
        return adv + 50.0 * mse + 50.0 * edge, {"G/adv_loss": adv, "G/mse_loss": mse,
                                                "G/edge_loss": edge}
