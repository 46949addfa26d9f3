"""WGAN-VGG, the Wasserstein GAN with a VGG19 perceptual loss (counterpart
of ``mtd_gan_tpu/models/wgan_vgg.py``; reference
arch/WGAN_VGG/networks.py:11-122).

* ``WGANVGGGenerator``: eleven 3x3 convs of 32 channels (no bias, ReLU),
  a 1x1 ``conv_out`` (no bias), the output ``relu(out + x)``; the
  reference's Sequential ``net.{0, 2, ..., 20}`` and ``net.22``.
* ``WGANVGGDiscriminator``: six 3x3 stages (64, 64/2, 128, 128/2, 256,
  256/2) with LeakyReLU 0.2 (``net.{0, 2, ..., 10}``), then ``fc1``
  (16384 -> 1024), LeakyReLU and ``fc2`` (1024 -> 1) on the NCHW flatten;
  64x64 input only. MAP-NN's critic is the same network with the names
  ``conv1..6`` (``MAPNNDiscriminator``, ``models/map_nn.py``).
* ``wgan_gradient_penalty``: ``10 * mean((||dD/dx||_2 - 1)^2)`` at
  ``a * real + (1 - a) * fake``, differentiable in D's parameters.
* ``WGANVGGModel``: ``d_loss = E[D(fake)] - E[D(y)] + GP``, ``g_loss =
  -E[D(fake)] + 0.1 * MSE(phi(fake), phi(y))`` with phi the registry's VGG19
  through relu5_4 (``get_perceptual_fn("wgan_vgg")``); 4 D updates a step.

torch's default init (the JAX ``torch_init=True``). Nothing here reaches a
Pallas kernel in the JAX package: cuDNN and cuBLAS run it. The public
functions take and give NHWC ``(N, H, W, 1)``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mtd_gan_tpu_torch._device import DeviceLike, resolve_device
from mtd_gan_tpu_torch.ops.layers import Conv2d, Linear, torch_init_
from mtd_gan_tpu_torch.parallel.mesh import batch_draw

Tensor = torch.Tensor

# (in, out, stride) of the critic's six 3x3 stages
CRITIC_STAGES = ((1, 64, 1), (64, 64, 2), (64, 128, 1), (128, 128, 2), (128, 256, 1),
                 (256, 256, 2))
CRITIC_SIZE = 64
GP_LAMBDA = 10.0


def _nchw(t: Tensor) -> Tensor:
    return t.permute(0, 3, 1, 2)


def _nhwc(t: Tensor) -> Tensor:
    return t.permute(0, 2, 3, 1)


def check_critic_input(h: int, w: int, model: str) -> None:
    """The WGAN-VGG / MAP-NN critic takes 64x64 only: raise otherwise."""
    if (h, w) != (CRITIC_SIZE, CRITIC_SIZE):
        raise ValueError(
            f"the {model} critic takes 64x64 inputs (its fc1 reads the 256 x 8 x 8 "
            f"map of three 2x downsamplings), got {h}x{w}: train it on 64x64 "
            f"patches ('window_patch' or 'full_patch'), as the JAX package does")


class WGANVGGGenerator(nn.Module):
    """NCHW in and out. ``dtype``: the convs' compute type; the output, the
    last conv plus the fp32 input, is fp32, as the JAX module's."""

    def __init__(self, features: int = 32, dtype: Optional[torch.dtype] = None):
        super().__init__()
        layers = []
        for i in range(11):
            layers += [Conv2d(1 if i == 0 else features, features, 3, padding=1,
                              bias=False, dtype=dtype), nn.ReLU()]
        layers.append(Conv2d(features, 1, 1, bias=False, dtype=dtype))
        self.net = nn.Sequential(*layers)

    def forward(self, x: Tensor) -> Tensor:
        return torch.relu(self.net(x) + x)


def _critic_convs(dtype: Optional[torch.dtype] = None):
    return [Conv2d(cin, cout, 3, stride, 1, dtype=dtype) for cin, cout, stride in CRITIC_STAGES]


class WGANVGGDiscriminator(nn.Module):
    """NCHW ``(N, 1, 64, 64)`` -> ``(N, 1)``. ``dtype``: the convs' compute
    type; the linear head, which has none in the JAX module, follows its
    input, so a bf16 critic scores in bf16 there too (the WGAN loss, its
    gradient penalty's double backward included, runs in the types the
    JAX model computes it in)."""

    model = "WGAN_VGG"

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.net = nn.Sequential(*[m for conv in _critic_convs(dtype)
                                   for m in (conv, nn.LeakyReLU(0.2))])
        self._head()

    def _head(self) -> None:
        self.fc1 = Linear(256 * 8 * 8, 1024)
        self.fc2 = Linear(1024, 1)

    def features(self, x: Tensor) -> Tensor:
        return self.net(x)

    def forward(self, x: Tensor) -> Tensor:
        check_critic_input(x.shape[2], x.shape[3], self.model)
        h = self.features(x).flatten(1)  # NCHW order, as the reference's view
        return self.fc2(F.leaky_relu(self.fc1(h), 0.2))


def wgan_gradient_penalty(disc_apply: Callable[[Tensor], Tensor], real: Tensor,
                          fake: Tensor, a: Tensor, lambda_: float = GP_LAMBDA) -> Tensor:
    """``lambda_ * mean((sqrt(sum (d sum D / d xhat)^2 + 1e-12) - 1)^2)`` at
    ``xhat = a * real + (1 - a) * fake`` (reference :113-122); ``a`` is the
    per-sample draw, shaped to broadcast (``(N, 1, 1, 1)``). The input
    gradient keeps its graph (``create_graph``), so a backward of the
    penalty reaches D's parameters through it."""
    interp = (a * real + (1.0 - a) * fake).detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(disc_apply(interp).sum(), interp, create_graph=True)
    norms = torch.sqrt((grads.reshape(grads.shape[0], -1) ** 2).sum(1) + 1e-12)
    return ((norms - 1.0) ** 2).mean() * lambda_


class CriticModel:
    """The WGAN-GP step shared by WGAN-VGG and MAP-NN: ``generate``,
    ``train_forward`` and ``d_loss`` on NHWC tensors, the hooks
    ``AdversarialTrainer`` calls (``update_stats`` is taken and unused: the
    critic has no spectral norm). ``device`` defaults to ``cuda`` and
    raises without a GPU."""

    n_d_tasks = 1
    d_steps_per_g = 4  # reference engine.py:434-438, :553-557

    def __init__(self, generator: nn.Module, discriminator: nn.Module,
                 device: DeviceLike):
        self.device = resolve_device(device)
        self.generator = generator.to(self.device).eval()
        self.discriminator = discriminator.to(self.device)

    def check_input(self, h: int, w: int) -> None:
        check_critic_input(h, w, self.name)

    @torch.no_grad()
    def generate(self, x: Tensor) -> Tensor:
        """``(N, H, W, 1)`` -> ``(N, H, W, 1)``."""
        return _nhwc(self.generator(_nchw(x)))

    def train_forward(self, x: Tensor) -> Tensor:
        """``G(x)`` with its graph, for a train step."""
        return _nhwc(self.generator(_nchw(x)))

    def critic(self, z: Tensor) -> Tensor:
        """D on NHWC ``z`` -> ``(N, 1)``."""
        return self.discriminator(_nchw(z))

    def d_loss(self, x: Tensor, y: Tensor, fake: Tensor, update_stats: bool = True,
               generator: Optional[torch.Generator] = None,
               draws: Optional[Tensor] = None) -> Tuple[Tensor, Dict[str, Tensor]]:
        """``wgan + gp`` on NHWC ``y`` and ``fake = G(x)`` (detached here);
        ``draws``: the GP's per-sample ``a ~ U(0, 1)``, ``(N, 1, 1, 1)``
        (drawn from ``generator`` when ``None``)."""
        fake = fake.detach()
        wgan = -self.critic(y).mean() + self.critic(fake).mean()
        a = (batch_draw(lambda s: torch.rand(s, generator=generator, device=self.device),
                        (y.shape[0], 1, 1, 1)) if draws is None else draws)
        gp = wgan_gradient_penalty(self.critic, y, fake, a)
        return wgan + gp, {"D/d_loss": wgan, "D/gp_loss": gp}


class WGANVGGModel(CriticModel):
    """WGAN-VGG with torch's default init drawn from ``seed``. ``feature_fn``
    (NHWC -> features) defaults to the registry's VGG19 through relu5_4 on
    the model's device, taken at the first G loss; ``use_perceptual=False``
    drops the perceptual term."""

    name = "WGAN_VGG"

    def __init__(self, use_perceptual: bool = True, feature_fn=None,
                 device: DeviceLike = None, seed: int = 0,
                 dtype: Optional[torch.dtype] = None):
        init = torch.Generator().manual_seed(seed)
        super().__init__(torch_init_(WGANVGGGenerator(dtype=dtype), init),
                         torch_init_(WGANVGGDiscriminator(dtype), init), device)
        self.dtype = dtype
        self.use_perceptual = use_perceptual
        self.feature_fn = feature_fn

    def g_loss_terms(self, fake: Tensor, x: Tensor, y: Tensor, update_stats: bool = True,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """``-E[D(fake)] + 0.1 * mean((phi(fake) - phi(y))^2)`` given ``fake
        = G(x)`` (NHWC); the target's features are detached."""
        adv = -self.critic(fake).mean()
        if not self.use_perceptual:
            return adv, {"G/g_loss": adv}
        if self.feature_fn is None:
            from mtd_gan_tpu_torch.features import get_perceptual_fn
            self.feature_fn = get_perceptual_fn("wgan_vgg", self.device)
        p = ((self.feature_fn(fake) - self.feature_fn(y.detach()).detach()) ** 2).mean()
        return adv + 0.1 * p, {"G/g_loss": adv, "G/p_loss": p}
