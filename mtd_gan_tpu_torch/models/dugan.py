"""DU-GAN, dual U-Net discriminators (image and gradient domain) with CutMix
consistency (counterpart of ``mtd_gan_tpu/models/dugan.py``; reference
arch/DUGAN/networks.py:18-145, arch/DUGAN/DUGAN_wrapper.py (UNet),
arch/DUGAN/REDCNN/REDCNN_wrapper.py (generator)).

* ``REDCNNGenerator`` (REDCNN_wrapper.py:6-33), also the generator of nine
  of the ten MTD-GAN ablations: L + 1 3x3 convs and L + 1 3x3 transposed
  convs (padding 1, 32 features), the ModuleLists ``encoder.{i}`` /
  ``decoder.{i}``. Unlike RED-CNN proper, the residual is saved BEFORE each
  encoder conv; the decoder runs deepest first and ``decoder.0`` maps back
  to ``in_channels``.
* ``UNetDiscriminator`` (DUGAN_wrapper.py:52-113; conv_dim 64, repeat_num
  6): seven residual down blocks ``down_blocks.{i}`` (``conv_res``, the
  double conv ``net.0`` / ``net.2``, the 4x4 stride-2 ``down`` on all but
  the last), the double-conv bottom ``conv.0`` / ``conv.2`` with a
  residual, six bilinear-up blocks ``up_blocks.{j}`` (skip concat, double
  conv ``conv.0`` / ``conv.2``, 1x1 ``shortcut``); the encoder head
  (LeakyReLU, global mean, ``to_logit.3``) gives ``(N,)``, the per-pixel
  ``conv_out`` ``(N, 1, H, W)``. Spectral norm on every conv with
  ``cin > 4`` and ``cout != 1`` (utils/ops.py:13-15), one power iteration
  stored per train-mode forward; init N(0, 0.01), zero biases.
* ``cutmix_mask`` / ``mask_src_tgt`` (networks.py:132-145) on given draws.
* ``DUGANModel``: the image and gradient D losses (LSGAN on real, fake and
  the input as fake, both heads; a CutMix pass whose loss counts when the
  coin says so) and the G loss ``0.1 * (image adv) + 0.1 * (gradient adv)
  + MSE + 20 * L1`` on the Sobel maps.

The reference init is N(0, 0.01) with zero biases. Nothing here reaches a
Pallas kernel in the JAX package: cuDNN runs it. The modules take NCHW;
``DUGANModel``'s functions take and give NHWC ``(N, H, W, 1)``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from mtd_gan_tpu_torch import losses
from mtd_gan_tpu_torch._device import DeviceLike, resolve_device
from mtd_gan_tpu_torch.ops.filters import sobel_magnitude
from mtd_gan_tpu_torch.ops.layers import SNConv2d, _SpectralNorm, normal_init_
from mtd_gan_tpu_torch.ops.upsample import upsample2x_bilinear

Tensor = torch.Tensor
INIT_STD = 0.01
SOBEL_EPS = 1e-4


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


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0) -> nn.Module:
    """A conv, spectral-normed by the turn_on_spectral_norm rule."""
    if cout != 1 and cin > 4:
        return SNConv2d(cin, cout, k, stride, padding)
    return nn.Conv2d(cin, cout, k, stride, padding)


def _run(layer: nn.Module, x: Tensor, update_stats: bool) -> Tensor:
    return layer(x, update_stats) if isinstance(layer, _SpectralNorm) else layer(x)


def _lrelu(x: Tensor) -> Tensor:
    return nn.functional.leaky_relu(x, 0.2)


def _double_conv(cin: int, cout: int) -> nn.Sequential:
    """The reference's ``Sequential(conv, LeakyReLU, conv, LeakyReLU)``."""
    return nn.Sequential(_conv(cin, cout, 3, padding=1), nn.LeakyReLU(0.2),
                         _conv(cout, cout, 3, padding=1), nn.LeakyReLU(0.2))


def _run_double(seq: nn.Sequential, x: Tensor, update_stats: bool) -> Tensor:
    return _lrelu(_run(seq[2], _lrelu(_run(seq[0], x, update_stats)), update_stats))


class _DownBlock(nn.Module):
    def __init__(self, cin: int, cout: int, downsample: bool):
        super().__init__()
        self.conv_res = _conv(cin, cout, 1, 2 if downsample else 1)
        self.net = _double_conv(cin, cout)
        self.down = _conv(cout, cout, 4, 2, 1) if downsample else None


class _UpBlock(nn.Module):
    def __init__(self, cin: int, cskip: int, cout: int):
        super().__init__()
        self.conv = _double_conv(cin + cskip, cout)
        self.shortcut = _conv(cin, cout, 1)


class UNetDiscriminator(nn.Module):
    """NCHW ``(N, C, H, W)``, H and W multiples of ``2^repeat_num`` ->
    ``(enc (N,), dec (N, 1, H, W))``."""

    def __init__(self, conv_dim: int = 64, repeat_num: int = 6, in_channels: int = 1):
        super().__init__()
        filters = [in_channels] + [min(conv_dim * 2 ** i, 512) for i in range(repeat_num + 1)]
        filters[-1] = filters[-2]
        pairs = list(zip(filters[:-1], filters[1:]))
        self.down_blocks = nn.ModuleList(
            [_DownBlock(cin, cout, i != len(pairs) - 1) for i, (cin, cout) in enumerate(pairs)])
        self.conv = _double_conv(filters[-1], filters[-1])
        # AdaptiveAvgPool2d(1) and Flatten hold no parameters: the linear
        # keeps the reference's index 3
        self.to_logit = nn.Sequential(nn.LeakyReLU(0.2), nn.Identity(), nn.Identity(),
                                      nn.Linear(filters[-1], 1))
        ups, u_ch = [], filters[-1]
        skips = [cout for _, cout in pairs[:-1]][::-1]
        for (cout, _), skip in zip(pairs[:-1][::-1], skips):
            ups.append(_UpBlock(u_ch, skip, cout))
            u_ch = cout
        self.up_blocks = nn.ModuleList(ups)
        self.conv_out = nn.Conv2d(u_ch, 1, 1)

    def forward(self, x: Tensor, update_stats: bool = True) -> Tuple[Tensor, Tensor]:
        # NCHW strides: an (N, 1, H, W) view of NHWC memory also reads as
        # channels_last, and on the CPU (torch 2.13) the backward of a 1x1
        # stride-2 conv in channels_last (``conv_res``) corrupts the heap
        h, residuals = x.contiguous().view(x.shape), []
        for blk in self.down_blocks:
            res = _run(blk.conv_res, h, update_stats)
            h = _run_double(blk.net, h, update_stats)
            residuals.append(h)
            if blk.down is not None:
                h = _run(blk.down, h, update_stats)
            h = h + res
        bottom = _run_double(self.conv, h, update_stats) + h
        enc = self.to_logit[3](_lrelu(bottom).mean(dim=(2, 3)))[:, 0]
        u = bottom
        for blk, skip in zip(self.up_blocks, residuals[:-1][::-1]):
            u = upsample2x_bilinear(u)
            p = _run_double(blk.conv, torch.cat([u, skip], 1), update_stats)
            u = p + _run(blk.shortcut, u, update_stats)
        return enc, self.conv_out(u)


def seeded_unet(conv_dim: int, repeat_num: int, generator: torch.Generator
                ) -> UNetDiscriminator:
    """A U-Net discriminator on the CPU with the reference init drawn from
    ``generator``: N(0, 0.01) weights and zero biases, then unit ``u`` /
    ``v`` vectors."""
    disc = normal_init_(UNetDiscriminator(conv_dim, repeat_num), INIT_STD, generator)
    with torch.no_grad():
        for _, buf in disc.named_buffers():
            buf.copy_(nn.functional.normalize(torch.randn(buf.shape, generator=generator),
                                              dim=0))
    return disc


def cutmix_mask(shape: Tuple[int, int, int, int], lam: Tensor, cx: Tensor, cy: Tensor
                ) -> Tensor:
    """The CutMix zero box (reference networks.py:132-145) as a function of
    its draws, each U(0, 1) (0-d float32 tensors): ``lam`` (Beta(1, 1)), the
    centre ``cx * w``, ``cy * h``; a box of ``sqrt(1 - lam)`` of each side,
    its edges rounded half to even and clipped to the image. NHWC ``shape``
    ``(n, h, w, c)``; 0 inside the box, 1 outside, float32."""
    n, h, w, c = shape
    cx, cy = cx * w, cy * h
    bw, bh = w * torch.sqrt(1.0 - lam), h * torch.sqrt(1.0 - lam)
    x0, x1 = torch.round((cx - bw / 2).clamp_min(0)), torch.round((cx + bw / 2).clamp_max(w))
    y0, y1 = torch.round((cy - bh / 2).clamp_min(0)), torch.round((cy + bh / 2).clamp_max(h))
    ys = torch.arange(h, dtype=torch.float32, device=lam.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=lam.device)[None, :]
    inside = (ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)
    mask = torch.where(inside, 0.0, 1.0)
    return mask[None, :, :, None].expand(shape)


def mask_src_tgt(source: Tensor, target: Tensor, mask: Tensor) -> Tensor:
    return source * mask + (1.0 - mask) * target


class CutMix(NamedTuple):
    """One domain loss's draws, each a 0-d U(0, 1) tensor: the box's
    ``lam``, ``cx`` and ``cy`` (:func:`cutmix_mask`) and the ``coin``; the
    CutMix terms count where ``coin >= 0.5``."""

    lam: Tensor
    cx: Tensor
    cy: Tensor
    coin: Tensor


def draw_cutmix(generator: Optional[torch.Generator], device: torch.device) -> CutMix:
    return CutMix(*torch.rand(4, generator=generator, device=device))


class DUGANModel:
    """Three networks: ``generator`` (REDCNN), ``image_discriminator`` and
    ``grad_discriminator`` (U-Nets), seeded from one generator in that
    order. ``device`` defaults to ``cuda`` and raises without a GPU."""

    name = "DU_GAN"
    n_d_tasks = 1

    def __init__(self, gen_features: int = 32, num_layers: int = 10, conv_dim: int = 64,
                 repeat_num: int = 6, device: DeviceLike = None, seed: int = 0):
        self.device = resolve_device(device)
        self.repeat_num = repeat_num
        init = torch.Generator().manual_seed(seed)
        gen = normal_init_(REDCNNGenerator(1, gen_features, num_layers), INIT_STD, init)
        self.generator = gen.to(self.device).eval()
        self.image_discriminator = seeded_unet(conv_dim, repeat_num, init).to(self.device)
        self.grad_discriminator = seeded_unet(conv_dim, repeat_num, init).to(self.device)

    def check_input(self, h: int, w: int) -> None:
        """The U-Nets halve a side ``repeat_num`` times: raise unless both
        sides are multiples of ``2^repeat_num``."""
        m = 2 ** self.repeat_num
        if h % m or w % m:
            raise ValueError(f"the DU-GAN discriminators take sides that are multiples "
                             f"of {m} (six 2x downsamplings), got {h}x{w}")

    @torch.no_grad()
    def generate(self, x: Tensor) -> Tensor:
        """``(N, H, W, 1)`` -> ``(N, H, W, 1)``."""
        return self.generator(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def train_forward(self, x: Tensor) -> Tensor:
        """``G(x)`` with its graph, for a train step."""
        return self.generator(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    @staticmethod
    def sobel(t: Tensor) -> Tensor:
        """The gradient domain of NHWC ``t`` (eps 1e-4)."""
        return sobel_magnitude(t.permute(0, 3, 1, 2), SOBEL_EPS).permute(0, 2, 3, 1)

    @staticmethod
    def _apply_d(disc: UNetDiscriminator, z: Tensor, update_stats: bool
                 ) -> Tuple[Tensor, Tensor]:
        enc, dec = disc(z.permute(0, 3, 1, 2), update_stats)
        return enc, dec.permute(0, 2, 3, 1)

    def _d_loss_domain(self, disc, real, fake, inp, update_stats, draws):
        """Four D forwards, each storing a power iteration where
        ``update_stats``: real, fake, the input (as fake) and the CutMix of
        real and fake. The mixed forward always runs (as in the JAX package,
        which gates only its loss), so the ``u`` cadence does not depend on
        the coin; the terms it gives count only where ``coin >= 0.5`` (zero
        gradient otherwise)."""
        real_enc, real_dec = self._apply_d(disc, real, update_stats)
        fake_enc, fake_dec = self._apply_d(disc, fake, update_stats)
        inp_enc, inp_dec = self._apply_d(disc, inp, update_stats)
        g = losses.ls_gan
        disc_loss = (g(real_enc, 1.0) + g(real_dec, 1.0) + g(fake_enc, 0.0)
                     + g(fake_dec, 0.0) + g(inp_enc, 0.0) + g(inp_dec, 0.0))
        mask = cutmix_mask(tuple(real_dec.shape), draws.lam, draws.cx, draws.cy)
        cm_enc, cm_dec = self._apply_d(disc, mask_src_tgt(real, fake, mask), update_stats)
        cutmix_loss = g(cm_enc, 0.0) + ((cm_dec - mask) ** 2).mean()
        cr_loss = losses.l2(cm_dec, mask_src_tgt(real_dec, fake_dec, mask))
        total = disc_loss + torch.where(draws.coin >= 0.5, cutmix_loss + cr_loss,
                                        torch.zeros_like(cutmix_loss))
        return total, {"disc_loss": disc_loss, "cutmix_loss": cutmix_loss,
                       "cr_loss": cr_loss}

    def image_d_loss(self, x: Tensor, y: Tensor, fake: Tensor, update_stats: bool = True,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[CutMix] = None
                     ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """The image D's loss on NHWC ``x``, ``y`` and ``fake = G(x)``
        (detached here); ``draws`` drawn from ``generator`` when ``None``."""
        draws = draw_cutmix(generator, self.device) if draws is None else draws
        total, det = self._d_loss_domain(self.image_discriminator, y, fake.detach(), x,
                                         update_stats, draws)
        return total, {f"D/Img_{k}": v for k, v in det.items()}

    def grad_d_loss(self, x: Tensor, y: Tensor, fake: Tensor, update_stats: bool = True,
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[CutMix] = None
                    ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """The gradient D's loss on the Sobel maps of ``y``, ``fake`` and
        ``x``."""
        draws = draw_cutmix(generator, self.device) if draws is None else draws
        total, det = self._d_loss_domain(self.grad_discriminator, self.sobel(y),
                                         self.sobel(fake.detach()), self.sobel(x),
                                         update_stats, draws)
        return total, {f"D/Grad_{k}": v for k, v in det.items()}

    def g_loss_terms(self, fake: Tensor, x: Tensor, y: Tensor, update_stats: bool = True
                     ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """The generator's loss given ``fake = G(x)`` (NHWC), one forward of
        each D (each storing a power iteration where ``update_stats``)."""
        ie, idec = self._apply_d(self.image_discriminator, fake, update_stats)
        sobel_fake = self.sobel(fake)
        ge, gdec = self._apply_d(self.grad_discriminator, sobel_fake, update_stats)
        g = losses.ls_gan
        adv = 0.1 * (g(ie, 1.0) + g(idec, 1.0)) + 0.1 * (g(ge, 1.0) + g(gdec, 1.0))
        pix = losses.l2(fake, y)
        grad = 20.0 * losses.l1(sobel_fake, self.sobel(y))
        return adv + pix + grad, {"G/adv_loss": adv, "G/pix_loss": pix, "G/grad_loss": grad}
