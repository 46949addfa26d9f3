"""Restormer, the efficient transformer for high-resolution restoration
(counterpart of ``mtd_gan_tpu/models/restormer.py``; reference
arch/Restormer/networks.py, the configuration dim 48, blocks (4, 6, 6, 8),
heads (1, 2, 4, 8), ffn 2.66, bias-free LayerNorm, 4 refinement blocks,
models.py:31).

* ``MDTA`` (:99-130): 1x1 qkv conv and its depthwise 3x3, q and k
  L2-normalised over the pixel axis, the (c x c) channel attention scaled
  by a learnable per-head ``temperature``.
* ``GDFN`` (:76-93): 1x1 expansion to 2 x hidden, depthwise 3x3, the
  exact-GELU gate ``gelu(x1) * x2``, 1x1 back.
* ``ChannelLayerNorm``: LayerNorm over the channels of each pixel; the
  bias-free variant divides by the standard deviation and keeps the mean
  (eps 1e-5), under the reference's ``norm{1,2}.body``.
* A 4-level U-Net with ``PixelUnshuffle`` / ``PixelShuffle`` resizing,
  skip concat and 1x1 reduction (levels 3 and 2), refinement blocks and a
  residual output (:191-283). Loss: L1 (:242).

No biases (``use_bias=False``, the published setting), torch's default
conv init drawn from the model's seed, ``temperature`` and the LayerNorm
weights at 1. State-dict names are the reference's, those
``convert_restormer`` of the JAX package reads (``patch_embed.proj``,
``encoder_level{1,2,3}.{i}``, ``latent``, ``decoder_level{3,2,1}``,
``refinement``, ``down1_2.body.0`` ..., ``reduce_chan_level{3,2}``,
``output``). Nothing here reaches a Pallas kernel in the JAX package. The
model's functions take NHWC ``(N, H, W, 1)`` with H and W multiples of 8;
the modules NCHW.

``dtype`` (``--bf16``): every conv computes in it, as the JAX module's; the
attention, the gate and the residual sums follow their inputs; the
LayerNorm takes its statistics in fp32 and rounds them to its input's
type, as ``jnp.var`` / ``jnp.mean`` do on a bf16 input; the output, the
last conv plus the fp32 input, is fp32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mtd_gan_tpu_torch import losses
from mtd_gan_tpu_torch._device import DeviceLike
from mtd_gan_tpu_torch.models.base import SupervisedModel
from mtd_gan_tpu_torch.ops.layers import Conv2d, torch_init_, widen

Tensor = torch.Tensor
LN_EPS = 1e-5


class _Norm(nn.Module):
    """``ChannelLayerNorm`` at ``body``: over dim 1 of NCHW."""

    def __init__(self, dim: int, bias_free: bool = True):
        super().__init__()
        self.body = ChannelLayerNorm(dim, bias_free)

    def forward(self, x: Tensor) -> Tensor:
        return self.body(x)


class ChannelLayerNorm(nn.Module):
    def __init__(self, dim: int, bias_free: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = None if bias_free else nn.Parameter(torch.zeros(dim))

    def forward(self, x: Tensor) -> Tensor:
        d = x.dtype
        var = widen(x).var(dim=1, keepdim=True, unbiased=False).to(d)
        w = self.weight.to(d)[:, None, None]
        if self.bias is None:
            return x / torch.sqrt(var + LN_EPS) * w
        mu = widen(x).mean(dim=1, keepdim=True).to(d)
        return (x - mu) / torch.sqrt(var + LN_EPS) * w + self.bias.to(d)[:, None, None]


class MDTA(nn.Module):
    def __init__(self, dim: int, num_heads: int, bias: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = Conv2d(dim, 3 * dim, 1, bias=bias, dtype=dtype)
        self.qkv_dwconv = Conv2d(3 * dim, 3 * dim, 3, padding=1, groups=3 * dim,
                                 bias=bias, dtype=dtype)
        self.project_out = Conv2d(dim, dim, 1, bias=bias, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        b, c, h, w = x.shape
        q, k, v = self.qkv_dwconv(self.qkv(x)).chunk(3, dim=1)
        heads = lambda z: z.reshape(b, self.num_heads, c // self.num_heads, h * w)
        q, k, v = heads(q), heads(k), heads(v)
        q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
        k = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-12)
        attn = torch.softmax((q @ k.transpose(-2, -1)) * self.temperature.to(q.dtype),
                             dim=-1)
        return self.project_out((attn @ v).reshape(b, c, h, w))


class GDFN(nn.Module):
    def __init__(self, dim: int, expansion: float = 2.66, bias: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        hidden = int(dim * expansion)
        self.project_in = Conv2d(dim, 2 * hidden, 1, bias=bias, dtype=dtype)
        self.dwconv = Conv2d(2 * hidden, 2 * hidden, 3, padding=1, groups=2 * hidden,
                             bias=bias, dtype=dtype)
        self.project_out = Conv2d(hidden, dim, 1, bias=bias, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        x1, x2 = self.dwconv(self.project_in(x)).chunk(2, dim=1)
        return self.project_out(F.gelu(x1) * x2)


class RestormerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, expansion: float = 2.66,
                 bias: bool = False, bias_free_ln: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm1 = _Norm(dim, bias_free_ln)
        self.attn = MDTA(dim, num_heads, bias, dtype)
        self.norm2 = _Norm(dim, bias_free_ln)
        self.ffn = GDFN(dim, expansion, bias, dtype)

    def forward(self, x: Tensor) -> Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class _Resample(nn.Module):
    """The reference's Downsample / Upsample: ``body`` = (3x3 conv, pixel
    unshuffle or shuffle)."""

    def __init__(self, n_feat: int, down: bool, dtype: Optional[torch.dtype] = None):
        super().__init__()
        out = n_feat // 2 if down else n_feat * 2
        self.body = nn.Sequential(Conv2d(n_feat, out, 3, padding=1, bias=False, dtype=dtype),
                                  nn.PixelUnshuffle(2) if down else nn.PixelShuffle(2))

    def forward(self, x: Tensor) -> Tensor:
        return self.body(x)


class _PatchEmbed(nn.Module):
    def __init__(self, in_c: int, dim: int, bias: bool, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.proj = Conv2d(in_c, dim, 3, padding=1, bias=bias, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        return self.proj(x)


class Restormer(nn.Module):
    """NCHW in and out, H and W multiples of 8."""

    def __init__(self, inp_channels: int = 1, out_channels: int = 1, dim: int = 48,
                 num_blocks: Sequence[int] = (4, 6, 6, 8), num_refinement_blocks: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8), expansion: float = 2.66,
                 bias: bool = False, bias_free_ln: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        d = dim
        stage = lambda n, width, h: nn.Sequential(
            *[RestormerBlock(width, h, expansion, bias, bias_free_ln, dtype)
              for _ in range(n)])
        self.patch_embed = _PatchEmbed(inp_channels, d, False, dtype)
        self.encoder_level1 = stage(num_blocks[0], d, heads[0])
        self.down1_2 = _Resample(d, down=True, dtype=dtype)
        self.encoder_level2 = stage(num_blocks[1], d * 2, heads[1])
        self.down2_3 = _Resample(d * 2, down=True, dtype=dtype)
        self.encoder_level3 = stage(num_blocks[2], d * 4, heads[2])
        self.down3_4 = _Resample(d * 4, down=True, dtype=dtype)
        self.latent = stage(num_blocks[3], d * 8, heads[3])
        self.up4_3 = _Resample(d * 8, down=False, dtype=dtype)
        self.reduce_chan_level3 = Conv2d(d * 8, d * 4, 1, bias=bias, dtype=dtype)
        self.decoder_level3 = stage(num_blocks[2], d * 4, heads[2])
        self.up3_2 = _Resample(d * 4, down=False, dtype=dtype)
        self.reduce_chan_level2 = Conv2d(d * 4, d * 2, 1, bias=bias, dtype=dtype)
        self.decoder_level2 = stage(num_blocks[1], d * 2, heads[1])
        self.up2_1 = _Resample(d * 2, down=False, dtype=dtype)
        self.decoder_level1 = stage(num_blocks[0], d * 2, heads[0])
        self.refinement = stage(num_refinement_blocks, d * 2, heads[0])
        self.output = Conv2d(d * 2, out_channels, 3, padding=1, bias=bias, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        e1 = self.encoder_level1(self.patch_embed(x))
        e2 = self.encoder_level2(self.down1_2(e1))
        e3 = self.encoder_level3(self.down2_3(e2))
        h = self.latent(self.down3_4(e3))
        h = self.decoder_level3(self.reduce_chan_level3(torch.cat([self.up4_3(h), e3], 1)))
        h = self.decoder_level2(self.reduce_chan_level2(torch.cat([self.up3_2(h), e2], 1)))
        h = self.decoder_level1(torch.cat([self.up2_1(h), e1], 1))  # no reduction
        return self.output(self.refinement(h)) + x


class RestormerModel(SupervisedModel):
    """Restormer (keyword arguments those of :class:`Restormer`) with the L1
    loss."""

    criterion = staticmethod(losses.l1)

    def __init__(self, device: DeviceLike = None, seed: int = 0,
                 dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(Restormer(dtype=dtype, **kwargs), device, seed, torch_init_)
        self.dtype = dtype
