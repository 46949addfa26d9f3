"""The diffusion UNet with its timestep embedding and self-attention
(counterpart of ``mtd_gan_tpu/models/diffusion/unet.py``; reference MONAI
``DiffusionModelUNet`` at the wrappers' configuration, networks.py:16-22:
in 2 (noisy sample + condition), out 1, channels (128, 256, 256),
attention at levels (F, T, T), one res block per level, 256 head
channels, GroupNorm(32)).

NCHW inside. conv_in 3x3 -> per level: ResnetBlock (+ attention), a
stride-2 3x3 conv (flax ``padding=1``) but at the last level -> middle:
ResnetBlock, attention, ResnetBlock -> per level, reversed: the skip
concatenated after ``h`` on the channel axis, ResnetBlock (+ attention),
num_res_blocks + 1 times, then a 2x nearest resize and a 3x3 conv but at
level 0 -> GroupNorm, SiLU, 3x3 conv. ResnetBlock: GN -> SiLU -> conv3x3
-> + time projection -> GN -> SiLU -> conv3x3 -> + skip (1x1 conv where
the channels change). Every GroupNorm has epsilon 1e-6. The timestep
embedding is the DDPM sinusoid, cos before sin, then a two-layer MLP
(ch[0] -> 4 ch[0]).

The modules carry the flax module names of the JAX package (``time_fc1``,
``conv_in``, ``down{l}_res{r}.norm1``, ``down{l}_attn{r}.to_q``,
``mid_attn``, ``up{u}_res{r}``, ``up{u}_upsample``, ``out_norm``,
``out_conv``, ...), so a flax tree carries over by a rename and a
transpose (``utils/torch_import.py``). Init: flax's defaults (LeCun
normal kernels, zero biases, GroupNorm 1 and 0), ``conv2`` and
``out_conv`` zero, drawn from the model's seed: a fresh UNet outputs 0.

Attention: the JAX package computes it in plain ``jnp`` (no Pallas
kernel): dense softmax attention up to 4096 tokens, exact attention over
query chunks of 2048 above (a 512x512 input puts 65,536 tokens at level
1, whose dense score matrix would take 17 GB). The block computes the same
on every device (:func:`attention_plain`), cuBLAS products on the card.

``dtype`` (``--bf16``) follows the JAX module (``unet.py:52-177``), whose
layers are flax's: the convs take ``dtype`` and compute in it; the
GroupNorms and the linears have none, and flax's promotion of a bf16 input
with fp32 parameters runs them in fp32, so they run on the widened input
here (the statistics, the attention and the timestep embedding fp32); the
time projection is cast to the conv output's type before the add; the
sums follow their operands' promotion, as ``jnp``'s do.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mtd_gan_tpu_torch.ops.layers import Conv2d, widen

Tensor = torch.Tensor
GN_EPS = 1e-6
DENSE_MAX_TOKENS = 4096
QUERY_CHUNK = 2048


def timestep_embedding(t: Tensor, dim: int, max_period: float = 10000.0) -> Tensor:
    """``(N, dim)``: cos then sin of t times the geometric frequencies."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    return F.pad(emb, (0, 1)) if dim % 2 == 1 else emb


class _GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` on the input widened to fp32 (flax's GroupNorm with
    no dtype on a bf16 input), fp32 out (float64 stays float64)."""

    def forward(self, x: Tensor) -> Tensor:
        return super().forward(widen(x))


def _group_norm(groups: int, channels: int) -> nn.GroupNorm:
    return _GroupNorm(groups, channels, eps=GN_EPS)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_dim: int,
                 norm_groups: int = 32, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm1 = _group_norm(norm_groups, in_channels)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1, dtype=dtype)
        self.time_emb_proj = nn.Linear(temb_dim, out_channels)
        self.norm2 = _group_norm(norm_groups, out_channels)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1, dtype=dtype)
        self.skip_connection = (Conv2d(in_channels, out_channels, 1, dtype=dtype)
                                if in_channels != out_channels else None)

    def forward(self, x: Tensor, temb: Tensor) -> Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None].to(h.dtype)
        h = self.conv2(F.silu(self.norm2(h)))
        if self.skip_connection is not None:
            x = self.skip_connection(x)
        return x + h


def attention_plain(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Softmax attention over ``(B, heads, seq, hd)`` as the JAX package
    computes it: dense up to DENSE_MAX_TOKENS, else exact over query chunks
    of QUERY_CHUNK (the score matrix of one chunk at a time)."""
    scale = q.shape[-1] ** -0.5
    dense = lambda qb: torch.softmax((qb @ k.transpose(-2, -1)) * scale, dim=-1) @ v
    if q.shape[2] <= DENSE_MAX_TOKENS:
        return dense(q)
    return torch.cat([dense(qb) for qb in q.split(QUERY_CHUNK, dim=2)], dim=2)


class AttentionBlock(nn.Module):
    """GroupNorm, q / k / v projections, softmax attention with
    ``max(C // num_head_channels, 1)`` heads, the output projection and the
    residual."""

    def __init__(self, channels: int, num_head_channels: int = 256, norm_groups: int = 32):
        super().__init__()
        self.heads = max(channels // num_head_channels, 1)
        self.norm = _group_norm(norm_groups, channels)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.proj_attn = nn.Linear(channels, channels)

    def forward(self, x: Tensor) -> Tensor:
        b, c, hh, ww = x.shape
        h = self.norm(x).reshape(b, c, hh * ww).transpose(1, 2)  # (B, seq, C)
        split = lambda z: z.reshape(b, hh * ww, self.heads, c // self.heads).transpose(1, 2)
        q, k, v = split(self.to_q(h)), split(self.to_k(h)), split(self.to_v(h))
        out = attention_plain(q, k, v)
        out = self.proj_attn(out.transpose(1, 2).reshape(b, hh * ww, c))
        return x + out.transpose(1, 2).reshape(b, c, hh, ww)


class DiffusionUNet(nn.Module):
    """``(N, in_channels, H, W)``, ``t`` (N,) -> ``(N, out_channels, H,
    W)``; H and W multiples of 2^(len(channels) - 1)."""

    def __init__(self, in_channels: int = 2, out_channels: int = 1,
                 channels: Sequence[int] = (128, 256, 256),
                 attention_levels: Sequence[bool] = (False, True, True),
                 num_res_blocks: int = 1, num_head_channels: int = 256,
                 norm_groups: int = 32, dtype: Optional[torch.dtype] = None):
        super().__init__()
        ch = tuple(channels)
        self.channels, self.attention_levels = ch, tuple(attention_levels)
        self.num_res_blocks = num_res_blocks
        temb_dim = ch[0] * 4
        self.time_fc1 = nn.Linear(ch[0], temb_dim)
        self.time_fc2 = nn.Linear(temb_dim, temb_dim)
        self.conv_in = Conv2d(in_channels, ch[0], 3, padding=1, dtype=dtype)
        res = lambda c_in, c_out: ResnetBlock(c_in, c_out, temb_dim, norm_groups, dtype)
        attn = lambda c: AttentionBlock(c, num_head_channels, norm_groups)
        cur, skips = ch[0], [ch[0]]
        for li, c in enumerate(ch):
            for ri in range(num_res_blocks):
                setattr(self, f"down{li}_res{ri}", res(cur, c))
                cur = c
                if self.attention_levels[li]:
                    setattr(self, f"down{li}_attn{ri}", attn(c))
                skips.append(c)
            if li != len(ch) - 1:
                setattr(self, f"down{li}_downsample",
                        Conv2d(c, c, 3, stride=2, padding=1, dtype=dtype))
                skips.append(c)
        self.mid_res1 = res(cur, ch[-1])
        self.mid_attn = attn(ch[-1])
        self.mid_res2 = res(ch[-1], ch[-1])
        cur = ch[-1]
        for ui, li in enumerate(reversed(range(len(ch)))):
            c = ch[li]
            for ri in range(num_res_blocks + 1):
                setattr(self, f"up{ui}_res{ri}", res(cur + skips.pop(), c))
                cur = c
                if self.attention_levels[li]:
                    setattr(self, f"up{ui}_attn{ri}", attn(c))
            if li != 0:
                setattr(self, f"up{ui}_upsample", Conv2d(c, c, 3, padding=1, dtype=dtype))
        self.out_norm = _group_norm(norm_groups, cur)
        self.out_conv = Conv2d(cur, out_channels, 3, padding=1, dtype=dtype)

    def forward(self, x: Tensor, t: Tensor) -> Tensor:
        ch, n_res = self.channels, self.num_res_blocks
        temb = timestep_embedding(t, ch[0])
        temb = self.time_fc2(F.silu(self.time_fc1(temb)))
        h = self.conv_in(x)
        skips = [h]
        for li in range(len(ch)):
            for ri in range(n_res):
                h = getattr(self, f"down{li}_res{ri}")(h, temb)
                if self.attention_levels[li]:
                    h = getattr(self, f"down{li}_attn{ri}")(h)
                skips.append(h)
            if li != len(ch) - 1:
                h = getattr(self, f"down{li}_downsample")(h)
                skips.append(h)
        h = self.mid_res2(self.mid_attn(self.mid_res1(h, temb)), temb)
        for ui, li in enumerate(reversed(range(len(ch)))):
            for ri in range(n_res + 1):
                h = getattr(self, f"up{ui}_res{ri}")(torch.cat([h, skips.pop()], dim=1), temb)
                if self.attention_levels[li]:
                    h = getattr(self, f"up{ui}_attn{ri}")(h)
            if li != 0:
                h = getattr(self, f"up{ui}_upsample")(
                    F.interpolate(h, scale_factor=2, mode="nearest"))
        return self.out_conv(F.silu(self.out_norm(h)))


def unet_init_(net: DiffusionUNet, generator: torch.Generator) -> DiffusionUNet:
    """flax's default init drawn from ``generator`` in ``net.modules()``
    order: conv and linear weights LeCun normal (a normal truncated at two
    standard deviations, std sqrt(1 / fan_in) / 0.8796), biases zero,
    GroupNorm 1 and 0; every ``conv2`` and ``out_conv`` zero."""
    zero = {id(net.out_conv)} | {id(m.conv2) for m in net.modules()
                                 if isinstance(m, ResnetBlock)}
    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            with torch.no_grad():
                if id(m) in zero:
                    m.weight.zero_()
                else:
                    std = (m.weight[0].numel() ** -0.5) / 0.87962566103423978
                    nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                          generator=generator)
                m.bias.zero_()
    return net
