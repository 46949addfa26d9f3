"""CTformer, the convolution-free token-to-token transformer denoiser
(counterpart of ``mtd_gan_tpu/models/ctformer.py``; reference
arch/CTformer/networks.py, token_performer.py, T2T_transformer_block.py;
the published configuration img 64, tokens ``performer``, embed 64, depth
1, heads 8, mlp_ratio 2, token_dim 64, models.py:29).

Geometry at 64x64: unfold 7/2 -> 29^2 tokens of 49 -> performer (-> 64)
-> roll (2, 2) -> unfold 3, dilation 2 -> 25^2 tokens of 576 -> performer
(-> 64) -> roll -> unfold 3 -> 23^2 tokens of 576 -> linear (-> 64); the
sinusoid position table; the transformer blocks; the mirrored decoder with
folds, the token residual adds and the inverse rolls; the output is ``x -
decoded`` (residual prediction).

The performer's kernel attention uses the positive random features
``exp(w^T x - |x|^2 / 2) / sqrt(m)``, ``m = emb / 2``, with a fixed
orthogonal ``w`` scaled by ``sqrt(m)`` (token_performer.py:26-37). The
reference keeps ``w`` as a ``requires_grad=False`` parameter; here it is a
persistent buffer under the same key, so it is in the state dict and in no
optimizer, and takes neither gradient nor decay (the JAX
``trainable_mask``). Its default draw is the port's own, from the model's
seed; weights carried from the JAX package or a reference checkpoint bring
theirs.

LayerNorm epsilon 1e-6, flax's default, which the JAX package takes; the
reference's ``nn.LayerNorm`` has 1e-5 (ROADMAP.md queue 3). Dropout 0.1 in
training, its masks drawn from an explicit ``torch.Generator``. State-dict
names are the reference's, those ``convert_ctformer`` of the JAX package
reads (``tokens_to_token.attention1`` ..., ``blocks.{i}``, ``norm``,
``dconv1.*``); the reference's unused ``cls_token`` / ``head`` and its
fixed ``pos_embed`` (rebuilt from its formula) are not built. Nothing here
reaches a Pallas kernel in the JAX package. The model's functions take
NHWC ``(N, 64, 64, 1)``; the modules NCHW and tokens ``(B, T, C)``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mtd_gan_tpu_torch import losses
from mtd_gan_tpu_torch._device import DeviceLike
from mtd_gan_tpu_torch.models.base import SupervisedModel
from mtd_gan_tpu_torch.ops.unfold import fold, unfold

Tensor = torch.Tensor
LN_EPS = 1e-6
TRUNC_STD = 0.02


def sinusoid_encoding(n_position: int, d_hid: int) -> np.ndarray:
    """``(1, n_position, d_hid)`` sin / cos table (T2T_transformer_block
    ``get_sinusoid_encoding``)."""
    pos = np.arange(n_position)[:, None]
    dim = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000, 2 * (dim // 2) / d_hid)
    table = np.zeros((n_position, d_hid), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table[None]


def dropout(x: Tensor, p: float, train: bool, generator: Optional[torch.Generator]
            ) -> Tensor:
    """Inverted dropout whose mask is drawn from ``generator``."""
    if not train or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep / (1.0 - p)


class TokenPerformer(nn.Module):
    """The FAVOR+ T2T unit (token_performer.py:8-60): ``(B, T, dim)`` ->
    ``(B, T, in_dim)``."""

    def __init__(self, dim: int, in_dim: int, kernel_ratio: float = 0.5,
                 dropout_rate: float = 0.1):
        super().__init__()
        emb = in_dim
        self.emb, self.m, self.dropout_rate = emb, int(emb * kernel_ratio), dropout_rate
        self.kqv = nn.Linear(dim, 3 * emb)
        self.proj = nn.Linear(emb, emb)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(emb, eps=LN_EPS)
        self.mlp = nn.Sequential(nn.Linear(emb, emb), nn.GELU(), nn.Linear(emb, emb))
        self.register_buffer("w", torch.zeros(self.m, emb))

    def draw_w(self, generator: torch.Generator) -> None:
        """``w``: the first ``m`` rows of a random orthogonal ``emb x emb``
        matrix (QR of a normal draw, signs fixed by R's diagonal) times
        ``sqrt(m)``."""
        q, r = torch.linalg.qr(torch.randn(self.emb, self.emb, generator=generator))
        q = q * torch.sign(torch.diagonal(r))
        with torch.no_grad():
            self.w.copy_(q[:self.m] * self.m ** 0.5)

    def _prm_exp(self, z: Tensor) -> Tensor:
        zd = (z * z).sum(-1, keepdim=True) / 2.0
        return torch.exp(z @ self.w.t() - zd) / self.m ** 0.5

    def forward(self, x: Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        k, q, v = self.kqv(self.norm1(x)).split(self.emb, dim=-1)
        kp, qp = self._prm_exp(k), self._prm_exp(q)
        d = qp @ kp.sum(1)[:, :, None]                      # (B, T, 1)
        kptv = torch.einsum("btd,btm->bdm", v, kp)
        y = torch.einsum("btm,bdm->btd", qp, kptv) / (d + 1e-8)
        y = v + dropout(self.proj(y), self.dropout_rate, train, generator)
        h = self.mlp(self.norm2(y))
        return y + dropout(h, self.dropout_rate, train, generator)


class _Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.proj = nn.Linear(dim, dim)


class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class TransformerBlock(nn.Module):
    """Pre-norm ViT block (T2T_transformer_block.py:99-115), ``(B, T, C)``."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 2.0,
                 dropout_rate: float = 0.1, attn_dropout: float = 0.1):
        super().__init__()
        self.num_heads, self.dropout_rate, self.attn_dropout = (num_heads, dropout_rate,
                                                                 attn_dropout)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = _Attention(dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = _MLP(dim, int(dim * mlp_ratio))

    def forward(self, x: Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        b, t, c = x.shape
        hd = c // self.num_heads
        drop = lambda z, p: dropout(z, p, train, generator)
        qkv = self.attn.qkv(self.norm1(x)).reshape(b, t, 3, self.num_heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        attn = torch.softmax((q @ k.transpose(-2, -1)) * hd ** -0.5, dim=-1)
        y = (drop(attn, self.attn_dropout) @ v).transpose(1, 2).reshape(b, t, c)
        x = x + drop(self.attn.proj(y), self.dropout_rate)
        h = drop(F.gelu(self.mlp.fc1(self.norm2(x))), self.dropout_rate)
        return x + drop(self.mlp.fc2(h), self.dropout_rate)


def _to_grid(t: Tensor) -> Tensor:
    """Tokens ``(B, T, C)`` -> NCHW ``(B, C, s, s)``, ``s = sqrt(T)``."""
    b, n, c = t.shape
    s = int(round(n ** 0.5))
    return t.transpose(1, 2).reshape(b, c, s, s)


def _to_tokens(g: Tensor) -> Tensor:
    return g.flatten(2).transpose(1, 2)


class _T2TEncoder(nn.Module):
    def __init__(self, in_chans: int, token_dim: int, embed_dim: int, dropout_rate: float):
        super().__init__()
        self.attention1 = TokenPerformer(in_chans * 49, token_dim, dropout_rate=dropout_rate)
        self.attention2 = TokenPerformer(token_dim * 9, token_dim, dropout_rate=dropout_rate)
        self.project = nn.Linear(token_dim * 9, embed_dim)


class _T2TDecoder(nn.Module):
    def __init__(self, in_chans: int, token_dim: int, embed_dim: int, dropout_rate: float):
        super().__init__()
        self.project = nn.Linear(embed_dim, token_dim * 9)
        self.attention2 = TokenPerformer(token_dim, token_dim * 9, dropout_rate=dropout_rate)
        self.attention1 = TokenPerformer(token_dim, in_chans * 49, dropout_rate=dropout_rate)


class CTformer(nn.Module):
    """NCHW ``(N, 1, img_size, img_size)`` in and out."""

    def __init__(self, img_size: int = 64, embed_dim: int = 64, token_dim: int = 64,
                 depth: int = 1, num_heads: int = 8, mlp_ratio: float = 2.0,
                 dropout_rate: float = 0.1, in_chans: int = 1):
        super().__init__()
        self.img_size, self.dropout_rate = img_size, dropout_rate
        s29 = (img_size - 7) // 2 + 1
        self.sizes = (s29, s29 - 4, s29 - 6)  # 29, 25, 23 at 64
        self.tokens_to_token = _T2TEncoder(in_chans, token_dim, embed_dim, dropout_rate)
        self.blocks = nn.ModuleList([TransformerBlock(embed_dim, num_heads, mlp_ratio,
                                                      dropout_rate, dropout_rate)
                                     for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.dconv1 = _T2TDecoder(in_chans, token_dim, embed_dim, dropout_rate)
        pos = sinusoid_encoding(self.sizes[2] ** 2, embed_dim)
        self.register_buffer("pos_table", torch.from_numpy(pos), persistent=False)

    def forward(self, x: Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        if tuple(x.shape[2:]) != (self.img_size, self.img_size):
            raise ValueError(
                f"CTformer takes {self.img_size}x{self.img_size} inputs (its folds "
                f"rebuild that size), got {tuple(x.shape[2:])}: train it on 64x64 patches "
                f"and run whole slices through the sliding window")
        enc, dec = self.tokens_to_token, self.dconv1
        s29, s25, _ = self.sizes
        roll = lambda g, k: torch.roll(g, (k, k), dims=(2, 3))
        t = enc.attention1(unfold(x, (7, 7), stride=(2, 2)).transpose(1, 2), train, generator)
        res_11 = t
        t = unfold(roll(_to_grid(t), 2), (3, 3), dilation=(2, 2))
        t = enc.attention2(t.transpose(1, 2), train, generator)
        res_22 = t
        t = enc.project(unfold(roll(_to_grid(t), 2), (3, 3)).transpose(1, 2))
        t = dropout(t + self.pos_table, self.dropout_rate, train, generator)
        for blk in self.blocks:
            t = blk(t, train, generator)
        t = dec.project(self.norm(t))
        g = roll(fold(t.transpose(1, 2), (s25, s25), (3, 3)), -2)
        t = dec.attention2(_to_tokens(g) + res_22, train, generator)
        g = roll(fold(t.transpose(1, 2), (s29, s29), (3, 3), dilation=(2, 2)), -2)
        t = dec.attention1(_to_tokens(g) + res_11, train, generator)
        return x - fold(t.transpose(1, 2), (self.img_size, self.img_size), (7, 7),
                        stride=(2, 2))


def ctformer_init_(net: CTformer, generator: torch.Generator) -> CTformer:
    """Truncated N(0, 0.02^2) (at 2 sigma) linear weights, zero biases, unit
    LayerNorms, then each performer's ``w``, drawn in ``net.modules()``
    order."""
    for m in net.modules():
        if isinstance(m, nn.Linear):
            nn.init.trunc_normal_(m.weight, std=TRUNC_STD, a=-2 * TRUNC_STD, b=2 * TRUNC_STD,
                                  generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, TokenPerformer):
            m.draw_w(generator)
    return net


class CTformerModel(SupervisedModel):
    """CTformer at the published configuration; the loss is ``100 * MSE +
    1e-4`` (reference engine.py:319; details ``loss`` and ``mse``), with
    dropout 0.1 drawn from the caller's generator. ``predict`` runs in
    eval (no dropout)."""

    def __init__(self, img_size: int = 64, embed_dim: int = 64, depth: int = 1,
                 num_heads: int = 8, mlp_ratio: float = 2.0, token_dim: int = 64,
                 dropout_rate: float = 0.1, device: DeviceLike = None, seed: int = 0):
        super().__init__(CTformer(img_size, embed_dim, token_dim, depth, num_heads,
                                  mlp_ratio, dropout_rate), device, seed, ctformer_init_)

    def apply(self, x: Tensor, train: bool = False,
              generator: Optional[torch.Generator] = None) -> Tensor:
        return self.net(x.permute(0, 3, 1, 2), train, generator).permute(0, 2, 3, 1)

    def loss(self, x: Tensor, y: Tensor, generator: Optional[torch.Generator] = None
             ) -> Tuple[Tensor, Dict[str, Tensor]]:
        val = losses.l2(self.apply(x, True, generator), y)
        scaled = val * 100.0 + 1e-4
        return scaled, {"loss": scaled, "mse": val}
