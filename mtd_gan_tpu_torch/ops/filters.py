"""The EdgeLoss filter bank (counterpart of ``gauss_blur5`` and
``laplacian_detail`` in ``mtd_gan_tpu/ops/filters.py``; reference
losses.py:113-138), on NCHW tensors, applied per channel."""

from __future__ import annotations

import torch
import torch.nn.functional as F

_BINOMIAL5 = (0.05, 0.25, 0.4, 0.25, 0.05)


def gauss_blur5(x: torch.Tensor) -> torch.Tensor:
    """Edge-replicate pad by 2, then the 5x5 binomial blur."""
    c = x.shape[1]
    k = torch.tensor(_BINOMIAL5, dtype=x.dtype, device=x.device)
    k2 = torch.outer(k, k).expand(c, 1, 5, 5)
    return F.conv2d(F.pad(x, (2, 2, 2, 2), mode="replicate"), k2, groups=c)


def laplacian_detail(x: torch.Tensor) -> torch.Tensor:
    """``x - blur(zero_stuff(blur(x)[::2, ::2] * 4))``: the even pixels of
    the blurred image, zero-stuffed back to full size, re-blurred."""
    filtered = gauss_blur5(x)
    stuffed = torch.zeros_like(filtered)
    stuffed[:, :, ::2, ::2] = filtered[:, :, ::2, ::2] * 4.0
    return x - gauss_blur5(stuffed)
