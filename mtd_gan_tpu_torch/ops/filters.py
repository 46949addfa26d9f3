"""Fixed filter banks (counterpart of ``mtd_gan_tpu/ops/filters.py``): the
EdgeLoss blur and detail layer (reference losses.py:113-138) and the
1/4-scaled Sobel gradient magnitude of MAP-NN and DU-GAN (reference
arch/MAP_NN/networks.py:139-159), on NCHW tensors, applied per channel."""

from __future__ import annotations

import torch
import torch.nn.functional as F

_BINOMIAL5 = (0.05, 0.25, 0.4, 0.25, 0.05)


def depthwise_conv2d(x: torch.Tensor, kernel2d: torch.Tensor, padding: int = 0) -> torch.Tensor:
    """One 2-D kernel applied to every channel of NCHW ``x`` (a
    cross-correlation, as ``lax.conv_general_dilated``), zero padding
    ``padding`` on each side."""
    c = x.shape[1]
    k = kernel2d.to(x.dtype).expand(c, 1, *kernel2d.shape)
    return F.conv2d(x, k, padding=padding, groups=c)


def sobel_magnitude(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``sqrt(gx^2 + gy^2 + eps)`` per channel, with the horizontal Sobel
    kernel scaled by 1/4 and its transpose, zero padding 1 (MAP-NN and DU-GAN
    call it with ``eps=1e-4``)."""
    h = torch.tensor([[1.0, 0.0, -1.0], [2.0, 0.0, -2.0], [1.0, 0.0, -1.0]],
                     device=x.device) / 4.0
    gx = depthwise_conv2d(x, h, padding=1)
    gy = depthwise_conv2d(x, h.t(), padding=1)
    return torch.sqrt(gx * gx + gy * gy + eps)


def gauss_blur5(x: torch.Tensor) -> torch.Tensor:
    """Edge-replicate pad by 2, then the 5x5 binomial blur."""
    k = torch.tensor(_BINOMIAL5, dtype=x.dtype, device=x.device)
    return depthwise_conv2d(F.pad(x, (2, 2, 2, 2), mode="replicate"), torch.outer(k, k))


def laplacian_detail(x: torch.Tensor) -> torch.Tensor:
    """``x - blur(zero_stuff(blur(x)[::2, ::2] * 4))``: the even pixels of
    the blurred image, zero-stuffed back to full size, re-blurred."""
    filtered = gauss_blur5(x)
    stuffed = torch.zeros_like(filtered)
    stuffed[:, :, ::2, ::2] = filtered[:, :, ::2, ::2] * 4.0
    return x - gauss_blur5(stuffed)
