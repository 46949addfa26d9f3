"""Unfold / Fold, im2col and its adjoint (counterpart of
``mtd_gan_tpu/ops/unfold.py``): the CTformer tokenizer's soft splits
(reference arch/CTformer/networks.py:44-47 use ``nn.Unfold`` / ``nn.Fold``
with stride and dilation). These are torch's ``F.unfold`` / ``F.fold`` on
NCHW tensors: features ordered channel-major ``(c, kh, kw)``, positions
row-major; ``fold`` sums overlapping contributions. No padding."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def unfold(x: Tensor, kernel: Tuple[int, int], stride: Tuple[int, int] = (1, 1),
           dilation: Tuple[int, int] = (1, 1)) -> Tensor:
    """NCHW ``(B, C, H, W)`` -> ``(B, C * kh * kw, L)``."""
    return F.unfold(x, kernel, dilation=dilation, stride=stride)


def fold(patches: Tensor, output_size: Tuple[int, int], kernel: Tuple[int, int],
         stride: Tuple[int, int] = (1, 1), dilation: Tuple[int, int] = (1, 1)) -> Tensor:
    """``(B, C * kh * kw, L)`` -> NCHW ``(B, C, H, W)``."""
    return F.fold(patches, output_size, kernel, dilation=dilation, stride=stride)
