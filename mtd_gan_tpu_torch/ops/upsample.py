"""Exact 2x bilinear upsampling with half-pixel centres (counterpart of
``mtd_gan_tpu/ops/upsample.py::upsample2x_bilinear``).

In 1-D, output 2k sits at source coordinate k - 1/4 and 2k+1 at k + 1/4:
``y[2k] = 0.75 x[k] + 0.25 x[k-1]``, ``y[2k+1] = 0.75 x[k] + 0.25 x[k+1]``,
edge-clamped. That is ``F.interpolate(scale_factor=2, mode="bilinear",
align_corners=False)``, the reference's ``nn.Upsample``; it is written, as
in the JAX package, as shifted adds and an interleave: PyTorch's bilinear
kernel (``upsample_bilinear2d_out_frame``) took a quarter of the train
step on an H100 (PERF.md, "Where the time goes").
"""

from __future__ import annotations

import torch


def _up2(x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    y = torch.stack([0.75 * x + 0.25 * prev, 0.75 * x + 0.25 * nxt], dim + 1)
    shape = list(x.shape)
    shape[dim] *= 2
    return y.reshape(shape)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, 2H, 2W)."""
    return _up2(_up2(x, 2), 3)
