"""Res-FFT-Conv block in plain PyTorch (counterpart of the non-TPU branch of
``mtd_gan_tpu/ops/fft_conv.py::fft_conv_block`` and ``FFTConvBlock``).

    out = x + relu(conv3x3(x) + b) + irfft2(relu(mix([Re; Im] rfft2(x)) + mb))

with orthonormal FFTs (reference arch/Ours/networks.py:15-36). Activations
are NCHW. ``mix`` is the spectral 1x1 conv weight ``(2C_out, 2C_in)``: the
transpose of the flax ``fft_kernel``.

``impl`` selects the spectral branch, as the JAX ``impl`` /
``spectral_impl`` do: ``"auto"`` is the plain PyTorch block (``torch.fft``);
``"tiled"`` and ``"fused"`` are the inference paths of the JAX
``"pallas_tiled"`` and ``"pallas_fused"``: the 3x3 conv branch and residual
in ``F.conv2d`` (the JAX package leaves that conv to XLA), then the
spectral branch on a kernel of ``ops/cuda_fftconv.py`` for a CUDA tensor:
K8 with that residual fused into its last pass (``"tiled"``), or K7, whose
branch the residual is added to (``"fused"``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def spectral_branch(x: torch.Tensor, mix: torch.Tensor,
                    mix_bias: torch.Tensor) -> torch.Tensor:
    """``irfft2(relu(mix([Re; Im] rfft2(x)) + mix_bias))`` on NCHW ``x``.

    The ReLU breaks Hermitian symmetry. ``jnp.fft.irfft2`` (and
    ``torch.fft.irfft2`` on the CPU) does a full complex inverse along H and
    then a c2r along W that drops the imaginary part of the W bins 0 and
    W/2. ``torch.fft.irfft2`` on CUDA does not drop them at every size
    (cuFFT's c2r assumes Hermitian input; ``chip_smoke.py`` prints the
    difference), so the two steps are written out and those imaginary parts
    are zeroed before the c2r."""
    h, w = x.shape[-2:]
    xf = torch.fft.rfft2(x, norm="ortho")
    spec = torch.cat([xf.real, xf.imag], dim=1)
    spec = torch.relu(F.conv2d(spec, mix[:, :, None, None], mix_bias))
    re, im = spec.chunk(2, dim=1)
    z = torch.fft.ifft(torch.complex(re, im), dim=-2, norm="ortho")
    edge = torch.zeros(z.shape[-1], dtype=torch.bool, device=z.device)
    edge[0] = True
    if w % 2 == 0:
        edge[w // 2] = True
    z = torch.where(edge, z.real.to(z.dtype), z)
    return torch.fft.irfft(z, n=w, dim=-1, norm="ortho")


SPECTRAL_IMPLS = ("auto", "tiled", "fused")


def fft_conv_block(x: torch.Tensor, img_weight: torch.Tensor,
                   img_bias: torch.Tensor, mix: torch.Tensor,
                   mix_bias: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Functional Res-FFT-Conv block on NCHW ``x``; ``img_weight`` is the
    ``(C, C, 3, 3)`` conv weight. ``impl``: ``"auto"``, ``"tiled"`` or
    ``"fused"`` (module docstring)."""
    res = x + torch.relu(F.conv2d(x, img_weight, img_bias, padding=1))
    if impl == "tiled":
        from mtd_gan_tpu_torch.ops.cuda_fftconv import spectral_branch_tiled

        return spectral_branch_tiled(x, mix, mix_bias, residual=res)
    if impl == "fused":
        from mtd_gan_tpu_torch.ops.cuda_fftconv import spectral_branch_fused

        return res + spectral_branch_fused(x, mix, mix_bias)
    if impl != "auto":
        raise ValueError(f"fft_conv_block: impl must be one of {SPECTRAL_IMPLS}, "
                         f"got {impl!r}")
    return res + spectral_branch(x, mix, mix_bias)


class FFTConvBlock(nn.Module):
    """The reference's ``FFT_ConvBlock``: ``img_conv`` (3x3) and ``fft_conv``
    (1x1 over the 2C stacked real/imag channels), state-dict names as in
    arch/Ours/networks.py. ``spectral_impl`` selects the path
    (:func:`fft_conv_block`); the parameters are the same for every impl."""

    def __init__(self, channels: int, spectral_impl: str = "auto"):
        super().__init__()
        if spectral_impl not in SPECTRAL_IMPLS:
            raise ValueError(f"FFTConvBlock: spectral_impl must be one of "
                             f"{SPECTRAL_IMPLS}, got {spectral_impl!r}")
        self.spectral_impl = spectral_impl
        self.img_conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.fft_conv = nn.Conv2d(2 * channels, 2 * channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fft_conv_block(x, self.img_conv.weight, self.img_conv.bias,
                              self.fft_conv.weight[:, :, 0, 0],
                              self.fft_conv.bias, impl=self.spectral_impl)
