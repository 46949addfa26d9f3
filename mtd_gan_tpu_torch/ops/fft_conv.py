"""Res-FFT-Conv block in plain PyTorch (counterpart of the non-TPU branch of
``mtd_gan_tpu/ops/fft_conv.py::fft_conv_block`` and ``FFTConvBlock``).

    out = x + relu(conv3x3(x) + b) + irfft2(relu(mix([Re; Im] rfft2(x)) + mb))

with orthonormal FFTs (reference arch/Ours/networks.py:15-36). Activations
are NCHW. ``mix`` is the spectral 1x1 conv weight ``(2C_out, 2C_in)``: the
transpose of the flax ``fft_kernel``.

``impl`` selects the spectral branch, as the JAX ``impl`` /
``spectral_impl`` do: ``"auto"`` is the plain PyTorch block (``torch.fft``);
``"tiled"`` and ``"fused"`` are the inference paths of the JAX
``"pallas_tiled"`` and ``"pallas_fused"``: the spectral branch on a kernel
of ``ops/cuda_fftconv.py`` for a CUDA tensor, each with the residual fused
into its last pass: K8 (``"tiled"``) or K7 (``"fused"``); ``"staged"`` is
the JAX unfused pipeline
``fft_block_nchw(fused=False)``: K4, K5 and K6 of ``ops/cuda_staged.py`` on
one spectrum buffer, the residual added in K6.

The plain block (``impl="auto"``, ``conv_impl="torch"``) computes in its
input's type, as the JAX block does (``mtd_gan_tpu/ops/fft_conv.py:91,
:150-180``): for a bf16 input the conv and the residual sums run in bf16
(the weights cast), the spectral branch in fp32 on the widened input, cast
back; cuFFT's zeroing of the W bins 0 and W/2 stays. The ``"tiled"``,
``"fused"`` and ``"staged"`` paths and ``conv_impl="k3"`` run at their
input's type too, fp32 or bf16, on the kernels' bf16 variants for a bf16
input (K3-bf16, K8-bf16, K7-bf16, K4-bf16 -> K5 -> K6-bf16:
``ops/cuda_staged.py``, ``ops/cuda_fftconv.py``), whose spectra stay fp32.
K8-bf16 and K6-bf16 add the residual in fp32 and round once; K7-bf16
rounds its branch to bf16 first, as the JAX fused block adds
``res + spectral_branch_fused(x)`` of two bf16 values.

``bound_dtype`` (``"staged"`` only) is the type of the half spectrum
between K4, K5 and K6, the JAX ``fft_block_nchw(bound_dtype=)``:
``torch.float32`` (complex64), or ``torch.bfloat16`` (bf16 pairs, rounded
after the W-rDFT and after K5's inverse H transform: K4-bf16s -> K5-bf16s
-> K6-bf16s), for fp32 or bf16 activations. The JAX default is bf16; the
port's is fp32, the function the routes compute: the spectrum then rounds
nowhere, as in the JAX ``fft_conv_block`` and the other kernel routes.

``conv_impl`` selects the 3x3 conv branch with its residual,
``x + relu(conv3x3(x) + b)``: ``"torch"`` is ``F.conv2d`` plus the
elementwise ops (the JAX package leaves that conv to XLA except in its
unfused pipeline), ``"k3"`` the hand-written K3 of ``ops/cuda_staged.py``
(its plain version on a CPU tensor).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mtd_gan_tpu_torch.ops.layers import widen


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
    xf = torch.fft.rfft2(x, norm="ortho")
    spec = torch.cat([xf.real, xf.imag], dim=1)
    spec = torch.relu(F.conv2d(spec, mix[:, :, None, None], mix_bias))
    re, im = spec.chunk(2, dim=1)
    return irfft2_real(re, im, x.shape[-1])


def irfft2_real(re: torch.Tensor, im: torch.Tensor, w: int) -> torch.Tensor:
    """The real inverse of the half spectrum ``re + i im`` (``(..., H, W//2
    + 1)``, ortho) to width ``w``, as ``jnp.fft.irfft2``: a complex inverse
    along H, then a c2r along W with the imaginary parts of the W bins 0
    and W/2 zeroed (:func:`spectral_branch`)."""
    z = torch.fft.ifft(torch.complex(re, im), dim=-2, norm="ortho")
    edge = torch.zeros(z.shape[-1], dtype=torch.bool, device=z.device)
    edge[0] = True
    if w % 2 == 0:
        edge[w // 2] = True
    z = torch.where(edge, z.real.to(z.dtype), z)
    return torch.fft.irfft(z, n=w, dim=-1, norm="ortho")


SPECTRAL_IMPLS = ("auto", "tiled", "fused", "staged")
CONV_IMPLS = ("torch", "k3")


def check_impls(spectral_impl: str, conv_impl: str, who: str) -> None:
    if spectral_impl not in SPECTRAL_IMPLS:
        raise ValueError(f"{who}: spectral_impl must be one of {SPECTRAL_IMPLS}, "
                         f"got {spectral_impl!r}")
    if conv_impl not in CONV_IMPLS:
        raise ValueError(f"{who}: conv_impl must be one of {CONV_IMPLS}, "
                         f"got {conv_impl!r}")


def check_bound(spectral_impl: str, bound_dtype: torch.dtype, who: str) -> None:
    """Raise unless ``bound_dtype`` is a spectrum type the staged kernels
    take (fp32 or bf16) and, if bf16, ``spectral_impl`` is ``"staged"``."""
    if bound_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{who}: bound_dtype must be torch.float32 or torch.bfloat16, "
                         f"got {bound_dtype}")
    if bound_dtype != torch.float32 and spectral_impl != "staged":
        raise ValueError(f"{who}: a bf16 bound_dtype needs spectral_impl 'staged', got "
                         f"{spectral_impl!r}")


def fft_conv_block(x: torch.Tensor, img_weight: torch.Tensor,
                   img_bias: torch.Tensor, mix: torch.Tensor,
                   mix_bias: torch.Tensor, impl: str = "auto",
                   conv_impl: str = "torch",
                   bound_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Functional Res-FFT-Conv block on NCHW ``x``; ``img_weight`` is the
    ``(C, C, 3, 3)`` conv weight. ``impl``: ``"auto"``, ``"tiled"``,
    ``"fused"`` or ``"staged"``; ``conv_impl``: ``"torch"`` or ``"k3"``;
    ``bound_dtype``: the staged spectrum's type (module docstring)."""
    check_impls(impl, conv_impl, "fft_conv_block")
    check_bound(impl, bound_dtype, "fft_conv_block")
    if conv_impl == "k3":
        from mtd_gan_tpu_torch.ops.cuda_staged import conv3x3

        res = conv3x3(x, img_weight, img_bias, relu=True, residual=True)
    else:
        d = x.dtype
        res = x + torch.relu(F.conv2d(x, img_weight.to(d), img_bias.to(d), padding=1))
    if impl == "staged":
        from mtd_gan_tpu_torch.ops.cuda_staged import irdft_w_add, rdft_w, spectral_mix_h

        # one spectrum buffer: K4 writes it, K5 works in place, K6 reads it
        return irdft_w_add(spectral_mix_h(rdft_w(x, bound_dtype), mix, mix_bias), res)
    if impl == "tiled":
        from mtd_gan_tpu_torch.ops.cuda_fftconv import spectral_branch_tiled

        return spectral_branch_tiled(x, mix, mix_bias, residual=res)
    if impl == "fused":
        from mtd_gan_tpu_torch.ops.cuda_fftconv import spectral_branch_fused

        return spectral_branch_fused(x, mix, mix_bias, residual=res)
    return res + spectral_branch(widen(x), mix, mix_bias).to(x.dtype)


class FFTConvBlock(nn.Module):
    """The reference's ``FFT_ConvBlock``: ``img_conv`` (3x3) and ``fft_conv``
    (1x1 over the 2C stacked real/imag channels), state-dict names as in
    arch/Ours/networks.py. ``spectral_impl``, ``conv_impl`` and
    ``bound_dtype`` select the path (:func:`fft_conv_block`); the parameters
    are the same for every choice."""

    def __init__(self, channels: int, spectral_impl: str = "auto",
                 conv_impl: str = "torch", bound_dtype: torch.dtype = torch.float32):
        super().__init__()
        check_impls(spectral_impl, conv_impl, "FFTConvBlock")
        check_bound(spectral_impl, bound_dtype, "FFTConvBlock")
        self.spectral_impl = spectral_impl
        self.conv_impl = conv_impl
        self.bound_dtype = bound_dtype
        self.img_conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.fft_conv = nn.Conv2d(2 * channels, 2 * channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fft_conv_block(x, self.img_conv.weight, self.img_conv.bias,
                              self.fft_conv.weight[:, :, 0, 0],
                              self.fft_conv.bias, impl=self.spectral_impl,
                              conv_impl=self.conv_impl, bound_dtype=self.bound_dtype)
