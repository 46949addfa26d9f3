"""Packed ResFFT generator inference: ``groups`` slices ride in the channel
axis (counterpart of ``mtd_gan_tpu/models/packed.py``:
``packed_resfft_apply``, ``_gconv``, ``_gdeconv``, ``_gfft_block``;
reference arch/Ours/networks.py:38-164).

The JAX package packs slices into channels so that every op fills the
TPU's 128 lanes (4 x 32 channels). The per-slice math is unchanged:

* the convs and deconvs are grouped convolutions, the per-slice kernel
  tiled along the output channels;
* the spectral 1x1 mix is applied per group;
* residuals and activations are elementwise and pack as they are.

Inference only, on the generator's state dict (reference names, so
``utils/torch_import.py::generator_state_dict_from_flax`` carries the JAX
weights across unchanged). Plain PyTorch: cuDNN grouped convs in ``dtype``,
the FFTs in fp32. No CLI reaches it, as in the JAX package.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from mtd_gan_tpu_torch.ops.fft_conv import irfft2_real
from mtd_gan_tpu_torch.ops.layers import conv_transpose_as_conv

Tensor = torch.Tensor


def _gconv(h: Tensor, weight: Tensor, bias: Tensor, groups: int, dtype) -> Tensor:
    """A 3x3 conv (``weight`` ``(out, in, 3, 3)``) on each of ``groups``
    channel groups of ``h``."""
    w = torch.cat([weight] * groups).to(dtype)
    return F.conv2d(h.to(dtype), w, bias.repeat(groups).to(dtype), padding=1, groups=groups)


def _gfft_block(h: Tensor, state: Mapping[str, Tensor], i: int, groups: int,
                c: int, dtype) -> Tensor:
    """``h + relu(conv3x3(h)) + irfft2(relu(mix([Re; Im] rfft2(h))))`` per
    group (``ops/fft_conv.py::fft_conv_block``)."""
    p = f"enforce.{i}"
    img = torch.relu(_gconv(h, state[f"{p}.img_conv.weight"], state[f"{p}.img_conv.bias"],
                            groups, dtype))
    n, _, hh, ww = h.shape
    xf = torch.fft.rfft2(h.float(), norm="ortho")  # (n, G*C, H, K)
    k = xf.shape[-1]
    spec = torch.cat([xf.real.reshape(n, groups, c, hh, k),
                      xf.imag.reshape(n, groups, c, hh, k)], dim=2)  # (n, G, 2C, H, K)
    mix = state[f"{p}.fft_conv.weight"][:, :, 0, 0].float()  # (out 2C, in 2C)
    spec = torch.einsum("oi,ngihk->ngohk", mix, spec)
    spec = torch.relu(spec + state[f"{p}.fft_conv.bias"].float()[:, None, None])
    re = spec[:, :, :c].reshape(n, groups * c, hh, k)
    im = spec[:, :, c:].reshape(n, groups * c, hh, k)
    return h + img + irfft2_real(re, im, ww).to(dtype)


@torch.no_grad()
def packed_resfft_apply(state: Mapping[str, Tensor], x: Tensor, features: int = 32,
                        num_layers: int = 10, groups: int = 4,
                        dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """The ResFFT generator on ``x`` ``(N, H, W, 1)``, ``N % groups == 0``,
    with ``groups`` slices packed into the channels: the same per-slice
    function as ``ResFFTGenerator`` on ``state`` (its state dict), in
    ``dtype`` (the FFTs in fp32). Returns ``(N, H, W, 1)`` in ``dtype``."""
    n, hh, ww, _ = x.shape
    if n % groups:
        raise ValueError(f"a batch of {n} does not pack into groups of {groups}")
    c, L = features, num_layers
    # pack: (N, H, W, 1) -> (N/G, G, H, W), slice g of a pack in channel g
    xp = x.reshape(n // groups, groups, hh, ww).to(dtype)
    conv = lambda h, name: _gconv(h, state[f"{name}.weight"], state[f"{name}.bias"],
                                  groups, dtype)
    deconv = lambda h, name: _gconv(h, conv_transpose_as_conv(state[f"{name}.weight"]),
                                    state[f"{name}.bias"], groups, dtype)
    fft = lambda h, i: _gfft_block(h, state, i, groups, c, dtype)

    skips = []
    h = xp
    for i in range(L):
        h = fft(torch.relu(conv(h, f"encoder.{i}")), i)
        skips.append(h)
    h = fft(torch.relu(conv(h, f"encoder.{L}")), L)
    h = torch.relu(deconv(h, f"decoder.{L}") + skips[-1])
    for i in range(L - 1, 0, -1):
        h = fft(h, 2 * L - i)
        h = torch.relu(deconv(h, f"decoder.{i}") + skips[i - 1])
    h = fft(h, 2 * L)
    out = torch.relu(deconv(h, "decoder.0") + xp)  # (N/G, G, H, W)
    return out.reshape(n, hh, ww, 1)
