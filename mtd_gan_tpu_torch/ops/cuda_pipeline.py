"""Channel-major generator pipeline on the hand-written K1 kernel
(counterpart of the fused path of ``mtd_gan_tpu/ops/pallas_pipeline.py``).

Activations are ``(N, C, H*W)`` fp32. One :func:`block_fused` call computes a
whole Res-FFT block together with the layer conv that feeds it and, on the
last block, the exit deconv + image residual: the counterpart of
``fft_block_nchw(fused=True)`` / ``_block_fused_call``. On a CUDA tensor it
launches ``csrc/block_fused.cu``; on a CPU tensor it runs
:func:`block_fused_reference`, the plain PyTorch version of the same
function. There is no fallback from one to the other.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mtd_gan_tpu_torch.ops import _build
from mtd_gan_tpu_torch.ops.fft_conv import fft_conv_block
from mtd_gan_tpu_torch.ops.layers import conv_transpose_as_conv

Tensor = torch.Tensor
ConvParams = Tuple[Tensor, Tensor]  # (weight (C_out, C_in, 3, 3), bias (C_out,))

# image sizes the kernel path takes (H == W); the column pass holds C*H
# complex values in shared memory
KERNEL_SIZES = (64, 128, 256, 512)
# channel counts the kernel is instantiated for
KERNEL_CHANNELS = (8, 16, 32)


def block_fused_reference(x: Tensor, h: int, w: int, km: Tensor, kb: Tensor,
                          mix: Tensor, mb: Tensor,
                          pre: Optional[ConvParams] = None,
                          skip: Optional[Tensor] = None,
                          post: Optional[ConvParams] = None,
                          img: Optional[Tensor] = None):
    """Plain PyTorch K1 (``F.conv2d`` + ``torch.fft``) on ``(N, C, H*W)``::

        a     = relu(conv(x, pre) + skip)      if pre else x
        out   = a + relu(conv(a, km) + kb) + irfft2(relu(mix [Re; Im] rfft2(a) + mb))
        final = relu(conv(out, post) + img)    if post

    Returns ``out``, or ``(out, final)`` with ``post``."""
    n = x.shape[0]
    a = x.reshape(n, -1, h, w)
    if pre is not None:
        a = F.conv2d(a, pre[0], pre[1], padding=1)
        if skip is not None:
            a = a + skip.reshape(a.shape)
        a = torch.relu(a)
    out = fft_conv_block(a, km, kb, mix, mb)
    flat = out.reshape(n, -1, h * w)
    if post is None:
        return flat
    final = torch.relu(F.conv2d(out, post[0], post[1], padding=1)
                       + img.reshape(n, 1, h, w))
    return flat, final.reshape(n, 1, h * w)


def rdft_twiddles(w: int) -> Tensor:
    """The twiddle table of the row passes K4 and K6 and of K1's FFTs
    (which run the same steps): ``exp(-2 pi i t / W)`` for ``t < W``, computed in
    float64 and rounded once to complex64 (CPU tensor)."""
    t = np.arange(w, dtype=np.float64)
    return torch.from_numpy(np.exp(-2j * np.pi * t / w).astype(np.complex64))


@functools.cache
def _device_twiddles(w: int, dev: torch.device) -> Tensor:
    """:func:`rdft_twiddles` on ``dev``, built once per (W, device) like a
    cuFFT plan (at most 8 KB each, W <= 1024)."""
    return rdft_twiddles(w).to(dev)


def _check(t: Optional[Tensor], shape, device, name: str,
           who: str = "block_fused") -> None:
    if t is None:
        return
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{who}: {name} must be a contiguous float32 "
                         f"tensor on {device}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def block_fused(x: Tensor, h: int, w: int, km: Tensor, kb: Tensor,
                mix: Tensor, mb: Tensor, pre: Optional[ConvParams] = None,
                skip: Optional[Tensor] = None,
                post: Optional[ConvParams] = None,
                img: Optional[Tensor] = None,
                scratch: Optional[Dict[str, Tensor]] = None):
    """K1: same arguments and result as :func:`block_fused_reference`.

    A CPU ``x`` takes the plain version. A CUDA ``x`` launches the kernel
    (one C entry call per block, counted in ``block_fused.launches``) or
    raises: on an unsupported shape or layout, or on a CUDA error. The
    kernel's FFTs, along W and along H (H == W), read K4's twiddle table
    (:func:`rdft_twiddles`, cached per device and W). A dict passed as
    ``scratch`` receives the pre conv's output ``hin`` (with ``pre``), on
    the card only."""
    if x.device.type == "cpu":
        return block_fused_reference(x, h, w, km, kb, mix, mb, pre=pre,
                                     skip=skip, post=post, img=img)
    if x.device.type != "cuda":
        raise ValueError(f"block_fused: unsupported device {x.device}")
    n, c_in, hw = x.shape
    c = km.shape[0]
    if h != w or h not in KERNEL_SIZES or hw != h * w:
        raise ValueError(f"block_fused: the kernel takes H == W in "
                         f"{KERNEL_SIZES}, got x {tuple(x.shape)} at {h}x{w}")
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"block_fused: the kernel takes C in "
                         f"{KERNEL_CHANNELS}, got {c}")
    if pre is None and c_in != c:
        raise ValueError("block_fused: without pre, x must have C channels")
    if skip is not None and pre is None:
        raise ValueError("block_fused: skip is added in the pre conv")
    if (post is None) != (img is None):
        raise ValueError("block_fused: post and img go together")
    dev = x.device
    pre_w, pre_b = pre if pre is not None else (None, None)
    post_w, post_b = post if post is not None else (None, None)
    for t, shape, name in (
            (x, (n, c_in, hw), "x"), (km, (c, c, 3, 3), "km"), (kb, (c,), "kb"),
            (mix, (2 * c, 2 * c), "mix"), (mb, (2 * c,), "mb"),
            (pre_w, (c, c_in, 3, 3), "pre weight"), (pre_b, (c,), "pre bias"),
            (skip, (n, c, hw), "skip"), (post_w, (1, c, 3, 3), "post weight"),
            (post_b, (1,), "post bias"), (img, (n, 1, hw), "img")):
        _check(t, shape, dev, name)

    lib = _build.block_fused_library()
    tw = _device_twiddles(w, dev)
    out = torch.empty((n, c, hw), device=dev, dtype=torch.float32)
    hbuf = torch.empty_like(out) if pre is not None else None
    spec = torch.empty((n, c, w // 2 + 1, h, 2), device=dev,
                       dtype=torch.float32)
    final = (torch.empty((n, 1, hw), device=dev, dtype=torch.float32)
             if post is not None else None)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.block_fused_forward(
            ptr(x), n, c_in, c, h, w, ptr(pre_w), ptr(pre_b), ptr(skip),
            ptr(km), ptr(kb), ptr(mix), ptr(mb), ptr(post_w), ptr(post_b),
            ptr(img), ptr(tw), ptr(hbuf), ptr(spec), ptr(out), ptr(final), stream)
    if err != 0:
        msg = lib.block_fused_error_string(err).decode()
        raise RuntimeError(f"block_fused: CUDA error {err} ({msg})")
    block_fused.launches += 1
    if scratch is not None and hbuf is not None:
        scratch["hin"] = hbuf
    return out if post is None else (out, final)


block_fused.launches = 0


def prep_generator_params(state: Mapping[str, Tensor],
                          num_layers: int) -> Dict[str, object]:
    """Generator state dict (reference names) -> pipeline weights, all
    contiguous fp32 on the state's device: ``enc0`` (entry conv),
    ``dec0_post`` (exit deconv as a conv), ``enc[i]`` = ``encoder.{i+1}``,
    ``dec[i]`` = ``decoder.{i+1}`` as a conv, ``blocks[i]`` =
    ``(km, kb, mix, mb)`` of ``enforce.{i}``."""
    L = num_layers
    f32 = lambda t: t.detach().float().contiguous()
    conv = lambda name: (f32(state[f"{name}.weight"]), f32(state[f"{name}.bias"]))
    deconv = lambda name: (conv_transpose_as_conv(f32(state[f"{name}.weight"])),
                           f32(state[f"{name}.bias"]))
    blocks: List[Tuple[Tensor, Tensor, Tensor, Tensor]] = []
    for i in range(2 * L + 1):
        km, kb = conv(f"enforce.{i}.img_conv")
        mix, mb = conv(f"enforce.{i}.fft_conv")
        blocks.append((km, kb, mix[:, :, 0, 0].contiguous(), mb))
    return {
        "enc0": conv("encoder.0"),
        "dec0_post": deconv("decoder.0"),
        "enc": [conv(f"encoder.{i}") for i in range(1, L + 1)],
        "dec": [deconv(f"decoder.{i}") for i in range(1, L + 1)],
        "blocks": blocks,
    }


def resfft_generator_nchw(state: Mapping[str, Tensor], x: Tensor,
                          num_layers: int = 10) -> Tensor:
    """Full ResFFT generator forward through :func:`block_fused`.

    ``state``: the generator's state dict; ``x``: ``(N, H, W, 1)``. Returns
    ``(N, H, W, 1)``. The entry conv (C_in = 1) runs as ``F.conv2d``, then
    2L+1 block calls, each fusing the layer conv that feeds it (wiring of
    ``resfft_generator_nchw`` in the JAX pipeline)."""
    n, h, w, _ = x.shape
    L = num_layers
    pp = prep_generator_params(state, L)
    x = x.float().contiguous()
    w0, b0 = pp["enc0"]
    a = torch.relu(F.conv2d(x.permute(0, 3, 1, 2), w0, b0, padding=1))
    a = a.reshape(n, -1, h * w).contiguous()
    img = x.reshape(n, 1, h * w)

    def blk(a_, i, pre=None, skip=None, post=None):
        km, kb, mix, mb = pp["blocks"][i]
        return block_fused(a_, h, w, km, kb, mix, mb, pre=pre, skip=skip,
                           post=post, img=img if post is not None else None)

    skips = []
    for i in range(L):
        a = blk(a, i, pre=pp["enc"][i - 1] if i > 0 else None)
        skips.append(a)
    a = blk(a, L, pre=pp["enc"][L - 1])
    # decoder block 2L-i takes dec_{i+1} (pp["dec"][i]) and skips[i]
    for i in range(L - 1, 0, -1):
        a = blk(a, 2 * L - i, pre=pp["dec"][i], skip=skips[i])
    _, final = blk(a, 2 * L, pre=pp["dec"][0], skip=skips[0],
                   post=pp["dec0_post"])
    return final.reshape(n, h, w, 1)
