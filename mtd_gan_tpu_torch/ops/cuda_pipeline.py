"""Channel-major generator pipeline on the hand-written K1 kernel
(counterpart of the fused path of ``mtd_gan_tpu/ops/pallas_pipeline.py``).

Activations are ``(N, C, H*W)``, fp32 or bf16. One :func:`block_fused` call
computes a whole Res-FFT block together with the layer conv that feeds it
and, on the last block, the exit deconv + image residual: the counterpart
of ``fft_block_nchw(fused=True)`` / ``_block_fused_call``. On a CUDA tensor
it launches ``csrc/block_fused.cu``; on a CPU tensor it runs
:func:`block_fused_reference`, the plain PyTorch version of the same
function. There is no fallback from one to the other.

bf16 activations (the JAX kernel's ``act_dtype=bfloat16``) select K1's bf16
variant, with the JAX kernel's rounding points: the block input, skip, the
pre conv's output and the block output are bf16; the convs multiply bf16
operands (the fp32 weights rounded) and sum in fp32; the spectral branch
and the block's sums run in fp32 and the output is rounded once; the exit
deconv and the image residual stay fp32. The weights stay fp32.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mtd_gan_tpu_torch.ops import _build
from mtd_gan_tpu_torch.ops.fft_conv import fft_conv_block, spectral_branch
from mtd_gan_tpu_torch.ops.layers import conv_transpose_as_conv

Tensor = torch.Tensor
ConvParams = Tuple[Tensor, Tensor]  # (weight (C_out, C_in, 3, 3), bias (C_out,))

# channel counts the kernel is instantiated for
KERNEL_CHANNELS = (8, 16, 32)
# activation types: fp32, and bf16 for the bf16 variant
ACT_DTYPES = (torch.float32, torch.bfloat16)
BF16 = torch.bfloat16


def in_k1_domain(h: int, w: int) -> bool:
    """Whether K1 (csrc/block_fused.cu ``in_domain``) takes H x W
    activations: H == W in {64, 128}, or 256 <= H <= 1024 and 128 <= W <=
    1024 with H and W multiples of 128 (the shapes the JAX ``generate``
    sends to its K1 pipeline, H >= 256 with H and W multiples of 128, up
    to 1024 a side)."""
    if h == w and h in (64, 128):
        return True
    return 256 <= h <= 1024 and 128 <= w <= 1024 and h % 128 == 0 and w % 128 == 0


def round_bf16(t: Tensor) -> Tensor:
    """``t`` rounded to bf16 and widened back, with the gradient passed
    through unchanged: a kernel's bf16 operand of an fp32 weight, whose
    gradient the kernel keeps in fp32."""
    return t + (t.to(BF16).float() - t).detach()


def block_fused_reference(x: Tensor, h: int, w: int, km: Tensor, kb: Tensor,
                          mix: Tensor, mb: Tensor,
                          pre: Optional[ConvParams] = None,
                          skip: Optional[Tensor] = None,
                          post: Optional[ConvParams] = None,
                          img: Optional[Tensor] = None, transpose: bool = False):
    """Plain PyTorch K1 (``F.conv2d`` + ``torch.fft``) on ``(N, C, H*W)``::

        a     = relu(conv(x, pre) + skip)      if pre else x
        out   = a + relu(conv(a, km) + kb) + irfft2(relu(mix [Re; Im] rfft2(a) + mb))
        final = relu(conv(out, post) + img)    if post

    Returns ``out``, or ``(out, final)`` with ``post``. A bf16 ``x`` takes
    K1's bf16 variant (module docstring): ``skip`` bf16, ``out`` bf16,
    ``final`` fp32. ``transpose``: the ``pre`` and ``post`` weights are
    stride-1 ``ConvTranspose2d`` weights (a generator's decoder), whose
    convs are :func:`conv_transpose_as_conv` of them."""
    if transpose:
        pre, post = ((conv_transpose_as_conv(p[0]), p[1]) if p is not None else None
                     for p in (pre, post))
    if x.dtype == BF16:
        return _block_fused_reference_bf16(x, h, w, km, kb, mix, mb, pre, skip, post, img)
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


def _block_fused_reference_bf16(x, h, w, km, kb, mix, mb, pre, skip, post, img):
    """Plain K1-bf16 with the kernel's rounding points: fp32 convs on
    bf16-valued operands (products exact, fp32 sums), ``a`` rounded to bf16
    after the pre conv, ``out`` rounded once after the block's fp32 sum.
    Under autograd the weights' gradients stay fp32 (:func:`round_bf16`)
    and each bf16 activation's cotangent is rounded to bf16, as K2-bf16's
    are."""
    n = x.shape[0]
    a = x.float().reshape(n, -1, h, w)
    if pre is not None:
        a = F.conv2d(a, round_bf16(pre[0]), pre[1], padding=1)
        if skip is not None:
            a = a + skip.float().reshape(a.shape)
        a = torch.relu(a).to(BF16).float()
    res = a + torch.relu(F.conv2d(a, round_bf16(km), kb, padding=1))
    out = (res + spectral_branch(a, mix, mb)).to(BF16)
    flat = out.reshape(n, -1, h * w)
    if post is None:
        return flat
    final = torch.relu(F.conv2d(out.float(), post[0], post[1], padding=1)
                       + img.reshape(n, 1, h, w))
    return flat, final.reshape(n, 1, h * w)


def rdft_twiddles(w: int) -> Tensor:
    """The twiddle table of W points of the row passes K4 and K6 and of
    K1's FFTs, which run the same steps (the column FFTs take the table of
    H points): ``exp(-2 pi i t / W)`` for ``t < W``, computed in float64
    and rounded once to complex64 (CPU tensor)."""
    t = np.arange(w, dtype=np.float64)
    return torch.from_numpy(np.exp(-2j * np.pi * t / w).astype(np.complex64))


@functools.cache
def _device_twiddles(w: int, dev: torch.device) -> Tensor:
    """:func:`rdft_twiddles` on ``dev``, built once per (W, device) like a
    cuFFT plan (at most 8 KB each, W <= 1024)."""
    return rdft_twiddles(w).to(dev)


def _check(t: Optional[Tensor], shape, device, name: str,
           who: str = "block_fused", dtype: torch.dtype = torch.float32) -> None:
    if t is None:
        return
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{who}: {name} must be a contiguous "
                         f"{str(dtype).removeprefix('torch.')} tensor on {device}, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def act_dtype(t: Tensor, who: str) -> torch.dtype:
    """``t``'s type if the kernels take it as activations (fp32, or bf16
    for their bf16 variants); raises otherwise."""
    if t.dtype not in ACT_DTYPES:
        raise ValueError(f"{who}: the kernel takes activations of {ACT_DTYPES}, "
                         f"got {t.dtype}")
    return t.dtype


def block_fused(x: Tensor, h: int, w: int, km: Tensor, kb: Tensor,
                mix: Tensor, mb: Tensor, pre: Optional[ConvParams] = None,
                skip: Optional[Tensor] = None,
                post: Optional[ConvParams] = None,
                img: Optional[Tensor] = None,
                scratch: Optional[Dict[str, Tensor]] = None, transpose: bool = False):
    """K1: same arguments and result as :func:`block_fused_reference`.

    A CPU ``x`` takes the plain version. A CUDA ``x`` launches the kernel
    (one C entry call per block, counted in ``block_fused.launches``; a bf16
    ``x`` launches the bf16 variant, counted in
    ``block_fused.launches_bf16``) or raises: on a shape outside
    :func:`in_k1_domain`, an unsupported type or layout, or a CUDA error.
    The kernel's FFTs along W read K4's twiddle table of W points and those
    along H the table of H points (:func:`rdft_twiddles`, cached per device
    and length). With ``transpose`` the kernel reads the ``pre`` and
    ``post`` weights flipped in place (K3's adjoint read), with no copy. A
    dict passed as ``scratch`` receives the pre conv's output ``hin``
    (with ``pre``), on the card only."""
    if x.device.type == "cpu":
        return block_fused_reference(x, h, w, km, kb, mix, mb, pre=pre, skip=skip,
                                     post=post, img=img, transpose=transpose)
    if x.device.type != "cuda":
        raise ValueError(f"block_fused: unsupported device {x.device}")
    n, c_in, hw = x.shape
    c = km.shape[0]
    act = act_dtype(x, "block_fused")
    bf = act == BF16
    if not in_k1_domain(h, w) or hw != h * w:
        raise ValueError(f"block_fused: x {tuple(x.shape)} at {h}x{w} is outside "
                         f"in_k1_domain (H == W in (64, 128), or 256 <= H <= 1024 and "
                         f"128 <= W <= 1024, both multiples of 128)")
    if bf and c_in != c:
        raise ValueError(f"block_fused: the bf16 variant takes C_in == C, got {c_in} -> {c}")
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
            (pre_w, (c_in, c, 3, 3) if transpose else (c, c_in, 3, 3), "pre weight"),
            (pre_b, (c,), "pre bias"), (skip, (n, c, hw), "skip"),
            (post_w, (c, 1, 3, 3) if transpose else (1, c, 3, 3), "post weight"),
            (post_b, (1,), "post bias"), (img, (n, 1, hw), "img")):
        _check(t, shape, dev, name, dtype=act if name in ("x", "skip") else torch.float32)

    lib = _build.block_fused_library()
    tw_w, tw_h = _device_twiddles(w, dev), _device_twiddles(h, dev)
    f32 = lambda *shape: torch.empty(shape, device=dev, dtype=torch.float32)
    out = torch.empty((n, c, hw), device=dev, dtype=act)
    hbuf = torch.empty_like(out) if pre is not None else None
    spec = f32(n, c, w // 2 + 1, h, 2)
    final = f32(n, 1, hw) if post is not None else None
    res = f32(n, c, hw) if bf else None  # the residual conv's part of the block's sum
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if bf:
            err = lib.block_fused_forward_bf16(
                ptr(x), n, c_in, c, h, w, ptr(pre_w), ptr(pre_b), ptr(skip),
                ptr(km), ptr(kb), ptr(mix), ptr(mb), ptr(post_w), ptr(post_b),
                int(transpose), ptr(img), ptr(tw_w), ptr(tw_h), ptr(hbuf), ptr(spec),
                ptr(res), ptr(out), ptr(final), stream)
        else:
            err = lib.block_fused_forward(
                ptr(x), n, c_in, c, h, w, ptr(pre_w), ptr(pre_b), ptr(skip),
                ptr(km), ptr(kb), ptr(mix), ptr(mb), ptr(post_w), ptr(post_b),
                int(transpose), ptr(img), ptr(tw_w), ptr(tw_h), ptr(hbuf), ptr(spec),
                ptr(out), ptr(final), stream)
    if err != 0:
        msg = lib.block_fused_error_string(err).decode()
        raise RuntimeError(f"block_fused: CUDA error {err} ({msg})")
    if bf:
        block_fused.launches_bf16 += 1
    else:
        block_fused.launches += 1
    if scratch is not None and hbuf is not None:
        scratch["hin"] = hbuf
    return out if post is None else (out, final)


block_fused.launches = 0
block_fused.launches_bf16 = 0


def prep_generator_params(state: Mapping[str, Tensor],
                          num_layers: int) -> Dict[str, object]:
    """Generator state dict (reference names) -> pipeline weights, all
    contiguous fp32 on the state's device: ``enc0`` (entry conv),
    ``dec0_post`` (exit deconv), ``enc[i]`` = ``encoder.{i+1}``, ``dec[i]``
    = ``decoder.{i+1}`` (a deconv), ``blocks[i]`` = ``(km, kb, mix, mb)``
    of ``enforce.{i}``. The deconvs keep their ``ConvTranspose2d`` weights,
    which K1 reads flipped in place; for the fp32 contiguous parameters of
    a generator every entry is a view of its parameter, so that
    preparing them launches nothing on the card."""
    L = num_layers
    f32 = lambda t: t.detach().float().contiguous()
    conv = lambda name: (f32(state[f"{name}.weight"]), f32(state[f"{name}.bias"]))
    blocks: List[Tuple[Tensor, Tensor, Tensor, Tensor]] = []
    for i in range(2 * L + 1):
        km, kb = conv(f"enforce.{i}.img_conv")
        mix, mb = conv(f"enforce.{i}.fft_conv")
        blocks.append((km, kb, mix[:, :, 0, 0].contiguous(), mb))
    return {
        "enc0": conv("encoder.0"),
        "dec0_post": conv("decoder.0"),
        "enc": [conv(f"encoder.{i}") for i in range(1, L + 1)],
        "dec": [conv(f"decoder.{i}") for i in range(1, L + 1)],
        "blocks": blocks,
    }


def entry_conv(x: Tensor, weight: Tensor, bias: Tensor,
               act_dtype: torch.dtype) -> Tensor:
    """The generator's entry conv (C_in = 1) on ``(N, H, W, 1)`` ``x`` as
    ``F.conv2d``, channel-major ``(N, C, H*W)`` out in ``act_dtype``: for
    bf16 on bf16 operands, as the JAX pipeline's entry conv
    (``x.astype(act)``, ``k0.astype(act)``, ``b0.astype(act)``). ``x`` is
    read as ``(N, 1, H, W)`` (a reshape: NCHW strides, so that the conv
    and its output keep the channel-major layout and nothing is copied)."""
    n, h, w, _ = x.shape
    if act_dtype == BF16:
        x, weight, bias = x.to(BF16), weight.to(BF16), bias.to(BF16)
    a = torch.relu(F.conv2d(x.reshape(n, 1, h, w), weight, bias, padding=1))
    return a.reshape(n, -1, h * w).contiguous()


def resfft_generator_nchw(state: Mapping[str, Tensor], x: Tensor,
                          num_layers: int = 10,
                          act_dtype: torch.dtype = torch.float32) -> Tensor:
    """Full ResFFT generator forward through :func:`block_fused`.

    ``state``: the generator's state dict; ``x``: ``(N, H, W, 1)``. Returns
    ``(N, H, W, 1)`` fp32. The entry conv (C_in = 1) runs as ``F.conv2d``,
    then 2L+1 block calls, each fusing the layer conv that feeds it (wiring
    of ``resfft_generator_nchw`` in the JAX pipeline). ``act_dtype``: the
    activations' type, fp32 or bf16 (K1's bf16 variant: the entry conv's
    output, every block boundary and every skip in bf16, the image residual
    of the exit in fp32, as the JAX pipeline's ``img32``)."""
    n, h, w, _ = x.shape
    L = num_layers
    pp = prep_generator_params(state, L)
    x = x.float().contiguous()
    a = entry_conv(x, *pp["enc0"], act_dtype)
    img = x.reshape(n, 1, h * w)

    def blk(a_, i, pre=None, skip=None, post=None, deconv=False):
        km, kb, mix, mb = pp["blocks"][i]
        return block_fused(a_, h, w, km, kb, mix, mb, pre=pre, skip=skip,
                           post=post, img=img if post is not None else None,
                           transpose=deconv)

    skips = []
    for i in range(L):
        a = blk(a, i, pre=pp["enc"][i - 1] if i > 0 else None)
        skips.append(a)
    a = blk(a, L, pre=pp["enc"][L - 1])
    # decoder block 2L-i takes dec_{i+1} (pp["dec"][i]) and skips[i]
    for i in range(L - 1, 0, -1):
        a = blk(a, 2 * L - i, pre=pp["dec"][i], skip=skips[i], deconv=True)
    _, final = blk(a, 2 * L, pre=pp["dec"][0], skip=skips[0],
                   post=pp["dec0_post"], deconv=True)
    return final.reshape(n, h, w, 1)
