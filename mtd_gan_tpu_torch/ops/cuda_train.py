"""Training path of the generator on the hand-written kernels K1 and K2
(counterpart of ``mtd_gan_tpu/ops/pallas_train.py``).

One :class:`BlockTrain` per Res-FFT block: its forward is
:func:`~mtd_gan_tpu_torch.ops.cuda_pipeline.block_fused` (K1) and it saves
only the block's inputs; its backward is :func:`block_bwd` (K2), which
recomputes the block from them: the "save block inputs, recompute inside
the block" policy of the JAX ``custom_vjp``. On a CUDA tensor
:func:`block_bwd` launches ``csrc/block_bwd.cu``; on a CPU tensor it runs
:func:`block_bwd_reference`, autograd through K1's plain version. There is
no fallback from one to the other.

A bf16 generator (``ResFFTGenerator(dtype=torch.bfloat16)``) trains on K1's
and K2's bf16 variants, as the JAX ``resfft_generator_train(act_dtype=
bfloat16)``: its block boundaries are bf16, the incoming cotangent is
rounded to bf16 and the input and skip cotangents leave in bf16
(``mtd_gan_tpu/ops/pallas_train.py:339-348, :452``), and the weight
gradients stay fp32 on the fp32 parameters.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from mtd_gan_tpu_torch.ops import _build
from mtd_gan_tpu_torch.ops.cuda_pipeline import (BF16, ConvParams, KERNEL_CHANNELS, _check,
                                                 act_dtype, _device_twiddles, block_fused,
                                                 block_fused_reference, entry_conv)
from mtd_gan_tpu_torch.ops.layers import conv_transpose_as_conv

Tensor = torch.Tensor
Grads = Dict[str, Tensor]

# K2 takes H == W in BWD_SIZES: the 64x64 training patches and whole
# slices up to 512x512, where its column pass (block_bwd.cu) runs on one
# CTA a bin or, at 512x512 and C = 32, a cluster of two. K1 takes more
# (cuda_pipeline.in_k1_domain); BlockTrain takes K2's sizes only. A train
# step takes the kernels at
# TRAIN_SIZES only: every discriminator a trainer pairs with a ResFFT
# generator takes 64x64 patches (models/mtd_gan.py
# check_discriminator_input), so no trainer sends whole slices; they reach
# K2 through resfft_generator_train or BlockTrain in a caller's own loop.
BWD_SIZES = (64, 128, 256, 512)
TRAIN_SIZES = (64,)
# Launch geometry: aim for about two blocks per SM of an H100 (132 SMs)
_TARGET_BLOCKS = 264
# image rows, and at most this many columns, per unit of work of the
# weight-gradient GEMM (kWgRows, kWgCols in csrc/block_bwd.cu)
_WGRAD_ROWS = 4
_WGRAD_COLS = 64


def _zeros_if_none(g: Optional[Tensor], like: Tensor) -> Tensor:
    return torch.zeros_like(like) if g is None else g


def block_bwd_reference(x: Tensor, g: Optional[Tensor], h: int, w: int,
                        km: Tensor, kb: Tensor, mix: Tensor, mb: Tensor,
                        pre: Optional[ConvParams] = None,
                        skip: Optional[Tensor] = None,
                        post: Optional[ConvParams] = None,
                        img: Optional[Tensor] = None,
                        gfin: Optional[Tensor] = None) -> Grads:
    """Plain K2: ``torch.autograd.grad`` through
    :func:`~mtd_gan_tpu_torch.ops.cuda_pipeline.block_fused_reference`.

    ``g`` is the cotangent of the block output ``out`` (``None`` = zero),
    ``gfin`` that of ``final`` when ``post`` is given. Returns a dict with
    ``xbar`` and the batch-summed ``km``, ``kb``, ``mix``, ``mb``; with
    ``skip`` also ``skip``; with ``pre`` ``pre_w``, ``pre_b``; with ``post``
    ``img``, ``post_w``, ``post_b``. A bf16 ``x`` (K2's bf16 variant; ``g``
    and ``skip`` bf16) differentiates K1-bf16's plain version: ``xbar`` and
    ``skip`` come back bf16, the rest fp32."""
    named = {"xbar": x, "km": km, "kb": kb, "mix": mix, "mb": mb}
    if pre is not None:
        named.update(pre_w=pre[0], pre_b=pre[1])
    if skip is not None:
        named["skip"] = skip
    if post is not None:
        named.update(post_w=post[0], post_b=post[1], img=img)
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_(True) for k, v in named.items()}
        get = leaves.get
        pre_l = (get("pre_w"), get("pre_b")) if pre is not None else None
        post_l = (get("post_w"), get("post_b")) if post is not None else None
        res = block_fused_reference(leaves["xbar"], h, w, leaves["km"], leaves["kb"],
                                    leaves["mix"], leaves["mb"], pre=pre_l,
                                    skip=get("skip"), post=post_l, img=get("img"))
        if post is None:
            outs, cots = [res], [_zeros_if_none(g, res)]
        else:
            outs = list(res)
            cots = [_zeros_if_none(g, res[0]), _zeros_if_none(gfin, res[1])]
        grads = torch.autograd.grad(outs, list(leaves.values()), cots,
                                    allow_unused=True)
    return {k: (torch.zeros_like(v) if d is None else d)
            for (k, v), d in zip(leaves.items(), grads)}


def _wgrad_units(n: int, h: int) -> int:
    """Units of work of K2's weight-gradient GEMM on n (H, W = H) images: a
    band of rows, cut into segments of ``_WGRAD_COLS`` columns above that
    width."""
    return n * (h // _WGRAD_ROWS) * (h // min(h, _WGRAD_COLS))


def _launch_geometry(n: int, h: int, k: int) -> Tuple[int, int]:
    """(blocks of the weight-gradient launches, partial rows of the spectral
    column launch): both persistent, a block per unit of work (a band or a
    band's segment; an (n, k) bin) up to about two blocks per SM, one wave;
    each block writes one partial, so few partials at large batches. Where
    a bin runs on a cluster of two CTAs (512x512 at C = 32) the column
    launch takes half as many clusters, a partial row each CTA."""
    return (min(_wgrad_units(n, h), _TARGET_BLOCKS), min(n * k, _TARGET_BLOCKS))


def _check_bwd_shape(h: int, w: int, who: str) -> None:
    """Raise unless K2 takes H x W (H == W in ``BWD_SIZES``)."""
    if h != w or h not in BWD_SIZES:
        raise ValueError(f"{who}: K2 takes H == W in {BWD_SIZES}, got {h}x{w}")


def block_bwd(x: Tensor, g: Optional[Tensor], h: int, w: int, km: Tensor,
              kb: Tensor, mix: Tensor, mb: Tensor,
              pre: Optional[ConvParams] = None, skip: Optional[Tensor] = None,
              post: Optional[ConvParams] = None, img: Optional[Tensor] = None,
              gfin: Optional[Tensor] = None,
              scratch: Optional[Dict[str, Tensor]] = None) -> Grads:
    """K2: same arguments and result as :func:`block_bwd_reference`.

    A CPU ``x`` takes the plain version. A CUDA ``x`` launches the kernel
    (one C entry call per block backward, counted in ``block_bwd.launches``;
    a bf16 ``x`` launches the bf16 variant, counted in
    ``block_bwd.launches_bf16``) or raises: on an unsupported shape, type or
    layout, or on a CUDA error. The
    kernel recomputes the forward it differentiates with K1's launches; a
    dict passed as ``scratch`` receives what it recomputed, ``hin`` (with
    ``pre``) and ``out`` (with ``post``), on the card only."""
    if x.device.type == "cpu":
        return block_bwd_reference(x, g, h, w, km, kb, mix, mb, pre=pre,
                                   skip=skip, post=post, img=img, gfin=gfin)
    if x.device.type != "cuda":
        raise ValueError(f"block_bwd: unsupported device {x.device}")
    n, c_in, hw = x.shape
    c = km.shape[0]
    act = act_dtype(x, "block_bwd")
    bf = act == BF16
    _check_bwd_shape(h, w, "block_bwd")
    if hw != h * w:
        raise ValueError(f"block_bwd: x {tuple(x.shape)} does not hold {h}x{w} images")
    if c not in KERNEL_CHANNELS or c_in != c:
        raise ValueError(f"block_bwd: the kernel takes C_in == C in "
                         f"{KERNEL_CHANNELS}, got {c_in} -> {c}")
    if skip is not None and pre is None:
        raise ValueError("block_bwd: skip is added in the pre conv")
    if (post is None) != (img is None):
        raise ValueError("block_bwd: post and img go together")
    dev = x.device
    g = _zeros_if_none(g, x)
    if post is not None:
        gfin = _zeros_if_none(gfin, img)
    pre_w, pre_b = pre if pre is not None else (None, None)
    post_w, post_b = post if post is not None else (None, None)
    for t, shape, name in (
            (x, (n, c, hw), "x"), (g, (n, c, hw), "g"), (km, (c, c, 3, 3), "km"),
            (kb, (c,), "kb"), (mix, (2 * c, 2 * c), "mix"), (mb, (2 * c,), "mb"),
            (pre_w, (c, c, 3, 3), "pre weight"), (pre_b, (c,), "pre bias"),
            (skip, (n, c, hw), "skip"), (post_w, (1, c, 3, 3), "post weight"),
            (post_b, (1,), "post bias"), (img, (n, 1, hw), "img"),
            (gfin if post is not None else None, (n, 1, hw), "gfin")):
        _check(t, shape, dev, name,
               dtype=act if name in ("x", "g", "skip") else torch.float32)

    lib = _build.block_bwd_library()
    tw = _device_twiddles(w, dev)
    k = w // 2 + 1
    wgrad_blocks, col_blocks = _launch_geometry(n, h, k)
    empty = lambda *shape: torch.empty(shape, device=dev, dtype=torch.float32)
    actv = lambda: torch.empty((n, c, hw), device=dev, dtype=act)
    hbuf = actv() if pre is not None else None  # hin
    rbuf = actv()
    obuf = actv() if post is not None else None  # out
    res = empty(n, c, hw) if bf and post is not None else None  # out's residual-conv part
    gbuf = actv() if post is not None else None
    abuf = empty(n, c, hw) if pre is not None or bf else None  # hbar
    spec_a, spec_b = empty(n, c, k, h, 2), empty(n, c, k, h, 2)
    w_part = empty(wgrad_blocks, c * 9 * c + c)
    mix_part = empty(col_blocks, 4 * c * c + 2 * c)
    out = {"xbar": actv(), "km": empty(c, c, 3, 3), "kb": empty(c),
           "mix": empty(2 * c, 2 * c), "mb": empty(2 * c)}
    if pre is not None:
        out.update(pre_w=empty(c, c, 3, 3), pre_b=empty(c))
    if skip is not None:
        out["skip"] = actv()
    if post is not None:
        out.update(img=empty(n, 1, hw), post_w=empty(1, c, 3, 3), post_b=empty(1))
    ptr = lambda t: None if t is None else t.data_ptr()
    o = lambda name: ptr(out.get(name))
    head = (ptr(x), ptr(g), n, c, h, w, ptr(pre_w), ptr(pre_b), ptr(skip),
            ptr(km), ptr(kb), ptr(mix), ptr(mb), ptr(post_w), ptr(post_b),
            ptr(img), ptr(gfin), ptr(tw), ptr(hbuf), ptr(rbuf), ptr(obuf))
    tail = (ptr(gbuf), ptr(abuf), ptr(spec_a), ptr(spec_b), ptr(w_part),
            ptr(mix_part), wgrad_blocks, col_blocks, o("xbar"), o("km"), o("kb"),
            o("mix"), o("mb"), o("skip"), o("pre_w"), o("pre_b"), o("img"),
            o("post_w"), o("post_b"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if bf:
            err = lib.block_bwd_bf16(*head, ptr(res), *tail, stream)
        else:
            err = lib.block_bwd(*head, *tail, stream)
    if err != 0:
        msg = lib.block_bwd_error_string(err).decode()
        raise RuntimeError(f"block_bwd: CUDA error {err} ({msg})")
    if bf:
        block_bwd.launches_bf16 += 1
    else:
        block_bwd.launches += 1
    if scratch is not None:
        scratch.update({name: t for name, t in (("hin", hbuf), ("out", obuf))
                        if t is not None})
    return out


block_bwd.launches = 0
block_bwd.launches_bf16 = 0


class BlockTrain(torch.autograd.Function):
    """One Res-FFT block with K1 forward and K2 backward. Inputs are the
    block's activations and weights (``None`` where absent), in the order
    ``x, skip, img, km, kb, mix, mb, pre_w, pre_b, post_w, post_b``;
    ``post_w`` is the exit deconv already written as a conv. Activations of
    bf16 run both kernels' bf16 variants: the cotangent of the block output
    is rounded to bf16 on its way in, those of ``x`` and ``skip`` leave in
    bf16. Off the CPU (whose plain versions take any shape) the shape must
    be one K2 takes (``BWD_SIZES``): the forward raises before it launches
    K1 otherwise, K1 taking more shapes than K2."""

    @staticmethod
    def forward(ctx, x, skip, img, km, kb, mix, mb, pre_w, pre_b, post_w, post_b,
                h, w):
        if x.device.type != "cpu":
            _check_bwd_shape(h, w, "BlockTrain")
        pre = (pre_w, pre_b) if pre_w is not None else None
        post = (post_w, post_b) if post_w is not None else None
        ctx.save_for_backward(x, skip, img, km, kb, mix, mb, pre_w, pre_b,
                              post_w, post_b)
        ctx.hw = (h, w)
        return block_fused(x, h, w, km, kb, mix, mb, pre=pre, skip=skip,
                           post=post, img=img)

    @staticmethod
    def backward(ctx, grad_out, grad_final=None):
        x, skip, img, km, kb, mix, mb, pre_w, pre_b, post_w, post_b = ctx.saved_tensors
        h, w = ctx.hw
        pre = (pre_w, pre_b) if pre_w is not None else None
        post = (post_w, post_b) if post_w is not None else None
        d = block_bwd(x, grad_out.to(x.dtype), h, w, km, kb, mix, mb, pre=pre, skip=skip,
                      post=post, img=img, gfin=grad_final)
        return (d["xbar"], d.get("skip"), d.get("img"), d["km"], d["kb"], d["mix"],
                d["mb"], d.get("pre_w"), d.get("pre_b"), d.get("post_w"),
                d.get("post_b"), None, None)


def train_route(h: int, w: int, c: int) -> str:
    """The generator forward of a train step on ``(N, H, W, 1)`` patches
    with C features: ``"kernels"`` (:func:`resfft_generator_train`, K1 +
    K2 on the card) where a trainer and both kernels take the batch, H == W
    in ``TRAIN_SIZES`` and C in ``KERNEL_CHANNELS``; else ``"autograd"``,
    the plain generator under autograd (the JAX trainer's
    ``g_forward="auto"`` fallback, ``mtd_gan_tpu/engine/gan.py``). The
    kernels take whole slices too (``BWD_SIZES``), but no trainer does
    (``TRAIN_SIZES``). A bf16 generator takes the same route:
    :class:`BlockTrain` runs K1's and K2's bf16 variants, which take the
    same batches, on its bf16 activations, and the autograd route runs the
    plain generator in bf16."""
    if h == w and h in TRAIN_SIZES and c in KERNEL_CHANNELS:
        return "kernels"
    return "autograd"


def resfft_generator_train(generator, x: Tensor) -> Tensor:
    """Differentiable ResFFT generator forward on K1 + K2.

    ``generator``: a :class:`~mtd_gan_tpu_torch.models.mtd_gan.ResFFTGenerator`;
    ``x``: ``(N, H, W, 1)``. Returns ``(N, H, W, 1)``, the same function as
    ``generator(x)`` with gradients to every parameter of ``generator``: the
    entry conv runs as ``F.conv2d`` under autograd, then 2L+1
    :class:`BlockTrain` calls with the wiring of
    ``cuda_pipeline.resfft_generator_nchw``. The block weights are built
    from the parameters with differentiable ops (the deconv flip, the 1x1
    mix view), so autograd carries their gradients back to the modules.
    The activations take the generator's ``dtype`` (fp32 or bf16, the JAX
    ``act_dtype``); the output and the image residual are fp32."""
    n, h, w, _ = x.shape
    L = generator.num_layers
    x = x.float().contiguous()
    enc0 = generator.encoder[0]
    a = entry_conv(x, enc0.weight, enc0.bias, generator.dtype or torch.float32)
    img = x.reshape(n, 1, h * w)
    conv = lambda m: (m.weight, m.bias)
    deconv = lambda m: (conv_transpose_as_conv(m.weight), m.bias)

    def blk(a_, i, pre=None, skip=None, post=None):
        e = generator.enforce[i]
        pre_w, pre_b = pre if pre is not None else (None, None)
        post_w, post_b = post if post is not None else (None, None)
        return BlockTrain.apply(
            a_, skip, img if post is not None else None, e.img_conv.weight,
            e.img_conv.bias, e.fft_conv.weight[:, :, 0, 0], e.fft_conv.bias,
            pre_w, pre_b, post_w, post_b, h, w)

    skips = []
    for i in range(L):
        a = blk(a, i, pre=conv(generator.encoder[i]) if i > 0 else None)
        skips.append(a)
    a = blk(a, L, pre=conv(generator.encoder[L]))
    # decoder block 2L-i takes decoder[i+1] and skips[i]
    for i in range(L - 1, 0, -1):
        a = blk(a, 2 * L - i, pre=deconv(generator.decoder[i + 1]), skip=skips[i])
    _, final = blk(a, 2 * L, pre=deconv(generator.decoder[1]), skip=skips[0],
                   post=deconv(generator.decoder[0]))
    return final.reshape(n, h, w, 1)


# the root train CLI's --g-forward choices (JAX engine/gan.py:130-159)
G_FORWARDS = ("auto", "einsum", "pallas", "pallas_packed")


def resolve_g_forward(g_forward: str, h: int, w: int, c: int) -> str:
    """The generator's route in a train step on ``(N, H, W, 1)`` patches
    with C features for the root CLI's ``--g-forward``: ``"auto"`` is
    :func:`train_route`'s choice (``"pallas"``, K1 + K2, where they take the
    batch, else ``"einsum"``, the plain generator under autograd);
    ``"pallas"`` raises where K1 + K2 do not take the batch.
    ``"pallas_packed"`` (the TPU's K1-forward / plain-backward variant) runs
    as ``"pallas"``: its math is the same and K2 is the faster backward."""
    if g_forward not in G_FORWARDS:
        raise ValueError(f"g_forward must be one of {G_FORWARDS}, got {g_forward!r}")
    if g_forward == "auto":
        return "pallas" if train_route(h, w, c) == "kernels" else "einsum"
    if g_forward == "einsum":
        return g_forward
    if train_route(h, w, c) != "kernels":
        raise ValueError(f"g_forward={g_forward!r}: K1 + K2 take H == W in {TRAIN_SIZES} "
                         f"(the trainers' patches) and C in {KERNEL_CHANNELS}, got "
                         f"{h}x{w}, C = {c}")
    return "pallas"
