"""The spectral branch on the hand-written kernels K8 and K7 (counterparts
of ``spectral_branch_tiled`` and ``spectral_branch_fused`` in
``mtd_gan_tpu/ops/pallas_fftconv.py``).

Both compute, on NCHW fp32 ``x`` ``(N, C, H, W)``,

    [residual +] irfft2(relu(mix([Re; Im] rfft2(x)) + bias))

with orthonormal FFTs and the Hermitian-fold inverse (the imaginary parts
of the W bins 0 and, for even W, W/2 dropped); without a residual each
returns the branch alone, as the JAX K7 does. On a CUDA tensor each
wrapper launches its kernel; on a CPU tensor it runs the plain PyTorch
version. There is no fallback from one to the other.

:func:`spectral_branch_tiled` (K8, ``csrc/spectral_tiled.cu``) takes C in
{8, 16, 32}; H % 64 == 0 with 64 <= H <= 768 (the column pass holds C*H
complex values of one bin in shared memory); W even with 2 <= W <= 1024.
The JAX kernel takes H % th == 0 (th = 64 by default) and pads K = W/2 + 1
to a multiple of 128. Its three launches are K4's row rDFT, K5's
mixed-radix column pass and K6's inverse rows with the residual, on the
twiddle tables of W and H (``cuda_pipeline.rdft_twiddles``, cached per
device).

:func:`spectral_branch_fused` (K7, ``csrc/spectral_fused.cu``) takes C in
{8, 16, 32} and 2 <= H, W <= 128 of any parity: the JAX kernel's
"H, W <= 128", one sample per thread-block cluster, in one launch that
runs K4's row steps, the column pass of K5 and K6's inverse rows (with the
residual in its store) on the twiddle tables of W and H.

bf16 activations: each takes a bf16 ``x`` and residual and launches its
bf16 variant, counted in ``<wrapper>.launches_bf16``; the spectrum stays
fp32 and the mix weight fp32. They round where their JAX counterparts do.
K8-bf16 (the JAX K8 on a bf16 block's ``x`` and ``res``, which adds the
residual inside the kernel) sums ``residual + branch`` in fp32 and rounds
once to bf16. K7-bf16 (the JAX fused block's ``res + spectral_branch_fused(
x)``, whose K7 writes ``x.dtype``) rounds the branch to bf16, then adds the
residual and rounds the sum again. Each plain version rounds at its
kernel's points.
"""

from __future__ import annotations

from typing import Optional

import torch

from mtd_gan_tpu_torch.ops import _build
from mtd_gan_tpu_torch.ops.cuda_pipeline import BF16, _check, _device_twiddles, act_dtype
from mtd_gan_tpu_torch.ops.fft_conv import spectral_branch
from mtd_gan_tpu_torch.ops.layers import widen

Tensor = torch.Tensor

TILED_CHANNELS = (8, 16, 32)
TILED_H_MULTIPLE = 64
TILED_MAX_H = 768
TILED_MAX_W = 1024


def in_tiled_domain(h: int, w: int) -> bool:
    """Whether K8 takes an H x W image (any channel count it is
    instantiated for)."""
    return (h % TILED_H_MULTIPLE == 0 and TILED_H_MULTIPLE <= h <= TILED_MAX_H
            and w % 2 == 0 and 2 <= w <= TILED_MAX_W)


def spectral_branch_tiled_reference(x: Tensor, mix: Tensor, bias: Tensor,
                                    residual: Optional[Tensor] = None) -> Tensor:
    """Plain PyTorch K8: ``fft_conv.spectral_branch`` plus the residual,
    in fp32 on a widened bf16 ``x`` and residual, the result rounded once
    to ``x``'s type."""
    out = spectral_branch(widen(x), mix, bias)
    return (out if residual is None else widen(residual) + out).to(x.dtype)


def spectral_branch_tiled(x: Tensor, mix: Tensor, bias: Tensor,
                          residual: Optional[Tensor] = None) -> Tensor:
    """K8: same arguments and result as :func:`spectral_branch_tiled_reference`;
    ``mix`` is ``(2C_out, 2C_in)``, ``bias`` ``(2C,)``.

    A CPU ``x`` takes the plain version. A CUDA ``x`` launches the kernel
    (one C entry call, counted in ``spectral_branch_tiled.launches``) or
    raises: outside the kernel's domain, on a wrong layout, when a gradient
    is asked for (the kernel has no backward), or on a CUDA error. A bf16
    ``x`` (and residual) launches K8-bf16 (``spectral_tiled_forward_bf16``,
    counted in ``spectral_branch_tiled.launches_bf16``)."""
    if x.device.type == "cpu":
        return spectral_branch_tiled_reference(x, mix, bias, residual)
    if x.device.type != "cuda":
        raise ValueError(f"spectral_branch_tiled: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"spectral_branch_tiled: x must be (N, C, H, W), got "
                         f"{tuple(x.shape)}")
    n, c, h, w = x.shape
    if not in_tiled_domain(h, w):
        raise ValueError(
            f"spectral_branch_tiled: the kernel takes H % {TILED_H_MULTIPLE} == 0 "
            f"with {TILED_H_MULTIPLE} <= H <= {TILED_MAX_H} and W even with "
            f"2 <= W <= {TILED_MAX_W}, got {h}x{w}")
    if c not in TILED_CHANNELS:
        raise ValueError(f"spectral_branch_tiled: the kernel takes C in "
                         f"{TILED_CHANNELS}, got {c}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, mix, bias, residual)):
        raise ValueError("spectral_branch_tiled: the kernel is inference only "
                         "(no backward); call it under torch.no_grad()")
    act = act_dtype(x, "spectral_branch_tiled")
    dev = x.device
    for t, shape, name, dtype in ((x, (n, c, h, w), "x", act),
                                  (mix, (2 * c, 2 * c), "mix", torch.float32),
                                  (bias, (2 * c,), "bias", torch.float32),
                                  (residual, (n, c, h, w), "residual", act)):
        _check(t, shape, dev, name, "spectral_branch_tiled", dtype)

    lib = _build.spectral_tiled_library()
    tw_w, tw_h = _device_twiddles(w, dev), _device_twiddles(h, dev)
    spec = torch.empty((n, c, w // 2 + 1, h, 2), device=dev, dtype=torch.float32)
    out = torch.empty_like(x)
    entry = lib.spectral_tiled_forward_bf16 if act == BF16 else lib.spectral_tiled_forward
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(x.data_ptr(), n, c, h, w, mix.data_ptr(), bias.data_ptr(),
                    None if residual is None else residual.data_ptr(), tw_w.data_ptr(),
                    tw_h.data_ptr(), spec.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        msg = lib.spectral_tiled_error_string(err).decode()
        raise RuntimeError(f"spectral_branch_tiled: CUDA error {err} ({msg})")
    if act == BF16:
        spectral_branch_tiled.launches_bf16 += 1
    else:
        spectral_branch_tiled.launches += 1
    return out


spectral_branch_tiled.launches = 0
spectral_branch_tiled.launches_bf16 = 0


FUSED_CHANNELS = (8, 16, 32)
FUSED_MAX_HW = 128

def spectral_branch_fused_reference(x: Tensor, mix: Tensor, bias: Tensor,
                                    residual: Optional[Tensor] = None) -> Tensor:
    """Plain K7: the plain K8 (:func:`spectral_branch_tiled_reference`)
    for an fp32 ``x``; for a bf16 ``x`` the branch computed in fp32 on the
    widened ``x`` and rounded to bf16, then the bf16 residual added in fp32
    and the sum rounded to bf16 again, as the JAX fused block does."""
    if x.dtype != BF16:
        return spectral_branch_tiled_reference(x, mix, bias, residual)
    out = spectral_branch(widen(x), mix, bias).to(BF16)
    return out if residual is None else (widen(residual) + widen(out)).to(BF16)


def in_fused_domain(h: int, w: int) -> bool:
    """Whether K7 takes an H x W image (any channel count it is
    instantiated for)."""
    return 2 <= h <= FUSED_MAX_HW and 2 <= w <= FUSED_MAX_HW


def spectral_branch_fused(x: Tensor, mix: Tensor, bias: Tensor,
                          residual: Optional[Tensor] = None) -> Tensor:
    """K7: ``[residual +] irfft2(relu(mix([Re; Im] rfft2(x)) + bias))`` on
    NCHW ``x`` ``(N, C, H, W)``, the same arguments and result as
    :func:`spectral_branch_fused_reference`; ``mix`` is ``(2C_out,
    2C_in)``, ``bias`` ``(2C,)``. Domain: C in {8, 16, 32} and
    2 <= H, W <= 128, odd or even.

    A CPU ``x`` takes the plain version. A CUDA ``x`` launches the kernel
    (one launch per call, counted in ``spectral_branch_fused.launches``) or
    raises: outside the kernel's domain, on a wrong layout, when a gradient
    is asked for (the kernel has no backward), or on a CUDA error. A bf16
    ``x`` (and residual) launches K7-bf16 (``spectral_fused_forward_bf16``,
    counted in ``spectral_branch_fused.launches_bf16``)."""
    if x.device.type == "cpu":
        return spectral_branch_fused_reference(x, mix, bias, residual)
    if x.device.type != "cuda":
        raise ValueError(f"spectral_branch_fused: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"spectral_branch_fused: x must be (N, C, H, W), got "
                         f"{tuple(x.shape)}")
    n, c, h, w = x.shape
    if not in_fused_domain(h, w):
        raise ValueError(f"spectral_branch_fused: the kernel takes 2 <= H, W <= "
                         f"{FUSED_MAX_HW}, got {h}x{w}")
    if c not in FUSED_CHANNELS:
        raise ValueError(f"spectral_branch_fused: the kernel takes C in "
                         f"{FUSED_CHANNELS}, got {c}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, mix, bias, residual)):
        raise ValueError("spectral_branch_fused: the kernel is inference only "
                         "(no backward); call it under torch.no_grad()")
    act = act_dtype(x, "spectral_branch_fused")
    dev = x.device
    for t, shape, name, dtype in ((x, (n, c, h, w), "x", act),
                                  (mix, (2 * c, 2 * c), "mix", torch.float32),
                                  (bias, (2 * c,), "bias", torch.float32),
                                  (residual, (n, c, h, w), "residual", act)):
        _check(t, shape, dev, name, "spectral_branch_fused", dtype)

    lib = _build.spectral_fused_library()
    tw_w, tw_h = _device_twiddles(w, dev), _device_twiddles(h, dev)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        # where the half spectrum does not fit the cluster's shared memory
        # the kernel keeps it in a device-memory scratch
        floats = lib.spectral_fused_scratch_floats(c, h, w)
        scratch = (torch.empty(n * floats, device=dev, dtype=torch.float32)
                   if floats > 0 else None)
        stream = torch.cuda.current_stream(dev).cuda_stream
        entry = lib.spectral_fused_forward_bf16 if act == BF16 else lib.spectral_fused_forward
        err = entry(
            x.data_ptr(), n, c, h, w, mix.data_ptr(), bias.data_ptr(),
            None if residual is None else residual.data_ptr(), tw_w.data_ptr(),
            tw_h.data_ptr(), None if scratch is None else scratch.data_ptr(),
            out.data_ptr(), stream)
    if err != 0:
        msg = lib.spectral_fused_error_string(err).decode()
        raise RuntimeError(f"spectral_branch_fused: CUDA error {err} ({msg})")
    if act == BF16:
        spectral_branch_fused.launches_bf16 += 1
    else:
        spectral_branch_fused.launches += 1
    return out


spectral_branch_fused.launches = 0
spectral_branch_fused.launches_bf16 = 0
