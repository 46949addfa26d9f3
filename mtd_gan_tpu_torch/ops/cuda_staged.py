"""The staged Res-FFT block on the hand-written kernels K3, K4, K5 and K6
(counterparts of ``conv3x3`` / ``_conv3x3_call``, ``_stage_a_call``,
``_stage_b_call`` and ``_stage_c_call`` in
``mtd_gan_tpu/ops/pallas_pipeline.py``, the JAX package's unfused block
pipeline ``fft_block_nchw(fused=False)``).

On NCHW fp32 activations the staged block is

    res = conv3x3(x, relu=True, residual=True)   # K3: x + relu(conv(x) + b)
    z   = rdft_w(x)                              # K4: (N, C, W/2+1, H) complex
    z   = spectral_mix_h(z, mix, bias)           # K5: in place
    out = irdft_w_add(z, res)                    # K6: res + c2r_W(z)

the same function as ``fft_conv.fft_conv_block(impl="auto")``. Each
wrapper has a plain PyTorch version beside it, cut at the same points as
``fft_conv.spectral_branch``: ``torch.fft.rfft`` along W, ``torch.fft.fft``
along H, the mix, the inverse along H, the Hermitian c2r along W with the
imaginary parts of the bins 0 and, for even W, W/2 dropped. The half
spectrum is complex64 ``(N, C, W/2+1, H)``, H contiguous; the JAX stages
pad K to Kp, keep Re and Im in separate K-rows and interleave K5's output
rows by chunk (layout, not semantics).

On a CUDA tensor each wrapper launches its kernel (one launch per call,
counted in ``<wrapper>.launches``) or raises; on a CPU tensor it runs the
plain version. There is no fallback from one to the other. Domains: K3
takes contiguous input without a gradient request, C_out a multiple
of 8 or 1, any C_in and any H, W (C_in == C_out with the residual),
and runs on the tensor cores in 3xTF32 for C_in in {8, 16, 24, 32} and
C_out a multiple of 8 (those launches also counted in
``conv3x3.launches_tc``), on its direct fp32 path otherwise; K4, K5 and
K6 take C in {8, 16, 32} and 2 <= H, W <= 1024 of any parity.

bf16 activations (a bf16 generator's staged and tiled routes; the JAX
``conv3x3`` on a bf16 ``x`` and the unfused pipeline at bf16 activations
with ``bound_dtype=float32``): K3, K4 and K6 take a bf16 ``x`` (K6 a bf16
``res``) and launch their bf16 variants, counted apart in
``<wrapper>.launches_bf16`` (K3's tensor-core ones also in
``conv3x3.launches_bf16_tc``). K3-bf16 convolves bf16 operands (the fp32
weight rounded to bf16, as the flax layers cast it) with fp32 sums, applies
its epilogue in fp32 and rounds once to the wider of ``x``'s and
``skip``'s types: bf16, or fp32 for the exit deconv's fp32 image. K4-bf16
writes the fp32 spectrum, K5 runs unchanged on it, K6-bf16 adds the bf16
residual in fp32 and rounds once to bf16. The plain versions round at the
same points with casts. Any other activation type raises.

bf16 spectra (the JAX pipeline at ``bound_dtype=bfloat16``, its default,
for fp32 or bf16 activations): ``rdft_w(x, bound_dtype=torch.bfloat16)``
writes the half spectrum as a bf16 tensor ``(N, C, W/2+1, H, 2)`` of (Re,
Im) pairs (PyTorch has no bf16 complex type), each rounded once from fp32
as the JAX stage A's ``astype``; ``spectral_mix_h`` and ``irdft_w_add``
take that tensor wherever they take a complex64 one. K5 widens it, computes
in fp32 and rounds its result once (the JAX stage B's output); K6 widens
it and adds the residual in fp32, rounding once to the residual's type.
These launches are counted apart, in ``<wrapper>.launches_bf16s``, for
either activation type. The plain versions round at the same points.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mtd_gan_tpu_torch.ops import _build
from mtd_gan_tpu_torch.ops.cuda_pipeline import (BF16, _check, _device_twiddles, act_dtype,
                                                 round_bf16)
from mtd_gan_tpu_torch.ops.fft_conv import check_bound
from mtd_gan_tpu_torch.ops.layers import widen

Tensor = torch.Tensor

STAGED_CHANNELS = (8, 16, 32)
STAGED_MAX_HW = 1024
_MAX_GRID = 65535


def in_staged_domain(h: int, w: int) -> bool:
    """Whether K4, K5 and K6 take an H x W image (any channel count they
    are instantiated for)."""
    return 2 <= h <= STAGED_MAX_HW and 2 <= w <= STAGED_MAX_HW


def _wants_grad(*tensors: Optional[Tensor]) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _device_of(x: Tensor, who: str) -> torch.device:
    if x.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {x.device}")
    return x.device


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# ---------------------------------------------------------------- K3


def conv3x3_reference(x: Tensor, weight: Tensor, bias: Optional[Tensor], *,
                      skip: Optional[Tensor] = None, relu: bool = True,
                      residual: bool = False, transpose: bool = False) -> Tensor:
    """Plain K3: ``[x +] [relu](conv(x) + bias [+ skip])`` with padding 1;
    ``conv`` is ``F.conv2d`` of a ``(C_out, C_in, 3, 3)`` weight or, with
    ``transpose``, ``F.conv_transpose2d`` of a ``ConvTranspose2d`` weight
    ``(C_in, C_out, 3, 3)`` (the flipped-kernel conv).

    A bf16 ``x`` takes K3-bf16's rounding points: the conv of ``x`` and the
    weight rounded to bf16 in fp32 (exact products, fp32 sums), the fp32
    bias, ``skip`` and epilogue, one rounding to the wider of ``x``'s and
    ``skip``'s types."""
    if x.dtype == BF16:
        out = conv3x3_reference(x.float(), round_bf16(weight), bias,
                                skip=None if skip is None else skip.float(), relu=relu,
                                residual=residual, transpose=transpose)
        return out.to(BF16 if skip is None else torch.promote_types(BF16, skip.dtype))
    conv = F.conv_transpose2d if transpose else F.conv2d
    out = conv(x, weight, bias, padding=1)
    if skip is not None:
        out = out + skip
    if relu:
        out = torch.relu(out)
    return x + out if residual else out


def conv3x3_kmat(weight: Tensor, transpose: bool = False) -> Tensor:
    """K3's B operand: the weight as a K-major ``(9 C_in, C_out)`` matrix,
    row ``tap * C_in + c_in`` with ``tap = 3 ky + kx`` (the JAX
    ``conv_kmat`` column order, transposed). ``weight`` is ``(C_out, C_in,
    3, 3)``, or with ``transpose`` a ``ConvTranspose2d`` weight ``(C_in,
    C_out, 3, 3)``, flipped spatially (``conv_kmat(flip=True)``). The
    kernel's prologue builds the same matrix in shared memory."""
    if transpose:
        k = weight.flip(2, 3).permute(2, 3, 0, 1)
    else:
        k = weight.permute(2, 3, 1, 0)
    return k.reshape(-1, k.shape[-1])


def conv3x3(x: Tensor, weight: Tensor, bias: Optional[Tensor], *,
            skip: Optional[Tensor] = None, relu: bool = True,
            residual: bool = False, transpose: bool = False) -> Tensor:
    """K3: same arguments and result as :func:`conv3x3_reference`.

    A CPU ``x`` takes the plain version. A CUDA ``x`` launches the kernel
    (``csrc/conv3x3.cu``, one launch per call, counted in
    ``conv3x3.launches``) or raises: outside the kernel's domain, on a
    wrong layout, when a gradient is asked for (the kernel has no
    backward), or on a CUDA error. The kernel picks its path by the
    channel counts before the launch: the tensor cores in 3xTF32 for C_in
    in {8, 16, 24, 32} and C_out a multiple of 8 (those launches are also
    counted in ``conv3x3.launches_tc``), the direct fp32 conv otherwise.

    A bf16 ``x`` launches K3-bf16 (``conv3x3_forward_bf16``, counted in
    ``conv3x3.launches_bf16`` and, on the tensor cores, where one wgmma
    bf16 product takes 16 k, ``conv3x3.launches_bf16_tc``): ``skip`` bf16
    or fp32, the output of the wider type; an fp32 ``skip`` only on the
    direct path (C_out = 1: the exit deconv's image)."""
    if x.device.type == "cpu":
        return conv3x3_reference(x, weight, bias, skip=skip, relu=relu,
                                 residual=residual, transpose=transpose)
    who = "conv3x3"
    dev = _device_of(x, who)
    if x.dim() != 4 or weight.dim() != 4 or tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"{who}: x must be (N, C, H, W) and the weight 3x3, got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    n, c_in, h, w = x.shape
    c_out = weight.shape[1] if transpose else weight.shape[0]
    if c_out != 1 and c_out % 8 != 0:
        raise ValueError(f"{who}: the kernel takes C_out a multiple of 8 or 1, "
                         f"got {c_out}")
    if residual and c_in != c_out:
        raise ValueError(f"{who}: the residual needs C_in == C_out, got "
                         f"{c_in} and {c_out}")
    if n * max(1, c_out // 8) > _MAX_GRID or h < 1 or w < 1:
        raise ValueError(f"{who}: the kernel takes N * C_out / 8 <= {_MAX_GRID} "
                         f"and H, W >= 1, got {tuple(x.shape)} -> C_out {c_out}")
    if _wants_grad(x, weight, bias, skip):
        raise ValueError(f"{who}: the kernel is inference only (no backward); "
                         f"call it under torch.no_grad()")
    act = act_dtype(x, who)
    bf = act == BF16
    lib = _build.conv3x3_library()
    tc = lib.conv3x3_tensor_cores(c_in, c_out)
    skip_dtype = act_dtype(skip, who) if bf and skip is not None else act
    if bf and skip_dtype == torch.float32 and tc:
        raise ValueError(f"{who}: the bf16 kernel takes an fp32 skip on its direct "
                         f"path only (C_out = 1), got C_in {c_in} -> C_out {c_out}")
    w_shape = (c_in, c_out, 3, 3) if transpose else (c_out, c_in, 3, 3)
    for t, shape, name, dtype in (
            (x, (n, c_in, h, w), "x", act), (weight, w_shape, "weight", torch.float32),
            (bias, (c_out,), "bias", torch.float32),
            (skip, (n, c_out, h, w), "skip", skip_dtype)):
        _check(t, shape, dev, name, who, dtype)

    out = torch.empty((n, c_out, h, w), device=dev,
                      dtype=torch.promote_types(act, skip_dtype))
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        if bf:
            err = lib.conv3x3_forward_bf16(
                x.data_ptr(), n, c_in, c_out, h, w, weight.data_ptr(), ptr(bias),
                ptr(skip), int(skip_dtype == BF16), out.data_ptr(), int(out.dtype == BF16),
                int(relu), int(residual), int(transpose), _stream(dev))
        else:
            err = lib.conv3x3_forward(
                x.data_ptr(), n, c_in, c_out, h, w, weight.data_ptr(), ptr(bias),
                ptr(skip), out.data_ptr(), int(relu), int(residual), int(transpose),
                _stream(dev))
    if err != 0:
        raise RuntimeError(f"{who}: CUDA error {err} "
                           f"({lib.conv3x3_error_string(err).decode()})")
    if bf:
        conv3x3.launches_bf16 += 1
        conv3x3.launches_bf16_tc += tc
    else:
        conv3x3.launches += 1
        conv3x3.launches_tc += tc
    return out


conv3x3.launches = 0
conv3x3.launches_tc = 0
conv3x3.launches_bf16 = 0
conv3x3.launches_bf16_tc = 0


# ------------------------------------------------------------ K4 - K6


def _check_staged(who: str, n: int, c: int, h: int, w: int) -> None:
    if not in_staged_domain(h, w):
        raise ValueError(f"{who}: the kernel takes 2 <= H, W <= {STAGED_MAX_HW}, "
                         f"got {h}x{w}")
    if c not in STAGED_CHANNELS:
        raise ValueError(f"{who}: the kernel takes C in {STAGED_CHANNELS}, got {c}")
    if n > _MAX_GRID:
        raise ValueError(f"{who}: the kernel takes N <= {_MAX_GRID}, got {n}")


def spectrum_shape(z: Tensor):
    """``(N, C, K, H)`` of a half spectrum: complex64 ``(N, C, K, H)``, or
    bf16 pairs ``(N, C, K, H, 2)``."""
    return tuple(z.shape[:4]) if z.dtype == BF16 else tuple(z.shape)


def widen_spectrum(z: Tensor) -> Tensor:
    """A bf16 spectrum of (Re, Im) pairs as complex64; any other
    spectrum as it is."""
    return torch.view_as_complex(z.float()) if z.dtype == BF16 else z


def _check_spec(z: Tensor, shape, dev: torch.device, who: str) -> None:
    if (z.device != dev or z.dtype not in (torch.complex64, BF16) or not z.is_contiguous()
            or (z.dtype == BF16 and (z.dim() != 5 or z.shape[-1] != 2))):
        raise ValueError(f"{who}: the spectrum must be a contiguous complex64 tensor or "
                         f"bf16 (Re, Im) pairs on {dev}, got {z.dtype} {tuple(z.shape)} "
                         f"on {z.device}")
    if spectrum_shape(z) != tuple(shape):
        raise ValueError(f"{who}: the spectrum has shape {spectrum_shape(z)}, "
                         f"expected {tuple(shape)}")


def _raise_on(lib, err: int, who: str) -> None:
    if err != 0:
        raise RuntimeError(f"{who}: CUDA error {err} "
                           f"({lib.spectral_staged_error_string(err).decode()})")


def rdft_w_reference(x: Tensor, bound_dtype: torch.dtype = torch.float32) -> Tensor:
    """Plain K4: the orthonormal real DFT of each row of NCHW ``x``, as
    ``(N, C, W/2+1, H)`` complex64, H contiguous; a bf16 ``x`` is widened
    to fp32 first (K4-bf16's spectrum is fp32). With ``bound_dtype`` bf16
    the spectrum is rounded to bf16 (Re, Im) pairs, ``(N, C, W/2+1, H,
    2)``."""
    z = torch.fft.rfft(widen(x), dim=-1, norm="ortho").transpose(-1, -2).contiguous()
    return torch.view_as_real(z).to(BF16) if bound_dtype == BF16 else z


def rdft_w(x: Tensor, bound_dtype: torch.dtype = torch.float32) -> Tensor:
    """K4: same arguments and result as :func:`rdft_w_reference`.

    A CPU ``x`` takes the plain version. A CUDA ``x`` launches the kernel
    (``csrc/spectral_staged.cu`` ``staged_rdft_w``, counted in
    ``rdft_w.launches``) or raises: outside its domain, on a wrong layout,
    when a gradient is asked for, or on a CUDA error. The kernel reads its
    twiddles from ``cuda_pipeline.rdft_twiddles``, cached per device and
    W. A bf16 ``x`` launches K4-bf16 (``staged_rdft_w_bf16``, counted in
    ``rdft_w.launches_bf16``). ``bound_dtype`` bf16 launches K4-bf16s
    (``staged_rdft_w_bf16s``, for an fp32 or bf16 ``x``, counted in
    ``rdft_w.launches_bf16s``)."""
    who = "rdft_w"
    check_bound("staged", bound_dtype, who)
    if x.device.type == "cpu":
        return rdft_w_reference(x, bound_dtype)
    dev = _device_of(x, who)
    if x.dim() != 4:
        raise ValueError(f"{who}: x must be (N, C, H, W), got {tuple(x.shape)}")
    n, c, h, w = x.shape
    _check_staged(who, n, c, h, w)
    if _wants_grad(x):
        raise ValueError(f"{who}: the kernel is inference only (no backward)")
    bf = act_dtype(x, who) == BF16
    _check(x, (n, c, h, w), dev, "x", who, x.dtype)

    lib = _build.spectral_staged_library()
    tw = _device_twiddles(w, dev)
    with torch.cuda.device(dev):
        if bound_dtype == BF16:
            z = torch.empty((n, c, w // 2 + 1, h, 2), device=dev, dtype=BF16)
            err = lib.staged_rdft_w_bf16s(x.data_ptr(), int(bf), n, c, h, w, tw.data_ptr(),
                                          z.data_ptr(), _stream(dev))
        else:
            z = torch.empty((n, c, w // 2 + 1, h), device=dev, dtype=torch.complex64)
            entry = lib.staged_rdft_w_bf16 if bf else lib.staged_rdft_w
            err = entry(x.data_ptr(), n, c, h, w, tw.data_ptr(), z.data_ptr(), _stream(dev))
    _raise_on(lib, err, who)
    if bound_dtype == BF16:
        rdft_w.launches_bf16s += 1
    elif bf:
        rdft_w.launches_bf16 += 1
    else:
        rdft_w.launches += 1
    return z


rdft_w.launches = 0
rdft_w.launches_bf16 = 0
rdft_w.launches_bf16s = 0


def spectral_mix_h_reference(z: Tensor, mix: Tensor, bias: Tensor) -> Tensor:
    """Plain K5 on a half spectrum ``z`` ``(N, C, K, H)``: the orthonormal
    FFT along H, ``relu(mix [Re; Im] + bias)`` over the stacked 2C channels
    (``mix`` ``(2C_out, 2C_in)``), the orthonormal inverse FFT along H.
    Returns a new tensor of ``z``'s kind: a bf16 spectrum ``(N, C, K, H,
    2)`` is widened, and the result rounded once to bf16 pairs."""
    zf = torch.fft.fft(widen_spectrum(z), dim=-1, norm="ortho")
    spec = torch.cat([zf.real, zf.imag], dim=1)
    spec = torch.relu(F.conv2d(spec, mix[:, :, None, None], bias))
    re, im = spec.chunk(2, dim=1)
    out = torch.fft.ifft(torch.complex(re, im), dim=-1, norm="ortho")
    return torch.view_as_real(out).to(BF16) if z.dtype == BF16 else out


def spectral_mix_h(z: Tensor, mix: Tensor, bias: Tensor) -> Tensor:
    """K5: the function of :func:`spectral_mix_h_reference`, computed in
    place: ``z`` holds the result and is returned.

    A CPU ``z`` takes the plain version (copied into ``z``). A CUDA ``z``
    launches the kernel (``csrc/spectral_staged.cu`` ``staged_mix_h``, the
    column pass of ``csrc/columns_mixed.cuh``, counted in
    ``spectral_mix_h.launches``) or raises: outside its domain, on a wrong
    layout, when a gradient is asked for, or on a CUDA error. The kernel
    reads the twiddle table of H points (``cuda_pipeline.rdft_twiddles``,
    cached per device and H); its cluster size and the branch of its odd
    step follow from (C, H) before the launch (``staged_mix_cluster_size``,
    ``staged_mix_odd_branch`` in the library). A bf16 spectrum ``(N, C,
    K, H, 2)`` launches K5-bf16s (``staged_mix_h_bf16s``, counted in
    ``spectral_mix_h.launches_bf16s``). Both read two bins a load where H
    is even, so ``z`` must lie at a multiple of two bins (16 bytes of
    complex64, 8 of bf16 pairs)."""
    if z.device.type == "cpu":
        return z.copy_(spectral_mix_h_reference(z, mix, bias))
    who = "spectral_mix_h"
    dev = _device_of(z, who)
    bf = z.dtype == BF16
    if z.dim() != (5 if bf else 4):
        raise ValueError(f"{who}: z must be (N, C, K, H) complex or (N, C, K, H, 2) bf16, "
                         f"got {tuple(z.shape)}")
    n, c, k, h = spectrum_shape(z)
    # K = W/2 + 1 for 2 <= W <= 1024
    if not 2 <= k <= STAGED_MAX_HW // 2 + 1:
        raise ValueError(f"{who}: the kernel takes 2 <= K <= "
                         f"{STAGED_MAX_HW // 2 + 1} bins, got {k}")
    _check_staged(who, n, c, h, 2)
    if _wants_grad(z, mix, bias):
        raise ValueError(f"{who}: the kernel is inference only (no backward)")
    _check_spec(z, (n, c, k, h), dev, who)
    if z.data_ptr() % (8 if bf else 16) != 0:
        raise ValueError(f"{who}: the spectrum must lie at a multiple of two bins")
    _check(mix, (2 * c, 2 * c), dev, "mix", who)
    _check(bias, (2 * c,), dev, "bias", who)

    lib = _build.spectral_staged_library()
    tw = _device_twiddles(h, dev)
    entry = lib.staged_mix_h_bf16s if bf else lib.staged_mix_h
    with torch.cuda.device(dev):
        err = entry(z.data_ptr(), n, c, h, k, mix.data_ptr(), bias.data_ptr(), tw.data_ptr(),
                    _stream(dev))
    _raise_on(lib, err, who)
    if bf:
        spectral_mix_h.launches_bf16s += 1
    else:
        spectral_mix_h.launches += 1
    return z


spectral_mix_h.launches = 0
spectral_mix_h.launches_bf16s = 0


def irdft_w_add_reference(z: Tensor, res: Tensor) -> Tensor:
    """Plain K6: ``res + c2r_W(z)`` for a half spectrum ``z`` ``(N, C,
    W/2+1, H)`` and ``res`` ``(N, C, H, W)``: the orthonormal Hermitian
    inverse along W, the imaginary parts of the bins 0 and, for even W,
    W/2 dropped (as ``fft_conv.spectral_branch`` does: cuFFT's c2r does
    not drop them at every size). A bf16 ``res`` is added in fp32 and the
    sum rounded once to bf16, as K6-bf16 does; a bf16 spectrum ``(N, C,
    W/2+1, H, 2)`` is widened first."""
    w = res.shape[-1]
    zt = widen_spectrum(z).transpose(-1, -2)
    edge = torch.zeros(zt.shape[-1], dtype=torch.bool, device=z.device)
    edge[0] = True
    if w % 2 == 0:
        edge[w // 2] = True
    zt = torch.where(edge, zt.real.to(zt.dtype), zt)
    return (widen(res) + torch.fft.irfft(zt, n=w, dim=-1, norm="ortho")).to(res.dtype)


def irdft_w_add(z: Tensor, res: Tensor) -> Tensor:
    """K6: same arguments and result as :func:`irdft_w_add_reference`.

    A CPU ``res`` takes the plain version. A CUDA ``res`` launches the
    kernel (``csrc/spectral_staged.cu`` ``staged_irdft_w_add``, counted in
    ``irdft_w_add.launches``) or raises: outside its domain, on a wrong
    layout, when a gradient is asked for, or on a CUDA error. The kernel
    reads K4's twiddle table (``cuda_pipeline.rdft_twiddles``, cached per
    device and W) and runs K4's forward steps on the conjugate spectrum.
    Its C entry also runs in place (``residual == out``), as K1 calls it.
    A bf16 ``res`` launches K6-bf16 (``staged_irdft_w_add_bf16``, counted in
    ``irdft_w_add.launches_bf16``; its output bf16). A bf16 spectrum
    ``(N, C, W/2+1, H, 2)`` launches K6-bf16s (``staged_irdft_w_add_bf16s``,
    for an fp32 or bf16 ``res``, counted in ``irdft_w_add.launches_bf16s``)."""
    if res.device.type == "cpu":
        return irdft_w_add_reference(z, res)
    who = "irdft_w_add"
    dev = _device_of(res, who)
    if res.dim() != 4:
        raise ValueError(f"{who}: res must be (N, C, H, W), got {tuple(res.shape)}")
    n, c, h, w = res.shape
    _check_staged(who, n, c, h, w)
    if _wants_grad(z, res):
        raise ValueError(f"{who}: the kernel is inference only (no backward)")
    bf = act_dtype(res, who) == BF16
    _check_spec(z, (n, c, w // 2 + 1, h), dev, who)
    _check(res, (n, c, h, w), dev, "res", who, res.dtype)

    lib = _build.spectral_staged_library()
    tw = _device_twiddles(w, dev)
    out = torch.empty_like(res)
    bf_spec = z.dtype == BF16
    with torch.cuda.device(dev):
        if bf_spec:
            err = lib.staged_irdft_w_add_bf16s(z.data_ptr(), res.data_ptr(), int(bf), n, c, h,
                                               w, tw.data_ptr(), out.data_ptr(), _stream(dev))
        else:
            entry = lib.staged_irdft_w_add_bf16 if bf else lib.staged_irdft_w_add
            err = entry(z.data_ptr(), res.data_ptr(), n, c, h, w, tw.data_ptr(),
                        out.data_ptr(), _stream(dev))
    _raise_on(lib, err, who)
    if bf_spec:
        irdft_w_add.launches_bf16s += 1
    elif bf:
        irdft_w_add.launches_bf16 += 1
    else:
        irdft_w_add.launches += 1
    return out


irdft_w_add.launches = 0
irdft_w_add.launches_bf16 = 0
irdft_w_add.launches_bf16s = 0

