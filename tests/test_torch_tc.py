"""What the CPU can hold of the Hopper redesigns of K3, K4 and K2
(mtd_gan_tpu_torch/csrc/conv3x3.cu, csrc/spectral_staged.cu,
csrc/block_bwd.cu): K4's host twiddle table, the arithmetic of K3's
tensor-core path, 3xTF32 through a conv in the ``conv_kmat`` column order,
and of K2's weight-gradient GEMM (wgrad_tc_kernel), 3xTF32 through g times
the im2col of the input, each emulated here in float32 against float64
convolutions. The kernels themselves run only on the card
(tests/test_torch_cuda.py); this file imports no JAX."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mtd_gan_tpu_torch.ops import cuda_staged as cs
from mtd_gan_tpu_torch.ops.cuda_pipeline import rdft_twiddles

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)


@pytest.mark.parametrize("w", [2, 3, 64, 200, 449, 1024])
def test_k4_twiddle_table_matches_numpy(w):
    """The table K4 reads, exp(-2 pi i t / W) for t < W, built in float64
    and rounded once to complex64: within 1e-7 of numpy's complex128."""
    got = rdft_twiddles(w)
    assert got.dtype == torch.complex64 and tuple(got.shape) == (w,)
    want = np.exp(-2j * np.pi * np.arange(w) / w)
    assert np.abs(got.numpy().astype(np.complex128) - want).max() <= 1e-7


def _tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 as cvt.rna.tf32.f32 does (to nearest, ties
    away from zero; 10 mantissa bits), as K3's to_tf32: half a unit added
    to the magnitude bits, the 13 low bits cleared."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _im2col(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N H W, 9 C): column tap * C + c, tap = 3 ky + kx,
    zero padding 1 (the K-order of conv3x3_kmat)."""
    n, c, h, w = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    taps = [xp[:, :, ky:ky + h, kx:kx + w] for ky in range(3) for kx in range(3)]
    return torch.stack(taps, 1).permute(0, 3, 4, 1, 2).reshape(n * h * w, 9 * c)


def _kmat_conv(x, weight, transpose, passes):
    """The conv as A @ B in float32, A = im2col(x), B = conv3x3_kmat:
    ``passes`` 3 is 3xTF32 (small*big + big*small + big*big), 1 one TF32
    product (big*big)."""
    a, b = _im2col(x), cs.conv3x3_kmat(weight, transpose)
    ab, bb = _tf32_rna(a), _tf32_rna(b)
    out = ab @ bb
    if passes == 3:
        out = (_tf32_rna(a - ab) @ bb + ab @ _tf32_rna(b - bb)) + out
    n, _, h, w = x.shape
    return out.reshape(n, h, w, -1).permute(0, 3, 1, 2)


# relative error (max |err| / max |want|) of 3xTF32 in float32 against the
# float64 conv (measured 5.2e-7 and 5.6e-7); one TF32 product measured
# 2.3e-4 (conv2d) and 2.8e-4 (deconv) on the same inputs, printed beside
# and not asserted
TOL_3XTF32 = 1e-5


@pytest.mark.parametrize("transpose", [False, True], ids=["conv2d", "conv_transpose2d"])
def test_3xtf32_conv_in_kmat_order_matches_float64(transpose):
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.standard_normal((1, 32, 40, 36)), dtype=torch.float32)
    weight = torch.tensor(rng.standard_normal((32, 32, 3, 3)) / np.sqrt(288),
                          dtype=torch.float32)
    conv = F.conv_transpose2d if transpose else F.conv2d
    want = conv(x.double(), weight.double(), padding=1)
    scale = want.abs().max().item()
    errs = {p: (_kmat_conv(x, weight, transpose, p).double() - want).abs().max().item()
            / scale for p in (3, 1)}
    print(f"{conv.__name__}: 3xTF32 {errs[3]:.2e}, 1xTF32 {errs[1]:.2e} relative")
    assert errs[3] <= TOL_3XTF32


def _wgrad_3xtf32(g: torch.Tensor, x: torch.Tensor, passes: int) -> torch.Tensor:
    """The weight gradient as wgrad_tc_kernel forms it, in float32: A = g
    (C_out x pixels), B = im2col(x) (pixels x 9 C_in, column tap * C_in +
    c_in), both split into TF32 big and small parts; ``passes`` 3 sums
    small*big + big*small + big*big, 1 only big*big. Returns (C_out, C_in,
    3, 3)."""
    n, c_out, h, w = g.shape
    a = g.permute(1, 0, 2, 3).reshape(c_out, n * h * w)
    b = _im2col(x)
    ab, bb = _tf32_rna(a), _tf32_rna(b)
    out = ab @ bb
    if passes == 3:
        out = (_tf32_rna(a - ab) @ bb + ab @ _tf32_rna(b - bb)) + out
    return out.reshape(c_out, 9, -1).permute(0, 2, 1).reshape(c_out, -1, 3, 3)


@pytest.mark.parametrize("shape", ["pre", "residual", "post"])
def test_3xtf32_weight_gradient_matches_float64(shape):
    """K2's weight-gradient GEMM in 3xTF32 (float32 emulation) against the
    float64 conv2d weight gradient, at the shapes K2 gives it (batch 2,
    24 x 24): the pre conv (C -> C, the block input x in [0, 1) and its
    cotangent), the residual conv (C -> C, the ReLU'd hin and the gated
    cotangent, half of it zero) and the exit conv (C -> 1). Relative error
    max |err| / max |want| within TOL_3XTF32; one TF32 product printed
    beside it, not asserted."""
    rng = np.random.default_rng(11)
    c = 32
    c_out = 1 if shape == "post" else c
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    x = t(rng.random((2, c, 24, 24)))
    g = t(rng.standard_normal((2, c_out, 24, 24)))
    if shape == "residual":
        x = torch.relu(x - 0.5)
        g = g * t(rng.random(g.shape) > 0.5)
    weight = torch.zeros((c_out, c, 3, 3), dtype=torch.float64, requires_grad=True)
    out = F.conv2d(x.double(), weight, padding=1)
    (want,) = torch.autograd.grad(out, weight, g.double())
    scale = want.abs().max().item()
    errs = {p: (_wgrad_3xtf32(g, x, p).double() - want).abs().max().item() / scale
            for p in (3, 1)}
    print(f"weight gradient {shape}: 3xTF32 {errs[3]:.2e}, 1xTF32 {errs[1]:.2e} relative")
    assert errs[3] <= TOL_3XTF32
