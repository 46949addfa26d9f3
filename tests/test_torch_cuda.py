"""The hand-written CUDA kernels K1 (mtd_gan_tpu_torch/csrc/block_fused.cu),
K2 (csrc/block_bwd.cu), K8 (csrc/spectral_tiled.cu), K7
(csrc/spectral_fused.cu), K3 (csrc/conv3x3.cu) and K4 - K6
(csrc/spectral_staged.cu; K5's and K8's column pass is csrc/columns_mixed.cuh)
and the bf16 variants of K3, K4, K6, K7 and K8 and the bf16-spectrum K4, K5
and K6 against their plain PyTorch versions, the
routes of ``generate`` and of the train step, and the diffusion UNet's
chunked attention and a DDIM chain against float64 and the CPU, on the
card. Every test is marked
``cuda`` and skips without a GPU. This file imports nothing of JAX, so it
runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

import copy

from mtd_gan_tpu_torch.engine.gan import MTDGANTrainer
from mtd_gan_tpu_torch.models.mtd_gan import MTDGANModel
from mtd_gan_tpu_torch.ops.cuda_fftconv import (spectral_branch_fused,
                                                spectral_branch_fused_reference,
                                                spectral_branch_tiled,
                                                spectral_branch_tiled_reference)
from mtd_gan_tpu_torch.ops import cuda_staged as cs
from mtd_gan_tpu_torch.ops.cuda_pipeline import block_fused, block_fused_reference
from mtd_gan_tpu_torch.ops.cuda_train import (block_bwd, block_bwd_reference,
                                              resfft_generator_train)
from mtd_gan_tpu_torch.ops.layers import conv_transpose_as_conv

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

VARIANTS = ("plain", "pre", "pre+skip", "pre+skip+post")
BF16 = torch.bfloat16
# fp32 on both sides, TF32 off; the kernels' FFTs and 3xTF32 convs sum in
# another order than cuFFT and cuDNN (measured ~1e-7 - 3e-6 relative)
TOL_REL = 1e-4

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, variant, c, size, n=2, seed=0, width=None):
    """std 1/sqrt(fan_in) weights, 0.1 biases, channel-major activations of
    size x ``width`` (default: square)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    w = lambda *s: t(rng.standard_normal(s) / np.sqrt(np.prod(s[1:])))
    b = lambda k: t(rng.standard_normal(k) * 0.1)
    width = width or size
    hw = size * width
    args = dict(x=t(rng.random((n, c, hw))), h=size, w=width, km=w(c, c, 3, 3),
                kb=b(c), mix=w(2 * c, 2 * c), mb=b(2 * c))
    if variant != "plain":
        args["pre"] = (w(c, c, 3, 3), b(c))
    if "skip" in variant:
        args["skip"] = t(rng.standard_normal((n, c, hw)) * 0.5)
    if "post" in variant:
        args["post"] = (w(1, c, 3, 3), b(1))
        args["img"] = t(rng.random((n, 1, hw)))
    return args


def _as_tuple(r):
    return r if isinstance(r, tuple) else (r,)


@pytest.mark.parametrize("c,size", [(8, 64), (16, 128), (32, 256), (32, 64), (32, 512)])
@pytest.mark.parametrize("variant", VARIANTS)
def test_kernel_matches_plain_version(dev, variant, c, size):
    args = _inputs(dev, variant, c, size, seed=VARIANTS.index(variant))
    before = block_fused.launches
    got = _as_tuple(block_fused(**args))
    torch.cuda.synchronize()
    assert block_fused.launches == before + 1
    want = _as_tuple(block_fused_reference(**args))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        rel = ((g - w).abs().max() / w.abs().max()).item()
        assert rel < TOL_REL, (variant, c, size, rel)


# K1 at the JAX gate's shapes beyond its squares (chip_smoke.py phase 35):
# (batch, H, W); K5's mixed-radix column pass at every H: the odd factors
# 3, 5, 7 of H in its odd step, 1024 and 896 on a 2-CTA cluster at C = 32,
# 256 x 1024 at a power-of-two H
K1_GATE_SHAPES = [(2, 1024, 1024), (4, 384, 384), (2, 640, 384), (2, 256, 1024),
                  (2, 896, 512)]


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("n,h,w", K1_GATE_SHAPES)
def test_kernel_matches_plain_version_on_the_jax_gate(dev, n, h, w, dtype):
    """K1 and K1-bf16 (pre+skip+post, C = 32) against their plain versions:
    fp32 TOL_REL per output, bf16 1e-2 max-relative (one bf16 unit is
    3.9e-3 of a value; chip_smoke.py TOL_BF16_REL); one launch."""
    args = _inputs(dev, "pre+skip+post", 32, h, n=n, seed=h + w, width=w)
    if dtype == BF16:
        args = {k: v.to(BF16) if k in ("x", "skip") else v for k, v in args.items()}
    counter = "launches" if dtype == torch.float32 else "launches_bf16"
    before = getattr(block_fused, counter)
    got = block_fused(**args)
    torch.cuda.synchronize()
    assert getattr(block_fused, counter) == before + 1
    want = block_fused_reference(**args)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and g.shape == r.shape
        rel = ((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
        assert rel < (TOL_REL if dtype == torch.float32 else 1e-2), (n, h, w, dtype, rel)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_kernel_reads_deconv_weights_in_place(dev, dtype):
    """A decoder block's call: ``ConvTranspose2d`` weights for the pre and
    the exit conv with ``transpose``, read flipped in place, give the bits of the same call on their flipped copies
    (``conv_transpose_as_conv``), at 384x384 (the odd step) and 256x256."""
    for h in (384, 256):
        args = _inputs(dev, "pre+skip+post", 32, h, n=2, seed=h)
        if dtype == BF16:
            args = {k: v.to(BF16) if k in ("x", "skip") else v for k, v in args.items()}
        (pw, pb), (qw, qb) = args["pre"], args["post"]
        flipped = block_fused(**args)
        t_args = dict(args, pre=(conv_transpose_as_conv(pw), pb),
                      post=(conv_transpose_as_conv(qw), qb))
        assert t_args["post"][0].shape == (32, 1, 3, 3)
        in_place = block_fused(**t_args, transpose=True)
        torch.cuda.synchronize()
        for a, b in zip(flipped, in_place):
            assert torch.equal(a, b), (h, dtype)


def test_generate_at_384_runs_the_k1_route(dev):
    """384x384, the JAX K1 pipeline's shape the tiled route served before:
    21 K1 launches per call, within 1e-3 of the plain module."""
    model = MTDGANModel(gen_features=32, num_layers=10, device=dev, seed=1)
    x = torch.rand((2, 384, 384, 1), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(0))
    before = (block_fused.launches, spectral_branch_tiled.launches)
    got = model.generate(x)
    torch.cuda.synchronize()
    assert (block_fused.launches - before[0], spectral_branch_tiled.launches) == (21, before[1])
    with torch.no_grad():
        want = model.generator(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert (got - want).abs().max().item() < 1e-3


@pytest.mark.parametrize("c_in", [16, 12])
def test_kernel_takes_a_pre_conv_of_another_width(dev, c_in):
    """A pre conv from C_in != C channels: C_in = 16 on the tensor cores
    (C = 32 out), C_in = 12 on the direct conv; the rest of the block as
    always."""
    args = _inputs(dev, "pre+skip", 32, 128, seed=4)
    rng = np.random.default_rng(5)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    args["x"] = t(rng.random((2, c_in, 128 * 128)))
    args["pre"] = (t(rng.standard_normal((32, c_in, 3, 3)) / np.sqrt(9 * c_in)),
                   args["pre"][1])
    got = block_fused(**args)
    want = block_fused_reference(**args)
    assert ((got - want).abs().max() / want.abs().max()).item() < TOL_REL


def test_kernel_library_holds_tensor_core_instructions(dev):
    """K1's convs run K3's wgmma path: its built library has HGMMA
    instructions (cuobjdump -sass, where the toolkit has it)."""
    import os
    import re
    import shutil
    import subprocess

    from torch.utils.cpp_extension import CUDA_HOME

    from mtd_gan_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or (
        os.path.join(CUDA_HOME, "bin", "cuobjdump") if CUDA_HOME else "")
    if not os.path.exists(tool):
        pytest.skip("cuobjdump not found")
    sass = subprocess.run([tool, "-sass", str(_build.build("block_fused"))],
                          capture_output=True, text=True, check=True).stdout
    assert len(re.findall(r"\bHGMMA\b", sass)) > 0


def test_kernel_rejects_unsupported_shapes(dev):
    args = _inputs(dev, "plain", 8, 64)
    with pytest.raises(ValueError, match="H == W"):
        block_fused(**{**args, "x": torch.zeros((2, 8, 96 * 96), device=dev),
                       "h": 96, "w": 96})
    with pytest.raises(ValueError, match="C in"):
        a24 = _inputs(dev, "plain", 24, 64)
        block_fused(**a24)
    # the activation type is checked first (fp32 or bf16), then the layout
    with pytest.raises(ValueError, match="activations of"):
        block_fused(**{**args, "x": args["x"].double()})
    with pytest.raises(ValueError, match="contiguous float32"):
        block_fused(**{**args, "x": args["x"].transpose(1, 2).contiguous().transpose(1, 2)})


def test_generate_runs_the_kernel_21_times_and_matches_plain(dev):
    """Full-width generator at 64x64: 2L+1 = 21 K1 launches per call, output
    within 1e-5 of the plain module (reference init, fp32)."""
    model = MTDGANModel(gen_features=32, num_layers=10, device=dev, seed=1)
    x = torch.rand((2, 64, 64, 1), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(0))
    before = block_fused.launches
    got = model.generate(x)
    torch.cuda.synchronize()
    assert block_fused.launches - before == 21
    with torch.no_grad():
        want = model.generator(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert (got - want).abs().max().item() < 1e-5


def _bwd_inputs(dev, variant, c, n, seed, margin=False, size=64):
    """K1's inputs at ``size`` x ``size`` plus seeded cotangents g (of out)
    and gfin (of final). ``margin``: every bias +-5 (and the res and post
    conv weights x0.05), so each ReLU's pre-activation keeps its sign far
    from zero and no mask depends on summation order."""
    args = _inputs(dev, variant, c, size, n=n, seed=seed)
    rng = np.random.default_rng(seed + 100)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    if margin:
        signed = lambda b: t(5.0 * rng.choice([-1.0, 1.0], b.shape))
        # the res and post convs read activations of size ~5 (after a
        # pre conv with a +5 bias): shrink their weights so that each bias
        # still dominates its pre-activation
        args.update(km=args["km"] * 0.05, kb=signed(args["kb"]), mb=signed(args["mb"]))
        if "pre" in args:
            args["pre"] = (args["pre"][0], signed(args["pre"][1]))
        if "post" in args:
            args["post"] = (args["post"][0] * 0.05, signed(args["post"][1]))
    args["g"] = t(rng.standard_normal((n, c, size * size)))
    if "post" in variant:
        args["gfin"] = t(rng.standard_normal((n, 1, size * size)))
    return args


# K2 against autograd through K1's plain version. With sign-certain masks
# (margin inputs) every output agrees to TOL_REL of its largest magnitude.
# With 1/sqrt(fan_in) weights a pre-activation within fp32 rounding of zero
# can take the other side of its ReLU in one of the two versions: a flip in
# the spectral mask moves one row of dmix and all of xbar by ~1e-3 relative
# (up to 4.3e-3 in the 2-norm on an H100 at batch 8), so those inputs are
# held to TOL_BWD_L2 in the relative 2-norm (without a flip the error is
# ~1e-6).
TOL_BWD_L2 = 1e-2


# K2-bf16 against its bf16 plain version, per output in the relative
# 2-norm: margin inputs 1e-2, 1/sqrt(fan_in) inputs 5e-2, where a
# pre-activation within a bf16 unit of zero flips its ReLU in one version
# (chip_smoke.py TOL_BF16_REL, TOL_BF16_L2)
TOL_BF16_BWD = {True: 1e-2, False: 5e-2}
# at the whole-slice sizes, with post on 1/sqrt(fan_in) inputs: at most
# one pixel in this many (rounded up) may have final's ReLU mask flipped
# between K2 and its plain version (chip_smoke.py POST_FLIP_PIXELS)
POST_FLIP_PIXELS = {torch.float32: 65536, BF16: 8192}
# (C, batch, size, activations): 64x64 in fp32, then C = 32, batch 2 at the
# whole-slice sizes in fp32 and bf16; from 128x128 the weight gradients run
# in 64-column segments of each band, and at 512x512 the column pass on a
# cluster of two CTAs a bin
K2_CASES = ([(8, 2, 64, torch.float32), (32, 2, 64, torch.float32),
             (32, 8, 64, torch.float32), (32, 20, 64, torch.float32)]
            + [(32, 2, size, dtype) for size in (128, 256, 512)
               for dtype in (torch.float32, BF16)])


def _bf16_acts(args):
    return {k: v.to(BF16) if k in ("x", "g", "skip") else v for k, v in args.items()}


@pytest.mark.parametrize("margin", [True, False])
@pytest.mark.parametrize("c,n,size,dtype", K2_CASES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_k2_matches_plain_version(dev, variant, c, n, size, dtype, margin):
    """Every output of K2 (K2-bf16 on bf16 activations) against
    block_bwd_reference, and the kernel repeats bit for bit (no float
    atomics). At batch 20 the persistent weight-gradient and column
    launches give some blocks more than one band or bin (320 bands, 660
    bins over 264 blocks). At 64x64 every output is held over every pixel;
    at the whole-slice sizes the exit bias's gradient, the sum of img's
    cotangent, over the pixels where final's ReLU mask agrees (a flip moves
    it by all of gfin there; img itself is held below), with the flips
    within POST_FLIP_PIXELS's limit."""
    args = _bwd_inputs(dev, variant, c, n, seed=VARIANTS.index(variant), margin=margin,
                       size=size)
    if dtype == BF16:
        args = _bf16_acts(args)
    counter = "launches_bf16" if dtype == BF16 else "launches"
    before = getattr(block_bwd, counter)
    got = block_bwd(**args)
    again = block_bwd(**args)
    torch.cuda.synchronize()
    assert getattr(block_bwd, counter) == before + 2
    want = block_bwd_reference(**args)
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[name], again[name]) for name in want)
    if size > 64 and not margin and "img" in want:
        flips = (got["img"] != 0) != (want["img"] != 0)
        assert int(flips.sum()) <= -(-flips.numel() // POST_FLIP_PIXELS[dtype])
        for d in (got, want):
            d["post_b"] = d["post_b"] - d["img"][flips].sum()
    for name, w in want.items():
        assert got[name].dtype == w.dtype, name
        d = got[name].float() - w.float()
        if dtype == BF16:
            rel = (d.norm() / w.float().norm().clamp_min(1e-30)).item()
            assert rel < TOL_BF16_BWD[margin], (variant, size, name, rel)
        elif margin:
            rel = (d.abs().max() / w.abs().max().clamp_min(1e-30)).item()
            assert rel < TOL_REL, (variant, c, n, size, name, rel)
        else:
            rel = (d.norm() / w.norm().clamp_min(1e-30)).item()
            assert rel < TOL_BWD_L2, (variant, c, n, size, name, rel)


def test_k2_rejects_unsupported_shapes(dev):
    args = _bwd_inputs(dev, "plain", 8, 2, seed=0)
    with pytest.raises(ValueError, match="H == W"):
        block_bwd(**{**args, "x": torch.zeros((2, 8, 32 * 32), device=dev),
                     "h": 32, "w": 32})
    with pytest.raises(ValueError, match="contiguous float32"):
        block_bwd(**{**args, "g": args["g"].double()})


@pytest.mark.parametrize("size,dtype", [(64, torch.float32), (512, torch.float32),
                                        (512, BF16)])
@pytest.mark.parametrize("c", [8, 32])
@pytest.mark.parametrize("variant", VARIANTS[1:])
def test_k2_recomputes_k1_forward_bit_for_bit(dev, variant, c, size, dtype):
    """K2 recomputes the forward it differentiates with K1's own launches:
    its hin equals K1's pre conv output bit for bit (every variant with
    pre), and on the last block its out equals K1's out, so the ReLU masks
    K2 applies are the ones K1's forward took; at 512x512 too (the column
    pass on a cluster at C = 32), fp32 and bf16."""
    args = _bwd_inputs(dev, variant, c, 2, seed=VARIANTS.index(variant), size=size)
    if dtype == BF16:
        args = _bf16_acts(args)
    fwd = {k: v for k, v in args.items() if k not in ("g", "gfin")}
    k1, k2 = {}, {}
    got = _as_tuple(block_fused(**fwd, scratch=k1))
    block_bwd(**args, scratch=k2)
    torch.cuda.synchronize()
    assert torch.equal(k2["hin"], k1["hin"])
    if "post" in variant:
        assert torch.equal(k2["out"], got[0])


def test_k2_library_holds_tensor_core_instructions(dev):
    """K2's convs and weight gradients run on the tensor cores: its built
    library has HGMMA (K3's conv) and HMMA (the weight-gradient mma.sync)
    instructions (cuobjdump -sass, where the toolkit has it)."""
    import os
    import re
    import shutil
    import subprocess

    from torch.utils.cpp_extension import CUDA_HOME

    from mtd_gan_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or (
        os.path.join(CUDA_HOME, "bin", "cuobjdump") if CUDA_HOME else "")
    if not os.path.exists(tool):
        pytest.skip("cuobjdump not found")
    sass = subprocess.run([tool, "-sass", str(_build.build("block_bwd"))],
                          capture_output=True, text=True, check=True).stdout
    assert len(re.findall(r"\bHGMMA\b", sass)) > 0
    assert len(re.findall(r"\bHMMA\b", sass)) > 0


def test_train_step_gradient_matches_plain_generator(dev):
    """One PCGrad step at full width (32 features, 10 layers, D 64
    features, 8 patches of 64x64) through K1 + K2 and through the plain
    generator under autograd, from one state: the D losses within 1e-4,
    and the generator gradient with the same cotangent of fake pulled
    through both within 1e-2 per leaf in the relative 2-norm
    (ReLU-boundary flips, see TOL_BWD_L2); 21 K1 and 21 K2 launches."""
    base = MTDGANModel(gen_features=32, disc_features=64, num_layers=10, device=dev,
                       seed=3)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((8, 64, 64, 1), device=dev, generator=g)
    y = (x + 0.05 * torch.randn(x.shape, device=dev, generator=g)).clamp(0, 1)
    order = torch.tensor([[0, 1, 2], [1, 2, 0], [2, 0, 1]])
    out = {}
    for label, forward in (
            ("kernel", resfft_generator_train),
            ("plain", lambda gen, t: gen(t.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))):
        model = copy.deepcopy(base)
        trainer = MTDGANTrainer(model, method="pcgrad", seed=0)
        before = block_fused.launches
        fake = forward(model.generator.train(), x)
        d_losses, _ = trainer.d_update(x, y, fake, order)
        total, _ = model.g_loss_terms(fake, x, y, generator=trainer.rng)
        (dfake,) = torch.autograd.grad(total, fake, retain_graph=True)
        out[label] = (model, fake, d_losses, dfake, block_fused.launches - before)
    (mk, fk, dk, _, nk), (mp, fp, dp, cp, np_) = out["kernel"], out["plain"]
    assert (nk, np_) == (21, 0)
    assert ((dk - dp).abs().max() / dp.abs().max()).item() < 1e-4
    before = block_bwd.launches
    gk = torch.autograd.grad(fk, list(mk.generator.parameters()), cp)
    gp = torch.autograd.grad(fp, list(mp.generator.parameters()), cp)
    assert block_bwd.launches - before == 21
    for (name, _), a, b in zip(base.generator.named_parameters(), gk, gp):
        rel = ((a - b).norm() / b.norm()).item()
        assert rel < 1e-2, (name, rel)


def _tiled_inputs(dev, n, c, h, w, seed=0):
    """x in [0, 1), 1/sqrt(fan_in) mix, 0.1 biases, a N(0, 0.5) residual."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    return dict(x=t(rng.random((n, c, h, w))),
                mix=t(rng.standard_normal((2 * c, 2 * c)) / np.sqrt(2 * c)),
                bias=t(rng.standard_normal(2 * c) * 0.1),
                residual=t(rng.standard_normal((n, c, h, w)) * 0.5))


@pytest.mark.parametrize("n,c,h,w", [(2, 32, 448, 448), (3, 8, 192, 70), (2, 32, 768, 768)])
def test_k8_matches_plain_version(dev, n, c, h, w):
    """K8 with the residual against its plain version (cuFFT), one launch
    per call, and two calls bit for bit. Its column pass runs 225 and 36
    CTAs per sample at 448 and 192, more than one wave of the card at
    these batches (448 = 64 * 7: the odd step in registers), and 385 2-CTA
    clusters per sample at 768^2, C = 32 (the bin with the mix is over
    227 KB)."""
    args = _tiled_inputs(dev, n, c, h, w)
    before = spectral_branch_tiled.launches
    got = spectral_branch_tiled(**args)
    again = spectral_branch_tiled(**args)
    torch.cuda.synchronize()
    assert spectral_branch_tiled.launches == before + 2
    assert torch.equal(got, again)
    want = spectral_branch_tiled_reference(**args)
    rel = ((got - want).abs().max() / want.abs().max()).item()
    assert rel < TOL_REL, (n, c, h, w, rel)


def test_k8_rejects_unsupported_shapes(dev):
    args = _tiled_inputs(dev, 1, 8, 64, 64)
    with pytest.raises(ValueError, match="H % 64 == 0"):
        spectral_branch_tiled(**_tiled_inputs(dev, 1, 8, 100, 100))
    with pytest.raises(ValueError, match="W even"):
        spectral_branch_tiled(**_tiled_inputs(dev, 1, 8, 64, 63))
    with pytest.raises(ValueError, match="C in"):
        spectral_branch_tiled(**_tiled_inputs(dev, 1, 24, 64, 64))
    with pytest.raises(ValueError, match="contiguous float32"):
        spectral_branch_tiled(**{**args, "x": args["x"].transpose(2, 3)})
    with pytest.raises(ValueError, match="inference only"):
        spectral_branch_tiled(**{**args, "x": args["x"].requires_grad_()})


def test_generate_at_320_runs_k8_21_times_and_no_k1(dev):
    """Full-width generator at 320x320 (outside K1's sizes): the tiled
    generator with 21 K8 launches and no K1 launch, within 1e-5 of the
    plain module (reference init, fp32)."""
    model = MTDGANModel(gen_features=32, num_layers=10, device=dev, seed=1)
    x = torch.rand((1, 320, 320, 1), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(0))
    k1, k8 = block_fused.launches, spectral_branch_tiled.launches
    got = model.generate(x)
    torch.cuda.synchronize()
    assert (block_fused.launches - k1, spectral_branch_tiled.launches - k8) == (0, 21)
    with torch.no_grad():
        want = model.generator(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert (got - want).abs().max().item() < 1e-5


@pytest.mark.parametrize("with_res", [False, True], ids=["branch", "residual"])
@pytest.mark.parametrize("c,h,w", [(32, 96, 96), (32, 100, 72), (32, 97, 66), (32, 127, 127),
                                   (32, 128, 128), (8, 33, 27)])
def test_k7_matches_plain_version(dev, c, h, w, with_res):
    """K7 against its plain version (cuFFT) with one launch per call, with
    and without the residual, and against a second call of itself bit for
    bit: 96^2, 100x72 and 97x66 (prime H, the odd step in two buffers) keep
    the half spectrum in the cluster's shared memory, 127^2 and 128^2 at
    C = 32 in the device-memory scratch."""
    a = _tiled_inputs(dev, 2, c, h, w)
    args = (a["x"], a["mix"], a["bias"], a["residual"] if with_res else None)
    before = spectral_branch_fused.launches
    got = spectral_branch_fused(*args)
    again = spectral_branch_fused(*args)
    torch.cuda.synchronize()
    assert spectral_branch_fused.launches == before + 2
    assert torch.equal(got, again)
    want = spectral_branch_fused_reference(*args)
    rel = ((got - want).abs().max() / want.abs().max()).item()
    assert rel < TOL_REL, (h, w, rel)


def test_k7_rejects_unsupported_calls(dev):
    args = _tiled_inputs(dev, 1, 8, 64, 64)
    x, mix, bias = args["x"], args["mix"], args["bias"]
    with pytest.raises(ValueError, match="2 <= H, W <= 128"):
        spectral_branch_fused(_tiled_inputs(dev, 1, 8, 129, 64)["x"], mix, bias)
    with pytest.raises(ValueError, match="C in"):
        a24 = _tiled_inputs(dev, 1, 24, 64, 64)
        spectral_branch_fused(a24["x"], a24["mix"], a24["bias"])
    with pytest.raises(ValueError, match="contiguous float32"):
        spectral_branch_fused(x.transpose(2, 3), mix, bias)
    with pytest.raises(ValueError, match="inference only"):
        spectral_branch_fused(x, mix.clone().requires_grad_(), bias)
    with pytest.raises(ValueError, match="residual has shape"):
        spectral_branch_fused(x, mix, bias, residual=torch.zeros((1, 8, 32, 64), device=dev))


def test_generate_at_100x72_runs_k7_21_times_and_no_k1_or_k8(dev):
    """Full-width generator at 100x72 (outside K1's and K8's domains): the
    fused generator with 21 K7 launches and no K1 or K8 launch, within 1e-5
    of the plain module (reference init, fp32)."""
    model = MTDGANModel(gen_features=32, num_layers=10, device=dev, seed=1)
    x = torch.rand((2, 100, 72, 1), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(0))
    counts = (block_fused.launches, spectral_branch_tiled.launches,
              spectral_branch_fused.launches)
    got = model.generate(x)
    torch.cuda.synchronize()
    assert (block_fused.launches - counts[0], spectral_branch_tiled.launches - counts[1],
            spectral_branch_fused.launches - counts[2]) == (0, 0, 21)
    with torch.no_grad():
        want = model.generator(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert (got - want).abs().max().item() < 1e-5


STAGED = (cs.conv3x3, cs.rdft_w, cs.spectral_mix_h, cs.irdft_w_add)
ALL_COUNTED = (block_fused, block_bwd, spectral_branch_tiled,
               spectral_branch_fused) + STAGED


def _counts():
    return [f.launches for f in ALL_COUNTED]


def _k3_inputs(dev, n, c, h, w, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    return dict(x=t(rng.random((n, c, h, w))),
                weight=t(rng.standard_normal((c, c, 3, 3)) / np.sqrt(9 * c)),
                bias=t(rng.standard_normal(c) * 0.1),
                skip=t(rng.standard_normal((n, c, h, w)) * 0.5),
                w1=t(rng.standard_normal((c, 1, 3, 3)) / np.sqrt(9 * c)),
                b1=t(rng.standard_normal(1) * 0.1), img=t(rng.random((n, 1, h, w))))


@pytest.mark.parametrize("n,c,h,w", [(2, 32, 200, 200), (1, 8, 449, 130),
                                     (1, 32, 1024, 1024), (2, 32, 448, 448),
                                     (2, 32, 96, 96), (1, 16, 448, 449), (2, 16, 200, 200),
                                     (1, 8, 96, 96)])
def test_k3_matches_plain_version(dev, n, c, h, w):
    """K3 in its four epilogues and the flipped deconv, on the tensor-core
    path (3xTF32) at C = 8, 16 and 32, and the C -> 1 exit deconv on the
    direct path, against its plain version (cuDNN): one launch per call,
    counted on the path it took."""
    a = _k3_inputs(dev, n, c, h, w)
    calls = [((a["x"], a["weight"], a["bias"]), kw, 1) for kw in (
        dict(relu=False), dict(relu=True), dict(skip=a["skip"]), dict(residual=True),
        dict(skip=a["skip"], transpose=True))]
    calls.append(((a["x"], a["w1"], a["b1"]), dict(skip=a["img"], transpose=True), 0))
    for args, kw, tc in calls:
        before = (cs.conv3x3.launches, cs.conv3x3.launches_tc)
        got = cs.conv3x3(*args, **kw)
        torch.cuda.synchronize()
        assert (cs.conv3x3.launches - before[0], cs.conv3x3.launches_tc - before[1]) == (1, tc)
        want = cs.conv3x3_reference(*args, **kw)
        rel = ((got - want).abs().max() / want.abs().max()).item()
        assert rel < TOL_REL, (sorted(kw), rel)


def test_k3_takes_the_direct_path_outside_the_tensor_core_channels(dev):
    """C_in = 12 (not a multiple of 8) and C_in = 40 (above the staged
    tile's 32) run the direct fp32 conv, within the same tolerance."""
    rng = np.random.default_rng(3)
    t = lambda arr: torch.tensor(arr, dtype=torch.float32, device=dev)
    for c_in in (12, 40):
        x = t(rng.random((2, c_in, 50, 70)))
        wt = t(rng.standard_normal((16, c_in, 3, 3)) / np.sqrt(9 * c_in))
        b = t(rng.standard_normal(16) * 0.1)
        before = (cs.conv3x3.launches, cs.conv3x3.launches_tc)
        got = cs.conv3x3(x, wt, b)
        torch.cuda.synchronize()
        assert (cs.conv3x3.launches - before[0], cs.conv3x3.launches_tc - before[1]) == (1, 0)
        want = cs.conv3x3_reference(x, wt, b)
        assert ((got - want).abs().max() / want.abs().max()).item() < TOL_REL


def test_k3_rejects_unsupported_calls(dev):
    a = _k3_inputs(dev, 1, 8, 32, 32)
    x, wt, b = a["x"], a["weight"], a["bias"]
    with pytest.raises(ValueError, match="multiple of 8 or 1"):
        cs.conv3x3(x, wt[:4], b[:4])
    with pytest.raises(ValueError, match="C_in == C_out"):
        cs.conv3x3(x, a["w1"], a["b1"], transpose=True, residual=True)
    with pytest.raises(ValueError, match="contiguous float32"):
        cs.conv3x3(x.transpose(2, 3), wt, b)
    with pytest.raises(ValueError, match="inference only"):
        cs.conv3x3(x, wt.clone().requires_grad_(), b)


# K5's plan by (C, H): the branch of its odd step (0 none, 1 in registers,
# 2 in two buffers) and its cluster size
K5_PLANS = {(32, 1024): (0, 2), (32, 800): (1, 2), (32, 448): (1, 1), (32, 449): (2, 2),
            (32, 200): (1, 1), (16, 200): (1, 1), (8, 130): (2, 1), (8, 2): (0, 1),
            (32, 1000): (2, 4), (16, 1000): (2, 2)}


@pytest.mark.parametrize("c,h,w", [(32, 1024, 1024), (32, 448, 449), (8, 130, 64),
                                   (16, 200, 200), (8, 2, 2), (32, 800, 800), (32, 449, 130),
                                   (32, 200, 200), (32, 1000, 64), (16, 1000, 64)])
def test_k4_k5_k6_match_plain_versions(dev, c, h, w):
    """K4, K5 and K6 each against its plain version (cuFFT), one launch per
    call, and K5 against a second call of itself bit for bit. At C = 32
    K5 takes each of its branches at batch 2, more than one wave of the
    card: no odd step on a 2-CTA cluster (1024), the odd step in registers
    on a 2-CTA cluster (800 = 32 * 25) and on one CTA (448 = 64 * 7, 200 =
    8 * 25), in two buffers on a 2-CTA cluster (449, prime) and on a 4-CTA
    cluster (1000 = 8 * 125; at C = 16 a 2-CTA cluster)."""
    a = _tiled_inputs(dev, 2, c, h, w)
    rel = lambda g, r: ((g - r).abs().max() / r.abs().max()).item()
    from mtd_gan_tpu_torch.ops import _build

    lib = _build.spectral_staged_library()
    assert (lib.staged_mix_odd_branch(h), lib.staged_mix_cluster_size(c, h)) == K5_PLANS[c, h]
    before = [f.launches for f in STAGED[1:]]
    z = cs.rdft_w(a["x"])
    zr = cs.rdft_w_reference(a["x"])
    t = cs.spectral_mix_h(zr.clone(), a["mix"], a["bias"])
    tr = cs.spectral_mix_h_reference(zr, a["mix"], a["bias"])
    out = cs.irdft_w_add(tr, a["residual"])
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(STAGED[1:], before)] == [1, 1, 1]
    assert torch.equal(t, cs.spectral_mix_h(zr.clone(), a["mix"], a["bias"]))
    errs = (rel(torch.view_as_real(z), torch.view_as_real(zr)),
            rel(torch.view_as_real(t), torch.view_as_real(tr)),
            rel(out, cs.irdft_w_add_reference(tr, a["residual"])))
    assert max(errs) < TOL_REL, errs


@pytest.mark.parametrize("c", [8, 32])
@pytest.mark.parametrize("h,w", [(1024, 1024), (101, 1024), (33, 200), (7, 449), (2, 2),
                                 (130, 2), (17, 9), (100, 512), (3, 64)])
def test_k4_matches_plain_version(dev, c, h, w):
    """K4 alone at odd H (a tail block of fewer than 16 rows, an odd last
    row paired with zeros), H not a multiple of 16, odd W, W = 2 and
    1024^2, against torch.fft.rfft; one launch per call."""
    x = _tiled_inputs(dev, 2, c, h, w)["x"]
    before = cs.rdft_w.launches
    got = cs.rdft_w(x)
    torch.cuda.synchronize()
    assert cs.rdft_w.launches == before + 1
    want = torch.view_as_real(cs.rdft_w_reference(x))
    rel = ((torch.view_as_real(got) - want).abs().max() / want.abs().max()).item()
    assert rel < TOL_REL, rel


@pytest.mark.parametrize("mode", ["residual", "no residual", "in place"])
@pytest.mark.parametrize("c,h,w", [(32, 1024, 1024), (32, 200, 200), (8, 448, 449),
                                   (8, 33, 200), (8, 2, 2), (8, 101, 1024), (8, 7, 449),
                                   (8, 17, 9)])
def test_k6_matches_plain_version(dev, c, h, w, mode):
    """K6 alone (the inverse of K4's row rDFT) against its plain version
    (torch.fft.irfft of the spectrum with the edge bins' imaginary parts
    dropped) at 1024^2, W = 200 (Q = 25), 449 (prime), 9, 2 and odd H:
    with the residual; and, the library called directly, with none (the C
    entry's null residual) and in place, the output being the residual, as
    K1 calls it. One launch per wrapper call."""
    a = _tiled_inputs(dev, 2, c, h, w)
    rng = np.random.default_rng(h + w)
    shape = (2, c, w // 2 + 1, h)
    t = lambda arr: torch.tensor(arr, dtype=torch.float32, device=dev)
    z = torch.complex(t(rng.standard_normal(shape)), t(rng.standard_normal(shape)))
    res = a["residual"]
    want = cs.irdft_w_add_reference(z, torch.zeros_like(res) if mode == "no residual" else res)
    before = cs.irdft_w_add.launches
    if mode == "residual":
        got = cs.irdft_w_add(z, res)
        launches = 1
    else:
        from mtd_gan_tpu_torch.ops import _build

        # the C entry itself: a null residual, or the residual as the output
        got = torch.empty_like(res) if mode == "no residual" else res.clone()
        res_ptr = None if mode == "no residual" else got.data_ptr()
        lib = _build.spectral_staged_library()
        err = lib.staged_irdft_w_add(z.data_ptr(), res_ptr, 2, c, h, w,
                                     cs._device_twiddles(w, res.device).data_ptr(),
                                     got.data_ptr(), torch.cuda.current_stream().cuda_stream)
        assert err == 0
        launches = 0
    torch.cuda.synchronize()
    assert cs.irdft_w_add.launches == before + launches
    rel = ((got - want).abs().max() / want.abs().max()).item()
    assert rel < TOL_REL, rel


# the bf16 variants against their bf16 plain versions: both sides round
# the same fp32 sums once at the same points, so an element whose sum lies
# near a midpoint rounds to the other bf16 value in one summation order:
# one unit, 2^-8 - 2^-7 of the value; 1e-2 max-relative allows two at the
# largest element (chip_smoke.py TOL_BF16_REL)
TOL_BF16_REL = 1e-2


@pytest.mark.parametrize("n,c,h,w", [(2, 32, 448, 448), (2, 8, 192, 70), (1, 8, 449, 130),
                                     (2, 16, 200, 200)])
def test_bf16_kernels_match_plain_versions(dev, n, c, h, w):
    """K3-bf16's C -> 1 exit deconv with the fp32 image on the direct path
    (fp32 out; its tensor-core path: test_k3_bf16_matches_plain_version),
    K4-bf16, K6-bf16 (with the residual, and in place through the C entry)
    and, where H % 64 == 0 and W is even, K8-bf16 with the residual, each
    against its bf16 plain version on 1/sqrt(fan_in) weights: one launch
    per wrapper call, counted in ``launches_bf16``, no fp32 launch. W = 70
    and 130 are no multiple of 4 (the scalar paths), 449 is prime."""
    from mtd_gan_tpu_torch.ops import _build

    bf16 = lambda d: {k: v.to(BF16) if k in ("x", "residual", "skip") else v
                      for k, v in d.items()}
    conv, a = bf16(_k3_inputs(dev, n, c, h, w)), bf16(_tiled_inputs(dev, n, c, h, w))
    rel = lambda g, r: ((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
    fp32_before = _counts()
    args, kw = (conv["x"], conv["w1"], conv["b1"]), dict(skip=conv["img"], transpose=True)
    before = (cs.conv3x3.launches_bf16, cs.conv3x3.launches_bf16_tc)
    got = cs.conv3x3(*args, **kw)
    torch.cuda.synchronize()
    assert (cs.conv3x3.launches_bf16 - before[0],
            cs.conv3x3.launches_bf16_tc - before[1]) == (1, 0)
    assert got.dtype == torch.float32
    assert rel(got, cs.conv3x3_reference(*args, **kw)) < TOL_BF16_REL
    before = (cs.rdft_w.launches_bf16, cs.irdft_w_add.launches_bf16)
    z = cs.rdft_w(a["x"])
    zr = cs.rdft_w_reference(a["x"])
    tr = cs.spectral_mix_h_reference(zr, a["mix"], a["bias"])
    out = cs.irdft_w_add(tr, a["residual"])
    inout = a["residual"].clone()
    lib = _build.spectral_staged_library()
    assert lib.staged_irdft_w_add_bf16(tr.data_ptr(), inout.data_ptr(), n, c, h, w,
                                       cs._device_twiddles(w, dev).data_ptr(),
                                       inout.data_ptr(),
                                       torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert (cs.rdft_w.launches_bf16 - before[0], cs.irdft_w_add.launches_bf16 - before[1]) == (1, 1)
    assert z.dtype == torch.complex64 and out.dtype == inout.dtype == BF16
    want = cs.irdft_w_add_reference(tr, a["residual"])
    assert rel(torch.view_as_real(z), torch.view_as_real(zr)) < TOL_REL
    assert rel(out, want) < TOL_BF16_REL and rel(inout, want) < TOL_BF16_REL
    if h % 64 == 0 and w % 2 == 0:
        before = spectral_branch_tiled.launches_bf16
        got = spectral_branch_tiled(a["x"], a["mix"], a["bias"], a["residual"])
        torch.cuda.synchronize()
        assert spectral_branch_tiled.launches_bf16 == before + 1 and got.dtype == BF16
        want = spectral_branch_tiled_reference(a["x"], a["mix"], a["bias"], a["residual"])
        assert rel(got, want) < TOL_BF16_REL
    assert _counts() == fp32_before


# K3-bf16 on the tensor cores, (C_in, C_out, N, H, W, offset of x in bf16
# values): every channel pair at 40 x 72; C = 32 at the 16-byte staging
# tier's widths (W % 8 == 0, x on 16 bytes: 1024, 448, 96, 72, 64) and the
# general tier's (449, 130, 100, 27, 1); C_in = 8, 16, 24 on the general
# tier (W = 70, 130, 27, 99) and C = 16 at 200 x 200; x starting 2 and 8
# bytes past an aligned address (the general tier at W = 64). Equal to
# chip_smoke.py's K3_BF16_TIER_CASES (held by
# tests/test_torch_tc_bf16_tile.py).
K3_BF16_CASES = (
    [(ci, co, 1, 40, 72, 0) for ci in (8, 16, 24, 32) for co in (8, 16, 32, 64)]
    + [(32, 32, n, h, w, 0) for n, h, w in ((1, 1024, 1024), (2, 448, 448), (2, 96, 96),
                                            (2, 100, 72), (2, 64, 64), (1, 130, 449),
                                            (1, 449, 130), (2, 100, 100), (2, 27, 27),
                                            (2, 5, 1))]
    + [(8, 8, 2, 192, 70, 0), (8, 8, 1, 449, 130, 0), (16, 16, 2, 200, 200, 0),
       (16, 16, 2, 27, 27, 0), (24, 24, 2, 27, 27, 0), (24, 64, 1, 33, 99, 0)]
    + [(c, c, 2, 64, 64, off) for c in (8, 24, 32) for off in (1, 4)])


@pytest.mark.parametrize("c_in,c_out,n,h,w,offset", K3_BF16_CASES)
def test_k3_bf16_matches_plain_version(dev, c_in, c_out, n, h, w, offset):
    """K3-bf16 on the tensor cores (relu; skip + relu; the flipped deconv
    with a bf16 skip; relu + residual where C_in == C_out), on both staging
    tiers of its bf16 tile, against its bf16 plain version on
    1/sqrt(fan_in) weights within TOL_BF16_REL: one bf16 tensor-core launch
    per call (``launches_bf16`` and ``launches_bf16_tc``), no fp32 launch,
    a bf16 output."""
    rng = np.random.default_rng(c_in * c_out + w + offset)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    x = t(rng.random((n, c_in, h, w)) - 0.5).to(BF16)
    if offset:
        x = torch.empty(x.numel() + offset, device=dev, dtype=BF16)[offset:].view(
            x.shape).copy_(x)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    weight = t(rng.standard_normal((c_out, c_in, 3, 3)) / np.sqrt(9 * c_in))
    wt_t = t(rng.standard_normal((c_in, c_out, 3, 3)) / np.sqrt(9 * c_in))
    bias = t(rng.standard_normal(c_out) * 0.1)
    skip = t(rng.standard_normal((n, c_out, h, w)) * 0.5).to(BF16)
    calls = [(weight, {}), (weight, dict(skip=skip)),
             (wt_t, dict(skip=skip, transpose=True, relu=False))]
    if c_in == c_out:
        calls.append((weight, dict(residual=True)))
    rel = lambda g, r: ((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
    fp32_before = _counts()
    for wt, kw in calls:
        before = (cs.conv3x3.launches_bf16, cs.conv3x3.launches_bf16_tc)
        got = cs.conv3x3(x, wt, bias, **kw)
        torch.cuda.synchronize()
        assert (cs.conv3x3.launches_bf16 - before[0],
                cs.conv3x3.launches_bf16_tc - before[1]) == (1, 1)
        assert got.dtype == BF16
        assert rel(got, cs.conv3x3_reference(x, wt, bias, **kw)) < TOL_BF16_REL, sorted(kw)
    assert _counts() == fp32_before


@pytest.mark.parametrize("offset", [1, 4], ids=["2 bytes", "8 bytes"])
def test_bf16_rows_read_and_write_unaligned_tensors(dev, offset):
    """K4-bf16's x and K6-bf16's residual and output starting ``offset``
    bf16 values into an allocation (W = 64, a multiple of 4): at 2 bytes
    the row passes take their scalar loads and stores, at 8 bytes their
    vector ones (four bf16 values are 8 bytes), each against its plain
    version."""
    n, c, h, w = 2, 8, 64, 64
    size = n * c * h * w
    a = _tiled_inputs(dev, 1, c, 2 * h, w + 1)
    view = lambda t: t.to(BF16).reshape(-1)[offset:offset + size].view(n, c, h, w)
    x, res = view(a["x"]), view(a["residual"])
    assert x.is_contiguous() and x.data_ptr() % 16 != 0 and res.data_ptr() % 16 != 0
    z = cs.rdft_w(x)
    want = torch.view_as_real(cs.rdft_w_reference(x))
    assert ((torch.view_as_real(z) - want).abs().max() / want.abs().max()).item() < TOL_REL
    zr = cs.rdft_w_reference(x)
    inout = torch.empty(size + offset, device=dev, dtype=BF16)[offset:].view(n, c, h, w)
    inout.copy_(res)
    from mtd_gan_tpu_torch.ops import _build

    lib = _build.spectral_staged_library()
    assert lib.staged_irdft_w_add_bf16(zr.data_ptr(), inout.data_ptr(), n, c, h, w,
                                       cs._device_twiddles(w, dev).data_ptr(),
                                       inout.data_ptr(),
                                       torch.cuda.current_stream().cuda_stream) == 0
    want = cs.irdft_w_add_reference(zr, res).float()
    for got in (cs.irdft_w_add(zr, res), inout):
        assert ((got.float() - want).abs().max() / want.abs().max()).item() < TOL_BF16_REL


@pytest.mark.parametrize("with_res", [False, True], ids=["branch", "residual"])
@pytest.mark.parametrize("n,c,h,w", [(4, 32, 96, 96), (2, 32, 100, 72), (2, 32, 127, 127),
                                     (2, 8, 33, 27)])
def test_k7_bf16_matches_plain_version(dev, n, c, h, w, with_res):
    """K7-bf16 (``spectral_branch_fused`` on a bf16 x and residual) against
    its bf16 plain version on 1/sqrt(fan_in) weights: one launch a call,
    counted in ``launches_bf16`` and no fp32 launch, two calls bit for bit,
    the branch rounded to bf16 before the residual is added. 127^2 at C =
    32 keeps its spectrum in the device-memory scratch; W = 27 and 127 are
    no multiple of 4 (the scalar row paths)."""
    a = {k: v.to(BF16) if k in ("x", "residual") else v
         for k, v in _tiled_inputs(dev, n, c, h, w).items()}
    args = (a["x"], a["mix"], a["bias"], a["residual"] if with_res else None)
    fp32_before = _counts()
    before = spectral_branch_fused.launches_bf16
    got = spectral_branch_fused(*args)
    again = spectral_branch_fused(*args)
    torch.cuda.synchronize()
    assert spectral_branch_fused.launches_bf16 == before + 2 and _counts() == fp32_before
    assert got.dtype == BF16 and torch.equal(got, again)
    want = spectral_branch_fused_reference(*args)
    err = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
    assert err < TOL_BF16_REL


@pytest.mark.parametrize("offset", [1, 4], ids=["2 bytes", "8 bytes"])
def test_k7_bf16_reads_and_writes_unaligned_tensors(dev, offset):
    """K7-bf16's x, residual and output starting ``offset`` bf16 values
    into an allocation (W = 64): at 2 bytes the rows take their scalar
    loads and stores, at 8 bytes their vector ones."""
    n, c, h, w = 2, 8, 32, 64
    size = n * c * h * w
    a = _tiled_inputs(dev, 1, c, 2 * h, w + 1)
    view = lambda t: t.to(BF16).reshape(-1)[offset:offset + size].view(n, c, h, w)
    x, res = view(a["x"]), view(a["residual"])
    assert x.is_contiguous() and x.data_ptr() % 16 != 0 and res.data_ptr() % 16 != 0
    got = spectral_branch_fused(x, a["mix"], a["bias"], res)
    want = spectral_branch_fused_reference(x, a["mix"], a["bias"], res).float()
    assert ((got.float() - want).abs().max() / want.abs().max()).item() < TOL_BF16_REL


@pytest.mark.parametrize("act", ["fp32", "bf16"])
@pytest.mark.parametrize("n,c,h,w", [(2, 32, 1024, 1024), (2, 8, 449, 130), (2, 16, 200, 200),
                                     (1, 8, 33, 27)])
def test_bf16_spectra_match_plain_versions(dev, n, c, h, w, act):
    """K4-bf16s, K5-bf16s and K6-bf16s (``bound_dtype`` bf16: the spectrum
    in bf16 (Re, Im) pairs) on fp32 or bf16 activations, each fed the plain
    input and held against its plain version: one launch a call, counted in
    ``launches_bf16s`` and nowhere else; K5-bf16s two calls bit for bit;
    K6-bf16s also in place through the C entry. Where the output rounds to
    bf16 (the spectra; K6's bf16 sum) one bf16 unit (TOL_BF16_REL), K6's
    fp32 sum TOL_REL. H = 449 and 33 take K5's odd step in two buffers,
    W = 130 and 27 the rows' scalar paths."""
    from mtd_gan_tpu_torch.ops import _build

    a = _tiled_inputs(dev, n, c, h, w)
    if act == "bf16":
        a = {k: v.to(BF16) if k in ("x", "residual") else v for k, v in a.items()}
    rel = lambda g, r: ((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
    before = _counts() + [cs.rdft_w.launches_bf16, cs.irdft_w_add.launches_bf16]
    counted = (cs.rdft_w, cs.spectral_mix_h, cs.irdft_w_add)
    bf16s = [f.launches_bf16s for f in counted]
    z = cs.rdft_w(a["x"], BF16)
    zr = cs.rdft_w_reference(a["x"], BF16)
    t1, t2 = zr.clone(), zr.clone()
    cs.spectral_mix_h(t1, a["mix"], a["bias"])
    cs.spectral_mix_h(t2, a["mix"], a["bias"])
    tr = cs.spectral_mix_h_reference(zr, a["mix"], a["bias"])
    out = cs.irdft_w_add(tr, a["residual"])
    inout = a["residual"].clone()
    lib = _build.spectral_staged_library()
    assert lib.staged_irdft_w_add_bf16s(tr.data_ptr(), inout.data_ptr(), int(act == "bf16"),
                                        n, c, h, w, cs._device_twiddles(w, dev).data_ptr(),
                                        inout.data_ptr(),
                                        torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert [f.launches_bf16s - b for f, b in zip(counted, bf16s)] == [1, 2, 1]
    assert _counts() + [cs.rdft_w.launches_bf16, cs.irdft_w_add.launches_bf16] == before
    assert z.dtype == t1.dtype == BF16 and tuple(z.shape) == (n, c, w // 2 + 1, h, 2)
    assert rel(z, zr) < TOL_BF16_REL
    assert torch.equal(t1, t2) and rel(t1, tr) < TOL_BF16_REL
    want = cs.irdft_w_add_reference(tr, a["residual"])
    tol = TOL_BF16_REL if act == "bf16" else TOL_REL
    assert out.dtype == inout.dtype == a["residual"].dtype
    assert rel(out, want) < tol and rel(inout, want) < tol


def test_generate_bf16_at_96_runs_the_fused_route(dev):
    """A bf16 full-width generator at 96x96 takes the fused route: 21
    K7-bf16 and 42 K3-bf16 launches a call and no fp32 kernel launch;
    the output fp32, finite, within 5e-2 of the fp32 generator's (a gross
    bound, chip_smoke.py TOL_BF16_GENERATE_ABS)."""
    m16 = MTDGANModel(gen_features=32, num_layers=10, device=dev, seed=1, dtype=BF16)
    m32 = MTDGANModel(gen_features=32, num_layers=10, device=dev, seed=1)
    x = torch.rand((2, 96, 96, 1), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(0))
    fp32_before = _counts()
    before = (spectral_branch_fused.launches_bf16, cs.conv3x3.launches_bf16)
    got = m16.generate(x)
    torch.cuda.synchronize()
    assert (spectral_branch_fused.launches_bf16 - before[0],
            cs.conv3x3.launches_bf16 - before[1]) == (21, 42)
    assert _counts() == fp32_before
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert (got - m32.generate(x)).abs().max().item() < 5e-2


def test_k4_reads_an_unaligned_input(dev):
    """x whose data does not start on 16 bytes: K4 takes its scalar loads
    (same result)."""
    flat = _tiled_inputs(dev, 1, 8, 64, 64 * 2 + 1)["x"].reshape(-1)
    x = flat[1:1 + 2 * 8 * 64 * 64].view(2, 8, 64, 64)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    want = torch.view_as_real(cs.rdft_w_reference(x))
    got = torch.view_as_real(cs.rdft_w(x))
    assert ((got - want).abs().max() / want.abs().max()).item() < TOL_REL


def test_k4_k5_k6_reject_unsupported_calls(dev):
    a = _tiled_inputs(dev, 1, 8, 64, 64)
    z = cs.rdft_w(a["x"])
    with pytest.raises(ValueError, match="C in"):
        cs.rdft_w(_tiled_inputs(dev, 1, 24, 64, 64)["x"])
    with pytest.raises(ValueError, match="2 <= H, W <= 1024"):
        cs.rdft_w(torch.zeros((1, 8, 1025, 64), device=dev))
    with pytest.raises(ValueError, match="2 <= H, W <= 1024"):
        cs.spectral_mix_h(torch.zeros((1, 8, 33, 1025), device=dev, dtype=torch.complex64),
                          a["mix"], a["bias"])
    with pytest.raises(ValueError, match="inference only"):
        cs.spectral_mix_h(z, a["mix"].clone().requires_grad_(), a["bias"])
    with pytest.raises(ValueError, match="complex64"):
        cs.irdft_w_add(torch.view_as_real(z).contiguous(), a["residual"])


def test_generate_at_200_runs_the_staged_route(dev):
    """Full-width generator at 200x200 (outside K1's, K8's and K7's
    domains): the staged generator, 42 K3 and 21 each of K4, K5 and K6,
    no K1, K8 or K7, within 1e-5 of the plain module (reference init)."""
    model = MTDGANModel(gen_features=32, num_layers=10, device=dev, seed=1)
    x = torch.rand((2, 200, 200, 1), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(0))
    before = _counts()
    got = model.generate(x)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_counts(), before)] == [0, 0, 0, 0, 42, 21, 21, 21]
    with torch.no_grad():
        want = model.generator(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert (got - want).abs().max().item() < 1e-5


@pytest.mark.parametrize("features,shape", [(64, (2, 96, 96, 1)), (32, (1, 1, 64, 1))])
def test_generate_plain_route_launches_nothing(dev, features, shape):
    """A width no kernel takes, or a side of 1: the plain module on the
    card, no kernel launch, within 1e-3 of the module on the CPU."""
    model = MTDGANModel(gen_features=features, num_layers=2, device=dev, seed=1)
    x = torch.rand(shape, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    before = _counts()
    got = model.generate(x)
    torch.cuda.synchronize()
    assert _counts() == before
    cpu = MTDGANModel(gen_features=features, num_layers=2, device="cpu", seed=1)
    assert (got.cpu() - cpu.generate(x.cpu())).abs().max().item() < 1e-3


def test_train_step_at_width_64_runs_no_kernel(dev):
    """gen_features=64 (K1 + K2 take C in {8, 16, 32}): the train step runs
    the plain generator under autograd, no K1 or K2 launch, finite losses."""
    model = MTDGANModel(gen_features=64, disc_features=16, num_layers=2, device=dev)
    trainer = MTDGANTrainer(model, method="pcgrad", seed=0)
    x = torch.rand((4, 64, 64, 1), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(0))
    before = _counts()
    m = trainer.train_step(x, (x + 0.01).clamp(0, 1))
    torch.cuda.synchronize()
    assert _counts() == before
    assert torch.isfinite(m["d_loss"]) and torch.isfinite(m["g_loss"])


def test_prefetch_to_device_gives_the_loader_batches_in_order(dev):
    """The device prefetcher (pinned host copies on a side stream) hands out
    the batches the host loader gives, in order, on the card; a kernel on
    the consumer's stream between batches sees each batch complete."""
    from mtd_gan_tpu_torch.data.pipeline import prefetch_to_device

    rng = np.random.default_rng(0)
    batches = [(rng.integers(-1000, 2000, (4, 256, 256, 1)).astype(np.int16),
                rng.integers(-1000, 2000, (4, 256, 256, 1)).astype(np.int16))
               for _ in range(6)]
    got = []
    for x, y in prefetch_to_device(iter(batches), dev, size=2):
        assert x.device.type == "cuda" and x.dtype == torch.int16
        got.append((x.double().sum().item(), y.cpu().numpy()))
    assert len(got) == len(batches)
    for (s, y), (hx, hy) in zip(got, batches):
        assert s == float(hx.astype(np.float64).sum())
        np.testing.assert_array_equal(y, hy)


@torch.no_grad()
def test_feature_metrics_on_the_card_match_the_cpu(dev):
    """PL and TML per slice and the Inception pool3 features of the registry's
    extractors on the card (fp32, TF32 off) against the same extractors on
    the CPU in float64, at 256x256, batch 2 per column."""
    from mtd_gan_tpu_torch.features import registry
    from mtd_gan_tpu_torch.features.inception import inception_pool3_features
    from mtd_gan_tpu_torch.metrics import perceptual

    rng = np.random.default_rng(0)
    x, y, p = (torch.tensor(rng.random((2, 256, 256, 1)), dtype=torch.float32)
               for _ in range(3))
    vgg64 = copy.deepcopy(registry.get_extractor("vgg19", dev)).cpu().double()
    fn64 = lambda t: vgg64(registry.to_rgb_nchw(t))
    pl, tml = (t.cpu().double() for t in perceptual.pl_tml(
        x.to(dev), y.to(dev), p.to(dev), registry.get_vgg_slices_fn(dev)))
    pl64, tml64 = perceptual.pl_tml(x.double(), y.double(), p.double(), fn64)
    for got, want in ((pl, pl64), (tml, tml64)):
        assert torch.all(got[1] == 0) and torch.all(want[1] == 0)
        assert ((got[0::2] - want[0::2]).abs() / want[0::2].abs()).max() < TOL_REL
    inc = registry.get_extractor("inception", dev)
    inc64 = copy.deepcopy(inc).cpu().double()
    cat = torch.cat([x, y, p])
    got = inception_pool3_features(inc, cat.to(dev)).cpu().double()
    want = inception_pool3_features(inc64, cat.double())
    assert torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want) < TOL_REL


@torch.no_grad()
def test_diffusion_chunked_attention_matches_float64_at_65536_tokens(dev):
    """The diffusion UNet's attention (the plain version, over query chunks
    of 2048 above 4096 tokens) on one (1, 1, 65536, 256) input, the
    level-1 shape of a 512x512 slice, in fp32 on the card against the same
    in float64 on the card, within TOL_REL of the largest output."""
    from mtd_gan_tpu_torch.models.diffusion.unet import attention_plain

    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((1, 1, 65536, 256), generator=g, device=dev) for _ in range(3))
    got = attention_plain(q, k, v).double()
    want = attention_plain(q.double(), k.double(), v.double())
    assert ((got - want).abs().max() / want.abs().max()).item() < TOL_REL


@torch.no_grad()
def test_diffusion_ddim_chain_on_the_card_matches_the_cpu(dev):
    """A 3-step DDIM chain of the full-width UNet at 64x64 on the card and on
    the CPU from the same weights (every leaf drawn) and the same draws:
    within 1e-3 of the largest sample value (a step divides x0's error by
    sqrt(acp_t))."""
    from mtd_gan_tpu_torch.models.diffusion import DDIMModel

    cpu = DDIMModel(device="cpu", seed=1)
    g = torch.Generator().manual_seed(1)
    for p in cpu.net.parameters():
        p.copy_(torch.randn(p.shape, generator=g) / p[0].numel() ** 0.5 if p.dim() > 1
                else p + 0.1 * torch.randn(p.shape, generator=g))
    card = DDIMModel(device=dev, seed=1)
    card.net.load_state_dict(cpu.net.state_dict())
    cpu.n_inference_steps = card.n_inference_steps = 3
    cond = torch.rand((1, 64, 64, 1), generator=g)
    draws = {"noise": torch.randn((1, 64, 64, 1), generator=g)}
    want = cpu.sample(cond, draws=draws)
    got = card.sample(cond.to(dev), draws={"noise": draws["noise"].to(dev)}).cpu()
    assert ((got - want).abs().max() / want.abs().max()).item() < 1e-3


def test_one_rank_nccl_data_parallel_step_matches_the_single_step(dev):
    """A one-rank NCCL grid (no torchrun environment): the DataParallel
    PCGrad step on K1 + K2 equals the Single step bit for bit (a one-rank
    all-reduce copies, the mean divides by 1), and launches 21 K1 + 21 K2
    at 10 layers; the grid's process group is gone after ``destroy``. Both
    steps run under cuDNN's and PyTorch's deterministic algorithms, as
    chip_smoke.py's phase 30 runs them: without PyTorch's the
    discriminator's backward varies ~1e-7 from call to call, which AdamW's
    first step turns into a parameter difference at a near-zero gradient."""
    from mtd_gan_tpu_torch.parallel import mesh

    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.random((8, 64, 64, 1)), dtype=torch.float32, device=dev)
    y = (x + 0.05 * torch.randn(x.shape, generator=torch.Generator().manual_seed(1))
         .to(dev)).clamp(0, 1)
    base = MTDGANModel(gen_features=8, disc_features=8, num_layers=10, device="cuda", seed=0)
    grid = mesh.make_grid("DataParallel", device="cuda")
    try:
        assert (grid.world, grid.data_size, grid.device.type) == (1, 1, "cuda")
        results = []
        for g in (None, grid):
            trainer = MTDGANTrainer(copy.deepcopy(base), method="pcgrad", seed=0, grid=g)
            block_fused.launches = block_bwd.launches = 0
            m = trainer.train_step(x, y)
            torch.cuda.synchronize()
            assert (block_fused.launches, block_bwd.launches) == (21, 21)
            results.append((m, trainer.model))
    finally:
        mesh.destroy(grid)
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)
    assert not torch.distributed.is_initialized()
    (m_single, single), (m_dp, dp) = results
    for k in m_single:
        assert m_dp[k].item() == m_single[k].item(), k
    for net in ("generator", "discriminator"):
        for (name, a), (_, b) in zip(getattr(dp, net).state_dict().items(),
                                     getattr(single, net).state_dict().items()):
            assert torch.equal(a, b), name
