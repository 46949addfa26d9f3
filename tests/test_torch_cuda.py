"""The hand-written CUDA kernels K1 (mtd_gan_tpu_torch/csrc/block_fused.cu),
K2 (csrc/block_bwd.cu), K8 (csrc/spectral_tiled.cu), K7
(csrc/spectral_fused.cu), K3 (csrc/conv3x3.cu) and K4 - K6
(csrc/spectral_staged.cu; K5's and K8's column pass is csrc/columns_mixed.cuh)
against their plain PyTorch versions, the
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

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

VARIANTS = ("plain", "pre", "pre+skip", "pre+skip+post")
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


def _inputs(dev, variant, c, size, n=2, seed=0):
    """std 1/sqrt(fan_in) weights, 0.1 biases, channel-major activations."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    w = lambda *s: t(rng.standard_normal(s) / np.sqrt(np.prod(s[1:])))
    b = lambda k: t(rng.standard_normal(k) * 0.1)
    hw = size * size
    args = dict(x=t(rng.random((n, c, hw))), h=size, w=size, km=w(c, c, 3, 3),
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
    with pytest.raises(ValueError, match="contiguous float32"):
        block_fused(**{**args, "x": args["x"].double()})


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


def _bwd_inputs(dev, variant, c, n, seed, margin=False):
    """K1's inputs plus seeded cotangents g (of out) and gfin (of final).
    ``margin``: every bias +-5 (and the res and post conv weights x0.05), so
    each ReLU's pre-activation keeps its sign far from zero and no mask
    depends on summation order."""
    args = _inputs(dev, variant, c, 64, n=n, seed=seed)
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
    args["g"] = t(rng.standard_normal((n, c, 64 * 64)))
    if "post" in variant:
        args["gfin"] = t(rng.standard_normal((n, 1, 64 * 64)))
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


@pytest.mark.parametrize("margin", [True, False])
@pytest.mark.parametrize("c,n", [(8, 2), (32, 2), (32, 8), (32, 20)])
@pytest.mark.parametrize("variant", VARIANTS)
def test_k2_matches_plain_version(dev, variant, c, n, margin):
    """Every output of K2 against block_bwd_reference, and the kernel
    repeats bit for bit (no float atomics). At batch 20 the persistent
    weight-gradient and column launches give some blocks more than one
    band or bin (320 bands, 660 bins over 264 blocks)."""
    args = _bwd_inputs(dev, variant, c, n, seed=VARIANTS.index(variant), margin=margin)
    before = block_bwd.launches
    got = block_bwd(**args)
    again = block_bwd(**args)
    torch.cuda.synchronize()
    assert block_bwd.launches == before + 2
    want = block_bwd_reference(**args)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        d = got[name] - w
        if margin:
            rel = (d.abs().max() / w.abs().max().clamp_min(1e-30)).item()
            assert rel < TOL_REL, (variant, c, n, name, rel)
        else:
            rel = (d.norm() / w.norm().clamp_min(1e-30)).item()
            assert rel < TOL_BWD_L2, (variant, c, n, name, rel)
        assert torch.equal(got[name], again[name]), name


def test_k2_rejects_unsupported_shapes(dev):
    args = _bwd_inputs(dev, "plain", 8, 2, seed=0)
    with pytest.raises(ValueError, match="H == W"):
        block_bwd(**{**args, "x": torch.zeros((2, 8, 32 * 32), device=dev),
                     "h": 32, "w": 32})
    with pytest.raises(ValueError, match="contiguous float32"):
        block_bwd(**{**args, "g": args["g"].double()})


@pytest.mark.parametrize("c", [8, 32])
@pytest.mark.parametrize("variant", VARIANTS[1:])
def test_k2_recomputes_k1_forward_bit_for_bit(dev, variant, c):
    """K2 recomputes the forward it differentiates with K1's own launches:
    its hin equals K1's pre conv output bit for bit (every variant with
    pre), and on the last block its out equals K1's out, so the ReLU masks
    K2 applies are the ones K1's forward took."""
    args = _bwd_inputs(dev, variant, c, 2, seed=VARIANTS.index(variant))
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
