"""The fused generator path of the PyTorch port (mtd_gan_tpu_torch/ops/
cuda_fftconv.py K7 wrapper, the ``"fused"`` impl of ops/fft_conv.py and
models/mtd_gan.py's fused view) against the JAX package's K7
(``spectral_branch_fused``) and its ``ResFFTGenerator(spectral_impl=
"pallas_fused")`` on the CPU, with the JAX kernel in interpret mode."""

import jax
import numpy as np
import pytest
import torch

from mtd_gan_tpu.models.mtd_gan import MTDGANModel as JaxModel
from mtd_gan_tpu.models.mtd_gan import ResFFTGenerator as JaxGenerator
from mtd_gan_tpu.ops.pallas_fftconv import spectral_branch_fused as jax_fused
from mtd_gan_tpu_torch.models.mtd_gan import MTDGANModel, ResFFTGenerator
from mtd_gan_tpu_torch.ops.cuda_fftconv import (spectral_branch_fused,
                                                spectral_branch_fused_reference)
from mtd_gan_tpu_torch.ops.fft_conv import FFTConvBlock, fft_conv_block, spectral_branch
from mtd_gan_tpu_torch.utils.torch_import import generator_state_dict_from_flax

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

# (N, H, W, C): odd H and odd W among them
K7_SHAPES = [(2, 40, 36, 8), (1, 33, 27, 4)]


@pytest.fixture(scope="module", params=K7_SHAPES, ids=lambda s: "x".join(map(str, s)))
def k7_case(request):
    """Seeded NHWC inputs and the JAX K7 (precision "highest", interpret
    mode), computed once per shape."""
    n, h, w, c = request.param
    rng = np.random.default_rng(0)
    x = rng.random((n, h, w, c)).astype(np.float32)
    mix = (rng.standard_normal((2 * c, 2 * c)) / np.sqrt(2 * c)).astype(np.float32)
    bias = (rng.standard_normal(2 * c) * 0.1).astype(np.float32)
    want = np.asarray(jax_fused(x, mix, bias, precision="highest", interpret=True))
    return dict(x=x, mix=mix, bias=bias, want=want)


def test_plain_k7_matches_jax_k7(k7_case):
    """spectral_branch_fused_reference (NCHW; the flax mix (2C_in, 2C_out)
    is the port's transpose) against the JAX K7 at max abs <= 1e-5 of
    max |want| (fp32 FFTs against fp32 DFT matmuls: ~1e-7 relative)."""
    c = k7_case
    got = spectral_branch_fused_reference(
        torch.tensor(c["x"]).permute(0, 3, 1, 2).contiguous(),
        torch.tensor(c["mix"].T.copy()), torch.tensor(c["bias"])
    ).permute(0, 2, 3, 1).numpy()
    want = c["want"]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_plain_k7_with_residual_matches_jax_k7_plus_residual(k7_case):
    """The plain K7 with a residual (NCHW) against the JAX K7 plus the same
    residual, at the tolerance of test_plain_k7_matches_jax_k7 on the
    residual-free part; without one it is the plain spectral branch bit
    for bit."""
    c = k7_case
    nchw = lambda a: torch.tensor(a).permute(0, 3, 1, 2).contiguous()
    x, mix, bias = nchw(c["x"]), torch.tensor(c["mix"].T.copy()), torch.tensor(c["bias"])
    res = np.random.default_rng(5).standard_normal(c["x"].shape).astype(np.float32)
    got = spectral_branch_fused_reference(x, mix, bias, nchw(res)).permute(0, 2, 3, 1).numpy()
    want = c["want"] + res
    assert np.abs(got - want).max() <= 1e-5 * np.abs(c["want"]).max() + 1e-6
    assert torch.equal(spectral_branch_fused_reference(x, mix, bias, None),
                       spectral_branch(x, mix, bias))


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.random((2, 8, 33, 27)), dtype=torch.float32)
    mix = torch.tensor(rng.standard_normal((16, 16)), dtype=torch.float32)
    bias = torch.tensor(rng.standard_normal(16), dtype=torch.float32)
    res = torch.tensor(rng.standard_normal((2, 8, 33, 27)), dtype=torch.float32)
    before = spectral_branch_fused.launches
    got = spectral_branch_fused(x, mix, bias)
    got_res = spectral_branch_fused(x, mix, bias, residual=res)
    assert spectral_branch_fused.launches == before
    assert torch.equal(got, spectral_branch_fused_reference(x, mix, bias))
    assert torch.equal(got_res, spectral_branch_fused_reference(x, mix, bias, res))
    with pytest.raises(ValueError, match="unsupported device"):
        spectral_branch_fused(x.to("meta"), mix.to("meta"), bias.to("meta"))


L, F, GEN_SHAPE = 1, 8, (2, 96, 80, 1)


@pytest.fixture(scope="module")
def fused_generator_case():
    """flax params with 1/sqrt(fan_in) weights and 0.1 biases (so the
    spectral branch is not negligible), a seeded input, and the JAX
    ResFFTGenerator(spectral_impl="pallas_fused") output (interpret mode,
    its default tf32 emulation)."""
    x = np.random.default_rng(2).random(GEN_SHAPE).astype(np.float32)
    jm = JaxModel(gen_features=F, disc_features=8, num_layers=L)
    params = jax.jit(jm.Generator.init)(jax.random.PRNGKey(0), x)["params"]
    rng = np.random.default_rng(3)

    def redraw(path, leaf):
        if "bias" in jax.tree_util.keystr(path):
            return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)
        fan_in = leaf.shape[0] if leaf.ndim == 2 else int(np.prod(leaf.shape[:3]))
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(redraw, params)
    fused = JaxGenerator(features=F, num_layers=L, spectral_impl="pallas_fused")
    want = np.asarray(fused.apply({"params": params}, x))
    return params, x, want


@pytest.mark.parametrize("which", ["module", "model_view"])
def test_fused_generator_matches_jax_pallas_fused_generator(fused_generator_case, which):
    """The port's fused generator on the CPU against the JAX pallas_fused
    generator at 1e-4 max abs (the JAX fused generator sits 2.9e-5 from its
    auto path here). Weights go through generator_state_dict_from_flax
    unchanged: into ResFFTGenerator(spectral_impl="fused") directly, or
    into MTDGANModel.generator, whose fused view shares them."""
    params, x, want = fused_generator_case
    sd = generator_state_dict_from_flax(params)
    if which == "module":
        gen = ResFFTGenerator(1, F, L, spectral_impl="fused")
        gen.load_state_dict(sd, strict=True)
    else:
        model = MTDGANModel(gen_features=F, num_layers=L, device="cpu")
        model.generator.load_state_dict(sd, strict=True)
        gen = model.generator_fused
        for name, t in gen.state_dict().items():
            assert t.data_ptr() == model.generator.state_dict()[name].data_ptr(), name
    with torch.no_grad():
        got = gen(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == GEN_SHAPE
    assert np.abs(got - want).max() <= 1e-4


def test_fft_conv_block_fused_equals_auto_on_cpu():
    """On CPU tensors the fused impl runs the same plain ops as "auto";
    the blocks' parameters have the same names."""
    rng = np.random.default_rng(4)
    auto, fused = FFTConvBlock(8), FFTConvBlock(8, spectral_impl="fused")
    assert list(fused.state_dict()) == list(auto.state_dict())
    fused.load_state_dict(auto.state_dict(), strict=True)
    x = torch.tensor(rng.random((2, 8, 33, 27)), dtype=torch.float32)
    with torch.no_grad():
        assert torch.equal(fused(x), auto(x))


@pytest.mark.parametrize("conv_impl", ["torch", "k3"])
def test_fft_conv_block_function_fused_equals_auto_on_cpu(conv_impl):
    """fft_conv_block(impl="fused"), which hands the block's residual to
    K7's wrapper, equals impl="auto" bit for bit on CPU tensors, with the
    3x3 conv branch on F.conv2d or on K3's plain version."""
    rng = np.random.default_rng(6)
    t = lambda *shape: torch.tensor(rng.standard_normal(shape) * 0.2, dtype=torch.float32)
    x, w, b, mix, mb = t(2, 8, 20, 17), t(8, 8, 3, 3), t(8), t(16, 16), t(16)
    with torch.no_grad():
        fused = fft_conv_block(x, w, b, mix, mb, impl="fused", conv_impl=conv_impl)
        auto = fft_conv_block(x, w, b, mix, mb, impl="auto", conv_impl=conv_impl)
    assert torch.equal(fused, auto)
