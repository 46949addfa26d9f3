"""The tiled generator path of the PyTorch port (mtd_gan_tpu_torch/ops/
cuda_fftconv.py, the ``"tiled"`` impl of ops/fft_conv.py and
models/mtd_gan.py's tiled view and routing) against the JAX package's K8
(``spectral_branch_tiled``) and ``GeneratorTiled`` on the CPU, with the
JAX kernels in interpret mode."""

import jax
import numpy as np
import pytest
import torch

from mtd_gan_tpu.models.mtd_gan import MTDGANModel as JaxModel
from mtd_gan_tpu.ops.pallas_fftconv import spectral_branch_tiled as jax_tiled
from mtd_gan_tpu_torch.models.mtd_gan import (MTDGANModel, ResFFTGenerator,
                                              generate_route)
from mtd_gan_tpu_torch.ops.cuda_fftconv import (in_fused_domain, in_tiled_domain,
                                                spectral_branch_tiled,
                                                spectral_branch_tiled_reference)
from mtd_gan_tpu_torch.ops.fft_conv import FFTConvBlock
from mtd_gan_tpu_torch.utils.torch_import import generator_state_dict_from_flax

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

# (N, H, W, C) and the JAX kernel's H-tile th
K8_SHAPES = [((1, 48, 40, 4), 24), ((2, 64, 96, 8), 32)]


@pytest.fixture(scope="module", params=K8_SHAPES, ids=lambda p: "x".join(map(str, p[0])))
def k8_case(request):
    """Seeded NHWC inputs and the JAX K8 (precision "highest", interpret
    mode) with and without the residual, computed once per shape."""
    (n, h, w, c), th = request.param
    rng = np.random.default_rng(0)
    x = rng.random((n, h, w, c)).astype(np.float32)
    mix = (rng.standard_normal((2 * c, 2 * c)) / np.sqrt(2 * c)).astype(np.float32)
    bias = (rng.standard_normal(2 * c) * 0.1).astype(np.float32)
    res = rng.standard_normal((n, h, w, c)).astype(np.float32)
    call = lambda r: np.asarray(jax_tiled(x, mix, bias, residual=r, precision="highest",
                                          th=th, tk=128, interpret=True))
    return dict(x=x, mix=mix, bias=bias, res=res,
                want={False: call(None), True: call(res)})


@pytest.mark.parametrize("with_res", [False, True])
def test_plain_k8_matches_jax_k8(k8_case, with_res):
    """spectral_branch_tiled_reference (NCHW; the flax mix (2C_in, 2C_out)
    is the port's transpose) against the JAX K8 at max abs <= 1e-5 of
    max |want| (fp32 FFTs against fp32 DFT matmuls: ~1e-7 relative)."""
    nchw = lambda a: torch.tensor(a).permute(0, 3, 1, 2).contiguous()
    c = k8_case
    got = spectral_branch_tiled_reference(
        nchw(c["x"]), torch.tensor(c["mix"].T.copy()), torch.tensor(c["bias"]),
        nchw(c["res"]) if with_res else None).permute(0, 2, 3, 1).numpy()
    want = c["want"][with_res]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.random((1, 8, 64, 32)), dtype=torch.float32)
    mix = torch.tensor(rng.standard_normal((16, 16)), dtype=torch.float32)
    bias = torch.zeros(16)
    before = spectral_branch_tiled.launches
    got = spectral_branch_tiled(x, mix, bias, residual=x)
    assert spectral_branch_tiled.launches == before
    assert torch.equal(got, spectral_branch_tiled_reference(x, mix, bias, x))
    with pytest.raises(ValueError, match="unsupported device"):
        spectral_branch_tiled(x.to("meta"), mix.to("meta"), bias.to("meta"))


L, F, GEN_SHAPE = 1, 8, (1, 64, 96, 1)


@pytest.fixture(scope="module")
def tiled_generator_case():
    """flax params with 1/sqrt(fan_in) weights and 0.1 biases (so the
    spectral branch is not negligible), a seeded input, and the JAX
    GeneratorTiled output (pallas_tiled, interpret mode, tf32 emulation)."""
    jm = JaxModel(gen_features=F, disc_features=8, num_layers=L)
    x = np.random.default_rng(2).random(GEN_SHAPE).astype(np.float32)
    params = jax.jit(jm.Generator.init)(jax.random.PRNGKey(0), x)["params"]
    rng = np.random.default_rng(3)

    def redraw(path, leaf):
        if "bias" in jax.tree_util.keystr(path):
            return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)
        fan_in = leaf.shape[0] if leaf.ndim == 2 else int(np.prod(leaf.shape[:3]))
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(redraw, params)
    want = np.asarray(jm.GeneratorTiled.apply({"params": params}, x))
    return params, x, want


@pytest.mark.parametrize("which", ["module", "model_view"])
def test_tiled_generator_matches_jax_generator_tiled(tiled_generator_case, which):
    """The port's tiled generator on the CPU against JAX's GeneratorTiled
    at 1e-4 max abs (the JAX package pins its tiled generator to 1e-4,
    tests/test_pallas_fftconv.py). Weights go through
    generator_state_dict_from_flax unchanged: into
    ResFFTGenerator(spectral_impl="tiled") directly, or into
    MTDGANModel.generator, whose tiled view shares them."""
    params, x, want = tiled_generator_case
    sd = generator_state_dict_from_flax(params)
    if which == "module":
        gen = ResFFTGenerator(1, F, L, spectral_impl="tiled")
        gen.load_state_dict(sd, strict=True)
    else:
        model = MTDGANModel(gen_features=F, num_layers=L, device="cpu")
        model.generator.load_state_dict(sd, strict=True)
        gen = model.generator_tiled
        for name, t in gen.state_dict().items():
            assert t.data_ptr() == model.generator.state_dict()[name].data_ptr(), name
    with torch.no_grad():
        got = gen(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == GEN_SHAPE
    assert np.abs(got - want).max() <= 1e-4


@pytest.mark.parametrize("h,w,route", [
    (64, 64, "k1"), (512, 512, "k1"), (448, 448, "tiled"), (384, 384, "k1"),
    (704, 704, "tiled"), (512, 320, "tiled"), (192, 192, "tiled"), (100, 100, "fused"),
    (96, 96, "fused"),
    (64, 127, "fused"), (33, 33, "fused"), (448, 449, "staged"), (832, 832, "staged"),
    (129, 129, "staged")])
def test_generate_route(h, w, route):
    if route == "staged":
        # neither K8 nor K7 takes them: the staged generator (K3 - K6) does
        assert not in_tiled_domain(h, w) and not in_fused_domain(h, w)
    assert generate_route(h, w, 32) == route


def test_fft_conv_block_tiled_equals_auto_on_cpu():
    """On CPU tensors the tiled impl runs the same plain ops as "auto";
    the blocks' parameters have the same names."""
    rng = np.random.default_rng(4)
    auto, tiled = FFTConvBlock(8), FFTConvBlock(8, spectral_impl="tiled")
    tiled.load_state_dict(auto.state_dict(), strict=True)
    x = torch.tensor(rng.random((2, 8, 64, 40)), dtype=torch.float32)
    with torch.no_grad():
        assert torch.equal(tiled(x), auto(x))
    # the JAX name stays unknown to the port, whose name is "fused"
    with pytest.raises(ValueError, match="spectral_impl"):
        FFTConvBlock(8, spectral_impl="pallas_fused")


def test_tiled_view_follows_updates_of_the_generator():
    """One set of parameters: an in-place update through the generator
    shows in the tiled view, and the CPU generate equals the view's output."""
    model = MTDGANModel(gen_features=F, num_layers=L, device="cpu", seed=5)
    assert list(model.generator_tiled.state_dict()) == list(model.generator.state_dict())
    with torch.no_grad():
        model.generator.enforce[0].fft_conv.bias.add_(1.0)
    assert torch.equal(model.generator_tiled.enforce[0].fft_conv.bias,
                       model.generator.enforce[0].fft_conv.bias)
    x = torch.tensor(np.random.default_rng(6).random((1, 64, 48, 1)), dtype=torch.float32)
    with torch.no_grad():
        view = model.generator_tiled(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert torch.equal(model.generate(x), view)
