"""K1's and K2's bf16 variants on the CPU: their plain versions through the
port's training path against the JAX K2 path at ``act_dtype=bfloat16``
(``pallas_train.resfft_generator_train`` in interpret mode); the
arithmetic of K3's bf16 operand path (``csrc/conv3x3_tc.cuh``: B staged in
bf16 in its K-major core matrices, A's 8-k groups paired into k16 steps,
one product a step, fp32 sums) and of K2's bf16 weight-gradient GEMM
(``csrc/block_bwd.cu``, ``mma.sync`` m16n8k16 over 16 pixels a step),
emulated in float32 against float64; and the routes a bf16 model takes.
The kernels themselves run only on the card (``chip_smoke.py`` phase 31).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mtd_gan_tpu.models.mtd_gan import MTDGANModel as JaxModel
from mtd_gan_tpu.ops.pallas_train import resfft_generator_train as jax_generator_train
from mtd_gan_tpu_torch.models.mtd_gan import MTDGANModel, ResFFTGenerator, generate_route
from mtd_gan_tpu_torch.ops import cuda_pipeline, cuda_train
from mtd_gan_tpu_torch.ops.cuda_pipeline import resfft_generator_nchw
from mtd_gan_tpu_torch.ops.cuda_train import (resfft_generator_train, resolve_g_forward,
                                              train_route)
from mtd_gan_tpu_torch.utils.torch_import import generator_state_dict_from_flax
from test_torch_tc_helpers import _bf16, _bf16_tc_conv

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

BF16 = torch.bfloat16


def _grads(gen, x, y):
    out = resfft_generator_train(gen, torch.tensor(x))
    loss = ((out - torch.tensor(y)) ** 2).mean()
    names, params = zip(*gen.named_parameters())
    return out.detach(), dict(zip(names, torch.autograd.grad(loss, params)))


def test_bf16_train_path_grads_match_jax_k2_path():
    """The port's bf16 training path (``BlockTrain`` on K1-bf16's and
    K2-bf16's plain versions) against the JAX K2 path at
    ``act_dtype=bfloat16`` in interpret mode, as
    ``test_torch_train_block.py`` holds the fp32 path: JAX init, L = 2, 8
    features, 4 x 16 x 16, every gradient leaf within the worst-leaf 5e-2
    relative of the JAX package's own bound (tests/test_pallas_train.py:66),
    or within twice the JAX bf16 path's own error against the fp32 gradient
    (``jax.grad`` of the fp32 ``Generator.apply``) where that is larger,
    the budget of test_torch_bf16_models.py: two leaves need it. The entry
    conv's bias, whose gradient the JAX path sums in bf16 (XLA's reduction
    of the cotangent of ``b0.astype(bf16)``, outside K2) 0.14 off the fp32
    one (the port's 2e-3); and the middle block's spectral bias (~1e-6 at
    this init, its ReLUs near zero), 4.9e-2 off in the JAX bf16 path and
    4.8e-2 in the JAX kernel path at fp32 activations. The port's bf16
    output differs from its fp32 one (bf16 did round), its output and every
    parameter and gradient are fp32."""
    jm = JaxModel(gen_features=8, disc_features=8, num_layers=2, dtype=jnp.float32)
    params = jax.jit(jm.Generator.init)(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 16, 16, 1), jnp.float32))["params"]
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (4, 16, 16, 1), jnp.float32))
    y = np.clip(x + 0.05, 0, 1)
    host = lambda tree: generator_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, tree))
    want = host(jax.jit(jax.grad(lambda p: jnp.mean((jax_generator_train(
        p, x, num_layers=2, act_dtype=jnp.bfloat16) - y) ** 2)))(params))
    fp32 = host(jax.jit(jax.grad(lambda p: jnp.mean(
        (jm.Generator.apply({"params": p}, x) - y) ** 2)))(params))
    state = generator_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    gens = {}
    for dtype in (None, BF16):
        gens[dtype] = ResFFTGenerator(1, 8, 2, dtype=dtype)
        gens[dtype].load_state_dict(state)
    before = (cuda_train.block_fused.launches_bf16, cuda_train.block_bwd.launches_bf16)
    out16, got = _grads(gens[BF16], x, y)
    out32, _ = _grads(gens[None], x, y)
    assert (cuda_train.block_fused.launches_bf16, cuda_train.block_bwd.launches_bf16) == before
    assert out16.dtype == torch.float32 and not torch.equal(out16, out32)
    assert all(p.dtype == torch.float32 for p in gens[BF16].parameters())
    rel = lambda a, b: float((a - b).abs().max() / (b.abs().max() + 1e-8))
    for k, w in want.items():
        assert got[k].dtype == torch.float32
        bound = max(5e-2, 2 * rel(w, fp32[k]))
        assert rel(got[k], w) < bound, (k, rel(got[k], w), bound)


# K3's bf16 operand path against the float64 conv of the same
# bf16-rounded operands: the products are exact in fp32, so only the fp32
# sums differ (measured ~3e-7 relative); against the float64 conv of the
# unrounded operands the bf16 rounding of the inputs and weights shows,
# ~2^-9 relative per operand (printed, not asserted)
TOL_BF16_SUMS = 1e-5


@pytest.mark.parametrize("c_in", [8, 16, 32])
@pytest.mark.parametrize("adjoint", [False, True], ids=["conv2d", "conv_transpose2d"])
def test_bf16_tc_conv_matches_float64(c_in, adjoint):
    """9 C_in is odd at C_in = 8: its last k16 step pairs the last 8-k
    group with zeros."""
    rng = np.random.default_rng(c_in)
    co = 16
    x = torch.tensor(rng.standard_normal((1, c_in, 20, 36)), dtype=torch.float32)
    shape = (c_in, co, 3, 3) if adjoint else (co, c_in, 3, 3)
    weight = torch.tensor(rng.standard_normal(shape) / np.sqrt(9 * c_in), dtype=torch.float32)
    conv = F.conv_transpose2d if adjoint else F.conv2d
    got = _bf16_tc_conv(x, weight, adjoint).double()
    want = conv(_bf16(x).double(), _bf16(weight).double(), padding=1)
    exact = conv(x.double(), weight.double(), padding=1)
    scale = want.abs().max().item()
    err = (got - want).abs().max().item() / scale
    print(f"bf16 tc conv C_in={c_in} {conv.__name__}: {err:.2e} against the rounded "
          f"operands, {(got - exact).abs().max().item() / scale:.2e} against the fp32 ones")
    assert err <= TOL_BF16_SUMS


def _bf16_wgrad(g: torch.Tensor, x: torch.Tensor, rows: int = 4) -> torch.Tensor:
    """K2's bf16 weight-gradient GEMM in float32: per band of ``rows``
    image rows a fresh accumulator over k16 steps of 16 pixels (A = g's
    C_out rows, B = the tap-shifted input's C_in columns, both bf16), the
    band added to the running partial. Returns (C_out, C_in, 3, 3)."""
    n, c_out, h, w = g.shape
    c_in = x.shape[1]
    xp = F.pad(_bf16(x), (1, 1, 1, 1))
    gb = _bf16(g)
    part = torch.zeros(c_out, c_in, 9)
    for b in range(n):
        for y0 in range(0, h, rows):
            band = torch.zeros(c_out, c_in, 9)
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                a = gb[b, :, y0:y0 + rows].reshape(c_out, -1)
                bm = xp[b, :, y0 + dy:y0 + dy + rows, dx:dx + w].reshape(c_in, -1)
                for p0 in range(0, rows * w, 16):
                    band[:, :, tap] += a[:, p0:p0 + 16] @ bm[:, p0:p0 + 16].T
            part = part + band
    return part.reshape(c_out, c_in, 3, 3)


def test_bf16_weight_gradient_matches_float64():
    """At K2's training geometry (64 columns: four k16 steps a row), the
    residual conv's shape (C -> C, a ReLU'd input, a half-zero cotangent),
    against the float64 weight gradient of the bf16-rounded operands."""
    rng = np.random.default_rng(5)
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    x = torch.relu(t(rng.random((2, 16, 8, 64))) - 0.5)
    g = t(rng.standard_normal((2, 16, 8, 64))) * t(rng.random((2, 16, 8, 64)) > 0.5)
    weight = torch.zeros((16, 16, 3, 3), dtype=torch.float64, requires_grad=True)
    out = F.conv2d(_bf16(x).double(), weight, padding=1)
    (want,) = torch.autograd.grad(out, weight, _bf16(g).double())
    err = (_bf16_wgrad(g, x).double() - want).abs().max().item() / want.abs().max().item()
    assert err <= TOL_BF16_SUMS


def test_bf16_routes():
    """A bf16 generator: ``generate`` takes K1-bf16 at K1's sizes, the tiled
    route (K8-bf16), the fused route (K7-bf16) and the staged route
    (K4-bf16 -> K5 -> K6-bf16) where they take the shape, each with
    K3-bf16, in the fp32 generator's order: a bf16 96^2 goes to the fused
    route, as the fp32 generator does; the plain module in bf16 at a width
    no kernel takes. The train step K1 + K2 where they take the batch, as
    fp32. On the CPU the K1 pipeline's bf16 plain version and the plain
    bf16 module are two bf16 functions, each within twice the other's error
    against fp32 (+ 1e-6)."""
    assert generate_route(512, 512, 32, BF16) == "k1"
    assert generate_route(64, 64, 8, BF16) == "k1"
    for h, w, c, route in ((448, 448, 32, "tiled"), (96, 96, 32, "fused"),
                           (1024, 1024, 32, "k1"), (960, 960, 32, "staged"),
                           (200, 200, 32, "staged"),
                           (512, 512, 64, "plain")):
        assert generate_route(h, w, c, BF16) == route, (h, w, c)
    assert generate_route(448, 448, 32) == "tiled"
    assert generate_route(96, 96, 32) == "fused"
    assert train_route(64, 64, 32) == "kernels" and train_route(128, 128, 32) == "autograd"
    assert resolve_g_forward("auto", 64, 64, 32) == "pallas"

    rng = np.random.default_rng(3)
    model = MTDGANModel(gen_features=8, num_layers=2, device="cpu", seed=0, dtype=BF16)
    with torch.no_grad():
        for p in model.generator.parameters():
            p.copy_(torch.tensor(rng.standard_normal(p.shape) / np.sqrt(p[0].numel())
                                 if p.dim() > 1 else 0.1 * rng.standard_normal(p.shape)))
    x = torch.tensor(rng.random((2, 32, 32, 1)), dtype=torch.float32)
    fp32 = ResFFTGenerator(1, 8, 2)
    fp32.load_state_dict(model.generator.state_dict())
    with torch.no_grad():
        want = fp32(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        plain = model.generate(x)
        k1 = resfft_generator_nchw(model.generator.state_dict(), x, 2, act_dtype=BF16)
    assert plain.dtype == k1.dtype == torch.float32
    e_plain = (plain - want).abs().max().item()
    e_k1 = (k1 - want).abs().max().item()
    assert 0 < e_k1 <= 2 * e_plain + 1e-6 and e_plain <= 2 * e_k1 + 1e-6, (e_k1, e_plain)
    assert cuda_pipeline.block_fused.launches_bf16 == 0
