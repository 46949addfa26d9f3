"""K7-bf16 on the bf16 fused route and the staged chain on bf16 spectra, on
the CPU: the plain K7-bf16 (mtd_gan_tpu_torch/ops/cuda_fftconv.py), the
bf16 fused block and the bf16 generator's fused view against the JAX
package's K7 (``spectral_branch_fused``), its ``pallas_fused`` block and
its bf16 ``pallas_fused`` generator; the plain K4, K6 and the staged block
with ``bound_dtype=torch.bfloat16`` (ops/cuda_staged.py, ops/fft_conv.py)
against the JAX stages and ``fft_block_nchw(fused=False,
bound_dtype=bfloat16)``. The Pallas kernels run in interpret mode; the
CUDA kernels only on the card (``chip_smoke.py`` phase 33).

Weights are drawn at N(0, 1/fan_in) with N(0, 0.1^2) biases, as in
tests/test_torch_bf16_routes.py, whose tolerances these are, with a bf16
unit the spacing of bf16 values at the largest output (2^-8 to 2^-7 of
it):

- where both sides round the same fp32 value once at the same point, one
  bf16 unit (a value at a midpoint rounds the other way in one of two
  summation orders);
- where neither side rounds, the fp32 tolerance of
  tests/test_torch_staged.py;
- otherwise (the flax layers round the conv, the bias and each residual
  add to bf16 apart; the JAX stage B casts its mix input and output to
  bf16), the bf16 budget: err(port bf16, JAX bf16) <= 2 err(JAX bf16, JAX
  fp32) + fp32 parity + 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtd_gan_tpu.models.mtd_gan import MTDGANModel as JaxModel
from mtd_gan_tpu.models.mtd_gan import ResFFTGenerator as JaxGenerator
from mtd_gan_tpu.ops import pallas_pipeline as pp
from mtd_gan_tpu.ops.fft_conv import fft_conv_block as jax_block
from mtd_gan_tpu.ops.pallas_fftconv import spectral_branch_fused as jax_fused
from mtd_gan_tpu_torch.models.mtd_gan import MTDGANModel
from mtd_gan_tpu_torch.ops import cuda_staged as cs
from mtd_gan_tpu_torch.ops.cuda_fftconv import (spectral_branch_fused,
                                                spectral_branch_fused_reference)
from mtd_gan_tpu_torch.ops.fft_conv import FFTConvBlock, fft_conv_block
from mtd_gan_tpu_torch.utils.torch_import import generator_state_dict_from_flax

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

BF16 = torch.bfloat16
JBF16 = jnp.bfloat16
# the fp32 tolerance of the plain K6 against the JAX stage C (tf32 factor
# packs): tests/test_torch_staged.py TOL_ROWS
TOL_ROWS = 2e-5


def unit(want) -> float:
    """One bf16 unit at the largest |want|: 2^(e - 7) for 2^e <= max < 2^(e+1)."""
    return 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)


def f32(a) -> np.ndarray:
    return a.float().numpy() if torch.is_tensor(a) else np.asarray(jnp.asarray(a, jnp.float32))


def max_abs(a, b) -> float:
    return float(np.abs(f32(a) - f32(b)).max())


def bf16_values(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16, as fp32."""
    return f32(jnp.asarray(a, JBF16))


def nchw(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(dtype)


def fan_in(rng, *shape, axes) -> np.ndarray:
    return (rng.standard_normal(shape) / np.sqrt(np.prod([shape[a] for a in axes]))
            ).astype(np.float32)


# ---------------------------------------------------------------- K7-bf16

# (N, H, W, C): odd H and odd W among them
K7_SHAPES = [(2, 40, 36, 8), (1, 33, 27, 8)]


@pytest.fixture(scope="module", params=K7_SHAPES, ids=lambda s: "x".join(map(str, s)))
def k7_case(request):
    """A bf16 NHWC x and residual, the spectral mix (flax layout) and bias,
    and the JAX K7 on the bf16 x (precision "highest", interpret mode),
    whose output is bf16."""
    n, h, w, c = request.param
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.random((n, h, w, c)), JBF16)
    res = jnp.asarray(rng.standard_normal((n, h, w, c)), JBF16)
    mix = fan_in(rng, 2 * c, 2 * c, axes=(0,))
    bias = (rng.standard_normal(2 * c) * 0.1).astype(np.float32)
    want = jax_fused(x, mix, bias, precision="highest", interpret=True)
    return dict(x=x, res=res, mix=mix, bias=bias, want=want)


def _port_k7(c, residual):
    nchw16 = lambda a: nchw(f32(a), BF16)
    return spectral_branch_fused_reference(
        nchw16(c["x"]), torch.tensor(c["mix"].T.copy()), torch.tensor(c["bias"]),
        nchw16(c["res"]) if residual else None).float().permute(0, 2, 3, 1).numpy()


def test_plain_k7_bf16_matches_jax_k7(k7_case):
    """spectral_branch_fused_reference on a bf16 x (no residual) against the
    JAX K7 on the same bf16 x: both take the branch in fp32 and round it
    once to bf16, so one bf16 unit."""
    c = k7_case
    assert str(c["want"].dtype) == "bfloat16"
    got = _port_k7(c, residual=False)
    assert max_abs(got, c["want"]) <= unit(f32(c["want"]))


def test_plain_k7_bf16_rounds_the_branch_before_the_residual(k7_case):
    """With a bf16 residual the plain K7-bf16 is the JAX fused block's ``res
    + spectral_branch_fused(x)``: the JAX branch (bf16) added to the bf16
    residual in bf16. The branches agree within one unit of the branch, so
    the sums within that plus one unit of the sum; rounding once instead
    (the tiled K8's order) is a different function, and the test tells the
    two apart on these inputs."""
    c = k7_case
    got = _port_k7(c, residual=True)
    want = f32(c["res"] + c["want"])
    assert max_abs(got, want) <= unit(f32(c["want"])) + unit(want)
    once = f32(jnp.asarray(f32(c["res"]) + np.asarray(jax_fused(
        c["x"].astype(jnp.float32), c["mix"], c["bias"], precision="highest",
        interpret=True)), JBF16))
    assert max_abs(got, once) > 0


def test_k7_wrapper_on_cpu_takes_bf16_and_counts_nothing():
    """On CPU tensors ``spectral_branch_fused`` runs the plain K7-bf16 on a
    bf16 x (it no longer refuses one) and counts no launch."""
    rng = np.random.default_rng(1)
    t = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.float32)
    x, res, mix, bias = t(2, 8, 33, 27).to(BF16), t(2, 8, 33, 27).to(BF16), t(16, 16), t(16)
    before = (spectral_branch_fused.launches, spectral_branch_fused.launches_bf16)
    got = spectral_branch_fused(x, mix, bias, residual=res)
    assert (spectral_branch_fused.launches, spectral_branch_fused.launches_bf16) == before
    assert got.dtype == BF16
    assert torch.equal(got, spectral_branch_fused_reference(x, mix, bias, res))


# ------------------------------------------------------- the fused block

N, C, H, W = 1, 8, 64, 64


@pytest.fixture(scope="module")
def block_weights():
    """A bf16-representable NHWC x, its unrounded draw, and the block's
    weights in the flax layout: HWIO conv kernel and bias, the spectral mix
    (2C_in, 2C_out) and bias."""
    rng = np.random.default_rng(4)
    x32 = rng.random((N, H, W, C)).astype(np.float32)
    return dict(x=bf16_values(x32), x32=x32, ik=fan_in(rng, 3, 3, C, C, axes=(0, 1, 2)),
                ib=(rng.standard_normal(C) * 0.1).astype(np.float32),
                fk=fan_in(rng, 2 * C, 2 * C, axes=(0,)),
                fb=(rng.standard_normal(2 * C) * 0.1).astype(np.float32))


def _port_block(b, x, impl, **kw):
    return fft_conv_block(x, torch.tensor(b["ik"].transpose(3, 2, 0, 1).copy()),
                          torch.tensor(b["ib"]), torch.tensor(b["fk"].T.copy()),
                          torch.tensor(b["fb"]), impl=impl, conv_impl="k3", **kw)


def test_bf16_fused_block_matches_jax_pallas_fused_block(block_weights):
    """The plain bf16 fused block (K3-bf16, then K7-bf16 with the block's
    residual: two roundings) against the JAX ``fft_conv_block(impl=
    "pallas_fused")`` on the same bf16 x (its K7 in interpret mode, its
    conv in XLA on bf16 operands, ``res + branch`` in bf16). The flax conv
    rounds the conv, the bias and the residual add apart where K3-bf16
    rounds once: the bf16 budget, with the fp32 parity of the fused block
    (the port's fp32 fused block against the JAX one, whose K7 runs its
    default tf32 emulation: 1.2e-5 measured here, held at the fused
    generator's 1e-4 of tests/test_torch_fused.py)."""
    b = block_weights
    got = _port_block(b, nchw(b["x"], BF16), "fused")
    args = [jnp.asarray(b[k]) for k in ("ik", "ib", "fk", "fb")]
    want = jax_block(jnp.asarray(b["x"], JBF16), *args, impl="pallas_fused")
    fp32 = jax_block(jnp.asarray(b["x"]), *args)
    parity = max_abs(_port_block(b, nchw(b["x"]), "fused").permute(0, 2, 3, 1),
                     jax_block(jnp.asarray(b["x"]), *args, impl="pallas_fused"))
    assert parity <= 1e-4
    assert got.dtype == BF16 and str(want.dtype) == "bfloat16"
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert max_abs(got, want) <= 2 * max_abs(want, fp32) + 1e-4 + 1e-6


def test_fft_conv_block_bound_dtype_is_staged_only():
    """``bound_dtype`` is the staged spectrum's type: fp32 or bf16, and bf16
    only with ``impl="staged"``."""
    for impl in ("auto", "tiled", "fused"):
        with pytest.raises(ValueError, match="needs spectral_impl 'staged'"):
            FFTConvBlock(8, impl, bound_dtype=BF16)
    with pytest.raises(ValueError, match="bound_dtype must be"):
        FFTConvBlock(8, "staged", bound_dtype=torch.float16)
    assert FFTConvBlock(8, "staged", bound_dtype=BF16).bound_dtype == BF16


# --------------------------------------------- the staged chain, bf16 spectra


@pytest.fixture(scope="module")
def stage_tables():
    """The JAX stage tables at H x W (tf32 factor packs, dense W factors,
    interpret mode)."""
    kp, tc, _, _, fwd_p, inv_p, _, _, _ = pp._spectral_tables(
        H, W, "tf32", use_ct_w=False, interpret=True)
    return dict(kp=kp, tc=tc, fwd_p=fwd_p, inv_p=inv_p)


def _jnp(x: np.ndarray, dtype) -> jnp.ndarray:
    """NHWC -> the JAX pipeline's (N, C, H*W)."""
    return jnp.asarray(x.transpose(0, 3, 1, 2).reshape(N, C, H * W), dtype)


@pytest.mark.parametrize("act", ["fp32", "bf16"])
def test_plain_k4_bf16s_matches_jax_stage_a(block_weights, stage_tables, act):
    """rdft_w_reference with ``bound_dtype`` bf16 against the JAX stage A
    at ``bound_dtype=bfloat16`` on the same x (fp32, or bf16): both round
    the fp32 spectrum once to bf16 (Re and Im apart), so one bf16 unit."""
    b, t = block_weights, stage_tables
    dtype = (torch.float32, jnp.float32) if act == "fp32" else (BF16, JBF16)
    x = b["x32"] if act == "fp32" else b["x"]
    z = cs.rdft_w_reference(nchw(x, dtype[0]), BF16)
    assert z.dtype == BF16 and tuple(z.shape) == (N, C, W // 2 + 1, H, 2)
    za = pp._stage_a_call(_jnp(x, dtype[1]), t["fwd_p"], H, W, t["kp"], "tf32", "bfloat16",
                          True)
    assert str(za.dtype) == "bfloat16"
    za, k, kp = f32(za), W // 2 + 1, t["kp"]
    for got, want in ((z[..., 0], za[:, :, :k]), (z[..., 1], za[:, :, kp:kp + k])):
        assert max_abs(got, want) <= unit(za)


@pytest.mark.parametrize("act", ["fp32", "bf16"])
def test_plain_k6_bf16s_matches_jax_stage_c(block_weights, stage_tables, act):
    """irdft_w_add_reference on a bf16 spectrum and an fp32 or bf16
    residual against the JAX stage C on the same bf16 spectrum (stage B's
    chunk-interleaved rows), writing the residual's type: both widen the
    spectrum and add in fp32; the fp32 sum is held to the fp32 tolerance,
    the bf16 one, rounded once on both sides, to one bf16 unit."""
    b, tb = block_weights, stage_tables
    rng = np.random.default_rng(7)
    res32 = rng.standard_normal((N, H, W, C)).astype(np.float32)
    res = res32 if act == "fp32" else bf16_values(res32)
    tdt, jdt = (torch.float32, jnp.float32) if act == "fp32" else (BF16, JBF16)
    x = nchw(b["x"], BF16)
    t = cs.spectral_mix_h_reference(cs.rdft_w_reference(x, BF16),
                                    torch.tensor(b["fk"].T.copy()), torch.tensor(b["fb"]))
    assert t.dtype == BF16
    kp, tc, k = tb["kp"], tb["tc"], W // 2 + 1
    merged = np.zeros((N, C, 2 * kp, H), np.float32)
    merged[:, :, :k], merged[:, :, kp:kp + k] = f32(t[..., 0]), f32(t[..., 1])
    tin = np.empty_like(merged)  # stage B's chunk-interleaved rows
    for j in range(kp // tc):
        tin[:, :, 2 * tc * j:2 * tc * j + tc] = merged[:, :, tc * j:tc * (j + 1)]
        tin[:, :, 2 * tc * j + tc:2 * tc * (j + 1)] = merged[:, :, kp + tc * j:kp + tc * (j + 1)]
    want = pp._stage_c_call(jnp.asarray(tin, JBF16), tb["inv_p"], _jnp(res, jdt), H, W, "tf32",
                            "float32" if act == "fp32" else "bfloat16", True)
    got = cs.irdft_w_add_reference(t, nchw(res, tdt))
    assert got.dtype == tdt and str(want.dtype) == str(jnp.dtype(jdt))
    want = f32(want).reshape(N, C, H, W)
    assert max_abs(got, want) <= (TOL_ROWS if act == "fp32" else unit(want))


@pytest.mark.parametrize("act", ["fp32", "bf16"])
def test_staged_block_bf16_spectra_matches_jax_unfused_pipeline(block_weights, act):
    """The plain staged block with ``bound_dtype`` bf16 (K3 -> K4-bf16s ->
    K5-bf16s -> K6-bf16s, on fp32 or bf16 activations) against the JAX
    ``fft_block_nchw(fused=False, bound_dtype=bfloat16)`` on the same x (its
    K3 on a bf16x2 weight pack for fp32 x, on a bf16 pack for bf16 x, as
    tests/test_torch_staged.py and tests/test_torch_bf16_routes.py hold
    them; tf32 spectral packs, interpret mode). Both round the spectrum
    after the W-rDFT and after stage B's inverse H transform, but the JAX
    stage B also casts its mix input and output to bf16, and the flax conv
    rounds apart where K3-bf16 rounds once: the bf16 budget, against the
    JAX fp32 block (``fft_conv_block``, jnp.fft) with the fp32 parity of
    tests/test_torch_staged.py (3e-3), and one bf16 unit of the output more
    at bf16 activations: both sides round the block's sum to bf16 last, so
    two sums within the budget can land on neighbouring bf16 values (here
    each is 0.029 and 0.033 from fp32, half a unit, and they read one unit,
    0.0625, apart: the budget alone is 0.061). The port's block with fp32
    spectra differs from it (the spectrum did round)."""
    b = block_weights
    x = b["x32"] if act == "fp32" else b["x"]
    tdt, jdt, pack = ((torch.float32, jnp.float32, "bf16x2") if act == "fp32"
                      else (BF16, JBF16, "bf16"))
    got = _port_block(b, nchw(x, tdt), "staged", bound_dtype=BF16)
    assert got.dtype == tdt
    assert not torch.equal(got, _port_block(b, nchw(x, tdt), "staged"))
    km = pp._pack_traced(pp.conv_kmat(jnp.asarray(b["ik"])), pack)
    want = pp.fft_block_nchw(_jnp(x, jdt), km, jnp.asarray(b["ib"])[:, None],
                             pp._pack_traced(jnp.asarray(b["fk"].T), "tf32"),
                             jnp.asarray(b["fb"])[:, None], H, W, precision="tf32",
                             bound_dtype=JBF16, fused=False, interpret=True)
    assert str(want.dtype) == str(jnp.dtype(jdt))
    fp32 = jax_block(jnp.asarray(x), *(jnp.asarray(b[k]) for k in ("ik", "ib", "fk", "fb")))
    want = f32(want).reshape(N, C, H, W)
    fp32 = f32(fp32).transpose(0, 3, 1, 2)
    last = unit(want) if act == "bf16" else 0.0
    assert max_abs(got, want) <= 2 * max_abs(want, fp32) + 3e-3 + last + 1e-6


# ------------------------------------------------------- the generator

L, F = 2, 8


@pytest.fixture(scope="module")
def generator_params():
    """flax params of an L = 2, 8-feature generator, every leaf redrawn at
    N(0, 1/fan_in), biases N(0, 0.1^2)."""
    jm = JaxModel(gen_features=F, disc_features=8, num_layers=L)
    params = jax.jit(jm.Generator.init)(jax.random.PRNGKey(0),
                                        np.zeros((1, 40, 36, 1), np.float32))["params"]
    rng = np.random.default_rng(3)

    def redraw(path, leaf):
        if "bias" in jax.tree_util.keystr(path):
            return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)
        fan = leaf.shape[0] if leaf.ndim == 2 else int(np.prod(leaf.shape[:3]))
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(redraw, params)


def test_bf16_fused_view_matches_jax_bf16_pallas_fused_generator(generator_params):
    """The bf16 generator's fused view (K3-bf16 + K7-bf16, the view built
    on the generator's shared fp32 parameters, no bf16 copy) against the
    JAX ``ResFFTGenerator(spectral_impl="pallas_fused", dtype=bfloat16)``
    (interpret mode) at 40 x 36, the budget of
    tests/test_torch_bf16_routes.py::test_bf16_view_matches_jax_bf16_generator
    with the fp32 fused generator's parity (1e-4, tests/test_torch_fused.py).
    Both outputs are fp32."""
    x = np.random.default_rng(5).random((2, 40, 36, 1)).astype(np.float32)
    want = JaxGenerator(features=F, num_layers=L, spectral_impl="pallas_fused",
                        dtype=JBF16).apply({"params": generator_params}, x)
    fp32 = JaxGenerator(features=F, num_layers=L).apply({"params": generator_params}, x)
    model = MTDGANModel(gen_features=F, num_layers=L, device="cpu", dtype=BF16)
    model.generator.load_state_dict(generator_state_dict_from_flax(generator_params),
                                    strict=True)
    view = model.views["fused"]
    assert view.dtype == BF16 and view.conv_impl == "k3"
    assert view.enforce[0].spectral_impl == "fused"
    for name, t in view.state_dict().items():
        assert t.dtype == torch.float32, name  # shared, not a bf16 copy
        assert t.data_ptr() == model.generator.state_dict()[name].data_ptr(), name
    with torch.no_grad():
        got = view(torch.tensor(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    got = got.permute(0, 2, 3, 1).numpy()
    assert max_abs(got, want) <= 2 * max_abs(want, fp32) + 1e-4 + 1e-6
