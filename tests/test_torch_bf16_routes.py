"""A bf16 generator's tiled and staged routes on the CPU: the plain versions
of K3-bf16, K8-bf16, K4-bf16 and K6-bf16 (mtd_gan_tpu_torch/ops/
cuda_staged.py, ops/cuda_fftconv.py), the staged bf16 block and the bf16
generator's tiled and staged views against the JAX package's functions on
bf16 activations, with the Pallas kernels in interpret mode. The kernels
themselves run only on the card (``chip_smoke.py`` phase 32).

Weights are drawn at N(0, 1/fan_in) with N(0, 0.1^2) biases, where bf16
does not hide under an image residual. Tolerances, with a bf16 unit the
spacing of bf16 values at the largest output (2^-8 to 2^-7 of it):

- where both sides round the same fp32 sum once at the same point, one
  bf16 unit (an element whose sum lies at a midpoint rounds the other way
  in one of two summation orders);
- where neither side rounds (K4-bf16's fp32 spectrum), the fp32 tolerance
  of tests/test_torch_staged.py;
- otherwise (the flax layers round the conv, the bias and each residual
  add to bf16 apart, the JAX stage B casts its mix input to bf16), the
  bf16 budget of tests/test_torch_bf16_models.py:
  err(port bf16, JAX bf16) <= 2 err(JAX bf16, JAX fp32) + fp32 parity + 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtd_gan_tpu.models.mtd_gan import MTDGANModel as JaxModel
from mtd_gan_tpu.ops import pallas_pipeline as pp
from mtd_gan_tpu.ops.layers import ConvTranspose
from mtd_gan_tpu.ops.pallas_fftconv import spectral_branch_tiled as jax_tiled
from mtd_gan_tpu_torch.models.mtd_gan import MTDGANModel
from mtd_gan_tpu_torch.ops import cuda_staged as cs
from mtd_gan_tpu_torch.ops.cuda_fftconv import spectral_branch_tiled_reference
from mtd_gan_tpu_torch.ops.fft_conv import fft_conv_block
from mtd_gan_tpu_torch.utils.torch_import import generator_state_dict_from_flax

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

BF16 = torch.bfloat16
JBF16 = jnp.bfloat16
# the fp32 tolerance of the plain K4 against the JAX stage A (tf32 factor
# packs, fp32 boundaries): tests/test_torch_staged.py TOL_ROWS
TOL_ROWS = 2e-5


def unit(want) -> float:
    """One bf16 unit at the largest |want|: 2^(e - 7) for 2^e <= max < 2^(e+1)."""
    return 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)


def f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32)) if not torch.is_tensor(a) else a.float().numpy()


def max_abs(a, b) -> float:
    return float(np.abs(f32(a) - f32(b)).max())


def to_nchw_bf16(a: np.ndarray) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(BF16)


def fan_in(rng, *shape, axes) -> np.ndarray:
    return (rng.standard_normal(shape) / np.sqrt(np.prod([shape[a] for a in axes]))
            ).astype(np.float32)


# ---------------------------------------------------------------- K3-bf16


@pytest.fixture(scope="module")
def conv_case():
    """NHWC x, an HWIO conv weight, bias, a skip and an fp32 image, and a
    C -> 1 ConvTranspose weight; x and the skip also rounded to bf16 (the
    bf16 paths' inputs: ``x``, ``s``; the fp32 path's: ``x32``, ``s32``)."""
    rng = np.random.default_rng(0)
    n, h, w, c = 1, 32, 64, 8
    x32 = rng.random((n, h, w, c)).astype(np.float32)
    s32 = (rng.standard_normal((n, h, w, c)) * 0.5).astype(np.float32)
    bf = lambda a: np.asarray(jnp.asarray(a, JBF16).astype(jnp.float32))
    return dict(x=bf(x32), x32=x32, s=bf(s32), s32=s32,
                k=fan_in(rng, 3, 3, c, c, axes=(0, 1, 2)),
                b=(rng.standard_normal(c) * 0.1).astype(np.float32),
                img=rng.random((n, h, w, 1)).astype(np.float32),
                k1=fan_in(rng, 3, 3, c, 1, axes=(0, 1, 2)),
                b1=(rng.standard_normal(1) * 0.1).astype(np.float32))


def _port_k3(c, epilogue):
    """conv3x3_reference on the bf16 x of ``conv_case`` for one epilogue."""
    x, b = to_nchw_bf16(c["x"]), torch.tensor(c["b"])
    oihw = torch.tensor(c["k"].transpose(3, 2, 0, 1).copy())
    deconv = torch.tensor(c["k"].transpose(2, 3, 0, 1).copy())  # (in, out, kh, kw)
    if epilogue == "relu+residual":
        return cs.conv3x3_reference(x, oihw, b, residual=True)
    if epilogue == "skip+relu":
        return cs.conv3x3_reference(x, oihw, b, skip=to_nchw_bf16(c["s"]))
    if epilogue == "deconv+skip+relu":
        return cs.conv3x3_reference(x, deconv, b, skip=to_nchw_bf16(c["s"]), transpose=True)
    return cs.conv3x3_reference(x, torch.tensor(c["k1"].transpose(2, 3, 0, 1).copy()),
                                torch.tensor(c["b1"]), transpose=True,
                                skip=torch.tensor(c["img"].transpose(0, 3, 1, 2).copy()))


def _flax_k3(c, epilogue, dtype):
    """The flax layers' ops for one epilogue, computing in ``dtype``:
    ``lax.conv_general_dilated`` (or the JAX ConvTranspose) on operands of
    that type, the bias added in it, then the skip, ReLU and residual; fp32
    on the unrounded x and skip."""
    wide = dtype == jnp.float32
    x = jnp.asarray(c["x32"] if wide else c["x"], dtype)
    skip = jnp.asarray(c["s32"] if wide else c["s"], dtype)
    if epilogue == "exit deconv C->1":
        params = {"kernel": jnp.asarray(c["k1"]), "bias": jnp.asarray(c["b1"])}
        y = ConvTranspose(1, (3, 3), padding=1, dtype=dtype).apply({"params": params}, x)
        return jax.nn.relu(y + jnp.asarray(c["img"]))
    if epilogue == "deconv+skip+relu":
        params = {"kernel": jnp.asarray(c["k"]), "bias": jnp.asarray(c["b"])}
        y = ConvTranspose(8, (3, 3), padding=1, dtype=dtype).apply({"params": params}, x)
        return jax.nn.relu(y + skip)
    y = jax.lax.conv_general_dilated(x, jnp.asarray(c["k"], dtype), (1, 1), [(1, 1), (1, 1)],
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"))
    y = y + jnp.asarray(c["b"], dtype)
    if epilogue == "skip+relu":
        return jax.nn.relu(y + skip)
    return x + jax.nn.relu(y)


K3_EPILOGUES = ("relu+residual", "skip+relu", "deconv+skip+relu", "exit deconv C->1")


@pytest.mark.parametrize("epilogue", K3_EPILOGUES)
def test_plain_k3_bf16_matches_lax_conv_on_bf16_operands(conv_case, epilogue):
    """conv3x3_reference on a bf16 x against the flax layers' ops on bf16
    operands (``lax.conv_general_dilated`` of bf16 x and weight, the bias,
    skip and residual added in bf16; the exit deconv's fp32 image added to
    its bf16 output), which round at more points than K3-bf16's one: the
    bf16 budget. The port returns bf16, and fp32 for the exit deconv, as
    the flax ops do."""
    got = _port_k3(conv_case, epilogue)
    want = _flax_k3(conv_case, epilogue, JBF16)
    fp32 = _flax_k3(conv_case, epilogue, jnp.float32)
    assert got.dtype == (torch.float32 if epilogue.startswith("exit") else BF16)
    assert str(want.dtype) == ("float32" if epilogue.startswith("exit") else "bfloat16")
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert max_abs(got, want) <= 2 * max_abs(want, fp32) + 1e-6


def _jax_k3(c, epilogue, pack):
    """The JAX K3 (conv3x3, interpret mode) on the bf16 x, its weight as a
    ``pack`` of conv_kmat: "bf16" (one bf16 value, K3-bf16's operand) or
    "bf16x2" (a hi/lo pair, the JAX conv's default)."""
    n, h, w, ci = c["x"].shape
    flat = lambda a, d: jnp.asarray(a.transpose(0, 3, 1, 2).reshape(n, -1, h * w), d)
    exit_ = epilogue.startswith("exit")
    k, b = (c["k1"], c["b1"]) if exit_ else (c["k"], c["b"])
    km = pp._pack_traced(pp.conv_kmat(jnp.asarray(k), flip="deconv" in epilogue), pack)
    skip = (flat(c["img"], jnp.float32) if exit_
            else flat(c["s"], JBF16) if "skip" in epilogue else None)
    out = pp.conv3x3(flat(c["x"], JBF16), km, jnp.asarray(b)[:, None], h, w, skip=skip,
                     relu=True, residual=epilogue == "relu+residual",
                     out_dtype=jnp.float32 if exit_ else None, interpret=True)
    return np.asarray(out.astype(jnp.float32)).reshape(n, -1, h, w)


@pytest.mark.parametrize("epilogue", ("relu+residual", "deconv+skip+relu", "exit deconv C->1"))
def test_plain_k3_bf16_matches_jax_k3(conv_case, epilogue):
    """conv3x3_reference on a bf16 x against the JAX K3 on the same bf16 x
    (interpret mode). With the weight packed as one bf16 value both round
    the same fp32 sum once, to the same type: one bf16 unit. The JAX K3's
    default pack is a hi/lo bf16 pair (~16 bits of the weight, where
    K3-bf16 and the flax layers keep 8): that difference, the weight
    rounding, measured 1.6e-2, 1.6e-2 and 1.4e-3 max abs at these three
    epilogues (one bf16 unit of outputs up to 3.1 and 3.7; the exit's fp32
    output up to 1.7), where the bf16 pack read 0, 0 and 1.2e-7. It is held
    to the bf16 budget, the JAX bf16x2 conv's own error against the fp32
    conv of the unrounded x (1.2e-2, 1.1e-2, 3.1e-3)."""
    got = _port_k3(conv_case, epilogue)
    want = _jax_k3(conv_case, epilogue, "bf16")
    assert got.dtype == (torch.float32 if epilogue.startswith("exit") else BF16)
    got = got.float().numpy()
    assert max_abs(got, want) <= unit(want)
    pair = _jax_k3(conv_case, epilogue, "bf16x2")
    fp32 = np.asarray(_flax_k3(conv_case, epilogue, jnp.float32)).transpose(0, 3, 1, 2)
    assert max_abs(got, pair) <= 2 * max_abs(pair, fp32) + 1e-6


# ------------------------------------------------------------- K8-bf16


@pytest.fixture(scope="module")
def k8_case():
    """NHWC x and residual rounded to bf16, the spectral mix (flax layout)
    and bias; the JAX K8 on the bf16 x, with and without the bf16
    residual, precision "highest" (fp32 DFT products), interpret mode."""
    rng = np.random.default_rng(1)
    n, h, w, c = 2, 64, 32, 8
    x = jnp.asarray(rng.random((n, h, w, c)), JBF16)
    res = jnp.asarray(rng.standard_normal((n, h, w, c)), JBF16)
    mix = fan_in(rng, 2 * c, 2 * c, axes=(0,))
    bias = (rng.standard_normal(2 * c) * 0.1).astype(np.float32)
    call = lambda r: jax_tiled(x, mix, bias, residual=r, precision="highest", th=64,
                               tk=128, interpret=True)
    return dict(x=x, res=res, mix=mix, bias=bias, want={False: call(None), True: call(res)})


@pytest.mark.parametrize("with_res", [False, True], ids=["branch", "residual"])
def test_plain_k8_bf16_matches_jax_k8(k8_case, with_res):
    """spectral_branch_tiled_reference on a bf16 x (and bf16 residual)
    against the JAX K8 on the same: both take the spectrum in fp32 and
    round residual + branch once to bf16, so one bf16 unit."""
    c = k8_case
    nchw = lambda a: to_nchw_bf16(np.asarray(a.astype(jnp.float32)))
    got = spectral_branch_tiled_reference(nchw(c["x"]), torch.tensor(c["mix"].T.copy()),
                                          torch.tensor(c["bias"]),
                                          nchw(c["res"]) if with_res else None)
    want = c["want"][with_res]
    assert got.dtype == BF16 and str(want.dtype) == "bfloat16"
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert max_abs(got, want) <= unit(f32(want))


# ------------------------------------------------- K4-bf16, K6-bf16, block

N, C, H, W = 1, 8, 64, 64


@pytest.fixture(scope="module")
def stage_case():
    """A bf16 x and residual, the spectral mix, the JAX stage tables (tf32
    factor packs, dense W factors, interpret mode) and the port's plain
    K4-bf16 and K5 outputs."""
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.random((N, C, H, W)), dtype=torch.float32).to(BF16)
    mix = fan_in(rng, 2 * C, 2 * C, axes=(1,))
    bias = (rng.standard_normal(2 * C) * 0.1).astype(np.float32)
    res = torch.tensor(rng.standard_normal((N, C, H, W)), dtype=torch.float32).to(BF16)
    kp, tc, use_ct, _, fwd_p, inv_p, _, h1, h2 = pp._spectral_tables(
        H, W, "tf32", use_ct_w=False, interpret=True)
    z = cs.rdft_w_reference(x)
    t = cs.spectral_mix_h_reference(z, torch.tensor(mix), torch.tensor(bias))
    return dict(x=x, res=res, kp=kp, tc=tc, fwd_p=fwd_p, inv_p=inv_p, z=z, t=t)


def _jnp(t: torch.Tensor, dtype=JBF16):
    return jnp.asarray(t.float().reshape(N, C, H * W).numpy(), dtype)


def test_plain_k4_bf16_matches_jax_stage_a(stage_case):
    """rdft_w_reference on a bf16 x against the JAX stage A on the same bf16
    x with fp32 boundaries: neither rounds its fp32 spectrum, so the fp32
    tolerance."""
    c = stage_case
    assert c["z"].dtype == torch.complex64
    za = np.asarray(pp._stage_a_call(_jnp(c["x"]), c["fwd_p"], H, W, c["kp"], "tf32",
                                     "float32", True))
    k = c["z"].shape[2]
    assert np.abs(c["z"].real.numpy() - za[:, :, :k]).max() <= TOL_ROWS
    assert np.abs(c["z"].imag.numpy() - za[:, :, c["kp"]:c["kp"] + k]).max() <= TOL_ROWS


def test_plain_k6_bf16_matches_jax_stage_c(stage_case):
    """irdft_w_add_reference on the fp32 spectrum and a bf16 residual
    against the JAX stage C on the same, writing bf16: both add in fp32 and
    round once to bf16, so one bf16 unit."""
    c = stage_case
    t, kp, tc = c["t"], c["kp"], c["tc"]
    k = t.shape[2]
    merged = np.zeros((N, C, 2 * kp, H), np.float32)
    merged[:, :, :k], merged[:, :, kp:kp + k] = t.real.numpy(), t.imag.numpy()
    tin = np.empty_like(merged)  # stage B's chunk-interleaved rows
    for j in range(kp // tc):
        tin[:, :, 2 * tc * j:2 * tc * j + tc] = merged[:, :, tc * j:tc * (j + 1)]
        tin[:, :, 2 * tc * j + tc:2 * tc * (j + 1)] = merged[:, :, kp + tc * j:kp + tc * (j + 1)]
    want = pp._stage_c_call(jnp.asarray(tin), c["inv_p"], _jnp(c["res"]), H, W, "tf32",
                            "bfloat16", True)
    got = cs.irdft_w_add_reference(t, c["res"])
    assert got.dtype == BF16 and str(want.dtype) == "bfloat16"
    want = f32(want).reshape(N, C, H, W)
    assert max_abs(got, want) <= unit(want)


def test_staged_bf16_block_matches_jax_unfused_pipeline():
    """The plain staged block at bf16 activations (K3-bf16 -> K4-bf16 -> K5
    -> K6-bf16) against the JAX fft_block_nchw(fused=False) on the same
    bf16 x with bound_dtype float32 (its K3 on a bf16 weight pack, tf32
    spectral packs, interpret mode). Both round res to bf16 and the block's
    sum once to bf16, but the JAX stage B casts its mix input to bf16: the
    bf16 budget, the JAX bf16 block against the fp32 block of the JAX
    package (``fft_conv_block``, jnp.fft) and the fp32 parity of
    tests/test_torch_staged.py (3e-3)."""
    from mtd_gan_tpu.ops.fft_conv import fft_conv_block as jax_block

    rng = np.random.default_rng(4)
    x = np.asarray(jnp.asarray(rng.random((N, H, W, C)), JBF16).astype(jnp.float32))
    ik = fan_in(rng, 3, 3, C, C, axes=(0, 1, 2))
    ib = (rng.standard_normal(C) * 0.1).astype(np.float32)
    fk = fan_in(rng, 2 * C, 2 * C, axes=(0,))
    fb = (rng.standard_normal(2 * C) * 0.1).astype(np.float32)
    got = fft_conv_block(to_nchw_bf16(x), torch.tensor(ik.transpose(3, 2, 0, 1).copy()),
                         torch.tensor(ib), torch.tensor(fk.T.copy()), torch.tensor(fb),
                         impl="staged", conv_impl="k3")
    xc = jnp.asarray(x.transpose(0, 3, 1, 2).reshape(N, C, H * W), JBF16)
    km = pp._pack_traced(pp.conv_kmat(jnp.asarray(ik)), "bf16")
    want = pp.fft_block_nchw(xc, km, jnp.asarray(ib)[:, None],
                             pp._pack_traced(jnp.asarray(fk.T), "tf32"),
                             jnp.asarray(fb)[:, None], H, W, precision="tf32",
                             bound_dtype=jnp.float32, fused=False, interpret=True)
    fp32 = jax_block(jnp.asarray(x), jnp.asarray(ik), jnp.asarray(ib), jnp.asarray(fk),
                     jnp.asarray(fb))
    assert got.dtype == BF16 and str(want.dtype) == "bfloat16"
    want = f32(want).reshape(N, C, H, W)
    fp32 = f32(fp32).transpose(0, 3, 1, 2)
    assert max_abs(got, want) <= 2 * max_abs(want, fp32) + 3e-3 + 1e-6


# ------------------------------------------------------- the generators

L, F = 2, 8


@pytest.fixture(scope="module")
def generator_params():
    """flax params of an L = 2, 8-feature generator, every leaf redrawn at
    N(0, 1/fan_in), biases N(0, 0.1^2)."""
    jm = JaxModel(gen_features=F, disc_features=8, num_layers=L)
    params = jax.jit(jm.Generator.init)(jax.random.PRNGKey(0),
                                        np.zeros((1, 64, 32, 1), np.float32))["params"]
    rng = np.random.default_rng(3)

    def redraw(path, leaf):
        if "bias" in jax.tree_util.keystr(path):
            return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)
        fan = leaf.shape[0] if leaf.ndim == 2 else int(np.prod(leaf.shape[:3]))
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(redraw, params)


def _bf16_view(params, route: str):
    model = MTDGANModel(gen_features=F, num_layers=L, device="cpu", dtype=BF16)
    model.generator.load_state_dict(generator_state_dict_from_flax(params), strict=True)
    view = model.views[route]
    assert view.dtype == BF16 and view.conv_impl == "k3"
    assert view.enforce[0].spectral_impl == route
    for name, t in view.state_dict().items():
        assert t.dtype == torch.float32, name  # shared, not a bf16 copy
        assert t.data_ptr() == model.generator.state_dict()[name].data_ptr(), name
    return view


@pytest.mark.parametrize("route,shape", [("tiled", (2, 64, 32, 1)),
                                         ("staged", (2, 40, 36, 1))], ids=["tiled", "staged"])
def test_bf16_view_matches_jax_bf16_generator(generator_params, route, shape):
    """The bf16 generator's tiled view (K3-bf16 + K8-bf16) against the JAX
    ``GeneratorTiled`` of ``MTDGANModel(dtype=bfloat16)`` (interpret mode),
    and its staged view (K3-bf16 + K4-bf16 -> K5 -> K6-bf16) against the
    JAX bf16 ``Generator.apply``, the XLA path the JAX generate takes at
    40 x 36; the bf16 budget with the fp32 parity of the routes' fp32 tests
    (1e-4 tiled, tests/test_torch_tiled.py; 2e-4 staged,
    tests/test_torch_staged.py). Both outputs are fp32."""
    x = np.random.default_rng(5).random(shape).astype(np.float32)
    j16, j32 = (JaxModel(gen_features=F, disc_features=8, num_layers=L, dtype=d)
                for d in (JBF16, None))
    apply16 = j16.GeneratorTiled.apply if route == "tiled" else j16.Generator.apply
    want = apply16({"params": generator_params}, x)
    fp32 = j32.Generator.apply({"params": generator_params}, x)
    with torch.no_grad():
        got = _bf16_view(generator_params, route)(torch.tensor(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    got = got.permute(0, 2, 3, 1).numpy()
    parity = 1e-4 if route == "tiled" else 2e-4
    assert max_abs(got, want) <= 2 * max_abs(want, fp32) + parity + 1e-6
