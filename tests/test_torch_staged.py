"""The staged generator path of the PyTorch port (mtd_gan_tpu_torch/ops/
cuda_staged.py: the plain K3, K4, K5 and K6, the ``"staged"`` impl of
ops/fft_conv.py, models/mtd_gan.py's staged view and routing, and the train
step's route choice) against the JAX package on the CPU: K3 against
``jax.lax.conv_general_dilated`` and the JAX ``conv3x3``, K4 - K6 against
``_stage_a_call``, ``_stage_b_call`` and ``_stage_c_call``, the staged
block against ``fft_block_nchw(fused=False)`` (the Pallas kernels in
interpret mode), and the staged generator against ``Generator.apply``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtd_gan_tpu.models.mtd_gan import MTDGANModel as JaxModel
from mtd_gan_tpu.ops import pallas_pipeline as pp
from mtd_gan_tpu.ops.layers import ConvTranspose
from mtd_gan_tpu_torch.models.mtd_gan import MTDGANModel, generate_route
from mtd_gan_tpu_torch.ops import cuda_staged as cs
from mtd_gan_tpu_torch.ops.cuda_train import train_route
from mtd_gan_tpu_torch.ops.fft_conv import fft_conv_block
from mtd_gan_tpu_torch.utils.torch_import import generator_state_dict_from_flax

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

nchw = lambda a: torch.tensor(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
oihw = lambda k: torch.tensor(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def _conv_case(seed, n, h, w, c):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, c)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(c) * 0.1).astype(np.float32)
    s = rng.standard_normal((n, h, w, c)).astype(np.float32)
    return x, k, b, s


def _lax_conv(x, k, b):
    return jax.lax.conv_general_dilated(
        x, k, (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + b


# epilogue -> (the port's keyword arguments, the JAX ops on conv(x) + b)
EPILOGUES = {
    "plain": (dict(relu=False), lambda v, x, s: v),
    "relu": (dict(), lambda v, x, s: jax.nn.relu(v)),
    "skip+relu": (dict(skip=True), lambda v, x, s: jax.nn.relu(v + s)),
    "relu+residual": (dict(residual=True), lambda v, x, s: x + jax.nn.relu(v)),
}


@pytest.mark.parametrize("epilogue", list(EPILOGUES) + ["flipped deconv"])
def test_plain_k3_matches_lax_conv(epilogue):
    """conv3x3_reference against jax.lax.conv_general_dilated (or the JAX
    ConvTranspose, the flipped-kernel conv) plus the same elementwise ops,
    fp32 both sides: max abs 1e-5."""
    x, k, b, s = _conv_case(0, 2, 12, 20, 8)
    if epilogue == "flipped deconv":
        params = {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}
        want = ConvTranspose(8, (3, 3), padding=1).apply({"params": params}, x)
        # ConvTranspose kernel (kh, kw, in, out) -> torch (in, out, kh, kw)
        got = cs.conv3x3_reference(nchw(x), torch.tensor(k.transpose(2, 3, 0, 1).copy()),
                                   torch.tensor(b), relu=False, transpose=True)
    else:
        kw, ops = EPILOGUES[epilogue]
        want = ops(_lax_conv(x, k, b), x, s)
        if kw.pop("skip", False):
            kw["skip"] = nchw(s)
        got = cs.conv3x3_reference(nchw(x), oihw(k), torch.tensor(b), **kw)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert np.abs(got - np.asarray(want)).max() <= 1e-5


@pytest.mark.parametrize("epilogue", ["relu+residual", "flipped deconv+skip+relu"])
def test_plain_k3_matches_jax_k3(epilogue):
    """conv3x3_reference against the JAX K3 (conv3x3, interpret mode) at
    1x8x32x64, atol 2e-2: the JAX package's own tolerance for its K3,
    whose conv runs on bf16 activations (tests/test_pallas_pipeline.py)."""
    x, k, b, s = _conv_case(1, 1, 32, 64, 8)
    n, h, w, c = x.shape
    flat = lambda a: jnp.asarray(a.transpose(0, 3, 1, 2).reshape(n, c, h * w))
    flip = epilogue.startswith("flipped")
    km = pp._pack_traced(pp.conv_kmat(jnp.asarray(k), flip=flip), "bf16x2")
    want = pp.conv3x3(flat(x), km, jnp.asarray(b)[:, None], h, w,
                      skip=flat(s) if flip else None, relu=True, residual=not flip,
                      interpret=True)
    if flip:
        got = cs.conv3x3_reference(nchw(x), torch.tensor(k.transpose(2, 3, 0, 1).copy()),
                                   torch.tensor(b), skip=nchw(s), transpose=True)
    else:
        got = cs.conv3x3_reference(nchw(x), oihw(k), torch.tensor(b), residual=True)
    want = np.asarray(want).reshape(n, c, h, w)
    assert np.abs(got.numpy() - want).max() <= 2e-2


@pytest.mark.parametrize("flip", [False, True], ids=["conv", "flipped deconv"])
def test_k3_kmat_order_matches_jax_conv_kmat(flip):
    """K3's B operand (conv3x3_kmat: row tap * C_in + c_in) is the JAX
    conv_kmat transposed, bit for bit, for a conv weight and for a
    ConvTranspose weight with the spatial flip."""
    rng = np.random.default_rng(5)
    k = rng.standard_normal((3, 3, 16, 8)).astype(np.float32)  # HWIO
    want = np.asarray(pp.conv_kmat(jnp.asarray(k), flip=flip)).T
    # conv: (C_out, C_in, 3, 3); deconv: ConvTranspose2d (C_in, C_out, 3, 3)
    weight = k.transpose(2, 3, 0, 1) if flip else k.transpose(3, 2, 0, 1)
    got = cs.conv3x3_kmat(torch.tensor(weight.copy()), transpose=flip).numpy()
    assert got.shape == want.shape == (9 * 16, 8)
    assert np.array_equal(got, want)


N, C, H, W = 1, 8, 64, 64
# max abs against the JAX stages in "tf32" with fp32 boundaries, at the
# weight scale of the JAX package's own tf32 block test (mix x0.05, bias
# x0.01; tests/test_pallas_pipeline.py), where its tolerance is 5e-3.
# Stages A and C run three bf16 passes on fp32 operands: measured 5.2e-6
# and 2.0e-6 on values up to 4.7. Stage B casts the mix input to bf16 (by
# design, pallas_pipeline.py _stage_b_call): measured 1.35e-3 on values up
# to 1.4.
TOL_ROWS = 2e-5
TOL_MIX = 3e-3


@pytest.fixture(scope="module")
def stage_case():
    """Seeded inputs, the JAX stage tables (fused=False: dense W factors,
    interpret mode) and the port's plain K4 and K5 outputs."""
    rng = np.random.default_rng(2)
    x = rng.random((N, C, H, W)).astype(np.float32)
    mix = (rng.standard_normal((2 * C, 2 * C)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(2 * C) * 0.01).astype(np.float32)
    res = rng.standard_normal((N, C, H, W)).astype(np.float32)
    kp, tc, use_ct, _, fwd_p, inv_p, _, h1, h2 = pp._spectral_tables(
        H, W, "tf32", use_ct_w=False, interpret=True)
    z = cs.rdft_w_reference(torch.tensor(x))
    t = cs.spectral_mix_h_reference(z, torch.tensor(mix), torch.tensor(bias))
    return dict(x=x, mix=mix, bias=bias, res=res, kp=kp, tc=tc, use_ct=use_ct,
                fwd_p=fwd_p, inv_p=inv_p, h1=h1, h2=h2, z=z, t=t)


def _merged(z, kp):
    """(N, C, K, H) complex -> the JAX stage A layout (N, C, 2Kp, H): Re in
    K-rows [0:K], Im in [Kp:Kp+K], zero padding."""
    k = z.shape[2]
    out = np.zeros(z.shape[:2] + (2 * kp, z.shape[3]), np.float32)
    out[:, :, :k] = z.real.numpy()
    out[:, :, kp:kp + k] = z.imag.numpy()
    return out


def _interleave(merged, kp, tc):
    """Stage A layout -> the chunk-interleaved rows [Re_0; Im_0; Re_1; ...]
    of tc K-rows each that stage B writes and stage C reads."""
    re, im = merged[:, :, :kp], merged[:, :, kp:]
    out = np.empty_like(merged)
    for j in range(kp // tc):
        out[:, :, 2 * tc * j:2 * tc * j + tc] = re[:, :, tc * j:tc * (j + 1)]
        out[:, :, 2 * tc * j + tc:2 * tc * (j + 1)] = im[:, :, tc * j:tc * (j + 1)]
    return out


def _deinterleave(t, kp, tc, k):
    """Stage B's chunk-interleaved rows -> (N, C, K, H) complex."""
    re = np.concatenate([t[:, :, 2 * tc * j:2 * tc * j + tc] for j in range(kp // tc)], 2)
    im = np.concatenate([t[:, :, 2 * tc * j + tc:2 * tc * (j + 1)]
                         for j in range(kp // tc)], 2)
    return re[:, :, :k] + 1j * im[:, :, :k]


def test_plain_k4_matches_jax_stage_a(stage_case):
    c = stage_case
    za = np.asarray(pp._stage_a_call(jnp.asarray(c["x"].reshape(N, C, H * W)), c["fwd_p"],
                                     H, W, c["kp"], "tf32", "float32", True))
    assert np.abs(_merged(c["z"], c["kp"]) - za).max() <= TOL_ROWS


def test_plain_k5_matches_jax_stage_b(stage_case):
    c = stage_case
    mixp = pp._pack_traced(jnp.asarray(c["mix"]), "tf32")
    tb = np.asarray(pp._stage_b_call(
        jnp.asarray(_merged(c["z"], c["kp"])), mixp, jnp.asarray(c["bias"])[:, None],
        c["h1"], c["h2"], H, c["kp"], c["tc"], "tf32", c["use_ct"], True))
    want = _deinterleave(tb, c["kp"], c["tc"], W // 2 + 1)
    assert np.abs(c["t"].numpy() - want).max() <= TOL_MIX


def test_plain_k6_matches_jax_stage_c(stage_case):
    c = stage_case
    tin = _interleave(_merged(c["t"], c["kp"]), c["kp"], c["tc"])
    want = np.asarray(pp._stage_c_call(
        jnp.asarray(tin), c["inv_p"], jnp.asarray(c["res"].reshape(N, C, H * W)), H, W,
        "tf32", "float32", True)).reshape(N, C, H, W)
    got = cs.irdft_w_add_reference(c["t"], torch.tensor(c["res"]))
    assert np.abs(got.numpy() - want).max() <= TOL_ROWS


@pytest.fixture(scope="module")
def block_case():
    """The block's weights as in tests/test_pallas_pipeline.py's precision
    test, a seeded NHWC input, and the port's plain staged block."""
    rng = np.random.default_rng(4)
    x = rng.random((N, H, W, C)).astype(np.float32)
    ik = (rng.standard_normal((3, 3, C, C)) * 0.05).astype(np.float32)
    ib = (rng.standard_normal(C) * 0.01).astype(np.float32)
    fk = (rng.standard_normal((2 * C, 2 * C)) * 0.05).astype(np.float32)
    fb = (rng.standard_normal(2 * C) * 0.01).astype(np.float32)
    args = (nchw(x), oihw(ik), torch.tensor(ib), torch.tensor(fk.T.copy()),
            torch.tensor(fb))
    return x, ik, ib, fk, fb, args, fft_conv_block(*args, impl="staged", conv_impl="k3")


def test_staged_block_matches_jax_unfused_pipeline(block_case):
    """The plain staged block (K3 -> K4 -> K5 -> K6) against the JAX
    fft_block_nchw(fused=False) in "tf32" with fp32 boundaries. The JAX
    package holds its tf32 block to 5e-3 max abs
    (tests/test_pallas_pipeline.py); its K3 and stage B run on bf16
    activations: measured 1.74e-3, held at 3e-3."""
    x, ik, ib, fk, fb, _, got = block_case
    xc = jnp.asarray(x.transpose(0, 3, 1, 2).reshape(N, C, H * W))
    km = pp._pack_traced(pp.conv_kmat(jnp.asarray(ik)), "bf16x2")
    want = pp.fft_block_nchw(xc, km, jnp.asarray(ib)[:, None],
                             pp._pack_traced(jnp.asarray(fk.T), "tf32"),
                             jnp.asarray(fb)[:, None], H, W, precision="tf32",
                             bound_dtype=jnp.float32, fused=False, interpret=True)
    want = np.asarray(want).reshape(N, C, H, W)
    assert np.abs(got.numpy() - want).max() <= 3e-3


def test_staged_block_matches_auto(block_case):
    """On CPU tensors the staged block is the plain block cut at other
    points (rfft along W then fft along H, vs rfft2): 1e-5 max abs."""
    *_, args, got = block_case
    want = fft_conv_block(*args, impl="auto")
    assert np.abs(got.numpy() - want.numpy()).max() <= 1e-5


L, F = 2, 8


@pytest.fixture(scope="module")
def generator_params():
    """flax params with 1/sqrt(fan_in) weights and 0.1 biases (so the
    spectral branch is not negligible)."""
    jm = JaxModel(gen_features=F, disc_features=8, num_layers=L)
    x = np.zeros((1, 40, 36, 1), np.float32)
    params = jax.jit(jm.Generator.init)(jax.random.PRNGKey(0), x)["params"]
    rng = np.random.default_rng(3)

    def redraw(path, leaf):
        if "bias" in jax.tree_util.keystr(path):
            return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)
        fan_in = leaf.shape[0] if leaf.ndim == 2 else int(np.prod(leaf.shape[:3]))
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jm, jax.tree_util.tree_map_with_path(redraw, params)


@pytest.mark.parametrize("shape", [(1, 40, 36, 1), (1, 33, 27, 1)], ids=str)
def test_staged_generator_matches_jax_generator(generator_params, shape):
    """MTDGANModel.generator_staged on the CPU (its parameters shared with
    the generator) against the JAX Generator.apply, the XLA path the JAX
    generate takes at these sizes: 2e-4 max abs."""
    jm, params = generator_params
    x = np.random.default_rng(5).random(shape).astype(np.float32)
    want = np.asarray(jm.Generator.apply({"params": params}, x))
    model = MTDGANModel(gen_features=F, num_layers=L, device="cpu")
    model.generator.load_state_dict(generator_state_dict_from_flax(params), strict=True)
    gen = model.generator_staged
    assert gen.conv_impl == "k3" and gen.enforce[0].spectral_impl == "staged"
    for name, t in gen.state_dict().items():
        assert t.data_ptr() == model.generator.state_dict()[name].data_ptr(), name
    with torch.no_grad():
        got = gen(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == shape
    assert np.abs(got - want).max() <= 2e-4


def test_wrappers_on_cpu_run_the_plain_versions_and_count_nothing():
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.random((2, 8, 9, 7)), dtype=torch.float32)
    wt = torch.tensor(rng.standard_normal((8, 8, 3, 3)), dtype=torch.float32)
    b = torch.zeros(8)
    mix = torch.tensor(rng.standard_normal((16, 16)), dtype=torch.float32)
    fns = (cs.conv3x3, cs.rdft_w, cs.spectral_mix_h, cs.irdft_w_add)
    before = [f.launches for f in fns]
    assert torch.equal(cs.conv3x3(x, wt, b, residual=True),
                       cs.conv3x3_reference(x, wt, b, residual=True))
    z = cs.rdft_w(x)
    assert torch.equal(z, cs.rdft_w_reference(x))
    want = cs.spectral_mix_h_reference(z, mix, torch.zeros(16))
    assert cs.spectral_mix_h(z, mix, torch.zeros(16)) is z  # in place
    assert torch.equal(z, want)
    assert torch.equal(cs.irdft_w_add(z, x), cs.irdft_w_add_reference(z, x))
    assert [f.launches for f in fns] == before
    meta = x.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cs.conv3x3(meta, wt.to("meta"), None)
    with pytest.raises(ValueError, match="unsupported device"):
        cs.rdft_w(meta)


@pytest.mark.parametrize("h,w,c,route", [
    (512, 512, 32, "k1"), (448, 448, 32, "tiled"), (96, 96, 32, "fused"),
    (1024, 1024, 32, "k1"), (960, 960, 32, "staged"), (200, 200, 32, "staged"),
    (800, 800, 8, "staged"),
    (448, 449, 32, "staged"), (130, 64, 16, "staged"), (2, 2, 32, "fused"),
    (1, 64, 32, "plain"), (1100, 64, 32, "plain"), (64, 1025, 32, "plain"),
    (512, 512, 64, "plain"), (200, 200, 64, "plain"), (96, 96, 24, "plain")])
def test_generate_route_table(h, w, c, route):
    assert generate_route(h, w, c) == route
    assert (route == "staged") <= cs.in_staged_domain(h, w)


@pytest.mark.parametrize("h,w,c,route", [
    (64, 64, 32, "kernels"), (64, 64, 8, "kernels"), (64, 64, 64, "autograd"),
    (64, 64, 24, "autograd"), (128, 128, 32, "autograd"), (64, 48, 32, "autograd")])
def test_train_route(h, w, c, route):
    assert train_route(h, w, c) == route


def test_train_step_takes_the_autograd_route_outside_the_kernels(monkeypatch):
    """A width K1 + K2 do not take trains through the plain generator under
    autograd: the kernel path is never called, and the losses are finite."""
    from mtd_gan_tpu_torch.engine import gan

    def refuse(*args, **kwargs):
        raise AssertionError("the K1 + K2 path was taken")

    monkeypatch.setattr(gan, "resfft_generator_train", refuse)
    model = MTDGANModel(gen_features=12, disc_features=4, num_layers=1, device="cpu")
    trainer = gan.MTDGANTrainer(model, method="pcgrad", seed=0)
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.random((2, 64, 64, 1)), dtype=torch.float32)
    m = trainer.train_step(x, (x + 0.01).clamp(0, 1))
    assert torch.isfinite(m["d_loss"]) and torch.isfinite(m["g_loss"])
