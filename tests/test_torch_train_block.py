"""The training path of the port's generator against the JAX package: K2's
plain version (``block_bwd_reference``) through ``BlockTrain`` against
``jax.vjp`` of the fp32 JAX block in all four variants;
``resfft_generator_train`` against ``jax.grad`` of ``Generator.apply`` and
against the JAX K2 path (``pallas_train.resfft_generator_train``, interpret
mode), whose five blocks at L = 2 run all four variants; and a float64
emulation of the kernel's spectral adjoint with numpy's FFTs
(csrc/block_bwd.cu::column_bwd_kernel; its radix schedule is modelled in
tests/test_torch_rows.py) against autograd.

Every comparison is a worst-leaf relative error: max|port - jax| /
max|jax| over each gradient leaf, in the flax layouts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtd_gan_tpu.models.mtd_gan import MTDGANModel as JaxModel
from mtd_gan_tpu.ops.fft_conv import fft_conv_block as jax_block
from mtd_gan_tpu.ops.layers import Conv, ConvTranspose
from mtd_gan_tpu.ops.pallas_train import resfft_generator_train as jax_generator_train
from mtd_gan_tpu_torch.models.mtd_gan import ResFFTGenerator
from mtd_gan_tpu_torch.ops import cuda_train
from mtd_gan_tpu_torch.ops.cuda_train import (BlockTrain, block_bwd, block_bwd_reference,
                                              resfft_generator_train)
from mtd_gan_tpu_torch.ops.fft_conv import spectral_branch
from mtd_gan_tpu_torch.ops.layers import conv_transpose_as_conv
from mtd_gan_tpu_torch.utils.torch_import import generator_state_dict_from_flax

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

N, C, H, PW = 2, 8, 32, 32
VARIANTS = ("plain", "pre", "pre+skip", "pre+skip+post")
LEAVES = ("x", "skip", "img", "ik", "ib", "fk", "fb", "pk", "pb", "qk", "qb")


def _inputs(variant, seed, size=H):
    """Block operands in the flax layouts (NHWC activations, HWIO convs,
    (kh, kw, in, out) exit deconv, (2C_in, 2C_out) mix) with 1/sqrt(fan_in)
    weights and 0.1 biases, plus seeded cotangents, at ``size`` x ``size``;
    numpy fp32."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s)
    p = dict(x=rng.random((N, size, size, C)),
             ik=f(3, 3, C, C) / np.sqrt(9 * C), ib=f(C) * 0.1,
             fk=f(2 * C, 2 * C) / np.sqrt(2 * C), fb=f(2 * C) * 0.1,
             g=f(N, size, size, C))
    if variant != "plain":
        p.update(pk=f(3, 3, C, C) / np.sqrt(9 * C), pb=f(C) * 0.1)
    if "skip" in variant:
        p["skip"] = f(N, size, size, C) * 0.5
    if "post" in variant:
        p.update(qk=f(3, 3, C, 1) / np.sqrt(9 * C), qb=f(1) * 0.1,
                 img=rng.random((N, size, size, 1)), gfin=f(N, size, size, 1))
    return {k: v.astype(np.float32) for k, v in p.items()}


def _cm(t):
    """NHWC torch -> channel-major (N, C, H*W)."""
    return t.permute(0, 3, 1, 2).reshape(t.shape[0], t.shape[3], -1).contiguous()


def _port_grads(p, variant):
    """Gradients of <out, g> + <final, gfin> through one BlockTrain on CPU
    tensors (plain K1 forward, plain K2 backward), w.r.t. leaves in the flax
    layouts: the port's weight layouts are built from them with torch ops."""
    lv = {k: torch.tensor(p[k], requires_grad=True) for k in LEAVES if k in p}
    pre_w = lv["pk"].permute(3, 2, 0, 1).contiguous() if "pk" in lv else None
    post_w = (conv_transpose_as_conv(lv["qk"].permute(2, 3, 0, 1))
              if "qk" in lv else None)
    res = BlockTrain.apply(
        _cm(lv["x"]), _cm(lv["skip"]) if "skip" in lv else None,
        _cm(lv["img"]) if "img" in lv else None,
        lv["ik"].permute(3, 2, 0, 1).contiguous(), lv["ib"],
        lv["fk"].t().contiguous(), lv["fb"], pre_w, lv.get("pb"), post_w,
        lv.get("qb"), p["x"].shape[1], p["x"].shape[2])
    outs = res if isinstance(res, tuple) else (res,)
    loss = (outs[0] * _cm(torch.tensor(p["g"]))).sum()
    if "post" in variant:
        loss = loss + (outs[1] * _cm(torch.tensor(p["gfin"]))).sum()
    grads = torch.autograd.grad(loss, list(lv.values()))
    return {k: g.numpy() for k, g in zip(lv, grads)}


def _jax_fp32_grads(p, variant):
    """jax.vjp of the block composed from the JAX package's fp32 pieces
    (Conv, ConvTranspose, fft_conv_block on the jnp.fft path)."""
    names = [k for k in LEAVES if k in p]

    def f(*vals):
        v = dict(zip(names, vals))
        a = v["x"]
        if "pk" in v:
            a = Conv(C, kernel_size=(3, 3), padding=1).apply(
                {"params": {"kernel": v["pk"], "bias": v["pb"]}}, a)
            if "skip" in v:
                a = a + v["skip"]
            a = jax.nn.relu(a)
        out = jax_block(a, v["ik"], v["ib"], v["fk"], v["fb"])
        if "qk" not in v:
            return out
        dec = ConvTranspose(1, kernel_size=(3, 3), padding=1).apply(
            {"params": {"kernel": v["qk"], "bias": v["qb"]}}, out)
        return out, jax.nn.relu(dec + v["img"])

    _, pull = jax.vjp(f, *[jnp.asarray(p[k]) for k in names])
    ct = (jnp.asarray(p["g"]), jnp.asarray(p["gfin"])) if "post" in variant \
        else jnp.asarray(p["g"])
    return {k: np.asarray(g) for k, g in zip(names, pull(ct))}


def _worst(got, want):
    assert sorted(got) == sorted(want)
    return {k: float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
            for k in want}


@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_k2_matches_jax_fp32_block(variant):
    """Against jax.vjp of the fp32 JAX block: worst-leaf 1e-4 relative
    (fp32 on both sides; FFT and conv summation order differ, ~1e-6)."""
    p = _inputs(variant, seed=10 + VARIANTS.index(variant))
    worst = _worst(_port_grads(p, variant), _jax_fp32_grads(p, variant))
    assert max(worst.values()) < 1e-4, worst


def test_block_bwd_on_cpu_takes_plain_version():
    """A CPU tensor goes to block_bwd_reference (same result, no launch);
    a missing output cotangent counts as zero."""
    rng = np.random.default_rng(3)
    t = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.float32)
    args = dict(x=t(N, C, 64 * 64), g=None, h=64, w=64, km=t(C, C, 3, 3) * 0.1,
                kb=t(C), mix=t(2 * C, 2 * C) * 0.1, mb=t(2 * C),
                pre=(t(C, C, 3, 3) * 0.1, t(C)), skip=t(N, C, 64 * 64),
                post=(t(1, C, 3, 3) * 0.1, t(1)), img=t(N, 1, 64 * 64),
                gfin=t(N, 1, 64 * 64))
    before = block_bwd.launches
    got = block_bwd(**args)
    assert block_bwd.launches == before
    want = block_bwd_reference(**{**args, "g": torch.zeros(N, C, 64 * 64)})
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_launch_geometry_fills_the_card():
    """Weight-gradient and spectral column blocks: a block per unit of
    work (a 4-row band, an (n, k) bin) at small batches, about two blocks
    per SM (one wave, one partial each) at large ones."""
    assert cuda_train._launch_geometry(2, 64, 33) == (32, 66)
    assert cuda_train._launch_geometry(160, 64, 33) == (264, 264)
    assert cuda_train._launch_geometry(8, 64, 33) == (8 * 64 // 4, 264)


def _k2_spectral_adjoint(hin, g, mix, mb):
    """column_bwd_kernel's algorithm on one sample (C, H, W) in float64,
    between K1's row passes: the c2r's adjoint as a half-spectrum rFFT
    weighted 2 on interior bins and 1 (imaginary part zeroed) on bins 0 and
    W/2, H-FFT, the mask of the recomputed s_pre, dmix / dmb, mix^T, the
    inverse H-FFT, division by the weights, and the c2r (which drops the
    imaginary parts of bins 0 and W/2) as the rFFT's adjoint."""
    c, h, w = hin.shape
    wk = np.full(w // 2 + 1, 2.0)
    wk[[0, -1]] = 1.0
    gspec = np.fft.rfft(g, axis=-1, norm="ortho") * wk
    gspec[..., [0, -1]] = gspec[..., [0, -1]].real
    a = np.fft.fft(np.fft.rfft(hin, axis=-1, norm="ortho"), axis=1, norm="ortho")
    b = np.fft.fft(gspec, axis=1, norm="ortho")
    s_in = np.concatenate([a.real, a.imag])
    s_pre = np.einsum("oi,ihk->ohk", mix, s_in) + mb[:, None, None]
    sbar = np.concatenate([b.real, b.imag]) * (s_pre > 0)
    t = np.einsum("oi,ohk->ihk", mix, sbar)
    back = np.fft.ifft(t[:c] + 1j * t[c:], axis=1, norm="ortho") / wk
    back[..., [0, -1]] = back[..., [0, -1]].real
    return (np.fft.irfft(back, n=w, axis=-1, norm="ortho"),
            np.einsum("ohk,ihk->oi", sbar, s_in), sbar.sum((1, 2)))


def test_kernel_spectral_adjoint_algorithm_matches_autograd():
    """The spectral adjoint as K2 computes it equals autograd through the
    plain spectral branch to float64 round-off."""
    rng = np.random.default_rng(5)
    c, h, w = 4, 16, 32
    hin, g = rng.standard_normal((2, c, h, w))
    mix = rng.standard_normal((2 * c, 2 * c)) / np.sqrt(2 * c)
    mb = rng.standard_normal(2 * c) * 0.1
    leaves = [torch.tensor(v, requires_grad=True) for v in (hin[None], mix, mb)]
    out = spectral_branch(*leaves)
    want = torch.autograd.grad(out, leaves, torch.tensor(g[None]))
    got = _k2_spectral_adjoint(hin, g, mix, mb)
    for a, b in zip(got, (want[0][0], want[1], want[2])):
        np.testing.assert_allclose(a, b.numpy(), atol=1e-12)


@pytest.fixture(scope="module")
def generator_setup():
    jm = JaxModel(gen_features=C, disc_features=8, num_layers=2)
    params = jax.jit(jm.Generator.init)(jax.random.PRNGKey(0),
                                        np.zeros((1, H, PW, 1), np.float32))["params"]
    rng = np.random.default_rng(1)

    def redraw(path, leaf):  # 1/sqrt(fan_in) weights, 0.1 biases
        if "bias" in jax.tree_util.keystr(path):
            return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)
        fan_in = leaf.shape[0] if leaf.ndim == 2 else int(np.prod(leaf.shape[:3]))
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(redraw, params)
    x = rng.random((N, H, PW, 1)).astype(np.float32)
    y = np.clip(x + 0.05 * rng.standard_normal(x.shape), 0, 1).astype(np.float32)
    gen = ResFFTGenerator(1, C, 2)
    gen.load_state_dict(generator_state_dict_from_flax(params))
    return jm, params, gen, x, y


def _port_generator_grads(gen, x, y, forward):
    out = forward(gen, torch.tensor(x))
    loss = ((out - torch.tensor(y)) ** 2).mean()
    names, params = zip(*gen.named_parameters())
    return out.detach().numpy(), dict(zip(names, torch.autograd.grad(loss, params)))


def test_train_generator_matches_plain_module_under_autograd(generator_setup):
    """resfft_generator_train on CPU tensors (BlockTrain with K1's and K2's
    plain versions, the kernel path's wiring and weight prep) against the
    plain ResFFTGenerator under autograd: output and every parameter
    gradient within 1e-5 relative (the same fp32 ops, grouped otherwise)."""
    _, _, gen, x, y = generator_setup
    before = (cuda_train.block_fused.launches, block_bwd.launches)
    out, got = _port_generator_grads(gen, x, y, resfft_generator_train)
    assert (cuda_train.block_fused.launches, block_bwd.launches) == before
    out2, want = _port_generator_grads(
        gen, x, y, lambda g, t: g(t.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
    assert np.abs(out - out2).max() <= 1e-5 * np.abs(out2).max()
    for k in want:
        rel = float((got[k] - want[k]).abs().max() / want[k].abs().max())
        assert rel < 1e-5, (k, rel)


def test_train_generator_grads_match_jax(generator_setup):
    """resfft_generator_train's parameter gradients against jax.grad of
    the fp32 Generator.apply (jnp.fft path) at L = 2, 8 features:
    worst-leaf 1e-4 relative, compared in the flax layouts through the
    port's own carry-over."""
    jm, params, gen, x, y = generator_setup
    want = jax.grad(lambda p: jnp.mean((jm.Generator.apply({"params": p}, x) - y) ** 2))(
        params)
    _, got = _port_generator_grads(gen, x, y, resfft_generator_train)
    flat_want = generator_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, want))
    for k, w in flat_want.items():
        rel = float((got[k] - w).abs().max() / w.abs().max())
        assert rel < 1e-4, (k, rel)


def test_train_generator_grads_match_jax_k2_path():
    """Against the JAX K2 path, pallas_train.resfft_generator_train in
    interpret mode (fp32 activations, bf16x2 spectral / bf16 conv packs and
    bf16 spectral scratch), in the JAX package's own configuration and at
    its own bound (tests/test_pallas_train.py:16-66): JAX init, L = 2, 8
    features, worst-leaf 5e-2 relative, at 4 x 16 x 16 to keep the
    interpret-mode run short. The JAX kernel's bf16 internals set that
    bound; the port computes in fp32."""
    jm = JaxModel(gen_features=C, disc_features=8, num_layers=2, dtype=jnp.float32)
    params = jax.jit(jm.Generator.init)(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 16, 16, 1), jnp.float32))["params"]
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (4, 16, 16, 1), jnp.float32))
    y = np.clip(x + 0.05, 0, 1)
    want = jax.jit(jax.grad(lambda p: jnp.mean((jax_generator_train(
        p, x, num_layers=2, act_dtype=jnp.float32) - y) ** 2)))(params)
    gen = ResFFTGenerator(1, C, 2)
    gen.load_state_dict(generator_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    _, got = _port_generator_grads(gen, x, y, resfft_generator_train)
    flat_want = generator_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, want))
    for k, w in flat_want.items():
        rel = float((got[k] - w).abs().max() / (w.abs().max() + 1e-8))
        assert rel < 5e-2, (k, rel)
