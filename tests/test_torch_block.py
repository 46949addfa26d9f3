"""The Res-FFT block of the PyTorch port against the JAX package:
the plain block (mtd_gan_tpu_torch/ops/fft_conv.py), the plain version of
K1 (``block_fused_reference``) and the wrapper ``block_fused``
(mtd_gan_tpu_torch/ops/cuda_pipeline.py).

Every comparison runs with the reference init N(0, 0.01) — under which a
block is almost the identity — and with std 1/sqrt(fan_in) weights (biases
0.1), compared by relative error max|port - jax| / max|jax|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtd_gan_tpu.ops import pallas_pipeline as pp
from mtd_gan_tpu.ops.fft_conv import fft_conv_block as jax_block
from mtd_gan_tpu.ops.layers import Conv, ConvTranspose
from mtd_gan_tpu_torch.ops.cuda_pipeline import block_fused, block_fused_reference
from mtd_gan_tpu_torch.ops.fft_conv import fft_conv_block, spectral_branch
from mtd_gan_tpu_torch.ops.layers import conv_transpose_as_conv

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

N, C, H, W = 2, 8, 64, 64
INITS = ("reference", "fan_in")
VARIANTS = ("plain", "pre", "pre+skip", "pre+skip+post")


def _weights(init, seed=0):
    """Block operands in the flax layouts (HWIO convs, (kh, kw, in, out)
    deconv, (2C_in, 2C_out) mix), numpy fp32."""
    rng = np.random.default_rng(seed)

    def w(*shape, fan):
        std = 0.01 if init == "reference" else fan ** -0.5
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def b(k):
        v = np.zeros(k) if init == "reference" else rng.standard_normal(k) * 0.1
        return v.astype(np.float32)

    return dict(
        x=rng.random((N, H, W, C)).astype(np.float32),
        ik=w(3, 3, C, C, fan=9 * C), ib=b(C),
        fk=w(2 * C, 2 * C, fan=2 * C), fb=b(2 * C),
        pk=w(3, 3, C, C, fan=9 * C), pb=b(C),
        skip=(rng.standard_normal((N, H, W, C)) * 0.5).astype(np.float32),
        qk=w(3, 3, C, 1, fan=9 * C), qb=b(1),
        img=rng.random((N, H, W, 1)).astype(np.float32))


def _cm(a):
    """NHWC -> channel-major (N, C, H*W)."""
    return np.ascontiguousarray(a.transpose(0, 3, 1, 2).reshape(a.shape[0], -1, H * W))


def _port_args(p, variant):
    t = torch.tensor
    oihw = lambda k: t(k.transpose(3, 2, 0, 1).copy())
    args = dict(x=t(_cm(p["x"])), h=H, w=W, km=oihw(p["ik"]), kb=t(p["ib"]),
                mix=t(p["fk"].T.copy()), mb=t(p["fb"]))
    if variant != "plain":
        args["pre"] = (oihw(p["pk"]), t(p["pb"]))
    if "skip" in variant:
        args["skip"] = t(_cm(p["skip"]))
    if "post" in variant:
        # torch ConvTranspose2d layout (in, out, kh, kw), then the flip
        args["post"] = (conv_transpose_as_conv(t(p["qk"].transpose(2, 3, 0, 1).copy())),
                        t(p["qb"]))
        args["img"] = t(_cm(p["img"]))
    return args


def _as_tuple(r):
    return r if isinstance(r, tuple) else (r,)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("init", INITS)
def test_plain_block_matches_jax_fp32(init):
    """Port block vs JAX fft_conv_block on the CPU (the jnp.fft path,
    ops/fft_conv.py:150-160). rtol 1e-5 / atol 1e-6: both fp32, they differ
    only by FFT round-off (pocketfft in both, other summation order)."""
    p = _weights(init)
    want = np.asarray(jax_block(jnp.asarray(p["x"]), p["ik"], p["ib"], p["fk"], p["fb"]))
    got = fft_conv_block(torch.tensor(p["x"]).permute(0, 3, 1, 2),
                         torch.tensor(p["ik"].transpose(3, 2, 0, 1).copy()),
                         torch.tensor(p["ib"]), torch.tensor(p["fk"].T.copy()),
                         torch.tensor(p["fb"])).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _jax_k1(p, variant):
    """JAX K1 (fft_block_nchw(fused=True)) in interpret mode at precision
    "tf32", operands built as tests/test_pallas_pipeline.py builds them."""
    pack = lambda m: pp._pack_traced(jnp.asarray(m), "tf32")
    kw = {}
    if variant != "plain":
        kw.update(pre_kmat_pack=pack(pp.conv_kmat(p["pk"])),
                  pre_bias=jnp.asarray(p["pb"])[:, None])
    if "skip" in variant:
        kw["skip"] = jnp.asarray(_cm(p["skip"]))
    if "post" in variant:
        kw.update(post_kmat_pack=pack(pp.conv_kmat(jnp.asarray(p["qk"]), flip=True)),
                  post_bias=jnp.asarray(p["qb"])[:, None],
                  post_img=jnp.asarray(_cm(p["img"])))
    return _as_tuple(pp.fft_block_nchw(
        jnp.asarray(_cm(p["x"])), pack(pp.conv_kmat(p["ik"])),
        jnp.asarray(p["ib"])[:, None], pack(p["fk"].T),
        jnp.asarray(p["fb"])[:, None], H, W, precision="tf32",
        interpret=True, **kw))


@pytest.mark.parametrize("init", INITS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_block_fused_reference_matches_jax_k1(variant, init):
    """block_fused_reference vs the JAX K1 kernel (interpret mode, "tf32").
    K1 keeps the spectrum in bf16 VMEM scratch (pallas_pipeline.py:1355) and
    feeds its convs bf16 hi/lo operands, so it sits ~1e-3 from fp32:
    atol 5e-3 at the reference init (the bound tests/test_pallas_pipeline.py
    pins for tf32 tables), 5e-3 relative with fan_in weights (about two
    bf16 unit round-offs, 2^-9 ~ 2e-3 each)."""
    p = _weights(init, seed=VARIANTS.index(variant))
    want = _jax_k1(p, variant)
    got = _as_tuple(block_fused_reference(**_port_args(p, variant)))
    assert len(got) == len(want) == (2 if "post" in variant else 1)
    for g, w_ in zip(got, want):
        if init == "reference":
            np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=5e-3)
        else:
            assert _rel(g.numpy(), w_) < 5e-3


def _jax_fp32_composition(p, variant):
    """K1's function composed from the JAX package's fp32 pieces: the Conv
    and ConvTranspose layers and fft_conv_block (jnp.fft path)."""
    x = jnp.asarray(p["x"])
    a = x
    if variant != "plain":
        a = Conv(C, kernel_size=(3, 3), padding=1).apply(
            {"params": {"kernel": p["pk"], "bias": p["pb"]}}, x)
        if "skip" in variant:
            a = a + p["skip"]
        a = jax.nn.relu(a)
    out = jax_block(a, p["ik"], p["ib"], p["fk"], p["fb"])
    res = [np.asarray(out)]
    if "post" in variant:
        dec = ConvTranspose(1, kernel_size=(3, 3), padding=1).apply(
            {"params": {"kernel": p["qk"], "bias": p["qb"]}}, out)
        res.append(np.asarray(jax.nn.relu(dec + p["img"])))
    return [_cm(r) for r in res]


@pytest.mark.parametrize("init", INITS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_block_fused_reference_matches_jax_fp32_composition(variant, init):
    """The same variants against the fp32 JAX composition: 1e-5 relative
    (fp32 on both sides; FFT and conv summation order differ)."""
    p = _weights(init, seed=10 + VARIANTS.index(variant))
    want = _jax_fp32_composition(p, variant)
    got = _as_tuple(block_fused_reference(**_port_args(p, variant)))
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        assert _rel(g.numpy(), w_) < 1e-5


def test_block_fused_on_cpu_takes_plain_version():
    """A CPU tensor goes to block_fused_reference: same result, and the
    kernel's launch counter does not move."""
    p = _weights("fan_in", seed=3)
    args = _port_args(p, "pre+skip+post")
    before = block_fused.launches
    got = block_fused(**args)
    want = block_fused_reference(**args)
    assert block_fused.launches == before
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=0, atol=0)


def _fft_radix2(data, inverse):
    """In-place radix-2 DIT FFT over the last axis: bit reversal, then
    butterflies with twiddles tw[j << (log_l - 1 - s)]."""
    L = data.shape[-1]
    log_l = L.bit_length() - 1
    rev = np.array([int(format(i, f"0{log_l}b")[::-1], 2) for i in range(L)])
    data = data[..., rev].copy()
    tw = np.exp(-2j * np.pi * np.arange(L // 2) / L)
    if inverse:
        tw = np.conj(tw)
    for s in range(log_l):
        m = 1 << s
        b = np.arange(L // 2)
        j = b & (m - 1)
        i0 = ((b >> s) << (s + 1)) + j
        u, v = data[..., i0], tw[j << (log_l - 1 - s)] * data[..., i0 + m]
        data[..., i0], data[..., i0 + m] = u + v, u - v
    return data


def _kernel_spectral(x, mix, mb):
    """A radix-2 model of the spectral branch on one sample (C, H, W): two
    real rows per complex row FFT, the per-bin column FFT -> mix ->
    inverse, and the Hermitian c2r that keeps only the real part of the W
    bins 0 and W/2, two rows per complex inverse FFT."""
    c, h, w = x.shape
    k = np.arange(w // 2 + 1)
    z = _fft_radix2(x[:, 0::2] + 1j * x[:, 1::2], False)        # (C, H/2, W)
    zk, zc = z[..., k], np.conj(z[..., (w - k) % w])
    spec = np.empty((c, h, k.size), complex)                     # [c, row, k]
    spec[:, 0::2], spec[:, 1::2] = (zk + zc) / 2, (zk - zc) / 2j
    spec /= np.sqrt(w)
    col = _fft_radix2(spec.transpose(0, 2, 1), False) / np.sqrt(h)  # [c, k, h]
    v = np.concatenate([col.real, col.imag], 0)                  # (2C, K, H)
    o = np.maximum(np.einsum("oi,ikh->okh", mix, v) + mb[:, None, None], 0)
    col = _fft_radix2(o[:c] + 1j * o[c:], True) / np.sqrt(h)
    a, b = col[..., 0::2].copy(), col[..., 1::2].copy()          # [c, k, pair]
    for t in (a, b):
        t[:, [0, -1]] = t[:, [0, -1]].real
    full = np.zeros((c, w, h // 2), complex)
    full[:, k] = a + 1j * b
    kk = np.arange(1, w // 2)
    full[:, w - kk] = np.conj(a[:, kk]) + 1j * np.conj(b[:, kk])
    rows = _fft_radix2(full.transpose(0, 2, 1), True) / np.sqrt(w)  # [c, pair, w]
    out = np.empty((c, h, w))
    out[:, 0::2], out[:, 1::2] = rows.real, rows.imag
    return out


def test_kernel_spectral_algorithm_matches_irfft2():
    """A radix-2 model of the branch (emulated in float64) equals the plain
    spectral branch to float64 round-off: the row packing/unpacking, the
    scaling and the irfft2 treatment of non-Hermitian input are right."""
    rng = np.random.default_rng(5)
    c, h, w = 4, 16, 32
    x = rng.standard_normal((c, h, w))
    mix = rng.standard_normal((2 * c, 2 * c)) / np.sqrt(2 * c)
    mb = rng.standard_normal(2 * c) * 0.1
    want = spectral_branch(torch.tensor(x[None]), torch.tensor(mix),
                           torch.tensor(mb))[0].numpy()
    np.testing.assert_allclose(_kernel_spectral(x, mix, mb), want, atol=1e-12)
