"""K1 beyond its four squares: the shapes the JAX ``generate`` sends to its
fused-block kernel (H >= 256, H and W multiples of 128), which the port's K1
takes up to 1024 a side (``cuda_pipeline.in_k1_domain``).

On the CPU the wrapper runs its plain version, ``block_fused_reference``;
here it is held against the JAX K1 (``fft_block_nchw(fused=True)``, interpret
mode) at small shapes of the new classes the JAX kernel takes: an odd factor
in H (48 = 16 * 3, 40 = 8 * 5) and H != W. The JAX kernel's dense H table
(every H whose quarter is not a multiple of 8, 48 and 40 here) packs one
bf16 row at precision "tf32", so these run at "bf16x2", its default. Then
the routes: ``generate_route`` over the JAX gate, K2's domain, which does
not widen with K1's, and ``train_route``. The kernels themselves run only on
the card (tests/test_torch_cuda.py, chip_smoke.py phase 35)."""

import ast
import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtd_gan_tpu.ops import pallas_pipeline as pp
from mtd_gan_tpu_torch.models.mtd_gan import ResFFTGenerator, generate_route
from mtd_gan_tpu_torch.ops import cuda_train
from mtd_gan_tpu_torch.ops.cuda_fftconv import in_fused_domain, in_tiled_domain
from mtd_gan_tpu_torch.ops.cuda_pipeline import (KERNEL_CHANNELS, block_fused,
                                                 block_fused_reference, in_k1_domain,
                                                 prep_generator_params, resfft_generator_nchw)
from mtd_gan_tpu_torch.ops.cuda_staged import in_staged_domain
from mtd_gan_tpu_torch.ops.cuda_train import (BWD_SIZES, TRAIN_SIZES, BlockTrain,
                                              resfft_generator_train, resolve_g_forward,
                                              train_route)
from mtd_gan_tpu_torch.ops.layers import conv_transpose_as_conv

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

N, C = 1, 8
BF16 = torch.bfloat16
SHAPES = ((48, 64), (40, 64), (64, 32))
# (variant, init): pre+skip at the reference init, pre+skip+post with
# 1/sqrt(fan_in) weights, one JAX call each; both at the odd factors, the
# second at H != W
CASES = (("pre+skip", "reference"), ("pre+skip+post", "fan_in"))
K1_CASES = [(h, w) + case for h, w in SHAPES[:2] for case in CASES] + [SHAPES[2] + CASES[1]]
PRECISION = "bf16x2"


def _weights(init, h, w, seed):
    """Block operands in the flax layouts, numpy fp32 (as test_torch_block)."""
    rng = np.random.default_rng(seed)

    def wt(*shape, fan):
        std = 0.01 if init == "reference" else fan ** -0.5
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def b(k):
        v = np.zeros(k) if init == "reference" else rng.standard_normal(k) * 0.1
        return v.astype(np.float32)

    return dict(x=rng.random((N, h, w, C)).astype(np.float32),
                ik=wt(3, 3, C, C, fan=9 * C), ib=b(C),
                fk=wt(2 * C, 2 * C, fan=2 * C), fb=b(2 * C),
                pk=wt(3, 3, C, C, fan=9 * C), pb=b(C),
                skip=(rng.standard_normal((N, h, w, C)) * 0.5).astype(np.float32),
                qk=wt(3, 3, C, 1, fan=9 * C), qb=b(1),
                img=rng.random((N, h, w, 1)).astype(np.float32))


def _cm(a):
    """NHWC -> channel-major (N, C, H*W)."""
    return np.ascontiguousarray(a.transpose(0, 3, 1, 2).reshape(a.shape[0], a.shape[3], -1))


def _as_tuple(r):
    return r if isinstance(r, tuple) else (r,)


@functools.cache
def _case(h, w, variant, init):
    return _weights(init, h, w, seed=SHAPES.index((h, w)) + 10 * CASES.index((variant, init)))


@functools.cache
def _jax_k1(h, w, variant, init, act=jnp.float32):
    """The JAX K1 in interpret mode, as tests/test_torch_block.py builds it
    (at precision ``PRECISION``), on activations of type ``act``; numpy
    fp32 outputs."""
    p = _case(h, w, variant, init)
    pack = lambda m: pp._pack_traced(jnp.asarray(m), PRECISION)
    kw = dict(pre_kmat_pack=pack(pp.conv_kmat(p["pk"])),
              pre_bias=jnp.asarray(p["pb"])[:, None],
              skip=jnp.asarray(_cm(p["skip"])).astype(act))
    if "post" in variant:
        kw.update(post_kmat_pack=pack(pp.conv_kmat(jnp.asarray(p["qk"]), flip=True)),
                  post_bias=jnp.asarray(p["qb"])[:, None],
                  post_img=jnp.asarray(_cm(p["img"])))
    out = pp.fft_block_nchw(
        jnp.asarray(_cm(p["x"])).astype(act), pack(pp.conv_kmat(p["ik"])),
        jnp.asarray(p["ib"])[:, None], pack(p["fk"].T), jnp.asarray(p["fb"])[:, None],
        h, w, precision=PRECISION, interpret=True, **kw)
    return tuple(np.asarray(o, np.float32) for o in _as_tuple(out))


def _port_k1(h, w, variant, init, act=torch.float32):
    p = _case(h, w, variant, init)
    t = torch.tensor
    oihw = lambda k: t(k.transpose(3, 2, 0, 1).copy())
    args = dict(x=t(_cm(p["x"])).to(act), h=h, w=w, km=oihw(p["ik"]), kb=t(p["ib"]),
                mix=t(p["fk"].T.copy()), mb=t(p["fb"]), pre=(oihw(p["pk"]), t(p["pb"])),
                skip=t(_cm(p["skip"])).to(act))
    if "post" in variant:
        args["post"] = (conv_transpose_as_conv(t(p["qk"].transpose(2, 3, 0, 1).copy())),
                        t(p["qb"]))
        args["img"] = t(_cm(p["img"]))
    return tuple(o.float().numpy() for o in _as_tuple(block_fused_reference(**args)))


@pytest.mark.parametrize("h,w,variant,init", K1_CASES)
def test_block_fused_reference_matches_jax_k1_at_new_shapes(h, w, variant, init):
    """block_fused_reference against the JAX K1 at tests/test_torch_block.py's
    tolerances: atol 5e-3 at the reference init, 5e-3 relative with fan_in
    weights (the JAX kernel keeps its spectrum in bf16 scratch)."""
    want = _jax_k1(h, w, variant, init)
    got = _port_k1(h, w, variant, init)
    assert len(got) == len(want) == (2 if "post" in variant else 1)
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape
        if init == "reference":
            np.testing.assert_allclose(g, w_, atol=5e-3)
        else:
            assert np.abs(g - w_).max() / np.abs(w_).max() < 5e-3


def test_block_fused_reference_bf16_matches_jax_k1_bf16():
    """K1-bf16's plain version against the JAX K1 on bf16 activations at
    48x64 (pre+skip+post, fan_in), per output within the budget of
    tests/test_torch_bf16_routes.py: 2 err(JAX bf16, JAX fp32) + the fp32
    parity + 1e-6."""
    case = (48, 64, "pre+skip+post", "fan_in")
    want_bf16 = _jax_k1(*case, act=jnp.bfloat16)
    want_fp32, got_fp32 = _jax_k1(*case), _port_k1(*case)
    got = _port_k1(*case, act=BF16)
    for g, wb, wf, gf in zip(got, want_bf16, want_fp32, got_fp32):
        budget = 2 * np.abs(wb - wf).max() + np.abs(gf - wf).max() + 1e-6
        assert np.abs(g - wb).max() <= budget
    assert not np.array_equal(got[0], got_fp32[0])  # bf16 did round


def test_kernel_pipeline_takes_h_not_w_on_the_cpu():
    """The K1 pipeline's wiring at H != W with an odd factor in H (48x64),
    on CPU tensors through K1's plain version: equal to the plain module
    within 1e-5 relative, no kernel launch."""
    rng = np.random.default_rng(7)
    gen = ResFFTGenerator(1, C, 1)
    with torch.no_grad():
        for p in gen.parameters():
            p.copy_(torch.tensor(rng.standard_normal(p.shape) / np.sqrt(p[0].numel())
                                 if p.dim() > 1 else 0.1 * rng.standard_normal(p.shape)))
    x = torch.tensor(rng.random((2, 48, 64, 1)), dtype=torch.float32)
    before = block_fused.launches
    got = resfft_generator_nchw(gen.state_dict(), x, 1)
    assert block_fused.launches == before
    with torch.no_grad():
        want = gen(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    assert ((got - want).abs().max() / want.abs().max()).item() < 1e-5


def test_k1_weights_are_the_generators_parameters():
    """The K1 pipeline's weights (``prep_generator_params``) are views of an
    fp32 generator's parameters, the deconvs included (K1 reads them
    flipped in place): preparing them copies nothing, so ``generate`` on the
    k1 route does no weight work per call and sees every update."""
    gen = ResFFTGenerator(1, C, 2)
    pp_ = prep_generator_params(gen.state_dict(), 2)
    got = [pp_["enc0"], pp_["dec0_post"], *pp_["enc"], *pp_["dec"]]
    want = [gen.encoder[0], gen.decoder[0], *gen.encoder[1:], *gen.decoder[1:]]
    for (wt, bs), m in zip(got, want):
        assert wt.data_ptr() == m.weight.data_ptr() and wt.shape == m.weight.shape
        assert bs.data_ptr() == m.bias.data_ptr()
    for (km, kb, mix, mb), blk in zip(pp_["blocks"], gen.enforce):
        assert km.data_ptr() == blk.img_conv.weight.data_ptr()
        assert mix.data_ptr() == blk.fft_conv.weight.data_ptr() and mix.shape == (2 * C, 2 * C)


def _jax_gate(h, w):
    """The JAX generate's gate to its K1 pipeline
    (mtd_gan_tpu/models/mtd_gan.py:284-287)."""
    return h >= 256 and h % 128 == 0 and w % 128 == 0


def _route_without_k1(h, w, c):
    """generate_route's order after k1: tiled, fused, staged, plain."""
    if c not in KERNEL_CHANNELS:
        return "plain"
    for route, fits in (("tiled", in_tiled_domain), ("fused", in_fused_domain),
                        ("staged", in_staged_domain)):
        if fits(h, w):
            return route
    return "plain"


# the gate's edges: every multiple of 128 up to 1024 and past it, the sides
# next to them and to the other routes' edges (64, 768, 1024), and a few off
# every grid
SIDES = sorted({1, 2, 8, 33, 56, 64, 72, 100, 120, 128, 136, 192, 200, 248, 256, 264, 320,
                384, 448, 449, 512, 576, 640, 704, 760, 768, 776, 832, 896, 960, 1016, 1024,
                1025, 1032, 1088, 1152, 1280})


@pytest.mark.parametrize("dtype", [None, BF16])
def test_generate_route_takes_k1_over_the_jax_gate(dtype):
    """k1 exactly on H == W in {64, 128} and on the JAX gate up to 1024 a
    side, for C in {8, 16, 32}, fp32 and bf16; the other routes as before
    everywhere else (a side above 1024 on the gate: the plain module)."""
    k1 = set()
    for h in SIDES:
        for w in SIDES:
            domain = (h == w and h in (64, 128)) or (_jax_gate(h, w) and max(h, w) <= 1024)
            assert in_k1_domain(h, w) == domain, (h, w)
            k1 |= {(h, w)} if domain else set()
            for c in KERNEL_CHANNELS + (24, 64):
                route = generate_route(h, w, c, dtype)
                if domain and c in KERNEL_CHANNELS:
                    assert route == "k1", (h, w, c)
                else:
                    assert route == _route_without_k1(h, w, c), (h, w, c, route)
    # 7 heights x 8 widths on the gate, and the two small squares
    assert len(k1) == 7 * 8 + 2
    assert generate_route(1152, 1152, 32, dtype) == "plain"
    assert generate_route(1024, 1152, 32, dtype) == "plain"
    for h, w in ((1024, 1024), (384, 384), (640, 640), (768, 768), (512, 1024), (768, 384)):
        assert generate_route(h, w, 32, dtype) == "k1"


def _recorder(monkeypatch):
    calls = []

    def block_fused(x, *args, **kwargs):
        calls.append(1)
        return torch.empty_like(x)

    monkeypatch.setattr(cuda_train, "block_fused", block_fused)
    return calls


def test_block_train_raises_before_k1_outside_k2s_sizes(monkeypatch):
    """K2 keeps its domain (H == W in BWD_SIZES) while K1's widens: off the
    CPU, BlockTrain and resfft_generator_train raise at 1024x1024 (and
    384x384, 512x256) before K1 is called; at 512x512 they reach it."""
    calls = _recorder(monkeypatch)
    assert BWD_SIZES == (64, 128, 256, 512)
    before = (block_fused.launches, block_fused.launches_bf16)
    meta = lambda *s: torch.empty(s, device="meta")
    for h, w in ((1024, 1024), (384, 384), (512, 256)):
        assert in_k1_domain(h, w)
        with pytest.raises(ValueError, match=f"BlockTrain: K2 takes H == W in .*{h}x{w}"):
            BlockTrain.apply(meta(2, C, h * w), None, None, meta(C, C, 3, 3), meta(C),
                             meta(2 * C, 2 * C), meta(2 * C), None, None, None, None, h, w)
        with torch.device("meta"):
            gen = ResFFTGenerator(1, C, 1)
        with pytest.raises(ValueError, match="K2 takes H == W"):
            resfft_generator_train(gen, meta(1, h, w, 1))
    assert calls == []
    BlockTrain.apply(meta(2, C, 512 * 512), None, None, meta(C, C, 3, 3), meta(C),
                     meta(2 * C, 2 * C), meta(2 * C), None, None, None, None, 512, 512)
    assert calls == [1]
    assert (block_fused.launches, block_fused.launches_bf16) == before


@pytest.mark.parametrize("h,w", [(64, 64), (128, 128), (512, 512), (1024, 1024), (384, 384),
                                 (768, 384), (256, 1024)])
def test_train_route_is_unchanged(h, w):
    """The train step takes K1 + K2 at 64x64 only (TRAIN_SIZES), whatever
    K1 takes: ``auto`` resolves to autograd and ``pallas`` raises elsewhere."""
    for c in KERNEL_CHANNELS:
        kernels = h == w and h in TRAIN_SIZES
        assert train_route(h, w, c) == ("kernels" if kernels else "autograd")
        assert resolve_g_forward("auto", h, w, c) == ("pallas" if kernels else "einsum")
        if not kernels:
            with pytest.raises(ValueError, match="K1 \\+ K2 take H == W in"):
                resolve_g_forward("pallas", h, w, c)


def _assigned(path, name):
    """The value of the top-level ``name = ...`` in ``path`` (a literal)."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"no {name} in {path}")


def test_card_shapes_agree_and_cover_the_column_passes():
    """chip_smoke.py's K1_GATE_SHAPES (phase 35) and the card tests' are the
    same shapes, all in K1's domain: 1024 a side, the odd factors 3, 5 and
    7 of H, H != W both ways, and a power-of-two H below W; the digests'
    K1 instances (tools/torch_fp32_digests.py) cover the four squares and
    lie in the domain too."""
    repo = Path(__file__).resolve().parent.parent
    smoke = _assigned(repo / "chip_smoke.py", "K1_GATE_SHAPES")
    assert [tuple(s) for s in smoke] == _assigned(repo / "tests" / "test_torch_cuda.py",
                                                  "K1_GATE_SHAPES")
    assert all(in_k1_domain(h, w) for _, h, w in smoke)
    odd = {h // (h & -h) for _, h, _ in smoke}
    assert odd == {1, 3, 5, 7} and max(h for _, h, _ in smoke) == 1024
    assert any(h < w for _, h, w in smoke) and any(h > w for _, h, w in smoke)
    blocks = _assigned(repo / "tools" / "torch_fp32_digests.py", "BLOCKS")
    assert all(in_k1_domain(h, w) for _, _, h, w, _ in blocks)
    assert {h for _, _, h, w, _ in blocks if h == w} >= {64, 128, 256, 512}
