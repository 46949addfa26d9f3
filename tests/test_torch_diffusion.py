"""The diffusion family of the port (``mtd_gan_tpu_torch/models/diffusion``)
against the JAX package's: the flax <-> state-dict converters bit for bit,
``timestep_embedding``, ``ResnetBlock``, ``AttentionBlock`` (dense, with
heads, and alone over 4224 tokens, JAX's query-chunked branch) and the
whole UNet (both attention branches) on numpy-drawn weights, every leaf
drawn (``conv2`` and ``out_conv`` start at zero, so init weights would
compare zeros); ``add_noise``; each scheduler's whole chain at its full
step count against JAX's ``_scan_body`` with an oracle ``eps_fn`` (DDPM fed
JAX's per-step ``z``); DDIM's and DDPM's 3-step ``sample`` on the tiny
UNet fed JAX's draws. The tiny UNet is the JAX tests' (channels (8, 16,
16), 16 head channels, GroupNorm(4)); the loss and the trainer are in
``test_torch_diffusion_train.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtd_gan_tpu.models.diffusion import schedulers as jax_sched
from mtd_gan_tpu.models.diffusion.unet import AttentionBlock as JaxAttention
from mtd_gan_tpu.models.diffusion.unet import ResnetBlock as JaxResnet
from mtd_gan_tpu.models.diffusion.unet import timestep_embedding as jax_embedding
from mtd_gan_tpu_torch.models.diffusion import schedulers, wrappers
from mtd_gan_tpu_torch.models.diffusion.unet import (AttentionBlock, ResnetBlock,
                                                     timestep_embedding)
from mtd_gan_tpu_torch.utils.torch_import import (diffusion_unet_flax_from_state_dict,
                                                  diffusion_unet_state_dict_from_flax)
from test_torch_diffusion_helpers import (ATOL, RTOL_SAMPLE, TINY, draw_tree, load_flax,
                                          tiny_models, tiny_unet)
from test_torch_train_helpers import host, nchw, rel

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

SCHEDULERS = {"DDPM": (jax_sched.DDPMScheduler, schedulers.DDPMScheduler),
              "DDIM": (jax_sched.DDIMScheduler, schedulers.DDIMScheduler),
              "PNDM": (jax_sched.PNDMScheduler, schedulers.PNDMScheduler),
              "DPM": (jax_sched.DPMSolverMultistepScheduler,
                      schedulers.DPMSolverMultistepScheduler)}
t = torch.tensor


def test_unet_state_dict_round_trips_flax_bit_for_bit():
    """flax tree -> state dict -> flax tree gives every leaf back bit for
    bit; the state dict holds exactly the port's keys and shapes; a fresh
    port UNet outputs exactly 0 (``conv2`` and ``out_conv`` zero), as the
    JAX one does."""
    _, params, _ = tiny_unet()
    sd = diffusion_unet_state_dict_from_flax(host(params))
    fresh = wrappers.DDIMModel(**TINY, device="cpu", seed=3)
    assert {k: v.shape for k, v in sd.items()} == {
        k: v.shape for k, v in fresh.net.state_dict().items()}
    back = diffusion_unet_flax_from_state_dict(sd)
    flat_want = jax.tree_util.tree_leaves_with_path(host(params))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], leaf, err_msg=str(path))
    z = fresh.eps(torch.rand(2, 16, 16, 1), torch.rand(2, 16, 16, 1), t([3, 900]))
    assert z.shape == (2, 16, 16, 1) and z.detach().abs().max().item() == 0.0


def test_timestep_embedding_matches_jax():
    """cos before sin, float32; an odd width padded with one zero. The
    frequency tables agree within one float32 ulp (XLA's ``exp`` and
    torch's round 9 of 64 entries the other way), which moves the argument
    t * f by up to t * 2^-23: each row held to ATOL plus that."""
    steps = np.array([0, 1, 17, 500, 999], np.int32)
    for dim in (8, 128, 33):
        want = np.asarray(jax_embedding(jnp.asarray(steps), dim))
        got = timestep_embedding(torch.from_numpy(steps), dim).numpy()
        tol = ATOL + steps[:, None] * 2.0 ** -23
        assert (np.abs(got - want) <= tol).all(), (dim, np.abs(got - want).max())
    np.testing.assert_allclose(got[:3], want[:3], rtol=0, atol=ATOL)


@pytest.mark.parametrize("c_in,c_out", [(8, 16), (16, 16)])
def test_resnet_block_matches_jax(c_in, c_out):
    """GroupNorm at epsilon 1e-6, the time projection after ``conv1``, the
    1x1 skip where the channels change."""
    rng = np.random.default_rng(c_in)
    x = rng.standard_normal((2, 12, 10, c_in)).astype(np.float32)
    temb = rng.standard_normal((2, 32)).astype(np.float32)
    jm = JaxResnet(c_out, norm_groups=4)
    params = draw_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, temb)["params"], c_out)
    want = jm.apply({"params": params}, x, temb)
    block = load_flax(ResnetBlock(c_in, c_out, 32, norm_groups=4), params)
    got = block(nchw(x), t(temb)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("h,w,c,head_channels", [(8, 6, 32, 8), (66, 64, 16, 16)])
def test_attention_block_matches_jax(h, w, c, head_channels):
    """Four heads over 48 tokens (dense); one head over 66 x 64 = 4224
    tokens, where the JAX block takes its query-chunked branch and the
    port's plain version its chunks of 2048 (the CPU's path)."""
    x = np.random.default_rng(h).standard_normal((1, h, w, c)).astype(np.float32)
    jm = JaxAttention(head_channels, norm_groups=4)
    params = draw_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)["params"], c)
    want = jax.jit(lambda p, v: jm.apply({"params": p}, v))(params, x)
    block = load_flax(AttentionBlock(c, head_channels, norm_groups=4), params)
    assert block.heads == c // head_channels
    got = block(nchw(x)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_unet_matches_jax():
    """The tiny UNet on all-drawn weights at 132 x 128, batch 1: level 1
    holds 66 x 64 = 4224 tokens (the chunked branch), level 2 1056 (dense).
    Output held to ATOL relative to its largest value."""
    jm, params, net = tiny_unet()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 132, 128, 2)).astype(np.float32)
    steps = np.array([912], np.int32)
    want = np.asarray(jax.jit(lambda p, v, s: jm.apply({"params": p}, v, s))(params, x, steps))
    got = net(nchw(x), torch.from_numpy(steps)).permute(0, 2, 3, 1).detach().numpy()
    assert np.abs(want).max() > 0.1  # not zeros: every leaf drawn
    assert rel(got, want) <= ATOL


def test_add_noise_and_timesteps_match_jax():
    js, ps = jax_sched.DDPMScheduler(), schedulers.DDPMScheduler()
    np.testing.assert_array_equal(ps.alphas_cumprod, np.asarray(js.alphas_cumprod))
    rng = np.random.default_rng(2)
    x0, noise = (rng.standard_normal((3, 8, 8, 1)).astype(np.float32) for _ in range(2))
    steps = np.array([0, 500, 999], np.int32)
    want = js.add_noise(x0, noise, jnp.asarray(steps))
    got = ps.add_noise(t(x0), t(noise), torch.from_numpy(steps).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    for name, (jcls, pcls) in SCHEDULERS.items():
        assert pcls.default_inference_steps == jcls.default_inference_steps, name
    for n in (3, 50, 1000):
        assert ps.timesteps(n) == js.inference_timesteps(n).tolist(), n


def _jax_ddpm_z(key, shape, n):
    """DDPM's per-step normals as its scan draws them: the key split once
    per step, the second half drawn."""
    def body(k, _):
        k, r = jax.random.split(k)
        return k, jax.random.normal(r, shape)

    return np.asarray(jax.jit(lambda k: jax.lax.scan(body, k, None, length=n)[1])(key))


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_scheduler_chain_matches_jax(name):
    """The whole reverse chain at the full step count (DDPM 1000, the others
    50) with an oracle ``eps_fn``: the eps consistent with a drawn x0 in
    [-1.2, 1.2] (clipping active for DDPM and DDIM) plus 0.2 x_t, so each
    step's eps depends on the chain. DDPM is fed JAX's per-step ``z``."""
    jcls, pcls = SCHEDULERS[name]
    js, ps = jcls(), pcls()
    n = js.default_inference_steps
    rng = np.random.default_rng(7)
    shape = (2, 8, 8, 1)
    x0 = rng.uniform(-1.2, 1.2, shape).astype(np.float32)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, shape))
    acp_j, acp_p = js.alphas_cumprod, t(ps.alphas_cumprod)

    def jax_eps(xt, step):
        return (xt - jnp.sqrt(acp_j[step]) * x0) / jnp.sqrt(1.0 - acp_j[step]) + 0.2 * xt

    def port_eps(xt, step):
        a = acp_p[step]
        return (xt - torch.sqrt(a) * t(x0)) / torch.sqrt(1.0 - a) + 0.2 * xt

    want = np.asarray(jax.jit(lambda k, v: js.sample(k, jax_eps, v, n))(key, noise))
    z = t(_jax_ddpm_z(key, shape, n)) if name == "DDPM" else None
    got = ps.sample(port_eps, t(noise), n, z_fn=lambda k: z[k])
    assert np.isfinite(want).all()
    assert rel(got.numpy(), want) <= ATOL, rel(got.numpy(), want)


@pytest.mark.parametrize("name", ["DDIM", "DDPM"])
def test_three_step_sample_matches_jax(name):
    """``sample`` on the tiny UNet for 3 steps (DDPM: t = 666, 333, 0),
    fed JAX's initial noise and, for DDPM, the ``z`` its scan draws from
    the same key, against ``_sample_one_program`` at 32 x 32."""
    jm, port = tiny_models(name)
    params = tiny_unet()[1]
    jm.n_inference_steps = port.n_inference_steps = 3
    key = jax.random.PRNGKey(9)
    cond = np.random.default_rng(9).random((1, 32, 32, 1)).astype(np.float32)
    want = np.asarray(jm._sample_one_program(params, key, cond))
    draws = {"noise": t(np.asarray(jax.random.normal(key, cond.shape))),
             "z": t(_jax_ddpm_z(key, cond.shape, 3))}
    got = port.sample(t(cond), draws=draws).numpy()
    assert rel(got, want) <= RTOL_SAMPLE, rel(got, want)
