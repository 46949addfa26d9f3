"""``--bf16`` across the twelve models whose constructor takes a ``dtype``:
each model's forward in the port and in the JAX package on the CPU, fp32
and bf16, from the same numpy weights carried across by the converters.

The weights are drawn at N(0, 1/fan_in) (norm scales 1 + N(0, 0.1^2),
biases N(0, 0.1^2)), so that no network hides under its image residual as
it does at the reference init. bf16 rounds at other points in the two
frameworks, so each port forward is held to the bf16 error itself: with
err the max |a - b| of two outputs,

    err(port bf16, JAX bf16) <= 2 err(JAX bf16, JAX fp32) + err(port fp32, JAX fp32) + 1e-6
    err(port bf16, port fp32) <= 2 err(JAX bf16, JAX fp32) + 1e-6

The middle term is the fp32 parity the bf16 comparison cannot beat (the
ops summed in other orders; CTformer's performers carry ~1e-4 of it, and
its JAX module computes in fp32 whatever its dtype, so its bf16 error is
0). Every parameter stays fp32."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtd_gan_tpu.models import get_model_class as jax_model_class
from mtd_gan_tpu_torch.models import get_model
from mtd_gan_tpu_torch.utils import torch_import as ti
from mtd_gan_tpu_torch.utils.checkpoint import load_model_state_dict, networks
from test_torch_train_helpers import host

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

TINY_UNET = dict(channels=(8, 16, 16), num_head_channels=16, norm_groups=4)
# name -> (small constructor kwargs of both packages, input side, the
# converter of the JAX variables to the port's model_state_dict)
MODELS = {
    "MTD_GAN_Method": (dict(gen_features=8, disc_features=8, num_layers=2), 32,
                       lambda v: ti.mtd_gan_state_dict_from_flax(
                           v.params_g, v.params_d, v.state_d)),
    "RED_CNN": (dict(out_ch=8), 32, ti.red_cnn_state_dict_from_flax),
    "EDCNN": (dict(out_ch=8, sobel_ch=8, use_feature_loss=False), 32,
              ti.edcnn_state_dict_from_flax),
    "WGAN_VGG": (dict(use_perceptual=False), 32,
                 lambda v: ti.wgan_vgg_state_dict_from_flax(v.params_g, v.params_d)),
    "MAP_NN": (dict(depth=2), 32, lambda v: ti.map_nn_state_dict_from_flax(v.params_g, v.params_d)),
    "DU_GAN": (dict(gen_features=8, num_layers=1, conv_dim=8, repeat_num=3), 32,
               lambda v: ti.dugan_state_dict_from_flax(v["params_g"], v["params_img_d"],
                                                       v["state_img_d"], v["params_grad_d"],
                                                       v["state_grad_d"])),
    "CTformer": ({}, 64, ti.ctformer_state_dict_from_flax),
    "Restormer": (dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1), 32,
                  ti.restormer_state_dict_from_flax),
    **{name: (TINY_UNET, 32, ti.diffusion_unet_state_dict_from_flax)
       for name in ("DDPM", "DDIM", "PNDM", "DPM")},
}
GAN = ("MTD_GAN_Method", "WGAN_VGG", "MAP_NN", "DU_GAN")
ONES = ("scale", "weight", "temperature", "sobel_factor")


def _draw(shapes, seed: int):
    """Every leaf drawn with numpy (module docstring); spectral-norm ``u``
    unit vectors."""
    rng = np.random.default_rng(seed)

    def one(path, s):
        key = getattr(path[-1], "key", getattr(path[-1], "name", ""))
        if key == "u":
            v = rng.standard_normal(s.shape)
            return (v / np.linalg.norm(v)).astype(np.float32)
        if key in ONES:
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if len(s.shape) >= 2:
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
                    ).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


@functools.cache
def _case(name):
    """The JAX model at fp32 and bf16, the drawn variables, the input (and
    the UNet's conditioning and timesteps) and the four outputs."""
    kwargs, side, _ = MODELS[name]
    jms = {d: jax_model_class(name)(**kwargs, dtype=d) for d in (None, jnp.bfloat16)}
    jm = jms[None]
    sample = (1, side, side, 1)
    shapes = jax.eval_shape(lambda k: jm.init(k, sample) if name not in GAN else jm.init(k),
                            jax.random.PRNGKey(0))
    v = _draw(shapes, 7)
    rng = np.random.default_rng(1)
    x = rng.random((2, side, side, 1)).astype(np.float32)
    cond = rng.random((2, side, side, 1)).astype(np.float32)
    t = np.array([3, 600], np.int32)
    outs = {}
    for d, m in jms.items():
        if name in GAN:
            params_g = v["params_g"] if name == "DU_GAN" else v.params_g
            out = m.generate(params_g, x)
        elif name in ("DDPM", "DDIM", "PNDM", "DPM"):
            out = jax.jit(m.unet.apply)({"params": v}, jnp.concatenate([x, cond], -1), t)
        else:
            out = jax.jit(m.apply)(v, x)
        outs[("jax", d)] = np.asarray(jnp.asarray(out, jnp.float32))
    sd = MODELS[name][2](host(v))
    xt = torch.tensor(x)
    for d in (None, torch.bfloat16):
        port = get_model(name, **kwargs, device="cpu", dtype=d)
        load_model_state_dict(port, sd)
        params = [p for m in networks(port).values() for p in m.parameters()]
        assert params and all(p.dtype == torch.float32 for p in params)
        with torch.no_grad():
            if name in GAN:
                out = port.generate(xt)
            elif name in ("DDPM", "DDIM", "PNDM", "DPM"):
                out = port.eps(xt, torch.tensor(cond), torch.tensor(t, dtype=torch.int64))
            else:
                out = port.predict(xt)
        outs[("port", d)] = out.float().numpy()
    return outs


@pytest.mark.parametrize("name", list(MODELS))
def test_bf16_forward_within_the_bf16_error(name):
    outs = _case(name)
    err = lambda a, b: float(np.abs(outs[a] - outs[b]).max())
    jax_bf16 = err(("jax", jnp.bfloat16), ("jax", None))
    floor = err(("port", None), ("jax", None))
    to_jax = err(("port", torch.bfloat16), ("jax", jnp.bfloat16))
    to_fp32 = err(("port", torch.bfloat16), ("port", None))
    print(f"{name}: JAX bf16 vs fp32 {jax_bf16:.3e}; port bf16 vs JAX bf16 {to_jax:.3e}, "
          f"vs port fp32 {to_fp32:.3e}; fp32 parity {floor:.3e}")
    assert to_jax <= 2 * jax_bf16 + floor + 1e-6
    assert to_fp32 <= 2 * jax_bf16 + 1e-6
    if name != "CTformer":  # the only one whose JAX module ignores its dtype
        assert jax_bf16 > 0 and to_fp32 > 0
