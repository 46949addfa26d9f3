"""Helpers shared by the diffusion tests of the port
(``test_torch_diffusion.py``, ``test_torch_diffusion_train.py``): the
tiny UNet's configuration (the JAX tests': channels (8, 16, 16), 16 head
channels, GroupNorm(4)), the tolerances, the numpy draw of every leaf and
the JAX and port models on one drawn tree. It holds no tests of its own:
pytest collects nothing here."""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from mtd_gan_tpu.models.diffusion import wrappers as jax_wrappers
from mtd_gan_tpu.models.diffusion.unet import DiffusionUNet as JaxUNet
from mtd_gan_tpu_torch.models.diffusion import wrappers
from mtd_gan_tpu_torch.models.diffusion.unet import DiffusionUNet
from mtd_gan_tpu_torch.utils.torch_import import diffusion_unet_state_dict_from_flax
from test_torch_train_helpers import host

ATOL = 1e-5        # the pieces, the UNet, the loss and the chains: float32 both sides
RTOL_SAMPLE = 1e-4  # a 3-step sample through the UNet, and every gradient leaf
TINY = dict(channels=(8, 16, 16), num_head_channels=16, norm_groups=4)
PORT_MODELS = {"DDPM": wrappers.DDPMModel, "DDIM": wrappers.DDIMModel,
               "PNDM": wrappers.PNDMModel, "DPM": wrappers.DPMModel}
JAX_MODELS = {"DDPM": jax_wrappers.DDPMModel, "DDIM": jax_wrappers.DDIMModel,
              "PNDM": jax_wrappers.PNDMModel, "DPM": jax_wrappers.DPMModel}


def draw_tree(shapes, seed):
    """Every leaf drawn with numpy: GroupNorm scales 1 + N(0, 0.1^2),
    kernels N(0, 1/fan_in), biases N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def one(path, s):
        if getattr(path[-1], "key", "") == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if len(s.shape) >= 2:
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
                    ).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


def load_flax(module, params):
    module.load_state_dict(diffusion_unet_state_dict_from_flax(host(params)), strict=True)
    return module


@functools.cache
def tiny_unet():
    """The JAX tiny UNet, its drawn params and the port's UNet carrying
    them."""
    jm = JaxUNet(**TINY)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 2)),
                            jnp.zeros((1,), jnp.int32))["params"]
    params = draw_tree(shapes, 31)
    return jm, params, load_flax(DiffusionUNet(**TINY), params)


@functools.cache
def tiny_models(name):
    """The JAX model and the port's on ``tiny_unet``'s params."""
    jm = JAX_MODELS[name](**TINY)
    port = PORT_MODELS[name](**TINY, device="cpu")
    load_flax(port.net, tiny_unet()[1])
    return jm, port
