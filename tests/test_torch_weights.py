"""Weight carry-over between the JAX generator and the PyTorch port
(mtd_gan_tpu_torch/utils/torch_import.py)."""

import argparse

import jax
import numpy as np
import pytest
import torch

from mtd_gan_tpu.models.mtd_gan import ResFFTGenerator as JaxGenerator
from mtd_gan_tpu.utils.torch_import import convert_resfft_generator
from mtd_gan_tpu_torch.models.mtd_gan import ResFFTGenerator
from mtd_gan_tpu_torch.utils.torch_import import (
    generator_state_dict_from_flax, load_reference_checkpoint,
    strip_module_prefixes)

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

L, C = 2, 8


def _flax_params(seed=0):
    gen = JaxGenerator(in_channels=1, features=C, num_layers=L)
    params = jax.jit(gen.init)(jax.random.PRNGKey(seed),
                               np.zeros((1, 64, 64, 1), np.float32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def test_state_dict_from_flax_loads_strict_and_round_trips():
    """flax -> port loads with strict=True, and the JAX package's own
    converter gives the flax tree back bit for bit (no tolerance: pure
    transposes)."""
    params = _flax_params()
    port = ResFFTGenerator(1, C, L)
    port.load_state_dict(generator_state_dict_from_flax(params), strict=True)
    back = convert_resfft_generator(port.state_dict(), prefix="", num_layers=L)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_strip_module_prefixes():
    sd = {"module.Generator.module.encoder.0.weight": 1, "Generator.x": 2}
    assert strip_module_prefixes(sd) == {"Generator.encoder.0.weight": 1,
                                         "Generator.x": 2}


@pytest.mark.parametrize("wrapped", [True, False])
def test_load_reference_checkpoint(tmp_path, wrapped):
    """Reference layout: {"model_state_dict": {"Generator.…", "Discriminator.…"},
    "epoch", "args": Namespace}; a bare state dict is epoch 0."""
    sd = generator_state_dict_from_flax(_flax_params(seed=1))
    model_sd = {f"Generator.module.{k}": v for k, v in sd.items()}
    model_sd["Discriminator.conv11.weight"] = torch.zeros(3)
    obj = ({"model_state_dict": model_sd, "epoch": 7,
            "args": argparse.Namespace(lr=1e-4)} if wrapped else model_sd)
    path = tmp_path / "ckpt.pth"
    torch.save(obj, path)
    epoch, gen = load_reference_checkpoint(str(path))
    assert epoch == (7 if wrapped else 0)
    assert set(gen) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(gen[k], v, rtol=0, atol=0)


def test_load_reference_checkpoint_without_generator_raises(tmp_path):
    path = tmp_path / "d_only.pth"
    torch.save({"model_state_dict": {"Discriminator.w": torch.zeros(1)}}, path)
    with pytest.raises(KeyError, match="Generator"):
        load_reference_checkpoint(str(path))
