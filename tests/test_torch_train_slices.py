"""K1 + K2 on whole slices: the train routes at the sizes K1 and K2 take
(64x64 to 512x512; a train step takes them at 64x64 only, since no
trainer takes whole slices) and outside them, the launch geometry of K2 at
those sizes, the port's ``resfft_generator_train`` at 128x128 (on the CPU
it runs K1's and K2's plain versions) against ``jax.grad`` of the JAX
``Generator.apply``, and the train CLI on a whole-slice preset.

The JAX K2 path (``pallas_train.resfft_generator_train`` in interpret mode)
takes about a minute for one gradient at 128x128 on a CPU, so the port is
held to the fp32 ``Generator.apply`` gradient, the path the JAX package's
own kernel tests hold their kernel to (tests/test_pallas_train.py:66). The
kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py phases 17 and 34)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtd_gan_tpu.models.mtd_gan import MTDGANModel as JaxModel
from mtd_gan_tpu_torch import train as train_cli
from mtd_gan_tpu_torch.data.dicom import write_synthetic_dicom
from mtd_gan_tpu_torch.models.mtd_gan import ResFFTGenerator
from mtd_gan_tpu_torch.ops import cuda_train
from mtd_gan_tpu_torch.ops.cuda_pipeline import KERNEL_CHANNELS
from mtd_gan_tpu_torch.ops.cuda_train import (BWD_SIZES, TRAIN_SIZES, block_bwd,
                                              resfft_generator_train, resolve_g_forward,
                                              train_route)
from mtd_gan_tpu_torch.utils.torch_import import generator_state_dict_from_flax

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

SLICE_SIZES = (128, 256, 512)
# shapes the JAX train kernel takes (H % 8 == 0) and K1 does not: H != W, a
# side that is not a power of two, 1024; and a width no kernel has
AUTOGRAD_SHAPES = ((200, 200, 32), (1024, 1024, 32), (512, 320, 32), (512, 512, 64))


@pytest.mark.parametrize("c", KERNEL_CHANNELS)
@pytest.mark.parametrize("h", SLICE_SIZES)
def test_whole_slices_take_the_kernels_outside_a_train_step(h, c):
    """K1 and K2 take whole slices (``resfft_generator_train``), but no
    trainer does (the 64x64 discriminators): a train step's route stays
    at the 64x64 patches, ``auto`` resolves to autograd and ``pallas``
    raises, for a bf16 generator as for fp32."""
    assert h in BWD_SIZES and h not in TRAIN_SIZES
    assert train_route(64, 64, c) == "kernels"
    assert train_route(h, h, c) == "autograd"
    assert resolve_g_forward("auto", h, h, c) == "einsum"
    for g_forward in ("pallas", "pallas_packed"):
        with pytest.raises(ValueError, match="K1 \\+ K2 take H == W in \\(64,\\)"):
            resolve_g_forward(g_forward, h, h, c)


@pytest.mark.parametrize("h,w,c", AUTOGRAD_SHAPES)
def test_other_shapes_take_autograd_and_pallas_raises(h, w, c):
    assert train_route(h, w, c) == "autograd"
    assert resolve_g_forward("auto", h, w, c) == "einsum"
    with pytest.raises(ValueError, match="K1 \\+ K2 take H == W in"):
        resolve_g_forward("pallas", h, w, c)


def test_launch_geometry_at_whole_slices():
    """K2's weight-gradient units at W > 64 are 4-row bands cut into
    64-column segments (kWgCols): 8 a band at 512, 2 at 128; both launches
    stay within about two blocks per SM."""
    assert cuda_train._wgrad_units(2, 64) == 2 * 16
    assert cuda_train._wgrad_units(2, 128) == 2 * 32 * 2
    assert cuda_train._wgrad_units(1, 512) == 128 * 8
    assert cuda_train._launch_geometry(1, 128, 65) == (64, 65)
    assert cuda_train._launch_geometry(20, 512, 257) == (264, 264)


@pytest.fixture(scope="module")
def generator_128():
    """A JAX generator (L = 2, 8 features) with 1/sqrt(fan_in) weights and
    0.1 biases, the port's generator holding the same weights, and a batch
    of two 128x128 slices."""
    jm = JaxModel(gen_features=8, disc_features=8, num_layers=2)
    params = jax.jit(jm.Generator.init)(jax.random.PRNGKey(0),
                                        np.zeros((1, 128, 128, 1), np.float32))["params"]
    rng = np.random.default_rng(22)

    def redraw(path, leaf):
        if "bias" in jax.tree_util.keystr(path):
            return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)
        fan_in = leaf.shape[0] if leaf.ndim == 2 else int(np.prod(leaf.shape[:3]))
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(redraw, params)
    x = rng.random((2, 128, 128, 1)).astype(np.float32)
    y = np.clip(x + 0.05 * rng.standard_normal(x.shape), 0, 1).astype(np.float32)
    gen = ResFFTGenerator(1, 8, 2)
    gen.load_state_dict(generator_state_dict_from_flax(params))
    return jm, params, gen, x, y


def test_whole_slice_generator_matches_jax(generator_128):
    """``resfft_generator_train`` at 128x128 (five blocks in all four
    variants, on K1's and K2's plain versions) against the fp32 JAX
    ``Generator.apply`` and ``jax.grad`` of the mean squared error: the
    output within 2e-4 of its largest value, every parameter gradient
    within 1e-4 of its leaf's largest value (the flax layouts, through the
    port's carry-over); no kernel launch on the CPU."""
    jm, params, gen, x, y = generator_128
    loss = lambda p: jnp.mean((jm.Generator.apply({"params": p}, x) - y) ** 2)
    want_out = np.asarray(jax.jit(jm.Generator.apply)({"params": params}, x))
    want = generator_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(params)))
    before = (cuda_train.block_fused.launches, block_bwd.launches)
    out = resfft_generator_train(gen, torch.tensor(x))
    names, leaves = zip(*gen.named_parameters())
    grads = torch.autograd.grad(((out - torch.tensor(y)) ** 2).mean(), leaves)
    assert (cuda_train.block_fused.launches, block_bwd.launches) == before
    out = out.detach().numpy()
    assert np.abs(out - want_out).max() <= 2e-4 * np.abs(want_out).max()
    for name, got in zip(names, grads):
        rel = float((got - want[name]).abs().max() / want[name].abs().max())
        assert rel < 1e-4, (name, rel)


def _write_pairs(root: str, split: str, n: int, size: int, rng) -> None:
    for i in range(n):
        for key in ("n_20", "n_100"):
            hu = 0.15 + 0.5 * rng.random((size, size))
            write_synthetic_dicom(os.path.join(root, split, "case0", key, f"s{i:03d}.IMA"),
                                  np.round(hu * 400.0 - 160.0 + 1024.0).astype(np.uint16))


@pytest.mark.parametrize("g_forward", ["pallas", "auto"])
def test_train_cli_on_whole_slices_stops_at_the_discriminator(tmp_path, g_forward):
    """``--dataset-type-train full`` on 128x128 slices: the step stops at
    the 64x64 multi-task discriminator, whose CLS head flattens a 1x1
    bottleneck (the JAX package's discriminator takes no whole slice
    either), before the generator's route is resolved and before any
    generator forward; no kernel runs."""
    rng = np.random.default_rng(0)
    _write_pairs(str(tmp_path), "train", 2, 128, rng)
    _write_pairs(str(tmp_path), "valid", 1, 128, rng)
    args = train_cli.get_args_parser().parse_args([
        "--data-root", str(tmp_path), "--batch-size", "2", "--epochs", "1",
        "--device", "cpu", "--dataset-type-train", "full", "--g-forward", g_forward,
        "--model-kwargs", json.dumps({"gen_features": 8, "disc_features": 8,
                                      "num_layers": 1}),
        "--checkpoint-dir", str(tmp_path / "ckpt"), "--save-dir", str(tmp_path / "out")])
    with pytest.raises(ValueError, match="discriminator takes 64x64 inputs"):
        train_cli.main(args)
