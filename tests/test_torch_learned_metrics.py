"""The port's learned metrics (``metrics/learned.py``: LPIPS and DISTS on
the VGG16 trunk, PieAPP) against the JAX package's on the CPU, on the same
weights (param trees drawn with numpy from seeds, given to the port through
``utils/torch_import``)."""

import jax
import numpy as np
import pytest
import torch

from mtd_gan_tpu.features import vgg as jax_vgg
from mtd_gan_tpu.metrics import learned as jax_learned
from mtd_gan_tpu_torch.features import vgg
from mtd_gan_tpu_torch.metrics import learned
from mtd_gan_tpu_torch.utils import torch_import

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

# relative, on the metric value: fp32 on both sides, convolutions summed in
# other orders (oneDNN against XLA)
TOL = 1e-4


def draw_tree(init_fn, seed: int):
    """He-normal kernels (fan-in = all axes but the last), biases N(0, 0.1),
    drawn with numpy in ``init_fn``'s shapes."""
    rng = np.random.default_rng(seed)

    def draw(s):
        if len(s.shape) >= 2:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map(draw, jax.eval_shape(init_fn))


def pair(seed: int, shape):
    """An image in [0.1, 0.9) and a noisy copy clipped to [0, 1]."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.1, 0.9, shape).astype(np.float32)
    y = np.clip(x + 0.05 * rng.standard_normal(shape), 0.0, 1.0).astype(np.float32)
    return x, y


def close(got, want, tol=TOL):
    got, want = float(got), float(want)
    assert abs(got - want) <= tol * abs(want), (got, want)


@pytest.fixture(scope="module")
def vgg16():
    tree = draw_tree(jax_vgg.init_vgg16_params, 16)
    trunk = vgg.vgg16_trunk()
    trunk.load_state_dict(torch_import.vgg16_state_dict_from_flax(tree), strict=True)
    return tree, trunk.eval()


@torch.no_grad()
def test_lpips_and_dists_match_jax(vgg16):
    tree, trunk = vgg16
    x, y = pair(8, (2, 64, 64, 1))
    rng = np.random.default_rng(9)
    lw = [rng.random((1, c, 1, 1)).astype(np.float32) for c in (64, 128, 256, 512, 512)]
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    close(learned.lpips(tx, ty, trunk, lw), jax_learned.lpips(x, y, tree, lw))
    chans = (3, 64, 128, 256, 512, 512)
    alpha = [rng.random(c).astype(np.float32) / 12 for c in chans]
    beta = [rng.random(c).astype(np.float32) / 12 for c in chans]
    close(learned.dists(tx, ty, trunk, alpha, beta), jax_learned.dists(x, y, tree, alpha, beta))


@torch.no_grad()
def test_pieapp_matches_jax():
    """91x91 gray slices: a 2x2 grid of 64x64 patches at stride 27. Held
    at 3e-4: the score layer sums 120832 fp32 products of feature
    differences, and both sides land 5e-5 - 1.2e-4 from the same network
    in float64, on opposite sides (measured)."""
    tree = draw_tree(jax_learned.init_pieapp_params, 11)
    model = learned.PieAPP()
    model.load_state_dict(torch_import.pieapp_state_dict_from_flax(tree), strict=True)
    x, y = pair(10, (2, 91, 91, 1))
    close(learned.pieapp(torch.from_numpy(x), torch.from_numpy(y), model.eval()),
          jax_learned.pieapp(x, y, tree), 3e-4)
