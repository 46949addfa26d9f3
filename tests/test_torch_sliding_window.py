"""The port's sliding-window inference against the JAX package's: the tile
starts and the Gaussian importance map, ``sliding_window_inference`` in
both modes at overlaps 0.3, 0.5 and 0.9 (chunks that cross samples), a
side smaller than the ROI, a multi-output predictor with per-tile CLS, and
``MTDGANModel.discriminate_full`` on the same drawn discriminator at the
three overlaps in both modes. 1e-4 where a sliding-window sum is in the
chain; NHWC at the boundary on both sides."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtd_gan_tpu.models.mtd_gan import MTDGANModel as JaxMTDGAN
from mtd_gan_tpu.ops import sliding_window as jax_sw
from mtd_gan_tpu_torch.models.mtd_gan import MTDGANModel
from mtd_gan_tpu_torch.ops import sliding_window as sw
from mtd_gan_tpu_torch.utils.torch_import import mtd_gan_state_dict_from_flax
from mtd_gan_tpu_torch.utils.checkpoint import load_model_state_dict
from test_torch_train_helpers import draw_variables, host

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

ATOL = 1e-4
OVERLAPS = (0.3, 0.5, 0.9)
MODES = ("constant", "gaussian")


def _tile_fn(xp):
    """A predictor whose tiles differ by more than their pixels: each tile's
    mean enters every output pixel."""
    def fn(tiles):
        return xp.tanh(3.0 * tiles) + tiles.mean(axis=(1, 2, 3), keepdims=True)
    return fn


def _torch_tile_fn(tiles):
    return torch.tanh(3.0 * tiles) + tiles.mean(dim=(1, 2, 3), keepdim=True)


@pytest.mark.parametrize("size,roi,overlap", [(512, 64, 0.9), (512, 64, 0.3), (100, 64, 0.5),
                                              (64, 64, 0.5), (40, 64, 0.3), (65, 64, 0.9)])
def test_tile_starts_and_importance_map_match_jax(size, roi, overlap):
    assert sw.scan_interval(size, roi, overlap) == jax_sw.scan_interval(size, roi, overlap)
    np.testing.assert_array_equal(sw.dense_patch_positions(size, roi, overlap),
                                  jax_sw.dense_patch_positions(size, roi, overlap))
    np.testing.assert_array_equal(sw.gaussian_importance_map((roi, 48)),
                                  np.asarray(jax_sw.gaussian_importance_map((roi, 48))))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("overlap", OVERLAPS)
def test_sliding_window_matches_jax(overlap, mode):
    """Two samples of 100x90 (and one of 40x70, a side below the ROI, zero
    padded around the centre) through 64x64 tiles in chunks of 5."""
    rng = np.random.default_rng(int(overlap * 10))
    for shape in ((2, 100, 90, 1), (1, 40, 70, 2)):
        x = rng.random(shape, dtype=np.float32)
        want = jax_sw.sliding_window_inference(jnp.asarray(x), (64, 64), _tile_fn(jnp),
                                               sw_batch_size=5, overlap=overlap, mode=mode)
        got = sw.sliding_window_inference(torch.tensor(x), (64, 64), _torch_tile_fn,
                                          sw_batch_size=5, overlap=overlap, mode=mode)
        assert got.shape == shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    with pytest.raises(ValueError, match="mode"):
        sw.sliding_window_inference(torch.zeros(1, 64, 64, 1), (64, 64), _torch_tile_fn,
                                    mode="linear")


def test_multi_output_predictor_keeps_per_tile_values():
    """A predictor of (per-tile CLS, a spatial map, a two-channel map): the
    CLS comes back unaggregated as (N, T, 1), the maps blended."""
    x = np.random.default_rng(3).random((2, 96, 80, 1), dtype=np.float32)

    def jax_pred(t):
        return (t.mean(axis=(1, 2)), jnp.sin(t), jnp.concatenate([t, t * t], -1))

    def port_pred(t):
        return (t.mean(dim=(1, 2)), torch.sin(t), torch.cat([t, t * t], -1))

    want = jax_sw.sliding_window_inference(jnp.asarray(x), (64, 64), jax_pred,
                                           sw_batch_size=3, overlap=0.5, mode="gaussian")
    got = sw.sliding_window_inference(torch.tensor(x), (64, 64), port_pred,
                                      sw_batch_size=3, overlap=0.5, mode="gaussian")
    assert isinstance(got, tuple) and len(got) == 3
    assert got[0].shape == (2, 4, 1) and got[2].shape == (2, 96, 80, 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@functools.cache
def _discriminators():
    """The JAX flagship's discriminator (4 features; eval: no dropout) and the
    port's, on the same numpy-drawn variables."""
    jm = JaxMTDGAN(gen_features=4, disc_features=4, num_layers=1)
    gv = draw_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 31)
    port = MTDGANModel(gen_features=4, disc_features=4, num_layers=1,
                       device="cpu")
    load_model_state_dict(port, mtd_gan_state_dict_from_flax(
        host(gv.params_g), host(gv.params_d), host(gv.state_d)))
    return jm, gv, port


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("overlap", OVERLAPS)
def test_discriminate_full_matches_jax(overlap, mode):
    """(cls per tile, seg, rec) on one 96x96 slice; the spectral-norm ``u``
    stays as it was (eval, no stored power iteration)."""
    jm, gv, port = _discriminators()
    x = np.random.default_rng(4).random((1, 96, 96, 1), dtype=np.float32)
    want = jax.jit(lambda pd, sd, z: jm.discriminate_full(
        pd, sd, z, overlap=overlap, mode=mode, sw_batch_size=8))(gv.params_d, gv.state_d, x)
    u = {k: v.clone() for k, v in port.discriminator.state_dict().items()
         if k.endswith("weight_u")}
    got = port.discriminate_full(torch.tensor(x), overlap=overlap, mode=mode, sw_batch_size=8)
    n_tiles = len(sw.dense_patch_positions(96, 64, overlap)) ** 2
    assert got[0].shape == (1, n_tiles, 1) and got[1].shape == got[2].shape == x.shape
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    for k, v in u.items():
        assert torch.equal(port.discriminator.state_dict()[k], v), k
