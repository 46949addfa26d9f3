"""The port's feature metrics against the JAX package's on the CPU: PL and
TML (``metrics/perceptual.py``) on the same VGG19 weights and the Fréchet
math (``metrics/fid.py``). The sweep at its default is in
``test_torch_feature_sweep.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtd_gan_tpu.features import vgg as jax_vgg
from mtd_gan_tpu.metrics import fid as jax_fid
from mtd_gan_tpu.metrics import perceptual as jax_perceptual
from mtd_gan_tpu_torch.features import registry, vgg
from mtd_gan_tpu_torch.metrics import fid, perceptual
from mtd_gan_tpu_torch.utils import torch_import
from tests.test_torch_feature_helpers import assert_rel, draw_tree, kept_per_array

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

# PL and TML, relative, per value: fp32 on both sides; the features differ
# by ~3e-6 (oneDNN against XLA convs), TML's Gram matrices and means by a
# few 1e-6 more
TOL_PL_TML = 1e-4


@pytest.fixture(scope="module")
def vgg19_tree():
    return draw_tree(jax_vgg.init_vgg19_params, 19)


def slices(seed: int, n: int = 1, size: int = 256):
    """Input, gt and prediction stand-ins in [0, 1], NHWC gray."""
    rng = np.random.default_rng(seed)
    gt = rng.random((n, size, size, 1), dtype=np.float32)
    inp = np.clip(gt + 0.1 * rng.standard_normal(gt.shape), 0, 1).astype(np.float32)
    pred = np.clip(gt + 0.03 * rng.standard_normal(gt.shape), 0, 1).astype(np.float32)
    return inp, gt, pred


@torch.no_grad()
def test_pl_tml_match_jax(vgg19_tree, monkeypatch):
    """``compute_pl`` / ``compute_tml`` and the pair losses at 256x256 on
    the same weights; gt-vs-gt exactly 0 on both sides; the port's
    :func:`perceptual.pl_tml` runs the trunk once for the three images."""
    trunk = vgg.vgg19_trunk()
    trunk.load_state_dict(torch_import.vgg19_state_dict_from_flax(vgg19_tree), strict=True)
    trunk.eval()
    calls = []
    trunk.register_forward_hook(lambda m, args, out: calls.append(args[0].shape[0]))
    port_fn = lambda t: trunk(registry.to_rgb_nchw(t))
    jax_fn = kept_per_array(jax.jit(
        lambda t: jax_vgg.vgg19_features(vgg19_tree, jnp.repeat(t, 3, axis=-1))))
    monkeypatch.setattr(jax_perceptual, "_vgg_fn", lambda: jax_fn)
    monkeypatch.setattr(perceptual, "_vgg_fn", lambda device: port_fn)
    inp, gt, pred = slices(0)
    want_pl = [float(v) for v in jax_perceptual.compute_pl(inp, gt, pred)]
    want_tml = [float(v) for v in jax_perceptual.compute_tml(inp, gt, pred)]
    ti, tg, tp = (torch.from_numpy(a) for a in (inp, gt, pred))
    pl, tml = perceptual.pl_tml(ti, tg, tp, port_fn)
    assert calls == [3] and pl.shape == tml.shape == (3, 1)
    assert want_pl[1] == 0.0 and want_tml[1] == 0.0
    assert pl[1, 0] == 0 and tml[1, 0] == 0
    assert_rel(pl[0::2, 0].numpy(), want_pl[0::2], TOL_PL_TML, "pl")
    assert_rel(tml[0::2, 0].numpy(), want_tml[0::2], TOL_PL_TML, "tml")
    assert_rel([float(v) for v in perceptual.compute_pl(ti, tg, tp)], want_pl, TOL_PL_TML)
    assert calls == [3, 3]
    assert_rel(float(perceptual.perceptual_loss(tp, tg, port_fn)),
               float(jax_perceptual.perceptual_loss(pred, gt, jax_fn)), TOL_PL_TML)
    assert_rel(float(perceptual.texture_matching_loss(ti, tg, port_fn)),
               float(jax_perceptual.texture_matching_loss(inp, gt, jax_fn)), TOL_PL_TML)


def test_tml_is_nan_below_256():
    """relu5_1 of a 128x128 slice is 8x8: no 16x16 patch, a mean over none,
    as in the JAX package."""
    trunk = vgg.vgg19_trunk().eval()
    fn = lambda t: trunk(registry.to_rgb_nchw(t))
    with torch.no_grad():
        pl, tml = perceptual.pl_tml(*(torch.from_numpy(a) for a in slices(1, size=128)), fn)
    assert torch.isfinite(pl).all() and torch.isnan(tml).all()


@pytest.mark.parametrize("n,d", [(3, 256), (300, 64)])
def test_frechet_matches_jax(n, d):
    """``frechet_distance`` and ``compute_fid`` on the same float32
    features, 1e-9 relative: the same float64 numpy on both sides. Three
    samples in 256 dimensions (rank-2 covariances, the clipped square root
    at work) and 300 in 64 (full rank)."""
    rng = np.random.default_rng(n)
    feats = [(rng.standard_normal((n, d)) + s).astype(np.float32) for s in (0.3, 0.0, 0.1)]
    want = jax_fid.compute_fid(*feats)
    got = fid.compute_fid(*feats)
    scale = abs(want[0])
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * scale)
    assert abs(fid.frechet_distance(feats[2], feats[1])
               - jax_fid.frechet_distance(feats[2], feats[1])) <= 1e-9 * scale
