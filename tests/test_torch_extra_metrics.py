"""The port's piq tail (``metrics/extra.py``) against the JAX package's on
the CPU, at small sizes, on the same inputs (numpy, from seeds). LPIPS,
DISTS and PieAPP are in ``test_torch_learned_metrics.py``."""

import functools
import sys

import jax
import numpy as np
import pytest
import torch

from mtd_gan_tpu.metrics import extra as jax_extra
from mtd_gan_tpu_torch.metrics import extra

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

# relative, on the metric value: fp32 on both sides, convolutions and
# DFTs in other orders (oneDNN and pocketfft against XLA's convs and the JAX
# package's DFT matmuls)
TOL = 1e-4


def pair(seed: int, shape):
    """An image in [0.1, 0.9) and a noisy copy clipped to [0, 1]."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.1, 0.9, shape).astype(np.float32)
    y = np.clip(x + 0.05 * rng.standard_normal(shape), 0.0, 1.0).astype(np.float32)
    return x, y


def close(got, want, tol=TOL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= tol * np.abs(want) + 1e-12), (got, want)


# name -> (shape of the pair, extra kwargs); 384x384 takes the 2x2
# pooling branches of FSIM, MDSI and VSI (and VSI's downsampling resize)
PAIR_METRICS = {
    "ms_ssim": ((2, 96, 96, 1), {}),
    "gmsd": ((2, 64, 64, 1), {}),
    "vif_p": ((2, 64, 64, 1), {}),
    "fsim": ((2, 64, 64, 1), {}),
    "haarpsi": ((2, 63, 65, 1), {}),
    "mdsi": ((2, 64, 64, 1), {}),
    "vsi": ((2, 64, 64, 1), {}),
}
BIG = {"fsim": (1, 384, 384, 1), "mdsi": (1, 384, 384, 1), "vsi": (1, 384, 384, 1)}


@pytest.mark.parametrize("name,big", [(n, False) for n in PAIR_METRICS]
                         + [(n, True) for n in BIG])
@torch.no_grad()
def test_pair_metric_matches_jax(name, big):
    shape, kwargs = PAIR_METRICS[name]
    x, y = pair(list(PAIR_METRICS).index(name), BIG[name] if big else shape)
    # jitted: op by op, the JAX side takes seconds a metric on the CPU
    want = float(jax.jit(functools.partial(getattr(jax_extra, name), **kwargs))(x, y))
    got = float(getattr(extra, name)(torch.from_numpy(x), torch.from_numpy(y), **kwargs))
    close(got, want)


@torch.no_grad()
def test_ssim3d_and_total_variation_match_jax():
    x, y = pair(1, (1, 12, 20, 24, 1))
    close(extra.ssim3d(torch.from_numpy(x), torch.from_numpy(y)), jax_extra.ssim3d(x, y))
    a, _ = pair(2, (2, 40, 48, 1))
    close(extra.total_variation(torch.from_numpy(a)), jax_extra.total_variation(a))


@torch.no_grad()
def test_brisque_matches_jax():
    """The 36 scaled features and the SVR score on random support vectors.
    The features take the fitted gamma from a table by argmin, so a table
    value one float32 ulp apart (``lgamma`` against ``gammaln``) can move a
    feature by one table step (0.001 of gamma, ~2e-4 after scaling): held
    at 1e-3 absolute."""
    x, _ = pair(3, (2, 64, 64, 1))
    want = np.asarray(jax_extra.brisque_features(x))
    got = extra.brisque_features(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 36)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    rng = np.random.default_rng(4)
    sv, coef = rng.uniform(-1, 1, (36, 8)), rng.standard_normal((8, 1))
    close(extra.brisque(torch.from_numpy(x), coef, sv), jax_extra.brisque(x, coef, sv), 1e-3)
    with pytest.raises(ValueError, match="even"):
        extra.brisque_features(torch.zeros(1, 33, 32, 1))


@torch.no_grad()
def test_inception_score_matches_jax():
    logits = np.random.default_rng(5).standard_normal((40, 10)).astype(np.float32) * 3
    other = np.random.default_rng(6).standard_normal((40, 10)).astype(np.float32)
    want_mean, want_std = jax_extra.inception_score(logits, num_splits=4)
    got_mean, got_std = extra.inception_score(torch.from_numpy(logits), num_splits=4)
    close(got_mean, want_mean)
    close(got_std, want_std)
    close(extra.inception_score_diff(torch.from_numpy(other), torch.from_numpy(logits), 4),
          jax_extra.inception_score_diff(other, logits, 4))


def test_host_metrics_match_jax(monkeypatch):
    """KID, MSID (both draw nothing or the same global np.random stream from
    the same seed) and the geometry score's RLT on the same inputs: the same
    float64 numpy, equal to 1e-12; the geometry score raises the same
    ImportError without gudhi (an empty stand-in ``gudhi`` module, which
    ``tests/ref_oracle.py`` leaves in ``sys.modules`` of a worker that ran a
    reference test first, is taken out for this check)."""
    rng = np.random.default_rng(7)
    a, b = rng.standard_normal((60, 16)), rng.standard_normal((50, 16)) + 0.2
    close(extra.kid(a, b), jax_extra.kid(a, b), 1e-12)
    for mode in ("max", "l2"):
        np.random.seed(0)
        want = jax_extra.msid(a, b, niters=20, msid_mode=mode)
        np.random.seed(0)
        close(extra.msid(a, b, niters=20, msid_mode=mode), want, 1e-12)
    intervals = [(0.0, 0.3), (0.1, np.inf), (0.2, 0.25)]
    np.testing.assert_array_equal(extra._gs_rlt(intervals, 0.5),
                                  jax_extra._gs_rlt(intervals, 0.5))
    if not hasattr(sys.modules.get("gudhi"), "WitnessComplex"):
        monkeypatch.delitem(sys.modules, "gudhi", raising=False)
    with pytest.raises(ImportError, match="gudhi"):
        extra.geometry_score(a, b, num_iters=1)
