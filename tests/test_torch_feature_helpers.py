"""Helpers shared by the feature tests of the port
(``test_torch_features.py``, ``test_torch_feature_metrics.py``,
``test_torch_feature_sweep.py``). It holds no tests of its own: pytest
collects nothing here."""

import jax
import numpy as np

from mtd_gan_tpu.features import registry as jax_registry
from mtd_gan_tpu.metrics import fid as jax_fid
from mtd_gan_tpu.metrics import perceptual as jax_perceptual
from mtd_gan_tpu_torch.features import registry


def draw_tree(init_fn, seed: int):
    """A param tree of ``init_fn``'s shapes drawn with numpy: He-normal
    kernels (fan-in = all axes but the last), batch-norm scales and
    variances in [0.5, 1.5), biases and means N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        if len(s.shape) >= 2:
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.standard_normal(s.shape, np.float32) * np.float32(np.sqrt(2.0 / fan_in))
        if getattr(path[-1], "key", "") in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return rng.standard_normal(s.shape, np.float32) * np.float32(0.1)

    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(init_fn))


def kept_per_array(fn):
    """``fn`` evaluated once per input array (the arrays are held, so no id
    is reused). The JAX package's ``compute_pl`` and ``compute_tml`` run
    the trunk twice per pair, 12 passes where a slice's 3 arrays are
    distinct; this runs the same function of the same inputs 3 times."""
    kept = {}

    def wrapped(x):
        if id(x) not in kept:
            kept[id(x)] = (x, fn(x))
        return kept[id(x)][1]
    return wrapped


def assert_rel(got, want, tol, label=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= tol * np.abs(want)), (label, got, want)


def clear_feature_caches():
    """The JAX package's extractor caches and the port's registry."""
    for fn in (jax_registry._vgg19_params, jax_registry._inception_params,
               jax_perceptual._vgg_fn, jax_fid.default_feature_fn):
        fn.cache_clear()
    registry.clear_cache()
