"""Helpers shared by the port's training tests of the CNN family and the
ablations (``test_torch_cnn.py``, ``test_torch_ablations.py``). It holds no
tests of its own: pytest collects nothing here."""

import os

import jax
import numpy as np

from mtd_gan_tpu_torch.data.dicom import write_synthetic_dicom

host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)


def rel(a, b) -> float:
    """max |a - b| / max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def data(seed: int, n: int, size: int = 64):
    """``x`` in [0, 1), ``y`` = x + noise clipped, the first 8 rows of y
    equal to x's (there ``x - y == 0``: NDS masks them)."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, size, size, 1)).astype(np.float32)
    y = np.clip(x + 0.05 * rng.standard_normal(x.shape), 0, 1).astype(np.float32)
    y[:, :8] = x[:, :8]
    return x, y


def assert_step_matches(name: str, delta_p, delta_w) -> None:
    """A parameter's change from a shared start after the same steps on both
    sides, by the rule of ``test_torch_trainer.py``: AdamW moves an entry by
    about lr = 1e-4 per step whatever its gradient's size, so an entry whose
    gradient sits at round-off may step either way; per leaf the mean
    deviation within 5% of the mean JAX change (+ 1e-8, a few fp32 ulps of
    a weight), every entry within 4e-4 (two steps of at most 2 lr apart)."""
    diff = np.abs(np.asarray(delta_p) - np.asarray(delta_w))
    assert diff.mean() <= 5e-2 * np.abs(delta_w).mean() + 1e-8, (name, diff.mean())
    assert diff.max() <= 4e-4, (name, diff.max())


def write_dataset(root: str, splits, size: int = 96) -> None:
    """Synthetic low / full dose DICOM pairs ``<split>/case0/{n_20,n_100}``."""
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:size, 0:size] / size - 0.5
    body = (xx ** 2 / 0.16 + yy ** 2 / 0.1 < 1) * 200.0
    for split, n in splits.items():
        for i in range(n):
            for key, noise in (("n_20", 60.0), ("n_100", 15.0)):
                hu = body - 100.0 + noise * rng.standard_normal((size, size))
                write_synthetic_dicom(os.path.join(root, split, "case0", key, f"s{i}.IMA"),
                                      np.round(hu + 1024.0).astype(np.uint16))
