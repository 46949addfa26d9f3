"""The ``python -m mtd_gan_tpu_torch.test`` sweep at its default (PL, TML
and FID on) against the JAX package's ``run_test`` on the CPU, with the same
generator and the same torchvision-named extractor files."""

import csv
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mtd_gan_tpu.data.pipeline import PairedDicomDataset as JaxDataset
from mtd_gan_tpu.data.pipeline import eval_loader as jax_eval_loader
from mtd_gan_tpu.data.transforms import make_eval_preprocess as jax_eval_preprocess
from mtd_gan_tpu.engine.loops import run_test as jax_run_test
from mtd_gan_tpu.features import inception as jax_inception
from mtd_gan_tpu.features import registry as jax_registry
from mtd_gan_tpu.features import vgg as jax_vgg
from mtd_gan_tpu.metrics import perceptual as jax_perceptual
from mtd_gan_tpu.models.mtd_gan import MTDGANModel as JaxModel
from mtd_gan_tpu_torch.data import dicom
from mtd_gan_tpu_torch.utils import torch_import
from tests.test_torch_feature_helpers import (assert_rel, clear_feature_caches,
                                              draw_tree, kept_per_array)

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

# PL and TML per slice, relative: fp32 on both sides, features ~3e-6 apart
# (oneDNN against XLA convs); measured 5.4e-7
TOL_PL_TML = 1e-4
# input_fid and pred_fid, relative. Three slices in 2048 dimensions give
# rank-2 covariances whose square roots clip eigenvalues that are rounding
# noise; measured 5.6e-8 and 8.1e-8. gt_fid is that noise alone (-7.6e-7
# and -7.3e-7 against an input_fid of 3840), held to 1e-6 of input_fid
TOL_FID = 1e-5


def _write_dataset(root, n=3, size=256):
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:size, 0:size] / size - 0.5
    body = (xx ** 2 / 0.16 + yy ** 2 / 0.1 < 1) * 200.0
    for i in range(n):
        for key, noise in (("n_20", 60.0), ("n_100", 15.0)):
            hu = body - 100.0 + noise * rng.standard_normal((size, size))
            dicom.write_synthetic_dicom(os.path.join(root, "test", "case0", key, f"s{i}.IMA"),
                                        np.round(hu + 1024.0).astype(np.uint16))


@pytest.fixture
def clear_caches():
    """The JAX package's extractor caches and the port's, cleared before
    and after the test."""
    clear_feature_caches()
    yield
    clear_feature_caches()


def test_sweep_matches_jax_run_test(clear_caches, tmp_path, monkeypatch):
    """The port's test CLI at its default (``--device cpu``, no
    ``--no-feature-metrics``) on 3 synthetic 256x256 pairs, eval batch 2,
    against the JAX ``run_test`` with feature metrics on: the same generator
    and the same ``vgg19-*.pth`` / ``pt_inception-*.pth`` files through
    ``MTD_GAN_TPU_WEIGHTS``. The columns and their order; per slice PL and
    TML within 1e-4 relative, gt_pl and gt_tml exactly 0; the FID summary
    within TOL_FID. The JAX side's VGG19 is jitted and kept per input array
    (:func:`kept_per_array`; ``compute_pl`` and ``compute_tml`` of one slice
    share the arrays). The CLI runs in a process of its own beside the JAX
    side, with 4 threads: its FID takes six float64 eigendecompositions of
    2048 x 2048 matrices, over ten seconds on one."""
    data = str(tmp_path / "data")
    _write_dataset(data)
    weights = tmp_path / "weights"
    weights.mkdir()
    torch.save(torch_import.vgg19_state_dict_from_flax(draw_tree(jax_vgg.init_vgg19_params, 19)),
               weights / "vgg19-test.pth")
    torch.save(torch_import.inception_state_dict_from_flax(
        draw_tree(jax_inception.init_inception_params, 2015)),
        weights / "pt_inception-test.pth")
    for var, value in (("MTD_GAN_TPU_WEIGHTS", weights), ("TORCH_HOME", tmp_path / "th"),
                       ("HOME", tmp_path / "home")):
        monkeypatch.setenv(var, str(value))

    jm = JaxModel(gen_features=8, disc_features=8, num_layers=2)
    params = jax.jit(jm.Generator.init)(
        jax.random.PRNGKey(3), np.zeros((1, 256, 256, 1), np.float32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    ckpt = tmp_path / "ref.pth"
    torch.save({"model_state_dict": {f"Generator.{k}": v for k, v in
                                     torch_import.generator_state_dict_from_flax(params).items()},
                "epoch": 2}, ckpt)

    port_dir = tmp_path / "port"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "4"
    # the port's CLI runs beside the JAX side; its output goes to a file
    with open(tmp_path / "port.log", "w+") as log, subprocess.Popen(
            [sys.executable, "-m", "mtd_gan_tpu_torch.test", "--device", "cpu",
             "--data-root", data, "--resume", str(ckpt), "--save-dir", str(port_dir),
             "--eval-batch", "2", "--model-kwargs",
             json.dumps({"gen_features": 8, "disc_features": 8, "num_layers": 2})],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT, text=True) as proc:
        jax_vgg_fn = kept_per_array(jax.jit(jax_registry.get_vgg_slices_fn()))
        monkeypatch.setattr(jax_perceptual, "_vgg_fn", lambda: jax_vgg_fn)
        jax_dir = tmp_path / "jax"
        want_summary = jax_run_test(
            jm, types.SimpleNamespace(params_g=params),
            jax_eval_loader(JaxDataset(data, "test")), jax_eval_preprocess("window", "mayo"),
            "mtd", save_dir=str(jax_dir), eval_batch=2)
        assert proc.wait(timeout=300) == 0, (log.seek(0), log.read())[1]
    status = jax_registry.feature_weights_status()
    assert "vgg19-test.pth" in status["vgg19"] and "pt_inception-test.pth" in status["inception"]

    with open(port_dir / "pred_results.csv") as f:
        got = list(csv.DictReader(f))
    with open(jax_dir / "pred_results.csv") as f:
        want = list(csv.DictReader(f))
    assert list(got[0]) == list(want[0])  # the JAX package's columns, in its order
    assert [r["filename"] for r in got] == [r["filename"] for r in want] and len(got) == 3
    for g, w in zip(got, want):
        assert float(g["gt_pl"]) == 0.0 and float(g["gt_tml"]) == 0.0
        for col in ("input_pl", "pred_pl", "input_tml", "pred_tml"):
            assert_rel(float(g[col]), float(w[col]), TOL_PL_TML, col)
    summary = json.loads((port_dir / "test_summary.json").read_text())
    assert list(summary) == list(want_summary)
    for k in ("input_fid", "pred_fid"):
        assert_rel(summary[k], want_summary[k], TOL_FID, k)
    assert abs(summary["gt_fid"]) <= 1e-6 * summary["input_fid"]
    assert abs(want_summary["gt_fid"]) <= 1e-6 * want_summary["input_fid"]
    log = json.loads((port_dir / "test_log.txt").read_text().splitlines()[-1])
    assert "vgg19-test.pth" in log["feature_weights"]["vgg19"]

