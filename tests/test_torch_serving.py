"""The serving path of the PyTorch port against the JAX package: DICOM
decode, HU windowing, pixel metrics, PNG/CSV writers and the
``python -m mtd_gan_tpu_torch.test`` sweep end to end."""

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
from PIL import Image

from mtd_gan_tpu.data import dicom as jax_dicom
from mtd_gan_tpu.data.pipeline import PairedDicomDataset as JaxDataset
from mtd_gan_tpu.data.pipeline import eval_loader as jax_eval_loader
from mtd_gan_tpu.data.transforms import make_eval_preprocess as jax_eval_preprocess
from mtd_gan_tpu.engine.loops import run_test as jax_run_test
from mtd_gan_tpu.metrics import pixel as jax_pixel
from mtd_gan_tpu.models.mtd_gan import MTDGANModel as JaxModel
from mtd_gan_tpu.utils.artifacts import save_png_gray as jax_save_png
from mtd_gan_tpu_torch.data import dicom
from mtd_gan_tpu_torch.data.pipeline import PairedDicomDataset, eval_loader
from mtd_gan_tpu_torch.data.transforms import make_eval_preprocess
from mtd_gan_tpu_torch.engine.loops import run_test
from mtd_gan_tpu_torch.metrics import pixel
from mtd_gan_tpu_torch.models.mtd_gan import MTDGANModel
from mtd_gan_tpu_torch.utils.artifacts import save_csv, save_png_gray
from mtd_gan_tpu_torch.utils.torch_import import generator_state_dict_from_flax

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("signed,slope,intercept",
                         [(False, 1.0, -1024.0), (True, 1.0, 0.0),
                          (False, 2.0, -1024.0)])
def test_dicom_hu_matches_jax(tmp_path, writer, signed, slope, intercept):
    """Either writer's file decodes to the same int16 HU in both readers
    (exact: integer arithmetic)."""
    rng = np.random.default_rng(0)
    lo, hi = (-1000, 1000) if signed else (0, 4000)
    stored = rng.integers(lo, hi, (32, 48))
    stored[0, 0] = -2000 if signed else stored[0, 0]  # air sentinel
    path = str(tmp_path / "s.IMA")
    (jax_dicom if writer == "jax" else dicom).write_synthetic_dicom(
        path, stored, slope=slope, intercept=intercept, signed=signed)
    want = jax_dicom.get_pixels_hu(path)
    got = dicom.get_pixels_hu(path)
    assert got.dtype == want.dtype == np.int16
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("preset,dataset", [("window", "mayo"),
                                            ("window", "brain"),
                                            ("full", "mayo")])
def test_eval_preprocess_matches_jax(preset, dataset):
    """Same fp32 formula; XLA folds the constants into another op order, so
    results agree to one ulp (atol 1e-7 on [0, 1])."""
    rng = np.random.default_rng(1)
    hu_x = rng.integers(-1100, 3000, (2, 16, 16, 1)).astype(np.int16)
    hu_y = rng.integers(-1100, 3000, (2, 16, 16, 1)).astype(np.int16)
    wx, wy = jax_eval_preprocess(preset, dataset)(hu_x, hu_y)
    gx, gy = make_eval_preprocess(preset, dataset)(torch.tensor(hu_x),
                                                  torch.tensor(hu_y))
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=0, atol=1e-7)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=0, atol=1e-7)


def test_pixel_metrics_match_jax():
    """RMSE/PSNR/SSIM triples at rtol 1e-5 (fp32; the SSIM window sums run
    in another order)."""
    rng = np.random.default_rng(2)
    y = rng.random((2, 64, 64, 1)).astype(np.float32)
    x = np.clip(y + 0.1 * rng.standard_normal(y.shape), 0, 1).astype(np.float32)
    p = np.clip(y + 0.03 * rng.standard_normal(y.shape), 0, 1).astype(np.float32)
    for name in ("compute_rmse", "compute_psnr", "compute_ssim"):
        want = [float(v) for v in getattr(jax_pixel, name)(x, y, p)]
        got = [float(v) for v in getattr(pixel, name)(
            torch.tensor(x), torch.tensor(y), torch.tensor(p))]
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
    # a 2-D image is one slice
    np.testing.assert_allclose(
        float(pixel.ssim(torch.tensor(x[0, ..., 0]), torch.tensor(y[0, ..., 0]))),
        float(jax_pixel.ssim(x[0, ..., 0], y[0, ..., 0])), rtol=1e-5)


def test_png_matches_jax_writer(tmp_path):
    """The zlib PNG encoder decodes (with PIL) to the same pixels as the
    JAX package's PIL writer: round(clip(x, 0, 1) * 255), half to even."""
    rng = np.random.default_rng(3)
    img = rng.random((40, 56, 1)) * 1.2 - 0.1
    img[0, :4, 0] = [0.5 / 255, 1.5 / 255, 2.5 / 255, 1.0]  # ties
    save_png_gray(str(tmp_path / "port.png"), img)
    jax_save_png(str(tmp_path / "jax.png"), img)
    got = np.asarray(Image.open(tmp_path / "port.png"))
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    assert Image.open(tmp_path / "port.png").mode == "L"
    np.testing.assert_array_equal(got, want)
    u8 = rng.integers(0, 256, (8, 8), dtype=np.uint8)
    save_png_gray(str(tmp_path / "u8.png"), u8)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "u8.png")), u8)


def test_csv_round_trip(tmp_path):
    rows = [{"a": 0.1, "b": 2.5, "filename": "x.png"},
            {"a": 1e-9, "b": 100.0, "filename": "y.png"}]
    save_csv(str(tmp_path / "r.csv"), rows)
    with open(tmp_path / "r.csv") as f:
        back = list(csv.DictReader(f))
    assert [r["filename"] for r in back] == ["x.png", "y.png"]
    assert [float(r["a"]) for r in back] == [0.1, 1e-9]


def test_run_test_refuses_feature_metrics(tmp_path):
    model = MTDGANModel(gen_features=8, num_layers=1, device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        run_test(model, [], make_eval_preprocess(), "mtd", str(tmp_path))
    with pytest.raises(NotImplementedError, match="not ported"):
        run_test(model, [], make_eval_preprocess(), "cnn", str(tmp_path),
                 compute_fid_metric=False, compute_feature_metrics=False)


def _write_dataset(root, n=3, size=64):
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:size, 0:size] / size - 0.5
    body = (xx ** 2 / 0.16 + yy ** 2 / 0.1 < 1) * 200.0
    for i in range(n):
        for key, noise in (("n_20", 60.0), ("n_100", 15.0)):
            hu = body - 100.0 + noise * rng.standard_normal((size, size))
            dicom.write_synthetic_dicom(
                os.path.join(root, "test", "case0", key, f"s{i}.IMA"),
                np.round(hu + 1024.0).astype(np.uint16))


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_cli_sweep_matches_jax_run_test(tmp_path):
    """``python -m mtd_gan_tpu_torch.test --device cpu`` on 3 synthetic
    64x64 pairs (eval batch 2, so the last group is padded) with the JAX
    model's weights saved as a reference-layout .pth: per-slice pred_psnr
    and pred_ssim within 1e-4 of JAX run_test with the same weights (fp32
    on both sides), same file names, PNGs within one grey level."""
    data = str(tmp_path / "data")
    _write_dataset(data)
    jm = JaxModel(gen_features=8, disc_features=8, num_layers=2)
    params = jax.jit(jm.Generator.init)(
        jax.random.PRNGKey(3), np.zeros((1, 64, 64, 1), np.float32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    sd = generator_state_dict_from_flax(params)
    ckpt = tmp_path / "ref.pth"
    torch.save({"model_state_dict": {f"Generator.{k}": v for k, v in sd.items()},
                "epoch": 5}, ckpt)

    port_dir = tmp_path / "port"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"  # as this process: one intra-op thread
    proc = subprocess.run(
        [sys.executable, "-m", "mtd_gan_tpu_torch.test", "--device", "cpu",
         "--no-feature-metrics", "--data-root", data, "--resume", str(ckpt),
         "--save-dir", str(port_dir), "--eval-batch", "2",
         "--model-kwargs", json.dumps({"gen_features": 8, "disc_features": 8,
                                       "num_layers": 2})],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr

    jax_dir = tmp_path / "jax"
    jax_run_test(jm, types.SimpleNamespace(params_g=params),
                 jax_eval_loader(JaxDataset(data, "test")),
                 jax_eval_preprocess("window", "mayo"), "mtd",
                 save_dir=str(jax_dir), compute_fid_metric=False,
                 compute_feature_metrics=False, eval_batch=2)

    got, want = _read_csv(port_dir / "pred_results.csv"), _read_csv(jax_dir / "pred_results.csv")
    assert [r["filename"] for r in got] == [r["filename"] for r in want]
    assert len(got) == 3
    for g, w in zip(got, want):
        for col in ("pred_psnr", "pred_ssim", "input_psnr", "input_ssim"):
            assert abs(float(g[col]) - float(w[col])) < 1e-4, (col, g, w)
    for r in want:
        a = np.asarray(Image.open(port_dir / "png" / r["filename"]), np.int16)
        b = np.asarray(Image.open(jax_dir / "png" / r["filename"]), np.int16)
        assert np.abs(a - b).max() <= 1
    summary = json.loads((port_dir / "test_summary.json").read_text())
    log = json.loads((port_dir / "test_log.txt").read_text().splitlines()[-1])
    assert log["epoch"] == 5 and log["pred_psnr"] == summary["pred_psnr"]


def test_port_loader_matches_jax_loader(tmp_path):
    data = str(tmp_path / "data")
    _write_dataset(data, n=2, size=32)
    got = list(eval_loader(PairedDicomDataset(data, "test"), 1))
    want = list(jax_eval_loader(JaxDataset(data, "test"), 1))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2] == w[2]
