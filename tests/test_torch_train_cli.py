"""The training data path and CLI of the port: the train preprocess's
deterministic parts against the JAX package (HU window, foreground bbox,
crop origins and crops at given offsets, rotation by a given angle), the
augmentation's draws, the shuffled loader's order, and
``python -m mtd_gan_tpu_torch.train`` -> ``python -m mtd_gan_tpu_torch.test``
on a tiny synthetic set."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtd_gan_tpu.data import transforms as jt
from mtd_gan_tpu.data.pipeline import _batched_indices as jax_batched_indices
from mtd_gan_tpu_torch.data import transforms as pt
from mtd_gan_tpu_torch.data.dicom import write_synthetic_dicom
from mtd_gan_tpu_torch.data.pipeline import PairedDicomDataset, batched_indices, train_loader
from mtd_gan_tpu_torch.utils.checkpoint import load_checkpoint

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PATCH = 64


def _hu(seed, n=3, size=96):
    """HU slices with an off-centre body (its bbox smaller than the image)
    and one empty slice (all air: bbox = whole image)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    body = ((yy - 40) ** 2 / 600 + (xx - 55) ** 2 / 300 < 1)
    hu = np.where(body, 40.0, -1000.0) + 30 * rng.standard_normal((n, size, size))
    hu[-1] = -1000.0
    return hu[..., None].astype(np.int16)


def test_window_bbox_and_crop_windows_match_jax():
    hu = _hu(0)
    y = pt._window_fn("mayo")(torch.tensor(hu).float())
    want_y = np.asarray(jt._window_fn("mayo")(jnp.asarray(hu, jnp.float32)))
    np.testing.assert_allclose(y.numpy(), want_y, atol=1e-7)
    got = pt.foreground_bbox(y > 0)
    for i in range(hu.shape[0]):
        want = jt._foreground_bbox(jnp.asarray(want_y[i] > 0))
        assert [int(g[i]) for g in got] == [int(w) for w in want]
    # crop origins: JAX draws top in [rmin, rmax - patch] after the same pad
    # and expansion; the port returns that inclusive range
    _, _, lo_r, hi_r, lo_c, hi_c = pt.crop_windows(y, y, PATCH)
    for i in range(hu.shape[0]):
        r0, r1, c0, c1 = (int(v) for v in jt._foreground_bbox(jnp.asarray(want_y[i] > 0)))
        for lo, hi, a, b in ((lo_r, hi_r, r0, r1), (lo_c, hi_c, c0, c1)):
            deficit = max(PATCH - (b - a), 0)
            assert int(lo[i]) == a + PATCH - (deficit + 1) // 2
            assert int(hi[i]) == b + PATCH + deficit // 2 - PATCH
            assert int(hi[i]) >= int(lo[i])


def test_crop_at_given_offsets_matches_jax_dynamic_slice():
    rng = np.random.default_rng(1)
    x = rng.random((2, 96, 96, 1)).astype(np.float32)
    y = rng.random((2, 96, 96, 1)).astype(np.float32)
    xp, yp, *_ = pt.crop_windows(torch.tensor(x), torch.tensor(y), PATCH)
    tops = torch.tensor([[0, 17, 96], [5, 64, 130]])
    lefts = torch.tensor([[3, 40, 128], [0, 90, 1]])
    px, py = pt.crop_pairs(xp, yp, tops, lefts, PATCH)
    assert px.shape == (2, 3, PATCH, PATCH, 1)
    for b in range(2):
        jxp = jnp.pad(x[b], ((PATCH, PATCH), (PATCH, PATCH), (0, 0)))
        jyp = jnp.pad(y[b], ((PATCH, PATCH), (PATCH, PATCH), (0, 0)))
        for s in range(3):
            start = (int(tops[b, s]), int(lefts[b, s]), 0)
            np.testing.assert_array_equal(
                px[b, s].numpy(), np.asarray(jax.lax.dynamic_slice(jxp, start, (PATCH, PATCH, 1))))
            np.testing.assert_array_equal(
                py[b, s].numpy(), np.asarray(jax.lax.dynamic_slice(jyp, start, (PATCH, PATCH, 1))))


@pytest.mark.parametrize("angle", [0.2, -0.25, np.pi / 12])
def test_rotation_matches_jax(angle):
    """Bilinear rotation with zero fill (grid_sample, align_corners) against
    map_coordinates(order=1, mode="constant"): 1e-5 (the normalised grid
    coordinates round differently)."""
    img = np.random.default_rng(2).random((PATCH, PATCH, 1)).astype(np.float32)
    want = np.asarray(jt._rotate_image(jnp.asarray(img), jnp.float32(angle)))
    got = pt.rotate_images(torch.tensor(img[None]), torch.tensor([angle], dtype=torch.float32))
    np.testing.assert_allclose(got[0].numpy(), want, atol=1e-5)


def test_train_preprocess_draws_from_its_generator():
    """Shapes (slice-major crops), values in [0, 1], x and y cut and
    augmented together, and the same generator seed gives the same batch."""
    hu = torch.tensor(_hu(3, n=2))
    pre = pt.make_train_preprocess(aug_prob=1.0)
    a = pre(hu, hu, torch.Generator().manual_seed(5))
    b = pre(hu, hu, torch.Generator().manual_seed(5))
    assert a[0].shape == a[1].shape == (16, PATCH, PATCH, 1)
    assert torch.equal(a[0], b[0]) and torch.equal(a[0], a[1])
    assert float(a[0].min()) >= 0 and float(a[0].max()) <= 1
    c = pt.make_train_preprocess("full_patch")(hu, hu, torch.Generator().manual_seed(5))
    assert c[0].shape == c[1].shape == (2 * 8, PATCH, PATCH, 1)


def test_loader_order_matches_jax(tmp_path):
    for n, bs, seed in ((10, 3, 0), (7, 7, 4), (9, 2, 11)):
        got = batched_indices(n, bs, True, True, seed)
        want = jax_batched_indices(n, bs, True, True, seed)
        assert [list(g) for g in got] == [list(w) for w in want]
    _write_dataset(str(tmp_path), {"train": 5})
    ds = PairedDicomDataset(str(tmp_path), "train")
    loader = train_loader(ds, 2, seed=3, num_threads=3)
    batches = list(loader)
    assert len(loader) == len(batches) == 2
    for (hx, hy), idxs in zip(batches, batched_indices(5, 2, True, True, 3)):
        want = [ds.load(int(i)) for i in idxs]
        np.testing.assert_array_equal(hx[..., 0], np.stack([w[0] for w in want]))
        np.testing.assert_array_equal(hy[..., 0], np.stack([w[1] for w in want]))


def _write_dataset(root, splits, size=96):
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:size, 0:size] / size - 0.5
    body = (xx ** 2 / 0.16 + yy ** 2 / 0.1 < 1) * 200.0
    for split, n in splits.items():
        for i in range(n):
            for key, noise in (("n_20", 60.0), ("n_100", 15.0)):
                hu = body - 100.0 + noise * rng.standard_normal((size, size))
                write_synthetic_dicom(os.path.join(root, split, "case0", key, f"s{i}.IMA"),
                                      np.round(hu + 1024.0).astype(np.uint16))


def _run(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"  # as this process: one intra-op thread
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_cli_train_then_test_round_trip(tmp_path):
    """Two epochs of ``train --device cpu`` (2 slices per step = 16 crops),
    a resume for a third, then ``test --resume`` on the last checkpoint:
    the checkpoint holds the reference layout and the test CLI reads it."""
    data, ckpt = str(tmp_path / "data"), tmp_path / "ckpt"
    _write_dataset(data, {"train": 2, "valid": 1, "test": 2})
    mk = json.dumps({"gen_features": 8, "disc_features": 8, "num_layers": 1})
    common = ["--device", "cpu", "--data-root", data, "--batch-size", "2",
              "--model-kwargs", mk, "--checkpoint-dir", str(ckpt),
              "--save-dir", str(tmp_path / "pred"), "--warmup-epochs", "1"]
    proc = _run("mtd_gan_tpu_torch.train", *common, "--epochs", "2")
    assert proc.returncode == 0, proc.stderr
    proc = _run("mtd_gan_tpu_torch.train", *common, "--epochs", "3",
                "--resume", str(ckpt / "epoch_1.pth"))
    assert proc.returncode == 0, proc.stderr
    assert "next epoch 2" in proc.stdout
    log = [json.loads(line) for line in (ckpt / "log.txt").read_text().splitlines()]
    assert [r["epoch"] for r in log] == [0, 1, 2]
    assert all(np.isfinite(r["train_d_loss"]) and np.isfinite(r["valid_loss"]) for r in log)
    saved = load_checkpoint(str(ckpt / "epoch_2.pth"))
    assert {"model_state_dict", "optimizer_G", "optimizer_D", "scheduler", "epoch",
            "args"} <= set(saved)
    keys = saved["model_state_dict"]
    assert any(k.startswith("Generator.") for k in keys)
    assert "Discriminator.conv11.weight_u" in keys and saved["epoch"] == 2
    proc = _run("mtd_gan_tpu_torch.test", "--device", "cpu", "--data-root", data,
                "--resume", str(ckpt / "epoch_2.pth"), "--no-feature-metrics",
                "--model-kwargs", mk, "--save-dir", str(tmp_path / "test"))
    assert proc.returncode == 0, proc.stderr
    summary = json.loads((tmp_path / "test" / "test_summary.json").read_text())
    assert np.isfinite(summary["pred_psnr"])


def test_train_cli_defaults_to_cuda_and_refuses_unported(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the exit without a GPU")
    proc = _run("mtd_gan_tpu_torch.train", "--data-root", str(tmp_path))
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
    proc = _run("mtd_gan_tpu_torch.train", "--device", "cpu", "--model", "DDPM_v2")
    assert proc.returncode != 0 and "unknown model 'DDPM_v2'" in proc.stderr
