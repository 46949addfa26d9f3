"""The diffusion family in the port's loops and CLIs: the grouped ``run_test``
sweep against the batch-1 sweep (5 slices at 64x64 in groups of 3, the
tail padded), the noise streams (every ``validate`` chunk and every sweep
slice its own), ``validate`` through the sliding window (64x64 tiles at
overlap 0.5, 32 a chunk), the test CLI's ``--eval-batch`` default of 1 for
``dn``, and the train and test CLIs end to end on each of the four models
(on the ``window_patch`` preset; DDIM on ``full`` and DPM on ``window``,
whole slices, as the root trains them). The UNet is narrow (channels (8,
16, 16), 16 head channels, GroupNorm(4)) with drawn weights, and the chains
are cut to 3 steps (``n_inference_steps``); no JAX here."""

import csv
import json
import os

import numpy as np
import pytest
import torch

from mtd_gan_tpu_torch import test as test_cli
from mtd_gan_tpu_torch import train as train_cli
from mtd_gan_tpu_torch.data.transforms import make_eval_preprocess
from mtd_gan_tpu_torch.engine import loops
from mtd_gan_tpu_torch.engine.supervised import SupervisedTrainer
from mtd_gan_tpu_torch.models import get_model
from mtd_gan_tpu_torch.models.diffusion import wrappers
from mtd_gan_tpu_torch.models.diffusion.wrappers import slice_seed
from mtd_gan_tpu_torch.utils.checkpoint import load_checkpoint
from test_torch_train_helpers import write_dataset

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

TINY = dict(channels=(8, 16, 16), num_head_channels=16, norm_groups=4)
# a grouped sample against the batch-1 samples of its slices: the same
# noise per slice, but the CPU's convs batched 3 or 1 round apart (~1e-6),
# and a DDIM step divides x0's error by sqrt(acp_t) (~0.14 at t = 666):
# 1.2e-5 - 2.1e-5 measured on the [-1, 1] samples, held to SAMPLE_ATOL; a
# sweep's metric rows (on the [0, 1]-clipped samples) to ROW_RTOL / ROW_ATOL
SAMPLE_ATOL = 1e-4
ROW_RTOL, ROW_ATOL = 1e-4, 1e-5


def _model(name="DDIM", steps=3, seed=0):
    """A narrow model with every weight drawn (N(0, 1/fan_in) kernels, N(0,
    0.1^2) biases and GroupNorm offsets), so the UNet's output is not 0."""
    model = get_model(name, **TINY, device="cpu", seed=seed)
    model.n_inference_steps = steps
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.net.parameters():
            if p.dim() > 1:
                p.copy_(torch.randn(p.shape, generator=g) / p[0].numel() ** 0.5)
            else:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return model


def _hu(rng, size=64):
    body = rng.normal(40.0, 60.0, (1, size, size, 1)).astype(np.float32)
    return body, body + rng.normal(0.0, 20.0, body.shape).astype(np.float32)


def test_run_test_grouped_matches_batch_one(tmp_path):
    """``eval_batch`` 3 (groups of 3, 3 and a padded 2) gives the batch-1
    sweep's rows: slice i samples from the stream of its position i
    whatever its group."""
    model = _model()
    eval_pre = make_eval_preprocess("window", "mayo")
    rows = {}
    for eb in (1, 3):
        rng = np.random.default_rng(7)
        items = [(*_hu(rng), [f"/fake/s{i}.IMA"]) for i in range(5)]
        out = tmp_path / f"eb{eb}"
        loops.run_test(model, items, eval_pre, "dn", str(out), compute_fid_metric=False,
                       compute_feature_metrics=False, eval_batch=eb, seed=11)
        with open(out / "pred_results.csv") as f:
            rows[eb] = list(csv.DictReader(f))
        assert len(os.listdir(out / "png")) == 5
    assert len(rows[1]) == len(rows[3]) == 5
    for ra, rb in zip(rows[1], rows[3]):
        assert ra["filename"] == rb["filename"]
        for k in ra:
            if k != "filename":
                assert float(rb[k]) == pytest.approx(float(ra[k]), rel=ROW_RTOL,
                                                     abs=ROW_ATOL), k


def test_noise_streams_are_fresh_per_call_and_per_slice():
    """``validate``'s predictor: each call the next stream under the seed
    (two calls on the same input differ). ``run_test``'s: each slice the
    stream of its position, so two equal slices in one group differ, and
    slices 0 and 1 in two calls equal slices 0 and 1 in one."""
    model = _model()
    x = torch.rand(1, 32, 32, 1)
    per_call = loops._predictor_for(model, "dn", seed=5)
    a, b = per_call(x), per_call(x)
    assert (a - b).abs().max() > 1e-3
    per_slice = loops._predictor_for(model, "dn", seed=5, per_slice=True)
    pair = per_slice(torch.cat([x, x]))
    assert (pair[0] - pair[1]).abs().max() > 1e-3
    again = loops._predictor_for(model, "dn", seed=5, per_slice=True)
    one_by_one = torch.cat([again(x), again(x)])
    torch.testing.assert_close(one_by_one, pair, rtol=0, atol=SAMPLE_ATOL)
    gen = torch.Generator().manual_seed(slice_seed(5, 1))
    torch.testing.assert_close(model.sample(x, generator=gen), pair[1:], rtol=0,
                               atol=SAMPLE_ATOL)


def test_validate_samples_through_the_sliding_window(tmp_path, monkeypatch):
    """A 224x224 slice: 36 tiles of 64x64 at overlap 0.5, in chunks of 32
    and 4, each chunk one call of ``sample`` on its own stream under the
    seed and the epoch; the loss is finite and the PNGs are written."""
    model = _model()
    calls = []
    sample = model.sample

    def recorded(condition, generator=None, draws=None):
        calls.append((tuple(condition.shape), generator.initial_seed()))
        return sample(condition, generator, draws)

    monkeypatch.setattr(model, "sample", recorded)
    hu_x, hu_y = _hu(np.random.default_rng(3), 224)
    stats = loops.validate(model, [(hu_x, hu_y)], make_eval_preprocess("window", "mayo"),
                           "dn", 0, save_dir=str(tmp_path), seed=9)
    epoch0 = slice_seed(9, 0)
    assert calls == [((32, 64, 64, 1), slice_seed(epoch0, 0)),
                     ((4, 64, 64, 1), slice_seed(epoch0, 1))]
    assert np.isfinite(stats["loss"])
    assert (tmp_path / "epoch_0_pred.png").exists()


def test_train_cli_validates_each_epoch_on_fresh_noise(tmp_path, monkeypatch):
    """Two epochs of the train CLI, each validating the one 64x64 slice (one
    tile, one call of ``sample``) with the CLI's ``--seed``: the two validations
    sample on different streams, keyed by the epoch, and their predictions
    differ."""
    monkeypatch.setattr(wrappers._DiffusionBase, "n_inference_steps", 2)
    calls = []
    sample = wrappers._DiffusionBase.sample

    def recorded(self, condition, generator=None, draws=None):
        out = sample(self, condition, generator, draws)
        calls.append((generator.initial_seed(), out))
        return out

    monkeypatch.setattr(wrappers._DiffusionBase, "sample", recorded)
    data_root = str(tmp_path / "data")
    write_dataset(data_root, {"train": 1, "valid": 1}, size=64)
    train_cli.main(train_cli.get_args_parser().parse_args(
        ["--device", "cpu", "--data-root", data_root, "--model", "DDIM", "--seed", "7",
         "--model-kwargs", json.dumps(TINY), "--batch-size", "1", "--epochs", "2",
         "--dataset-type-train", "window_patch",
         "--checkpoint-dir", str(tmp_path / "ckpt"), "--save-dir", str(tmp_path / "pred")]))
    assert [seed for seed, _ in calls] == [slice_seed(slice_seed(7, e), 0) for e in (0, 1)]
    assert (calls[0][1] - calls[1][1]).abs().max() > 1e-3


def test_test_cli_eval_batch_defaults_to_one_for_dn():
    assert test_cli.get_args_parser().parse_args([]).eval_batch is None
    assert test_cli.default_eval_batch("dn") == 1
    for family in ("cnn", "tr", "wgan", "dugan", "mtd"):
        assert test_cli.default_eval_batch(family) == 8


@pytest.mark.parametrize("name,preset", [("DDPM", "window_patch"), ("DDIM", "window_patch"),
                                         ("PNDM", "window_patch"), ("DPM", "window_patch"),
                                         ("DDIM", "full"), ("DPM", "window")])
def test_cli_trains_and_tests_each_model(tmp_path, monkeypatch, name, preset):
    """``train`` (one epoch of one step, validation through the window) then
    ``test --resume``: a ``SupervisedTrainer``, the flat checkpoint of the
    UNet's keys with one optimizer, finite metrics, the sweep one slice a
    forward by default with the CLI's seed."""
    monkeypatch.setattr(wrappers._DiffusionBase, "n_inference_steps", 2)
    monkeypatch.setattr(wrappers.DDPMModel, "n_inference_steps", 2)
    seen = {}
    run_test = loops.run_test

    def recorded(*args, **kw):
        seen.update(eval_batch=kw["eval_batch"], seed=kw["seed"])
        return run_test(*args, **kw)

    monkeypatch.setattr(test_cli, "run_test", recorded)
    trainers = []
    build = train_cli.build_trainer
    monkeypatch.setattr(train_cli, "build_trainer",
                        lambda *a, **kw: trainers.append(build(*a, **kw)) or trainers[-1])
    data_root = str(tmp_path / "data")
    write_dataset(data_root, {"train": 1, "valid": 1, "test": 2})
    common = ["--device", "cpu", "--data-root", data_root, "--model", name,
              "--model-kwargs", json.dumps(TINY)]
    ckpt = tmp_path / "ckpt"
    stats = train_cli.main(train_cli.get_args_parser().parse_args(
        common + ["--batch-size", "1", "--epochs", "1", "--dataset-type-train", preset,
                  "--checkpoint-dir", str(ckpt), "--save-dir", str(tmp_path / "pred")]))
    assert isinstance(trainers[0], SupervisedTrainer)
    assert np.isfinite(stats["train_loss"]) and np.isfinite(stats["valid_loss"])
    saved = load_checkpoint(str(ckpt / "epoch_0.pth"))
    assert {"model_state_dict", "optimizer", "scheduler", "epoch", "args"} <= set(saved)
    keys = get_model(name, **TINY, device="cpu").net.state_dict().keys()
    assert sorted(saved["model_state_dict"]) == sorted(keys)
    summary = test_cli.main(test_cli.get_args_parser().parse_args(
        common + ["--resume", str(ckpt / "epoch_0.pth"), "--no-feature-metrics",
                  "--save-dir", str(tmp_path / "test")]))
    assert seen == {"eval_batch": 1, "seed": 42}
    assert np.isfinite(summary["pred_psnr"]) and np.isfinite(summary["pred_ssim"])
