"""The port's entry points against the root CLIs and the JAX package: every
flag the root ``train.py`` and ``test.py`` take, with the same default but
``--device``; ``bench.run`` at a tiny size on the CPU and ``bench.main``
without a GPU; the cosine warm-restart schedule and the ``full``,
``full_patch`` and ``window`` train presets against JAX; the test CLI's
checkpoint choice; the params-only warm start; the method's state through
a checkpoint; the TensorBoard sink, the profiler trace and the CPU
prefetcher."""

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtd_gan_tpu.data import transforms as jt
from mtd_gan_tpu.optim import CosineWarmRestarts as JaxCosine
from mtd_gan_tpu_torch import bench
from mtd_gan_tpu_torch import test as test_cli
from mtd_gan_tpu_torch import train as train_cli
from mtd_gan_tpu_torch.data import transforms as pt
from mtd_gan_tpu_torch.data.dicom import write_synthetic_dicom
from mtd_gan_tpu_torch.data.pipeline import prefetch_to_device
from mtd_gan_tpu_torch.engine.gan import MTDGANTrainer
from mtd_gan_tpu_torch.models.mtd_gan import MTDGANModel
from mtd_gan_tpu_torch.optim import CosineWarmRestarts, get_scheduler
from mtd_gan_tpu_torch.utils.checkpoint import load_pretrained, restore, save_checkpoint
from mtd_gan_tpu_torch.utils.logging import TensorBoardSink
from mtd_gan_tpu_torch.utils.profiling import StepTimer, trace

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PATCH = 64
# defaults that differ on purpose, with the reason
DIFFERENT_DEFAULTS = {"device": "the root runs on 'tpu', the port on 'cuda'"}


def _root_parser(name):
    spec = importlib.util.spec_from_file_location(f"root_{name}", REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.get_args_parser()


@pytest.mark.parametrize("name, port", [("train", train_cli), ("test", test_cli)])
def test_cli_takes_every_root_flag_with_its_default(name, port):
    """Every flag of the root CLI parses in the port's, and its default is
    the same (``--method`` is ``""``: the plain summed backward)."""
    root = {a.dest: a for a in _root_parser(name)._actions if a.option_strings}
    mine = {a.dest: a for a in port.get_args_parser()._actions if a.option_strings}
    assert set(root) <= set(mine), sorted(set(root) - set(mine))
    for dest, action in root.items():
        if dest in DIFFERENT_DEFAULTS:
            continue
        assert mine[dest].default == action.default, (dest, mine[dest].default,
                                                      action.default)
        assert mine[dest].option_strings == action.option_strings, dest


def test_train_cli_refuses_the_tpu_only_flags():
    parse = train_cli.get_args_parser().parse_args
    for flags in (["--tp-size", "4"], ["--g-precision", "bf16x2"], ["--g-forward", "pallas"],
                  ["--bf16"], ["--multi-gpu-mode", "DataParallel"]):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            train_cli.main(parse(["--device", "cpu", *flags]))
    with pytest.raises(NotImplementedError, match="item 14"):
        test_cli.main(test_cli.get_args_parser().parse_args(
            ["--device", "cpu", "--multi-gpu-mode", "DataParallel"]))


def test_bench_run_on_the_cpu_and_main_without_a_gpu(monkeypatch, capsys):
    out = bench.run(32, (2, 1), gen_features=8, num_layers=1, device="cpu", iters=2)
    for key in ("metric", "value", "unit", "vs_baseline", "tflops", "mfu", "peak_tflops",
                "batch", "warmup_s", "device", "route"):
        assert key in out, key
    assert out["value"] > 0 and out["vs_baseline"] > 0 and out["batch"] in (1, 2)
    assert out["batches"] == [2, 1]
    assert out["route"] == "plain" and out["device"] == "cpu" and out["mfu"] is None
    json.dumps(out)
    assert "# batch 2:" in capsys.readouterr().err
    # 21 blocks at 512^2 as the fused block counts them, plus the entry conv
    assert bench.generator_flops(512) == pytest.approx(
        sum(sum(bench.block_work(1, 512, v)[:2]) for v in
            ["plain"] + ["pre"] * 10 + ["pre+skip"] * 9 + ["pre+skip+post"])
        + (2 * 9 * 32 + 64) * 512 * 512)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main()


@pytest.mark.parametrize("t_mult", [1, 2])
def test_cosine_warm_restarts_match_jax(t_mult):
    mine, want = CosineWarmRestarts(1e-4, t_mult=t_mult), JaxCosine(1e-4, t_mult=t_mult)
    for epoch in range(-1, 250):
        assert mine(epoch) == pytest.approx(want(epoch), rel=1e-12), epoch
    assert get_scheduler("cosine_annealing_warm_restart", 1e-4, 500)(37) == \
        pytest.approx(JaxCosine(1e-4)(37), rel=1e-12)
    with pytest.raises(KeyError):
        get_scheduler("step_lr", 1e-4, 500)


def _hu(seed, n=2, size=96):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    body = ((yy - 40) ** 2 / 600 + (xx - 55) ** 2 / 300 < 1)
    hu = np.where(body, 40.0, -1000.0) + 30 * rng.standard_normal((n, size, size))
    return hu[..., None].astype(np.int16)


@pytest.mark.parametrize("preset", ["full", "window"])
def test_whole_slice_presets_match_jax(preset):
    """Without augmentation: the normalisation (and, for ``window``, the
    per-image min-max rescale) of whole slices."""
    hu = _hu(0)
    got = pt.make_train_preprocess(preset, aug_prob=0.0)(
        torch.tensor(hu), torch.tensor(hu), torch.Generator().manual_seed(0))
    want = jt.make_train_preprocess(preset, aug_prob=0.0)(
        jax.random.PRNGKey(0), jnp.asarray(hu), jnp.asarray(hu))
    for g, w in zip(got, want):
        assert g.shape == w.shape == hu.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    if preset == "window":
        assert float(got[0].min()) == 0.0 and float(got[0].max()) == pytest.approx(1.0)


@pytest.mark.parametrize("size", [96, 48])
def test_full_patch_crops_match_jax(size):
    """``full_patch``: the full-range normalisation and crop origins over the
    whole slice (grown to the patch where the slice is smaller), the crops at
    given offsets against ``dynamic_slice`` of the padded JAX slice, and the
    preprocess's crops at the origins its generator draws."""
    hu = _hu(1, size=size)
    x = pt.dicom_normalize(torch.tensor(hu).float())
    np.testing.assert_allclose(
        x.numpy(), np.asarray(jt.dicom_normalize(jnp.asarray(hu, jnp.float32))), atol=1e-7)
    xp, yp, lo_r, hi_r, lo_c, hi_c = pt.crop_windows(x, x, PATCH, foreground=False)
    deficit = max(PATCH - size, 0)
    for lo, hi in ((lo_r, hi_r), (lo_c, hi_c)):  # JAX _sample_patches_pair's range
        assert lo.tolist() == [PATCH - (deficit + 1) // 2] * 2
        assert hi.tolist() == [PATCH + size + deficit // 2 - PATCH] * 2
    tops = torch.stack([lo_r, hi_r], 1)
    lefts = torch.stack([hi_c, lo_c], 1)
    px, _ = pt.crop_pairs(xp, yp, tops, lefts, PATCH)
    for b in range(2):
        jxp = jnp.pad(jnp.asarray(x[b].numpy()), ((PATCH, PATCH), (PATCH, PATCH), (0, 0)))
        for s in range(2):
            start = (int(tops[b, s]), int(lefts[b, s]), 0)
            np.testing.assert_array_equal(
                px[b, s].numpy(), np.asarray(jax.lax.dynamic_slice(jxp, start, (PATCH, PATCH, 1))))
    got, _ = pt.make_train_preprocess("full_patch", aug_prob=0.0)(
        torch.tensor(hu), torch.tensor(hu), torch.Generator().manual_seed(4))
    u = torch.rand((2, 2, 8), generator=torch.Generator().manual_seed(4))
    pick = lambda lo, hi, v: torch.minimum(lo[:, None] + (v * (hi - lo + 1)[:, None]).long(),
                                           hi[:, None])
    want, _ = pt.crop_pairs(xp, yp, pick(lo_r, hi_r, u[0]), pick(lo_c, hi_c, u[1]), PATCH)
    assert got.shape == (2 * 8, PATCH, PATCH, 1)
    assert torch.equal(got, want.reshape(16, PATCH, PATCH, 1))


def test_whole_slices_refused_by_the_train_step():
    model = MTDGANModel(gen_features=8, disc_features=8, num_layers=1, device="cpu")
    x = torch.rand(1, 96, 96, 1)
    with pytest.raises(ValueError, match="64x64"):
        MTDGANTrainer(model, method=None).train_step(x, x)


def _save_generator(path, seed, epoch):
    m = MTDGANModel(gen_features=8, disc_features=8, num_layers=1, device="cpu", seed=seed)
    sd = {f"Generator.{k}": v for k, v in m.generator.state_dict().items()}
    torch.save({"model_state_dict": sd, "epoch": epoch}, path)


def test_test_cli_picks_the_latest_or_the_named_epoch(tmp_path):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    for seed, epoch in ((1, 0), (2, 2), (3, 10)):
        _save_generator(str(ckpt / f"epoch_{epoch}.pth"), seed, epoch)
    assert test_cli.checkpoint_path(str(ckpt)).endswith("epoch_10.pth")
    assert test_cli.checkpoint_path(str(ckpt), 2).endswith("epoch_2.pth")
    with pytest.raises(FileNotFoundError):
        test_cli.checkpoint_path(str(ckpt), 5)
    with pytest.raises(FileNotFoundError):
        test_cli.checkpoint_path(str(tmp_path))
    rng = np.random.default_rng(0)
    for key in ("n_20", "n_100"):
        for i in range(2):
            write_synthetic_dicom(str(tmp_path / "data" / "test" / "c" / key / f"s{i}.IMA"),
                                  rng.integers(900, 1200, (32, 32)).astype(np.uint16))
    common = ["--device", "cpu", "--data-root", str(tmp_path / "data"), "--checkpoint-dir",
              str(ckpt), "--no-feature-metrics", "--model-kwargs",
              json.dumps({"gen_features": 8, "num_layers": 1})]
    for extra, epoch in (([], 10), (["--epoch", "2"], 2)):
        save = tmp_path / f"out{epoch}"
        test_cli.main(test_cli.get_args_parser().parse_args(
            [*common, *extra, "--save-dir", str(save)]))
        line = json.loads((save / "test_log.txt").read_text().splitlines()[-1])
        assert line["epoch"] == epoch and np.isfinite(line["pred_psnr"])


def _tiny(method, seed=0):
    model = MTDGANModel(gen_features=8, disc_features=8, num_layers=1, dropout_rate=0.0,
                        device="cpu", seed=seed)
    return model, MTDGANTrainer(model, method=method, seed=seed)


def _batch(seed):
    x = torch.rand((2, 64, 64, 1), generator=torch.Generator().manual_seed(seed))
    return x, (x + 0.02).clamp(0, 1)


def test_from_pretrained_loads_parameters_with_fresh_optimizers(tmp_path):
    model, trainer = _tiny("pcgrad")
    trainer.train_step(*_batch(0))
    path = str(tmp_path / "epoch_0.pth")
    save_checkpoint(path, model, trainer, 0, argparse.Namespace())
    fresh, fresh_trainer = _tiny("pcgrad", seed=5)
    assert load_pretrained(path, fresh) == 0
    assert any(k.endswith("weight_u") for k in fresh.discriminator.state_dict())
    for a, b in ((model.generator, fresh.generator),
                 (model.discriminator, fresh.discriminator)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    assert not fresh_trainer.opt_g.state and not fresh_trainer.opt_d.state


def test_checkpoint_without_method_state_is_refused_by_resume(tmp_path):
    """A checkpoint written before checkpoints carried the method state
    (no ``mto_*`` keys) is refused with a message naming the warm start,
    which still loads it."""
    model, trainer = _tiny("pcgrad")
    path = str(tmp_path / "epoch_3.pth")
    save_checkpoint(path, model, trainer, 3, argparse.Namespace())
    ckpt = torch.load(path, weights_only=False)
    for key in ("mto_method", "mto_state", "optimizer_mto"):
        del ckpt[key]
    torch.save(ckpt, path)
    fresh, fresh_trainer = _tiny("pcgrad", seed=5)
    with pytest.raises(ValueError, match="no MTO method state.*--from-pretrained"):
        restore(path, fresh, fresh_trainer)
    assert load_pretrained(path, fresh) == 3


@pytest.mark.parametrize("method", ["uw", "dwa", "nashmtl"])
def test_method_state_round_trips_through_a_checkpoint(tmp_path, method):
    """After two steps, save and restore into a fresh trainer: the state (UW's
    log-sigma and its optimizer, DWA's costs, NashMTL's alpha) comes back,
    and a third step from each gives the same state."""
    model, trainer = _tiny(method)
    for s in range(2):
        trainer.train_step(*_batch(s))
    path = str(tmp_path / "epoch_1.pth")
    save_checkpoint(path, model, trainer, 1, argparse.Namespace())
    model2, trainer2 = _tiny(method, seed=9)
    assert restore(path, model2, trainer2) == 1
    fields = {"uw": "logsigma", "dwa": "costs", "nashmtl": "prvs_alpha"}
    assert trainer2.mto_state.step == trainer.mto_state.step == 2
    assert torch.equal(getattr(trainer2.mto_state, fields[method]),
                       getattr(trainer.mto_state, fields[method]))
    if method == "uw":
        assert trainer2.opt_mto.param_groups[0]["params"][0] is trainer2.mto_state.logsigma
        st, st2 = trainer.opt_mto.state_dict()["state"], trainer2.opt_mto.state_dict()["state"]
        assert torch.equal(st[0]["exp_avg"], st2[0]["exp_avg"])
    for t in (trainer, trainer2):
        t.train_step(*_batch(7))
    for f in ("logsigma", "costs", "dwa_weights", "prvs_alpha"):
        a, b = getattr(trainer.mto_state, f), getattr(trainer2.mto_state, f)
        assert (a is None and b is None) or torch.equal(a, b), f
    _, other = _tiny("pcgrad")
    with pytest.raises(ValueError, match="method"):
        restore(path, MTDGANModel(gen_features=8, disc_features=8, num_layers=1,
                                  device="cpu"), other)


def test_uw_learning_rate_follows_the_schedule():
    _, trainer = _tiny("uw")
    trainer.set_epoch_lr(5e-5)
    assert trainer.opt_mto.param_groups[0]["lr"] == pytest.approx(0.025 * 5e-5 / 1e-4)


def test_tensorboard_sink_does_nothing_without_tensorboardx(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # the import fails
    sink = TensorBoardSink(str(tmp_path / "runs"))
    sink.scalars({"loss": 1.0, "epoch": 3, "note": "x"}, 0)
    sink.close()
    assert not (tmp_path / "runs").exists()


def test_profiler_trace_and_step_timer(tmp_path):
    with trace(str(tmp_path / "prof")):
        torch.ones(8).add_(1)
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    with trace("") as prof:
        assert prof is None
    timer = StepTimer()
    for _ in range(3):
        with timer:
            pass
    assert timer.summary()["steps"] == 3


def test_prefetch_passes_host_batches_through_on_the_cpu():
    items = [(np.arange(4).reshape(2, 2), np.ones(3))] * 3
    out = list(prefetch_to_device(items, "cpu"))
    assert len(prefetch_to_device(items, "cpu")) == 3
    assert all(a is b for o, i in zip(out, items) for a, b in zip(o, i))
