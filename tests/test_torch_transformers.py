"""The transformer family of the port (CTformer, Restormer) and the small
ops of item 10 against the JAX package's: ``unfold`` / ``fold``, the
sinusoid table, the performer and ViT blocks, CTformer at its published
size and Restormer small (forward, loss and gradient in eval mode),
Restormer's pieces (the with-bias LayerNorm, ``pixel_unshuffle``),
``SkipAttentionBlock``, ``SCSEModule``, ``WindowConv2D``, the weight
converters both ways, the reference-layout loads, the ``tr`` family's
``run_test`` on 2 slices at 128x128 against the JAX ``run_test``, and the
train and test CLIs on CTformer. The weights are numpy draws carried across
by the converters; 64x64, batch 2; Restormer at dim 8, blocks (1, 1, 1, 1),
one refinement block."""

import argparse
import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtd_gan_tpu.engine.loops import run_test as jax_run_test
from mtd_gan_tpu.data.transforms import make_eval_preprocess as jax_eval_preprocess
from mtd_gan_tpu.models.ctformer import CTformerModel as JaxCTformer
from mtd_gan_tpu.models.ctformer import TokenPerformer as JaxPerformer
from mtd_gan_tpu.models.ctformer import TransformerBlock as JaxBlock
from mtd_gan_tpu.models.ctformer import sinusoid_encoding as jax_sinusoid
from mtd_gan_tpu.models.restormer import ChannelLayerNorm as JaxLN
from mtd_gan_tpu.models.restormer import RestormerModel as JaxRestormer
from mtd_gan_tpu.models.restormer import pixel_unshuffle as jax_unshuffle
from mtd_gan_tpu.ops.attention import SCSEModule as JaxSCSE
from mtd_gan_tpu.ops.attention import SkipAttentionBlock as JaxSkip
from mtd_gan_tpu.ops.unfold import fold as jax_fold
from mtd_gan_tpu.ops.unfold import unfold as jax_unfold
from mtd_gan_tpu.ops.window_conv import WindowConv2D as JaxWindow
from mtd_gan_tpu.utils.torch_import import convert_ctformer, convert_restormer
from mtd_gan_tpu_torch import test as test_cli
from mtd_gan_tpu_torch import train as train_cli
from mtd_gan_tpu_torch.data.pipeline import PairedDicomDataset, eval_loader
from mtd_gan_tpu_torch.data.transforms import make_eval_preprocess
from mtd_gan_tpu_torch.engine.loops import build_trainer, run_test
from mtd_gan_tpu_torch.engine.supervised import SupervisedTrainer
from mtd_gan_tpu_torch.models import get_model
from mtd_gan_tpu_torch.models.ctformer import (CTformerModel, TokenPerformer,
                                               TransformerBlock, sinusoid_encoding)
from mtd_gan_tpu_torch.models.restormer import ChannelLayerNorm, RestormerModel
from mtd_gan_tpu_torch.ops.attention import SCSEModule, SkipAttentionBlock
from mtd_gan_tpu_torch.ops.unfold import fold, unfold
from mtd_gan_tpu_torch.ops.window_conv import WindowConv2D
from mtd_gan_tpu_torch.utils.checkpoint import restore
from mtd_gan_tpu_torch.utils.torch_import import (_conv_entries, _dense_entries,
                                                  _performer_entries,
                                                  ctformer_state_dict_from_flax,
                                                  load_reference_checkpoint,
                                                  restormer_state_dict_from_flax)
from test_torch_train_helpers import host, nchw, rel, write_dataset

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

ATOL = 1e-5        # forwards and losses, float32 both sides
RTOL_GRAD = 1e-4   # gradients, per leaf
RESTORMER_SMALL = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)
t = torch.tensor


def _draw(shapes, seed):
    """A tree of ``shapes`` drawn with numpy: LayerNorm scales and
    Restormer's temperatures 1 + N(0, 0.1^2), the performers' ``w``
    N(0, 1), kernels N(0, 1/fan_in), biases N(0, 0.01^2)."""
    rng = np.random.default_rng(seed)

    def one(path, s):
        key = getattr(path[-1], "key", "")
        if key in ("scale", "weight", "temperature"):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if key == "w":
            return rng.standard_normal(s.shape).astype(np.float32)
        if len(s.shape) >= 2:
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
                    ).astype(np.float32)
        return (0.01 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


@functools.cache
def _ctformer():
    jm = JaxCTformer()
    params = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 21)
    port = CTformerModel(device="cpu")
    port.net.load_state_dict(ctformer_state_dict_from_flax(host(params)), strict=True)
    return jm, params, port


@functools.cache
def _restormer():
    jm = JaxRestormer(**RESTORMER_SMALL)
    params = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 22)
    port = RestormerModel(**RESTORMER_SMALL, device="cpu")
    port.net.load_state_dict(restormer_state_dict_from_flax(host(params)), strict=True)
    return jm, params, port


@pytest.mark.parametrize("kernel,stride,dilation,size", [
    ((7, 7), (2, 2), (1, 1), 64), ((3, 3), (1, 1), (2, 2), 29), ((3, 3), (1, 1), (1, 1), 25)])
def test_unfold_and_fold_match_jax(kernel, stride, dilation, size):
    """torch's ``nn.Unfold`` / ``nn.Fold`` order (channel-major features,
    row-major positions), overlaps summed by ``fold``."""
    x = np.random.default_rng(1).random((2, size, size, 3), dtype=np.float32)
    want = np.asarray(jax_unfold(jnp.asarray(x), kernel, stride, dilation))
    got = unfold(nchw(x), kernel, stride, dilation)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    back = np.asarray(jax_fold(jnp.asarray(want), (size, size), kernel, stride, dilation))
    np.testing.assert_allclose(fold(got, (size, size), kernel, stride, dilation)
                               .permute(0, 2, 3, 1).numpy(), back, atol=ATOL)


def test_token_blocks_match_jax():
    """The sinusoid table; a performer (its ``w`` carried across) and a ViT
    block in eval, on the same drawn weights. Every LayerNorm of the port's
    CTformer has flax's epsilon, 1e-6, which the JAX package takes; the
    reference's ``nn.LayerNorm`` has 1e-5 (ROADMAP.md queue 3)."""
    np.testing.assert_array_equal(sinusoid_encoding(529, 64), jax_sinusoid(529, 64))
    norms = [m for m in _ctformer()[2].net.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert len(norms) == 11 and {m.eps for m in norms} == {flax.linen.LayerNorm().epsilon}
    assert torch.nn.LayerNorm(4).eps == 1e-5
    x = np.random.default_rng(2).standard_normal((2, 50, 49)).astype(np.float32)
    jp = JaxPerformer(dim=49, in_dim=64)
    params = _draw(jax.eval_shape(lambda k: jp.init(k, x, False), jax.random.PRNGKey(0)), 23)
    port = TokenPerformer(49, 64)
    sd = {}
    _performer_entries(sd, "p", host(params["params"]))
    port.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = port(t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jp.apply(params, x, False)), atol=ATOL)
    x = np.random.default_rng(3).standard_normal((2, 23, 64)).astype(np.float32)
    jb = JaxBlock(64, 8)
    params = _draw(jax.eval_shape(lambda k: jb.init(k, x, False), jax.random.PRNGKey(0)), 24)
    block = TransformerBlock(64, 8)
    p, sd = host(params["params"]), {}
    for name, ref in (("norm1", "norm1"), ("norm2", "norm2")):
        sd[f"{ref}.weight"], sd[f"{ref}.bias"] = t(p[name]["scale"]), t(p[name]["bias"])
    for name, ref in (("qkv", "attn.qkv"), ("proj", "attn.proj"), ("mlp_fc1", "mlp.fc1"),
                      ("mlp_fc2", "mlp.fc2")):
        _dense_entries(sd, ref, p[name])
    block.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = block(t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jb.apply(params, x, False)), atol=ATOL)


def _eval_loss_and_grads(jm, params, port, loss_jax, loss_port):
    """The eval-mode loss and its gradient w.r.t. every parameter on both
    sides; the JAX tree in the port's layout."""
    rng = np.random.default_rng(4)
    x = rng.random((2, 64, 64, 1), dtype=np.float32)
    y = np.clip(x + 0.05 * rng.standard_normal(x.shape), 0, 1).astype(np.float32)
    # jitted: one compile is faster than the model's ops one by one
    want, want_g = jax.jit(jax.value_and_grad(lambda p: loss_jax(jm.apply(p, x), y)))(params)
    port.net.zero_grad()
    got = loss_port(port.apply(t(x)), t(y))
    got.backward()
    return x, float(got.detach()), float(want), want_g


@pytest.mark.parametrize("model", ["CTformer", "Restormer"])
def test_forward_loss_and_gradient_match_jax(model):
    """CTformer at its published configuration and Restormer small, in
    eval: the forward (1e-5), the training loss (CTformer's ``100 * MSE +
    1e-4``, Restormer's L1) and its gradient w.r.t. every parameter (1e-4
    of each leaf's largest entry); CTformer's fixed ``w`` is a buffer."""
    if model == "CTformer":
        jm, params, port = _ctformer()
        loss_jax = lambda p, y: ((p - y) ** 2).mean() * 100.0 + 1e-4
        loss_port = lambda p, y: ((p - y) ** 2).mean() * 100.0 + 1e-4
        to_sd = ctformer_state_dict_from_flax
    else:
        jm, params, port = _restormer()
        loss_jax = lambda p, y: jnp.abs(p - y).mean()
        loss_port = lambda p, y: (p - y).abs().mean()
        to_sd = restormer_state_dict_from_flax
    x, got, want, want_g = _eval_loss_and_grads(jm, params, port, loss_jax, loss_port)
    pred = np.asarray(jax.jit(lambda p, z: jm.apply(p, z))(params, x))
    # held to 1e-5 of the largest output: CTformer's reach ~17 here and its
    # performers' exp() kernels amplify float32 rounding (either framework
    # reads ~1e-4 from float64); Restormer's ~2 (1.03e-5 seen at one pixel)
    np.testing.assert_allclose(port.predict(t(x)).numpy(), pred,
                               atol=ATOL * np.abs(pred).max())
    assert abs(got - want) <= ATOL * max(1.0, abs(want))
    want_sd = to_sd(host(want_g))
    names = dict(port.net.named_parameters())
    assert set(names) | {k for k, _ in port.net.named_buffers() if k.endswith(".w")} == set(
        want_sd)
    for k, p in names.items():
        assert rel(p.grad.numpy(), want_sd[k].numpy()) <= RTOL_GRAD, k
    if model == "CTformer":
        assert all(not b.requires_grad for k, b in port.net.named_buffers() if k.endswith(".w"))
        # the training loss: dropout on, drawn from the caller's generator
        xs, ys = t(x), t(x)
        a = port.loss(xs, ys, generator=torch.Generator().manual_seed(1))[0]
        b = port.loss(xs, ys, generator=torch.Generator().manual_seed(1))[0]
        c = port.loss(xs, ys, generator=torch.Generator().manual_seed(2))[0]
        assert float(a) == float(b) != float(c)
        with pytest.raises(ValueError, match="64x64"):
            port.predict(torch.zeros(1, 32, 32, 1))


def test_restormer_pieces_match_jax():
    """The with-bias ``ChannelLayerNorm`` and the pixel unshuffle."""
    x = np.random.default_rng(5).standard_normal((2, 8, 6, 12)).astype(np.float32)
    jl = JaxLN(bias_free=False)
    params = _draw(jax.eval_shape(jl.init, jax.random.PRNGKey(0), x), 25)
    ln = ChannelLayerNorm(12, bias_free=False)
    ln.load_state_dict({k: t(v) for k, v in host(params["params"]).items()}, strict=True)
    with torch.no_grad():
        got = ln(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(jl.apply(params, x)), atol=ATOL)
    np.testing.assert_array_equal(  # Restormer's downsample: torch's channel order
        torch.nn.PixelUnshuffle(2)(nchw(x)).permute(0, 2, 3, 1).numpy(),
        np.asarray(jax_unshuffle(jnp.asarray(x), 2)))


def _conv_sd(params):
    sd = {}
    for name, p in host(params["params"]).items():
        if "kernel" in p:
            _conv_entries(sd, name, p)
        else:
            sd.update({f"{name}.{k}": t(v) for k, v in p.items()})
    return sd


def test_attention_blocks_and_window_conv_match_jax():
    """``SkipAttentionBlock``, ``SCSEModule`` and ``WindowConv2D`` (its
    presets as drawn, then trained values; both activations)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, 12, 6)).astype(np.float32)
    g = rng.standard_normal((2, 16, 12, 5)).astype(np.float32)
    js = JaxSkip(inter_channels=4)
    params = _draw(jax.eval_shape(js.init, jax.random.PRNGKey(0), x, g), 26)
    skip = SkipAttentionBlock(6, 5, 4)
    skip.load_state_dict(_conv_sd(params), strict=True)
    with torch.no_grad():
        got = skip(nchw(x), nchw(g)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(js.apply(params, x, g)), atol=ATOL)
    jc = JaxSCSE(reduction=2)
    params = _draw(jax.eval_shape(jc.init, jax.random.PRNGKey(0), x), 27)
    scse = SCSEModule(6, reduction=2)
    scse.load_state_dict(_conv_sd(params), strict=True)
    with torch.no_grad():
        got = scse(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(jc.apply(params, x)), atol=ATOL)
    hu = rng.random((2, 8, 8, 1), dtype=np.float32)
    for mode in ("relu", "sigmoid"):
        jw = JaxWindow(mode=mode, out_channels=7)
        params = jw.init(jax.random.PRNGKey(0), hu)
        win = WindowConv2D(1, 7, mode)
        for k, v in host(params["params"]).items():
            np.testing.assert_array_equal(getattr(win, k).detach().numpy(), v)
        params = _draw(jax.eval_shape(jw.init, jax.random.PRNGKey(0), hu), 28)
        win.load_state_dict({k: t(v) for k, v in host(params["params"]).items()})
        with torch.no_grad():
            got = win(nchw(hu)).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, np.asarray(jw.apply(params, hu)), atol=ATOL)
    with pytest.raises(ValueError, match="mode"):
        WindowConv2D(mode="tanh")


@pytest.mark.parametrize("model", ["CTformer", "Restormer"])
def test_state_dicts_round_trip_and_reference_loads(tmp_path, model):
    """flax -> the port's state dict loads strict, and the JAX converter
    gives the tree back bit for bit; a flat reference-layout ``.pth`` with
    DataParallel ``module.`` segments and keys the JAX converter does not
    read (CTformer's ``cls_token``, ``head``, ``pos_embed``) loads through
    ``load_reference_checkpoint`` with the network's keys."""
    if model == "CTformer":
        _, params, port = _ctformer()
        sd = ctformer_state_dict_from_flax(host(params))
        back = convert_ctformer(sd)
        extra = {"cls_token": torch.zeros(1, 1, 64), "pos_embed": torch.zeros(1, 529, 64),
                 "head.weight": torch.zeros(1, 64), "head.bias": torch.zeros(1)}
    else:
        _, params, port = _restormer()
        sd = restormer_state_dict_from_flax(host(params))
        back = convert_restormer(sd, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)
        extra = {}
    want = dict(jax.tree_util.tree_flatten_with_path(host(params))[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(want) == set(got)
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], leaf, err_msg=jax.tree_util.keystr(path))
    path = tmp_path / "ref.pth"
    torch.save({"model_state_dict": {f"module.{k}": v for k, v in {**sd, **extra}.items()},
                "epoch": 4, "args": argparse.Namespace(a=1)}, path)
    with pytest.raises(ValueError, match="keys"):
        load_reference_checkpoint(str(path), model)
    epoch, state = load_reference_checkpoint(str(path), model, keys=port.net.state_dict())
    fresh = get_model(model, **(RESTORMER_SMALL if model == "Restormer" else {}),
                      device="cpu", seed=3)
    fresh.net.load_state_dict(state, strict=True)
    assert epoch == 4
    for k, v in fresh.net.state_dict().items():
        assert torch.equal(v, port.net.state_dict()[k]), k


def test_tr_run_test_matches_jax(tmp_path):
    """The ``tr`` family's sweep (the sliding window at overlap 0.9, 960
    tiles a chunk, ``constant``, one slice a group) on 2 slices at 128x128
    with Restormer small: every pixel column of both summaries (1e-4: a
    sliding-window sum in the chain) and the same rows."""
    jm, params, port = _restormer()
    data = str(tmp_path / "data")
    write_dataset(data, {"test": 2}, size=128)
    items = list(eval_loader(PairedDicomDataset(data, "test"), 1))
    # the JAX sweep pads the last chunk of tiles to its sw_batch: 144 (a
    # slice's tiles at 128^2) gives the same blend without 816 tiles of zeros
    want = jax_run_test(jm, argparse.Namespace(params=params), items,
                        jax_eval_preprocess(), "tr", str(tmp_path / "jax"),
                        compute_fid_metric=False, compute_feature_metrics=False,
                        tr_sw_batch=144)
    got = run_test(port, items, make_eval_preprocess(), "tr", str(tmp_path / "port"),
                   compute_fid_metric=False, compute_feature_metrics=False)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-4 * max(1.0, abs(v)), (k, got[k], v)


def test_cli_trains_resumes_and_tests_ctformer(tmp_path):
    """``train`` (one step on 8 patches of 64x64, validation through the
    sliding window) then ``test --resume`` (the sweep at overlap 0.9); the
    checkpoint holds the performers' ``w``, unchanged by the step, and a
    ``restore`` gives back the model and the optimizer's state."""
    data_root = str(tmp_path / "data")
    write_dataset(data_root, {"train": 1, "valid": 1, "test": 2}, size=80)
    common = ["--device", "cpu", "--data-root", data_root, "--model", "CTformer"]
    ckpt = tmp_path / "ckpt"
    stats = train_cli.main(train_cli.get_args_parser().parse_args(
        common + ["--batch-size", "1", "--epochs", "1", "--checkpoint-dir", str(ckpt),
                  "--save-dir", str(tmp_path / "pred")]))
    assert np.isfinite(stats["train_loss"]) and np.isfinite(stats["valid_loss"])
    saved = torch.load(ckpt / "epoch_0.pth", weights_only=False)
    assert {"optimizer", "epoch", "scheduler"} <= set(saved)
    w_key = "tokens_to_token.attention1.w"
    start = CTformerModel(device="cpu", seed=2024)
    assert torch.equal(saved["model_state_dict"][w_key], start.net.state_dict()[w_key])
    model = get_model("CTformer", device="cpu", seed=5)
    trainer = build_trainer("CTformer", model, train_cli.get_args_parser().parse_args(common))
    assert isinstance(trainer, SupervisedTrainer)
    assert all(p.requires_grad for g in trainer.opt.param_groups for p in g["params"])
    assert restore(str(ckpt / "epoch_0.pth"), model, trainer) == 0
    for k, v in saved["model_state_dict"].items():
        assert torch.equal(model.net.state_dict()[k], v), k
    assert len(trainer.opt.state_dict()["state"]) == len(saved["optimizer"]["state"]) > 0
    summary = test_cli.main(test_cli.get_args_parser().parse_args(
        common + ["--resume", str(ckpt / "epoch_0.pth"), "--no-feature-metrics",
                  "--save-dir", str(tmp_path / "test")]))
    assert np.isfinite(summary["pred_psnr"])
