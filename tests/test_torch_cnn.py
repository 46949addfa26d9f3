"""The CNN family of the port against the JAX package's: the RED-CNN and
EDCNN forwards, EDCNN's Sobel bank, the compound loss and its gradient,
two ``SupervisedTrainer`` steps, the weight converters both ways, the
reference-layout loads of a flat ``model_state_dict``, the model registry
and family dispatch for every JAX name, and the train and test CLIs on
RED-CNN with the whole-slice ``full`` preset. Small widths (RED-CNN 8,
EDCNN 8 / 8) at 32x32; the weights are numpy draws carried across by the
converters."""

import argparse
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtd_gan_tpu import losses as jax_losses
from mtd_gan_tpu.engine import loops as jax_loops
from mtd_gan_tpu.engine.supervised import SupervisedState
from mtd_gan_tpu.engine.supervised import SupervisedTrainer as JaxTrainer
from mtd_gan_tpu.features import resnet as jax_resnet
from mtd_gan_tpu.models import ALIASES as JAX_ALIASES
from mtd_gan_tpu.models import _REGISTRY as JAX_REGISTRY
from mtd_gan_tpu.models import _ensure_registered
from mtd_gan_tpu.models.edcnn import EDCNNModel as JaxEDCNN
from mtd_gan_tpu.models.edcnn import edcnn_sobel_bank as jax_sobel_bank
from mtd_gan_tpu.models.red_cnn import REDCNNModel as JaxREDCNN
from mtd_gan_tpu.utils.torch_import import convert_edcnn, convert_red_cnn
from mtd_gan_tpu_torch import losses
from mtd_gan_tpu_torch import test as test_cli
from mtd_gan_tpu_torch import train as train_cli
from mtd_gan_tpu_torch.engine import loops
from mtd_gan_tpu_torch.engine.gan import MTDGANTrainer
from mtd_gan_tpu_torch.engine.supervised import SupervisedTrainer
from mtd_gan_tpu_torch.engine.wgan import AdversarialTrainer, DUGANTrainer
from mtd_gan_tpu_torch.features import resnet
from mtd_gan_tpu_torch.features.registry import to_rgb_nchw
from mtd_gan_tpu_torch.models import get_model, get_model_class, resolve_alias
from mtd_gan_tpu_torch.models.edcnn import EDCNNModel, edcnn_sobel_bank
from mtd_gan_tpu_torch.models.red_cnn import REDCNNModel
from mtd_gan_tpu_torch.utils import torch_import
from mtd_gan_tpu_torch.utils.torch_import import (edcnn_state_dict_from_flax,
                                                  load_reference_checkpoint,
                                                  red_cnn_state_dict_from_flax)
from test_torch_feature_helpers import draw_tree
from test_torch_train_helpers import assert_step_matches, data, host, rel, write_dataset

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

SIZE = 32
# name -> (JAX model, port model, flax -> port converter, JAX converter)
MODELS = {
    "RED_CNN": (lambda: JaxREDCNN(out_ch=8), lambda **kw: REDCNNModel(out_ch=8, **kw),
                red_cnn_state_dict_from_flax, convert_red_cnn),
    "EDCNN": (lambda: JaxEDCNN(out_ch=8, sobel_ch=8, use_feature_loss=False),
              lambda **kw: EDCNNModel(out_ch=8, sobel_ch=8, use_feature_loss=False, **kw),
              edcnn_state_dict_from_flax, convert_edcnn),
}


@functools.cache
def _case(name):
    """The JAX model and a numpy-drawn param tree (He-normal kernels, biases
    and the Sobel factor N(0, 0.1^2))."""
    jm = MODELS[name][0]()
    return jm, draw_tree(lambda: jm.init(jax.random.PRNGKey(0), (1, SIZE, SIZE, 1)),
                         {"RED_CNN": 1, "EDCNN": 2}[name])


def _port(name, params, **kw):
    m = MODELS[name][1](device="cpu", **kw)
    m.net.load_state_dict(MODELS[name][2](host(params)), strict=True)
    return m


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_matches_jax(name):
    """NHWC in and out, within 2e-4 of the JAX ``apply``."""
    jm, params = _case(name)
    x, _ = data(0, 2, SIZE)
    want = np.asarray(jax.jit(jm.apply)(params, x))
    got = _port(name, params).predict(torch.tensor(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


@pytest.mark.parametrize("name", list(MODELS))
def test_state_dict_round_trips_through_the_jax_converter(name):
    """flax -> port loads strict; the JAX converter gives the tree back bit
    for bit. EDCNN's state dict has no Sobel bank: its keys are exactly
    those ``convert_edcnn`` reads."""
    _, params = _case(name)
    m = _port(name, params)
    sd = m.net.state_dict()
    assert sorted(sd) == sorted(torch_import.FLAT_REFERENCE_KEYS[name])
    back = MODELS[name][3](sd)
    want = dict(jax.tree_util.tree_flatten_with_path(host(params))[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(want) == set(got)
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], leaf, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("c", [4, 8, 32])
@pytest.mark.parametrize("c_in", [1, 3])
def test_sobel_bank_matches_jax_bit_for_bit(c, c_in):
    want = jax_sobel_bank(3, c, c_in).transpose(3, 2, 0, 1)
    np.testing.assert_array_equal(edcnn_sobel_bank(3, c, c_in), want)
    m = EDCNNModel(out_ch=8, sobel_ch=c, use_feature_loss=False, device="cpu")
    np.testing.assert_array_equal(m.net.conv_sobel.sobel_weight.numpy(),
                                  jax_sobel_bank(3, c, 1).transpose(3, 2, 0, 1))
    assert "conv_sobel.sobel_weight" not in dict(m.net.named_parameters())


def test_compound_loss_and_its_gradient_match_jax():
    """MSE + 0.01 x the mean ResNet50-block feature MSE on one drawn ResNet50
    at 32x32: the value within 1e-4 relative, the gradient w.r.t. ``pred``
    within 5e-2 (max-norm relative), the trunk's parameters untouched."""
    tree = draw_tree(jax_resnet.init_resnet50_params, 50)
    want_fn = jax_losses.make_compound_loss(
        lambda x: jax_resnet.resnet50_block_features(tree, jnp.repeat(x, 3, axis=-1)))
    pred, target = data(3, 2, SIZE)
    want, want_grad = jax.jit(jax.value_and_grad(want_fn))(pred, target)
    trunk = resnet.ResNet50Trunk()
    trunk.load_state_dict(torch_import.resnet50_state_dict_from_flax(tree), strict=True)
    trunk.eval().requires_grad_(False)
    loss = losses.make_compound_loss(lambda x: trunk(to_rgb_nchw(x)))
    p = torch.tensor(pred, requires_grad=True)
    got = loss(p, torch.tensor(target))
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-4 * abs(float(want))
    assert rel(p.grad.numpy(), want_grad) <= 5e-2
    assert all(q.grad is None for q in trunk.parameters())


@functools.cache
def _two_steps(name):
    """Two steps of the JAX ``SupervisedTrainer`` and of the port's from the
    same drawn parameters on the same batch."""
    jm, params = _case(name)
    tr = JaxTrainer(jm)
    state = SupervisedState(params=params, opt_state=tr.tx.init(params),
                            rng=jax.random.PRNGKey(1), step=jnp.zeros((), jnp.int32))
    m = _port(name, params)
    port = SupervisedTrainer(m)
    x, y = data(4, 2, SIZE)
    jax_losses_, port_losses = [], []
    for _ in range(2):
        state, metrics = tr.train_step(state, x, y)
        jax_losses_.append(float(metrics["loss"]))
        port_losses.append(float(port.train_step(torch.tensor(x), torch.tensor(y))["loss"]))
    return params, host(state.params), jax_losses_, m, port_losses


@pytest.mark.parametrize("name", list(MODELS))
def test_two_supervised_steps_match_jax(name):
    """The loss of both steps within 1e-4 relative; the parameters by their
    change from the shared start (``assert_step_matches``)."""
    params, final, jax_l, m, port_l = _two_steps(name)
    np.testing.assert_allclose(port_l, jax_l, rtol=1e-4)
    start = MODELS[name][2](host(params))
    want = MODELS[name][2](final)
    for k, p in m.net.named_parameters():
        assert_step_matches(k, (p.detach() - start[k]).numpy(), (want[k] - start[k]).numpy())


@pytest.mark.parametrize("name", list(MODELS))
def test_reference_flat_checkpoint_loads(tmp_path, name):
    """A flat reference ``model_state_dict`` (DataParallel ``module.``
    prefixes, EDCNN's stored Sobel bank, an ``args`` Namespace): exactly the
    keys the JAX converter reads, loaded ``strict=True``."""
    _, params = _case(name)
    src = _port(name, params)
    sd = {f"module.{k}": v for k, v in src.net.state_dict().items()}
    sd["module.conv_sobel.sobel_weight"] = torch.zeros(8, 1, 3, 3)
    path = tmp_path / "ref.pth"
    torch.save({"model_state_dict": sd, "epoch": 12, "args": argparse.Namespace()}, path)
    epoch, got = load_reference_checkpoint(str(path), "ED_CNN" if name == "EDCNN" else name)
    assert epoch == 12
    m = MODELS[name][1](device="cpu", seed=9)
    m.net.load_state_dict(got, strict=True)
    x = torch.rand(1, SIZE, SIZE, 1)
    torch.testing.assert_close(m.predict(x), src.predict(x), rtol=0, atol=0)
    del sd["module.conv1.bias" if name == "RED_CNN" else "module.conv_p3.weight"]
    torch.save({"model_state_dict": sd}, path)
    with pytest.raises(KeyError, match="missing"):
        load_reference_checkpoint(str(path), name)


def test_registry_and_family_dispatch_cover_every_jax_name():
    """Every name of the JAX registry and its aliases: the same family, and
    it builds (no family is left unported: ``UNPORTED_FAMILIES`` is empty);
    ``build_trainer`` gives each family its trainer (``wgan`` 4 critic
    updates a step, the ablations 1, ``dn`` the supervised trainer); a
    family listed as unported raises in ``run_test``, naming its ROADMAP.md
    item."""
    _ensure_registered()
    names = sorted(set(JAX_REGISTRY) | set(JAX_ALIASES))
    assert len(names) == 26  # 22 models and 4 aliases
    assert loops.UNPORTED_FAMILIES == {}
    args = argparse.Namespace(optimizer="adamw", lr=1e-4, method="pcgrad")
    diffusion = {"channels": (8, 16, 16), "num_head_channels": 16, "norm_groups": 4}
    small = {"RED_CNN": {"out_ch": 8},
             "EDCNN": {"out_ch": 8, "sobel_ch": 8, "use_feature_loss": False},
             "WGAN_VGG": {"use_perceptual": False}, "MAP_NN": {"depth": 1},
             "DU_GAN": {"gen_features": 8, "num_layers": 1, "conv_dim": 8},
             "CTformer": {},
             "Restormer": {"dim": 8, "num_blocks": (1, 1, 1, 1),
                           "num_refinement_blocks": 1},
             "DDPM": diffusion, "DDIM": diffusion, "PNDM": diffusion, "DPM": diffusion}
    want = {"cnn": SupervisedTrainer, "tr": SupervisedTrainer, "mtd": AdversarialTrainer,
            "wgan": AdversarialTrainer, "dugan": DUGANTrainer, "dn": SupervisedTrainer}
    for name in names:
        family = loops.family_of(name)
        assert family == jax_loops.family_of(name), name
        assert get_model_class(name) is get_model_class(resolve_alias(name))
        if name.startswith("Ablation_") and name != "Ablation_CLS":
            continue  # one of the ten builds here; all ten in test_torch_ablations.py
        kw = small.get(resolve_alias(name),
                       {"gen_features": 8, "disc_features": 8, "num_layers": 1})
        trainer = loops.build_trainer(name, get_model(name, device="cpu", **kw), args)
        assert isinstance(trainer, MTDGANTrainer if name in ("MTD_GAN", "MTD_GAN_Method")
                          else want[family]), name
        if family in ("wgan", "mtd") and not isinstance(trainer, MTDGANTrainer):
            assert trainer.n_critic == (4 if family == "wgan" else 1), name
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(loops.UNPORTED_FAMILIES, "dn", 11)
        with pytest.raises(NotImplementedError, match="queue 1, item 11"):
            loops.run_test(None, [], None, "dn", "unused")
    with pytest.raises(KeyError, match="unknown model"):
        get_model_class("RED-CNN")


def test_cli_trains_red_cnn_on_whole_slices_then_tests(tmp_path):
    """``train --model RED_CNN --dataset-type-train full`` (one epoch of two
    96x96 slices in one step), then ``test --resume``: the flat checkpoint
    with one optimizer, finite metrics."""
    data_root = str(tmp_path / "data")
    write_dataset(data_root, {"train": 2, "valid": 1, "test": 2})
    common = ["--device", "cpu", "--data-root", data_root, "--model", "RED_CNN",
              "--model-kwargs", '{"out_ch": 8}']
    ckpt = tmp_path / "ckpt"
    stats = train_cli.main(train_cli.get_args_parser().parse_args(
        common + ["--batch-size", "2", "--epochs", "1", "--dataset-type-train", "full",
                  "--checkpoint-dir", str(ckpt), "--save-dir", str(tmp_path / "pred")]))
    assert np.isfinite(stats["train_loss"]) and np.isfinite(stats["valid_loss"])
    saved = torch.load(ckpt / "epoch_0.pth", weights_only=False)
    assert {"model_state_dict", "optimizer", "scheduler", "epoch", "args"} <= set(saved)
    assert sorted(saved["model_state_dict"]) == sorted(torch_import.FLAT_REFERENCE_KEYS["RED_CNN"])
    summary = test_cli.main(test_cli.get_args_parser().parse_args(
        common + ["--resume", str(ckpt / "epoch_0.pth"), "--no-feature-metrics",
                  "--save-dir", str(tmp_path / "test")]))
    assert np.isfinite(summary["pred_psnr"]) and np.isfinite(summary["pred_ssim"])
