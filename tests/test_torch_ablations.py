"""The ten MTD-GAN ablations of the port against the JAX package's: every
recipe's ``d_loss`` and ``g_loss`` with their terms, the five head sets'
discriminator outputs, two ``AdversarialTrainer`` steps (the REC quirk,
NDS + RC, and the ResFFT generator on K1 + K2's plain versions), the
weight converters both ways, the reference-layout loads (a whole ablation;
the pure SEG discriminator's ``dconv`` names and dead ``enc_out``), the
flagship discriminator's keys and draws, and the train and test CLIs on an
ablation. Generator 8 / discriminator 8 features, L = 1, 64x64, batch 2,
dropout 0 on both sides; the weights are numpy draws carried across by the
converters."""

import argparse
import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtd_gan_tpu.engine.wgan import AdversarialTrainer as JaxTrainer
from mtd_gan_tpu.engine.wgan import AdvTrainState
from mtd_gan_tpu.models.ablations import ABLATIONS as JAX_ABLATIONS
from mtd_gan_tpu.models.mtd_gan import MultiTaskDiscriminator as JaxDisc
from mtd_gan_tpu.utils.torch_import import convert_ablation
from mtd_gan_tpu_torch import test as test_cli
from mtd_gan_tpu_torch import train as train_cli
from mtd_gan_tpu_torch.engine.wgan import AdversarialTrainer
from mtd_gan_tpu_torch.models.ablations import ABLATIONS
from mtd_gan_tpu_torch.models.mtd_gan import MTDGANModel, MultiTaskDiscriminator
from mtd_gan_tpu_torch.utils.checkpoint import load_model_state_dict, load_pretrained
from mtd_gan_tpu_torch.utils.torch_import import (ablation_state_dict_from_flax,
                                                  discriminator_state_dict_from_flax,
                                                  load_reference_checkpoint)
from test_torch_train_helpers import assert_step_matches, data, host, write_dataset

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

WIDTH = dict(gen_features=8, disc_features=8, num_layers=1)
ATOL = 2e-4
HEAD_SETS = [("cls",), ("seg",), ("cls", "seg"), ("cls", "rec"), ("seg", "rec")]


def _draw(shapes, seed):
    """A tree of ``shapes`` drawn with numpy: kernels N(0, 1/fan_in), biases
    N(0, 0.01^2), spectral-norm ``u`` unit vectors."""
    rng = np.random.default_rng(seed)

    def one(path, s):
        if getattr(path[-1], "key", "") == "u":
            v = rng.standard_normal(s.shape)
            return (v / np.linalg.norm(v)).astype(np.float32)
        if len(s.shape) >= 2:
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
                    ).astype(np.float32)
        return (0.01 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


@functools.cache
def _jax_recipe(name):
    """The JAX recipe at test width, dropout 0, and numpy-drawn variables."""
    jm = JAX_ABLATIONS[name](**WIDTH, dtype=jnp.float32)
    jm.Discriminator = JaxDisc(features=8, heads=jm.heads, dropout_rate=0.0,
                               dtype=jnp.float32)
    return jm, _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 1)


def _port(name, gv):
    m = ABLATIONS[name](**WIDTH, dropout_rate=0.0, device="cpu")
    load_model_state_dict(m, ablation_state_dict_from_flax(
        host(gv.params_g), host(gv.params_d), host(gv.state_d)))
    return m


def _u(model):
    return {n[:-len(".weight_u")]: b.numpy() for n, b in
            model.discriminator.named_buffers() if n.endswith(".weight_u")}


@pytest.mark.parametrize("name", list(JAX_ABLATIONS))
def test_recipe_losses_match_jax(name):
    """``d_loss`` (its pair pass and RC's storing a power iteration each),
    then ``g_loss`` on the updated ``u``: totals, the terms' keys and
    values within 2e-4, and the ``u`` vectors after both within 1e-5."""
    jm, gv = _jax_recipe(name)
    x, y = data(0, 2)
    # op by op: after the first recipes every op is compiled, faster than a
    # jit of each recipe
    d, (sp, d_det) = jm.d_loss(gv.params_d, gv.params_g, gv.state_d,
                               jax.random.PRNGKey(1), x, y)
    g, (sp, g_det) = jm.g_loss(gv.params_g, gv.params_d, sp, jax.random.PRNGKey(2), x, y)
    d, d_det, g, g_det, sp = host((d, d_det, g, g_det, sp))
    m = _port(name, gv)
    xt, yt = torch.tensor(x), torch.tensor(y)
    with torch.no_grad():
        pd, pd_det = m.d_loss(xt, yt, m.generate(xt))
        pg, pg_det = m.g_loss_terms(m.train_forward(xt), xt, yt)
    for want, got in ((d_det, pd_det), (g_det, pg_det)):
        assert sorted(want) == sorted(got)
        for k, v in want.items():
            assert abs(float(got[k]) - float(v)) <= ATOL, (k, float(got[k]), v)
    assert abs(float(pd) - float(d)) <= ATOL and abs(float(pg) - float(g)) <= ATOL
    u = _u(m)
    for layer, s in sp.items():
        np.testing.assert_allclose(u[layer], s["u"], atol=1e-5, err_msg=layer)


@pytest.mark.parametrize("heads", HEAD_SETS)
def test_head_set_outputs_match_jax(heads):
    """The five partial discriminators' outputs (eval, no stored power
    iteration) within 2e-4, in (cls, seg, rec) order; one head gives its
    tensor alone."""
    jd = JaxDisc(features=8, heads=heads, dropout_rate=0.0, dtype=jnp.float32)
    x = np.random.default_rng(5).random((2, 64, 64, 1), dtype=np.float32)
    variables = _draw(jax.eval_shape(functools.partial(jd.init, train=False),
                                     jax.random.PRNGKey(0), x), 2)
    want = jd.apply(variables, x, train=False, update_stats=False)
    port = MultiTaskDiscriminator(1, 8, 0.0, heads=heads)
    port.load_state_dict(discriminator_state_dict_from_flax(
        host(variables["params"]), host(variables["spectral"])), strict=True)
    with torch.no_grad():
        got = port(torch.tensor(x).permute(0, 3, 1, 2), train=False, update_stats=False)
    if len(heads) == 1:
        assert isinstance(got, torch.Tensor)
        got, want = (got,), (want,)
    assert len(got) == len(want) == len(heads)
    for g, w in zip(got, want):
        g = g.permute(0, 2, 3, 1) if g.dim() == 4 else g
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@functools.cache
def _two_steps(name):
    """Two steps of the JAX ``AdversarialTrainer(n_critic=1)`` and of the
    port's from the same drawn state, on the same batch."""
    jm, gv = _jax_recipe(name)
    tr = JaxTrainer(jm, n_critic=1)
    tr._step_fn = tr._build_step()
    state = AdvTrainState(params_g=gv.params_g, params_d=gv.params_d, state_d=gv.state_d,
                          opt_g=tr.tx_g.init(gv.params_g), opt_d=tr.tx_d.init(gv.params_d),
                          rng=jax.random.PRNGKey(3), step=jnp.zeros((), jnp.int32))
    m = _port(name, gv)
    port = AdversarialTrainer(m, n_critic=1)
    x, y = data(1, 2)
    jax_metrics, port_metrics = [], []
    for _ in range(2):
        state, metrics = tr.train_step(state, x, y)
        jax_metrics.append(host(metrics))
        port_metrics.append({k: float(v) for k, v in
                             port.train_step(torch.tensor(x), torch.tensor(y)).items()})
    return gv, host(state), jax_metrics, m, port_metrics


STEP_RECIPES = ["Ablation_CLS_REC", "Ablation_CLS_SEG_REC_NDS_RC",
                "Ablation_CLS_SEG_REC_NDS_RC_ResFFT"]


@pytest.mark.parametrize("name", STEP_RECIPES)
def test_two_steps_match_jax_losses(name):
    """Every metric of both steps within 2e-4 (the second step runs on the
    parameters and ``u`` the first one produced)."""
    _, _, jax_metrics, _, port_metrics = _two_steps(name)
    for want, got in zip(jax_metrics, port_metrics):
        assert sorted(want) == sorted(got)
        for k, v in want.items():
            assert abs(got[k] - float(v)) <= ATOL, (k, got[k], v)


@pytest.mark.parametrize("name", STEP_RECIPES)
def test_two_steps_match_jax_parameters(name):
    """Generator and discriminator parameters by their change from the
    shared start (the rule of ``assert_step_matches``), and the
    spectral-norm ``u`` within 2e-3."""
    gv, state, _, m, _ = _two_steps(name)
    start = ablation_state_dict_from_flax(host(gv.params_g), host(gv.params_d),
                                          host(gv.state_d))
    final = ablation_state_dict_from_flax(state.params_g, state.params_d, state.state_d)
    port = {f"Generator.{k}": p for k, p in m.generator.named_parameters()}
    port.update({f"Discriminator.{k}": p for k, p in m.discriminator.named_parameters()})
    assert set(port) <= set(final)
    for k, p in port.items():
        assert_step_matches(k, (p.detach() - start[k]).numpy(), (final[k] - start[k]).numpy())
    u = _u(m)
    for layer, s in state.state_d.items():
        np.testing.assert_allclose(u[layer], s["u"], atol=2e-3, err_msg=layer)


@pytest.mark.parametrize("name", ["Ablation_SEG_REC", "Ablation_CLS_SEG_REC_NDS_RC_ResFFT"])
def test_state_dict_round_trips_through_the_jax_converter(name):
    """flax -> the port's ``model_state_dict`` loads strict, and the JAX
    ``convert_ablation`` gives the flax tree back bit for bit."""
    jm, gv = _jax_recipe(name)
    sd = ablation_state_dict_from_flax(host(gv.params_g), host(gv.params_d), host(gv.state_d))
    m = _port(name, gv)
    back = convert_ablation(sd, heads=jm.heads, resfft="ResFFT" in name, num_layers=1)
    for field in ("params_g", "params_d", "state_d"):
        want = dict(jax.tree_util.tree_flatten_with_path(host(getattr(gv, field)))[0])
        got = dict(jax.tree_util.tree_flatten_with_path(back[field])[0])
        assert set(want) == set(got), field
        for path, leaf in want.items():
            np.testing.assert_array_equal(got[path], leaf, err_msg=jax.tree_util.keystr(path))
    assert set(m.discriminator.state_dict()) == {k[len("Discriminator."):] for k in sd
                                                if k.startswith("Discriminator.")}


def test_reference_ablation_checkpoints_load(tmp_path):
    """A reference-layout ablation ``.pth`` (DataParallel ``module.``
    segments, an ``args`` Namespace): the test CLI's generator load and the
    whole-model warm start. A pure SEG_Discriminator state dict with its
    ``dconv`` names and the dead ``enc_out`` loads into ``Ablation_SEG``,
    which has no ``enc_out`` to step."""
    name = "Ablation_CLS_SEG_REC_NDS_RC"
    _, gv = _jax_recipe(name)
    src = _port(name, gv)
    sd = {k.replace("Generator.", "Generator.module."): v for k, v in
          ablation_state_dict_from_flax(host(gv.params_g), host(gv.params_d),
                                        host(gv.state_d)).items()}
    path = tmp_path / "abl.pth"
    torch.save({"model_state_dict": sd, "epoch": 7, "args": argparse.Namespace(x=1)}, path)
    epoch, gen = load_reference_checkpoint(str(path), name)
    m = ABLATIONS[name](**WIDTH, device="cpu", seed=5)
    m.generator.load_state_dict(gen, strict=True)
    assert epoch == 7 == load_pretrained(str(path), m)
    for a, b in ((m.generator, src.generator), (m.discriminator, src.discriminator)):
        for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(v, w), k

    seg = ABLATIONS["Ablation_SEG"](**WIDTH, dropout_rate=0.0, device="cpu", seed=1)
    ref = {("dconv" + k[len("s_dconv"):] if k.startswith("s_dconv") else k): v
           for k, v in seg.discriminator.state_dict().items()}
    ref["enc_out.weight"], ref["enc_out.bias"] = torch.zeros(1, 64), torch.zeros(1)
    torch.save({"model_state_dict": {
        **{f"Generator.{k}": v for k, v in seg.generator.state_dict().items()},
        **{f"Discriminator.{k}": v for k, v in ref.items()}}, "epoch": 1}, tmp_path / "seg.pth")
    loaded = ABLATIONS["Ablation_SEG"](**WIDTH, dropout_rate=0.0, device="cpu", seed=2)
    load_pretrained(str(tmp_path / "seg.pth"), loaded)
    x = torch.rand(2, 1, 64, 64)
    with torch.no_grad():
        torch.testing.assert_close(loaded.discriminator(x, False, False),
                                   seg.discriminator(x, False, False), rtol=0, atol=0)
    assert not any(k.startswith("enc_out") for k, _ in loaded.discriminator.named_parameters())


def test_flagship_discriminator_keeps_its_keys_and_draws():
    """The default heads build the flagship's module as before head subsets
    existed: the same state-dict keys in the same order, the same seeded
    values, and the same outputs (digests and sums of the module as it was)."""
    m = MTDGANModel(gen_features=8, disc_features=8, num_layers=1, device="cpu", seed=0)
    sd = m.discriminator.state_dict()
    assert len(sd) == 198
    assert hashlib.sha256("\n".join(sd).encode()).hexdigest() == (
        "2cc472d532d70477a7eb0a9f2b77586ecd162d0f47f9f830643108cb1e168004")
    digest = hashlib.sha256()
    for v in sd.values():
        digest.update(v.numpy().tobytes())
    assert digest.hexdigest() == (
        "2bbaea0b1955279fe0753c5cd0013733f100de76832d42def2de87a53bfc3ba7")
    x = torch.tensor(np.random.default_rng(0).random((2, 64, 64, 1), dtype=np.float32))
    with torch.no_grad():
        outs = m.discriminator(x.permute(0, 3, 1, 2), train=False, update_stats=False)
    np.testing.assert_allclose([float(o.double().sum()) for o in outs],
                               [-1.310159359491081e-05, -0.6259045551127329,
                                3.136542242495672], rtol=1e-6, atol=1e-9)


def test_cli_trains_and_tests_an_ablation(tmp_path, capsys):
    """``train`` (one epoch of one step, ``window_patch``, ``--method``
    noted and not used) then ``test --resume`` on ``Ablation_CLS_REC``: the
    checkpoint holds ``Generator.*`` / ``Discriminator.*`` and both
    optimizers, no method state; whole-slice presets refuse."""
    data_root = str(tmp_path / "data")
    write_dataset(data_root, {"train": 2, "valid": 1, "test": 2})
    mk = '{"gen_features": 8, "disc_features": 8, "num_layers": 1}'
    common = ["--device", "cpu", "--data-root", data_root, "--model", "Ablation_CLS_REC",
              "--model-kwargs", mk]
    ckpt = tmp_path / "ckpt"
    stats = train_cli.main(train_cli.get_args_parser().parse_args(
        common + ["--batch-size", "2", "--epochs", "1", "--method", "pcgrad",
                  "--checkpoint-dir", str(ckpt), "--save-dir", str(tmp_path / "pred")]))
    assert "--method pcgrad is not used" in capsys.readouterr().out
    assert np.isfinite(stats["train_d_loss"]) and np.isfinite(stats["valid_loss"])
    saved = torch.load(ckpt / "epoch_0.pth", weights_only=False)
    assert {"optimizer_G", "optimizer_D", "epoch"} <= set(saved)
    assert "mto_method" not in saved
    assert "Discriminator.r_up1.upsample.0.weight" in saved["model_state_dict"]
    summary = test_cli.main(test_cli.get_args_parser().parse_args(
        common + ["--resume", str(ckpt / "epoch_0.pth"), "--no-feature-metrics",
                  "--save-dir", str(tmp_path / "test")]))
    assert np.isfinite(summary["pred_psnr"])
    with pytest.raises(ValueError, match="64x64"):
        train_cli.main(train_cli.get_args_parser().parse_args(
            common + ["--batch-size", "2", "--epochs", "1", "--dataset-type-train", "full",
                      "--checkpoint-dir", str(tmp_path / "full")]))
