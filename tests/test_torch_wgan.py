"""The WGAN family of the port (WGAN-VGG, MAP-NN, DU-GAN) against the JAX
package's: the Sobel magnitude, ``msfr_loss`` (its axes), the VGG19
perceptual loss and its gradient, the gradient penalty on given draws
(and the linear critic's closed form), the networks' forwards, the U-Net
discriminator's ``u`` after one and four train-mode forwards, the CutMix
mask on given draws, every model's D and G losses, the weight converters
both ways, the reference-layout loads, and the train and test CLIs on
WGAN_VGG and DU_GAN (the train steps against the JAX trainers are in
``test_torch_wgan_steps.py``). The weights are numpy draws carried across
by the converters; 64x64, batch 2; the DU-GAN U-Nets at conv_dim 8
(repeat_num 6), its generator at 8 features, L = 1."""

import argparse
import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtd_gan_tpu.losses import make_vgg_loss as jax_vgg_loss
from mtd_gan_tpu.losses import msfr_loss as jax_msfr
from mtd_gan_tpu.models.dugan import cutmix_mask as jax_cutmix
from mtd_gan_tpu.models.map_nn import CPCE2D as JaxCPCE
from mtd_gan_tpu.models.wgan_vgg import wgan_gradient_penalty as jax_gp
from mtd_gan_tpu.ops.filters import sobel_magnitude as jax_sobel
from mtd_gan_tpu.utils.torch_import import convert_dugan, convert_map_nn, convert_wgan_vgg
from mtd_gan_tpu_torch import test as test_cli
from mtd_gan_tpu_torch import train as train_cli
from mtd_gan_tpu_torch.engine.loops import build_trainer
from mtd_gan_tpu_torch.engine.wgan import AdversarialTrainer, DUGANTrainer
from mtd_gan_tpu_torch.features.registry import get_extractor, to_rgb_nchw
from mtd_gan_tpu_torch.losses import get_loss, l1, make_vgg_loss, msfr_loss
from mtd_gan_tpu_torch.models import get_model
from mtd_gan_tpu_torch.models.dugan import DUGANModel, cutmix_mask
from mtd_gan_tpu_torch.models.map_nn import CPCE2D, MAPNNModel
from mtd_gan_tpu_torch.models.wgan_vgg import WGANVGGModel, wgan_gradient_penalty
from mtd_gan_tpu_torch.ops.filters import sobel_magnitude
from mtd_gan_tpu_torch.utils.checkpoint import load_pretrained, networks, restore
from mtd_gan_tpu_torch.utils.torch_import import load_reference_checkpoint
from test_torch_train_helpers import (assert_tree_close, critic_pair, critic_state_dict, cutmix_draws, data,
                                      draw_variables, dugan_pair, dugan_port, dugan_state_dict,
                                      host, losses_close, nchw, u_buffers, unet_u, vgg_pair,
                                      write_dataset)

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

ATOL = 1e-5          # forwards and losses, float32 both sides
ATOL_VGG = 1e-4      # a VGG19 in the chain
RTOL_GRAD = 1e-4     # gradients, per leaf
# the published U-Net depth (six 2x downsamplings of 64x64) at narrow widths
DUGAN_WIDTH = (("gen_features", 8), ("num_layers", 1), ("conv_dim", 8), ("repeat_num", 6))
t = torch.tensor


@pytest.mark.parametrize("eps", [1e-6, 1e-4])
def test_sobel_magnitude_matches_jax(eps):
    x = np.random.default_rng(0).random((2, 32, 40, 3), dtype=np.float32)
    want = np.asarray(jax_sobel(jnp.asarray(x), eps=eps))
    got = sobel_magnitude(nchw(x), eps).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("channels", [1, 3])
def test_msfr_loss_takes_all_axes_of_nhwc(channels):
    """``rfftn`` over N, H, W and C with the real half on C, as
    ``jnp.fft.rfftn`` takes an NHWC array: the JAX value, numpy's in
    float64, the criterion table's entry; NCHW (the half on W) differs."""
    rng = np.random.default_rng(channels)
    p, q = (rng.random((2, 16, 12, channels), dtype=np.float32) for _ in range(2))
    want = float(jax_msfr(jnp.asarray(p), jnp.asarray(q)))
    f64 = np.abs(np.fft.rfftn(p.astype(np.float64)) - np.fft.rfftn(q.astype(np.float64)))
    got = float(msfr_loss(t(p), t(q)))
    assert abs(got - want) <= ATOL * abs(want) and abs(got - f64.mean()) <= ATOL * f64.mean()
    assert get_loss("MSFR Loss") is msfr_loss
    nchw = float(msfr_loss(t(p).permute(0, 3, 1, 2), t(q).permute(0, 3, 1, 2)))
    assert abs(nchw - want) > 1e-3 * want


def test_vgg_loss_and_its_gradient_match_jax():
    """The five-slice loss and its gradient w.r.t. ``x`` within 1e-4; the
    registry's VGG19 behind the default loss takes no gradient. ``x`` and
    ``y`` differ everywhere: where a feature of both is equal, the L1's
    subgradient is 0 here (torch's, the reference's) and 1 in JAX
    (``test_l1_subgradient_at_ties``)."""
    vgg = vgg_pair()
    rng = np.random.default_rng(5)
    x, y = (rng.random((2, 64, 64, 1), dtype=np.float32) for _ in range(2))
    want, want_g = jax.value_and_grad(jax_vgg_loss(vgg["jax_slices"]))(jnp.asarray(x),
                                                                         jnp.asarray(y))
    xt = t(x).requires_grad_(True)
    got = make_vgg_loss(vgg["slices"])(xt, t(y))
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= ATOL_VGG * abs(float(want))
    # the gradient against the same trunk in float64: the port's reads
    # ~5e-7 (relative 2-norm), the JAX package's ~7.5e-3 on this input (its
    # VJP through the max pools; ROADMAP.md queue 3), so the port is held
    # to float64 at 1e-5 and to JAX at 1e-2
    trunk64 = copy.deepcopy(vgg["trunk"]).double()
    x64 = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    make_vgg_loss(lambda z: trunk64(to_rgb_nchw(z)))(
        x64, torch.tensor(y, dtype=torch.float64)).backward()
    rel2 = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    assert rel2(xt.grad.numpy(), x64.grad.numpy()) <= 1e-5
    assert rel2(xt.grad.numpy(), np.asarray(want_g)) <= 1e-2
    xt = t(x[:1, :32, :32]).requires_grad_(True)
    make_vgg_loss(device="cpu")(xt, t(y[:1, :32, :32])).backward()
    trunk = get_extractor("vgg19", "cpu")
    assert xt.grad is not None and all(not p.requires_grad and p.grad is None
                                       for p in trunk.parameters())


def test_l1_subgradient_at_ties():
    """``|a - b|`` at ``a == b``: torch's (and the reference's ``F.l1_loss``)
    gradient is 0, ``jnp.abs``'s 1, so the JAX package's L1 losses push
    where a prediction equals its target (ROADMAP.md queue 3). The port
    keeps torch's."""
    a = torch.zeros(4, requires_grad=True)
    l1(a, torch.zeros(4)).backward()
    assert torch.equal(a.grad, torch.zeros(4))
    from mtd_gan_tpu.losses import l1 as jax_l1
    np.testing.assert_array_equal(jax.grad(jax_l1)(jnp.zeros(4), jnp.zeros(4)), 0.25)


def test_gradient_penalty_matches_jax_on_given_draws():
    """The GP of the drawn critic at the JAX key's ``a`` and its gradient
    w.r.t. every critic parameter; the linear critic's closed form
    ``10 (sqrt(64) - 1)^2``."""
    jm, gv, port = critic_pair("WGAN_VGG")
    x, y = data(6, 2)
    fake = np.asarray(jm.generate(gv.params_g, x))
    key = jax.random.PRNGKey(7)
    a = np.asarray(jax.random.uniform(key, (2, 1, 1, 1), jnp.float32))
    gp_fn = lambda pd: jax_gp(lambda z: jm._d(pd, z), key, y, fake)
    want, want_g = jax.value_and_grad(gp_fn)(gv.params_d)
    got = wgan_gradient_penalty(port.critic, t(y), t(fake), t(a))
    params = dict(port.discriminator.named_parameters())
    # fc2's bias leaves the input gradient unchanged: no gradient (JAX: 0)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        params.values(), torch.autograd.grad(got, list(params.values()), allow_unused=True))]
    assert abs(float(got.detach()) - float(want)) <= ATOL * max(1.0, abs(float(want)))
    want_sd = critic_state_dict("WGAN_VGG", gv.params_g, want_g)
    assert_tree_close({f"Discriminator.{k}": g.numpy() for k, g in zip(params, grads)},
                      {k: v.numpy() for k, v in want_sd.items()
                       if k.startswith("Discriminator.")}, RTOL_GRAD, "gp grad")
    lin = wgan_gradient_penalty(lambda z: z.sum((1, 2, 3)), torch.zeros(2, 4, 4, 4),
                                torch.ones(2, 4, 4, 4), torch.rand(2, 1, 1, 1))
    np.testing.assert_allclose(float(lin), 10 * (np.sqrt(64) - 1) ** 2, rtol=1e-5)


@pytest.mark.parametrize("name", ["WGAN_VGG", "MAP_NN"])
def test_critic_models_forward_match_jax(name):
    """Generator and critic outputs; the critic refuses any size but 64."""
    jm, gv, port = critic_pair(name)
    x, _ = data(8, 2)
    np.testing.assert_allclose(port.generate(t(x)).numpy(),
                               np.asarray(jm.generate(gv.params_g, x)), atol=ATOL)
    with torch.no_grad():
        got = port.critic(t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm._d(gv.params_d, x)), atol=ATOL)
    with pytest.raises(ValueError, match="64x64"):
        port.critic(torch.zeros(1, 32, 32, 1))


def test_cpce_module_matches_jax():
    """One CPCE_2D module (the generator applies it five times, tied)."""
    cpce = JaxCPCE()
    x = np.random.default_rng(9).random((2, 40, 36, 1), dtype=np.float32)
    params = draw_variables(jax.eval_shape(cpce.init, jax.random.PRNGKey(0), x), 10)
    port = CPCE2D()
    sd = critic_state_dict("MAP_NN", {"CPCE_2D": params["params"]},
                           critic_pair("MAP_NN")[1].params_d)
    port.load_state_dict({k[len("Generator.CPCE_2D."):]: v for k, v in sd.items()
                          if k.startswith("Generator.")}, strict=True)
    with torch.no_grad():
        got = port(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(cpce.apply(params, x)), atol=ATOL)


@pytest.mark.parametrize("n_forwards", [1, 4])
def test_unet_outputs_and_u_match_jax(n_forwards):
    """The image U-Net's two heads after ``n_forwards`` train-mode forwards,
    and every spectral-norm ``u`` then."""
    jm, v, _ = dugan_pair(DUGAN_WIDTH)
    x, _ = data(11, 2)
    sp = v["state_img_d"]
    disc = dugan_port(dict(DUGAN_WIDTH), v)
    # jitted: one compile is faster than the U-Net's ops one by one
    apply = jax.jit(lambda variables, z: jm.Image_Discriminator.apply(
        variables, z, update_stats=True, mutable=["spectral"]))
    for _ in range(n_forwards):
        (want_enc, want_dec), mut = apply({"params": v["params_img_d"], "spectral": sp}, x)
        sp = mut["spectral"]
        with torch.no_grad():
            enc, dec = disc.image_discriminator(nchw(x), update_stats=True)
    np.testing.assert_allclose(enc.numpy(), np.asarray(want_enc), atol=ATOL)
    np.testing.assert_allclose(dec.permute(0, 2, 3, 1).numpy(), np.asarray(want_dec),
                               atol=ATOL)
    want_u = unet_u(v["params_img_d"], sp)
    got_u = u_buffers(disc.image_discriminator)
    assert set(got_u) == set(want_u)
    for k in want_u:
        np.testing.assert_allclose(got_u[k], want_u[k], atol=ATOL, err_msg=k)


@pytest.mark.parametrize("seed", range(4))
def test_cutmix_mask_matches_jax_on_given_draws(seed):
    key = jax.random.PRNGKey(seed)
    r_mask = jax.random.split(key)[1]
    want = np.asarray(jax_cutmix(r_mask, (2, 64, 48, 1)))
    d = cutmix_draws(key)
    got = cutmix_mask((2, 64, 48, 1), d.lam, d.cx, d.cy)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() <= want.size


@pytest.mark.parametrize("name", ["WGAN_VGG", "MAP_NN"])
def test_critic_model_losses_match_jax(name):
    """``d_loss`` at the JAX key's GP draw and ``g_loss_terms``, with their
    terms (WGAN-VGG's perceptual term through the drawn VGG19)."""
    jm, gv, port = critic_pair(name)
    x, y = data(12, 2)
    key = jax.random.PRNGKey(13)
    fake = jm.generate(gv.params_g, x)
    d, (_, d_det) = jm.d_loss(gv.params_d, gv.params_g, gv.state_d, key, x, y, fake=fake)
    g, (_, g_det) = jm.g_loss_terms(fake, gv.params_d, gv.state_d, key, x, y)
    a = t(np.asarray(jax.random.uniform(key, (2, 1, 1, 1), jnp.float32)))
    fk = port.generate(t(x))
    pd, pd_det = port.d_loss(t(x), t(y), fk, draws=a)
    with torch.no_grad():
        pg, pg_det = port.g_loss_terms(fk, t(x), t(y))
    tol = ATOL_VGG if name == "WGAN_VGG" else ATOL
    losses_close({**pd_det, "total": pd}, {**host(d_det), "total": d}, ATOL, "d")
    losses_close({**pg_det, "total": pg}, {**host(g_det), "total": g}, tol, "g")


def test_dugan_losses_and_u_match_jax():
    """Both domain losses (coin drawn from the JAX keys, the CutMix forward
    run whatever it says) and the G loss on the updated ``u``, with their
    terms; every ``u`` after the three losses."""
    jm, v, _ = dugan_pair(DUGAN_WIDTH)
    model = dugan_port(dict(DUGAN_WIDTH), v)
    x, y = data(14, 2)
    k_img, k_grad, k_g = jax.random.split(jax.random.PRNGKey(15), 3)
    fake = jm.generate(v["params_g"], x)
    di, (sp_i, di_det) = jm.image_d_loss(v["params_img_d"], v["params_g"], v["state_img_d"],
                                         k_img, x, y, fake=fake)
    dg, (sp_g, dg_det) = jm.grad_d_loss(v["params_grad_d"], v["params_g"],
                                        v["state_grad_d"], k_grad, x, y, fake=fake)
    g, (sp_i, sp_g, g_det) = jm.g_loss_terms(fake, v["params_img_d"], v["params_grad_d"],
                                             sp_i, sp_g, k_g, x, y)
    fk = model.generate(t(x))
    with torch.no_grad():
        pi, pi_det = model.image_d_loss(t(x), t(y), fk, draws=cutmix_draws(k_img))
        pgr, pgr_det = model.grad_d_loss(t(x), t(y), fk, draws=cutmix_draws(k_grad))
        pg, pg_det = model.g_loss_terms(fk, t(x), t(y))
    losses_close({**pi_det, "t": pi}, {**host(di_det), "t": di}, ATOL, "img")
    losses_close({**pgr_det, "t": pgr}, {**host(dg_det), "t": dg}, ATOL, "grad")
    losses_close({**pg_det, "t": pg}, {**host(g_det), "t": g}, ATOL, "g")
    for disc, params, sp in ((model.image_discriminator, v["params_img_d"], sp_i),
                             (model.grad_discriminator, v["params_grad_d"], sp_g)):
        want, got = unet_u(params, sp), u_buffers(disc)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name", ["WGAN_VGG", "MAP_NN", "DU_GAN"])
def test_state_dicts_round_trip_through_the_jax_converters(name):
    """flax -> the port's ``model_state_dict`` loads strict into every
    network, and the JAX converter gives the flax trees back bit for bit."""
    if name == "DU_GAN":
        _, v, port = dugan_pair(DUGAN_WIDTH)
        sd = dugan_state_dict(v)
        back = convert_dugan(sd, num_layers=1, repeat_num=6)
        fields = {k: v[k] for k in back}
    else:
        _, gv, port = critic_pair(name)
        sd = critic_state_dict(name, gv.params_g, gv.params_d)
        back = (convert_wgan_vgg if name == "WGAN_VGG" else convert_map_nn)(sd)
        fields = {"params_g": gv.params_g, "params_d": gv.params_d}
    assert set(sd) == {p + k for p, m in networks(port).items() for k in m.state_dict()}
    for field, tree in fields.items():
        want = dict(jax.tree_util.tree_flatten_with_path(host(tree))[0])
        got = dict(jax.tree_util.tree_flatten_with_path(back[field])[0])
        assert set(want) == set(got), field
        for path, leaf in want.items():
            np.testing.assert_array_equal(got[path], leaf, err_msg=jax.tree_util.keystr(path))


def test_reference_checkpoints_load(tmp_path):
    """Reference-layout ``.pth`` files (DataParallel ``module.`` segments, an
    ``args`` Namespace): the test CLI's generator load of each model, and
    DU-GAN's whole-model warm start (both U-Nets with their ``u``)."""
    for name in ("WGAN_VGG", "MAP_NN", "DU_GAN"):
        if name == "DU_GAN":
            _, v, src = dugan_pair(DUGAN_WIDTH)
            sd = dugan_state_dict(v)
        else:
            _, gv, src = critic_pair(name)
            sd = critic_state_dict(name, gv.params_g, gv.params_d)
        sd = {k.replace("Generator.", "Generator.module."): w for k, w in sd.items()}
        path = tmp_path / f"{name}.pth"
        torch.save({"model_state_dict": sd, "epoch": 3, "args": argparse.Namespace(a=1)}, path)
        epoch, gen = load_reference_checkpoint(str(path), name)
        kw = dict(DUGAN_WIDTH) if name == "DU_GAN" else {}
        m = {"WGAN_VGG": WGANVGGModel, "MAP_NN": MAPNNModel, "DU_GAN": DUGANModel}[name](
            **kw, device="cpu", seed=9)
        m.generator.load_state_dict(gen, strict=True)
        assert epoch == 3 == load_pretrained(str(path), m)
        for prefix, module in networks(m).items():
            for k, w in module.state_dict().items():
                assert torch.equal(w, networks(src)[prefix].state_dict()[k]), (name, k)


@pytest.mark.parametrize("name", ["WGAN_VGG", "DU_GAN"])
def test_cli_trains_resumes_and_tests(tmp_path, name):
    """``train`` (one epoch of one step, ``window_patch``, validation; the
    trainer the family takes: 4 critic updates for WGAN-VGG, three
    optimizers for DU-GAN) then ``test --resume``; the checkpoint's
    networks and optimizers, and a ``restore`` into a fresh model and
    trainer that gives back the same state."""
    data_root = str(tmp_path / "data")
    write_dataset(data_root, {"train": 1, "valid": 1, "test": 2})
    kw = '{"gen_features": 8, "num_layers": 1, "conv_dim": 8}' if name == "DU_GAN" else ""
    common = ["--device", "cpu", "--data-root", data_root, "--model", name,
              "--model-kwargs", kw]
    ckpt = tmp_path / "ckpt"
    stats = train_cli.main(train_cli.get_args_parser().parse_args(
        common + ["--batch-size", "1", "--epochs", "1", "--checkpoint-dir", str(ckpt),
                  "--save-dir", str(tmp_path / "pred")]))
    assert np.isfinite(stats["train_g_loss"]) and np.isfinite(stats["valid_loss"])
    saved = torch.load(ckpt / "epoch_0.pth", weights_only=False)
    opts = ({"optimizer_G", "optimizer_Img_D", "optimizer_Grad_D"} if name == "DU_GAN"
            else {"optimizer_G", "optimizer_D"})
    assert opts <= set(saved) and "mto_method" not in saved
    prefixes = ({"Generator", "Image_Discriminator", "Grad_Discriminator"}
                if name == "DU_GAN" else {"Generator", "Discriminator"})
    assert {k.split(".")[0] for k in saved["model_state_dict"]} == prefixes
    model = get_model(name, **json.loads(kw or "{}"), device="cpu", seed=5)
    trainer = build_trainer(name, model, train_cli.get_args_parser().parse_args(common))
    if name == "DU_GAN":
        assert isinstance(trainer, DUGANTrainer)
    else:
        assert isinstance(trainer, AdversarialTrainer) and trainer.n_critic == 4
    assert restore(str(ckpt / "epoch_0.pth"), model, trainer) == 0
    again = {p + k: v for p, m in networks(model).items() for k, v in m.state_dict().items()}
    assert again.keys() == saved["model_state_dict"].keys()
    for k, v in saved["model_state_dict"].items():
        assert torch.equal(again[k], v), k
    for key in opts:
        opt = {"optimizer_G": trainer.opt_g, "optimizer_D": getattr(trainer, "opt_d", None),
               "optimizer_Img_D": getattr(trainer, "opt_img_d", None),
               "optimizer_Grad_D": getattr(trainer, "opt_grad_d", None)}[key]
        state, want = opt.state_dict()["state"], saved[key]["state"]
        assert state.keys() == want.keys() and len(state) > 0, key
        for i in want:
            for k, v in want[i].items():
                assert torch.equal(state[i][k], v), (key, i, k)
    summary = test_cli.main(test_cli.get_args_parser().parse_args(
        common + ["--resume", str(ckpt / "epoch_0.pth"), "--no-feature-metrics",
                  "--save-dir", str(tmp_path / "test")]))
    assert np.isfinite(summary["pred_psnr"])
