"""Helpers shared by the port's training tests of the CNN family, the
ablations, the WGAN family and the transformers (``test_torch_cnn.py``,
``test_torch_ablations.py``, ``test_torch_wgan.py``,
``test_torch_transformers.py``). It holds no tests of its own: pytest
collects nothing here."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mtd_gan_tpu_torch.data.dicom import write_synthetic_dicom

host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)


def rel(a, b) -> float:
    """max |a - b| / max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def draw_variables(shapes, seed: int, bias_std: float = 0.01):
    """A tree of ``shapes`` drawn with numpy: kernels N(0, 1/fan_in) (fan-in
    = all axes but the last), spectral-norm ``u`` unit vectors, every other
    leaf N(0, bias_std^2)."""
    rng = np.random.default_rng(seed)

    def one(path, s):
        if getattr(path[-1], "key", "") == "u":
            v = rng.standard_normal(s.shape)
            return (v / np.linalg.norm(v)).astype(np.float32)
        if len(s.shape) >= 2:
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
                    ).astype(np.float32)
        return (bias_std * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


def assert_tree_close(got, want, rtol: float, label: str = "") -> None:
    """Per leaf (a mapping of names to arrays): max |got - want| within
    ``rtol`` of max |want|."""
    assert set(got) == set(want), (label, set(got) ^ set(want))
    for k in want:
        assert rel(got[k], want[k]) <= rtol, (label, k, rel(got[k], want[k]))


def data(seed: int, n: int, size: int = 64):
    """``x`` in [0, 1), ``y`` = x + noise clipped, the first 8 rows of y
    equal to x's (there ``x - y == 0``: NDS masks them)."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, size, size, 1)).astype(np.float32)
    y = np.clip(x + 0.05 * rng.standard_normal(x.shape), 0, 1).astype(np.float32)
    y[:, :8] = x[:, :8]
    return x, y


def assert_step_matches(name: str, delta_p, delta_w, updates: int = 2) -> None:
    """A parameter's change from a shared start after the same steps on both
    sides, by the rule of ``test_torch_trainer.py``: AdamW moves an entry by
    about lr = 1e-4 per step whatever its gradient's size, so an entry whose
    gradient sits at round-off may step either way; per leaf the mean
    deviation within 5% of the mean JAX change (+ 1e-8, a few fp32 ulps of
    a weight), every entry within 2e-4 per update (two updates: 4e-4; at
    most 2 lr apart each)."""
    diff = np.abs(np.asarray(delta_p) - np.asarray(delta_w))
    assert diff.mean() <= 5e-2 * np.abs(delta_w).mean() + 1e-8, (name, diff.mean())
    assert diff.max() <= 2e-4 * updates, (name, diff.max())


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


# ---- the WGAN family (test_torch_wgan.py, test_torch_wgan_steps.py) ----

def nchw(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a)).permute(0, 3, 1, 2)


@functools.cache
def vgg_pair():
    """A He-normal VGG19 drawn with numpy: the JAX trunk's functions on its
    params and the port's trunk carrying them (``trunk``, ``slices``,
    ``perceptual``)."""
    from mtd_gan_tpu.features import vgg as jax_vgg
    from mtd_gan_tpu_torch.features.registry import to_rgb_nchw
    from mtd_gan_tpu_torch.features.vgg import VGG_SLICE_ENDS, WGAN_VGG_END, vgg19_trunk
    from mtd_gan_tpu_torch.utils.torch_import import vgg19_state_dict_from_flax
    from test_torch_feature_helpers import draw_tree

    params = draw_tree(lambda: jax_vgg.init_vgg19_params(jax.random.PRNGKey(0)), 19)
    trunk = vgg19_trunk()
    trunk.load_state_dict(vgg19_state_dict_from_flax(host(params)), strict=True)
    trunk.eval().requires_grad_(False)
    rgb = lambda x: jnp.repeat(x, 3, axis=-1)
    return dict(
        jax_slices=lambda x: jax_vgg.vgg19_features(params, rgb(x), VGG_SLICE_ENDS),
        jax_perceptual=lambda x: jax_vgg.vgg19_features(params, rgb(x), (WGAN_VGG_END,))[0],
        trunk=trunk, slices=lambda x: trunk(to_rgb_nchw(x)),
        perceptual=lambda x: trunk(to_rgb_nchw(x), (WGAN_VGG_END,))[0])


def critic_state_dict(name: str, params_g, params_d):
    from mtd_gan_tpu_torch.utils.torch_import import (map_nn_state_dict_from_flax,
                                                      wgan_vgg_state_dict_from_flax)
    to_sd = wgan_vgg_state_dict_from_flax if name == "WGAN_VGG" else map_nn_state_dict_from_flax
    return to_sd(host(params_g), host(params_d))


def critic_port(name: str, gv):
    """The port's WGAN-VGG (on ``vgg_pair``'s trunk) or MAP-NN carrying the
    flax variables ``gv``."""
    from mtd_gan_tpu_torch.models.map_nn import MAPNNModel
    from mtd_gan_tpu_torch.models.wgan_vgg import WGANVGGModel
    from mtd_gan_tpu_torch.utils.checkpoint import load_model_state_dict

    port = (WGANVGGModel(feature_fn=vgg_pair()["perceptual"], device="cpu")
            if name == "WGAN_VGG" else MAPNNModel(device="cpu"))
    load_model_state_dict(port, critic_state_dict(name, gv.params_g, gv.params_d))
    return port


@functools.cache
def critic_pair(name: str):
    """The JAX model (WGAN-VGG on ``vgg_pair``'s VGG19), its numpy-drawn
    variables and the port's model carrying them."""
    from mtd_gan_tpu.models.map_nn import MAPNNModel as JaxMAPNN
    from mtd_gan_tpu.models.wgan_vgg import WGANVGGModel as JaxWGAN

    jm = (JaxWGAN(feature_fn=vgg_pair()["jax_perceptual"]) if name == "WGAN_VGG"
          else JaxMAPNN())
    gv = draw_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 3)
    return jm, gv, critic_port(name, gv)


def dugan_state_dict(v):
    from mtd_gan_tpu_torch.utils.torch_import import dugan_state_dict_from_flax
    v = host(v)
    return dugan_state_dict_from_flax(v["params_g"], v["params_img_d"], v["state_img_d"],
                                      v["params_grad_d"], v["state_grad_d"])


def dugan_port(width: dict, v):
    from mtd_gan_tpu_torch.models.dugan import DUGANModel
    from mtd_gan_tpu_torch.utils.checkpoint import load_model_state_dict

    model = DUGANModel(**width, device="cpu")
    load_model_state_dict(model, dugan_state_dict(v))
    return model


@functools.cache
def dugan_pair(width: tuple):
    """The JAX DU-GAN at ``dict(width)``, its numpy-drawn variables and the
    port's model carrying them."""
    from mtd_gan_tpu.models.dugan import DUGANModel as JaxDUGAN

    jm = JaxDUGAN(**dict(width))
    v = draw_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 4)
    return jm, v, dugan_port(dict(width), v)


def u_buffers(module) -> dict:
    """Every spectral-norm ``u`` of ``module`` by state-dict name."""
    return {n: b.numpy().copy() for n, b in module.state_dict().items()
            if n.endswith("weight_u")}


def unet_u(params, spectral) -> dict:
    """The flax U-Net's ``u`` vectors under the port's state-dict names."""
    from mtd_gan_tpu_torch.utils.torch_import import unet_state_dict_from_flax
    return {k: v.numpy() for k, v in unet_state_dict_from_flax(host(params), host(spectral))
            .items() if k.endswith("weight_u")}


def cutmix_draws(key):
    """The draws the JAX ``_d_loss_domain`` takes from its key, as the
    port's ``CutMix``."""
    from mtd_gan_tpu_torch.models.dugan import CutMix
    r_coin, r_mask = jax.random.split(key)
    r_lam, r_cx, r_cy = jax.random.split(r_mask, 3)
    u = [float(jax.random.uniform(k)) for k in (r_lam, r_cx, r_cy, r_coin)]
    return CutMix(*(torch.tensor(v, dtype=torch.float32) for v in u))


def losses_close(got, want, tol: float, label: str) -> None:
    """The same keys; each value within ``tol`` (absolute up to 1, relative
    above)."""
    assert sorted(got) == sorted(want), (label, sorted(got), sorted(want))
    for k, w in want.items():
        assert abs(float(got[k]) - float(w)) <= tol * max(1.0, abs(float(w))), (
            label, k, float(got[k]), float(w))


@functools.cache
def critic_steps(name: str, n_critic: int = 2):
    """Two steps of the JAX ``AdversarialTrainer`` (run op by op) and of the
    port's from the same drawn state (``critic_pair``), the port fed the
    JAX step's GP draws; returns both sides' metrics, the start and the
    JAX end state in the port's layout, and the port's model."""
    from mtd_gan_tpu.engine.wgan import AdversarialTrainer as JaxAdversarial
    from mtd_gan_tpu.engine.wgan import AdvTrainState
    from mtd_gan_tpu_torch.engine.wgan import AdversarialTrainer

    jm, gv, _ = critic_pair(name)
    tr = JaxAdversarial(jm, n_critic=n_critic)
    step = tr._build_step()
    state = AdvTrainState(params_g=gv.params_g, params_d=gv.params_d, state_d=gv.state_d,
                          opt_g=tr.tx_g.init(gv.params_g), opt_d=tr.tx_d.init(gv.params_d),
                          rng=jax.random.PRNGKey(16), step=jnp.zeros((), jnp.int32))
    port = critic_port(name, gv)
    trainer = AdversarialTrainer(port, n_critic=n_critic)
    x, y = data(17, 2)
    jax_metrics, port_metrics = [], []
    for _ in range(2):
        keys = jax.random.split(state.rng, 2 + n_critic)[2:]
        draws = [torch.tensor(np.asarray(jax.random.uniform(k, (2, 1, 1, 1), jnp.float32)))
                 for k in keys]
        with jax.disable_jit():
            state, metrics = step(state, x, y)
        jax_metrics.append(host(metrics))
        port_metrics.append(trainer.train_step(torch.tensor(x), torch.tensor(y), draws=draws))
    return (jax_metrics, port_metrics, critic_state_dict(name, gv.params_g, gv.params_d),
            critic_state_dict(name, state.params_g, state.params_d), port)


# a loss taken after an AdamW update (DU-GAN's G loss): an entry whose
# gradient sits at round-off moves by up to lr = 1e-4 either way in either
# framework (``assert_step_matches``), as test_torch_ablations.py holds its
# steps
ATOL_STEP = 2e-4


def params_match(model, start, final, label: str, d_updates: int = 2) -> None:
    """Every parameter of the model's networks by its change from ``start``
    against the JAX change to ``final`` (``assert_step_matches``, two
    generator updates and ``d_updates`` of each discriminator; 1e-4 of each
    leaf is out of reach for the same reason as ``ATOL_STEP``)."""
    from mtd_gan_tpu_torch.utils.checkpoint import networks
    for prefix, m in networks(model).items():
        for k, p in m.named_parameters():
            name = prefix + k
            assert name in final, (label, name)
            assert_step_matches(f"{label} {name}", (p.detach() - start[name]).numpy(),
                                (final[name] - start[name]).numpy(),
                                2 if prefix == "Generator." else d_updates)
