"""The port's MTD-GAN trainer against the JAX package's: the Gram-space
PCGrad against a sequential projection, two full steps against
``MTDGANTrainer(g_forward="einsum")`` under PCGrad (the JAX projection
orders injected), CAGrad (only the shared parameters step) and UW (a
learnable log-sigma with its own optimizer), the optimizer's treatment of
unassigned parameters, the plain summed method, and the learning-rate
schedule. 8 features, L = 2, 64 x 64, batch 4, fp32, dropout 0 on both
sides. (The per-task D gradients and the
PCGrad-combined gradient are held to the JAX package's in
test_torch_discriminator.py, which shares their JAX compile.)"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtd_gan_tpu.engine.gan import MTDGANTrainer as JaxTrainer
from mtd_gan_tpu.models.mtd_gan import MTDGANModel as JaxModel
from mtd_gan_tpu.models.mtd_gan import MultiTaskDiscriminator as JaxDisc
from mtd_gan_tpu.optim import get_scheduler as jax_scheduler
from mtd_gan_tpu_torch.engine.gan import MTDGANTrainer
from mtd_gan_tpu_torch.models.mtd_gan import MTDGANModel
from mtd_gan_tpu_torch.mto.methods import (METHODS, check_method, combine_grads,
                                           pcgrad_coefficients)
from mtd_gan_tpu_torch.optim import get_scheduler
from mtd_gan_tpu_torch.utils.torch_import import (discriminator_state_dict_from_flax,
                                                  generator_state_dict_from_flax)

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

B = 4
host = lambda t: jax.tree_util.tree_map(np.asarray, t)


def _jax_model():
    jm = JaxModel(gen_features=8, disc_features=8, num_layers=2, dtype=jnp.float32,
                  remat=False)
    jm.Discriminator = JaxDisc(features=8, dropout_rate=0.0)
    return jm


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((B, 64, 64, 1)).astype(np.float32)
    y = np.clip(x + 0.05 * rng.standard_normal(x.shape), 0, 1).astype(np.float32)
    y[:, :8] = x[:, :8]
    return x, y


def _port_model(params_g, params_d, state_d):
    m = MTDGANModel(gen_features=8, disc_features=8, num_layers=2, dropout_rate=0.0,
                    device="cpu")
    m.generator.load_state_dict(generator_state_dict_from_flax(host(params_g)))
    m.discriminator.load_state_dict(
        discriminator_state_dict_from_flax(host(params_d), host(state_d)))
    return m


def _jax_orders(rng_mto, k=3):
    """The projection orders _pcgrad_shared draws (mto/methods.py:351-365)."""
    return torch.tensor(np.stack([np.asarray(jax.random.permutation(r, k))
                                  for r in jax.random.split(rng_mto, k)]))


def _flat_d(tree):
    """A D-shaped flax tree (no spectral state) -> the port's names."""
    sd = discriminator_state_dict_from_flax(host(tree), {})
    return {(k if not k.endswith(".weight") or "upsample" in k or k.split(".")[0] in
             ("enc_out", "dec_out", "rec_out") else k[:-len("weight")] + "weight_orig"): v
            for k, v in sd.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def test_pcgrad_coefficients_match_sequential_projection():
    """The Gram-space PCGrad equals the reference's sequential projection of
    each task's gradient against the others' ORIGINAL gradients."""
    rng = np.random.default_rng(7)
    g = rng.standard_normal((3, 50))
    g[1] = -0.8 * g[0] + 0.3 * g[1]  # a conflicting pair
    order = torch.tensor([[2, 0, 1], [0, 1, 2], [1, 2, 0]])
    want = np.zeros(50)
    for i in range(3):
        v = g[i].copy()
        for j in order[i].tolist():
            dot = v @ g[j]
            if dot < 0:
                v -= dot / (g[j] @ g[j] + 1e-12) * g[j]
        want += v
    w = pcgrad_coefficients(torch.tensor(g @ g.T), order)
    np.testing.assert_allclose(w.numpy() @ g, want, atol=1e-12)


@functools.cache
def _two_steps(method):
    """Two steps of ``method`` on each side from the JAX trainer's initial
    state, the JAX orders injected into the port under PCGrad."""
    jm = _jax_model()
    tr = JaxTrainer(jm, method=method, g_forward="einsum", g_remat=False,
                    d_remat=False)
    state = tr.create_state(jax.random.PRNGKey(3))
    m = _port_model(state.params_g, state.params_d, state.state_d)
    port = MTDGANTrainer(m, method=method)
    x, y = _data(1)
    jax_metrics, port_metrics = [], []
    for _ in range(2):
        _, _, rng_mto, _ = jax.random.split(state.rng, 4)
        order = _jax_orders(rng_mto)
        state, metrics = tr.train_step(state, x, y)
        jax_metrics.append(host(metrics))
        port_metrics.append({k: float(v) for k, v in
                             port.train_step(torch.tensor(x), torch.tensor(y), order).items()})
    return host(state), jax_metrics, m, port_metrics, port


@pytest.fixture(scope="module", params=["pcgrad", "cagrad", "uw"])
def two_steps(request):
    return (request.param, *_two_steps(request.param))


def test_two_steps_match_jax_losses(two_steps):
    """Every metric of both steps within 1e-4 relative (the second step
    runs on the parameters the first one produced)."""
    _, _, jax_metrics, _, port_metrics, _ = two_steps
    for jm_, pm in zip(jax_metrics, port_metrics):
        assert sorted(jm_) == sorted(pm)
        for k, v in jm_.items():
            assert abs(pm[k] - float(v)) <= 1e-4 * abs(float(v)) + 1e-9, (k, pm[k], v)


def test_two_steps_match_jax_parameters(two_steps):
    """Parameters and spectral-norm u after two steps, compared by their
    change from the shared start. AdamW moves an entry by about lr = 1e-4
    per step whatever its gradient's size, so an entry whose gradient sits
    at round-off may step either way: per leaf the mean deviation within 5%
    of the mean JAX change, every entry within 4e-4 (two steps of at most
    2 lr apart); u within 1e-5. The parameters the method gives no
    gradient stay put on both sides (PCGrad: the unassigned ``c_fc``;
    CAGrad: every parameter but the shared ones); UW's log-sigma within
    1e-5."""
    method, state, _, m, _, port = two_steps
    init = _jax_model().init(jax.random.PRNGKey(3))

    def check(name, delta_p, delta_w):
        diff = np.abs(delta_p - delta_w)
        # 1e-8: a few fp32 ulps of a weight of size 0.01-0.1
        assert diff.mean() <= 5e-2 * np.abs(delta_w).mean() + 1e-8, (name, diff.mean())
        assert diff.max() <= 4e-4, name

    port_g = dict(m.generator.named_parameters())
    init_g = generator_state_dict_from_flax(host(init.params_g))
    for k, w in generator_state_dict_from_flax(state.params_g).items():
        check(k, (port_g[k].detach() - init_g[k]).numpy(), (w - init_g[k]).numpy())
    port_d = dict(m.discriminator.named_parameters())
    init_d = _flat_d(init.params_d)
    label = dict(zip((n for n, _ in m.discriminator.named_parameters()), port.d_labels))
    frozen = {"pcgrad": ("unassigned",), "cagrad": ("task", "unassigned")}.get(method, ())
    for k, w in _flat_d(state.params_d).items():
        delta_w = (w - init_d[k]).numpy()
        delta_p = (port_d[k].detach() - init_d[k]).numpy()
        if label[k] in frozen:  # no gradient under the method: no step, no decay
            assert not np.any(delta_w) and not np.any(delta_p), k
            continue
        check(k, delta_p, delta_w)
    if method == "uw":
        np.testing.assert_allclose(port.mto_state.logsigma.numpy(),
                                   state.mto_state.logsigma, rtol=1e-5, atol=1e-7)
    u_port = {n[:-len(".weight_u")]: b.numpy() for n, b in m.discriminator.named_buffers()
              if n.endswith(".weight_u")}
    for name, u in state.state_d.items():
        np.testing.assert_allclose(u_port[name], u["u"], atol=2e-3)


def test_unassigned_parameters_take_no_optimizer_step():
    m = copy.deepcopy(_two_steps("pcgrad")[2])  # the cached model stays as it is
    port = MTDGANTrainer(m, method="pcgrad")
    x, y = (torch.tensor(a) for a in _data(2))
    before = m.discriminator.c_fc.weight_orig.detach().clone()
    port.train_step(x, y)
    assert torch.equal(m.discriminator.c_fc.weight_orig, before)
    assert m.discriminator.c_fc.weight_orig not in port.opt_d.state


def test_plain_sum_without_method_and_unported_methods_raise():
    """method=None: every D parameter, c_fc included, gets the summed task
    gradient; every method name is accepted, an unknown one raises."""
    g = [[torch.ones(2), torch.full((3,), 2.0)], [torch.ones(2), torch.zeros(3)]]
    out, state, weights = combine_grads(None, g, ["shared", "unassigned"])
    assert torch.equal(out[0], torch.full((2,), 2.0)) and torch.equal(out[1], g[0][1])
    assert state is None and weights is None
    assert check_method("") is None
    assert [check_method(name) for name in METHODS] == list(METHODS)
    with pytest.raises(KeyError):
        check_method("nope")
    m = MTDGANModel(gen_features=8, disc_features=8, num_layers=1, dropout_rate=0.0,
                    device="cpu")
    x, y = (torch.tensor(a) for a in _data(3))
    MTDGANTrainer(m, method=None).d_update(x, y, x.clone())
    assert m.discriminator.c_fc.weight_orig.grad is None  # zeroed after the step
    before = m.discriminator.c_fc.weight_orig.detach().clone()
    MTDGANTrainer(m, method=None).d_update(x, y, x.clone())
    assert not torch.equal(m.discriminator.c_fc.weight_orig, before)


def test_poly_lr_matches_jax():
    for epoch in (0, 3, 10, 49, 120, 499):
        assert get_scheduler("poly_lr", 1e-4, 500, 10, 1e-5)(epoch) == pytest.approx(
            jax_scheduler("poly_lr", 1e-4, 500, 10, 1e-5)(epoch), rel=1e-12)
