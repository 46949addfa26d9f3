"""The discriminator side of the port against the JAX package: the
spectral-norm multi-task discriminator (three heads, the power-iteration
state after 1 and after 4 + 1 iterations), ``d_loss`` and
``g_loss_terms``, the partitions, the ops and losses they use, and the
state-dict round trip through the JAX package's converter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtd_gan_tpu import losses as jax_losses
from mtd_gan_tpu.models.base import param_labels as jax_param_labels
from mtd_gan_tpu.models.mtd_gan import MTDGANModel as JaxModel
from mtd_gan_tpu.models.mtd_gan import MultiTaskDiscriminator as JaxDisc
from mtd_gan_tpu.mto import combine_grads as jax_combine, get_method
from mtd_gan_tpu.ops.filters import laplacian_detail as jax_laplacian
from mtd_gan_tpu.ops.layers import advance_spectral_state as jax_advance
from mtd_gan_tpu.ops.pixel_shuffle import pixel_shuffle as jax_pixel_shuffle
from mtd_gan_tpu.ops.upsample import upsample2x_bilinear as jax_upsample
from mtd_gan_tpu.utils.torch_import import convert_mtd_discriminator
from mtd_gan_tpu_torch import losses
from mtd_gan_tpu_torch.models.base import param_labels
from mtd_gan_tpu_torch.models.mtd_gan import MTDGANModel, MultiTaskDiscriminator
from mtd_gan_tpu_torch.mto.methods import combine_grads, per_task_grads
from mtd_gan_tpu_torch.mto.methods import get_method as port_get_method
from mtd_gan_tpu_torch.ops.filters import laplacian_detail
from mtd_gan_tpu_torch.ops.layers import advance_spectral_state
from mtd_gan_tpu_torch.ops.pixel_shuffle import PixelShuffleUpsample
from mtd_gan_tpu_torch.ops.upsample import upsample2x_bilinear
from mtd_gan_tpu_torch.utils.torch_import import discriminator_state_dict_from_flax

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

F_D, B = 8, 2
nchw = lambda a: torch.tensor(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def jax_model():
    """JAX MTDGANModel at 8 features with dropout 0, its initial params and
    spectral state, and seeded inputs."""
    jm = JaxModel(gen_features=8, disc_features=F_D, num_layers=2, dtype=jnp.float32)
    jm.Discriminator = JaxDisc(features=F_D, dropout_rate=0.0)
    gv = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    x = rng.random((B, 64, 64, 1)).astype(np.float32)
    y = np.clip(x + 0.05 * rng.standard_normal(x.shape), 0, 1).astype(np.float32)
    y[:, :8] = x[:, :8]  # some pixels where low and full dose agree (NDS mask)
    fake = np.clip(x + 0.02 * rng.standard_normal(x.shape), 0, 1).astype(np.float32)
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return jm, host(gv.params_d), host(gv.state_d), x, y, fake


def _port_disc(params_d, state_d):
    d = MultiTaskDiscriminator(1, F_D, dropout_rate=0.0)
    d.load_state_dict(discriminator_state_dict_from_flax(params_d, state_d), strict=True)
    return d


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _u(d):
    return {name[:-len(".weight_u")]: buf.numpy() for name, buf in d.named_buffers()
            if name.endswith(".weight_u")}


@pytest.mark.parametrize("advance", [0, 4])
def test_discriminator_matches_jax(jax_model, advance):
    """All three heads and every layer's u after one stored power iteration,
    optionally after 4 more first (the trainer's cadence): heads within 1e-4
    relative, u within 1e-5 (fp32 convs of another summation order through
    20 spectral-norm layers)."""
    jm, params, state, x, *_ = jax_model
    port = _port_disc(params, state)
    if advance:
        state = jax_advance(params, state, n_iters=advance)
        advance_spectral_state(port, advance)
    want, mutated = jax.jit(lambda p, sp, z: jm.Discriminator.apply(
        {"params": p, "spectral": sp}, z, train=False, update_stats=True,
        mutable=["spectral"]))(params, state, x)
    got = port(nchw(x), train=False, update_stats=True)
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.detach().numpy()
        assert _rel(g.transpose(0, 2, 3, 1) if g.ndim == 4 else g, w) < 1e-4
    u_port = _u(port)
    for name, u in mutated["spectral"].items():
        np.testing.assert_allclose(u_port[name], np.asarray(u["u"]), atol=1e-5)


def _port_model(params, state):
    m = MTDGANModel(gen_features=8, disc_features=F_D, num_layers=2, dropout_rate=0.0,
                    device="cpu")
    m.discriminator = _port_disc(params, state)
    return m


def test_d_loss_pcgrad_and_g_loss_terms_match_jax(jax_model):
    """The stacked [disc, rec, consist] losses and every detail (1e-4
    relative: fp32, two pair-batched D applications), the D gradients of
    each task (1e-3 per leaf: 20 spectral-norm layers deep), the PCGrad
    combination against the JAX combine_grads with the JAX projection
    orders injected (shared leaves projected, task leaves summed, c_fc
    without a gradient on the port and zero on the JAX side; 1e-3),
    g_loss_terms (1e-5) and its gradient w.r.t. fake (1e-4)."""
    jm, params, state, x, y, fake = jax_model
    m = _port_model(params, state)
    names = [n for n, _ in m.discriminator.named_parameters()]
    d_params = [p for _, p in m.discriminator.named_parameters()]
    losses_t, details = m.d_loss(torch.tensor(x), torch.tensor(y), torch.tensor(fake))
    want_losses, (sp, want_details) = jax.jit(lambda p: jm.d_loss(
        p, None, state, jax.random.PRNGKey(1), x, y, update_stats=False, remat=False,
        fake=fake))(params)
    assert _rel(losses_t.detach(), want_losses) < 1e-4
    for k, v in want_details.items():
        assert _rel(details[k].detach(), v) < 1e-4 + 1e-6 / max(abs(float(v)), 1e-30), k
    # the spectral state is frozen in d_loss on both sides
    for name, u in _u(m.discriminator).items():
        np.testing.assert_array_equal(u, state[name]["u"])
    jac = jax.jit(jax.jacrev(lambda p: jm.d_loss(
        p, None, state, jax.random.PRNGKey(1), x, y, update_stats=False, remat=False,
        fake=fake)[0]))(params)
    task_grads = per_task_grads(losses_t, d_params)
    for task in range(3):
        got = dict(zip(names, task_grads[task]))
        jg = jax.tree_util.tree_map(lambda a: np.asarray(a[task]), jac)
        flat = discriminator_state_dict_from_flax(jg, {})
        # near-zero leaves are held to a thousandth of the largest gradient
        # entry of all three tasks instead of their own scale: at the
        # reference init the consistency loss is ~1e-12 and its gradient
        # sits at fp32 round-off
        floor = 1e-3 * max(float(np.abs(a).max()) for a in jax.tree_util.tree_leaves(jac))
        for k, w in flat.items():
            key = k if k in got else k.replace(".weight", ".weight_orig")
            err = float((got[key] - w).abs().max()) / max(float(w.abs().max()), floor)
            assert err < 1e-3, (task, k, err)

    method, rng_mto = get_method("pcgrad"), jax.random.PRNGKey(11)
    jm_labels = jax.tree_util.tree_map_with_path(
        lambda path, _: jm.d_param_label(tuple(q.key for q in path)), params)
    want = jax.jit(lambda st: jax_combine(method, method.init_state(), rng_mto, want_losses,
                                          st, jm_labels)[0])(jac)
    orders = torch.tensor(np.stack([np.asarray(jax.random.permutation(r, 3))
                                    for r in jax.random.split(rng_mto, 3)]))
    port_labels = [jm.d_param_label(tuple(n.split("."))) for n in names]
    combined = dict(zip(names, combine_grads(port_get_method("pcgrad"), task_grads,
                                             port_labels, orders)[0]))
    flat = discriminator_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, want), {})
    for k, w in flat.items():
        key = k if k in combined else k.replace(".weight", ".weight_orig")
        if key.startswith("c_fc"):
            assert combined[key] is None and not w.abs().max()
            continue
        err = float((combined[key] - w).abs().max()) / max(float(w.abs().max()), floor)
        assert err < 1e-3, ("pcgrad", k, err)

    ft = torch.tensor(fake, requires_grad=True)
    total, g_details = m.g_loss_terms(ft, torch.tensor(x), torch.tensor(y))
    (dfake,) = torch.autograd.grad(total, ft)
    (want_total, (_, want_g)), want_dfake = jax.jit(jax.value_and_grad(
        lambda f: jm.g_loss_terms(f, params, state, jax.random.PRNGKey(2), x, y,
                                  remat=False), has_aux=True))(jnp.asarray(fake))
    assert _rel(total.detach(), want_total) < 1e-5
    for k, v in want_g.items():
        assert _rel(g_details[k].detach(), v) < 1e-5, k
    assert _rel(dfake, want_dfake) < 1e-4


def test_partition_labels_match_jax(jax_model):
    """shared / task / unassigned per parameter, c_fc in neither group."""
    jm, params, *_ = jax_model
    port = param_labels(MultiTaskDiscriminator(1, F_D), jm.d_param_label)
    jl = jax_param_labels(params, jm.d_param_label)
    want = {}
    for name, p in jl.items():
        for leaf, lab in p.items():
            if isinstance(lab, dict):  # r_up{i}/proj
                for leaf2, lab2 in lab.items():
                    want[f"{name}.upsample.0.{'weight' if leaf2 == 'kernel' else 'bias'}"] = lab2
            else:
                sn = name in jax_model[2]
                wname = ("weight_orig" if sn else "weight") if leaf == "kernel" else "bias"
                want[f"{name}.{wname}"] = lab
    assert port == want
    assert {lab for n, lab in port.items() if n.startswith("c_fc")} == {"unassigned"}
    for name in ("bconv2", "bconv1", "c_fc"):
        assert MTDGANModel.d_last_shared_label((name,)) == jm.d_last_shared_label((name,))


def test_state_dict_round_trips_through_jax_converter(jax_model):
    """flax params + u -> port state dict -> the JAX package's
    convert_mtd_discriminator gives the flax tree back bit for bit."""
    _, params, state, *_ = jax_model
    sd = _port_disc(params, state).state_dict()
    back_params, back_state = convert_mtd_discriminator(sd, prefix="")
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v)
                      for k, v in jax.tree_util.tree_leaves_with_path(t)}
    for a, b in ((back_params, params), (back_state, state)):
        fa, fb = flat(a), flat(b)
        assert sorted(fa) == sorted(fb)
        for k in fb:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    assert any(k.endswith(".weight_v") for k in sd)


def test_ops_match_jax():
    """upsample2x_bilinear (against the JAX function and F.interpolate, 1e-6:
    the same two taps in another order), pixel_shuffle (exact) and
    laplacian_detail (1e-6: the same 5x5 stencil summed in another order)."""
    rng = np.random.default_rng(3)
    for shape in ((2, 6, 10, 3), (2, 1, 1, 4)):
        a = rng.standard_normal(shape).astype(np.float32)
        got = upsample2x_bilinear(nchw(a))
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                                   np.asarray(jax_upsample(a)), atol=1e-6)
        torch.testing.assert_close(got, torch.nn.functional.interpolate(
            nchw(a), scale_factor=2, mode="bilinear", align_corners=False),
            rtol=0, atol=1e-6)
    b = rng.standard_normal((2, 5, 7, 12)).astype(np.float32)
    shuffle = PixelShuffleUpsample(3).upsample[1]  # the REC decoder's nn.PixelShuffle
    np.testing.assert_array_equal(shuffle(nchw(b)).numpy().transpose(0, 2, 3, 1),
                                  np.asarray(jax_pixel_shuffle(b, 2)))
    c = rng.random((2, 16, 20, 1)).astype(np.float32)
    np.testing.assert_allclose(laplacian_detail(nchw(c)).numpy().transpose(0, 2, 3, 1),
                               np.asarray(jax_laplacian(c)), atol=1e-6)


def test_losses_match_jax():
    rng = np.random.default_rng(4)
    p, t = rng.random((2, 2, 16, 16, 1)).astype(np.float32)
    diff = np.where(rng.random(p.shape) < 0.3, 0.0, p - t).astype(np.float32)
    tt = torch.tensor
    pairs = [
        (losses.l1(tt(p), tt(t)), jax_losses.l1(p, t)),
        (losses.l2(tt(p), tt(t)), jax_losses.l2(p, t)),
        (losses.ls_gan(tt(p), 1.0), jax_losses.ls_gan(p, 1.0)),
        (losses.nds_loss(tt(p), 0.0, tt(diff)), jax_losses.nds_loss(p, 0.0, diff)),
        (losses.charbonnier_loss(tt(p), tt(t)), jax_losses.charbonnier_loss(p, t)),
        (losses.edge_loss(nchw(p), nchw(t)), jax_losses.edge_loss(p, t)),
        (losses.get_loss("MSFR Loss")(tt(p), tt(t)), jax_losses.msfr_loss(p, t)),
    ]
    for got, want in pairs:
        assert _rel(got, want) < 1e-5
    with pytest.raises(KeyError, match="unknown loss"):
        losses.get_loss("VGG Loss")
