"""The flagship's PCGrad step at bf16 on the CPU against the JAX bf16 step:
from one drawn state and batch, the generator forward, the stacked D
losses, each task's D gradient (what PCGrad combines), g_loss and the
generator gradient, in the port (on K1-bf16's and K2-bf16's plain versions,
its default route, and on the plain generator under autograd) and in the
JAX package (its einsum generator, the route it takes off the TPU), each
at fp32 and bf16. 8 features, L = 2, batch 4 of 64 x 64, dropout 0, the
weights drawn at N(0, 1/fan_in). Each value is held to the budget of
``test_torch_bf16_models.py`` plus one bf16 unit:

    err(port bf16, JAX bf16) <= 2 err(JAX bf16, JAX fp32) + err(port fp32, JAX fp32)
                                + 2^-8 |JAX bf16| + 1e-6

with err the max |a - b| over the elements for fake, the D losses and
g_loss, and the 2-norm of the difference for the generator gradient and
for each task's D gradient, each taken whole (the vectors PCGrad projects),
|.| the matching norm. The unit: a bf16 layer's bias gradient is itself
bf16 in both frameworks (the cotangent of ``bias.astype(bf16)`` summed in
bf16), so two sums that differ in fp32 rounding can round to neighbouring
bf16 values, 2^-8 of the value apart, however close their fp32 errors are.
The gradients are held whole and not leaf by leaf: PyTorch rounds every
eager bf16 op where XLA's fused kernels round once a fusion, and the tiny
leaves whose terms cancel (the consistency task's, ~1e-6) read several
times the JAX bf16 error there (printed). The gradients come back fp32 on
fp32 parameters."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtd_gan_tpu.models.mtd_gan import MTDGANModel as JaxModel
from mtd_gan_tpu.models.mtd_gan import MultiTaskDiscriminator as JaxDisc
from mtd_gan_tpu_torch.engine.gan import MTDGANTrainer
from mtd_gan_tpu_torch.models.mtd_gan import MTDGANModel
from mtd_gan_tpu_torch.mto.methods import per_task_grads
from mtd_gan_tpu_torch.ops.cuda_train import resfft_generator_train
from mtd_gan_tpu_torch.utils.torch_import import (discriminator_state_dict_from_flax,
                                                  generator_state_dict_from_flax)
from test_torch_bf16_models import _draw
from test_torch_train_helpers import data, host

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

BF16 = torch.bfloat16


def _jax_model(dtype):
    jm = JaxModel(gen_features=8, disc_features=8, num_layers=2, dtype=dtype, remat=False)
    jm.Discriminator = JaxDisc(features=8, dropout_rate=0.0, dtype=dtype)
    return jm


def _d_names(tree):
    """A D-shaped flax tree (no spectral state) -> the port's names."""
    sd = discriminator_state_dict_from_flax(host(tree), {})
    return {(k[:-len("weight")] + "weight_orig"
             if k.endswith(".weight") and "upsample" not in k
             and k.split(".")[0] not in ("enc_out", "dec_out", "rec_out") else k): v
            for k, v in sd.items()}


@functools.cache
def _state():
    shapes = jax.eval_shape(_jax_model(jnp.float32).init, jax.random.PRNGKey(0))
    v = _draw(shapes, 11)
    x, y = data(2, 4)
    return v, x, y


@functools.cache
def _jax_step(bf16: bool):
    """fake, the stacked D losses, the per-task D gradients and g_loss with
    the generator gradient of the JAX model, by the port's names."""
    v, x, y = _state()
    jm = _jax_model(jnp.bfloat16 if bf16 else jnp.float32)
    rng = jax.random.PRNGKey(5)
    fake = jm.generate(v.params_g, x)

    def losses(pd):
        return jm.d_loss(pd, v.params_g, v.state_d, rng, x, y, train=True,
                         update_stats=False, remat=False, fake=fake)[0]

    d = jax.jit(losses)(v.params_d)
    jac = jax.jit(jax.jacrev(losses))(v.params_d)
    task = [_d_names(jax.tree_util.tree_map(lambda a, i=i: a[i], jac)) for i in range(3)]
    g_fn = lambda pg: jm.g_loss(pg, v.params_d, v.state_d, rng, x, y, train=True,
                                remat=False)[0]
    g_loss, g_grad = jax.jit(jax.value_and_grad(g_fn))(v.params_g)
    return {"fake": np.asarray(fake, np.float32), "d_losses": np.asarray(d, np.float32),
            "task": task, "g_loss": np.float32(g_loss),
            "g_grad": generator_state_dict_from_flax(host(g_grad))}


@functools.cache
def _port_step(dtype, route: str):
    v, x, y = _state()
    m = MTDGANModel(gen_features=8, disc_features=8, num_layers=2, dropout_rate=0.0,
                    device="cpu", dtype=dtype)
    m.generator.load_state_dict(generator_state_dict_from_flax(host(v.params_g)))
    m.discriminator.load_state_dict(
        discriminator_state_dict_from_flax(host(v.params_d), host(v.state_d)))
    trainer = MTDGANTrainer(m, method="pcgrad", g_forward=route)
    gen = m.generator.train()
    xt, yt = torch.tensor(x), torch.tensor(y)
    fake = (resfft_generator_train(gen, xt) if route == "pallas"
            else gen(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
    d, _ = m.d_loss(xt, yt, fake, update_stats=False)
    names = [n for n, _ in m.discriminator.named_parameters()]
    task = [dict(zip(names, gs)) for gs in per_task_grads(d, trainer.d_params)]
    g_loss, _ = m.g_loss_terms(fake, xt, yt, update_stats=True)
    gnames, gparams = zip(*m.generator.named_parameters())
    g_grad = dict(zip(gnames, torch.autograd.grad(g_loss, gparams)))
    assert all(p.dtype == torch.float32 for p in (*gparams, *trainer.d_params))
    assert all(g.dtype == torch.float32 for g in g_grad.values())
    assert all(g.dtype == torch.float32 for t in task for g in t.values())
    to_np = lambda t: t.detach().float().numpy()
    return {"fake": to_np(fake), "d_losses": to_np(d),
            "task": [{k: to_np(g) for k, g in t.items()} for t in task],
            "g_loss": np.float32(g_loss.item()),
            "g_grad": {k: to_np(g) for k, g in g_grad.items()}}


def _values(step):
    """name -> (array, norm): the elementwise values in the max-norm, each
    task's D gradient and the generator gradient whole in the 2-norm."""
    flat = lambda grads: np.concatenate([np.ravel(grads[k]) for k in sorted(grads)])
    out = {k: (np.ravel(step[k]), np.inf) for k in ("fake", "d_losses", "g_loss")}
    out.update({f"task{i}": (flat(t), 2) for i, t in enumerate(step["task"])})
    out["g_grad"] = (flat(step["g_grad"]), 2)
    return out


@pytest.mark.parametrize("route", ["pallas", "einsum"])
def test_bf16_step_within_the_bf16_error(route):
    jax16, jax32 = _values(_jax_step(True)), _values(_jax_step(False))
    port16, port32 = _values(_port_step(BF16, route)), _values(_port_step(None, route))
    for k, (j16, norm) in jax16.items():
        err = lambda a, b: float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64), norm))
        j32, p16, p32 = jax32[k][0], port16[k][0], port32[k][0]
        unit = 2.0 ** -8 * float(np.linalg.norm(np.asarray(j16, np.float64), norm))
        bound = 2 * err(j16, j32) + err(p32, j32) + unit + 1e-6
        print(f"route {route} {k}: port bf16 vs JAX bf16 {err(p16, j16):.3e} (bound "
              f"{bound:.3e}); bf16 vs fp32 JAX {err(j16, j32):.3e}, port {err(p16, p32):.3e}")
        assert err(p16, j16) <= bound, (k, err(p16, j16), bound)
    assert not np.array_equal(port16["fake"][0], port32["fake"][0])
