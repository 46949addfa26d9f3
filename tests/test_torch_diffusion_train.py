"""The diffusion family's training in the port against the JAX package:
the eps-MSE loss and every gradient leaf with the same noise and t, and
two ``SupervisedTrainer`` steps, on the tiny UNet with every leaf drawn
(``test_torch_diffusion_helpers.py``) at 16 x 16."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mtd_gan_tpu.engine.supervised import SupervisedState
from mtd_gan_tpu.engine.supervised import SupervisedTrainer as JaxTrainer
from mtd_gan_tpu_torch.engine.supervised import SupervisedTrainer
from mtd_gan_tpu_torch.utils.torch_import import diffusion_unet_state_dict_from_flax
from test_torch_diffusion_helpers import (ATOL, JAX_MODELS, PORT_MODELS, RTOL_SAMPLE, TINY,
                                          load_flax, tiny_models, tiny_unet)
from test_torch_train_helpers import assert_step_matches, host, rel

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

t = torch.tensor


def _jax_loss_draws(key, shape):
    """The loss's noise and t as ``_DiffusionBase.loss`` draws them."""
    r_noise, r_t = jax.random.split(key)
    return {"noise": t(np.asarray(jax.random.normal(r_noise, shape))),
            "t": torch.from_numpy(np.asarray(jax.random.randint(r_t, (shape[0],), 0, 1000))
                                  .astype(np.int64))}


def _data(seed, n=2, size=16):
    rng = np.random.default_rng(seed)
    x = rng.random((n, size, size, 1)).astype(np.float32)
    return x, np.clip(x + 0.05 * rng.standard_normal(x.shape), 0, 1).astype(np.float32)


def test_loss_and_gradients_match_jax():
    """The eps-MSE with the same noise and t: the value at ATOL relative,
    every gradient leaf within RTOL_SAMPLE of its largest entry."""
    jm, port = tiny_models("DDIM")
    params = tiny_unet()[1]
    x, y = _data(11)
    key = jax.random.PRNGKey(4)
    (want, _), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(params, x, y, key)
    port.net.zero_grad()
    got, _ = port.loss(t(x), t(y), draws=_jax_loss_draws(key, y.shape))
    got.backward()
    assert abs(got.item() - float(want)) <= ATOL * abs(float(want))
    want_grads = diffusion_unet_state_dict_from_flax(host(grads))
    for k, p in port.net.named_parameters():
        g, w = p.grad.numpy(), want_grads[k].numpy()
        if k.endswith("to_k.bias"):
            # zero in exact arithmetic (softmax is blind to a shift shared by
            # every key): both sides hold round-off
            scale = np.abs(want_grads[k.replace("bias", "weight")].numpy()).max()
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-5 * scale, k
            continue
        assert rel(g, w) <= RTOL_SAMPLE, k


def test_two_trainer_steps_match_jax():
    """Two steps of the JAX ``SupervisedTrainer`` and of the port's from the
    same drawn parameters on the same batch, the port's draws taken from the
    JAX state's keys: the losses within RTOL_SAMPLE relative, the
    parameters by their change from the shared start
    (``assert_step_matches``)."""
    params = tiny_unet()[1]
    jm = JAX_MODELS["DDPM"](**TINY)
    tr = JaxTrainer(jm)
    state = SupervisedState(params=params, opt_state=tr.tx.init(params),
                            rng=jax.random.PRNGKey(6), step=jnp.zeros((), jnp.int32))
    port = PORT_MODELS["DDPM"](**TINY, device="cpu")
    load_flax(port.net, params)
    trainer = SupervisedTrainer(port)
    x, y = _data(12)
    for _ in range(2):
        rng_loss = jax.random.split(state.rng)[1]
        got = trainer.train_step(t(x), t(y), draws=_jax_loss_draws(rng_loss, y.shape))
        state, metrics = tr.train_step(state, x, y)
        np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]),
                                   rtol=RTOL_SAMPLE)
    start = diffusion_unet_state_dict_from_flax(host(params))
    want = diffusion_unet_state_dict_from_flax(host(state.params))
    for k, p in port.net.named_parameters():
        dp, dw = (p.detach() - start[k]).numpy(), (want[k] - start[k]).numpy()
        if k.endswith("to_k.bias"):  # a round-off gradient: AdamW's 2 lr per step bound
            assert np.abs(dp - dw).max() <= 2 * 2e-4, k
            continue
        assert_step_matches(k, dp, dw)
