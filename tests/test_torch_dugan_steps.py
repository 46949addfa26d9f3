"""Train steps of DU-GAN against the JAX package's ``DUGANTrainer`` on the
same draws: two steps, the first with both CutMix coins on, the second
with both off (the mixed forward still runs, and advances ``u``). The JAX
step is jitted (op by op takes minutes). The U-Nets are at conv_dim 8,
repeat_num 3 here (fewer layers to compile; ``test_torch_wgan.py`` holds
the module at its published repeat_num 6), the generator at 8 features, L
= 1; 64x64, batch 2. Tolerances: ``test_torch_wgan_steps.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtd_gan_tpu.engine.wgan import DUGANTrainer as JaxDUGANTrainer
from mtd_gan_tpu.engine.wgan import DUGANTrainState
from mtd_gan_tpu_torch.engine.wgan import DUGANTrainer
from test_torch_train_helpers import (ATOL_STEP, cutmix_draws, data, dugan_pair, dugan_port,
                                      dugan_state_dict, host, losses_close, params_match,
                                      u_buffers, unet_u)

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

ATOL_U = 1e-5     # spectral-norm u (unit vectors)
DUGAN_WIDTH = (("gen_features", 8), ("num_layers", 1), ("conv_dim", 8), ("repeat_num", 3))
t = torch.tensor


@functools.cache
def _dugan_steps():
    """Two steps of the JAX ``DUGANTrainer`` and of the port's from the same
    drawn state, the port fed the JAX draws: a key whose first step has
    both CutMix coins on and whose second has both off."""
    jm, v, _ = dugan_pair(DUGAN_WIDTH)
    tr = JaxDUGANTrainer(jm)
    step = tr._build_step()

    def coins(key):
        out = []
        for _ in range(2):
            key, r_img, r_grad, _ = jax.random.split(key, 4)
            out.append(tuple(float(cutmix_draws(k).coin) >= 0.5 for k in (r_img, r_grad)))
        return out

    seed = next(s for s in range(200)
                if coins(jax.random.PRNGKey(s)) == [(True, True), (False, False)])
    state = DUGANTrainState(
        params_g=v["params_g"], params_img_d=v["params_img_d"],
        params_grad_d=v["params_grad_d"], state_img_d=v["state_img_d"],
        state_grad_d=v["state_grad_d"], opt_g=tr.tx_g.init(v["params_g"]),
        opt_img_d=tr.tx_img.init(v["params_img_d"]),
        opt_grad_d=tr.tx_grad.init(v["params_grad_d"]), rng=jax.random.PRNGKey(seed),
        step=jnp.zeros((), jnp.int32))
    model = dugan_port(dict(DUGAN_WIDTH), v)
    trainer = DUGANTrainer(model)
    x, y = data(18, 2)
    jax_metrics, port_metrics, u = [], [], []
    for _ in range(2):
        _, r_img, r_grad, _ = jax.random.split(state.rng, 4)
        draws = {"img": cutmix_draws(r_img), "grad": cutmix_draws(r_grad)}
        state, metrics = step(state, x, y)
        jax_metrics.append(host(metrics))
        port_metrics.append(trainer.train_step(t(x), t(y), draws=draws))
        u.append(((u_buffers(model.image_discriminator),
                   unet_u(state.params_img_d, state.state_img_d)),
                  (u_buffers(model.grad_discriminator),
                   unet_u(state.params_grad_d, state.state_grad_d))))
    final = dugan_state_dict({"params_g": state.params_g,
                              "params_img_d": state.params_img_d,
                              "state_img_d": state.state_img_d,
                              "params_grad_d": state.params_grad_d,
                              "state_grad_d": state.state_grad_d})
    return jax_metrics, port_metrics, u, dugan_state_dict(v), final, model


@pytest.mark.parametrize("step", [0, 1], ids=["coin_on", "coin_off"])
def test_dugan_trainer_steps_match_jax(step):
    """A step's metrics and every ``u`` of both U-Nets after it (the first
    step with both CutMix terms counted, the second with neither: the
    mixed forward still advances ``u``)."""
    jax_metrics, port_metrics, u, _, _, _ = _dugan_steps()
    losses_close(port_metrics[step], jax_metrics[step], ATOL_STEP, f"step {step}")
    for got, want in u[step]:
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=ATOL_U, err_msg=k)


def test_dugan_trainer_parameters_match_jax():
    """All three networks' parameters after the two steps."""
    _, _, _, start, final, model = _dugan_steps()
    params_match(model, start, final, "DU_GAN")
