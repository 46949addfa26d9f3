"""Train steps of WGAN-VGG against the JAX package's ``AdversarialTrainer``
on the same draws: two steps of 2 critic updates each (the CLIs wire the
models' 4, ``test_torch_wgan.py``); 64x64, batch 2. The JAX steps run op
by op (``jax.disable_jit``: a compile of the critic loop with its double
backward takes over a minute on the CPU). MAP-NN's and DU-GAN's steps are in ``test_torch_map_nn_steps.py`` and ``test_torch_dugan_steps.py``.

Losses taken after an AdamW update (the last critic update's, the G loss)
are held to 1e-3 (absolute up to 1, relative above), parameters by the
rule of ``assert_step_matches``: an entry whose gradient sits at round-off
moves by up to lr = 1e-4 either way in either framework, and the gradient
penalty amplifies the difference (5.5e-4 relative seen on MAP-NN's second
step's penalty; 1.2e-3 on WGAN-VGG's G loss at batch 1, where the critic's
gradients hold more such entries)."""

import torch

from test_torch_train_helpers import critic_steps, losses_close, params_match

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

ATOL_CRITIC_STEP = 1e-3


def test_wgan_vgg_two_steps_match_jax():
    """Every metric of both steps (the second on the first's parameters and
    Adam moments), and both networks' parameters after them."""
    jax_metrics, port_metrics, start, final, port = critic_steps("WGAN_VGG")
    for i, (want, got) in enumerate(zip(jax_metrics, port_metrics)):
        losses_close(got, want, ATOL_CRITIC_STEP, f"WGAN_VGG step {i}")
    params_match(port, start, final, "WGAN_VGG", d_updates=4)
