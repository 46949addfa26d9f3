"""Trainer of the scalar-``d_loss`` GAN models (counterpart of
``AdversarialTrainer`` in ``mtd_gan_tpu/engine/wgan.py``; reference
engine.py:419-653), as the MTD-GAN ablations use it (``n_critic=1``,
``engine/loops.py::build_trainer``). The gradient penalty, CutMix and
DU-GAN's trainer are not ported yet (ROADMAP.md queue 1, item 9).

One step, on NHWC patches:

1. ONE generator forward ``fake = G(x)`` (``model.train_forward``: the
   ResFFT generator on K1 + K2 where they take the batch, else autograd),
   its graph kept for the G update. The JAX step runs G again in each
   loss, because the ablations' ``d_loss`` takes no ``fake``; the G
   parameters are constant across the D updates, so the values are the
   same;
2. ``n_critic`` D updates on the detached fake: ``d_loss``, backward,
   AdamW;
3. the G update: ``g_loss_terms`` on the post-update D, backpropagated
   through the saved graph, AdamW.

Every D forward of a loss stores one spectral-norm power iteration (the
``(y, fake)`` pair pass, RC's second pass, the G pass), as the JAX
``update_stats=train`` does: the cadence is coupled to the forwards, unlike
``MTDGANTrainer``'s frozen-then-advanced schedule.
"""

from __future__ import annotations

from typing import Dict

import torch

from mtd_gan_tpu_torch import optim
from mtd_gan_tpu_torch.models.mtd_gan import check_discriminator_input

Tensor = torch.Tensor


class AdversarialTrainer:
    """Holds the two optimizers and the step's dropout generator (seeded
    from ``seed``). ``n_critic``: D updates per step."""

    def __init__(self, model, optimizer: str = "adamw", lr: float = 1e-4,
                 weight_decay: float = 5e-4, n_critic: int = 1, seed: int = 0):
        self.model = model
        self.n_critic = n_critic
        self.opt_g = optim.get_optimizer(optimizer, model.generator.parameters(), lr,
                                         weight_decay)
        self.opt_d = optim.get_optimizer(optimizer, model.discriminator.parameters(), lr,
                                         weight_decay)
        self.rng = torch.Generator(device=model.device).manual_seed(seed)

    def set_epoch_lr(self, lr: float) -> None:
        optim.set_learning_rate(self.opt_g, lr)
        optim.set_learning_rate(self.opt_d, lr)

    def train_step(self, x: Tensor, y: Tensor) -> Dict[str, Tensor]:
        """One step on ``x``, ``y`` (N, 64, 64, 1) on the model's device;
        returns the last D update's details, the G details, ``d_loss`` and
        ``g_loss`` as 0-d tensors."""
        model = self.model
        _, h, w, _ = x.shape
        check_discriminator_input(h, w)
        model.generator.train()
        model.discriminator.train()
        fake = model.train_forward(x)
        for _ in range(self.n_critic):
            d_loss, d_details = model.d_loss(x, y, fake, update_stats=True,
                                             generator=self.rng)
            d_loss.backward()
            self.opt_d.step()
            self.opt_d.zero_grad(set_to_none=True)
        g_loss, g_details = model.g_loss_terms(fake, x, y, update_stats=True,
                                               generator=self.rng)
        params_g = list(model.generator.parameters())
        for p, g in zip(params_g, torch.autograd.grad(g_loss, params_g)):
            p.grad = g
        self.opt_g.step()
        self.opt_g.zero_grad(set_to_none=True)
        metrics = {k: v.detach() for k, v in {**d_details, **g_details}.items()}
        metrics["d_loss"] = d_loss.detach()
        metrics["g_loss"] = g_loss.detach()
        return metrics
