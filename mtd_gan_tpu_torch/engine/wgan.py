"""Trainers of the scalar-``d_loss`` GAN models (counterpart of
``mtd_gan_tpu/engine/wgan.py``; reference engine.py:419-784).

``AdversarialTrainer`` — WGAN-VGG and MAP-NN (``n_critic = 4``, the
models' ``d_steps_per_g``) and the MTD-GAN ablations (``n_critic = 1``,
``engine/loops.py::build_trainer``). One step, on NHWC patches:

1. ONE generator forward ``fake = G(x)`` (``model.train_forward``: the
   ResFFT generator on K1 + K2 where they take the batch, else autograd),
   its graph kept for the G update; the G parameters are constant across
   the D updates, so one forward serves them all, as the JAX step's
   ``hoist`` does;
2. ``n_critic`` D updates on the detached fake: ``d_loss`` (for the WGAN
   models with the gradient penalty, whose input gradient keeps its graph),
   backward, AdamW;
3. the G update: ``g_loss_terms`` on the post-update D, backpropagated
   through the saved graph, AdamW.

Every D forward of an ablation's loss stores one spectral-norm power
iteration (the ``(y, fake)`` pair pass, RC's second pass, the G pass), as
the JAX ``update_stats=train`` does.

``DUGANTrainer`` — DU-GAN (reference engine.py:658-784): three optimizers
(G, image D, gradient D) and one G forward a step; the image-D update,
then the gradient-D update, then the G update on both updated Ds. Each
domain loss runs four D forwards (real, fake, input, CutMix), each storing
a power iteration, and the G loss one more per D.

The random draws (the GP's ``a``, the CutMix box and coin) come from the
trainer's ``torch.Generator``, seeded from ``seed``; ``train_step`` takes
them explicitly too (``draws``), which is how the tests feed the JAX
package's.

On a :class:`~mtd_gan_tpu_torch.parallel.mesh.Grid` (``DataParallel``)
each rank takes its rows of the global batch; the GP's ``a`` is the global
draw's rows (``mesh.batch_draws``), the CutMix box and coin (one per
batch) come out equal on every rank, and every update's gradients and the
metrics are averaged over the data group: the single-rank step on the
whole batch.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from mtd_gan_tpu_torch import optim
from mtd_gan_tpu_torch.models.dugan import CutMix
from mtd_gan_tpu_torch.parallel.mesh import (Grid, average_grads, batch_draws, mean_metrics,
                                             mean_over_data)

Tensor = torch.Tensor


def _step(opt: torch.optim.Optimizer, module: torch.nn.Module, loss: Tensor,
          grid: Optional[Grid]) -> None:
    loss.backward()
    average_grads(grid, module.parameters())
    opt.step()
    opt.zero_grad(set_to_none=True)


def _generator_step(opt: torch.optim.Optimizer, generator: torch.nn.Module,
                    loss: Tensor, grid: Optional[Grid]) -> None:
    """The G update through ``fake``'s saved graph; the Ds' ``.grad`` stay
    untouched."""
    params = list(generator.parameters())
    grads = mean_over_data(grid, torch.autograd.grad(loss, params))
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


class AdversarialTrainer:
    """Holds the two optimizers and the step's random generator (seeded from
    ``seed``). ``n_critic``: D updates per step."""

    def __init__(self, model, optimizer: str = "adamw", lr: float = 1e-4,
                 weight_decay: float = 5e-4, n_critic: int = 1, seed: int = 0,
                 grid: Optional[Grid] = None):
        self.model = model
        self.grid = grid
        self.n_critic = n_critic
        self.opt_g = optim.get_optimizer(optimizer, model.generator.parameters(), lr,
                                         weight_decay)
        self.opt_d = optim.get_optimizer(optimizer, model.discriminator.parameters(), lr,
                                         weight_decay)
        self.rng = torch.Generator(device=model.device).manual_seed(seed)

    def set_epoch_lr(self, lr: float) -> None:
        optim.set_learning_rate(self.opt_g, lr)
        optim.set_learning_rate(self.opt_d, lr)

    def train_step(self, x: Tensor, y: Tensor,
                   draws: Optional[Sequence] = None) -> Dict[str, Tensor]:
        """One step on ``x``, ``y`` (N, H, W, 1) on the model's device (the
        sizes the model's ``check_input`` takes); ``draws``: one entry per D
        update for the model's ``d_loss`` (the GP's ``a``), drawn when
        ``None``. Returns the last D update's details, the G details,
        ``d_loss`` and ``g_loss`` as 0-d tensors."""
        model = self.model
        _, h, w, _ = x.shape
        model.check_input(h, w)
        model.generator.train()
        model.discriminator.train()
        fake = model.train_forward(x)
        with batch_draws(self.grid, x.shape[0]):
            for i in range(self.n_critic):
                kw = {} if draws is None else {"draws": draws[i]}
                d_loss, d_details = model.d_loss(x, y, fake, update_stats=True,
                                                 generator=self.rng, **kw)
                _step(self.opt_d, model.discriminator, d_loss, self.grid)
            g_loss, g_details = model.g_loss_terms(fake, x, y, update_stats=True,
                                                   generator=self.rng)
        _generator_step(self.opt_g, model.generator, g_loss, self.grid)
        metrics = {k: v.detach() for k, v in {**d_details, **g_details}.items()}
        metrics["d_loss"] = d_loss.detach()
        metrics["g_loss"] = g_loss.detach()
        return mean_metrics(self.grid, metrics)


class DUGANTrainer:
    """DU-GAN's three optimizers (``opt_g``, ``opt_img_d``, ``opt_grad_d``)
    and the step's random generator (seeded from ``seed``)."""

    def __init__(self, model, optimizer: str = "adamw", lr: float = 1e-4,
                 weight_decay: float = 5e-4, seed: int = 0, grid: Optional[Grid] = None):
        self.model = model
        self.grid = grid
        make = lambda m: optim.get_optimizer(optimizer, m.parameters(), lr, weight_decay)
        self.opt_g = make(model.generator)
        self.opt_img_d = make(model.image_discriminator)
        self.opt_grad_d = make(model.grad_discriminator)
        self.rng = torch.Generator(device=model.device).manual_seed(seed)

    def set_epoch_lr(self, lr: float) -> None:
        for opt in (self.opt_g, self.opt_img_d, self.opt_grad_d):
            optim.set_learning_rate(opt, lr)

    def train_step(self, x: Tensor, y: Tensor,
                   draws: Optional[Dict[str, CutMix]] = None) -> Dict[str, Tensor]:
        """One step on ``x``, ``y`` (N, H, W, 1); ``draws``: ``{"img": ...,
        "grad": ...}``, each domain loss's CutMix draws, drawn when
        ``None``. Returns every
        loss's details, ``d_img_loss``, ``d_grad_loss`` and ``g_loss`` as 0-d
        tensors."""
        model = self.model
        _, h, w, _ = x.shape
        model.check_input(h, w)
        for m in (model.generator, model.image_discriminator, model.grad_discriminator):
            m.train()
        draws = draws or {}
        fake = model.train_forward(x)
        img_total, img_det = model.image_d_loss(x, y, fake, generator=self.rng,
                                                draws=draws.get("img"))
        _step(self.opt_img_d, model.image_discriminator, img_total, self.grid)
        grad_total, grad_det = model.grad_d_loss(x, y, fake, generator=self.rng,
                                                 draws=draws.get("grad"))
        _step(self.opt_grad_d, model.grad_discriminator, grad_total, self.grid)
        g_total, g_det = model.g_loss_terms(fake, x, y)
        _generator_step(self.opt_g, model.generator, g_total, self.grid)
        metrics = {k: v.detach() for k, v in {**img_det, **grad_det, **g_det}.items()}
        metrics.update(d_img_loss=img_total.detach(), d_grad_loss=grad_total.detach(),
                       g_loss=g_total.detach())
        return mean_metrics(self.grid, metrics)
