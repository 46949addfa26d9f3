"""MTD-GAN trainer: the hoisted PCGrad step (counterpart of
``mtd_gan_tpu/engine/gan.py::MTDGANTrainer``; reference engine.py:26-76).

One step, on NHWC ``(N, 64, 64, 1)`` patches:

1. one generator forward ``fake = G(x)``, whose graph is kept for the G
   update: through
   :func:`~mtd_gan_tpu_torch.ops.cuda_train.resfft_generator_train` (K1
   forward, K2 backward on the card; their plain versions on the CPU) where
   both kernels take the batch, else the plain generator under autograd
   (:func:`~mtd_gan_tpu_torch.ops.cuda_train.train_route`);
2. the D update on the detached fake: ``d_loss`` with the spectral-norm
   state frozen, one gradient per task, PCGrad (or the plain sum without a
   method), AdamW; under PCGrad the unassigned D parameters take no step
   and no decay (their ``.grad`` stays ``None``);
3. the spectral-norm ``u`` advanced 4 times with the PRE-update weights;
4. the G update: ``g_loss_terms`` on the POST-update D (storing one more
   power iteration), backpropagated through the saved G graph, AdamW.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from mtd_gan_tpu_torch import optim
from mtd_gan_tpu_torch.models.base import param_labels
from mtd_gan_tpu_torch.mto.methods import (check_method, combine_grads,
                                           per_task_grads, random_order)
from mtd_gan_tpu_torch.ops.cuda_train import resfft_generator_train, train_route
from mtd_gan_tpu_torch.ops.layers import advance_spectral_state

Tensor = torch.Tensor


class MTDGANTrainer:
    """Holds the model's optimizers and the step's random generator.
    ``seed`` seeds the dropout masks and the PCGrad orders."""

    def __init__(self, model, method: Optional[str] = "pcgrad",
                 optimizer: str = "adamw", lr: float = 1e-4,
                 weight_decay: float = 5e-4, sn_iters: int = 4, seed: int = 0):
        self.model = model
        self.method = check_method(method)
        self.sn_iters = sn_iters
        self.opt_g = optim.get_optimizer(optimizer, model.generator.parameters(),
                                         lr, weight_decay)
        self.opt_d = optim.get_optimizer(optimizer, model.discriminator.parameters(),
                                         lr, weight_decay)
        named = list(model.discriminator.named_parameters())
        self.d_params = [p for _, p in named]
        labels = param_labels(model.discriminator, model.d_param_label)
        self.d_labels = [labels[n] for n, _ in named]
        self.rng = torch.Generator(device=model.device).manual_seed(seed)
        self.order_rng = torch.Generator().manual_seed(seed)

    def set_epoch_lr(self, lr: float) -> None:
        optim.set_learning_rate(self.opt_g, lr)
        optim.set_learning_rate(self.opt_d, lr)

    def d_update(self, x: Tensor, y: Tensor, fake: Tensor,
                 order: Optional[Tensor] = None):
        """Steps D on the detached ``fake``; returns the stacked losses and
        the details."""
        model = self.model
        model.discriminator.train()
        losses, details = model.d_loss(x, y, fake, update_stats=False,
                                       generator=self.rng)
        task_grads = per_task_grads(losses, self.d_params)
        if self.method == "pcgrad" and order is None:
            order = random_order(model.n_d_tasks, self.order_rng)
        grads = combine_grads(self.method, task_grads, self.d_labels, order)
        # decoupled SN cadence: advance u with the pre-update weights
        advance_spectral_state(model.discriminator, self.sn_iters)
        for p, g in zip(self.d_params, grads):
            p.grad = g
        self.opt_d.step()
        self.opt_d.zero_grad(set_to_none=True)
        return losses.detach(), details

    def generator_grads(self, fake: Tensor, x: Tensor, y: Tensor):
        """``g_loss_terms`` on the current D (storing one power iteration)
        and its gradient w.r.t. the generator's parameters through ``fake``'s
        graph; returns ``(total, details, grads)``."""
        total, details = self.model.g_loss_terms(fake, x, y, update_stats=True,
                                                 generator=self.rng)
        grads = torch.autograd.grad(total, list(self.model.generator.parameters()))
        return total, details, grads

    def train_step(self, x: Tensor, y: Tensor, order: Optional[Tensor] = None
                   ) -> Dict[str, Tensor]:
        """One step on ``x``, ``y`` (N, H, W, 1) on the model's device.
        ``order``: PCGrad projection orders, ``(3, 3)``, one permutation per
        task (drawn when ``None``). Returns the step's metrics as 0-d tensors
        (``d_loss`` the sum of the three task losses, ``g_loss`` the total)."""
        model = self.model
        gen = model.generator.train()
        _, h, w, _ = x.shape
        if train_route(h, w, model.gen_features) == "kernels":
            fake = resfft_generator_train(gen, x)
        else:
            fake = gen(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        d_losses, d_details = self.d_update(x, y, fake, order)
        g_total, g_details, grads = self.generator_grads(fake, x, y)
        for p, g in zip(gen.parameters(), grads):
            p.grad = g
        self.opt_g.step()
        self.opt_g.zero_grad(set_to_none=True)
        metrics = {k: v.detach() for k, v in {**d_details, **g_details}.items()}
        metrics["d_loss"] = d_losses.sum()
        metrics["g_loss"] = g_total.detach()
        return metrics
