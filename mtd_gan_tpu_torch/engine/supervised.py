"""Supervised trainer of the CNN, transformer and diffusion families
(counterpart of ``mtd_gan_tpu/engine/supervised.py``; reference
engine.py:192-414, 789-897).

One step: the model's self-contained loss (its random draws, such as
CTformer's dropout or a diffusion model's noise and timesteps, from the
trainer's ``torch.Generator``, seeded from ``seed``), its backward, one
AdamW step (lr 1e-4, decoupled weight decay 5e-4,
``optim.get_optimizer``) over the network's trainable parameters (buffers
such as EDCNN's Sobel bank and CTformer's performer ``w`` take none).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from mtd_gan_tpu_torch import optim

Tensor = torch.Tensor


class SupervisedTrainer:
    """``model`` exposes ``net``, ``loss(x, y) -> (value, details)`` and
    ``predict``."""

    def __init__(self, model, optimizer: str = "adamw", lr: float = 1e-4,
                 weight_decay: float = 5e-4, seed: int = 0):
        self.model = model
        params = [p for p in model.net.parameters() if p.requires_grad]
        self.opt = optim.get_optimizer(optimizer, params, lr, weight_decay)
        self.rng = torch.Generator(device=model.device).manual_seed(seed)

    def set_epoch_lr(self, lr: float) -> None:
        optim.set_learning_rate(self.opt, lr)

    def train_step(self, x: Tensor, y: Tensor, draws: Optional[Dict] = None
                   ) -> Dict[str, Tensor]:
        """One step on NHWC ``x``, ``y`` on the model's device; returns the
        loss and its details as 0-d tensors. ``draws``: the loss's random
        draws, given in place of the generator's (the diffusion models'
        noise and timesteps)."""
        self.model.net.train()
        kw = {} if draws is None else {"draws": draws}
        loss, details = self.model.loss(x, y, generator=self.rng, **kw)
        loss.backward()
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        metrics = {k: v.detach() for k, v in details.items()}
        metrics["loss"] = loss.detach()
        return metrics

    def predict(self, x: Tensor) -> Tensor:
        return self.model.predict(x)
