"""MTD-GAN trainer: the hoisted step with a multi-task method on the
discriminator (counterpart of ``mtd_gan_tpu/engine/gan.py::MTDGANTrainer``;
reference engine.py:26-76).

One step, on NHWC ``(N, 64, 64, 1)`` patches:

1. one generator forward ``fake = G(x)``, whose graph is kept for the G
   update: through
   :func:`~mtd_gan_tpu_torch.ops.cuda_train.resfft_generator_train` (K1
   forward, K2 backward on the card; their plain versions on the CPU) where
   both kernels take the batch, else the plain generator under autograd
   (:func:`~mtd_gan_tpu_torch.ops.cuda_train.train_route`);
2. the D update on the detached fake: ``d_loss`` with the spectral-norm
   state frozen, one gradient per task, the method's combination (or the
   plain sum without a method), AdamW; the parameters the method gives no
   gradient (PCGrad: the unassigned ones; CAGrad: all but the shared ones)
   take no step and no decay (their ``.grad`` stays ``None``); UW's
   log-sigma takes its own AdamW step on its analytic gradient;
3. the spectral-norm ``u`` advanced 4 times with the PRE-update weights;
4. the G update: ``g_loss_terms`` on the POST-update D (storing one more
   power iteration), backpropagated through the saved G graph, AdamW.

On a :class:`~mtd_gan_tpu_torch.parallel.mesh.Grid` (``--multi-gpu-mode``)
each rank takes its rows of the global batch; the step equals the
single-rank step on the whole batch (JAX: the same jitted step on a
sharded mesh). The batch-shaped draws are taken at the global shape and
sliced (``mesh.batch_draws``); each task's D gradient and the task losses
are averaged over the data group before the method combines them (UW's
log-sigma gradient and the method's state see the global losses), the
generator's gradient before its AdamW step, and the metrics returned are
the global means. With ``tensor_parallel`` the generator forward is
``parallel/tensor.py::tp_generate`` over the model group, and its gradient
is summed over that group (each rank holds its share) before the mean over
the data group; the rest of the step is replicated over the model group.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from mtd_gan_tpu_torch import optim
from mtd_gan_tpu_torch.models.base import param_labels
from mtd_gan_tpu_torch.models.mtd_gan import check_discriminator_input
from mtd_gan_tpu_torch.mto.methods import (combine_grads, get_method, per_task_grads,
                                           random_order, uw_logsigma_grad)
from mtd_gan_tpu_torch.ops.cuda_train import (G_FORWARDS, resfft_generator_train,
                                              resolve_g_forward)
from mtd_gan_tpu_torch.ops.layers import advance_spectral_state
from mtd_gan_tpu_torch.parallel.mesh import (Grid, batch_draws, mean_metrics, mean_over_data,
                                             sum_over_model)
from mtd_gan_tpu_torch.parallel.tensor import tp_generate

Tensor = torch.Tensor

# UW's log-sigma learning rate at the base lr (reference train.py:122-124)
METHOD_LR = 0.025


class MTDGANTrainer:
    """Holds the model's optimizers, the method's state and the step's random
    generators. ``seed`` seeds the dropout masks, PCGrad's orders and RLW's
    draws. After each step ``task_weights`` holds the method's reported
    task weights (the JAX step computes them and leaves them out of its
    metrics, so the port does too). ``grid``: the ranks of a multi-rank
    step, ``tensor_parallel`` the generator split over its model group
    (module docstring); ``g_forward``: the generator's route
    (``ops/cuda_train.py::resolve_g_forward``; under tensor parallelism
    only ``"auto"``, which is ``tp_generate``)."""

    def __init__(self, model, method: Optional[str] = "pcgrad",
                 optimizer: str = "adamw", lr: float = 1e-4,
                 weight_decay: float = 5e-4, sn_iters: int = 4, seed: int = 0,
                 grid: Optional[Grid] = None, tensor_parallel: bool = False,
                 g_forward: str = "auto"):
        if g_forward not in G_FORWARDS:
            raise ValueError(f"g_forward must be one of {G_FORWARDS}, got {g_forward!r}")
        if tensor_parallel and grid is None:
            raise ValueError("tensor_parallel needs a grid")
        if tensor_parallel and g_forward != "auto":
            raise ValueError(f"g_forward={g_forward!r}: under TensorParallel the generator "
                             f"runs tp_generate (g_forward='auto')")
        self.model = model
        self.grid = grid
        self.tensor_parallel = tensor_parallel
        self.g_forward = g_forward
        self.mto = get_method(method, n_tasks=model.n_d_tasks) if method else None
        self.method = self.mto.name if self.mto else None
        self.mto_state = self.mto.init_state() if self.mto else None
        self.task_weights: Optional[Tensor] = None
        self.base_lr = lr
        # UW's learnable log-sigma: a second AdamW (the JAX tx_mto)
        self.opt_mto = (torch.optim.AdamW([self.mto_state.logsigma], lr=METHOD_LR,
                                          betas=(0.9, 0.999), eps=1e-8,
                                          weight_decay=5e-4)
                        if self.method == "uw" else None)
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
        # the reference scheduler scales both optimizer_D groups, UW's too
        if self.opt_mto is not None:
            optim.set_learning_rate(self.opt_mto, METHOD_LR * lr / self.base_lr)

    def d_update(self, x: Tensor, y: Tensor, fake: Tensor,
                 order: Optional[Tensor] = None, draw: Optional[Tensor] = None):
        """Steps D on the detached ``fake``; returns the stacked losses and
        the details. ``order``: PCGrad's orders, ``draw``: RLW's normals
        (drawn when ``None``)."""
        model = self.model
        model.discriminator.train()
        losses, details = model.d_loss(x, y, fake, update_stats=False,
                                       generator=self.rng)
        task_grads = per_task_grads(losses, self.d_params)
        if self.grid is not None:
            n_p = len(self.d_params)
            flat = mean_over_data(self.grid, [g for gs in task_grads for g in gs] + [losses])
            task_grads = [flat[i * n_p:(i + 1) * n_p] for i in range(len(task_grads))]
            losses = flat[-1]
        k = model.n_d_tasks
        if self.method == "pcgrad" and order is None:
            order = random_order(k, self.order_rng)
        if self.method == "rlw" and draw is None:
            draw = torch.randn(k, generator=self.order_rng)
        grads, new_state, self.task_weights = combine_grads(
            self.mto, task_grads, self.d_labels, order, losses, self.mto_state, draw)
        if self.opt_mto is not None:  # UW: log-sigma's step on the old value
            self.mto_state.logsigma.grad = uw_logsigma_grad(self.mto_state, losses)
            self.opt_mto.step()
            self.opt_mto.zero_grad(set_to_none=True)
        self.mto_state = new_state
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
        if self.grid is not None:
            grads = mean_over_data(self.grid, sum_over_model(self.grid, grads))
        return total, details, grads

    def train_step(self, x: Tensor, y: Tensor, order: Optional[Tensor] = None,
                   draw: Optional[Tensor] = None) -> Dict[str, Tensor]:
        """One step on ``x``, ``y`` (N, H, W, 1) on the model's device (with a
        grid: this rank's rows of the global batch, ``mesh.shard_batch``).
        ``order``: PCGrad projection orders, ``(3, 3)``, one permutation per
        task; ``draw``: RLW's three normals (each drawn when ``None``).
        Returns the step's metrics as 0-d tensors (``d_loss`` the sum of the
        three task losses, ``g_loss`` the total)."""
        model = self.model
        gen = model.generator.train()
        n, h, w, _ = x.shape
        check_discriminator_input(h, w)
        route = ("tp" if self.tensor_parallel else
                 resolve_g_forward(self.g_forward, h, w, model.gen_features))
        if route == "tp":
            fake = tp_generate(gen, x, self.grid)
        elif route == "pallas":
            fake = resfft_generator_train(gen, x)
        else:
            fake = gen(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        with batch_draws(self.grid, n):
            d_losses, d_details = self.d_update(x, y, fake, order, draw)
            g_total, g_details, grads = self.generator_grads(fake, x, y)
        for p, g in zip(gen.parameters(), grads):
            p.grad = g
        self.opt_g.step()
        self.opt_g.zero_grad(set_to_none=True)
        metrics = {k: v.detach() for k, v in {**d_details, **g_details}.items()}
        metrics["g_loss"] = g_total.detach()
        metrics = mean_metrics(self.grid, metrics)
        metrics["d_loss"] = d_losses.sum()
        return metrics
