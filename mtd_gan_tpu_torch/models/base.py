"""The supervised model protocol and the parameter partitions for
multi-task gradient surgery (counterpart of ``mtd_gan_tpu/models/base.py``)."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from mtd_gan_tpu_torch import losses
from mtd_gan_tpu_torch._device import DeviceLike, resolve_device

Tensor = torch.Tensor


def param_labels(module: nn.Module,
                 label_fn: Callable[[Tuple[str, ...]], str]) -> Dict[str, str]:
    """``{parameter name: label_fn(name split on '.')}`` over
    ``module.named_parameters()``, top-level module name first."""
    return {name: label_fn(tuple(name.split(".")))
            for name, _ in module.named_parameters()}


class SupervisedModel:
    """A single network ``net`` with a self-contained loss: ``apply``
    (differentiable) and ``predict`` (no graph) map NHWC to NHWC, ``loss``
    gives ``(criterion(apply(x), y), details)``, MSE unless a model sets
    another ``criterion``. ``device`` defaults to ``cuda`` and raises
    without a GPU; ``init(net, generator)`` draws the weights on the CPU
    from ``seed``."""

    criterion = staticmethod(losses.l2)

    def __init__(self, net: nn.Module, device: DeviceLike, seed: int, init):
        self.device = resolve_device(device)
        init(net, torch.Generator().manual_seed(seed))
        self.net = net.to(self.device)

    def apply(self, x: Tensor) -> Tensor:
        return self.net(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    @torch.no_grad()
    def predict(self, x: Tensor) -> Tensor:
        return self.apply(x)

    def loss(self, x: Tensor, y: Tensor, generator: Optional[torch.Generator] = None
             ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """``generator``: the random draws of a model that takes any (e.g.
        CTformer's dropout); unused here."""
        val = self.criterion(self.apply(x), y)
        return val, {"loss": val}
