"""Parameter partitions for multi-task gradient surgery (counterpart of
``mtd_gan_tpu/models/base.py::param_labels``)."""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from torch import nn


def param_labels(module: nn.Module,
                 label_fn: Callable[[Tuple[str, ...]], str]) -> Dict[str, str]:
    """``{parameter name: label_fn(name split on '.')}`` over
    ``module.named_parameters()``, top-level module name first."""
    return {name: label_fn(tuple(name.split(".")))
            for name, _ in module.named_parameters()}
