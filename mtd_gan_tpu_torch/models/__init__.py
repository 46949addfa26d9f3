"""Model registry of the PyTorch/CUDA port (counterpart of
``mtd_gan_tpu/models/__init__.py``; reference models.py:19-80).

The ported names build through :func:`get_model`; the JAX package's
aliases (``MTD_GAN``, ``ED_CNN``, ...) resolve first, as there. Every name
of the JAX registry is ported; any other name raises ``KeyError``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

ALIASES = {
    "MTD_GAN": "MTD_GAN_Method",
    "ED_CNN": "EDCNN",
    "MAP_NN_brain": "MAP_NN",
    "DU_GAN_brain": "DU_GAN",
}


def resolve_alias(name: str) -> str:
    return ALIASES.get(name, name)


def registry() -> Dict[str, Callable[..., Any]]:
    """Ported name -> constructor (keyword arguments, ``device`` and
    ``seed`` among them)."""
    from mtd_gan_tpu_torch.models.ablations import ABLATIONS
    from mtd_gan_tpu_torch.models.ctformer import CTformerModel
    from mtd_gan_tpu_torch.models.diffusion import DDIMModel, DDPMModel, DPMModel, PNDMModel
    from mtd_gan_tpu_torch.models.dugan import DUGANModel
    from mtd_gan_tpu_torch.models.edcnn import EDCNNModel
    from mtd_gan_tpu_torch.models.map_nn import MAPNNModel
    from mtd_gan_tpu_torch.models.mtd_gan import MTDGANModel
    from mtd_gan_tpu_torch.models.red_cnn import REDCNNModel
    from mtd_gan_tpu_torch.models.restormer import RestormerModel
    from mtd_gan_tpu_torch.models.wgan_vgg import WGANVGGModel

    return {"RED_CNN": REDCNNModel, "EDCNN": EDCNNModel, "CTformer": CTformerModel,
            "Restormer": RestormerModel, "WGAN_VGG": WGANVGGModel, "MAP_NN": MAPNNModel,
            "DU_GAN": DUGANModel, "MTD_GAN_Method": MTDGANModel, "DDPM": DDPMModel,
            "DDIM": DDIMModel, "PNDM": PNDMModel, "DPM": DPMModel, **ABLATIONS}


def ported_names() -> tuple:
    """Every name :func:`get_model` builds, the aliases included."""
    names = tuple(registry())
    return names + tuple(a for a, n in ALIASES.items() if n in names)


def get_model_class(name: str) -> Callable[..., Any]:
    """The constructor for a reference-compatible name."""
    resolved = resolve_alias(name)
    table = registry()
    if resolved in table:
        return table[resolved]
    raise KeyError(f"unknown model {name!r}; known: {sorted(table)}")


def get_model(name: str, **kwargs):
    """Build a model by reference-compatible name."""
    return get_model_class(name)(**kwargs)
