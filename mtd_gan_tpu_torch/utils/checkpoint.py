"""Training checkpoints in the reference layout (counterpart of
``mtd_gan_tpu/utils/checkpoint.py``; reference train.py:146-173, 276-310).

One ``torch.save`` dict per epoch: ``model_state_dict``, the optimizers,
``scheduler`` (the epoch it was last stepped to), ``epoch`` and ``args``.

* A supervised model (RED_CNN, EDCNN, CTformer, Restormer;
  ``SupervisedTrainer``): the flat ``model_state_dict`` of its network
  (CTformer's fixed performer ``w`` included) and one ``optimizer``.
* An adversarial model (MTD_GAN_Method, the ablations, WGAN_VGG, MAP_NN):
  ``Generator.*`` and ``Discriminator.*`` (the discriminator with its
  spectral-norm ``weight_u`` / ``weight_v`` where it has them),
  ``optimizer_G`` and ``optimizer_D``.
* DU_GAN (``DUGANTrainer``): ``Generator.*``, ``Image_Discriminator.*`` and
  ``Grad_Discriminator.*`` (their ``u`` / ``v``), ``optimizer_G``,
  ``optimizer_Img_D`` and ``optimizer_Grad_D``.
  ``MTDGANTrainer`` adds the multi-task method's state: ``mto_method`` (its
  name, ``None`` for the plain sum), ``mto_state`` (step, UW's log-sigma,
  DWA's cost history and weights, NashMTL's alpha) and ``optimizer_mto``
  (UW's log-sigma optimizer), so that a resume goes on with the method
  exactly where it stopped (the reference drops it, quirk 5; the JAX
  package saves it too).

Restoring needs every key: a checkpoint is read whole or not at all.
:func:`load_pretrained` is the params-only warm start of
``--from-pretrained``; it also reads a reference discriminator's names
(``torch_import.reference_discriminator_state_dict``).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import torch
from torch import nn

from mtd_gan_tpu_torch.mto.methods import MTOState
from mtd_gan_tpu_torch.utils.torch_import import (reference_discriminator_state_dict,
                                                  strip_module_prefixes)


def networks(model) -> Dict[str, nn.Module]:
    """``model_state_dict`` prefix -> module: ``{"": net}`` for a supervised
    model, ``Generator.``, ``Image_Discriminator.`` and
    ``Grad_Discriminator.`` for DU-GAN, else ``Generator.`` and
    ``Discriminator.``."""
    if hasattr(model, "net"):
        return {"": model.net}
    if hasattr(model, "image_discriminator"):
        return {"Generator.": model.generator,
                "Image_Discriminator.": model.image_discriminator,
                "Grad_Discriminator.": model.grad_discriminator}
    return {"Generator.": model.generator, "Discriminator.": model.discriminator}


def _optimizers(trainer) -> Dict[str, torch.optim.Optimizer]:
    if hasattr(trainer, "opt"):
        return {"optimizer": trainer.opt}
    if hasattr(trainer, "opt_img_d"):
        return {"optimizer_G": trainer.opt_g, "optimizer_Img_D": trainer.opt_img_d,
                "optimizer_Grad_D": trainer.opt_grad_d}
    return {"optimizer_G": trainer.opt_g, "optimizer_D": trainer.opt_d}


def save_checkpoint(path: str, model, trainer, epoch: int,
                    args: argparse.Namespace) -> None:
    sd = {prefix + k: v for prefix, module in networks(model).items()
          for k, v in module.state_dict().items()}
    ckpt = {"model_state_dict": sd,
            **{k: opt.state_dict() for k, opt in _optimizers(trainer).items()},
            "scheduler": {"last_epoch": epoch}, "epoch": epoch, "args": args}
    if hasattr(trainer, "mto_state"):
        state = trainer.mto_state
        ckpt.update(mto_method=trainer.method,
                    mto_state=state.to_dict() if state is not None else None,
                    optimizer_mto=(trainer.opt_mto.state_dict()
                                   if trainer.opt_mto is not None else None))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)  # a cut run never leaves half a checkpoint


def load_checkpoint(path: str) -> Dict:
    with torch.serialization.safe_globals([argparse.Namespace]):
        return torch.load(path, map_location="cpu", weights_only=True)


def load_model_state_dict(model, sd: Dict[str, torch.Tensor]) -> None:
    """A ``model_state_dict`` (``module.`` segments stripped, a reference
    discriminator's names mapped) into the model's networks, each
    ``strict=True``."""
    sd = strip_module_prefixes(sd)
    for prefix, module in networks(model).items():
        part = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
        if hasattr(module, "heads"):  # an MTD-GAN discriminator
            part = reference_discriminator_state_dict(part, module.heads)
        module.load_state_dict(part, strict=True)


def load_pretrained(path: str, model) -> int:
    """Params-only warm start (root train.py:160-170): the model's tensors,
    spectral-norm ``u`` / ``v`` included (:func:`load_model_state_dict`);
    optimizers and method state stay fresh. Returns the checkpoint's
    epoch."""
    ckpt = load_checkpoint(path)
    load_model_state_dict(model, ckpt["model_state_dict"])
    return int(ckpt["epoch"])


def restore(path: str, model, trainer) -> int:
    """Loads the model, the optimizers and, for ``MTDGANTrainer``, the
    method's state and optimizer; returns the epoch the checkpoint was
    written after. The checkpoint's method must be the trainer's."""
    ckpt = load_checkpoint(path)
    has_method = hasattr(trainer, "mto_state")
    if has_method and "mto_method" not in ckpt:
        raise ValueError(f"{path} holds no MTO method state (it was written before "
                         f"checkpoints carried one) and cannot be resumed; start "
                         f"from its parameters with --from-pretrained")
    if has_method and ckpt["mto_method"] != trainer.method:
        raise ValueError(f"{path} was written with method {ckpt['mto_method']!r}, "
                         f"the trainer runs {trainer.method!r}")
    epoch = load_pretrained(path, model)
    for key, opt in _optimizers(trainer).items():
        opt.load_state_dict(ckpt[key])
    if has_method and trainer.mto_state is not None:
        saved = MTOState(**ckpt["mto_state"])
        if trainer.opt_mto is not None:
            # the optimizer holds the log-sigma tensor itself: update it in place
            trainer.mto_state.logsigma.copy_(saved.logsigma)
            saved.logsigma = trainer.mto_state.logsigma
            trainer.opt_mto.load_state_dict(ckpt["optimizer_mto"])
        trainer.mto_state = saved
    return epoch
