"""Training checkpoints in the reference layout (counterpart of
``mtd_gan_tpu/utils/checkpoint.py``; reference train.py:146-173, 276-310).

One ``torch.save`` dict per epoch: ``model_state_dict`` (``Generator.*`` and
``Discriminator.*``, the discriminator with its spectral-norm ``weight_u`` /
``weight_v``), ``optimizer_G``, ``optimizer_D``, ``scheduler`` (the epoch
it was last stepped to), ``epoch``, ``args``, and the multi-task method's
state: ``mto_method`` (its name, ``None`` for the plain sum), ``mto_state``
(step, UW's log-sigma, DWA's cost history and weights, NashMTL's alpha)
and ``optimizer_mto`` (UW's log-sigma optimizer), so that a resume goes on
with the method exactly where it stopped (the reference drops it, quirk 5;
the JAX package saves it too). Restoring needs every key: a checkpoint is
read whole or not at all. :func:`load_pretrained` is the params-only warm
start of ``--from-pretrained``.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import torch

from mtd_gan_tpu_torch.mto.methods import MTOState


def save_checkpoint(path: str, model, trainer, epoch: int,
                    args: argparse.Namespace) -> None:
    sd = {f"Generator.{k}": v for k, v in model.generator.state_dict().items()}
    sd.update({f"Discriminator.{k}": v
               for k, v in model.discriminator.state_dict().items()})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    state = trainer.mto_state
    torch.save({"model_state_dict": sd,
                "optimizer_G": trainer.opt_g.state_dict(),
                "optimizer_D": trainer.opt_d.state_dict(),
                "scheduler": {"last_epoch": epoch},
                "epoch": epoch, "args": args,
                "mto_method": trainer.method,
                "mto_state": state.to_dict() if state is not None else None,
                "optimizer_mto": (trainer.opt_mto.state_dict()
                                  if trainer.opt_mto is not None else None)}, tmp)
    os.replace(tmp, path)  # a cut run never leaves half a checkpoint


def load_checkpoint(path: str) -> Dict:
    with torch.serialization.safe_globals([argparse.Namespace]):
        return torch.load(path, map_location="cpu", weights_only=True)


def load_pretrained(path: str, model) -> int:
    """Params-only warm start (root train.py:160-170): the ``Generator.*``
    and ``Discriminator.*`` tensors, spectral-norm ``u`` / ``v`` included;
    optimizers and method state stay fresh. Returns the checkpoint's
    epoch."""
    ckpt = load_checkpoint(path)
    sd = ckpt["model_state_dict"]
    for prefix, module in (("Generator.", model.generator),
                           ("Discriminator.", model.discriminator)):
        module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                                if k.startswith(prefix)}, strict=True)
    return int(ckpt["epoch"])


def restore(path: str, model, trainer) -> int:
    """Loads model, both optimizers and the method's state and optimizer;
    returns the epoch the checkpoint was written after. The checkpoint's
    method must be the trainer's."""
    ckpt = load_checkpoint(path)
    if "mto_method" not in ckpt:
        raise ValueError(f"{path} holds no MTO method state (it was written before "
                         f"checkpoints carried one) and cannot be resumed; start "
                         f"from its parameters with --from-pretrained")
    if ckpt["mto_method"] != trainer.method:
        raise ValueError(f"{path} was written with method {ckpt['mto_method']!r}, "
                         f"the trainer runs {trainer.method!r}")
    epoch = load_pretrained(path, model)
    trainer.opt_g.load_state_dict(ckpt["optimizer_G"])
    trainer.opt_d.load_state_dict(ckpt["optimizer_D"])
    if trainer.mto_state is not None:
        saved = MTOState(**ckpt["mto_state"])
        if trainer.opt_mto is not None:
            # the optimizer holds the log-sigma tensor itself: update it in place
            trainer.mto_state.logsigma.copy_(saved.logsigma)
            saved.logsigma = trainer.mto_state.logsigma
            trainer.opt_mto.load_state_dict(ckpt["optimizer_mto"])
        trainer.mto_state = saved
    return epoch
