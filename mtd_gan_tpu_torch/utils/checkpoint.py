"""Training checkpoints in the reference layout (counterpart of
``mtd_gan_tpu/utils/checkpoint.py``; reference train.py:146-173, 276-310).

One ``torch.save`` dict per epoch: ``model_state_dict`` (``Generator.*`` and
``Discriminator.*``, the discriminator with its spectral-norm ``weight_u`` /
``weight_v``), ``optimizer_G``, ``optimizer_D``, ``scheduler`` (the epoch
it was last stepped to), ``epoch`` and ``args``. Restoring needs every
key: a checkpoint is read whole or not at all.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import torch


def save_checkpoint(path: str, model, trainer, epoch: int,
                    args: argparse.Namespace) -> None:
    sd = {f"Generator.{k}": v for k, v in model.generator.state_dict().items()}
    sd.update({f"Discriminator.{k}": v
               for k, v in model.discriminator.state_dict().items()})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"model_state_dict": sd,
                "optimizer_G": trainer.opt_g.state_dict(),
                "optimizer_D": trainer.opt_d.state_dict(),
                "scheduler": {"last_epoch": epoch},
                "epoch": epoch, "args": args}, tmp)
    os.replace(tmp, path)  # a cut run never leaves half a checkpoint


def load_checkpoint(path: str) -> Dict:
    with torch.serialization.safe_globals([argparse.Namespace]):
        return torch.load(path, map_location="cpu", weights_only=True)


def restore(path: str, model, trainer) -> int:
    """Loads model, both optimizers and the trainer's device; returns the
    epoch the checkpoint was written after."""
    ckpt = load_checkpoint(path)
    sd = ckpt["model_state_dict"]
    for prefix, module in (("Generator.", model.generator),
                           ("Discriminator.", model.discriminator)):
        module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                                if k.startswith(prefix)}, strict=True)
    trainer.opt_g.load_state_dict(ckpt["optimizer_G"])
    trainer.opt_d.load_state_dict(ckpt["optimizer_D"])
    return int(ckpt["epoch"])
