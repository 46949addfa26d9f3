"""Training CLI of the port — the MTD-GAN PCGrad recipe (counterpart of the
root ``train.py`` for ``--model MTD_GAN_Method``; reference train.py:22-67).

    python -m mtd_gan_tpu_torch.train --data-root DATA --batch-size 20 \
        --method pcgrad --epochs 500 --checkpoint-dir ckpt --save-dir preds \
        [--device cuda|cpu]

Per epoch: the poly learning rate, shuffled batches of slices cut into 8
random 64x64 crops each (``window_patch``) on the device, one trainer step
per batch, validation on the ``valid`` split every ``--valid-every``
epochs, a JSON line in ``<checkpoint-dir>/log.txt`` and a reference-layout
checkpoint ``<checkpoint-dir>/epoch_<n>.pth`` (which
``python -m mtd_gan_tpu_torch.test --resume`` reads).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import time

import torch

from mtd_gan_tpu_torch._device import resolve_device
from mtd_gan_tpu_torch.data.pipeline import PairedDicomDataset, eval_loader, train_loader
from mtd_gan_tpu_torch.data.transforms import make_eval_preprocess, make_train_preprocess
from mtd_gan_tpu_torch.engine.gan import MTDGANTrainer
from mtd_gan_tpu_torch.engine.loops import train_one_epoch, validate
from mtd_gan_tpu_torch.losses import get_loss
from mtd_gan_tpu_torch.models.mtd_gan import MTDGANModel
from mtd_gan_tpu_torch.optim import get_scheduler
from mtd_gan_tpu_torch.utils.checkpoint import restore, save_checkpoint

PORTED_MODELS = ("MTD_GAN_Method",)


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("MTD-GAN train (PyTorch/CUDA)", add_help=False)
    p.add_argument("--dataset", default="mayo", type=str)
    p.add_argument("--data-root", default="", type=str)
    p.add_argument("--dataset-type-train", default="window_patch", type=str)
    p.add_argument("--dataset-type-valid", default="window", type=str)
    p.add_argument("--batch-size", default=20, type=int,
                   help="slices per step; each gives 8 crops of 64x64")
    p.add_argument("--train-num-workers", default=4, type=int)
    p.add_argument("--model", default="MTD_GAN_Method", type=str)
    p.add_argument("--loss", default="L1 Loss", type=str,
                   help="validation criterion")
    p.add_argument("--method", default="pcgrad", type=str,
                   help="MTO method for the discriminator ('' = plain sum)")
    p.add_argument("--optimizer", default="adamw", type=str)
    p.add_argument("--scheduler", default="poly_lr", type=str)
    p.add_argument("--epochs", default=500, type=int)
    p.add_argument("--warmup-epochs", default=10, type=int)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--min-lr", default=1e-5, type=float)
    p.add_argument("--multi-gpu-mode", default="Single", type=str)
    p.add_argument("--g-forward", default="auto", type=str)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--device", default="cuda", type=str)
    p.add_argument("--print-freq", default=10, type=int)
    p.add_argument("--save-checkpoint-every", default=1, type=int)
    p.add_argument("--checkpoint-dir", default="checkpoints", type=str)
    p.add_argument("--save-dir", default="predictions", type=str)
    p.add_argument("--resume", default="", type=str,
                   help="a checkpoint this CLI wrote; training goes on after "
                        "its epoch")
    p.add_argument("--valid-every", default=1, type=int)
    p.add_argument("--seed", default=2024, type=int)
    p.add_argument("--model-kwargs", default="", type=str,
                   help='JSON kwargs for the model ctor, e.g. '
                        '\'{"gen_features": 32, "disc_features": 64, "num_layers": 10}\'')
    return p


def _refuse_unported(args) -> None:
    if args.model not in PORTED_MODELS:
        raise NotImplementedError(
            f"model {args.model!r} is not ported yet (ROADMAP.md queue 1, "
            f"items 8-11); ported: {PORTED_MODELS}")
    if args.multi_gpu_mode != "Single":
        raise NotImplementedError(
            "--multi-gpu-mode other than Single is not ported yet (ROADMAP.md "
            "queue 1, item 14)")
    if args.g_forward != "auto" or args.bf16:
        raise NotImplementedError(
            "--g-forward and --bf16 are TPU options with no port (ROADMAP.md "
            "queue 1, item 5; bf16 boundaries are later work)")


def main(args) -> dict:
    _refuse_unported(args)
    device = resolve_device(args.device)
    kwargs = json.loads(args.model_kwargs or "{}")
    model = MTDGANModel(**kwargs, device=device, seed=args.seed)
    trainer = MTDGANTrainer(model, method=args.method or None,
                            optimizer=args.optimizer, lr=args.lr, seed=args.seed)
    sched = get_scheduler(args.scheduler, args.lr, args.epochs, args.warmup_epochs,
                          args.min_lr)
    train_pre = make_train_preprocess(args.dataset_type_train, args.dataset)
    eval_pre = make_eval_preprocess(args.dataset_type_valid, args.dataset)
    train_ds = PairedDicomDataset(args.data_root, "train")
    valid_ds = PairedDicomDataset(args.data_root, "valid")
    print(f"train slices: {len(train_ds)}, valid slices: {len(valid_ds)}")
    n_params = sum(p.numel() for m in (model.generator, model.discriminator)
                   for p in m.parameters())
    print(f"Number of Learnable Params: {n_params}")

    start_epoch = 0
    if args.resume:
        start_epoch = restore(args.resume, model, trainer) + 1
        print(f"resumed from {args.resume}; next epoch {start_epoch}")
    os.makedirs(args.checkpoint_dir, exist_ok=True)
    os.makedirs(args.save_dir, exist_ok=True)
    crops = torch.Generator(device=device).manual_seed(args.seed)
    stats = {}
    for epoch in range(start_epoch, args.epochs):
        lr = sched(epoch)
        trainer.set_epoch_lr(lr)
        loader = train_loader(train_ds, args.batch_size, seed=args.seed + epoch,
                              num_threads=args.train_num_workers)
        train_stats = train_one_epoch(trainer, loader, train_pre, crops,
                                      args.print_freq, header=f"Train: [{epoch}]")
        stats = {"epoch": epoch, "lr": lr,
                 **{f"train_{k}": v for k, v in train_stats.items()}}
        if epoch % args.valid_every == 0:
            valid_stats = validate(model, eval_loader(valid_ds), eval_pre, epoch,
                                   save_dir=os.path.join(args.save_dir, "valid"),
                                   criterion=get_loss(args.loss))
            stats.update({f"valid_{k}": v for k, v in valid_stats.items()})
        with open(os.path.join(args.checkpoint_dir, "log.txt"), "a") as f:
            f.write(json.dumps(stats) + "\n")
        print(json.dumps(stats), flush=True)
        if epoch % args.save_checkpoint_every == 0 or epoch == args.epochs - 1:
            save_checkpoint(os.path.join(args.checkpoint_dir, f"epoch_{epoch}.pth"),
                            model, trainer, epoch, args)
    return stats


if __name__ == "__main__":
    parser = argparse.ArgumentParser("MTD-GAN train (PyTorch/CUDA)",
                                     parents=[get_args_parser()])
    start = time.time()
    main(parser.parse_args())
    print(f"total time: {datetime.timedelta(seconds=int(time.time() - start))}")
