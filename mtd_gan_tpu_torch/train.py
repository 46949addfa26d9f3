"""Training CLI of the port (counterpart of the root ``train.py``, with its
flags and defaults but ``--device``; reference train.py:22-67).

    python -m mtd_gan_tpu_torch.train --data-root DATA --batch-size 20 \
        [--model MTD_GAN_Method] --method pcgrad --epochs 500 \
        --checkpoint-dir ckpt --save-dir preds [--device cuda|cpu]

``--model``: ``MTD_GAN_Method`` (alias ``MTD_GAN``), the CNN family
``RED_CNN`` and ``EDCNN`` (alias ``ED_CNN``), one of the ten MTD-GAN
ablations ``Ablation_*`` (``models/ablations.py``), the WGAN family
``WGAN_VGG``, ``MAP_NN`` (alias ``MAP_NN_brain``) and ``DU_GAN`` (alias
``DU_GAN_brain``), the transformers ``CTformer`` and ``Restormer``, or the
diffusion models ``DDPM``, ``DDIM``, ``PNDM`` and ``DPM`` (the eps-MSE on
the conditioned UNet); ``--model-kwargs`` reaches the model's
constructor. For
MTD_GAN_Method ``--method`` picks the discriminator's multi-task method
(any of the eleven); without it, as at the root, the three task losses are
summed. The other GAN models have a scalar discriminator loss and no
method: a given ``--method`` is noted and not used, as at the root
(WGAN-VGG and MAP-NN take 4 critic updates a step, DU-GAN three
optimizers). The whole-slice presets ``full`` and ``window`` train
RED_CNN, EDCNN, DU_GAN, Restormer and the diffusion models; the 64x64
discriminators (MTD-GAN's, the ablations', the WGAN critic) and CTformer
refuse them. The transformers validate through the 64x64 sliding window,
the diffusion models too (overlap 0.5, the whole reverse chain per chunk
of 32 tiles, noise streams under ``--seed``).
Per epoch: the learning rate of ``--scheduler`` (``poly_lr`` or
``cosine_annealing_warm_restart``), shuffled batches of slices cut by the
``--dataset-type-train`` preset (``window_patch``: 8 random 64x64 crops
each) on the device, one trainer step per batch, validation on the
``valid`` split every ``--valid-every`` epochs, a JSON line in
``<checkpoint-dir>/log.txt``, TensorBoard scalars in
``<checkpoint-dir>/runs`` (where ``tensorboardX`` is installed) and a
reference-layout checkpoint ``<checkpoint-dir>/epoch_<n>.pth`` (which
``python -m mtd_gan_tpu_torch.test`` reads). ``--from-pretrained`` warm
starts the parameters from such a checkpoint, ``--resume`` goes on from
one; ``--profile-dir`` writes a ``torch.profiler`` trace of the first
epoch; the arguments are saved to
``<checkpoint-dir>/args/args_<stamp>.json``.

Several ranks (``parallel/mesh.py``), one process each::

    torchrun --standalone --nproc-per-node N -m mtd_gan_tpu_torch.train \
        --multi-gpu-mode DataParallel|TensorParallel [--tp-size M] ...

``DataParallel`` splits each global batch by rows over the ranks;
``TensorParallel`` (MTD_GAN_Method only) splits the generator's channels
over ``--tp-size`` ranks (-1: all of them) and the batch over the rest.
Every rank validates, so that no rank waits on another's validation
past the process group's timeout (NCCL's is 10 minutes; a diffusion
model's sampling takes longer); rank 0 alone writes the checkpoints,
``log.txt``, TensorBoard, the PNGs and the args snapshot while the others
wait at a barrier. ``--resume`` and ``--from-pretrained`` load the same
file on every rank. ``--g-forward`` picks the generator's route in
MTD_GAN_Method's step (``ops/cuda_train.py::resolve_g_forward``: ``auto``,
``einsum``, ``pallas``; ``pallas_packed`` is noted and runs as ``pallas``;
under TensorParallel only ``auto``).
``--g-precision`` (``bf16``, ``bf16x2``) names the TPU kernels' factor
table passes: the port's kernels compute their tables in fp32 either way.
``--bf16`` does what the root's does: every model whose constructor takes
``dtype`` gets ``torch.bfloat16`` (its layers compute in bf16, its
parameters, optimizer state and checkpoints stay fp32, so ``test
--resume`` loads the run as it is); the others print a note and train in
fp32.
"""

from __future__ import annotations

import argparse
import datetime
import inspect
import json
import os
import time

import torch

from mtd_gan_tpu_torch._device import resolve_device
from mtd_gan_tpu_torch.data.pipeline import PairedDicomDataset, eval_loader, train_loader
from mtd_gan_tpu_torch.data.transforms import make_eval_preprocess, make_train_preprocess
from mtd_gan_tpu_torch.engine.loops import build_trainer, family_of, train_one_epoch, validate
from mtd_gan_tpu_torch.losses import get_loss
from mtd_gan_tpu_torch.models import get_model, get_model_class, ported_names
from mtd_gan_tpu_torch.ops.cuda_train import G_FORWARDS
from mtd_gan_tpu_torch.optim import get_scheduler
from mtd_gan_tpu_torch.parallel import mesh
from mtd_gan_tpu_torch.utils.checkpoint import (load_pretrained, networks, restore,
                                                save_checkpoint)
from mtd_gan_tpu_torch.utils.logging import TensorBoardSink
from mtd_gan_tpu_torch.utils.profiling import trace

PORTED_MODELS = ported_names()


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("MTD-GAN train (PyTorch/CUDA)", add_help=False)
    p.add_argument("--dataset", default="mayo", type=str)
    p.add_argument("--data-root", default="", type=str)
    p.add_argument("--dataset-type-train", default="window_patch", type=str)
    p.add_argument("--dataset-type-valid", default="window", type=str)
    p.add_argument("--batch-size", default=20, type=int,
                   help="slices per step; the patch presets cut 8 crops of "
                        "64x64 from each")
    p.add_argument("--train-num-workers", default=4, type=int)
    p.add_argument("--valid-num-workers", default=4, type=int,
                   help="taken for the root CLI's sake: validation decodes "
                        "in order on the main thread, as there")
    p.add_argument("--model", default="MTD_GAN_Method", type=str,
                   help=f"one of {', '.join(PORTED_MODELS)}")
    p.add_argument("--loss", default="L1 Loss", type=str,
                   help="validation criterion")
    p.add_argument("--method", default="", type=str,
                   help="MTO method for the discriminator (ls, scaleinvls, stl, "
                        "uw, rlw, imtl, dwa, pcgrad, cagrad, mgda, nashmtl; "
                        "'' = the plain sum); MTD_GAN_Method only")
    p.add_argument("--optimizer", default="adamw", type=str)
    p.add_argument("--scheduler", default="poly_lr", type=str)
    p.add_argument("--epochs", default=500, type=int)
    p.add_argument("--warmup-epochs", default=10, type=int)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--min-lr", default=1e-5, type=float)
    p.add_argument("--multi-gpu-mode", default="Single", type=str,
                   choices=list(mesh.MODES),
                   help="DataParallel: the batch split over the ranks; "
                        "TensorParallel: MTD_GAN_Method's generator split by "
                        "channels over --tp-size ranks (run under torchrun)")
    p.add_argument("--tp-size", default=-1, type=int,
                   help="ranks a TensorParallel model group (-1: all)")
    p.add_argument("--g-forward", default="auto", type=str, choices=list(G_FORWARDS),
                   help="MTD_GAN_Method's generator in the step: auto (K1 + K2 "
                        "where they take the batch), einsum (plain autograd), "
                        "pallas (K1 + K2); pallas_packed runs as pallas")
    p.add_argument("--g-precision", default="bf16", type=str, choices=["bf16", "bf16x2"],
                   help="the TPU kernels' factor-table passes; the port's "
                        "kernels compute their tables in fp32 either way")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute on the models whose constructor takes a dtype "
                        "(the parameters stay fp32)")
    p.add_argument("--device", default="cuda", type=str)
    p.add_argument("--print-freq", default=10, type=int)
    p.add_argument("--save-checkpoint-every", default=1, type=int)
    p.add_argument("--checkpoint-dir", default="checkpoints", type=str)
    p.add_argument("--save-dir", default="predictions", type=str)
    p.add_argument("--from-pretrained", default="", type=str,
                   help="a checkpoint this CLI wrote: its parameters (and "
                        "spectral-norm state), fresh optimizers")
    p.add_argument("--resume", default="", type=str,
                   help="a checkpoint this CLI wrote; training goes on after "
                        "its epoch")
    p.add_argument("--valid-every", default=1, type=int)
    p.add_argument("--seed", default=2024, type=int)
    p.add_argument("--model-kwargs", default="", type=str,
                   help='JSON kwargs for the model ctor, e.g. '
                        '\'{"gen_features": 32, "disc_features": 64, "num_layers": 10}\'')
    p.add_argument("--profile-dir", default="", type=str,
                   help="write a torch.profiler trace of the first epoch here")
    p.add_argument("--memo", default="", type=str)
    return p


def _check_flags(args) -> None:
    """Raise for an unknown model name; note the TPU flags the port takes
    and does not use as the TPU does."""
    get_model_class(args.model)  # an unknown name raises
    if args.g_precision == "bf16x2":
        print("note: --g-precision bf16x2 is not used: the port's kernels compute "
              "their factor tables in fp32 on the CUDA cores, where bf16 tables buy "
              "nothing; under --bf16 the bf16 block boundaries set the error anyway "
              "(the JAX sweep: 2.8e-2 for bf16 tables against 3.0e-2, "
              "mtd_gan_tpu/engine/gan.py:149-156)", flush=True)
    if args.g_forward == "pallas_packed":
        print("note: --g-forward pallas_packed runs as pallas (K1 + K2): the TPU's "
              "K1-forward / plain-backward variant computes the same step", flush=True)


def main(args) -> dict:
    """One training run; under ``torchrun`` (or in a process group the
    caller began) this rank's part of it."""
    _check_flags(args)
    grid = mesh.make_grid(args.multi_gpu_mode, args.tp_size, args.device)
    try:
        return _train(args, grid)
    finally:
        mesh.destroy(grid)


def model_kwargs(args) -> dict:
    """``--model-kwargs``, with ``dtype=torch.bfloat16`` under ``--bf16``
    where the constructor takes a ``dtype`` (the root ``train.py:121-132``);
    for the others a note, and fp32."""
    kwargs = json.loads(args.model_kwargs or "{}")
    if args.bf16 and "dtype" not in kwargs:
        if "dtype" in inspect.signature(get_model_class(args.model)).parameters:
            kwargs["dtype"] = torch.bfloat16
        else:
            print(f"note: {args.model} does not support --bf16; using fp32", flush=True)
    return kwargs


def _train(args, grid) -> dict:
    device = grid.device if grid is not None else resolve_device(args.device)
    main_rank = mesh.is_main(grid)
    model = get_model(args.model, **model_kwargs(args), device=device, seed=args.seed)
    family = family_of(args.model)
    trainer = build_trainer(args.model, model, args, seed=args.seed, grid=grid)
    sched = get_scheduler(args.scheduler, args.lr, args.epochs, args.warmup_epochs,
                          args.min_lr)
    train_pre = make_train_preprocess(args.dataset_type_train, args.dataset)
    eval_pre = make_eval_preprocess(args.dataset_type_valid, args.dataset)
    train_ds = PairedDicomDataset(args.data_root, "train")
    valid_ds = PairedDicomDataset(args.data_root, "valid")
    print(f"train slices: {len(train_ds)}, valid slices: {len(valid_ds)}")
    n_params = sum(p.numel() for m in networks(model).values() for p in m.parameters())
    print(f"Number of Learnable Params: {n_params}")
    if grid is not None:
        print(f"rank {grid.rank} of {grid.world}: data {grid.data_rank} of "
              f"{grid.data_size}, model {grid.model_rank} of {grid.model_size}, "
              f"{device}", flush=True)

    start_epoch = 0
    if args.from_pretrained:
        load_pretrained(args.from_pretrained, model)
        print(f"warm-started params from {args.from_pretrained}")
    if args.resume:
        start_epoch = restore(args.resume, model, trainer) + 1
        print(f"resumed from {args.resume}; next epoch {start_epoch}")
    tb = None
    if main_rank:
        os.makedirs(args.checkpoint_dir, exist_ok=True)
        os.makedirs(args.save_dir, exist_ok=True)
        # args snapshot (reference train.py:330-337)
        stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        os.makedirs(os.path.join(args.checkpoint_dir, "args"), exist_ok=True)
        with open(os.path.join(args.checkpoint_dir, "args", f"args_{stamp}.json"), "w") as f:
            json.dump(vars(args), f, indent=2)
        tb = TensorBoardSink(os.path.join(args.checkpoint_dir, "runs"))
    crops = torch.Generator(device=device).manual_seed(args.seed)
    stats = {}
    for epoch in range(start_epoch, args.epochs):
        lr = sched(epoch)
        trainer.set_epoch_lr(lr)
        loader = train_loader(train_ds, args.batch_size, seed=args.seed + epoch,
                              num_threads=args.train_num_workers)
        with trace(args.profile_dir if epoch == start_epoch and main_rank else None):
            train_stats = train_one_epoch(trainer, loader, train_pre, crops,
                                          args.print_freq, header=f"Train: [{epoch}]",
                                          grid=grid)
        stats = {"epoch": epoch, "lr": lr,
                 **{f"train_{k}": v for k, v in train_stats.items()}}
        if epoch % args.valid_every == 0:
            valid_stats = validate(model, eval_loader(valid_ds), eval_pre, family, epoch,
                                   save_dir=(os.path.join(args.save_dir, "valid")
                                             if main_rank else None),
                                   criterion=get_loss(args.loss), seed=args.seed)
            stats.update({f"valid_{k}": v for k, v in valid_stats.items()})
        if not main_rank:
            mesh.barrier(grid)  # rank 0 writes
            continue
        with open(os.path.join(args.checkpoint_dir, "log.txt"), "a") as f:
            f.write(json.dumps(stats) + "\n")
        tb.scalars(stats, epoch)
        print(json.dumps(stats), flush=True)
        if epoch % args.save_checkpoint_every == 0 or epoch == args.epochs - 1:
            save_checkpoint(os.path.join(args.checkpoint_dir, f"epoch_{epoch}.pth"),
                            model, trainer, epoch, args)
        mesh.barrier(grid)
    if tb is not None:
        tb.close()
    decoded = {"train": dict(train_ds.decoded), "valid": dict(valid_ds.decoded)}
    print(f"decoded files by codec: {decoded}", flush=True)
    return {**stats, "decoded": decoded}


if __name__ == "__main__":
    parser = argparse.ArgumentParser("MTD-GAN train (PyTorch/CUDA)",
                                     parents=[get_args_parser()])
    start = time.time()
    main(parser.parse_args())
    print(f"total time: {datetime.timedelta(seconds=int(time.time() - start))}")
