"""Test CLI of the port — the metric sweep over a test split (counterpart
of the root ``test.py``, with its flags and defaults but ``--device``).

    python -m mtd_gan_tpu_torch.test --data-root DATA --checkpoint-dir ckpt \
        [--model MTD_GAN_Method] [--epoch N] [--no-feature-metrics] \
        [--device cuda|cpu]

``--model`` takes the train CLI's names: ``MTD_GAN_Method``, ``RED_CNN``,
``EDCNN``, the ten ``Ablation_*``, ``WGAN_VGG``, ``MAP_NN``, ``DU_GAN``,
``CTformer``, ``Restormer``, ``DDPM``, ``DDIM``, ``PNDM``, ``DPM`` and the
aliases; ``--model-kwargs`` reaches the model's constructor. Loads the
network the sweep runs from a reference-layout ``.pth`` (the generator's
``Generator.*``, or the flat ``model_state_dict`` of RED_CNN, EDCNN,
CTformer, Restormer and the diffusion models' UNet; CTformer and Restormer
through the sliding window at overlap 0.9, one slice at a time; the
diffusion models sample each whole slice from its own noise stream under
``--seed``): ``--resume``, else
``<checkpoint-dir>/epoch_<n>.pth`` as the train CLI writes it (the epoch
``--epoch`` names, the latest at -1). Runs full-image inference in groups
of ``--eval-batch`` slices, computes RMSE/PSNR/SSIM and, unless
``--no-feature-metrics``, PL and TML per slice and the corpus FIDs, writes a
PNG per slice, ``pred_results.csv``, ``test_summary.json`` and appends a
JSON line to ``test_log.txt`` in ``--save-dir``. The feature extractors
read the torchvision weight files WEIGHTS.md names, else take seeded
weights (``mtd_gan_tpu_torch/features/registry.py``). The flags that only
configure training (``--loss``, ``--lr``, ``--method``, ``--optimizer``,
``--print-freq``) and ``--test-num-workers`` are taken and unused, as at
the root.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
from typing import Dict, Optional

from mtd_gan_tpu_torch._device import resolve_device
from mtd_gan_tpu_torch.data.pipeline import PairedDicomDataset, eval_loader
from mtd_gan_tpu_torch.data.transforms import make_eval_preprocess
from mtd_gan_tpu_torch.engine.loops import family_of, run_test
from mtd_gan_tpu_torch.features import feature_weights_status
from mtd_gan_tpu_torch.models import get_model, get_model_class, ported_names
from mtd_gan_tpu_torch.utils.profiling import StepTimer
from mtd_gan_tpu_torch.utils.torch_import import load_reference_checkpoint

PORTED_MODELS = ported_names()


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("MTD-GAN test (PyTorch/CUDA)", add_help=False)
    p.add_argument("--dataset", default="mayo", type=str)
    p.add_argument("--data-root", default="", type=str)
    p.add_argument("--split", default="test", type=str)
    p.add_argument("--dataset-type-test", default="window", type=str)
    p.add_argument("--test-batch-size", default=1, type=int)
    p.add_argument("--test-num-workers", default=4, type=int,
                   help="taken for the root CLI's sake: the sweep decodes in "
                        "order on the main thread, as there")
    p.add_argument("--model", default="MTD_GAN_Method", type=str,
                   help=f"one of {', '.join(PORTED_MODELS)}")
    p.add_argument("--loss", default="L1 Loss", type=str)
    p.add_argument("--method", default="", type=str)
    p.add_argument("--optimizer", default="adamw", type=str)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--multi-gpu-mode", default="Single", type=str)
    p.add_argument("--device", default="cuda", type=str)
    p.add_argument("--print-freq", default=10, type=int)
    p.add_argument("--checkpoint-dir", default="checkpoints", type=str)
    p.add_argument("--save-dir", default="predictions/test", type=str)
    p.add_argument("--resume", default="", type=str,
                   help="reference-layout .pth checkpoint "
                        "({'model_state_dict': {'Generator.…': …}}, flat for "
                        "RED_CNN and EDCNN); default: "
                        "<checkpoint-dir>/epoch_<epoch>.pth")
    p.add_argument("--epoch", default=-1, type=int,
                   help="epoch to restore from --checkpoint-dir (-1 = latest)")
    p.add_argument("--eval-batch", default=None, type=int,
                   help="slices per forward in the sweep (metrics/PNGs stay "
                        "per slice); default 1 for the diffusion models, else 8")
    p.add_argument("--no-feature-metrics", action="store_true",
                   help="skip PL/TML/FID (no pretrained weights scenario)")
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--model-kwargs", default="", type=str,
                   help='JSON kwargs for the model ctor, e.g. '
                        '\'{"gen_features": 32, "num_layers": 10}\'')
    p.add_argument("--memo", default="", type=str)
    return p


def default_eval_batch(family: str) -> int:
    """The sweep's slices per forward when ``--eval-batch`` is not given:
    1 for ``dn`` (root test.py:86-88), else 8."""
    return 1 if family == "dn" else 8


def checkpoint_path(checkpoint_dir: str, epoch: int = -1) -> str:
    """``<checkpoint_dir>/epoch_<epoch>.pth``, the highest epoch at -1
    (root test.py:36-40, :78-80, on the files the train CLI writes)."""
    if epoch >= 0:
        path = os.path.join(checkpoint_dir, f"epoch_{epoch}.pth")
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint {path}")
        return path
    found = {int(m.group(1)): p for p in glob.glob(os.path.join(checkpoint_dir, "epoch_*.pth"))
             if (m := re.fullmatch(r"epoch_(\d+)\.pth", os.path.basename(p)))}
    if not found:
        raise FileNotFoundError(f"no epoch_<n>.pth checkpoints under {checkpoint_dir}")
    return found[max(found)]


def main(args, phases: Optional[Dict[str, StepTimer]] = None) -> dict:
    """The sweep; ``phases`` receives the host seconds by phase (model load,
    then :func:`~mtd_gan_tpu_torch.engine.loops.run_test`'s)."""
    get_model_class(args.model)  # an unported name raises, naming its item
    if args.multi_gpu_mode != "Single":
        raise NotImplementedError(
            "--multi-gpu-mode other than Single is not ported yet (ROADMAP.md "
            "queue 1, item 14)")
    device = resolve_device(args.device)
    load = StepTimer(sync=device.type == "cuda")
    with load:
        kwargs = json.loads(args.model_kwargs or "{}")
        model = get_model(args.model, **kwargs, device=device, seed=args.seed)
        family = family_of(args.model)
        path = args.resume or checkpoint_path(args.checkpoint_dir, args.epoch)
        net = model.net if family in ("cnn", "tr", "dn") else model.generator
        epoch, state = load_reference_checkpoint(path, args.model, keys=net.state_dict())
        net.load_state_dict(state, strict=True)
    if phases is not None:
        phases["load"] = load
    print(f"restored epoch {epoch} from {path}")

    ds = PairedDicomDataset(args.data_root, args.split)
    print(f"test slices: {len(ds)}")
    summary = run_test(
        model, eval_loader(ds, args.test_batch_size),
        make_eval_preprocess(args.dataset_type_test, args.dataset), family,
        save_dir=args.save_dir,
        compute_fid_metric=not args.no_feature_metrics,
        compute_feature_metrics=not args.no_feature_metrics,
        eval_batch=default_eval_batch(family) if args.eval_batch is None else args.eval_batch,
        phases=phases, seed=args.seed)
    line = {"epoch": epoch, "model": args.model, **summary, "memo": args.memo,
            "decoded": ds.decoded}
    if not args.no_feature_metrics:
        line["feature_weights"] = feature_weights_status()
    os.makedirs(args.save_dir, exist_ok=True)
    with open(os.path.join(args.save_dir, "test_log.txt"), "a") as f:
        f.write(json.dumps(line) + "\n")
    print(json.dumps(line, indent=2))
    return summary


if __name__ == "__main__":
    parser = argparse.ArgumentParser("MTD-GAN test (PyTorch/CUDA)",
                                     parents=[get_args_parser()])
    main(parser.parse_args())
