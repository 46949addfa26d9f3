"""Test CLI of the port — the MTD-GAN metric sweep over a test split
(counterpart of the root ``test.py`` for ``--model MTD_GAN_Method``).

    python -m mtd_gan_tpu_torch.test --data-root DATA --resume ckpt.pth \
        --no-feature-metrics [--device cuda|cpu]

Loads the generator from a reference-layout ``.pth``, runs full-image
inference in groups of ``--eval-batch`` slices, computes RMSE/PSNR/SSIM per
slice, writes a PNG per slice, ``pred_results.csv``, ``test_summary.json``
and appends a JSON line to ``test_log.txt`` in ``--save-dir``.
"""

from __future__ import annotations

import argparse
import json
import os

from mtd_gan_tpu_torch._device import resolve_device
from mtd_gan_tpu_torch.data.pipeline import PairedDicomDataset, eval_loader
from mtd_gan_tpu_torch.data.transforms import make_eval_preprocess
from mtd_gan_tpu_torch.engine.loops import run_test
from mtd_gan_tpu_torch.models.mtd_gan import MTDGANModel
from mtd_gan_tpu_torch.utils.torch_import import load_reference_checkpoint

PORTED_MODELS = ("MTD_GAN_Method",)


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("MTD-GAN test (PyTorch/CUDA)", add_help=False)
    p.add_argument("--dataset", default="mayo", type=str)
    p.add_argument("--data-root", default="", type=str)
    p.add_argument("--split", default="test", type=str)
    p.add_argument("--dataset-type-test", default="window", type=str)
    p.add_argument("--test-batch-size", default=1, type=int)
    p.add_argument("--model", default="MTD_GAN_Method", type=str)
    p.add_argument("--device", default="cuda", type=str)
    p.add_argument("--save-dir", default="predictions/test", type=str)
    p.add_argument("--resume", required=True, type=str,
                   help="reference-layout .pth checkpoint "
                        "({'model_state_dict': {'Generator.…': …}})")
    p.add_argument("--eval-batch", default=8, type=int,
                   help="slices per forward in the sweep (metrics/PNGs stay "
                        "per slice)")
    p.add_argument("--no-feature-metrics", action="store_true",
                   help="skip PL/TML/FID (required: not ported yet)")
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--model-kwargs", default="", type=str,
                   help='JSON kwargs for the model ctor, e.g. '
                        '\'{"gen_features": 32, "num_layers": 10}\'')
    p.add_argument("--memo", default="", type=str)
    return p


def main(args) -> dict:
    if args.model not in PORTED_MODELS:
        raise NotImplementedError(
            f"model {args.model!r} is not ported yet (ROADMAP.md queue 1, "
            f"items 8-11); ported: {PORTED_MODELS}")
    device = resolve_device(args.device)
    kwargs = json.loads(args.model_kwargs or "{}")
    model = MTDGANModel(**kwargs, device=device, seed=args.seed)
    epoch, state = load_reference_checkpoint(args.resume)
    model.generator.load_state_dict(state, strict=True)
    print(f"restored epoch {epoch} from {args.resume}")

    ds = PairedDicomDataset(args.data_root, args.split)
    print(f"test slices: {len(ds)}")
    summary = run_test(
        model, eval_loader(ds, args.test_batch_size),
        make_eval_preprocess(args.dataset_type_test, args.dataset), "mtd",
        save_dir=args.save_dir,
        compute_fid_metric=not args.no_feature_metrics,
        compute_feature_metrics=not args.no_feature_metrics,
        eval_batch=args.eval_batch)
    line = {"epoch": epoch, "model": args.model, **summary, "memo": args.memo}
    os.makedirs(args.save_dir, exist_ok=True)
    with open(os.path.join(args.save_dir, "test_log.txt"), "a") as f:
        f.write(json.dumps(line) + "\n")
    print(json.dumps(line, indent=2))
    return summary


if __name__ == "__main__":
    parser = argparse.ArgumentParser("MTD-GAN test (PyTorch/CUDA)",
                                     parents=[get_args_parser()])
    main(parser.parse_args())
