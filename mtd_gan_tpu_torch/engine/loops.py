"""Epoch loops of the MTD-GAN family: ``train_one_epoch``, ``validate`` and
the test-set metric sweep ``run_test`` (counterpart of
``mtd_gan_tpu/engine/loops.py``).

Training: per batch, the HU pair goes to the model's device, the train
preprocess cuts and augments the crops there, and one trainer step runs;
step metrics stay on the device and are fetched at print boundaries.
Validation: full-slice predictions, the criterion per slice, and PNGs of
the last slice.

Per slice: RMSE / PSNR / SSIM for the input, gt and prediction columns, a
PNG of the clipped prediction, and a row of ``pred_results.csv``; the means
go to ``test_summary.json``. Predictions run on groups of ``eval_batch``
loader items, the last group padded by repeating its last item (padded
outputs dropped), while metrics, PNGs and rows stay per item.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from mtd_gan_tpu_torch import losses as losses_lib
from mtd_gan_tpu_torch.metrics import pixel as pixel_metrics
from mtd_gan_tpu_torch.utils.artifacts import save_csv, save_png_gray
from mtd_gan_tpu_torch.utils.logging import MetricLogger

_METRIC_COLUMNS = ("input_rmse", "gt_rmse", "pred_rmse",
                   "input_psnr", "gt_psnr", "pred_psnr",
                   "input_ssim", "gt_ssim", "pred_ssim")


def _predictor_for(model, family: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Full-image prediction function; only the MTD-GAN family is ported."""
    if family != "mtd":
        raise NotImplementedError(
            f"family {family!r} is not ported yet (ROADMAP.md queue 1, "
            f"items 8-11)")
    return model.generate


def train_one_epoch(trainer, loader: Iterable, preprocess,
                    generator: torch.Generator, print_freq: int = 10,
                    header: str = "Train:") -> Dict[str, float]:
    """One epoch over ``loader`` items ``(hu_x, hu_y)``; returns the epoch
    means of the step metrics. Non-finite metrics are reported and the
    epoch goes on (reference engine.py:208-209)."""
    logger = MetricLogger()
    device = trainer.model.device
    pending: List[Tuple[int, Dict[str, torch.Tensor]]] = []

    def flush():
        for step, metrics in pending:
            host = {k: float(v) for k, v in metrics.items()}
            bad = [k for k, v in host.items() if not np.isfinite(v)]
            if bad:
                print(f"WARNING: non-finite metrics at step {step}: {bad}", flush=True)
            logger.update(**host)
        pending.clear()

    for i, (hu_x, hu_y) in enumerate(logger.log_every(loader, print_freq, header,
                                                      pre_print=flush)):
        x, y = preprocess(torch.from_numpy(np.asarray(hu_x)).to(device),
                          torch.from_numpy(np.asarray(hu_y)).to(device), generator)
        pending.append((i, trainer.train_step(x, y)))
    flush()
    return logger.global_averages()


@torch.no_grad()
def validate(model, loader: Iterable, eval_preprocess, epoch: int,
             save_dir: Optional[str] = None,
             criterion: Callable = losses_lib.l1) -> Dict[str, float]:
    """Criterion of the generator's prediction per validation slice; PNGs of
    the last slice's input, ground truth and prediction in ``save_dir``."""
    logger = MetricLogger()
    pending, last = [], None
    for batch in loader:
        x, y = eval_preprocess(torch.from_numpy(np.asarray(batch[0])).to(model.device),
                               torch.from_numpy(np.asarray(batch[1])).to(model.device))
        pred = model.generate(x)
        pending.append(criterion(pred, y))
        last = (x, y, pred)
    for v in torch.stack(pending).cpu().tolist() if pending else []:
        logger.update(loss=v)
    if save_dir and last is not None:
        x, y, pred = (t[0].cpu().numpy() for t in last)
        for name, img in (("input", x), ("gt", y), ("pred", np.clip(pred, 0, 1))):
            save_png_gray(os.path.join(save_dir, f"epoch_{epoch}_{name}.png"), img)
    return logger.global_averages()


def _grouped(items: Iterable, group_n: int) -> Iterator[Tuple[List, int]]:
    buf = []
    for item in items:
        buf.append(item)
        if len(buf) == group_n:
            yield buf, len(buf)
            buf = []
    if buf:
        n_real = len(buf)
        buf += [buf[-1]] * (group_n - n_real)
        yield buf, n_real


def _pixel_metrics(x: torch.Tensor, y: torch.Tensor,
                   p: torch.Tensor) -> torch.Tensor:
    return torch.stack(pixel_metrics.compute_rmse(x, y, p)
                       + pixel_metrics.compute_psnr(x, y, p)
                       + pixel_metrics.compute_ssim(x, y, p))


@torch.no_grad()
def run_test(model, loader: Iterable, eval_preprocess, family: str,
             save_dir: str, compute_fid_metric: bool = True,
             compute_feature_metrics: bool = True,
             eval_batch: int = 8) -> Dict[str, float]:
    """Metric sweep over ``loader`` items ``(hu_x, hu_y[, paths])`` on the
    model's device; returns the per-column means (also written to
    ``save_dir/test_summary.json``)."""
    if compute_feature_metrics or compute_fid_metric:
        raise NotImplementedError(
            "feature metrics (PL/TML) and FID are not ported yet "
            "(ROADMAP.md queue 1, item 13): pass compute_feature_metrics="
            "False and compute_fid_metric=False")
    predictor = _predictor_for(model, family)
    device = model.device
    os.makedirs(save_dir, exist_ok=True)
    rows: List[Dict] = []
    n_seen = 0
    with ThreadPoolExecutor(max_workers=4) as png_pool:
        png_futures = []
        for group, n_real in _grouped(loader, eval_batch):
            hu_x = torch.from_numpy(np.concatenate([np.asarray(b[0]) for b in group]))
            hu_y = torch.from_numpy(np.concatenate([np.asarray(b[1]) for b in group]))
            x, y = eval_preprocess(hu_x.to(device), hu_y.to(device))
            pred = predictor(x).clamp(0.0, 1.0)

            metrics, pngs, names = [], [], []
            off = 0
            for item in group[:n_real]:
                b_i = np.asarray(item[0]).shape[0]
                xi, yi, pi = x[off:off + b_i], y[off:off + b_i], pred[off:off + b_i]
                off += b_i
                metrics.append(_pixel_metrics(xi, yi, pi))
                # same round(clip * 255) (half to even) as save_png_gray
                pngs.append(torch.round(pi[0, ..., 0] * 255.0).to(torch.uint8))
                paths = item[2] if len(item) > 2 else None
                names.append((os.path.basename(paths[0]) if paths
                              else f"slice_{n_seen:05d}") + ".png")
                n_seen += 1
            metrics_h = torch.stack(metrics).cpu().numpy()  # one sync per group
            pngs_h = torch.stack(pngs).cpu().numpy()
            for name, m, png in zip(names, metrics_h, pngs_h):
                png_futures.append(png_pool.submit(
                    save_png_gray, os.path.join(save_dir, "png", name), png))
                row = {k: float(v) for k, v in zip(_METRIC_COLUMNS, m)}
                row["filename"] = name
                rows.append(row)
        for fut in png_futures:
            fut.result()  # surface encode/write errors

    summary = {k: float(np.mean([r[k] for r in rows])) for k in _METRIC_COLUMNS}
    save_csv(os.path.join(save_dir, "pred_results.csv"), rows)
    with open(os.path.join(save_dir, "test_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary
