"""Family dispatch and the epoch loops: ``build_trainer``,
``train_one_epoch``, ``validate`` and the test-set metric sweep
``run_test`` (counterpart of ``mtd_gan_tpu/engine/loops.py``). Families:

  cnn    RED_CNN, EDCNN          SupervisedTrainer, ``model.predict``
  tr     CTformer, Restormer     SupervisedTrainer, ``model.predict`` over
                                 64x64 tiles: the sliding window at overlap
                                 0.3, 32 tiles a chunk to validate, 0.9 and
                                 960 to test, ``constant`` blending, one
                                 slice per group (reference engine.py:345,
                                 378)
  wgan   WGAN_VGG, MAP_NN        AdversarialTrainer, 4 D updates a step
  dugan  DU_GAN                  DUGANTrainer, three optimizers
  mtd    MTD_GAN_Method          MTDGANTrainer; the ten ``Ablation_*``:
                                 AdversarialTrainer, 1 D update a step
  dn     DDPM, DDIM, PNDM, DPM   SupervisedTrainer (eps-MSE); the whole
                                 reverse chain per prediction: validated
                                 through the sliding window (64x64 tiles
                                 at overlap 0.5, 32 a chunk, ``constant``;
                                 JAX engine/loops.py:196-201), tested on
                                 the full image (engine.py:866)

The GAN families predict with ``model.generate``. A ``dn`` prediction
samples from fresh noise: in ``validate`` each call of the predictor (a
chunk of tiles) takes the next noise stream under ``seed``; in
``run_test`` each slice takes the stream of its position in the sweep, so a
grouped sweep gives every slice the noise of the batch-1 sweep.

Training: the loader is wrapped in ``prefetch_to_device``, so each HU pair
is on the model's device before its step; the train preprocess cuts and
augments the crops there, and one trainer step runs; step metrics stay on
the device and are fetched at print boundaries.
Validation: full-slice predictions (``tr``: through the sliding window),
the criterion per slice, and PNGs of the last slice.

Per slice: RMSE / PSNR / SSIM and, unless turned off, PL and TML for the
input, gt and prediction columns, a PNG of the clipped prediction, and a
row of ``pred_results.csv``; the means go to ``test_summary.json``, with the
corpus FIDs of the three columns. Predictions run on groups of
``eval_batch`` loader items (one for ``tr``, as in the JAX package: the
sliding window batches the tiles), the last group padded by repeating its last
item (padded outputs dropped), while metrics, PNGs and rows stay per item;
the VGG19 trunk and the Inception each take a group's real input, gt and
prediction slices in one pass. Given a ``phases`` dict, the sweep charges
its host time to named phases (decode, h2d, generate, metrics, features,
png, csv), each ending in a device synchronize.
"""

from __future__ import annotations

import contextlib
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from mtd_gan_tpu_torch import losses as losses_lib
from mtd_gan_tpu_torch.data.pipeline import prefetch_to_device
from mtd_gan_tpu_torch.features.registry import get_inception_feature_fn, get_vgg_slices_fn
from mtd_gan_tpu_torch.metrics import fid as fid_lib
from mtd_gan_tpu_torch.metrics import perceptual
from mtd_gan_tpu_torch.metrics import pixel as pixel_metrics
from mtd_gan_tpu_torch.models import resolve_alias
from mtd_gan_tpu_torch.models.diffusion.wrappers import slice_seed
from mtd_gan_tpu_torch.ops.sliding_window import sliding_window_inference
from mtd_gan_tpu_torch.parallel.mesh import shard_batch
from mtd_gan_tpu_torch.utils.artifacts import save_csv, save_png_gray
from mtd_gan_tpu_torch.utils.logging import MetricLogger
from mtd_gan_tpu_torch.utils.profiling import StepTimer

_METRIC_COLUMNS = ("input_rmse", "gt_rmse", "pred_rmse",
                   "input_psnr", "gt_psnr", "pred_psnr",
                   "input_ssim", "gt_ssim", "pred_ssim")
_FEATURE_COLUMNS = ("input_pl", "gt_pl", "pred_pl", "input_tml", "gt_tml", "pred_tml")


FAMILY = {
    "RED_CNN": "cnn", "EDCNN": "cnn",
    "CTformer": "tr", "Restormer": "tr",
    "WGAN_VGG": "wgan", "MAP_NN": "wgan",
    "DU_GAN": "dugan",
    "MTD_GAN_Method": "mtd",
    "DDPM": "dn", "DDIM": "dn", "PNDM": "dn", "DPM": "dn",
}
# the sliding window of the tr family: 64x64 tiles (reference engine.py:345,
# 378); the dn family validates through it too (engine.py:835)
TR_ROI = (64, 64)
TR_VALID = dict(overlap=0.3, sw_batch_size=32)
TR_TEST = dict(overlap=0.9, sw_batch_size=960)
DN_VALID = dict(overlap=0.5, sw_batch_size=32)


def family_of(model_name: str) -> str:
    """The family of a reference-compatible name (``Ablation_*`` are
    ``mtd``; an unknown name is ``cnn``, as in the JAX package)."""
    model_name = resolve_alias(model_name)
    if model_name.startswith("Ablation_"):
        return "mtd"
    return FAMILY.get(model_name, "cnn")


def _refuse_family(family: str) -> None:
    if family not in ("cnn", "tr", "wgan", "dugan", "mtd", "dn"):
        raise KeyError(family)


def build_trainer(model_name: str, model, args, seed: int = 0, grid=None):
    """The family's trainer: ``SupervisedTrainer`` for ``cnn``, ``tr`` and
    ``dn``;
    ``AdversarialTrainer`` with the model's ``d_steps_per_g`` (4) D updates
    a step for ``wgan``; ``DUGANTrainer`` for ``dugan``; for ``mtd``,
    ``MTDGANTrainer`` with ``args.method`` for a stacked ``d_loss``
    (MTD_GAN_Method), else ``AdversarialTrainer(n_critic=1)``, which, as in
    the JAX package, takes no method: a given ``--method`` is noted and not
    used (so for ``wgan`` and ``dugan``). ``seed`` seeds each trainer's
    random draws. ``grid``: the ranks of ``args.multi_gpu_mode`` (a
    ``parallel.mesh.Grid``), given to every trainer; ``TensorParallel``
    splits MTD_GAN_Method's generator over its model group and raises
    ``ValueError`` for every other model, as the JAX package
    (``mtd_gan_tpu/engine/loops.py:66-69, 88-90``). ``args.g_forward``
    reaches ``MTDGANTrainer``."""
    from mtd_gan_tpu_torch.engine.gan import MTDGANTrainer
    from mtd_gan_tpu_torch.engine.supervised import SupervisedTrainer
    from mtd_gan_tpu_torch.engine.wgan import AdversarialTrainer, DUGANTrainer

    family = family_of(model_name)
    _refuse_family(family)
    tp = getattr(args, "multi_gpu_mode", "Single") == "TensorParallel"
    if tp and family != "mtd":
        raise ValueError("TensorParallel is implemented for the MTD_GAN family "
                         "(channel-sharded Res-FFT generator); use DataParallel here")
    kw = dict(optimizer=args.optimizer, lr=args.lr, seed=seed, grid=grid)
    if family in ("cnn", "tr", "dn"):
        return SupervisedTrainer(model, **kw)
    method = args.method or None
    if family == "mtd" and model.n_d_tasks > 1:
        return MTDGANTrainer(model, method=method, tensor_parallel=tp,
                             g_forward=getattr(args, "g_forward", "auto"), **kw)
    if tp:
        raise ValueError("TensorParallel needs the full MTD_GAN_Method (the ablations "
                         "use scalar d_loss models)")
    if method:
        print(f"note: --method {method} is not used: {model_name} has a scalar "
              f"discriminator loss", flush=True)
    if family == "dugan":
        return DUGANTrainer(model, **kw)
    n_critic = model.d_steps_per_g if family == "wgan" else 1
    return AdversarialTrainer(model, n_critic=n_critic, **kw)


def _predictor_for(model, family: str, seed: int = 0, per_slice: bool = False
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Full-image prediction function: ``model.predict`` for ``cnn``; for
    ``tr`` ``model.predict`` over 64x64 tiles (the caller's sliding
    window); ``model.generate`` for the GAN families (the ablations
    included); for ``dn`` the model's reverse chain, each call on the next
    noise stream under ``seed`` (``validate``: a chunk of tiles shares
    one), or with ``per_slice`` each slice on the stream of its position
    among the slices of every call so far (``run_test``)."""
    _refuse_family(family)
    if family != "dn":
        return model.predict if family in ("cnn", "tr") else model.generate
    count = [0]

    def sample(x: torch.Tensor) -> torch.Tensor:
        first = count[0]
        if per_slice:
            count[0] += x.shape[0]
            return model.sample_batched(x, [slice_seed(seed, first + i)
                                            for i in range(x.shape[0])])
        count[0] += 1
        return model.sample(x, torch.Generator(device=x.device).manual_seed(
            slice_seed(seed, first)))

    return sample


def _window_predict(predictor: Callable, x: torch.Tensor, window: Dict) -> torch.Tensor:
    return sliding_window_inference(x, TR_ROI, predictor, mode="constant", **window)


def train_one_epoch(trainer, loader: Iterable, preprocess,
                    generator: torch.Generator, print_freq: int = 10,
                    header: str = "Train:", device_prefetch: bool = True,
                    grid=None) -> Dict[str, float]:
    """One epoch over ``loader`` items ``(hu_x, hu_y)``; returns the epoch
    means of the step metrics. Non-finite metrics are reported and the
    epoch goes on (reference engine.py:208-209). ``device_prefetch``: copy
    each batch to the device ahead of its step. ``grid``: every rank loads
    the global batch and cuts its crops from ``generator`` (seeded alike on
    every rank), then keeps its rows (``parallel.mesh.shard_batch``)."""
    logger = MetricLogger()
    device = trainer.model.device
    if device_prefetch:
        loader = prefetch_to_device(loader, device)
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
        x, y = preprocess(torch.as_tensor(hu_x, device=device),
                          torch.as_tensor(hu_y, device=device), generator)
        pending.append((i, trainer.train_step(shard_batch(grid, x), shard_batch(grid, y))))
    flush()
    return logger.global_averages()


@torch.no_grad()
def validate(model, loader: Iterable, eval_preprocess, family: str, epoch: int,
             save_dir: Optional[str] = None,
             criterion: Callable = losses_lib.l1, seed: int = 0) -> Dict[str, float]:
    """Criterion of the model's full-slice prediction per validation slice;
    PNGs of the last slice's input, ground truth and prediction in
    ``save_dir``. ``seed``: the ``dn`` family's noise streams, keyed by
    ``epoch`` as well, so each epoch's validation draws fresh noise."""
    predictor = _predictor_for(model, family, slice_seed(seed, epoch))
    window = {"tr": TR_VALID, "dn": DN_VALID}.get(family)
    logger = MetricLogger()
    pending, last = [], None
    for batch in loader:
        x, y = eval_preprocess(torch.from_numpy(np.asarray(batch[0])).to(model.device),
                               torch.from_numpy(np.asarray(batch[1])).to(model.device))
        pred = _window_predict(predictor, x, window) if window else predictor(x)
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


def _timed(items: Iterable, timer) -> Iterator:
    """``items``, each ``next`` charged to ``timer``."""
    it = iter(items)
    while True:
        with timer:
            item = next(it, StopIteration)
        if item is StopIteration:
            return
        yield item


@torch.no_grad()
def run_test(model, loader: Iterable, eval_preprocess, family: str,
             save_dir: str, compute_fid_metric: bool = True,
             compute_feature_metrics: bool = True,
             eval_batch: int = 8,
             phases: Optional[Dict[str, StepTimer]] = None, seed: int = 0) -> Dict[str, float]:
    """Metric sweep over ``loader`` items ``(hu_x, hu_y[, paths])`` on the
    model's device; returns the per-column means and, with
    ``compute_fid_metric``, ``input_fid`` / ``gt_fid`` / ``pred_fid`` (also
    written to ``save_dir/test_summary.json``). ``compute_feature_metrics``
    adds the PL and TML columns. ``phases``: where to record the host
    seconds of each phase (``decode`` the loader, ``h2d`` the copy and
    window, ``generate``, ``metrics`` the pixel metrics with their copy
    back, ``features`` the VGG19 trunk and the Inception with theirs,
    ``png`` the encoders' drain, ``csv`` the FID, CSV and summary), one
    synchronizing :class:`StepTimer` each. ``seed``: the ``dn`` family's
    noise streams, one per slice."""
    predictor = _predictor_for(model, family, seed, per_slice=True)
    device = model.device
    if phases is not None:
        sync = device.type == "cuda"
        for name in ("decode", "h2d", "generate", "metrics", "features", "png", "csv"):
            phases.setdefault(name, StepTimer(sync=sync))
        loader = _timed(loader, phases["decode"])
    span = (lambda name: phases[name]) if phases is not None else (
        lambda name: contextlib.nullcontext())
    if family == "tr":
        eval_batch = 1  # the sliding window batches its tiles itself
    vgg_fn = get_vgg_slices_fn(device) if compute_feature_metrics else None
    inception_fn = get_inception_feature_fn(device) if compute_fid_metric else None
    columns = _METRIC_COLUMNS + (_FEATURE_COLUMNS if compute_feature_metrics else ())
    os.makedirs(save_dir, exist_ok=True)
    rows: List[Dict] = []
    feats: List[np.ndarray] = []  # (3, n, 2048) per group: input, gt, pred
    n_seen = 0
    with ThreadPoolExecutor(max_workers=4) as png_pool:
        png_futures = []
        for group, n_real in _grouped(loader, eval_batch):
            with span("h2d"):
                hu_x = torch.from_numpy(np.concatenate([np.asarray(b[0]) for b in group]))
                hu_y = torch.from_numpy(np.concatenate([np.asarray(b[1]) for b in group]))
                x, y = eval_preprocess(hu_x.to(device), hu_y.to(device))
            with span("generate"):
                pred = (_window_predict(predictor, x, TR_TEST) if family == "tr"
                        else predictor(x)).clamp(0.0, 1.0)

            with span("metrics"):
                metrics, pngs, names, offsets = [], [], [], [0]
                for item in group[:n_real]:
                    off = offsets[-1]
                    b_i = np.asarray(item[0]).shape[0]
                    offsets.append(off + b_i)
                    xi, yi, pi = x[off:off + b_i], y[off:off + b_i], pred[off:off + b_i]
                    metrics.append(_pixel_metrics(xi, yi, pi))
                    # same round(clip * 255) (half to even) as save_png_gray
                    pngs.append(torch.round(pi[0, ..., 0] * 255.0).to(torch.uint8))
                    paths = item[2] if len(item) > 2 else None
                    names.append((os.path.basename(paths[0]) if paths
                                  else f"slice_{n_seen:05d}") + ".png")
                    n_seen += 1
                metrics_h = torch.stack(metrics).cpu().numpy()  # one sync per group
                pngs_h = torch.stack(pngs).cpu().numpy()
            n_img = offsets[-1]
            if vgg_fn is not None or inception_fn is not None:
                with span("features"):
                    xs, ys, ps = x[:n_img], y[:n_img], pred[:n_img]
                    if vgg_fn is not None:
                        # (6, n_img): PL then TML rows of input, gt, pred
                        pl_tml_h = torch.cat(perceptual.pl_tml(xs, ys, ps, vgg_fn)).cpu().numpy()
                    if inception_fn is not None:
                        f = fid_lib.compute_feat(xs, ys, ps, inception_fn)
                        feats.append(torch.stack(f).cpu().numpy())
            for i, (name, m, png) in enumerate(zip(names, metrics_h, pngs_h)):
                png_futures.append(png_pool.submit(
                    save_png_gray, os.path.join(save_dir, "png", name), png))
                row = {k: float(v) for k, v in zip(_METRIC_COLUMNS, m)}
                if vgg_fn is not None:
                    # an item's images averaged, as the JAX package's batch mean
                    item_means = pl_tml_h[:, offsets[i]:offsets[i + 1]].mean(axis=1)
                    row.update({k: float(v) for k, v in zip(_FEATURE_COLUMNS, item_means)})
                row["filename"] = name
                rows.append(row)
        with span("png"):
            for fut in png_futures:
                fut.result()  # surface encode/write errors

    with span("csv"):
        summary = {k: float(np.mean([r[k] for r in rows])) for k in columns}
        if feats:
            corpus = np.concatenate(feats, axis=1)
            summary.update(zip(("input_fid", "gt_fid", "pred_fid"),
                               fid_lib.compute_fid(*corpus)))
        save_csv(os.path.join(save_dir, "pred_results.csv"), rows)
        with open(os.path.join(save_dir, "test_summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
    return summary
