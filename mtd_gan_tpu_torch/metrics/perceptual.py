"""Feature-space metrics PL (VGG perceptual) and TML (Gram texture matching)
(counterpart of ``mtd_gan_tpu/metrics/perceptual.py``).

  PL  -> reference metrics.py:93-106: 5-slice VGG19, weights (1/32 ... 1),
         L1 between the feature maps
  TML -> reference metrics.py:109-168: the feature maps cut into 16x16
         patches, a Gram matrix per patch, weighted L1 between them

Images are NHWC gray (B, H, W, 1); features NCHW. ``compute_pl`` and
``compute_tml`` return (input-vs-gt, gt-vs-gt, pred-vs-gt) triples, as the
JAX package does, but run the VGG trunk once per image: the JAX package
runs it twice per pair, 12 passes where 3 images are distinct.
:func:`pl_tml` gives both triples per image from that one pass. TML is NaN
below 256x256: relu5_1 (1/16 of the side) then holds no 16x16 patch.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from mtd_gan_tpu_torch.features.registry import get_vgg_slices_fn, in_fp32

Tensor = torch.Tensor
FeatureFn = Callable[[Tensor], List[Tensor]]

_WEIGHTS = (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1.0)


def _vgg_fn(device) -> FeatureFn:
    return get_vgg_slices_fn(device)


@in_fp32
def perceptual_loss(x: Tensor, y: Tensor, feature_fn: Optional[FeatureFn] = None) -> Tensor:
    """PL: weighted L1 between the VGG19 slice activations of x and y."""
    fn = feature_fn or _vgg_fn(x.device)
    return sum(w * torch.mean(torch.abs(a - b)) for w, a, b in zip(_WEIGHTS, fn(x), fn(y)))


def _patch_grams(feat: Tensor, patch: int = 16) -> Tensor:
    """NCHW features -> Gram matrices of the non-overlapping patch x patch
    patches (torch ``Unfold`` with kernel = stride = patch), (B, L, C, C)."""
    b, c, h, w = feat.shape
    lh, lw = h // patch, w // patch
    f = feat[:, :, :lh * patch, :lw * patch].reshape(b, c, lh, patch, lw, patch)
    f = f.permute(0, 2, 4, 1, 3, 5).reshape(b, lh * lw, c, patch * patch)
    return f @ f.transpose(-1, -2)


@in_fp32
def texture_matching_loss(x: Tensor, y: Tensor, feature_fn: Optional[FeatureFn] = None,
                          patch: int = 16) -> Tensor:
    """TML: weighted L1 between the patchwise Gram matrices of the VGG19
    features of x and y."""
    fn = feature_fn or _vgg_fn(x.device)
    return sum(w * torch.mean(torch.abs(_patch_grams(a, patch) - _patch_grams(b, patch)))
               for w, a, b in zip(_WEIGHTS, fn(x), fn(y)))


@in_fp32
def pl_tml(inp: Tensor, target: Tensor, pred: Tensor,
           feature_fn: Optional[FeatureFn] = None) -> Tuple[Tensor, Tensor]:
    """PL and TML of input, gt and prediction against gt, per image, from
    one trunk pass over the three batches: two (3, B) tensors, rows
    (input, gt, pred). gt-vs-gt is exactly 0. A mean over images of a row
    is what the JAX package's ``compute_pl`` / ``compute_tml`` give for the
    batch (every image has as many elements)."""
    fn = feature_fn or _vgg_fn(inp.device)
    b = inp.shape[0]
    feats = fn(torch.cat([inp, target, pred]))
    pl = inp.new_zeros((3, b))
    tml = inp.new_zeros((3, b))
    for w, f in zip(_WEIGHTS, feats):
        f = f.reshape(3, b, *f.shape[1:])
        pl += w * torch.abs(f - f[1:2]).mean(dim=(2, 3, 4))
        grams = _patch_grams(f.flatten(0, 1))
        grams = grams.reshape(3, b, *grams.shape[1:])
        tml += w * torch.abs(grams - grams[1:2]).mean(dim=(2, 3, 4))
    return pl, tml


def _triple(values: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    means = values.mean(dim=1)
    return means[0], means[1], means[2]


def compute_pl(inp: Tensor, target: Tensor, pred: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    return _triple(pl_tml(inp, target, pred)[0])


def compute_tml(inp: Tensor, target: Tensor, pred: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    return _triple(pl_tml(inp, target, pred)[1])
