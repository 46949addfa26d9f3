"""Preprocessing on tensors, on the batch's device (counterpart of
``mtd_gan_tpu/data/transforms.py``).

Presets (reference create_datasets/Mayo.py, Sinogram.py):
  full*        : HU [-1024, 3072] -> [0, 1]
  window*      : HU window (abdomen for mayo, brain otherwise) -> [0, 1], clipped
  window_patch : (train) window, foreground bbox of y > 0, zero padding,
                 8 random paired 64x64 crops, then the paired augmentation
  aug          : rot90 (k in 1..3), flip of both axes, rotation by
                 U(-15, 15) degrees (bilinear, zero fill, same size), each
                 with probability 0.1, drawn per crop
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

WINDOW_PRESETS = {
    "abdomen": (-160.0, 240.0),  # Mayo.py:104
    "brain": (0.0, 80.0),        # Sinogram.py:103
}

HU_MIN, HU_MAX = -1024.0, 3072.0


def dicom_normalize(x: Tensor) -> Tensor:
    """HU -> [0,1] over the full scanner range (reference Mayo.py:45-48)."""
    return (x - HU_MIN) / (HU_MAX - HU_MIN)


def scale_intensity_range(x: Tensor, a_min: float, a_max: float,
                          b_min: float = 0.0, b_max: float = 1.0,
                          clip: bool = True) -> Tensor:
    y = (x - a_min) / (a_max - a_min) * (b_max - b_min) + b_min
    return y.clamp(b_min, b_max) if clip else y


def _window_fn(dataset: str) -> Callable[[Tensor], Tensor]:
    a_min, a_max = WINDOW_PRESETS["abdomen" if dataset == "mayo" else "brain"]
    return lambda hu: scale_intensity_range(hu, a_min, a_max)


def make_eval_preprocess(preset: str = "window", dataset: str = "mayo"
                         ) -> Callable[[Tensor, Tensor], Tuple[Tensor, Tensor]]:
    """Validation/test: windowing only, no aug (Mayo.py:141-161). The
    returned function maps HU tensors (any numeric dtype) to float32 on
    their own device."""
    norm = _window_fn(dataset) if preset.startswith("window") else dicom_normalize

    def preprocess(hu_x: Tensor, hu_y: Tensor) -> Tuple[Tensor, Tensor]:
        return norm(hu_x.float()), norm(hu_y.float())

    return preprocess


# ---------------------------------------------------------------- training

def foreground_bbox(mask: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per slice of ``mask`` (B, H, W, C): (rmin, rmax, cmin, cmax) of the
    nonzero pixels, half-open, each (B,); the full image where empty."""
    b, h, w = mask.shape[:3]
    rows = mask.any(dim=3).any(dim=2)
    cols = mask.any(dim=3).any(dim=1)
    any_fg = rows.any(dim=1)
    idx_r = torch.arange(h, device=mask.device)
    idx_c = torch.arange(w, device=mask.device)
    rmin = torch.where(rows, idx_r, h).amin(1)
    rmax = torch.where(rows, idx_r, -1).amax(1) + 1
    cmin = torch.where(cols, idx_c, w).amin(1)
    cmax = torch.where(cols, idx_c, -1).amax(1) + 1
    full = lambda v, d: torch.where(any_fg, v, torch.full_like(v, d))
    return full(rmin, 0), full(rmax, h), full(cmin, 0), full(cmax, w)


def crop_windows(x: Tensor, y: Tensor, patch: int
                 ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Zero-pad (B, H, W, C) slices by ``patch`` and return the padded pair
    and, per slice, the range of crop origins: tops in [lo_r, hi_r], lefts in
    [lo_c, hi_c] (inclusive), confined to the foreground bbox of ``y > 0``
    grown to at least ``patch`` (MONAI CropForegroundd + SpatialPadd)."""
    pad = (0, 0, patch, patch, patch, patch)
    xp, yp = F.pad(x, pad), F.pad(y, pad)
    rmin, rmax, cmin, cmax = foreground_bbox(y > 0)

    def expand(lo, hi):
        deficit = (patch - (hi - lo)).clamp_min(0)
        return lo + patch - (deficit + 1) // 2, hi + patch + deficit // 2

    rmin, rmax = expand(rmin, rmax)
    cmin, cmax = expand(cmin, cmax)
    return xp, yp, rmin, rmax - patch, cmin, cmax - patch


def crop_pairs(xp: Tensor, yp: Tensor, tops: Tensor, lefts: Tensor,
               patch: int) -> Tuple[Tensor, Tensor]:
    """Crops ``(B, S, patch, patch, C)`` at origins ``tops``, ``lefts``
    (B, S) of the padded slices (B, Hp, Wp, C)."""
    ar = torch.arange(patch, device=xp.device)
    rows = (tops[..., None] + ar)[..., :, None]            # (B, S, P, 1)
    cols = (lefts[..., None] + ar)[..., None, :]           # (B, S, 1, P)
    bidx = torch.arange(xp.shape[0], device=xp.device)[:, None, None, None]
    return xp[bidx, rows, cols], yp[bidx, rows, cols]


def rotate_images(img: Tensor, angle: Tensor) -> Tensor:
    """Bilinear same-size rotation of (N, H, W, C) about the image centre by
    ``angle`` (N,) radians, zero outside: output pixel (i, j) reads source
    ``(cos a (i - cy) - sin a (j - cx) + cy, sin a (i - cy) + cos a (j - cx)
    + cx)`` (the JAX package's ``_rotate_image``)."""
    n, h, w, _ = img.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys = torch.arange(h, dtype=img.dtype, device=img.device) - cy
    xs = torch.arange(w, dtype=img.dtype, device=img.device) - cx
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    cos, sin = torch.cos(angle)[:, None, None], torch.sin(angle)[:, None, None]
    src_y = cos * yy - sin * xx + cy
    src_x = sin * yy + cos * xx + cx
    # grid_sample with align_corners=True: -1 and 1 are the first and last
    # pixel centres; zeros padding gives each out-of-range corner weight 0
    grid = torch.stack([src_x / (w - 1) * 2 - 1, src_y / (h - 1) * 2 - 1], dim=-1)
    out = F.grid_sample(img.permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out.permute(0, 2, 3, 1)


def augment_pairs(x: Tensor, y: Tensor, generator: Optional[torch.Generator],
                  prob: float = 0.1) -> Tuple[Tensor, Tensor]:
    """Paired augmentation of (N, H, W, C) crops, drawn per crop."""
    n = x.shape[0]
    dev = x.device
    draw = lambda: torch.rand(n, generator=generator, device=dev)
    sel = lambda m: m[:, None, None, None]
    apply_rot, k = draw() < prob, 1 + (draw() * 3).long().clamp_max(2)
    for kk in (1, 2, 3):
        m = sel(apply_rot & (k == kk))
        x = torch.where(m, torch.rot90(x, kk, dims=(1, 2)), x)
        y = torch.where(m, torch.rot90(y, kk, dims=(1, 2)), y)
    m = sel(draw() < prob)
    x = torch.where(m, x.flip(1, 2), x)
    y = torch.where(m, y.flip(1, 2), y)
    m = sel(draw() < prob)
    angle = (draw() * 2 - 1) * (math.pi / 12)
    x = torch.where(m, rotate_images(x, angle), x)
    y = torch.where(m, rotate_images(y, angle), y)
    return x, y


def make_train_preprocess(preset: str = "window_patch", dataset: str = "mayo",
                          patch: int = 64, num_samples: int = 8,
                          aug_prob: float = 0.1):
    """Returns ``(hu_x, hu_y, generator) -> (x, y)``: HU tensors (B, H, W, 1)
    to float32 crops ``(B * num_samples, patch, patch, 1)`` on their device
    (MONAI list_data_collate order: slice-major). Only ``window_patch``, the
    flagship's preset, is ported."""
    if preset != "window_patch":
        raise NotImplementedError(
            f"train preset {preset!r} is not ported yet (ROADMAP.md queue 1, "
            f"item 7); ported: window_patch")
    norm = _window_fn(dataset)

    def preprocess(hu_x: Tensor, hu_y: Tensor,
                   generator: Optional[torch.Generator] = None):
        x, y = norm(hu_x.float()), norm(hu_y.float())
        xp, yp, lo_r, hi_r, lo_c, hi_c = crop_windows(x, y, patch)
        b, dev = x.shape[0], x.device
        u = torch.rand((2, b, num_samples), generator=generator, device=dev)
        pick = lambda lo, hi, v: lo[:, None] + (v * (hi - lo + 1)[:, None]).long()
        tops = torch.minimum(pick(lo_r, hi_r, u[0]), hi_r[:, None])
        lefts = torch.minimum(pick(lo_c, hi_c, u[1]), hi_c[:, None])
        px, py = crop_pairs(xp, yp, tops, lefts, patch)
        px = px.reshape(b * num_samples, patch, patch, -1)
        py = py.reshape(b * num_samples, patch, patch, -1)
        return augment_pairs(px, py, generator, aug_prob)

    return preprocess
