"""Overlap-tile (sliding-window) inference (counterpart of
``mtd_gan_tpu/ops/sliding_window.py``; reference: MONAI's
``sliding_window_inference``, engine.py:345, 378, 835, which CTformer,
Restormer and the diffusion models use to rebuild 512x512 slices from
64x64 tiles, and the multi-output generalisation of
module/sliding_window.py:25-786 that blends the discriminator's (cls, seg,
rec) with constant or Gaussian importance maps and count normalisation).

NHWC at the boundary, as the port's other entry points (``predict``,
``generate``) take and give it: ``inputs`` ``(N, H, W, C)``, the predictor
maps ``(B, rh, rw, C)`` tiles. Tile starts follow MONAI's interval rule
with the last tile clamped flush; a side smaller than the ROI is zero
padded around the centre and unpadded after. The tiles go through the
predictor in chunks of ``sw_batch_size`` (the last chunk shorter; the JAX
package pads it, which no predictor here can tell apart), and each chunk's
weighted tiles are added into the output at their places
(``index_add_``) before the next is predicted, so the tiles of a whole
slice never live at once. The JAX ``mesh`` argument has no port (one
device; ROADMAP.md queue 1, item 14).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def scan_interval(image_size: int, roi: int, overlap: float) -> int:
    """MONAI's scan interval: ``roi * (1 - overlap)``, at least 1, at most
    ``roi``; the ROI itself when it spans the image."""
    if roi == image_size:
        return roi
    return max(1, min(int(roi * (1.0 - overlap)), roi))


def dense_patch_positions(image_size: int, roi: int, overlap: float) -> np.ndarray:
    """The 1-D tile starts, the last clamped flush to the edge (repeats
    dropped)."""
    interval = scan_interval(image_size, roi, overlap)
    n = int(math.ceil((image_size - roi) / interval)) + 1 if image_size > roi else 1
    starts = dict.fromkeys(min(i * interval, image_size - roi) for i in range(n))
    return np.asarray(list(starts), dtype=np.int64)


def gaussian_importance_map(roi: Sequence[int], sigma_scale: float = 0.125) -> np.ndarray:
    """The centred Gaussian weight of a tile (MONAI's ``gaussian`` mode),
    peak 1, floored at float16's smallest normal; float32."""
    maps = []
    for size in roi:
        xs = np.arange(size) - (size - 1) / 2.0
        maps.append(np.exp(-0.5 * (xs / (sigma_scale * size)) ** 2))
    m = np.outer(maps[0], maps[1]).astype(np.float32)
    return np.clip(m / m.max(), np.finfo(np.float16).tiny, None)


def tile_coords(h: int, w: int, roi: Tuple[int, int], overlap: float) -> np.ndarray:
    """``(T, 2)`` tile origins, rows major."""
    rs = dense_patch_positions(h, roi[0], overlap)
    cs = dense_patch_positions(w, roi[1], overlap)
    rr, cc = np.meshgrid(rs, cs, indexing="ij")
    return np.stack([rr.ravel(), cc.ravel()], axis=-1)


def sliding_window_inference(inputs: Tensor, roi_size: Tuple[int, int],
                             predictor: Callable, sw_batch_size: int = 32,
                             overlap: float = 0.25, mode: str = "constant",
                             sigma_scale: float = 0.125):
    """Tiled inference over NHWC ``inputs``.

    ``predictor`` maps ``(B, rh, rw, C)`` to ``(B, rh, rw, C')`` or to a
    tuple whose entries are either spatial tiles of that form (blended into
    full-size maps, importance-weighted, normalised by the summed weights)
    or per-tile values such as CLS logits, which come back unaggregated as
    ``(N, T, ...)`` (the reference concatenates them,
    module/sliding_window.py:126). ``mode``: ``constant`` or ``gaussian``.
    Returns the predictor's structure."""
    if mode not in ("constant", "gaussian"):
        raise ValueError(f"unknown mode {mode!r}")
    n, h0, w0, c = inputs.shape
    rh, rw = roi_size
    pad_h, pad_w = max(rh - h0, 0), max(rw - w0, 0)
    top, left = pad_h // 2, pad_w // 2
    if pad_h or pad_w:
        inputs = F.pad(inputs, (0, 0, left, pad_w - left, top, pad_h - top))
    _, h, w, _ = inputs.shape
    dev = inputs.device
    coords = torch.as_tensor(tile_coords(h, w, (rh, rw), overlap), device=dev)
    t = coords.shape[0]
    imap = (torch.as_tensor(gaussian_importance_map((rh, rw), sigma_scale), device=dev)
            if mode == "gaussian" else torch.ones((rh, rw), device=dev))
    # every window as a view, then the tiles of each chunk gathered from it
    windows = inputs.unfold(1, rh, 1).unfold(2, rw, 1)  # (N, h', w', C, rh, rw)
    # flat output index of each tile pixel: origin + in-tile offset
    local = (torch.arange(rh, device=dev)[:, None] * w
             + torch.arange(rw, device=dev)[None, :]).reshape(-1)
    base = coords[:, 0] * w + coords[:, 1]

    spatial, per_tile, dtypes, is_tuple = {}, {}, {}, None
    count = torch.zeros(n * h * w, device=dev)
    total = n * t
    for start in range(0, total, sw_batch_size):
        idx = torch.arange(start, min(start + sw_batch_size, total), device=dev)
        ni, ti = idx // t, idx % t
        tiles = windows[ni, coords[ti, 0], coords[ti, 1]].permute(0, 2, 3, 1)
        preds = predictor(tiles)
        is_tuple = isinstance(preds, (tuple, list))
        pix = ((ni * (h * w) + base[ti])[:, None] + local[None, :]).reshape(-1)
        for k, p in enumerate(preds if is_tuple else (preds,)):
            if p.dim() >= 4 and tuple(p.shape[1:3]) == (rh, rw):
                if k not in spatial:
                    spatial[k] = torch.zeros(n * h * w, p.shape[3], device=dev)
                    dtypes[k] = p.dtype
                vals = p.float() * imap[None, :, :, None]
                spatial[k].index_add_(0, pix, vals.reshape(-1, p.shape[3]))
            else:
                per_tile.setdefault(k, []).append(p)
        if spatial:
            count.index_add_(0, pix, imap.reshape(1, -1).expand(len(idx), -1).reshape(-1))
    outs = []
    for k in range(len(spatial) + len(per_tile)):
        if k in spatial:
            full = (spatial[k] / count[:, None]).reshape(n, h, w, -1)
            outs.append(full[:, top:top + h0, left:left + w0].to(dtypes[k]))
        else:
            p = torch.cat(per_tile[k])
            outs.append(p.reshape(n, t, *p.shape[1:]))
    return tuple(outs) if is_tuple else outs[0]
