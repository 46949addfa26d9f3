"""Corpus-level Fréchet Inception Distance (counterpart of
``mtd_gan_tpu/metrics/fid.py``; reference metrics.py:17-41, with the
Fréchet distance of module/piq/fid.py:149-191).

The features come from the FID InceptionV3 on the device
(:func:`compute_feat`); the Fréchet math runs on the host in float64 with
the JAX package's matrix square root (a symmetric eigendecomposition of the
symmetrised product), numpy here as there.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from mtd_gan_tpu_torch.features.registry import get_inception_feature_fn

Tensor = torch.Tensor


def compute_feat(inp: Tensor, target: Tensor, pred: Tensor,
                 feature_fn: Optional[Callable[[Tensor], Tensor]] = None
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """(B, 2048) pool3 features of input, gt and prediction, from one
    Inception pass over the three batches; the caller gathers them for the
    corpus FID (reference engine.py:145-146)."""
    fn = feature_fn or get_inception_feature_fn(inp.device)
    return fn(torch.cat([inp, target, pred])).chunk(3)


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Matrix square root by a symmetric eigendecomposition (float64)."""
    mat = (mat + mat.T) / 2.0
    vals, vecs = np.linalg.eigh(mat)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(feats_x: np.ndarray, feats_y: np.ndarray) -> float:
    """FID between two feature corpora (N, D), float64 throughout."""
    x = np.asarray(feats_x, np.float64)
    y = np.asarray(feats_y, np.float64)
    cov_x = np.cov(x, rowvar=False)
    cov_y = np.cov(y, rowvar=False)
    diff = x.mean(0) - y.mean(0)
    sqrt_x = _sqrtm_psd(cov_x)
    covmean = _sqrtm_psd(sqrt_x @ cov_y @ sqrt_x)
    return float(diff @ diff + np.trace(cov_x) + np.trace(cov_y) - 2.0 * np.trace(covmean))


def compute_fid(input_feats, target_feats, pred_feats) -> Tuple[float, float, float]:
    """(input-vs-gt, gt-vs-gt, pred-vs-gt) corpus FIDs (reference
    metrics.py:33-41)."""
    inp, tgt, prd = (np.asarray(f) for f in (input_feats, target_feats, pred_feats))
    return frechet_distance(inp, tgt), frechet_distance(tgt, tgt), frechet_distance(prd, tgt)
