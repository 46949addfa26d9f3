"""Weight carry-over from the JAX package and the reference layout.

* :func:`generator_state_dict_from_flax` turns a flax ``ResFFTGenerator``
  ``params`` tree (nested dicts of numpy arrays) into the port's state dict;
  it is the inverse of ``convert_resfft_generator`` in the JAX package;
  :func:`discriminator_state_dict_from_flax` does the same for the
  discriminator with its spectral-norm ``u`` (inverse of
  ``convert_mtd_discriminator``) and :func:`mtd_gan_state_dict_from_flax`
  for the whole model;
* :func:`load_reference_checkpoint` reads a checkpoint in the reference
  layout (``{"model_state_dict": {"Generator.…": …}, "epoch": …}``, as
  ``tools/import_torch_checkpoint.py`` reads it) and returns the generator's
  state dict.

Layout conventions (flax -> torch): conv HWIO -> OIHW; transposed conv
``(kh, kw, in, out)`` -> ``(in, out, kh, kw)``; spectral mix ``(2C_in,
2C_out)`` -> 1x1 conv ``(2C_out, 2C_in, 1, 1)``.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


def strip_module_prefixes(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Remove DataParallel ``module.`` segments anywhere in the key path
    (GAN wrappers wrap each submodule, so ``Generator.module.`` occurs)."""
    return {".".join(seg for seg in k.split(".") if seg != "module"): v
            for k, v in sd.items()}


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))  # a contiguous copy


def generator_state_dict_from_flax(params_g: Mapping[str, Any]
                                   ) -> Dict[str, torch.Tensor]:
    """flax ``params_g`` (``enc_i``, ``dec_i``, ``fft_i``) -> state dict with
    the reference names, for ``ResFFTGenerator.load_state_dict``."""
    L = sum(1 for k in params_g if k.startswith("enc_")) - 1
    sd: Dict[str, torch.Tensor] = {}
    for i in range(L + 1):
        enc, dec = params_g[f"enc_{i}"], params_g[f"dec_{i}"]
        sd[f"encoder.{i}.weight"] = _t(np.asarray(enc["kernel"]).transpose(3, 2, 0, 1))
        sd[f"encoder.{i}.bias"] = _t(enc["bias"])
        sd[f"decoder.{i}.weight"] = _t(np.asarray(dec["kernel"]).transpose(2, 3, 0, 1))
        sd[f"decoder.{i}.bias"] = _t(dec["bias"])
    for i in range(2 * L + 1):
        p = params_g[f"fft_{i}"]
        blk = f"enforce.{i}"
        sd[f"{blk}.img_conv.weight"] = _t(np.asarray(p["img_kernel"]).transpose(3, 2, 0, 1))
        sd[f"{blk}.img_conv.bias"] = _t(p["img_bias"])
        sd[f"{blk}.fft_conv.weight"] = _t(np.asarray(p["fft_kernel"]).T[:, :, None, None])
        sd[f"{blk}.fft_conv.bias"] = _t(p["fft_bias"])
    return sd


def load_reference_checkpoint(path: str) -> Tuple[int, Dict[str, torch.Tensor]]:
    """Reference-layout ``.pth`` -> ``(epoch, generator state dict)``.

    Loads with ``weights_only=True``; the ``argparse.Namespace`` the
    reference stores under ``args`` is allow-listed. A bare state dict (no
    ``model_state_dict``) is taken as the model state at epoch 0."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if "model_state_dict" in ckpt:
        epoch, sd = int(ckpt.get("epoch", 0)), ckpt["model_state_dict"]
    else:
        epoch, sd = 0, ckpt
    prefix = "Generator."
    gen = {k[len(prefix):]: v for k, v in strip_module_prefixes(sd).items()
           if k.startswith(prefix)}
    if not gen:
        raise KeyError(f"{path}: no '{prefix}' keys in the model state dict")
    return epoch, gen


def _sn_entries(sd: Dict[str, torch.Tensor], name: str, w: np.ndarray,
                u: np.ndarray) -> None:
    """``name.weight_orig`` / ``weight_u`` / ``weight_v`` of a spectral-norm
    layer; ``v = n(W^T u)`` on torch's ``(out, -1)`` view, as the next
    iteration computes it."""
    w_mat = w.reshape(w.shape[0], -1).astype(np.float64)
    u = np.asarray(u, np.float32)
    v = w_mat.T @ u
    sd[f"{name}.weight_orig"] = _t(w)
    sd[f"{name}.weight_u"] = _t(u)
    sd[f"{name}.weight_v"] = _t(v / (np.linalg.norm(v) + 1e-12))


def discriminator_state_dict_from_flax(params_d: Mapping[str, Any],
                                       state_d: Mapping[str, Any]
                                       ) -> Dict[str, torch.Tensor]:
    """flax ``MultiTaskDiscriminator`` params and its ``spectral`` state
    (each layer's ``u``) -> the port's discriminator state dict, the inverse
    of ``convert_mtd_discriminator``: conv HWIO -> OIHW, dense (in, out) ->
    (out, in), ``u`` -> ``weight_u``."""
    sd: Dict[str, torch.Tensor] = {}
    for name, p in params_d.items():
        if name.startswith("r_up"):
            q = p["proj"]
            sd[f"{name}.upsample.0.weight"] = _t(np.asarray(q["kernel"]).transpose(3, 2, 0, 1))
            sd[f"{name}.upsample.0.bias"] = _t(q["bias"])
            continue
        k = np.asarray(p["kernel"])
        w = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
        if name in state_d:
            _sn_entries(sd, name, w, state_d[name]["u"])
        else:
            sd[f"{name}.weight"] = _t(w)
        sd[f"{name}.bias"] = _t(p["bias"])
    return sd


def mtd_gan_state_dict_from_flax(params_g: Mapping[str, Any],
                                 params_d: Mapping[str, Any],
                                 state_d: Mapping[str, Any]
                                 ) -> Dict[str, torch.Tensor]:
    """The whole model in the reference's ``model_state_dict`` layout:
    ``Generator.*`` and ``Discriminator.*``."""
    sd = {f"Generator.{k}": v for k, v in generator_state_dict_from_flax(params_g).items()}
    sd.update({f"Discriminator.{k}": v for k, v in
               discriminator_state_dict_from_flax(params_d, state_d).items()})
    return sd
