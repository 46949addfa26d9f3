"""Weight carry-over from the JAX package and the reference layout.

* :func:`generator_state_dict_from_flax` turns a flax ``ResFFTGenerator``
  ``params`` tree (nested dicts of numpy arrays) into the port's state dict;
  it is the inverse of ``convert_resfft_generator`` in the JAX package;
  :func:`discriminator_state_dict_from_flax` does the same for the
  discriminator with its spectral-norm ``u`` (inverse of
  ``convert_mtd_discriminator``) and :func:`mtd_gan_state_dict_from_flax`
  for the whole model;
* :func:`vgg19_state_dict_from_flax`, :func:`vgg16_state_dict_from_flax`,
  :func:`resnet50_state_dict_from_flax`, :func:`inception_state_dict_from_flax`
  and :func:`pieapp_state_dict_from_flax` turn the JAX package's feature
  extractors' param trees (nested dicts of numpy arrays, its
  ``features/*.py`` and ``metrics/learned.py`` layouts) into the port's
  torchvision-named state dicts; they are the inverses of its
  ``import_torch_*`` functions;
* :func:`red_cnn_state_dict_from_flax`, :func:`edcnn_state_dict_from_flax`,
  :func:`redcnn_generator_state_dict_from_flax` and
  :func:`ablation_state_dict_from_flax` do the same for the CNN family, DU-GAN's
  generator and the ten ablations (inverses of ``convert_red_cnn``,
  ``convert_edcnn``, ``convert_dugan_generator`` and ``convert_ablation``);
  :func:`wgan_vgg_state_dict_from_flax`, :func:`map_nn_state_dict_from_flax`,
  :func:`dugan_state_dict_from_flax` (both U-Nets with their ``u``,
  :func:`unet_state_dict_from_flax`), :func:`ctformer_state_dict_from_flax`
  (the performers' ``w`` included) and :func:`restormer_state_dict_from_flax`
  for the WGAN family and the transformers (inverses of
  ``convert_wgan_vgg``, ``convert_map_nn``, ``convert_dugan``,
  ``convert_ctformer`` and ``convert_restormer``);
* :func:`diffusion_unet_state_dict_from_flax` carries the JAX package's
  ``DiffusionUNet`` tree into the port's UNet, whose modules bear the flax
  names, and :func:`diffusion_unet_flax_from_state_dict` carries it back
  (the JAX package has no converter for it, and the reference's MONAI
  names are not in the repository);
* :func:`load_reference_checkpoint` reads a checkpoint in the reference
  layout (``{"model_state_dict": {"Generator.…": …}, "epoch": …}``, as
  ``tools/import_torch_checkpoint.py`` reads it) and returns the state dict
  of the network the test sweep runs: the generator's, or for RED_CNN,
  EDCNN, CTformer and Restormer the flat ``model_state_dict`` cut to the
  keys the JAX converter reads; :func:`reference_discriminator_state_dict` maps a reference
  discriminator (the pure SEG discriminator's ``dconv`` names and its dead
  ``enc_out`` included) onto the port's.

Layout conventions (flax -> torch): conv HWIO -> OIHW; transposed conv
``(kh, kw, in, out)`` -> ``(in, out, kh, kw)``; spectral mix ``(2C_in,
2C_out)`` -> 1x1 conv ``(2C_out, 2C_in, 1, 1)``.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch


def strip_module_prefixes(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Remove DataParallel ``module.`` segments anywhere in the key path
    (GAN wrappers wrap each submodule, so ``Generator.module.`` occurs)."""
    return {".".join(seg for seg in k.split(".") if seg != "module"): v
            for k, v in sd.items()}


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))  # a contiguous copy


def _conv_entries(sd: Dict[str, torch.Tensor], name: str, p: Mapping[str, Any],
                  transposed: bool = False) -> None:
    """flax conv HWIO -> ``name.weight`` OIHW (a depthwise ``(kh, kw, 1, C)``
    -> ``(C, 1, kh, kw)``), or a transposed conv ``(kh, kw, in, out)`` ->
    ``(in, out, kh, kw)``; ``name.bias`` where the layer has one."""
    k = np.asarray(p["kernel"])
    sd[f"{name}.weight"] = _t(k.transpose(2, 3, 0, 1) if transposed else k.transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _dense_entries(sd: Dict[str, torch.Tensor], name: str, p: Mapping[str, Any]) -> None:
    """flax dense ``(in, out)`` -> ``name.weight`` ``(out, in)``; its bias."""
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _layernorm_entries(sd: Dict[str, torch.Tensor], name: str, p: Mapping[str, Any]) -> None:
    """flax ``LayerNorm`` (``scale``, ``bias``) -> ``name.weight`` /
    ``name.bias``."""
    sd[f"{name}.weight"] = _t(p["scale"])
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def redcnn_generator_state_dict_from_flax(params_g: Mapping[str, Any]
                                          ) -> Dict[str, torch.Tensor]:
    """flax ``enc_i`` / ``dec_i`` -> ``encoder.{i}`` / ``decoder.{i}``: DU-GAN's
    generator (inverse of ``convert_dugan_generator``), and the conv layers
    of the ResFFT generator."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(sum(1 for k in params_g if k.startswith("enc_"))):
        _conv_entries(sd, f"encoder.{i}", params_g[f"enc_{i}"])
        _conv_entries(sd, f"decoder.{i}", params_g[f"dec_{i}"], transposed=True)
    return sd


def generator_state_dict_from_flax(params_g: Mapping[str, Any]
                                   ) -> Dict[str, torch.Tensor]:
    """flax ``params_g`` (``enc_i``, ``dec_i``, ``fft_i``) -> state dict with
    the reference names, for ``ResFFTGenerator.load_state_dict``."""
    L = sum(1 for k in params_g if k.startswith("enc_")) - 1
    sd = redcnn_generator_state_dict_from_flax(params_g)
    for i in range(2 * L + 1):
        p = params_g[f"fft_{i}"]
        blk = f"enforce.{i}"
        sd[f"{blk}.img_conv.weight"] = _t(np.asarray(p["img_kernel"]).transpose(3, 2, 0, 1))
        sd[f"{blk}.img_conv.bias"] = _t(p["img_bias"])
        sd[f"{blk}.fft_conv.weight"] = _t(np.asarray(p["fft_kernel"]).T[:, :, None, None])
        sd[f"{blk}.fft_conv.bias"] = _t(p["fft_bias"])
    return sd


# the model_state_dict keys the JAX converters read for the single-network
# models, whose model_state_dict has no prefix: RED-CNN's convs; EDCNN's
# Sobel factor and bias, not its fixed bank ``conv_sobel.sobel_weight``
# (rebuilt from its formula), and its dense blocks
FLAT_REFERENCE_KEYS = {
    "RED_CNN": tuple(f"{c}{i}.{p}" for c in ("conv", "tconv") for i in range(1, 6)
                     for p in ("weight", "bias")),
    "EDCNN": ("conv_sobel.sobel_factor", "conv_sobel.bias") + tuple(
        f"conv_{c}{i}.{p}" for i in range(1, 9) for c in ("p", "f")
        for p in ("weight", "bias")),
}


# the single-network models whose flat keys depend on their configuration
CONFIGURED_FLAT_MODELS = ("CTformer", "Restormer", "DDPM", "DDIM", "PNDM", "DPM")


def load_reference_checkpoint(path: str, model_name: str = "MTD_GAN_Method",
                              keys: Optional[Iterable[str]] = None
                              ) -> Tuple[int, Dict[str, torch.Tensor]]:
    """Reference-layout ``.pth`` -> ``(epoch, state dict)`` of the network
    the test sweep runs: for the single-network models exactly the keys the
    JAX converter reads from the flat ``model_state_dict`` (others, such as
    EDCNN's stored Sobel bank or CTformer's ``cls_token``, ``head`` and
    ``pos_embed``, are not read), for load with ``strict=True``: those of
    ``FLAT_REFERENCE_KEYS`` for RED_CNN and EDCNN (aliases resolved), and
    ``keys`` (the port network's own, which depend on the configuration;
    ignored for the other models) for CTformer, Restormer and the
    diffusion models (DDPM, DDIM, PNDM, DPM: the UNet's); for the GAN
    models (the MTD-GAN family,
    WGAN_VGG, MAP_NN, DU_GAN) the ``Generator.`` part.

    Loads with ``weights_only=True``; the ``argparse.Namespace`` the
    reference stores under ``args`` is allow-listed. A bare state dict (no
    ``model_state_dict``) is taken as the model state at epoch 0;
    DataParallel ``module.`` segments are stripped."""
    from mtd_gan_tpu_torch.models import resolve_alias

    with torch.serialization.safe_globals([argparse.Namespace]):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if "model_state_dict" in ckpt:
        epoch, sd = int(ckpt.get("epoch", 0)), ckpt["model_state_dict"]
    else:
        epoch, sd = 0, ckpt
    sd = strip_module_prefixes(sd)
    name = resolve_alias(model_name)
    if name in CONFIGURED_FLAT_MODELS:
        if keys is None:
            raise ValueError(f"{model_name}: pass the keys of the network to load")
    else:
        keys = FLAT_REFERENCE_KEYS.get(name)
    if keys is not None:
        missing = [k for k in keys if k not in sd]
        if missing:
            raise KeyError(f"{path}: {model_name} keys missing from the model state "
                           f"dict: {missing[:4]}")
        return epoch, {k: sd[k] for k in keys}
    prefix = "Generator."
    gen = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    if not gen:
        raise KeyError(f"{path}: no '{prefix}' keys in the model state dict")
    return epoch, gen


def reference_discriminator_state_dict(sd: Mapping[str, Any], heads: Tuple[str, ...]
                                       ) -> Dict[str, Any]:
    """A reference discriminator's state dict (no ``Discriminator.`` prefix)
    -> the port's ``MultiTaskDiscriminator(heads=heads)`` names. The pure
    SEG discriminator (arch/Ours/networks.py:611-764) names its decoder
    convs ``dconv{i}{j}`` where every multi-head one has ``s_dconv{i}{j}``,
    and carries an ``enc_out`` Linear its forward never uses (:695): the
    first are renamed (detected as the JAX ``convert_mtd_discriminator``
    does), the second dropped where there is no CLS head, so that the dead
    layer takes no optimizer step."""
    bare_seg = "seg" in heads and ("s_dconv11.weight_orig" not in sd
                                   and "s_dconv11.weight" not in sd)
    out = {}
    for k, v in sd.items():
        if "cls" not in heads and k.split(".")[0] == "enc_out":
            continue
        out["s_" + k if bare_seg and k.startswith("dconv") else k] = v
    return out


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


def red_cnn_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax RED-CNN (``conv1..5``, ``tconv1..5``) -> the port's ``REDCNN``
    (inverse of ``convert_red_cnn``)."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(1, 6):
        _conv_entries(sd, f"conv{i}", params[f"conv{i}"])
    for i in range(1, 6):
        _conv_entries(sd, f"tconv{i}", params[f"tconv{i}"], transposed=True)
    return sd


def edcnn_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax EDCNN -> the port's ``EDCNN`` (inverse of ``convert_edcnn``): the
    Sobel factor ``(C,)`` -> ``(C, 1, 1, 1)``, its bias, ``conv_p{i}`` /
    ``conv_f{i}``."""
    sob = params["conv_sobel"]
    factor = np.asarray(sob["sobel_factor"])
    sd = {"conv_sobel.sobel_factor": _t(factor.reshape(-1, 1, 1, 1)),
          "conv_sobel.bias": _t(sob["bias"])}
    for i in range(1, 9):
        for c in ("p", "f"):
            _conv_entries(sd, f"conv_{c}{i}", params[f"conv_{c}{i}"])
    return sd


def ablation_state_dict_from_flax(params_g: Mapping[str, Any], params_d: Mapping[str, Any],
                                  state_d: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A whole ablation in the ``model_state_dict`` layout (inverse of
    ``convert_ablation``): ``Generator.*`` (the ResFFT generator where
    ``params_g`` has Res-FFT blocks, else DU-GAN's) and the head-subset
    ``Discriminator.*`` with its ``u`` vectors."""
    gen = (generator_state_dict_from_flax if "fft_0" in params_g
           else redcnn_generator_state_dict_from_flax)(params_g)
    sd = {f"Generator.{k}": v for k, v in gen.items()}
    sd.update({f"Discriminator.{k}": v for k, v in
               discriminator_state_dict_from_flax(params_d, state_d).items()})
    return sd


def _prefixed(prefix: str, sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {f"{prefix}{k}": v for k, v in sd.items()}


def wgan_vgg_state_dict_from_flax(params_g: Mapping[str, Any], params_d: Mapping[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """WGAN-VGG in the ``model_state_dict`` layout (inverse of
    ``convert_wgan_vgg``): ``conv{i}`` / ``conv_out`` -> ``Generator.net.{2
    i}`` / ``Generator.net.22``, the critic's ``conv{i}`` ->
    ``Discriminator.net.{2 i}``, ``fc1``, ``fc2``."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(11):
        _conv_entries(sd, f"Generator.net.{2 * i}", params_g[f"conv{i}"])
    _conv_entries(sd, "Generator.net.22", params_g["conv_out"])
    for i in range(6):
        _conv_entries(sd, f"Discriminator.net.{2 * i}", params_d[f"conv{i}"])
    for fc in ("fc1", "fc2"):
        _dense_entries(sd, f"Discriminator.{fc}", params_d[fc])
    return sd


def map_nn_state_dict_from_flax(params_g: Mapping[str, Any], params_d: Mapping[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    """MAP-NN in the ``model_state_dict`` layout (inverse of
    ``convert_map_nn``): ``Generator.CPCE_2D.*`` and the critic's
    ``Discriminator.conv{1..6}``, ``fc1``, ``fc2``."""
    sd: Dict[str, torch.Tensor] = {}
    cpce = params_g["CPCE_2D"]
    for name, p in cpce.items():
        transposed = name.startswith("decoder") and not name.endswith("_")
        _conv_entries(sd, f"Generator.CPCE_2D.{name}", p, transposed=transposed)
    for i in range(6):
        _conv_entries(sd, f"Discriminator.conv{i + 1}", params_d[f"conv{i}"])
    for fc in ("fc1", "fc2"):
        _dense_entries(sd, f"Discriminator.{fc}", params_d[fc])
    return sd


def _unet_names(n_down: int):
    """(reference name, flax path) of every conv of DU-GAN's U-Net, in the
    order of ``_convert_dugan_unet``."""
    names = []
    for i in range(n_down):
        names += [(f"down_blocks.{i}.conv_res", (f"down{i}_res",)),
                  (f"down_blocks.{i}.net.0", (f"down{i}_net", "conv1")),
                  (f"down_blocks.{i}.net.2", (f"down{i}_net", "conv2"))]
        if i != n_down - 1:
            names.append((f"down_blocks.{i}.down", (f"down{i}_down",)))
    names += [("conv.0", ("bottom", "conv1")), ("conv.2", ("bottom", "conv2"))]
    for j in range(n_down - 1):
        names += [(f"up_blocks.{j}.conv.0", (f"up{j}_net", "conv1")),
                  (f"up_blocks.{j}.conv.2", (f"up{j}_net", "conv2")),
                  (f"up_blocks.{j}.shortcut", (f"up{j}_sc",))]
    return names + [("conv_out", ("conv_out",))]


def _get(tree: Mapping[str, Any], path: Tuple[str, ...]):
    for k in path:
        if k not in tree:
            return None
        tree = tree[k]
    return tree


def unet_state_dict_from_flax(params: Mapping[str, Any], spectral: Mapping[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """DU-GAN's flax ``UNetDiscriminator`` params and its ``spectral`` state
    -> the port's ``UNetDiscriminator`` state dict (inverse of
    ``_convert_dugan_unet``): a conv with a ``u`` becomes a spectral-norm
    layer (``weight_orig``, ``weight_u``, ``weight_v``)."""
    sd: Dict[str, torch.Tensor] = {}
    n_down = sum(1 for k in params if k.endswith("_res"))
    for ref, path in _unet_names(n_down):
        p = _get(params, path)
        w = np.asarray(p["kernel"]).transpose(3, 2, 0, 1)
        u = _get(spectral, path)
        if u is not None:
            _sn_entries(sd, ref, w, u["u"])
        else:
            sd[f"{ref}.weight"] = _t(w)
        sd[f"{ref}.bias"] = _t(p["bias"])
    _dense_entries(sd, "to_logit.3", params["to_logit"])
    return sd


def dugan_state_dict_from_flax(params_g: Mapping[str, Any], params_img_d: Mapping[str, Any],
                               state_img_d: Mapping[str, Any],
                               params_grad_d: Mapping[str, Any],
                               state_grad_d: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """DU-GAN in the ``model_state_dict`` layout (inverse of
    ``convert_dugan``): ``Generator.*``, ``Image_Discriminator.*`` and
    ``Grad_Discriminator.*`` with their ``u`` vectors."""
    sd = _prefixed("Generator.", redcnn_generator_state_dict_from_flax(params_g))
    sd.update(_prefixed("Image_Discriminator.",
                        unet_state_dict_from_flax(params_img_d, state_img_d)))
    sd.update(_prefixed("Grad_Discriminator.",
                        unet_state_dict_from_flax(params_grad_d, state_grad_d)))
    return sd


def _performer_entries(sd: Dict[str, torch.Tensor], pre: str, p: Mapping[str, Any]) -> None:
    _layernorm_entries(sd, f"{pre}.norm1", p["norm1"])
    _dense_entries(sd, f"{pre}.kqv", p["kqv"])
    _dense_entries(sd, f"{pre}.proj", p["proj"])
    _layernorm_entries(sd, f"{pre}.norm2", p["norm2"])
    _dense_entries(sd, f"{pre}.mlp.0", p["mlp_fc1"])
    _dense_entries(sd, f"{pre}.mlp.2", p["mlp_fc2"])
    sd[f"{pre}.w"] = _t(p["w"])


def ctformer_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax CTformer -> the port's ``CTformer`` (inverse of
    ``convert_ctformer``), the performers' fixed ``w`` included."""
    sd: Dict[str, torch.Tensor] = {}
    _performer_entries(sd, "tokens_to_token.attention1", params["enc_attn1"])
    _performer_entries(sd, "tokens_to_token.attention2", params["enc_attn2"])
    _dense_entries(sd, "tokens_to_token.project", params["project"])
    for i in range(sum(1 for k in params if k.startswith("block"))):
        p, pre = params[f"block{i}"], f"blocks.{i}"
        _layernorm_entries(sd, f"{pre}.norm1", p["norm1"])
        _dense_entries(sd, f"{pre}.attn.qkv", p["qkv"])
        _dense_entries(sd, f"{pre}.attn.proj", p["proj"])
        _layernorm_entries(sd, f"{pre}.norm2", p["norm2"])
        _dense_entries(sd, f"{pre}.mlp.fc1", p["mlp_fc1"])
        _dense_entries(sd, f"{pre}.mlp.fc2", p["mlp_fc2"])
    _layernorm_entries(sd, "norm", params["norm"])
    _dense_entries(sd, "dconv1.project", params["deproject"])
    _performer_entries(sd, "dconv1.attention2", params["dec_attn2"])
    _performer_entries(sd, "dconv1.attention1", params["dec_attn1"])
    return sd


RESTORMER_STAGES = (("encoder_level1", "enc1"), ("encoder_level2", "enc2"),
                    ("encoder_level3", "enc3"), ("latent", "latent"),
                    ("decoder_level3", "dec3"), ("decoder_level2", "dec2"),
                    ("decoder_level1", "dec1"), ("refinement", "refine"))


def restormer_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax Restormer -> the port's ``Restormer`` (inverse of
    ``convert_restormer``)."""
    sd: Dict[str, torch.Tensor] = {}
    _conv_entries(sd, "patch_embed.proj", params["patch_embed"])
    for ref, ours in RESTORMER_STAGES:
        i = 0
        while f"{ours}_{i}" in params:
            p, pre = params[f"{ours}_{i}"], f"{ref}.{i}"
            for norm in ("norm1", "norm2"):
                sd[f"{pre}.{norm}.body.weight"] = _t(p[norm]["weight"])
                if "bias" in p[norm]:
                    sd[f"{pre}.{norm}.body.bias"] = _t(p[norm]["bias"])
            sd[f"{pre}.attn.temperature"] = _t(p["attn"]["temperature"])
            for sub, layers in (("attn", ("qkv", "qkv_dwconv", "project_out")),
                                ("ffn", ("project_in", "dwconv", "project_out"))):
                for layer in layers:
                    _conv_entries(sd, f"{pre}.{sub}.{layer}", p[sub][layer])
            i += 1
    for name in ("down1_2", "down2_3", "down3_4", "up4_3", "up3_2", "up2_1"):
        _conv_entries(sd, f"{name}.body.0", params[name])
    _conv_entries(sd, "reduce_chan_level3", params["reduce3"])
    _conv_entries(sd, "reduce_chan_level2", params["reduce2"])
    _conv_entries(sd, "output", params["output"])
    return sd


def _oihw(kernel) -> torch.Tensor:
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))


def vgg19_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """VGG param tree (``conv<N>``: HWIO ``kernel``, ``bias``) ->
    ``features.<N>.weight`` / ``.bias``; serves VGG16 as well."""
    sd: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        idx = int(name[len("conv"):])
        sd[f"features.{idx}.weight"] = _oihw(p["kernel"])
        sd[f"features.{idx}.bias"] = _t(p["bias"])
    return sd


vgg16_state_dict_from_flax = vgg19_state_dict_from_flax


def _bn_entries(sd: Dict[str, torch.Tensor], name: str, p: Mapping[str, Any]) -> None:
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])
    sd[f"{name}.running_mean"] = _t(p["mean"])
    sd[f"{name}.running_var"] = _t(p["var"])


def resnet50_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """ResNet50 param tree (``conv1``, ``bn1``, ``layer<l>_<b>`` blocks with
    ``down_conv`` / ``down_bn`` on the first) -> torchvision names
    (``layer<l>.<b>.conv1.weight``, ``….downsample.0`` / ``.1``)."""
    sd = {"conv1.weight": _oihw(params["conv1"])}
    _bn_entries(sd, "bn1", params["bn1"])
    for name, blk in params.items():
        if not name.startswith("layer"):
            continue
        li, bi = name[len("layer"):].split("_")
        pre = f"layer{li}.{bi}"
        for i in (1, 2, 3):
            sd[f"{pre}.conv{i}.weight"] = _oihw(blk[f"conv{i}"])
            _bn_entries(sd, f"{pre}.bn{i}", blk[f"bn{i}"])
        if "down_conv" in blk:
            sd[f"{pre}.downsample.0.weight"] = _oihw(blk["down_conv"])
            _bn_entries(sd, f"{pre}.downsample.1", blk["down_bn"])
    return sd


def inception_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """FID Inception param tree (``<Module>.<branch>``: ``kernel``, ``scale``,
    ``bias``, ``mean``, ``var``; ``fc``) -> pt_inception names
    (``<Module>.<branch>.conv.weight``, ``… .bn.running_var``, ``fc.weight``)."""
    sd: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        if name == "fc":
            sd["fc.weight"] = _t(np.asarray(p["kernel"]).T)
            sd["fc.bias"] = _t(p["bias"])
            continue
        sd[f"{name}.conv.weight"] = _oihw(p["kernel"])
        _bn_entries(sd, f"{name}.bn", p)
    return sd


def pieapp_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """PieAPP param tree (``conv1`` … ``conv11`` HWIO, the dense layers
    ``(in, out)``) -> PieAPPv0.1 names (OIHW convs, ``(out, in)`` linears)."""
    sd: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        k = np.asarray(p["kernel"])
        sd[f"{name}.weight"] = _oihw(k) if k.ndim == 4 else _t(k.T)
        sd[f"{name}.bias"] = _t(p["bias"])
    return sd


def diffusion_unet_state_dict_from_flax(params: Mapping[str, Any], prefix: str = ""
                                        ) -> Dict[str, torch.Tensor]:
    """flax ``DiffusionUNet`` params -> the port's ``DiffusionUNet`` state
    dict: the module path joined by dots, conv HWIO -> OIHW, dense
    ``(in, out)`` -> ``(out, in)``, GroupNorm ``scale`` -> ``weight``."""
    sd: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        if isinstance(p, Mapping):
            sd.update(diffusion_unet_state_dict_from_flax(p, f"{prefix}{name}."))
            continue
        a = np.asarray(p)
        if name == "kernel":
            sd[f"{prefix}weight"] = _t(a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T)
        else:  # GroupNorm "scale", every "bias"
            sd[f"{prefix}{'weight' if name == 'scale' else name}"] = _t(a)
    return sd


def diffusion_unet_flax_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`diffusion_unet_state_dict_from_flax`: nested
    dicts of float32 numpy arrays."""
    tree: Dict[str, Any] = {}
    for key, v in sd.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        a = v.detach().cpu().numpy()
        if leaf == "weight":
            leaf, a = ("kernel", a.transpose(2, 3, 1, 0)) if a.ndim == 4 else (
                ("kernel", a.T) if a.ndim == 2 else ("scale", a))
        node[leaf] = np.ascontiguousarray(a, np.float32)
    return tree
