"""Feature-extractor registry (counterpart of
``mtd_gan_tpu/features/registry.py``): torchvision weight discovery and the
extractors, built once per device.

Search order for the state-dict files: ``$MTD_GAN_TPU_WEIGHTS``, then
``$TORCH_HOME/hub/checkpoints``, then ``hub/checkpoints`` under
``~/.cache/torch`` (the JAX package's order);
names ``vgg19-*.pth``, ``resnet50-*.pth`` and ``pt_inception-*.pth``
(WEIGHTS.md). Files load with ``torch.load(..., weights_only=True)`` and
then ``load_state_dict(..., strict=True)`` (without torchvision's classifier
heads, which are not built). A file that is found but does not
load raises; it never falls back. Without a file the extractor takes seeded
He-normal weights drawn from an explicit ``torch.Generator``: functional
and reproducible, but not pretrained, so PL / TML / FID then differ from
the paper's and from the JAX package's fallback (another generator).
Nothing here downloads.

Every extractor runs in fp32 with TF32 off for its convs and matmuls
(:func:`fp32_precision`), the precision of the JAX package's reference.
"""

from __future__ import annotations

import contextlib
import functools
import glob
import os
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from mtd_gan_tpu_torch._device import DeviceLike, resolve_device
from mtd_gan_tpu_torch.features import inception as inception_lib
from mtd_gan_tpu_torch.features import resnet as resnet_lib
from mtd_gan_tpu_torch.features import vgg as vgg_lib

# name -> (file prefix, constructor, fallback init, fallback seed, the state
# dict's entries the extractor has: torchvision's classifier heads are not
# built, pt_inception's fc is)
_SPECS = {
    "vgg19": ("vgg19-", vgg_lib.vgg19_trunk, vgg_lib.init_he_normal_, 19,
              lambda k: k.startswith("features.")),
    "resnet50": ("resnet50-", resnet_lib.ResNet50Trunk, resnet_lib.init_he_normal_, 50,
                 lambda k: not k.startswith("fc.")),
    "inception": ("pt_inception-", inception_lib.FIDInceptionV3,
                  inception_lib.init_he_normal_, 2015, lambda k: True),
}

_STATUS: Dict[str, str] = {}
_CACHE: Dict[Tuple[str, torch.device], nn.Module] = {}


@contextlib.contextmanager
def fp32_precision():
    """TF32 off for cuDNN convs and for matmuls inside the block; the
    previous settings come back after it."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def in_fp32(fn: Callable) -> Callable:
    """``fn`` run inside :func:`fp32_precision`."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with fp32_precision():
            return fn(*args, **kwargs)
    return wrapped


def find_weight_file(prefix: str) -> Optional[str]:
    """The first ``<prefix>*.pth`` (sorted) in the first search root that
    holds one, else ``None``."""
    roots = [os.environ.get("MTD_GAN_TPU_WEIGHTS"),
             os.path.join(os.environ.get("TORCH_HOME", ""), "hub", "checkpoints"),
             os.path.join(os.path.expanduser("~/.cache/torch"), "hub", "checkpoints")]
    for root in roots:
        if not root:
            continue
        hits = sorted(glob.glob(os.path.join(root, f"{prefix}*.pth")))
        if hits:
            return hits[0]
    return None


def build_extractor(name: str) -> nn.Module:
    """A new extractor ``name`` on the CPU, in eval, with its weights: the
    file if one is found, else the seeded fallback. Records the source in
    :func:`feature_weights_status`."""
    prefix, make, init, seed, keep = _SPECS[name]
    model = make()
    path = find_weight_file(prefix)
    if path:
        try:
            sd = torch.load(path, map_location="cpu", weights_only=True)
            model.load_state_dict({k: v for k, v in sd.items() if keep(k)},
                                  strict=True)
        except Exception as e:
            raise RuntimeError(f"{name} weights {path} did not load; remove or replace "
                               f"the file (no fallback is taken when one is found)") from e
        _STATUS[name] = f"torchvision weights: {path}"
    else:
        init(model, torch.Generator().manual_seed(seed))
        _STATUS[name] = f"seeded random fallback (no {prefix}*.pth found)"
    return model.eval().requires_grad_(False)


def get_extractor(name: str, device: DeviceLike = None) -> nn.Module:
    """The extractor ``name`` on ``device`` (default ``cuda``), built on the
    first request for that device and kept."""
    dev = resolve_device(device)
    key = (name, dev)
    if key not in _CACHE:
        _CACHE[key] = build_extractor(name).to(dev)
    return _CACHE[key]


def clear_cache() -> None:
    """Forget every built extractor and its status (e.g. after the weight
    files changed)."""
    _CACHE.clear()
    _STATUS.clear()


def feature_weights_status() -> Dict[str, str]:
    return dict(_STATUS)


def to_rgb_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC, 1 or 3 channels -> NCHW, 3 channels (a gray slice repeated, as
    the reference does, losses.py:59)."""
    if x.shape[-1] == 1:
        x = x.expand(*x.shape[:-1], 3)
    return x.permute(0, 3, 1, 2).contiguous()


def get_vgg_slices_fn(device: DeviceLike = None
                      ) -> Callable[[torch.Tensor], List[torch.Tensor]]:
    """Gray NHWC (B, H, W, 1) -> the NCHW VGG19 activations at the five
    PL / TML slice ends."""
    trunk = get_extractor("vgg19", device)
    return in_fp32(lambda x: trunk(to_rgb_nchw(x)))


def get_resnet_feature_fn(device: DeviceLike = None
                          ) -> Callable[[torch.Tensor], List[torch.Tensor]]:
    """Gray NHWC -> the NCHW ResNet50 block features (EDCNN's compound loss)."""
    model = get_extractor("resnet50", device)
    return in_fp32(lambda x: model(to_rgb_nchw(x)))


def get_inception_feature_fn(device: DeviceLike = None
                             ) -> Callable[[torch.Tensor], torch.Tensor]:
    """[0, 1] NHWC -> (B, 2048) FID pool3 features."""
    model = get_extractor("inception", device)
    return in_fp32(lambda x: inception_lib.inception_pool3_features(model, x))


def get_perceptual_fn(kind: str = "wgan_vgg", device: DeviceLike = None
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Single-output extractors. ``wgan_vgg``: VGG19 ``features[:35]``,
    through relu5_4 (reference arch/WGAN_VGG/networks.py:54-64)."""
    if kind != "wgan_vgg":
        raise KeyError(kind)
    trunk = get_extractor("vgg19", device)
    return in_fp32(lambda x: trunk(to_rgb_nchw(x), (vgg_lib.WGAN_VGG_END,))[0])
