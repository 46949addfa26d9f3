"""Weight init, the transposed-conv layout shared by the generator and the
kernel pipeline, the layers with the JAX layers' compute dtype, and the
spectral-norm layers of the discriminator (counterpart of
``mtd_gan_tpu/ops/layers.py``).

Compute dtype (``--bf16``): :class:`Conv2d`, :class:`ConvTranspose2d`,
:class:`Linear`, :class:`SNConv2d` and :class:`SNLinear` take ``dtype``
(``None``: the input's type, fp32 for an fp32 input), cast their input and
their weight and bias to it and return that type, as the JAX ``Conv``,
``ConvTranspose`` and ``Dense`` do (``mtd_gan_tpu/ops/layers.py:135-157,
:205-218, :249-253``). The parameters stay fp32: the master copy the
optimizer updates and the checkpoint stores. The spectral norm's power
iteration and its sigma stay fp32; the normalised weight is cast.

The generator's layers have no spectral norm. Two things need care when
carrying weights between the frameworks:

* flax keeps a transposed-conv kernel as ``(kh, kw, in, out)`` and applies it
  as a conv with the spatial flip; torch's ``ConvTranspose2d`` weight is
  ``(in, out, kh, kw)``;
* at stride 1 with ``padding=1`` a 3x3 ``ConvTranspose2d`` equals ``conv2d``
  with ``w_conv[o, i, y, x] = w_t[i, o, 2 - y, 2 - x]``
  (:func:`conv_transpose_as_conv`), which is how the kernel path runs every
  decoder layer.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

SN_EPS = 1e-12


def widen(t: torch.Tensor) -> torch.Tensor:
    """``t`` in at least fp32: bf16 widened, fp32 and float64 as they are
    (the JAX package's casts to fp32 of a bf16 value, which leave a float64
    reference computation in float64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def compute_dtype(dtype: Optional[torch.dtype], x: torch.Tensor) -> torch.dtype:
    """A layer's compute type: its ``dtype``, else its input's."""
    return dtype or x.dtype


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``dtype`` (module docstring); the same
    parameters and state-dict names."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = compute_dtype(self.dtype, x)
        return self._conv_forward(x.to(d), self.weight.to(d), _cast(self.bias, d))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in ``dtype`` (module docstring)."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = compute_dtype(self.dtype, x)
        return F.conv_transpose2d(x.to(d), self.weight.to(d), _cast(self.bias, d),
                                  self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` (module docstring)."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = compute_dtype(self.dtype, x)
        return F.linear(x.to(d), self.weight.to(d), _cast(self.bias, d))


def normal_init_(module: nn.Module, std: float,
                 generator: torch.Generator) -> nn.Module:
    """N(0, std) weights and zero biases on every conv of ``module``, drawn in
    ``module.modules()`` order from ``generator``, also on linear and
    spectral-norm layers (reference init of the MTD-GAN family, arch/Ours/networks.py:57-61). ``module`` must be on the
    generator's device (the CPU): weights are drawn there and moved after."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear, _SpectralNorm)):
            weight = m.weight_orig if isinstance(m, _SpectralNorm) else m.weight
            with torch.no_grad():
                weight.normal_(0.0, std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
    return module


def torch_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """torch's default ``Conv2d`` / ``ConvTranspose2d`` / ``Linear`` init
    drawn from ``generator`` in ``module.modules()`` order: weight and bias
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in from the weight's dim 1 times
    the kernel area (``out_channels`` for a transposed conv), as torch's
    kaiming-uniform with a = sqrt(5) gives it; the JAX ``torch_init=True``
    of RED-CNN, EDCNN and WGAN-VGG (``mtd_gan_tpu/ops/layers.py``)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            bound = m.weight[0].numel() ** -0.5
            with torch.no_grad():
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
    return module


def conv_transpose_as_conv(weight: torch.Tensor) -> torch.Tensor:
    """``ConvTranspose2d`` weight ``(in, out, kh, kw)`` at stride 1 -> the
    equivalent ``conv2d`` weight ``(out, in, kh, kw)`` (spatial flip + swap),
    the counterpart of ``conv_kmat(flip=True)`` in the JAX pipeline."""
    return weight.flip(2, 3).transpose(0, 1).contiguous()


def spectral_weight_matrix(weight: torch.Tensor) -> torch.Tensor:
    """The ``(out, -1)`` matrix view each spectral-norm layer power-iterates
    (torch's layout: a column permutation of the flax view)."""
    return weight.reshape(weight.shape[0], -1)


def _l2_normalize(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + SN_EPS)


def power_iteration(w_mat: torch.Tensor, u: torch.Tensor, n_iters: int = 1):
    """``n_iters`` steps of ``v = n(W^T u), u = n(W v)`` on the detached
    ``(out, -1)`` weight matrix; returns ``(u, v)``."""
    w_mat = w_mat.detach()
    v = None
    for _ in range(n_iters):
        v = _l2_normalize(w_mat.t() @ u)
        u = _l2_normalize(w_mat @ v)
    return u, v


class _SpectralNorm(nn.Module):
    """Spectral normalisation with an explicit ``u`` buffer (``_SpectralMixin``
    of the JAX package, not ``torch.nn.utils.spectral_norm``): every call runs
    one power iteration on the detached weight, divides the weight by
    ``sigma = u_new . W v`` (the gradient flows through ``W`` only) and stores
    ``u_new`` (and ``v``) only when ``update_stats`` is set. State-dict names
    are the reference's: ``weight_orig``, ``bias``, ``weight_u``,
    ``weight_v``; the ``(out, -1)`` view of a conv weight is torch's, a
    column permutation of the flax view, which leaves ``u`` unchanged."""

    def _init_sn(self, weight_shape, bias: bool):
        self.weight_orig = nn.Parameter(torch.empty(weight_shape))
        self.bias = nn.Parameter(torch.zeros(weight_shape[0])) if bias else None
        rows = weight_shape[0]
        cols = int(torch.tensor(weight_shape[1:]).prod())
        self.register_buffer("weight_u", torch.full((rows,), rows ** -0.5))
        self.register_buffer("weight_v", torch.full((cols,), cols ** -0.5))

    def normalized_weight(self, update_stats: bool) -> torch.Tensor:
        w_mat = spectral_weight_matrix(self.weight_orig)
        with torch.no_grad():
            u, v = power_iteration(w_mat, self.weight_u)
        sigma = torch.dot(u, w_mat @ v)
        if update_stats:
            with torch.no_grad():
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        return self.weight_orig / sigma

    @torch.no_grad()
    def advance(self, n_iters: int) -> None:
        """``n_iters`` power iterations on the current weight, stored."""
        u, v = power_iteration(spectral_weight_matrix(self.weight_orig), self.weight_u,
                               n_iters)
        self.weight_u.copy_(u)
        self.weight_v.copy_(v)


class SNConv2d(_SpectralNorm):
    """Spectral-norm ``Conv2d`` computing in ``dtype`` (module docstring; a
    tuple input takes the first part's type); a tuple input is concatenated
    on channels in order (the JAX layer's sum of per-part convs)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self._init_sn((out_channels, in_channels, kernel_size, kernel_size), bias)

    def forward(self, x, update_stats: bool = True) -> torch.Tensor:
        parts = list(x) if isinstance(x, (tuple, list)) else [x]
        d = compute_dtype(self.dtype, parts[0])
        x = torch.cat([p.to(d) for p in parts], dim=1) if len(parts) > 1 else x.to(d)
        return F.conv2d(x, self.normalized_weight(update_stats).to(d), _cast(self.bias, d),
                        stride=self.stride, padding=self.padding)


class SNLinear(_SpectralNorm):
    """Spectral-norm ``Linear`` computing in ``dtype`` (module docstring)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self._init_sn((out_features, in_features), bias)

    def forward(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        d = compute_dtype(self.dtype, x)
        return F.linear(x.to(d), self.normalized_weight(update_stats).to(d),
                        _cast(self.bias, d))


def advance_spectral_state(module: nn.Module, n_iters: int = 1) -> None:
    """Advance every spectral-norm ``u`` of ``module`` by ``n_iters`` power
    iterations on the current weights, layer by layer (the per-layer path of
    the JAX ``advance_spectral_state``). The iteration never touches
    activations, so it runs decoupled from the forwards."""
    for layer in module.modules():
        if isinstance(layer, _SpectralNorm):
            layer.advance(n_iters)
