"""Weight init, the transposed-conv layout shared by the generator and the
kernel pipeline, and the spectral-norm layers of the discriminator
(counterpart of ``mtd_gan_tpu/ops/layers.py``).

The generator uses plain ``nn.Conv2d`` / ``nn.ConvTranspose2d`` (no spectral
norm). Two things need care when carrying weights between the frameworks:

* flax keeps a transposed-conv kernel as ``(kh, kw, in, out)`` and applies it
  as a conv with the spatial flip; torch's ``ConvTranspose2d`` weight is
  ``(in, out, kh, kw)``;
* at stride 1 with ``padding=1`` a 3x3 ``ConvTranspose2d`` equals ``conv2d``
  with ``w_conv[o, i, y, x] = w_t[i, o, 2 - y, 2 - x]``
  (:func:`conv_transpose_as_conv`), which is how the kernel path runs every
  decoder layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

SN_EPS = 1e-12


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
    """Spectral-norm ``Conv2d``; a tuple input is concatenated on channels in
    order (the JAX layer's sum of per-part convs)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self._init_sn((out_channels, in_channels, kernel_size, kernel_size), bias)

    def forward(self, x, update_stats: bool = True) -> torch.Tensor:
        if isinstance(x, (tuple, list)):
            x = torch.cat(list(x), dim=1)
        return F.conv2d(x, self.normalized_weight(update_stats), self.bias,
                        stride=self.stride, padding=self.padding)


class SNLinear(_SpectralNorm):
    """Spectral-norm ``Linear``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self._init_sn((out_features, in_features), bias)

    def forward(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        return F.linear(x, self.normalized_weight(update_stats), self.bias)


def advance_spectral_state(module: nn.Module, n_iters: int = 1) -> None:
    """Advance every spectral-norm ``u`` of ``module`` by ``n_iters`` power
    iterations on the current weights, layer by layer (the per-layer path of
    the JAX ``advance_spectral_state``). The iteration never touches
    activations, so it runs decoupled from the forwards."""
    for layer in module.modules():
        if isinstance(layer, _SpectralNorm):
            layer.advance(n_iters)
