"""Channel tensor parallelism of the Res-FFT generator over the model group
of a :class:`~mtd_gan_tpu_torch.parallel.mesh.Grid` (counterpart of
``mtd_gan_tpu/parallel/tensor.py``: ``tp_generate``, ``_row_parallel``,
``_fft_block_tp``, ``_tp_forward``; reference arch/Ours/networks.py:38-164).

* Activations are channel-sharded, ``(N, C/m, H, W)`` on each of the ``m``
  ranks: the 2-D DFTs of a Res-FFT block are per channel and run locally.
* Every 3x3 conv / deconv and the 2C x 2C spectral mix contract the whole
  channel axis: each rank contracts its input shard against its slice of
  the kernel, and the partial sums meet in ONE reduce-scatter per layer,
  which also leaves each rank its own output channels. The mix's output is
  viewed as (2, C), so that a rank's chunk is its channels' real and
  imaginary halves.
* The entry conv (C_in = 1) is column-parallel, with no collective; the
  exit deconv (C_out = 1) ends in an all-reduce, the output replicated.

The weights stay replicated (the generator is 1.4 MB): each rank slices
its shards from the whole parameters, so a parameter's gradient on one
rank is its share, and the sum over the model group is the whole gradient
(``mesh.sum_over_model``). The collectives' backwards are Megatron's
pairs: reduce-scatter forward, all-gather backward; the exit all-reduce,
whose replicated output feeds the same loss on every rank, passes the
cotangent through unchanged. The exit bias is added on model rank 0
before that all-reduce, so it counts once in the sum of the shares.

Plain PyTorch in fp32 (``F.conv2d``, ``torch.fft``), as the JAX einsum
path; no hand-written kernel, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from mtd_gan_tpu_torch.ops.fft_conv import irfft2_real
from mtd_gan_tpu_torch.ops.layers import conv_transpose_as_conv, widen
from mtd_gan_tpu_torch.parallel.mesh import Grid

Tensor = torch.Tensor


class _ReduceScatter(torch.autograd.Function):
    """Sum over ``group`` of ``part``, each rank keeping chunk ``rank`` of
    axis ``dim`` (``size`` chunks); the backward all-gathers the chunks'
    cotangents."""

    @staticmethod
    def forward(ctx, part: Tensor, dim: int, group, size: int) -> Tensor:
        ctx.dim, ctx.group, ctx.size = dim, group, size
        # chunk r of axis dim to the front: rows [r * N, (r + 1) * N)
        stacked = part.unflatten(dim, (size, -1)).movedim(dim, 0)
        out = part.new_empty(stacked.shape[1:])
        dist.reduce_scatter_tensor(out, stacked.flatten(0, 1).contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad: Tensor):
        grad = grad.contiguous()
        full = grad.new_empty((ctx.size * grad.shape[0],) + grad.shape[1:])
        dist.all_gather_into_tensor(full, grad, group=ctx.group)
        full = full.unflatten(0, (ctx.size, -1)).movedim(0, ctx.dim)
        return full.flatten(ctx.dim, ctx.dim + 1), None, None, None


class _AllReduce(torch.autograd.Function):
    """Sum over ``group``, its output replicated and consumed alike on every
    rank; the cotangent passes through unchanged."""

    @staticmethod
    def forward(ctx, part: Tensor, group) -> Tensor:
        out = part.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: Tensor):
        return grad, None


def _chunk(t: Tensor, dim: int, grid: Grid) -> Tensor:
    """This model rank's slice of ``t`` along ``dim`` (``model_size``
    chunks)."""
    n = t.shape[dim] // grid.model_size
    return t.narrow(dim, grid.model_rank * n, n)


def _reduce_scatter(part: Tensor, dim: int, grid: Grid) -> Tensor:
    return _ReduceScatter.apply(part, dim, grid.model_group, grid.model_size)


def _row_parallel(h: Tensor, weight: Tensor, bias: Tensor, grid: Grid) -> Tensor:
    """A 3x3 conv (``weight`` ``(C, C, 3, 3)``, as a conv) on the channel
    shard ``h``: the rank's input columns, the partial outputs
    reduce-scattered, plus the rank's bias slice."""
    part = F.conv2d(h, _chunk(weight, 1, grid), padding=1)
    return _reduce_scatter(part, 1, grid) + _chunk(bias, 0, grid)[:, None, None]


def _fft_block_tp(h: Tensor, block, grid: Grid) -> Tensor:
    """``h + relu(conv3x3(h)) + irfft2(relu(mix([Re; Im] rfft2(h))))`` on
    the channel shard ``h`` (``ops/fft_conv.py::fft_conv_block``); the
    spectral part in fp32, cast to ``h``'s type as the JAX block casts it
    (``mtd_gan_tpu/parallel/tensor.py:89``). The JAX ``tp_generate`` reads
    no model dtype: its activations, and so these, take the input's type,
    fp32."""
    c = block.img_conv.weight.shape[0]
    img = torch.relu(_row_parallel(h, block.img_conv.weight, block.img_conv.bias, grid))
    xf = torch.fft.rfft2(widen(h), norm="ortho")
    mix = block.fft_conv.weight[:, :, 0, 0]  # (out 2C, in 2C)
    cols = torch.cat([_chunk(mix[:, :c], 1, grid), _chunk(mix[:, c:], 1, grid)], dim=1)
    part = F.conv2d(torch.cat([xf.real, xf.imag], dim=1), cols[:, :, None, None])
    n, _, hh, k = part.shape
    # output channels as (part, channel): each rank's chunk is its
    # channels' real and imaginary halves
    spec = _reduce_scatter(part.reshape(n, 2, c, hh, k), 2, grid)
    bias = _chunk(block.fft_conv.bias.reshape(2, c), 1, grid)
    spec = torch.relu(spec + bias[None, :, :, None, None])
    return h + img + irfft2_real(spec[:, 0], spec[:, 1], h.shape[-1]).to(h.dtype)


def tp_generate(generator, x: Tensor, grid: Grid) -> Tensor:
    """The generator forward with its channels split over ``grid``'s model
    group: ``generator`` a
    :class:`~mtd_gan_tpu_torch.models.mtd_gan.ResFFTGenerator` (its
    parameters, replicated), ``x`` ``(N, H, W, 1)`` the rank's rows of the
    batch (the same on every rank of the model group). Returns ``(N, H, W,
    1)``, equal on those ranks; differentiable in the generator's
    parameters, each rank's gradient its share (module docstring).
    ``features`` must divide by the model size."""
    L, c = generator.num_layers, generator.features
    if c % grid.model_size:
        raise ValueError(f"{c} features do not split over {grid.model_size} model ranks")
    n, hh, ww, _ = x.shape
    img = x.reshape(n, 1, hh, ww).float()
    conv = lambda m: (m.weight, m.bias)
    deconv = lambda m: (conv_transpose_as_conv(m.weight), m.bias)

    def layer(h, params, skip: Optional[Tensor] = None):
        out = _row_parallel(h, *params, grid)
        return torch.relu(out if skip is None else out + skip)

    enc0 = generator.encoder[0]
    h = torch.relu(F.conv2d(img, _chunk(enc0.weight, 0, grid), _chunk(enc0.bias, 0, grid),
                            padding=1))
    skips = []
    for i in range(L):
        if i > 0:
            h = layer(h, conv(generator.encoder[i]))
        h = _fft_block_tp(h, generator.enforce[i], grid)
        skips.append(h)
    h = _fft_block_tp(layer(h, conv(generator.encoder[L])), generator.enforce[L], grid)
    h = layer(h, deconv(generator.decoder[L]), skips[-1])
    for i in range(L - 1, 0, -1):
        h = _fft_block_tp(h, generator.enforce[2 * L - i], grid)
        h = layer(h, deconv(generator.decoder[i]), skips[i - 1])
    h = _fft_block_tp(h, generator.enforce[2 * L], grid)
    w0, b0 = deconv(generator.decoder[0])
    # the bias on model rank 0 alone (its share on the others is zero, so
    # every rank's graph reaches every parameter)
    part = F.conv2d(h, _chunk(w0, 1, grid), padding=1) + b0[:, None, None] * (
        grid.model_rank == 0)
    out = _AllReduce.apply(part, grid.model_group)
    return torch.relu(out + img).reshape(n, hh, ww, 1)
