"""The process grid of a multi-rank run over ``torch.distributed``
(counterpart of ``mtd_gan_tpu/parallel/mesh.py``: ``make_mesh``,
``batch_sharding``, ``replicated_sharding``, ``shard_batch``; reference
train.py:93-110).

One process per rank, as ``torchrun`` starts them::

    torchrun --standalone --nproc-per-node N -m mtd_gan_tpu_torch.train \
        --multi-gpu-mode DataParallel ...

``DataParallel`` is a 1-D data grid: parameters replicated on every rank,
the global batch split by rows, gradients and metrics averaged over the
ranks, so a step equals the single-rank step on the whole batch.
``TensorParallel`` is a 2-D (data x model) grid of ``data_size x
model_size`` ranks: rank ``d * model_size + m`` holds data row ``d`` and
model column ``m``, as the JAX mesh ``reshape(data, model)`` places its
devices; the MTD-GAN generator runs channel-sharded over the model group
(:mod:`~mtd_gan_tpu_torch.parallel.tensor`).

Every random draw whose shape leads with the batch is taken at the global
batch's shape from the same seeded generator on every rank, and each rank
keeps its rows (:func:`batch_draws`, :func:`batch_draw`): the dropout
masks, the gradient penalty's ``a``, the diffusion models' noise and
timesteps. Draws that do not depend on the batch (PCGrad's orders, RLW's
normals, DU-GAN's CutMix box) come out equal on every rank as they are.

Backend ``nccl`` with each rank on ``cuda:LOCAL_RANK``, ``gloo`` on the
CPU. A failed init or collective raises: a run never goes on as one rank.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import socket
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from mtd_gan_tpu_torch._device import DeviceLike, resolve_device

Tensor = torch.Tensor
MODES = ("Single", "DataParallel", "TensorParallel")


@dataclass
class Grid:
    """This rank's place in the grid. ``data_group`` holds the ranks of its
    model column (the same model shard, other rows of the batch),
    ``model_group`` those of its data row; ``owns_group``: the grid
    initialized the default process group and :func:`destroy` ends it."""

    rank: int
    world: int
    device: torch.device
    data_size: int
    model_size: int
    data_group: dist.ProcessGroup
    model_group: dist.ProcessGroup
    owns_group: bool = False

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_size

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_size


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def grid_shape(mode: str, world: int, tp_size: int = -1) -> Tuple[int, int]:
    """``(data_size, model_size)`` for ``--multi-gpu-mode`` and
    ``--tp-size`` (root train.py:136-143): ``DataParallel`` all ranks on the
    data axis; ``TensorParallel`` ``tp_size`` ranks a model group (-1: all
    of them) and the rest on the data axis."""
    if mode == "DataParallel":
        return world, 1
    if mode != "TensorParallel":
        raise ValueError(f"--multi-gpu-mode must be one of {MODES}, got {mode!r}")
    model = world if tp_size == -1 else tp_size
    if model < 1 or world % model:
        raise ValueError(f"--tp-size {tp_size} does not divide the {world} ranks")
    return world // model, model


def make_grid(mode: str, tp_size: int = -1, device: DeviceLike = None) -> Optional[Grid]:
    """The grid of ``mode`` (``None`` for ``Single``).

    The default process group is the caller's where one is initialized;
    else it comes from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), or
    without it is one rank on a free localhost port, so that the same code
    runs. ``device``: ``cuda`` (``cuda:LOCAL_RANK``, backend ``nccl``) or
    ``cpu`` (``gloo``)."""
    if mode == "Single":
        return None
    dev = resolve_device(device)
    owns = not dist.is_initialized()
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if owns:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "RANK" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
                                    rank=0, world_size=1)
    rank, world = dist.get_rank(), dist.get_world_size()
    data_size, model_size = grid_shape(mode, world, tp_size)
    # every rank creates every group, in the same order
    data_groups = [dist.new_group([d * model_size + m for d in range(data_size)])
                   for m in range(model_size)]
    model_groups = [dist.new_group([d * model_size + m for m in range(model_size)])
                    for d in range(data_size)]
    return Grid(rank, world, dev, data_size, model_size,
                data_groups[rank % model_size], model_groups[rank // model_size], owns)


def destroy(grid: Optional[Grid]) -> None:
    """Ends the default process group where :func:`make_grid` began it."""
    if grid is not None and grid.owns_group:
        dist.destroy_process_group()


def is_main(grid: Optional[Grid]) -> bool:
    """Rank 0 (or no grid): the rank that writes files."""
    return grid is None or grid.rank == 0


def barrier(grid: Optional[Grid]) -> None:
    if grid is not None:
        if grid.device.type == "cuda":
            dist.barrier(device_ids=[grid.device.index])
        else:
            dist.barrier()


def shard_batch(grid: Optional[Grid], x: Tensor) -> Tensor:
    """This rank's rows of the global batch ``x``: data row ``d`` of ``D``
    keeps rows ``[d * N / D, (d + 1) * N / D)``. Raises unless N divides by
    the data size, as JAX's batch sharding does."""
    if grid is None:
        return x
    n = x.shape[0]
    if n % grid.data_size:
        raise ValueError(f"a batch of {n} does not split over {grid.data_size} data ranks")
    rows = n // grid.data_size
    return x[grid.data_rank * rows:(grid.data_rank + 1) * rows]


def _all_reduce_flat(tensors: Sequence[Optional[Tensor]], group, scale: float
                     ) -> List[Optional[Tensor]]:
    """One all-reduce (sum) of every tensor of ``tensors`` over ``group``,
    times ``scale``; ``None`` entries stay ``None``."""
    present = [t for t in tensors if t is not None]
    if not present:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1) for t in present])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat.mul_(scale)
    out, at = [], 0
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


def mean_over_data(grid: Optional[Grid], tensors: Sequence[Optional[Tensor]]
                   ) -> List[Optional[Tensor]]:
    """The mean over the data group of each of ``tensors`` (gradients, loss
    values, metrics), in one collective; as given without a grid."""
    if grid is None:
        return list(tensors)
    return _all_reduce_flat(tensors, grid.data_group, 1.0 / grid.data_size)


def sum_over_model(grid: Optional[Grid], tensors: Sequence[Optional[Tensor]]
                   ) -> List[Optional[Tensor]]:
    """The sum over the model group: the whole gradient of a replicated
    weight from each rank's share of it (tensor parallel)."""
    if grid is None or grid.model_size == 1:
        return list(tensors)
    return _all_reduce_flat(tensors, grid.model_group, 1.0)


def average_grads(grid: Optional[Grid], params) -> None:
    """Each ``.grad`` of ``params`` replaced by its mean over the data group
    (one collective; a parameter without a gradient keeps none)."""
    if grid is None:
        return
    params = list(params)
    for p, g in zip(params, mean_over_data(grid, [p.grad for p in params])):
        p.grad = g


def mean_metrics(grid: Optional[Grid], metrics: dict) -> dict:
    """A step's 0-d metrics averaged over the data group (each is a batch
    mean over equal shards, so this is the global batch's value)."""
    if grid is None:
        return metrics
    return dict(zip(metrics, mean_over_data(grid, list(metrics.values()))))


# (rows of one chunk on this rank, data rank, data size) inside a step
_DRAW_ROWS: contextvars.ContextVar[Optional[Tuple[int, int, int]]] = (
    contextvars.ContextVar("draw_rows", default=None))


@contextlib.contextmanager
def batch_draws(grid: Optional[Grid], rows: int) -> Iterator[None]:
    """Inside, :func:`batch_draw` takes each batch-shaped draw at the
    global batch's shape and keeps this rank's rows; ``rows``: the rank's
    batch (``x.shape[0]``). Nothing changes without a grid."""
    token = _DRAW_ROWS.set(None if grid is None else (rows, grid.data_rank, grid.data_size))
    try:
        yield
    finally:
        _DRAW_ROWS.reset(token)


def batch_draw(sample: Callable[[Tuple[int, ...]], Tensor], shape: Sequence[int]) -> Tensor:
    """``sample(shape)``, or inside :func:`batch_draws` this rank's rows of
    ``sample`` at the global shape. A draw's leading axis is ``k`` chunks of
    the rank's batch (``k = 2`` for a discriminator pass over ``[y;
    fake]``); the global draw's is ``k`` chunks of the global batch, and
    the rank keeps its rows of each."""
    shape = tuple(shape)
    ctx = _DRAW_ROWS.get()
    if ctx is None:
        return sample(shape)
    rows, data_rank, data_size = ctx
    if shape[0] % rows:
        raise ValueError(f"a draw of {shape[0]} rows is not whole chunks of {rows}")
    full = sample((shape[0] * data_size,) + shape[1:])
    k, total = shape[0] // rows, rows * data_size
    keep = torch.cat([torch.arange(j * total + data_rank * rows,
                                   j * total + (data_rank + 1) * rows) for j in range(k)])
    return full[keep.to(full.device)]
