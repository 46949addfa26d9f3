"""Helpers shared by the parallel-layer tests of the port
(``test_torch_parallel.py``, ``test_torch_parallel_steps.py``,
``test_torch_parallel_cli.py``): spawning gloo ranks on the CPU and the
rank-side work. It imports no JAX (the spawned ranks import it) and holds
no tests of its own: pytest collects nothing here.

Each rank is a process started with ``spawn``, joined to its group by
``file://`` init in the test's ``tmp_path`` (no port, so test workers never
collide), with one intra-op thread; what it returns is saved with
``torch.save`` and read back by the parent."""

import datetime
import json
import os
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mtd_gan_tpu_torch.data.dicom import write_synthetic_dicom
from mtd_gan_tpu_torch.engine.gan import MTDGANTrainer
from mtd_gan_tpu_torch.engine.supervised import SupervisedTrainer
from mtd_gan_tpu_torch.engine.wgan import AdversarialTrainer
from mtd_gan_tpu_torch.models import get_model
from mtd_gan_tpu_torch.models.mtd_gan import ResFFTGenerator
from mtd_gan_tpu_torch.parallel import mesh
from mtd_gan_tpu_torch.parallel.tensor import tp_generate

# the steps against the single-rank step on the whole batch
RTOL_LOSS = 1e-5
RTOL_PARAM, ATOL_PARAM = 2e-4, 2e-6
TINY_UNET = dict(channels=(8, 16, 16), num_head_channels=16, norm_groups=4)


def _rank_main(rank: int, fn: Callable, world: int, init: str, out: str, args,
               timeout: Optional[float]) -> None:
    torch.set_num_threads(1)
    extra = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world, **extra)
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))


def run_ranks(fn: Callable, world: int, tmp: Path, *args, meanwhile: Callable = None,
              timeout: Optional[float] = None):
    """``fn(*args)`` on ``world`` spawned gloo ranks; their results by
    rank. A rank that raises fails the call. With ``meanwhile``, returns
    (the results, ``meanwhile()``), which runs here while the ranks run.
    ``timeout``: the process group's, in seconds (else torch's default)."""
    tmp.mkdir(parents=True, exist_ok=True)
    init = tmp / "init"
    ranks = mp.start_processes(_rank_main,
                               args=(fn, world, str(init), str(tmp), args, timeout),
                               nprocs=world, start_method="spawn", join=False)
    here = meanwhile() if meanwhile is not None else None
    while not ranks.join():
        pass
    got = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]
    return got if meanwhile is None else (got, here)


# ---- the tensor-parallel generator ----

def tp_forward_and_grads(state: Dict[str, torch.Tensor], features: int, num_layers: int,
                         x: torch.Tensor, y: torch.Tensor, tp_size: int) -> Dict:
    """On each rank: ``tp_generate`` on its data rows, and the gradient of
    the global batch's mean squared error w.r.t. every generator parameter
    (summed over the model group, averaged over the data group)."""
    grid = mesh.make_grid("TensorParallel", tp_size, "cpu")
    gen = ResFFTGenerator(1, features, num_layers)
    gen.load_state_dict(state)
    out = tp_generate(gen, mesh.shard_batch(grid, x), grid)
    loss = ((out - mesh.shard_batch(grid, y)) ** 2).mean()
    names = [n for n, _ in gen.named_parameters()]
    grads = torch.autograd.grad(loss, list(gen.parameters()))
    grads = mesh.mean_over_data(grid, mesh.sum_over_model(grid, grads))
    return {"data_rank": grid.data_rank, "out": out.detach(),
            "grads": dict(zip(names, grads))}


# ---- one trainer step at a time, single rank or on a grid ----

def build(kind: str, grid: Optional[mesh.Grid]):
    """The trainer of ``kind`` (``mtd`` the flagship with PCGrad and its
    dropout on, ``mtd_tp`` the same with the generator split over the model
    group, ``mtd_einsum`` the flagship on the plain generator, ``red_cnn``,
    ``wgan_vgg`` without the perceptual loss, ``ddim`` a tiny UNet), small,
    on the CPU, seed 0."""
    if kind.startswith("mtd"):
        model = get_model("MTD_GAN_Method", gen_features=8, disc_features=8, num_layers=1,
                          device="cpu", seed=0)
        return MTDGANTrainer(model, method="pcgrad", seed=0, grid=grid,
                             tensor_parallel=kind == "mtd_tp",
                             g_forward="einsum" if kind == "mtd_einsum" else "auto")
    if kind == "red_cnn":
        return SupervisedTrainer(get_model("RED_CNN", out_ch=8, device="cpu", seed=0),
                                 seed=0, grid=grid)
    if kind == "wgan_vgg":
        model = get_model("WGAN_VGG", use_perceptual=False, device="cpu", seed=0)
        return AdversarialTrainer(model, n_critic=model.d_steps_per_g, seed=0, grid=grid)
    if kind == "ddim":
        return SupervisedTrainer(get_model("DDIM", **TINY_UNET, device="cpu", seed=0),
                                 seed=0, grid=grid)
    raise KeyError(kind)


def state_of(trainer) -> Dict[str, torch.Tensor]:
    """Every network's state dict (parameters and spectral-norm vectors),
    and each optimizer's first moment over 0.1 (after one step the
    gradient itself; after more, the same linear mix of the gradients in
    both runs), which holds the scale of the gradients that AdamW's update
    does not show."""
    model = trainer.model
    nets = ({"net": model.net} if hasattr(model, "net") else
            {"g": model.generator, "d": model.discriminator})
    state = {f"{k}.{n}": v.detach().clone() for k, m in nets.items()
             for n, v in m.state_dict().items()}
    for attr, opt in vars(trainer).items():
        if isinstance(opt, torch.optim.Optimizer):
            params = [p for group in opt.param_groups for p in group["params"]]
            for i, p in enumerate(params):
                if "exp_avg" in opt.state.get(p, {}):
                    state[f"{attr}.exp_avg.{i}"] = opt.state[p]["exp_avg"] / 0.1
    return state


def run_steps(kind: str, grid: Optional[mesh.Grid], batches: Sequence) -> Dict:
    """The trainer of ``kind`` through ``batches`` (global ``(x, y)``), each
    rank on its rows; the metrics of every step and the state after."""
    trainer = build(kind, grid)
    metrics = []
    for x, y in batches:
        m = trainer.train_step(mesh.shard_batch(grid, x), mesh.shard_batch(grid, y))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "state": state_of(trainer)}


def steps_on_grid(mode: str, kind: str, batches: Sequence) -> Dict:
    return run_steps(kind, mesh.make_grid(mode, -1, "cpu"), batches)


def batches(size: int, n: int, steps: int, seed: int = 0) -> List:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        x = rng.random((n, size, size, 1)).astype(np.float32)
        y = np.clip(x + 0.05 * rng.standard_normal(x.shape), 0, 1).astype(np.float32)
        out.append((torch.tensor(x), torch.tensor(y)))
    return out


def assert_steps_match(got: Dict, want: Dict) -> None:
    for m_got, m_want in zip(got["metrics"], want["metrics"], strict=True):
        assert m_got.keys() == m_want.keys()
        for k in m_want:
            np.testing.assert_allclose(m_got[k], m_want[k], rtol=RTOL_LOSS, err_msg=k)
    assert got["state"].keys() == want["state"].keys()
    for k, v in want["state"].items():
        np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), rtol=RTOL_PARAM,
                                   atol=ATOL_PARAM, err_msg=k)


# ---- the train CLI ----

def write_dataset(root: Path, splits: Dict[str, int], size: int = 96) -> None:
    """Synthetic low / full dose DICOM pairs ``<split>/case0/{n_20,n_100}``."""
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:size, 0:size] / size - 0.5
    body = (xx ** 2 / 0.16 + yy ** 2 / 0.1 < 1) * 200.0
    for split, n in splits.items():
        for i in range(n):
            for key, noise in (("n_20", 60.0), ("n_100", 15.0)):
                hu = body - 100.0 + noise * rng.standard_normal((size, size))
                write_synthetic_dicom(str(root / split / "case0" / key / f"s{i}.IMA"),
                                      np.round(hu + 1024.0).astype(np.uint16))


def train_argv(data: Path, out: Path, *extra: str) -> List[str]:
    """One epoch of the flagship (8 features, one layer, PCGrad, no warm-up:
    the full learning rate) on the ``window_patch`` crops of 2-slice
    batches, validation on, on the CPU; the files under ``out``."""
    return ["--device", "cpu", "--data-root", str(data), "--batch-size", "2",
            "--epochs", "1", "--warmup-epochs", "0", "--method", "pcgrad",
            "--train-num-workers", "1",
            "--model-kwargs", json.dumps({"gen_features": 8, "disc_features": 8,
                                          "num_layers": 1}),
            "--checkpoint-dir", str(out / "ckpt"), "--save-dir", str(out / "pred"), *extra]


def train_cli(argv: List[str]) -> Dict:
    from mtd_gan_tpu_torch import train

    return train.main(train.get_args_parser().parse_args(argv))


def train_clis(runs: Sequence[Tuple[List[str], float]]) -> List[Dict]:
    """The train CLI once for each ``(argv, delay)`` of ``runs``, in turn,
    in the caller's process group (each run builds its grid on it and
    leaves it up); each validation of the run takes ``delay`` seconds more."""
    from mtd_gan_tpu_torch import train

    real, out = train.validate, []
    for argv, delay in runs:
        def slow(*args, delay=delay, **kwargs):
            time.sleep(delay)
            return real(*args, **kwargs)

        train.validate = slow
        try:
            out.append(train_cli(argv))
        finally:
            train.validate = real
    return out
