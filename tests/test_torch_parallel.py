"""The port's parallel layer and packed generator against the JAX package:
``parallel/tensor.py::tp_generate`` on 2 gloo ranks against the JAX
``tp_generate`` on a 2-device CPU mesh and against the single-device
generator (features 8, 2 layers, 2 x 16^2; atol 2e-5, as
tests/test_tensor_parallel.py:21-27), its parameter gradients against
``jax.grad`` (atol 3e-5, :44-63), the 2 x 2 data x model composition on 4
ranks (:30-38); ``models/packed.py::packed_resfft_apply`` against the JAX
one and the port's generator (fp32, rtol 1e-4 / atol 1e-5, as
tests/test_models.py:118); ``build_trainer``'s refusals of TensorParallel;
``--g-forward pallas_packed``'s gradient (it runs as ``pallas``, K1 + K2,
their plain versions on the CPU) against ``einsum``'s; the grid's shapes, rows and draws without ranks."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from mtd_gan_tpu.models.mtd_gan import ResFFTGenerator as JaxGenerator
from mtd_gan_tpu.models.packed import packed_resfft_apply as jax_packed
from mtd_gan_tpu.parallel.tensor import tp_generate as jax_tp_generate
from mtd_gan_tpu_torch.engine import loops
from mtd_gan_tpu_torch.models import get_model
from mtd_gan_tpu_torch.models.mtd_gan import ResFFTGenerator
from mtd_gan_tpu_torch.models.packed import packed_resfft_apply
from mtd_gan_tpu_torch.ops.cuda_train import resfft_generator_train, resolve_g_forward
from mtd_gan_tpu_torch.parallel import mesh
from mtd_gan_tpu_torch.utils.torch_import import generator_state_dict_from_flax
from test_torch_parallel_helpers import run_ranks, tp_forward_and_grads

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

C, L, S = 8, 2, 16
ATOL_TP, ATOL_GRAD = 2e-5, 3e-5
host = lambda t: jax.tree_util.tree_map(np.asarray, t)


def _params(seed=0):
    """flax params_g, every leaf drawn with numpy: weights N(0, 0.25 /
    fan_in), biases N(0, 0.05^2) (nonzero, so that a bias counted on the
    wrong ranks shows)."""
    shapes = jax.eval_shape(JaxGenerator(features=C, num_layers=L).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, S, S, 1)))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if "bias" in jax.tree_util.keystr(path):
            return (0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan_in = leaf.shape[0] if len(leaf.shape) == 2 else int(np.prod(leaf.shape[:3]))
        return (0.5 * rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _data(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((n, S, S, 1)).astype(np.float32)
    return x, np.clip(x + 0.05 * rng.standard_normal(x.shape), 0, 1).astype(np.float32)


def _jax_forward(mesh_=None):
    """The JAX generator (``tp_generate`` on ``mesh_``, else the
    single-device module), jitted: op by op it takes minutes here."""
    if mesh_ is None:
        gen = JaxGenerator(features=C, num_layers=L)
        return jax.jit(lambda p, x: gen.apply({"params": p}, x))
    return jax.jit(lambda p, x: jax_tp_generate(p, x, mesh_, num_layers=L, features=C))


def _jax_grads(params, x, y, mesh_=None):
    fwd = _jax_forward(mesh_)
    grad = jax.jit(jax.grad(lambda p: jnp.mean((fwd(p, x) - y) ** 2)))
    return generator_state_dict_from_flax(host(grad(params)))


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """The port's tp_generate and its gradients on 2 ranks (one model group)
    and on 4 (2 x 2), and the JAX side of each."""
    params = _params()
    state = generator_state_dict_from_flax(params)
    runs = {}
    for world, tp, n, seed in ((2, -1, 2, 1), (4, 2, 4, 2)):
        x, y = _data(n, seed)
        ranks = run_ranks(tp_forward_and_grads, world, tmp_path_factory.mktemp(f"tp{world}"),
                          state, C, L, torch.tensor(x), torch.tensor(y), tp)
        devices = np.array(jax.devices()[:world])
        jax_mesh = (Mesh(devices, ("model",)) if world == 2 else
                    Mesh(devices.reshape(2, 2), ("data", "model")))
        runs[world] = dict(x=x, y=y, ranks=ranks, mesh=jax_mesh, params=params)
    return runs


def _gathered(ranks):
    """The global batch's output from each model column's data shards."""
    data_size = max(res["data_rank"] for res in ranks) + 1
    model_size = len(ranks) // data_size
    return [np.concatenate([ranks[d * model_size + m]["out"].numpy()
                            for d in range(data_size)]) for m in range(model_size)]


def test_tp_forward_matches_jax_tp_and_the_single_device_generator(tp_runs):
    run = tp_runs[2]
    x, params = run["x"], run["params"]
    want_tp = np.asarray(_jax_forward(run["mesh"])(params, x))
    want = np.asarray(_jax_forward()(params, x))
    for got in _gathered(run["ranks"]):
        np.testing.assert_allclose(got, want_tp, atol=ATOL_TP)
        np.testing.assert_allclose(got, want, atol=ATOL_TP)


def test_tp_gradients_match_jax_grad(tp_runs):
    run = tp_runs[2]
    want = _jax_grads(run["params"], run["x"], run["y"], run["mesh"])
    for res in run["ranks"]:
        assert res["grads"].keys() == want.keys()
        for k, g in res["grads"].items():
            np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=ATOL_GRAD, err_msg=k)


def test_tp_composes_with_the_data_axis(tp_runs):
    """2 x 2 ranks: the batch split over data, the channels over model; the
    gradients against ``jax.grad`` of the single-device generator."""
    run = tp_runs[4]
    x, params = run["x"], run["params"]
    want = np.asarray(_jax_forward(run["mesh"])(params, x))
    for got in _gathered(run["ranks"]):
        np.testing.assert_allclose(got, want, atol=ATOL_TP)
    grads = _jax_grads(params, x, run["y"])
    for res in run["ranks"]:
        for k, g in res["grads"].items():
            np.testing.assert_allclose(g.numpy(), grads[k].numpy(), atol=ATOL_GRAD, err_msg=k)


def test_packed_generator_matches_jax_and_the_generator():
    params = _params(3)
    x = np.random.default_rng(4).random((4, 32, 32, 1)).astype(np.float32)
    want = np.asarray(jax_packed(params, x, features=C, num_layers=L, groups=4,
                                 dtype=jnp.float32))
    state = generator_state_dict_from_flax(host(params))
    got = packed_resfft_apply(state, torch.tensor(x), features=C, num_layers=L, groups=4,
                              dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    gen = ResFFTGenerator(1, C, L)
    gen.load_state_dict(state)
    with torch.no_grad():
        plain = gen(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="does not pack"):
        packed_resfft_apply(state, torch.tensor(x[:3]), features=C, num_layers=L)
    assert packed_resfft_apply(state, torch.tensor(x), features=C,
                               num_layers=L).dtype == torch.bfloat16


@pytest.mark.parametrize("name,kwargs,match", [
    ("RED_CNN", {"out_ch": 8}, "use DataParallel"),
    ("Ablation_CLS", {"gen_features": 8, "disc_features": 8, "num_layers": 1},
     "full MTD_GAN_Method"),
])
def test_build_trainer_refuses_tensor_parallel_outside_the_flagship(name, kwargs, match):
    args = argparse.Namespace(optimizer="adamw", lr=1e-4, method="pcgrad",
                              multi_gpu_mode="TensorParallel", g_forward="auto")
    with pytest.raises(ValueError, match=match):
        loops.build_trainer(name, get_model(name, device="cpu", **kwargs), args)


def test_pallas_packed_gradient_matches_einsum():
    """``--g-forward pallas_packed`` runs as ``pallas`` (K1 + K2; their
    plain versions here), whose gradient matches the plain generator's;
    both refuse a batch K1 + K2 do not take."""
    gen = ResFFTGenerator(1, C, L)
    gen.load_state_dict(generator_state_dict_from_flax(_params(5)))
    x, y = (torch.tensor(a) for a in _data(2, 6))
    x64 = torch.nn.functional.interpolate(x.permute(0, 3, 1, 2), size=64).permute(0, 2, 3, 1)
    y64 = torch.nn.functional.interpolate(y.permute(0, 3, 1, 2), size=64).permute(0, 2, 3, 1)
    params = list(gen.parameters())
    plain = lambda t: gen(t.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    got, want = (torch.autograd.grad(((fwd(gen, x64) if fwd else plain(x64)) - y64)
                                     .square().mean(), params)
                 for fwd in (resfft_generator_train, None))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-7)
    assert [resolve_g_forward(r, 64, 64, C) for r in ("auto", "einsum", "pallas",
                                                      "pallas_packed")] == [
        "pallas", "einsum", "pallas", "pallas"]
    assert resolve_g_forward("auto", S, S, C) == "einsum"
    with pytest.raises(ValueError, match="K1 \\+ K2 take"):
        resolve_g_forward("pallas", S, S, C)
    with pytest.raises(ValueError, match="'pallas_packed': K1 \\+ K2 take"):
        resolve_g_forward("pallas_packed", S, S, C)
    with pytest.raises(ValueError, match="must be one of"):
        resolve_g_forward("xla", 64, 64, C)


def test_grid_shapes_rows_and_draws_without_ranks():
    """``grid_shape`` as the root's mesh, ``shard_batch`` and ``batch_draw``
    on a grid object (no process group: they need none)."""
    assert mesh.grid_shape("DataParallel", 4) == (4, 1)
    assert mesh.grid_shape("TensorParallel", 4) == (1, 4)
    assert mesh.grid_shape("TensorParallel", 4, 2) == (2, 2)
    for mode, tp in (("TensorParallel", 3), ("Pipeline", -1)):
        with pytest.raises(ValueError):
            mesh.grid_shape(mode, 4, tp)
    assert mesh.make_grid("Single") is None
    grid = mesh.Grid(rank=3, world=4, device=torch.device("cpu"), data_size=2,
                     model_size=2, data_group=None, model_group=None)
    assert (grid.data_rank, grid.model_rank) == (1, 1)
    x = torch.arange(8.0)
    assert mesh.shard_batch(grid, x).tolist() == [4.0, 5.0, 6.0, 7.0]
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_batch(grid, x[:3])
    # a [y; fake] pass of 2 x 3 rows: the global draw is 2 x 6 rows, this
    # data rank keeps rows 3-5 of each half
    draw = lambda s: torch.arange(float(np.prod(s))).reshape(s)
    with mesh.batch_draws(grid, 3):
        got = mesh.batch_draw(draw, (6, 2))
        with pytest.raises(ValueError, match="whole chunks"):
            mesh.batch_draw(draw, (4, 2))
    assert got[:, 0].tolist() == [6.0, 8.0, 10.0, 18.0, 20.0, 22.0]
    assert mesh.batch_draw(draw, (6, 2)).equal(draw((6, 2)))
