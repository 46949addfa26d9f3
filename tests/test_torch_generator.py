"""MTD-GAN generator of the PyTorch port (mtd_gan_tpu_torch/models/mtd_gan.py
and ops/cuda_pipeline.py) against the JAX package on the CPU."""

import jax
import numpy as np
import pytest
import torch

from mtd_gan_tpu.models.mtd_gan import MTDGANModel as JaxModel
from mtd_gan_tpu.ops import pallas_pipeline as pp
from mtd_gan_tpu_torch.models.mtd_gan import MTDGANModel
from mtd_gan_tpu_torch.ops import cuda_pipeline
from mtd_gan_tpu_torch.utils.torch_import import generator_state_dict_from_flax

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

L, C, N, S = 2, 8, 2, 64
INITS = ("reference", "fan_in")


def _params(init):
    """flax params_g: the JAX model's own init (reference N(0, 0.01)), or
    the same tree redrawn with std 1/sqrt(fan_in) weights and 0.1 biases."""
    jm = JaxModel(gen_features=C, disc_features=8, num_layers=L)
    params = jax.jit(jm.Generator.init)(
        jax.random.PRNGKey(0), np.zeros((1, S, S, 1), np.float32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    if init == "fan_in":
        rng = np.random.default_rng(1)

        def redraw(path, leaf):
            name = jax.tree_util.keystr(path)
            if "bias" in name:
                return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)
            fan_in = leaf.shape[0] if leaf.ndim == 2 else int(np.prod(leaf.shape[:3]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

        params = jax.tree_util.tree_map_with_path(redraw, params)
    return jm, params


def _x(seed=2):
    return np.random.default_rng(seed).random((N, S, S, 1)).astype(np.float32)


def _port(params):
    model = MTDGANModel(gen_features=C, num_layers=L, device="cpu")
    model.generator.load_state_dict(generator_state_dict_from_flax(params),
                                    strict=True)
    return model


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("init", INITS)
def test_generate_cpu_matches_jax(init):
    """Port generate(device="cpu") vs JAX MTDGANModel.generate on the CPU
    (fp32 Generator.apply, jnp.fft): atol 1e-5 at the reference init,
    1e-5 relative with fan_in weights (fp32 FFT/conv round-off through
    2L+1 = 5 blocks)."""
    jm, params = _params(init)
    x = _x()
    want = np.asarray(jm.generate(params, x))
    got = _port(params).generate(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (N, S, S, 1)
    if init == "reference":
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        assert _rel(got, want) < 1e-5


def test_generate_cpu_matches_jax_pallas_pipeline():
    """Against the JAX kernel pipeline (resfft_generator_nchw, interpret
    mode: bf16 tables and activations) at atol 2e-4, the bound
    tests/test_pallas_pipeline.py:25-30 pins that pipeline to."""
    _, params = _params("reference")
    x = _x(3)
    want = np.asarray(pp.resfft_generator_nchw(params, x, num_layers=L,
                                               interpret=True))
    got = _port(params).generate(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("init", INITS)
def test_kernel_pipeline_wiring_matches_module(init):
    """The kernel path's weight prep (deconv flip, mix layout) and block
    wiring (pre/skip/post of the 2L+1 block calls) run on CPU tensors
    through block_fused's plain version: equal to the plain module within
    1e-5 relative (fp32, the same ops in another grouping)."""
    _, params = _params(init)
    model = _port(params)
    x = torch.tensor(_x(4))
    before = cuda_pipeline.block_fused.launches
    got = cuda_pipeline.resfft_generator_nchw(model.generator.state_dict(), x, L)
    assert cuda_pipeline.block_fused.launches == before  # CPU: no kernel
    want = model.generate(x)
    assert got.shape == want.shape == (N, S, S, 1)
    assert _rel(got.numpy(), want.numpy()) < 1e-5


def test_model_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MTDGANModel(gen_features=C, num_layers=L)


def test_generate_rejects_input_on_another_device():
    model = MTDGANModel(gen_features=C, num_layers=L, device="cpu")
    with pytest.raises(ValueError, match="input on meta"):
        model.generate(torch.empty((1, S, S, 1), device="meta"))


def test_seeded_init_is_reproducible():
    a = MTDGANModel(gen_features=C, num_layers=L, device="cpu", seed=7)
    b = MTDGANModel(gen_features=C, num_layers=L, device="cpu", seed=7)
    for (k, va), vb in zip(a.generator.state_dict().items(),
                           b.generator.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)
    w = a.generator.state_dict()["enforce.0.fft_conv.weight"]
    assert abs(float(w.std()) - 0.01) < 2e-3
