"""Multi-rank train steps of the port on 2 gloo ranks against the
single-rank step on the whole batch (which tests/test_torch_trainer.py and
the family tests hold to the JAX package): the flagship's PCGrad step with
DataParallel (dropout on: its masks are the global draw's rows) and with
TensorParallel (the generator split by channels), and one DataParallel
step each of ``SupervisedTrainer`` (RED-CNN), ``AdversarialTrainer``
(WGAN-VGG, four critic updates with the gradient penalty's draws) and a
diffusion model (DDIM: the noise and the timesteps). Losses rtol 1e-5,
parameters rtol 2e-4 / atol 2e-6, as tests/test_tensor_parallel.py:66-72.
The ranks run once for the file, every case in one spawn, while the
single-rank steps run here."""

import pytest
import torch

from test_torch_parallel_helpers import (assert_steps_match, batches, run_ranks, run_steps,
                                         steps_on_grid)

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

# kind -> (grid, the single-rank step it is held to, patch size, global batch, steps)
CASES = {
    "mtd": ("DataParallel", "mtd", 64, 4, 2),
    "mtd_tp": ("TensorParallel", "mtd_einsum", 64, 4, 1),
    "red_cnn": ("DataParallel", "red_cnn", 32, 4, 1),
    "wgan_vgg": ("DataParallel", "wgan_vgg", 64, 4, 1),
    "ddim": ("DataParallel", "ddim", 16, 4, 1),
}


def _all_kinds(data):
    """On each rank, every case on its grid, in turn."""
    return {kind: steps_on_grid(CASES[kind][0], kind, data[kind]) for kind in CASES}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the ranks' results by rank, the single-rank steps) by case."""
    data = {kind: batches(size, n, steps, seed=i)
            for i, (kind, (_, _, size, n, steps)) in enumerate(CASES.items())}
    got, want = run_ranks(
        _all_kinds, 2, tmp_path_factory.mktemp("ranks"), data,
        meanwhile=lambda: {k: run_steps(CASES[k][1], None, data[k]) for k in CASES})
    return {kind: ([r[kind] for r in got], want[kind]) for kind in CASES}


@pytest.mark.parametrize("kind", list(CASES))
def test_two_rank_step_matches_the_single_rank_step(ranks, kind):
    got, want = ranks[kind]
    for rank_result in got:
        assert_steps_match(rank_result, want)
