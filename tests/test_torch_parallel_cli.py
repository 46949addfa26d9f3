"""``python -m mtd_gan_tpu_torch.train --multi-gpu-mode DataParallel`` and
``TensorParallel`` on 2 gloo ranks against the single-rank run, each on
the plain generator (``--g-forward einsum``; TensorParallel splits it and
takes no other route): one epoch of the flagship (8 features, one layer,
PCGrad, dropout on) on a tiny synthetic set, one step of 2 slices x 8
crops; every rank cuts the global batch's crops and keeps its rows
(DataParallel) or the whole batch (TensorParallel). Every rank validates
and rank 0 alone writes: its checkpoint and its log line match the
single-rank run's within 1e-5. A third DataParallel run validates for
longer than the process group's timeout on every rank, and ends as the
first does. The runs share one spawn of the ranks, while the single-rank
run runs here."""

import json

import numpy as np
import pytest
import torch

from mtd_gan_tpu_torch.models import get_model
from mtd_gan_tpu_torch.utils.checkpoint import networks
from test_torch_parallel_helpers import (run_ranks, train_argv, train_cli, train_clis,
                                         write_dataset)

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

MODES = {"DataParallel": ["--g-forward", "einsum"], "TensorParallel": []}
# the ranks' process group times out after TIMEOUT s; the third run's
# validation takes SLOW s more on every rank (a rank that waited on
# another's validation would time out)
TIMEOUT, SLOW = 15.0, 18.0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The root of the runs, the single-rank run's stats and the ranks'
    stats by mode (rank 0's and rank 1's)."""
    root = tmp_path_factory.mktemp("cli")
    write_dataset(root / "data", {"train": 2, "valid": 1})
    runs = [(train_argv(root / "data", root / mode, *route, "--multi-gpu-mode", mode), 0.0)
            for mode, route in MODES.items()]
    runs.append((train_argv(root / "data", root / "slow", *MODES["DataParallel"],
                            "--multi-gpu-mode", "DataParallel"), SLOW))
    ranks, single = run_ranks(
        train_clis, 2, root / "ranks", runs, timeout=TIMEOUT,
        meanwhile=lambda: train_cli(train_argv(root / "data", root / "single",
                                               "--g-forward", "einsum")))
    return root, single, {mode: [r[i] for r in ranks]
                          for i, mode in enumerate([*MODES, "slow"])}


@pytest.mark.parametrize("mode", list(MODES))
def test_two_rank_epoch_matches_the_single_rank_epoch(runs, mode):
    root, want_stats, by_mode = runs
    ranks, out = by_mode[mode], root / mode
    for key in ("train_d_loss", "train_g_loss", "valid_loss"):
        np.testing.assert_allclose(ranks[0][key], want_stats[key], rtol=1e-5, err_msg=key)
    # every rank averaged the same global metrics and validated the same model
    for key in ("train_g_loss", "valid_loss"):
        np.testing.assert_allclose(ranks[1][key], want_stats[key], rtol=1e-5, err_msg=key)
    _hold_checkpoint(root, out)
    logs = (out / "ckpt" / "log.txt").read_text().splitlines()
    assert len(logs) == 1 and json.loads(logs[0])["epoch"] == 0
    assert len(list((out / "ckpt" / "args").iterdir())) == 1


def test_validation_past_the_group_timeout_keeps_the_ranks_in_step(runs):
    """Each rank validates for SLOW s, past the group's TIMEOUT s: no rank
    waits on another's validation, so the run ends on both ranks with the
    DataParallel run's results."""
    root, want_stats, by_mode = runs
    for rank in by_mode["slow"]:
        for key in ("train_g_loss", "valid_loss"):
            np.testing.assert_allclose(rank[key], want_stats[key], rtol=1e-5, err_msg=key)
    _hold_checkpoint(root, root / "slow")


def _hold_checkpoint(root, out):
    """The run's checkpoint matches the single-rank run's (1e-5), and the
    epoch moved the parameters."""
    want = torch.load(root / "single" / "ckpt" / "epoch_0.pth", weights_only=False)
    got = torch.load(out / "ckpt" / "epoch_0.pth", weights_only=False)
    assert got["model_state_dict"].keys() == want["model_state_dict"].keys()
    # the parameters the run started from (the CLI's default seed)
    start = get_model("MTD_GAN_Method", gen_features=8, disc_features=8, num_layers=1,
                      device="cpu", seed=2024)
    first = {p + k: v for p, m in networks(start).items() for k, v in m.state_dict().items()}
    moved = 0.0
    for k, v in want["model_state_dict"].items():
        np.testing.assert_allclose(got["model_state_dict"][k].numpy(), v.numpy(), atol=1e-5,
                                   err_msg=k)
        moved = max(moved, float((v - first[k]).abs().max()))
    assert moved > 1e-4  # the epoch stepped the parameters
