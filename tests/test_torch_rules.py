"""Rules of the PyTorch port: it imports nothing of JAX or the JAX package,
its entry points refuse to run without a GPU unless asked for the CPU, and
``chip_smoke.py`` fails without a GPU or without the repository."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mtd_gan_tpu_torch import resolve_device

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "PIL", "pandas",
             "mtd_gan_tpu")

_IMPORT_ALL = f"""
import importlib, pkgutil, sys
import mtd_gan_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mtd_gan_tpu_torch.__path__,
                                               "mtd_gan_tpu_torch.")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {FORBIDDEN!r})
print(len(names), bad)
assert not bad, bad
"""


def _env():
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def test_port_imports_nothing_of_jax_or_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 15, proc.stdout


def test_resolve_device(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported"):
        resolve_device("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")


def test_cli_defaults_to_cuda_and_raises_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the exit without a GPU")
    proc = subprocess.run(
        [sys.executable, "-m", "mtd_gan_tpu_torch.test", "--resume",
         str(tmp_path / "missing.pth"), "--no-feature-metrics"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu_or_repo(tmp_path, alone):
    """Without a GPU, or run from a directory holding chip_smoke.py and
    nothing else of the repository, it exits non-zero and prints no result
    line."""
    if not alone and torch.cuda.is_available():
        pytest.skip("checks the exit without a GPU")
    cwd = REPO
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
