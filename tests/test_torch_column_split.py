"""tools/torch_column_split.py instruments the column kernels by text: its
anchors must still be found in the port's kernel sources, or the split
stops on the card. Here on the CPU: the stamps it adds to
``csrc/columns_mixed.cuh`` and the stamp pointer's setter it adds to
``csrc/spectral_staged.cu``. No JAX, no GPU."""

import importlib.util
import os
import shutil

import torch

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_column_split", os.path.join(ROOT, "tools", "torch_column_split.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_column_split_stamps_every_phase(tmp_path):
    tool = _tool()
    csrc = tmp_path / "csrc"
    shutil.copytree(os.path.join(ROOT, "mtd_gan_tpu_torch", "csrc"), csrc)
    phases = tool.stamp_columns_mixed(str(csrc))
    text = (csrc / "columns_mixed.cuh").read_text()
    assert [text.count(f"stamp({i});") for i in range(len(phases) + 1)] == [1] * 8
    staged = (csrc / "spectral_staged.cu").read_text()
    staged = tool.replace(staged, 'extern "C" {\n', tool.SET_STAMPS)
    assert staged.count("int set_stamps(void* p)") == 1
