"""tools/torch_column_split.py instruments the column kernels and K7 by
text: its anchors must still be found in the port's kernel sources, or the
split stops on the card. Here on the CPU: the stamps it adds to
``csrc/columns_mixed.cuh`` and to ``csrc/spectral_fused.cu`` (``--k7``),
and the stamp pointer's setter it adds to their C interfaces. No JAX, no
GPU."""

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


def test_k7_split_stamps_every_phase():
    """``--k7``: every phase stamp of K7 (csrc/spectral_fused.cu) finds its
    anchor once, the stamps' slots fit the tool's 16, and the kernel's
    planner is left room for them; the stamp pointer's setter goes into the
    C interface."""
    tool = _tool()
    with open(os.path.join(ROOT, "mtd_gan_tpu_torch", "csrc", "spectral_fused.cu")) as f:
        text = f.read()
    stamped, phases = tool.stamp_k7(text)
    assert len(phases) < tool.K7_SLOTS
    assert [stamped.count(f"stamp({i});") for i in range(len(phases))] == [1] * len(phases)
    assert stamped.count("stamp_begin();") == 1 and stamped.count("stamp_end();") == 1
    assert stamped.count("shared_optin() - 256,") == 2
    stamped = tool.replace(stamped, 'extern "C" {\n', tool.SET_STAMPS)
    assert stamped.count("int set_stamps(void* p)") == 1


def test_k1_columns_calls_the_headers_launchers():
    """K1 (``csrc/block_fused.cu``) and K2's recompute of K1's forward
    (``csrc/block_bwd.cu``) run the launcher of ``columns_mixed.cuh``,
    whose kernel this tool splits, with the arguments its header declares:
    the spectrum (n, c, W/2 + 1, H) on the table of H points. No second
    forward column pass is left: ``block_columns.cuh`` holds only the mix
    that every column pass applies."""
    csrc = os.path.join(ROOT, "mtd_gan_tpu_torch", "csrc")
    text = {}
    for name in ("block_columns.cuh", "columns_mixed.cuh", "block_fused.cu", "block_bwd.cu"):
        with open(os.path.join(csrc, name)) as f:
            text[name] = " ".join(f.read().split())
    assert ("cudaError_t launch_columns_mixed(TS* spec, const float* mix, "
            "const float* mix_bias, const float2* tw, int n, int c, int h, int k, "
            "cudaStream_t stream)") in text["columns_mixed.cuh"]
    assert ("launch_columns_mixed(spec2, mix, mb, reinterpret_cast<const float2*>(tw_h), "
            "n, c, h, w / 2 + 1, stream)") in text["block_fused.cu"]
    assert "launch_columns_mixed(sb, mix, mb, tw, n, c, h, w / 2 + 1, stream)" in text[
        "block_bwd.cu"]
    assert "__global__" not in text["block_columns.cuh"]
    assert "mix_output" in text["block_columns.cuh"]
