#!/usr/bin/env python3
"""Split the port's spectral column pass (K5, and K8's pass B) by phase on
an NVIDIA GPU, and K8 by launch.

    python3 tools/torch_column_split.py [CHECKOUT]

CHECKOUT is a checkout of this repository (default: the one holding this
script). The script copies the checkout's ``mtd_gan_tpu_torch/csrc`` into a
temporary directory, adds ``clock64`` stamps between the phases of the
column kernel (thread 0 of each CTA, after a block-wide sync), builds the
copy with the package's own nvcc flags and runs it through its C entry
``staged_mix_h`` at C = 32: 1024x1024 batch 2, 800x800 batch 2, 200x200
batch 8, 448x448 batch 8 and 449x130 batch 2. It prints, per shape, the
kernel's time (CUDA events, stamps on), the mean lifetime of a CTA in SM
clocks and each phase's share of it, and checks the stamped kernel
against the plain version. Two kernel sources are known:

  * ``csrc/columns_mixed.cuh`` (``columns_mixed_kernel``): load, forward
    DIF steps, forward odd step (with the cluster sync), mix, transposed
    odd step, DIT steps, store;
  * the cluster kernel ``staged_mix_kernel`` of ``csrc/spectral_staged.cu``
    that the column pass replaced (commit 91d3a81): twiddles (sincospi),
    load, forward FFT, cluster wait, mix (distributed shared memory reads),
    inverse FFT + store, exit wait.

Then K8 (the checkout's ``spectral_branch_tiled``) at 448x448, batch 8,
C = 32, with the residual: its time and its device time per kernel under
torch.profiler. The card's name and power limit come first.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

C = 32
SHAPES = ((2, 1024, 1024), (2, 800, 800), (8, 200, 200), (8, 448, 448), (2, 449, 130))
STAMP = ("  auto stamp = [&](int i) {\n    __syncthreads();\n"
         "    if (threadIdx.x == 0) g_stamps[8 * ((size_t)(blockIdx.z * gridDim.y + "
         "blockIdx.y) * gridDim.x + blockIdx.x) + i] = clock64();\n  };\n  stamp(0);\n")
SET_STAMPS = ('extern "C" {\n\nint set_stamps(void* p) {\n'
              '  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n}\n')


def replace(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"torch_column_split: the kernel source has no {old!r}")
    return text.replace(old, new)


def stamp_columns_mixed(csrc: str):
    """Stamps in columns_mixed_kernel; returns the phase names."""
    path = os.path.join(csrc, "columns_mixed.cuh")
    s = open(path).read()
    s = replace(s, "namespace cg = cooperative_groups;\n",
                "namespace cg = cooperative_groups;\n\n__device__ long long* g_stamps;\n")
    s = replace(s, "  const auto dec = [&](int h) { return Q == 1 ? h : decimated(h, P, Q); };\n",
                "  const auto dec = [&](int h) { return Q == 1 ? h : decimated(h, P, Q); };\n"
                + STAMP)
    s = replace(s, "  __syncthreads();\n\n  // forward: the P-point DIF steps, then the odd step\n"
                "  column_steps<false>(data, pitch, CL, pl, tw);\n",
                "  stamp(1);\n\n  column_steps<false>(data, pitch, CL, pl, tw);\n  stamp(2);\n")
    sync = ("  if constexpr (S > 1) {\n    cg::this_cluster().sync();\n  } else {\n"
            "    __syncthreads();\n  }\n")
    s = replace(s, sync + "\n  // the mix of", sync + "  stamp(3);\n\n  // the mix of")
    s = replace(s, sync + "\n  // inverse:", sync + "  stamp(4);\n\n  // inverse:")
    s = replace(s, "  column_steps<true>(data, pitch, CL, pl, tw);\n",
                "  stamp(5);\n  column_steps<true>(data, pitch, CL, pl, tw);\n  stamp(6);\n")
    s = replace(s, "      col[c * cstride + h] = make_float2(a.x * scale, -a.y * scale);\n"
                "    }\n  }\n}", "      col[c * cstride + h] = make_float2(a.x * scale, "
                "-a.y * scale);\n    }\n  }\n  stamp(7);\n}")
    open(path, "w").write(s)
    return ("load", "forward DIF steps", "forward odd step + sync", "mix",
            "transposed odd step", "DIT steps", "store")


def stamp_cluster_kernel(csrc: str):
    """Stamps in the cluster kernel staged_mix_kernel; returns the phase
    names."""
    path = os.path.join(csrc, "spectral_staged.cu")
    s = open(path).read()
    s = replace(s, "namespace cg = cooperative_groups;\n",
                "namespace cg = cooperative_groups;\n\n__device__ long long* g_stamps;\n")
    s = replace(s, "  const int k = blockIdx.y, n = blockIdx.z;\n\n  extern __shared__",
                "  const int k = blockIdx.y, n = blockIdx.z;\n" + STAMP
                + "\n  extern __shared__")
    s = replace(s, "  make_twiddles(twp, P);\n\n  float2* col",
                "  make_twiddles(twp, P);\n  stamp(1);\n\n  float2* col")
    s = replace(s, "  __syncthreads();\n  if (log_p > 0) fft_radix2(work, CL * Q, P, log_p, twp, "
                "false);", "  stamp(2);\n  if (log_p > 0) fft_radix2(work, CL * Q, P, log_p, "
                "twp, false);")
    s = replace(s, "  // every CTA of the cluster has its forward result in place\n"
                "  cluster.sync();", "  stamp(3);\n  cluster.sync();\n  stamp(4);")
    s = replace(s, "  __syncthreads();\n  if (log_p > 0) fft_radix2(work, CL * Q, P, log_p, twp, "
                "true);", "  stamp(5);\n  if (log_p > 0) fft_radix2(work, CL * Q, P, log_p, "
                "twp, true);")
    s = replace(s, "  // no CTA leaves while a partner may still read its `nat`\n"
                "  cluster.sync();\n}", "  stamp(6);\n  cluster.sync();\n  stamp(7);\n}")
    open(path, "w").write(s)
    return ("twiddles (sincospi)", "load", "forward FFT", "cluster wait", "mix (DSMEM)",
            "inverse FFT + store", "exit wait")


def cuda_ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def inputs(n, h, w):
    rng = np.random.default_rng(0)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda").contiguous()
    return dict(x=t(rng.random((n, C, h, w))),
                mix=t(rng.standard_normal((2 * C, 2 * C)) / np.sqrt(2 * C)),
                bias=t(rng.standard_normal(2 * C) * 0.1),
                residual=t(rng.standard_normal((n, C, h, w)) * 0.5))


def main():
    checkout = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                               else os.path.join(os.path.dirname(__file__), ".."))
    if not torch.cuda.is_available():
        raise SystemExit("torch_column_split: needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, checkout)
    from mtd_gan_tpu_torch.ops import _build
    from mtd_gan_tpu_torch.ops.cuda_fftconv import spectral_branch_tiled
    from mtd_gan_tpu_torch.ops.cuda_staged import rdft_w_reference, spectral_mix_h_reference

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory(prefix="column_split_") as tmp:
        csrc = os.path.join(tmp, "csrc")
        shutil.copytree(os.path.join(checkout, "mtd_gan_tpu_torch", "csrc"), csrc)
        new = os.path.exists(os.path.join(csrc, "columns_mixed.cuh"))
        phases = stamp_columns_mixed(csrc) if new else stamp_cluster_kernel(csrc)
        src = os.path.join(csrc, "spectral_staged.cu")
        text = replace(open(src).read(), 'extern "C" {\n', SET_STAMPS)
        open(src, "w").write(text)
        lib_path = os.path.join(tmp, "libstamped.so")
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib_path, src],
                              capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"torch_column_split: nvcc failed:\n{proc.stderr}")
        lib = ctypes.CDLL(lib_path)
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.staged_mix_h.argtypes = [P, I, I, I, I, P, P] + ([P] if new else []) + [P]
        lib.staged_mix_cluster_size.argtypes = [I, I]
        lib.set_stamps.argtypes = [P]
        for n, h, w in SHAPES:
            a = inputs(n, h, w)
            z = rdft_w_reference(a["x"])
            k = z.shape[2]
            s = lib.staged_mix_cluster_size(C, h)
            table = torch.tensor(np.exp(-2j * np.pi * np.arange(h) / h).astype(np.complex64),
                                 device="cuda")
            tw = [table.data_ptr()] if new else []
            stamps = torch.zeros((s * k * n, 8), dtype=torch.int64, device="cuda")
            if lib.set_stamps(stamps.data_ptr()) != 0:
                raise SystemExit("torch_column_split: set_stamps failed")
            zi = z.clone()

            def run():
                err = lib.staged_mix_h(zi.data_ptr(), n, C, h, k, a["mix"].data_ptr(),
                                       a["bias"].data_ptr(), *tw,
                                       torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise SystemExit(f"torch_column_split: CUDA error {err}")

            ms = cuda_ms(run)
            zi.copy_(z)
            run()
            want = torch.view_as_real(spectral_mix_h_reference(z, a["mix"], a["bias"]))
            rel = ((torch.view_as_real(zi) - want).abs().max() / want.abs().max()).item()
            st = stamps.double().cpu().numpy()
            d, life = np.diff(st, axis=1), st[:, 7] - st[:, 0]
            print(f"column pass {h}x{w} batch {n} C={C}: {ms:.4f} ms (stamped), cluster of {s}, "
                  f"{s * k * n} CTAs, mean CTA life {life.mean():.0f} clk, rel err {rel:.2e}; "
                  + ", ".join(f"{p} {d[:, i].mean():.0f} clk ({d[:, i].sum() / life.sum():.4f})"
                              for i, p in enumerate(phases)), flush=True)
            del a, z, zi, stamps, table

    from torch.profiler import ProfilerActivity, profile

    a = inputs(8, 448, 448)
    with torch.no_grad():
        k8 = lambda: spectral_branch_tiled(a["x"], a["mix"], a["bias"], a["residual"])
        print(f"K8 448x448 batch 8 C={C} with residual: {cuda_ms(k8):.4f} ms", flush=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                k8()
            torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").replace("void ", "")
            by[name.split("(")[0]] = by.get(name.split("(")[0], 0.0) + e.time_range.elapsed_us()
    for name, us in by.items():
        print(f"K8 448x448 batch 8 kernel {name}: {us / 5e3:.4f} ms per call", flush=True)


if __name__ == "__main__":
    main()
