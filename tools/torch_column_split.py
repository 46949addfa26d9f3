#!/usr/bin/env python3
"""Split the port's spectral column pass (K5, and K8's pass B) by phase on
an NVIDIA GPU, and K8 by launch; with ``--k7``, split the per-sample fused
spectral branch K7 by phase instead.

    python3 tools/torch_column_split.py [CHECKOUT]
    python3 tools/torch_column_split.py --k7 [CHECKOUT]

CHECKOUT is a checkout of this repository (default: the one holding this
script). The script copies the checkout's ``mtd_gan_tpu_torch/csrc`` into a
temporary directory, adds ``clock64`` stamps between the phases of the
column kernel (thread 0 of each CTA, after a block-wide sync), builds the
copy with the package's own nvcc flags and runs it through its C entry
``staged_mix_h`` at C = 32: 1024x1024 batch 2, 800x800 batch 2, 200x200
batch 8, 448x448 batch 8 and 449x130 batch 2. It prints, per shape, the
kernel's time (CUDA events, stamps on), the mean lifetime of a CTA in SM
clocks and each phase's share of it, and checks the stamped kernel
against the plain version. The phases of ``csrc/columns_mixed.cuh``'s
``columns_mixed_kernel`` and the device functions it calls: load, forward
DIF steps, forward odd step (with the cluster sync), mix, transposed odd
step, DIT steps, store.

Then K8 (the checkout's ``spectral_branch_tiled``) at 448x448, batch 8,
C = 32, with the residual: its time and its device time per kernel under
torch.profiler. The card's name and power limit come first.

``--k7`` stamps ``csrc/spectral_fused.cu`` the same way (thread 0 of each
CTA, after a block-wide sync, into slots in shared memory; a phase that
repeats, such as one batch of rows, adds up) and runs it through its C
entry ``spectral_fused_forward`` at 96x96 (C = 32), 100x72 (C = 32),
128x128 (C = 32, the spectrum in the device-memory scratch) and 33x27
(C = 8), batch 64 each, printing the kernel's time with the stamps on,
each phase's mean clocks per CTA and its share of the CTAs' summed
lifetime, and the error against the plain version. The phases, with the
residual: start wait, rows (load, steps, read-out), row wait, reorder in,
column FFT, mix, column inverse (a CTA's owned bins together), reorder
out, column wait, inverse rows (gather, steps, store), exit wait.

Then, at 96x96, batch 64, C = 32, the checkout's own wrappers (no stamps),
in turns: K7 with the residual and the staged branch
``irdft_w_add(spectral_mix_h(rdft_w(x)), res)`` (K4 -> K5 -> K6).

Both stampers follow the kernel sources of this checkout; to split an
older kernel, run the tool as it stood in that kernel's commit.
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
# the column pass: thread 0 of each CTA writes the clock of stamp i; at
# file scope, so that the kernel and the device functions it calls both
# reach it
STAMP_FN = ("__device__ long long* g_stamps;\n\n"
            "__device__ __forceinline__ void stamp(int i) {\n  __syncthreads();\n"
            "  if (threadIdx.x == 0)\n    g_stamps[8 * (((size_t)blockIdx.z * gridDim.y + "
            "blockIdx.y) * gridDim.x + blockIdx.x) + i] = clock64();\n}\n")
SET_STAMPS = ('extern "C" {\n\nint set_stamps(void* p) {\n'
              '  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n}\n')


def replace(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"torch_column_split: the kernel source has no {old!r}")
    return text.replace(old, new)


def replace_once(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"torch_column_split: the kernel source has {text.count(old)} "
                         f"of {old!r}, not one")
    return text.replace(old, new)


def stamp_columns_mixed(csrc: str):
    """Stamps in columns_mixed_kernel and its columns_forward and
    columns_inverse; returns the phase names."""
    path = os.path.join(csrc, "columns_mixed.cuh")
    s = open(path).read()
    s = replace_once(s, "namespace cg = cooperative_groups;\n",
                     "namespace cg = cooperative_groups;\n\n" + STAMP_FN)
    s = replace_once(s, "  const auto dec = [&](int h) { return Q == 1 ? h : decimated(h, P, Q); };\n",
                     "  const auto dec = [&](int h) { return Q == 1 ? h : decimated(h, P, Q); };\n"
                     "  stamp(0);\n")
    s = replace_once(s, "  __syncthreads();\n\n  columns_forward<CL, TWO>(",
                     "  stamp(1);\n\n  columns_forward<CL, TWO>(")
    s = replace_once(s, "  column_steps<false>(data, pitch, rows, pl, tw);\n",
                     "  column_steps<false>(data, pitch, rows, pl, tw);\n  stamp(2);\n")
    sync = ("  if constexpr (S > 1) {\n    cg::this_cluster().sync();\n  } else {\n"
            "    __syncthreads();\n  }\n")
    s = replace_once(s, sync + "\n  // the mix of", sync + "  stamp(3);\n\n  // the mix of")
    s = replace_once(s, "reads them\n" + sync, "reads them\n" + sync + "  stamp(4);\n")
    s = replace_once(s, "  column_steps<true>(data, pitch, rows, pl, tw);\n",
                     "  stamp(5);\n  column_steps<true>(data, pitch, rows, pl, tw);\n"
                     "  stamp(6);\n")
    s = replace_once(s, "      col[c * cstride + h] = make_float2(a.x * scale, -a.y * scale);\n"
                     "    }\n  }\n}", "      col[c * cstride + h] = make_float2(a.x * scale, "
                     "-a.y * scale);\n    }\n  }\n  stamp(7);\n}")
    open(path, "w").write(s)
    return ("load", "forward DIF steps", "forward odd step + sync", "mix",
            "transposed odd step", "DIT steps", "store")


# K7: thread 0 of each CTA adds the clocks since its previous stamp to the
# phase's slot, so a phase that repeats adds up. The slots live in the
# CTA's shared memory (slot 15: the clock of the previous stamp) and go to
# device memory once, at the end; the kernel's planner is left 256 bytes
# for them. The stamp functions are at file scope, so that the kernel and
# the device functions it calls both reach them
K7_SLOTS = 16
K7_STAMP_FN = ("__device__ long long* g_stamps;\n\n"
               "__device__ __forceinline__ long long* stamp_slots() {\n"
               f"  __shared__ long long slots[{K7_SLOTS}];\n  return slots;\n}}\n\n"
               "__device__ __forceinline__ void stamp_begin() {\n"
               f"  if (threadIdx.x < {K7_SLOTS})\n"
               f"    stamp_slots()[threadIdx.x] = threadIdx.x == {K7_SLOTS - 1} ? clock64() : 0;\n"
               "}\n\n"
               "__device__ __forceinline__ void stamp(int i) {\n  __syncthreads();\n"
               "  if (threadIdx.x == 0) {\n    long long* s = stamp_slots();\n"
               "    const long long t = clock64();\n"
               f"    s[i] += t - s[{K7_SLOTS - 1}];\n    s[{K7_SLOTS - 1}] = t;\n  }}\n}}\n\n"
               "__device__ __forceinline__ void stamp_end() {\n  __syncthreads();\n"
               f"  if (threadIdx.x < {K7_SLOTS})\n"
               f"    g_stamps[{K7_SLOTS} * ((size_t)blockIdx.y * gridDim.x + blockIdx.x) + "
               "threadIdx.x] =\n        stamp_slots()[threadIdx.x];\n}\n\n")
K7_STAMP = "  stamp_begin();\n"


def stamp_k7(text: str):
    """Stamps in K7 on rdft_rows.cuh's and columns_mixed.cuh's steps;
    returns (source, phase names). "reorder in" moves a group of bins into
    the column pass's decimated order (from the scratch where the bins are
    not resident), "reorder out" back."""
    s = replace_once(text, "namespace {\n", K7_STAMP_FN + "namespace {\n")
    s = replace_once(s, "  const size_t bin_elems = (size_t)C * ph;\n",
                     "  const size_t bin_elems = (size_t)C * ph;\n" + K7_STAMP)
    s = replace_once(s, "its shared memory may be written\n  cluster.sync();\n",
                     "its shared memory may be written\n  cluster.sync();\n  stamp(0);\n")
    steps = "    rdft_steps(rows, pw, nb, rp, 0, tw_w);\n"
    s = replace_once(s, "    __syncthreads();\n" + steps + "    for (int u",
                     "    stamp(1);\n" + steps + "    stamp(2);\n    for (int u")
    s = replace_once(s, "      d[slot(r + 1)] = b;\n    }\n    __syncthreads();\n  }\n",
                     "      d[slot(r + 1)] = b;\n    }\n    stamp(3);\n  }\n")
    s = replace_once(s, "  __threadfence();\n  cluster.sync();\n\n  // ---- 2. columns",
                     "  __threadfence();\n  cluster.sync();\n  stamp(4);\n\n  // ---- 2. columns")
    s = replace_once(s, "    columns_group<C, TWO>(cols, nbin,",
                     "    stamp(5);\n    columns_group<C, TWO>(cols, nbin,")
    s = replace_once(s, "    mix_positions<C>(", "    stamp(6);\n    mix_positions<C>(")
    inverse = "    columns_inverse<C, TWO>(d, mixed, ph, bins * C, H, pl, tw, stw);\n"
    s = replace_once(s, inverse, "    stamp(7);\n" + inverse + "    stamp(8);\n")
    s = replace_once(s, "  __threadfence();\n  cluster.sync();\n\n  // ---- 3. inverse rows",
                     "  stamp(9);\n  __threadfence();\n  cluster.sync();\n  stamp(10);\n\n"
                     "  // ---- 3. inverse rows")
    s = replace_once(s, "    __syncthreads();\n" + steps + "    // a warp's outputs",
                     "    stamp(11);\n" + steps + "    stamp(12);\n    // a warp's outputs")
    s = replace_once(s, "    __syncthreads();\n  }\n  // no CTA leaves while another may still read "
                     "its shared memory\n  cluster.sync();\n}",
                     "    stamp(13);\n  }\n  cluster.sync();\n  stamp(14);\n  stamp_end();\n}")
    optin = "plan_fused(c, h, w, shared_optin(),"
    if s.count(optin) != 2:
        raise SystemExit(f"torch_column_split: the kernel source has {s.count(optin)} "
                         f"of {optin!r}, not two")
    s = s.replace(optin, "plan_fused(c, h, w, shared_optin() - 256,")
    return s, ("start wait", "rows: load", "rows: steps", "rows: read-out", "row wait",
               "reorder in", "column FFT", "mix", "column inverse", "reorder out",
               "column wait", "inverse rows: gather", "inverse rows: steps",
               "inverse rows: store", "exit wait")


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


def column_main(checkout: str):
    from mtd_gan_tpu_torch.ops import _build
    from mtd_gan_tpu_torch.ops.cuda_fftconv import spectral_branch_tiled
    from mtd_gan_tpu_torch.ops.cuda_staged import rdft_w_reference, spectral_mix_h_reference

    with tempfile.TemporaryDirectory(prefix="column_split_") as tmp:
        csrc = os.path.join(tmp, "csrc")
        shutil.copytree(os.path.join(checkout, "mtd_gan_tpu_torch", "csrc"), csrc)
        phases = stamp_columns_mixed(csrc)
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
        lib.staged_mix_h.argtypes = [P, I, I, I, I, P, P, P, P]
        lib.staged_mix_cluster_size.argtypes = [I, I]
        lib.set_stamps.argtypes = [P]
        for n, h, w in SHAPES:
            a = inputs(n, h, w)
            z = rdft_w_reference(a["x"])
            k = z.shape[2]
            s = lib.staged_mix_cluster_size(C, h)
            table = torch.tensor(np.exp(-2j * np.pi * np.arange(h) / h).astype(np.complex64),
                                 device="cuda")
            stamps = torch.zeros((s * k * n, 8), dtype=torch.int64, device="cuda")
            if lib.set_stamps(stamps.data_ptr()) != 0:
                raise SystemExit("torch_column_split: set_stamps failed")
            zi = z.clone()

            def run():
                err = lib.staged_mix_h(zi.data_ptr(), n, C, h, k, a["mix"].data_ptr(),
                                       a["bias"].data_ptr(), table.data_ptr(),
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


# (n, c, h, w) of the K7 split
K7_SHAPES = ((64, 32, 96, 96), (64, 32, 100, 72), (64, 32, 128, 128), (64, 8, 33, 27))


def k7_inputs(n, c, h, w, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda").contiguous()
    return dict(x=t(rng.random((n, c, h, w))),
                mix=t(rng.standard_normal((2 * c, 2 * c)) / np.sqrt(2 * c)),
                bias=t(rng.standard_normal(2 * c) * 0.1),
                residual=t(rng.standard_normal((n, c, h, w)) * 0.5))


def k7_main(checkout: str):
    from mtd_gan_tpu_torch.ops import _build
    from mtd_gan_tpu_torch.ops import cuda_fftconv
    from mtd_gan_tpu_torch.ops.cuda_pipeline import _device_twiddles
    from mtd_gan_tpu_torch.ops.cuda_staged import irdft_w_add, rdft_w, spectral_mix_h

    fused = cuda_fftconv.spectral_branch_fused
    reference = cuda_fftconv.spectral_branch_fused_reference
    with tempfile.TemporaryDirectory(prefix="k7_split_") as tmp:
        csrc = os.path.join(tmp, "csrc")
        shutil.copytree(os.path.join(checkout, "mtd_gan_tpu_torch", "csrc"), csrc)
        src = os.path.join(csrc, "spectral_fused.cu")
        text, phases = stamp_k7(open(src).read())
        open(src, "w").write(replace(text, 'extern "C" {\n', SET_STAMPS))
        lib_path = os.path.join(tmp, "libk7stamped.so")
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib_path, src],
                              capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"torch_column_split: nvcc failed:\n{proc.stderr}")
        lib = ctypes.CDLL(lib_path)
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.spectral_fused_forward.argtypes = [P, I, I, I, I, P, P, P, P, P, P, P, P]
        lib.spectral_fused_scratch_floats.argtypes = [I, I, I]
        lib.spectral_fused_scratch_floats.restype = ctypes.c_longlong
        lib.set_stamps.argtypes = [P]
        for n, c, h, w in K7_SHAPES:
            a = k7_inputs(n, c, h, w)
            res = a["residual"]
            floats = lib.spectral_fused_scratch_floats(c, h, w)
            scratch = torch.empty(max(1, n * floats), device="cuda")
            out = torch.empty_like(a["x"])
            stamps = torch.zeros((8 * n, K7_SLOTS), dtype=torch.int64, device="cuda")
            if lib.set_stamps(stamps.data_ptr()) != 0:
                raise SystemExit("torch_column_split: set_stamps failed")
            stream = torch.cuda.current_stream().cuda_stream
            args = [a["x"].data_ptr(), n, c, h, w, a["mix"].data_ptr(), a["bias"].data_ptr(),
                    res.data_ptr(), _device_twiddles(w, out.device).data_ptr(),
                    _device_twiddles(h, out.device).data_ptr(),
                    scratch.data_ptr() if floats > 0 else None, out.data_ptr(), stream]

            def run():
                err = lib.spectral_fused_forward(*args)
                if err != 0:
                    raise SystemExit(f"torch_column_split: CUDA error {err}")

            ms = cuda_ms(run)
            stamps.zero_()
            run()
            want = reference(a["x"], a["mix"], a["bias"], res)
            rel = ((out - want).abs().max() / want.abs().max()).item()
            st = stamps.double().cpu().numpy()[:, :len(phases)]  # slot 15: a clock
            life = st.sum(axis=1)
            mode = "scratch" if floats > 0 else "resident"
            print(f"K7 {h}x{w} batch {n} C={c}: {ms:.4f} ms (stamped), {mode}, "
                  f"{8 * n} CTAs, mean CTA life {life.mean():.0f} clk, rel err {rel:.2e}; "
                  + ", ".join(f"{p} {st[:, i].mean():.0f} clk ({st[:, i].sum() / life.sum():.4f})"
                              for i, p in enumerate(phases)), flush=True)
            del a, scratch, out, stamps

    # the checkout's own wrappers, no stamps: K7 with the residual against
    # the staged branch K4 -> K5 -> K6 on the same inputs, in turns
    a = k7_inputs(64, 32, 96, 96, seed=4)
    x, mix, bias, res = a["x"], a["mix"], a["bias"], a["residual"]
    with torch.no_grad():
        k7 = lambda: fused(x, mix, bias, residual=res)
        staged = lambda: irdft_w_add(spectral_mix_h(rdft_w(x), mix, bias), res)
        diff = (k7() - staged()).abs().max().item()
        turns = [cuda_ms(f) for f in (k7, staged, staged, k7)]
    print(f"96x96 batch 64 C=32: K7(x, residual=res) {turns[0]:.4f} / {turns[3]:.4f} ms, staged "
          f"K4 -> K5 -> K6 with the residual {turns[1]:.4f} / {turns[2]:.4f} ms "
          f"(K7, staged, staged, K7); outputs differ by {diff:.3e} max abs", flush=True)


def main():
    args = sys.argv[1:]
    k7 = "--k7" in args
    args = [a for a in args if a != "--k7"]
    checkout = os.path.abspath(args[0] if args
                               else os.path.join(os.path.dirname(__file__), ".."))
    if not torch.cuda.is_available():
        raise SystemExit("torch_column_split: needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, checkout)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    if k7:
        k7_main(checkout)
    else:
        column_main(checkout)


if __name__ == "__main__":
    main()
