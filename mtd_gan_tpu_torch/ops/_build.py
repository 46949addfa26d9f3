"""Build and load the port's native libraries.

Each ``.cu`` source under ``mtd_gan_tpu_torch/csrc/`` is compiled by
``nvcc`` for ``sm_90a`` (:func:`build`), the host decoder
``csrc/dicom_codec.cc`` by ``g++`` (:func:`build_host`), into a shared
library with a plain C interface loaded with ``ctypes``. Libraries go to
``mtd_gan_tpu_torch/_build/``, named by a hash of the source (and the
headers it may include) and the flags, and are built on first use; a failed
build raises. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-O3", "-shared", "-fPIC")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _compile(name: str, src: Path, compiler: str, flags, headers=()) -> Path:
    """``compiler flags -o lib<name>_<hash>.so src`` unless that library
    exists; the compiler's log is kept beside it as ``.log``, starting with
    the build seconds."""
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    for header in headers:
        h.update(header.read_bytes())
    lib = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([compiler, *flags, "-o", tmp, str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{os.path.basename(compiler)} failed for {src.name}:\n"
                           f"{proc.stderr}")
    lib.with_suffix(".log").write_text(
        f"build seconds: {time.perf_counter() - t0:.2f}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: concurrent builds race harmlessly
    return lib


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library for its current source
    (and the ``csrc/*.cuh`` headers it may include) is already built;
    returns the library path. The compiler's log (with the ``-Xptxas -v``
    register and shared-memory report) is kept beside it as ``.log``."""
    return _compile(name, CSRC / f"{name}.cu", _nvcc(), NVCC_FLAGS,
                    sorted(CSRC.glob("*.cuh")))


def build_host(name: str) -> Path:
    """Compile the host source ``csrc/<name>.cc`` with ``g++`` (``-O3
    -shared -fPIC``) unless built; returns the library path. Raises when
    there is no ``g++`` or the build fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native DICOM decoder needs a "
                           "host C++ compiler")
    return _compile(name, CSRC / f"{name}.cc", gxx, HOST_FLAGS)


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def block_fused_library() -> ctypes.CDLL:
    """The K1 library (``csrc/block_fused.cu``), built on first call."""
    lib = ctypes.CDLL(str(build("block_fused")))
    lib.block_fused_forward.argtypes = [
        _P, _I, _I, _I, _I, _I,      # x, n, c_in, c, h, w
        _P, _P, _P,                  # pre_w, pre_b, skip
        _P, _P, _P, _P,              # km, kb, mix, mb
        _P, _P, _I, _P,              # post_w, post_b, adjoint, img
        _P, _P,                      # twiddles of W, twiddles of H
        _P, _P, _P, _P, _P,          # hbuf, spec, out, final_out, stream
    ]
    lib.block_fused_forward.restype = ctypes.c_int
    lib.block_fused_forward_bf16.argtypes = [
        _P, _I, _I, _I, _I, _I,      # x, n, c_in, c, h, w
        _P, _P, _P,                  # pre_w, pre_b, skip
        _P, _P, _P, _P,              # km, kb, mix, mb
        _P, _P, _I, _P,              # post_w, post_b, adjoint, img
        _P, _P,                      # twiddles of W, twiddles of H
        _P, _P, _P, _P, _P, _P,      # hbuf, spec, res, out, final_out, stream
    ]
    lib.block_fused_forward_bf16.restype = ctypes.c_int
    lib.block_fused_error_string.argtypes = [ctypes.c_int]
    lib.block_fused_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def block_bwd_library() -> ctypes.CDLL:
    """The K2 library (``csrc/block_bwd.cu``), built on first call."""
    lib = ctypes.CDLL(str(build("block_bwd")))
    lib.block_bwd.argtypes = [
        _P, _P, _I, _I, _I, _I,      # x, g, n, c, h, w
        _P, _P, _P,                  # pre_w, pre_b, skip
        _P, _P, _P, _P,              # km, kb, mix, mb
        _P, _P, _P, _P, _P,          # post_w, post_b, img, gfin, twiddles
        _P, _P, _P, _P, _P,          # hbuf, rbuf, obuf, gbuf, abuf
        _P, _P, _P, _P, _I, _I,      # spec_a, spec_b, w_part, mix_part, wgrad/column blocks
        _P, _P, _P, _P, _P,          # xbar, dkm, dkb, dmix, dmb
        _P, _P, _P,                  # skipbar, dpre_w, dpre_b
        _P, _P, _P, _P,              # imgbar, dpost_w, dpost_b, stream
    ]
    lib.block_bwd.restype = ctypes.c_int
    lib.block_bwd_bf16.argtypes = [
        _P, _P, _I, _I, _I, _I,      # x, g, n, c, h, w
        _P, _P, _P,                  # pre_w, pre_b, skip
        _P, _P, _P, _P,              # km, kb, mix, mb
        _P, _P, _P, _P, _P,          # post_w, post_b, img, gfin, twiddles
        _P, _P, _P, _P, _P, _P,      # hbuf, rbuf, obuf, res, gbuf, abuf
        _P, _P, _P, _P, _I, _I,      # spec_a, spec_b, w_part, mix_part, wgrad/column blocks
        _P, _P, _P, _P, _P,          # xbar, dkm, dkb, dmix, dmb
        _P, _P, _P,                  # skipbar, dpre_w, dpre_b
        _P, _P, _P, _P,              # imgbar, dpost_w, dpost_b, stream
    ]
    lib.block_bwd_bf16.restype = ctypes.c_int
    lib.block_bwd_error_string.argtypes = [ctypes.c_int]
    lib.block_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def spectral_tiled_library() -> ctypes.CDLL:
    """The K8 library (``csrc/spectral_tiled.cu``), built on first call."""
    lib = ctypes.CDLL(str(build("spectral_tiled")))
    lib.spectral_tiled_forward.argtypes = [
        _P, _I, _I, _I, _I,          # x, n, c, h, w
        _P, _P, _P,                  # mix, mix_bias, residual
        _P, _P,                      # twiddles of W, twiddles of H
        _P, _P, _P,                  # spec, out, stream
    ]
    lib.spectral_tiled_forward.restype = ctypes.c_int
    lib.spectral_tiled_forward_bf16.argtypes = lib.spectral_tiled_forward.argtypes
    lib.spectral_tiled_forward_bf16.restype = ctypes.c_int
    lib.spectral_tiled_error_string.argtypes = [ctypes.c_int]
    lib.spectral_tiled_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def spectral_fused_library() -> ctypes.CDLL:
    """The K7 library (``csrc/spectral_fused.cu``), built on first call."""
    lib = ctypes.CDLL(str(build("spectral_fused")))
    lib.spectral_fused_scratch_floats.argtypes = [_I, _I, _I]  # c, h, w
    lib.spectral_fused_scratch_floats.restype = ctypes.c_longlong
    lib.spectral_fused_forward.argtypes = [
        _P, _I, _I, _I, _I,          # x, n, c, h, w
        _P, _P, _P,                  # mix, mix_bias, residual
        _P, _P,                      # twiddles of W, twiddles of H
        _P, _P, _P,                  # scratch, out, stream
    ]
    lib.spectral_fused_forward.restype = ctypes.c_int
    lib.spectral_fused_forward_bf16.argtypes = lib.spectral_fused_forward.argtypes
    lib.spectral_fused_forward_bf16.restype = ctypes.c_int
    lib.spectral_fused_error_string.argtypes = [ctypes.c_int]
    lib.spectral_fused_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def conv3x3_library() -> ctypes.CDLL:
    """The K3 library (``csrc/conv3x3.cu``), built on first call."""
    lib = ctypes.CDLL(str(build("conv3x3")))
    lib.conv3x3_forward.argtypes = [
        _P, _I, _I, _I, _I, _I,      # x, n, c_in, c_out, h, w
        _P, _P, _P, _P,              # weight, bias, skip, out
        _I, _I, _I, _P,              # relu, residual, adjoint, stream
    ]
    lib.conv3x3_forward.restype = ctypes.c_int
    lib.conv3x3_forward_bf16.argtypes = [
        _P, _I, _I, _I, _I, _I,      # x, n, c_in, c_out, h, w
        _P, _P, _P, _I, _P, _I,      # weight, bias, skip, skip_bf16, out, out_bf16
        _I, _I, _I, _P,              # relu, residual, adjoint, stream
    ]
    lib.conv3x3_forward_bf16.restype = ctypes.c_int
    lib.conv3x3_tensor_cores.argtypes = [_I, _I]  # c_in, c_out
    lib.conv3x3_tensor_cores.restype = ctypes.c_int
    lib.conv3x3_error_string.argtypes = [ctypes.c_int]
    lib.conv3x3_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def spectral_staged_library() -> ctypes.CDLL:
    """The K4, K5 and K6 library (``csrc/spectral_staged.cu``), built on
    first call."""
    lib = ctypes.CDLL(str(build("spectral_staged")))
    lib.staged_rdft_w.argtypes = [
        _P, _I, _I, _I, _I,          # x, n, c, h, w
        _P, _P, _P,                  # twiddles, spec, stream
    ]
    lib.staged_mix_h.argtypes = [
        _P, _I, _I, _I, _I,          # spec, n, c, h, k
        _P, _P, _P, _P,              # mix, mix_bias, twiddles, stream
    ]
    lib.staged_irdft_w_add.argtypes = [
        _P, _P, _I, _I, _I, _I,      # spec, residual, n, c, h, w
        _P, _P, _P,                  # twiddles, out, stream
    ]
    lib.staged_rdft_w_bf16.argtypes = lib.staged_rdft_w.argtypes
    lib.staged_irdft_w_add_bf16.argtypes = lib.staged_irdft_w_add.argtypes
    # the bf16-spectrum variants; an int says whether x / the residual is bf16
    lib.staged_rdft_w_bf16s.argtypes = [
        _P, _I, _I, _I, _I, _I,      # x, x_bf16, n, c, h, w
        _P, _P, _P,                  # twiddles, spec, stream
    ]
    lib.staged_mix_h_bf16s.argtypes = lib.staged_mix_h.argtypes
    lib.staged_irdft_w_add_bf16s.argtypes = [
        _P, _P, _I, _I, _I, _I, _I,  # spec, residual, res_bf16, n, c, h, w
        _P, _P, _P,                  # twiddles, out, stream
    ]
    lib.staged_mix_cluster_size.argtypes = [_I, _I]  # c, h
    lib.staged_mix_odd_branch.argtypes = [_I]  # h
    for fn in (lib.staged_rdft_w, lib.staged_mix_h, lib.staged_irdft_w_add,
               lib.staged_rdft_w_bf16, lib.staged_irdft_w_add_bf16,
               lib.staged_rdft_w_bf16s, lib.staged_mix_h_bf16s, lib.staged_irdft_w_add_bf16s,
               lib.staged_mix_cluster_size, lib.staged_mix_odd_branch):
        fn.restype = ctypes.c_int
    lib.spectral_staged_error_string.argtypes = [ctypes.c_int]
    lib.spectral_staged_error_string.restype = ctypes.c_char_p
    return lib
