"""ctypes bridge to the port's native DICOM decoder
(``mtd_gan_tpu_torch/csrc/dicom_codec.cc``; counterpart of
``mtd_gan_tpu/data/native.py``).

The library is built with ``g++`` on first use into
``mtd_gan_tpu_torch/_build/`` (``ops/_build.py::build_host``). A ctypes
call releases the GIL, so the loader's threads decode in parallel. Where no
compiler exists, or the build fails, :func:`library` is ``None`` and
:func:`decode_hu` returns ``None``: the caller decodes in Python, as the JAX
package does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np

from mtd_gan_tpu_torch.ops import _build

MAX_PIXELS = 4096 * 4096


@functools.cache
def library() -> Optional[ctypes.CDLL]:
    """The decoder library, built on the first call; ``None`` without one."""
    try:
        lib = ctypes.CDLL(str(_build.build_host("dicom_codec")))
    except (RuntimeError, OSError):
        return None
    lib.dicom_decode_hu.restype = ctypes.c_int
    lib.dicom_decode_hu.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int16), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    return lib


def decode_hu(path: str) -> Optional[np.ndarray]:
    """A DICOM file as int16 HU ``(rows, cols)`` through the native codec;
    ``None`` without the library or when the codec refuses the file (an
    unsupported transfer syntax, no 16-bit PixelData)."""
    lib = library()
    if lib is None:
        return None
    with open(path, "rb") as f:
        buf = f.read()
    # the pixels lie inside the file: len(buf) / 2 int16 always suffice
    out = np.empty(min(MAX_PIXELS, max(len(buf) // 2, 1)), np.int16)
    rows, cols = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.dicom_decode_hu(
        buf, len(buf), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        out.size, ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        return None
    return out[:rows.value * cols.value].reshape(rows.value, cols.value)
