"""The port's native DICOM decoder (``csrc/dicom_codec.cc``, built here with
``g++`` into ``mtd_gan_tpu_torch/_build/``) against the port's Python codec
and the JAX package's ``data/native.decode_hu``, bit for bit, on explicit
and implicit VR little-endian files, unsigned and signed pixels, with and
without a rescale slope, the -2000 air sentinel, with and without the
Part-10 preamble; and the dataset's record of which codec decoded what."""

import os
import shutil
import struct

import numpy as np
import pytest
import torch

from mtd_gan_tpu.data import native as jax_native
from mtd_gan_tpu_torch.data import native
from mtd_gan_tpu_torch.data.dicom import (EXPLICIT_VR_LE, IMPLICIT_VR_LE, get_pixels_hu,
                                          write_synthetic_dicom)
from mtd_gan_tpu_torch.data.pipeline import PairedDicomDataset
from mtd_gan_tpu_torch.ops import _build

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the decoder falls back to the Python codec")
    out = native.library()
    assert out is not None
    return out


def _explicit(name, vr, value):
    g, e = name
    if len(value) % 2:
        value += b"\x00"
    if vr in (b"OB", b"OW", b"SQ", b"UN"):
        return struct.pack("<HH2sHI", g, e, vr, 0, len(value)) + value
    return struct.pack("<HH2sH", g, e, vr, len(value)) + value


def _implicit(name, _vr, value):
    g, e = name
    if len(value) % 2:
        value += b"\x00"
    return struct.pack("<HHI", g, e, len(value)) + value


def write_dicom(path, pixels, slope, intercept, signed, implicit, preamble=True):
    """A CT slice with the pixel module and rescale in the body, explicit or
    implicit VR little endian (the file meta group is explicit either way)."""
    el = _implicit if implicit else _explicit
    rows, cols = pixels.shape
    body = b"".join([
        el((0x0008, 0x0060), b"CS", b"CT"),
        el((0x0028, 0x0002), b"US", struct.pack("<H", 1)),
        el((0x0028, 0x0010), b"US", struct.pack("<H", rows)),
        el((0x0028, 0x0011), b"US", struct.pack("<H", cols)),
        el((0x0028, 0x0100), b"US", struct.pack("<H", 16)),
        el((0x0028, 0x0103), b"US", struct.pack("<H", int(signed))),
        el((0x0028, 0x1052), b"DS", f"{intercept:g}".encode()),
        el((0x0028, 0x1053), b"DS", f"{slope:g}".encode()),
        el((0x7FE0, 0x0010), b"OW", pixels.astype("<i2" if signed else "<u2").tobytes()),
    ])
    ts = (IMPLICIT_VR_LE if implicit else EXPLICIT_VR_LE).encode()
    meta = _explicit((0x0002, 0x0010), b"UI", ts)
    head = (b"\x00" * 128 + b"DICM"
            + _explicit((0x0002, 0x0000), b"UL", struct.pack("<I", len(meta))) + meta
            if preamble else b"")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(head + body)


CASES = {
    "explicit": dict(slope=1.0, intercept=-1024.0, signed=False, implicit=False),
    "explicit_signed_slope": dict(slope=1.5, intercept=-1000.0, signed=True, implicit=False),
    "implicit": dict(slope=1.0, intercept=-1024.0, signed=False, implicit=True),
    "implicit_signed_slope": dict(slope=0.5, intercept=-24.0, signed=True, implicit=True),
    "raw_explicit_no_preamble": dict(slope=2.0, intercept=-1024.0, signed=True,
                                     implicit=False, preamble=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_decoder_matches_python_and_jax(lib, tmp_path, case):
    rng = np.random.default_rng(sum(map(ord, case)))
    kw = CASES[case]
    if kw["signed"]:
        pixels = rng.integers(-2048, 3000, (40, 56)).astype(np.int16)
        pixels[3, :7] = -2000  # the air sentinel
    else:
        pixels = rng.integers(0, 4095, (40, 56)).astype(np.uint16)
    path = str(tmp_path / f"{case}.dcm")
    write_dicom(path, pixels, **kw)
    got = native.decode_hu(path)
    want = get_pixels_hu(path)
    assert got is not None and got.dtype == np.int16 and got.shape == (40, 56)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_native.decode_hu(path))


def test_native_decoder_builds_into_the_port_build_dir(lib):
    path = _build.build_host("dicom_codec")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libdicom_codec_")
    assert path.with_suffix(".log").read_text().startswith("build seconds:")


def test_dataset_decodes_natively_and_records_it(lib, tmp_path):
    rng = np.random.default_rng(5)
    for i in range(2):
        for key in ("n_20", "n_100"):
            write_synthetic_dicom(str(tmp_path / "test" / "case0" / key / f"s{i}.IMA"),
                                  rng.integers(0, 2000, (24, 24)).astype(np.uint16))
    ds = PairedDicomDataset(str(tmp_path), "test")
    for i in range(len(ds)):
        lo, hi = ds.load(i)
        np.testing.assert_array_equal(lo, get_pixels_hu(ds.low_paths[i]))
        np.testing.assert_array_equal(hi, get_pixels_hu(ds.high_paths[i]))
    assert ds.decoded == {"native": 4, "python": 0}


def test_dataset_falls_back_to_python_without_the_library(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "library", lambda: None)
    write_synthetic_dicom(str(tmp_path / "test" / "c" / "n_20" / "a.IMA"),
                          np.full((8, 8), 1000, np.uint16))
    write_synthetic_dicom(str(tmp_path / "test" / "c" / "n_100" / "a.IMA"),
                          np.full((8, 8), 1100, np.uint16))
    ds = PairedDicomDataset(str(tmp_path), "test")
    lo, hi = ds.load(0)
    assert int(lo[0, 0]) == -24 and int(hi[0, 0]) == 76
    assert ds.decoded == {"native": 0, "python": 2}
