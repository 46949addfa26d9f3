"""K3's bf16 input tile and A fragments (``mtd_gan_tpu_torch/csrc/
conv3x3_tc.cuh``: ``stage_tile_bf16`` and the ``if constexpr (BF)`` gather
of ``conv3x3_tc_kernel``), modelled in numpy on the CPU. The staging model
follows the kernel's copy units on each tier (the 16-byte tier's four
chunks and two pairs a row; the general tier's 18 pairs, asynchronous where
the row starts on 4 bytes and the pair lies inside the image, else loaded
by the threads), asserts each copy's alignment and that it lies wholly
inside or outside the image, and holds every shared slot the kernel reads
against the input value or zero it should hold, for tiles at every image
edge, for each W tier and for even and odd row offsets. The fragment model
builds each thread's A registers as the kernel does (two 16-bit slots
joined by ``prmt`` 0x5410), places them by wgmma's m64k16 fragment layout,
and sums the k16 steps: equal, bit for bit, to the steps of
``_bf16_tc_conv`` (tests/test_torch_tc_helpers.py), so the k order and the
bits are kept, and within TOL_BF16_SUMS of the float64 conv of the
bf16-rounded operands. The kernel itself runs only on the card
(tests/test_torch_cuda.py); this file imports no JAX."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_tc_helpers import _bf16, _bf16_tc_steps, _tc_sum

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

# conv3x3_tc.cuh's constants
TILE_H, TILE_W, THREADS = 16, 32, 512
PITCH = 40                        # kTcPitch16
PLANE = (TILE_H + 2) * PITCH + 8  # kTcPlane16
# as tests/test_torch_bf16_kernels.py: only the fp32 sums differ
TOL_BF16_SUMS = 1e-5

# (C_in, H, W, offset of x in bf16 values from a 256-byte aligned start):
# the 16-byte tier (W % 8 == 0, x on 16 bytes; 72 = two whole tiles and a
# partial one), the general tier with every row on 4 bytes (x 8 bytes
# off; W = 36), with odd row offsets (x 2 bytes off; odd W, whose rows
# alternate), and a one-column image
CASES = [(8, 20, 72, 0), (32, 20, 72, 0), (8, 20, 72, 4), (8, 20, 72, 1), (8, 19, 36, 0),
         (8, 17, 27, 0), (16, 17, 27, 3), (24, 17, 27, 1), (8, 5, 1, 0)]


def _bits(a: np.ndarray) -> np.ndarray:
    """float32 values that are bf16 values -> their 16 bits."""
    return (np.ascontiguousarray(a, np.float32).view(np.uint32) >> 16).astype(np.uint32)


def _tier(w: int, offset: int) -> bool:
    """launch_tc's choice: the 16-byte tier when W % 8 == 0 and x starts on
    16 bytes."""
    return w % 8 == 0 and (2 * offset) % 16 == 0


def _stage(mem, offset, n, c_in, h, w, y0, x0, b_bytes):
    """stage_tile_bf16 for the tile (n, y0, x0): the (C_in, PLANE) slots,
    NaN where nothing is written. ``mem``: x's values in float32 from
    element ``offset`` of an allocation; ``b_bytes``: B's bytes before the
    tiles (the tile's byte offset in shared memory)."""
    tile = np.full((c_in, PLANE), np.nan, np.float32)
    aligned = _tier(w, offset)
    for ci in range(c_in):
        for yy in range(TILE_H + 2):
            gy = y0 - 1 + yy
            row_ok = 0 <= gy < h
            row = offset + ((n * c_in + ci) * h + (gy if row_ok else 0)) * w
            at = yy * PITCH  # in the channel's plane, ci * PLANE into the tile
            shared = b_bytes + 2 * ci * PLANE
            if aligned:
                units = [(16, x0 + 8 * j, 8 * j, row_ok and x0 + 8 * j < w) for j in range(4)]
                units += [(4, x0 - 2, PITCH - 2, row_ok and 0 <= x0 - 2 < w),
                          (4, x0 + 32, 32, row_ok and 0 <= x0 + 32 < w)]
                for size, gx, pos, ok in units:
                    cnt = size // 2
                    inside = [row_ok and 0 <= gx + e < w for e in range(cnt)]
                    assert all(v == ok for v in inside), "a copy across the image edge"
                    assert (shared + 2 * (at + pos)) % size == 0, "shared address"
                    if ok:
                        assert (2 * (row + gx)) % size == 0, "global address"
                    tile[ci, at + pos:at + pos + cnt] = (mem[row + gx:row + gx + cnt] if ok
                                                         else 0.0)
                continue
            for p in range(18):
                gx, pos = x0 - 2 + 2 * p, PITCH - 2 if p == 0 else 2 * p - 2
                in0, in1 = row_ok and 0 <= gx < w, row_ok and 0 <= gx + 1 < w
                assert (shared + 2 * (at + pos)) % 4 == 0, "shared address"
                if in0 and in1 and (2 * row) % 4 == 0:  # cp.async of 4 bytes
                    assert (2 * (row + gx)) % 4 == 0, "global address"
                    tile[ci, at + pos:at + pos + 2] = mem[row + gx:row + gx + 2]
                else:  # two 2-byte loads, or zeros
                    tile[ci, at + pos] = mem[row + gx] if in0 else 0.0
                    tile[ci, at + pos + 1] = mem[row + gx + 1] if in1 else 0.0
    return tile


def _input(c_in: int, h: int, w: int, offset: int, n: int = 2, seed: int = 0):
    """x (N, C_in, H, W) of bf16 values in float32 and its allocation."""
    rng = np.random.default_rng(seed)
    x = _bf16(torch.tensor(rng.standard_normal((n, c_in, h, w)), dtype=torch.float32))
    mem = np.concatenate([np.zeros(offset, np.float32), x.numpy().reshape(-1),
                          np.zeros(8, np.float32)])
    return x, mem


def _tiles(n: int, h: int, w: int):
    for b in range(n):
        for y0 in range(0, h, TILE_H):
            for x0 in range(0, w, TILE_W):
                yield b, y0, x0


@pytest.mark.parametrize("c_in,h,w,offset", CASES)
def test_bf16_tile_holds_its_window(c_in, h, w, offset):
    """Every slot the kernel reads (row position (gx - x0) mod 40 for gx in
    x0 - 1 .. x0 + 33, all 18 rows, all channels) holds x there or zero
    outside the image, every tile of both images; the four unused positions
    and the plane's padding are never written."""
    x, mem = _input(c_in, h, w, offset)
    xn = x.numpy()
    pos = np.r_[np.arange(34), PITCH - 2, PITCH - 1]
    gxs = np.r_[np.arange(34), -2, -1]
    for b, y0, x0 in _tiles(2, h, w):
        tile = _stage(mem, offset, b, c_in, h, w, y0, x0, b_bytes=256)
        planes = tile[:, :(TILE_H + 2) * PITCH].reshape(c_in, TILE_H + 2, PITCH)
        gy = y0 - 1 + np.arange(TILE_H + 2)[:, None]
        gx = x0 + gxs[None, :]
        inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
        want = np.where(inside[None], xn[b][:, np.clip(gy, 0, h - 1), np.clip(gx, 0, w - 1)], 0)
        np.testing.assert_array_equal(planes[:, :, pos], want)
        assert np.isnan(planes[:, :, 34:PITCH - 2]).all()
        assert np.isnan(tile[:, (TILE_H + 2) * PITCH:]).all()


def _a_registers(tile, c_in: int, s: int):
    """Every thread's A registers of k16 step s as the kernel gathers them:
    (4, 2, 512) uint32 [register, m-tile i, thread]."""
    ci8 = c_in // 8
    tid = np.arange(THREADS)
    warp, lane = tid >> 5, tid & 31
    g, t, wg, ww = lane >> 2, lane & 3, warp >> 2, warp & 3
    col0 = (ww & 1) * 16
    bits = _bits(np.nan_to_num(tile, nan=np.float32(np.inf)))
    regs = np.zeros((4, 2, THREADS), np.uint32)
    for hh in range(2):
        kg = 2 * s + hh
        if kg >= 9 * ci8:
            continue
        tap, kc = divmod(kg, ci8)
        dy, dx = divmod(tap, 3)
        xx = col0 + g + dx
        cols = (np.where(xx == 0, PITCH - 1, xx - 1), xx + 7)  # pixels g, g + 8
        for i in range(2):
            row = 2 * (2 * wg + i) + (ww >> 1) + dy
            ch = kc * 8 + 2 * t
            for r8, col in enumerate(cols):
                lo = bits[ch, row * PITCH + col]
                hi = bits[ch + 1, row * PITCH + col]
                regs[2 * hh + r8, i] = (lo & 0xFFFF) | ((hi & 0xFFFF) << 16)  # prmt 0x5410
    return regs


def _place(regs, a_img, b, y0, x0, h, w):
    """wgmma's m64k16 A fragment: thread (warp w, g, t) of a warpgroup
    holds rows 16 (w % 4) + g (registers 0, 2) and + 8 (1, 3) by k 2t,
    2t + 1 (0, 1) and 2t + 8, 2t + 9 (2, 3), low half the lower k; m-tile
    2wg + i is output rows 2m, 2m + 1 of the tile, row r at (r // 32, r %
    32). Writes the tile's in-image pixels of a_img (N, H, W, 16)."""
    tid = np.arange(THREADS)
    warp, lane = tid >> 5, tid & 31
    g, t, wg, ww = lane >> 2, lane & 3, warp >> 2, warp & 3
    for reg in range(4):
        mrow = 16 * ww + g + 8 * (reg & 1)
        k = 2 * t + 8 * (reg >> 1)
        for i in range(2):
            m = 2 * wg + i
            y, xg = y0 + 2 * m + mrow // 32, x0 + mrow % 32
            ok = (y < h) & (xg < w)
            word = regs[reg, i]
            for e in range(2):
                v = ((word >> (16 * e)) & 0xFFFF).astype(np.uint32) << 16
                a_img[b, y[ok], xg[ok], k[ok] + e] = v[ok].view(np.float32)


@pytest.mark.parametrize("c_in,h,w,offset", [(8, 20, 72, 0), (32, 20, 72, 0),
                                             (8, 17, 27, 1), (32, 17, 27, 1)])
@pytest.mark.parametrize("adjoint", [False, True], ids=["conv2d", "conv_transpose2d"])
def test_bf16_fragments_rebuild_the_conv(c_in, h, w, offset, adjoint):
    """Each k16 step's A, gathered from the modelled tiles by the kernel's
    fragment map, is the step's A of ``_bf16_tc_steps`` bit for bit (so the
    summed conv is ``_bf16_tc_conv``'s exactly), and the sum is within
    TOL_BF16_SUMS of the float64 conv of the bf16-rounded operands; the
    residual epilogue's slot (co, row yl + 1, position xl) holds x at the
    output pixel. 9 C_in is odd at C_in = 8: the last step's second group
    is zeros."""
    x, mem = _input(c_in, h, w, offset, seed=c_in + w)
    rng = np.random.default_rng(1)
    co = 16
    shape = (c_in, co, 3, 3) if adjoint else (co, c_in, 3, 3)
    weight = torch.tensor(rng.standard_normal(shape) / np.sqrt(9 * c_in), dtype=torch.float32)
    steps = _bf16_tc_steps(x, weight, adjoint)
    tiles = {key: _stage(mem, offset, key[0], c_in, h, w, key[1], key[2], b_bytes=256)
             for key in _tiles(2, h, w)}
    ours = []
    for s, (a_want, b_rows) in enumerate(steps):
        a_img = np.full((2, h, w, 16), np.nan, np.float32)
        for (b, y0, x0), tile in tiles.items():
            _place(_a_registers(tile, c_in, s), a_img, b, y0, x0, h, w)
        np.testing.assert_array_equal(a_img, a_want.numpy(), err_msg=f"step {s}")
        ours.append((torch.from_numpy(a_img), b_rows))
    got = _tc_sum(ours)
    assert torch.equal(got, _tc_sum(steps))
    conv = F.conv_transpose2d if adjoint else F.conv2d
    want = conv(x.double(), _bf16(weight).double(), padding=1)
    assert ((got.double() - want).abs().max() / want.abs().max()).item() <= TOL_BF16_SUMS
    for (b, y0, x0), tile in tiles.items():
        for yl in range(min(TILE_H, h - y0)):
            xl = np.arange(min(TILE_W, w - x0))
            np.testing.assert_array_equal(tile[:, (yl + 1) * PITCH + xl],
                                          x.numpy()[b, :, y0 + yl, x0 + xl].T)


def _assigned(path: Path, name: str, env: dict):
    """The value of the module-level assignment to ``name`` in ``path``,
    evaluated with the names ``env`` gives (the file is parsed, not
    imported)."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in node.targets):
            return eval(compile(ast.Expression(node.value), str(path), "eval"), env)
    raise AssertionError(f"no {name} in {path}")


def test_card_cases_agree_and_cover_both_tiers():
    """chip_smoke.py's K3_BF16_TIER_CASES (phase 32) and the card tests'
    K3_BF16_CASES (tests/test_torch_cuda.py) are the same cases, and they
    hold every C_in on both staging tiers and on rows that start at an odd
    element (odd W or an odd offset: the thread-loaded pairs)."""
    repo = Path(__file__).resolve().parent.parent
    smoke = repo / "chip_smoke.py"
    cases = _assigned(smoke, "K3_BF16_TIER_CASES", {"C": _assigned(smoke, "C", {})})
    assert cases == _assigned(repo / "tests" / "test_torch_cuda.py", "K3_BF16_CASES", {})
    tiers = {(c_in, _tier(w, off)) for c_in, _, _, _, w, off in cases}
    assert tiers == {(c_in, t) for c_in in (8, 16, 24, 32) for t in (False, True)}
    odd = {c_in for c_in, _, _, _, w, off in cases if w % 2 or off % 2}
    assert odd == {8, 16, 24, 32}
