#!/usr/bin/env python3
"""Digests of the kernels' outputs on seeded inputs, per checkout of the
port: the guard that templating their device code on a new type (an
activation type, a spectrum type), or redesigning where a kernel's
operands come from, left every existing instance computing what it did,
bit for bit.

    python3 tools/torch_fp32_digests.py [CHECKOUT ...]    (on an NVIDIA GPU)

For each checkout (default: this one), in its own process with that
checkout first on ``sys.path``, :func:`digests` builds the kernels of K1
(``csrc/block_fused.cu``), K2, K3, K8, K7 and K4 - K6 from its sources,
runs the fp32 kernels K1 - K8 and the bf16 variants K1-bf16, K2-bf16,
K3-bf16, K4-bf16, K6-bf16 and K8-bf16 on inputs drawn with numpy from
fixed seeds,
through the wrappers every checkout since the bf16 variants share, and
takes the SHA-256 of each output's bytes (its first 16 hex digits); a K1
shape the checkout's wrapper refuses (ValueError) is left out of its
digests. Prints one JSON line per checkout, then which of the first
checkout's digests differ in another; exits 1 if any does. A kernel
whose digests agree computed the same bits from the same inputs.
``chip_smoke.py`` phase 33 runs :func:`digests` on its own checkout and
holds it against the digests this tool printed for the parent of the
change that last redesigned the code.

Unpack an older checkout with ``git archive`` into the git-ignored
``archive_check/`` and pass its path.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

# K4 - K6 at the staged route's sizes: clusters of 2 (1024, C = 32) and 4
# (1000), K5's odd step in registers (200 = 8 x 25) and in two buffers
# (1000, 449, 33), the rows' scalar paths (W = 130, 27)
STAGED = ((2, 32, 1024, 1024), (2, 32, 200, 200), (2, 32, 1000, 64), (2, 8, 449, 130),
          (2, 16, 33, 27))
# K8 at 448^2 (one CTA a bin), 768^2 (a 2-CTA cluster), 512x320
TILED = ((2, 32, 448, 448), (2, 32, 768, 768), (2, 8, 512, 320))
# K7 resident (96^2, 100x72, 33x27) and with the spectrum in its scratch
# (127^2 at C = 32)
FUSED = ((4, 32, 96, 96), (2, 32, 100, 72), (2, 32, 127, 127), (2, 8, 33, 27))
# K1 (N, C, H, W, variant): at C = 32 with every option and plain at C = 8,
# then the other two squares; then shapes of the JAX gate beyond the
# squares, which a checkout whose K1 refuses them leaves out: 1024^2 and
# the odd factors 3, 5 and 7 of H on K5's mixed-radix column pass (1024,
# 896 on a 2-CTA cluster at C = 32), 256 x 1024 on K1's own
BLOCKS = ((2, 32, 512, 512, "pre+skip+post"), (4, 8, 64, 64, "plain"),
          (2, 16, 128, 128, "pre+skip+post"), (2, 32, 256, 256, "plain"),
          (2, 32, 1024, 1024, "pre+skip+post"), (2, 16, 384, 384, "pre+skip+post"),
          (2, 32, 640, 384, "plain"), (2, 8, 256, 1024, "pre+skip+post"),
          (2, 32, 896, 512, "pre+skip+post"))
# K3 at the staged route's 1024^2 and the tiled route's 448^2 (the bf16
# tile's 16-byte tier), 449x130 and 33x27 at C = 8 (its general tier)
CONVS = ((2, 32, 1024, 1024), (2, 32, 448, 448), (2, 32, 449, 130), (2, 8, 33, 27))
# K2 at the train step's shape, pre + skip, and plain at C = 8
BWDS = ((160, 32, "pre+skip"), (8, 8, "plain"))


def _digest(t) -> str:
    import torch

    t = t.detach()
    if t.is_complex():
        t = torch.view_as_real(t)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def _spectral_inputs(seed: int, n: int, c: int, h: int, w: int):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda").contiguous()
    return dict(x=t(rng.random((n, c, h, w))),
                mix=t(rng.standard_normal((2 * c, 2 * c)) / np.sqrt(2 * c)),
                bias=t(rng.standard_normal(2 * c) * 0.1),
                residual=t(rng.standard_normal((n, c, h, w)) * 0.5))


def _block_inputs(seed: int, n: int, c: int, h: int, w: int, variant: str):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda").contiguous()
    wt = lambda *s: t(rng.standard_normal(s) / np.sqrt(np.prod(s[1:])))
    b = lambda k: t(rng.standard_normal(k) * 0.1)
    hw = h * w
    args = dict(x=t(rng.random((n, c, hw))), h=h, w=w, km=wt(c, c, 3, 3), kb=b(c),
                mix=wt(2 * c, 2 * c), mb=b(2 * c))
    if variant != "plain":
        args["pre"] = (wt(c, c, 3, 3), b(c))
        args["skip"] = t(rng.standard_normal((n, c, hw)) * 0.5)
        args["post"] = (wt(1, c, 3, 3), b(1))
        args["img"] = t(rng.random((n, 1, hw)))
    return args


def _conv_inputs(seed: int, n: int, c: int, h: int, w: int):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda").contiguous()
    return dict(x=t(rng.random((n, c, h, w)) - 0.5),
                weight=t(rng.standard_normal((c, c, 3, 3)) / np.sqrt(9 * c)),
                bias=t(rng.standard_normal(c) * 0.1),
                skip=t(rng.standard_normal((n, c, h, w)) * 0.5))


def _bf16(args):
    import torch

    return {k: v.to(torch.bfloat16) if k in ("x", "skip", "residual", "g") else v
            for k, v in args.items()}


def digests() -> dict:
    """{label: digest} of every case above, on the current CUDA device."""
    import numpy as np
    import torch

    from mtd_gan_tpu_torch.ops import _build
    from mtd_gan_tpu_torch.ops.cuda_fftconv import spectral_branch_fused, spectral_branch_tiled
    from mtd_gan_tpu_torch.ops.cuda_pipeline import block_fused
    from mtd_gan_tpu_torch.ops.cuda_staged import conv3x3, irdft_w_add, rdft_w, spectral_mix_h
    from mtd_gan_tpu_torch.ops.cuda_train import block_bwd

    names = ("block_fused", "block_bwd", "conv3x3", "spectral_tiled", "spectral_fused",
             "spectral_staged")
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(_build.build, names))
    out = {}
    with torch.no_grad():
        for seed, (n, c, h, w) in enumerate(STAGED):
            a = _spectral_inputs(seed, n, c, h, w)
            shape = f"{n}x{c}x{h}x{w}"
            z = rdft_w(a["x"])
            out[f"K4 {shape}"] = _digest(z)
            out[f"K5 {shape}"] = _digest(spectral_mix_h(z, a["mix"], a["bias"]))
            out[f"K6 {shape}"] = _digest(irdft_w_add(z, a["residual"]))
            b = _bf16(a)
            out[f"K4-bf16 {shape}"] = _digest(rdft_w(b["x"]))
            out[f"K6-bf16 {shape}"] = _digest(irdft_w_add(z, b["residual"]))
        for seed, (n, c, h, w) in enumerate(TILED):
            a = _spectral_inputs(10 + seed, n, c, h, w)
            shape = f"{n}x{c}x{h}x{w}"
            out[f"K8 {shape}"] = _digest(spectral_branch_tiled(**a))
            out[f"K8 {shape} no residual"] = _digest(
                spectral_branch_tiled(**{**a, "residual": None}))
            out[f"K8-bf16 {shape}"] = _digest(spectral_branch_tiled(**_bf16(a)))
        for seed, (n, c, h, w) in enumerate(FUSED):
            a = _spectral_inputs(20 + seed, n, c, h, w)
            shape = f"{n}x{c}x{h}x{w}"
            out[f"K7 {shape}"] = _digest(spectral_branch_fused(**a))
            out[f"K7 {shape} no residual"] = _digest(
                spectral_branch_fused(**{**a, "residual": None}))
        for seed, (n, c, h, w, variant) in enumerate(BLOCKS):
            a = _block_inputs(30 + seed, n, c, h, w, variant)
            label = f"{n}x{c}x{h}x{w} {variant}"
            for dtype, args in (("K1", a), ("K1-bf16", _bf16(a))):
                try:
                    got = block_fused(**args)
                except ValueError:  # a checkout whose K1 does not take the shape
                    continue
                for i, t in enumerate(got if isinstance(got, tuple) else (got,)):
                    out[f"{dtype} {label} output {i}"] = _digest(t)
        for seed, (n, c, h, w) in enumerate(CONVS):
            a = _conv_inputs(40 + seed, n, c, h, w)
            shape = f"{n}x{c}x{h}x{w}"
            for dtype, b in (("K3", a), ("K3-bf16", _bf16(a))):
                args = (b["x"], b["weight"], b["bias"])
                out[f"{dtype} {shape} relu+residual"] = _digest(conv3x3(*args, residual=True))
                out[f"{dtype} {shape} skip"] = _digest(conv3x3(*args, skip=b["skip"]))
                out[f"{dtype} {shape} deconv+skip"] = _digest(
                    conv3x3(*args, skip=b["skip"], relu=False, transpose=True))
        for seed, (n, c, variant) in enumerate(BWDS):
            a = _block_inputs(50 + seed, n, c, 64, 64, variant)
            a.pop("post", None)
            a.pop("img", None)
            a["g"] = torch.tensor(np.random.default_rng(60 + seed).standard_normal(
                (n, c, 64 * 64)), dtype=torch.float32, device="cuda")
            label = f"{n}x{c}x64x64 {variant}"
            for dtype, args in (("K2", a), ("K2-bf16", _bf16(a))):
                for name, t in sorted(block_bwd(**args).items()):
                    out[f"{dtype} {label} {name}"] = _digest(t)
    torch.cuda.synchronize()
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(digests()), flush=True)
        return 0
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    checkouts = sys.argv[1:] or [here]
    runs = []
    for path in checkouts:
        path = os.path.abspath(path)
        env = {**os.environ, "PYTHONPATH": path}
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", path],
                              cwd=path, env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            print(f"{path}: failed\n{proc.stdout}{proc.stderr}", flush=True)
            return 1
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"checkout": path, "digests": got}), flush=True)
        runs.append(got)
    differ = sorted(k for k in runs[0] if any(r.get(k) != runs[0][k] for r in runs[1:]))
    print(f"digests: {len(runs[0])} outputs, {len(runs)} checkouts; differ: {differ or 'none'}",
          flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
