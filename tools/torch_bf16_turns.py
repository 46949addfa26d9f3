#!/usr/bin/env python3
"""Time the port's bf16 kernels that run K3's tensor-core conv, and bf16
``generate`` on every route, beside their fp32 counterparts, for one or
more checkouts in turns on an NVIDIA GPU.

    python3 tools/torch_bf16_turns.py CHECKOUT [CHECKOUT ...]

Each CHECKOUT is a checkout of this repository; each runs in a process of
its own, in the order given, so that ``PARENT . . PARENT`` takes turns
between a parent commit and this one. Every call goes through the API that
all versions since the bf16 routes share, C = 32, TF32 off:

  * K1 and K1-bf16 (``block_fused``) at 512x512, batch 8, pre + skip;
  * K2 and K2-bf16 (``block_bwd``) at 64x64, batch 160, pre + skip;
  * K3 and K3-bf16 (``conv3x3``) at 1024x1024, batch 2, relu + residual;
  * ``MTDGANModel.generate`` at full width (10 layers, seed 0), fp32 and
    bf16, at each route's main-path shape: 512^2 batch 8 (K1), 448^2
    batch 8 (tiled), 1024^2 batch 2 and 200^2 batch 8 (staged), 96^2
    batch 64 (fused).

Inputs are drawn with numpy from seed 0 (1/sqrt(fan_in) weights, 0.1
biases). Kernel times are CUDA events, the mean of 20 calls after one
warm-up call; ``generate`` the mean of 5. The card's name and power limit
come first. The kernels are built into each checkout's own
``mtd_gan_tpu_torch/_build``.
"""

from __future__ import annotations

import os
import subprocess
import sys

C = 32
GENERATE = ((8, 512), (8, 448), (2, 1024), (8, 200), (64, 96))


def cuda_ms(fn, iters: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def one(checkout: str) -> None:
    """Times the checkout's kernels and ``generate``."""
    sys.path.insert(0, checkout)
    import numpy as np
    import torch

    from mtd_gan_tpu_torch.models.mtd_gan import MTDGANModel
    from mtd_gan_tpu_torch.ops.cuda_pipeline import block_fused
    from mtd_gan_tpu_torch.ops.cuda_staged import conv3x3
    from mtd_gan_tpu_torch.ops.cuda_train import block_bwd

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    bf16 = torch.bfloat16
    rng = np.random.default_rng(0)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda").contiguous()
    weight = lambda *s: t(rng.standard_normal(s) / np.sqrt(np.prod(s[1:])))
    bias = lambda k: t(rng.standard_normal(k) * 0.1)
    act = lambda a, dt: {k: v.to(dt) if k in ("x", "skip", "g") else v for k, v in a.items()}

    def block(n: int, size: int):
        hw = size * size
        return dict(x=t(rng.random((n, C, hw))), h=size, w=size, km=weight(C, C, 3, 3),
                    kb=bias(C), mix=weight(2 * C, 2 * C), mb=bias(2 * C),
                    pre=(weight(C, C, 3, 3), bias(C)),
                    skip=t(rng.standard_normal((n, C, hw)) * 0.5))

    label = os.path.basename(os.path.abspath(checkout))
    parts = []
    with torch.no_grad():
        k1 = block(8, 512)
        k2 = block(160, 64)
        k2["g"] = t(rng.standard_normal((160, C, 64 * 64)))
        x3 = t(rng.random((2, C, 1024, 1024)))
        w3, b3 = weight(C, C, 3, 3), bias(C)
        for name, fn, a in (("K1", block_fused, k1), ("K2", block_bwd, k2)):
            a16 = act(a, bf16)
            times = [cuda_ms(lambda: fn(**a)), cuda_ms(lambda: fn(**a16))]
            parts.append(f"{name} {times[0]:.4f} / bf16 {times[1]:.4f} ms")
        x16 = x3.to(bf16)
        times = [cuda_ms(lambda: conv3x3(x3, w3, b3, residual=True)),
                 cuda_ms(lambda: conv3x3(x16, w3, b3, residual=True))]
        parts.append(f"K3 {times[0]:.4f} / bf16 {times[1]:.4f} ms")
        print(f"{label}: K1 512x512 b8 pre+skip, K2 64x64 b160 pre+skip, K3 1024x1024 b2 "
              f"relu+residual: " + "; ".join(parts), flush=True)
        del k1, k2, x3, x16
        models = {dt: MTDGANModel(gen_features=C, num_layers=10, device="cuda", seed=0,
                                  dtype=dt) for dt in (None, bf16)}
        parts = []
        for n, size in GENERATE:
            x = t(rng.random((n, size, size, 1)))
            times = [cuda_ms(lambda: models[dt].generate(x), 5) for dt in (None, bf16)]
            parts.append(f"{size}^2 b{n} {times[0]:.3f} / bf16 {times[1]:.3f}")
        print(f"{label}: generate fp32 / bf16 ms: " + "; ".join(parts), flush=True)


def main():
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        one(args[1])
        return
    if not args:
        raise SystemExit(__doc__)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_bf16_turns: needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    for checkout in args:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        os.path.abspath(checkout)], check=True)


if __name__ == "__main__":
    main()
