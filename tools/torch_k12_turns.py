#!/usr/bin/env python3
"""Time the port's fp32 K1 (the fused Res-FFT block) and K2 (its backward)
of one or more checkouts, in turns, on an NVIDIA GPU at the main paths'
shapes.

    python3 tools/torch_k12_turns.py CHECKOUT [CHECKOUT ...]

Each CHECKOUT is a checkout of this repository; each runs in a process of
its own, in the order given, so that ``PARENT . . PARENT`` takes turns
between a parent commit and this one. Every call goes through the API that
all versions share (``block_fused`` and ``block_bwd`` on fp32 tensors):

  * K1 at 512x512, batch 8, C = 32, with the pre conv and the skip (the
    serving route's commonest call);
  * K2 at 64x64, batch 160, C = 32, with the pre conv and the skip (the
    train step's).

Inputs: 1/sqrt(fan_in) weights and 0.1 biases, drawn with numpy from seed
0. Times are CUDA events, the mean of 20 calls after one warm-up call, TF32
off. The card's name and power limit come first. The kernels are built
into each checkout's own ``mtd_gan_tpu_torch/_build``.
"""

from __future__ import annotations

import os
import subprocess
import sys

C = 32
ITERS = 20


def cuda_ms(fn) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def inputs(n: int, size: int):
    """K1's pre+skip arguments and K2's cotangent, fp32 on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda").contiguous()
    hw = size * size
    weight = lambda *s: t(rng.standard_normal(s) / np.sqrt(np.prod(s[1:])))
    bias = lambda k: t(rng.standard_normal(k) * 0.1)
    args = dict(x=t(rng.random((n, C, hw))), h=size, w=size, km=weight(C, C, 3, 3),
                kb=bias(C), mix=weight(2 * C, 2 * C), mb=bias(2 * C),
                pre=(weight(C, C, 3, 3), bias(C)),
                skip=t(rng.standard_normal((n, C, hw)) * 0.5))
    return args, t(rng.standard_normal((n, C, hw)))


def one(checkout: str) -> None:
    """Times the checkout's K1 and K2."""
    sys.path.insert(0, checkout)
    import torch

    from mtd_gan_tpu_torch.ops.cuda_pipeline import block_fused
    from mtd_gan_tpu_torch.ops.cuda_train import block_bwd

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    label = os.path.basename(os.path.abspath(checkout))
    k1_args, _ = inputs(8, 512)
    k1 = cuda_ms(lambda: block_fused(**k1_args))
    k2_args, g = inputs(160, 64)
    k2 = cuda_ms(lambda: block_bwd(g=g, **k2_args))
    print(f"{label}: K1 512x512 batch 8 pre+skip {k1:.4f} ms; K2 64x64 batch 160 pre+skip "
          f"{k2:.4f} ms", flush=True)


def main():
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        one(args[1])
        return
    if not args:
        raise SystemExit(__doc__)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_k12_turns: needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    for checkout in args:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        os.path.abspath(checkout)], check=True)


if __name__ == "__main__":
    main()
