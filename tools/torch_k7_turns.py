#!/usr/bin/env python3
"""Time the port's per-sample fused spectral branch K7 of one or more
checkouts, in turns, on an NVIDIA GPU at the small inputs of the fused
route.

    python3 tools/torch_k7_turns.py CHECKOUT [CHECKOUT ...]

Each CHECKOUT is a checkout of this repository; each runs in a process of
its own, in the order given, so that ``PARENT . . PARENT`` takes turns
between a parent commit and this one. Every call goes through the API that
all versions of K7 share, so an older kernel is timed as its own route
calls it:

  * K7 alone, ``spectral_branch_fused(x, mix, bias)``, batch 64: C = 32 at
    33x33, 97x66 and 96x96, C = 8 at 33x27;
  * the fused Res-FFT block on the same inputs,
    ``fft_conv_block(..., impl="fused", conv_impl="k3")``: K3's conv with
    its residual, then K7, the residual added inside K7 or after it,
    whichever the checkout does;
  * ``MTDGANModel.generate`` on the fused route (32 features, 10 layers,
    random weights from seed 0) at 100x72, batch 4.

Times are CUDA events, the mean of 10 calls after one warm-up call. The
card's name and power limit come first. The kernels are built into each
checkout's own ``mtd_gan_tpu_torch/_build``.
"""

from __future__ import annotations

import os
import subprocess
import sys

# (n, c, h, w) of the kernel and block timings
SHAPES = ((64, 32, 33, 33), (64, 32, 97, 66), (64, 32, 96, 96), (64, 8, 33, 27))
GENERATE = (4, 100, 72)
ITERS = 10


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


def one(checkout: str) -> None:
    """Times the checkout's K7, fused block and fused generate."""
    sys.path.insert(0, checkout)
    import numpy as np
    import torch

    from mtd_gan_tpu_torch.models.mtd_gan import MTDGANModel, generate_route
    from mtd_gan_tpu_torch.ops.cuda_fftconv import spectral_branch_fused
    from mtd_gan_tpu_torch.ops.fft_conv import fft_conv_block

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda").contiguous()
    label = os.path.basename(os.path.abspath(checkout))
    with torch.no_grad():
        for n, c, h, w in SHAPES:
            x = t(rng.random((n, c, h, w)))
            weight = t(rng.standard_normal((c, c, 3, 3)) / np.sqrt(9 * c))
            bias = t(rng.standard_normal(c) * 0.1)
            mix = t(rng.standard_normal((2 * c, 2 * c)) / np.sqrt(2 * c))
            mix_bias = t(rng.standard_normal(2 * c) * 0.1)
            alone = cuda_ms(lambda: spectral_branch_fused(x, mix, mix_bias))
            block = cuda_ms(lambda: fft_conv_block(x, weight, bias, mix, mix_bias,
                                                   impl="fused", conv_impl="k3"))
            print(f"{label}: {h}x{w} batch {n} C={c}: K7 alone {alone:.4f} ms, fused block "
                  f"(K3 + K7 + residual) {block:.4f} ms", flush=True)
        n, h, w = GENERATE
        model = MTDGANModel(gen_features=32, num_layers=10, device="cuda", seed=0)
        x = t(rng.random((n, h, w, 1)))
        route = generate_route(h, w, 32)
        gen = cuda_ms(lambda: model.generate(x))
    print(f"{label}: generate {h}x{w} batch {n} ({route} route): {gen:.4f} ms", flush=True)


def main():
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        one(args[1])
        return
    if not args:
        raise SystemExit(__doc__)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_k7_turns: needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    for checkout in args:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        os.path.abspath(checkout)], check=True)


if __name__ == "__main__":
    main()
