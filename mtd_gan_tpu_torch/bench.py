"""Headline benchmark of the port: 512x512 denoised CT slices/s through
``MTDGANModel.generate`` at full width (32 features, 10 layers = 21 Res-FFT
blocks), random weights from a fixed seed, best over a batch sweep
(counterpart of the root ``bench.py``).

    python -m mtd_gan_tpu_torch.bench

Batches 64, 32, 16, 8 and 4 in that order (96 and 128 last with
``BENCH_PROBE_HEADROOM=1``); a batch at or above one that failed is skipped,
and once ``BENCH_BUDGET_S`` seconds (default 1500) have passed no new batch
starts. Each batch: one warm call (the first one builds the kernels), then
20 timed calls (CUDA events); one line on stderr with its slices/s, warm-up
seconds and route. Then one JSON line on stdout: ``metric``, ``value`` (the
best slices/s), ``unit``, ``vs_baseline`` (``value`` over the plain PyTorch
module's slices/s at the same batch, measured in the same run with TF32
off), ``tflops`` and ``mfu`` (the useful FLOPs of a slice, counted from the
model's shapes by :func:`generator_flops`, over the H100's dense TF32 peak),
``peak_tflops``, ``batch``, ``warmup_s``, ``route``, ``batches`` (those
that ran, in sweep order) and ``device`` (the card's name and power
limit). If every batch fails it prints the error line
and exits 1. ``main`` needs a GPU; :func:`run` also runs on the CPU (the
plain module, for tests).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, Sequence

import torch

from mtd_gan_tpu_torch._device import resolve_device
from mtd_gan_tpu_torch.models.mtd_gan import MTDGANModel, generate_route
from mtd_gan_tpu_torch.ops.cuda_pipeline import block_fused

METRIC = "512x512 CT slices/sec/chip (MTD-GAN G inference)"
UNIT = "slices/sec"
BATCHES = (64, 32, 16, 8, 4)
PROBE_BATCHES = (96, 128)
SEED = 2024  # the root's weights and inputs key
# NVIDIA H100 SXM, dense TF32 on the tensor cores (data sheet): the peak of
# the type K1's C -> C convs run in, so that the share cannot pass 1
PEAK_TF32_FLOPS = 495e12


def block_work(n: int, size: int, variant: str, c: int = 32):
    """(conv FLOPs, other FLOPs, bytes) one fused Res-FFT block call needs.
    Conv FLOPs: the multiply-adds of each C->C 3x3 conv, 2*9*C*C per
    pixel. Other FLOPs: each conv's 3-op epilogue per output; the spectral
    mix 2*(2C)^2 per (h, k) bin plus bias and ReLU; a real 2-D FFT forward
    and one inverse, 2.5*HW*log2(HW) each per channel; the spectral add;
    the C->1 post conv. Bytes: every input read once, every output written
    once, fp32."""
    hw = size * size
    k = size // 2 + 1
    n_convs = 1 if variant == "plain" else 2
    conv = n * n_convs * 2 * 9 * c * c * hw
    other = n * (n_convs * 3 * c * hw
                 + (2 * (2 * c) ** 2 + 2 * 2 * c) * size * k
                 + 2 * 2.5 * c * hw * math.log2(hw) + c * hw)
    words = n_convs * (9 * c * c + c) + 4 * c * c + 2 * c
    words += n * c * hw * (3 if "skip" in variant else 2)  # x [, skip], out
    if "post" in variant:
        other += n * (2 * 9 * c + 3) * hw
        words += 9 * c + 1 + 2 * n * hw  # post weights, img, final
    return conv, other, 4 * words


def generator_flops(size: int, c: int = 32, num_layers: int = 10) -> float:
    """Useful FLOPs of one size x size slice through the generator: the
    2L + 1 blocks as :func:`block_work` counts them (block 0 without a layer
    conv, the encoder's L with one, the decoder's L - 1 with the skip, the
    last with the C -> 1 exit deconv as well), plus the 1 -> C entry conv
    with its bias and ReLU."""
    variants = ("plain",) + ("pre",) * num_layers + ("pre+skip",) * (num_layers - 1) \
        + ("pre+skip+post",)
    blocks = sum(sum(block_work(1, size, v, c)[:2]) for v in variants)
    return blocks + (2 * 9 * c + 2 * c) * size * size


def card_name() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def _slices_per_s(fn, x: torch.Tensor, iters: int):
    """(slices/s over ``iters`` calls, seconds of the one warm call before)."""
    cuda = x.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    fn(x)
    sync()
    warm = time.perf_counter() - t0
    if cuda:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn(x)
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(x)
        seconds = time.perf_counter() - t0
    return x.shape[0] * iters / seconds, warm


def run(size: int = 512, batches: Sequence[int] = BATCHES, gen_features: int = 32,
        num_layers: int = 10, device=None, iters: int = 20,
        budget_s: float = 1500.0) -> Dict:
    """The sweep; returns the JSON line's fields (``value`` 0.0 and an
    ``error`` when every batch failed). ``device`` defaults to ``cuda``.
    The plain module is timed at the best batch with ``max(2, iters // 4)``
    calls after a warm call."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = MTDGANModel(gen_features=gen_features, num_layers=num_layers,
                            device=dev, seed=SEED)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        route = generate_route(size, size, gen_features) if cuda else "plain"
        t_start = time.perf_counter()
        best, best_batch, warmups = 0.0, None, {}
        min_failed, last_err, attempts = None, None, 0
        for batch in batches:
            if min_failed is not None and batch >= min_failed:
                print(f"# batch {batch}: skipped (>= failed batch {min_failed})",
                      file=sys.stderr, flush=True)
                continue
            if attempts and time.perf_counter() - t_start > budget_s:
                print(f"# budget exhausted, skipping batch {batch}", file=sys.stderr,
                      flush=True)
                continue
            attempts += 1
            try:
                x = torch.rand((batch, size, size, 1), generator=gen, device=dev)
                launches = block_fused.launches
                sps, warm = _slices_per_s(model.generate, x, iters)
                per_call = (block_fused.launches - launches) / (iters + 1)
            except (RuntimeError, MemoryError) as e:  # e.g. device memory
                first = str(e).strip().splitlines()[0] if str(e) else ""
                print(f"# batch {batch} failed: {type(e).__name__}: {first[:200]}",
                      file=sys.stderr, flush=True)
                min_failed, last_err = batch, e
                x = None
                if cuda:
                    torch.cuda.empty_cache()
                continue
            if route == "k1" and per_call != 2 * num_layers + 1:
                raise RuntimeError(f"batch {batch}: {per_call} K1 launches per "
                                   f"generate, expected {2 * num_layers + 1}")
            print(f"# batch {batch}: {sps:.2f} slices/s (warmup {warm:.1f} s, route "
                  f"{route})", file=sys.stderr, flush=True)
            warmups[batch] = warm
            if sps > best:
                best, best_batch = sps, batch
            del x
        if best_batch is None:
            err = (str(last_err).strip().splitlines()[0][:300]
                   if last_err is not None and str(last_err) else "")
            return {"metric": METRIC, "value": 0.0, "unit": UNIT, "vs_baseline": 0.0,
                    "batches": [], "error": f"{type(last_err).__name__}: {err}" if last_err is not None
                    else "no batch size attempted"}
        x = torch.rand((best_batch, size, size, 1), generator=gen, device=dev)
        with torch.no_grad():
            plain, _ = _slices_per_s(
                lambda t: model.generator(t.permute(0, 3, 1, 2)), x, max(2, iters // 4))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    tflops = generator_flops(size, gen_features, num_layers) * best / 1e12
    return {"metric": METRIC, "value": best, "unit": UNIT, "vs_baseline": best / plain,
            "tflops": tflops,
            "mfu": tflops * 1e12 / PEAK_TF32_FLOPS if cuda else None,
            "peak_tflops": PEAK_TF32_FLOPS / 1e12 if cuda else None,
            "batch": best_batch, "warmup_s": warmups[best_batch], "plain_value": plain,
            "route": route, "batches": list(warmups),
            "device": card_name() if cuda else "cpu"}


def main() -> Dict:
    resolve_device("cuda")  # raises without a GPU
    batches = BATCHES + (PROBE_BATCHES if os.environ.get("BENCH_PROBE_HEADROOM") == "1"
                         else ())
    result = run(batches=batches, budget_s=float(os.environ.get("BENCH_BUDGET_S", "1500")))
    print(json.dumps(result), flush=True)
    if result["value"] == 0.0:
        sys.exit(1)
    return result


if __name__ == "__main__":
    main()
