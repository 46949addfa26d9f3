"""PyTorch/CUDA port of mtd_gan_tpu for NVIDIA Hopper (H100).

The JAX package ``mtd_gan_tpu`` is the reference this package is held
against; nothing here imports it (or JAX). Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; without a GPU they raise.

Ported so far: MTD-GAN generator inference and the ``test`` metric sweep
(``python -m mtd_gan_tpu_torch.test``) and the MTD-GAN PCGrad training path
(``python -m mtd_gan_tpu_torch.train``), with the fused Res-FFT block, its
backward, the tiled spectral branch (for the slice sizes the fused block
does not take) and the per-sample fused spectral branch (for the small
inputs neither takes) as hand-written CUDA kernels
(``csrc/block_fused.cu``, ``csrc/block_bwd.cu``, ``csrc/spectral_tiled.cu``,
``csrc/spectral_fused.cu``).
"""

from mtd_gan_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
