"""PyTorch/CUDA port of mtd_gan_tpu for NVIDIA Hopper (H100).

The JAX package ``mtd_gan_tpu`` is the reference this package is held
against; nothing here imports it (or JAX). Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; without a GPU they raise.

Ported so far: the flagship MTD-GAN's three entry points with the root
CLIs' flags: the headline benchmark (``python -m mtd_gan_tpu_torch.bench``),
generator inference and the ``test`` metric sweep (``python -m
mtd_gan_tpu_torch.test``, with PL, TML and FID by default) and training
with any of the eleven multi-task methods (``python -m
mtd_gan_tpu_torch.train``); the CNN family (RED-CNN, EDCNN) and the ten
MTD-GAN ablations through the same ``train`` and ``test`` CLIs
(``models``, ``engine``); the feature extractors and the feature, learned
and piq-tail metrics (``features``, ``metrics``); the eight Pallas kernels
of the JAX package as hand-written CUDA kernels (``csrc/*.cu``), and its
native DICOM decoder (``csrc/dicom_codec.cc``).
"""

from mtd_gan_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
