"""The diffusion family: the conditioned ``DiffusionUNet`` and the
DDPM / DDIM / PNDM / DPM-Solver++ schedulers and models (counterpart of
``mtd_gan_tpu/models/diffusion/``). Nothing here reaches a Pallas kernel
in the JAX package; on the card it runs on cuDNN and cuBLAS."""

from mtd_gan_tpu_torch.models.diffusion.schedulers import (DDIMScheduler, DDPMScheduler,
                                                          DPMSolverMultistepScheduler,
                                                          PNDMScheduler)
from mtd_gan_tpu_torch.models.diffusion.unet import DiffusionUNet
from mtd_gan_tpu_torch.models.diffusion.wrappers import (DDIMModel, DDPMModel, DPMModel,
                                                        PNDMModel)

__all__ = ["DDPMScheduler", "DDIMScheduler", "PNDMScheduler", "DPMSolverMultistepScheduler",
           "DiffusionUNet", "DDPMModel", "DDIMModel", "PNDMModel", "DPMModel"]
