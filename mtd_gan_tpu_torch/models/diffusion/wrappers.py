"""The diffusion models DDPM, DDIM, PNDM and DPM (counterpart of
``mtd_gan_tpu/models/diffusion/wrappers.py``; reference
arch/Diffusion/networks.py:13-125 and the engine's diffusion loops,
engine.py:789-897):

* training: the eps-prediction MSE. ``t`` is drawn in [0, 1000), the
  target slice (n_100) is noised to ``x_t`` and the UNet predicts the noise
  from ``[x_t ; condition]`` concatenated on the channel axis
  (inferer.py:40-69);
* sampling: the whole reverse chain from pure noise, conditioned by the
  same concatenation (inferer.py:72-126): DDPM 1000 steps, DDIM, PNDM and
  DPM 50 (``n_inference_steps``, an attribute a caller may set).

Every random draw comes from an explicit ``torch.Generator`` on the model's
device, or is passed in (``draws=``): the loss takes ``{"noise", "t"}``,
a sample ``{"noise", "z"}`` (``z``: one tensor per step, DDPM's; the last,
at t = 0, unused). ``sample_batched`` gives every slice its own generator,
so slice i's trajectory is the batch-1 ``sample`` of that slice with that
generator (up to the batched convs' rounding). The models follow the
supervised protocol of ``models/base.py`` (``net``, ``device``, ``loss``,
``predict``); their functions take NHWC ``(N, H, W, 1)``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from mtd_gan_tpu_torch._device import DeviceLike
from mtd_gan_tpu_torch.models.base import SupervisedModel
from mtd_gan_tpu_torch.models.diffusion.schedulers import (BaseScheduler, DDIMScheduler,
                                                          DDPMScheduler,
                                                          DPMSolverMultistepScheduler,
                                                          PNDMScheduler)
from mtd_gan_tpu_torch.models.diffusion.unet import DiffusionUNet, unet_init_

Tensor = torch.Tensor


def slice_seed(seed: int, index: int) -> int:
    """The seed of noise stream ``index`` under ``seed`` (numpy's
    ``SeedSequence`` mixes the two, so neighbouring streams are
    unrelated)."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0] >> 1)


class _DiffusionBase(SupervisedModel):
    scheduler_cls = BaseScheduler
    n_inference_steps = 50

    def __init__(self, channels: Sequence[int] = (128, 256, 256), num_head_channels: int = 256,
                 norm_groups: int = 32, device: DeviceLike = None, seed: int = 0):
        net = DiffusionUNet(in_channels=2, out_channels=1, channels=channels,
                            attention_levels=(False, True, True), num_res_blocks=1,
                            num_head_channels=num_head_channels, norm_groups=norm_groups)
        super().__init__(net, device, seed, unet_init_)
        self.scheduler = self.scheduler_cls()
        self.rng = torch.Generator(device=self.device).manual_seed(seed)

    def eps(self, x_t: Tensor, condition: Tensor, t: Tensor) -> Tensor:
        """The UNet's noise prediction, NHWC in and out; ``t`` (N,)."""
        z = torch.cat([x_t, condition], dim=-1).permute(0, 3, 1, 2).contiguous()
        return self.net(z, t).permute(0, 2, 3, 1)

    def loss(self, x: Tensor, y: Tensor, generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, Tensor]] = None) -> Tuple[Tensor, Dict[str, Tensor]]:
        """eps-MSE: ``x`` the condition (n_20), ``y`` the target (n_100)."""
        if draws is None:
            noise = torch.randn(y.shape, generator=generator, device=y.device)
            t = torch.randint(0, self.scheduler.num_train_timesteps, (y.shape[0],),
                              generator=generator, device=y.device)
        else:
            noise, t = draws["noise"], draws["t"]
        val = torch.mean((self.eps(self.scheduler.add_noise(y, noise, t), x, t) - noise) ** 2)
        return val, {"loss": val}

    def _chain(self, condition: Tensor, noise: Tensor, z_fn) -> Tensor:
        n = condition.shape[0]

        def eps_fn(x_t: Tensor, t: int) -> Tensor:
            return self.eps(x_t, condition, torch.full((n,), t, device=condition.device))

        return self.scheduler.sample(eps_fn, noise, self.n_inference_steps, z_fn)

    @torch.no_grad()
    def sample(self, condition: Tensor, generator: Optional[torch.Generator] = None,
               draws: Optional[Dict[str, Tensor]] = None) -> Tensor:
        """The reverse chain from noise, conditioned on ``condition`` (N, H,
        W, 1): the noise and DDPM's per-step ``z`` from ``generator`` (drawn
        in that order), or from ``draws``."""
        if draws is not None:
            return self._chain(condition, draws["noise"], lambda k: draws["z"][k])
        randn = lambda: torch.randn(condition.shape, generator=generator,
                                    device=condition.device)
        return self._chain(condition, randn(), lambda k: randn())

    @torch.no_grad()
    def sample_batched(self, condition: Tensor, seeds: Sequence[int]) -> Tensor:
        """Slice i sampled with its own generator seeded ``seeds[i]``: each
        slice draws what the batch-1 ``sample`` draws, in the same order."""
        gens = [torch.Generator(device=condition.device).manual_seed(s) for s in seeds]
        one = condition.shape[1:]
        randn = lambda: torch.cat([torch.randn((1, *one), generator=g, device=condition.device)
                                   for g in gens])
        return self._chain(condition, randn(), lambda k: randn())

    def predict(self, x: Tensor) -> Tensor:
        """``sample`` on the model's own generator (seeded from ``seed``),
        fresh noise on every call (the reference's forward,
        networks.py:32-38)."""
        return self.sample(x, generator=self.rng)

    apply = predict


class DDPMModel(_DiffusionBase):
    scheduler_cls = DDPMScheduler
    n_inference_steps = 1000


class DDIMModel(_DiffusionBase):
    scheduler_cls = DDIMScheduler


class PNDMModel(_DiffusionBase):
    scheduler_cls = PNDMScheduler


class DPMModel(_DiffusionBase):
    scheduler_cls = DPMSolverMultistepScheduler
