"""The ten MTD-GAN ablations (counterpart of
``mtd_gan_tpu/models/ablations.py``; reference
arch/Ours/networks.py:1324-1936).

Each is DU-GAN's ``REDCNNGenerator`` (32 features, 3x3, padding 1; the
last recipe swaps in the ``ResFFTGenerator``) with a head-subset
``MultiTaskDiscriminator``, and returns a SCALAR ``d_loss``
(``n_d_tasks = 1``: the plain summed backward; only the flagship stacks
per-task losses for MTO). Recipes:

  name                          heads          NDS    RC
  Ablation_CLS                  (cls,)         -      -
  Ablation_SEG                  (seg,)         -      -
  Ablation_CLS_SEG              (cls, seg)     -      -
  Ablation_CLS_REC              (cls, rec)     -      -
  Ablation_SEG_REC              (seg, rec)     -      -
  Ablation_CLS_SEG_REC          all            -      -
  Ablation_CLS_SEG_REC_NDS      all            yes    -
  Ablation_CLS_SEG_REC_RC       all            -      yes
  Ablation_CLS_SEG_REC_NDS_RC   all            yes    yes
  ..._NDS_RC_ResFFT             all            yes    yes   (ResFFT G)

Quirks of the reference kept: a two-head ``g_loss`` scores BOTH outputs
with ``ls_gan(., 1)``, even when the second head is REC (:1482-1500,
:1541-1559); NDS applies only where the SEG head is; the D pass is one
concatenated 2B forward of ``(y, fake)``; RC adds a second D pass on the
clipped REC outputs. Every D forward of a loss stores one power iteration
(``update_stats``). ``generate`` of the ResFFT recipe takes the flagship's
routes (K1 at 512^2, the tiled, fused, staged or plain generator
otherwise); the REDCNN generator runs on cuDNN, outside any kernel, as in
the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from mtd_gan_tpu_torch import losses
from mtd_gan_tpu_torch._device import DeviceLike, resolve_device
from mtd_gan_tpu_torch.models.dugan import REDCNNGenerator
from mtd_gan_tpu_torch.models.mtd_gan import (HEADS, INIT_STD, ResFFTGenerator,
                                              check_discriminator_input, generator_views,
                                              resfft_generate, seeded_discriminator)
from mtd_gan_tpu_torch.ops.cuda_train import resfft_generator_train, train_route
from mtd_gan_tpu_torch.ops.layers import normal_init_

Tensor = torch.Tensor


class AblationModel:
    """A recipe's generator and discriminator, seeded as the flagship's
    (N(0, 0.01) weights, zero biases, unit ``u`` / ``v`` drawn after them
    from one generator), ``generate``, and the losses of the adversarial
    step on NHWC tensors. ``device`` defaults to ``cuda`` and raises without
    a GPU."""

    n_d_tasks = 1
    check_input = staticmethod(check_discriminator_input)

    def __init__(self, heads: Tuple[str, ...], use_nds: bool = False,
                 use_rc: bool = False, resfft: bool = False,
                 gen_features: int = 32, disc_features: int = 64,
                 num_layers: int = 10, dropout_rate: float = 0.3,
                 device: DeviceLike = None, seed: int = 0):
        self.device = resolve_device(device)
        self.use_nds, self.use_rc, self.resfft = use_nds, use_rc, resfft
        self.gen_features = gen_features
        init = torch.Generator().manual_seed(seed)
        gen = (ResFFTGenerator(1, gen_features, num_layers) if resfft
               else REDCNNGenerator(1, gen_features, num_layers))
        normal_init_(gen, INIT_STD, init)
        self.generator = gen.to(self.device).eval()
        self.views = generator_views(self.generator) if resfft else None
        self.discriminator = seeded_discriminator(disc_features, dropout_rate, heads,
                                                  init).to(self.device)
        self.heads = self.discriminator.heads  # in (cls, seg, rec) order

    @torch.no_grad()
    def generate(self, x: Tensor) -> Tensor:
        """``(N, H, W, 1)`` -> ``(N, H, W, 1)``."""
        if self.resfft:
            return resfft_generate(self.views, x)
        return self.generator(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def train_forward(self, x: Tensor) -> Tensor:
        """``G(x)`` with its graph, for a train step: the ResFFT generator on
        K1 + K2 (``resfft_generator_train``) where ``train_route`` gives them
        the batch, as the flagship's step does; else the plain module under
        autograd (the REDCNN generator always)."""
        _, h, w, _ = x.shape
        if self.resfft and train_route(h, w, self.gen_features) == "kernels":
            return resfft_generator_train(self.generator, x)
        return self.generator(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def _apply_d(self, z: Tensor, update_stats: bool,
                 generator: Optional[torch.Generator]) -> Tuple[Tensor, ...]:
        out = self.discriminator(z.permute(0, 3, 1, 2), train=True,
                                 update_stats=update_stats, generator=generator)
        out = out if isinstance(out, tuple) else (out,)
        return tuple(t.permute(0, 2, 3, 1) if t.dim() == 4 else t for t in out)

    def _seg_metric(self, pred: Tensor, target: float, diff: Tensor) -> Tensor:
        if self.use_nds:
            return losses.nds_loss(pred, target, diff)
        return losses.ls_gan(pred, target)

    def d_loss(self, x: Tensor, y: Tensor, fake: Tensor, update_stats: bool = True,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """The scalar D loss on NHWC ``x``, ``y`` and ``fake = G(x)``
        (detached here), and its terms."""
        fake = fake.detach()
        b = y.shape[0]
        pair = self._apply_d(torch.cat([y, fake]), update_stats, generator)
        real = [t[:b] for t in pair]
        fke = [t[b:] for t in pair]
        diff = x - y
        head = {h: i for i, h in enumerate(self.heads)}
        details: Dict[str, Tensor] = {}
        if "cls" in head:
            i = head["cls"]
            details["D/real_enc"] = losses.ls_gan(real[i], 1.0)
            details["D/fake_enc"] = losses.ls_gan(fke[i], 0.0)
        if "seg" in head:
            i = head["seg"]
            details["D/real_dec"] = self._seg_metric(real[i], 1.0, diff)
            details["D/fake_dec"] = self._seg_metric(fke[i], 0.0, diff)
        if "rec" in head:
            i = head["rec"]
            details["D/rec_loss_real"] = losses.l1(real[i], y)
            details["D/rec_loss_fake"] = losses.l1(fke[i], fake)
        if self.use_rc:
            i = head["rec"]
            rc = self._apply_d(torch.cat([real[i].clamp(0.0, 1.0), fke[i].clamp(0.0, 1.0)]),
                               update_stats, generator)
            c, s = head["cls"], head["seg"]
            details["D/consist_loss_real_enc"] = losses.l2(real[c], rc[c][:b])
            details["D/consist_loss_real_dec"] = losses.l2(real[s], rc[s][:b])
            details["D/consist_loss_fake_enc"] = losses.l2(fke[c], rc[c][b:])
            details["D/consist_loss_fake_dec"] = losses.l2(fke[s], rc[s][b:])
        return sum(details.values()), details

    def g_loss_terms(self, fake: Tensor, x: Tensor, y: Tensor, update_stats: bool = True,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """The generator's loss given ``fake = G(x)`` (NHWC): the adversarial
        term on the first one or two outputs, 50 x Charbonnier, 50 x
        EdgeLoss."""
        outs = self._apply_d(fake, update_stats, generator)
        details = {"G/gen_enc": losses.ls_gan(outs[0], 1.0)}
        if len(self.heads) > 1:
            # the first two outputs scored (quirk: even REC as the second head)
            details["G/gen_dec"] = (losses.nds_loss(outs[1], 1.0, x - y)
                                    if self.use_nds and "seg" in self.heads
                                    else losses.ls_gan(outs[1], 1.0))
        details["G/pix_loss"] = 50.0 * losses.charbonnier_loss(fake, y)
        details["G/edge_loss"] = 50.0 * losses.edge_loss(fake.permute(0, 3, 1, 2),
                                                         y.permute(0, 3, 1, 2))
        return sum(details.values()), details


def _make(heads, **recipe):
    return lambda **kwargs: AblationModel(heads=heads, **recipe, **kwargs)


ABLATIONS = {
    "Ablation_CLS": _make(("cls",)),
    "Ablation_SEG": _make(("seg",)),
    "Ablation_CLS_SEG": _make(("cls", "seg")),
    "Ablation_CLS_REC": _make(("cls", "rec")),
    "Ablation_SEG_REC": _make(("seg", "rec")),
    "Ablation_CLS_SEG_REC": _make(HEADS),
    "Ablation_CLS_SEG_REC_NDS": _make(HEADS, use_nds=True),
    "Ablation_CLS_SEG_REC_RC": _make(HEADS, use_rc=True),
    "Ablation_CLS_SEG_REC_NDS_RC": _make(HEADS, use_nds=True, use_rc=True),
    "Ablation_CLS_SEG_REC_NDS_RC_ResFFT": _make(HEADS, use_nds=True, use_rc=True, resfft=True),
}
