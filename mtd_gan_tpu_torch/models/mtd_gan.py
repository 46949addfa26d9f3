"""MTD-GAN: the Res-FFT generator, the multi-task discriminator and the
losses of the adversarial step (counterpart of
``mtd_gan_tpu/models/mtd_gan.py``).

State-dict names follow the reference (arch/Ours/networks.py:38-474):
``encoder.{i}`` (Conv2d), ``decoder.{i}`` (ConvTranspose2d) and
``enforce.{i}.img_conv`` / ``enforce.{i}.fft_conv`` for the generator, the
layout ``mtd_gan_tpu/utils/torch_import.py::convert_resfft_generator``
reads; ``conv{i}{j}``, ``down{i}``, ``bconv{1,2}``, ``c_fc``, ``enc_out``,
``s_dconv{i}{j}``, ``dec_out``, ``r_up{i}.upsample.0``, ``r_dconv{i}{j}``,
``rec_out`` with spectral-norm ``weight_orig`` / ``weight_u`` /
``weight_v`` for the discriminator, the layout ``convert_mtd_discriminator``
reads. Activations are NCHW inside; the public functions take the JAX
package's NHWC ``(N, H, W, 1)`` (the same memory for one channel).

``dtype`` (``--bf16``): the generator's and the discriminator's layers
compute in it, as the JAX modules' ``dtype`` (``ops/layers.py``); the
parameters stay fp32. The model keeps it as ``self.dtype``, which the
trainer and the routes read; the losses run in fp32, where the JAX model
casts (``_f32``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from mtd_gan_tpu_torch import losses
from mtd_gan_tpu_torch._device import DeviceLike, resolve_device
from mtd_gan_tpu_torch.ops.cuda_fftconv import in_fused_domain, in_tiled_domain
from mtd_gan_tpu_torch.ops.cuda_pipeline import (KERNEL_CHANNELS, in_k1_domain,
                                                 resfft_generator_nchw)
from mtd_gan_tpu_torch.ops.cuda_staged import conv3x3, in_staged_domain
from mtd_gan_tpu_torch.ops.fft_conv import FFTConvBlock, check_impls
from mtd_gan_tpu_torch.ops.layers import (Conv2d, ConvTranspose2d, Linear, SNConv2d, SNLinear,
                                          normal_init_, widen)
from mtd_gan_tpu_torch.ops.pixel_shuffle import PixelShuffleUpsample
from mtd_gan_tpu_torch.ops.upsample import upsample2x_bilinear
from mtd_gan_tpu_torch.parallel.mesh import batch_draw

INIT_STD = 0.01  # reference init N(0, 0.01), zero biases
Tensor = torch.Tensor


class ResFFTGenerator(nn.Module):
    """Symmetric encoder/decoder with 2L+1 interleaved Res-FFT-Conv blocks
    and long skip-adds; NCHW in and out. ``spectral_impl`` selects the
    blocks' spectral path and ``conv_impl`` the path of every 3x3 conv but
    the C_in = 1 entry conv (``ops/fft_conv.py``): ``"torch"`` (cuDNN and
    elementwise ops) or ``"k3"`` (the hand-written K3 with its fused
    epilogue; ``None``: K3 with a kernel spectral path, else ``"torch"``).
    The parameters and their names are the same for every choice.
    ``dtype``: the convs' compute type (the entry conv's on every path, the
    others' on the plain module; K3 computes in its input's type, so the
    kernel views run K3-bf16), the Res-FFT blocks following their input;
    the output, the exit deconv plus the fp32 image, is fp32, as the JAX
    module's. ``bound_dtype`` (``spectral_impl="staged"`` only): the type
    of the blocks' half spectrum between K4, K5 and K6 (``FFTConvBlock``;
    the JAX ``fft_block_nchw(bound_dtype=)``), fp32 by default."""

    def __init__(self, in_channels: int = 1, features: int = 32,
                 num_layers: int = 10, spectral_impl: str = "auto",
                 conv_impl: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None,
                 bound_dtype: torch.dtype = torch.float32):
        super().__init__()
        if conv_impl is None:
            conv_impl = "torch" if spectral_impl == "auto" else "k3"
        check_impls(spectral_impl, conv_impl, "ResFFTGenerator")
        L, f = num_layers, features
        self.num_layers, self.features = L, f
        self.conv_impl = conv_impl
        self.dtype = dtype
        self.encoder = nn.ModuleList(
            [Conv2d(in_channels, f, 3, padding=1, dtype=dtype)]
            + [Conv2d(f, f, 3, padding=1, dtype=dtype) for _ in range(L)])
        self.decoder = nn.ModuleList(
            [ConvTranspose2d(f, in_channels, 3, padding=1, dtype=dtype)]
            + [ConvTranspose2d(f, f, 3, padding=1, dtype=dtype) for _ in range(L)])
        self.enforce = nn.ModuleList([FFTConvBlock(f, spectral_impl, conv_impl, bound_dtype)
                                      for _ in range(2 * L + 1)])

    def _layer(self, conv: nn.Module, h: Tensor,
               skip: Optional[Tensor] = None) -> Tensor:
        """``relu(conv(h) [+ skip])`` for a 3x3 layer conv or deconv."""
        if self.conv_impl == "k3":
            return conv3x3(h, conv.weight, conv.bias, skip=skip, relu=True,
                           transpose=isinstance(conv, nn.ConvTranspose2d))
        out = conv(h)
        return torch.relu(out if skip is None else out + skip)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        L = self.num_layers
        skips = []
        h = torch.relu(self.encoder[0](x))  # C_in = 1: cuDNN on every path
        for i in range(L):
            if i > 0:
                h = self._layer(self.encoder[i], h)
            h = self.enforce[i](h)
            skips.append(h)
        h = self.enforce[L](self._layer(self.encoder[L], h))
        h = self._layer(self.decoder[L], h, skips[-1])
        for i in range(L - 1, 0, -1):
            h = self.enforce[2 * L - i](h)
            h = self._layer(self.decoder[i], h, skips[i - 1])
        h = self.enforce[2 * L](h)
        return self._layer(self.decoder[0], h, x)


def share_parameters(view: nn.Module, source: nn.Module) -> nn.Module:
    """Give ``view`` the parameter objects of ``source`` (same names): one
    set of parameters, so an update or a ``load_state_dict`` through either
    module shows in both. Returns ``view``."""
    params = dict(source.named_parameters())
    for name, _ in list(view.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        setattr(view.get_submodule(owner), leaf, params[name])
    return view


def generate_route(h: int, w: int, c: int, dtype: Optional[torch.dtype] = None) -> str:
    """The path ``MTDGANModel.generate`` takes for a CUDA input of H x W
    with a generator of C features computing in ``dtype`` (``None``:
    fp32), chosen by shape and width before any launch. A generator takes
    the first of the routes below that it fits, in the same order for both
    types; a bf16 generator runs each on the kernels' bf16 variants
    (K1-bf16; K8-bf16; K7-bf16; K4-bf16 -> K5 -> K6-bf16, the spectrum fp32;
    every 3x3 conv but the entry conv on K3-bf16). The routes:

    - ``"k1"``: the fused-block pipeline (``ops/cuda_pipeline.py``), H == W
      in {64, 128}, and 256 <= H <= 1024, 128 <= W <= 1024 with H and W
      multiples of 128 (``in_k1_domain``);
    - ``"tiled"``: the generator with the K8 spectral branch
      (``ops/cuda_fftconv.py``), H % 64 == 0 with 64 <= H <= 768 and W even
      with 2 <= W <= 1024;
    - ``"fused"``: the generator with the K7 spectral branch, 2 <= H, W <= 128;
    - ``"staged"``: the generator with the K4 -> K5 -> K6 spectral branch
      (``ops/cuda_staged.py``), 2 <= H, W <= 1024, any parity;
    - ``"plain"``: the plain module (cuDNN, cuFFT and ``spectral_branch``'s
      own zeroing of the W bins 0 and W/2), for every other shape (a side
      of 1, a side above 1024) and for C outside {8, 16, 32}, which no
      kernel is instantiated for.

    The tiled, fused and staged generators run every 3x3 conv but the entry
    conv on K3.

    Differences from the JAX routing (``mtd_gan_tpu/models/mtd_gan.py``
    generate), each the same function on another path: there, on the TPU,
    H >= 256 with H and W multiples of 128 goes to the K1 pipeline, other
    H >= 256 with H % 64 == 0 and W even to ``GeneratorTiled`` (K8), and
    everything else, at any width, to the XLA generator. Here K1 takes the
    same shapes up to 1024 a side; a side above 1024 runs the plain module.
    K1 also takes 64^2 and 128^2; K8 takes H from 64; the small inputs
    neither takes (96^2, 100x72, 33x33, ...) run the JAX package's
    small-input kernel, K7; and what none of those takes up to 1024 a side
    (800^2, 200^2, 130x64, 448x449, ...) runs the JAX package's unfused
    kernels K3 - K6. Only the rest runs the plain module, the port of the
    XLA path. The JAX routing does not look at the
    type either; its K1 pipeline always computes with bf16 boundaries,
    where here a bf16 generator takes the bf16 variants and an fp32 one
    the fp32 kernels. The staged route keeps its spectrum fp32
    (``bound_dtype`` of ``ResFFTGenerator``), where the JAX unfused
    pipeline's default rounds it to bf16 (ROADMAP.md, queue 2)."""
    if c in KERNEL_CHANNELS:
        if in_k1_domain(h, w):
            return "k1"
        if in_tiled_domain(h, w):
            return "tiled"
        if in_fused_domain(h, w):
            return "fused"
        if in_staged_domain(h, w):
            return "staged"
    return "plain"


def generator_views(generator: ResFFTGenerator) -> Dict[str, nn.Module]:
    """``generate``'s modules by route: ``"plain"`` is ``generator``;
    ``"tiled"``, ``"fused"`` and ``"staged"`` are the JAX
    ``GeneratorTiled``, the JAX ``ResFFTGenerator(spectral_impl=
    "pallas_fused")`` and the JAX unfused pipeline
    (``fft_block_nchw(fused=False)``) as generators: its parameters (shared,
    not copied) with the Res-FFT blocks on K8, K7 or K4 -> K5 -> K6. They
    are built on "meta", so their own placeholder weights take no memory
    and no random draws, with the generator's ``dtype``: a bf16 view's
    kernels read the shared fp32 weights and round them as they stage
    them, so no view holds a bf16 copy."""
    views = {"plain": generator}
    for impl in ("tiled", "fused", "staged"):
        with torch.device("meta"):
            view = ResFFTGenerator(1, generator.features, generator.num_layers,
                                   spectral_impl=impl, dtype=generator.dtype)
        views[impl] = share_parameters(view, generator).eval()
    return views


@torch.no_grad()
def resfft_generate(views: Dict[str, nn.Module], x: Tensor) -> Tensor:
    """``(N, H, W, 1)`` -> ``(N, H, W, 1)`` through the generator of
    :func:`generator_views`. A CUDA ``x`` takes the path
    :func:`generate_route` names: the K1 pipeline, the tiled (K8), fused
    (K7) or staged (K4 -> K5 -> K6) generator, each with its 3x3 convs on
    K3, or the plain module; a bf16 generator the same routes on the
    kernels' bf16 variants, or the plain module in bf16.
    A CPU ``x`` runs the plain module.
    ``x`` must be on the generator's device type."""
    gen = views["plain"]
    device = next(gen.parameters()).device
    if x.device.type != device.type:
        raise ValueError(f"generate: input on {x.device}, model on {device}")
    if x.device.type == "cpu":
        return gen(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    n, h, w, _ = x.shape
    route = generate_route(h, w, gen.features, gen.dtype)
    if route == "k1":
        return resfft_generator_nchw(gen.state_dict(), x, gen.num_layers,
                                     act_dtype=gen.dtype or torch.float32)
    # reshape, not permute: NCHW strides for the kernels' layout checks
    return views[route](x.reshape(n, 1, h, w).contiguous()).reshape(n, h, w, 1)


def check_discriminator_input(h: int, w: int) -> None:
    """The multi-task discriminator takes 64x64 only: raise otherwise."""
    if (h, w) != (64, 64):
        raise ValueError(
            f"the MTD-GAN discriminator takes 64x64 inputs (its CLS head "
            f"flattens a 1x1 bottleneck after six 2x downsamplings), got "
            f"{h}x{w}: the train presets 'full' and 'window' give whole "
            f"slices, on which the JAX package's step fails too; the models "
            f"that train on them are RED_CNN, EDCNN, DU_GAN and Restormer "
            f"(WGAN_VGG, MAP_NN and CTformer take 64x64 patches too)")


def _lrelu(x: Tensor) -> Tensor:
    return nn.functional.leaky_relu(x, 0.2)


HEADS = ("cls", "seg", "rec")


class MultiTaskDiscriminator(nn.Module):
    """Spectral-norm encoder (six conv-conv-down stages, 1x1 bottleneck) with
    a CLS head (SN linear, dropout, linear), a SEG decoder (bilinear 2x +
    skip concat) and a REC decoder (pixel shuffle + skip concat); input
    64x64 NCHW, outputs ``(cls (N, 1), seg (N, 1, 64, 64), rec (N, 1, 64,
    64))``. ``heads`` selects the decoders that are built and run: the
    reference's five partial discriminators (CLS, SEG, CLS_SEG, CLS_REC,
    SEG_REC, arch/Ours/networks.py:507-1320) are this module with fewer
    heads, the outputs in (cls, seg, rec) order for the enabled subset, a
    single head's output alone. The default, all three, is the flagship's.
    ``update_stats`` stores each spectral-norm layer's power iteration;
    ``generator`` draws the dropout mask in training. ``dtype``: the convs'
    compute type, as the JAX module's (the CLS head's linears and the
    pixel-shuffle convs, which have none there, follow their input)."""

    def __init__(self, in_channels: int = 1, features: int = 64,
                 dropout_rate: float = 0.3, heads: Tuple[str, ...] = HEADS,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if not heads or set(heads) - set(HEADS):
            raise ValueError(f"heads must be a non-empty subset of {HEADS}, got {heads}")
        f = features
        self.dropout_rate = dropout_rate
        self.heads = tuple(h for h in HEADS if h in heads)
        enc_ch = [f, f * 2, f * 4, f * 8, f * 8, f * 8]
        c_prev = in_channels
        for i, ch in enumerate(enc_ch, start=1):
            setattr(self, f"conv{i}1", SNConv2d(c_prev, ch, 3, padding=1, dtype=dtype))
            setattr(self, f"conv{i}2", SNConv2d(ch, ch, 3, padding=1, dtype=dtype))
            setattr(self, f"down{i}", SNConv2d(ch, ch, 4, stride=2, padding=1, dtype=dtype))
            c_prev = ch
        self.bconv1 = SNConv2d(f * 8, f * 8, 1, dtype=dtype)
        self.bconv2 = SNConv2d(f * 8, f * 8, 1, dtype=dtype)
        if "cls" in heads:
            self.c_fc = SNLinear(f * 8, f * 8)
            self.enc_out = Linear(f * 8, 1)
        dec_ch = [f * 8, f * 8, f * 4, f * 2, f, 1]
        prev = f * 8
        for i, ch in enumerate(dec_ch, start=1):
            skip_ch = enc_ch[6 - i]
            if "seg" in heads:
                setattr(self, f"s_dconv{i}1",
                        SNConv2d(prev + skip_ch, ch, 3, padding=1, dtype=dtype))
                setattr(self, f"s_dconv{i}2", SNConv2d(ch, ch, 3, padding=1, dtype=dtype))
            if "rec" in heads:
                setattr(self, f"r_up{i}", PixelShuffleUpsample(prev, 2))
                setattr(self, f"r_dconv{i}1",
                        SNConv2d(prev + skip_ch, ch, 3, padding=1, dtype=dtype))
                setattr(self, f"r_dconv{i}2", SNConv2d(ch, ch, 3, padding=1, dtype=dtype))
            prev = ch
        if "seg" in heads:
            self.dec_out = Conv2d(1, 1, 1, dtype=dtype)
        if "rec" in heads:
            self.rec_out = Conv2d(1, 1, 1, dtype=dtype)

    def forward(self, x: Tensor, train: bool = True, update_stats: bool = True,
                generator: Optional[torch.Generator] = None):
        sn = lambda name, v: _lrelu(getattr(self, name)(v, update_stats))
        h, skips = x, []
        for i in range(1, 7):
            h = sn(f"conv{i}2", sn(f"conv{i}1", h))
            skips.append(h)
            h = getattr(self, f"down{i}")(h, update_stats)
        x_bot = sn("bconv2", sn("bconv1", h))

        outputs = []
        if "cls" in self.heads:
            c = _lrelu(self.c_fc(x_bot.reshape(x_bot.shape[0], -1), update_stats))
            if train and self.dropout_rate > 0:
                keep = batch_draw(lambda s: torch.rand(s, generator=generator,
                                                       device=c.device),
                                  c.shape) >= self.dropout_rate
                c = c * keep / (1.0 - self.dropout_rate)
            outputs.append(self.enc_out(c))
        s = r = x_bot
        for i in range(1, 7):
            if "seg" in self.heads:
                s = sn(f"s_dconv{i}1", (upsample2x_bilinear(s), skips[6 - i]))
                s = sn(f"s_dconv{i}2", s)
            if "rec" in self.heads:
                r = sn(f"r_dconv{i}1", (getattr(self, f"r_up{i}")(r), skips[6 - i]))
                r = sn(f"r_dconv{i}2", r)
        if "seg" in self.heads:
            outputs.append(self.dec_out(s))
        if "rec" in self.heads:
            outputs.append(self.rec_out(r))
        return outputs[0] if len(outputs) == 1 else tuple(outputs)


def seeded_discriminator(features: int, dropout_rate: float, heads: Tuple[str, ...],
                         generator: torch.Generator,
                         dtype: Optional[torch.dtype] = None) -> MultiTaskDiscriminator:
    """A discriminator on the CPU with the reference init, drawn from
    ``generator``: N(0, 0.01) weights and zero biases, then the unit ``u``
    / ``v`` vectors."""
    disc = MultiTaskDiscriminator(1, features, dropout_rate, heads=heads, dtype=dtype)
    normal_init_(disc, INIT_STD, generator)
    with torch.no_grad():
        for _, buf in disc.named_buffers():
            buf.copy_(nn.functional.normalize(torch.randn(buf.shape, generator=generator),
                                              dim=0))
    return disc


# partition labels for MTO gradient surgery (reference :318-380)
_D_SHARED_PREFIXES = tuple(
    [f"conv{i}{j}" for i in range(1, 7) for j in (1, 2)]
    + [f"down{i}" for i in range(1, 7)] + ["bconv1", "bconv2"])
_D_TASK_PREFIXES = tuple(
    [f"s_dconv{i}{j}" for i in range(1, 7) for j in (1, 2)]
    + [f"r_up{i}" for i in range(1, 7)]
    + [f"r_dconv{i}{j}" for i in range(1, 7) for j in (1, 2)]
    + ["enc_out", "dec_out", "rec_out"])
# "c_fc" is in neither list, as in the reference, whose PCGrad path never
# populates c_fc.grad (PARITY.md:47)


def d_param_label(path: Tuple[str, ...]) -> str:
    if path[0] in _D_SHARED_PREFIXES:
        return "shared"
    if path[0] in _D_TASK_PREFIXES:
        return "task"
    return "unassigned"


def d_last_shared_label(path: Tuple[str, ...]) -> bool:
    return path[0] == "bconv2"


class MTDGANModel:
    """Flagship adversarial model: seeded init, ``generate``, and the losses
    of the train step. ``d_loss`` returns the stacked 3-task vector the MTO
    layer consumes; ``g_loss_terms`` is a scalar.

    ``device`` defaults to ``cuda`` and raises without a GPU; pass
    ``device="cpu"`` for the plain PyTorch path. ``dtype``: the compute
    type (``None``: fp32; ``torch.bfloat16`` for ``--bf16``), the
    parameters fp32 either way."""

    name = "MTD_GAN"
    n_d_tasks = 3

    def __init__(self, gen_features: int = 32, disc_features: int = 64,
                 num_layers: int = 10, dropout_rate: float = 0.3,
                 device: DeviceLike = None, seed: int = 0,
                 dtype: Optional[torch.dtype] = None):
        self.device = resolve_device(device)
        self.gen_features = gen_features
        self.num_layers = num_layers
        self.dtype = dtype  # compute dtype (None = fp32); the trainer reads it
        init = torch.Generator().manual_seed(seed)
        gen = ResFFTGenerator(1, gen_features, num_layers, dtype=dtype)
        normal_init_(gen, INIT_STD, init)
        self.generator = gen.to(self.device).eval()
        self.views = generator_views(self.generator)
        self.generator_tiled = self.views["tiled"]
        self.generator_fused = self.views["fused"]
        self.generator_staged = self.views["staged"]
        self.discriminator = seeded_discriminator(disc_features, dropout_rate, HEADS,
                                                  init, dtype).to(self.device)

    def generate(self, x: Tensor) -> Tensor:
        """``(N, H, W, 1)`` -> ``(N, H, W, 1)`` on the route
        :func:`generate_route` names (:func:`resfft_generate`)."""
        return resfft_generate(self.views, x)

    # ---- losses (reference arch/Ours/networks.py:1957-2009) ----
    def _apply_d(self, z: Tensor, update_stats: bool,
                 generator: Optional[torch.Generator]):
        return self.discriminator(z.permute(0, 3, 1, 2), train=True,
                                  update_stats=update_stats, generator=generator)

    def d_loss(self, x: Tensor, y: Tensor, fake: Tensor, update_stats: bool = False,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Stacked ``[disc, rec, consist]`` on NHWC ``x``, ``y`` and the
        generator output ``fake`` (detached here). D runs twice, each time on
        a concatenated pair: ``[y; fake]``, then the clipped restorations
        ``[clip(real_rec); clip(fake_rec)]`` (restoration consistency). The
        heads' outputs and ``fake`` are cast to fp32 before the losses, as
        the JAX ``_f32`` does."""
        fake = widen(fake.detach())
        b = y.shape[0]
        as_nhwc = lambda t: widen(t.permute(0, 2, 3, 1) if t.dim() == 4 else t)
        pair1 = [as_nhwc(t) for t in self._apply_d(torch.cat([y, fake]), update_stats,
                                                   generator)]
        (real_enc, real_dec, real_rec) = [t[:b] for t in pair1]
        (fake_enc, fake_dec, fake_rec) = [t[b:] for t in pair1]
        diff = x - y
        d_real_enc = losses.ls_gan(real_enc, 1.0)
        d_fake_enc = losses.ls_gan(fake_enc, 0.0)
        d_real_dec = losses.nds_loss(real_dec, 1.0, diff)
        d_fake_dec = losses.nds_loss(fake_dec, 0.0, diff)
        disc_loss = d_real_enc + d_fake_enc + d_real_dec + d_fake_dec
        rec_loss_real = losses.l1(real_rec, y)
        rec_loss_fake = losses.l1(fake_rec, fake)
        rec_loss = rec_loss_real + rec_loss_fake

        pair2 = [as_nhwc(t) for t in self._apply_d(
            torch.cat([real_rec.clamp(0.0, 1.0), fake_rec.clamp(0.0, 1.0)]),
            update_stats, generator)]
        rr_enc, rr_dec = pair2[0][:b], pair2[1][:b]
        rf_enc, rf_dec = pair2[0][b:], pair2[1][b:]
        c_re = losses.l2(real_enc, rr_enc)
        c_rd = losses.l2(real_dec, rr_dec)
        c_fe = losses.l2(fake_enc, rf_enc)
        c_fd = losses.l2(fake_dec, rf_dec)
        consist_loss = c_re + c_rd + c_fe + c_fd
        details = {
            "D/real_enc": d_real_enc, "D/fake_enc": d_fake_enc,
            "D/real_dec": d_real_dec, "D/fake_dec": d_fake_dec,
            "D/rec_loss_real": rec_loss_real, "D/rec_loss_fake": rec_loss_fake,
            "D/consist_loss_real_enc": c_re, "D/consist_loss_real_dec": c_rd,
            "D/consist_loss_fake_enc": c_fe, "D/consist_loss_fake_dec": c_fd,
        }
        return torch.stack([disc_loss, rec_loss, consist_loss]), details

    def g_loss_terms(self, fake: Tensor, x: Tensor, y: Tensor,
                     update_stats: bool = True,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """The generator's loss given ``fake = G(x)`` (NHWC): LSGAN on the CLS
        head, NDS on the SEG head, 50 x Charbonnier and 50 x EdgeLoss, in
        fp32 (the JAX ``_f32``)."""
        gen_enc, gen_dec, _ = self._apply_d(fake, update_stats, generator)
        gen_enc, gen_dec = widen(gen_enc), widen(gen_dec.permute(0, 2, 3, 1))
        fake = widen(fake)
        adv_enc = losses.ls_gan(gen_enc, 1.0)
        adv_dec = losses.nds_loss(gen_dec, 1.0, x - y)
        pix_loss = 50.0 * losses.charbonnier_loss(fake, y)
        edge = 50.0 * losses.edge_loss(fake.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2))
        total = adv_enc + adv_dec + pix_loss + edge
        details = {"G/gen_enc": adv_enc, "G/gen_dec": adv_dec,
                   "G/pix_loss": pix_loss, "G/edge_loss": edge}
        return total, details

    d_param_label = staticmethod(d_param_label)
    d_last_shared_label = staticmethod(d_last_shared_label)

    @torch.no_grad()
    def discriminate_full(self, x: Tensor, overlap: float = 0.5, mode: str = "gaussian",
                          sw_batch_size: int = 64) -> Tuple[Tensor, Tensor, Tensor]:
        """The 64x64 discriminator over whole NHWC slices through the
        multi-output sliding window (reference module/sliding_window.py:25-786),
        in eval (no dropout) with no stored power iteration: ``(cls (N, T,
        1)`` per tile, as the reference concatenates them (:126), ``seg``
        and ``rec`` ``(N, H, W, 1)`` blended)."""
        from mtd_gan_tpu_torch.ops.sliding_window import sliding_window_inference

        def predictor(tiles: Tensor):
            out = self.discriminator(tiles.permute(0, 3, 1, 2), train=False,
                                     update_stats=False)
            return tuple(t.permute(0, 2, 3, 1) if t.dim() == 4 else t for t in out)

        return sliding_window_inference(x, (64, 64), predictor, sw_batch_size=sw_batch_size,
                                        overlap=overlap, mode=mode)
