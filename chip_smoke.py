#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mtd_gan_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the kernels K1 (csrc/block_fused.cu), K2 (csrc/block_bwd.cu), K8
     (csrc/spectral_tiled.cu), K7 (csrc/spectral_fused.cu), K3
     (csrc/conv3x3.cu) and K4 - K6 (csrc/spectral_staged.cu), one nvcc
     process per source, started together (sm_90a), and print the build logs;
  3. hold K1 (``block_fused``) against its plain PyTorch version
     (``block_fused_reference``) at C = 32, 64x64 to 512x512, batch 2, in
     all four variants (plain, pre, pre+skip, pre+skip+post), with the
     reference init and with 1/sqrt(fan_in) weights;
  4. full ``MTDGANModel.generate`` (32 features, 10 layers = 21 blocks,
     512x512, batch 8) against the plain module, 21 K1 launches per call;
  5. serving: the ``mtd_gan_tpu_torch.test`` sweep over 16 synthetic
     512x512 DICOM pairs with seeded weights saved as a reference-layout
     .pth — the serving path, whose K1 launches are counted;
  6. hold K8 (``spectral_branch_tiled``) against its plain version
     (``spectral_branch_tiled_reference``) and against a second call of
     itself (bit for bit), one launch a call, at C = 32 and C = 8, batch 2,
     192x192 to 768x768 and 512x320, with and without the residual, with
     the reference init and with 1/sqrt(fan_in) weights; H = 100 and C = 24
     must raise;
  7. ``generate`` at 448x448, batch 8, full width, against the plain
     module: 21 K8, 42 K3 (41 on the tensor cores, the C -> 1 exit deconv
     on the direct path) and 0 K1 launches per call; one 512x320 call at
     batch 2 the same;
  8. serving at 448x448: the ``test`` sweep over 16 synthetic 448x448
     DICOM pairs — the tiled serving path, 42 K8, 84 K3 and 0 K1 launches;
  9. hold K7 (``spectral_branch_fused``) against its plain version
     (``spectral_branch_fused_reference``) and against a second call of
     itself (bit for bit) at C = 32, batch 2, 32x32 to 128x128 with odd and
     prime sizes (100x72, 97x66, 127x127; 127x127 and 128x128 with the
     spectrum in the device-memory scratch), and at C = 8, 33x27, with and
     without the residual, with the reference init and with 1/sqrt(fan_in)
     weights; H = 129, C = 24, a residual of another shape and a gradient
     request must raise;
  10. ``generate`` at 96x96, batch 64, full width, against the plain
     module: 21 K7 (each with the block's residual in its store), 42 K3 (41
     on the tensor cores) and 0 K1 / K8 launches per call, and as many
     ``aten::add`` calls as the tiled route's ``generate`` (no separate
     residual add); one 100x72 call at batch 4 the same;
  11. serving at 96x96: the ``test`` sweep over 16 synthetic 96x96 DICOM
     pairs — the fused serving path, 42 K7, 84 K3 and 0 K1 / K8 launches;
  12. hold K3 (``conv3x3``) against its plain version (``F.conv2d`` plus
     the elementwise ops) in its four epilogues (plain, relu, skip+relu,
     relu+residual), the flipped deconv with skip+relu (these five on the
     tensor-core path) and the C -> 1 exit deconv (the direct path), at
     448x448, 96x96, 200x200, 1024x1024, 449x130 and 448x449, C = 32,
     batch 2, with both inits, each call's path counted; C_out = 12, a
     residual with C_in != C_out and a gradient request must raise; where
     the toolkit has ``cuobjdump``, count the tensor-core instructions
     (HMMA, HGMMA) in K3's, K1's and K2's libraries (K1 and K2 run their
     C -> C convs on K3's kernel, K2 its weight gradients on mma.sync):
     none is fatal;
  13. hold K4 (``rdft_w``), K5 (``spectral_mix_h``) and K6 (``irdft_w_add``,
     and K6 in place, its output the residual, as K1 calls it) each
     against its plain version (``torch.fft``), each fed the plain input,
     and K5 against a second call of itself (bit for bit), at 1024x1024,
     800x800, 200x200, 130x64, 448x449, 2x2, 1000x64 and the odd heights
     101x1024, 33x200 and 449x130, at C = 32 and C = 8, batch 2, with both
     inits, printing the branch of K5's odd step and its cluster size at
     each;
     C = 24, a side of 1025 and a gradient request must raise;
  14. ``generate`` at 1024x1024, batch 2, and 200x200, batch 8, full width,
     against the plain module: 42 K3 (41 on the tensor cores), 21 each of
     K4, K5 and K6 and 0 K1 / K7 / K8 launches per call;
  15. serving at 1024x1024: the ``test`` sweep over 8 synthetic 1024x1024
     DICOM pairs — the staged serving path, its K3 - K6 launches counted;
  16. F1: ``generate`` at gen_features=64 (200x200, batch 2) and on a 1x64
     input (32 features) runs the plain module on the card with no kernel
     launch, within 1e-3 of the same module on the CPU;
  17. hold K2 (``block_bwd``) and its fp32 plain version against the
     plain version in float64 on sign-certain ("margin") inputs at batch 8
     and 160, K2 also with one block per band and per bin; hold K2
     against its plain version (``block_bwd_reference``, autograd through
     K1's) at 64x64, C = 32, batch 2 and 8 in the four variants, with the
     reference init, with 1/sqrt(fan_in) weights and with margin biases,
     and at batch 160 (the train step's) in pre+skip and pre+skip+post
     with the last two; and the forward K2 recomputes against K1's, bit
     for bit: hin (every variant with pre) and out (pre+skip+post), at
     C = 8 and 32;
  18. the PCGrad train step at full width (generator 32 features x 10
     layers, discriminator 64 features, 160 patches of 64x64 cut by
     ``make_train_preprocess`` from 20 synthetic 512x512 slices): from one
     state, the generator gradient and the D losses through K1 + K2 against
     the plain generator under autograd; then 3 more kernel steps, finite
     losses and 21 K1 + 21 K2 launches per step; the first state's
     gradients also read against the plain generator in float64; the same
     check on three more states and patch sets, each read twice, and as
     witnesses (not held) with another forward in place of K1: K1's plain
     version, K1's convs alone and hand-written FFTs alone;
  19. F2: one train step at gen_features=64 (16 of those patches): the
     plain generator under autograd, no kernel launch, finite losses;
  20. training: ``python -m mtd_gan_tpu_torch.train --method pcgrad`` (one
     epoch, 2 steps of 20 slices, validation) on synthetic train / valid
     splits — the training path, whose K1 and K2 launches are counted —
     then ``python -m mtd_gan_tpu_torch.test --resume`` on its checkpoint;
     then a second 1-epoch run with ``--method uw --scheduler
     cosine_annealing_warm_restart --dataset-type-train full_patch
     --from-pretrained`` (the first run's checkpoint) ``--profile-dir``,
     its K2 launches counted and UW's state in its checkpoint, and ``test
     --checkpoint-dir --epoch 0`` without ``--resume``;
  21. timings with CUDA events (K1, K2, K8, K7 and K3 - K6 and their plain
     versions per call beside their bounds (K1 and K3: the fp32 CUDA-core
     bound and the bound with their convs on the tensor cores in 3xTF32;
     K7 with the residual, as the fused route calls it, and without, and
     in turns with the staged branch K4 -> K5 -> K6 on the same input)
     and, for K3, K4 and K6, one library call of the same function (K4:
     ``torch.fft.rfft``, and beside it the same with K4's transposed
     layout; K6: ``torch.fft.irfft`` + the residual, and K6 in place); K5
     at 800x800, batch 2, and 200x200, batch 8, too; K1 split by its
     launches (pre conv, residual conv, rows, column pass, inverse rows)
     under torch.profiler; K8 split the same way (K4's rows, the column
     pass, K6's inverse rows); K2 at 64x64, batch 160, pre+skip, split by
     its 14 launches the same way, its convs and weight gradients beside
     cuDNN's (``F.conv2d``, ``aten.convolution_backward``) on the same
     tensors; K3 at 448x448 and 96x96 too;
     generate and sweep slices/s at 512x512, 448x448, 96x96, 1024x1024 and
     200x200; generate at 512x512 on the K1 route and on the staged
     generator, in turns (a measurement only: the route stays K1); generate
     at 448x448 and 96x96 with the convs on K3 and on cuDNN, in turns; ms
     per train step and patches/s), torch.profiler breakdowns of one
     generate call at 512x512, 448x448, 96x96, 1024x1024 and 200x200 and of
     one train step by kernel, then the kernel JSON line, the card line and
     the result line;
  22. the native DICOM decoder (``csrc/dicom_codec.cc``) against the Python
     codec, bit for bit, and both per file;
  23. the 64-slice 512x512 ``test`` sweep, twice, its host time split by
     phase;
  24. ``bench.run`` at the root's batches;
  25. one full-width train step per MTO method on K1 + K2;
  26. the feature metrics (run right after phase 5): the ``test`` CLI at its
     default, PL / TML / FID on, over phase 5's 16 slices, in turns with
     ``--no-feature-metrics`` (on, off, off, on), each split by phase with
     the ``features`` phase: exactly 0 gt_pl and gt_tml in every row, every
     column finite, the three FIDs in the summary, K1 launched as in phase
     5; then at 512x512, batch 2, the VGG19 slice features, PL and TML per
     slice and the Inception pool3 features on the card against the same
     port functions on the CPU in float64, and the FID math fed either
     side's features; the extractors' times at the sweep's group of 8
     slices (VGG19 per image pass beside its fp32 bound); the weights
     status.
  27. the CNN family and the ablations (run right after phase 26):
     RED-CNN (96 channels), EDCNN (32 / 32, its compound loss on the
     registry's ResNet50), Ablation_CLS_SEG_REC_NDS_RC (REDCNN generator,
     all heads) and Ablation_CLS_SEG_REC_NDS_RC_ResFFT at full width, each
     through the ``train`` CLI (one epoch of 2 steps of 20 slices,
     ``window_patch``, validation) and ``test --resume`` on its checkpoint
     over phase 5's 16 slices; RED-CNN one step on ``full`` (8 whole
     512x512 slices); finite metrics; the card's forward of each trained
     model against the CPU forward of the same weights (128x128, batch 2);
     the ResFFT ablation's K1 and K2 launches (21 + 21 a train step, 21 K1
     per validation slice, 42 K1 per sweep) and no launch of any kernel on
     the other models' paths; each model's forward at 512x512, batch 8, and
     train step on 160 patches timed; a profile of the REDCNN generator's
     ``generate``. The kernel line's K1 and K2 launches are phase 20's
     first train run plus the ResFFT ablation's train run (and, for K1, its
     sweep).
  28. the WGAN and transformer families (run right after phase 27):
     WGAN-VGG (its perceptual loss on the registry's VGG19), MAP-NN, DU-GAN,
     CTformer and Restormer at their published widths, each through the
     ``train`` CLI (one epoch of 2 steps of 20 slices, ``window_patch``,
     validation; 4 critic updates a step for WGAN-VGG and MAP-NN;
     Restormer 4 slices a step, 160 patches exceeding the card's memory)
     and ``test --resume`` on its checkpoint: the WGAN family over phase
     5's 16 slices, CTformer over 8 and Restormer over 2 slices at 512x512
     through the sliding window at overlap 0.9 (5776 tiles a slice);
     finite metrics; the card's forward of each trained model against the
     CPU's on the same weights; WGAN-VGG's gradient penalty and its critic
     gradient (cuDNN's double backward) against the CPU's on the same
     draws; DU-GAN's step with both CutMix coins forced on, then off;
     ``MTDGANModel.discriminate_full`` on one 512x512 slice; no launch of
     K1 - K8 on any of these paths; each model's forward at 512x512, batch
     8 (the transformers through the sliding window at overlap 0.3), and
     train step on 160 patches (Restormer's on 32) timed; a profile of
     Restormer's sliding-window forward.
  29. the diffusion family (run right after phase 28; its own random
     data, so the later phases draw what they drew before): the UNet at its
     published width (channels (128, 256, 256), attention at levels 1 - 2,
     one head of 256 channels), random weights from seed 0. One UNet
     forward at 512x512, batch 1 (65,536 tokens at level 1, the plain
     chunked attention), beside its FLOPs (counted by ``FlopCounterMode`` on
     the meta device); a 10-step DDPM segment at 512x512 (not a whole
     1000-step sample, >= ~245 s); whole 50-step DDIM, DPM and PNDM samples
     at 256x256; a train step on 160 x 64x64 patches and its peak memory;
     a validation chunk (the UNet at 64x64, batch 32 and 17, and a 50-step
     sample of 32 tiles, with a profile of the forward); the ``train`` CLI
     (one DDIM epoch of 2 steps of 20 256x256 slices, validation of one
     slice through the sliding window) and ``test --resume`` on 2 slices; at 64x64 on drawn weights, the card against the CPU: one UNet
     forward, a 3-step chain of each sampler from the same draws, one
     loss and its gradient; no launch of K1 - K8 on any of these paths.
Phases 1 - 25, 27 - 29 pass ``--no-feature-metrics`` to the test CLI, so
their series stay comparable. TF32 is off for every plain PyTorch op (cuDNN
convs, matmuls), so both sides compute in fp32.
"""

from __future__ import annotations

import copy
import csv
import json
import math
import os
import re
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mtd_gan_tpu_torch import bench
from mtd_gan_tpu_torch import test as test_cli
from mtd_gan_tpu_torch import train as train_cli
from mtd_gan_tpu_torch.bench import block_work as k1_work
from mtd_gan_tpu_torch.data import native
from mtd_gan_tpu_torch.data.dicom import get_pixels_hu, write_synthetic_dicom
from mtd_gan_tpu_torch.data.pipeline import PairedDicomDataset
from mtd_gan_tpu_torch.data.transforms import make_train_preprocess
from mtd_gan_tpu_torch.engine import gan
from mtd_gan_tpu_torch.engine.gan import MTDGANTrainer
from mtd_gan_tpu_torch.engine.loops import TR_VALID, build_trainer, family_of
from mtd_gan_tpu_torch.features import registry
from mtd_gan_tpu_torch.features.inception import inception_pool3_features
from mtd_gan_tpu_torch.features.vgg import VGG19_CFG, VGG_SLICE_ENDS
from mtd_gan_tpu_torch.metrics import fid as fid_lib
from mtd_gan_tpu_torch.metrics import perceptual
from mtd_gan_tpu_torch.models.dugan import CutMix
from mtd_gan_tpu_torch.models.mtd_gan import (MTDGANModel, ResFFTGenerator,
                                              share_parameters)
from mtd_gan_tpu_torch.models.wgan_vgg import WGANVGGModel, wgan_gradient_penalty
from mtd_gan_tpu_torch.ops import _build, cuda_train
from mtd_gan_tpu_torch.ops.cuda_staged import (conv3x3, conv3x3_reference, irdft_w_add,
                                               irdft_w_add_reference, rdft_w,
                                               rdft_w_reference, spectral_mix_h,
                                               spectral_mix_h_reference)
from mtd_gan_tpu_torch.ops.cuda_fftconv import (spectral_branch_fused,
                                                spectral_branch_fused_reference,
                                                spectral_branch_tiled,
                                                spectral_branch_tiled_reference)
from mtd_gan_tpu_torch.ops.cuda_pipeline import (_device_twiddles, block_fused,
                                               block_fused_reference)
from mtd_gan_tpu_torch.ops.cuda_train import (block_bwd, block_bwd_reference,
                                              resfft_generator_train)
from mtd_gan_tpu_torch.mto.methods import METHODS, MTOState
from mtd_gan_tpu_torch.ops.fft_conv import fft_conv_block
from mtd_gan_tpu_torch.ops.sliding_window import dense_patch_positions, sliding_window_inference
from mtd_gan_tpu_torch.ops.upsample import upsample2x_bilinear
from mtd_gan_tpu_torch.utils.artifacts import save_png_gray
from mtd_gan_tpu_torch.models import get_model
from mtd_gan_tpu_torch.models.diffusion.schedulers import DDPMScheduler
from mtd_gan_tpu_torch.models.diffusion.unet import DiffusionUNet
from mtd_gan_tpu_torch.models.diffusion.wrappers import (DDIMModel, DDPMModel, DPMModel,
                                                        PNDMModel)
from mtd_gan_tpu_torch.utils.checkpoint import load_checkpoint, load_pretrained

# max |kernel - plain| / max |plain| per block call: both sides are fp32
# quality (K1's convs in 3xTF32); they differ by FFT algorithm (radix
# steps in shared memory vs cuFFT) and summation order, ~1e-6 relative
TOL_BLOCK_REL = 1e-4
# max |kernel - plain| / max |plain| per K8 or K7 call: fp32 both sides,
# mixed-radix FFTs in shared memory against cuFFT (other order of summation)
TOL_SPECTRAL_REL = 1e-4
# max |kernel - plain| on the [0, 1] generator output after 21 blocks
TOL_GENERATE_ABS = 1e-3
# K2 against autograd through K1's plain version, per output. With
# sign-certain masks ("margin" inputs): max |kernel - plain| / max |plain|,
# fp32 both sides (against the plain version in float64 on an H100, K2
# reads up to 2.5e-6 and the fp32 plain version up to 1.3e-5:
# k2_accuracy). Otherwise a pre-activation within fp32 rounding of zero
# can fall on the other side of its ReLU in one version: a flipped spectral
# mask moves one row of dmix and all of xbar by ~1e-3 (up to 4.3e-3 in the
# 2-norm on an H100 at batch 8, ~1e-6 without a flip), so those inputs are
# held in the relative 2-norm
TOL_BWD_MARGIN_REL = 1e-4
TOL_BWD_L2 = 1e-2
# one train step from one state: the generator gradient through K1 + K2
# against the plain generator under autograd (the same cotangent of fake
# pulled through both), per leaf in the relative 2-norm (the max-norm is
# printed beside it), and the stacked D losses. The same ReLU-boundary
# flips happen in 21 blocks x 160 patches: one flipped spectral mask moves
# a spectral bias gradient (a sum of 160 x 64 x 33 terms) by ~1/sqrt(338k)
# = 1.7e-3 of its size, so 1e-3 is not reachable between two fp32 orders
# of summation (PERF.md, Findings)
TOL_STEP_GRAD_L2 = 1e-2
TOL_STEP_DLOSS_REL = 1e-4
# an MTO method's combined D gradient, over every leaf the method gives
# one, 2-norm relative, against the same combine_grads in float64 on the
# same per-task gradients: both take the Gram matrix and the solve in
# float64, so what differs is the fp32 weighted sum on the card (held in
# the 2-norm, not by the weights: IMTL's and NashMTL's weights span up to
# ten decades, and the largest would hide an error in the others)
TOL_MTO = 1e-5
# phase 26: the VGG19 slice features, PL and TML per slice (max |card -
# cpu| / max |cpu|, per value for PL and TML) and the Inception pool3
# features (relative 2-norm) on the card in fp32 (TF32 off) against the same
# port functions on the CPU in float64; the FID math on the host fed the
# card's features against the same math fed the float64 ones (relative, on
# input-vs-gt and pred-vs-gt; gt-vs-gt is rounding noise on both sides)
TOL_FEATURES_REL = 1e-4
TOL_FID_REL = 1e-4
# phase 27: the card's forward of a CNN-family or REDCNN-generator model
# against the CPU forward of the same weights, max abs on the [0, 1]-scale
# output: both fp32 (cuDNN's TF32 off), the same convs summed in other
# orders (the ResFFT ablation's generate is held to TOL_GENERATE_ABS, its
# K1 route's tolerance)
TOL_FAMILY_ABS = 1e-4
# published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, dense TF32 on the tensor cores and HBM3 bandwidth; the C -> C
# convs of K1 and K3 run three TF32 products (3xTF32) on the tensor cores,
# everything else fp32 on the CUDA cores
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = bench.PEAK_TF32_FLOPS
PEAK_HBM_BYTES = 3.35e12

C = 32
VARIANTS = ("plain", "pre", "pre+skip", "pre+skip+post")
TILED_SHAPES = ((192, 192), (320, 320), (384, 384), (448, 448), (512, 320), (768, 768))
# K7 at C = 32, then one C = 8 shape; 97 and 127 are prime
FUSED_SHAPES = tuple((32, hw) for hw in ((32, 32), (64, 64), (96, 96), (100, 72),
                                         (97, 66), (127, 127), (128, 128))) + ((8, (33, 27)),)
# K3 at the generators' sizes; K4 - K6 at the staged route's sizes (449 is
# prime; 200 and 800 have the odd factor 25), each at C = 32 and C = 8
K3_SHAPES = ((448, 448), (96, 96), (200, 200), (1024, 1024), (449, 130), (448, 449))
# odd H with a tail block of fewer than 16 rows: 101 (W = 1024 reads its
# rows in K4's first radix step), 33 (W = 200 is staged first). K5's odd
# step by H: none at 1024 and 2; in registers at 448 (dense, Q = 7), 200
# and 800 (Q = 25 as 5 x 5; 800 and 1024 on a 2-CTA cluster at C = 32);
# in two buffers at 130 (Q = 65), 101, 33, 449 (a 2-CTA cluster at C = 32)
# and 1000 (Q = 125, a 4-CTA cluster at C = 32)
STAGED_SHAPES = ((1024, 1024), (800, 800), (200, 200), (130, 64), (448, 449), (2, 2),
                 (101, 1024), (33, 200), (449, 130), (1000, 64))
# the launch counts the main paths are held to, by kernel
COUNTED = {"K1": block_fused, "K2": block_bwd, "K8": spectral_branch_tiled,
           "K7": spectral_branch_fused, "K3": conv3x3, "K4": rdft_w,
           "K5": spectral_mix_h, "K6": irdft_w_add}
# K3's launches on its tensor-core path, counted beside COUNTED
K3_TC = "K3tc"
# one generate call on the tiled, fused or staged route: 42 K3 (10 encoder,
# 21 residual, 10 decoder convs and the exit deconv; all but the C -> 1
# exit deconv on the tensor cores) besides its spectral kernel; the staged
# route's spectral branch is 21 each of K4, K5 and K6
K3_PER_CALL = {"K3": 42, K3_TC: 41}
STAGED_PER_CALL = {**K3_PER_CALL, "K4": 21, "K5": 21, "K6": 21}
TRAIN_SLICES, CROPS = 20, 8  # reference batch: 20 slices x 8 crops = 160 patches
# phase 27: each model at its full width, and the slices of a `full`
# (whole 512x512 slice) RED-CNN step: 8 of the 20 a patch step takes, for
# the activations of 96 channels at 512^2
FULL_WIDTH = {"gen_features": C, "disc_features": 64, "num_layers": 10}
FAMILY_MODELS = (("RED_CNN", {"out_ch": 96}), ("EDCNN", {"out_ch": 32, "sobel_ch": 32}),
                 ("Ablation_CLS_SEG_REC_NDS_RC", FULL_WIDTH),
                 ("Ablation_CLS_SEG_REC_NDS_RC_ResFFT", FULL_WIDTH))
RESFFT_ABLATION = "Ablation_CLS_SEG_REC_NDS_RC_ResFFT"
FULL_SLICES = 8
# phase 28: the WGAN and transformer families at their published widths
# (the constructors' defaults; WGAN-VGG's perceptual loss on the registry's
# VGG19), and the 512x512 slices the tr family's test sweep takes at its
# overlap of 0.9 (5776 tiles of 64x64 a slice)
NEW_FAMILY_MODELS = ("WGAN_VGG", "MAP_NN", "DU_GAN", "CTformer", "Restormer")
TR_SWEEP_SLICES = {"CTformer": 8, "Restormer": 2}
# Restormer's train step on 160 64x64 patches (20 slices) needs more than
# the card's 80 GB in fp32 (its activations at full width, ~0.5 GB a
# patch): its train CLI takes 4 slices a step (32 patches), its timed step
# those 32
RESTORMER_TRAIN_SLICES = 4
# phase 28: the card's forward of a trained model against the CPU's on the
# same weights, max abs on the [0, 1]-scale output (CTformer's and
# Restormer's through the sliding window): fp32 both sides (TF32 off), the
# same ops summed in other orders
TOL_NEW_FAMILY_ABS = 1e-4
# the gradient penalty on the card against the CPU on the same draws
# (relative), and its gradient w.r.t. each critic leaf (relative 2-norm;
# the max-norm printed beside it): cuDNN's double backward in fp32 against
# the CPU's. The gradient's error depends on the algorithms cuDNN picks on
# the card: 4.4e-6, 6.4e-5 and 2.4e-4 in three calls on three H100s
TOL_GP_REL = 1e-4
TOL_GP_GRAD_L2 = 1e-3
# phase 29: the diffusion family. The card against the CPU on the same
# drawn weights and draws: one UNet forward (max-relative), a 3-step chain of
# each sampler (max-relative on the sample: a step divides x0's error by
# sqrt(acp_t), up to ~7x at t = 666), the loss (relative) and its gradient
# (each leaf's relative 2-norm; ``to_k.bias``, whose gradient is zero in
# exact arithmetic, against its weight's gradient)
TOL_DN_FORWARD_REL = 1e-4
TOL_DN_CHAIN_REL = 1e-3
TOL_DN_LOSS_REL = 1e-4
TOL_DN_GRAD_L2 = 1e-3
DN_CLI_SIZE = 256
DN_SEGMENT_STEPS = 10


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def block_inputs(size: int, n: int, init: str, variant: str, seed: int, c: int = C):
    """Seeded K1 inputs on the GPU at C = ``c``. ``init``: "reference"
    (N(0, 0.01) weights, zero biases) or "fan_in" (std 1/sqrt(fan_in),
    biases 0.1)."""
    rng = np.random.default_rng(seed)
    hw = size * size

    def weight(*shape):
        fan_in = int(np.prod(shape[1:]))
        std = 0.01 if init == "reference" else 1.0 / math.sqrt(fan_in)
        return rng.standard_normal(shape) * std

    def bias(k):
        return np.zeros(k) if init == "reference" else rng.standard_normal(k) * 0.1

    t = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda").contiguous()
    args = dict(x=t(rng.random((n, c, hw))), h=size, w=size,
                km=t(weight(c, c, 3, 3)), kb=t(bias(c)),
                mix=t(weight(2 * c, 2 * c)), mb=t(bias(2 * c)))
    if variant != "plain":
        args["pre"] = (t(weight(c, c, 3, 3)), t(bias(c)))
    if "skip" in variant:
        args["skip"] = t(rng.standard_normal((n, c, hw)) * 0.5)
    if "post" in variant:
        args["post"] = (t(weight(1, c, 3, 3)), t(bias(1)))
        args["img"] = t(rng.random((n, 1, hw)))
    return args


def bwd_inputs(n: int, init: str, variant: str, seed: int, c: int = C):
    """K1's inputs at 64x64 plus seeded cotangents g (of out) and gfin (of
    final). ``init`` "margin": 1/sqrt(fan_in) weights (the res and post convs
    x0.05) and every bias +-5, so each ReLU keeps its sign far from zero."""
    args = block_inputs(64, n, "reference" if init == "reference" else "fan_in",
                        variant, seed, c)
    rng = np.random.default_rng(seed + 100)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda").contiguous()
    if init == "margin":
        signed = lambda b: t(5.0 * rng.choice([-1.0, 1.0], tuple(b.shape)))
        # the res and post convs read activations of size ~5 (after a
        # pre conv with a +5 bias): shrink their weights so that each bias
        # still dominates its pre-activation
        args.update(km=args["km"] * 0.05, kb=signed(args["kb"]), mb=signed(args["mb"]))
        if "pre" in args:
            args["pre"] = (args["pre"][0], signed(args["pre"][1]))
        if "post" in args:
            args["post"] = (args["post"][0] * 0.05, signed(args["post"][1]))
    args["g"] = t(rng.standard_normal((n, c, 64 * 64)))
    if "post" in variant:
        args["gfin"] = t(rng.standard_normal((n, 1, 64 * 64)))
    return args


def check_k2_recompute():
    """Phase 17: the forward K2 recomputes is K1's, bit for bit: its hin
    against K1's pre conv output (every variant with pre), its out against
    K1's out (pre+skip+post), at C = 8 and 32, batch 2 and 8."""
    for c in (8, C):
        for n in (2, 8):
            for vi, variant in enumerate(VARIANTS[1:], start=1):
                args = bwd_inputs(n, "fan_in", variant, seed=vi, c=c)
                fwd = {k: v for k, v in args.items() if k not in ("g", "gfin")}
                k1, k2 = {}, {}
                out = as_tuple(block_fused(**fwd, scratch=k1))[0]
                block_bwd(**args, scratch=k2)
                torch.cuda.synchronize()
                pairs = [("hin", k2["hin"], k1["hin"])]
                if "post" in variant:
                    pairs.append(("out", k2["out"], out))
                parts = []
                for name, a, b in pairs:
                    same = torch.equal(a, b)
                    parts.append(f"{name} {'equal' if same else 'DIFFERS'} (max abs "
                                 f"{(a - b).abs().max().item():.3e})")
                    if not same:
                        fail(f"K2 recompute C={c} n={n} {variant}: {name} is not K1's")
                print(f"K2 recompute vs K1 64x64 C={c} n={n} {variant:14s}: "
                      + "; ".join(parts), flush=True)


def check_k2():
    """Phase 17; returns the largest absolute error of the margin checks
    (the ones no mask flip can disturb). Batch 2 and 8 give each block of
    the weight-gradient and column launches one band or one bin; batch 160,
    the train step's, gives each about 10 bands and 20 bins."""
    worst_margin_abs = 0.0
    for n in (2, 8, 160):
        for init in ("reference", "fan_in", "margin"):
            for vi, variant in enumerate(VARIANTS):
                if n == 160 and (init == "reference" or variant not in VARIANTS[2:]):
                    continue
                args = bwd_inputs(n, init, variant, seed=vi)
                got = block_bwd(**args)
                want = block_bwd_reference(**args)
                torch.cuda.synchronize()
                parts = []
                for name, w in want.items():
                    g = got[name]
                    if not torch.isfinite(g).all():
                        fail(f"K2 n={n} {init} {variant}: non-finite {name}")
                    d = g - w
                    err = d.abs().max().item()
                    rel = err / max(w.abs().max().item(), 1e-30)
                    l2 = (d.norm() / w.norm().clamp_min(1e-30)).item()
                    parts.append(f"{name} {err:.2e}/{rel:.2e}/{l2:.2e}")
                    if init == "margin":
                        worst_margin_abs = max(worst_margin_abs, err)
                        if rel > TOL_BWD_MARGIN_REL:
                            fail(f"K2 n={n} margin {variant} {name}: relative error "
                                 f"{rel:.3e} > {TOL_BWD_MARGIN_REL}")
                    elif l2 > TOL_BWD_L2:
                        fail(f"K2 n={n} {init} {variant} {name}: relative 2-norm "
                             f"error {l2:.3e} > {TOL_BWD_L2}")
                print(f"K2 check 64x64 C={C} n={n} {init:9s} {variant:14s} "
                      f"(max_abs/max_rel/l2_rel): " + "; ".join(parts), flush=True)
    return worst_margin_abs


def as_float64(args):
    """``args`` with every tensor (and every tensor of a tuple) in float64."""
    wide = lambda v: v.double() if torch.is_tensor(v) else v
    return {k: tuple(map(wide, v)) if isinstance(v, tuple) else wide(v)
            for k, v in args.items()}


def k2_accuracy():
    """Phase 17: K2 and the fp32 plain version against the plain version in
    float64 on margin inputs (pre+skip), at batch 8 and 160; K2 with the
    wrapper's persistent launches and with one block per band and per bin
    (so that no accumulator runs over more than one band or bin). Per
    output max |err| / max |float64|; K2's held to TOL_BWD_MARGIN_REL."""
    per_unit = lambda n, h, k: (n * (h // cuda_train._WGRAD_ROWS), n * k)
    for n in (8, 160):
        args = bwd_inputs(n, "margin", "pre+skip", seed=2)
        want = block_bwd_reference(**as_float64(args))
        runs = {"K2": block_bwd(**args)}
        geometry = cuda_train._launch_geometry
        cuda_train._launch_geometry = per_unit
        try:
            runs["K2 one unit per block"] = block_bwd(**args)
        finally:
            cuda_train._launch_geometry = geometry
        runs["plain fp32"] = block_bwd_reference(**args)
        torch.cuda.synchronize()
        blocks = geometry(n, 64, 33)
        for label, got in runs.items():
            errs = {name: ((got[name].double() - w).abs().max()
                           / w.abs().max().clamp_min(1e-300)).item()
                    for name, w in want.items()}
            print(f"K2 accuracy 64x64 C={C} n={n} margin pre+skip {label} (blocks "
                  f"{per_unit(n, 64, 33) if 'unit' in label else blocks}) against "
                  f"float64, max_rel: " + "; ".join(f"{k} {v:.2e}" for k, v in errs.items()),
                  flush=True)
            worst = max(errs.values())
            if label == "K2" and worst > TOL_BWD_MARGIN_REL:
                fail(f"K2 n={n} margin pre+skip: relative error {worst:.3e} against "
                     f"float64 > {TOL_BWD_MARGIN_REL}")
        del args, want, runs


def as_tuple(r):
    return r if isinstance(r, tuple) else (r,)


def check_kernel():
    """Phase 3; returns the largest absolute error seen."""
    worst_abs = 0.0
    for size in (64, 128, 256, 512):
        for init in ("reference", "fan_in"):
            for vi, variant in enumerate(VARIANTS):
                args = block_inputs(size, 2, init, variant, seed=vi)
                got = as_tuple(block_fused(**args))
                want = as_tuple(block_fused_reference(**args))
                torch.cuda.synchronize()
                for name, g, r in zip(("out", "final"), got, want):
                    if not torch.isfinite(g).all():
                        fail(f"K1 {size}^2 {init} {variant}: non-finite {name}")
                    err = (g - r).abs().max().item()
                    rel = err / max(r.abs().max().item(), 1e-30)
                    worst_abs = max(worst_abs, err)
                    print(f"K1 check {size}x{size} C={C} n=2 {init:9s} "
                          f"{variant:14s} {name:5s}: max_abs {err:.3e} "
                          f"rel {rel:.3e}", flush=True)
                    if rel > TOL_BLOCK_REL:
                        fail(f"K1 {size}^2 {init} {variant} {name}: relative "
                             f"error {rel:.3e} > {TOL_BLOCK_REL}")
    return worst_abs


def expect_raise(label: str, fn):
    """Fail unless ``fn()`` raises ValueError (with gradients enabled)."""
    try:
        with torch.enable_grad():
            fn()
    except ValueError as e:
        print(f"{label} raises: {e}", flush=True)
    else:
        fail(f"{label} did not raise")


def tiled_inputs(n: int, h: int, w: int, init: str, seed: int, c: int = C):
    """Seeded spectral-branch inputs (NCHW) on the GPU. ``init``:
    "reference" (N(0, 0.01) mix, zero bias) or "fan_in" (std 1/sqrt(2C),
    bias 0.1); the residual N(0, 0.5)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda").contiguous()
    std = 0.01 if init == "reference" else 1.0 / math.sqrt(2 * c)
    bias = np.zeros(2 * c) if init == "reference" else rng.standard_normal(2 * c) * 0.1
    return dict(x=t(rng.random((n, c, h, w))),
                mix=t(rng.standard_normal((2 * c, 2 * c)) * std), bias=t(bias),
                residual=t(rng.standard_normal((n, c, h, w)) * 0.5))


def hold_spectral(name: str, kernel, reference, cases) -> float:
    """Hold a spectral-branch kernel (K8 or K7) against its plain version
    and against a second call of itself (bit for bit), one launch per
    call, at each (c, (h, w), seed) of ``cases``, batch 2, both inits, with
    and without the residual; returns the largest absolute error seen."""
    worst_abs = 0.0
    for c, (h, w), seed in cases:
        for init in ("reference", "fan_in"):
            args = tiled_inputs(2, h, w, init, seed=seed, c=c)
            for with_res in (False, True):
                call = dict(args) if with_res else {**args, "residual": None}
                before = kernel.launches
                got = kernel(**call)
                again = kernel(**call)
                torch.cuda.synchronize()
                label = f"{name} {h}x{w} C={c} {init} residual={with_res}"
                if kernel.launches != before + 2:
                    fail(f"{label}: {kernel.launches - before} launches for 2 calls")
                want = reference(**call)
                if not torch.isfinite(got).all():
                    fail(f"{label}: non-finite output")
                if not torch.equal(got, again):
                    fail(f"{label}: two calls differ")
                err = (got - want).abs().max().item()
                rel = err / max(want.abs().max().item(), 1e-30)
                worst_abs = max(worst_abs, err)
                print(f"{name} check {h}x{w} C={c} n=2 {init:9s} residual={with_res!s:5s}: "
                      f"max_abs {err:.3e} rel {rel:.3e}, two calls bit for bit", flush=True)
                if rel > TOL_SPECTRAL_REL:
                    fail(f"{label}: relative error {rel:.3e} > {TOL_SPECTRAL_REL}")
    return worst_abs


def check_k8():
    """Phase 6; returns the largest absolute error seen."""
    worst_abs = hold_spectral("K8", spectral_branch_tiled, spectral_branch_tiled_reference,
                              [(c, hw, si) for c in (C, 8)
                               for si, hw in enumerate(TILED_SHAPES)])
    for label, call in (
            ("H = 100", {**tiled_inputs(1, 64, 64, "fan_in", 0),
                         "x": torch.zeros((1, C, 100, 100), device="cuda"),
                         "residual": None}),
            ("C = 24", {"x": torch.zeros((1, 24, 64, 64), device="cuda"),
                        "mix": torch.zeros((48, 48), device="cuda"),
                        "bias": torch.zeros(48, device="cuda")})):
        expect_raise(f"K8 with {label}", lambda: spectral_branch_tiled(**call))
    return worst_abs


def check_k7():
    """Phase 9; returns the largest absolute error seen."""
    worst_abs = hold_spectral("K7", spectral_branch_fused, spectral_branch_fused_reference,
                              [(c, hw, si) for si, (c, hw) in enumerate(FUSED_SHAPES)])
    x, mix, bias = (tiled_inputs(1, 64, 64, "fan_in", 0)[k] for k in ("x", "mix", "bias"))
    zeros = lambda *shape: torch.zeros(shape, device="cuda")
    for label, call in (
            ("H = 129", (zeros(1, C, 129, 64), mix, bias)),
            ("C = 24", (zeros(1, 24, 64, 64), zeros(48, 48), zeros(48))),
            ("a residual of another shape", (x, mix, bias, zeros(1, C, 64, 32))),
            ("mix.requires_grad", (x, mix.clone().requires_grad_(), bias))):
        expect_raise(f"K7 with {label}", lambda: spectral_branch_fused(*call))
    return worst_abs


def count_adds(fn) -> int:
    """The ``aten::add`` calls of one call of ``fn`` (torch.profiler, CPU
    side)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.name in ("aten::add", "aten::add_"))


def k3_calls(n: int, h: int, w: int, init: str, seed: int):
    """The K3 calls of the generators at one shape, by epilogue: ``(args,
    keywords)`` on seeded GPU tensors (``init`` as :func:`block_inputs`)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda").contiguous()
    std = 0.01 if init == "reference" else 1.0 / math.sqrt(9 * C)
    bias = lambda k: t(np.zeros(k) if init == "reference" else rng.standard_normal(k) * 0.1)
    x = t(rng.random((n, C, h, w)))
    wt, b = t(rng.standard_normal((C, C, 3, 3)) * std), bias(C)
    skip = t(rng.standard_normal((n, C, h, w)) * 0.5)
    w1, b1 = t(rng.standard_normal((C, 1, 3, 3)) * std), bias(1)
    img = t(rng.random((n, 1, h, w)))
    return {"plain": ((x, wt, b), dict(relu=False)),
            "relu": ((x, wt, b), dict()),
            "skip+relu": ((x, wt, b), dict(skip=skip)),
            "relu+residual": ((x, wt, b), dict(residual=True)),
            "deconv+skip+relu": ((x, wt, b), dict(skip=skip, transpose=True)),
            "exit deconv C->1": ((x, w1, b1), dict(skip=img, transpose=True))}


def check_k3():
    """Phase 12; returns the largest absolute error seen."""
    worst_abs = 0.0
    for si, (h, w) in enumerate(K3_SHAPES):
        for init in ("reference", "fan_in"):
            for label, (args, kw) in k3_calls(2, h, w, init, seed=si).items():
                before = (conv3x3.launches, conv3x3.launches_tc)
                got = conv3x3(*args, **kw)
                torch.cuda.synchronize()
                # every call at C = 32 takes the tensor cores but the exit
                # deconv (C_out = 1), which takes the direct path
                tc = 0 if label.startswith("exit") else 1
                if (conv3x3.launches - before[0], conv3x3.launches_tc - before[1]) != (1, tc):
                    fail(f"K3 {h}x{w} {label}: {conv3x3.launches - before[0]} launches, "
                         f"{conv3x3.launches_tc - before[1]} on the tensor cores, "
                         f"expected 1 and {tc}")
                want = conv3x3_reference(*args, **kw)
                if not torch.isfinite(got).all():
                    fail(f"K3 {h}x{w} {init} {label}: non-finite output")
                err = (got - want).abs().max().item()
                rel = err / max(want.abs().max().item(), 1e-30)
                worst_abs = max(worst_abs, err)
                print(f"K3 check {h}x{w} C={C} n=2 {init:9s} {label:16s} "
                      f"({'tensor cores' if tc else 'direct'}): max_abs {err:.3e} "
                      f"rel {rel:.3e}", flush=True)
                if rel > TOL_SPECTRAL_REL:
                    fail(f"K3 {h}x{w} {init} {label}: relative error {rel:.3e} > "
                         f"{TOL_SPECTRAL_REL}")
    calls = k3_calls(1, 64, 64, "fan_in", 0)
    (x, wt, b), _ = calls["plain"]
    w1 = calls["exit deconv C->1"][0][1]
    expect_raise("K3 with C_out = 12", lambda: conv3x3(x, wt[:12], b[:12]))
    expect_raise("K3 residual with C_in != C_out",
                 lambda: conv3x3(x, w1, None, transpose=True, residual=True))
    expect_raise("K3 with weight.requires_grad",
                 lambda: conv3x3(x, wt.clone().requires_grad_(), b))
    return worst_abs


def count_tensor_core_instructions(label: str, lib_path) -> None:
    """Count the tensor-core instructions in a built library (K3's, K1's, K2's)
    with ``cuobjdump -sass``, where the toolkit has it; fail if there is
    none."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump") or (
        os.path.join(CUDA_HOME, "bin", "cuobjdump") if CUDA_HOME else None)
    if not tool or not os.path.exists(tool):
        print(f"{label} SASS: cuobjdump not found (not counted)", flush=True)
        return
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    hmma, hgmma = (len(re.findall(rf"\b{op}\b", sass)) for op in ("HMMA", "HGMMA"))
    print(f"{label} SASS ({lib_path.name}): {hmma} HMMA, {hgmma} HGMMA instructions",
          flush=True)
    if hmma + hgmma == 0:
        fail(f"{label}'s library holds no tensor-core instruction (HMMA / HGMMA)")


def k6_in_place(lib, z, inout):
    """K6 as K1 calls it: the C entry with the residual as its output, the
    sum written over the residual (no wrapper, so no launch is counted)."""
    n, c, h, w = inout.shape
    err = lib.staged_irdft_w_add(z.data_ptr(), inout.data_ptr(), n, c, h, w,
                                 _device_twiddles(w, inout.device).data_ptr(),
                                 inout.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        fail(f"K6 in place {h}x{w}: CUDA error {err}")
    return inout


# the branch of K5's odd step by the library's code (staged_mix_odd_branch)
K5_BRANCHES = ("none", "in registers", "in two buffers")


def check_staged(lib):
    """Phase 13: K4, K5 and K6 each against its plain version, each fed the
    plain version's input of the stage before, K5 also against a second
    call of itself; returns the largest absolute error of each."""
    worst = {"K4": 0.0, "K5": 0.0, "K6": 0.0}
    for c in (C, 8):
        for si, (h, w) in enumerate(STAGED_SHAPES):
            for init in ("reference", "fan_in"):
                a = tiled_inputs(2, h, w, init, seed=si, c=c)
                before = [COUNTED[k].launches for k in worst]
                zr = rdft_w_reference(a["x"])
                tr = spectral_mix_h_reference(zr, a["mix"], a["bias"])
                k6_want = irdft_w_add_reference(tr, a["residual"])
                inout = a["residual"].clone()
                k5 = spectral_mix_h(zr.clone(), a["mix"], a["bias"])
                outs = {"K4": (rdft_w(a["x"]), zr),
                        "K5": (k5, tr),
                        "K6": (irdft_w_add(tr, a["residual"]), k6_want),
                        "K6 in place": (k6_in_place(lib, tr, inout), k6_want)}
                torch.cuda.synchronize()
                if [COUNTED[k].launches - b for k, b in zip(worst, before)] != [1, 1, 1]:
                    fail(f"K4-K6 {h}x{w}: not one launch each")
                if not torch.equal(k5, spectral_mix_h(zr.clone(), a["mix"], a["bias"])):
                    fail(f"K5 {h}x{w} C={c} {init}: two calls differ")
                parts = []
                for name, (got, want) in outs.items():
                    got, want = (torch.view_as_real(t) if t.is_complex() else t
                                 for t in (got, want))
                    if not torch.isfinite(got).all():
                        fail(f"{name} {h}x{w} C={c} {init}: non-finite output")
                    err = (got - want).abs().max().item()
                    rel = err / max(want.abs().max().item(), 1e-30)
                    worst[name[:2]] = max(worst[name[:2]], err)
                    parts.append(f"{name} {err:.3e}/{rel:.3e}")
                    if rel > TOL_SPECTRAL_REL:
                        fail(f"{name} {h}x{w} C={c} {init}: relative error {rel:.3e} "
                             f"> {TOL_SPECTRAL_REL}")
                print(f"K4-K6 check {h}x{w} C={c} n=2 {init:9s} (K5: odd step "
                      f"{K5_BRANCHES[lib.staged_mix_odd_branch(h)]}, cluster of "
                      f"{lib.staged_mix_cluster_size(c, h)}, two calls bit for bit; "
                      f"max_abs/rel): " + "; ".join(parts), flush=True)
    a = tiled_inputs(1, 64, 64, "fan_in", 0)
    z = rdft_w(a["x"])
    zeros = lambda *shape, **kw: torch.zeros(shape, device="cuda", **kw)
    expect_raise("K4 with C = 24", lambda: rdft_w(zeros(1, 24, 64, 64)))
    expect_raise("K4 with H = 1025", lambda: rdft_w(zeros(1, C, 1025, 64)))
    expect_raise("K5 with H = 1025", lambda: spectral_mix_h(
        zeros(1, C, 33, 1025, dtype=torch.complex64), a["mix"], a["bias"]))
    expect_raise("K5 with C = 24", lambda: spectral_mix_h(
        zeros(1, 24, 33, 64, dtype=torch.complex64), zeros(48, 48), zeros(48)))
    expect_raise("K5 with mix.requires_grad", lambda: spectral_mix_h(
        z, a["mix"].clone().requires_grad_(), a["bias"]))
    expect_raise("K6 with W = 1025", lambda: irdft_w_add(
        zeros(1, C, 513, 64, dtype=torch.complex64), zeros(1, C, 64, 1025)))
    expect_raise("K6 with res.requires_grad", lambda: irdft_w_add(
        z, a["residual"].clone().requires_grad_()))
    return worst


def check_plain_route(label: str, features: int, num_layers: int, x):
    """F1: ``generate`` on a route no kernel takes runs the plain module on
    the card with no kernel launch, within TOL_GENERATE_ABS of the same
    module on the CPU."""
    model = MTDGANModel(gen_features=features, num_layers=num_layers, device="cuda",
                        seed=0)
    cpu = MTDGANModel(gen_features=features, num_layers=num_layers, device="cpu", seed=0)
    zero_counts()
    pred = model.generate(x)
    torch.cuda.synchronize()
    counts = read_counts()
    want = cpu.generate(x.cpu())
    if pred.shape != x.shape or not torch.isfinite(pred).all():
        fail(f"{label}: output {tuple(pred.shape)} not finite/expected")
    err = (pred.cpu() - want).abs().max().item()
    print(f"{label} (plain route, {features} features, {num_layers} layers): max_abs "
          f"vs the CPU module {err:.3e} (tol {TOL_GENERATE_ABS}); launches {counts}",
          flush=True)
    expect_counts(label, counts, {})
    if err > TOL_GENERATE_ABS:
        fail(f"{label}: error {err:.3e} > {TOL_GENERATE_ABS}")


def check_train_width64(x, y):
    """F2: a train step at gen_features=64 (outside K1's and K2's widths)
    runs the plain generator under autograd: no kernel launch, finite
    losses."""
    model = MTDGANModel(gen_features=64, disc_features=64, num_layers=10, device="cuda",
                        seed=0)
    trainer = MTDGANTrainer(model, method="pcgrad", seed=0)
    zero_counts()
    m = trainer.train_step(x, y)
    torch.cuda.synchronize()
    counts = read_counts()
    d, g = m["d_loss"].item(), m["g_loss"].item()
    print(f"train step at gen_features=64 ({x.shape[0]} patches): d_loss {d:.6f} "
          f"g_loss {g:.6f}; launches {counts}", flush=True)
    expect_counts("train step at gen_features=64", counts, {})
    if not (math.isfinite(d) and math.isfinite(g)):
        fail(f"train step at gen_features=64: non-finite losses {d}, {g}")


def zero_counts():
    for fn in COUNTED.values():
        fn.launches = 0
    conv3x3.launches_tc = 0


def read_counts():
    return {**{name: fn.launches for name, fn in COUNTED.items()},
            K3_TC: conv3x3.launches_tc}


def expect_counts(label: str, got, want):
    """Fail unless the launch counts ``got`` equal ``want`` (every kernel
    not named in ``want`` must not have launched)."""
    want = {name: want.get(name, 0) for name in list(COUNTED) + [K3_TC]}
    if got != want:
        fail(f"{label}: launches {got}, expected {want}")


def check_generate(model, x, route: str, want):
    """``generate`` on ``x`` against the plain module; the launch counts
    zeroed just before the call and read just after must equal ``want``."""
    n, h, w, _ = x.shape
    zero_counts()
    pred = model.generate(x)
    torch.cuda.synchronize()
    counts = read_counts()
    with torch.no_grad():
        plain = plain_forward(model.generator, x)
    if pred.shape != x.shape or not torch.isfinite(pred).all():
        fail(f"generate {h}x{w} output {tuple(pred.shape)} not finite/expected")
    err = (pred - plain).abs().max().item()
    print(f"generate {h}x{w} batch {n} (21 blocks, {route}): max_abs vs plain module "
          f"{err:.3e} (tol {TOL_GENERATE_ABS}); launches {counts}", flush=True)
    expect_counts(f"generate {h}x{w}", counts, want)
    if err > TOL_GENERATE_ABS:
        fail(f"generate {h}x{w} error {err:.3e} > {TOL_GENERATE_ABS}")


def run_sweep(model, rng, tmp: str, size: int, want, n_slices: int = 16):
    """The ``test`` CLI over ``n_slices`` synthetic size x size DICOM pairs
    with the model's weights saved as a reference-layout .pth; the launch
    counts are zeroed just before the run and read just after, and must
    equal ``want``. Returns (seconds, launch counts)."""
    root = os.path.join(tmp, f"data{size}")
    write_split(root, "test", rng, n_slices, size=size)
    ckpt = os.path.join(tmp, "weights.pth")
    sd = {f"Generator.{k}": v.detach().cpu() for k, v in model.generator.state_dict().items()}
    torch.save({"model_state_dict": sd, "epoch": 0}, ckpt)
    save_dir = os.path.join(tmp, f"out{size}")
    args = test_cli.get_args_parser().parse_args([
        "--data-root", root, "--resume", ckpt, "--save-dir", save_dir,
        "--no-feature-metrics", "--device", "cuda", "--seed", "0",
        "--model-kwargs", json.dumps({"gen_features": C, "num_layers": 10}),
    ])
    zero_counts()
    t0 = time.perf_counter()
    summary = test_cli.main(args)
    sweep_s = time.perf_counter() - t0
    counts = read_counts()
    with open(os.path.join(save_dir, "pred_results.csv")) as f:
        n_rows = sum(1 for _ in f) - 1
    n_png = len(os.listdir(os.path.join(save_dir, "png")))
    with open(os.path.join(save_dir, "test_summary.json")) as f:
        written = json.load(f)
    if n_rows != n_slices or n_png != n_slices:
        fail(f"sweep {size}^2 wrote {n_rows} rows and {n_png} PNGs, expected {n_slices}")
    expect_native(f"sweep {size}^2", read_decoded(save_dir))
    if not all(math.isfinite(v) for v in list(summary.values()) + list(written.values())):
        fail(f"non-finite sweep {size}^2 metrics: {summary}")
    print(f"sweep {size}x{size}: {n_rows} rows, {n_png} PNGs, pred_psnr "
          f"{summary['pred_psnr']:.4f} pred_ssim {summary['pred_ssim']:.5f}; "
          f"launches {counts}", flush=True)
    expect_counts(f"sweep {size}^2 ({n_slices // 8} groups of 8)", counts, want)
    return sweep_s, counts


def irfft2_cuda_vs_cpu():
    """Why the plain spectral branch zeroes the imaginary parts of the W
    bins 0 and W/2 itself: torch.fft.irfft2 of a non-Hermitian spectrum on
    CUDA against the CPU (which drops them, as jnp.fft.irfft2 does)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    for size in (64, 128, 256, 512):
        shape = (2, C, size, size // 2 + 1)
        z = torch.complex(torch.randn(shape, device="cuda", generator=g),
                          torch.randn(shape, device="cuda", generator=g))
        gpu = torch.fft.irfft2(z, s=(size, size), norm="ortho").cpu()
        cpu = torch.fft.irfft2(z.cpu(), s=(size, size), norm="ortho")
        rel = ((gpu - cpu).abs().max() / cpu.abs().max()).item()
        print(f"irfft2 of non-Hermitian input, CUDA vs CPU, {size}x{size}: "
              f"rel {rel:.3e}", flush=True)


def phantom(rng, n: int, size: int) -> np.ndarray:
    """(n, size, size) values in [0, 1]: an ellipse body with inserts plus
    noise, a stand-in for a windowed CT slice."""
    yy, xx = np.mgrid[0:size, 0:size] / size - 0.5
    body = ((xx / 0.42) ** 2 + (yy / 0.35) ** 2 < 1).astype(np.float64)
    insert = ((xx - 0.1) ** 2 + (yy + 0.05) ** 2 < 0.01).astype(np.float64)
    base = 0.15 + 0.5 * body + 0.25 * insert
    return np.clip(base[None] + 0.05 * rng.standard_normal((n, size, size)), 0, 1)


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k1_bounds(n: int, size: int, variant: str):
    """K1's bounds ((ms, by), (ms, by)): every operation fp32 on the CUDA
    cores; and, as K1 runs, the convs' multiply-adds as three TF32 products
    on the tensor cores and the rest fp32 on the CUDA cores, the larger of
    the two engines' times (they can run at once), of the bytes' time."""
    conv, other, nbytes = k1_work(n, size, variant)
    t_bytes = nbytes / PEAK_HBM_BYTES
    t_ops = max(3 * conv / PEAK_TF32_FLOPS, other / PEAK_FP32_FLOPS)
    tc = (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")
    return bound((conv + other, nbytes)), tc


def k2_work(n: int, size: int, variant: str):
    """(conv FLOPs, other FLOPs, bytes) one K2 call needs. Conv FLOPs: the
    C->C contractions, 2*9*C*C per pixel each: the recomputed convs (pre,
    res), their adjoints and their weight gradients (with post the
    recomputed res conv too). Other FLOPs: the convs' 3-op epilogues; the
    spectral mix recomputed, its weight gradient and its transpose,
    2*(2C)^2 per (h, k) bin each; three real 2-D FFTs (of hin, of g, and
    the inverse), 2.5*HW*log2(HW) each per channel; with post, the
    forward's second spectral half (mix, inverse FFT) and the C->1 post
    conv, its weight gradient and its adjoint. Bytes: every input read once
    (x, g, skip, img, gfin, weights), every output written once (xbar,
    skipbar, imgbar, weight gradients), fp32."""
    hw = size * size
    k = size // 2 + 1
    n_convs = 1 if variant == "plain" else 2
    mac = 2 * 9 * C * C * hw
    mix = 2 * (2 * C) ** 2 * size * k
    fft = 2.5 * C * hw * math.log2(hw)
    conv = n * 3 * n_convs * mac
    other = n * (3 * n_convs * 3 * C * hw + 3 * mix + 3 * fft)
    weights = n_convs * (9 * C * C + C) + 4 * C * C + 2 * C
    words = 2 * weights + n * C * hw * 2  # weights and their grads; x, xbar
    words += n * C * hw  # g
    if "skip" in variant:
        words += 2 * n * C * hw  # skip, skipbar
    if "post" in variant:
        conv += n * mac
        other += n * (mix + fft + 3 * (2 * 9 * C * hw + 3 * hw))
        words += 2 * (9 * C + 1) + 3 * n * hw  # post weights + grads; img, gfin, imgbar
    return conv, other, 4 * words


def k2_bounds(n: int, size: int, variant: str):
    """K2's bounds ((ms, by), (ms, by)), as :func:`k1_bounds`: every
    operation fp32 on the CUDA cores; and, as K2 runs, the C->C
    contractions as three TF32 products on the tensor cores and the rest
    fp32 on the CUDA cores, the larger of the two engines' times, or of
    the bytes' time."""
    conv, other, nbytes = k2_work(n, size, variant)
    t_bytes = nbytes / PEAK_HBM_BYTES
    t_ops = max(3 * conv / PEAK_TF32_FLOPS, other / PEAK_FP32_FLOPS)
    tc = (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")
    return bound((conv + other, nbytes)), tc


def k8_work(n: int, h: int, w: int):
    """(FLOPs, bytes) one K8 call with the residual needs. FLOPs: a real 2-D
    FFT forward and one inverse, 2.5*HW*log2(HW) each per channel; the
    spectral mix 2*(2C)^2 per (h, k) bin plus bias and ReLU; the residual
    add. Bytes: x, residual and out once each, the mix and its bias, fp32."""
    hw = h * w
    k = w // 2 + 1
    flops = n * (2 * 2.5 * C * hw * math.log2(hw)
                 + (2 * (2 * C) ** 2 + 2 * 2 * C) * h * k + C * hw)
    words = 3 * n * C * hw + 4 * C * C + 2 * C
    return flops, 4 * words


def k7_work(n: int, h: int, w: int, residual: bool):
    """(FLOPs, bytes) one K7 call needs: ``k8_work``, without the residual
    (its add and its bytes) where the call passes none."""
    if residual:
        return k8_work(n, h, w)
    hw = h * w
    k = w // 2 + 1
    flops = n * (2 * 2.5 * C * hw * math.log2(hw) + (2 * (2 * C) ** 2 + 2 * 2 * C) * h * k)
    words = 2 * n * C * hw + 4 * C * C + 2 * C
    return flops, 4 * words


def k3_work(n: int, h: int, w: int, variant: str, c_in: int = C, c_out: int = C,
            passes: int = 1):
    """(FLOPs, bytes) one K3 call needs: 2*9*C_in multiply-adds per output
    value (``passes`` times: 3 on the 3xTF32 tensor-core path) plus one op
    each for the bias, the skip, the ReLU and the residual it applies; x,
    the weights, the bias and the skip read once, out written once, fp32."""
    ops = 1 + ("skip" in variant) + ("relu" in variant) + ("residual" in variant)
    flops = n * h * w * c_out * (passes * 2 * 9 * c_in + ops)
    words = n * h * w * (c_in + c_out) + 9 * c_in * c_out + c_out
    if "skip" in variant:
        words += n * h * w * c_out
    return flops, 4 * words


def k4_work(n: int, h: int, w: int, c: int = C):
    """(FLOPs, bytes) one K4 call needs: a real W-point FFT per row,
    2.5*W*log2(W); x read once (fp32), the half spectrum written once
    (complex64)."""
    k = w // 2 + 1
    return n * c * h * 2.5 * w * math.log2(w), 4 * n * c * h * w + 8 * n * c * k * h


def k5_work(n: int, h: int, w: int, c: int = C):
    """(FLOPs, bytes) one K5 call needs: per (n, k) bin a complex H-point
    FFT and its inverse per channel, 5*H*log2(H) each, and at every h the
    2C x 2C mix, 2*(2C)^2, plus bias and ReLU; the spectrum read and
    written once (complex64), the mix and its bias read once."""
    k = w // 2 + 1
    flops = n * k * (2 * c * 5 * h * math.log2(h) + (2 * (2 * c) ** 2 + 2 * 2 * c) * h)
    return flops, 2 * 8 * n * c * k * h + 4 * (4 * c * c + 2 * c)


def k6_work(n: int, h: int, w: int, c: int = C):
    """(FLOPs, bytes) one K6 call needs: a Hermitian W-point c2r per row,
    2.5*W*log2(W), and the residual add; the spectrum (complex64) and the
    residual read once, out written once."""
    k = w // 2 + 1
    flops = n * c * h * (2.5 * w * math.log2(w) + w)
    return flops, 8 * n * c * k * h + 2 * 4 * n * c * h * w


def bound(work, peak_flops: float = PEAK_FP32_FLOPS):
    flops, nbytes = work
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def kernel_name(event) -> str:
    """A profiler event's kernel name without namespaces and arguments."""
    name = re.sub(r"\(anonymous namespace\)::|^void ", "", event.name)
    return name.split("(")[0][:70]


def launch_split(label: str, fn, launches, calls: int = 5, beside=None):
    """``fn`` split by its launches: the device time of each launch of one
    call, averaged over ``calls`` calls under torch.profiler, in the order
    ``launches`` ((launch, kernel), ...) names them; fails unless every
    launch ran the kernel it names. ``beside`` ({launch: text}) is printed
    after a launch's time. Returns {launch: ms}, or None when the profiler
    records no device time."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    if len(kernels) != calls * len(launches):
        print(f"{label}: {len(kernels)} device events for {calls} calls (not measured)",
              flush=True)
        return None
    split = {}
    for i, (launch, kernel) in enumerate(launches):
        events = kernels[i::len(launches)]
        names = {kernel_name(e) for e in events}
        split[launch] = sum(e.time_range.elapsed_us() for e in events) / calls / 1e3
        if not all(kernel in name for name in names):
            fail(f"{label} {launch} ran {names}, not {kernel}")
        print(f"{label} {launch:22s}: {', '.join(sorted(names))} {split[launch]:.3f} ms"
              f"{(beside or {}).get(launch, '')}", flush=True)
    total = sum(split.values())
    print(f"{label}: {total:.3f} ms of kernels per call; shares "
          + ", ".join(f"{k} {v / total:.4f}" for k, v in split.items()), flush=True)
    return split


# K1's launches in the order one call with "pre" makes them, and the
# kernel each must be: its convs K3's tensor-core kernel
K1_LAUNCHES = (("pre conv", "conv3x3_tc_kernel"), ("residual conv", "conv3x3_tc_kernel"),
               ("rows (K4)", "rdft_w_kernel"), ("column pass", "column_mix_rows_kernel"),
               ("inverse rows (K6)", "irdft_w_kernel"))
# K8's launches: K4's row rDFT, the mixed-radix column pass K5 runs, K6's
# inverse rows with the residual
K8_LAUNCHES = (("rows (K4)", "rdft_w_kernel"), ("column pass", "columns_mixed_kernel"),
               ("inverse rows (K6)", "irdft_w_kernel"))
# K2's launches in the order one call with "pre" and "skip" makes them,
# and the kernel each must be
K2_LAUNCHES = (("pre conv", "conv3x3_tc_kernel"), ("rows of hin (K4)", "rdft_w_kernel"),
               ("gate conv", "conv3x3_tc_kernel"), ("residual wgrad", "wgrad_tc_kernel"),
               ("residual wgrad sum", "sum_partials_kernel"),
               ("residual adjoint conv", "conv3x3_tc_kernel"),
               ("rows of g (K4)", "rdft_w_kernel"), ("column pass", "column_bwd_kernel"),
               ("column sums", "sum_partials_kernel"), ("inverse rows (K6)", "irdft_w_kernel"),
               ("ReLU mask", "relu_grad_kernel"), ("pre wgrad", "wgrad_tc_kernel"),
               ("pre wgrad sum", "sum_partials_kernel"),
               ("pre adjoint conv", "conv3x3_tc_kernel"))


def cudnn_k2_parts(args):
    """cuDNN's counterparts of K2's conv and weight-gradient launches on
    tensors of the same shapes (64x64, "pre+skip"; TF32 off): the two
    forward convs as ``F.conv2d``, each adjoint conv and each weight and
    bias gradient as ``aten.convolution_backward`` with the output mask of
    that gradient alone. Returns {launch: fn}."""
    n, c, hw = args["x"].shape
    size = int(math.isqrt(hw))
    img = lambda t: t.reshape(n, c, size, size)
    x, g = img(args["x"]), img(args["g"])
    (pre_w, pre_b), km, kb = args["pre"], args["km"], args["kb"]
    bwd = lambda gout, inp, wt, mask: torch.ops.aten.convolution_backward(
        gout, inp, wt, [c], [1, 1], [1, 1], [1, 1], False, [0, 0], 1, mask)
    grads, inputs = [False, True, True], [True, False, False]
    return {"pre conv": lambda: torch.nn.functional.conv2d(x, pre_w, pre_b, padding=1),
            "gate conv": lambda: torch.nn.functional.conv2d(x, km, kb, padding=1),
            "residual wgrad": lambda: bwd(g, x, km, grads),
            "residual adjoint conv": lambda: bwd(g, x, km, inputs),
            "pre wgrad": lambda: bwd(g, x, pre_w, grads),
            "pre adjoint conv": lambda: bwd(g, x, pre_w, inputs)}


def profile_k2_split(label: str, args):
    """K2 split by its 14 launches (:func:`launch_split`), and beside each
    conv and weight-gradient launch the time of cuDNN's call for the same
    part (CUDA events)."""
    library = {name: cuda_ms(fn, 10) for name, fn in cudnn_k2_parts(args).items()}
    split = launch_split(f"K2 split {label}", lambda: block_bwd(**args), K2_LAUNCHES,
                         beside={k: f", cuDNN {v:.3f} ms" for k, v in library.items()})
    if split is not None:
        print(f"K2 split {label}: its convs and weight gradients "
              f"{sum(split[k] for k in library):.3f} ms against cuDNN's "
              f"{sum(library.values()):.3f} ms", flush=True)
    return split


def profile(label: str, fn):
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's busy share between the first kernel's start and the last
    kernel's end."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"profile {label}: no device events recorded (not measured)")
        return
    by_name = {}
    for e in kernels:
        name = kernel_name(e)
        total, count = by_name.get(name, (0.0, 0))
        by_name[name] = (total + e.time_range.elapsed_us(), count + 1)
    busy = sum(t for t, _ in by_name.values())
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels))
    print(f"profile {label}: {busy / 1e3:.3f} ms of kernels in a {span / 1e3:.3f} ms "
          f"span, busy share {busy / span:.4f}", flush=True)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (total, count) in ranked[:25]:
        print(f"profile {label} kernel {name}: {total / 1e3:.3f} ms, {count} launches, "
              f"{total / busy:.4f} of kernel time", flush=True)


def write_split(root: str, split: str, rng, n: int, size: int = 512):
    """n synthetic DICOM pairs of the phantom under <root>/<split>."""
    for i, (lo, hi) in enumerate(zip(phantom(rng, n, size), phantom(rng, n, size))):
        for key, img in (("n_20", lo), ("n_100", hi)):
            hu = img * 400.0 - 160.0  # abdomen window [-160, 240] HU
            write_synthetic_dicom(
                os.path.join(root, split, "case0", key, f"slice{i:03d}.IMA"),
                np.round(hu + 1024.0).astype(np.uint16))


def plain_forward(gen, x):
    return gen(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def train_patches(rng, seed: int):
    """160 paired 64x64 patches cut by the train preprocess from 20
    synthetic 512x512 slices (HU), on the card."""
    lo = phantom(rng, TRAIN_SLICES, 512) * 400.0 - 160.0
    hi = np.clip(lo + 20.0 * rng.standard_normal(lo.shape), -1024, 3071)
    hu = lambda a: torch.tensor(np.round(a)[..., None], dtype=torch.int16, device="cuda")
    pre = make_train_preprocess("window_patch", "mayo")
    return pre(hu(lo), hu(hi), torch.Generator(device="cuda").manual_seed(seed))


def k1_hybrid(convs: str, spectral: str):
    """A stand-in for K1 (``block_fused``'s arguments and result) in the
    train step's witnesses, a measurement only: its C -> C convs on K3's
    tensor-core kernel, which K1 runs (``convs="K3"``), or on cuDNN
    (``"cuDNN"``); its spectral branch on ``torch.fft`` (``spectral="torch"``)
    or on K4 -> K5 -> K6 (``"K4-K6"``: K4 and K6 are K1's row kernels, K5 a
    hand-written column pass like K1's); the exit conv on cuDNN."""
    def forward(x, h, w, km, kb, mix, mb, pre=None, skip=None, post=None, img=None):
        n = x.shape[0]
        a = x.reshape(n, -1, h, w)
        conv = conv3x3 if convs == "K3" else conv3x3_reference
        if pre is not None:
            a = conv(a, pre[0], pre[1], skip=None if skip is None else skip.reshape(a.shape))
        out = fft_conv_block(a, km, kb, mix, mb,
                             impl="staged" if spectral == "K4-K6" else "auto",
                             conv_impl="k3" if convs == "K3" else "torch")
        if post is None:
            return out.reshape(n, -1, h * w)
        final = conv3x3_reference(out, post[0], post[1], skip=img.reshape(n, 1, h, w))
        return out.reshape(n, -1, h * w), final.reshape(n, 1, h * w)
    return forward


def step_errors(x, y, model_seed: int, label: str, hold: bool = True,
                truth: bool = False):
    """One step from one state through K1 + K2 and through the plain
    generator under autograd: the D losses and g_loss, the cotangent of
    fake that g_loss_terms gives each path, and the generator gradient with
    the plain path's cotangent pulled through both generator graphs (so
    that only K1 and K2 differ). Held to the tolerances when ``hold``. With
    ``truth`` the same cotangent is also pulled through the plain generator
    in float64, and both fp32 gradients are read against it (not held).
    Returns (D-loss error, worst leaf's 2-norm error, its max-norm error,
    its name) and the state the step started from."""
    base = MTDGANModel(gen_features=C, disc_features=64, num_layers=10,
                       device="cuda", seed=model_seed)
    order = torch.tensor([[0, 1, 2], [1, 2, 0], [2, 0, 1]])
    paths = {}
    for path, forward in (("kernel", resfft_generator_train), ("plain", plain_forward)):
        model = copy.deepcopy(base)
        trainer = MTDGANTrainer(model, method="pcgrad", seed=0)
        fake = forward(model.generator.train(), x)
        d_losses, _ = trainer.d_update(x, y, fake, order)
        total, _ = model.g_loss_terms(fake, x, y, update_stats=True, generator=trainer.rng)
        (dfake,) = torch.autograd.grad(total, fake, retain_graph=True)
        paths[path] = (model, fake, d_losses, total.detach(), dfake)
    (mk, fk, dk, gk, ck), (mp, fp, dp, gp, cp) = paths["kernel"], paths["plain"]
    grads_k = torch.autograd.grad(fk, list(mk.generator.parameters()), cp)
    grads_p = torch.autograd.grad(fp, list(mp.generator.parameters()), cp)
    torch.cuda.synchronize()
    d_rel = ((dk - dp).abs().max() / dp.abs().max()).item()
    c_rel = ((ck - cp).norm() / cp.norm()).item()
    worst = (0.0, 0.0, "")
    for (name, _), a, b in zip(base.generator.named_parameters(), grads_k, grads_p):
        if not torch.isfinite(a).all():
            fail(f"{label}: non-finite generator gradient {name}")
        l2 = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
        mx = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
        worst = max(worst, (l2, mx, name))
        if hold and l2 > TOL_STEP_GRAD_L2:
            fail(f"{label}: generator gradient {name} relative 2-norm error "
                 f"{l2:.3e} > {TOL_STEP_GRAD_L2} (max-norm {mx:.3e})")
    print(f"{label} (160 x 64x64, 32/64 features, 10 layers): D losses kernel "
          f"{dk.tolist()} plain {dp.tolist()} rel {d_rel:.3e}; g_loss {gk.item():.6f} vs "
          f"{gp.item():.6f}; cotangent of fake rel {c_rel:.3e} (2-norm); generator "
          f"gradient worst leaf {worst[2]} {worst[0]:.3e} (2-norm) {worst[1]:.3e} "
          f"(max-norm) over {len(grads_k)} leaves", flush=True)
    if hold and d_rel > TOL_STEP_DLOSS_REL:
        fail(f"{label}: D losses differ by {d_rel:.3e} > {TOL_STEP_DLOSS_REL}")
    if truth:
        gen64 = copy.deepcopy(base.generator).double().train()
        f64 = plain_forward(gen64, x.double())
        grads_t = torch.autograd.grad(f64, list(gen64.parameters()), cp.double())
        names = [name for name, _ in base.generator.named_parameters()]
        for path, grads in (("kernel", grads_k), ("plain", grads_p)):
            errs = [((a.double() - t).norm() / t.norm().clamp_min(1e-300)).item()
                    for a, t in zip(grads, grads_t)]
            i = int(np.argmax(errs))
            print(f"{label}: {path} generator gradient against the plain generator in "
                  f"float64, worst leaf {names[i]} {errs[i]:.3e} (2-norm), median leaf "
                  f"{float(np.median(errs)):.3e}", flush=True)
        del gen64, f64, grads_t
    return (d_rel, worst[0], worst[1], worst[2]), base


def check_train_step(x, y):
    """Phase 18: :func:`step_errors` from one state, then 3 kernel steps
    with their launch counts. Returns the kernel trainer."""
    _, base = step_errors(x, y, 0, "train step", truth=True)
    trainer = MTDGANTrainer(base, method="pcgrad", seed=0)
    for step in range(3):
        block_fused.launches = block_bwd.launches = 0
        m = trainer.train_step(x, y)
        torch.cuda.synchronize()
        k1, k2 = block_fused.launches, block_bwd.launches
        d, g = m["d_loss"].item(), m["g_loss"].item()
        print(f"train step {step}: d_loss {d:.6f} g_loss {g:.6f}; K1 launches {k1}, "
              f"K2 launches {k2}", flush=True)
        if not (math.isfinite(d) and math.isfinite(g)):
            fail(f"train step {step}: non-finite losses {d}, {g}")
        if (k1, k2) != (21, 21):
            fail(f"train step {step}: {k1} K1 and {k2} K2 launches, expected 21 + 21")
    return trainer


# the train step's witnesses: the forward K2 differentiates in place of K1
WITNESSES = {"witness": block_fused_reference,
             "witness K3 convs": k1_hybrid("K3", "torch"),
             "witness K4-K6 FFTs": k1_hybrid("cuDNN", "K4-K6")}


def train_step_spread():
    """Phase 18: the train step's gradient check on three more states and
    patch sets (seeds 0, 1, 2), each read twice; and witnesses on the same
    seeds (not held to the tolerance), each with another forward in place
    of K1 that K2 differentiates: K1's plain version (``F.conv2d`` in fp32
    and ``torch.fft``), so that K1's 3xTF32 convs and FFTs are out of the
    comparison; and :func:`k1_hybrid` with K1's convs alone, and with
    hand-written FFTs alone, to tell which part of K1's forward moves the
    masks."""
    spread = {}
    for seed in (0, 1, 2):
        x, y = train_patches(np.random.default_rng(100 + seed), seed=seed)
        for label, reps in (("kernel", 2), *((w, 1) for w in WITNESSES)):
            for rep in range(reps):
                tag = f"train step seed {seed} {label} read {rep + 1}"
                cuda_train.block_fused = WITNESSES.get(label, block_fused)
                try:
                    (_, l2, _, _), _ = step_errors(x, y, seed, tag, hold=label == "kernel")
                finally:
                    cuda_train.block_fused = block_fused
                spread[(label, seed, rep)] = l2
        del x, y
    for label in ("kernel", *WITNESSES):
        got = [v for k, v in spread.items() if k[0] == label]
        print(f"train step spread {label}: worst leaf 2-norm error min {min(got):.3e} "
              f"max {max(got):.3e} over {len(got)} reads", flush=True)


def check_train_cli(rng, tmp: str):
    """Phase 14: the training path through its CLI, then the test CLI on the
    checkpoint it wrote. Returns (K1, K2) launches of the train run."""
    root = os.path.join(tmp, "train_data")
    write_split(root, "train", rng, 2 * TRAIN_SLICES)
    write_split(root, "valid", rng, 2)
    write_split(root, "test", rng, 4)
    ckpt_dir = os.path.join(tmp, "ckpt")
    kwargs = json.dumps({"gen_features": C, "disc_features": 64, "num_layers": 10})
    args = train_cli.get_args_parser().parse_args([
        "--data-root", root, "--batch-size", str(TRAIN_SLICES), "--epochs", "1",
        "--device", "cuda", "--seed", "0", "--model-kwargs", kwargs,
        "--method", "pcgrad", "--checkpoint-dir", ckpt_dir,
        "--save-dir", os.path.join(tmp, "train_out"), "--print-freq", "1"])
    block_fused.launches = block_bwd.launches = 0
    t0 = time.perf_counter()
    stats = train_cli.main(args)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = (block_fused.launches, block_bwd.launches)
    if not all(math.isfinite(v) for v in stats.values() if isinstance(v, float)):
        fail(f"train CLI: non-finite epoch stats {stats}")
    if launches[1] != 2 * 21 or launches[0] < 2 * 21:
        fail(f"train CLI: {launches} (K1, K2) launches, expected 2 steps x 21 K2 "
             f"and at least as many K1")
    for split, decoded in stats["decoded"].items():
        expect_native(f"train CLI {split}", decoded)
    ckpt = os.path.join(ckpt_dir, "epoch_0.pth")
    keys = load_checkpoint(ckpt)["model_state_dict"]
    if not (any(k.startswith("Generator.") for k in keys)
            and any(k.startswith("Discriminator.") for k in keys)):
        fail("train CLI: the checkpoint lacks Generator.* or Discriminator.* keys")
    test_dir = os.path.join(tmp, "test_out")
    summary = test_cli.main(test_cli.get_args_parser().parse_args([
        "--data-root", root, "--resume", ckpt, "--save-dir", test_dir,
        "--no-feature-metrics", "--device", "cuda", "--model-kwargs", kwargs]))
    expect_native("test --resume", read_decoded(test_dir))
    if not all(math.isfinite(v) for v in summary.values()):
        fail(f"test CLI after train: non-finite metrics {summary}")
    print(f"train CLI: 1 epoch of 2 steps x {TRAIN_SLICES} slices in {train_s:.3f} s "
          f"(validation and checkpoint included), train_d_loss "
          f"{stats['train_d_loss']:.6f} train_g_loss {stats['train_g_loss']:.6f} "
          f"valid_loss {stats['valid_loss']:.6f}; K1 launches {launches[0]}, K2 launches "
          f"{launches[1]}; checkpoint {len(keys)} tensors; test --resume pred_psnr "
          f"{summary['pred_psnr']:.4f}", flush=True)
    check_train_cli_second(root, tmp, ckpt)
    return launches


def read_decoded(save_dir: str):
    """The decoder counts of the last line of a sweep's test_log.txt."""
    with open(os.path.join(save_dir, "test_log.txt")) as f:
        return json.loads(f.read().splitlines()[-1])["decoded"]


def expect_native(label: str, decoded) -> None:
    """Fail if any file was decoded in Python: this machine has g++."""
    if decoded["python"] or not decoded["native"]:
        fail(f"{label}: decoded {decoded}: every file must go through the native codec")


def check_decoder(root: str):
    """Phase 22: the native DICOM decoder (``csrc/dicom_codec.cc``, g++ into
    ``_build/``) on the synthetic DICOMs under ``root``: present, bit for bit
    the Python codec, and its ms per file next to the Python codec's."""
    if native.library() is None:
        fail("the native DICOM decoder did not build (g++)")
    ds = PairedDicomDataset(root, "test")
    paths = ds.low_paths + ds.high_paths
    times = {}
    for label, decode in (("native", native.decode_hu), ("python", get_pixels_hu)):
        t0 = time.perf_counter()
        out = [decode(p) for p in paths]
        times[label] = (time.perf_counter() - t0) * 1e3 / len(paths)
        if label == "native":
            ours = out
    for p, a, b in zip(paths, ours, out):
        if a is None or a.dtype != b.dtype or not np.array_equal(a, b):
            fail(f"native decoder differs from the Python codec on {p}")
    print(f"decoder: {len(paths)} files {ours[0].shape[0]}x{ours[0].shape[1]}, native "
          f"{times['native']:.4f} ms/file, python {times['python']:.4f} ms/file, bit for "
          f"bit equal", flush=True)
    return times


SPLIT_PHASES = ("load", "decode", "h2d", "generate", "metrics", "png", "csv")


def sweep_split(model, root: str, tmp: str, n_slices: int):
    """Phase 23: the 512x512 ``test`` sweep over ``n_slices`` DICOM pairs,
    twice, its host time split by phase (each phase ends in a device
    synchronize): model construction and checkpoint load, decode, H2D and
    window, ``generate`` (K1, its launches counted), metrics with their copy
    back, the PNG encoders' drain, CSV and summary; beside it one PNG
    encode of a 512x512 slice on this thread. The steady-state slices/s
    divide the slices by the loop's phases (decode to PNG), without the
    fixed costs (load, CSV)."""
    ckpt = os.path.join(tmp, "split_weights.pth")
    sd = {f"Generator.{k}": v.detach().cpu() for k, v in model.generator.state_dict().items()}
    torch.save({"model_state_dict": sd, "epoch": 0}, ckpt)
    png = np.zeros((512, 512), np.uint8)
    t0 = time.perf_counter()
    for i in range(8):
        save_png_gray(os.path.join(tmp, "split_png", f"{i}.png"), png)
    png_ms = (time.perf_counter() - t0) * 1e3 / 8
    out = []
    for run in (1, 2):
        save_dir = os.path.join(tmp, f"split{run}")
        args = test_cli.get_args_parser().parse_args([
            "--data-root", root, "--resume", ckpt, "--save-dir", save_dir,
            "--no-feature-metrics", "--device", "cuda", "--seed", "0",
            "--model-kwargs", json.dumps({"gen_features": model.gen_features,
                                          "num_layers": model.num_layers})])
        phases = {}
        zero_counts()
        t0 = time.perf_counter()
        summary = test_cli.main(args, phases)
        wall = time.perf_counter() - t0
        counts = read_counts()
        expect_counts(f"sweep split {n_slices} slices", counts,
                      {"K1": n_slices // 8 * 21})
        expect_native(f"sweep split run {run}", read_decoded(save_dir))
        if not all(math.isfinite(v) for v in summary.values()):
            fail(f"sweep split: non-finite metrics {summary}")
        secs = {p: phases[p].summary()["total_s"] for p in SPLIT_PHASES}
        loop = sum(secs[p] for p in ("decode", "h2d", "generate", "metrics", "png"))
        print(f"sweep split 512x512 run {run}: {n_slices} slices, wall {wall:.4f} s; "
              + ", ".join(f"{p} {secs[p]:.4f} s" for p in SPLIT_PHASES)
              + f"; steady state {n_slices / loop:.4f} slices/s; one PNG encode "
              f"{png_ms:.3f} ms on this thread; launches {counts}", flush=True)
        out.append((secs, n_slices / loop, wall))
    return out


def check_bench():
    """Phase 24: ``bench.run`` at the root's batches (64, 32, 16, 8, 4):
    every one of them ran (the sweep skips the batches at and above one
    that failed), on the K1 route, with a value above 0."""
    result = bench.run(device="cuda")
    print(f"bench: {json.dumps(result)}", flush=True)
    if result["value"] <= 0 or result.get("route") != "k1":
        fail(f"bench: value {result['value']} on route {result.get('route')}")
    if result["batches"] != list(bench.BATCHES):
        fail(f"bench: batches {result['batches']} ran, expected {list(bench.BATCHES)}")
    if not 0 < result["mfu"] <= 1:
        fail(f"bench: mfu {result['mfu']} outside (0, 1]")
    return result


def _flat(grads):
    return torch.cat([g.reshape(-1).double() for g in grads if g is not None])


def check_mto_methods(x, y):
    """Phase 25: one full-width train step per MTO method (generator 32 x 10
    layers, discriminator 64, the 160 patches of phase 18) on K1 + K2: 21
    launches of each, finite losses, and the method against
    ``combine_grads`` run in float64 on the same per-task gradients,
    losses, state and draws: the combined gradient over every leaf the
    method gives one (2-norm) held to ``TOL_MTO``, the task weights' worst
    error relative to each weight itself printed beside it. Then one step
    timed with CUDA events. Returns {method: ms per step}."""
    captured = {}
    real = gan.combine_grads

    def capture(method, task_grads, labels, order=None, losses=None, state=None, draw=None):
        # a copy of the state: UW's optimizer steps log-sigma in place after
        snap = MTOState(**{k: v.clone() if torch.is_tensor(v) else v
                           for k, v in state.to_dict().items()})
        out = real(method, task_grads, labels, order, losses, state, draw)
        captured.update(args=(method, task_grads, labels, order, losses, snap, draw),
                        out=out)
        return out

    base = MTDGANModel(gen_features=C, disc_features=64, num_layers=10, device="cuda",
                       seed=0)
    ms = {}
    gan.combine_grads = capture
    try:
        for name in METHODS:
            model = copy.deepcopy(base)
            trainer = MTDGANTrainer(model, method=name, seed=0)
            block_fused.launches = block_bwd.launches = 0
            m = trainer.train_step(x, y)
            torch.cuda.synchronize()
            k1, k2 = block_fused.launches, block_bwd.launches
            d, g = m["d_loss"].item(), m["g_loss"].item()
            method, task_grads, labels, order, losses, state, draw = captured["args"]
            grads = captured["out"][0]
            weights = trainer.task_weights
            state64 = MTOState(**{k: v.double() if torch.is_tensor(v) else v
                                  for k, v in state.to_dict().items()})
            grads64, _, weights64 = real(
                method, [[t.double() for t in gs] for gs in task_grads], labels, order,
                losses.double(), state64, None if draw is None else draw.double())
            if [g is None for g in grads] != [g is None for g in grads64]:
                fail(f"MTO {name}: the leaves given a gradient differ from float64")
            err = ((_flat(grads) - _flat(grads64)).norm() / _flat(grads64).norm()).item()
            nz = weights64 != 0
            w_err = ((weights.double() - weights64)[nz].abs()
                     / weights64[nz].abs()).max().item()
            del grads64, captured["args"], captured["out"]
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            trainer.train_step(x, y)
            end.record()
            end.synchronize()
            ms[name] = start.elapsed_time(end)
            print(f"MTO {name}: d_loss {d:.6f} g_loss {g:.6f}; weights "
                  f"{weights.tolist()}; vs float64: combined D gradient {err:.3e} "
                  f"(2-norm, tol {TOL_MTO}), weights {w_err:.3e} (each relative to "
                  f"itself); K1 {k1} K2 {k2}; {ms[name]:.2f} ms/step", flush=True)
            if not (math.isfinite(d) and math.isfinite(g)):
                fail(f"MTO {name}: non-finite losses {d}, {g}")
            if (k1, k2) != (21, 21):
                fail(f"MTO {name}: {k1} K1 and {k2} K2 launches, expected 21 + 21")
            if not err <= TOL_MTO:
                fail(f"MTO {name}: combined D gradient {err:.3e} from float64 > {TOL_MTO}")
            del model, trainer, m
            torch.cuda.empty_cache()
    finally:
        gan.combine_grads = real
    return ms


def check_train_cli_second(root: str, tmp: str, pretrained: str):
    """Phase 20, second run: the train CLI again, one epoch of 2 steps, with UW, the
    cosine warm-restart scheduler, the ``full_patch`` preset, a warm start
    from the first run's checkpoint and a profiler trace of the epoch; then
    ``test --checkpoint-dir --epoch 0`` without ``--resume``."""
    ckpt_dir = os.path.join(tmp, "ckpt_uw")
    prof = os.path.join(tmp, "prof")
    kwargs = json.dumps({"gen_features": C, "disc_features": 64, "num_layers": 10})
    args = train_cli.get_args_parser().parse_args([
        "--data-root", root, "--batch-size", str(TRAIN_SLICES), "--epochs", "1",
        "--device", "cuda", "--seed", "1", "--model-kwargs", kwargs,
        "--method", "uw", "--scheduler", "cosine_annealing_warm_restart",
        "--dataset-type-train", "full_patch", "--from-pretrained", pretrained,
        "--profile-dir", prof, "--checkpoint-dir", ckpt_dir,
        "--save-dir", os.path.join(tmp, "train_uw_out"), "--print-freq", "1"])
    block_fused.launches = block_bwd.launches = 0
    t0 = time.perf_counter()
    stats = train_cli.main(args)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = (block_fused.launches, block_bwd.launches)
    if not all(math.isfinite(v) for v in stats.values() if isinstance(v, float)):
        fail(f"train CLI (uw): non-finite epoch stats {stats}")
    if launches[1] != 2 * 21 or launches[0] < 2 * 21:
        fail(f"train CLI (uw): {launches} (K1, K2) launches, expected 2 steps x 21 K2")
    for split, decoded in stats["decoded"].items():
        expect_native(f"train CLI (uw) {split}", decoded)
    trace_mb = os.path.getsize(os.path.join(prof, "trace.json")) / 2**20
    saved = load_checkpoint(os.path.join(ckpt_dir, "epoch_0.pth"))
    logsigma = saved["mto_state"]["logsigma"]
    if saved["mto_method"] != "uw" or saved["optimizer_mto"] is None or not torch.any(logsigma):
        fail(f"train CLI (uw): the checkpoint lacks UW's state ({saved['mto_method']}, "
             f"logsigma {logsigma})")
    test_dir = os.path.join(tmp, "test_uw_out")
    summary = test_cli.main(test_cli.get_args_parser().parse_args([
        "--data-root", root, "--checkpoint-dir", ckpt_dir, "--epoch", "0",
        "--save-dir", test_dir, "--no-feature-metrics", "--device", "cuda",
        "--model-kwargs", kwargs]))
    expect_native("test --checkpoint-dir", read_decoded(test_dir))
    if not all(math.isfinite(v) for v in summary.values()):
        fail(f"test --checkpoint-dir --epoch 0: non-finite metrics {summary}")
    print(f"train CLI (uw, cosine warm restarts, full_patch, from-pretrained): 1 epoch of "
          f"2 steps in {train_s:.3f} s, lr {stats['lr']:.3e}, train_d_loss "
          f"{stats['train_d_loss']:.6f} train_g_loss {stats['train_g_loss']:.6f}; K1 "
          f"launches {launches[0]}, K2 launches {launches[1]}; logsigma "
          f"{logsigma.tolist()}; trace {trace_mb:.1f} MiB; test --checkpoint-dir --epoch 0 "
          f"pred_psnr {summary['pred_psnr']:.4f}", flush=True)


def vgg19_flops(n: int, size: int, end: int = max(VGG_SLICE_ENDS)) -> float:
    """Multiply-adds x 2 of the VGG19 trunk through sequential index
    ``end`` on n size x size images (3x3 convs only; ReLUs and pools are
    a rounding error)."""
    flops, c_in, side, idx = 0.0, 3, size, 0
    for v in VGG19_CFG:
        if idx > end:
            break
        if v == "M":
            side //= 2
            idx += 1
        else:
            flops += 2.0 * n * side * side * 9 * c_in * v
            c_in = v
            idx += 2
    return flops


def rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def check_features(rng, size: int = 512, group: int = 8):
    """Phase 26 (a), (c): the feature metrics on the card against the same
    port functions on the CPU in float64, at 512x512, batch 2 per column
    (input, gt, pred stand-ins from the phantom): the VGG19 slice features,
    PL and TML per slice, the Inception pool3 features and the FID math fed
    either side's features; then their times on the card (CUDA events) at
    the sweep's group of 8 slices, VGG19 per image pass beside its bound;
    and the weights status. Returns the times."""
    n = 2
    x, y, p = (torch.tensor(phantom(rng, n, size)[..., None], dtype=torch.float32)
               for _ in range(3))
    cat = torch.cat([x, y, p])
    vgg64 = copy.deepcopy(registry.get_extractor("vgg19", "cuda")).cpu().double()
    inc64 = copy.deepcopy(registry.get_extractor("inception", "cuda")).cpu().double()
    vgg_fn = registry.get_vgg_slices_fn("cuda")
    t0 = time.perf_counter()
    with torch.no_grad():
        f_card = [f.cpu().double() for f in vgg_fn(cat.cuda())]
        f_cpu = vgg64(registry.to_rgb_nchw(cat.double()))
        pl, tml = (t.cpu().double() for t in perceptual.pl_tml(x.cuda(), y.cuda(), p.cuda(),
                                                               vgg_fn))
        # the same concatenation: the float64 features computed above
        pl64, tml64 = perceptual.pl_tml(x.double(), y.double(), p.double(), lambda _: f_cpu)
        g_card = inception_pool3_features(registry.get_extractor("inception", "cuda"),
                                          cat.cuda()).cpu().double()
        g_cpu = inception_pool3_features(inc64, cat.double())
    cpu_s = time.perf_counter() - t0
    slice_errs = [rel_max(a, b) for a, b in zip(f_card, f_cpu)]
    value_errs = {}
    for label, got, want in (("pl", pl, pl64), ("tml", tml, tml64)):
        if got[1].abs().max().item() != 0.0 or want[1].abs().max().item() != 0.0:
            fail(f"features: gt-vs-gt {label} {got[1].tolist()} (card), "
                 f"{want[1].tolist()} (cpu), expected exactly 0")
        value_errs[label] = ((got[0::2] - want[0::2]).abs() / want[0::2].abs()).max().item()
    inc_err = (torch.linalg.vector_norm(g_card - g_cpu)
               / torch.linalg.vector_norm(g_cpu)).item()
    fid_card = fid_lib.compute_fid(*g_card.reshape(3, n, -1).numpy())
    fid_cpu = fid_lib.compute_fid(*g_cpu.reshape(3, n, -1).numpy())
    fid_errs = [abs(a - b) / abs(b) for a, b in zip(fid_card, fid_cpu)]
    print(f"features {size}x{size} batch {n} per column, card (fp32, TF32 off) vs CPU float64: "
          f"VGG19 slices max rel {', '.join(f'{e:.3e}' for e in slice_errs)}; PL "
          f"{pl.tolist()} max rel {value_errs['pl']:.3e}; TML {tml.tolist()} max rel "
          f"{value_errs['tml']:.3e}; Inception pool3 rel 2-norm {inc_err:.3e} "
          f"(tol {TOL_FEATURES_REL}); FID (input, gt, pred) card {fid_card}, cpu "
          f"{fid_cpu}, rel {fid_errs[0]:.3e}, {fid_errs[2]:.3e} (tol {TOL_FID_REL}); "
          f"float64 CPU side {cpu_s:.1f} s", flush=True)
    if max(slice_errs + list(value_errs.values()) + [inc_err]) > TOL_FEATURES_REL:
        fail("features: the card differs from the CPU float64 reference")
    if max(fid_errs[0], fid_errs[2]) > TOL_FID_REL:
        fail("features: the FID fed the card's features differs from the float64 one")
    del vgg64, inc64, f_card, f_cpu

    # times at the sweep's group: 8 slices, 24 images through each extractor
    xs, ys, ps = (torch.tensor(phantom(rng, group, size)[..., None],
                               dtype=torch.float32).cuda() for _ in range(3))
    trunk_in = registry.to_rgb_nchw(torch.cat([xs, ys, ps]))
    trunk = registry.get_extractor("vgg19", "cuda")
    inc_fn = registry.get_inception_feature_fn("cuda")
    with torch.no_grad(), registry.fp32_precision():
        trunk_ms = cuda_ms(lambda: trunk(trunk_in, VGG_SLICE_ENDS), 3)
        pl_tml_ms = cuda_ms(lambda: perceptual.pl_tml(xs, ys, ps, vgg_fn), 3)
        inc_ms = cuda_ms(lambda: fid_lib.compute_feat(xs, ys, ps, inc_fn), 3)
    flops = vgg19_flops(1, size)
    bound_ms = flops / PEAK_FP32_FLOPS * 1e3
    per_image = trunk_ms / (3 * group)
    print(f"time features {size}x{size}, group of {group} slices: VGG19 trunk through relu5_1 "
          f"{trunk_ms:.3f} ms per {3 * group} images = {per_image:.3f} ms per image pass "
          f"(bound {bound_ms:.3f} ms: {flops / 1e9:.1f} GFLOP over 67 TFLOP/s fp32; "
          f"{bound_ms / per_image:.3f} of it); PL + TML {pl_tml_ms:.3f} ms = "
          f"{pl_tml_ms / group:.3f} ms per slice; Inception pool3 {inc_ms:.3f} ms = "
          f"{inc_ms / group:.3f} ms per slice", flush=True)
    print(f"feature weights: {json.dumps(registry.feature_weights_status())}", flush=True)
    return {"trunk_ms_per_image": per_image, "bound_ms": bound_ms,
            "pl_tml_ms_per_slice": pl_tml_ms / group, "inception_ms_per_slice": inc_ms / group}


FEATURE_SPLIT = ("load", "decode", "h2d", "generate", "metrics", "features", "png", "csv")


def feature_sweep(model, root: str, tmp: str, n_slices: int):
    """Phase 26 (b): ``python -m mtd_gan_tpu_torch.test``'s ``main`` at its
    default, feature metrics on, over phase 5's 512x512 set, in turns with
    ``--no-feature-metrics`` (on, off, off, on), each split by phase; fails
    unless every row has exactly 0 gt_pl and gt_tml and finite columns, the
    summary its three FIDs, and K1 launched as in phase 5. Returns the
    steady-state slices/s of each run (the loop's phases, decode to PNG)."""
    ckpt = os.path.join(tmp, "feature_weights.pth")
    sd = {f"Generator.{k}": v.detach().cpu() for k, v in model.generator.state_dict().items()}
    torch.save({"model_state_dict": sd, "epoch": 0}, ckpt)
    out = []
    for run, features in enumerate((True, False, False, True)):
        save_dir = os.path.join(tmp, f"features{run}")
        argv = ["--data-root", root, "--resume", ckpt, "--save-dir", save_dir,
                "--device", "cuda", "--seed", "0",
                "--model-kwargs", json.dumps({"gen_features": model.gen_features,
                                              "num_layers": model.num_layers})]
        args = test_cli.get_args_parser().parse_args(
            argv + ([] if features else ["--no-feature-metrics"]))
        phases = {}
        zero_counts()
        t0 = time.perf_counter()
        summary = test_cli.main(args, phases)
        wall = time.perf_counter() - t0
        counts = read_counts()
        label = f"feature sweep run {run} ({'on' if features else 'off'})"
        expect_counts(label, counts, {"K1": n_slices // 8 * 21})
        with open(os.path.join(save_dir, "pred_results.csv")) as f:
            rows = list(csv.DictReader(f))
        if len(rows) != n_slices:
            fail(f"{label}: {len(rows)} rows, expected {n_slices}")
        values = [float(v) for r in rows for k, v in r.items() if k != "filename"]
        if not all(math.isfinite(v) for v in values + list(summary.values())):
            fail(f"{label}: non-finite columns")
        if features:
            gt = [(float(r["gt_pl"]), float(r["gt_tml"])) for r in rows]
            if any(v != 0.0 for pair in gt for v in pair):
                fail(f"{label}: gt_pl / gt_tml not exactly 0: {gt}")
            if not {"input_fid", "gt_fid", "pred_fid"} <= set(summary):
                fail(f"{label}: the summary lacks the FIDs: {sorted(summary)}")
        secs = {p: phases[p].summary().get("total_s", 0.0) for p in FEATURE_SPLIT}
        loop = sum(secs[p] for p in FEATURE_SPLIT[1:-1])
        fids = (f"; FID input {summary['input_fid']:.4f} gt {summary['gt_fid']:.3e} pred "
                f"{summary['pred_fid']:.4f}; pred_pl {summary['pred_pl']:.6f} pred_tml "
                f"{summary['pred_tml']:.6f}" if features else "")
        print(f"{label}: {n_slices} slices 512x512, wall {wall:.4f} s; "
              + ", ".join(f"{p} {secs[p]:.4f} s" for p in FEATURE_SPLIT)
              + f"; steady state {n_slices / loop:.4f} slices/s{fids}; launches {counts}",
              flush=True)
        out.append((features, n_slices / loop, secs))
    return out


def family_run(name: str, kwargs, root: str, test_root: str, tmp: str,
               preset: str = "window_patch", batch: int = TRAIN_SLICES):
    """Phase 27: one epoch of the ``train`` CLI for ``name`` on ``root``
    (its train split in batches of ``batch`` slices cut by ``preset``, its
    valid split), then, for the patch presets, ``test --resume`` on the
    checkpoint over ``test_root``'s 16 slices. The launch counts are zeroed
    just before each run and read just after. Returns (train stats, train
    seconds, train counts, test summary or None, sweep seconds, sweep
    counts, checkpoint)."""
    ckpt_dir = os.path.join(tmp, f"ckpt_{name}_{preset}")
    common = ["--model", name, "--model-kwargs", json.dumps(kwargs), "--device", "cuda",
              "--seed", "0"]
    args = train_cli.get_args_parser().parse_args(common + [
        "--data-root", root, "--batch-size", str(batch), "--epochs", "1",
        "--dataset-type-train", preset, "--checkpoint-dir", ckpt_dir,
        "--save-dir", os.path.join(tmp, f"train_{name}"), "--print-freq", "1"])
    zero_counts()
    t0 = time.perf_counter()
    stats = train_cli.main(args)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = read_counts()
    if not all(math.isfinite(v) for v in stats.values() if isinstance(v, float)):
        fail(f"train CLI {name} ({preset}): non-finite epoch stats {stats}")
    for split, decoded in stats["decoded"].items():
        expect_native(f"train CLI {name} {split}", decoded)
    ckpt = os.path.join(ckpt_dir, "epoch_0.pth")
    if preset != "window_patch":
        return stats, train_s, train_counts, None, None, None, ckpt
    save_dir = os.path.join(tmp, f"test_{name}")
    zero_counts()
    t0 = time.perf_counter()
    summary = test_cli.main(test_cli.get_args_parser().parse_args(common + [
        "--data-root", test_root, "--resume", ckpt, "--save-dir", save_dir,
        "--no-feature-metrics"]))
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    sweep_counts = read_counts()
    expect_native(f"test --resume {name}", read_decoded(save_dir))
    if not all(math.isfinite(v) for v in summary.values()):
        fail(f"test --resume {name}: non-finite metrics {summary}")
    return stats, train_s, train_counts, summary, sweep_s, sweep_counts, ckpt


def check_families(rng, tmp: str, test_root: str, x_gen):
    """Phase 27: RED-CNN (96), EDCNN (32, the compound loss on the registry's
    ResNet50) and the ablations Ablation_CLS_SEG_REC_NDS_RC (REDCNN
    generator, all heads) and ..._ResFFT at full width, each through the
    ``train`` CLI (2 steps of 20 slices, ``window_patch``) and ``test
    --resume`` on phase 5's 16 slices at 512x512; RED-CNN one step on
    ``full`` (whole slices, batch FULL_SLICES). Held: finite metrics; the
    card's forward of each trained model against the CPU forward of the same
    weights; the ResFFT ablation's K1 + K2 launches (21 + 21 a train step,
    21 K1 per validation slice, 42 K1 per sweep) and none of any kernel on
    the other three models' paths. Timed: each model's ``generate`` /
    ``predict`` at 512x512, batch 8, and its train step on 160 patches; a
    profile of the REDCNN generator's ``generate``. Returns the ResFFT
    ablation's (K1, K2) launches of its train run and sweep."""
    root = os.path.join(tmp, "family_data")
    write_split(root, "train", rng, 2 * TRAIN_SLICES)
    write_split(root, "valid", rng, 2)
    full_root = os.path.join(tmp, "family_full")
    write_split(full_root, "train", rng, FULL_SLICES)
    write_split(full_root, "valid", rng, 1)
    x, y = train_patches(rng, seed=27)
    x_cmp = torch.tensor(phantom(rng, 2, 128)[..., None], dtype=torch.float32)
    ablation_launches = (0, 0)
    for name, kwargs in FAMILY_MODELS:
        stats, train_s, train_counts, summary, sweep_s, sweep_counts, ckpt = family_run(
            name, kwargs, root, test_root, tmp)
        resfft = name == RESFFT_ABLATION
        # 2 steps x 21 K1 + 21 K2, and 21 K1 per 512x512 validation slice
        expect_counts(f"train CLI {name}", train_counts,
                      {"K1": 2 * 21 + 2 * 21, "K2": 2 * 21} if resfft else {})
        expect_counts(f"test --resume {name}", sweep_counts, {"K1": 2 * 21} if resfft else {})
        if resfft:
            ablation_launches = (train_counts["K1"] + sweep_counts["K1"], train_counts["K2"])
        loss_key = "train_loss" if family_of(name) == "cnn" else "train_g_loss"
        print(f"family {name}: train CLI 1 epoch of 2 steps x {TRAIN_SLICES} slices in "
              f"{train_s:.3f} s (validation and checkpoint included), {loss_key} "
              f"{stats[loss_key]:.6f}, valid_loss {stats['valid_loss']:.6f}, launches "
              f"{train_counts}; test --resume 16 slices 512x512 in {sweep_s:.3f} s, "
              f"pred_psnr {summary['pred_psnr']:.4f} pred_ssim {summary['pred_ssim']:.5f}, "
              f"launches {sweep_counts}", flush=True)

        # the trained weights on the card against the CPU
        card = get_model(name, **kwargs, device="cuda", seed=1)
        cpu = get_model(name, **kwargs, device="cpu", seed=1)
        for m in (card, cpu):
            load_pretrained(ckpt, m)
        run = (lambda m, z: m.predict(z)) if family_of(name) == "cnn" else (
            lambda m, z: m.generate(z))
        got = run(card, x_cmp.cuda())
        want = run(cpu, x_cmp)
        tol = TOL_GENERATE_ABS if resfft else TOL_FAMILY_ABS
        err = (got.cpu() - want).abs().max().item()
        if got.shape != x_cmp.shape or not torch.isfinite(got).all() or err > tol:
            fail(f"family {name}: card vs CPU forward {tuple(got.shape)}, max_abs {err:.3e} "
                 f"> {tol}")
        print(f"family {name}: card vs CPU forward 128x128 batch 2 max_abs {err:.3e} (tol "
              f"{tol})", flush=True)
        del cpu

        # times: the forward at 512x512 batch 8, a train step on 160 patches
        fwd_ms = cuda_ms(lambda: run(card, x_gen), 3)
        trainer = build_trainer(name, card, train_cli.get_args_parser().parse_args([]))
        zero_counts()
        trainer.train_step(x, y)
        torch.cuda.synchronize()
        expect_counts(f"train step {name}", read_counts(),
                      {"K1": 21, "K2": 21} if resfft else {})
        torch.cuda.reset_peak_memory_stats()
        step_ms = cuda_ms(lambda: trainer.train_step(x, y), 3)
        print(f"time family {name}: forward 512x512 batch 8 {fwd_ms:.2f} ms = "
              f"{8e3 / fwd_ms:.2f} slices/s; train step 160 x 64x64 {step_ms:.2f} ms = "
              f"{160e3 / step_ms:.2f} patches/s, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        if name == "Ablation_CLS_SEG_REC_NDS_RC":
            profile("generate REDCNN-generator ablation 512x512 batch 8",
                    lambda: card.generate(x_gen))
        del card, trainer

    # RED-CNN on whole slices: one step of FULL_SLICES 512x512 slices
    torch.cuda.reset_peak_memory_stats()
    stats, train_s, counts, *_ = family_run("RED_CNN", {"out_ch": 96}, full_root, test_root,
                                            tmp, preset="full", batch=FULL_SLICES)
    expect_counts("train CLI RED_CNN full", counts, {})
    print(f"family RED_CNN full: 1 step of {FULL_SLICES} slices 512x512 in {train_s:.3f} s "
          f"(validation and checkpoint included), train_loss {stats['train_loss']:.6f}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return ablation_launches


def _new_family_forward(name: str, model, x):
    """A trained model's full-image output: ``generate`` for the GAN
    families, CTformer and Restormer through the sliding window at the
    validation setting (overlap 0.3, 32 tiles a chunk, constant)."""
    if family_of(name) == "tr":
        return sliding_window_inference(x, (64, 64), model.predict, mode="constant",
                                        **TR_VALID)
    return model.generate(x)


def check_gradient_penalty(x, y):
    """Phase 28: WGAN-VGG's penalty and its gradient w.r.t. every critic
    leaf on the card against the CPU, on the same weights and draws."""
    models = {dev: WGANVGGModel(use_perceptual=False, device=dev, seed=3)
              for dev in ("cuda", "cpu")}
    xs, ys = x[:16], y[:16]
    fake = models["cuda"].generate(xs)
    a = torch.rand((16, 1, 1, 1), generator=torch.Generator().manual_seed(4))
    out = {}
    for dev, m in models.items():
        gp = wgan_gradient_penalty(m.critic, ys.to(m.device), fake.to(m.device),
                                   a.to(m.device))
        params = dict(m.discriminator.named_parameters())
        grads = torch.autograd.grad(gp, list(params.values()), allow_unused=True)
        out[dev] = (gp.item(), {k: (torch.zeros_like(p) if g is None else g).cpu()
                                for (k, p), g in zip(params.items(), grads)})
    (gp_card, g_card), (gp_cpu, g_cpu) = out["cuda"], out["cpu"]
    err = abs(gp_card - gp_cpu) / abs(gp_cpu)
    rel_l2 = {k: (torch.linalg.vector_norm(g_card[k] - g_cpu[k])
                  / max(torch.linalg.vector_norm(g_cpu[k]), 1e-30)).item() for k in g_cpu}
    leaf = max(rel_l2, key=rel_l2.get)
    worst_max = max(((g_card[k] - g_cpu[k]).abs().max()
                     / max(g_cpu[k].abs().max(), 1e-30)).item() for k in g_cpu)
    if not math.isfinite(gp_card) or err > TOL_GP_REL or rel_l2[leaf] > TOL_GP_GRAD_L2:
        fail(f"gradient penalty card vs CPU: gp {gp_card} vs {gp_cpu} (rel {err:.3e}, tol "
             f"{TOL_GP_REL}), worst leaf {leaf} gradient rel 2-norm {rel_l2[leaf]:.3e} "
             f"(tol {TOL_GP_GRAD_L2})")
    print(f"gradient penalty WGAN-VGG critic, 16 x 64x64: card {gp_card:.6f} CPU "
          f"{gp_cpu:.6f} rel {err:.3e} (tol {TOL_GP_REL}); D gradient worst leaf {leaf} "
          f"rel 2-norm {rel_l2[leaf]:.3e} (tol {TOL_GP_GRAD_L2}), worst max-norm "
          f"{worst_max:.3e}", flush=True)


def check_dugan_coins(model, x, y):
    """Phase 28: a DU-GAN step with both CutMix coins forced on, then one
    with both off: the domain totals are the LSGAN terms plus the CutMix
    and consistency terms, or the LSGAN terms alone; every ``u`` advances in
    both."""
    trainer = build_trainer("DU_GAN", model, train_cli.get_args_parser().parse_args([]))
    box = [torch.tensor(v, device="cuda") for v in (0.3, 0.5, 0.5)]
    for coin in (1.0, 0.0):
        draws = CutMix(*box, torch.tensor(coin, device="cuda"))
        u0 = {k: v.clone() for k, v in model.image_discriminator.state_dict().items()
              if k.endswith("weight_u")}
        zero_counts()
        m = {k: v.item() for k, v in trainer.train_step(
            x, y, draws={"img": draws, "grad": draws}).items()}
        expect_counts(f"DU-GAN step coin {coin}", read_counts(), {})
        moved = sum(not torch.equal(v, model.image_discriminator.state_dict()[k])
                    for k, v in u0.items())
        for dom in ("Img", "Grad"):
            total = m[f"d_{dom.lower()}_loss"]
            want = m[f"D/{dom}_disc_loss"] + coin * (m[f"D/{dom}_cutmix_loss"]
                                                     + m[f"D/{dom}_cr_loss"])
            if not all(math.isfinite(v) for v in m.values()) or abs(total - want) > 1e-5 * (
                    1.0 + abs(want)) or moved != len(u0):
                fail(f"DU-GAN step coin {coin}: {dom} total {total} vs {want}, {moved} of "
                     f"{len(u0)} u moved, metrics {m}")
        print(f"DU-GAN step coin {'on' if coin else 'off'}: d_img_loss {m['d_img_loss']:.6f} "
              f"(cutmix {m['D/Img_cutmix_loss']:.6f}, cr {m['D/Img_cr_loss']:.6f}), "
              f"d_grad_loss {m['d_grad_loss']:.6f}, g_loss {m['g_loss']:.6f}; "
              f"{moved} of {len(u0)} u advanced", flush=True)


def check_new_families(rng, tmp: str, test_root: str, x_gen, model):
    """Phase 28: WGAN-VGG, MAP-NN, DU-GAN, CTformer and Restormer at their
    published widths (seed 0; WGAN-VGG's perceptual loss on the registry's
    VGG19), each through the ``train`` CLI (2 steps of 20 slices,
    ``window_patch``, validation; 4 critic updates a step for WGAN-VGG and
    MAP-NN; Restormer RESTORMER_TRAIN_SLICES a step) and ``test --resume``
    (the WGAN family on phase 5's 16 slices, the tr family on
    TR_SWEEP_SLICES at overlap 0.9). Held: finite
    metrics; the card's forward of each trained model against the CPU's on
    the same weights; the gradient penalty and its D gradient card vs CPU;
    DU-GAN's step with the CutMix coin forced on and off;
    ``discriminate_full`` on one 512x512 slice; no launch of K1 - K8 on any
    of these paths. Timed: each model's forward at 512x512, batch 8 (the tr
    family through the sliding window at overlap 0.3), and its train step
    on 160 patches (Restormer's on 32); a profile of Restormer's
    sliding-window forward."""
    root = os.path.join(tmp, "family_data")  # phase 27's train and valid splits
    roots = {name: os.path.join(tmp, f"{name}_data") for name in TR_SWEEP_SLICES}
    for name, n in TR_SWEEP_SLICES.items():
        write_split(roots[name], "test", rng, n)
    # Restormer's train and valid splits: 2 steps of RESTORMER_TRAIN_SLICES
    restormer_root = os.path.join(tmp, "restormer_train")
    write_split(restormer_root, "train", rng, 2 * RESTORMER_TRAIN_SLICES)
    write_split(restormer_root, "valid", rng, 2)
    x, y = train_patches(rng, seed=28)
    x_cmp = torch.tensor(phantom(rng, 2, 128)[..., None], dtype=torch.float32)
    x_window = x_cmp[:1, :64, :96].contiguous()  # two 64x64 tiles at overlap 0.5
    check_gradient_penalty(x, y)
    for name in NEW_FAMILY_MODELS:
        tr = family_of(name) == "tr"
        n_train = RESTORMER_TRAIN_SLICES if name == "Restormer" else TRAIN_SLICES
        stats, train_s, train_counts, summary, sweep_s, sweep_counts, ckpt = family_run(
            name, {}, restormer_root if name == "Restormer" else root,
            roots[name] if tr else test_root, tmp, batch=n_train)
        expect_counts(f"train CLI {name}", train_counts, {})
        expect_counts(f"test --resume {name}", sweep_counts, {})
        n_sweep = TR_SWEEP_SLICES[name] if tr else 16
        loss_key = "train_loss" if tr else "train_g_loss"
        print(f"family {name}: train CLI 1 epoch of 2 steps x {n_train} slices in "
              f"{train_s:.3f} s (validation and checkpoint included), {loss_key} "
              f"{stats[loss_key]:.6f}, valid_loss {stats['valid_loss']:.6f}; test --resume "
              f"{n_sweep} slices 512x512 in {sweep_s:.3f} s = {n_sweep / sweep_s:.4f} "
              f"slices/s, pred_psnr {summary['pred_psnr']:.4f} pred_ssim "
              f"{summary['pred_ssim']:.5f}; launches {train_counts} / {sweep_counts}",
              flush=True)

        card = get_model(name, device="cuda", seed=1)
        cpu = get_model(name, device="cpu", seed=1)
        for m in (card, cpu):
            load_pretrained(ckpt, m)
        z = x_window if tr else x_cmp
        if tr:
            fwd = lambda m, v: sliding_window_inference(v, (64, 64), m.predict, mode="constant",
                                                        overlap=0.5, sw_batch_size=2)
        else:
            fwd = lambda m, v: m.generate(v)
        got, want = fwd(card, z.cuda()), fwd(cpu, z)
        err = (got.cpu() - want).abs().max().item()
        if got.shape != z.shape or not torch.isfinite(got).all() or err > TOL_NEW_FAMILY_ABS:
            fail(f"family {name}: card vs CPU forward {tuple(got.shape)}, max_abs {err:.3e} "
                 f"> {TOL_NEW_FAMILY_ABS}")
        print(f"family {name}: card vs CPU forward {tuple(z.shape[1:3])} batch {z.shape[0]} "
              f"max_abs {err:.3e} (tol {TOL_NEW_FAMILY_ABS})", flush=True)
        del cpu

        trainer = build_trainer(name, card, train_cli.get_args_parser().parse_args([]))
        n_patch = n_train * CROPS
        xs, ys = x[:n_patch], y[:n_patch]
        zero_counts()
        fwd_ms = cuda_ms(lambda: _new_family_forward(name, card, x_gen), 2 if tr else 3)
        trainer.train_step(xs, ys)
        torch.cuda.synchronize()
        expect_counts(f"forward and train step {name}", read_counts(), {})
        torch.cuda.reset_peak_memory_stats()
        step_ms = cuda_ms(lambda: trainer.train_step(xs, ys), 3)
        how = "sliding window overlap 0.3" if tr else "generate"
        print(f"time family {name}: forward 512x512 batch 8 ({how}) {fwd_ms:.2f} ms = "
              f"{8e3 / fwd_ms:.4f} slices/s; train step {n_patch} x 64x64 {step_ms:.2f} ms = "
              f"{n_patch * 1e3 / step_ms:.2f} patches/s, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        if name == "DU_GAN":
            check_dugan_coins(card, x, y)
        if name == "Restormer":
            profile("Restormer sliding window 512x512 batch 8 overlap 0.3",
                    lambda: _new_family_forward(name, card, x_gen))
        del card, trainer

    # the flagship's discriminator over one whole slice
    zero_counts()
    t0 = time.perf_counter()
    cls, seg, rec = model.discriminate_full(x_gen[:1])
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    expect_counts("discriminate_full", read_counts(), {})
    n_tiles = len(dense_patch_positions(512, 64, 0.5)) ** 2
    if (cls.shape != (1, n_tiles, 1) or seg.shape != x_gen[:1].shape
            or rec.shape != x_gen[:1].shape
            or not all(torch.isfinite(t).all() for t in (cls, seg, rec))):
        fail(f"discriminate_full: shapes {cls.shape}, {seg.shape}, {rec.shape}")
    print(f"discriminate_full 512x512 (overlap 0.5, gaussian, 64 tiles a chunk): "
          f"{n_tiles} tiles in {full_s:.3f} s", flush=True)


DN_MODELS = {"DDPM": DDPMModel, "DDIM": DDIMModel, "PNDM": PNDMModel, "DPM": DPMModel}


def unet_flops(size: int, batch: int = 1) -> float:
    """FLOPs of one full-width UNet forward: convs, linears and the
    attention products counted by ``FlopCounterMode`` over a forward on the
    meta device (elementwise ops, GroupNorm and softmax not counted)."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        net = DiffusionUNet()
        x = torch.empty(batch, 2, size, size)
        t = torch.zeros(batch, dtype=torch.long)
    with FlopCounterMode(display=False) as counter:
        net(x, t)
    return float(counter.get_total_flops())


def once_ms(fn):
    """(fn's result, its ms by CUDA events over that one call)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def draw_unet_weights(net, seed: int) -> None:
    """Every leaf drawn (on the CPU, then copied): kernels N(0, 1/fan_in),
    biases and GroupNorm offsets N(0, 0.1^2) added to their init, so
    ``conv2`` and ``out_conv`` are not zero."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            d = (torch.randn(p.shape, generator=g) / p[0].numel() ** 0.5 if p.dim() > 1
                 else 0.1 * torch.randn(p.shape, generator=g))
            p.copy_(d.to(p.device) if p.dim() > 1 else p + d.to(p.device))


def check_diffusion_cpu(rng):
    """Phase 29: at 64x64 on drawn weights, the card against the CPU: one
    UNet forward (batch 2), a 3-step chain of each sampler from the same
    draws (batch 1), one loss from the same draws and its gradient."""
    cpu = DDIMModel(device="cpu", seed=3)
    draw_unet_weights(cpu.net, 3)
    card = DDIMModel(device="cuda", seed=3)
    card.net.load_state_dict(cpu.net.state_dict())
    g = torch.Generator().manual_seed(64)
    cond = torch.tensor(phantom(rng, 2, 64)[..., None], dtype=torch.float32)
    x_t = torch.randn(cond.shape, generator=g)
    t = torch.tensor([40, 700])
    zero_counts()
    with torch.no_grad():
        want = cpu.eps(x_t, cond, t)
        got = card.eps(x_t.cuda(), cond.cuda(), t.cuda()).cpu()
    err = rel_max(got, want)
    if not torch.isfinite(got).all() or err > TOL_DN_FORWARD_REL:
        fail(f"diffusion UNet forward card vs CPU: max-relative {err:.3e} > "
             f"{TOL_DN_FORWARD_REL}")
    print(f"diffusion UNet forward 64x64 batch 2 card vs CPU (drawn weights): max-relative "
          f"{err:.3e} (tol {TOL_DN_FORWARD_REL})", flush=True)
    errs = {}
    for name, cls in DN_MODELS.items():
        draws = {"noise": torch.randn((1, 64, 64, 1), generator=g),
                 "z": torch.randn((3, 1, 64, 64, 1), generator=g)}
        for m in (cpu, card):
            m.scheduler, m.n_inference_steps = cls.scheduler_cls(), 3
        want = cpu.sample(cond[:1], draws=draws)
        got = card.sample(cond[:1].cuda(), draws={k: v.cuda() for k, v in draws.items()}).cpu()
        errs[name] = rel_max(got, want)
        if not torch.isfinite(got).all() or errs[name] > TOL_DN_CHAIN_REL:
            fail(f"diffusion {name} 3-step chain card vs CPU: max-relative "
                 f"{errs[name]:.3e} > {TOL_DN_CHAIN_REL}")
    print(f"diffusion 3-step chains 64x64 card vs CPU (same draws): "
          f"{', '.join(f'{k} {v:.3e}' for k, v in errs.items())} max-relative (tol "
          f"{TOL_DN_CHAIN_REL})", flush=True)
    y = (cond + 0.02 * torch.randn(cond.shape, generator=g)).clamp(0, 1)
    draws = {"noise": torch.randn(cond.shape, generator=g), "t": torch.tensor([17, 930])}
    out = {}
    for m in (cpu, card):
        dev = m.device
        m.net.zero_grad()
        loss, _ = m.loss(cond.to(dev), y.to(dev), draws={k: v.to(dev) for k, v in draws.items()})
        loss.backward()
        out[dev.type] = (loss.item(), {k: p.grad.cpu() for k, p in m.net.named_parameters()})
    expect_counts("diffusion card vs CPU", read_counts(), {})
    (l_card, g_card), (l_cpu, g_cpu) = out["cuda"], out["cpu"]
    loss_err = abs(l_card - l_cpu) / abs(l_cpu)
    rel_l2 = {}
    for k in g_cpu:
        if k.endswith("to_k.bias"):  # zero in exact arithmetic: round-off on both sides
            ref = torch.linalg.vector_norm(g_cpu[k.replace("bias", "weight")])
        else:
            ref = torch.linalg.vector_norm(g_cpu[k])
        rel_l2[k] = (torch.linalg.vector_norm(g_card[k] - g_cpu[k]) / max(ref, 1e-30)).item()
    leaf = max(rel_l2, key=rel_l2.get)
    if not math.isfinite(l_card) or loss_err > TOL_DN_LOSS_REL or rel_l2[leaf] > TOL_DN_GRAD_L2:
        fail(f"diffusion loss card vs CPU: {l_card} vs {l_cpu} (rel {loss_err:.3e}), worst "
             f"gradient leaf {leaf} rel 2-norm {rel_l2[leaf]:.3e}")
    print(f"diffusion eps-MSE 64x64 batch 2 card vs CPU: loss {l_card:.6f} vs {l_cpu:.6f} rel "
          f"{loss_err:.3e} (tol {TOL_DN_LOSS_REL}); gradient worst leaf {leaf} rel 2-norm "
          f"{rel_l2[leaf]:.3e} (tol {TOL_DN_GRAD_L2})", flush=True)


def check_diffusion(tmp: str):
    """Phase 29: the diffusion family at its published width. Held: finite
    samples of the input's shape; the train and test CLIs' finite metrics;
    the card against the CPU (``check_diffusion_cpu``); no launch of K1 -
    K8 on any path. Timed: the 512x512 UNet forward beside its FLOPs, a
    10-step DDPM segment at 512x512, 50-step DDIM, DPM and PNDM samples at
    256x256, a train step on 160 patches and its peak memory, the CLIs."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(29)
    model = DDIMModel(device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(29)
    cond = torch.tensor(phantom(rng, 1, 512)[..., None], dtype=torch.float32, device="cuda")
    x_t = torch.randn(cond.shape, generator=g, device="cuda")
    t500 = torch.full((1,), 500, device="cuda")
    zero_counts()
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: model.eps(x_t, cond, t500), 3)
        # a 10-step segment of the 1000-step DDPM chain at 512x512
        sched = DDPMScheduler()
        steps = sched.timesteps(1000)[:DN_SEGMENT_STEPS]

        def segment():
            carry = sched.init_carry(torch.randn(cond.shape, generator=g, device="cuda"))
            for k, t in enumerate(steps):
                eps = model.eps(carry[0], cond, torch.full((1,), t, device="cuda"))
                z = torch.randn(cond.shape, generator=g, device="cuda")
                carry = sched.step(carry, k, t, eps, 1000, z)
            return carry[0]

        seg, seg_ms = once_ms(segment)
        cond256 = torch.tensor(phantom(rng, 1, DN_CLI_SIZE)[..., None], dtype=torch.float32,
                               device="cuda")
        samples = {}
        for name in ("DDIM", "DPM", "PNDM"):
            model.scheduler = DN_MODELS[name].scheduler_cls()
            model.n_inference_steps = DN_MODELS[name].n_inference_steps
            out, ms = once_ms(lambda: model.sample(cond256, generator=g))
            if out.shape != cond256.shape or not torch.isfinite(out).all():
                fail(f"diffusion {name} sample 256x256: {tuple(out.shape)}, finite "
                     f"{bool(torch.isfinite(out).all())}")
            samples[name] = ms
        model.scheduler = DDIMModel.scheduler_cls()
        model.n_inference_steps = DDIMModel.n_inference_steps
    expect_counts("diffusion forward and samples", read_counts(), {})
    if not torch.isfinite(seg).all():
        fail("diffusion DDPM segment 512x512: non-finite sample")
    flops512, flops256 = unet_flops(512), unet_flops(DN_CLI_SIZE)
    print(f"time diffusion UNet forward 512x512 batch 1 ({flops512 / 1e12:.3f} TFLOP, fp32 "
          f"bound {flops512 / PEAK_FP32_FLOPS * 1e3:.2f} ms, plain chunked attention): {fwd_ms:.2f} "
          f"ms, {flops512 / fwd_ms / 1e9:.2f} TFLOP/s", flush=True)
    print(f"time diffusion DDPM segment 512x512 batch 1: {DN_SEGMENT_STEPS} steps in "
          f"{seg_ms:.2f} ms = {seg_ms / DN_SEGMENT_STEPS:.2f} ms/step (a 1000-step sample "
          f"~{seg_ms / DN_SEGMENT_STEPS:.0f} s)", flush=True)
    print(f"time diffusion samples 256x256 batch 1, 50 steps ({flops256 / 1e12:.3f} TFLOP a "
          f"step): {', '.join(f'{k} {v:.2f} ms ({v / 50:.2f} ms/step)' for k, v in samples.items())}",
          flush=True)

    # a train step on the reference batch, fp32, TF32 off
    x, y = train_patches(rng, seed=29)
    trainer = build_trainer("DDIM", model, train_cli.get_args_parser().parse_args([]))
    zero_counts()
    m = trainer.train_step(x, y)
    torch.cuda.synchronize()
    expect_counts("diffusion train step", read_counts(), {})
    if not math.isfinite(m["loss"].item()):
        fail(f"diffusion train step: loss {m['loss'].item()}")
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: trainer.train_step(x, y), 3)
    step_flops = 3 * unet_flops(64, len(x))
    print(f"time diffusion train step {len(x)} x 64x64 (DDIM, AdamW, fp32, TF32 off; "
          f"~{step_flops / 1e12:.2f} TFLOP as 3x the forward's): {step_ms:.2f} ms = "
          f"{len(x) * 1e3 / step_ms:.2f} patches/s, {step_flops / step_ms / 1e9:.2f} TFLOP/s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    # a validation chunk: the sliding window's 32 and 17 tiles of a 256x256
    # slice, each a whole 50-step DDIM chain
    tiles = x[:32, ..., :1].contiguous()
    with torch.no_grad():
        chunk_ms = {n: cuda_ms(lambda: model.eps(tiles[:n], tiles[:n], t500.expand(n)), 3)
                    for n in (32, 17)}
        _, sample32_ms = once_ms(lambda: model.sample(tiles, generator=g))
    print(f"time diffusion validation chunk 64x64: UNet forward batch 32 "
          f"{chunk_ms[32]:.2f} ms, batch 17 {chunk_ms[17]:.2f} ms; 50-step DDIM sample batch "
          f"32 {sample32_ms:.2f} ms", flush=True)
    profile("diffusion UNet forward 64x64 batch 32",
            lambda: model.eps(tiles, tiles, t500.expand(32)))
    del model, trainer, x, y

    # the CLIs: one DDIM epoch of 2 steps with validation, test --resume
    root = os.path.join(tmp, "dn_data")
    write_split(root, "train", rng, 2 * TRAIN_SLICES, DN_CLI_SIZE)
    write_split(root, "valid", rng, 1, DN_CLI_SIZE)
    write_split(root, "test", rng, 2, DN_CLI_SIZE)
    stats, train_s, train_counts, summary, sweep_s, sweep_counts, _ = family_run(
        "DDIM", {}, root, root, tmp)
    expect_counts("train CLI DDIM", train_counts, {})
    expect_counts("test --resume DDIM", sweep_counts, {})
    print(f"family DDIM: train CLI 1 epoch of 2 steps x {TRAIN_SLICES} slices "
          f"{DN_CLI_SIZE}x{DN_CLI_SIZE} in {train_s:.3f} s (validation of 1 slice through "
          f"the window at overlap 0.5, 49 tiles, and checkpoint included), train_loss "
          f"{stats['train_loss']:.6f}, valid_loss {stats['valid_loss']:.6f}; test --resume 2 "
          f"slices in {sweep_s:.3f} s, pred_psnr {summary['pred_psnr']:.4f} pred_ssim "
          f"{summary['pred_ssim']:.5f}; launches {train_counts} / {sweep_counts}", flush=True)

    check_diffusion_cpu(rng)
    print(f"phase 29 (diffusion): {time.perf_counter() - t_phase:.1f} s", flush=True)


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = bench.card_name()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # ---- 2. build the six sources in parallel (one nvcc each)
    t0 = time.perf_counter()
    names = ("block_fused", "block_bwd", "spectral_tiled", "spectral_fused", "conv3x3",
             "spectral_staged")
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        libs = list(pool.map(_build.build, names))
    _build.block_fused_library()
    _build.block_bwd_library()
    _build.spectral_tiled_library()
    _build.spectral_fused_library()
    _build.conv3x3_library()
    staged_lib = _build.spectral_staged_library()
    print(f"build: {', '.join(names)} in {time.perf_counter() - t0:.2f} s", flush=True)
    for lib in libs:
        log = lib.with_suffix(".log")
        if log.exists():
            print(log.read_text().strip(), flush=True)

    # ---- 3. K1 against its plain version
    irfft2_cuda_vs_cpu()
    max_abs_err = check_kernel()

    # ---- 4. generate at full width
    model = MTDGANModel(gen_features=C, num_layers=10, device="cuda", seed=0)
    rng = np.random.default_rng(0)
    x_gen = torch.tensor(phantom(rng, 8, 512)[..., None], dtype=torch.float32,
                         device="cuda")
    check_generate(model, x_gen, "k1", {"K1": 21})

    n_slices = 16
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # ---- 5. serving at 512x512: the main path on K1
        sweep_s, _ = run_sweep(model, rng, tmp, 512, {"K1": 2 * 21}, n_slices)

        # ---- 26. the feature metrics: the test CLI at its default (PL, TML,
        # FID) on phase 5's set, in turns without them; the extractors on
        # the card against the CPU in float64, their times, the weights
        feature_runs = feature_sweep(model, os.path.join(tmp, "data512"), tmp, n_slices)
        feature_times = check_features(rng)

        # ---- 27. the CNN family and two ablations through the train and
        # test CLIs; the ResFFT ablation on K1 + K2
        ablation_launches = check_families(rng, tmp, os.path.join(tmp, "data512"), x_gen)

        # ---- 28. the WGAN and transformer families through the train and
        # test CLIs; none of K1 - K8 on their paths
        check_new_families(rng, tmp, os.path.join(tmp, "data512"), x_gen, model)

        # ---- 29. the diffusion family through the train and test CLIs;
        # none of K1 - K8 on its paths
        check_diffusion(tmp)

        # ---- 6. K8 against its plain version
        k8_max_abs_err = check_k8()

        # ---- 7. generate at 448x448 and 512x320 on the tiled path
        x448 = torch.tensor(phantom(rng, 8, 448)[..., None], dtype=torch.float32,
                            device="cuda")
        x_rect = torch.tensor(phantom(rng, 2, 512)[:, :, 96:416, None],
                              dtype=torch.float32, device="cuda")
        for x in (x448, x_rect):
            check_generate(model, x, "tiled", {"K8": 21, **K3_PER_CALL})

        # ---- 8. serving at 448x448: the main path on K8
        two_calls = {k: 2 * v for k, v in K3_PER_CALL.items()}
        sweep448_s, counts = run_sweep(model, rng, tmp, 448, {"K8": 2 * 21, **two_calls},
                                       n_slices)
        k8_sweep = counts["K8"]

        # ---- 9. K7 against its plain version
        k7_max_abs_err = check_k7()

        # ---- 10. generate at 96x96 and 100x72 on the fused path
        x96 = torch.tensor(phantom(rng, 64, 96)[..., None], dtype=torch.float32,
                           device="cuda")
        x_small = torch.tensor(phantom(rng, 4, 100)[:, :, 14:86, None],
                               dtype=torch.float32, device="cuda")
        for x in (x96, x_small):
            check_generate(model, x, "fused", {"K7": 21, **K3_PER_CALL})
        # the fused route adds the block's residual inside K7, as the tiled
        # route does inside K8: both generators make the same aten::add calls
        adds = {route: count_adds(lambda: model.generate(x_in))
                for route, x_in in (("fused", x96), ("tiled", x448))}
        print(f"generate aten::add calls: fused 96x96 {adds['fused']}, tiled 448x448 "
              f"{adds['tiled']}", flush=True)
        if adds["fused"] != adds["tiled"]:
            fail(f"the fused route makes {adds['fused']} aten::add calls, the tiled "
                 f"{adds['tiled']}: a separate residual add")

        # ---- 11. serving at 96x96: the main path on K7
        sweep96_s, counts = run_sweep(model, rng, tmp, 96, {"K7": 2 * 21, **two_calls},
                                      n_slices)
        k7_sweep = counts["K7"]

        # ---- 12. K3 against its plain version
        k3_max_abs_err = check_k3()
        count_tensor_core_instructions("K3", libs[names.index("conv3x3")])
        count_tensor_core_instructions("K1", libs[names.index("block_fused")])
        count_tensor_core_instructions("K2", libs[names.index("block_bwd")])

        # ---- 13. K4, K5 and K6 against their plain versions
        staged_max_abs_err = check_staged(staged_lib)

        # ---- 14. generate at 1024x1024 and 200x200 on the staged path
        x1024 = torch.tensor(phantom(rng, 2, 1024)[..., None], dtype=torch.float32,
                             device="cuda")
        x200 = torch.tensor(phantom(rng, 8, 200)[..., None], dtype=torch.float32,
                            device="cuda")
        for x in (x1024, x200):
            check_generate(model, x, "staged", STAGED_PER_CALL)

        # ---- 15. serving at 1024x1024: the main path on K3 - K6
        n_hires = 8
        sweep1024_s, staged_sweep = run_sweep(
            model, rng, tmp, 1024, dict(STAGED_PER_CALL), n_hires)

    # ---- 16. F1: generate on the plain route, no kernel launch
    check_plain_route("generate 200x200 batch 2 at gen_features=64", 64, 10,
                      torch.tensor(phantom(rng, 2, 200)[..., None], dtype=torch.float32,
                                   device="cuda"))
    check_plain_route("generate 1x64 at gen_features=32", C, 10,
                      torch.tensor(phantom(rng, 1, 64)[:, 32:33, :, None],
                                   dtype=torch.float32, device="cuda"))

    # ---- 17. K2 against its plain version
    k2_accuracy()
    k2_max_abs_err = check_k2()
    check_k2_recompute()

    # ---- 18. the train step at full width
    x, y = train_patches(rng, seed=0)
    trainer = check_train_step(x, y)
    train_step_spread()

    # ---- 19. F2: a train step at a width K1 and K2 do not take
    check_train_width64(x[:16], y[:16])

    # ---- 20. the training path through its CLI, then test --resume; a
    # second run with UW and the rest of the root flags, then test
    # --checkpoint-dir --epoch 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        train_launches = check_train_cli(rng, tmp)

    # ---- 22. the native DICOM decoder; 23. the sweep's host-time split
    n_split = 64
    with tempfile.TemporaryDirectory(prefix="chip_smoke_split_") as tmp:
        split_root = os.path.join(tmp, "data")
        write_split(split_root, "test", rng, n_split)
        check_decoder(split_root)
        sweep_split(model, split_root, tmp, n_split)

    # ---- 24. the bench CLI's sweep on the K1 route
    check_bench()

    # ---- 25. one train step per MTO method on K1 + K2
    check_mto_methods(x, y)

    # ---- 21. timings (CUDA events)
    times = {}
    for vi, variant in enumerate(VARIANTS):
        args = block_inputs(512, 8, "fan_in", variant, seed=vi)
        k_ms = cuda_ms(lambda: block_fused(**args), 10)
        p_ms = cuda_ms(lambda: block_fused_reference(**args), 10)
        (cc_ms, cc_by), (b_ms, by) = k1_bounds(8, 512, variant)
        times[variant] = (k_ms, p_ms, b_ms, by)
        print(f"time K1 512x512 batch 8 {variant:14s}: kernel {k_ms:.3f} ms, "
              f"plain {p_ms:.3f} ms, bound {b_ms:.3f} ms ({by}, convs on the tensor "
              f"cores in 3xTF32; fp32 CUDA-core bound {cc_ms:.3f} ms, {cc_by})",
              flush=True)
        if variant == "pre+skip":
            launch_split("K1 split 512x512 batch 8 pre+skip", lambda: block_fused(**args),
                         K1_LAUNCHES)
        del args
    bwd_times = {}
    for vi, variant in enumerate(VARIANTS):
        args = bwd_inputs(160, "fan_in", variant, seed=vi)
        k_ms = cuda_ms(lambda: block_bwd(**args), 10)
        p_ms = cuda_ms(lambda: block_bwd_reference(**args), 5)
        (cc_ms, cc_by), (b_ms, by) = k2_bounds(160, 64, variant)
        conv, other, nbytes = k2_work(160, 64, variant)
        bwd_times[variant] = (k_ms, p_ms, b_ms, by)
        print(f"time K2 64x64 batch 160 {variant:14s}: kernel {k_ms:.3f} ms, "
              f"plain {p_ms:.3f} ms, bound {b_ms:.3f} ms ({by}, convs and weight "
              f"gradients on the tensor cores in 3xTF32; fp32 CUDA-core bound "
              f"{cc_ms:.3f} ms, {cc_by}; {conv / 1e9:.2f} + {other / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB)", flush=True)
        if variant == "pre+skip":
            profile_k2_split("64x64 batch 160 pre+skip", args)
        del args
    fwd_args = block_inputs(64, 160, "fan_in", "pre+skip", seed=2)
    k1_train_ms = cuda_ms(lambda: block_fused(**fwd_args), 10)
    (cc_ms, _), (b_ms, _) = k1_bounds(160, 64, "pre+skip")
    print(f"time K1 64x64 batch 160 pre+skip: kernel {k1_train_ms:.3f} ms, bound "
          f"{b_ms:.3f} ms (fp32 CUDA-core bound {cc_ms:.3f} ms)", flush=True)
    launch_split("K1 split 64x64 batch 160 pre+skip", lambda: block_fused(**fwd_args),
                 K1_LAUNCHES)
    del fwd_args
    k8_args = tiled_inputs(8, 448, 448, "fan_in", seed=3)
    k8_ms = cuda_ms(lambda: spectral_branch_tiled(**k8_args), 10)
    k8_plain_ms = cuda_ms(lambda: spectral_branch_tiled_reference(**k8_args), 10)
    k8_bound_ms, k8_by = bound(k8_work(8, 448, 448))
    flops, nbytes = k8_work(8, 448, 448)
    print(f"time K8 448x448 batch 8 C={C} with residual: kernel {k8_ms:.3f} ms, plain "
          f"{k8_plain_ms:.3f} ms, bound {k8_bound_ms:.3f} ms ({k8_by}; "
          f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)", flush=True)
    with torch.no_grad():
        launch_split("K8 split 448x448 batch 8 with residual",
                     lambda: spectral_branch_tiled(**k8_args), K8_LAUNCHES)
    del k8_args
    # K7 as the fused route calls it (with the block's residual), and
    # without; beside it, in turns, the staged branch on the same input
    k7_args = tiled_inputs(64, 96, 96, "fan_in", seed=4)
    k7_alone = {**k7_args, "residual": None}
    k7_ms = cuda_ms(lambda: spectral_branch_fused(**k7_args), 10)
    k7_plain_ms = cuda_ms(lambda: spectral_branch_fused_reference(**k7_args), 10)
    k7_bound_ms, k7_by = bound(k7_work(64, 96, 96, residual=True))
    flops, nbytes = k7_work(64, 96, 96, residual=True)
    print(f"time K7 96x96 batch 64 C={C} with residual: kernel {k7_ms:.3f} ms, plain "
          f"{k7_plain_ms:.3f} ms, bound {k7_bound_ms:.3f} ms ({k7_by}; "
          f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)", flush=True)
    alone_ms = cuda_ms(lambda: spectral_branch_fused(**k7_alone), 10)
    alone_plain_ms = cuda_ms(lambda: spectral_branch_fused_reference(**k7_alone), 10)
    alone_bound = bound(k7_work(64, 96, 96, residual=False))
    print(f"time K7 96x96 batch 64 C={C} without residual: kernel {alone_ms:.3f} ms, plain "
          f"{alone_plain_ms:.3f} ms, bound {alone_bound[0]:.3f} ms ({alone_bound[1]})",
          flush=True)
    with torch.no_grad():
        k7_call = lambda: spectral_branch_fused(**k7_args)
        staged_call = lambda: irdft_w_add(spectral_mix_h(rdft_w(k7_args["x"]), k7_args["mix"],
                                                         k7_args["bias"]), k7_args["residual"])
        turns = [cuda_ms(f, 10) for f in (k7_call, staged_call, staged_call, k7_call)]
    print(f"time K7 96x96 batch 64 C={C} with residual {turns[0]:.3f} / {turns[3]:.3f} ms, "
          f"staged K4 -> K5 -> K6 with residual {turns[1]:.3f} / {turns[2]:.3f} ms "
          f"(K7, staged, staged, K7)", flush=True)
    del k7_args, k7_alone
    # K3 - K6 at the staged route's main-path shape, 1024x1024 batch 2
    staged_times = {}
    # K3 on its tensor-core path (3xTF32): the bound of that path, and
    # beside it the fp32 CUDA-core bound of the same convolution
    k3_cuda_core = bound(k3_work(2, 1024, 1024, "relu+residual"))
    args, kw = k3_calls(2, 1024, 1024, "fan_in", seed=5)["relu+residual"]
    k3_x, k3_w, k3_b = args
    staged_times["K3"] = (
        cuda_ms(lambda: conv3x3(*args, **kw), 10),
        cuda_ms(lambda: conv3x3_reference(*args, **kw), 10),
        cuda_ms(lambda: torch.nn.functional.conv2d(k3_x, k3_w, k3_b, padding=1), 10),
        bound(k3_work(2, 1024, 1024, "relu+residual", passes=3), PEAK_TF32_FLOPS))
    del args, kw, k3_x, k3_w, k3_b
    for n_k3, size in ((8, 448), (64, 96)):
        args, kw = k3_calls(n_k3, size, size, "fan_in", seed=5)["relu+residual"]
        k_ms = cuda_ms(lambda: conv3x3(*args, **kw), 10)
        c_ms = cuda_ms(lambda: torch.nn.functional.conv2d(*args, padding=1), 10)
        b_ms, by = bound(k3_work(n_k3, size, size, "relu+residual", passes=3),
                         PEAK_TF32_FLOPS)
        print(f"time K3 {size}x{size} batch {n_k3} C={C} relu+residual: kernel {k_ms:.3f} "
              f"ms, library {c_ms:.3f} ms, bound {b_ms:.3f} ms ({by}, tensor cores)",
              flush=True)
        del args, kw
    a = tiled_inputs(2, 1024, 1024, "fan_in", seed=6)
    z = rdft_w_reference(a["x"])
    staged_times["K4"] = (
        cuda_ms(lambda: rdft_w(a["x"]), 10), cuda_ms(lambda: rdft_w_reference(a["x"]), 10),
        cuda_ms(lambda: torch.fft.rfft(a["x"], dim=-1, norm="ortho"), 10),
        bound(k4_work(2, 1024, 1024)))
    k4_layout_ms = cuda_ms(lambda: torch.fft.rfft(a["x"], dim=-1, norm="ortho")
                           .transpose(-1, -2).contiguous(), 10)
    # what streaming K4's bytes costs on this card: a device copy of x
    # (268 MB read, 268 MB written, against K4's 269 MB written)
    copy_out = torch.empty_like(a["x"])
    k4_copy_ms = cuda_ms(lambda: copy_out.copy_(a["x"]), 10)
    del copy_out
    z5 = z.clone()  # K5 works in place: time it on a copy
    staged_times["K5"] = (
        cuda_ms(lambda: spectral_mix_h(z5, a["mix"], a["bias"]), 10),
        cuda_ms(lambda: spectral_mix_h_reference(z, a["mix"], a["bias"]), 10), None,
        bound(k5_work(2, 1024, 1024)))
    # the library's c2r on the same spectrum with the bins 0 and W/2 zeroed
    zz = z.clone()
    zz[:, :, 0].imag.zero_()
    zz[:, :, -1].imag.zero_()
    staged_times["K6"] = (
        cuda_ms(lambda: irdft_w_add(z, a["residual"]), 10),
        cuda_ms(lambda: irdft_w_add_reference(z, a["residual"]), 10),
        cuda_ms(lambda: a["residual"] + torch.fft.irfft(
            zz.transpose(-1, -2), n=1024, dim=-1, norm="ortho"), 10),
        bound(k6_work(2, 1024, 1024)))
    # K6 as K1 calls it: the sum written over the residual
    inout = a["residual"].clone()
    k6_inplace_ms = cuda_ms(lambda: k6_in_place(staged_lib, z, inout), 10)
    del a, z, z5, zz, inout
    # K5 at the staged route's other sizes: 800x800 (Q = 25 on a 2-CTA
    # cluster) and 200x200 (Q = 25, one CTA per bin), the generators' batches
    for n5, h5 in ((2, 800), (8, 200)):
        a = tiled_inputs(n5, h5, h5, "fan_in", seed=6)
        z = rdft_w_reference(a["x"])
        z5 = z.clone()
        k_ms = cuda_ms(lambda: spectral_mix_h(z5, a["mix"], a["bias"]), 10)
        p_ms = cuda_ms(lambda: spectral_mix_h_reference(z, a["mix"], a["bias"]), 10)
        b_ms, by = bound(k5_work(n5, h5, h5))
        print(f"time K5 {h5}x{h5} batch {n5} C={C}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} "
              f"ms, bound {b_ms:.3f} ms ({by}); odd step "
              f"{K5_BRANCHES[staged_lib.staged_mix_odd_branch(h5)]}, cluster of "
              f"{staged_lib.staged_mix_cluster_size(C, h5)}", flush=True)
        del a, z, z5
    for name, (k_ms, p_ms, l_ms, (b_ms, by)) in staged_times.items():
        lib_txt = "none" if l_ms is None else f"{l_ms:.3f} ms"
        extra = ""
        if name == "K3":
            extra = (f" (tensor cores, 3xTF32; fp32 CUDA-core bound {k3_cuda_core[0]:.3f} ms, "
                     f"{k3_cuda_core[1]})")
        elif name == "K4":
            extra = (f"; library with K4's layout (rfft, transpose, contiguous) "
                     f"{k4_layout_ms:.3f} ms; a device copy of x {k4_copy_ms:.3f} ms")
        elif name == "K5":
            extra = (f"; odd step {K5_BRANCHES[staged_lib.staged_mix_odd_branch(1024)]}, "
                     f"cluster of {staged_lib.staged_mix_cluster_size(C, 1024)}")
        elif name == "K6":
            extra = f"; in place (out = residual) {k6_inplace_ms:.3f} ms"
        print(f"time {name} 1024x1024 batch 2 C={C}: kernel {k_ms:.3f} ms, plain "
              f"{p_ms:.3f} ms, library {lib_txt}, bound {b_ms:.3f} ms ({by}){extra}",
              flush=True)
    gen_ms = cuda_ms(lambda: model.generate(x_gen), 3)
    print(f"time generate 512x512 batch 8: {gen_ms:.2f} ms/call = "
          f"{8e3 / gen_ms:.2f} slices/s", flush=True)
    # is generate_route's order (K1 before staged) still right at 512^2? The
    # staged generator on the same input, in turns with the K1 route; the
    # route itself is not changed here
    x_nchw = x_gen.reshape(8, 1, 512, 512).contiguous()
    with torch.no_grad():
        run_staged = lambda: model.generator_staged(x_nchw)
        staged_err = (run_staged().reshape(x_gen.shape) - model.generate(x_gen)).abs().max()
        turns = [cuda_ms(f, 3) for f in (lambda: model.generate(x_gen), run_staged,
                                          run_staged, lambda: model.generate(x_gen))]
    print(f"time generate 512x512 batch 8, K1 route {turns[0]:.2f} / {turns[3]:.2f} ms, "
          f"staged generator {turns[1]:.2f} / {turns[2]:.2f} ms (K1, staged, staged, K1); "
          f"outputs differ by {staged_err.item():.3e} max abs", flush=True)
    del x_nchw
    gen448_ms = cuda_ms(lambda: model.generate(x448), 3)
    print(f"time generate 448x448 batch 8: {gen448_ms:.2f} ms/call = "
          f"{8e3 / gen448_ms:.2f} slices/s", flush=True)
    gen96_ms = cuda_ms(lambda: model.generate(x96), 3)
    print(f"time generate 96x96 batch 64: {gen96_ms:.2f} ms/call = "
          f"{64e3 / gen96_ms:.2f} slices/s", flush=True)
    gen1024_ms = cuda_ms(lambda: model.generate(x1024), 3)
    print(f"time generate 1024x1024 batch 2: {gen1024_ms:.2f} ms/call = "
          f"{2e3 / gen1024_ms:.2f} slices/s", flush=True)
    gen200_ms = cuda_ms(lambda: model.generate(x200), 3)
    print(f"time generate 200x200 batch 8: {gen200_ms:.2f} ms/call = "
          f"{8e3 / gen200_ms:.2f} slices/s", flush=True)
    # K3 against cuDNN on the tiled and fused routes: the same generator
    # with its convs on cuDNN, in turns (K3, cuDNN, cuDNN, K3)
    for impl, x_in, n_in in (("tiled", x448, 8), ("fused", x96, 64)):
        with torch.device("meta"):
            cudnn = ResFFTGenerator(1, C, 10, spectral_impl=impl, conv_impl="torch")
        cudnn = share_parameters(cudnn, model.generator).eval()
        nchw_in = x_in.reshape(n_in, 1, *x_in.shape[1:3])
        with torch.no_grad():
            run_cudnn = lambda: cudnn(nchw_in)
            turns = [cuda_ms(f, 3) for f in (lambda: model.generate(x_in), run_cudnn,
                                              run_cudnn, lambda: model.generate(x_in))]
        size = x_in.shape[1]
        print(f"time generate {size}x{size} batch {n_in} ({impl}): 3x3 convs on K3 "
              f"{turns[0]:.2f} / {turns[3]:.2f} ms, on cuDNN {turns[1]:.2f} / "
              f"{turns[2]:.2f} ms (K3, cuDNN, cuDNN, K3)", flush=True)
    print(f"time sweep 512x512: {n_slices} slices in {sweep_s:.3f} s = "
          f"{n_slices / sweep_s:.2f} slices/s", flush=True)
    print(f"time sweep 448x448: {n_slices} slices in {sweep448_s:.3f} s = "
          f"{n_slices / sweep448_s:.2f} slices/s", flush=True)
    print(f"time sweep 96x96: {n_slices} slices in {sweep96_s:.3f} s = "
          f"{n_slices / sweep96_s:.2f} slices/s", flush=True)
    print(f"time sweep 1024x1024: {n_hires} slices in {sweep1024_s:.3f} s = "
          f"{n_hires / sweep1024_s:.2f} slices/s", flush=True)
    rates = {on: [r for f, r, _ in feature_runs if f == on] for on in (True, False)}
    print(f"time sweep 512x512 steady state (phase 26, on / off / off / on): feature "
          f"metrics on {', '.join(f'{r:.2f}' for r in rates[True])}, off "
          f"{', '.join(f'{r:.2f}' for r in rates[False])} slices/s; PL + TML "
          f"{feature_times['pl_tml_ms_per_slice']:.3f} ms and Inception "
          f"{feature_times['inception_ms_per_slice']:.3f} ms per slice; VGG19 "
          f"{feature_times['trunk_ms_per_image']:.3f} ms per image pass (bound "
          f"{feature_times['bound_ms']:.3f})", flush=True)
    up_in = torch.randn((320, 64, 32, 32), device="cuda", requires_grad=True)
    for label, up in (("shift-add (port)", upsample2x_bilinear),
                      ("F.interpolate", lambda t: torch.nn.functional.interpolate(
                          t, scale_factor=2, mode="bilinear", align_corners=False))):
        up_ms = cuda_ms(lambda: torch.autograd.grad(up(up_in).sum(), up_in), 10)
        print(f"time 2x bilinear upsample fwd+bwd (320, 64, 32, 32) {label}: "
              f"{up_ms:.3f} ms", flush=True)
    del up_in
    # the step's own peak, not the earlier phases' (phase 25 holds eleven
    # models' gradients in float64)
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: trainer.train_step(x, y), 3)
    print(f"time train step 160 x 64x64 (32/64 features, 10 layers, PCGrad + "
          f"AdamW): {step_ms:.2f} ms/step = {160e3 / step_ms:.2f} patches/s; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    profile("generate 512x512 batch 8", lambda: model.generate(x_gen))
    profile("generate 448x448 batch 8", lambda: model.generate(x448))
    profile("generate 96x96 batch 64", lambda: model.generate(x96))
    profile("generate 1024x1024 batch 2", lambda: model.generate(x1024))
    profile("generate 200x200 batch 8", lambda: model.generate(x200))
    profile("train step 160 x 64x64", lambda: trainer.train_step(x, y))

    k_ms, p_ms, b_ms, by = times["pre+skip"]
    kb_ms, pb_ms, bb_ms, bby = bwd_times["pre+skip"]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s to here, the builds "
          f"included", flush=True)
    print(json.dumps({"kernels": [{
        "name": "block_fused", "route": "cuda",
        "source": "mtd_gan_tpu_torch/csrc/block_fused.cu",
        "replaces": "mtd_gan_tpu/ops/pallas_pipeline.py:954",
        "launches": train_launches[0] + ablation_launches[0], "max_abs_err": max_abs_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
        "library_ms": None,
    }, {
        "name": "block_bwd", "route": "cuda",
        "source": "mtd_gan_tpu_torch/csrc/block_bwd.cu",
        "replaces": "mtd_gan_tpu/ops/pallas_train.py:109",
        "launches": train_launches[1] + ablation_launches[1], "max_abs_err": k2_max_abs_err,
        "ms": kb_ms, "plain_ms": pb_ms, "bound_ms": bb_ms, "bound_by": bby,
        "library_ms": None,
    }, {
        "name": "spectral_tiled", "route": "cuda",
        "source": "mtd_gan_tpu_torch/csrc/spectral_tiled.cu",
        "replaces": "mtd_gan_tpu/ops/pallas_fftconv.py:351",
        "launches": k8_sweep, "max_abs_err": k8_max_abs_err,
        "ms": k8_ms, "plain_ms": k8_plain_ms, "bound_ms": k8_bound_ms,
        "bound_by": k8_by, "library_ms": None,
    }, {
        "name": "spectral_fused", "route": "cuda",
        "source": "mtd_gan_tpu_torch/csrc/spectral_fused.cu",
        "replaces": "mtd_gan_tpu/ops/pallas_fftconv.py:267",
        "launches": k7_sweep, "max_abs_err": k7_max_abs_err,
        "ms": k7_ms, "plain_ms": k7_plain_ms, "bound_ms": k7_bound_ms,
        "bound_by": k7_by, "library_ms": None,
        # ms, plain_ms and bound_ms above are with the block's residual, as
        # the fused route calls K7; these without it
        "no_residual_ms": alone_ms, "no_residual_plain_ms": alone_plain_ms,
        "no_residual_bound_ms": alone_bound[0],
    }] + [{
        "name": name, "route": "cuda", "source": f"mtd_gan_tpu_torch/csrc/{src}",
        "replaces": f"mtd_gan_tpu/ops/pallas_pipeline.py:{line}",
        "launches": staged_sweep[key],
        "max_abs_err": k3_max_abs_err if key == "K3" else staged_max_abs_err[key],
        "ms": staged_times[key][0], "plain_ms": staged_times[key][1],
        "bound_ms": staged_times[key][3][0], "bound_by": staged_times[key][3][1],
        "library_ms": staged_times[key][2],
    } for key, name, src, line in (
        ("K3", "conv3x3", "conv3x3.cu", 439),
        ("K4", "staged_rdft_w", "spectral_staged.cu", 588),
        ("K5", "staged_mix_h", "spectral_staged.cu", 844),
        ("K6", "staged_irdft_w_add", "spectral_staged.cu", 908))]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
