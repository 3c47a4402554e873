#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA card.

    python3 chip_smoke.py

Phases (each one either succeeds or ends the run with a non-zero exit):

1. print the card's name and power limit; turn TF32 off for matmuls and
   convolutions;
2. build the CUDA kernels under ``diverse_channel_vit_torch/csrc`` (one
   ``nvcc`` per source, in parallel) and print the build time;
3. hold each kernel against its plain PyTorch version and time the kernel,
   the plain version and a PyTorch library yardstick: the forwards B1
   (attend_project) and B3 (ln_mlp), then the backwards B2 and B4, at the
   flagship shapes (B = 64 images, N = 1600 tokens padded from 1569,
   D = 384, 6 heads, hidden 1536, bf16), B1 split by launch (B5's attention
   and a projection GEMM, profiler) beside each launch's bound and timed
   beside its library call at the recipe's, EViT's and serving's other
   grids, B3 and B4 also at the recipe's, EViT's and ragged grids, and B2
   and B4 each twice on the same inputs, bit for bit;
   then B5 and B6 (flash_packed,
   forward and backward) at the three grids the EViT path gives them, B5's
   lse within 1e-5 and B6 twice on the same inputs, bit for bit, with B1's
   and B2's times printed beside theirs (all four run on one flash core,
   ``flash_wgmma.cuh``); then
   B7 and B8 (the int8 ln_mlp, forward and backward) at the flagship shapes,
   with the share of int8 codes that differ from the plain version's; B8's
   recomputed h held bit for bit against B7's, B7's h-storing twin's
   output and codes against its own, B8 twice bit for bit, B8's time split by launch
   (profiler) beside each launch's bound, and an estimate of both kernels'
   epilogue time from a SASS count of their helpers; then
   the benchmark scripts' kernels at the scripts' default shapes: S1
   (``bwd_call``, both schedules), S2 (``qkv_flash_fwd``) and S3
   (``int8_ln_mlp``, B7's kernel), each also held against its package
   sibling on the same inputs (the other schedule and B6 given B5's lse, B5,
   B7), bit for bit, S1 also across two calls; then B1, B2, B5, B6, S1 and
   S2 again at head width 128 (3 heads at D = 384, the ``small_tpu``
   preset), under names ending ``_dh128``; then B3, B4, B1 and B2 at the
   ``base`` preset's widths (D = 768, hidden 3072, 12 heads of 64; B3 runs
   a row pass and two GEMMs there, B4's dy a GEMM and a row pass), under
   names ending ``_d768``, B3 and B4 with and without biases and residual,
   B4 twice bit for bit, B4 at both widths and B3 at 768 split by launch
   (profiler) beside each launch's bound and the bytes its tiles load from
   L2; B1 at 12 heads of 64 and at 3 of 128 split by launch as at 6; then B7
   and B8 at D = 768 (a cluster of two blocks per 64 rows
   each) as at D = 384, also on a grid with a half-full last 128-row tile;
4. phase f32 (``train.dtype=float32``, the reference's own precision: every
   block takes the unfused route, and B5 and B6 run their f32 kernels,
   ``csrc/flash_f32.cuh``, 3xTF32 products with P kept in f32): B5-f32 and
   B6-f32 against their plain versions in full f32 at EViT's three grids,
   the DCS recipe's k = 1 grid (256, 197) and PPT channel pruning's (832,
   785), B = 64, at 6 heads of 64 and 3 of 128 (``_f32`` and ``_f32_dh128``
   names), o within 2e-5 of max|o|, lse within 1e-5, dq, dk and dv within
   1e-4 of each max|g|, padded dk / dv rows exactly 0 and B6 twice bit for
   bit, timed beside the bound (one TF32 pass), the plain version and SDPA
   in f32 with TF32 off, and at (1600, 1569) split by launch, each pass
   beside its own bound (B5-f32's forward at one TF32 pass; B6-f32's di by
   bytes, its dk/dv and dq passes at one TF32 pass of their own products);
   the f32 kernels' registers, spills and shared memory; 12 f32 train steps
   of DiChaViT-S at full width and depth, B = 64 (B5-f32 and B6-f32 x 11 a
   step, nothing else) and a profiled one; 2 steps at depth 3 through the
   kernels against the plain route (losses within 1e-5, step-0 gradients
   within 1e-4 of max|g|); the card's f32 logits at full depth against the CPU's (B = 4, within 1e-4 of
   max|logit|); ``main`` with ``++train.dtype=float32`` (2 epochs of 256
   images, evals; TF32 off inside, the flags restored after); an f32
   ``ServingEngine`` from ``build_model``'s default dtype at buckets 1 and
   64 (B5-f32 x 11 per forward, logits against the plain route); EViT (3
   steps at depth 4 over EViT's grids), PPT token pruning (a step at full
   depth over its unpadded grids) and the DCS recipe (k = 1, 3, 8 at depth
   3: N 256 to 1600), each against the plain route; the ``small_tpu``
   preset (3 heads of 128) timed and against the plain route;
5. build full-width DiChaViT-S (8 channels, 224^2, patch 16, depth 12, 161
   classes, seeded random weights, bf16 compute) and serve requests through
   ``ServingEngine`` (``predict``, ``submit``) and ``ServingHTTPServer`` on
   localhost, with the kernel launch counts set to 0 just before and read
   just after; time each batch bucket and profile one 64-image ``predict``;
   then hold the logits against the same model run through the plain
   versions. The same for the model with EViT pruning (keep_rate 0.7:
   B5 at layers 3, 6 and 9, B1 / B3 at the other eight) and, for one
   forward and its profile, with ``gelu_exact`` (every block unfused:
   B5 x 11);
6. train the model (f32 parameters, bf16 compute) with the port's
   ``make_optimizer`` / ``make_lr_schedule`` / ``TrainState`` /
   ``make_train_step`` on one synthetic batch of 64 images: CE + CDL + TDL,
   AdamW with the JUMP-CP weight-decay schedule; counts set to 0 just before
   2 warm-up and 10 timed steps and read just after (B1-B4 11 launches per
   step); profile one step; then 3 steps through the kernels against 3
   steps through the plain versions from the same weights, at depth 4. The
   same with EViT pruning (B5, B6 3 launches per step, B1-B4 8), and one
   ``gelu_exact`` step at depth 3, kernels against plain versions;
7. int8 (``quantization="int8"``): serve buckets 1-64 through an int8
   ``ServingEngine`` and HTTP (B7 and B1 x 11 per forward, no B3) beside an
   unquantised engine on the same model; train 12 int8 steps (B1, B2, B7,
   B8 x 11 per step) and 3 at depth 4 against the plain route;
8. the DCS recipe: 48 steps at B = 64 with k drawn from the JAX benchmark's
   mixture (``lowest_cosine_prob``, temperature 1000), each k warmed once
   first, images/s and launches per step (B1-B4 x 11); 3 steps at k = 2, 5
   and 8 at depth 4 against the plain route, both drawing the same channels;
9. the ``small_tpu`` preset (3 heads of 128, every attention kernel at head
   width 128) at full width and depth, as the JAX benchmark's ``mxu_native``
   flagship and recipe, ``int8_dh128`` and dh-128 EViT recipe cells: serving
   as phase 5 (buckets 1-64, a k = 3 subset, logits against the plain
   route), 12 train steps and the 3-step parity at depth 4, the DCS recipe,
   12 int8 train steps (B1, B2, B7, B8) and their parity, and the DCS recipe
   with EViT (keep_rate 0.7: B5 and B6 at layers 3, 6 and 9) and its parity
   at k = 2, 5 and 8; each path prints its images/s, p50 ms and peak memory
   beside the card;
10. the ``base`` preset (DiChaViT-B: D = 768, 12 heads, MLP 3072) at full
   width and depth: serving as phase 5 (buckets 1-64, a k = 3 subset,
   logits against the plain route), 12 train steps at B = 64 and the 3-step
   parity at depth 4, each with its ``phase`` line; the same three with
   ``quantization: int8`` (serving as phase 7: B7 and B1 x 11 per forward,
   no B3; train B1, B2, B7 and B8 x 11 per step, no B3 / B4); then the
   port's geometry smoke
   (``diverse_channel_vit_torch.scripts.smoke_geometries``) through its
   ``main``: the JAX script's five geometries (CHAMMI's 12 channels with the
   proxy loss, DCS at k = 5 of 12, base, head width 128, So2Sat's 18
   channels at 32^2 with patch 8), 6 train steps each, every loss finite,
   B1-B4 x 11 per step, a ``phase`` line each;
11. run the port's three benchmark scripts through their entry points at
   their defaults (``bench_attn`` chain, bwd-variants, step and small-k,
   ``bench_block_fusion``, ``bench_int8_lnmlp``) and S1's and S2's at 3
   heads (``bench_attn bwd-variants --heads 3``, ``bench_block_fusion`` at
   3 heads), their output echoed, the counts set to 0 just before each and
   read just after;
12. the training entry point, ``diverse_channel_vit_torch.main.main`` in
    this process (config tree -> data layer -> Trainer -> eval ->
    checkpoint), each run with the counts set to 0 just before and read
    just after: DiChaViT-S on ``synthetic_cfg`` at the flagship geometry
    (640 images, B = 64, 2 epochs, eval before training and after each
    epoch, 128 images a split at the auto-sized eval batch), B1-B4 x 11 per
    step and B1 / B3 x 11 per eval forward, losses finite, every valid eval
    image counted, epoch 2 under the profiler (the device's busy share), the
    host's time per batch; a Trainer resumed from the ``model_last`` it
    wrote starts at epoch 3 with its parameters and Adam moments bit for
    bit; one epoch of the DCS recipe (the k sequence equal to numpy
    ``default_rng(seed)``'s) and one of int8 (B7 / B8 for B3 / B4); the
    JUMP-CP augmentation on a 64-image batch on the card against the CPU;
    which of yaml, pandas, pyarrow and h5py import (pandas and pyarrow
    must), one JUMP-CP epoch from a fixture the script writes, with
    the augmentation on the card; then the novel-channel evals: first
    ``novel_parity``, DiChaViT-S's eval forward at full width and depth,
    kernel route against plain route from the same weights, at B = 64 with
    the (C, D) ``avg_2`` table of a mapper whose test split holds two
    channels train lacks, on the subset sweep's 7-of-8 grid (N = 1373
    padded to 1408) and with a per-sample (B, C, D) ``dynamic_input_corr_4``
    override (B1 / B3 x 11 per forward on the kernel route, none on the
    plain one, logits within the serving tolerance); then ``main`` with the
    overrides of ``train_scripts.sh:11`` as written (DCS, the ``zero``
    strategy, the channel-subset sweep) on that fixture for 1 epoch: B1-B4
    x 11 per step, B1 / B3 x 11 per eval forward, the eval keys those the
    CPU tests hold to JAX's, the seconds of ``eval_regular`` and of the
    sweep, the sweep's images/s and the eval peak memory; then CHAMMI: the recipe of
    ``train_scripts.sh:8`` (DiChaViT-S, 224^2, batch 64, TPS 0.2, DCS) for
    2 epochs with an eval after each, on a CHAMMI tree the script writes
    (128 Train and 64 test rows a chunk at CHAMMI's tape sizes, one packed
    blob): B1-B4 x 33 per step (3 chunk micro-batches) and B1 / B3 x 11 per
    eval forward, every step's per-chunk losses finite, the k sequence
    ``default_rng(2025)``'s drawn per chunk, global labels, a feature row
    per metadata row, the nine MorphEm task rows and a CHAMMI score in
    [0, 1], and the card's kNN predictions equal to the CPU's; then the
    same recipe on a chunk subset (``train.training_chunks=Allen_HPA``,
    strategies zero, avg_2 and replicate, 1 epoch): B1-B4 x 22 per step,
    B1 / B3 x 11 per eval forward, the CHAMMI score per strategy and CP's
    features (all five of its channels novel) different between zero and
    avg_2; before the novel-channel evals, ``main`` with ``jump_cp_cfg`` and
    ``model=vit_adapt``, then ``model=hypervit_adapt``, one epoch each on the
    JUMP-CP fixture (B1-B4 x 11 per step and B1 / B3 x 11 per eval forward,
    every call at N = 256, n_valid 197), and ``cifar10_cfg`` for one epoch on
    a CIFAR pickle tree the script writes (ChannelViT-S on 3 channels at 32^2,
    patch 8: every call at N = 64, n_valid 49); a ``phase`` line each;
13. the Trainer's runtime at full width and depth (DiChaViT-S, B = 64):
    for DropPath (rate 0.1; B1 without its residual and B3 / B4 with
    ``residual=False`` in blocks 1-10), MIRO (24 B1 and 24 B3 a step, the
    live forward's and the pre-featurizer's, 12 B2 and 12 B4) and
    ``unfreeze_last_n_layers = 2`` (the frozen tensors unchanged), 2 steps
    through the kernels against 2 through the plain versions from the same
    weights and DropPath masks, then 12 timed steps, each ``phase`` line
    beside the plain step's images/s and p50; ``main`` on ``synthetic_cfg``
    with DropPath, MIRO, the last two blocks trainable, SWAD, ``plot_attn``,
    ``profile_dir`` and an RSS cap together (2 epochs: the model takes the
    SWAD average, a Chrome trace and an attention map per evaluation); a run
    (DCS, DropPath, SWAD, MIRO) that a SIGTERM stops in the middle of its
    second epoch, resumed by the next Trainer, against the uninterrupted
    run, every parameter bit for bit;
14. the last training knobs at full width and depth (DiChaViT-S, B = 64),
    each ``phase`` line beside the plain step's images/s and p50 with the
    port's kernels by launch over one profiled step and the worst parity
    figures: ``samplers``, the train step with ``lowest_cosine_prob_proj``,
    ``lowest_cosine_prob_resnet34`` (a random-init ResNet-34 scorer) and
    ``hcs_per_sample`` at k = 4 of 8 channels (B1-B4 x 11 a step at N = 832,
    n_valid 785), 2 steps through the kernels against 2 through the plain
    versions drawing the same channels, then 5 timed steps; ``optimizers``,
    SGD (Nesterov momentum), Adam, AdamP and AdamW with a bf16 first moment:
    3 updates on the card against a CPU copy within 1e-6, then 3 timed
    steps; ``ppt``, ``block_type=block_v2`` with token pruning and with
    channel pruning (kc = 4): the eval forward and one train step against
    the plain route (12 B5 a forward, 12 B5 and 12 B6 a step, no B1-B4, at
    the grids each block's pruning leaves), then 5 timed steps; and
    ``hcs_dropout``, ``random`` and ``channel`` at kc = 4 (B1-B4 x 11 at N =
    832, n_valid 785), one step against the plain route, then 5 timed
    steps; then ``main`` with the ResNet-34 sampler, Adam and PPT token
    pruning for one short epoch, and the C7 check (a ``Trainer.train`` that
    raises leaves SIGTERM's handler as it found it);
15. the paper's four baseline ViTs (``vit_adapt``, ``depthwisevit_adapt``
    with ``channel_weights`` and with ``attention`` pooling,
    ``hypervit_adapt``, ``templatemixingvit``) at the small preset, full width
    and depth, JUMP-CP geometry (197 tokens padded to 256), B = 64: first
    B1-B4 against their plain versions at (N, n_valid) = (256, 197), (64,
    17) and (64, 49); then for each model serving as phase 5 (B1 / B3 x 11
    per forward, logits against the plain route), 2 train steps through the
    kernels against 2 through the plain versions (B1-B4 x 11 a step, every
    call at (256, 197); losses and step-0 gradients within the train
    tolerances), 10 timed steps (``phase`` line) and a profiled one, beside
    the plain DiChaViT step; ``vit_adapt`` at 32^2 with patch 8 (B1 / B3 at
    (64, 17)) against the plain route; ``fused_block: false`` on DiChaViT at depth 4
    (B5 / B6 alone, no B1-B4) and ``vit_adapt`` with ``quantization: int8``
    at depth 4 (B7 / B8), each against the plain route;
16. the ConvNeXt family, DINOv2 and the feature-extraction CLI, where no
    kernel of the port runs (the counts set to 0 first must read 0 at the
    end, and no ``dcvit`` kernel shows in a profile): each of the six
    ConvNeXt models at full ConvNeXt-Tiny width and depth, JUMP-CP
    geometry, with its yaml's values: its f32 forward on the card (TF32
    off) against the CPU's at B = 4 within 1e-3 of max|logit|, the bf16
    forward within LOGITS_REL_TOL, one bf16 train step against the f32 CPU
    step (loss, every gradient within TRAIN_GRAD_REL_TOL of its max|g|),
    12 timed steps at B = 64 and a profiled one (``phase convnext`` lines:
    images/s, p50, peak memory, the device's busy share), serving p50 at
    buckets 1 and 64; DINOv2 at the ``dinov2_vits14_reg`` shape against the
    CPU in f32 and timed; ``main`` with ``convnext_base`` on a JUMP-CP
    fixture from a timm-layout checkpoint it writes
    (``pretrained_pad_random``), with ``shared_convnext`` (from that
    checkpoint, ``pretrained_pad_avg``) and ``depthwiseconvnext``
    (Allen_HPA, three novel-channel strategies) on a CHAMMI fixture of 96
    images a chunk with the embedding figures; the CLI with ``dinov2_jax``, ``resnet18_jax``
    and ``convnext_jax`` on that fixture into ``run_benchmark``;
17. print the ``kernels`` JSON line (each kernel's launches from its main
    paths, per Trainer epoch, and the CHAMMI, novel-channel and CHAMMI
    subset runs', per step of the runtime, training-knob and baseline
    phases' runs, and per epoch of the baselines' and CIFAR's Trainer
    runs), the card line, and last
    the result line
    ``{"ok": true, "device": {...}}``.

It imports nothing of JAX. Without a CUDA device, or outside a checkout of
the repository, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np

# flagship geometry (DiChaViT-S at JUMP-CP)
B, N_VALID, D, HEADS, HID = 64, 1569, 384, 6, 1536
# the small_tpu preset: the same width in 3 heads of 128 (the JAX bench's
# mxu_native, int8_dh128 and dh-128 EViT recipe cells)
TPU_PRESET, HEADS_TPU = "small_tpu", 3
# the base preset (DiChaViT-B: D = 768 in 12 heads of 64, MLP 3072) at the
# same geometry: the MLP kernels at D = 768
BASE_PRESET, D_BASE, HEADS_BASE, HID_BASE = "base", 768, 12, 3072
CHANNELS, IMG, PATCH, DEPTH, CLASSES = 8, 224, 16, 12, 161
BUCKETS = (1, 4, 16, 64)
# the plain-route training check runs at this depth (the plain attention
# materialises every (N, N) score matrix); the timed steps run at DEPTH
PARITY_DEPTH = 4
# EViT (keep_rate 0.7): layers 3, 6 and 9 prune at DEPTH (1, 2 and 3 at
# PARITY_DEPTH); the grids B5 meets there, (N, n_valid): 1569 -> 1 + 1097
# tokens padded to 1152, -> 1 + 767 = 768 (no mask), -> 1 + 536 padded to 576
KEEP_RATE = 0.7
EVIT_GRIDS = ((1600, 1569), (1152, 1098), (768, 768))
# the gelu_exact training check: blocks 0-1 unfused, block 2 the readout
GELU_PARITY_DEPTH = 3
# H100 SXM published dense peaks
PEAK_BF16_FLOPS, PEAK_INT8_OPS, PEAK_BYTES = 989e12, 1979e12, 3.35e12
# the dense TF32 peak: the f32 attention kernels' bound is one TF32 pass of
# their FLOPs (their 3xTF32 products take three, so they reach a third of it
# at most)
PEAK_TF32_FLOPS = 494.7e12
# the DCS recipe (bench.py:85-94): lowest_cosine_prob at temperature 1000
HCS_METHOD, HCS_TEMP = "lowest_cosine_prob", 1000.0
# int8 codes that may differ between an int8 kernel and its plain version: a
# value within f32 noise of a .5 tie (the LayerNorm sums in another order,
# the plain version's tanh comes from another library build) rounds the other
# way; a wrong scale or product would flip most codes
MAX_CODE_FLIPS = 1e-2
# kernel vs plain version, both bf16: they round at the same points but sum
# in other orders and the kernel's online softmax rounds P against a running
# max, so an output may land one or two bf16 ulps (2^-7 relative) apart
KERNEL_REL_TOL = 2e-2
# B5's log-sum-exp against its plain version: f32 statistics of the same
# scores (the kernel's ex2 and log2 against the plain version's exp and log)
LSE_REL_TOL = 1e-5
# logits after 12 layers of such differences
LOGITS_REL_TOL = 5e-2
# kernel route vs plain route over 3 train steps at PARITY_DEPTH: losses, and
# each parameter's step-0 gradient against max|g| of that parameter (the
# differences above, carried through 4 layers forward and back)
TRAIN_LOSS_REL_TOL = 1e-2
TRAIN_GRAD_REL_TOL = 5e-2
# the f32 phase (train.dtype=float32: every block unfused, B5 and B6 in f32):
# the f32 kernels against their plain versions (full f32, TF32 off), o within
# F32_O_TOL of max|o|, lse within LSE_REL_TOL, dq, dk and dv within
# F32_GRAD_TOL of each max|g|, at EViT's grids, the DCS recipe's k = 1 grid
# (197 tokens in 256) and PPT channel pruning's 785 tokens (padded to 832);
# the kernel route against the plain route at F32_PARITY_DEPTH, losses
# within F32_LOSS_TOL and step-0 gradients within F32_GRAD_TOL of each
# max|g|; the card's logits against the CPU's within F32_LOGITS_TOL of
# max|logit|. Each f32 tolerance is an f32 sum in another order, a few
# hundred ulps; one TF32 pass would miss the kernel's by about 1e-3.
F32_GRIDS = EVIT_GRIDS + ((256, 197), (832, 785))
F32_O_TOL, F32_GRAD_TOL, F32_LOSS_TOL, F32_LOGITS_TOL = 2e-5, 1e-4, 1e-5, 1e-4
F32_PARITY_DEPTH = 3
# the Trainer runtime phase: DropPath at the last block's rate, MIRO at the
# JAX Trainer's defaults (train.miro_ld 0.01, train.miro_lr_mult 10), and
# the last two blocks trainable
DROP_PATH_RATE, MIRO_LD, MIRO_LR_MULT, UNFREEZE_LAST = 0.1, 0.01, 10.0, 2
RUNTIME_PARITY_STEPS = 2
# the train step's default optimizer (optimizer/adamw_jumpcp.yaml)
ADAMW_JUMPCP = dict(lr=2.5e-4, betas=[0.9, 0.999], eps=1e-6, weight_decay=0.04,
                    weight_decay_end=0.4, amsgrad=False)
# the training knobs' phases: the three samplers at a fixed k, PPT and HCS
# dropout at kc = token_keep_channels, and the other optimizers (the
# configs' hyper-parameters: optimizer/sgd.yaml with Nesterov momentum,
# optimizer/adam.yaml with a coupled decay, timm's AdamP defaults, and
# AdamW with a bf16 first moment)
KNOB_K, KNOB_KC = 4, 4
# the samplers at the config's hcs_sampling_temp (at the recipe's 1000 the
# Gumbel noise outweighs any score)
SAMPLER_TEMP = 0.1
SAMPLERS = ("lowest_cosine_prob_proj", "lowest_cosine_prob_resnet34", "hcs_per_sample")
OPTIMIZERS = {
    "sgd": ("sgd", dict(lr=0.01, momentum=0.9, nesterov=True, weight_decay=5e-4)),
    "adam": ("adam", dict(lr=1e-4, betas=[0.9, 0.999], eps=1e-8, weight_decay=1e-4)),
    "adamp": ("adamp", dict(lr=1e-4, betas=[0.9, 0.999], eps=1e-8, weight_decay=1e-2,
                            wd_ratio=0.1, nesterov=True)),
    "adamw mu_dtype=bfloat16": ("adamw", dict(ADAMW_JUMPCP, mu_dtype="bfloat16")),
}
# an optimizer's update on the card against the same update on the CPU,
# each tensor's max|diff| / max|ref| (f32 arithmetic in another order)
OPT_REL_TOL = 1e-6
# the grids (n_valid) PPT's 12 blocks attend over at 8 channels and kc = 4:
# token pruning keeps max(1, n * 4 // 8) of the n non-CLS tokens at each
# block, channel pruning 4 channels at block 0; HCS dropout keeps 4 * 196
# tokens, 785 with the CLS row, padded to 832
PPT_GRIDS = {"token_pruning": (1569, 785, 393, 197, 99, 50, 25, 13, 7, 4, 2, 2),
             "channel_pruning": (1569,) + (785,) * 11}
HCS_DROP_GRID = (832, 785)
# the (N, n_valid) grids of the kernel route's attention calls in the last
# train_parity run of each label (attention_grids)
LAST_GRIDS = {}
# the paper's four baseline ViTs (ROADMAP A8.3) at the small preset (D = 384,
# 6 heads of 64, depth 12, MLP 1536) and JUMP-CP geometry: each a trunk over
# 196 patch tokens and the CLS row, 197 tokens padded to 256, so B1-B4 at
# (256, 197); their configs' yaml values (hidden_dim 128, num_templates 10,
# the attn_pooling/param1 group)
ATTN_POOLING_PARAM1 = dict(depth=1, dim_head=16, heads=4, mlp_dim=4, dropout=0.0,
                           use_cls_token=False, use_channel_tokens=False)
BASELINES = {
    "vit_adapt": dict(model_name="vit_adapt"),
    "depthwisevit_adapt channel_weights": dict(model_name="depthwisevit_adapt",
                                               pooling_channel_type="channel_weights"),
    "depthwisevit_adapt attention": dict(model_name="depthwisevit_adapt",
                                         pooling_channel_type="attention",
                                         attn_pooling=ATTN_POOLING_PARAM1),
    "hypervit_adapt": dict(model_name="hypervit_adapt", z_dim=64, hidden_dim=128),
    "templatemixingvit": dict(model_name="templatemixingvit", num_templates=10),
}
BASELINE_GRID = (256, 197)
# the grids of the smaller geometries, (N, n_valid): a baseline at So2Sat's
# 32^2 with patch 8 (16 patches and the CLS row in 64), and CIFAR's ChannelViT
# (3 channels of 16 patches and the CLS row in 64)
SMALL_GRIDS = ((64, 17), (64, 49))


# the other grids B3 and B4 meet, (images, tokens): a last 128-row tile half
# full (192 rows), the recipe's smallest grid (k = 1: N = 256), the EViT grid
# after layer 6 (N = 768), and a token count that is no multiple of 64
LN_MLP_GRIDS = ((3, 64), (8, 256), (8, 768), (1, 100))
# the other grids B1 meets at the flagship's 6 heads, (images, N, n_valid):
# EViT's after layers 3, 6 and 9, the DCS recipe's k = 5, 3 and 1 of 8
# channels (k 196 + 1 tokens), and serving's one-image bucket
AP_GRIDS = ((B, 1152, 1098), (B, 768, 768), (B, 576, 537), (B, 1024, 981), (B, 640, 589),
            (B, 256, 197), (1, 1600, 1569))


def stamp(label: str, t_start: float) -> None:
    """The run's seconds so far, after a phase."""
    print(f"[{time.perf_counter() - t_start:.1f} s] {label} done", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def hold(name: str, label: str, pairs, tol: float = KERNEL_REL_TOL) -> tuple:
    """Raise unless every kernel output in ``pairs`` ((what, kernel, plain),
    ...) is finite and within ``tol`` of max|plain|; return the
    (max_abs_err, rel_err) of the output with the largest rel_err."""
    import torch

    torch.cuda.synchronize()
    errs = []
    for what, got, ref in pairs:
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} ({label}): {what} is not finite")
        err = (got.float() - ref.float()).abs().max().item()
        rel = err / (ref.float().abs().max().item() + 1e-12)
        print(f"{name} ({label}): {what} max_abs_err {err:.3e} rel {rel:.3e} "
              f"(tolerance rel <= {tol})")
        if not rel <= tol:
            raise AssertionError(f"{name} ({label}): {what} disagrees with its plain version")
        errs.append((err, rel))
    return max(errs, key=lambda e: e[1])


def kernel_name(name: str, heads: int, d: int = D) -> str:
    """The kernels line's name of an attention kernel at d / heads head width:
    the name alone at 64 and the flagship width, with the head width or the
    model width beside it otherwise."""
    dh = d // heads
    return f"{name}_dh{dh}" if dh != 64 else width_name(name, d)


def width_name(name: str, d: int) -> str:
    """The kernels line's name of a kernel at model width d: the name alone at
    the flagship width, with the width beside it otherwise."""
    return name if d == D else f"{name}_d{d}"


def _rnd(torch, g):
    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)
    return rnd


def check_kernels(fb, torch, F):
    """Phase 3, forwards: each kernel against its plain version at flagship
    shapes.

    Each kernel runs twice. First as the main path calls it, residual fused,
    with biases drawn at the residual's scale, so a dropped or misplaced bias
    or residual moves the output far past the tolerance. Then with no
    residual and zero output bias, so the kernel's products alone set
    max|plain| and a fault there cannot hide under the added terms."""
    rnd = _rnd(torch, torch.Generator(device="cuda").manual_seed(0))
    return {"attend_project_fwd": check_attend_project_fwd(fb, torch, F, HEADS, rnd),
            "ln_mlp_fwd": check_ln_mlp_fwd(fb, torch, F, rnd)}


def check_ln_mlp_fwd(fb, torch, F, rnd, d=D, hid=HID):
    """B3 (ln_mlp_fwd) against its plain version at the flagship grid with
    model width ``d`` and hidden width ``hid``, residual fused and then bare,
    as check_kernels describes, then at LN_MLP_GRIDS; its timings."""
    n = -(-N_VALID // 64) * 64
    bf16 = torch.bfloat16
    # the model reads only the n_valid real rows of the padded grid, so the
    # bound counts those (the kernels also compute the padded rows)
    rows = B * N_VALID
    name = width_name("ln_mlp_fwd", d)
    x = rnd(B, n, d)
    s, bb = rnd(d, scale=0.1, dtype=torch.float32) + 1.0, rnd(d, scale=0.1, dtype=torch.float32)
    w1, b1 = rnd(hid, d, scale=d ** -0.5), rnd(hid)
    w2, b2 = rnd(d, hid, scale=hid ** -0.5), rnd(d)
    largs = (x, s, bb, w1, b1, w2, b2, True)
    bare = (x, s, bb, w1, b1, w2, torch.zeros_like(b2), False)

    def hold_ln(label, a):
        return hold(name, label, (("out", fb.ln_mlp(*a), fb.ln_mlp_plain(*a)),))

    err, rel = hold_ln("main path", largs)
    hold_ln("no residual, zero bias", bare)
    for (nb, nn), res in zip(LN_MLP_GRIDS, (True, False, True, False)):
        hold_ln(f"{nb} x {nn} tokens, residual {res}",
                (rnd(nb, nn, d), s, bb, w1, b1, w2, b2 if res else torch.zeros_like(b2), res))
    ms = cuda_ms(lambda: fb.ln_mlp(*largs), 10)
    plain_ms = cuda_ms(lambda: fb.ln_mlp_plain(*largs), 3, warmup=1)
    sb, bbb = s.to(bf16), bb.to(bf16)

    def library():
        y = F.layer_norm(x, (d,), sb, bbb, 1e-6)
        return F.linear(F.gelu(F.linear(y, w1, b1), approximate="tanh"), w2, b2) + x

    library_ms = cuda_ms(library, 10)
    extra = {}
    if d != D:  # three launches at 768: each beside its bound
        m = B * n
        gemm = 2 * rows * d * hid / PEAK_BF16_FLOPS
        part_bounds = {
            "LN pass": (4 * rows * d + 8 * rows) / PEAK_BYTES,
            "fc1": max(gemm, 2 * (rows * d + rows * hid + d * hid) / PEAK_BYTES),
            "fc2": max(gemm, 2 * (rows * hid + 2 * rows * d + d * hid) / PEAK_BYTES),
        }
        extra["sub_ms"] = launch_split(name, lambda: fb.ln_mlp(*largs), B3_PARTS, part_bounds,
                                       b3_l2_bytes(m, d, hid))
    return dict(
        source="diverse_channel_vit_torch/csrc/ln_mlp.cu",
        replaces="diverse_channel_vit_tpu/ops/fused_block.py:152",
        max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        flops=4 * rows * d * hid,
        bytes=2 * (2 * rows * d + 2 * d * hid + hid + d) + 4 * 2 * d, **extra,
    )


def check_attend_project_fwd(fb, torch, F, heads, rnd, D=D):
    """B1 (attend_project_fwd) against its plain version at flagship shapes
    with ``heads`` heads (6 of 64, or 3 of 128 for the small_tpu preset, or
    at D = 768 the base preset's 12 of 64), residual fused and then bare, as
    check_kernels describes; its timings."""
    n = -(-N_VALID // 64) * 64
    rows = B * N_VALID
    dh = D // heads
    qkv, x_res = rnd(B, n, 3 * D), rnd(B, n, D)
    wp, bp = rnd(D, D, scale=D ** -0.5), rnd(D)
    args = (qkv, x_res, wp, bp, heads, dh ** -0.5, N_VALID)
    bare = (qkv, None, wp, torch.zeros_like(bp), heads, dh ** -0.5, N_VALID)
    name = kernel_name("attend_project_fwd", heads, D)

    def hold_ap(label, a):
        (o_k, l_k, xo_k), (o_p, l_p, xo_p) = (f(*a, need_o=True) for f in
                                              (fb.attend_project_fwd, fb.attend_project_fwd_plain))
        return hold(name, label, (("xo", xo_k, xo_p), ("o", o_k, o_p), ("lse", l_k, l_p)))

    err_xo, rel_xo = hold_ap("main path", args)
    hold_ap("no residual, zero bias", bare)
    ms = cuda_ms(lambda: fb.attend_project_fwd(*args), 10)
    plain_ms = cuda_ms(lambda: fb.attend_project_fwd_plain(*args), 3, warmup=1)
    keep = (torch.arange(n, device="cuda") < N_VALID)[None, None, None, :]

    def library():
        q, k, v = qkv.view(B, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
        return F.linear(o.transpose(1, 2).reshape(B, n, D), wp, bp) + x_res

    library_ms = cuda_ms(library, 10)
    part_bounds = {  # two launches: each beside its bound
        "attention": max(4 * rows * N_VALID * D / PEAK_BF16_FLOPS,
                         2 * (rows * 3 * D + rows * D) / PEAK_BYTES),
        "projection": max(2 * rows * D * D / PEAK_BF16_FLOPS,
                          2 * (3 * rows * D + D * D + D) / PEAK_BYTES),
    }
    extra = {"sub_ms": launch_split(name, lambda: fb.attend_project_fwd(*args), B1_PARTS,
                                    part_bounds)}
    if heads == HEADS:  # the flagship's
        extra["per_grid"] = ap_grid_times(fb, torch, F, rnd)
    return dict(
        source="diverse_channel_vit_torch/csrc/attend_project.cu",
        replaces="diverse_channel_vit_tpu/ops/fused_block.py:671",
        max_abs_err=err_xo, rel_err=rel_xo, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        flops=4 * rows * N_VALID * D + 2 * rows * D * D,
        bytes=2 * (rows * 3 * D + 2 * rows * D + D * D + D), **extra,
    )


def ap_grid_times(fb, torch, F, rnd) -> list:
    """B1 at the flagship's 6 heads of 64 on the other grids the model gives
    it (AP_GRIDS), residual fused: its time and its library call's a call,
    each grid's output held against its plain version."""
    out = []
    for nb, n, nv in AP_GRIDS:
        qkv, x_res = rnd(nb, n, 3 * D), rnd(nb, n, D)
        wp, bp = rnd(D, D, scale=D ** -0.5), rnd(D)
        args = (qkv, x_res, wp, bp, HEADS, (D // HEADS) ** -0.5, nv)
        label = f"{nb} x ({n}, {nv})"
        hold("attend_project_fwd", label, (("xo", fb.attend_project_fwd(*args)[2],
                                           fb.attend_project_fwd_plain(*args)[2]),))
        keep = (torch.arange(n, device="cuda") < nv)[None, None, None, :]

        def library():
            q, k, v = qkv.view(nb, n, 3, HEADS, D // HEADS).permute(2, 0, 3, 1, 4)
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
            return F.linear(o.transpose(1, 2).reshape(nb, n, D), wp, bp) + x_res

        g = dict(batch=nb, n=n, n_valid=nv, ms=cuda_ms(lambda: fb.attend_project_fwd(*args), 10),
                 library_ms=cuda_ms(library, 10))
        print(f"attend_project_fwd at {label}: kernel {g['ms']:.4f} ms, library "
              f"{g['library_ms']:.4f} ms")
        out.append(g)
    return out


def check_attend_project_bwd(fb, torch, F, heads, rnd, D=D):
    """B2 (attend_project_bwd) against its plain version at flagship shapes
    with ``heads`` heads at width ``D``, as check_bwd_kernels describes; its
    timings."""
    n = -(-N_VALID // 64) * 64
    rows = B * N_VALID
    dh = D // heads
    name = kernel_name("attend_project_bwd", heads, D)
    qkv, x_res = rnd(B, n, 3 * D), rnd(B, n, D)
    wp, bp = rnd(D, D, scale=D ** -0.5), rnd(D)
    dxo = rnd(B, n, D)
    names = ("dq", "dk", "dv", "dwp", "dbp", "db_qkv")

    def split(out):
        dqkv, dwp, dbp, db = out
        return (dqkv[..., :D], dqkv[..., D:2 * D], dqkv[..., 2 * D:], dwp, dbp, db)

    def hold_ap(label, n_valid):
        o, lse, _ = fb.attend_project_fwd(qkv, x_res, wp, bp, heads, dh ** -0.5, n_valid,
                                          need_o=True)
        a = (qkv, o, lse, wp, dxo, heads, dh ** -0.5, n_valid)
        got = split(fb.attend_project_bwd(*a))
        worst = hold(name, label,
                     list(zip(names, got, split(fb.attend_project_bwd_plain(*a)))))
        return worst, got, a

    (err, rel), got, args = hold_ap("main path", N_VALID)
    pad = torch.cat([got[1][:, N_VALID:], got[2][:, N_VALID:]], dim=-1)
    if torch.count_nonzero(pad).item() != 0:
        raise AssertionError(f"{name}: padded key rows have dk or dv != 0")
    print(f"{name}: dk and dv exactly 0 on the {n - N_VALID} padded key rows")
    hold_ap("every key valid", n)
    first, second = fb.attend_project_bwd(*args), fb.attend_project_bwd(*args)
    if not all(torch.equal(p, q) for p, q in zip(first, second)):
        raise AssertionError(f"{name}: two calls on the same inputs differ")
    print(f"{name}: two calls on the same inputs agree bit for bit")
    del first, second, got, pad
    ms = cuda_ms(lambda: fb.attend_project_bwd(*args), 10)
    plain_ms = cuda_ms(lambda: fb.attend_project_bwd_plain(*args), 2, warmup=1)
    keep = (torch.arange(n, device="cuda") < N_VALID)[None, None, None, :]
    lq, lw, lb = (t.detach().clone().requires_grad_() for t in (qkv, wp, bp))
    q, k, v = lq.view(B, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
    lib_out = F.linear(o.transpose(1, 2).reshape(B, n, D), lw, lb) + x_res
    library_ms = cuda_ms(
        lambda: torch.autograd.grad(lib_out, (lq, lw, lb), dxo, retain_graph=True), 10)
    del lib_out, o, q, k, v
    return dict(
        source="diverse_channel_vit_torch/csrc/attend_project_bwd.cu",
        replaces="diverse_channel_vit_tpu/ops/fused_block.py:713",
        max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        flops=10 * rows * N_VALID * D + 4 * rows * D * D,
        bytes=2 * (rows * 3 * D + rows * D + rows * D + D * D + rows * 3 * D)
        + 4 * (rows * heads + D * D + D + 3 * D),
    )

def check_bwd_kernels(fb, torch, F):
    """Phase 3, backwards: B2 and B4 against their plain versions at flagship
    shapes, every output.

    B2 runs from the forward kernel's own o and lse, as the main path calls
    it (keys 1569-1599 masked), and again with every key valid; it takes no
    residual (the autograd Function passes dxo to the residual itself). B4
    runs with the residual fused, as the main path calls it, and without.
    dxo and do are drawn at scale 1. Padded key rows must come out of B2 with
    dk = dv = 0 exactly, and two calls of B2, as of B4, on the same inputs
    must agree bit for bit."""
    rnd = _rnd(torch, torch.Generator(device="cuda").manual_seed(1))
    return {"attend_project_bwd": check_attend_project_bwd(fb, torch, F, HEADS, rnd),
            "ln_mlp_bwd": check_ln_mlp_bwd(fb, torch, F, rnd)}


def check_ln_mlp_bwd(fb, torch, F, rnd, d=D, hid=HID):
    """B4 (ln_mlp_bwd) against its plain version at the flagship grid with
    model width ``d`` and hidden width ``hid``, every output, residual fused
    and not, then at LN_MLP_GRIDS; two calls on the same inputs bit for bit;
    its timings."""
    n = -(-N_VALID // 64) * 64
    bf16 = torch.bfloat16
    rows = B * N_VALID
    name = width_name("ln_mlp_bwd", d)
    x, do = rnd(B, n, d), rnd(B, n, d)
    s, bb = rnd(d, scale=0.1, dtype=torch.float32) + 1.0, rnd(d, scale=0.1, dtype=torch.float32)
    w1, b1 = rnd(hid, d, scale=d ** -0.5), rnd(hid)
    w2 = rnd(d, hid, scale=hid ** -0.5)
    names = ("dx", "dw1", "db1", "dw2", "db2", "ds", "db")

    def hold_ln(label, residual):
        a = (x, s, bb, w1, b1, w2, do, residual)
        return hold(name, label,
                    list(zip(names, fb.ln_mlp_bwd(*a), fb.ln_mlp_bwd_plain(*a)))), a

    (err, rel), largs = hold_ln("main path, residual fused", True)
    hold_ln("no residual", False)
    for (nb, nn), res in zip(LN_MLP_GRIDS, (False, True, False, True)):
        a = (rnd(nb, nn, d), s, bb, w1, b1, w2, rnd(nb, nn, d), res)
        hold(name, f"{nb} x {nn} tokens, residual {res}",
             list(zip(names, fb.ln_mlp_bwd(*a), fb.ln_mlp_bwd_plain(*a))))
    first, second = fb.ln_mlp_bwd(*largs), fb.ln_mlp_bwd(*largs)
    if not all(torch.equal(p, q) for p, q in zip(first, second)):
        raise AssertionError(f"{name}: two calls on the same inputs differ")
    print(f"{name}: two calls on the same inputs agree bit for bit")
    del first, second
    ms = cuda_ms(lambda: fb.ln_mlp_bwd(*largs), 10)
    plain_ms = cuda_ms(lambda: fb.ln_mlp_bwd_plain(*largs), 2, warmup=1)
    m = B * n
    splits = fb._ln_mlp_wgrad_splits(m, d, hid, torch.device("cuda"))
    ln_bwd_bytes = 6 * rows * d + 8 * rows  # x, do and dx bf16, the statistics
    part_bounds = {
        "LN pass": (4 * rows * d + 8 * rows) / PEAK_BYTES,
        "dual": max(4 * rows * d * hid / PEAK_BF16_FLOPS, (4 * rows * d + 4 * rows * hid)
                    / PEAK_BYTES),
        "dy": max(2 * rows * d * hid / PEAK_BF16_FLOPS,
                  (2 * rows * hid + (ln_bwd_bytes if d == D else 4 * rows * d)) / PEAK_BYTES),
        "LN backward": (4 * rows * d + ln_bwd_bytes) / PEAK_BYTES,  # with dy in f32
        "wgrad": 4 * rows * d * hid / PEAK_BF16_FLOPS,
        "reductions": 4 * (splits * 2 * d * hid + -(-m // 128) * (hid + 3 * d)) / PEAK_BYTES,
    }
    sub_ms = launch_split(name, lambda: fb.ln_mlp_bwd(*largs),
                          B4_PARTS if d == D else B4_PARTS_D768, part_bounds,
                          b4_l2_bytes(m, d, hid))
    lib_in = [t.detach().clone().requires_grad_()
              for t in (x, s.to(bf16), bb.to(bf16), w1, b1, w2, rnd(d))]
    lx, ls, lbb, lw1, lb1, lw2, lb2 = lib_in
    lib_out = F.linear(F.gelu(F.linear(F.layer_norm(lx, (d,), ls, lbb, 1e-6), lw1, lb1),
                              approximate="tanh"), lw2, lb2) + lx
    library_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, lib_in, do, retain_graph=True), 10)
    del lib_out
    return dict(
        source="diverse_channel_vit_torch/csrc/ln_mlp_bwd.cu",
        replaces="diverse_channel_vit_tpu/ops/fused_block.py:167",
        max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        flops=10 * rows * d * hid,
        bytes=2 * (3 * rows * d + 2 * d * hid + hid) + 4 * (2 * d + 2 * d * hid + hid + 3 * d),
        sub_ms=sub_ms,
    )


def _quant_rows(torch, v):
    s = torch.clamp_min(v.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-8)
    return torch.round(v / s).to(torch.int8), s


def _int_mm(torch, a, w):
    """a (..., K) int8 times w (N, K) int8 in int32, by cuBLASLt
    (``torch._int_mm``), as f32: the library yardstick of the int8 GEMMs."""
    out = torch._int_mm(a.reshape(-1, a.shape[-1]), w.t())
    return out.reshape(*a.shape[:-1], w.shape[0]).float()


def int8_library_ms(name: str, fn):
    """``fn``'s time, or None (printed as not measured) if this PyTorch build
    refuses ``torch._int_mm`` at these shapes."""
    try:
        return cuda_ms(fn, 10)
    except RuntimeError as e:
        print(f"{name}: library yardstick not measured: torch._int_mm raised {e}")
        return None


def code_flips(name: str, label: str, got, want) -> float:
    share = (got != want.reshape(got.shape)).float().mean().item()
    print(f"{name} ({label}): int8 codes differing from the plain version's: {share:.3e} "
          f"of {got.numel()} (at most {MAX_CODE_FLIPS})")
    if not share <= MAX_CODE_FLIPS:
        raise AssertionError(f"{name} ({label}): too many int8 codes differ")
    return share


# B8's, B4's and B3's launches, by a part of the kernel names the profiler
# reports, and what each is
B8_PARTS = (("q_rows_kernel", "LN pass"), ("q_dual_kernel", "dual"), ("q_dy_kernel", "dy"),
            ("wgrad_kernel", "wgrad"), ("reduce_partials_kernel", "reductions"))
B4_PARTS = (("ln_rows_kernel", "LN pass"), ("dual_kernel", "dual"), ("dy_kernel", "dy"),
            ("wgrad_kernel", "wgrad"), ("reduce_partials_kernel", "reductions"))
# at D = 768 dy is a GEMM into f32 and the LayerNorm backward a row pass of its own
B4_PARTS_D768 = (*B4_PARTS[:2], ("EpiStoreF32", "dy"), ("ln_bwd_rows_kernel", "LN backward"),
                 *B4_PARTS[3:])
B3_PARTS = (("ln_rows_kernel", "LN pass"), ("EpiGelu", "fc1"), ("EpiBiasResidual", "fc2"))
# B1's two launches
B1_PARTS = (("flash_packed_fwd_kernel", "attention"), ("EpiBiasResidual", "projection"))


def b4_l2_bytes(m: int, d: int, hid: int) -> dict:
    """Bytes B4's GEMM launches load from L2 into shared memory over m rows,
    from their tiles (``csrc/ln_mlp_bwd.cu``, ``csrc/ln_mlp_wgrad.cuh``,
    ``csrc/ln_mlp_gemm.cuh``), in 8 KB boxes of 64 x 64 bf16: each block's
    k-steps times what it loads a step, a multicast box counted once: at
    768 dy's blocks of two row tiles share W1's boxes (2 + 2 boxes a block
    a step)."""
    box = 64 * 64 * 2
    tiles128, tiles64 = -(-m // 128), -(-m // 64)
    dy = (tiles64 * (hid // 64) * 7 if d == 384
          else -(-m // 256) * 2 * (d // 256) * (hid // 64) * 4)
    return {"dual": tiles128 * (hid // 128) * (d // 64) * 8 * box, "dy": dy * box,
            "wgrad": 2 * (d // 128) * (hid // 192) * tiles64 * 5 * box}


def b3_l2_bytes(m: int, d: int, hid: int) -> dict:
    """The same for B3's GEMMs at 768 (``csrc/ln_mlp_gemm.cuh``): 128 x 256
    tiles, the blocks of two row tiles sharing the weight tile, so a block
    loads its A box (2 boxes) and half the B tile (2) a step."""
    box = 64 * 64 * 2
    tiles = -(-m // 256) * 2
    return {"fc1": tiles * -(-hid // 256) * (d // 64) * 4 * box,
            "fc2": tiles * (d // 256) * (hid // 64) * 4 * box}


def launch_split(name: str, fn, parts, bounds: dict, l2_bytes: dict = None) -> dict:
    """Device ms a call of ``fn`` spends in each of its launches ``parts``
    (profiler, 3 calls), printed beside each one's bound and, where
    ``l2_bytes`` gives it, the bytes its blocks load from L2 into shared
    memory (counted from the tile shapes). {label: ms or None}. A reading
    is kept only where every part's kernels were recorded 3 times or a
    multiple of it (the profiler now and then loses a window's records);
    else the window is read again, three times at most."""
    import torch

    parts = [((keys,) if isinstance(keys, str) else keys, label) for keys, label in parts]
    for _ in range(3):
        times = device_ms_by_kernel(fn, 3, torch)
        hits = [[k for k in times if any(key in k for key in keys)] for keys, _ in parts]
        if all(h and all(times[k][1] % 3 == 0 for k in h) for h in hits):
            break
        launches = {k: c for k, (_, c) in times.items()}
        print(f"{name}: the profiler lost launches of this window ({launches}); read again")
    else:
        times = {}
    split = {}
    for keys, label in parts:
        split[label] = (sum(ms for k, (ms, _) in times.items() if any(key in k for key in keys))
                        if times else None)
        shown = "not measured" if split[label] is None else f"{split[label]:.4f} ms"
        l2 = ""
        if l2_bytes and label in l2_bytes:
            l2 = f", L2 -> shared memory {l2_bytes[label] / 1e9:.2f} GB"
        print(f"{name} part {label}: {shown} a call, bound {bounds[label] * 1e3:.4f} ms{l2}")
    return split

# One hidden element of each int8 kernel's epilogue, built from int8.cuh's
# helpers alone, for counting its instructions in the SASS: B7's pass 1
# (h_pre into the row max) and pass 2 (GELU, quantisation), B8's GELU and
# GELU' from one tanhf with both dequantisations (dual) and the quantisation
# of dh_pre (dy). Inputs come from memory so that nothing folds.
EPILOGUE_PROBE = r"""
#include "int8.cuh"
using namespace dcvit;
extern "C" __global__ void b7_element(const int* a, const float* f, float* o, int8_t* q) {
  const int i = threadIdx.x;
  o[i] = fmaxf(o[i], __fadd_rn(dequant(a[i], f[0], f[1]), f[2]));
  const float h = gelu_tanh_rn(__fadd_rn(dequant(a[i + 1024], f[0], f[3]), f[4]));
  q[i] = quant_s8(h, f[5]);
}
extern "C" __global__ void b8_element(const int* a, const float* f, float* o, int8_t* q) {
  const int i = threadIdx.x;
  float g, dg;
  gelu_dgelu_tanh_rn(__fadd_rn(dequant(a[i], f[0], f[1]), f[2]), g, dg);
  const float dp = __fmul_rn(dequant(a[i + 1024], f[3], f[4]), dg);
  o[i] = g;
  o[i + 1024] = dp;
  q[i] = quant_s8(o[i + 2048], f[5]);
}
"""
# SASS opcodes that move data or steer control, not counted as epilogue work
PROBE_SKIP = ("LDG", "STG", "LDC", "ULDC", "S2R", "S2UR", "EXIT", "BRA", "NOP", "CS2R",
              "CALL", "RET", "BSSY", "BSYNC")


@functools.lru_cache(maxsize=None)
def epilogue_instructions(kernels) -> dict:
    """Static SASS instruction count of one hidden element of B7's and B8's
    epilogues (``EPILOGUE_PROBE`` built with the kernels' flags, read with
    ``cuobjdump -sass``), memory and control opcodes left out, up to each
    function's first unpredicated EXIT: the subroutines placed after it
    (``__fdiv_rn``'s slow path, reached by CALL) are left out, both sides of
    a branch in the body still count. {} (printed as not measured) where the
    toolkit lacks cuobjdump."""
    import os
    import re

    nvcc = kernels.nvcc_path()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(cuobjdump):
        print("int8 epilogue instructions: not measured (no cuobjdump beside nvcc)")
        return {}
    probe_dir = kernels.BUILD_DIR / "probe"
    probe_dir.mkdir(parents=True, exist_ok=True)
    src, cubin = probe_dir / "epilogue_probe.cu", probe_dir / "epilogue_probe.cubin"
    src.write_text(EPILOGUE_PROBE)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-cubin", "-I", str(kernels.CSRC), "-o", str(cubin), str(src)],
                   check=True, capture_output=True, text=True, timeout=300)
    sass = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True, capture_output=True,
                          text=True, timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
        if not (name and m):
            continue
        op = m.group(2).split(".")[0]
        if op == "EXIT" and not m.group(1):
            name = None  # the rest is subroutines off the fast path
        elif op not in PROBE_SKIP:
            counts[name] += 1
    print(f"int8 epilogue instructions per hidden element (static SASS count to the first "
          f"EXIT, memory and control left out): {counts}")
    return counts


@functools.lru_cache(maxsize=None)
def issue_rate() -> float:
    """Thread-instructions a second the card could issue at the SM clock's
    maximum (nvidia-smi): SMs x 4 schedulers x 32 lanes x that clock. The
    clock under load may be lower."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60).stdout.split()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * 4 * 32 * mhz * 1e6


def device_ms_by_kernel(fn, calls: int, torch) -> dict:
    """Device ms a call of each kernel ``fn`` launches, over ``calls`` calls,
    and its launches in that window, from the profiler: {kernel: (ms,
    launches)}, {} if it recorded no device time. One call runs first in a
    warm-up step whose records are dropped: the profiler can miss the first
    launch of the window it starts in."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        prof.step()
    out = {}
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", 0) or 0
        if dev > 0 and getattr(e, "device_type", None) != torch.autograd.DeviceType.CPU:
            ms, count = out.get(e.key, (0.0, 0))
            out[e.key] = (ms + dev / 1e3 / calls, count + e.count)
    return out


def check_q_kernels(fb, torch, F, kernels, d=D, hid=HID, seed=3):
    """Phase 3, the int8 ln_mlp: B7 and B8 against their plain versions at
    the flagship grid with model width ``d`` and hidden width ``hid`` (at D
    = 768 both run a cluster of two blocks per 64 rows), each output within
    KERNEL_REL_TOL and the codes of the last int8 product (hq for B7,
    dh_pre's for B8) within MAX_CODE_FLIPS. B7 runs with the residual fused
    and output biases at the residual's scale, as the main path calls it,
    then with no residual and zero output bias; B8 with the residual fused
    and without; at D = 768 both also at LN_MLP_GRIDS' 3 x 64 (a half-full
    last 128-row tile) and 1 x 100 (a ragged last 64-row tile). The library
    yardstick is the same arithmetic in PyTorch ops with ``torch._int_mm``
    (cuBLASLt int8) for the int8 GEMMs and, in B8, bf16 ``torch.matmul`` for
    the weight gradients.
    B7's instantiation that also stores h must give the main path's output
    and codes, and B8's recomputed h must equal its h, bit for bit; two B8
    calls on the same inputs agree bit for bit; B8's time is split by its
    launches (profiler) beside each one's bound; and the epilogue's
    instruction count (SASS) gives an estimate of its issue time, printed
    beside the bound: neither a bound nor a measured time."""
    n = -(-N_VALID // 64) * 64
    rnd = _rnd(torch, torch.Generator(device="cuda").manual_seed(seed))
    bf16, f32 = torch.bfloat16, torch.float32
    rows = B * N_VALID
    name7, name8 = width_name("ln_mlp_q_fwd", d), width_name("ln_mlp_q_bwd", d)
    x, do = rnd(B, n, d), rnd(B, n, d)
    s, bb = rnd(d, scale=0.1, dtype=f32) + 1.0, rnd(d, scale=0.1, dtype=f32)
    w1, b1 = rnd(hid, d, scale=d ** -0.5), rnd(hid)
    w2, b2 = rnd(d, hid, scale=hid ** -0.5), rnd(d)
    w1q, s1c, w2q, s2c, w1r, s1r, w2r, s2r = fb.quantize_mlp_weights(w1, w2, backward=True)
    results = {}
    more_grids = (LN_MLP_GRIDS[0], LN_MLP_GRIDS[3]) if d != D else ()

    # --- B7 ln_mlp_q_fwd
    fargs = (x, s, bb, w1q, s1c, b1, w2q, s2c, b2, True)
    flips = []
    cases = [("main path", fargs),
             ("no residual, zero bias",
              (x, s, bb, w1q, s1c, b1, w2q, s2c, torch.zeros_like(b2), False))]
    for nb, nn in more_grids:
        cases.append((f"{nb} x {nn} tokens, residual True",
                      (rnd(nb, nn, d), s, bb, w1q, s1c, b1, w2q, s2c, b2, True)))
    for label, a in cases:
        out, codes = fb.ln_mlp_q_fwd(*a, with_codes=True)
        out_p, codes_p = fb.ln_mlp_q_plain(*a, with_codes=True)
        worst = hold(name7, label, (("out", out, out_p),))
        flips.append(code_flips(name7, label, codes, codes_p))
        if label == "main path":
            err, rel = worst
        del out, codes, out_p, codes_p
    ms = cuda_ms(lambda: fb.ln_mlp_q_fwd(*fargs), 10)
    plain_ms = cuda_ms(lambda: fb.ln_mlp_q_plain(*fargs), 3, warmup=1)
    insns = epilogue_instructions(kernels)
    rate = issue_rate()

    def epilogue_estimate(name, key, elements):
        """Printed only: an estimate from a static count at the maximum
        clock, which may lie above or below the epilogue's real issue time."""
        if key in insns:
            print(f"{name}: epilogue estimate {insns[key] * elements / rate * 1e3:.4f} ms "
                  f"({insns[key]} instructions x {elements} hidden elements / {rate:.4g} "
                  f"thread-instructions/s at the maximum SM clock; not a bound)")

    def library():
        xf = x.float()
        yq, ys = _quant_rows(torch, F.layer_norm(xf, (d,), s, bb, 1e-6))
        h = F.gelu(_int_mm(torch, yq, w1q) * ys * s1c + b1.float(), approximate="tanh")
        hq, hs = _quant_rows(torch, h)
        return (_int_mm(torch, hq, w2q) * hs * s2c + b2.float() + xf).to(bf16)

    library_ms = int8_library_ms(name7, library)
    results[name7] = dict(
        source="diverse_channel_vit_torch/csrc/ln_mlp_q.cu",
        replaces="diverse_channel_vit_tpu/ops/fused_block.py:474",
        max_abs_err=err, rel_err=rel, code_flips=max(flips), ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, int8_ops=4 * rows * d * hid, flops=0,
        bytes=2 * 2 * rows * d + 2 * d * hid + 4 * (hid + d) + 2 * (hid + d) + 4 * 2 * d,
    )
    epilogue_estimate(name7, "b7_element", rows * hid)

    # --- B8 ln_mlp_q_bwd
    names = ("dx", "dw1", "db1", "dw2", "db2", "ds", "db")
    flips = []
    cases = [("main path, residual fused", (x, do, True)), ("no residual", (x, do, False))]
    for nb, nn in more_grids:
        cases.append((f"{nb} x {nn} tokens, residual True",
                      (rnd(nb, nn, d), rnd(nb, nn, d), True)))
    for label, (xx, dd, residual) in cases:
        a = (xx, s, bb, w1q, s1c, b1, w1r, s1r, w2r, s2r, dd, residual)
        got = fb.ln_mlp_q_bwd(*a, with_codes=True)
        want = fb.ln_mlp_q_bwd_plain(*a, with_codes=True)
        worst = hold(name8, label, list(zip(names, got[:7], want[:7])))
        flips.append(code_flips(name8, label, got[7], want[7]))
        if label.startswith("main path"):
            (err, rel), bargs = worst, a
        del got, want
    # B7's h comes from its instantiation that also stores h (ln_mlp_q.cu),
    # whose output and codes must be the main path's
    out7, codes7, h7 = fb.ln_mlp_q_fwd(*fargs, with_codes=True, with_h=True)
    out_main, codes_main = fb.ln_mlp_q_fwd(*fargs, with_codes=True)
    if not (torch.equal(out7, out_main) and torch.equal(codes7, codes_main)):
        raise AssertionError(f"{name7}: the output or codes with h differ from the main path's")
    h8 = fb.ln_mlp_q_bwd(*bargs, with_h=True)[7]
    if not torch.equal(h7, h8):
        raise AssertionError(f"{name8}: the recomputed h differs from {name7}'s")
    print(f"{name8}: the recomputed h equals {name7}'s, bit for bit (and {name7}'s output and "
          "codes with h are the main path's)")
    del out7, codes7, h7, h8, out_main, codes_main
    first, second = fb.ln_mlp_q_bwd(*bargs), fb.ln_mlp_q_bwd(*bargs)
    if not all(torch.equal(p, q) for p, q in zip(first, second)):
        raise AssertionError(f"{name8}: two calls on the same inputs differ")
    print(f"{name8}: two calls on the same inputs agree bit for bit")
    del first, second
    ms = cuda_ms(lambda: fb.ln_mlp_q_bwd(*bargs), 10)
    plain_ms = cuda_ms(lambda: fb.ln_mlp_q_bwd_plain(*bargs), 2, warmup=1)
    # B8's launches, each beside its bound (max of operations and bytes)
    m = B * n
    splits = fb._ln_mlp_wgrad_splits(m, d, hid, torch.device("cuda"))
    part_bounds = {
        "LN pass": 8 * rows * d / PEAK_BYTES,
        "dual": max(4 * rows * d * hid / PEAK_INT8_OPS, (2 * rows * d + 8 * rows * hid) / PEAK_BYTES),
        "dy": max(2 * rows * d * hid / PEAK_INT8_OPS, (4 * rows * hid + 6 * rows * d) / PEAK_BYTES),
        "wgrad": 4 * rows * d * hid / PEAK_BF16_FLOPS,
        "reductions": 4 * (splits * 2 * d * hid + -(-m // 128) * hid
                           + -(-m // 64) * 3 * d) / PEAK_BYTES,
    }
    split = launch_split(name8, lambda: fb.ln_mlp_q_bwd(*bargs), B8_PARTS, part_bounds)

    def library_bwd():
        xf, dof = x.float().reshape(-1, d), do.float().reshape(-1, d)
        mu = xf.mean(dim=-1, keepdim=True)
        rstd = torch.rsqrt(((xf - mu) ** 2).mean(dim=-1, keepdim=True) + 1e-6)
        xhat = (xf - mu) * rstd
        y = xhat * s + bb
        yq, ys = _quant_rows(torch, y)
        h_pre = (_int_mm(torch, yq, w1q) * ys * s1c + b1.float()).requires_grad_()
        with torch.enable_grad():
            h = F.gelu(h_pre, approximate="tanh")
        h16 = h.detach().to(bf16)
        dw2 = torch.matmul(do.reshape(-1, d).t(), h16)
        doq, dos = _quant_rows(torch, dof)
        dh = _int_mm(torch, doq, w2r) * dos * s2r
        (dh_pre,) = torch.autograd.grad(h, h_pre, dh)
        dw1 = torch.matmul(dh_pre.to(bf16).t(), y.to(bf16))
        dhq, dhs = _quant_rows(torch, dh_pre)
        dy = _int_mm(torch, dhq, w1r) * dhs * s1r
        dxhat = dy * s
        dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                     - xhat * (dxhat * xhat).mean(-1, keepdim=True)) + dof
        return (dx.to(bf16), dw1, dh_pre.sum(0), dw2, dof.sum(0), (dy * xhat).sum(0),
                dy.sum(0))

    library_ms = int8_library_ms(name8, library_bwd)
    results[name8] = dict(
        source="diverse_channel_vit_torch/csrc/ln_mlp_q_bwd.cu",
        replaces="diverse_channel_vit_tpu/ops/fused_block.py:525",
        max_abs_err=err, rel_err=rel, code_flips=max(flips), ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, int8_ops=6 * rows * d * hid, flops=4 * rows * d * hid,
        bytes=2 * 3 * rows * d + 3 * d * hid + 4 * (2 * hid + 3 * d) + 2 * hid
        + 4 * (2 * d * hid + hid + 3 * d), sub_ms=split,
    )
    epilogue_estimate(name8, "b8_element", rows * hid)
    return results


def check_flash_kernels(torch, F, core, heads=HEADS, dtype=None):
    """Phase 3, B5 and B6 (flash_attention_packed) against their plain
    versions at the grids the EViT path gives them (EVIT_GRIDS, B = 64,
    ``heads`` heads: 6 of 64, or 3 of 128 for the small_tpu preset; bf16),
    q, k and v as the thirds of one packed qkv tensor, as
    the model passes them. The last grid has no mask and no padded rows.
    Each output within KERNEL_REL_TOL, B5's lse within LSE_REL_TOL; B6's dk
    and dv exactly 0 on padded key rows, and two B6 calls on the same inputs
    equal bit for bit. Times are per call at each grid and summed over the
    three (one EViT forward's or step's work), beside the same sums for the
    bound, the plain version and the library call (SDPA; for B6 autograd
    through it), and printed beside B1's and B2's from ``core`` (the
    results of check_kernels and check_bwd_kernels), which run on the same
    flash core. With ``dtype`` f32, the f32 kernels (``_f32`` names; phase
    f32) at F32_GRIDS, o within F32_O_TOL, the gradients within
    F32_GRAD_TOL, the library call in f32 with TF32 off, the bound at one
    TF32 pass."""
    from diverse_channel_vit_torch.ops import attention as at

    f32 = dtype == torch.float32
    rnd = _rnd(torch, torch.Generator(device="cuda").manual_seed(2))
    dt = torch.float32 if f32 else torch.bfloat16
    dh, scale = D // heads, (D // heads) ** -0.5
    sfx = "_f32" if f32 else ""
    fname = kernel_name("flash_packed_fwd" + sfx, heads)
    bname = kernel_name("flash_packed_bwd" + sfx, heads)
    ap_f, ap_b = kernel_name("attend_project_fwd", heads), kernel_name("attend_project_bwd", heads)
    o_tol, g_tol = (F32_O_TOL, F32_GRAD_TOL) if f32 else (KERNEL_REL_TOL, KERNEL_REL_TOL)
    csrc = "diverse_channel_vit_torch/csrc/"
    fwd = dict(source=csrc + ("flash_f32.cuh" if f32 else "flash_packed.cu"),
               replaces="diverse_channel_vit_tpu/ops/attention.py:243", grids=[],
               tolerance=o_tol)
    bwd = dict(source=csrc + ("flash_f32.cuh" if f32 else "flash_packed_bwd.cu"),
               replaces="diverse_channel_vit_tpu/ops/attention.py:297", grids=[],
               tolerance=g_tol)
    for n, n_valid in (F32_GRIDS if f32 else EVIT_GRIDS):
        label = f"N {n}, n_valid {n_valid}"
        qkv = rnd(B, n, 3 * D, dtype=dt)
        q, k, v = qkv.split(D, dim=-1)
        do = rnd(B, n, D, dtype=dt)
        o, lse = at.flash_packed_fwd(q, k, v, heads, scale, n_valid, need_lse=True)
        o_p, lse_p = at.flash_packed_fwd_plain(q, k, v, heads, scale, n_valid, need_lse=True)
        err_f, rel_f = hold(fname, label, (("o", o, o_p), ("lse", lse, lse_p)), o_tol)
        rel_lse = ((lse - lse_p).abs().max() / lse_p.abs().max()).item()
        print(f"{fname} ({label}): lse rel {rel_lse:.3e} (tolerance rel <= "
              f"{LSE_REL_TOL})")
        if not rel_lse <= LSE_REL_TOL:
            raise AssertionError(f"{fname} ({label}): lse disagrees with its plain "
                                 "version")
        del o_p, lse_p
        got = at.flash_packed_bwd(q, k, v, o, do, lse, heads, scale, n_valid)
        want = at.flash_packed_bwd_plain(q, k, v, o, do, lse, heads, scale, n_valid)
        err_b, rel_b = hold(bname, label,
                            (("dq", got[0], want[0]), ("dk", got[1], want[1]),
                             ("dv", got[2], want[2])), g_tol)
        pad = int(torch.count_nonzero(got[1][:, n_valid:])) + \
            int(torch.count_nonzero(got[2][:, n_valid:]))
        if pad:
            raise AssertionError(f"{bname} ({label}): padded key rows have dk or dv != 0")
        print(f"{bname} ({label}): dk and dv exactly 0 on the {n - n_valid} padded "
              "key rows")
        again = at.flash_packed_bwd(q, k, v, o, do, lse, heads, scale, n_valid)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{bname} ({label}): two calls on the same inputs "
                                 "differ")
        print(f"{bname} ({label}): two calls on the same inputs agree bit for bit")
        del got, want, again
        keep = (torch.arange(n, device="cuda") < n_valid)[None, None, None, :]
        heads_view = qkv.view(B, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
        timing_f = dict(
            ms=cuda_ms(lambda: at.flash_packed_fwd(q, k, v, heads, scale, n_valid), 10),
            plain_ms=cuda_ms(lambda: at.flash_packed_fwd_plain(q, k, v, heads, scale, n_valid),
                             3, warmup=1),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                *heads_view, attn_mask=keep), 10))
        timing_b = dict(
            ms=cuda_ms(lambda: at.flash_packed_bwd(q, k, v, o, do, lse, heads, scale, n_valid),
                       10),
            plain_ms=cuda_ms(lambda: at.flash_packed_bwd_plain(q, k, v, o, do, lse, heads, scale,
                                                               n_valid), 2, warmup=1))
        if f32 and (n, n_valid) == F32_GRIDS[0]:
            fwd["sub_ms"], bwd["sub_ms"] = f32_passes(
                fname, bname, lambda: at.flash_packed_fwd(q, k, v, heads, scale, n_valid),
                lambda: at.flash_packed_bwd(q, k, v, o, do, lse, heads, scale, n_valid),
                n, n_valid, heads)
        lq = qkv.detach().clone().requires_grad_()
        lib_out = F.scaled_dot_product_attention(
            *lq.view(B, n, 3, heads, dh).permute(2, 0, 3, 1, 4), attn_mask=keep)
        do_h = do.view(B, n, heads, dh).transpose(1, 2)
        timing_b["library_ms"] = cuda_ms(
            lambda: torch.autograd.grad(lib_out, lq, do_h, retain_graph=True), 10)
        del lib_out, lq
        rows, size, peak = B * n_valid, qkv.element_size(), PEAK_TF32_FLOPS if f32 \
            else PEAK_BF16_FLOPS
        for entry, err, rel, timing, flops, nbytes in (
                (fwd, err_f, rel_f, timing_f, 4 * rows * n_valid * D, size * 4 * rows * D),
                (bwd, err_b, rel_b, timing_b, 10 * rows * n_valid * D,
                 size * 8 * rows * D + 4 * rows * heads)):
            entry["grids"].append(dict(n=n, n_valid=n_valid, max_abs_err=err, rel_err=rel,
                                       flops=flops, bytes=nbytes, **timing,
                                       bound_ms=1e3 * max(flops / peak, nbytes / PEAK_BYTES)))
        del qkv, q, k, v, o, lse, do
        torch.cuda.empty_cache()
    results = {}
    for name, entry in ((fname, fwd), (bname, bwd)):
        grids = entry.pop("grids")
        worst = max(grids, key=lambda g: g["rel_err"])
        entry.update(max_abs_err=worst["max_abs_err"], rel_err=worst["rel_err"],
                     **{key: sum(g[key] for g in grids)
                        for key in ("ms", "plain_ms", "library_ms", "flops", "bytes")},
                     per_grid=[{k: g[k] for k in ("n", "n_valid", "ms", "bound_ms", "plain_ms",
                                                  "library_ms")} for g in grids])
        if f32:  # bounded at the TF32 rate, not the bf16 one
            entry["tf32_flops"] = entry.pop("flops")
            entry["flops"] = 0
        results[name] = entry
    per_grid = {name: ", ".join(f"{g['ms']:.4f}" for g in results[name]["per_grid"])
                for name in results}
    if f32:
        print(f"f32 flash kernels (flash_f32.cuh), head width {dh}: B5-f32 "
              f"{results[fname]['ms']:.4f} ms ({per_grid[fname]}) and B6-f32 "
              f"{results[bname]['ms']:.4f} ms ({per_grid[bname]}) over the grids "
              f"{[g[0:2] for g in F32_GRIDS]}")
        return results
    print(f"flash core (flash_wgmma.cuh), head width {dh}: B1 {core[ap_f]['ms']:.4f} ms and B2 "
          f"{core[ap_b]['ms']:.4f} ms at N 1600; B5 {results[fname]['ms']:.4f} ms "
          f"({per_grid[fname]}) and B6 {results[bname]['ms']:.4f} ms ({per_grid[bname]}) over "
          "the EViT grids")
    return results


# B5-f32 and B6-f32 by launch: (profiler substrings, label)
F32_FWD_PARTS = (("f32a::fwd_kernel", "forward"),)
F32_BWD_PARTS = (("f32a::di_kernel", "di"),
                 (("f32a::kv_kernel", "legacy::flash_f32_kv_kernel"), "dk/dv"),
                 (("f32a::q_kernel", "legacy::flash_f32_q_kernel"), "dq"))


def f32_passes(fname: str, bname: str, fwd, bwd, n: int, n_valid: int, heads: int) -> tuple:
    """B5-f32 and B6-f32 (calls ``fwd`` and ``bwd``) at one grid split by
    launch, each pass beside its own bound: di (o and do read, di written)
    by bytes; the forward (S and P V), the dk/dv pass (S^T, dP^T, dV, dK)
    and the dq pass (S, dP, dQ) at one TF32 pass of their products over the
    real keys and queries. Returns both splits {label: ms}."""
    elems, pair = B * n * D, 2 * B * n_valid * n_valid * D  # a product's FLOPs
    fwd_b = {"forward": 2 * pair / PEAK_TF32_FLOPS}
    bwd_b = {"di": 4 * (2 * elems + B * heads * n) / PEAK_BYTES,
             "dk/dv": 4 * pair / PEAK_TF32_FLOPS, "dq": 3 * pair / PEAK_TF32_FLOPS}
    return (launch_split(fname, fwd, F32_FWD_PARTS, fwd_b),
            launch_split(bname, bwd, F32_BWD_PARTS, bwd_b))


def f32_smem() -> None:
    """The f32 kernels' dynamic shared memory a block (ptxas reports static
    shared memory only)."""
    from diverse_channel_vit_torch.ops import kernels
    import ctypes

    for name, labels in (("flash_f32_smem_fwd", ("fwd_kernel<64>", "fwd_kernel<128>")),
                         ("flash_f32_smem_bwd", ("kv_kernel<64>", "q_kernel<64>",
                                                 "legacy::flash_f32_kv_kernel<128>",
                                                 "legacy::flash_f32_q_kernel<128>"))):
        out = (ctypes.c_int * len(labels))()
        kernels.function(name)(ctypes.addressof(out), len(labels))
        print("f32 kernels' dynamic shared memory a block: " + ", ".join(
            f"{label} {size} bytes" for label, size in zip(labels, out)))


# the benchmark scripts' default geometry (scripts/bench_attn.py,
# scripts/bench_block_fusion.py: N = 1569 padded to a multiple of 128;
# scripts/bench_int8_lnmlp.py: N = 1600, every row real)
SCRIPT_N, INT8_N = 1664, 1600


def check_script_kernels(fb, torch, F, heads=HEADS):
    """Phase 3, the benchmark scripts' kernels at their scripts' default
    shapes, each against its plain version and its package sibling on the
    same inputs (the difference printed), S1 and S2 at ``heads`` heads (6
    of 64, or 3 of 128: ``bench_attn --heads 3`` and ``bench_block_fusion``
    at 3 heads), S3 with the default heads only:

    - S1 ``bwd_call`` (B = 64, N = 1664, n_valid = 1569): both schedules,
      every output, padded key rows exactly 0; ``pair_staged`` against
      ``pair_batched``, against B6 (``flash_packed_bwd``) given B5's lse on
      the same inputs, and against a second call must agree bit for bit.
      Library: autograd through SDPA on q, k and v, the backward timed.
    - S2 ``qkv_flash_fwd`` (the same grid): against B5 (``flash_packed_fwd``
      on the three views of the same qkv), bit for bit. Library: SDPA on the
      views.
    - S3 ``int8_ln_mlp`` (B = 64, N = 1600), B7's kernel launched through
      B7's wrapper: residual fused with biases at the residual's scale, then
      no residual and zero output bias; the hidden codes within
      MAX_CODE_FLIPS of the plain version's; against B7 (``ln_mlp_q_fwd``)
      on the same codes and scales, outputs and hidden codes bit for bit.
      Library: B7's composition with ``torch._int_mm``."""
    from diverse_channel_vit_torch.ops import attention as at
    from diverse_channel_vit_torch.scripts import bench_attn as s1
    from diverse_channel_vit_torch.scripts import bench_block_fusion as s2
    from diverse_channel_vit_torch.scripts import bench_int8_lnmlp as s3

    rnd = _rnd(torch, torch.Generator(device="cuda").manual_seed(4))
    bf16, f32 = torch.bfloat16, torch.float32
    n, dh = SCRIPT_N, D // heads
    scale = dh ** -0.5
    rows = B * n  # every query row is computed and read
    keep = (torch.arange(n, device="cuda") < N_VALID)[None, None, None, :]
    results = {}
    s1name, s2name = kernel_name("bwd_call", heads), kernel_name("qkv_flash_fwd", heads)

    # --- S1 bwd_call
    q, k, v, o, do = (rnd(B, n, D) for _ in range(5))
    args = (q, k, v, o, do, heads, scale, N_VALID)
    want = s1.bwd_call_plain(*args)
    got, ms = {}, {}
    for variant in s1.VARIANTS:
        got[variant] = s1.bwd_call(*args, variant)
        worst = hold(s1name, variant, list(zip(("dq", "dk", "dv"), got[variant], want)))
        if variant == "pair_staged":
            err, rel = worst
        pad = sum(int(torch.count_nonzero(t[:, N_VALID:])) for t in got[variant][1:])
        if pad:
            raise AssertionError(f"{s1name} ({variant}): padded key rows have dk or dv != 0")
        ms[variant] = cuda_ms(lambda variant=variant: s1.bwd_call(*args, variant), 10)
    print(f"{s1name}: dk and dv exactly 0 on the {n - N_VALID} padded key rows")
    sibling = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got["pair_staged"], got["pair_batched"]))
    print(f"{s1name}: max |pair_staged - pair_batched| over dq, dk, dv: {sibling:.3e} "
          "(must be 0)")
    if sibling != 0.0:
        raise AssertionError(f"{s1name}: the two schedules disagree")
    # S1 = its statistics pass (B5's lse, recomputed) + B6's passes
    lse = at.flash_packed_fwd(q, k, v, heads, scale, N_VALID, need_lse=True)[1]
    b6 = at.flash_packed_bwd(q, k, v, o, do, lse, heads, scale, N_VALID)
    b6_diff = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got["pair_staged"], b6))
    b6_ms = cuda_ms(lambda: at.flash_packed_bwd(q, k, v, o, do, lse, heads, scale, N_VALID), 10)
    print(f"{s1name}: max |S1 - B6 given B5's lse| over dq, dk, dv: {b6_diff:.3e} (must be 0); "
          f"B6 {b6_ms:.4f} ms, S1 {ms['pair_staged']:.4f} ms")
    if b6_diff != 0.0:
        raise AssertionError(f"{s1name}: S1 disagrees with B6 given B5's lse")
    for variant in s1.VARIANTS:
        again = s1.bwd_call(*args, variant)
        if not all(torch.equal(a, b) for a, b in zip(got[variant], again)):
            raise AssertionError(f"{s1name} ({variant}): two calls on the same inputs differ")
    print(f"{s1name}: two calls on the same inputs agree bit for bit in both schedules")
    del got, want, lse, b6, again
    plain_ms = cuda_ms(lambda: s1.bwd_call_plain(*args), 2, warmup=1)
    lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))
    heads_view = [t.view(B, n, heads, dh).transpose(1, 2) for t in (lq, lk, lv)]
    lib_out = F.scaled_dot_product_attention(*heads_view, attn_mask=keep, scale=scale)
    do_h = do.view(B, n, heads, dh).transpose(1, 2)
    library_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, (lq, lk, lv), do_h,
                                                     retain_graph=True), 10)
    del lib_out, lq, lk, lv, heads_view
    results[s1name] = dict(
        source="diverse_channel_vit_torch/csrc/bench_attn_bwd.cu",
        replaces="scripts/bench_attn.py:94",
        max_abs_err=err, rel_err=rel, ms=ms["pair_staged"], plain_ms=plain_ms,
        library_ms=library_ms, per_variant=ms, sibling_max_abs_diff=sibling,
        b6_max_abs_diff=b6_diff, sibling_ms=b6_ms,
        flops=10 * rows * N_VALID * D, bytes=2 * 8 * rows * D,
    )
    del q, k, v, o, do, args
    torch.cuda.empty_cache()

    # --- S2 qkv_flash_fwd
    qkv = rnd(B, n, 3 * D)
    out = s2.qkv_flash_fwd(qkv, heads, scale, N_VALID)
    err, rel = hold(s2name, "benchmark grid",
                    (("o", out, s2.qkv_flash_fwd_plain(qkv, heads, scale, N_VALID)),))
    views = qkv.split(D, dim=-1)
    b5 = at.flash_packed_fwd(*views, heads, scale, N_VALID)[0]
    sibling = (out.float() - b5.float()).abs().max().item()
    b5_ms = cuda_ms(lambda: at.flash_packed_fwd(*views, heads, scale, N_VALID), 10)
    ms = cuda_ms(lambda: s2.qkv_flash_fwd(qkv, heads, scale, N_VALID), 10)
    print(f"{s2name}: max |S2 - B5 (flash_packed_fwd)| on the same qkv {sibling:.3e} "
          f"(must be 0); B5 {b5_ms:.4f} ms, S2 {ms:.4f} ms")
    if sibling != 0.0:
        raise AssertionError(f"{s2name}: S2 disagrees with B5 on the same qkv")
    plain_ms = cuda_ms(lambda: s2.qkv_flash_fwd_plain(qkv, heads, scale, N_VALID), 3, warmup=1)
    heads_view = qkv.view(B, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(*heads_view, attn_mask=keep), 10)
    results[s2name] = dict(
        source="diverse_channel_vit_torch/csrc/qkv_flash.cu",
        replaces="scripts/bench_block_fusion.py:121",
        max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        sibling_max_abs_diff=sibling, sibling_ms=b5_ms,
        flops=4 * rows * N_VALID * D, bytes=2 * 4 * rows * D,
    )
    del qkv, out, b5, views, heads_view
    torch.cuda.empty_cache()

    if heads != HEADS:
        return results

    # --- S3 int8_ln_mlp
    rows = B * INT8_N
    x = rnd(B, INT8_N, D)
    s, bb = rnd(D, scale=0.1, dtype=f32) + 1.0, rnd(D, scale=0.1, dtype=f32)
    w1q, s1c = s3.quant_w(rnd(HID, D, scale=D ** -0.5))
    w2q, s2c = s3.quant_w(rnd(D, HID, scale=HID ** -0.5))
    b1, b2 = rnd(HID), rnd(D)
    fargs = (x, s, bb, w1q, s1c, b1, w2q, s2c, b2, True)
    flips = []
    for label, a in (("main path", fargs),
                     ("no residual, zero bias",
                      (x, s, bb, w1q, s1c, b1, w2q, s2c, torch.zeros_like(b2), False))):
        out, codes = s3.int8_ln_mlp(*a, with_codes=True)
        out_p, codes_p = s3.int8_ln_mlp_plain(*a, with_codes=True)
        worst = hold("int8_ln_mlp", label, (("out", out, out_p),))
        flips.append(code_flips("int8_ln_mlp", label, codes, codes_p))
        out7, codes7 = fb.ln_mlp_q_fwd(*a, with_codes=True)
        diff = (out.float() - out7.float()).abs().max().item()
        share = (codes != codes7).float().mean().item()
        print(f"int8_ln_mlp ({label}): against B7 (ln_mlp_q_fwd) on the same codes and scales: "
              f"max |out - out_B7| {diff:.3e}, hidden codes differing {share:.3e} (both must "
              "be 0: one kernel)")
        if diff != 0.0 or share != 0.0:
            raise AssertionError(f"int8_ln_mlp ({label}): S3 disagrees with B7")
        if label == "main path":
            (err, rel), sibling, sibling_codes = worst, diff, share
        del out, codes, out_p, codes_p, out7, codes7
    ms = cuda_ms(lambda: s3.int8_ln_mlp(*fargs), 10)
    b7_ms = cuda_ms(lambda: fb.ln_mlp_q_fwd(*fargs), 10)
    print(f"int8_ln_mlp: S3 {ms:.4f} ms, B7 {b7_ms:.4f} ms (one kernel)")
    plain_ms = cuda_ms(lambda: s3.int8_ln_mlp_plain(*fargs), 3, warmup=1)

    def library():
        xf = x.float()
        yq, ys = _quant_rows(torch, F.layer_norm(xf, (D,), s, bb, 1e-6))
        h = F.gelu(_int_mm(torch, yq, w1q) * ys * s1c + b1.float(), approximate="tanh")
        hq, hs = _quant_rows(torch, h)
        return (_int_mm(torch, hq, w2q) * hs * s2c + b2.float() + xf).to(bf16)

    library_ms = int8_library_ms("int8_ln_mlp", library)
    results["int8_ln_mlp"] = dict(
        source="diverse_channel_vit_torch/csrc/ln_mlp_q.cu",
        replaces="scripts/bench_int8_lnmlp.py:39",
        max_abs_err=err, rel_err=rel, code_flips=max(flips), ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, sibling_max_abs_diff=sibling, sibling_code_share=sibling_codes,
        sibling_ms=b7_ms, int8_ops=4 * rows * D * HID, flops=0,
        bytes=2 * 2 * rows * D + 2 * D * HID + 4 * (HID + D) + 2 * (HID + D) + 4 * 2 * D,
    )
    del x, fargs
    torch.cuda.empty_cache()
    return results


# which kernels each benchmark script run must launch: (module, argv or the
# keywords of its main, names); the last two runs are the small_tpu
# preset's head width, 3 heads of 128
SCRIPT_RUNS = (
    ("bench_attn", ["chain"], ("attend_project_fwd", "attend_project_bwd")),
    ("bench_attn", ["bwd-variants"], ("bwd_call",)),
    ("bench_attn", ["step"], ("attend_project_fwd", "ln_mlp_fwd", "attend_project_bwd",
                              "ln_mlp_bwd")),
    ("bench_attn", ["small-k"], ("attend_project_fwd", "ln_mlp_fwd", "attend_project_bwd",
                                 "ln_mlp_bwd")),
    ("bench_block_fusion", [], ("flash_packed_fwd", "flash_packed_bwd", "qkv_flash_fwd")),
    ("bench_int8_lnmlp", [], ("ln_mlp_fwd", "int8_ln_mlp")),
    ("bench_attn", ["bwd-variants", "--heads", str(HEADS_TPU)], ("bwd_call",)),
    ("bench_block_fusion", {"heads": HEADS_TPU},
     ("flash_packed_fwd", "flash_packed_bwd", "qkv_flash_fwd")),
)


def script_label(name: str, args) -> str:
    """How a run of SCRIPT_RUNS is called: its command line, or its main's
    call for a keyword that the script takes in Python only."""
    if isinstance(args, dict):
        kw = ", ".join(f"{k}={v}" for k, v in args.items())
        return f"diverse_channel_vit_torch.scripts.{name}.main({kw})"
    return " ".join(["python -m", f"diverse_channel_vit_torch.scripts.{name}", *args])


def run_geometries(fb, torch, want: dict) -> dict:
    """The port's geometry smoke (``scripts/smoke_geometries.py``) through
    its ``main``, as ``python -m`` runs it: the JAX script's five geometries,
    1 + 5 train steps each at its batch size, every loss finite (the script
    asserts it). Per geometry its launch counts, ``want`` per step (the port
    pads every token grid to a multiple of 64, So2Sat's 289 tokens to 320, so
    every geometry takes the fused route), and its phase line. Returns the
    paths by label."""
    from diverse_channel_vit_torch.scripts import smoke_geometries as sg

    fb.reset_launches()
    results = sg.main(device="cuda")
    paths = {}
    for tag, _ in sg.GEOMETRIES:
        r = results[tag]
        check_counts(f"geometry {tag}", r["launches"], r["steps"], "step", want)
        print(f"phase geometry {tag}: {r['imgs_per_s']:.2f} images/s, mean "
              f"{r['ms_per_step']:.3f} ms a step over {r['steps'] - 1} steps, peak memory "
              f"{r['peak_mem_gb']:.3f} GB; card {card_line()}")
        paths[f"geometry {tag}"] = (r["launches"], r["steps"], "step")
    torch.cuda.empty_cache()
    return paths


def run_scripts(fb):
    """Phase 11: each benchmark script through its entry point (``main``, what
    ``python -m diverse_channel_vit_torch.scripts.<name>`` calls) at its
    defaults and at 3 heads of 128 (SCRIPT_RUNS), its output echoed; the
    counts set to 0 just before each run and read just after, and each
    kernel the run exists for launched at least once. An exception ends the
    smoke run. Returns the counts by run."""
    import importlib

    counts = {}
    for name, args, names in SCRIPT_RUNS:
        label = script_label(name, args)
        mod = importlib.import_module(f"diverse_channel_vit_torch.scripts.{name}")
        print(f"== {label}", flush=True)
        t = time.perf_counter()
        fb.reset_launches()
        if isinstance(args, dict):
            mod.main(**args)
        elif args:
            mod.main(args)
        else:
            mod.main()
        launches = {k: c for k, c in fb.LAUNCHES.items() if c}
        print(f"== {label}: {time.perf_counter() - t:.1f} s; kernel launches {launches}",
              flush=True)
        missing = [k for k in names if not launches.get(k)]
        if missing:
            raise AssertionError(f"{label}: {missing} launched no time")
        counts[label] = launches
    return counts


def phase_line(label: str, imgs_per_s: float, p50_ms: float, torch) -> None:
    """A path's images/s and p50 ms beside the peak device memory since the
    path reset it and the card it ran on."""
    print(f"phase {label}: {imgs_per_s:.2f} images/s, p50 {p50_ms:.3f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; card {card_line()}")


def post_npy(port: int, image: np.ndarray, cids) -> np.ndarray:
    buf = io.BytesIO()
    np.save(buf, image)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/predict", data=buf.getvalue(), method="POST",
        headers={"Content-Type": "application/x-npy", "X-Channels": ",".join(map(str, cids))},
    )
    with urllib.request.urlopen(req, timeout=300) as resp:
        return np.load(io.BytesIO(resp.read()), allow_pickle=False)


def get_json(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
        return json.loads(resp.read())


def device_time(e, torch) -> float:
    """The device microseconds of one ``key_averages()`` item, 0 for a host
    item and for a range that ``record_function`` marks on the device's
    timeline (a user annotation, the optimizer's
    ``Optimizer.step#AdamW.step``): such a range spans kernels counted
    already."""
    if (getattr(e, "device_type", None) == torch.autograd.DeviceType.CPU
            or getattr(e, "is_user_annotation", False) or e.key.startswith("Optimizer.")):
        return 0
    return getattr(e, "self_device_time_total", 0) or 0


def profile_call(fn, label: str, torch):
    """Device time by kernel over one call of ``fn``, and the device's busy
    share of its wall time: prints the 16 largest items, then every other
    kernel of the port (``dcvit::``). Returns the rows (device us, name,
    count), largest first, and the busy share (None where the profiler
    recorded no device time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    rows = sorted(((device_time(e, torch), e.key, e.count) for e in prof.key_averages()
                   if device_time(e, torch) > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        print(f"profile of {label}: the profiler recorded no device time; breakdown not measured")
        return [], None
    print(f"profile of {label}: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%)")
    for i, (dev, key, count) in enumerate(rows):
        if i < 16 or "dcvit::" in key:
            print(f"  {100 * dev / busy:5.1f}%  {dev / 1e3:8.3f} ms  x{count:<4d} {key[:90]}")
    return rows, busy / wall_us


def model_config(depth: int, **extra):
    from diverse_channel_vit_torch.config import Config

    return Config({
        "in_channel_names": [f"ch{i}" for i in range(CHANNELS)], "img_size": [IMG],
        "patch_size": PATCH, "pretrained_model_name": "small", "depth": depth,
        "proxy_loss_lambda": 1e-3, "ortho_loss_v1_lambda": 1e-3, "gamma_s": 1.0,
        "gamma_d": 4.0, **extra,
    })


_BUILT: dict = {}


def build(depth: int, **extra):
    """DiChaViT-S on the card, random weights from seed 0, bf16 compute (or
    ``dtype`` in ``extra``), or with ``model_name`` in ``extra`` that model
    (``attn_pooling``: its config group). The first build of a configuration is kept and later ones
    are copies of it (the same seeded weights, without drawing them again on
    the host)."""
    import copy

    import torch

    from diverse_channel_vit_torch.models import build_model

    key = (depth, tuple(sorted((k, repr(v)) for k, v in extra.items())))
    if key not in _BUILT:
        extra = dict(extra)
        name, attn_pooling = extra.pop("model_name", "dichavit"), extra.pop("attn_pooling", None)
        dtype = extra.pop("dtype", torch.bfloat16)
        _BUILT[key] = build_model(name, model_config(depth, **extra),
                                  {"JUMP-CP": list(range(CHANNELS))}, CLASSES, device="cuda",
                                  dtype=dtype, seed=0, attn_pooling=attn_pooling)
    return copy.deepcopy(_BUILT[key])


def check_counts(label: str, launches: dict, units: int, unit: str, want: dict) -> None:
    """Raise unless every kernel launched ``want[name]`` times per ``unit``
    (0 for a kernel ``want`` does not name) over ``units`` of them."""
    for name, count in launches.items():
        per = want.get(name, 0)
        if units == 0 or count != per * units:
            raise AssertionError(f"{label}: {name} launched {count} times in {units} {unit}s, "
                                 f"want {per} per {unit}")
    print(f"{label}: kernel launches {launches} in {units} {unit}s, as expected")


def evit_blocks(model):
    blocks = model.feature_extractor.blocks
    depth = len(blocks)
    return [blocks[i] for i in sorted({depth // 4, depth // 2, (3 * depth) // 4})]


def kept_differences(own, ref, forced: bool) -> list:
    """Per EViT layer, how many tokens of the unpruned grid that ``own``
    kept ``ref`` did not, summed over the images. Each entry is a (B, keep)
    index tensor into the grid the layer before left. With ``forced`` the
    ``own`` route kept ``ref``'s tokens at every layer (its indices are its
    own choice on ``ref``'s grids); otherwise each route's grids follow its
    own choices."""
    out, ids_own, ids_ref = [], None, None
    for a, b in zip(own, ref):
        base = ids_ref if forced else ids_own
        a = a if base is None else base.gather(1, a)
        b = b if ids_ref is None else ids_ref.gather(1, b)
        out.append(int(sum(a.shape[1] - len(set(x.tolist()) & set(y.tolist()))
                           for x, y in zip(a.cpu(), b.cpu()))))
        ids_own, ids_ref = a, b
    return out



def prune_seams(model, extra: dict):
    """The blocks whose pruning choice one route can force on the other,
    with the names of their chosen and forced indices: PPT's every block,
    EViT's three pruning layers, or none."""
    blocks = model.feature_extractor.blocks
    if extra.get("block_type") == "block_v2":
        return list(blocks), "kept", "forced"
    if extra.get("keep_rate"):
        return evit_blocks(model), "evit_kept", "evit_forced"
    return [], None, None


def pick_differences(own, ref) -> list:
    """Per PPT block, how many of the tokens (summed over the images) or
    channels that ``own`` chose ``ref`` did not, both on ``ref``'s grids
    (the forced route's choices index the same grids)."""
    out = []
    for a, b in zip(own, ref):
        if a is None or b is None:
            out.append(0 if a is None and b is None else -1)
            continue
        rows = [(a.cpu(),), (b.cpu(),)] if a.ndim == 1 else [a.cpu(), b.cpu()]
        out.append(int(sum(len(x) - len(set(x.tolist()) & set(y.tolist()))
                           for x, y in zip(*rows))))
    return out


@contextlib.contextmanager
def attention_grids(fb):
    """Record the (N, n_valid) of every attention call inside the block:
    ``flash_attention_packed`` (B5 / B6) as the blocks call it, before it
    pads, and ``attend_project`` (B1 / B2)."""
    from diverse_channel_vit_torch.models import vit

    seen = []
    real_flash, real_ap = vit.flash_attention_packed, fb.attend_project

    def flash(q, k, v, num_heads, sm_scale=None, valid_len=None):
        seen.append(("flash", q.shape[1], q.shape[1] if valid_len is None else int(valid_len)))
        return real_flash(q, k, v, num_heads, sm_scale, valid_len)

    def attend_project(y, *args):
        valid_len = args[7] if len(args) > 7 else None
        seen.append(("attend_project", y.shape[1],
                     y.shape[1] if valid_len is None else int(valid_len)))
        return real_ap(y, *args)

    vit.flash_attention_packed, fb.attend_project = flash, attend_project
    try:
        yield seen
    finally:
        vit.flash_attention_packed, fb.attend_project = real_flash, real_ap


def resnet_scorer(torch):
    """The ``_resnet34`` sampler's scorer as the Trainer builds it without
    ``model.resnet34_ckpt``: a ResNet-34 trunk, random init from seed 0, bf16,
    on the card."""
    from diverse_channel_vit_torch.models.resnet import (RESNET34_LAYERS, ResNetFeatures,
                                                         per_channel_features)

    net = ResNetFeatures(RESNET34_LAYERS, dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(0), device="cuda")
    return lambda x: per_channel_features(net, x)


def logits_close(label: str, got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if not np.isfinite(got).all():
        raise AssertionError(f"{label}: logits not finite")
    err = float(np.abs(got - want).max())
    rel = err / float(np.abs(want).max())
    print(f"{label}: max_abs_err {err:.3e} rel {rel:.3e} (tolerance rel <= {LOGITS_REL_TOL})")
    if not rel <= LOGITS_REL_TOL:
        raise AssertionError(f"{label}: kernel route disagrees with the plain route")
    return rel


def serve(fb, torch, label: str = "serving", **extra):
    """Phase 5: full-width DiChaViT-S (or with ``extra`` another preset of
    the same width) through the serving entry points."""
    from diverse_channel_vit_torch.serving import ServingEngine
    from diverse_channel_vit_torch.serving_http import ServingHTTPServer

    model = build(DEPTH, **extra)
    engine = ServingEngine(model, buckets=BUCKETS, device="cuda")
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((B, CHANNELS, IMG, IMG), dtype=np.float32)
    full, sub = list(range(CHANNELS)), [0, 3, 5]

    torch.cuda.reset_peak_memory_stats()
    fb.reset_launches()
    engine.n_forwards = 0
    t0 = time.perf_counter()
    engine.warmup(full, (IMG, IMG))
    out64 = engine.predict(imgs, full)
    out3 = engine.predict(imgs[:3], full)
    out_sub = engine.predict(np.ascontiguousarray(imgs[:4, sub]), sub)
    engine.start()
    futs = [engine.submit(imgs[i], full) for i in range(5)]
    out_submit = np.stack([f.result(timeout=300) for f in futs])
    server = ServingHTTPServer(engine, port=0).start()
    try:
        out_http = post_npy(server.port, imgs[7], full)
        health = get_json(server.port, "/healthz")
        stats = get_json(server.port, "/v1/stats")
    finally:
        server.stop()
    timings = {}
    for bucket in BUCKETS:
        reps = 8 if bucket == 64 else 20
        lats = []
        for _ in range(reps):
            t = time.perf_counter()
            engine.predict(imgs[:bucket], full)
            lats.append(time.perf_counter() - t)
        lats = np.sort(np.asarray(lats))
        timings[bucket] = {
            "imgs_per_s": bucket * reps / float(lats.sum()),
            "p50_ms": float(np.percentile(lats, 50)) * 1e3,
            "p99_ms": float(np.percentile(lats, 99)) * 1e3,
            "reps": reps,
        }
    profile_call(lambda: engine.predict(imgs, full), "one 64-image predict", torch)
    launches, forwards = dict(fb.LAUNCHES), engine.n_forwards
    print(f"main path: {forwards} forwards in {time.perf_counter() - t0:.1f} s; "
          f"health {health}; stats {stats}")
    # blocks 0-10 fused, block 11 the CLS readout; no flash_packed, no backward
    check_counts(label, launches, forwards, "forward",
                 {"attend_project_fwd": DEPTH - 1, "ln_mlp_fwd": DEPTH - 1})

    outs = {"predict64": out64, "predict3": out3, "predict_subset": out_sub,
            "submit": out_submit, "http": out_http}
    for key, val in outs.items():
        if not np.isfinite(val).all():
            raise AssertionError(f"{key}: logits not finite")
    if out64.shape != (B, CLASSES) or out_sub.shape != (4, CLASSES) or out_http.shape != (CLASSES,):
        raise AssertionError("unexpected logits shape")
    # the same images through other buckets and entry points agree
    scale = np.abs(out64).max()
    for key, got, want in (("predict3", out3, out64[:3]), ("submit", out_submit, out64[:5]),
                           ("http", out_http, out64[7])):
        rel = np.abs(got - want).max() / scale
        print(f"{key} vs the 64-bucket rows: rel {rel:.3e} (tolerance {KERNEL_REL_TOL})")
        if rel > KERNEL_REL_TOL:
            raise AssertionError(f"{key} disagrees with the same images in the 64 bucket")

    # the same model through the plain versions, on the card
    with fb.plain_versions(), torch.inference_mode():
        cid = torch.arange(CHANNELS, device="cuda")
        ref = model(torch.from_numpy(imgs).cuda().to(torch.bfloat16), cid)[0].float().cpu().numpy()
        cid_sub = torch.tensor(sub, device="cuda")
        ref_sub = model(torch.from_numpy(np.ascontiguousarray(imgs[:4, sub])).cuda()
                        .to(torch.bfloat16), cid_sub)[0].float().cpu().numpy()
    if dict(fb.LAUNCHES) != launches:
        raise AssertionError("the plain run launched a kernel")
    for key, got, want in (("predict64", out64, ref), ("predict_subset", out_sub, ref_sub)):
        logits_close(f"logits {key} vs plain versions on the card", got, want)
    engine.stop()
    print(f"{label} " + json.dumps({"buckets": timings}))
    phase_line(f"{label}, bucket 64", timings[64]["imgs_per_s"], timings[64]["p50_ms"], torch)
    del model, engine
    return launches, forwards


def serve_int8(fb, torch, label: str = "int8 serving", **extra):
    """Phase 5d: int8 serving of DiChaViT-S (or with ``extra`` another
    preset, such as the base one). One bf16 model behind two engines:
    ``ServingEngine(quantization="int8")`` serves buckets 1-64 through
    ``predict``, ``submit`` and ``ServingHTTPServer``, the counts set to 0
    just before and read just after (per forward B7 and B1 x 11, no B3);
    then a 64-image ``predict`` of the unquantised engine on the same model
    must launch B3 x 11 and no B7, and give other logits. The int8 logits are
    held against the plain route on the card."""
    from diverse_channel_vit_torch.serving import ServingEngine
    from diverse_channel_vit_torch.serving_http import ServingHTTPServer

    model = build(DEPTH, **extra)
    engine = ServingEngine(model, buckets=BUCKETS, device="cuda", quantization="int8")
    dense_engine = ServingEngine(model, buckets=BUCKETS, device="cuda")
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((B, CHANNELS, IMG, IMG), dtype=np.float32)
    full = list(range(CHANNELS))

    torch.cuda.reset_peak_memory_stats()
    fb.reset_launches()
    engine.n_forwards = 0
    engine.warmup(full, (IMG, IMG))
    out64 = engine.predict(imgs, full)
    engine.start()
    out_submit = np.stack([f.result(timeout=300)
                           for f in [engine.submit(imgs[i], full) for i in range(5)]])
    server = ServingHTTPServer(engine, port=0).start()
    try:
        out_http = post_npy(server.port, imgs[7], full)
    finally:
        server.stop()
        engine.stop()
    timings = {}
    for bucket in BUCKETS:
        reps = 8 if bucket == 64 else 20
        lats = []
        for _ in range(reps):
            t = time.perf_counter()
            engine.predict(imgs[:bucket], full)
            lats.append(time.perf_counter() - t)
        lats = np.sort(np.asarray(lats))
        timings[bucket] = {"imgs_per_s": bucket * reps / float(lats.sum()),
                           "p50_ms": float(np.percentile(lats, 50)) * 1e3,
                           "p99_ms": float(np.percentile(lats, 99)) * 1e3, "reps": reps}
    launches, forwards = dict(fb.LAUNCHES), engine.n_forwards
    check_counts(label, launches, forwards, "forward",
                 {"attend_project_fwd": DEPTH - 1, "ln_mlp_q_fwd": DEPTH - 1})
    # peak memory of the int8 engine's own forwards (the checks below add more)
    phase_line(f"{label}, bucket 64", timings[64]["imgs_per_s"], timings[64]["p50_ms"], torch)
    profile_call(lambda: engine.predict(imgs, full), f"one 64-image predict ({label})", torch)

    fb.reset_launches()
    dense_engine.n_forwards = 0
    dense = dense_engine.predict(imgs, full)
    check_counts(f"bf16 serving beside {label}", dict(fb.LAUNCHES), dense_engine.n_forwards,
                 "forward", {"attend_project_fwd": DEPTH - 1, "ln_mlp_fwd": DEPTH - 1})
    if {blk.quantization for blk in model.feature_extractor.blocks} != {"none"}:
        raise AssertionError("the int8 engine changed the model's own quantization")
    for key, val in (("predict64", out64), ("submit", out_submit), ("http", out_http)):
        if not np.isfinite(val).all():
            raise AssertionError(f"{label} {key}: logits not finite")
    if out64.shape != (B, CLASSES) or out_http.shape != (CLASSES,):
        raise AssertionError(f"unexpected {label} logits shape")
    scale = np.abs(out64).max()
    for key, got, want in (("submit", out_submit, out64[:5]), ("http", out_http, out64[7])):
        rel = np.abs(got - want).max() / scale
        print(f"{label} {key} vs the 64-bucket rows: rel {rel:.3e} (tolerance {KERNEL_REL_TOL})")
        if rel > KERNEL_REL_TOL:
            raise AssertionError(f"{label} {key} disagrees with the same images in the 64 bucket")
    moved = float(np.abs(out64 - dense).max() / np.abs(dense).max())
    print(f"{label} logits vs the bf16 engine's: rel {moved:.3e} (must differ)")
    if moved == 0.0:
        raise AssertionError(f"{label}: the int8 engine's logits equal the bf16 engine's")
    with fb.plain_versions(), fb.quantization("int8"), torch.inference_mode():
        ref = model(torch.from_numpy(imgs).cuda().to(torch.bfloat16),
                    torch.arange(CHANNELS, device="cuda"))[0].float().cpu().numpy()
    logits_close(f"{label} logits vs plain versions on the card", out64, ref)
    print(f"{label} " + json.dumps({"buckets": timings}))
    del model, engine, dense_engine
    torch.cuda.empty_cache()
    return launches, forwards, timings


def serve_evit(fb, torch):
    """Phase 5b: EViT-pruned DiChaViT-S (keep_rate 0.7) through
    ``ServingEngine`` and one HTTP request, the counts set to 0 just before
    and read just after: per forward B5 at the three pruning layers and B1 /
    B3 at the other eight non-readout blocks. The HTTP request (bucket 1)
    keeps the tokens the 64-image forward kept for its image, so the two can
    be held together; then the logits against the plain route on the card,
    the kernel route keeping the plain route's tokens. How many tokens each
    route would keep of its own accord is printed beside."""
    from diverse_channel_vit_torch.serving import ServingEngine
    from diverse_channel_vit_torch.serving_http import ServingHTTPServer

    model = build(DEPTH, keep_rate=KEEP_RATE)
    blocks = evit_blocks(model)
    engine = ServingEngine(model, buckets=BUCKETS, device="cuda")
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((B, CHANNELS, IMG, IMG), dtype=np.float32)
    full = list(range(CHANNELS))

    fb.reset_launches()
    engine.n_forwards = 0
    out64 = engine.predict(imgs, full)
    kept64 = [blk.evit_kept.clone() for blk in blocks]
    lats = []
    for _ in range(8):
        t = time.perf_counter()
        engine.predict(imgs, full)
        lats.append(time.perf_counter() - t)
    engine.start()
    server = ServingHTTPServer(engine, port=0).start()
    try:
        for blk, idx in zip(blocks, kept64):
            blk.evit_forced = idx[7:8]
        out_http = post_npy(server.port, imgs[7], full)
        own_http = [blk.evit_kept.clone() for blk in blocks]
    finally:
        server.stop()
        engine.stop()
        for blk in blocks:
            blk.evit_forced = None
    launches, forwards = dict(fb.LAUNCHES), engine.n_forwards
    check_counts("EViT serving", launches, forwards, "forward",
                 {"attend_project_fwd": DEPTH - 4, "ln_mlp_fwd": DEPTH - 4,
                  "flash_packed_fwd": 3})
    print(f"EViT serving: kept tokens per pruning layer {[k.shape[1] for k in kept64]}; "
          f"bucket 1 would keep otherwise "
          f"{kept_differences(own_http, [k[7:8] for k in kept64], forced=True)}"
          " tokens of image 7")
    lats = np.sort(np.asarray(lats))
    timing = {"imgs_per_s": B * len(lats) / float(lats.sum()),
              "p50_ms": float(np.percentile(lats, 50)) * 1e3, "reps": len(lats)}
    print("EViT serving bucket 64 " + json.dumps(timing))
    profile_call(lambda: engine.predict(imgs, full), "one 64-image EViT predict", torch)
    if out64.shape != (B, CLASSES) or out_http.shape != (CLASSES,):
        raise AssertionError("unexpected logits shape")
    rel = np.abs(out_http - out64[7]).max() / np.abs(out64).max()
    print(f"EViT http vs the 64-bucket row, same kept tokens: rel {rel:.3e} "
          f"(tolerance {KERNEL_REL_TOL})")
    if not rel <= KERNEL_REL_TOL:
        raise AssertionError("EViT http disagrees with the same image in the 64 bucket")

    x = torch.from_numpy(imgs).cuda().to(torch.bfloat16)
    cid = torch.arange(CHANNELS, device="cuda")
    with fb.plain_versions(), torch.inference_mode():
        ref = model(x, cid)[0].float().cpu().numpy()
    kept_plain = [blk.evit_kept.clone() for blk in blocks]
    print(f"EViT serving: the 64-image predict kept "
          f"{kept_differences(kept64, kept_plain, forced=False)} tokens per pruning layer that "
          "the plain route did not")
    for blk, idx in zip(blocks, kept_plain):
        blk.evit_forced = idx
    with torch.inference_mode():
        got = model(x, cid)[0].float().cpu().numpy()
    for blk in blocks:
        blk.evit_forced = None
    logits_close("EViT logits vs plain versions on the card, same kept tokens", got, ref)
    del model, engine
    torch.cuda.empty_cache()
    return launches, forwards, timing


def serve_gelu_exact(fb, torch):
    """Phase 5c: DiChaViT-S with ``gelu_exact`` at full width, one 64-image
    ``predict``: every non-readout block takes the unfused route (B5 x 11,
    no B1 / B3); a profile of a second predict; the logits against the plain
    route on the card."""
    from diverse_channel_vit_torch.serving import ServingEngine

    model = build(DEPTH, gelu_exact=True)
    engine = ServingEngine(model, buckets=BUCKETS, device="cuda")
    imgs = np.random.default_rng(0).standard_normal((B, CHANNELS, IMG, IMG), dtype=np.float32)
    engine.predict(imgs[:1], list(range(CHANNELS)))  # first use, outside the count
    fb.reset_launches()
    engine.n_forwards = 0
    t = time.perf_counter()
    out = engine.predict(imgs, list(range(CHANNELS)))
    secs = time.perf_counter() - t
    launches, forwards = dict(fb.LAUNCHES), engine.n_forwards
    check_counts("gelu_exact serving", launches, forwards, "forward",
                 {"flash_packed_fwd": DEPTH - 1})
    print(f"gelu_exact serving: one 64-image predict {secs * 1e3:.2f} ms")
    profile_call(lambda: engine.predict(imgs, list(range(CHANNELS))),
                 "one 64-image gelu_exact predict", torch)
    with fb.plain_versions(), torch.inference_mode():
        ref = model(torch.from_numpy(imgs).cuda().to(torch.bfloat16),
                    torch.arange(CHANNELS, device="cuda"))[0].float().cpu().numpy()
    logits_close("gelu_exact logits vs plain versions on the card", out, ref)
    del model, engine
    torch.cuda.empty_cache()
    return launches, forwards


def recipe_ks(n_draws: int = 48) -> list:
    """The JAX benchmark's k mixture of the DCS recipe (``bench.py:137``
    ``_recipe_ks``): k ~ U[1, 8] from numpy's ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    return [int(rng.integers(1, CHANNELS + 1)) for _ in range(n_draws)]


def train_setup(depth: int, torch, ks=None, runtime=None, knobs=None, **extra):
    """Model, train state and steps as a user builds them: DiChaViT-S with
    f32 parameters from seed 0 and bf16 compute; AdamW with the JUMP-CP
    weight-decay schedule (optimizer/adamw_jumpcp.yaml) under the cosine lr
    schedule (scheduler/cosine.yaml); CE + CDL + TDL with
    extra_loss_lambda = 1. ``steps[i % len(steps)]`` is step i's function:
    one all-channel step, or with ``ks`` the DCS recipe's step for k = ks[i]
    (``HCS_METHOD`` at ``HCS_TEMP``, one step function per distinct k, all
    drawing from one generator seeded with 0 on the card). ``runtime``, as
    the Trainer wires ``train.miro`` and ``model.unfreeze_last_n_layers``:
    ``{"miro": True}`` adds the pre-featurizer, the encoders (their lr
    ``MIRO_LR_MULT`` times the others') and ``MIRO_LD`` times MIRO's loss;
    ``{"unfreeze_last_n_layers": n}`` leaves the frozen parameters out of
    the optimizer. DropPath is the model key ``drop_path_rate``; each step
    function draws its masks (and HCS token dropout its kept tokens) from a
    generator of its own seeded with 0. ``knobs``: ``{"sampler": method}``
    samples ``KNOB_K`` channels a step by that method (the ``_resnet34``
    one scored by a randomly initialised ResNet-34, :func:`resnet_scorer`),
    drawing from a generator of its own seeded with 0; ``{"optimizer":
    (name, params)}`` takes that optimizer in AdamW's place."""
    from diverse_channel_vit_torch.training import (
        TrainState, make_lr_schedule, make_optimizer, make_train_step)

    model = build(depth, **extra)
    runtime, knobs = runtime or {}, knobs or {}
    kw = dict(channel_ids=range(CHANNELS), loss_type="ce", extra_loss_lambda=1.0)
    frozen, mult = set(), None
    if runtime.get("miro"):
        from diverse_channel_vit_torch.training.miro import (MIRO_KEY, init_encoders,
                                                             pre_featurizer)

        kw.update(miro_pre=pre_featurizer(model), miro_ld=MIRO_LD)
        setattr(model, MIRO_KEY, init_encoders(model))
        mult = MIRO_LR_MULT
    if runtime.get("unfreeze_last_n_layers") is not None:
        from diverse_channel_vit_torch.training.freeze import (build_trainable_labels,
                                                               frozen_names)

        frozen = frozen_names(build_trainable_labels(
            model.named_parameters(), unfreeze_last_n_layers=runtime["unfreeze_last_n_layers"]))
    lr = make_lr_schedule("cosine", 2.5e-4, dict(
        t_initial="FILL_LATER", lr_min=1e-6, cycle_mul=1.0, cycle_decay=0.5, cycle_limit=1,
        warmup_t=3, warmup_lr_init=1e-5, warmup_prefix=False, t_in_epochs=True, k_decay=1.0,
    ), num_epochs=100, steps_per_epoch=100)
    opt_name, opt_params = knobs.get("optimizer", ("adamw", ADAMW_JUMPCP))
    tx = make_optimizer(opt_name, dict(opt_params), lr_schedule=lr, total_steps=10_000)
    state = TrainState(model, tx, frozen=frozen, miro_lr_mult=mult)
    if knobs.get("sampler"):
        method = knobs["sampler"]
        kw.update(k=KNOB_K, hcs_method=method, hcs_temp=SAMPLER_TEMP,
                  generator=torch.Generator(device="cuda").manual_seed(0))
        if method.endswith("_resnet34"):
            kw["feature_fn"] = resnet_scorer(torch)
    if ks is None:
        return model, state, [make_train_step(model, **kw)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    by_k = {k: make_train_step(model, k=k, hcs_method=HCS_METHOD, hcs_temp=HCS_TEMP,
                               generator=gen, **kw) for k in sorted(set(ks))}
    return model, state, [by_k[k] for k in ks]


def synthetic_batch(torch):
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((B, CHANNELS, IMG, IMG), dtype=np.float32)
    labels = rng.integers(0, CLASSES, size=B)
    return {"image": torch.from_numpy(imgs).cuda(), "label": torch.from_numpy(labels).cuda()}


def train(fb, torch, label: str, want: dict, runtime=None, knobs=None, warm=2, timed=10,
          table=True, **extra):
    """The DiChaViT-S train step on the card at full width: counts set to 0
    just before ``warm`` warm-up and ``timed`` timed steps and read just
    after, each kernel ``want[name]`` launches per step; then one profiled
    step, printed as a table by device time, or without ``table`` kept as
    the port's kernels by launch (``timing["profiled"]``). ``runtime``,
    ``knobs`` and ``extra`` as in :func:`train_setup`."""
    batch = synthetic_batch(torch)
    model, state, (step,) = train_setup(DEPTH, torch, runtime=runtime, knobs=knobs, **extra)
    n_params = sum(p.numel() for p in model.parameters())
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise AssertionError("the model's parameters are not f32")
    torch.cuda.reset_peak_memory_stats()
    fb.reset_launches()
    lats, losses = [], []
    for i in range(warm + timed):
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        if i >= warm:
            lats.append(time.perf_counter() - t)
        losses.append({k: float(v) for k, v in m.items() if k != "sampled_channels"})
    launches, steps = dict(fb.LAUNCHES), warm + timed
    check_counts(label, launches, steps, "step", want)
    for i, m in enumerate(losses):
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"{label} step {i}: non-finite metrics {m}")
    print(f"{label} metrics, step 0: {json.dumps(losses[0])}; step {steps - 1}: "
          f"{json.dumps(losses[-1])}")
    lats = np.asarray(lats)
    timing = {"imgs_per_s": B * timed / float(lats.sum()),
              "p50_ms": float(np.percentile(lats, 50)) * 1e3,
              "min_ms": float(lats.min()) * 1e3, "max_ms": float(lats.max()) * 1e3,
              "steps": timed, "batch": B, "params": n_params,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"{label} " + json.dumps(timing))
    phase_line(label, timing["imgs_per_s"], timing["p50_ms"], torch)
    if table:
        profile_call(lambda: step(state, batch), f"one {label} step (64 images)", torch)
    else:
        timing["profiled"] = profiled_launches(lambda: step(state, batch), torch)
    del model, state, step
    torch.cuda.empty_cache()
    return launches, steps, timing


def train_recipe(fb, torch, want: dict, label: str = "DCS recipe train", **extra):
    """The DCS recipe at full width: B = 64, k drawn per step from the JAX
    benchmark's 48-draw mixture, one step function per k over one train
    state (``extra``: model config keys, such as another preset or EViT's
    keep_rate). Each distinct k is warmed once and that pass discarded (a
    fresh shape's first pass runs slow); then counts set to 0 just before
    the 48 timed steps and read just after, each kernel ``want[name]``
    launches per step, whatever k. The p50 step is the median interval
    between CUDA events recorded after each step (no host synchronisation
    inside the timed run)."""
    batch = synthetic_batch(torch)
    ks = recipe_ks()
    model, state, steps = train_setup(DEPTH, torch, ks=ks, **extra)
    first = {}
    for i, k in enumerate(ks):
        first.setdefault(k, i)
    for k, i in sorted(first.items()):
        state, m = steps[i](state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fb.reset_launches()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(len(ks) + 1)]
    t = time.perf_counter()
    events[0].record()
    metrics = []
    for i in range(len(ks)):
        state, m = steps[i](state, batch)
        events[i + 1].record()
        metrics.append(m)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    launches = dict(fb.LAUNCHES)
    check_counts(label, launches, len(ks), "step", want)
    sampled = [m["sampled_channels"].tolist() if "sampled_channels" in m else "all"
               for m in metrics[:6]]
    losses = [float(m["loss"]) for m in metrics]
    if not np.isfinite(losses).all():
        raise AssertionError(f"{label}: non-finite losses {losses}")
    for k, m in zip(ks, metrics):
        got = len(m["sampled_channels"]) if "sampled_channels" in m else CHANNELS
        if got != k:
            raise AssertionError(f"{label}: a k = {k} step trained on {got} channels")
    timing = {"imgs_per_s": B * len(ks) / secs, "steps": len(ks), "batch": B,
              "mean_k": float(np.mean(ks)), "secs": secs,
              "p50_ms": float(np.percentile(step_ms, 50)),
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"{label}: k of the first steps {ks[:6]}, channels drawn {sampled}; "
          f"losses {losses[0]:.4f} .. {losses[-1]:.4f}")
    print(f"{label} " + json.dumps(timing))
    phase_line(label, timing["imgs_per_s"], timing["p50_ms"], torch)
    del model, state, steps
    torch.cuda.empty_cache()
    return launches, len(ks), timing


def train_parity(fb, torch, label: str, depth: int, n_steps: int, want: dict, ks=None,
                 runtime=None, knobs=None, loss_tol=TRAIN_LOSS_REL_TOL,
                 grad_tol=TRAIN_GRAD_REL_TOL, **extra):
    """Kernel route against plain route from the same weights: ``n_steps``
    steps at ``depth`` (with ``ks``, the recipe's steps at those k, both
    routes drawing from generators of the same seed), losses within
    TRAIN_LOSS_REL_TOL and step-0 gradients within TRAIN_GRAD_REL_TOL of
    max|g|, the channels drawn equal. The plain route runs first; its EViT
    blocks' kept tokens are forced on the kernel route step by step
    (near-equal CLS scores may otherwise keep another boundary token), and
    how many tokens the kernel route would have kept otherwise is printed.
    ``runtime`` as in :func:`train_setup`: both routes draw the same DropPath
    masks (each step function's own generator seeded with 0), and the frozen
    parameters must come out of the steps unchanged on both. ``knobs`` as
    there: both routes draw the same channels and HCS token drops; PPT's
    kept tokens or channels (``block_type="block_v2"``) are forced as
    EViT's are. The (N, n_valid) of the kernel route's attention calls go
    into ``LAST_GRIDS[label]``. ``loss_tol`` and ``grad_tol`` replace the
    bf16 tolerances (the f32 phase's are tighter)."""
    batch = synthetic_batch(torch)
    runs = {}
    for route in ("plain", "kernels"):
        model, state, steps = train_setup(depth, torch, ks=ks, runtime=runtime, knobs=knobs,
                                          **extra)
        frozen0 = {n: p.detach().clone() for n, p in model.named_parameters()
                   if n in state.frozen}
        blocks, kept_attr, forced_attr = prune_seams(model, extra)
        before = dict(fb.LAUNCHES)
        ctx = fb.plain_versions() if route == "plain" else attention_grids(fb)
        route_losses, grads0, kept, flips, drawn = [], None, [], [], []
        with ctx as seen:
            for i in range(n_steps):
                if route == "kernels":
                    for blk, idx in zip(blocks, runs["plain"][3][i]):
                        setattr(blk, forced_attr, idx)
                state, m = steps[i % len(steps)](state, batch)
                route_losses.append(float(m["loss"]))
                drawn.append(m["sampled_channels"].tolist() if "sampled_channels" in m else None)
                kept.append([None if getattr(blk, kept_attr) is None
                             else getattr(blk, kept_attr).clone() for blk in blocks])
                if route == "kernels":
                    flips.append(kept_differences(kept[-1], runs["plain"][3][i], forced=True)
                                 if extra.get("keep_rate")
                                 else pick_differences(kept[-1], runs["plain"][3][i]))
                if i == 0:
                    grads0 = {n: p.grad.float().clone() for n, p in model.named_parameters()
                              if p.grad is not None}
        if route == "kernels":
            LAST_GRIDS[label] = list(seen)
        torch.cuda.synchronize()
        counts = {k: fb.LAUNCHES[k] - before[k] for k in before}
        for n, p in model.named_parameters():
            if n in frozen0 and not torch.equal(p.detach(), frozen0[n]):
                raise AssertionError(f"{label}: frozen {n} moved on the {route} route")
        runs[route] = (route_losses, grads0, counts, kept, flips, drawn)
        del model, state, steps
        torch.cuda.empty_cache()
    (lk, gk, nk, _, flips, dk), (lp, gp, np_, _, _, dp) = runs["kernels"], runs["plain"]
    if any(np_.values()):
        raise AssertionError(f"{label}: the plain training run launched kernels: {np_}")
    check_counts(f"{label}, kernel route", nk, n_steps, "step", want)
    if extra.get("keep_rate") or extra.get("block_type") == "block_v2":
        print(f"{label}: picks the kernel route would have made otherwise, per step and "
              f"pruning layer, of {B} images: {flips}")
    if ks is not None or any(dk):
        print(f"{label}: channels drawn per step, kernel route {dk}, plain route {dp}")
        if dk != dp:
            raise AssertionError(f"{label}: the two routes drew other channels")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    print(f"{label} (depth {depth}, {n_steps} steps): losses kernels {lk} plain {lp}, "
          f"max rel {loss_rel:.3e} (tolerance {loss_tol})")
    if not loss_rel <= loss_tol:
        raise AssertionError(f"{label}: losses of the kernel and plain routes disagree")
    worst = (0.0, "")
    for name, g in gk.items():
        ref = gp[name]
        scale = ref.abs().max().item()
        rel = (g - ref).abs().max().item() / scale if scale else (g - ref).abs().max().item()
        worst = max(worst, (rel, name))
    print(f"{label}: step-0 gradients of {len(gk)} parameter tensors, worst rel "
          f"{worst[0]:.3e} ({worst[1]}) (tolerance {grad_tol} of max|g|)")
    if not worst[0] <= grad_tol:
        raise AssertionError(f"{label}: gradient of {worst[1]} disagrees")
    return {"loss_rel": loss_rel, "grad_rel": worst[0], "grad_worst": worst[1]}


# the training entry point (``python -m diverse_channel_vit_torch.main``) at
# the flagship geometry on the synthetic dataset: 640 images (10 steps an
# epoch at B = 64), 128 eval images a split
TRAINER_OVERRIDES = [
    "dataset.img_size=224", "model.img_size=[224]", "model.patch_size=16",
    "model.pretrained_model_name=small", "dataset.num_classes=161", "train.batch_size=64",
    "dataset.num_train_samples=640", "dataset.num_eval_samples=128", "eval.every_n_epochs=1",
]
TRAIN_SEED = 1234  # the Trainer's seed when train.seed is unset


class TrainerProbe:
    """Records what a Trainer run through ``main`` did, by wrapping the
    Trainer's methods for the length of a ``with`` block: the Trainer built,
    each epoch's metrics, wall time and peak device memory (since the run's
    or the last evaluation's start), each CHAMMI step's metrics, the k of
    every DCS draw, each evaluation's wall time and peak device memory, and
    the eval forwards and the attention plots (``train.plot_attn``); of a
    CHAMMI evaluation (``evaluation/morphem_eval``)
    also the seconds of its feature forwards and of its benchmark, and the
    features of each (strategy, chunk); of any other also the seconds of
    ``eval_regular`` and of the channel-subset sweep.
    With ``profile_epoch`` that epoch runs under ``torch.profiler`` (device
    activity only) and its device busy time is kept."""

    def __init__(self, torch, profile_epoch=None):
        self.torch, self.profile_epoch = torch, profile_epoch
        self.trainer, self.epochs, self.draws, self.evals = None, {}, [], []
        self.eval_forwards, self.busy_us, self.steps, self.plots = 0, None, [], 0
        self.feature_rows, self.features, self.split = {}, {}, {}
        self.tf32 = None  # TF32 for (matmul, cuDNN) as Trainer.train found it

    def __enter__(self):
        from diverse_channel_vit_torch import trainer as tm
        from diverse_channel_vit_torch.evaluation import morphem_eval as me

        torch, probe = self.torch, self
        self.tm, self.saved = tm, {n: getattr(tm.Trainer, n) for n in (
            "train", "train_one_epoch", "_draw_k", "evaluate_model", "_train_one_batch_morphem",
            "eval_regular", "eval_subset_channels", "plot_attention")}
        self.saved_eval = tm.make_eval_step
        self.me, self.saved_me = me, {n: getattr(me, n) for n in (
            "extract_features", "run_benchmark")}
        saved, saved_me = self.saved, self.saved_me

        def train(trainer):
            probe.trainer = trainer
            probe.tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
            return saved["train"](trainer)

        def timed(trainer, epoch, start_batch=0):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = saved["train_one_epoch"](trainer, epoch, start_batch=start_batch)
            torch.cuda.synchronize()
            probe.epochs[epoch] = dict(out, wall_s=time.perf_counter() - t,
                                       peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            return out

        def train_one_epoch(trainer, epoch, start_batch=0):
            if epoch != probe.profile_epoch:
                return timed(trainer, epoch, start_batch)
            from torch.profiler import ProfilerActivity, profile

            # the epoch's wall time is taken inside the profiler's block, so
            # its start-up and teardown stay out of the busy share
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = timed(trainer, epoch, start_batch)
            probe.busy_us = sum(device_time(e, torch) for e in prof.key_averages())
            return out

        def draw_k(trainer, c):
            k = saved["_draw_k"](trainer, c)
            probe.draws.append(k)
            return k

        def evaluate_model(trainer, epoch):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            probe.split = {"forward": 0.0, "benchmark": 0.0}
            t = time.perf_counter()
            out = saved["evaluate_model"](trainer, epoch)
            torch.cuda.synchronize()
            probe.evals.append(dict(out, wall_s=time.perf_counter() - t, images=sum(
                n for _, n in trainer.eval_counts.values()),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9, split=dict(probe.split)))
            return out

        def extract_features(trainer, chunk, loader, new_channel_init=None):
            t = time.perf_counter()
            feats = saved_me["extract_features"](trainer, chunk, loader, new_channel_init)
            probe.split["forward"] += time.perf_counter() - t
            probe.feature_rows[chunk] = len(feats)
            probe.features[new_channel_init, chunk] = feats
            return feats

        def timed_part(name, key):
            def run(trainer, *args):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = saved[name](trainer, *args)
                torch.cuda.synchronize()
                probe.split[key] = probe.split.get(key, 0.0) + time.perf_counter() - t
                return out

            return run

        def run_benchmark(*args, **kwargs):
            t = time.perf_counter()
            out = saved_me["run_benchmark"](*args, **kwargs)
            probe.split["benchmark"] += time.perf_counter() - t
            return out

        def morphem_step(trainer, batch):
            out = saved["_train_one_batch_morphem"](trainer, batch)
            probe.steps.append({k: v for k, v in out.items() if k != "sampled_channels"})
            return out

        def plot_attention(trainer, epoch):
            probe.plots += 1
            return saved["plot_attention"](trainer, epoch)

        def make_eval_step(model):
            step = probe.saved_eval(model)

            def counted(x, cids, override=None, **chunk_kw):
                probe.eval_forwards += 1
                return step(x, cids, override, **chunk_kw)

            return counted

        tm.Trainer.train, tm.Trainer.train_one_epoch = train, train_one_epoch
        tm.Trainer._draw_k, tm.Trainer.evaluate_model = draw_k, evaluate_model
        tm.Trainer._train_one_batch_morphem = morphem_step
        tm.Trainer.plot_attention = plot_attention
        tm.Trainer.eval_regular = timed_part("eval_regular", "eval_regular")
        tm.Trainer.eval_subset_channels = timed_part("eval_subset_channels", "subset_sweep")
        tm.make_eval_step = make_eval_step
        me.extract_features, me.run_benchmark = extract_features, run_benchmark
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.tm.Trainer, name, fn)
        for name, fn in self.saved_me.items():
            setattr(self.me, name, fn)
        self.tm.make_eval_step = self.saved_eval
        return False


def run_trainer(fb, torch, label: str, config: str, overrides, want_step: dict,
                want_forward: dict, profile_epoch=None, want_plot=None):
    """``diverse_channel_vit_torch.main.main`` in this process on the card:
    counts set to 0 just before and read just after, each kernel launched
    ``want_step[name]`` times per train step plus ``want_forward[name]`` per
    eval forward (and ``want_plot[name]`` per attention plot); every train
    loss finite and every valid eval image
    counted. Prints the run's ``phase`` line; returns the probe and the
    counts."""
    from diverse_channel_vit_torch import main as port_main

    argv = ["-cn", config, *overrides]
    print(f"== {label}: python -m diverse_channel_vit_torch.main {' '.join(argv)}", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fb.reset_launches()
    with TrainerProbe(torch, profile_epoch) as probe:
        best = port_main.main(argv)
    launches = dict(fb.LAUNCHES)
    t = probe.trainer
    steps = len(probe.epochs) * t.updates_per_epoch
    if t.debug or not steps:
        raise AssertionError(f"{label}: no full epoch ran")
    for name, count in launches.items():
        want = (want_step.get(name, 0) * steps + want_forward.get(name, 0) * probe.eval_forwards
                + (want_plot or {}).get(name, 0) * probe.plots)
        if count != want:
            raise AssertionError(f"{label}: {name} launched {count} times in {steps} steps and "
                                 f"{probe.eval_forwards} eval forwards, want {want}")
    print(f"{label}: kernel launches {launches} in {steps} steps and {probe.eval_forwards} "
          f"eval forwards, as expected")
    for epoch, m in probe.epochs.items():
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"{label} epoch {epoch}: non-finite metrics {m}")
    splits = [s for s in t.mapper if s != "train"]
    n_eval = {s: t.eval_counts.get(s, (0, 0))[1] for s in splits}
    want_eval = {s: len(t._eval_loader_for(s).dataset) for s in splits}
    if not probe.evals or n_eval != want_eval:
        raise AssertionError(f"{label}: eval counted {n_eval} images, want {want_eval}")
    # the newest epoch the profiler did not slow
    shown = max(e for e in probe.epochs if e != profile_epoch or len(probe.epochs) == 1)
    last = probe.epochs[shown]
    ev = probe.evals[-1]
    print(f"{label}: best accuracy {best:.4f}; epochs {json.dumps(probe.epochs)}; evals "
          f"{json.dumps(probe.evals)}")
    print(f"phase {label}: {last['imgs_per_sec_per_chip']:.2f} images/s (Trainer steady, "
          f"epoch {shown}), epoch {last['wall_s']:.3f} s, eval "
          f"{ev['images'] / ev['wall_s']:.2f} images/s at eval batch size "
          f"{t.cfg.eval.batch_size}, eval peak memory {ev['peak_gb']:.3f} GB, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; card {card_line()}")
    return probe, launches, steps


def trainer_paths(fb, torch, bare_imgs_per_s: float) -> dict:
    """The training entry point on the card: the Trainer at full width (2
    epochs, eval every epoch, a checkpoint) and a resume from it; the DCS
    recipe and int8 through the Trainer; the JUMP-CP augmentation on the
    card against the CPU; the card's packages (pandas and pyarrow must
    import), one JUMP-CP epoch from a fixture through the Trainer with the
    augmentation on the card; two baselines on that fixture and CIFAR-10
    (:func:`baseline_trainers`); the novel-channel evals on that fixture;
    CHAMMI on every chunk and on Allen_HPA. Returns the paths by label."""
    import tempfile

    from diverse_channel_vit_torch.config import load_config
    from diverse_channel_vit_torch.trainer import Trainer

    fused4 = ("attend_project_fwd", "ln_mlp_fwd", "attend_project_bwd", "ln_mlp_bwd")
    int8_train = ("attend_project_fwd", "attend_project_bwd", "ln_mlp_q_fwd", "ln_mlp_q_bwd")
    per_fwd = dict.fromkeys(("attend_project_fwd", "ln_mlp_fwd"), DEPTH - 1)
    paths = {}
    with tempfile.TemporaryDirectory(prefix="dcvit_trainer_") as tmp:
        over = TRAINER_OVERRIDES + ["train.num_epochs=2", f"train.checkpoints={tmp}"]
        probe, launches, steps = run_trainer(
            fb, torch, "Trainer", "synthetic_cfg", over, dict.fromkeys(fused4, DEPTH - 1),
            per_fwd, profile_epoch=2)
        paths["Trainer"] = (launches, len(probe.epochs), "epoch")
        host_batch(probe.trainer)
        e2 = probe.epochs[2]
        busy = probe.busy_us / 1e6 / e2["wall_s"] if probe.busy_us else None
        print(f"phase Trainer epoch 2 (profiled): {e2['imgs_per_sec_per_chip']:.2f} images/s "
              f"beside the bare step's {bare_imgs_per_s:.2f} (train phase, batch on the card); "
              f"device busy {'not measured' if busy is None else f'{100 * busy:.1f}%'} of the "
              f"epoch's {e2['wall_s']:.3f} s; card {card_line()}")
        # resume from the checkpoint that run wrote: epoch 3, the saved state
        ckpt = probe.trainer.checkpoints
        path = f"{ckpt}/model_last"
        saved = torch.load(path, map_location="cpu", weights_only=True)
        t2 = Trainer(load_config("synthetic_cfg", over + [
            "train.resume_train=True", f"train.resume_model={path}"]))
        live = t2.model.state_dict()
        same = all(torch.equal(live[k].cpu(), v) for k, v in saved["model"].items())
        moments = t2.state.optimizer.state_dict()["state"]
        same_m = all(torch.equal(moments[i][key].cpu(), s[key]) for i, s in
                     saved["optimizer"]["state"].items() for key in ("exp_avg", "exp_avg_sq"))
        print(f"Trainer resume from {path}: start_epoch {t2.start_epoch}, step {t2.state.step}, "
              f"parameters equal {same}, optimizer moments equal {same_m}")
        if not (t2.start_epoch == 3 and t2.state.step == steps and same and same_m):
            raise AssertionError("Trainer resume: the resumed state differs from the saved one")
        del t2, probe, saved, live, moments
        one = TRAINER_OVERRIDES + ["train.num_epochs=1", "train.save_model=none",
                                   "eval.skip_eval_first_epoch=True", f"train.checkpoints={tmp}"]
        probe, launches, _ = run_trainer(
            fb, torch, "Trainer DCS recipe", "synthetic_cfg", one + [
                "model.enable_sample=True", f"model.hcs_sampling={HCS_METHOD}",
                f"model.hcs_sampling_temp={HCS_TEMP:g}"],
            dict.fromkeys(fused4, DEPTH - 1), per_fwd)
        rng = np.random.default_rng(TRAIN_SEED)
        want = [int(rng.integers(1, CHANNELS + 1)) for _ in probe.draws]
        print(f"Trainer DCS recipe: k drawn {probe.draws}, numpy default_rng({TRAIN_SEED}) "
              f"gives {want}")
        if probe.draws != want or not probe.draws:
            raise AssertionError("Trainer DCS recipe: the k sequence differs from _draw_k's")
        paths["Trainer DCS recipe"] = (launches, 1, "epoch")
        probe, launches, _ = run_trainer(
            fb, torch, "Trainer int8", "synthetic_cfg", one + ["model.quantization=int8"],
            dict.fromkeys(int8_train, DEPTH - 1),
            dict.fromkeys(("attend_project_fwd", "ln_mlp_q_fwd"), DEPTH - 1))
        paths["Trainer int8"] = (launches, 1, "epoch")
        del probe
        augment_on_card(torch)
        have = {}
        for mod in ("yaml", "pandas", "pyarrow", "h5py"):
            try:
                __import__(mod)
                have[mod] = True
            except ImportError:
                have[mod] = False
        listed = ", ".join(f"{m} {'imports' if ok else 'missing'}" for m, ok in have.items())
        print(f"card packages: {listed}")
        if not (have["pandas"] and have["pyarrow"]):
            raise AssertionError("the JUMP-CP, novel-channel and CHAMMI phases need pandas and "
                                 "pyarrow (the JUMP-CP index, CHAMMI's metadata and benchmark)")
        root = write_jumpcp_fixture(tmp)
        probe, launches, _ = run_trainer(
            fb, torch, "Trainer JUMP-CP fixture", "jump_cp_cfg", [
                f"++dataset.root_dir={root}", "train.batch_size=64", "train.num_epochs=1",
                "train.save_model=none", "eval.skip_eval_first_epoch=True",
                "train.device_augment=True", f"train.checkpoints={tmp}"],
            dict.fromkeys(fused4, DEPTH - 1), per_fwd)
        if not probe.trainer.train_loader.dataset.device_augment:
            raise AssertionError("Trainer JUMP-CP fixture: the augmentation ran on the host")
        del probe
        paths.update(baseline_trainers(fb, torch, root, tmp))
        paths["Trainer novel channels"] = novel_trainer(fb, torch, root, tmp)
        t0 = time.perf_counter()
        chammi_root = write_chammi_fixture(tmp)
        print(f"== CHAMMI fixture written in {time.perf_counter() - t0:.1f} s", flush=True)
        paths["Trainer CHAMMI"] = chammi_trainer(fb, torch, tmp, chammi_root)
        paths["Trainer CHAMMI subset"] = chammi_subset(fb, torch, tmp, chammi_root)
    torch.cuda.empty_cache()
    return paths


def trainer_runtime(fb, torch, bare: dict) -> dict:
    """The Trainer's runtime on the card at full width (DiChaViT-S, depth
    12, B = 64): for DropPath (rate 0.1), MIRO and ``unfreeze_last_n_layers
    = 2``, the train step through the kernels against the plain route from
    the same weights with the same DropPath masks (``RUNTIME_PARITY_STEPS``
    steps), then 12 timed steps beside the plain step's time (``bare``);
    ``main`` on ``synthetic_cfg`` with DropPath, MIRO, the last two blocks
    trainable, SWAD, ``plot_attn``, ``profile_dir`` and an RSS cap together;
    a run preempted by SIGTERM in the middle of its second epoch and resumed
    against the uninterrupted run. Returns the paths by label."""
    import tempfile

    fused4 = ("attend_project_fwd", "ln_mlp_fwd", "attend_project_bwd", "ln_mlp_bwd")
    plain_step = dict.fromkeys(fused4, DEPTH - 1)
    # MIRO: the live forward and the pre-featurizer's each run all 12 blocks
    # (no CLS-only readout), the backward the live forward's 12
    miro_step = {"attend_project_fwd": 2 * DEPTH, "ln_mlp_fwd": 2 * DEPTH,
                 "attend_project_bwd": DEPTH, "ln_mlp_bwd": DEPTH}
    cases = [("DropPath", plain_step, None, dict(drop_path_rate=DROP_PATH_RATE)),
             ("MIRO", miro_step, {"miro": True}, {}),
             (f"unfreeze_last_n_layers={UNFREEZE_LAST}", plain_step,
              {"unfreeze_last_n_layers": UNFREEZE_LAST}, {})]
    paths = {}
    for key, want, runtime, extra in cases:
        train_parity(fb, torch, f"runtime {key} train parity", DEPTH, RUNTIME_PARITY_STEPS, want,
                     runtime=runtime, **extra)
        launches, steps, timing = train(fb, torch, f"runtime {key} train", want,
                                        runtime=runtime, **extra)
        paths[f"runtime {key} train"] = (launches, steps, "step")
        per = {k: v / steps for k, v in launches.items() if v}
        print(f"phase Trainer runtime {key}: {timing['imgs_per_s']:.2f} images/s, p50 "
              f"{timing['p50_ms']:.3f} ms, beside the plain step's {bare['imgs_per_s']:.2f} "
              f"images/s, p50 {bare['p50_ms']:.3f} ms (train phase); launches per step "
              f"{json.dumps(per)}; card {card_line()}")
    with tempfile.TemporaryDirectory(prefix="dcvit_runtime_") as tmp:
        over = TRAINER_OVERRIDES + [
            "train.num_epochs=2", "train.save_model=none", f"train.checkpoints={tmp}",
            f"++model.drop_path_rate={DROP_PATH_RATE}", "++train.miro=True",
            f"++model.unfreeze_last_n_layers={UNFREEZE_LAST}", "++train.swad=True",
            "++train.swa_start=1", "++train.plot_attn=True", f"++train.profile_dir={tmp}/trace",
            "++train.max_host_rss_gb=1000"]
        fwd = dict.fromkeys(("attend_project_fwd", "ln_mlp_fwd"), DEPTH - 1)
        probe, launches, _ = run_trainer(
            fb, torch, "Trainer runtime", "synthetic_cfg", over, miro_step, fwd,
            want_plot=dict.fromkeys(("attend_project_fwd", "ln_mlp_fwd"), DEPTH))
        t = probe.trainer
        traces = sorted(os.listdir(f"{tmp}/trace"))
        npys = sorted(os.listdir(f"{t.checkpoints}/attn"))
        swa_same = all(torch.equal(p.detach(), a) for p, a in zip(t.state.params, t.swa_params))
        print(f"Trainer runtime: {len(t.state.frozen)} parameter tensors frozen, SWAD averaged "
              f"{t.swa_n} updates and the model took the average: {swa_same}; plots "
              f"{probe.plots} ({npys}); profiler trace {traces} "
              f"({sum(os.path.getsize(f'{tmp}/trace/{n}') for n in traces) / 1e6:.1f} MB)")
        if not (swa_same and t.swa_n == t.updates_per_epoch and len(traces) == 1
                and all(f"cls_attn_epoch{e}.npy" in npys for e in range(3))):
            raise AssertionError("Trainer runtime: SWAD, the trace or the attention maps are "
                                 "missing")
        paths["Trainer runtime"] = (launches, len(probe.epochs), "epoch")
        del probe, t
        preempt_on_card(torch, tmp)
    torch.cuda.empty_cache()
    return paths


def preempt_on_card(torch, tmp: str) -> None:
    """A run (DCS, DropPath, SWAD from epoch 2, MIRO; 4 steps an epoch, 2
    epochs) that a SIGTERM stops after its 5th step, in the middle of epoch
    2, and that the next Trainer of the same (dataset, seed) resumes, held
    against the uninterrupted run: every parameter bit for bit."""
    import signal

    from diverse_channel_vit_torch.config import load_config
    from diverse_channel_vit_torch.trainer import Trainer

    over = TRAINER_OVERRIDES + [
        "train.num_epochs=2", "dataset.num_train_samples=256", "train.save_model=none",
        "++eval.skip_eval_first_epoch=True", "++eval.only_eval_first_and_last=True",
        "model.enable_sample=True", f"model.hcs_sampling={HCS_METHOD}",
        f"model.hcs_sampling_temp={HCS_TEMP:g}", f"++model.drop_path_rate={DROP_PATH_RATE}",
        "++train.swad=True", "++train.swa_start=1", "++train.miro=True"]

    def trainer(name):
        return Trainer(load_config("synthetic_cfg", over + [f"train.checkpoints={tmp}/{name}"]))

    t0 = time.perf_counter()
    ta = trainer("a")
    ta.train()
    tb = trainer("b")
    run, calls = Trainer._train_one_batch_regular, [0]

    def batch_then_sigterm(self, batch):
        out = run(self, batch)
        calls[0] += 1
        if calls[0] == 5:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    Trainer._train_one_batch_regular = batch_then_sigterm
    try:
        tb.train()
    finally:
        Trainer._train_one_batch_regular = run
    tb2 = trainer("b")
    where = (tb.state.step, tb2.start_epoch, tb2._resume_start_batch)
    tb2.train()
    upe = ta.updates_per_epoch
    sa, sb = ta.model.state_dict(), tb2.model.state_dict()
    differ = {k: float((sa[k].float() - sb[k].float()).abs().max()) for k in sa
              if not torch.equal(sa[k], sb[k])}
    print(f"Trainer preemption: SIGTERM after step {where[0]}, resumed at epoch {where[1]} "
          f"batch {where[2]}, finished at step {tb2.state.step} (uninterrupted "
          f"{ta.state.step}); {len(sa) - len(differ)} of {len(sa)} tensors equal bit for bit"
          f"{'' if not differ else f', max abs diff {max(differ.values()):.3e} in ' + str(sorted(differ, key=differ.get)[-3:])}"
          f"; {time.perf_counter() - t0:.1f} s for the three runs")
    if where != (5, 5 // upe + 1, 5 % upe) or tb2.state.step != ta.state.step or differ:
        raise AssertionError("Trainer preemption: the resumed run differs from the "
                             "uninterrupted one")


def profiled_launches(fn, torch) -> dict:
    """The port's kernels (``dcvit::``) by launch count over one call of
    ``fn``, from the profiler (the device's own record of the launches)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[0][:60]: e.count for e in prof.key_averages()
            if "dcvit::" in e.key}


def knob_train(fb, torch, label: str, want: dict, knobs=None, warm=1, timed=5, **extra):
    """A knob's timed steps at full width (:func:`train`), the port's
    kernels by launch over one more step from the profiler. Returns the path
    and the timing."""
    launches, steps, timing = train(fb, torch, label, want, knobs=knobs, warm=warm,
                                    timed=timed, table=False, **extra)
    return (launches, steps, "step"), timing


def knob_line(phase: str, key: str, timing: dict, parity: dict, bare: dict) -> None:
    print(f"phase {phase} {key}: {timing['imgs_per_s']:.2f} images/s, p50 "
          f"{timing['p50_ms']:.3f} ms (the plain step {bare['imgs_per_s']:.2f} images/s, p50 "
          f"{bare['p50_ms']:.3f} ms); launches in one profiled step "
          f"{json.dumps(timing['profiled'])}; worst parity {json.dumps(parity)}; "
          f"card {card_line()}", flush=True)


def check_grids(label: str, seen, want: set) -> None:
    got = {tuple(g) for g in seen}
    print(f"{label}: attention grids (kind, N, n_valid) {sorted(got)}")
    if got != want:
        raise AssertionError(f"{label}: attention grids {sorted(got)}, want {sorted(want)}")


def ppt_forward_parity(fb, torch, pruning: str, extra: dict) -> dict:
    """PPT's eval forward at full width and depth, kernel route against
    plain route from the same weights, the plain route's kept tokens or
    channels forced on the kernel route: logits within LOGITS_REL_TOL, 12
    B5 launches and nothing else, at ``PPT_GRIDS[pruning]``."""
    x = synthetic_batch(torch)["image"]
    cids = torch.arange(CHANNELS, device="cuda")
    runs = {}
    for route in ("plain", "kernels"):
        model = build(DEPTH, **extra).eval()
        blocks = list(model.feature_extractor.blocks)
        if route == "kernels":
            for blk, idx in zip(blocks, runs["plain"][1]):
                blk.forced = idx
        before = dict(fb.LAUNCHES)
        ctx = fb.plain_versions() if route == "plain" else attention_grids(fb)
        with ctx as seen, torch.no_grad():
            out = model(x, cids)[0].float().cpu()
        torch.cuda.synchronize()
        counts = {k: fb.LAUNCHES[k] - before[k] for k in before}
        runs[route] = (out, [blk.kept for blk in blocks], counts, seen)
        del model
        torch.cuda.empty_cache()
    (ok, kk, ck, seen), (op, kp, cp, _) = runs["kernels"], runs["plain"]
    label = f"ppt {pruning} forward"
    if any(cp.values()):
        raise AssertionError(f"{label}: the plain route launched kernels: {cp}")
    check_counts(f"{label}, kernel route", ck, 1, "forward", {"flash_packed_fwd": DEPTH})
    grids = tuple(nv for kind, n, nv in seen)
    print(f"{label}: n_valid per block {grids}; picks the kernel route would have made "
          f"otherwise {pick_differences(kk, kp)}")
    if grids != PPT_GRIDS[pruning] or any(kind != "flash" for kind, _, _ in seen):
        raise AssertionError(f"{label}: grids {seen}, want {PPT_GRIDS[pruning]}")
    return {"logits_rel": logits_close(label, ok, op)}


def optimizer_updates(torch) -> dict:
    """Each optimizer of OPTIMIZERS on the card against the same optimizer
    on a CPU copy: 3 updates of f32 tensors of a block's shapes on fixed f32
    gradients, clipped at global norm 1; every parameter (and the bf16 first
    moment) within OPT_REL_TOL of its tensor's largest entry. The last
    tensor's gradients are orthogonal to its rows, so AdamP projects it."""
    from diverse_channel_vit_torch.training import make_optimizer

    rng = np.random.default_rng(20)
    shapes = [(3 * D, D), (3 * D,), (HID, D), (D, D)]
    params = [rng.standard_normal(sh).astype(np.float32) for sh in shapes]
    p_last = params[-1].astype(np.float64)
    grads = []
    for _ in range(3):
        g = [0.02 * rng.standard_normal(sh) for sh in shapes]
        g[-1] = g[-1] - p_last * ((p_last * g[-1]).sum(1, keepdims=True)
                                  / (p_last * p_last).sum(1, keepdims=True))
        grads.append([a.astype(np.float32) for a in g])
    out = {}
    for label, (name, hp) in OPTIMIZERS.items():
        sides = {}
        for dev in ("cpu", "cuda"):
            tx = make_optimizer(name, dict(hp), lr_schedule=lambda s, lr=hp["lr"]: float(lr),
                                total_steps=3, clip_grad_norm=1.0)
            ps = [torch.nn.Parameter(torch.from_numpy(a.copy()).to(dev)) for a in params]
            o = tx.init(ps)
            for t, g in enumerate(grads):
                for p, a in zip(ps, g):
                    p.grad = torch.from_numpy(a.copy()).to(dev)
                tx.update(o, t)
            moments = [o.state[p].get("exp_avg") for p in ps]
            sides[dev] = [p.detach().cpu() for p in ps], [
                None if m is None else m.cpu() for m in moments]
        worst = 0.0
        card = sides["cuda"]
        for (a, b) in zip(card[0] + [m for m in card[1] if m is not None],
                          sides["cpu"][0] + [m for m in sides["cpu"][1] if m is not None]):
            if a.dtype != b.dtype:
                raise AssertionError(f"optimizer {label}: the card keeps {a.dtype}, the CPU "
                                     f"{b.dtype}")
            worst = max(worst, float((a.float() - b.float()).abs().max() / b.float().abs().max()))
        moved = float((card[0][0] - torch.from_numpy(params[0])).abs().max())
        print(f"optimizer {label}: 3 updates on the card against the CPU, worst rel "
              f"{worst:.3e} (tolerance {OPT_REL_TOL}); largest move {moved:.3e}; first moment "
              f"{card[1][0].dtype if card[1][0] is not None else 'none'}")
        if not (worst <= OPT_REL_TOL and moved > 0):
            raise AssertionError(f"optimizer {label}: the card's update disagrees with the CPU's")
        out[label] = worst
    return out


def sigterm_after_a_raise(torch, tmp: str) -> None:
    """ROADMAP C7 on the card: a ``Trainer.train`` that raises
    (``train.save_model=best``, refused after the first epoch) leaves
    SIGTERM's handler as it found it."""
    import signal

    from diverse_channel_vit_torch.config import load_config
    from diverse_channel_vit_torch.trainer import Trainer

    before = signal.getsignal(signal.SIGTERM)
    t = Trainer(load_config("synthetic_cfg", TRAINER_OVERRIDES + [
        "train.num_epochs=1", "dataset.num_train_samples=64", "train.save_model=best",
        "++eval.skip_eval_first_epoch=True", f"train.checkpoints={tmp}/c7"]))
    try:
        t.train()
    except NotImplementedError as e:
        raised = str(e)
    else:
        raise AssertionError("C7 check: train.save_model=best did not raise")
    after = signal.getsignal(signal.SIGTERM)
    print(f"C7 check: Trainer.train raised ({raised}); SIGTERM's handler before {before!r}, "
          f"after {after!r}")
    if after is not before:
        raise AssertionError("C7 check: a raising Trainer.train left its SIGTERM handler")


def training_knobs(fb, torch, bare: dict) -> dict:
    """The last training knobs of DiChaViT at full width and depth
    (DiChaViT-S, B = 64): the samplers, the optimizers, PPT and HCS
    dropout, each held against the plain route and timed beside the plain
    step (``bare``); ``main`` with a sampler, an optimizer and PPT together;
    the C7 check. Returns the paths by label."""
    import tempfile

    fused4 = ("attend_project_fwd", "ln_mlp_fwd", "attend_project_bwd", "ln_mlp_bwd")
    plain_step = dict.fromkeys(fused4, DEPTH - 1)
    ppt_step = {"flash_packed_fwd": DEPTH, "flash_packed_bwd": DEPTH}
    dropped = {("attend_project", *HCS_DROP_GRID)}
    paths = {}
    # samplers: k = KNOB_K of 8 channels (785 tokens in 832)
    for method in SAMPLERS:
        knobs = {"sampler": method}
        label = f"samplers {method}"
        parity = train_parity(fb, torch, f"{label} train parity", DEPTH, RUNTIME_PARITY_STEPS,
                              plain_step, knobs=knobs)
        check_grids(label, LAST_GRIDS[f"{label} train parity"], dropped)
        paths[f"{label} train"], timing = knob_train(fb, torch, f"{label} train", plain_step,
                                                     knobs=knobs)
        knob_line("samplers", method, timing, parity, bare)
    # optimizers: the card's update against the CPU's, then 3 timed steps
    updates = optimizer_updates(torch)
    for label, opt in OPTIMIZERS.items():
        paths[f"optimizers {label} train"], timing = knob_train(
            fb, torch, f"optimizers {label} train", plain_step, knobs={"optimizer": opt},
            timed=3)
        knob_line("optimizers", label, timing, {"update_rel": updates[label]}, bare)
    # PPT: every block a BlockV2 on the unpadded grid, B5 / B6 alone
    for pruning in ("token_pruning", "channel_pruning"):
        extra = dict(block_type="block_v2", dropout_tokens_hcs=pruning,
                     token_keep_channels=KNOB_KC)
        parity = ppt_forward_parity(fb, torch, pruning, extra)
        parity.update(train_parity(fb, torch, f"ppt {pruning} train parity", DEPTH, 1,
                                   ppt_step, **extra))
        grids = tuple(nv for kind, n, nv in LAST_GRIDS[f"ppt {pruning} train parity"])
        if grids != PPT_GRIDS[pruning]:
            raise AssertionError(f"ppt {pruning} train: grids {grids}")
        paths[f"ppt {pruning} train"], timing = knob_train(fb, torch, f"ppt {pruning} train",
                                                           ppt_step, **extra)
        knob_line("ppt", pruning, timing, parity, bare)
    # HCS token and channel dropout: B1-B4 on the dropped grid
    for mode in ("random", "channel"):
        extra = dict(dropout_tokens_hcs=mode, token_keep_channels=KNOB_KC)
        label = f"hcs_dropout {mode}"
        parity = train_parity(fb, torch, f"{label} train parity", DEPTH, 1, plain_step, **extra)
        check_grids(label, LAST_GRIDS[f"{label} train parity"], dropped)
        paths[f"{label} train"], timing = knob_train(fb, torch, f"{label} train", plain_step,
                                                     **extra)
        knob_line("hcs_dropout", mode, timing, parity, bare)
    with tempfile.TemporaryDirectory(prefix="dcvit_knobs_") as tmp:
        over = TRAINER_OVERRIDES + [
            "train.num_epochs=1", "dataset.num_train_samples=256", "train.save_model=none",
            f"train.checkpoints={tmp}", "++model.enable_sample=True",
            "++model.hcs_sampling=lowest_cosine_prob_resnet34", "optimizer=adam",
            "++model.block_type=block_v2", "++model.dropout_tokens_hcs=token_pruning"]
        probe, launches, steps = run_trainer(fb, torch, "Trainer training knobs",
                                             "synthetic_cfg", over, ppt_step,
                                             {"flash_packed_fwd": DEPTH})
        paths["Trainer training knobs"] = (launches, len(probe.epochs), "epoch")
        del probe
        sigterm_after_a_raise(torch, tmp)
    torch.cuda.empty_cache()
    return paths


def check_baseline_grids(fb, torch) -> dict:
    """B1-B4 against their plain versions at the grids the baselines and the
    smaller geometries give them (BASELINE_GRID and SMALL_GRIDS) at B = 64,
    D = 384, 6 heads of 64, hidden 1536, bf16: B1 with its residual, B2 from
    B1's o and lse (padded key rows' dk and dv exactly 0), B3 with its
    residual, B4 without. Returns each kernel's (N, n_valid, max_abs_err,
    rel_err) per grid."""
    rnd = _rnd(torch, torch.Generator(device="cuda").manual_seed(21))
    dh = D // HEADS
    s, bb = rnd(D, scale=0.1, dtype=torch.float32) + 1.0, rnd(D, scale=0.1, dtype=torch.float32)
    w1, b1 = rnd(HID, D, scale=D ** -0.5), rnd(HID)
    w2, b2 = rnd(D, HID, scale=HID ** -0.5), rnd(D)
    wp, bp = rnd(D, D, scale=D ** -0.5), rnd(D)
    out = {k: [] for k in ("attend_project_fwd", "attend_project_bwd", "ln_mlp_fwd",
                           "ln_mlp_bwd")}
    for n, nv in (BASELINE_GRID,) + SMALL_GRIDS:
        label = f"{B} x ({n}, {nv})"
        qkv, x, do = rnd(B, n, 3 * D), rnd(B, n, D), rnd(B, n, D)
        a = (qkv, x, wp, bp, HEADS, dh ** -0.5, nv)
        (o, lse, xo), ref = (fb.attend_project_fwd(*a, need_o=True),
                             fb.attend_project_fwd_plain(*a, need_o=True))
        errs = {"attend_project_fwd": hold("attend_project_fwd", label, (
            ("xo", xo, ref[2]), ("o", o, ref[0]), ("lse", lse, ref[1])))}
        a = (qkv, o, lse, wp, do, HEADS, dh ** -0.5, nv)
        got = fb.attend_project_bwd(*a)
        errs["attend_project_bwd"] = hold("attend_project_bwd", label, list(zip(
            ("dqkv", "dwp", "dbp", "db_qkv"), got, fb.attend_project_bwd_plain(*a))))
        if torch.count_nonzero(got[0][:, nv:, D:]).item() != 0:
            raise AssertionError(f"attend_project_bwd ({label}): padded key rows have dk or "
                                 "dv != 0")
        a = (x, s, bb, w1, b1, w2, b2, True)
        errs["ln_mlp_fwd"] = hold("ln_mlp_fwd", label, (("out", fb.ln_mlp(*a),
                                                         fb.ln_mlp_plain(*a)),))
        a = (x, s, bb, w1, b1, w2, do, False)
        errs["ln_mlp_bwd"] = hold("ln_mlp_bwd", label, list(zip(
            ("dx", "dw1", "db1", "dw2", "db2", "ds", "db"), fb.ln_mlp_bwd(*a),
            fb.ln_mlp_bwd_plain(*a))))
        for name, (err, rel) in errs.items():
            out[name].append(dict(n=n, n_valid=nv, max_abs_err=err, rel_err=rel))
    torch.cuda.empty_cache()
    return out


def small_geometry_forward(fb, torch) -> None:
    """``vit_adapt`` at So2Sat's geometry (32^2, patch 8, at full width and
    depth): a 64-image eval forward through the kernels against the plain
    versions, B1 / B3 x 11 at (64, 17), logits within LOGITS_REL_TOL."""
    extra = dict(BASELINES["vit_adapt"], img_size=[32], patch_size=8)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, CHANNELS, 32, 32), dtype=np.float32)).cuda().to(torch.bfloat16)
    cids = torch.arange(CHANNELS, device="cuda")
    model = build(DEPTH, **extra)
    label = "baselines vit_adapt 32^2 patch 8 forward"
    before = dict(fb.LAUNCHES)
    with attention_grids(fb) as seen, torch.inference_mode():
        got = model(x, cids)[0].float().cpu()
    counts = {k: fb.LAUNCHES[k] - before[k] for k in before}
    check_counts(label, counts, 1, "forward", dict.fromkeys(("attend_project_fwd",
                                                            "ln_mlp_fwd"), DEPTH - 1))
    check_grids(label, seen, {("attend_project", *SMALL_GRIDS[0])})
    before = dict(fb.LAUNCHES)
    with fb.plain_versions(), torch.inference_mode():
        want = model(x, cids)[0].float().cpu()
    if dict(fb.LAUNCHES) != before:
        raise AssertionError(f"{label}: the plain run launched a kernel")
    logits_close(label, got, want)
    del model


def baselines(fb, torch, bare: dict) -> dict:
    """The paper's four baseline ViTs at full width and depth (BASELINES,
    DepthwiseViT with both poolings; B = 64, JUMP-CP geometry): for each,
    serving as phase 5 (logits against the plain route), 2 train steps
    through the kernels against 2 through the plain versions from the same
    weights (B1-B4 x 11 a step, every call at BASELINE_GRID), then 2 + 10
    timed steps and a profiled one, beside the plain DiChaViT step
    (``bare``); ``vit_adapt`` at
    So2Sat's 32^2 with patch 8; ``fused_block: false`` on DiChaViT (B5 / B6
    alone) and ``vit_adapt`` with ``quantization: int8`` (B7 / B8), each at
    PARITY_DEPTH against the plain route. Returns the paths by label."""
    fused4 = ("attend_project_fwd", "ln_mlp_fwd", "attend_project_bwd", "ln_mlp_bwd")
    int8_train = ("attend_project_fwd", "attend_project_bwd", "ln_mlp_q_fwd", "ln_mlp_q_bwd")
    per_step = dict.fromkeys(fused4, DEPTH - 1)
    paths = {}
    for label, extra in BASELINES.items():
        t0 = time.perf_counter()
        label = f"baselines {label}"
        paths[f"{label} serving"] = (*serve(fb, torch, f"{label} serving", **extra), "forward")
        parity = train_parity(fb, torch, f"{label} train parity", DEPTH, RUNTIME_PARITY_STEPS,
                              per_step, **extra)
        check_grids(label, LAST_GRIDS[f"{label} train parity"],
                    {("attend_project", *BASELINE_GRID)})
        launches, steps, timing = train(fb, torch, f"{label} train", per_step, **extra)
        paths[f"{label} train"] = (launches, steps, "step")
        print(f"{label}: train {timing['imgs_per_s']:.2f} images/s, p50 {timing['p50_ms']:.3f} "
              f"ms (the plain DiChaViT-S step {bare['imgs_per_s']:.2f} images/s, p50 "
              f"{bare['p50_ms']:.3f} ms); worst parity {json.dumps(parity)}; phase "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    small_geometry_forward(fb, torch)
    # model.fused_block: false, the unfused route in every block but the
    # readout: B5 / B6 and none of B1-B4
    label = "fused_block false train parity"
    unfused = {"flash_packed_fwd": PARITY_DEPTH - 1, "flash_packed_bwd": PARITY_DEPTH - 1}
    train_parity(fb, torch, label, PARITY_DEPTH, 1, unfused, fused_block=False)
    check_grids(label, LAST_GRIDS[label], {("flash", -(-N_VALID // 64) * 64, N_VALID)})
    train_parity(fb, torch, "baselines vit_adapt int8 train parity", PARITY_DEPTH,
                 RUNTIME_PARITY_STEPS, dict.fromkeys(int8_train, PARITY_DEPTH - 1),
                 quantization="int8", **BASELINES["vit_adapt"])
    torch.cuda.empty_cache()
    return paths


def baseline_trainers(fb, torch, root: str, tmp: str) -> dict:
    """``main`` with ``jump_cp_cfg`` and ``model=vit_adapt``, then
    ``model=hypervit_adapt``, one epoch each on the JUMP-CP fixture at
    ``root`` (B1-B4 x 11 a step and B1 / B3 x 11 an eval forward, every call
    at BASELINE_GRID); then ``cifar10_cfg`` (ChannelViT-S on 3 channels at
    32^2, patch 8) for one epoch on a CIFAR pickle tree written here
    (``scripts/make_cifar_fixture``: 320 train and 128 test images), every
    call at (64, 49). Returns the paths by label."""
    import os

    from diverse_channel_vit_torch.scripts.make_cifar_fixture import main as make_cifar

    fused4 = ("attend_project_fwd", "ln_mlp_fwd", "attend_project_bwd", "ln_mlp_bwd")
    per_step = dict.fromkeys(fused4, DEPTH - 1)
    per_fwd = dict.fromkeys(("attend_project_fwd", "ln_mlp_fwd"), DEPTH - 1)
    one = ["train.batch_size=64", "train.num_epochs=1", "train.save_model=none",
           "eval.skip_eval_first_epoch=True", f"train.checkpoints={tmp}"]
    runs = [(f"Trainer baselines {m}", "jump_cp_cfg", [
        f"model={m}", f"++dataset.root_dir={root}", "train.device_augment=True", *one],
        BASELINE_GRID) for m in ("vit_adapt", "hypervit_adapt")]
    cifar = make_cifar(os.path.join(tmp, "cifar"), n_per_batch=64, n_test=128)
    runs.append(("Trainer CIFAR-10", "cifar10_cfg", [
        f"++dataset.root_dir={cifar}", "eval.every_n_epochs=1", *one], SMALL_GRIDS[1]))
    paths = {}
    for label, config, over, grid in runs:
        with attention_grids(fb) as seen:
            probe, launches, _ = run_trainer(fb, torch, label, config, over, per_step, per_fwd)
        check_grids(label, seen, {("attend_project", *grid)})
        paths[label] = (launches, 1, "epoch")
        del probe
    return paths


def host_batch(trainer) -> None:
    """What the Trainer's host side costs a train batch, outside the epoch:
    the loader's next batch (3 threads make the synthetic images), then
    ``_to_device`` (the cast to bf16 and the pageable copy to the card)."""
    import torch

    loader = trainer.train_loader
    it = iter(loader)
    ms = []
    for _ in range(2):
        t = time.perf_counter()
        batch = next(it)
        t1 = time.perf_counter()
        trainer._to_device(batch)
        torch.cuda.synchronize()
        ms.append(((t1 - t) * 1e3, (time.perf_counter() - t1) * 1e3))
    print(f"Trainer host side per {len(batch['label'])}-image batch: loader "
          f"{' / '.join(f'{a:.1f}' for a, _ in ms)} ms, cast and copy to the card "
          f"{' / '.join(f'{b:.1f}' for _, b in ms)} ms (two batches)")


def augment_on_card(torch) -> None:
    """The JUMP-CP train augmentation (``ops/augment.py``) on a B = 64, 8 x
    224² raw batch on the card against the same call on the CPU, the same
    draws (made on the CPU from seed 0): max abs difference within 1e-5 of
    max|x| (f32; TF32 off). Prints its ms per batch."""
    from diverse_channel_vit_torch.data.normalization import get_mean_std_dataset
    from diverse_channel_vit_torch.ops import augment

    mean, std = get_mean_std_dataset("jump_cp")
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 60, (B, CHANNELS, IMG, IMG)).astype(np.float32))
    draws = augment.make_draws(torch.Generator().manual_seed(0), B, IMG, IMG)
    want = augment.jumpcp_train_augment(None, x, mean, std, draws=draws)
    xc = x.cuda()
    dc = {k: v.cuda() for k, v in draws.items()}
    got = augment.jumpcp_train_augment(None, xc, mean, std, draws=dc)
    err = (got.cpu() - want).abs().max().item()
    scale = want.abs().max().item()
    ms = cuda_ms(lambda: augment.jumpcp_train_augment(None, xc, mean, std, draws=dc), 10)
    print(f"phase JUMP-CP augmentation on the card: {ms:.3f} ms per {B}-image batch "
          f"(8 x {IMG}^2, f32); max_abs_err against the CPU {err:.3e}, max|out| {scale:.3e} "
          f"(tolerance 1e-5 x max|x| = {1e-5 * x.abs().max().item():.3e}); card {card_line()}")
    if not err <= 1e-5 * x.abs().max().item():
        raise AssertionError("JUMP-CP augmentation: the card disagrees with the CPU")


def write_jumpcp_fixture(tmp: str, n: int = 256) -> str:
    """A JUMP-CP tree in the layout of tests/test_regular_e2e.py: ``n``
    cells of 8 x 224² crops of 3 classes (3 labelled wells), the cyto-mask
    parquet index and the plate maps. Returns the root (with its slash)."""
    import os

    import pandas as pd

    root = os.path.join(tmp, "jumpcp_fixture")
    pm = os.path.join(root, "jumpcp", "platemap_and_metadata")
    os.makedirs(pm)
    os.makedirs(os.path.join(root, "imgs"))
    rng = np.random.default_rng(0)
    wells = [f"A{j:02d}" for j in range(1, 9)]
    protos = rng.uniform(1, 30, size=(3, CHANNELS, 1, 1))
    paths, locs = [], []
    for i in range(n):
        img = protos[i % 3] + rng.normal(0, 3.0, (CHANNELS, IMG, IMG))
        np.save(os.path.join(root, f"imgs/c{i}.npy"), img.astype(np.float32))
        paths.append(f"s3://insitro-research-2023-context-vit/imgs/c{i}.npy")
        locs.append(wells[i % 3])
    pd.DataFrame({"path": paths, "ID": range(n), "well_loc": locs}).to_parquet(
        os.path.join(root, "jumpcp", "BR00116991.pq"))
    for pert, col in [("compound", "target"), ("crispr", "gene"), ("orf", "gene")]:
        pd.DataFrame({"broad_sample": [f"s{k}" for k in range(3)],
                      "well_position": wells[:3]}).to_parquet(
            os.path.join(pm, f"JUMP-Target-1_{pert}_platemap.tsv"))
        pd.DataFrame({"broad_sample": [f"s{k}" for k in range(3)],
                      col: [f"t{k}" for k in range(3)]}).to_parquet(
            os.path.join(pm, f"JUMP-Target-1_{pert}_metadata.tsv"))
    return root + "/"


# CHAMMI (morphem70k): each chunk's tape size (h, w) and channels, as in the
# real dataset (Allen / WTC-11 238 x 374, HPA 512 x 512, CP 160 x 160), its
# classes, its MorphEm tasks and its leave-one-out column
CHAMMI_CHUNKS = {"Allen": (238, 374, 3), "HPA": (512, 512, 4), "CP": (160, 160, 5)}
CHAMMI_CLASSES = {
    "Allen": ["M0", "M1M2", "M3", "M4M5", "M6M7_complete", "M6M7_single"],
    "HPA": ["golgi apparatus", "microtubules", "mitochondria", "nuclear speckles"],
    "CP": ["BRD-A29260609", "BRD-K04185004", "BRD-K21680192", "DMSO"],
}
CHAMMI_TASKS = {"Allen": ["Task_one", "Task_two"], "HPA": ["Task_one", "Task_two", "Task_three"],
                "CP": ["Task_one", "Task_two", "Task_three", "Task_four"]}
CHAMMI_LEAVEOUT = {"HPA": "cell_type", "CP": "Plate"}
CHAMMI_TRAIN, CHAMMI_TEST = 128, 64  # rows a chunk
# train_scripts.sh:8 (DiChaViT on CHAMMI), the hydra -m flag and the tag aside
CHAMMI_RECIPE = [
    "model=dichavit", "++model.enable_sample=True", "++model.pretrained_model_name=small",
    "dataset=morphem70k_v2_12channels", "++optimizer.params.lr=0.00004",
    "++model.temperature=0.07", "++train.num_epochs=60", "++train.save_model=last",
    "++model.new_channel_inits=[zero]", "++train.batch_size=64", "++eval.batch_size=256",
    "++train.debug=False", "++eval.every_n_epochs=6", "++eval.skip_eval_first_epoch=True",
    "++train.tps_prob=0.2", "++model.orthogonal_channel_emb_init=True",
    "++train.extra_loss_lambda=1", "++model.proxy_loss_lambda=0.1",
    "++model.ortho_loss_v1_lambda=1", "++model.gamma_s=0.5", "++model.gamma_d=2",
    "++model.reverse_pos_pairs=True", "++train.seed=2025",
    "++model.hcs_sampling=lowest_cosine_prob"]
CHAMMI_SEED = 2025


def write_chammi_fixture(tmp: str, n_train: int = CHAMMI_TRAIN, n_test: int = CHAMMI_TEST,
                         name: str = "chammi_fixture") -> str:
    """A CHAMMI tree: ``morphem70k_v2.csv``, every tape in one packed blob
    (``chammi_packed.bin`` and its ``.index.json``, read without PIL), and
    ``Allen|HPA|CP/enriched_meta.csv`` with the MorphEm task columns and
    HPA's ``cell_type`` and CP's ``Plate``. Each chunk has ``n_train`` Train
    rows and ``n_test`` rows spread over its tasks, uint8 tapes at its own
    size: a class prototype per channel plus noise. Returns the root."""
    import json
    import os

    import pandas as pd

    root = os.path.join(tmp, name)
    os.makedirs(root)
    rng = np.random.default_rng(0)
    rows, index, off = [], {}, 0
    with open(os.path.join(root, "chammi_packed.bin"), "wb") as blob:
        for chunk, (h, w, c) in CHAMMI_CHUNKS.items():
            classes, tasks = CHAMMI_CLASSES[chunk], CHAMMI_TASKS[chunk]
            protos = rng.integers(20, 180, size=(len(classes), c), dtype=np.uint8)
            splits = ["Train"] * n_train + [tasks[i % len(tasks)] for i in range(n_test)]
            meta = []
            for i, split in enumerate(splits):
                label = classes[i % len(classes)]
                tape = rng.integers(0, 64, size=(h, w * c), dtype=np.uint8)
                tape += np.repeat(protos[i % len(classes)], w)[None, :]
                rel = f"{chunk.lower()}/img_{i}.tif"
                index[rel] = [off, h, w * c, "uint8"]
                blob.write(tape.tobytes())
                off += tape.nbytes
                rows.append({"file_path": rel, "channel_width": w, "chunk": chunk,
                             "label": label, "train_test_split": split})
                meta.append({"Label": label, "train_test_split": split})
            mdf = pd.DataFrame(meta)
            if chunk in CHAMMI_LEAVEOUT:
                mdf[CHAMMI_LEAVEOUT[chunk]] = [f"g{i % 3}" for i in range(len(mdf))]
            for t in tasks:
                mdf[t] = mdf["train_test_split"] == t
            os.makedirs(os.path.join(root, chunk))
            mdf.to_csv(os.path.join(root, chunk, "enriched_meta.csv"), index=False)
    with open(os.path.join(root, "chammi_packed.bin.index.json"), "w") as f:
        json.dump(index, f)
    pd.DataFrame(rows).to_csv(os.path.join(root, "morphem70k_v2.csv"), index=False)
    return root


def chammi_host_batch(trainer) -> str:
    """The host's ms per mixed batch (the loader's next batch with TPS at
    ``train.tps_prob``, then the copy to the card), over three batches, and
    the TPS warps that fired."""
    import torch

    from diverse_channel_vit_torch.data import morphem70k

    warp, fired = morphem70k.tps_warp_chw, [0]

    def counted(rng, img):
        fired[0] += 1
        return warp(rng, img)

    morphem70k.tps_warp_chw = counted
    try:
        it = iter(trainer.train_loader)
        ms = []
        for _ in range(3):
            t = time.perf_counter()
            batch = next(it)
            t1 = time.perf_counter()
            trainer._to_device(batch)
            torch.cuda.synchronize()
            ms.append(((t1 - t) * 1e3, (time.perf_counter() - t1) * 1e3))
    finally:
        morphem70k.tps_warp_chw = warp
    n = sum(len(b["label"]) for b in batch.values())
    return (f"host per {n}-image mixed batch: loader {' / '.join(f'{a:.1f}' for a, _ in ms)} ms, "
            f"copy to the card {' / '.join(f'{b:.1f}' for _, b in ms)} ms, "
            f"{fired[0]} TPS warps in {3 * n} images")


# k per chunk (Allen 3, HPA 4, CP 5 channels) in the CHAMMI parity's 3 steps:
# each chunk once at k = 1 (197 tokens padded to 256) and once at all of its
# channels (641, 785 and 981 tokens padded to 640, 832 and 1024)
CHAMMI_PARITY_KS = ((1, 4, 5), (3, 1, 2), (2, 3, 1))


def chammi_parity(fb, torch, root: str, tmp: str) -> None:
    """The CHAMMI step's kernel route against its plain route, as
    train_parity holds the single-chunk step: two Trainers from chammi_cfg
    with the recipe at PARITY_DEPTH on the fixture, the second given the
    first's initial weights, run the same 3 mixed batches (the run's quotas)
    through ``Trainer._train_one_batch_morphem`` with the k of
    CHAMMI_PARITY_KS, both routes drawing the channels from generators of
    the same seed. Per-chunk losses and grad_norm within TRAIN_LOSS_REL_TOL,
    step-0 gradients (summed over the three chunks' backwards into
    ``.grad``) within TRAIN_GRAD_REL_TOL of max|g|, the channels drawn
    equal; the kernel route launches B1-B4 3 x (PARITY_DEPTH - 1) times a
    step, the plain route none."""
    from diverse_channel_vit_torch.config import load_config
    from diverse_channel_vit_torch.trainer import Trainer

    label = "Trainer CHAMMI parity"
    fused4 = ("attend_project_fwd", "ln_mlp_fwd", "attend_project_bwd", "ln_mlp_bwd")
    over = [*CHAMMI_RECIPE, f"++model.depth={PARITY_DEPTH}", f"++dataset.root_dir={root}",
            f"++train.checkpoints={tmp}/chammi_parity"]
    keys = [f"{c}/loss" for c in CHAMMI_CHUNKS] + ["grad_norm"]
    t0 = time.perf_counter()
    runs, init, host = {}, None, None
    for route in ("plain", "kernels"):
        t = Trainer(load_config("chammi_cfg", over))
        if init is None:
            init = {k: v.clone() for k, v in t.model.state_dict().items()}
            it = iter(t.train_loader)
            host = [next(it) for _ in CHAMMI_PARITY_KS]
            quotas = dict(t.train_loader.quotas)
        else:
            t.model.load_state_dict(init)
        ks = iter(k for step in CHAMMI_PARITY_KS for k in step)
        t._draw_k = lambda c, ks=ks: next(ks)
        before = dict(fb.LAUNCHES)
        ctx = fb.plain_versions() if route == "plain" else contextlib.nullcontext()
        metrics, grads0 = [], None
        with ctx:
            for i, hb in enumerate(host):
                if list(hb) != list(CHAMMI_CHUNKS):
                    raise AssertionError(f"{label}: a mixed batch of chunks {list(hb)}")
                metrics.append(t._train_one_batch_morphem(t._to_device(hb)))
                if i == 0:
                    grads0 = {n: p.grad.float().clone() for n, p in t.model.named_parameters()
                              if p.grad is not None}
        torch.cuda.synchronize()
        counts = {k: fb.LAUNCHES[k] - before[k] for k in before}
        runs[route] = (metrics, grads0, counts)
        del t
        torch.cuda.empty_cache()
    (mk, gk, nk), (mp, gp, np_) = runs["kernels"], runs["plain"]
    if any(np_.values()):
        raise AssertionError(f"{label}: the plain route launched kernels: {np_}")
    check_counts(f"{label}, kernel route", nk, len(host), "step",
                 dict.fromkeys(fused4, 3 * (PARITY_DEPTH - 1)))
    drawn = [[m.get("sampled_channels") for m in ms] for ms in (mk, mp)]
    print(f"{label}: quotas {quotas}, k per step {CHAMMI_PARITY_KS}, channels drawn, "
          f"kernel route {drawn[0]}, plain route {drawn[1]}")
    if drawn[0] != drawn[1]:
        raise AssertionError(f"{label}: the two routes drew other channels")
    rel = {k: max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(mk, mp)) for k in keys}
    print(f"{label} (depth {PARITY_DEPTH}, {len(host)} steps): kernels "
          f"{[[round(m[k], 6) for k in keys] for m in mk]} plain "
          f"{[[round(m[k], 6) for k in keys] for m in mp]} ({', '.join(keys)}), max rel "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in rel.items()})} (tolerance "
          f"{TRAIN_LOSS_REL_TOL})")
    if not all(v <= TRAIN_LOSS_REL_TOL for v in rel.values()):
        raise AssertionError(f"{label}: losses or grad_norm of the two routes disagree")
    if sorted(gk) != sorted(gp):
        raise AssertionError(f"{label}: the routes gave gradients to other parameters")
    worst = (0.0, "")
    for name, g in gk.items():
        ref = gp[name]
        scale = ref.abs().max().item()
        err = (g - ref).abs().max().item()
        worst = max(worst, (err / scale if scale else err, name))
    print(f"{label}: step-0 gradients of {len(gk)} parameter tensors, worst rel "
          f"{worst[0]:.3e} ({worst[1]}) (tolerance {TRAIN_GRAD_REL_TOL} of max|g|); "
          f"{time.perf_counter() - t0:.1f} s")
    if not worst[0] <= TRAIN_GRAD_REL_TOL:
        raise AssertionError(f"{label}: gradient of {worst[1]} disagrees")


def chammi_trainer(fb, torch, tmp: str, root: str):
    """CHAMMI through ``main`` at full width: DiChaViT-S, 224^2, batch 64,
    the overrides of train_scripts.sh:8 with 2 epochs and an eval after each
    (``eval.clean_up`` off to keep the features), on a fixture this script
    writes (``root``). The counts set to 0 just before and read just after: B1-B4 x 33
    per step (11 fused blocks x 3 chunk micro-batches), B1 / B3 x 11 per
    eval forward. Every step's per-chunk losses and grad_norm finite; the
    k sequence numpy ``default_rng(2025)``'s, drawn per chunk; global
    labels (Allen's at 4..9); per chunk as many feature rows as its
    ``enriched_meta.csv``; the nine MorphEm task rows and a CHAMMI score in
    [0, 1]; the card's kNN predictions equal to the CPU's on the saved
    features. Prints its ``phase`` line; returns its counts, steps and
    unit."""
    import os

    import pandas as pd

    from diverse_channel_vit_torch import main as port_main
    from diverse_channel_vit_torch.evaluation import KNeighbors

    label = "Trainer CHAMMI"
    out = os.path.join(tmp, "chammi_run")
    argv = ["-cn", "chammi_cfg", *CHAMMI_RECIPE, "++train.num_epochs=2",
            "++eval.every_n_epochs=1", "++eval.clean_up=False", f"++dataset.root_dir={root}",
            f"++eval.root_dir={root}", f"++eval.feature_dir={out}/feat/{{FOLDER_NAME}}",
            f"++eval.dest_dir={out}/res/{{FOLDER_NAME}}", f"++train.checkpoints={out}/ck"]
    chammi_parity(fb, torch, root, tmp)
    print(f"== {label}: python -m diverse_channel_vit_torch.main {' '.join(argv)}", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fused4 = ("attend_project_fwd", "ln_mlp_fwd", "attend_project_bwd", "ln_mlp_bwd")
    fb.reset_launches()
    with TrainerProbe(torch) as probe:
        best = port_main.main(argv)
    launches = dict(fb.LAUNCHES)
    t = probe.trainer
    steps = len(probe.steps)
    if steps != 2 * t.updates_per_epoch or not steps or len(probe.evals) != 2:
        raise AssertionError(f"{label}: {steps} steps and {len(probe.evals)} evals, want "
                             f"{2 * t.updates_per_epoch} and 2")
    per_step, per_fwd = 3 * (DEPTH - 1), DEPTH - 1
    for name, count in launches.items():
        want = (per_step * steps if name in fused4 else 0) + (
            per_fwd * probe.eval_forwards if name in fused4[:2] else 0)
        if count != want:
            raise AssertionError(f"{label}: {name} launched {count} times in {steps} steps and "
                                 f"{probe.eval_forwards} eval forwards, want {want}")
    print(f"{label}: kernel launches {launches} in {steps} steps and {probe.eval_forwards} "
          f"eval forwards ({per_step} a step, {per_fwd} an eval forward), as expected")
    keys = ("Allen/loss", "HPA/loss", "CP/loss", "grad_norm")
    for i, m in enumerate(probe.steps):
        if not all(np.isfinite(m[k]) for k in keys):
            raise AssertionError(f"{label} step {i}: non-finite metrics {m}")
    print(f"{label}: per step " + "; ".join(
        ", ".join(f"{k} {m[k]:.4f}" for k in keys) for m in probe.steps))
    rng = np.random.default_rng(CHAMMI_SEED)
    cs = [3, 4, 5] * steps
    want_k = [int(rng.integers(1, c + 1)) for c in cs]
    print(f"{label}: k drawn {probe.draws} for channel counts {cs[:6]}..., numpy "
          f"default_rng({CHAMMI_SEED}) gives {want_k}")
    if probe.draws != want_k:
        raise AssertionError(f"{label}: the k sequence differs from _draw_k's")
    batch = next(iter(t.train_loader))
    labels = {c: b["label"] for c, b in batch.items()}
    print(f"{label}: quotas {t.train_loader.quotas}, labels of one batch "
          f"{ {c: sorted(set(v.tolist())) for c, v in labels.items()} }")
    if not (min(v.min() for v in labels.values()) >= 0
            and max(v.max() for v in labels.values()) <= 13
            and 4 <= labels["Allen"].min() and labels["Allen"].max() <= 9):
        raise AssertionError(f"{label}: labels outside the global vocabulary")
    want_rows = {c: len(pd.read_csv(os.path.join(root, c, "enriched_meta.csv")))
                 for c in CHAMMI_CHUNKS}
    res = probe.evals[-1]
    tasks = sorted(k for k in res if k.startswith("knn_cosine/") and k.endswith("/acc"))
    score = res["knn_cosine/chammi_score"]
    print(f"{label}: feature rows {probe.feature_rows} (enriched_meta {want_rows}); "
          f"{len(tasks)} task rows " + ", ".join(f"{k[11:-4]} {res[k]:.4f}" for k in tasks)
          + f"; knn_cosine/chammi_score {score:.4f}, best {best:.4f}")
    if probe.feature_rows != want_rows or len(tasks) != 9 or not 0.0 <= score <= 1.0:
        raise AssertionError(f"{label}: the MorphEm eval is incomplete")
    # the card's kNN against the CPU's on the saved features (epoch 2)
    feats = os.path.join(out, "feat", f"epoch2_seed{t.seed}")
    agree = {}
    for chunk in CHAMMI_CHUNKS:
        x = np.load(os.path.join(feats, chunk, "features.npy"))
        meta = pd.read_csv(os.path.join(root, chunk, "enriched_meta.csv"))
        tr = (meta["train_test_split"] == "Train").to_numpy()
        y = meta["Label"].to_numpy()
        for metric in ("cosine", "l2"):
            card = KNeighbors(metric=metric, device="cuda").fit(x[tr], y[tr]).predict(x[~tr])
            cpu = KNeighbors(metric=metric, device="cpu").fit(x[tr], y[tr]).predict(x[~tr])
            agree[f"{chunk}/{metric}"] = int((card == cpu).sum())
            if not np.array_equal(card, cpu):
                raise AssertionError(f"{label}: the card's kNN ({chunk}, {metric}) differs "
                                     "from the CPU's")
    print(f"{label}: the card's kNN predictions equal the CPU's on the saved features "
          f"({agree} of {CHAMMI_TEST} test rows a chunk)")
    host = chammi_host_batch(t)
    try:
        import PIL  # noqa: F401

        pil = "PIL imports"
    except ImportError:
        pil = "PIL missing (the packed blob needs none)"
    e2 = probe.epochs[2]
    split = res["split"]
    print(f"phase {label}: {e2['imgs_per_sec_per_chip']:.2f} images/s (Trainer steady, epoch 2), "
          f"epoch {e2['wall_s']:.3f} s, {host}; eval {res['wall_s']:.3f} s (forward "
          f"{split['forward']:.3f} s, benchmark {split['benchmark']:.3f} s) for "
          f"{sum(want_rows.values())} images at eval batch size {t.cfg.eval.batch_size}, "
          f"eval peak memory {res['peak_gb']:.3f} GB, train peak memory "
          f"{probe.epochs[1]['peak_gb']:.3f} GB (epoch 1); {pil}; card {card_line()}")
    launches.update(eval_forwards=probe.eval_forwards)
    del probe, t
    return launches, steps, "step"


# the novel-channel evals: a mapper whose test split holds channels 6 and 7
# that train lacks, and the subset sweep's 7-of-8 grid (N = 1 + 7 * 196 =
# 1373 tokens, padded to 1408)
NOVEL_TRAIN = list(range(6))
NOVEL_SUBSET = [0, 1, 2, 3, 5, 6, 7]
NOVEL_KEYS = {"valid/accuracy", "test/zero/accuracy", "subset_8/mean", "subset_8/std",
              "subset_7/mean", "subset_7/std", "accuracy"}
CHAMMI_STRATEGIES = ("zero", "avg_2", "replicate")


def recipe_overrides(line: int):
    """``train_scripts.sh`` at ``line``: the config name and its overrides
    as written, less the hydra ``-m`` flag and the tag."""
    import os
    import shlex

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "train_scripts.sh")
    with open(path) as f:
        args = shlex.split(f.read().splitlines()[line - 1])
    i = args.index("-cn")
    return args[i + 1], [a for a in args[i + 2:] if not a.startswith("tag=")]


def novel_parity(fb, torch) -> None:
    """The novel-channel evals' forward, kernel route against plain route on
    one DiChaViT-S (full width and depth, bf16, seed 0), B = 64 images of 8
    channels at 224²: (a) the (C, D) ``avg_2`` table of a mapper whose test
    split holds channels 6 and 7 that train lacks; (b) the subset sweep's 7
    of 8 channels (N = 1373 padded to 1408), no override; (c) the per-sample
    (B, C, D) ``dynamic_input_corr_4`` override from a bank of 8 exemplars of
    train's 6 channels, each image's novel rows its own. Logits within
    LOGITS_REL_TOL of the plain route's (the serving phase's tolerance); B1
    and B3 11 launches each per kernel-route forward, none on the plain
    route; the avg_2 table moves the logits off the table's own rows'."""
    from diverse_channel_vit_torch.ops import novel_channels as nc
    from diverse_channel_vit_torch.training import make_eval_step

    label = "novel_parity"
    t0 = time.perf_counter()
    model = build(DEPTH)
    step = make_eval_step(model)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((B, CHANNELS, IMG, IMG), dtype=np.float32)).cuda()
    bank = torch.from_numpy(rng.standard_normal((8, len(NOVEL_TRAIN), IMG, IMG),
                                                dtype=np.float32)).cuda()
    table = model.feature_extractor.patch_embed.channel_embed.weight.detach()
    mapper = {"train": NOVEL_TRAIN, "test": list(range(CHANNELS))}
    avg2 = nc.synthesize_rows(table, nc.synthesis_plan(mapper, "test", "train", "avg_2"))
    dyn = torch.stack([table[c].expand(B, -1) if c in NOVEL_TRAIN else
                       nc.dynamic_input_corr(4, x, c, bank, table, NOVEL_TRAIN)
                       for c in range(CHANNELS)], dim=1)
    same = int((dyn[1:, CHANNELS - 1] == dyn[:1, CHANNELS - 1]).all(dim=1).sum())
    if dyn.shape != (B, CHANNELS, D) or same:
        raise AssertionError(f"{label}: the dynamic override is {tuple(dyn.shape)} with {same} "
                             "images sharing image 0's row")
    full = torch.arange(CHANNELS, device="cuda")
    sub = torch.tensor(NOVEL_SUBSET, device="cuda")
    cases = {"avg_2 (C, D), N 1600": (x, full, avg2),
             "7 of 8, N 1408": (x[:, NOVEL_SUBSET].contiguous(), sub, None),
             "dynamic_input_corr_4 (B, C, D), N 1600": (x, full, dyn)}
    outs, secs = {}, {}
    for route in ("kernels", "plain"):
        ctx = fb.plain_versions() if route == "plain" else contextlib.nullcontext()
        fb.reset_launches()
        with ctx:
            for name, (xx, cids, ov) in cases.items():
                torch.cuda.synchronize()
                t = time.perf_counter()
                outs[route, name] = step(xx, cids, ov).float().cpu().numpy()
                secs[route, name] = time.perf_counter() - t
        launches = dict(fb.LAUNCHES)
        if route == "kernels":
            check_counts(f"{label}, kernel route", launches, len(cases), "forward",
                         {"attend_project_fwd": DEPTH - 1, "ln_mlp_fwd": DEPTH - 1})
        elif any(launches.values()):
            raise AssertionError(f"{label}: the plain route launched kernels: {launches}")
    for name in cases:
        logits_close(f"{label} {name}", outs["kernels", name], outs["plain", name])
    own = step(x, full).float().cpu().numpy()
    moved = float(np.abs(outs["kernels", "avg_2 (C, D), N 1600"] - own).max())
    print(f"{label}: the avg_2 table moves the logits by up to {moved:.3e} from the table's "
          f"own rows'; one call each, kernel route "
          f"{ {n: round(secs['kernels', n] * 1e3, 1) for n in cases} } ms, plain route "
          f"{ {n: round(secs['plain', n] * 1e3, 1) for n in cases} } ms; "
          f"{time.perf_counter() - t0:.1f} s; card {card_line()}")
    if not moved > 0:
        raise AssertionError(f"{label}: the override did not reach the forward")
    del model, step, x, bank, dyn
    torch.cuda.empty_cache()


def novel_trainer(fb, torch, root: str, tmp: str):
    """``main`` with the overrides of train_scripts.sh:11 as written (DiChaViT
    on JUMP-CP: DCS, the ``zero`` strategy, the channel-subset sweep) on
    the JUMP-CP fixture, cut to 1 epoch: B1-B4 x 11 per step, B1 / B3 x 11
    per eval forward (``valid``, ``test`` under ``zero``, the 9 subsets);
    the eval keys those the CPU tests hold to JAX's. Runs ``novel_parity``
    first. Prints the seconds of ``eval_regular`` and of the sweep, the
    sweep's images/s and the eval peak memory. Returns its counts, steps and
    unit."""
    novel_parity(fb, torch)
    t0 = time.perf_counter()
    label = "Trainer novel channels"
    name, recipe = recipe_overrides(11)
    fused4 = ("attend_project_fwd", "ln_mlp_fwd", "attend_project_bwd", "ln_mlp_bwd")
    per_fwd = dict.fromkeys(fused4[:2], DEPTH - 1)
    probe, launches, steps = run_trainer(
        fb, torch, label, name, recipe + ["++train.num_epochs=1", f"++dataset.root_dir={root}",
                                          f"++train.checkpoints={tmp}/novel"],
        dict.fromkeys(fused4, DEPTH - 1), per_fwd)
    t = probe.trainer
    ev = probe.evals[-1]
    keys = set(ev) - {"wall_s", "images", "peak_gb", "split"}
    n_test = t.eval_counts["test"][1]
    per = {k: (launches[k] - (DEPTH - 1) * steps) / probe.eval_forwards for k in fused4[:2]}
    split = ev["split"]
    n_sub = 1 + CHANNELS  # the 8 channels, then each 7 of them
    print(f"{label}: eval keys {sorted(keys)}; "
          + ", ".join(f"{k} {ev[k]:.4f}" for k in sorted(keys))
          + f"; {probe.eval_forwards} eval forwards, B1 / B3 launches per eval forward {per}; "
          f"eval_regular {split['eval_regular']:.3f} s, subset sweep {split['subset_sweep']:.3f} s "
          f"for {n_sub} subsets of {n_test} test images "
          f"({n_sub * n_test / split['subset_sweep']:.2f} images/s), eval peak memory "
          f"{ev['peak_gb']:.3f} GB; {time.perf_counter() - t0:.1f} s; card {card_line()}")
    if keys != NOVEL_KEYS or per != dict.fromkeys(fused4[:2], DEPTH - 1):
        raise AssertionError(f"{label}: eval keys {sorted(keys)} (want {sorted(NOVEL_KEYS)}), "
                             f"launches per eval forward {per}")
    launches.update(eval_forwards=probe.eval_forwards)
    del probe, t
    return launches, steps, "step"


def chammi_subset(fb, torch, tmp: str, root: str):
    """CHAMMI on a chunk subset through ``main``: the overrides of
    train_scripts.sh:8 with ``train.training_chunks=Allen_HPA`` and the
    strategies zero, avg_2 and replicate, 1 epoch, on the CHAMMI fixture:
    B1-B4 x 22 per step (two chunk micro-batches), B1 / B3 x 11 per eval
    forward (each chunk's test batches under each strategy: 9 forwards at
    the recipe's eval batch of 256); the CHAMMI score per strategy,
    ``accuracy`` the first's; CP's features (five channels Allen and HPA
    never trained) differ between zero and avg_2. Returns its counts,
    steps and unit."""
    import os

    from diverse_channel_vit_torch import main as port_main

    label = "Trainer CHAMMI subset"
    out = os.path.join(tmp, "chammi_subset")
    argv = ["-cn", "chammi_cfg", *CHAMMI_RECIPE, "++train.num_epochs=1",
            "++train.training_chunks=Allen_HPA",
            f"++model.new_channel_inits=[{','.join(CHAMMI_STRATEGIES)}]",
            f"++dataset.root_dir={root}", f"++eval.root_dir={root}",
            f"++eval.feature_dir={out}/feat/{{FOLDER_NAME}}",
            f"++eval.dest_dir={out}/res/{{FOLDER_NAME}}", f"++train.checkpoints={out}/ck"]
    print(f"== {label}: python -m diverse_channel_vit_torch.main {' '.join(argv)}", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fused4 = ("attend_project_fwd", "ln_mlp_fwd", "attend_project_bwd", "ln_mlp_bwd")
    t0 = time.perf_counter()
    fb.reset_launches()
    with TrainerProbe(torch) as probe:
        port_main.main(argv)
    launches = dict(fb.LAUNCHES)
    secs = time.perf_counter() - t0
    t = probe.trainer
    steps = len(probe.steps)
    per_step, per_fwd = 2 * (DEPTH - 1), DEPTH - 1
    want_fwd = len(CHAMMI_STRATEGIES) * sum(len(ld) for ld in t.test_loaders.values())
    if not steps or steps != t.updates_per_epoch or probe.eval_forwards != want_fwd:
        raise AssertionError(f"{label}: {steps} steps and {probe.eval_forwards} eval forwards, "
                             f"want {t.updates_per_epoch} and {want_fwd}")
    for name, count in launches.items():
        want = (per_step * steps if name in fused4 else 0) + (
            per_fwd * probe.eval_forwards if name in fused4[:2] else 0)
        if count != want:
            raise AssertionError(f"{label}: {name} launched {count} times in {steps} steps and "
                                 f"{probe.eval_forwards} eval forwards, want {want}")
    res = probe.evals[-1]
    scores = {s: res[f"{s}/knn_cosine/chammi_score"] for s in CHAMMI_STRATEGIES}
    cp = {s: probe.features[s, "CP"] for s in CHAMMI_STRATEGIES}
    moved = float(np.abs(cp["zero"] - cp["avg_2"]).max())
    allen = float(np.abs(probe.features["zero", "Allen"] - probe.features["avg_2", "Allen"]).max())
    print(f"{label}: kernel launches {launches} in {steps} steps and {probe.eval_forwards} eval "
          f"forwards, as expected; quotas {t.train_loader.quotas}; CHAMMI score per strategy "
          f"{scores}, accuracy {res['accuracy']:.4f}; CP features zero vs avg_2 max diff "
          f"{moved:.3e}, Allen's (all trained) {allen:.3e}; eval {res['wall_s']:.3f} s "
          f"(forward {res['split']['forward']:.3f} s, benchmark "
          f"{res['split']['benchmark']:.3f} s), eval peak memory {res['peak_gb']:.3f} GB; "
          f"{secs:.1f} s; card {card_line()}")
    if (sorted(t.train_loader.quotas) != ["Allen", "HPA"] or res["accuracy"] != scores["zero"]
            or not all(0.0 <= v <= 1.0 for v in scores.values()) or not moved > 0):
        raise AssertionError(f"{label}: the strategies' eval is wrong")
    launches.update(eval_forwards=probe.eval_forwards)
    del probe, t
    return launches, steps, "step"


# the ConvNeXt family (ROADMAP A9) at JUMP-CP geometry (8 channels, 224^2,
# 161 classes), full ConvNeXt-Tiny width and depth, each with its yaml's
# values; DINOv2 at the dinov2_vits14_reg shape; the feature-extraction CLI's
# three backbones. No kernel of the port lies on these paths.
CONVNEXT = {
    "convnext_base": dict(model_name="convnext_base"),
    "shared_convnext": dict(model_name="shared_convnext"),
    "sliceparamconvnext": dict(model_name="sliceparamconvnext"),
    "templatemixingconvnext": dict(model_name="templatemixingconvnext", num_templates=64,
                                   separate_coef=True),
    "hyperconvnext": dict(model_name="hyperconvnext", z_dim=64, hidden_dim=128),
    "depthwiseconvnext": dict(model_name="depthwiseconvnext", kernels_per_channel=16,
                              pooling_channel_type="weighted_sum_random"),
}
CONVNEXT_PARITY_B = 4
# the CHAMMI fixture of the ConvNeXt phase: Train and test rows a chunk
# (half the CHAMMI phase's: the host reads the tapes, and the phase's
# budget is 120 s)
CONVNEXT_CHAMMI_ROWS = (64, 32)
# the parity checks set every block's layer scale to this (the seeded init's
# 1e-6 would leave the blocks out of the output)
CONVNEXT_GAMMA = 0.3
# the card in f32 with TF32 off against the CPU in f32: the same arithmetic
# in other summation orders (cuDNN's and the CPU's convolution algorithms)
F32_REL_TOL = 1e-3
DINO = dict(dim=384, heads=6, depth=12, patch=14, registers=4, grid=37)
FEATURE_BACKBONES = ("dinov2_jax", "resnet18_jax", "convnext_jax")


def convnext_model(name: str, device: str, dtype, extra: dict, mapper=None):
    """A ConvNeXt-family model at JUMP-CP geometry from seed 0 (the same
    weights whatever the device and dtype), on ``mapper`` or else the one the
    Trainer builds for a single-chunk dataset (``train``, ``valid``,
    ``test``: the first key's stems and tables; DepthwiseConvNeXt
    average-pools), every block's layer scale at CONVNEXT_GAMMA."""
    import torch

    from diverse_channel_vit_torch.models import build_model

    extra = dict(extra)
    ids = list(range(CHANNELS))
    model = build_model(extra.pop("model_name"), model_config(DEPTH, **extra),
                        mapper or {"train": ids, "valid": ids, "test": ids}, CLASSES,
                        device=device, dtype=dtype, seed=0)
    with torch.no_grad():
        for blk in model.feature_extractor.trunk.blocks:
            blk.gamma.fill_(CONVNEXT_GAMMA)
    return model


def rel_close(label: str, what: str, got, want, tol: float) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if not np.isfinite(got).all():
        raise AssertionError(f"{label}: {what} not finite")
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"{label}: {what} rel {rel:.3e} (tolerance {tol})")
    if not rel <= tol:
        raise AssertionError(f"{label}: {what} disagrees")
    return rel


def no_port_kernels(label: str, names) -> None:
    """Raise if a kernel of the port (namespace ``dcvit``) ran."""
    ours = [n for n in names if "dcvit" in n]
    if ours:
        raise AssertionError(f"{label}: the profiler saw the port's kernels {ours[:3]}")


def convnext_checks(fb, torch, label: str, extra: dict, bare: dict) -> dict:
    """One ConvNeXt-family model at full width: its f32 forward on the card
    (TF32 off) against the CPU's at B = 4 within F32_REL_TOL, the bf16
    forward within LOGITS_REL_TOL; a bf16 train step on the card against the
    f32 CPU step (AdamW, CE), the loss within TRAIN_LOSS_REL_TOL and every
    gradient within TRAIN_GRAD_REL_TOL of its own max|g|; 2 + 10 timed
    bf16 steps at B = 64 and one profiled (the device's busy share, no kernel
    of the port); serving p50 at buckets 1 and 64. Returns its figures."""
    import copy

    from diverse_channel_vit_torch.serving import ServingEngine
    from diverse_channel_vit_torch.training import (TrainState, make_lr_schedule,
                                                    make_optimizer, make_train_step)

    t0 = time.perf_counter()
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.standard_normal((CONVNEXT_PARITY_B, CHANNELS, IMG, IMG),
                                             dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, CLASSES, size=CONVNEXT_PARITY_B))
    cids = list(range(CHANNELS))
    cpu = convnext_model(label, "cpu", torch.float32, extra)
    card = convnext_model(label, "cuda", torch.bfloat16, extra)
    n_params = sum(p.numel() for p in cpu.parameters())
    card32 = copy.deepcopy(cpu).cuda()
    out = {"params": n_params}
    with torch.no_grad():
        want = cpu(x, torch.tensor(cids))[0].numpy()
        got32 = card32(x.cuda(), torch.tensor(cids, device="cuda"))[0].float().cpu().numpy()
        got16 = card(x.cuda(), torch.tensor(cids, device="cuda"))[0].float().cpu().numpy()
    out["f32_rel"] = rel_close(label, "f32 logits, card vs CPU", got32, want, F32_REL_TOL)
    out["bf16_rel"] = rel_close(label, "bf16 logits, card vs CPU f32", got16, want,
                                LOGITS_REL_TOL)
    del card32
    lr = make_lr_schedule("none", ADAMW_JUMPCP["lr"], {}, num_epochs=1, steps_per_epoch=1)
    grads, losses = {}, {}
    for side, model, dev in (("cpu", cpu, "cpu"), ("card", card, "cuda")):
        state = TrainState(model, make_optimizer("adamw", dict(ADAMW_JUMPCP), lr_schedule=lr,
                                                 total_steps=10))
        step = make_train_step(model, channel_ids=cids, loss_type="ce")
        _, m = step(state, {"image": x.to(dev), "label": y.to(dev)})
        losses[side] = float(m["loss"])
        grads[side] = {n: p.grad.float().cpu() for n, p in model.named_parameters()
                       if p.grad is not None}
        del state, step
    loss_rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    worst = max(((grads["card"][n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30), n)
                for n, g in grads["cpu"].items())
    print(f"{label}: bf16 card step vs f32 CPU step: loss {losses['card']:.6f} vs "
          f"{losses['cpu']:.6f}, rel {loss_rel:.3e} (tolerance {TRAIN_LOSS_REL_TOL}); "
          f"{len(grads['cpu'])} gradients, worst rel {worst[0]:.3e} ({worst[1]}) (tolerance "
          f"{TRAIN_GRAD_REL_TOL} of its max|g|)")
    if not (loss_rel <= TRAIN_LOSS_REL_TOL and worst[0] <= TRAIN_GRAD_REL_TOL
            and set(grads["card"]) == set(grads["cpu"])):
        raise AssertionError(f"{label}: the card's step disagrees with the CPU's")
    out.update(loss_rel=loss_rel, grad_rel=worst[0], grad_worst=worst[1])
    del cpu, grads
    # 2 + 10 timed bf16 steps at B = 64, then one profiled
    batch = synthetic_batch(torch)
    state = TrainState(card, make_optimizer("adamw", dict(ADAMW_JUMPCP), lr_schedule=lr,
                                            total_steps=100))
    step = make_train_step(card, channel_ids=cids, loss_type="ce")
    torch.cuda.reset_peak_memory_stats()
    lats = []
    for i in range(12):
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        if i >= 2:
            lats.append(time.perf_counter() - t)
        if not np.isfinite(float(m["loss"])):
            raise AssertionError(f"{label}: step {i} loss not finite")
    lats = np.asarray(lats)
    out.update(train_p50_ms=float(np.percentile(lats, 50)) * 1e3,
               train_imgs_per_s=B * len(lats) / float(lats.sum()),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    rows, busy = profile_call(lambda: step(state, batch), f"one {label} step (64 images)", torch)
    no_port_kernels(label, [k for _, k, _ in rows])
    out["busy"] = busy
    del state, step, batch
    card.eval()
    engine = ServingEngine(card, buckets=(1, 64), device="cuda")
    engine.warmup(cids, (IMG, IMG))
    imgs = rng.standard_normal((B, CHANNELS, IMG, IMG), dtype=np.float32)
    for bucket, reps in ((1, 20), (64, 8)):
        lat = []
        for _ in range(reps):
            t = time.perf_counter()
            logits = engine.predict(imgs[:bucket], cids)
            lat.append(time.perf_counter() - t)
        if not np.isfinite(logits).all() or logits.shape != (bucket, CLASSES):
            raise AssertionError(f"{label}: serving logits {logits.shape} not finite")
        out[f"serve_p50_ms_{bucket}"] = float(np.percentile(lat, 50)) * 1e3
    engine.stop()
    print(f"phase convnext {label}: train {out['train_imgs_per_s']:.2f} images/s, p50 "
          f"{out['train_p50_ms']:.3f} ms, peak memory {out['peak_gb']:.3f} GB, device busy "
          f"{'not measured' if busy is None else f'{100 * busy:.1f}%'} of a profiled step; "
          f"serving p50 {out['serve_p50_ms_1']:.3f} ms at bucket 1, "
          f"{out['serve_p50_ms_64']:.3f} ms at bucket 64; {n_params:,} parameters; the plain "
          f"DiChaViT-S step {bare['p50_ms']:.3f} ms; {time.perf_counter() - t0:.1f} s; card "
          f"{card_line()}", flush=True)
    del card, engine
    torch.cuda.empty_cache()
    return out


def depthwise_chammi_step(torch) -> dict:
    """DepthwiseConvNeXt on CHAMMI's mapper (its per-chunk patch embedding;
    HPA's 4 channels at 224^2, B = 4, the proxy loss) against the CPU's f32
    step. Held: the card's f32 step (TF32 off), the loss and every gradient
    within F32_REL_TOL (of its own max|g|); the card's bf16 step's loss
    within TRAIN_LOSS_REL_TOL. Printed, not held: the bf16 step's
    gradients, each as a share of its own max|g|. Two of them are small
    differences of large terms, which bf16's rounding of the terms
    dominates: the patch embedding's bias, whose gradient is the sum over
    pixels of the patch-embedded map's gradient (the bias-free 1x1 conv and
    the InstanceNorm after the 3x3 bank take out a constant shift, so the
    sum nearly cancels: |sum g| / sum |g| by channel, from the CPU's step,
    is printed), and the softmax channel weights ``weighted_sum_pooling``
    (the softmax's backward subtracts the weighted mean of the channels'
    terms). Returns the readings."""
    import diverse_channel_vit_torch.models.convnext_variants as cv
    from diverse_channel_vit_torch.training import (TrainState, make_lr_schedule,
                                                    make_optimizer, make_train_step)

    label, chunk = "depthwiseconvnext CHAMMI", "HPA"
    mapper = {"Allen": [5, 2, 6], "HPA": [3, 6, 5, 0], "CP": [5, 0, 7, 1, 4]}
    rng = np.random.default_rng(37)
    x = torch.from_numpy(rng.standard_normal((CONVNEXT_PARITY_B, len(mapper[chunk]), IMG, IMG),
                                             dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, CLASSES, size=CONVNEXT_PARITY_B))
    lr = make_lr_schedule("none", ADAMW_JUMPCP["lr"], {}, num_epochs=1, steps_per_epoch=1)
    bias = f"feature_extractor.patch_emb_bias_{chunk}"
    held = {}
    real_conv = cv._conv

    def keep_patch_map(x_, w, b=None, **kw):
        out = real_conv(x_, w, b, **kw)
        if b is not None and "map" not in held and out.requires_grad:
            held["map"] = out
            out.retain_grad()
        return out

    runs = {}
    for side, dev, dtype in (("cpu", "cpu", torch.float32), ("card f32", "cuda", torch.float32),
                             ("card bf16", "cuda", torch.bfloat16)):
        model = convnext_model(label, dev, dtype, CONVNEXT["depthwiseconvnext"], mapper)
        state = TrainState(model, make_optimizer("adamw", dict(ADAMW_JUMPCP), lr_schedule=lr,
                                                 total_steps=10))
        step = make_train_step(model, channel_ids=mapper[chunk], loss_type="proxy", chunk=chunk)
        if side == "cpu":
            cv._conv = keep_patch_map
        try:
            _, m = step(state, {"image": x.to(dev), "label": y.to(dev)})
        finally:
            cv._conv = real_conv
        runs[side] = (float(m["loss"]), {n: p.grad.float().cpu() for n, p in
                                         model.named_parameters() if p.grad is not None})
        del model, state, step
    g_map = held.pop("map").grad.double()
    cancel = (g_map.sum(dim=(0, 2, 3)).abs() / g_map.abs().sum(dim=(0, 2, 3))).tolist()
    loss, want = runs["cpu"]
    out = {"cancellation": cancel}
    for side, loss_tol in (("card f32", F32_REL_TOL), ("card bf16", TRAIN_LOSS_REL_TOL)):
        got_loss, got = runs[side]
        loss_rel = abs(got_loss - loss) / abs(loss)
        rels = {n: (got[n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
                for n, g in want.items()}
        worst = sorted(((r, n) for n, r in rels.items()), reverse=True)
        out[side] = dict(loss_rel=loss_rel, grad_rel=worst[0][0], bias_rel=rels[bias])
        if side == "card f32":
            grads = (f"worst rel {worst[0][0]:.3e} ({worst[0][1]}) (tolerance {F32_REL_TOL} of "
                     f"its max|g|)")
            ok = worst[0][0] <= F32_REL_TOL and set(got) == set(want)
        else:
            grads = ("not held, the largest rel " + ", ".join(f"{r:.3e} ({n})" for r, n in
                                                             worst[:4]) + f"; {bias} "
                     f"{rels[bias]:.3e}")
            ok = set(got) == set(want)
        print(f"{label}: {side} step vs f32 CPU step: loss rel {loss_rel:.3e} (tolerance "
              f"{loss_tol}); {len(rels)} gradients, {grads}", flush=True)
        if not (loss_rel <= loss_tol and ok):
            raise AssertionError(f"{label}: the card's {side} step disagrees with the CPU's")
    print(f"{label}: {bias}'s gradient, the sum over pixels of the patch-embedded map's, "
          f"cancels to |sum g| / sum |g| = {', '.join(f'{c:.3e}' for c in cancel)} by channel; "
          f"card {card_line()}", flush=True)
    return out


def dinov2_state(rng) -> dict:
    """A hub-layout DINOv2 state dict of the dinov2_vits14_reg shape (D =
    384, 6 heads, depth 12, patch 14, 4 registers, the 37 x 37 grid), drawn
    by numpy: the random stand-in for the published weights."""
    d, p, g = DINO["dim"], DINO["patch"], DINO["grid"]
    sd = {"cls_token": rng.normal(size=(1, 1, d)) * 0.02,
          "pos_embed": rng.normal(size=(1, 1 + g * g, d)) * 0.02,
          "register_tokens": rng.normal(size=(1, DINO["registers"], d)) * 0.02,
          "mask_token": np.zeros((1, d)),
          "patch_embed.proj.weight": rng.normal(size=(d, 3, p, p)) / (p * np.sqrt(3)),
          "patch_embed.proj.bias": np.zeros(d), "norm.weight": np.ones(d), "norm.bias": np.zeros(d)}
    for i in range(DINO["depth"]):
        o = f"blocks.{i}."
        for ln in ("norm1", "norm2"):
            sd[o + ln + ".weight"], sd[o + ln + ".bias"] = np.ones(d), np.zeros(d)
        for name, (n_out, n_in) in (("attn.qkv", (3 * d, d)), ("attn.proj", (d, d)),
                                    ("mlp.fc1", (4 * d, d)), ("mlp.fc2", (d, 4 * d))):
            sd[o + name + ".weight"] = rng.normal(size=(n_out, n_in)) / np.sqrt(n_in)
            sd[o + name + ".bias"] = np.zeros(n_out)
        sd[o + "ls1.gamma"] = np.full(d, 0.1)
        sd[o + "ls2.gamma"] = np.full(d, 0.1)
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def timm_convnext_state(rng) -> dict:
    """A timm ``convnext_tiny`` state dict drawn by numpy (the shapes of
    ``convnext_tiny.fb_in22k``, its head included): the random stand-in for
    the pretrained checkpoint."""
    from diverse_channel_vit_torch.models.convnext import TINY

    dims = TINY["dims"]
    sd = {"stem.0.weight": rng.normal(size=(96, 3, 4, 4)) * 0.1, "stem.0.bias": np.zeros(96),
          "stem.1.weight": np.ones(96), "stem.1.bias": np.zeros(96),
          "head.norm.weight": np.ones(768), "head.norm.bias": np.zeros(768),
          "head.fc.weight": rng.normal(size=(1000, 768)) * 0.02, "head.fc.bias": np.zeros(1000)}
    for s, (depth, dim) in enumerate(zip(TINY["depths"], dims)):
        if s:
            sd[f"stages.{s}.downsample.0.weight"] = np.ones(dims[s - 1])
            sd[f"stages.{s}.downsample.0.bias"] = np.zeros(dims[s - 1])
            sd[f"stages.{s}.downsample.1.weight"] = rng.normal(
                size=(dim, dims[s - 1], 2, 2)) / np.sqrt(4 * dims[s - 1])
            sd[f"stages.{s}.downsample.1.bias"] = np.zeros(dim)
        for b in range(depth):
            p = f"stages.{s}.blocks.{b}."
            sd[p + "conv_dw.weight"] = rng.normal(size=(dim, 1, 7, 7)) / 7
            sd[p + "conv_dw.bias"] = np.zeros(dim)
            sd[p + "norm.weight"], sd[p + "norm.bias"] = np.ones(dim), np.zeros(dim)
            sd[p + "mlp.fc1.weight"] = rng.normal(size=(4 * dim, dim)) / np.sqrt(dim)
            sd[p + "mlp.fc1.bias"] = np.zeros(4 * dim)
            sd[p + "mlp.fc2.weight"] = rng.normal(size=(dim, 4 * dim)) / np.sqrt(4 * dim)
            sd[p + "mlp.fc2.bias"] = np.zeros(dim)
            sd[p + "gamma"] = np.full(dim, 0.1)
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def resnet18_state(rng) -> dict:
    """A torchvision-layout ResNet-18 state dict drawn by numpy, BatchNorm
    statistics and ``fc`` included: the random stand-in for the pretrained
    ResNet-18."""
    sd = {}

    def conv_bn(conv, bn, cout, cin, k):
        sd[conv + ".weight"] = rng.normal(size=(cout, cin, k, k)) * np.sqrt(2.0 / (cin * k * k))
        sd[bn + ".weight"], sd[bn + ".bias"] = np.ones(cout), np.zeros(cout)
        sd[bn + ".running_mean"], sd[bn + ".running_var"] = np.zeros(cout), np.ones(cout)

    conv_bn("conv1", "bn1", 64, 3, 7)
    cin = 64
    for li, (n, cout) in enumerate(zip((2, 2, 2, 2), (64, 128, 256, 512))):
        for bi in range(n):
            t = f"layer{li + 1}.{bi}"
            conv_bn(t + ".conv1", t + ".bn1", cout, cin, 3)
            conv_bn(t + ".conv2", t + ".bn2", cout, cout, 3)
            if (li > 0 and bi == 0) or cin != cout:
                conv_bn(t + ".downsample.0", t + ".downsample.1", cout, cin, 1)
            cin = cout
    sd["fc.weight"], sd["fc.bias"] = rng.normal(size=(1000, 512)) * 0.02, np.zeros(1000)
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def save_state(path: str, sd: dict) -> str:
    import torch

    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return path


def dinov2_checks(torch) -> dict:
    """DINOv2 at the dinov2_vits14_reg shape with random weights: the card's
    f32 forward against the CPU's at B = 4 (224^2: the 37 x 37 grid
    resampled to 16 x 16) within F32_REL_TOL, hub and HuggingFace layouts
    alike; the card's CLS features of 64 images timed (10 calls after 2)."""
    from diverse_channel_vit_torch.models import dinov2

    sd = dinov2_state(np.random.default_rng(41))
    cfg = dinov2.config_from_state_dict(sd)
    model = dinov2.load_torch_dinov2_state(dinov2.DinoV2ViT(**cfg), sd).eval()
    x = torch.from_numpy(np.random.default_rng(42).standard_normal((CONVNEXT_PARITY_B, 3, IMG,
                                                                   IMG), dtype=np.float32))
    with torch.no_grad():
        want = model.forward_features(x)
        card = model.cuda()
        got = card.forward_features(x.cuda())
    out = {k: rel_close("dinov2", f"{k}, card f32 vs CPU", got[k].cpu(), want[k], F32_REL_TOL)
           for k in ("x_norm_clstoken", "x_norm_patchtokens")}
    xb = torch.from_numpy(np.random.default_rng(43).standard_normal(
        (B, 3, IMG, IMG), dtype=np.float32)).cuda()
    with torch.no_grad():
        ms = cuda_ms(lambda: card(xb), 10)
    out["ms_64"] = ms
    print(f"phase dinov2 (vits14_reg shape, f32, {cfg}): CLS features of 64 images in {ms:.3f} "
          f"ms ({B / ms * 1e3:.2f} images/s); card {card_line()}", flush=True)
    del card
    torch.cuda.empty_cache()
    return out


def pretrained_stems(torch, config: str, over, path: str) -> None:
    """A Trainer built from ``config`` with ``over`` (``model.pretrained`` the
    timm state dict at ``path``): each stem of the model holds the
    pretrained 3-channel stem on its first three input channels, and under
    ``pretrained_pad_avg`` channel 3 + i the mean of pretrained channels i
    to i + n_avg - 1 (n_avg 2 for a 5-channel stem, else 3)."""
    from diverse_channel_vit_torch.config import load_config
    from diverse_channel_vit_torch.trainer import Trainer

    t = Trainer(load_config(config, over))
    pre = torch.load(path, weights_only=True)["stem.0.weight"]
    avg = t.cfg.model.init_first_layer == "pretrained_pad_avg"
    fe, shapes = t.model.feature_extractor, {}
    for name, p in fe.named_parameters():
        if not name.startswith("stem_conv") or name == "stem_conv1x1.weight":
            continue
        stem = p.detach().cpu()
        n_avg = 2 if stem.shape[1] == 5 else 3
        ok = torch.equal(stem[:, :3], pre) and (not avg or all(
            torch.allclose(stem[:, 3 + i], pre[:, i:i + n_avg].mean(dim=1))
            for i in range(stem.shape[1] - 3)))
        shapes[name] = tuple(stem.shape)
        if not ok:
            raise AssertionError(f"{config}: {name} was not widened from the pretrained stem")
    print(f"{config} {t.cfg.model.name} pretrained ({t.cfg.model.init_first_layer}): stems "
          f"{shapes} hold the pretrained {tuple(pre.shape)} stem as the rule says")
    if not shapes:
        raise AssertionError(f"{config}: no stem to check")
    del t


def convnext_trainers(fb, torch, tmp: str) -> str:
    """``main`` on the card with ConvNeXt models, the counts set to 0 before
    each and read after (every one 0: no kernel of the port on these paths):
    ``jump_cp_cfg`` with ``convnext_base`` for one epoch on the JUMP-CP
    fixture, ``model.pretrained`` a timm-layout state dict written here and
    ``init_first_layer: pretrained_pad_random`` (``pretrained_pad_avg``
    widens 3 channels to at most 6: at JUMP-CP's 8 the reference averages an
    empty window into NaN, and the port raises); ``chammi_cfg`` with
    ``shared_convnext`` on every chunk from that state dict under
    ``pretrained_pad_avg`` (each chunk's stem widened to 3, 4 and 5
    channels), and with ``depthwiseconvnext`` on
    ``train.training_chunks=Allen_HPA`` with the novel-channel strategies
    zero, avg_2 and replicate, one epoch each on the CHAMMI fixture, with
    the embedding figures (``eval.umap``). A Trainer built from each
    pretrained config first shows the widened stems
    (:func:`pretrained_stems`). Returns the CHAMMI fixture's root."""
    from diverse_channel_vit_torch import main as port_main

    root = write_jumpcp_fixture(tmp)
    path = save_state(os.path.join(tmp, "convnext_tiny.pth"),
                      timm_convnext_state(np.random.default_rng(44)))
    over = [f"++dataset.root_dir={root}", "model=convnext_base", "train.batch_size=64",
            "train.num_epochs=1", "train.save_model=none", "eval.skip_eval_first_epoch=True",
            "train.device_augment=True", f"++model.pretrained={path}",
            "++model.init_first_layer=pretrained_pad_random", f"train.checkpoints={tmp}"]
    pretrained_stems(torch, "jump_cp_cfg", over, path)
    probe, launches, _ = run_trainer(fb, torch, "Trainer convnext_base", "jump_cp_cfg", over, {},
                                     {})
    del probe
    chammi_root = write_chammi_fixture(tmp, *CONVNEXT_CHAMMI_ROWS)
    pretrained = [f"++model.pretrained={path}", "++model.init_first_layer=pretrained_pad_avg"]
    pretrained_stems(torch, "chammi_cfg", ["model=shared_convnext", *pretrained,
                                           f"++dataset.root_dir={chammi_root}",
                                           f"++train.checkpoints={tmp}/stems"], path)
    for label, model, extra in (
            ("Trainer CHAMMI shared_convnext", "shared_convnext", pretrained),
            ("Trainer CHAMMI depthwiseconvnext", "depthwiseconvnext", [
                "++train.training_chunks=Allen_HPA",
                f"++model.new_channel_inits=[{','.join(CHAMMI_STRATEGIES)}]"])):
        out = os.path.join(tmp, model)
        argv = ["-cn", "chammi_cfg", f"model={model}", "++train.batch_size=64",
                "++train.num_epochs=1", "++eval.skip_eval_first_epoch=True", "++eval.umap=True",
                f"++dataset.root_dir={chammi_root}", f"++eval.root_dir={chammi_root}",
                f"++eval.feature_dir={out}/feat/{{FOLDER_NAME}}",
                f"++eval.dest_dir={out}/res/{{FOLDER_NAME}}", f"++train.checkpoints={out}/ck",
                *extra]
        print(f"== {label}: python -m diverse_channel_vit_torch.main {' '.join(argv)}",
              flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fb.reset_launches()
        with TrainerProbe(torch) as probe:
            port_main.main(argv)
        secs = time.perf_counter() - t0
        t = probe.trainer
        if any(fb.LAUNCHES.values()):
            raise AssertionError(f"{label}: the port's kernels launched: {dict(fb.LAUNCHES)}")
        steps, res = len(probe.steps), probe.evals[-1]
        novel = model == "depthwiseconvnext"
        strategies = list(CHAMMI_STRATEGIES) if novel else [None]
        scores = {s: res[("" if s is None else f"{s}/") + "knn_cosine/chammi_score"]
                  for s in strategies}
        figures = sorted(n for n in os.listdir(f"{out}/res/epoch1_seed{t.seed}")
                         if n.endswith((".png", ".npy")))
        pooling = {k: v for k, v in t.model.feature_extractor.named_parameters()
                   if k.startswith("weighted_sum_pooling")}
        ok = (steps == t.updates_per_epoch and all(np.isfinite(v) for m in probe.steps
                                                   for v in m.values())
              and all(0.0 <= v <= 1.0 for v in scores.values()) and len(figures) >= 3)
        if novel:
            moved = float(np.abs(probe.features["zero", "CP"]
                                 - probe.features["avg_2", "CP"]).max())
            ok = ok and moved > 0 and sorted(t.train_loader.quotas) == ["Allen", "HPA"]
        e = probe.epochs[1]
        print(f"phase {label}: {e['imgs_per_sec_per_chip']:.2f} images/s (Trainer steady), "
              f"{steps} steps, epoch {e['wall_s']:.3f} s; CHAMMI score {scores}; eval "
              f"{res['wall_s']:.3f} s (forward {res['split']['forward']:.3f} s, benchmark and "
              f"figures {res['split']['benchmark']:.3f} s), eval peak memory "
              f"{res['peak_gb']:.3f} GB; figures {figures}; pooling weights "
              f"{sorted(pooling)}; no kernel of the port launched; {secs:.1f} s; card "
              f"{card_line()}", flush=True)
        if not ok:
            raise AssertionError(f"{label}: a step, a score or a figure is wrong")
        del probe, t
    return chammi_root


def feature_cli(torch, root: str, tmp: str) -> dict:
    """``python -m diverse_channel_vit_torch.evaluation.feature_extraction``
    through its ``main``, with ``dinov2_jax``, ``resnet18_jax`` and
    ``convnext_jax`` from state dicts written here, on every dataset of the
    CHAMMI fixture at 224^2, into MorphEm's ``run_benchmark`` with the
    embedding figures; which of scikit-learn and matplotlib import, each
    backbone's images/s (host loading included) and CHAMMI score."""
    from diverse_channel_vit_torch.evaluation import benchmark
    from diverse_channel_vit_torch.evaluation import feature_extraction as fe

    have = {}
    for mod in ("sklearn", "matplotlib", "umap"):
        try:
            __import__(mod)
            have[mod] = True
        except ImportError:
            have[mod] = False
    print("feature extraction: " + ", ".join(f"{m} {'imports' if ok else 'missing'}"
                                             for m, ok in have.items()))
    weights = {"dinov2_jax": save_state(os.path.join(tmp, "dinov2.pth"),
                                        dinov2_state(np.random.default_rng(45))),
               "resnet18_jax": save_state(os.path.join(tmp, "resnet18.pth"),
                                          resnet18_state(np.random.default_rng(46))),
               "convnext_jax": save_state(os.path.join(tmp, "convnext_fe.pth"),
                                          timm_convnext_state(np.random.default_rng(47)))}
    out = {}
    for model in FEATURE_BACKBONES:
        feat_dir = os.path.join(tmp, "fe", model)
        n, dims = 0, {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for dataset in ("Allen", "HPA", "CP"):
            path = fe.main(["--root_dir", root, "--dataset", dataset, "--dest", feat_dir,
                            "--model", model, "--weights", weights[model], "--img_size",
                            str(IMG), "--batch_size", "64"])
            feats = np.load(path)
            if not np.isfinite(feats).all():
                raise AssertionError(f"feature extraction {model} {dataset}: not finite")
            n += len(feats)
            dims[dataset] = feats.shape[1]
        secs = time.perf_counter() - t0
        dest = os.path.join(tmp, "fe_res", model)
        df = benchmark.run_benchmark(root, dest, feat_dir, "features.npy", umap=True,
                                     knn_metric="cosine", device="cuda")
        score = benchmark.chammi_score(df)
        figures = sorted(x for x in os.listdir(dest) if x.endswith((".png", ".npy")))
        print(f"phase feature extraction {model}: {n} images in {secs:.3f} s ({n / secs:.2f} "
              f"images/s, host loading included), feature widths {dims}; CHAMMI score "
              f"{score:.4f}; figures {figures}; card {card_line()}", flush=True)
        if not (0.0 <= score <= 1.0 and len(figures) >= 3):
            raise AssertionError(f"feature extraction {model}: the benchmark or its figures "
                                 "failed")
        out[model] = n / secs
    return out


def convnext_family(fb, torch, bare: dict) -> None:
    """The ConvNeXt family, DINOv2 and the feature-extraction CLI on the card
    (ROADMAP A9, A7): each of the six models (:func:`convnext_checks`),
    DINOv2 (:func:`dinov2_checks`), ``main`` with three of them
    (:func:`convnext_trainers`) and the CLI (:func:`feature_cli`). The
    counts are set to 0 first and must read 0 at the end."""
    import tempfile

    t0 = time.perf_counter()
    fb.reset_launches()
    figures = {}
    for label, extra in CONVNEXT.items():
        figures[label] = convnext_checks(fb, torch, label, extra, bare)
    figures["depthwiseconvnext CHAMMI"] = depthwise_chammi_step(torch)
    figures["dinov2"] = dinov2_checks(torch)
    with tempfile.TemporaryDirectory(prefix="dcvit_convnext_") as tmp:
        chammi_root = convnext_trainers(fb, torch, tmp)
        figures["feature extraction images/s"] = feature_cli(torch, chammi_root, tmp)
    if any(fb.LAUNCHES.values()):
        raise AssertionError(f"convnext family: the port's kernels launched: "
                             f"{dict(fb.LAUNCHES)}")
    print(f"convnext family: {json.dumps(figures)}; no kernel of the port launched; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase f32: train.dtype=float32, the reference's precision
# ---------------------------------------------------------------------------


def f32_serving(fb, torch) -> tuple:
    """An f32 ``ServingEngine`` at buckets 1 and 64 over DiChaViT-S built
    with ``build_model``'s default dtype (f32): every block unfused, B5-f32
    x 11 per forward and no other kernel; p50 and p99 per bucket; the
    64-image logits against the plain route on the card within
    F32_LOGITS_TOL."""
    from diverse_channel_vit_torch.models import build_model
    from diverse_channel_vit_torch.serving import ServingEngine

    model = build_model("dichavit", model_config(DEPTH), {"JUMP-CP": list(range(CHANNELS))},
                        CLASSES, device="cuda", seed=0)
    blocks = model.feature_extractor.blocks
    if any(blk.dtype != torch.float32 for blk in blocks):
        raise AssertionError("f32 serving: build_model's default dtype is not f32")
    engine = ServingEngine(model, buckets=(1, B), device="cuda")
    imgs = np.random.default_rng(0).standard_normal((B, CHANNELS, IMG, IMG), dtype=np.float32)
    full = list(range(CHANNELS))
    torch.cuda.reset_peak_memory_stats()
    fb.reset_launches()
    engine.n_forwards = 0
    engine.warmup(full, (IMG, IMG))
    out64 = engine.predict(imgs, full)
    timings = {}
    for bucket, reps in ((1, 20), (B, 8)):
        lats = []
        for _ in range(reps):
            t = time.perf_counter()
            engine.predict(imgs[:bucket], full)
            lats.append(time.perf_counter() - t)
        lats = np.asarray(lats)
        timings[bucket] = {"imgs_per_s": bucket * reps / float(lats.sum()),
                           "p50_ms": float(np.percentile(lats, 50)) * 1e3,
                           "p99_ms": float(np.percentile(lats, 99)) * 1e3, "reps": reps}
    launches, forwards = dict(fb.LAUNCHES), engine.n_forwards
    check_counts("f32 serving", launches, forwards, "forward",
                 {"flash_packed_fwd_f32": DEPTH - 1})
    if out64.shape != (B, CLASSES):
        raise AssertionError(f"f32 serving: logits of shape {out64.shape}")
    with fb.plain_versions(), torch.inference_mode():
        ref = model(torch.from_numpy(imgs).cuda(), torch.arange(CHANNELS, device="cuda"))[0]
    rel_close("f32 serving", "64-image logits vs the plain route", out64, ref.cpu().numpy(),
              F32_LOGITS_TOL)
    print("f32 serving " + json.dumps({"buckets": timings}))
    phase_line("f32 serving, bucket 64", timings[B]["imgs_per_s"], timings[B]["p50_ms"], torch)
    print(f"phase f32 serving, bucket 1: p50 {timings[1]['p50_ms']:.3f} ms, p99 "
          f"{timings[1]['p99_ms']:.3f} ms; bucket 64: p50 {timings[B]['p50_ms']:.3f} ms, p99 "
          f"{timings[B]['p99_ms']:.3f} ms; card {card_line()}")
    del model, engine
    torch.cuda.empty_cache()
    return launches, forwards


def f32_card_vs_cpu(fb, torch) -> float:
    """DiChaViT-S in f32 at full width and depth, the same seeded weights on
    the card (the kernels: B5-f32 x 11) and on the CPU, 4 images: the card's
    logits within F32_LOGITS_TOL of max|logit| of the CPU's (the CPU tests
    hold the CPU path against JAX)."""
    from diverse_channel_vit_torch.models import build_model

    x = np.random.default_rng(7).standard_normal((4, CHANNELS, IMG, IMG), dtype=np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        model = build_model("dichavit", model_config(DEPTH), {"JUMP-CP": list(range(CHANNELS))},
                            CLASSES, device=dev, dtype=torch.float32, seed=0)
        before = dict(fb.LAUNCHES)
        with torch.no_grad():
            out[dev] = model(torch.from_numpy(x).to(dev),
                             torch.arange(CHANNELS, device=dev))[0].cpu().numpy()
        counts = {k: fb.LAUNCHES[k] - before[k] for k in before}
        check_counts(f"f32 forward on {dev}", counts, 1, "forward",
                     {"flash_packed_fwd_f32": DEPTH - 1} if dev == "cuda" else {})
        del model
    return rel_close("f32 forward", "logits, card (kernels) vs CPU", out["cuda"], out["cpu"],
                     F32_LOGITS_TOL)


def f32_trainer(fb, torch, step: dict) -> tuple:
    """``main`` with ``++train.dtype=float32`` on ``synthetic_cfg`` at the
    flagship geometry, 2 epochs of 256 images with an eval before and after
    each: B5-f32 and B6-f32 x 11 a step, B5-f32 x 11 an eval forward. TF32
    is turned on for matmuls and cuDNN before the call: the Trainer must
    find both off and ``main`` must leave both on again."""
    import tempfile

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with tempfile.TemporaryDirectory(prefix="dcvit_f32_") as tmp:
            over = TRAINER_OVERRIDES + ["train.num_epochs=2", "dataset.num_train_samples=256",
                                        f"train.checkpoints={tmp}", "++train.dtype=float32"]
            probe, launches, steps = run_trainer(fb, torch, "Trainer f32", "synthetic_cfg", over,
                                                 step, {"flash_packed_fwd_f32": DEPTH - 1})
        after = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    print(f"Trainer f32: TF32 (matmul, cuDNN) {probe.tf32} inside main, {after} after it")
    if probe.tf32 != (False, False) or after != (True, True):
        raise AssertionError("Trainer f32: main did not turn TF32 off for the run and restore it")
    return launches, len(probe.epochs), "epoch"


def f32_models(fb, torch, F, results: dict) -> dict:
    """Phase f32: ``train.dtype=float32`` (the reference's own precision) on
    the card, where every block takes the unfused route and B5 and B6 run
    their f32 kernels (``csrc/flash_f32.cuh``). The f32 kernels against
    their plain versions at F32_GRIDS, 6 heads of 64 and 3 of 128 (into
    ``results``, the kernels line's entries); 12 f32 train steps of
    DiChaViT-S at full width and depth, B = 64 (B5-f32 and B6-f32 x 11 a
    step, nothing else) and a profiled one; the kernel route against the
    plain route at F32_PARITY_DEPTH; the card's f32 logits against the
    CPU's; ``main`` with ``++train.dtype=float32``; an f32 ServingEngine;
    EViT (3 steps at PARITY_DEPTH over EVIT_GRIDS), PPT token pruning (a
    step at full depth over its unpadded grids) and the DCS recipe (k = 1,
    3 and 8: N 256 to 1600), each against the plain route; the small_tpu
    preset (3 heads of 128) timed and against the plain route. Returns the
    paths by label."""
    f32 = dict(dtype=torch.float32, loss_tol=F32_LOSS_TOL, grad_tol=F32_GRAD_TOL)
    t0 = time.perf_counter()
    f32_smem()
    for heads in (HEADS, HEADS_TPU):
        results.update(check_flash_kernels(torch, F, results, heads, dtype=torch.float32))
    torch.cuda.empty_cache()

    def per(n: int) -> dict:
        return {"flash_packed_fwd_f32": n, "flash_packed_bwd_f32": n}

    step, parity = per(DEPTH - 1), per(F32_PARITY_DEPTH - 1)
    paths = {}
    launches, steps, timing = train(fb, torch, "f32 train", step, dtype=torch.float32)
    paths["f32 train"] = (launches, steps, "step")
    train_parity(fb, torch, "f32 train parity", F32_PARITY_DEPTH, 2, parity, **f32)
    f32_card_vs_cpu(fb, torch)
    paths["Trainer f32"] = f32_trainer(fb, torch, step)
    paths["f32 serving"] = (*f32_serving(fb, torch), "forward")
    # EViT at PARITY_DEPTH: pruning layers 1, 2 and 3, every block on B5 / B6
    train_parity(fb, torch, "f32 EViT train parity", PARITY_DEPTH, 3, per(PARITY_DEPTH),
                 keep_rate=KEEP_RATE, **f32)
    check_grids("f32 EViT", LAST_GRIDS["f32 EViT train parity"],
                {("flash", n, nv) for n, nv in EVIT_GRIDS})
    ppt = dict(block_type="block_v2", dropout_tokens_hcs="token_pruning",
               token_keep_channels=KNOB_KC)
    train_parity(fb, torch, "f32 ppt token_pruning train parity", DEPTH, 1, per(DEPTH),
                 **ppt, **f32)
    grids = tuple(nv for _, _, nv in LAST_GRIDS["f32 ppt token_pruning train parity"])
    if grids != PPT_GRIDS["token_pruning"]:
        raise AssertionError(f"f32 ppt token_pruning train: grids {grids}")
    train_parity(fb, torch, "f32 DCS recipe train parity", F32_PARITY_DEPTH, 3, parity,
                 ks=(1, 3, 8), **f32)
    check_grids("f32 DCS recipe", LAST_GRIDS["f32 DCS recipe train parity"],
                {("flash", 256, 197), ("flash", 640, 589), ("flash", 1600, 1569)})
    tpu = dict(pretrained_model_name=TPU_PRESET, dtype=torch.float32)
    paths["small_tpu f32 train"] = (*train(fb, torch, "small_tpu f32 train", step, warm=1,
                                           timed=3, table=False, **tpu)[:2], "step")
    train_parity(fb, torch, "small_tpu f32 train parity", F32_PARITY_DEPTH, 2, parity,
                 pretrained_model_name=TPU_PRESET, **f32)
    torch.cuda.empty_cache()
    print(f"phase f32: {time.perf_counter() - t0:.1f} s; f32 step p50 {timing['p50_ms']:.3f} ms, "
          f"{timing['imgs_per_s']:.2f} images/s, peak memory {timing['peak_mem_gb']:.3f} GB; "
          f"card {card_line()}")
    return paths


def main() -> int:
    import torch
    import torch.nn.functional as F

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from diverse_channel_vit_torch.ops import fused_block as fb
    from diverse_channel_vit_torch.ops import kernels

    card = card_line()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; allow_tf32: matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn {torch.backends.cudnn.allow_tf32}")

    secs = kernels.build()
    print(f"kernel build: {secs:.1f} s")
    for name, log in kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    # the wgmma core's kernels: their registers, spills, stack frames and
    # ptxas notes (C75xx: wgmma serialised, setmaxnreg ignored)
    for name in ("attend_project", "attend_project_bwd", "flash_packed", "flash_packed_bwd",
                 "bench_attn_bwd", "qkv_flash", "ln_mlp", "ln_mlp_bwd", "ln_mlp_q",
                 "ln_mlp_q_bwd"):
        for line in kernels.BUILD_LOG.get(name, "").splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "stack frame", "C75")):
                print(f"  ptxas {name}: {line.strip()}")

    results = check_kernels(fb, torch, F)
    results.update(check_bwd_kernels(fb, torch, F))
    results.update(check_flash_kernels(torch, F, results))
    results.update(check_q_kernels(fb, torch, F, kernels))
    results.update(check_script_kernels(fb, torch, F))
    # the attention kernels at head width 128: the small_tpu preset's 3 heads
    rnd = _rnd(torch, torch.Generator(device="cuda").manual_seed(10))
    results[kernel_name("attend_project_fwd", HEADS_TPU)] = check_attend_project_fwd(
        fb, torch, F, HEADS_TPU, rnd)
    results[kernel_name("attend_project_bwd", HEADS_TPU)] = check_attend_project_bwd(
        fb, torch, F, HEADS_TPU, rnd)
    results.update(check_flash_kernels(torch, F, results, HEADS_TPU))
    results.update(check_script_kernels(fb, torch, F, HEADS_TPU))
    # the base preset's widths: B3 and B4 at D = 768, B1 and B2 with 12 heads
    # of 64
    rnd = _rnd(torch, torch.Generator(device="cuda").manual_seed(12))
    results[width_name("ln_mlp_fwd", D_BASE)] = check_ln_mlp_fwd(fb, torch, F, rnd, D_BASE,
                                                                HID_BASE)
    results[width_name("ln_mlp_bwd", D_BASE)] = check_ln_mlp_bwd(fb, torch, F, rnd, D_BASE,
                                                                HID_BASE)
    results[kernel_name("attend_project_fwd", HEADS_BASE, D_BASE)] = check_attend_project_fwd(
        fb, torch, F, HEADS_BASE, rnd, D_BASE)
    results[kernel_name("attend_project_bwd", HEADS_BASE, D_BASE)] = check_attend_project_bwd(
        fb, torch, F, HEADS_BASE, rnd, D_BASE)
    # B7 and B8 at D = 768 (a cluster of two blocks per 64 rows each)
    results.update(check_q_kernels(fb, torch, F, kernels, D_BASE, HID_BASE, seed=13))
    torch.cuda.empty_cache()
    stamp("kernel checks", t_start)
    # phase f32: train.dtype=float32, B5 and B6 in f32 (their kernels' checks
    # join the kernels line)
    paths = f32_models(fb, torch, F, results)
    stamp("f32 models", t_start)
    for name, r in results.items():
        # each product at the unit that runs it: bf16 FLOPs and int8 operations
        t_ops = (r.pop("flops") / PEAK_BF16_FLOPS + r.pop("int8_ops", 0) / PEAK_INT8_OPS
                 + r.pop("tf32_flops", 0) / PEAK_TF32_FLOPS)
        t_bytes = r.pop("bytes") / PEAK_BYTES
        r["bound_ms"] = max(t_ops, t_bytes) * 1e3
        r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        lib = "not measured" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")

    # each path: the counts by kernel and the units (forwards or steps) they
    # were read over; the kernels line takes each kernel's launches from its
    # main paths
    fused4 = ("attend_project_fwd", "ln_mlp_fwd", "attend_project_bwd", "ln_mlp_bwd")
    evit4 = {**dict.fromkeys(fused4, DEPTH - 4), "flash_packed_fwd": 3, "flash_packed_bwd": 3}
    int8_train = ("attend_project_fwd", "attend_project_bwd", "ln_mlp_q_fwd", "ln_mlp_q_bwd")
    paths["serving"] = (*serve(fb, torch), "forward")
    torch.cuda.empty_cache()
    paths["EViT serving"] = (*serve_evit(fb, torch)[:2], "forward")
    serve_gelu_exact(fb, torch)
    launches, steps, bare = train(fb, torch, "train", dict.fromkeys(fused4, DEPTH - 1))
    paths["train"] = (launches, steps, "step")
    train_parity(fb, torch, "train parity", PARITY_DEPTH, 3,
                 dict.fromkeys(fused4, PARITY_DEPTH - 1))
    paths["EViT train"] = (*train(fb, torch, "EViT train", evit4, keep_rate=KEEP_RATE)[:2],
                           "step")
    # at PARITY_DEPTH the pruning layers are 1, 2 and 3: block 0 fused, no readout
    evit_parity = {**dict.fromkeys(fused4, 1), "flash_packed_fwd": 3, "flash_packed_bwd": 3}
    train_parity(fb, torch, "EViT train parity", PARITY_DEPTH, 3, evit_parity,
                 keep_rate=KEEP_RATE)
    train_parity(fb, torch, "gelu_exact train parity", GELU_PARITY_DEPTH, 1,
                 {"flash_packed_fwd": GELU_PARITY_DEPTH - 1,
                  "flash_packed_bwd": GELU_PARITY_DEPTH - 1}, gelu_exact=True)
    # int8: B7 / B8 in place of B3 / B4 in every fused block
    paths["int8 serving"] = (*serve_int8(fb, torch)[:2], "forward")
    paths["int8 train"] = (*train(fb, torch, "int8 train", dict.fromkeys(int8_train, DEPTH - 1),
                                  quantization="int8")[:2], "step")
    train_parity(fb, torch, "int8 train parity", PARITY_DEPTH, 3,
                 dict.fromkeys(int8_train, PARITY_DEPTH - 1), quantization="int8")
    # the DCS recipe: k of 8 channels per step, B1-B4 in every fused block
    paths["DCS recipe train"] = (*train_recipe(fb, torch, dict.fromkeys(fused4, DEPTH - 1))[:2],
                                 "step")
    train_parity(fb, torch, "DCS recipe train parity", PARITY_DEPTH, 3,
                 dict.fromkeys(fused4, PARITY_DEPTH - 1), ks=(2, 5, 8))
    torch.cuda.empty_cache()
    stamp("small preset serving and training", t_start)

    # the small_tpu preset (3 heads of 128) at full width and depth, as the
    # JAX bench's mxu_native, int8_dh128 and dh-128 EViT recipe cells: every
    # attention kernel at head width 128
    tpu = dict(pretrained_model_name=TPU_PRESET)
    paths["small_tpu serving"] = (*serve(fb, torch, "small_tpu serving", **tpu), "forward")
    torch.cuda.empty_cache()
    paths["small_tpu train"] = (*train(fb, torch, "small_tpu train",
                                       dict.fromkeys(fused4, DEPTH - 1), **tpu)[:2], "step")
    train_parity(fb, torch, "small_tpu train parity", PARITY_DEPTH, 3,
                 dict.fromkeys(fused4, PARITY_DEPTH - 1), **tpu)
    paths["small_tpu DCS recipe train"] = (*train_recipe(
        fb, torch, dict.fromkeys(fused4, DEPTH - 1), "small_tpu DCS recipe train", **tpu)[:2],
        "step")
    paths["small_tpu int8 train"] = (*train(
        fb, torch, "small_tpu int8 train", dict.fromkeys(int8_train, DEPTH - 1),
        quantization="int8", **tpu)[:2], "step")
    train_parity(fb, torch, "small_tpu int8 train parity", PARITY_DEPTH, 3,
                 dict.fromkeys(int8_train, PARITY_DEPTH - 1), quantization="int8", **tpu)
    paths["small_tpu EViT recipe train"] = (*train_recipe(
        fb, torch, evit4, "small_tpu EViT recipe train", keep_rate=KEEP_RATE, **tpu)[:2],
        "step")
    train_parity(fb, torch, "small_tpu EViT recipe train parity", PARITY_DEPTH, 3, evit_parity,
                 ks=(2, 5, 8), keep_rate=KEEP_RATE, **tpu)
    torch.cuda.empty_cache()
    stamp("small_tpu preset", t_start)

    # the base preset (DiChaViT-B) at full width and depth: serving, train,
    # and the 3-step parity at depth 4, in bf16 and in int8 (B7 / B8 at D =
    # 768); then the geometry smoke
    base = dict(pretrained_model_name=BASE_PRESET)
    paths["base serving"] = (*serve(fb, torch, "base serving", **base), "forward")
    torch.cuda.empty_cache()
    paths["base train"] = (*train(fb, torch, "base train", dict.fromkeys(fused4, DEPTH - 1),
                                  **base)[:2], "step")
    train_parity(fb, torch, "base train parity", PARITY_DEPTH, 3,
                 dict.fromkeys(fused4, PARITY_DEPTH - 1), **base)
    paths["base int8 serving"] = (*serve_int8(fb, torch, "base int8 serving", **base)[:2],
                                  "forward")
    paths["base int8 train"] = (*train(fb, torch, "base int8 train",
                                       dict.fromkeys(int8_train, DEPTH - 1),
                                       quantization="int8", **base)[:2], "step")
    train_parity(fb, torch, "base int8 train parity", PARITY_DEPTH, 3,
                 dict.fromkeys(int8_train, PARITY_DEPTH - 1), quantization="int8", **base)
    torch.cuda.empty_cache()
    stamp("base preset", t_start)
    paths.update(run_geometries(fb, torch, dict.fromkeys(fused4, DEPTH - 1)))
    # the benchmark scripts: S1-S3 run only there, S1 and S2 also at 3 heads
    for (name, args, _), counts in zip(SCRIPT_RUNS, run_scripts(fb).values()):
        paths[script_label(name, args)] = (counts, 1, "run")
    # the training entry point: main -> config -> data -> Trainer -> eval ->
    # checkpoint, at full width
    stamp("geometries and benchmark scripts", t_start)
    paths.update(trainer_paths(fb, torch, bare["imgs_per_s"]))
    stamp("trainer paths", t_start)
    # the Trainer's runtime: DropPath, MIRO, freezing, SWAD, the attention
    # maps, the profiler trace, preemption and resume
    paths.update(trainer_runtime(fb, torch, bare))
    stamp("trainer runtime", t_start)
    # the last training knobs: the samplers, the optimizers, PPT, HCS
    # dropout, main with them, the C7 check
    paths.update(training_knobs(fb, torch, bare))
    stamp("training knobs", t_start)
    # the paper's baseline ViTs: serving, training and their parity at full
    # width, fused_block false, an int8 baseline (their main runs are in
    # trainer_paths); B1-B4 at the baselines' and the smaller geometries'
    # grids
    for name, grids in check_baseline_grids(fb, torch).items():
        results[name]["baseline_grids"] = grids
    paths.update(baselines(fb, torch, bare))
    stamp("baselines", t_start)
    # the ConvNeXt family, DINOv2 and the feature-extraction CLI: no kernel
    # of the port on their paths (the kernels line is unchanged)
    convnext_family(fb, torch, bare)
    stamp("convnext family", t_start)

    # each kernel's main paths, first the one its launches are read from
    dh128 = "_dh128"
    main_paths = {
        "attend_project_fwd": ("serving", "train"),
        "ln_mlp_fwd": ("serving", "train"),
        "attend_project_bwd": ("train",),
        "ln_mlp_bwd": ("train",),
        "flash_packed_fwd": ("EViT serving", "EViT train"),
        "flash_packed_bwd": ("EViT train",),
        "ln_mlp_q_fwd": ("int8 serving", "int8 train"),
        "ln_mlp_q_bwd": ("int8 train",),
        "bwd_call": (script_label(*SCRIPT_RUNS[1][:2]),),
        "qkv_flash_fwd": (script_label(*SCRIPT_RUNS[4][:2]),),
        "int8_ln_mlp": (script_label(*SCRIPT_RUNS[5][:2]),),
        "attend_project_fwd" + dh128: ("small_tpu serving", "small_tpu train",
                                       "small_tpu int8 train"),
        "attend_project_bwd" + dh128: ("small_tpu train", "small_tpu int8 train"),
        "flash_packed_fwd" + dh128: ("small_tpu EViT recipe train",),
        "flash_packed_bwd" + dh128: ("small_tpu EViT recipe train",),
        "bwd_call" + dh128: (script_label(*SCRIPT_RUNS[6][:2]),),
        "qkv_flash_fwd" + dh128: (script_label(*SCRIPT_RUNS[7][:2]),),
        width_name("ln_mlp_fwd", D_BASE): ("base serving", "base train"),
        width_name("ln_mlp_bwd", D_BASE): ("base train",),
        kernel_name("attend_project_fwd", HEADS_BASE, D_BASE): ("base serving", "base train"),
        kernel_name("attend_project_bwd", HEADS_BASE, D_BASE): ("base train",),
        width_name("ln_mlp_q_fwd", D_BASE): ("base int8 serving", "base int8 train"),
        width_name("ln_mlp_q_bwd", D_BASE): ("base int8 train",),
        "flash_packed_fwd_f32": ("f32 serving", "f32 train"),
        "flash_packed_bwd_f32": ("f32 train",),
        "flash_packed_fwd_f32" + dh128: ("small_tpu f32 train",),
        "flash_packed_bwd_f32" + dh128: ("small_tpu f32 train",),
    }
    d768 = f"_d{D_BASE}"
    line = []
    for name, r in results.items():
        counter = name
        for suffix in (dh128, d768):
            counter = counter[:-len(suffix)] if counter.endswith(suffix) else counter
        entry = {"name": name, "route": "cuda", "source": r["source"], "replaces": r["replaces"]}
        first, *rest = main_paths[name]
        counts, units, unit = paths[first]
        entry.update(launches=counts[counter], launches_in=first,
                     **{f"launches_per_{unit}": counts[counter] / units})
        for label in rest:
            counts, units, unit = paths[label]
            entry[f"launches_per_{unit}_{label.replace(' ', '_')}"] = counts[counter] / units
        if name in fused4:
            for label in ("EViT train", "DCS recipe train"):
                counts, units, _ = paths[label]
                entry[f"launches_per_step_{label.replace(' ', '_')}"] = counts[name] / units
        for label in ("Trainer", "Trainer int8", "Trainer runtime", "Trainer training knobs",
                      "Trainer CIFAR-10", "Trainer f32",
                      *(p for p in paths if p.startswith(("runtime ", "samplers ",
                                                          "optimizers ", "ppt ",
                                                          "hcs_dropout ", "baselines ",
                                                          "Trainer baselines ")))):
            counts, units, unit = paths[label]
            if name in counts and counts[name]:
                entry[f"launches_per_{unit}_{label.replace(' ', '_')}"] = counts[name] / units
        for label in ("Trainer CHAMMI", "Trainer novel channels", "Trainer CHAMMI subset"):
            counts, units, _ = paths[label]
            if counts.get(name):
                # the run's launches: per step (CHAMMI: one micro-batch a
                # chunk) and per eval forward
                tag = label.replace(" ", "_")
                entry.update({f"launches_{tag}": counts[name], f"{tag}_steps": units,
                              f"{tag}_eval_forwards": counts["eval_forwards"]})
        if "code_flips" in r:
            entry.update(code_flips=r["code_flips"])
        entry.update(max_abs_err=r["max_abs_err"], rel_err=r["rel_err"],
                     tolerance=r.get("tolerance", KERNEL_REL_TOL), ms=r["ms"], kernel_ms=r["ms"],
                     plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                     library_ms=r["library_ms"])
        for key in ("per_grid", "per_variant", "sibling_max_abs_diff", "b6_max_abs_diff",
                    "sibling_code_share", "sibling_ms", "sub_ms", "baseline_grids"):
            if key in r:
                entry[key] = r[key]
        line.append(entry)
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
