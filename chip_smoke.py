#!/usr/bin/env python3
"""Drive the lfb_tpu_torch port once on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; without a CUDA device, or
away from the rest of the repository, it exits non-zero before printing any
result):

1. Print the card's name and power limit, and what the host has of the
   modules a data layer could use (found without importing them); then
   build the CUDA kernels of
   ``lfb_tpu_torch/csrc`` and print the build time, ptxas's registers,
   spills and wgmma notes, and the tensor-core instructions (HMMA, HGMMA)
   that ``cuobjdump -sass`` finds in each attention kernel, the stem
   forward and weight gradient and the fused bottleneck: the bf16 ones
   must have some, and the attention kernels and the stem forward HGMMA
   (``wgmma``), with no note from ptxas that it serialised their wgmma.
2. Hold each kernel against its plain PyTorch version on the card, at the
   flagship shapes (every attention regime, and the EPIC FBO-NL's decode
   shapes; the fused bottleneck at every identity-block shape of R101 at
   crop 256), and time both (median of
   CUDA-event timings, taken in turns), with one PyTorch call that computes
   the same function where there is one (``F.conv3d`` for the stem,
   ``F.scaled_dot_product_attention`` for attention, under the first of its
   backends that takes the shape; beside the fused bottleneck, the same
   block as the unfused bf16 path runs it), timed both ways (its device
   time as the kernel's: ``library_device_ms``), and the kernel's bound: the
   larger of its operations over the card's peak for their type and its
   bytes over the memory rate.  Each kernel's device time is taken apart
   too (:func:`device_ms`: 20 calls back to back, enqueued while the card
   sleeps), since a timing from an idle card also holds the wrapper's host
   work.  The stem forward is also timed, and its rate logged, at the
   train step's shape; the RoI forward also at the AVA dataset's layout
   (``TPU.MAX_BOXES_PER_CLIP`` 32 rows a clip, 1-6 of them boxes, the rest
   zero rows of clip 0: 512 rows a batch).  Each bf16 attention regime
   (res3, res4) logs the kernel's device ms and TFLOP/s beside SDPA's
   device ms, holds the row log-sum-exp to ``torch.logsumexp`` and checks
   that two calls give bitwise the same out and lse.  The frozen affine's
   kernels are held bit for bit, forward and backward, at a main-path site
   of each variant (:func:`check_affine`).
3. Hold the full-width model on the card (f32, kernels) against the same
   model on the CPU (f32, plain versions) on one clip: the flagship,
   Charades with the fused bottleneck, and EPIC verb with it.
4. The flagship main path at full width: ``flagship_cfg()`` (R101-I3D-NL,
   3-layer FBO-NL, 300-row windows, T 32, crop 256), 16 clips x 4 boxes per
   batch, seeded perturbed weights, uint8 frames.  Phase A runs the bank
   extraction entry point (``extract_ava_bank``) over 2 batches, which
   returns the host bank; synthetic rows top it up to AVA scale (235 videos
   x 897 s, Poisson(2) rows per second); the bank goes to the card.  Phase B
   runs 3 batches of the eval step with that bank, then the same 3 batches
   again with ``TPU.PALLAS_BOTTLENECK`` (the fused identity blocks), whose
   prob must be within 2e-2 of the unfused prob and of the f32 model's.  Each kernel's launch
   counter is reset before the phase and must read exactly its launches per
   forward times the batches after it (no backward kernel runs).
5. The Charades main path at full width: ``charades_cfg()`` with
   ``TPU.PALLAS_BOTTLENECK`` (R101-I3D-NL without res5 dilation, clip-level
   head, 157 classes, 2-layer post-act FBO-NL over 20-row windows), 16 clips
   per batch.  Phase A runs ``extract_frame_bank`` over 2 batches;
   synthetic rows top the frame-level bank up to the Charades val split
   (1,814 videos of 15-45 s at 24 fps, a row every 12 frames); the
   ``FrameDeviceBank`` goes to the card; phase B runs 3 batches of the eval
   step with windows from ``gather_centers``.  Launches are checked as in 4.
6. EPIC verb: ``epic_verb_cfg`` (``configs/epic_verb_r50_lfb_nl.yaml`` read
   by the port's ``load_config``) with ``TPU.PALLAS_BOTTLENECK``: R50-I3D-NL,
   125 softmax classes, 2-layer pre-act FBO-NL over 40-row windows.  Phase A
   runs ``extract_frame_bank(..., 'epic')`` over 2 batches of clips named by
   video; synthetic rows top the bank up to the val split (50 videos of
   P26-P31, 2-16 min at 30 fps, a row a second); it goes to the card keyed
   by ``video_name_to_idx``; phase B runs 3 batches.  Launches are checked
   as in 4, softmax rows must sum to 1.
7. EPIC noun: ``epic_noun_cfg`` (unfused), phase B only: a synthetic
   detector bank (0-10 boxes a second over the same videos) goes through
   ``write_lfb``, ``LFB.LOAD_LFB_PATH`` set by ``merge_cfg_from_list``,
   ``load_lfb`` and ``build_device_bank``; 3 batches with 120-row windows.
8. The checkpoint layer on the card: the EPIC verb params and momentum
   saved and loaded back bitwise; a K400-style pretrained pickle (BN
   statistics, momentum, 400 classes, a 2-D stem) converted into the EPIC
   verb model, and one forward on it.
9. Hold each backward kernel against its plain PyTorch version at the
   flagship train shapes (B = 8 clips x 4 boxes, T 32, crop 224), the RoI
   forward at that shape too, and the forward attention kernel's row
   log-sum-exp against ``torch.logsumexp``;
   time both, with the library call and the bound, as in phase 2 (cuDNN's
   weight gradient for the stem; SDPA's backward, its forward + backward
   less its forward, for attention; per bf16 regime the kernels' device ms
   and TFLOP/s beside SDPA's backward), and check that two calls of the
   attention backward give bitwise the same dq, dk and dv.
10. One full-width f32 train step (1 clip x 4 boxes, dropout 0) on the card
    (kernels) against the same step on the CPU (plain versions), from the
    same params: the loss and every momentum buffer.
11. The train phase: ``make_train_step`` of ``build_spec(flagship_cfg(),
    'train')`` (crop 224, dropout 0.3 / 0.2, ``TPU.REMAT ''``), bf16 compute
    with f32 master weights, 8 clips x 4 boxes of uint8 frames per step, bank
    windows drawn from phase 4's AVA-scale device bank with a per-step
    generator: 2 warm-up and 5 timed steps, each with its launch counts
    checked, a finite loss, and nonzero momentum after it.  Then the
    released global batch, 16 clips, 2 warm-up and 5 timed steps under
    ``TPU.REMAT`` 'stage' and under '' from the same params, batches and
    generators: the launches per step ('stage' runs the 5 backbone
    attention forwards again in the backward: 13 a step), ms per step,
    clips/s and the peak memory of each; the first step's loss under
    'stage' within 2e-2 of ''s (bf16) and within 1e-6 on one f32 clip; a
    lower peak under 'stage'.  Then Charades stage 2
    (``MODEL.FREEZE_BACKBONE``, 'stage') at 16 clips with windows from phase
    5's frame bank: 1 warm-up and 3 timed steps, no stem weight gradient,
    the attention backward only for the 2 FBO layers, momentum only on the
    head and the backbone unchanged.  Then EPIC verb stage 2
    (``epic_verb_cfg``, R50, ``TPU.REMAT ''``, B = 16, crop 224, dropout
    0.3) with windows from phase 6's bank: 1 warm-up and 3 timed steps, the
    launches of each (attention 7 forward and 7 backward, the stem and its
    weight gradient), a finite loss and momentum on conv1 and the
    classifier.
12. The flagship from JPEG frames on disk, through the entry points a user
    runs.  A synthetic AVA split in the reference's file formats goes into a
    temporary directory under ``build/`` (:func:`write_ava_split`: 16 videos
    x 510 JPEG frames of 640 x 360 at 30 fps over secs 900-916, keyframes at
    902-913 with 1-6 predicted boxes each, scores uniform over 0.8-1.0, GT
    boxes with 1-3 classes, the labelmap, an empty exclusions file), with
    seeded weights saved by ``save_params``.
    ``lfb_tpu_torch.tools.test_net.main`` runs on it with
    ``configs/ava_r101_lfb_nl_3l.yaml``, ``NUM_GPUS 1``, ``TPU.REMAT ''``,
    ``TPU.DEVICE_BANK True``, ``LFB.WRITE_LFB True`` and the split's paths:
    the bank sweep (``get_lfb``), FBO inference over the device bank, the
    detections CSV and the frame-mAP, 10 batches of 16 clips (the bank
    sweep) and 12 (the test sweep), two to three times the loader's
    prefetch window of 4; then
    ``tools.lfb_loader.main`` with ``LFB.LOAD_LFB`` reads the written
    ``val_lfb.pkl`` back.  Checks: the bank holds one finite 2048-d row per
    predicted box at or above 0.9, keyed by (video, sec), and the rows of
    the last batch's padding (lfb_tpu's sweep keeps them); the detections
    CSV one line per (box at or above 0.85, class); the frame-mAP is finite
    and in [0, 1]; the launch counters read each sweep's forwards times its
    launches per forward (as phase 4's A and B); both sweeps ran on the card;
    ``lfb_loader`` read the bank back bitwise.  Printed for each sweep: the
    whole sweep's seconds and clips/s, the first batch's ms; then, over the
    batches after the first and again over those after the first prefetch
    window (the steady state, which the loader began only once the sweep
    had taken a batch), ms per batch, clips/s, the host's time per batch
    (decode + transforms on the loader's thread, waiting for the batch,
    ``to_device``), the card's time per batch between CUDA events around
    each step and its busy share, with ``os.cpu_count()`` and
    ``DATALOADER.NUM_WORKERS``; then the ms per batch of each sweep's first
    4 batches held on the card, and the RoI forward on the rows of the
    first test batch against its plain version.
13. Stage-2 training from the same JPEG frames (the split has train lists
    too) through ``lfb_tpu_torch.tools.train_net.main`` with the flagship
    YAML, ``NUM_GPUS 1``, ``TPU.DEVICE_BANK True``, ``TPU.REMAT`` left at
    its 'stage', 16 clips a step at crop 224 and dropout 0.3: both bank
    sweeps with phase 12's baseline pickle, then 8 steps from a K400-style
    R101 pickle (``CONVERT_MODEL``, ``RESET_START_ITER``) with a warm-up to
    iteration 3 and an LR step at 5, checkpoints at 4 and 8 and the
    train-time eval at 8; then the same command with ``SOLVER.MAX_ITER 10``
    resumes at 8 (the banks read back from their pickles) and tests the
    last checkpoint.  Checks: finite bank rows in both pickles; the
    checkpoints 4, 8 and 10; the resumed run's start at 8 with the params
    and momentum of ``c2_model_iter8.pkl`` bitwise; a finite loss at every
    step; each step's LR and every momentum rescale as ``lfb_tpu`` makes
    them; a frame-mAP in [0, 1] and a detections CSV from the eval and the
    test; the launch counters (the sweeps' forwards times their launches
    per forward, plus the steps times 'stage''s per step); every parameter
    and momentum buffer on the card.  Printed: each part's seconds, the ms
    per step from disk after the first prefetch window (steps without a
    checkpoint or eval), the host's waiting, the card's busy share, the
    peak memory, beside phase 11's ms per step from memory.
14. Data parallelism (``lfb_tpu_torch.parallel``) on the one card: (a)
    phase 11's 'stage' steps at B = 16 again, from the same params, batches
    and generators, through the data-parallel step in an NCCL group of one
    rank, with phase 4's bank replicated and then row-sharded
    (``TPU.BANK_SHARDED``), held to phase 11's within
    ``REMAT_BF16_BOUNDS``, ms per step beside phase 11's; (b) two ranks
    spawned on the card in a gloo group (NCCL refuses two ranks on one
    card; gloo moves the collectives through the host, so its times are no
    multi-GPU speed): the flagship 'stage' step (dropout off) at the global
    B = 16, 8 clips a rank, on batches whose halves hold 32 and 16 valid
    boxes, against one process at B = 16 (``REMAT_BF16_BOUNDS``), each
    rank's launches per step those of one process; a row-sharded bank's
    windows bitwise those of the whole table; then ``get_lfb`` over phase
    12's split at world 2 against phase 12's bank (the same keys, rows
    within ``DP_BANK_BOUND``).  ``tools.train_net`` on two ranks is
    left to the CPU tests (``tests/test_torch_parallel_tools.py``): on
    ``cuda`` the command lines take NCCL, one rank a card.
15. True-BN training (``MODEL.USE_AFFINE False`` with true-BN non-local
    blocks, ``lfb_tpu``'s default) of the flagship at full width, seeded
    perturbed weights with running statistics: (a) one f32 step (1 clip x
    4 boxes, dropout 0) on the card against the same step on the CPU (the
    loss, updated params, running statistics and, as a whole, the momentum
    within ``TRUE_BN_F32_BOUNDS``); (b) at the released B = 16, crop 224, bf16,
    with ``TPU.REMAT 'stage'`` set, 1 warm-up and 3 timed steps: the launch
    counters read remat off (8 attention forwards a step, not 13), ms per
    step, the peak memory; (c) ``compute_precise_bn_stats`` over 4 of those
    batches, ms per iteration, then one eval forward with the new
    statistics in bf16 within ``TRUE_BN_EVAL_BOUND`` of the same forward in
    f32; (d) two gloo ranks on the card, 2 f32 true-BN steps at a global 2
    clips against one process's (running statistics and params within
    ``TRUE_BN_DP_BOUND`` of each tensor's largest value, the momentum as a
    whole within ``TRUE_BN_F32_BOUNDS``).
16. The parity harness: ``python -m lfb_tpu_torch.tools.parity_eval
    --dryrun DIR`` (its ``main``, in process) over its five configs on
    ``cuda``, the flagship through multi-crop testing with its bank
    inferred again for each flip; each config timed, ``DRYRUN SUMMARY:
    5/5`` asserted.
17. The on-card tools (:func:`tools_phase`): (a) ``python -m
    lfb_tpu_torch.tools.gpu_smoke`` in a subprocess, its nine PASS lines
    and its pass line last; (b) ``tools.mfu_probe``'s grid (the train-mode
    forward with its loss at B 8 / 16 x crop 224 / 256, its launch
    counters checked), conv (each backbone op alone, at three regimes) and
    flat modes at full width, in process, their tables printed under the
    card's name and power limit; (c) the cost model's count of the (8, 224)
    forward within 2% of ``GRID_TF``, every per-op entry above the card's
    peak marked INVALID, the flat rewrite within its 2e-2; (d) a
    diagnostic, logged and not bounded: two f32 train steps from one state
    in a subprocess, as run and under deterministic algorithms, whether
    they agree bitwise and which ops have no deterministic implementation.
18. The real-scale bank rehearsal (:func:`rehearsal_phase`, the functions
    of ``lfb_tpu_torch.tools.bank_rehearsal`` in process, on its config:
    the JAX tool's flagship, unfused): (a) AVA at 235 videos (3.2 GiB f32,
    rows tiled by ``fast_fill``), the f32 and the bf16 bank built, each
    with its inference ladder at T 32, crop 256 (``REHEARSAL_INFER``: the
    top rung cannot fit on 80 GB and must run out of memory, the rungs
    below find the largest batch that fits); with the f32 bank also the
    extract ladder (phase A) and the train ladder (``REHEARSAL_TRAIN``,
    ``TPU.REMAT ''``); (b) the bf16 bank's bytes exactly half the f32
    bank's, and its prob on one batch within ``BF16_BANK_BOUND`` of the f32
    bank's; (c) the f32 bank row-sharded in a one-rank NCCL group: the
    inference ladder at the fitting batch, and (b)'s batch again, bitwise
    the unsharded prob (else held at 1e-6); (d) Charades at the train
    split's scale (9,800 videos, 4.1 GiB, every row drawn), a table width
    of 600, its inference and train ladders.  After every rung that ran out
    of memory the allocator must hold no more than ``REHEARSAL_OOM_SLACK``
    over what it held before the rung; the launch counters of each fitting
    rung, run alone, read its forwards exactly.  The reports are printed as the tool prints them, each headed
    by the card's name and power limit.

TF32 is off for matmuls and cuDNN convolutions throughout, so the plain
versions the kernels are compared with compute in full f32.

The second-to-last line is a JSON object with one entry per kernel (its
launches on the main path, max_abs_err, ms, device_ms, plain_ms, bound_ms,
bound_by, library_ms and library_device_ms, null where no one PyTorch
call computes the same function);
the last line is ``{"ok": true, "device": {...}}``.

OpenCV is imported only by phase 12 (and by the port's data layer, at
first use).

The bounds come from the benchmark's frozen cost model
(:mod:`gpubench.cost.kernels`).  Where the time of a cell goes is the
benchmark's to trace: ``python3 -m gpubench.run --trace 1`` and
``python3 -m gpubench.spans``.
"""

import json
import os
import queue
import statistics
import subprocess
import sys
import time

import numpy as np

from gpubench.cost import kernels as cost
from lfb_tpu_torch.tools.mfu_probe import card_line

SEED = 0
B, BOXES_PER_CLIP = 16, 4
EXTRACT_BATCHES, INFER_BATCHES = 2, 3
TRAIN_B, TRAIN_WARMUP, TRAIN_STEPS = 8, 2, 5
# Phase 11's steps at the released global batch, under each TPU.REMAT mode,
# and Charades stage 2 (FREEZE_BACKBONE).
REMAT_B, REMAT_MODES = 16, ('stage', '')
# Bounds of the 'stage' steps against the '' steps, relative to each
# tensor's largest value, several times the largest gaps read on an H100:
# over phase 11's 7 steps in bf16, the losses (read up to 1.8e-4), the
# updated params (5.4e-4) and the momentum (3.2e-2, a small bias's
# buffer); after one f32 step of one clip, the params (8.1e-8) and the
# momentum (3.2e-6).  The two modes differ only by the order of f32 sums in
# the library kernels' backward (two f32 runs under '' differ as much), which
# bf16 and the ReLU gates amplify step by step.  A region recomputed
# wrongly, or a gradient lost in one, moves a tensor by its whole scale.
REMAT_BF16_BOUNDS = (1e-3, 5e-3, 2e-1)
REMAT_F32_BOUNDS = (1e-6, 3e-5)
CHARADES_TRAIN_WARMUP, CHARADES_TRAIN_STEPS = 1, 3
EPIC_TRAIN_WARMUP, EPIC_TRAIN_STEPS = 1, 3
# Phase 14 (b): two ranks on the one card, 3 steps at the global B = 16.
DP_WORLD, DP_STEPS = 2, 3
# Rows of phase 14 (b)'s bank sweep at world 2 against phase 12's at world
# 1, relative to the largest: bf16 through R101 at another batch (8 clips a
# rank, not 16), where cuDNN may take other algorithms.
DP_BANK_BOUND = 2e-3
# Phase 15: true-BN training (lfb_tpu's default, MODEL.USE_AFFINE False with
# true-BN non-local blocks), at B = 16 under TPU.REMAT 'stage' (which true BN
# turns off), precise BN over 4 of its batches, two gloo ranks on the card.
TRUE_BN = {'MODEL.USE_AFFINE': False, 'NONLOCAL.USE_AFFINE': False,
           'NONLOCAL.USE_BN': True}
TRUE_BN_WARMUP, TRUE_BN_STEPS, PRECISE_BN_ITERS = 1, 3, 4
# The f32 steps of (a) and (d): no dropout (the card and the CPU, or the
# ranks and one process, draw other masks).
F32_STEP = {'TPU.COMPUTE_DTYPE': 'float32', 'TRAIN.DROPOUT_RATE': 0.0,
            'FBO_NL.DROPOUT_RATE': 0.0}
# Under true BN a bias that a batch-statistics BN follows has an exact
# gradient of zero, as ``*_phi_b`` always has: the non-local blocks'
# ``*_out_b`` (the BN after the output conv subtracts its shift) and
# ``*_g_b`` (the softmax rows sum to 1, so it shifts every output alike).
TRUE_BN_ZERO_GRAD = ('_phi_b', '_out_b', '_g_b')
# (a), one f32 step of one clip on the card against the CPU: the loss, the
# updated params and the running statistics, each tensor against its
# largest CPU value, and the momentum as a whole (its relative L2
# distance).  A random deep BN net's gradients are chaotic: scaling the
# weights by one f32 rounding step (NUDGE) moves single momentum buffers by
# up to 1.1e-1 of their largest value on the card, so each buffer's gap is
# logged beside that floor, not bounded; over all buffers the nudge moves
# the momentum by 2.6e-4 (relative L2) and the CPU is 1.0e-4 away (PR 12),
# where a wrong statistic or gradient moves it by its own scale.
TRUE_BN_F32_BOUNDS = {'loss': 1e-4, 'params': 1e-4, 'stats': 1e-3,
                      'momentum': 1e-3}
NUDGE = 2 ** -22
# (c) the eval forward in bf16 against f32 (phase 4's bound for bf16); (d)
# two ranks against one process: the losses, and each param and running
# statistic against its largest value, TRUE_BN_DP_BOUND; the momentum's
# relative L2 distance (1.7e-4 on the card, the nudge's 1.4e-4),
# TRUE_BN_F32_BOUNDS['momentum'].
TRUE_BN_EVAL_BOUND, TRUE_BN_DP_BOUND = 2e-2, 1e-4
AVA_VIDEOS = 235
CHARADES_VIDEOS = 1814                  # TEST.DATASET_SIZE, the val split
CHARADES_FRAMES = (15 * 24, 45 * 24)    # video lengths, 30 s on average
CHARADES_ROW_EVERY = 12                 # 24 fps / 2 bank clips per second
# EPIC-Kitchens' val split: persons P26-P31 (lfb_tpu/data/epic.py), about 50
# videos of 2-16 min at 30 fps, 7.4 h in all; the verb bank has a row a
# second, the noun (detector) bank 0-10 boxes a second.
EPIC_PERSONS = ('P26', 'P27', 'P28', 'P29', 'P30', 'P31')
EPIC_VIDEOS = 50
EPIC_FPS = 30
EPIC_FRAMES = (2 * 60 * EPIC_FPS, 16 * 60 * EPIC_FPS)
EPIC_TOTAL_FRAMES = int(7.4 * 3600 * EPIC_FPS)
EPIC_MAX_BOXES = 10
TIMING_ITERS = 10
CFG_OVERRIDES = {'NUM_GPUS': 1}
MAX_BOXES_PER_CLIP = 32                 # TPU.MAX_BOXES_PER_CLIP, the default
# Phase 12's AVA split on disk: 16 videos, JPEG frames at 30 fps over secs
# 900-916 (510 a video), keyframes at secs 902-913, 640 x 360 frames.  A
# sweep is then 10-12 batches of 16, about three times the loader's prefetch
# window, so its later batches show the loader's steady rate.
AVA_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'configs', 'ava_r101_lfb_nl_3l.yaml')
DISK_VIDEOS, DISK_FPS, DISK_FRAMES = 16, 30, 510
MEMORY_BATCHES = 4                      # each sweep's, timed from memory
DISK_KEYFRAMES = range(902, 914)
DISK_SIZE = (360, 640)
FUSED = {'TPU.PALLAS_BOTTLENECK': True}

KERNELS = {
    'stem_conv': dict(route='cuda', source='lfb_tpu_torch/csrc/stem_conv.cu',
                      replaces='lfb_tpu/ops/pallas_stem.py:212'),
    'stem_conv_dw': dict(route='cuda',
                         source='lfb_tpu_torch/csrc/stem_conv_dw.cu',
                         replaces='lfb_tpu/ops/pallas_stem.py:322'),
    'roi_align_maxpool': dict(
        route='cuda', source='lfb_tpu_torch/csrc/roi_align_maxpool.cu',
        replaces='lfb_tpu/ops/pallas_roi_align.py:186'),
    'roi_align_maxpool_bwd': dict(
        route='cuda', source='lfb_tpu_torch/csrc/roi_align_maxpool.cu',
        replaces='lfb_tpu/ops/pallas_roi_align.py:219'),
    'attention': dict(route='cuda', source='lfb_tpu_torch/csrc/attention.cu',
                      replaces='lfb_tpu/ops/pallas_attention.py:111'),
    'attention_bwd': dict(route='cuda',
                          source='lfb_tpu_torch/csrc/attention_bwd.cu',
                          replaces='lfb_tpu/ops/pallas_attention.py:153'),
    'fused_bottleneck': dict(route='cuda',
                             source='lfb_tpu_torch/csrc/fused_bottleneck.cu',
                             replaces='lfb_tpu/ops/pallas_bottleneck.py:170'),
    # No TPU kernel: XLA fuses the frozen affine into the conv's epilogue.
    'affine_act': dict(route='cuda', source='lfb_tpu_torch/csrc/affine_act.cu',
                       replaces=None),
    # No TPU kernel: lfb_tpu pools with XLA's reduce_window.
    'max_pool': dict(route='cuda', source='lfb_tpu_torch/csrc/max_pool.cu',
                     replaces=None),
}
_NO_BWD = {'stem_conv_dw': 0, 'roi_align_maxpool_bwd': 0, 'attention_bwd': 0,
           'affine_act_bwd': 0, 'max_pool_saved': 0, 'max_pool_bwd': 0}
# R101's identity blocks (2 + 3 + 22 + 2), each one fused launch.
_FUSED_LAUNCHES = {'fused_bottleneck': 29}
# Frozen-affine sites of a forward, one affine_act launch each: 3 an unfused
# block (2a, 2b, 2c with its shortcut) and 1 a non-local block; a fused
# identity block has none, and the stem's affine and ReLU run in the pool
# kernel's fused pass with pool1.  R101 has 33 blocks, R50 16, 4 of them
# projection blocks; both have 5 non-local blocks.
R101_AFFINE, R50_AFFINE = 3 * 33 + 5, 3 * 16 + 5
FUSED_AFFINE = 3 * 4 + 5
# Max pools of a forward, one max_pool launch each: the stem's fused pass,
# pool2 and the 5 non-local blocks'.  An inference forward writes no
# offsets; a forward whose input needs a gradient writes them at every pool
# and the backward launches once a pool.
POOLS = 1 + 1 + 5
_INFER_POOLS = {'max_pool': POOLS}
_TRAIN_POOLS = {'max_pool': POOLS, 'max_pool_saved': POOLS,
                'max_pool_bwd': POOLS}
# Kernel launches per forward of each phase, and per train step.
PER_FORWARD = {'A': {'stem_conv': 1, 'roi_align_maxpool': 1, 'attention': 5,
                     'fused_bottleneck': 0, 'affine_act': R101_AFFINE,
                     **_NO_BWD, **_INFER_POOLS},
               'B': {'stem_conv': 1, 'roi_align_maxpool': 1, 'attention': 8,
                     'fused_bottleneck': 0, 'affine_act': R101_AFFINE,
                     **_NO_BWD, **_INFER_POOLS},
               'B fused': {'stem_conv': 1, 'roi_align_maxpool': 1,
                           'attention': 8, **_FUSED_LAUNCHES,
                           'affine_act': FUSED_AFFINE, **_NO_BWD,
                           **_INFER_POOLS},
               'Charades A': {'stem_conv': 1, 'roi_align_maxpool': 0,
                              'attention': 5, **_FUSED_LAUNCHES,
                              'affine_act': FUSED_AFFINE, **_NO_BWD,
                              **_INFER_POOLS},
               'Charades B': {'stem_conv': 1, 'roi_align_maxpool': 0,
                              'attention': 7, **_FUSED_LAUNCHES,
                              'affine_act': FUSED_AFFINE, **_NO_BWD,
                              **_INFER_POOLS},
               # R50: 5 non-local blocks, 12 identity blocks (2 + 3 + 5 + 2).
               'EPIC verb A': {'stem_conv': 1, 'roi_align_maxpool': 0,
                               'attention': 5, 'fused_bottleneck': 12,
                               'affine_act': FUSED_AFFINE, **_NO_BWD,
                              **_INFER_POOLS},
               'EPIC verb B': {'stem_conv': 1, 'roi_align_maxpool': 0,
                               'attention': 7, 'fused_bottleneck': 12,
                               'affine_act': FUSED_AFFINE, **_NO_BWD,
                              **_INFER_POOLS},
               'EPIC noun B': {'stem_conv': 1, 'roi_align_maxpool': 0,
                               'attention': 7, 'fused_bottleneck': 0,
                               'affine_act': R50_AFFINE, **_NO_BWD,
                               **_INFER_POOLS},
               # Every affine site's and pool's input needs a gradient: one
               # backward launch a site and a pool.
               'train': {'stem_conv': 1, 'stem_conv_dw': 1,
                         'roi_align_maxpool': 1, 'roi_align_maxpool_bwd': 1,
                         'attention': 8, 'attention_bwd': 8,
                         'fused_bottleneck': 0, 'affine_act': R101_AFFINE,
                         'affine_act_bwd': R101_AFFINE, **_TRAIN_POOLS},
               # TPU.REMAT 'stage' runs res2-res5 again in the backward:
               # their affine sites, and res3 and res4's 5 non-local blocks'
               # attention forwards and pools (the stem and pool2 are outside
               # the stages, the FBO outside the backbone).  The stages' first
               # run has grad mode on too, so its pools write offsets (which
               # the checkpoint drops).
               'train stage': {'stem_conv': 1, 'stem_conv_dw': 1,
                               'roi_align_maxpool': 1,
                               'roi_align_maxpool_bwd': 1, 'attention': 13,
                               'attention_bwd': 8, 'fused_bottleneck': 0,
                               'affine_act': 2 * R101_AFFINE,
                               'affine_act_bwd': R101_AFFINE,
                               'max_pool': POOLS + 5,
                               'max_pool_saved': POOLS + 5,
                               'max_pool_bwd': POOLS},
               # Charades stage 2 (MODEL.FREEZE_BACKBONE): the backbone
               # trains nothing, so 'stage' recomputes nothing and no affine
               # site takes a backward; the 2 FBO layers take the only
               # attention backward.
               'Charades train': {'stem_conv': 1, 'stem_conv_dw': 0,
                                  'roi_align_maxpool': 0,
                                  'roi_align_maxpool_bwd': 0, 'attention': 7,
                                  'attention_bwd': 2, 'fused_bottleneck': 0,
                                  'affine_act': R101_AFFINE,
                                  'affine_act_bwd': 0, **_INFER_POOLS,
                                  'max_pool_saved': 0, 'max_pool_bwd': 0},
               # EPIC verb stage 2 (TPU.REMAT ''): R50's 5 non-local blocks
               # and the 2 FBO layers, forward and backward.
               'EPIC verb train': {'stem_conv': 1, 'stem_conv_dw': 1,
                                   'roi_align_maxpool': 0,
                                   'roi_align_maxpool_bwd': 0,
                                   'attention': 7, 'attention_bwd': 7,
                                   'fused_bottleneck': 0,
                                   'affine_act': R50_AFFINE,
                                   'affine_act_bwd': R50_AFFINE,
                                   **_TRAIN_POOLS}}
# True BN (phase 15) normalizes with separate operations: no affine launch.
_NO_AFFINE = {'affine_act': 0, 'affine_act_bwd': 0}
PER_FORWARD['true-BN B'] = {**PER_FORWARD['B'], **_NO_AFFINE}
PER_FORWARD['true-BN train'] = {**PER_FORWARD['train'], **_NO_AFFINE}
# R101's identity blocks at crop 256, B = 16: (label, x shape, Ci, kT,
# dilation, launches per flagship forward, per Charades forward).  res5 is
# dilated (d 2) in the flagship and not in Charades.
BLOCKS = [('res2 kT3', (B, 32, 64, 64, 256), 64, 3, 1, 2, 2),
          ('res3 kT1', (B, 16, 32, 32, 512), 128, 1, 1, 2, 2),
          ('res3 kT3', (B, 16, 32, 32, 512), 128, 3, 1, 1, 1),
          ('res4 kT3', (B, 16, 16, 16, 1024), 256, 3, 1, 11, 11),
          ('res4 kT1', (B, 16, 16, 16, 1024), 256, 1, 1, 11, 11),
          ('res5 kT3 d2', (B, 16, 16, 16, 2048), 512, 3, 2, 1, 0),
          ('res5 kT1 d2', (B, 16, 16, 16, 2048), 512, 1, 2, 1, 0),
          ('res5 kT3 d1', (B, 16, 16, 16, 2048), 512, 3, 1, 0, 1),
          ('res5 kT1 d1', (B, 16, 16, 16, 2048), 512, 1, 1, 0, 1)]


def log(msg):
    print(msg, flush=True)


def preamble():
    """Fail unless a CUDA device and the port are present; print the card."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device')
    import lfb_tpu_torch  # noqa: F401  (absent outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log('card: ' + card_line())
    log('torch {} cuda {}; TF32 off for matmul and cuDNN'.format(
        torch.__version__, torch.version.cuda))
    log(host_record())
    from lfb_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    cuda_build.library()
    log('built {} from lfb_tpu_torch/csrc in {:.1f} s (nvcc {:.1f} s)'.format(
        cuda_build.library_path().name, time.perf_counter() - t0,
        cuda_build.build_seconds))
    for line in cuda_build.build_log.splitlines():
        if any(key in line for key in ('registers', 'spill', 'Compiling',
                                       'wgmma', 'Performance')):
            log('  ptxas: ' + line.strip())
    check_tensor_cores(cuda_build.library_path())
    serialized = serialized_wgmma(cuda_build.build_log)
    if serialized:
        raise AssertionError('ptxas serialised the wgmma of {} '
                             '(C7510-C7520)'.format(', '.join(serialized)))


def host_record():
    """What the host has of the modules a data layer could use, found
    without importing any of them: Python modules by
    ``importlib.util.find_spec``, libjpeg by ``ctypes.util.find_library``."""
    import ctypes.util
    import importlib.util
    found = {name: importlib.util.find_spec(name) is not None
             for name in ('yaml', 'cv2', 'PIL', 'torchvision', 'sklearn')}
    found['libjpeg'] = ctypes.util.find_library('jpeg')
    return 'host has: ' + ', '.join('{} {}'.format(k, v)
                                    for k, v in found.items())


# The bf16 kernels that must run on the tensor cores (HMMA is the SASS of
# mma.sync, HGMMA of wgmma): attention forward and backward, the stem
# forward and weight gradient and the fused bottleneck; those of
# WGMMA_KERNELS must have HGMMA, and ptxas must not have serialised their
# wgmma (its notes C7510-C7520).
MMA_KERNELS = ('attn_fwd_wgmma_kernel', 'attn_bwd_dkdv_wgmma_kernel',
               'attn_bwd_dq_wgmma_kernel', 'stem_conv_wgmma_kernel',
               'stem_dw_wgmma_kernel', 'fused_bottleneck_wgmma_kernel')
WGMMA_KERNELS = ('attn_fwd_wgmma_kernel', 'attn_bwd_dkdv_wgmma_kernel',
                 'attn_bwd_dq_wgmma_kernel', 'stem_conv_wgmma_kernel',
                 'stem_dw_wgmma_kernel', 'fused_bottleneck_wgmma_kernel')


def check_tensor_cores(lib_path):
    """Count the tensor-core instructions (HMMA, HGMMA) of each kernel in
    the built library's SASS (``cuobjdump -sass``) and log those of the
    attention kernels and of ``MMA_KERNELS``; fail if a kernel of
    ``MMA_KERNELS`` has none, or one of ``WGMMA_KERNELS`` no HGMMA."""
    import re
    import shutil
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    sass = subprocess.run([tool, '-sass', str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.match(r'\s*Function : (\S+)', line)
        if m:
            name = m.group(1)
            counts[name] = {'HMMA': 0, 'HGMMA': 0}
        elif name is not None:
            m = re.search(r'\b(HG?MMA)\b', line)
            if m:
                counts[name][m.group(1)] += 1
    for fn, n in sorted(counts.items()):
        if 'attn' in fn or any(kernel in fn for kernel in MMA_KERNELS):
            log('  sass: {} HMMA, {} HGMMA instructions in {}'.format(
                n['HMMA'], n['HGMMA'], fn))
    for kernel in MMA_KERNELS:
        if not any(kernel in fn and sum(n.values()) > 0
                   for fn, n in counts.items()):
            raise AssertionError('{}: no tensor-core instruction in its '
                                 'SASS'.format(kernel))
    for kernel in WGMMA_KERNELS:
        if not any(kernel in fn and n['HGMMA'] > 0
                   for fn, n in counts.items()):
            raise AssertionError('{}: no HGMMA (wgmma) in its '
                                 'SASS'.format(kernel))


def serialized_wgmma(build_log):
    """The kernels of ``WGMMA_KERNELS`` for which ptxas's log holds a note
    that it serialised their wgmma (C7520 and its kin C7510-C7519: a path
    it cannot prove uniform, too few registers, accumulators written inside
    a pipeline stage): the note names its function, or else follows the
    function's 'Compiling entry function' line."""
    import re
    found, current = set(), ''
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
        if re.search(r'\(C75[12]\d\)', line) and 'serialized' in line:
            named = re.search(r"function '([^']+)'", line)
            fn = named.group(1) if named else current
            found.update(k for k in WGMMA_KERNELS if k in fn)
    return sorted(found)


def cuda_ms(fn, iters):
    """Median CUDA-event time of ``fn`` in ms over ``iters`` runs."""
    import torch
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


DEVICE_ITERS = 20


def device_ms(fn, iters=DEVICE_ITERS):
    """The card's time for one call of ``fn`` in ms: after a warm-up, ``iters``
    calls back to back between two CUDA events, over ``iters``.  The card
    first sleeps (``torch.cuda._sleep``) while the host enqueues them all, so
    the wrapper's host work does not pace the kernels; if the card woke
    before the last call was enqueued, the sleep is lengthened and the
    timing taken again."""
    import torch
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    cycles = int(4e9 * max(host_s, 1e-4))   # 2x the enqueue at 2 GHz
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()       # the card still asleep: all enqueued
        end.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise AssertionError('device_ms: the host could not enqueue {} calls '
                         'ahead of the card'.format(iters))


def compare(label, kernel_fn, plain_fn, bound, iters, library_fn=None,
            library_label='library'):
    """Kernel vs plain on the same inputs; returns {err: max_abs_err, ms,
    device_ms, plain_ms, library_ms}.  ``bound`` is relative to max |plain|;
    a function that returns a tuple (dq, dk, dv) is held output by output,
    each to its own max |plain|.  ``ms`` is the median of single calls from
    an idle card (the wrapper's host work included), ``device_ms`` the
    kernel's time alone (:func:`device_ms`).  ``library_fn``, one PyTorch
    call computing the same function (or another yardstick, logged as
    ``library_label``), is timed in the same turns (library_ms None without
    one)."""
    import torch
    got, ref = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    if not isinstance(got, tuple):
        got, ref = (got,), (ref,)
    err = rel = 0.0
    for a, b in zip(got, ref, strict=True):
        a, b = a.float(), b.float()
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError('{}: shape {} vs {} or non-finite '
                                 'output'.format(label, tuple(a.shape),
                                                 tuple(b.shape)))
        e = (a - b).abs().max().item()
        err = max(err, e)
        rel = max(rel, e / max(b.abs().max().item(), 1e-30))
    del got, ref
    fns = [kernel_fn, plain_fn] + ([library_fn] if library_fn else [])
    times = [[] for _ in fns]
    for _ in range(max(iters, 1)):   # in turns: kernel, plain, library
        for fn, ts in zip(fns, times):
            ts.append(cuda_ms(fn, 1))
    ms, plain_ms, *lib = [statistics.median(ts) for ts in times]
    dev_ms = device_ms(kernel_fn)
    lib_dev = device_ms(library_fn) if library_fn else None
    log('{}: max_abs_err {:.3e}, rel {:.3e} (bound {:.0e}); kernel {:.4f} ms '
        '(device {:.4f} ms), plain {:.4f} ms{}'.format(
            label, err, rel, bound, ms, dev_ms, plain_ms,
            ', {} {:.4f} ms (device {:.4f} ms)'.format(
                library_label, lib[0], lib_dev) if lib else ''))
    if not rel <= bound:
        raise AssertionError('{}: error {:.3e} of max|ref|, above {:.0e}'.format(
            label, rel, bound))
    return {'err': err, 'ms': ms, 'device_ms': dev_ms, 'plain_ms': plain_ms,
            'library_ms': lib[0] if lib else None,
            'library_device_ms': lib_dev}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(*parts):
    """bound_ms and bound_by of ``parts``, each (calls, call) with ``call``
    a kernel call's (family, operations, bytes, dtype) of
    :mod:`gpubench.cost.kernels`: the calls' bounds (``cost.bound_s``)
    summed, and what bounds the largest part, 'operations' or 'bytes'."""
    ms = [n * 1e3 * cost.bound_s(flops, nb, dtype)
          for n, (_, flops, nb, dtype) in parts]
    by = ['operations' if cost.bound_s(flops, 0, dtype)
          >= cost.bound_s(0, nb, dtype) else 'bytes'
          for _, (_, flops, nb, dtype) in parts]
    return {'bound_ms': sum(ms), 'bound_by': max(zip(ms, by))[1]}


def bytes_ms(nb):
    """The bound of a bf16 kernel that only moves ``nb`` bytes, in ms."""
    return 1e3 * cost.bound_s(0, nb, 'bfloat16')


def sdpa_call(q, k, v, do, scale):
    """F.scaled_dot_product_attention on (B, N, C) inputs as one head, under
    the first backend (in PyTorch's order of preference) that takes them
    forward and backward; returns (forward fn, forward + backward fn,
    backend name).  The yardstick of ``library_ms``; the port never calls
    it."""
    import warnings
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    q4, k4, v4 = (t[:, None].detach().requires_grad_(True) for t in (q, k, v))
    do4 = do[:, None]
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        def fwd(backend=backend):
            with sdpa_kernel(backend), torch.no_grad():
                return F.scaled_dot_product_attention(q4, k4, v4,
                                                      scale=scale)[:, 0]

        def fwd_bwd(backend=backend):
            with sdpa_kernel(backend):
                out = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
                return torch.autograd.grad(out, (q4, k4, v4), do4)

        try:
            with warnings.catch_warnings():
                warnings.simplefilter('ignore')
                fwd()
                fwd_bwd()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return fwd, fwd_bwd, backend.name
    raise AssertionError('no SDPA backend takes q{} k{}'.format(
        tuple(q.shape), tuple(k.shape)))


def rand_rois(rng, n_clips, boxes, crop):
    n = n_clips * boxes
    return np.stack([
        np.repeat(np.arange(n_clips), boxes).astype(np.float32),
        rng.uniform(0, crop / 2, n), rng.uniform(0, crop / 2, n),
        rng.uniform(crop / 2, crop, n), rng.uniform(crop / 2, crop, n)],
        axis=1).astype(np.float32)


def roi_layout(rng, n_clips, max_boxes, crop):
    """RoI rows as the AVA dataset lays them out (``data/ava.py``): clip b
    owns rows [b * max_boxes, (b + 1) * max_boxes), its 1-6 boxes first,
    then zero rows, which name clip 0."""
    rois = np.zeros((n_clips * max_boxes, 5), np.float32)
    for b in range(n_clips):
        n = int(rng.integers(1, 7))
        rois[b * max_boxes:b * max_boxes + n] = rand_rois(rng, 1, n, crop)
        rois[b * max_boxes:b * max_boxes + n, 0] = b
    return rois


def check_roi_layout(label, fmap, rois_np, dense, iters):
    """The RoI forward on the dataset's padded rows (``rois_np``, most of
    them zero rows of clip 0) against its plain version, logged beside
    ``dense``, the same kernel's timing at 4 boxes a clip."""
    import torch
    from lfb_tpu_torch.ops import cuda_roi_align
    rois = torch.from_numpy(rois_np).to(fmap.device)
    real = int((rois_np[:, 1:] != 0).any(axis=1).sum())
    r = compare(
        'roi_align_maxpool fmap{} rois{} f32, the dataset layout ({}; {} '
        'real rows)'.format(tuple(fmap.shape), tuple(rois.shape), label, real),
        lambda: cuda_roi_align.roi_align_maxpool(fmap, rois),
        lambda: cuda_roi_align.roi_align_maxpool_plain(fmap, rois), 1e-5,
        iters)
    bound_ms = bound((1, cost.roi_fwd(rois_np, fmap.shape[1])))['bound_ms']
    log('  roi_align_maxpool at {} rows: device {:.4f} ms, bound {:.4f} ms; '
        'at {} rows (4 boxes a clip): device {:.4f} ms'.format(
            rois.shape[0], r['device_ms'], bound_ms, B * BOXES_PER_CLIP,
            dense['device_ms']))
    return r


def log_regime(label, flops, r, lib_label):
    """One bf16 attention regime's device ms and rate beside the library
    call's device ms, the card named."""
    rate = flops / (r['device_ms'] * 1e-3) / 1e12
    log('  {}: kernel device {:.4f} ms, {:.1f} TFLOP/s ({:.1f}% of the bf16 '
        'peak); {} device {:.4f} ms ({:.2f}x the kernel); {}'.format(
            label, r['device_ms'], rate, 100 * rate * 1e12
            / cost.PEAK_FLOPS['bfloat16'], lib_label, r['library_device_ms'],
            r['library_device_ms'] / r['device_ms'], card_line()))


def check_attention_forward(label, q, k, v, scale, r):
    """A bf16 regime of the forward at phase B's shape: its rate beside
    SDPA's, its row log-sum-exp against ``torch.logsumexp`` (1e-5 of the
    largest), and two calls bitwise equal (no atomics, a fixed order)."""
    import torch
    from lfb_tpu_torch.ops import cuda_attention
    b, nq, c = q.shape
    log_regime('attention {} forward'.format(label),
               4 * b * nq * k.shape[1] * c, r, 'SDPA')
    out, lse = cuda_attention.fused_attention_lse(q, k, v, scale=scale)
    ref = torch.logsumexp(
        torch.matmul(q.float(), k.float().transpose(1, 2)) * scale, dim=-1)
    rel = ((lse - ref).abs().max() / ref.abs().max()).item()
    out2, lse2 = cuda_attention.fused_attention_lse(q, k, v, scale=scale)
    same = torch.equal(out, out2) and torch.equal(lse, lse2)
    log('  attention {} lse: rel err {:.3e} vs torch.logsumexp (bound '
        '1e-05); two calls bitwise equal: {}'.format(label, rel, same))
    if not rel <= 1e-5 or not same:
        raise AssertionError('attention {}: lse {:.3e} or two calls '
                             'differ'.format(label, rel))


def check_kernels(iters=TIMING_ITERS):
    """Phase 2: each kernel vs its plain version at the flagship shapes, with
    its bound and, where one PyTorch call computes the same function, that
    call's time.

    Bounds, relative to max |plain|: bf16 outputs 1e-2 (both sides round an
    f32 accumulation to bf16, 2^-8 apart at most twice over); f32 outputs
    1e-5 (f32 sums of at most a few thousand terms in another order).
    """
    import torch
    import torch.nn.functional as F
    from lfb_tpu_torch.ops import cuda_attention, cuda_roi_align, cuda_stem
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    results = {}

    x = torch.randint(0, 256, (B, 32, 256, 256, 3), generator=g, device=dev)
    x = ((x.float() / 255 - 0.45) / 0.225).to(torch.bfloat16)
    w = torch.randn((64, 3, 5, 7, 7), generator=g, device=dev) * (2 / 735) ** .5
    x_cl = x.permute(0, 4, 1, 2, 3)                  # channels-last view
    w_cl = w.to(torch.bfloat16, memory_format=torch.channels_last_3d)
    r = compare(
        'stem_conv x{} bf16'.format(tuple(x.shape)),
        lambda: cuda_stem.stem_conv(x, w, temporal_pad=2),
        lambda: cuda_stem.stem_conv_plain(x, w, 2), 1e-2, iters,
        lambda: F.conv3d(x_cl, w_cl, None, (1, 2, 2), (2, 3, 3)))
    out_elems = B * 32 * 128 * 128 * 64
    results['stem_conv'] = dict(
        r, tolerance='1e-2', library='F.conv3d (cuDNN, bf16, channels-last)',
        **bound((1, cost.stem_fwd(B, 32, 256, 5))))
    log_stem_rate(r['ms'], out_elems, 5)
    del x, x_cl
    # The train steps' shapes (crop 224; B = 16 in phases 11 and 13, B = 8
    # in phase 11), checked and logged.
    for n_clips in (REMAT_B, TRAIN_B):
        x = torch.randint(0, 256, (n_clips, 32, 224, 224, 3), generator=g,
                          device=dev)
        x = ((x.float() / 255 - 0.45) / 0.225).to(torch.bfloat16)
        x_cl = x.permute(0, 4, 1, 2, 3)
        r = compare(
            'stem_conv x{} bf16 (train shape)'.format(tuple(x.shape)),
            lambda: cuda_stem.stem_conv(x, w, temporal_pad=2),
            lambda: cuda_stem.stem_conv_plain(x, w, 2), 1e-2, iters,
            lambda: F.conv3d(x_cl, w_cl, None, (1, 2, 2), (2, 3, 3)))
        log_stem_rate(r['ms'], n_clips * 32 * 112 * 112 * 64, 5)
        del x, x_cl

    fmap = torch.relu(torch.randn((B, 16, 16, 2048), generator=g, device=dev))
    rois_np = rand_rois(rng, B, BOXES_PER_CLIP, 256)
    rois = torch.from_numpy(rois_np).to(dev)
    r = compare(
        'roi_align_maxpool fmap{} rois{} f32'.format(tuple(fmap.shape),
                                                     tuple(rois.shape)),
        lambda: cuda_roi_align.roi_align_maxpool(fmap, rois),
        lambda: cuda_roi_align.roi_align_maxpool_plain(fmap, rois), 1e-5,
        iters)
    results['roi_align_maxpool'] = dict(
        r, tolerance='1e-5', **bound((1, cost.roi_fwd(rois_np, 16))))
    # The layout of a batch from the AVA dataset (phase 12), logged beside.
    check_roi_layout('1-6 boxes a clip', fmap,
                     roi_layout(rng, B, MAX_BOXES_PER_CLIP, 256), r, iters)

    # (label, B, Nq, Nk, C, dtype, calls per phase-B forward)
    regimes = [('res3 NL', 64, 4096, 1024, 256, torch.bfloat16, 2),
               ('res4 NL', 16, 4096, 1024, 512, torch.bfloat16, 3),
               ('FBO-NL', 64, 1, 300, 512, torch.float32, 3)]
    total = {'err': 0.0, 'ms': 0.0, 'device_ms': 0.0, 'plain_ms': 0.0,
             'library_ms': 0.0, 'library_device_ms': 0.0}
    parts, backends = [], []
    for label, b, nq, nk, c, dtype, calls in regimes:
        q, k, v = (torch.randn((b, n, c), generator=g, device=dev).to(dtype)
                   for n in (nq, nk, nk))
        lib_fwd, _, backend = sdpa_call(q, k, v, q, c ** -0.5)
        backends.append('{} {}'.format(label, backend))
        r = compare(
            'attention {} q{} k{} {}'.format(label, (b, nq, c), (b, nk, c),
                                            str(dtype).split('.')[-1]),
            lambda: cuda_attention.fused_attention(q, k, v, scale=c ** -0.5),
            lambda: cuda_attention.attention_plain(q, k, v, c ** -0.5),
            1e-2 if dtype == torch.bfloat16 else 1e-5, iters, lib_fwd)
        log('  SDPA backend for {}: {}'.format(label, backend))
        if dtype == torch.bfloat16:
            check_attention_forward(label, q, k, v, c ** -0.5, r)
        total['err'] = max(total['err'], r['err'])
        for key in ('ms', 'device_ms', 'plain_ms', 'library_ms',
                    'library_device_ms'):
            total[key] += calls * r[key]
        parts.append((calls, cost.attention_fwd(b, nq, nk, c,
                                                str(dtype).split('.')[-1])))
    log('attention, the 8 calls of one phase-B forward: kernel {:.3f} ms '
        '(device {:.3f} ms), plain {:.3f} ms, SDPA {:.3f} ms (device {:.3f} '
        'ms); device kernel / SDPA {:.3f}; {}'.format(
            total['ms'], total['device_ms'], total['plain_ms'],
            total['library_ms'], total['library_device_ms'],
            total['device_ms'] / total['library_device_ms'], card_line()))
    # The clip-level FBO-NL's decode shapes (Nq 1, f32) of the EPIC phases,
    # logged with their bound; the totals above stay the flagship's.
    for label, nk in (('EPIC verb FBO-NL', 40), ('EPIC noun FBO-NL', 120)):
        q = torch.randn((B, 1, 512), generator=g, device=dev)
        k, v = (torch.randn((B, nk, 512), generator=g, device=dev)
                for _ in range(2))
        lib_fwd, _, backend = sdpa_call(q, k, v, q, 512 ** -0.5)
        r = compare(
            'attention {} q{} k{} float32 (SDPA {})'.format(
                label, (B, 1, 512), (B, nk, 512), backend),
            lambda: cuda_attention.fused_attention(q, k, v, scale=512 ** -0.5),
            lambda: cuda_attention.attention_plain(q, k, v, 512 ** -0.5),
            1e-5, iters, lib_fwd)
        total['err'] = max(total['err'], r['err'])
        decode = bound((1, cost.attention_fwd(B, 1, nk, 512, 'float32')))
        log('  bound for {}: {:.5f} ms, {}'.format(
            label, decode['bound_ms'], decode['bound_by']))
    results['attention'] = dict(
        total, tolerance='1e-5 f32, 1e-2 bf16',
        library='F.scaled_dot_product_attention ({})'.format(
            ', '.join(backends)), **bound(*parts))
    del q, k, v
    results['fused_bottleneck'] = check_bottleneck(g, iters)
    results['affine_act'] = check_affine(g, iters)
    results['max_pool'] = check_pool(g, iters)
    return results


def check_affine(g, iters):
    """The frozen affine's kernels (``ops/cuda_affine.py``, bf16) against
    their plain versions, today's composition of PyTorch passes, bit for
    bit, timed in turns with it, at the main path's sites of each variant:
    res2's 2c + ReLU with its identity shortcut and with a projection
    block's affine shortcut (B x 32 x 64 x 64 x 256, crop 256), the stem's
    affine + ReLU (B x 32 x 128 x 128 x 64) and a res3 non-local block's
    affine + residual, no ReLU (B x 16 x 32 x 32 x 512); then the backward
    of the three shortcuts at the train crop, each writing what the main
    path's autograd asks of it.  Bound: the bytes read and written once
    over 3.35 TB/s.  Returns the identity 2c's forward row."""
    import torch
    from lfb_tpu_torch.ops import cuda_affine as ca
    dev = g.device

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def bitwise(label, got, want):
        view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
        for a, w in zip(got, want, strict=True):
            if (a is None) != (w is None) or (a is not None and not torch.equal(
                    a.view(view[a.dtype]), w.view(view[w.dtype]))):
                raise AssertionError('affine_act {}: kernel and plain '
                                     'differ'.format(label))

    def operands(shape, shortcut):
        """x (or dy), scale, bias, residual, its scale and its bias."""
        c = shape[-1]
        x = randn(*shape).to(torch.bfloat16)
        r = None if shortcut == 'none' else randn(*shape).to(torch.bfloat16)
        affine = shortcut == 'affine'
        return (x, 1 + 0.1 * randn(c), 0.1 * randn(c), r,
                1 + 0.1 * randn(c) if affine else None,
                0.1 * randn(c) if affine else None)

    def log_row(label, r, bound_ms):
        log('  affine_act {}: device {:.4f} ms against the bound {:.4f} ms '
            '({:.1f}% of 3.35 TB/s); the composition {:.4f} ms ({:.2f}x); {}'
            .format(label, r['device_ms'], bound_ms,
                    100 * bound_ms / r['device_ms'], r['library_device_ms'],
                    r['library_device_ms'] / r['device_ms'], card_line()))

    rows = {}
    for label, shape, shortcut, relu in (
            ('res2 2c + shortcut + ReLU', (B, 32, 64, 64, 256), 'identity',
             True),
            ('res2 projection 2c + branch1 + ReLU', (B, 32, 64, 64, 256),
             'affine', True),
            ('stem + ReLU', (B, 32, 128, 128, 64), 'none', True),
            ('res3 non-local + residual', (B, 16, 32, 32, 512), 'identity',
             False)):
        x, s, b, r, rs, rb = operands(shape, shortcut)

        def kernel():
            return ca.affine_act_fwd(x, s, b, relu, r, rs, rb)

        def plain():
            return ca.affine_act_plain(x, s, b, relu, r, rs, rb)

        timed_row = compare('affine_act {} x{} bf16'.format(label, shape),
                            kernel, plain, 0.0, iters, plain, 'composition')
        bitwise(label, (kernel(),), (plain(),))
        rows[label] = dict(
            timed_row, tolerance='0 (bit for bit)',
            library='the PyTorch composition it replaces',
            bound_ms=bytes_ms(nbytes(x) * (2 + (r is not None))),
            bound_by='bytes')
        log_row(label, timed_row, rows[label]['bound_ms'])
        del x, r
    # The backward: dx, and the shortcut's gradient (g through the ReLU for
    # an identity shortcut, g * residual_scale for an affine one; without a
    # ReLU it is dy itself, and the kernel writes dx alone).
    for label, shape, shortcut, relu, outs in (
            ('res2 2c + shortcut + ReLU', (B, 32, 56, 56, 256), 'identity',
             True, (0, 1)),
            ('res2 projection 2c + branch1 + ReLU', (B, 32, 56, 56, 256),
             'affine', True, (0, 2)),
            ('res3 non-local + residual', (B, 16, 28, 28, 512), 'identity',
             False, (0,))):
        dy, s, _, _, rs, _ = operands(shape, shortcut)
        y = torch.relu(randn(*shape)).to(torch.bfloat16) if relu else None

        def kernel():
            got = ca.affine_act_bwd(dy, y, s, rs,
                                    need_g=shortcut != 'affine')
            return tuple(got[i] for i in outs)

        def plain():
            want = ca.affine_act_bwd_plain(dy, y, s, rs)
            return tuple(want[i] for i in outs)

        timed_row = compare(
            'affine_act_bwd {} x{} bf16 (train shape)'.format(label, shape),
            kernel, plain, 0.0, iters, plain, 'composition')
        bitwise('backward ' + label, kernel(), plain())
        log_row('backward ' + label, timed_row,
                bytes_ms(nbytes(dy) * (1 + relu + len(outs))))
        del dy, y
    return rows['res2 2c + shortcut + ReLU']


# The max pools of an R101 / R50 forward, (label, x shape at crop 256, the
# same at the train crop 224, window, launches a forward): the stem's fused
# affine + ReLU + pool1, pool2 and the non-local blocks' (2 in res3, 3 in
# res4).
POOL_SITES = [
    ('pool1 + stem affine + ReLU', (B, 32, 128, 128, 64), (B, 32, 112, 112, 64),
     ((1, 3, 3), (1, 2, 2), (0, 1, 1)), 1),
    ('pool2', (B, 32, 64, 64, 256), (B, 32, 56, 56, 256),
     ((2, 1, 1), (2, 1, 1), (0, 0, 0)), 1),
    ('res3 non-local', (B, 16, 32, 32, 512), (B, 16, 28, 28, 512),
     ((1, 2, 2), (1, 2, 2), (0, 0, 0)), 2),
    ('res4 non-local', (B, 16, 16, 16, 1024), (B, 16, 14, 14, 1024),
     ((1, 2, 2), (1, 2, 2), (0, 0, 0)), 3)]


def check_pool(g, iters):
    """The max pool's kernels (``ops/cuda_pool.py``, bf16) against their
    plain versions, bit for bit, at each pool of the main path
    (:data:`POOL_SITES`): the forward at crop 256 with no offsets, as
    inference runs it (the stem's site fused behind its affine and ReLU),
    timed beside the PyTorch calls it replaces (``F.max_pool3d``, which
    writes int64 indices, behind ``affine_act`` at the stem's site) and held
    to them bit for bit; then at the train crop the forward that writes the
    offsets and the backward, beside ATen's forward with indices and its
    atomic backward, the backward's bits the same on a second call.  Bound:
    the bytes read and written once over 3.35 TB/s.  Returns a forward's
    row: each number summed over a forward's 7 launches."""
    import torch
    import torch.nn.functional as F
    from lfb_tpu_torch.ops import cuda_affine as ca
    from lfb_tpu_torch.ops import cuda_pool as cp
    dev = g.device

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def bitwise(label, got, want):
        view = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
                torch.uint8: torch.uint8}
        if not torch.equal(got.contiguous().view(view[got.dtype]),
                           want.contiguous().view(view[want.dtype])):
            raise AssertionError('max_pool {}: kernel and reference '
                                 'differ'.format(label))

    def aten(x, window, indices=False):
        out = F.max_pool3d(x.permute(0, 4, 1, 2, 3), *window,
                           return_indices=indices)
        if indices:
            return out[0].permute(0, 2, 3, 4, 1), out[1]
        return out.permute(0, 2, 3, 4, 1).contiguous()

    def log_row(label, r, bound_ms, lib_label):
        log('  max_pool {}: device {:.4f} ms against the bound {:.4f} ms '
            '({:.1f}% of 3.35 TB/s); {} {:.4f} ms ({:.2f}x); {}'.format(
                label, r['device_ms'], bound_ms,
                100 * bound_ms / r['device_ms'], lib_label,
                r['library_device_ms'],
                r['library_device_ms'] / r['device_ms'], card_line()))

    total = dict(err=0.0, ms=0.0, device_ms=0.0, plain_ms=0.0,
                 library_ms=0.0, library_device_ms=0.0, bound_ms=0.0)
    for label, shape, train_shape, window, per_forward in POOL_SITES:
        stem = label.startswith('pool1')
        x = randn(*shape).to(torch.bfloat16)
        s, b = (1 + 0.1 * randn(shape[-1]), 0.1 * randn(shape[-1])) if stem \
            else (None, None)

        def kernel():
            return cp.max_pool_fwd(x, *window, save=False, scale=s,
                                   bias=b)[0]

        def plain():
            h = ca.affine_act_plain(x, s, b, True) if stem else x
            return cp.max_pool_plain(h, *window)[0]

        def library():
            return aten(ca.affine_act_fwd(x, s, b, True) if stem else x,
                        window)

        lib_label = ('affine_act + F.max_pool3d' if stem
                     else 'F.max_pool3d')
        r = compare('max_pool {} x{} bf16'.format(label, shape), kernel,
                    plain, 0.0, iters, library, lib_label)
        y = kernel()
        bitwise(label, y, plain())
        bitwise(label + ' against ' + lib_label, y, library())
        bound_ms = bytes_ms(nbytes(x, y))
        log_row(label, r, bound_ms, lib_label)
        for key in ('ms', 'device_ms', 'plain_ms', 'library_ms',
                    'library_device_ms'):
            total[key] += per_forward * r[key]
        total['bound_ms'] += per_forward * bound_ms
        del x, y
        # The train crop: the forward with offsets, then the backward.
        x = randn(*train_shape).to(torch.bfloat16)
        if stem:
            s, b = 1 + 0.1 * randn(shape[-1]), 0.1 * randn(shape[-1])

        def kernel_saved():
            return cp.max_pool_fwd(x, *window, save=True, scale=s, bias=b)

        def library_saved():
            return aten(ca.affine_act_fwd(x, s, b, True) if stem else x,
                        window, indices=True)

        def plain_saved():
            return cp.max_pool_plain(
                ca.affine_act_plain(x, s, b, True) if stem else x, *window)

        y, offsets = kernel_saved()
        plain_y, plain_offsets = plain_saved()
        bitwise(label + ' (offsets)', offsets, plain_offsets)
        bitwise(label + ' (y with offsets)', y, plain_y)
        del plain_y, plain_offsets
        r = compare('max_pool {} with offsets x{} bf16 (train shape)'.format(
            label, train_shape), kernel_saved, plain_saved, 0.0, iters,
            library_saved, lib_label + ' with indices')
        log_row(label + ' with offsets', r,
                bytes_ms(nbytes(x, y) + offsets.numel()),
                lib_label + ' with indices')
        dy = randn(*y.shape).to(torch.bfloat16)
        h = ca.affine_act_fwd(x, s, b, True) if stem else x
        _, index = aten(h, window, indices=True)
        dy_cf = dy.permute(0, 4, 1, 2, 3)
        h_cf = h.permute(0, 4, 1, 2, 3)

        def backward():
            return cp.max_pool_bwd(dy, offsets, train_shape, *window,
                                   y=y if stem else None, scale=s)

        def plain_backward():
            return cp.max_pool_bwd_plain(dy, offsets, train_shape, *window,
                                         y=y if stem else None, scale=s)

        def library_backward():
            g_h = torch.ops.aten.max_pool3d_with_indices_backward(
                dy_cf, h_cf, *window, (1, 1, 1), False, index)
            return (ca.affine_act_bwd(g_h.permute(0, 2, 3, 4, 1), h, s)[0]
                    if stem else g_h)

        lib_bwd = ('max_pool3d backward + affine_act_bwd' if stem
                   else 'max_pool3d backward')
        r = compare('max_pool_bwd {} x{} bf16 (train shape)'.format(
            label, train_shape), backward, plain_backward, 0.0, iters,
            library_backward, lib_bwd)
        dx = backward()
        bitwise(label + ' backward', dx, plain_backward())
        bitwise(label + ' backward, second call', backward(), dx)
        log_row(label + ' backward', r, bytes_ms(
            nbytes(dy, dx) + offsets.numel() + (nbytes(y) if stem else 0)),
            lib_bwd)
        del x, y, offsets, dy, h, index, dy_cf, h_cf, dx
    log('  max_pool: a forward\'s 7 launches at crop 256: device {:.4f} ms '
        'against the bound {:.4f} ms; what they replace {:.4f} ms'.format(
            total['device_ms'], total['bound_ms'],
            total['library_device_ms']))
    return dict(total, tolerance='0 (bit for bit)', bound_by='bytes',
                library='F.max_pool3d (behind affine_act at the stem)')


def log_stem_rate(ms, out_elems, kt):
    """The stem forward's rate: the direct conv's operations (kT x 147
    multiply-adds per output), and those of the product over the
    space-to-depth packing that the bf16 kernel runs (kT x 256)."""
    log('  stem_conv: {:.0f} TFLOP/s of the direct conv ({:.0f} GFLOP), {:.0f} '
        'TFLOP/s of the packed product ({:.0f} GFLOP)'.format(
            2 * out_elems * kt * 147 / ms / 1e9, 2 * out_elems * kt * 147 / 1e9,
            2 * out_elems * kt * 256 / ms / 1e9,
            2 * out_elems * kt * 256 / 1e9))


def bottleneck_params(c, ci, kt, g):
    """Folded block weights (port layout) at fan-in scale, branch2c at 0.2
    of it as in :func:`perturbed_params`, and 0.1 * N(0, 1) biases."""
    import torch
    dev = g.device

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    return (randn(ci, c, kt, 1, 1) * (kt * c) ** -0.5, 0.1 * randn(ci),
            randn(ci, ci, 1, 3, 3) * (9 * ci) ** -0.5, 0.1 * randn(ci),
            randn(c, ci, 1, 1, 1) * 0.2 * ci ** -0.5, 0.1 * randn(c))


def unfused_block(shape, ci, kt, d, p):
    """The identity block as the default (unfused) path runs it, from the
    folded weights with unit affine scales: ``models/backbone.py``'s
    ``Bottleneck`` (three cuDNN convolutions, the affine, ReLU and residual
    passes) in the flagship spec's bf16."""
    import torch
    from lfb_tpu_torch.config import flagship_cfg
    from lfb_tpu_torch.models.backbone import Bottleneck
    from lfb_tpu_torch.models.spec import build_spec
    spec = build_spec(flagship_cfg(CFG_OVERRIDES), 'test')
    c = shape[-1]
    params = {}
    for branch, w, bias in (('a', p[0], p[1]), ('b', p[2], p[3]),
                            ('c', p[4], p[5])):
        params['blk_branch2{}_w'.format(branch)] = w
        params['blk_branch2{}_bn_s'.format(branch)] = torch.ones_like(bias)
        params['blk_branch2{}_bn_b'.format(branch)] = bias
    block = Bottleneck(spec, 'blk', dim_in=c, dim_out=c, stride=1,
                       temp_stride=1, use_temp_conv=kt // 2, dilation=d)

    def run(x):
        with torch.inference_mode():
            return block(params, x, False)

    return run


def check_bottleneck(g, iters):
    """The fused bottleneck (bf16) vs its plain version (f32 cuDNN
    convolutions on the same bf16-rounded operands, intermediates rounded
    to bf16) at each identity-block shape of R101 at crop 256.  Bound 1e-2
    of max |plain|: both sides round h1, h2 and the output to bf16 (2^-8).
    Beside it, the same block as the default bf16 path runs it
    (:func:`unfused_block`), timed in the same turns; each shape's device
    ms, TFLOP/s and share of the bf16 peak are logged beside the unfused
    block's, and two calls must give the same bits."""
    import torch
    from lfb_tpu_torch.ops import cuda_bottleneck as cb
    err, totals = 0.0, {'flagship': [0.0] * 5, 'Charades': [0.0] * 5}
    parts = []
    for label, shape, ci, kt, d, n_ava, n_charades in BLOCKS:
        x = torch.relu(torch.randn(shape, generator=g, device=g.device))
        x = x.to(torch.bfloat16)
        p = bottleneck_params(shape[-1], ci, kt, g)
        unfused = unfused_block(shape, ci, kt, d, p)

        def fused():
            return cb.fused_identity_bottleneck(
                x, *p, temporal_pad=kt // 2, dilation=d)

        r = compare(
            'fused_bottleneck {} x{} Ci {} bf16'.format(label, shape, ci),
            fused, lambda: cb.fused_identity_bottleneck_plain(
                x, *p, temporal_pad=kt // 2, dilation=d), 1e-2, iters,
            lambda: unfused(x), 'unfused bf16 block')
        err = max(err, r['err'])
        for name, n in (('flagship', n_ava), ('Charades', n_charades)):
            for i, key in enumerate(('ms', 'plain_ms', 'library_ms',
                                     'device_ms', 'library_device_ms')):
                totals[name][i] += n * r[key]
        call = cost.bottleneck(shape, ci, kt)
        block = bound((1, call))
        rate = call[1] / (r['device_ms'] * 1e-3) / 1e12
        same = torch.equal(fused(), fused())
        log('  {}: kernel device {:.4f} ms, {:.1f} TFLOP/s ({:.1f}% of the '
            'bf16 peak; bound {:.4f} ms, {}); unfused bf16 block device '
            '{:.4f} ms ({:.3f}x the kernel); two calls bitwise equal: {}; '
            '{}'.format(label, r['device_ms'], rate,
                        100 * rate * 1e12 / cost.PEAK_FLOPS['bfloat16'],
                        block['bound_ms'], block['bound_by'],
                        r['library_device_ms'],
                        r['library_device_ms'] / r['device_ms'], same,
                        card_line()))
        if not same:
            raise AssertionError('fused_bottleneck {}: two calls '
                                 'differ'.format(label))
        parts.append((n_ava, call))
        del x
    for name, (ms, plain_ms, unfused_ms, dev_ms, unfused_dev) in (
            totals.items()):
        log('fused_bottleneck, the 29 launches of one {} forward: kernel '
            '{:.3f} ms (device {:.3f} ms), plain {:.3f} ms, the unfused bf16 '
            'blocks {:.3f} ms (device {:.3f} ms); device kernel / unfused '
            '{:.3f}'.format(name, ms, dev_ms, plain_ms, unfused_ms,
                            unfused_dev, dev_ms / unfused_dev))
    return {'err': err, 'ms': totals['flagship'][0],
            'device_ms': totals['flagship'][3],
            'plain_ms': totals['flagship'][1], 'library_ms': None,
            'tolerance': '1e-2', **bound(*parts)}


def perturbed_params(spec, device):
    """Reference init, then every all-zero tensor (biases, zero-init NL and
    FBO output convs) drawn as 0.05 * N(0, 1), so every path reaches the
    logits, and each residual branch's last scale (branch2c) set near 0.2:
    at the reference's gamma of 1 the 33 random blocks would grow the
    activations about 1.4x each."""
    import torch
    from lfb_tpu_torch.models.model import init_params
    g = torch.Generator(device=device).manual_seed(SEED)
    params = init_params(spec, g)
    for name, value in params.items():
        if name.endswith('_branch2c_bn_s'):
            params[name] = 0.2 + 0.02 * torch.randn(value.shape, generator=g,
                                                    device=device)
        elif not value.any():
            params[name] = 0.05 * torch.randn(value.shape, generator=g,
                                              device=device)
    return params


def make_clip_batch(spec, rng, device, *, n_clips=B, with_lfb=False,
                    lengths=None):
    """A clip-level (Charades, EPIC) batch: uint8 frames and, for phase B,
    either explicit bank windows ('lfb') or the device bank's (video,
    center) keys, centers inside the video: ``lengths`` gives each video's
    frames by its dense id (Charades without it: every video is longer than
    ``CHARADES_FRAMES[0]``)."""
    import torch
    crop, t = spec.crop_size, spec.video_length
    batch = {'data': rng.integers(0, 256, (n_clips, t, crop, crop, 3),
                                  np.uint8)}
    if with_lfb:
        batch['lfb'] = np.abs(rng.standard_normal(
            (n_clips, spec.fbo.num_lfb_feat, 2048), np.float32)) * 0.5
    elif spec.fbo.enabled and not spec.lfb_infer_only and lengths is None:
        batch['lfb_video_idx'] = rng.integers(0, CHARADES_VIDEOS, n_clips,
                                              dtype=np.int32)
        batch['lfb_center'] = rng.integers(0, CHARADES_FRAMES[0], n_clips,
                                           dtype=np.int32)
    elif spec.fbo.enabled and not spec.lfb_infer_only:
        videos = rng.integers(0, len(lengths), n_clips)
        batch['lfb_video_idx'] = videos.astype(np.int32)
        batch['lfb_center'] = (rng.random(n_clips)
                               * lengths[videos]).astype(np.int32)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def make_batch(spec, rng, device, *, n_clips=B, boxes=BOXES_PER_CLIP,
               with_lfb=False, with_labels=False):
    import torch
    crop, t = spec.crop_size, spec.video_length
    n = n_clips * boxes
    batch = {
        'data': rng.integers(0, 256, (n_clips, t, crop, crop, 3), np.uint8),
        'proposals': rand_rois(rng, n_clips, boxes, crop),
        'metadata': np.stack([
            rng.integers(0, AVA_VIDEOS, n), rng.integers(902, 1799, n),
            np.full(n, 400), np.full(n, 600)], axis=1).astype(np.float32),
        'box_mask': np.ones(n, np.float32),
    }
    if with_lfb:
        batch['lfb'] = np.abs(rng.standard_normal(
            (n, spec.fbo.num_lfb_feat, 2048), np.float32)) * 0.5
    if with_labels:
        batch['labels'] = (rng.random((n, spec.num_classes)) < 0.1).astype(
            np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def reference_check(cfg):
    """Phase 3: full width, one clip, f32: kernels on the card vs plain
    versions on the CPU, for the flagship, for Charades with the fused
    bottleneck (all 29 identity blocks launch it on the card) and for EPIC
    verb with it (R50's 12).  Bound 2e-3 x max|CPU| (f32 sums through 101
    layers, taken in other orders by cuDNN, the kernels and the CPU)."""
    import torch
    from lfb_tpu_torch.config import charades_cfg, epic_verb_cfg, flagship_cfg
    from lfb_tpu_torch.models.spec import build_spec
    from lfb_tpu_torch.utils.profiling import counts
    f32 = {'NUM_GPUS': 1, 'TPU.COMPUTE_DTYPE': 'float32'}
    spec = build_spec(flagship_cfg(f32), 'test')
    batch = make_batch(spec, np.random.default_rng(SEED + 1), 'cuda',
                       n_clips=1, boxes=2, with_lfb=True)
    hold_card_against_cpu('flagship', spec, batch,
                          ('box_pooled', 'logits', 'prob'))
    spec = build_spec(charades_cfg({**f32, **FUSED}), 'test')
    batch = make_clip_batch(spec, np.random.default_rng(SEED + 8), 'cuda',
                            n_clips=1, with_lfb=True)
    before = counts().get('kernel.bottleneck.fwd', 0)
    hold_card_against_cpu('Charades, fused bottleneck', spec, batch,
                          ('pool5', 'logits', 'prob'))
    fused = counts().get('kernel.bottleneck.fwd', 0) - before
    if fused != _FUSED_LAUNCHES['fused_bottleneck']:
        raise AssertionError('Charades reference: {} fused launches'.format(
            fused))
    spec = build_spec(epic_verb_cfg({**f32, **FUSED}), 'test')
    batch = make_clip_batch(spec, np.random.default_rng(SEED + 9), 'cuda',
                            n_clips=1, with_lfb=True)
    before = counts().get('kernel.bottleneck.fwd', 0)
    hold_card_against_cpu('EPIC verb, fused bottleneck', spec, batch,
                          ('pool5', 'logits', 'prob'))
    fused = counts().get('kernel.bottleneck.fwd', 0) - before
    if fused != 12:
        raise AssertionError('EPIC verb reference: {} fused launches'.format(
            fused))


def hold_card_against_cpu(label, spec, batch, keys):
    import torch
    from lfb_tpu_torch.models.model import forward
    params = perturbed_params(spec, torch.device('cuda'))
    t0 = time.perf_counter()
    gpu = forward(spec, params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cpu = forward(spec, {k: v.cpu() for k, v in params.items()},
                  {k: v.cpu() for k, v in batch.items()})
    t2 = time.perf_counter()
    for key in keys:
        got, ref = gpu[key].float().cpu(), cpu[key].float()
        err = (got - ref).abs().max().item()
        scale = max(ref.abs().max().item(), 1e-30)
        log('reference {} {}: card vs CPU max_abs_err {:.3e}, rel {:.3e} '
            '(bound 2e-03)'.format(label, key, err, err / scale))
        if not (torch.isfinite(got).all() and err <= 2e-3 * scale):
            raise AssertionError('reference check failed for {} {}'.format(
                label, key))
    log('reference {} forward: card {:.1f} s (first call), CPU {:.1f} '
        's'.format(label, t1 - t0, t2 - t1))


def tiled_rows(rng, total):
    """``total`` rows x 2048 f32 from one tiled random block."""
    block = np.abs(rng.standard_normal((4096, 2048), np.float32)) * 0.5
    return np.tile(block, (-(-total // 4096), 1))[:total]


def synthetic_frame_bank(host_bank, rng):
    """Top the Charades ``host_bank`` up to the val split: every video gets
    a length of 15-45 s at 24 fps and a row at each bank frame it lacks
    (frames 11, 23, ..., as ``lfb_tpu.data.charades.get_lfb_frames``), from
    one tiled random block."""
    lengths = rng.integers(CHARADES_FRAMES[0], CHARADES_FRAMES[1] + 1,
                           CHARADES_VIDEOS)
    feats = tiled_rows(rng, int((lengths // CHARADES_ROW_EVERY).sum()))
    pos = 0
    for v, n in enumerate(lengths.tolist()):
        frames = host_bank.setdefault(v, {})
        for f in range(CHARADES_ROW_EVERY - 1, n, CHARADES_ROW_EVERY):
            frames.setdefault(f, feats[pos])
            pos += 1
    return host_bank


def synthetic_host_bank(host_bank, rng):
    """Top ``host_bank`` up to AVA scale: every (video, sec) it lacks gets
    Poisson(2) rows (clipped to 25) from one tiled random block."""
    from lfb_tpu_torch.bank.device_bank import AVA_NUM_SECS, AVA_SEC_BASE
    counts = rng.poisson(2.0, size=(AVA_VIDEOS, AVA_NUM_SECS)).clip(0, 25)
    feats = tiled_rows(rng, int(counts.sum()))
    pos = 0
    for v in range(AVA_VIDEOS):
        secs = host_bank.setdefault(v, {})
        for si in np.nonzero(counts[v])[0]:
            n = int(counts[v, si])
            secs.setdefault(int(si) + AVA_SEC_BASE, list(feats[pos:pos + n]))
            pos += n
    return host_bank


def timed(batches, stamps):
    """Yield ``batches``, appending the host clock to ``stamps`` once the
    card is idle before each batch and after the last: ``stamps`` then
    bounds each batch's work, whatever consumes the batches."""
    import torch
    for batch in batches:
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        yield batch
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())


# Kernel name -> its launch counter in the port's counter registry.
COUNTERS = {'fused_bottleneck': 'kernel.bottleneck.fwd',
            'stem_conv': 'kernel.stem.fwd',
            'stem_conv_dw': 'kernel.stem.dw',
            'roi_align_maxpool': 'kernel.roi_align.fwd',
            'roi_align_maxpool_bwd': 'kernel.roi_align.bwd',
            'attention': 'kernel.attention.fwd',
            'attention_bwd': 'kernel.attention.bwd',
            'affine_act': 'kernel.affine.fwd',
            'affine_act_bwd': 'kernel.affine.bwd',
            'max_pool': 'kernel.pool.fwd',
            'max_pool_saved': 'kernel.pool.fwd_saved',
            'max_pool_bwd': 'kernel.pool.bwd'}
_LAUNCHES_AT_RESET = {}


def reset_launches():
    """Count launches from here on (:func:`read_launches`)."""
    from lfb_tpu_torch.utils.profiling import counts
    _LAUNCHES_AT_RESET.clear()
    _LAUNCHES_AT_RESET.update(counts())


def read_launches():
    """Kernel name -> its launches since the last :func:`reset_launches`."""
    from lfb_tpu_torch.utils.profiling import counts
    now = counts()
    return {name: now.get(key, 0) - _LAUNCHES_AT_RESET.get(key, 0)
            for name, key in COUNTERS.items()}


def run_phase(label, fn, batches, per_forward):
    """Call ``fn`` on the batches (through :func:`timed`) with every launch
    counter at 0 just before and read just after; check the counters.
    Returns (ms per batch after the first, fn's result, launches)."""
    stamps = []
    reset_launches()
    result = fn(timed(batches, stamps))
    launches = read_launches()
    ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    want = {name: n * len(batches) for name, n in per_forward.items()}
    log('phase {}: launches {} (want {}); ms per batch {}'.format(
        label, launches, want, ['{:.1f}'.format(m) for m in ms]))
    if launches != want or len(ms) != len(batches):
        raise AssertionError('phase {}: kernel launch counts {} != {}'.format(
            label, launches, want))
    steady = statistics.mean(ms[1:])
    log('phase {}: {:.1f} ms per batch after the first, {:.1f} clips/s'.format(
        label, steady, B / (steady / 1e3)))
    return steady, result, launches


def main_path(cfg):
    """Phase 4: bank extraction, the AVA-scale bank, FBO inference, unfused
    and fused."""
    import torch
    from lfb_tpu_torch.bank.device_bank import build_device_bank
    from lfb_tpu_torch.bank.lfb import extract_ava_bank
    from lfb_tpu_torch.config import flagship_cfg
    from lfb_tpu_torch.models.spec import build_spec
    from lfb_tpu_torch.train.steps import make_eval_step
    dev = torch.device('cuda')
    spec_a = build_spec(cfg, 'test', lfb_infer_only=True)
    spec_b = build_spec(cfg, 'test')
    params = perturbed_params(spec_b, dev)
    rng = np.random.default_rng(SEED + 2)
    torch.cuda.reset_peak_memory_stats()

    # Phase A through the entry point: each batch's time includes its
    # features' copy to the host bank; building the bank from the collected
    # features (construct_ava_lfb, 128 rows) follows the last stamp.
    batches = [make_batch(spec_a, rng, dev) for _ in range(EXTRACT_BATCHES)]
    ms_a, host_bank, launches_a = run_phase(
        'A (bank extraction)', lambda bs: extract_ava_bank(spec_a, params, bs),
        batches, PER_FORWARD['A'])
    feats = [f for s in host_bank.values() for fs in s.values() for f in fs]
    if len(feats) != EXTRACT_BATCHES * B * BOXES_PER_CLIP or not all(
            f.shape == (2048,) and np.isfinite(f).all() for f in feats):
        raise AssertionError('phase A: bad host bank')
    del batches

    t0 = time.perf_counter()
    host_bank = synthetic_host_bank(host_bank, rng)
    t1 = time.perf_counter()
    bank = build_device_bank(cfg, host_bank, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del host_bank
    bank_gb = bank.feats.numel() * bank.feats.element_size() / 2 ** 30
    log('bank: {} rows ({} extracted) x 2048 {} = {:.2f} GiB on the card; '
        'synthesis {:.1f} s, build + copy {:.1f} s'.format(
            bank.feats.shape[0], len(feats),
            str(bank.feats.dtype).split('.')[-1], bank_gb, t1 - t0, t2 - t1))

    infer = make_eval_step(spec_b, bank=bank, bank_seed=SEED)
    batches = [make_batch(spec_b, rng, dev) for _ in range(INFER_BATCHES)]
    ms_b, outs, launches_b = run_phase(
        'B (FBO inference, device bank)',
        lambda bs: [infer(params, b) for b in bs], batches, PER_FORWARD['B'])
    for out in outs:
        prob = out['prob']
        if tuple(prob.shape) != (B * BOXES_PER_CLIP, spec_b.num_classes) or \
                not (torch.isfinite(out['logits']).all()
                     and bool(((prob >= 0) & (prob <= 1)).all())):
            raise AssertionError('phase B: bad logits/prob')
    log('two-phase: {:.1f} clips/s (each clip once per phase); peak device '
        'memory {:.2f} GiB'.format(2 * B / ((ms_a + ms_b) / 1e3),
                                  torch.cuda.max_memory_allocated() / 2 ** 30))

    # The same batches, bank and params through the fused identity blocks.
    infer = make_eval_step(
        build_spec(flagship_cfg({**CFG_OVERRIDES, **FUSED}), 'test'),
        bank=bank, bank_seed=SEED)
    ms_f, outs_f, launches_f = run_phase(
        'B fused (TPU.PALLAS_BOTTLENECK)',
        lambda bs: [infer(params, b) for b in bs], batches,
        PER_FORWARD['B fused'])
    # Both bf16 paths against the same batches through the f32 model.  The
    # unfused bf16 path itself lies about 1.1e-2 from it (max over the
    # batch's probs), so the fused path is held to 2e-2 of each.
    infer = make_eval_step(build_spec(flagship_cfg(
        {**CFG_OVERRIDES, 'TPU.COMPUTE_DTYPE': 'float32'}), 'test'),
        bank=bank, bank_seed=SEED)
    f32 = [infer(params, b) for b in batches]

    def dist(xs, ys):
        d = torch.cat([(x['prob'].float() - y['prob'].float()).abs().flatten()
                       for x, y in zip(xs, ys, strict=True)])
        return d.max().item(), d.mean().item()

    (diff, diff_mean), (d_fused, _), (d_unfused, _) = (
        dist(outs_f, outs), dist(outs_f, f32), dist(outs, f32))
    log('phase B fused vs unfused: {:.1f} vs {:.1f} ms per batch; prob max '
        '|diff| {:.3e} (mean {:.3e}; bound 2e-2); max |diff| from the f32 '
        'model: fused {:.3e} (bound 2e-2), unfused {:.3e}'.format(
            ms_f, ms_b, diff, diff_mean, d_fused, d_unfused))
    if not (diff <= 2e-2 and d_fused <= 2e-2):
        raise AssertionError('phase B fused: prob {:.3e} from the unfused and '
                             '{:.3e} from the f32 prob'.format(diff, d_fused))
    return {k: launches_a[k] + launches_b[k] + launches_f[k]
            for k in launches_a}, bank


def charades_path():
    """Phase 5: the Charades main path with the fused bottleneck: frame-level
    bank extraction, the val-scale frame bank on the card, FBO inference
    with windows gathered from it.  Returns the launches and the bank (for
    the Charades train step of phase 11)."""
    import torch
    from lfb_tpu_torch.bank.device_bank import build_device_bank
    from lfb_tpu_torch.bank.lfb import extract_frame_bank
    from lfb_tpu_torch.config import charades_cfg
    from lfb_tpu_torch.models.spec import build_spec
    from lfb_tpu_torch.train.steps import make_eval_step
    dev = torch.device('cuda')
    cfg = charades_cfg({**CFG_OVERRIDES, **FUSED})
    spec_a = build_spec(cfg, 'test', lfb_infer_only=True)
    spec_b = build_spec(cfg, 'test')
    params = perturbed_params(spec_b, dev)
    rng = np.random.default_rng(SEED + 7)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    # The sweep's clip list: distinct (video, bank frame) pairs.
    n = EXTRACT_BATCHES * B
    clips = [(int(v), CHARADES_ROW_EVERY * int(k) - 1) for v, k in zip(
        rng.choice(CHARADES_VIDEOS, n, replace=False),
        rng.integers(1, CHARADES_FRAMES[0] // CHARADES_ROW_EVERY + 1, n))]
    batches = [make_clip_batch(spec_a, rng, dev)
               for _ in range(EXTRACT_BATCHES)]
    ms_a, host_bank, launches_a = run_phase(
        'Charades A (frame-level bank extraction)',
        lambda bs: extract_frame_bank(spec_a, params, bs, clips, 'charades'),
        batches, PER_FORWARD['Charades A'])
    feats = [f for frames in host_bank.values() for f in frames.values()]
    if len(feats) != n or not all(f.shape == (2048,) and np.isfinite(f).all()
                                  for f in feats):
        raise AssertionError('Charades phase A: bad host bank')
    del batches

    t0 = time.perf_counter()
    host_bank = synthetic_frame_bank(host_bank, rng)
    t1 = time.perf_counter()
    bank = build_device_bank(cfg, host_bank, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del host_bank
    log_bank('Charades', bank, n, ('synthesis', t1 - t0),
             ('build + copy', t2 - t1))

    infer = make_eval_step(spec_b, bank=bank)
    batches = [make_clip_batch(spec_b, rng, dev)
               for _ in range(INFER_BATCHES)]
    ms_b, outs, launches_b = run_phase(
        'Charades B (FBO inference, frame device bank)',
        lambda bs: [infer(params, b) for b in bs], batches,
        PER_FORWARD['Charades B'])
    check_clip_outputs('Charades phase B', outs, spec_b)
    log('Charades two-phase: {:.1f} clips/s (each clip once per phase); '
        'peak device memory {:.2f} GiB, {:.2f} GiB of it held from the '
        'flagship phases (their bank and params)'.format(
            2 * B / ((ms_a + ms_b) / 1e3),
            torch.cuda.max_memory_allocated() / 2 ** 30, held / 2 ** 30))
    return {k: launches_a[k] + launches_b[k] for k in launches_a}, bank


def check_clip_outputs(label, outs, spec):
    """Each batch's prob: (B, classes), finite logits, values in [0, 1];
    softmax rows (single-label heads) summing to 1 within 1e-3."""
    import torch
    for out in outs:
        prob = out['prob'].float()
        ok = (tuple(prob.shape) == (B, spec.num_classes)
              and bool(torch.isfinite(out['logits']).all())
              and bool(((prob >= 0) & (prob <= 1)).all()))
        if ok and not spec.multi_label:
            ok = (prob.sum(-1) - 1).abs().max().item() <= 1e-3
        if not ok:
            raise AssertionError('{}: bad logits/prob'.format(label))


def epic_videos(rng):
    """The EPIC val split's videos: names (P26_01, P27_01, ...), each
    one's length in frames (2-16 min, scaled to 7.4 h in all), and the
    dense ids of the bank's video index,
    a permutation of the names' order; returns (names, {name: frames},
    {name: id}, frames by id)."""
    names = ['{}_{:02d}'.format(EPIC_PERSONS[i % len(EPIC_PERSONS)],
                                i // len(EPIC_PERSONS) + 1)
             for i in range(EPIC_VIDEOS)]
    frames = rng.integers(EPIC_FRAMES[0], EPIC_FRAMES[1] + 1, EPIC_VIDEOS)
    frames = np.clip(np.round(frames * (EPIC_TOTAL_FRAMES / frames.sum())),
                     *EPIC_FRAMES).astype(np.int64)
    ids = rng.permutation(EPIC_VIDEOS)
    by_id = np.empty(EPIC_VIDEOS, np.int64)
    by_id[ids] = frames
    return (names, dict(zip(names, frames.tolist())),
            dict(zip(names, ids.tolist())), by_id)


def bank_frames(n):
    """A video of ``n`` frames' bank frames: one a second (the verb bank's
    sweep takes frames 30, 60, ..., ``lfb_tpu/data/epic.py:
    lfb_frame_annotations``; the noun bank's detector ran at 1 fps)."""
    return range(EPIC_FPS, n + 1, EPIC_FPS)


def synthetic_verb_bank(host_bank, frames_of, rng):
    """Top the EPIC verb ``host_bank`` {video name: {frame: feat}} up to a
    row at every bank frame of every video."""
    feats = tiled_rows(rng, sum(len(bank_frames(n))
                                for n in frames_of.values()))
    pos = 0
    for name, n in frames_of.items():
        frames = host_bank.setdefault(name, {})
        for f in bank_frames(n):
            frames.setdefault(f, feats[pos])
            pos += 1
    return host_bank


def synthetic_noun_bank(frames_of, name_to_idx, rng):
    """A detector bank {video id: {frame: (n, 2048)}} with n drawn from
    0-10 at every bank frame; returns it and its row count."""
    counts = {name: rng.integers(0, EPIC_MAX_BOXES + 1, len(bank_frames(n)))
              for name, n in frames_of.items()}
    total = sum(int(c.sum()) for c in counts.values())
    feats = tiled_rows(rng, total)
    bank, pos = {}, 0
    for name, n in frames_of.items():
        frames = bank[name_to_idx[name]] = {}
        for f, k in zip(bank_frames(n), counts[name].tolist()):
            frames[f] = feats[pos:pos + k]
            pos += k
    return bank, total


def log_cfg(label, cfg, spec):
    log('{}: configs/epic_{}_r50_lfb_nl.yaml by the port\'s load_config: R{} '
        'arc {}, {} {} classes, FBO-{} {} layers ({}-act) over {} rows, T {}, '
        'crop {}, fused bottleneck {}'.format(
            label, cfg.EPIC.CLASS_TYPE, spec.depth, spec.arc_choice,
            spec.num_classes, 'sigmoid' if spec.multi_label else 'softmax',
            spec.fbo.fbo_type, spec.fbo.num_layers,
            'pre' if spec.fbo.pre_act else 'post', spec.fbo.num_lfb_feat,
            spec.video_length, spec.crop_size, spec.use_pallas_bottleneck))


def log_bank(label, bank, extracted, *stages):
    """The device bank's rows, size and index table, and the seconds of
    each (name, seconds) stage that built it."""
    log('{} bank: {} rows ({} extracted) x 2048 {} = {:.2f} GiB on the card, '
        '{} videos x {} table columns; {}'.format(
            label, bank.feats.shape[0], extracted,
            str(bank.feats.dtype).split('.')[-1],
            bank.feats.numel() * bank.feats.element_size() / 2 ** 30,
            bank.num_videos(), bank.frame_ids.shape[1],
            ', '.join('{} {:.1f} s'.format(k, v) for k, v in stages)))


def log_gather(label, bank, batch):
    """The window gather's time (``choose_rows``' argsort over the table
    width, then the rows) for one batch's keys."""
    ms = cuda_ms(lambda: bank.gather_centers(batch['lfb_video_idx'],
                                             batch['lfb_center']),
                 TIMING_ITERS)
    log('{}: the window gather of {} clips takes {:.3f} ms (median of {})'
        .format(label, B, ms, TIMING_ITERS))


def epic_verb_path(videos):
    """Phase 6: EPIC verb with the fused bottleneck: the bank sweep over
    clips named by video (phase A), the bank topped up to the val split and
    keyed by the dense ids of ``video_name_to_idx``, FBO inference with
    windows gathered from it (phase B).  Returns the launches and (spec,
    params, bank, a phase-B batch) for :func:`checkpoint_phase`."""
    import torch
    from lfb_tpu_torch.bank.device_bank import build_device_bank
    from lfb_tpu_torch.bank.lfb import extract_frame_bank
    from lfb_tpu_torch.config import epic_verb_cfg
    from lfb_tpu_torch.models.spec import build_spec
    from lfb_tpu_torch.train.steps import make_eval_step
    dev = torch.device('cuda')
    names, frames_of, name_to_idx, lengths = videos
    cfg = epic_verb_cfg({**CFG_OVERRIDES, **FUSED})
    spec_a = build_spec(cfg, 'test', lfb_infer_only=True)
    spec_b = build_spec(cfg, 'test')
    log_cfg('EPIC verb', cfg, spec_b)
    params = perturbed_params(spec_b, dev)
    rng = np.random.default_rng(SEED + 11)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    # The sweep's clip list: rows (person, video name, frame, frame, 0, 0)
    # as lfb_frame_annotations makes them, distinct videos.
    n = EXTRACT_BATCHES * B
    clips = [(names[v][:3], names[v], f, f, 0, 0) for v, f in zip(
        rng.choice(EPIC_VIDEOS, n, replace=False).tolist(),
        (EPIC_FPS * rng.integers(1, EPIC_FRAMES[0] // EPIC_FPS + 1,
                                 n)).tolist())]
    batches = [make_clip_batch(spec_a, rng, dev)
               for _ in range(EXTRACT_BATCHES)]
    ms_a, host_bank, launches_a = run_phase(
        'EPIC verb A (bank extraction by video name)',
        lambda bs: extract_frame_bank(spec_a, params, bs, clips, 'epic'),
        batches, PER_FORWARD['EPIC verb A'])
    feats = [f for frames in host_bank.values() for f in frames.values()]
    if sorted(host_bank) != sorted(c[1] for c in clips) or not all(
            f.shape == (2048,) and np.isfinite(f).all() for f in feats):
        raise AssertionError('EPIC verb phase A: bad host bank')
    del batches

    t0 = time.perf_counter()
    host_bank = synthetic_verb_bank(host_bank, frames_of, rng)
    t1 = time.perf_counter()
    bank = build_device_bank(cfg, host_bank, name_to_idx, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del host_bank
    log_bank('EPIC verb', bank, n, ('synthesis', t1 - t0),
             ('build + copy', t2 - t1))

    infer = make_eval_step(spec_b, bank=bank)
    batches = [make_clip_batch(spec_b, rng, dev, lengths=lengths)
               for _ in range(INFER_BATCHES)]
    ms_b, outs, launches_b = run_phase(
        'EPIC verb B (FBO inference, name-keyed frame device bank)',
        lambda bs: [infer(params, b) for b in bs], batches,
        PER_FORWARD['EPIC verb B'])
    check_clip_outputs('EPIC verb phase B', outs, spec_b)
    log_gather('EPIC verb phase B', bank, batches[0])
    log('EPIC verb two-phase: {:.1f} clips/s (each clip once per phase); '
        'peak device memory {:.2f} GiB, {:.2f} GiB of it held from the '
        'flagship phases'.format(
            2 * B / ((ms_a + ms_b) / 1e3),
            torch.cuda.max_memory_allocated() / 2 ** 30, held / 2 ** 30))
    return ({k: launches_a[k] + launches_b[k] for k in launches_a},
            (spec_b, params, bank, batches[0]))


def epic_noun_path(videos):
    """Phase 7: EPIC noun, phase B only (its bank comes from a detector),
    unfused: a synthetic detector bank over the same videos goes the
    released path, ``write_lfb``, ``LFB.LOAD_LFB_PATH`` set by a CLI-style
    override, ``load_lfb``, ``build_device_bank``; then FBO inference with
    120-row windows gathered from it."""
    import tempfile
    import torch
    from lfb_tpu_torch.bank.device_bank import build_device_bank
    from lfb_tpu_torch.bank.lfb import load_lfb, write_lfb
    from lfb_tpu_torch.config import epic_noun_cfg
    from lfb_tpu_torch.core.config import merge_cfg_from_list
    from lfb_tpu_torch.models.spec import build_spec
    from lfb_tpu_torch.ops import cuda_build
    from lfb_tpu_torch.train.steps import make_eval_step
    dev = torch.device('cuda')
    _, frames_of, name_to_idx, lengths = videos
    cfg = epic_noun_cfg(CFG_OVERRIDES)
    spec_b = build_spec(cfg, 'test')
    log_cfg('EPIC noun', cfg, spec_b)
    params = perturbed_params(spec_b, dev)
    rng = np.random.default_rng(SEED + 12)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    host_bank, rows = synthetic_noun_bank(frames_of, name_to_idx, rng)
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(
            prefix='epic_noun_lfb_', dir=cuda_build.BUILD_DIR.parent) as d:
        merge_cfg_from_list(cfg, ['CHECKPOINT.DIR', d, 'LFB.LOAD_LFB_PATH', d])
        path = write_lfb(cfg, host_bank, is_train=False)
        size = os.path.getsize(path)
        del host_bank
        t2 = time.perf_counter()
        host_bank = load_lfb(cfg, is_train=False)
        t3 = time.perf_counter()
    bank = build_device_bank(cfg, host_bank, device=dev)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    del host_bank
    if bank.feats.shape[0] != rows + 1:
        raise AssertionError('EPIC noun bank: {} rows, not {}'.format(
            bank.feats.shape[0] - 1, rows))
    log_bank('EPIC noun', bank, 0, ('synthesis', t1 - t0),
             ('write_lfb ({:.2f} GiB pickle)'.format(size / 2 ** 30), t2 - t1),
             ('load_lfb', t3 - t2), ('build + copy', t4 - t3))

    infer = make_eval_step(spec_b, bank=bank)
    batches = [make_clip_batch(spec_b, rng, dev, lengths=lengths)
               for _ in range(INFER_BATCHES)]
    _, outs, launches = run_phase(
        'EPIC noun B (FBO inference, detector device bank)',
        lambda bs: [infer(params, b) for b in bs], batches,
        PER_FORWARD['EPIC noun B'])
    check_clip_outputs('EPIC noun phase B', outs, spec_b)
    log_gather('EPIC noun phase B', bank, batches[0])
    log('EPIC noun: peak device memory {:.2f} GiB, {:.2f} GiB of it held from '
        'the earlier phases'.format(
            torch.cuda.max_memory_allocated() / 2 ** 30, held / 2 ** 30))
    return launches


def checkpoint_phase(spec, params, bank, batch):
    """Phase 8: the port's checkpoint layer on the card.  ``save_params``
    of the EPIC verb params and an ``SGDState``'s momentum, then
    ``load_params_into`` fresh ones on the card: every tensor bitwise.
    Then a K400-style pretrained pickle built from the port's own names of
    the BN-mode R50 (``_bn_rm`` / ``_bn_riv``, ``*_momentum``, a 400-class
    classifier, a 2-D stem kernel) loads with ``convert_model``: the BN
    folds, the classifier and the FBO keep their values, the stem inflates,
    every other blob loads as it is; one EPIC verb forward on it is
    finite."""
    import tempfile
    import torch
    from lfb_tpu_torch.config import epic_verb_cfg
    from lfb_tpu_torch.models.model import init_params
    from lfb_tpu_torch.models.spec import build_spec
    from lfb_tpu_torch.ops import cuda_build
    from lfb_tpu_torch.train import checkpoints, optimizer
    from lfb_tpu_torch.train.steps import make_eval_step, split_params
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    _, frozen = split_params(spec, params)
    state = optimizer.init_state(params, set(frozen))
    for value in state.momentum.values():
        value.normal_(generator=g)
    fresh = init_params(spec, torch.Generator(device=dev).manual_seed(
        SEED + 14))
    bn_spec = build_spec(epic_verb_cfg({
        **CFG_OVERRIDES, 'MODEL.USE_AFFINE': False, 'NONLOCAL.USE_BN': True,
        'NONLOCAL.USE_AFFINE': False, 'MODEL.NUM_CLASSES': 400,
        'LFB.ENABLED': False}), 'test')
    rng = np.random.default_rng(SEED + 13)
    blobs = {k: v.cpu().numpy() for k, v in perturbed_params(bn_spec,
                                                              dev).items()}
    for name in blobs:
        if name.endswith('_bn_riv'):
            blobs[name] = 1 + 0.1 * np.abs(rng.standard_normal(
                blobs[name].shape, np.float32))
    blobs['conv1_w'] = np.ascontiguousarray(blobs['conv1_w'][:, :, 0])
    for name in ('conv1_w', 'res2_0_branch2a_w', 'pred_w'):
        blobs[name + '_momentum'] = np.ones_like(blobs[name])
    with tempfile.TemporaryDirectory(
            prefix='checkpoints_', dir=cuda_build.BUILD_DIR.parent) as d:
        path = os.path.join(d, 'c2_model_iter36000.pkl')
        t0 = time.perf_counter()
        checkpoints.save_params(path, params, model_iter=36000, lr=1e-5,
                                momentum=state.momentum)
        t1 = time.perf_counter()
        loaded, momentum, it, _ = checkpoints.load_params_into(
            path, fresh, load_momentum=True,
            momentum=optimizer.init_state(fresh, set(frozen)).momentum)
        t2 = time.perf_counter()
        size = os.path.getsize(path)
        k400 = os.path.join(d, 'r50_k400_pretrained.pkl')
        checkpoints.write_pkl(k400, {'blobs': blobs})
        converted, _, _, _ = checkpoints.load_params_into(
            k400, fresh, convert_model=True)
    for got, want in ((loaded, params), (momentum, state.momentum)):
        if sorted(got) != sorted(want) or not all(
                got[k].is_cuda and got[k].dtype == torch.float32
                and torch.equal(got[k], want[k]) for k in want):
            raise AssertionError('checkpoint round trip: not bitwise')
    if it != 36000:
        raise AssertionError('checkpoint round trip: model_iter {}'.format(it))
    log('checkpoint: save_params of {} params + {} momentum buffers ({:.2f} '
        'GiB pickle) {:.1f} s, load_params_into on the card {:.1f} s: every '
        'tensor bitwise'.format(len(params), len(state.momentum),
                                size / 2 ** 30, t1 - t0, t2 - t1))

    kept, folded = [], 0
    for name, value in converted.items():
        if name.startswith('pred_') or name not in blobs:
            kept.append(name)
            want = fresh[name]
        elif name == 'conv1_w':
            want = torch.from_numpy(blobs[name] / np.float32(5))[:, :, None]
            want = want.expand(value.shape).to(dev)
        elif name.endswith(('_bn_s', '_bn_b')) and (
                name[:-len('_bn_s')] + '_bn_rm' in blobs):
            layer = name[:-len('_bn_s')]
            std = np.sqrt(blobs[layer + '_bn_riv'] + 1e-5)
            scale = blobs[layer + '_bn_s']
            want = torch.from_numpy(
                scale / std if name.endswith('_s')
                else blobs[layer + '_bn_b'] - blobs[layer + '_bn_rm'] * scale
                / std).to(dev)
            folded += name.endswith('_s')
        else:
            want = torch.from_numpy(blobs[name]).to(dev)
        if value.shape != want.shape or not torch.equal(value, want):
            raise AssertionError('K400 conversion: {}'.format(name))
    if not (kept and all(k.startswith(('pred_', 'lfb_')) or 'fbonl' in k
                         for k in kept) and 'pred_w' in kept
            and blobs['pred_w'].shape == (400, 2048)):
        raise AssertionError('K400 conversion: kept {}'.format(kept))
    out = make_eval_step(spec, bank=bank)(converted, batch)
    if not bool(torch.isfinite(out['logits']).all()):
        raise AssertionError('K400 conversion: non-finite logits')
    log('checkpoint: a K400-style pickle ({} blobs, 400 classes) loaded with '
        'convert_model: {} BN layers folded, the stem inflated to {}, {} '
        'params kept (classifier, FBO); an EPIC verb forward on it is '
        'finite'.format(len(blobs), folded, tuple(converted['conv1_w'].shape),
                        len(kept)))


def check_backward_kernels(iters=TIMING_ITERS):
    """Phase 9: each backward kernel vs its plain version at the train
    steps' shapes (T 32, crop 224): at the released global batch, B = 16
    clips x 4 boxes (phase 11's remat steps, phase 13's steps), whose
    results the kernel line reports, and at phase 11's B = 8; the RoI pair
    also on the dataset's padded rows at B = 16 (phase 13), and the
    attention backward at Charades stage 2's FBO-NL shape (phase 11).  The
    tolerances are those of :func:`check_backward_at`."""
    import torch
    from lfb_tpu_torch.ops import cuda_attention, cuda_roi_align
    results = check_backward_at(REMAT_B, iters)
    check_backward_at(TRAIN_B, iters)
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(SEED + 18)
    rng = np.random.default_rng(SEED + 18)
    fmap = torch.relu(torch.randn((REMAT_B, 14, 14, 2048), generator=g,
                                  device=dev))
    rois = torch.from_numpy(roi_layout(rng, REMAT_B, MAX_BOXES_PER_CLIP,
                                       224)).to(dev)
    dout = torch.randn((rois.shape[0], 2048), generator=g, device=dev)
    for label, kernel_fn, plain_fn in (
            ('roi_align_maxpool',
             lambda: cuda_roi_align.roi_align_maxpool(fmap, rois),
             lambda: cuda_roi_align.roi_align_maxpool_plain(fmap, rois)),
            ('roi_align_maxpool_bwd',
             lambda: cuda_roi_align.roi_align_maxpool_bwd(fmap, rois, dout),
             lambda: cuda_roi_align.roi_align_maxpool_bwd_plain(fmap, rois,
                                                                dout))):
        compare('{} fmap{} rois{} f32, the dataset layout (phase 13)'.format(
            label, tuple(fmap.shape), tuple(rois.shape)), kernel_fn,
            plain_fn, 1e-5, iters)
    del fmap, dout
    # Charades stage 2: the FBO-NL's window of 20 rows, f32.
    q, do = (torch.randn((REMAT_B, 1, 512), generator=g, device=dev)
             for _ in range(2))
    k, v = (torch.randn((REMAT_B, 20, 512), generator=g, device=dev)
            for _ in range(2))
    out, lse = cuda_attention.fused_attention_lse(q, k, v, scale=512 ** -0.5)
    delta = (do * out).sum(-1)
    compare('attention_bwd Charades FBO-NL q{} k{} float32'.format(
        tuple(q.shape), tuple(k.shape)),
        lambda: cuda_attention.fused_attention_bwd(q, k, v, do, lse, delta,
                                                   scale=512 ** -0.5),
        lambda: cuda_attention.attention_bwd_plain(q, k, v, do, lse, delta,
                                                   512 ** -0.5), 1e-5, iters)
    return results


def check_backward_at(n_clips, iters):
    """Each backward kernel vs its plain version at a train step's shapes
    for ``n_clips`` clips x 4 boxes, and the forward attention kernel's row
    log-sum-exp vs ``torch.logsumexp``; returns the results, the attention
    rows summed over the 8 calls of a train step.

    Bounds, relative to max |plain| of each output: attention 1e-5 in f32
    and 1e-2 in bf16 (both sides form f32 gradients from the same inputs, in
    other orders); lse 1e-5; RoI 1e-5 (f32 sums of at most 16 x 4 terms per
    bin and box); stem dW 1e-2 (cuDNN's bf16 weight gradient rounds its
    output to bf16, the kernel keeps its f32 sum).
    """
    import torch
    from lfb_tpu_torch.ops import cuda_attention, cuda_roi_align, cuda_stem
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    rng = np.random.default_rng(SEED + 4)
    n = n_clips * BOXES_PER_CLIP
    results = {}

    x = torch.randint(0, 256, (n_clips, 32, 224, 224, 3), generator=g,
                      device=dev)
    x = ((x.float() / 255 - 0.45) / 0.225).to(torch.bfloat16)
    dy = torch.randn((n_clips, 32, 112, 112, 64), generator=g,
                     device=dev).to(torch.bfloat16)
    x_cl, dy_cl = x.permute(0, 4, 1, 2, 3), dy.permute(0, 4, 1, 2, 3)
    r = compare(
        'stem_conv_dw x{} dOut{} bf16'.format(tuple(x.shape), tuple(dy.shape)),
        lambda: cuda_stem.stem_conv_dw(x, dy, 5),
        lambda: cuda_stem.stem_conv_dw_plain(x, dy, 5), 1e-2, iters,
        lambda: torch.nn.grad.conv3d_weight(x_cl, (64, 3, 5, 7, 7), dy_cl,
                                            stride=(1, 2, 2),
                                            padding=(2, 3, 3)))
    results['stem_conv_dw'] = dict(
        r, tolerance='1e-2',
        library='torch.nn.grad.conv3d_weight (cuDNN, bf16)',
        **bound((1, cost.stem_dw(n_clips, 32, 224, 5))))
    # Its rate: the direct conv's operations (kT x 147 multiply-adds per
    # output gradient element) and those of the packed product it runs.
    direct, packed = 2 * dy.numel() * 5 * 147, 2 * dy.numel() * 5 * 256
    rate = direct / (r['device_ms'] * 1e-3) / 1e12
    log('  stem_conv_dw at B = {}: kernel device {:.4f} ms, {:.1f} TFLOP/s '
        'of the direct conv ({:.1f}% of the bf16 peak), {:.1f} of the '
        'packed product; cuDNN wgrad device {:.4f} ms; device kernel / cuDNN '
        '{:.3f}; {}'.format(n_clips, r['device_ms'], rate,
                            100 * rate * 1e12 / cost.PEAK_FLOPS['bfloat16'],
                            packed / (r['device_ms'] * 1e-3) / 1e12,
                            r['library_device_ms'],
                            r['device_ms'] / r['library_device_ms'],
                            card_line()))
    del x, dy, x_cl, dy_cl

    fmap = torch.relu(torch.randn((n_clips, 14, 14, 2048), generator=g,
                                  device=dev))
    rois_np = rand_rois(rng, n_clips, BOXES_PER_CLIP, 224)
    rois = torch.from_numpy(rois_np).to(dev)
    dout = torch.randn((n, 2048), generator=g, device=dev)
    # The forward at the train step's shape, logged only.
    compare('roi_align_maxpool fmap{} rois{} f32 (train shape)'.format(
        tuple(fmap.shape), tuple(rois.shape)),
        lambda: cuda_roi_align.roi_align_maxpool(fmap, rois),
        lambda: cuda_roi_align.roi_align_maxpool_plain(fmap, rois), 1e-5,
        iters)
    log('  roi_align_maxpool bound at the train shape: {:.4f} ms'.format(
        bound((1, cost.roi_fwd(rois_np, 14)))['bound_ms']))
    r = compare(
        'roi_align_maxpool_bwd fmap{} rois{} f32'.format(tuple(fmap.shape),
                                                         tuple(rois.shape)),
        lambda: cuda_roi_align.roi_align_maxpool_bwd(fmap, rois, dout),
        lambda: cuda_roi_align.roi_align_maxpool_bwd_plain(fmap, rois, dout),
        1e-5, iters)
    # The map's pixels the boxes reach are read; the whole gradient map is
    # written.
    results['roi_align_maxpool_bwd'] = dict(
        r, tolerance='1e-5',
        **bound((1, cost.roi_bwd(rois_np, n_clips, 14))))
    del fmap

    # (label, B, Nq, Nk, C, dtype, calls per train step)
    regimes = [('res3 NL', 4 * n_clips, 3136, 784, 256, torch.bfloat16, 2),
               ('res4 NL', n_clips, 3136, 784, 512, torch.bfloat16, 3),
               ('FBO-NL', n, 1, 300, 512, torch.float32, 3)]
    total = {'err': 0.0, 'ms': 0.0, 'device_ms': 0.0, 'plain_ms': 0.0,
             'library_ms': 0.0, 'library_device_ms': 0.0}
    parts, backends = [], []
    for label, b, nq, nk, c, dtype, calls in regimes:
        q, k, v, do = (torch.randn((b, m, c), generator=g, device=dev).to(dtype)
                       for m in (nq, nk, nk, nq))
        scale = c ** -0.5
        out, lse = cuda_attention.fused_attention_lse(q, k, v, scale=scale)
        ref_lse = torch.logsumexp(
            torch.matmul(q.float(), k.float().transpose(1, 2)) * scale, dim=-1)
        lse_rel = ((lse - ref_lse).abs().max() / ref_lse.abs().max()).item()
        log('attention lse {}: rel err {:.3e} vs torch.logsumexp (bound '
            '1e-05)'.format(label, lse_rel))
        if not lse_rel <= 1e-5:
            raise AssertionError('attention lse {}: {:.3e}'.format(label,
                                                                  lse_rel))
        delta = (do.float() * out.float()).sum(-1)
        lib_fwd, lib_fwd_bwd, backend = sdpa_call(q, k, v, do, scale)
        backends.append('{} {}'.format(label, backend))
        r = compare(
            'attention_bwd {} q{} k{} {}'.format(
                label, (b, nq, c), (b, nk, c), str(dtype).split('.')[-1]),
            lambda: cuda_attention.fused_attention_bwd(q, k, v, do, lse, delta,
                                                       scale=scale),
            lambda: cuda_attention.attention_bwd_plain(q, k, v, do, lse, delta,
                                                       scale),
            1e-2 if dtype == torch.bfloat16 else 1e-5, iters, lib_fwd_bwd)
        # SDPA's backward alone: its forward + backward less its forward.
        lib_ms = r['library_ms'] - cuda_ms(lib_fwd, max(iters, 1))
        lib_dev = r['library_device_ms'] - device_ms(lib_fwd)
        log('  SDPA backend for {}: {}; its backward {:.4f} ms (device '
            '{:.4f} ms)'.format(label, backend, lib_ms, lib_dev))
        if dtype == torch.bfloat16:
            log_regime('attention_bwd {} at B = {}'.format(label, n_clips),
                       10 * b * nq * nk * c,
                       dict(r, library_device_ms=lib_dev), 'SDPA backward')
            again = cuda_attention.fused_attention_bwd(q, k, v, do, lse,
                                                       delta, scale=scale)
            first = cuda_attention.fused_attention_bwd(q, k, v, do, lse,
                                                       delta, scale=scale)
            same = all(torch.equal(x, y) for x, y in zip(first, again))
            log('  attention_bwd {}: two calls bitwise equal: {}'.format(
                label, same))
            if not same:
                raise AssertionError('attention_bwd {}: two calls '
                                     'differ'.format(label))
            del again, first
        total['err'] = max(total['err'], r['err'])
        total['ms'] += calls * r['ms']
        total['device_ms'] += calls * r['device_ms']
        total['plain_ms'] += calls * r['plain_ms']
        total['library_ms'] += calls * lib_ms
        total['library_device_ms'] += calls * lib_dev
        parts.append((calls, cost.attention_bwd(b, nq, nk, c,
                                                str(dtype).split('.')[-1])))
    log('attention_bwd, the 8 calls of one train step at B = {}: kernel '
        '{:.3f} ms (device {:.3f} ms), plain {:.3f} ms, SDPA backward {:.3f} '
        'ms (device {:.3f} ms); device kernel / SDPA {:.3f}; {}'.format(
            n_clips, total['ms'], total['device_ms'], total['plain_ms'],
            total['library_ms'], total['library_device_ms'],
            total['device_ms'] / total['library_device_ms'], card_line()))
    results['attention_bwd'] = dict(
        total, tolerance='1e-5 f32, 1e-2 bf16',
        library='F.scaled_dot_product_attention backward ({})'.format(
            ', '.join(backends)), **bound(*parts))
    return results


def train_reference_check(cfg):
    """Phase 10: one full-width f32 train step (1 clip x 4 boxes, T 32, crop
    224, dropout 0) on the card (kernels) against the same step on the CPU
    (plain versions), from the same params and batch.

    Bounds, relative to the largest CPU value of each tensor: the loss 1e-4;
    each momentum buffer (after one step, lr times the gradient) 1e-3 for
    the FBO, classifier and res5 params and 2e-2 upstream (conv1, res2-res4,
    the backbone's non-local blocks).  Sums in other orders through 101
    layers can flip a near-zero ReLU gate in the backbone, which moves the
    gradients upstream of it (ROADMAP queue 3, "not faults").  A ``*_phi_b``
    buffer is held to the scale of its ``*_phi_w`` buffer: the softmax over
    the keys does not change when every key moves by the same vector, so
    that bias's exact gradient is zero and what both sides hold is rounding.
    """
    import torch
    from lfb_tpu_torch.config import flagship_cfg
    from lfb_tpu_torch.models.spec import build_spec
    spec = build_spec(flagship_cfg({**CFG_OVERRIDES, **F32_STEP}), 'train')
    params = perturbed_params(spec, torch.device('cuda'))
    batch = make_batch(spec, np.random.default_rng(SEED + 5), 'cuda',
                       n_clips=1, with_lfb=True, with_labels=True)
    (gpu_loss, _, gpu_m, _, gpu_s), (cpu_loss, _, cpu_m, _, cpu_s) = (
        one_step(device, spec, cfg.SOLVER, params, batch)
        for device in ('cuda', 'cpu'))
    loss_rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    log('train reference: loss card {:.7f} CPU {:.7f}, rel {:.3e} (bound '
        '1e-04); card {:.1f} s (first step), CPU {:.1f} s'.format(
            gpu_loss, cpu_loss, loss_rel, gpu_s, cpu_s))
    worst = {True: (0.0, ''), False: (0.0, '')}
    for name, ref in cpu_m.items():
        got = gpu_m[name]
        if not torch.isfinite(got).all():
            raise AssertionError('train reference: non-finite ' + name)
        scale = ref.abs().max().item()
        if name.endswith('_phi_b'):
            scale = max(scale, cpu_m[name[:-1] + 'w'].abs().max().item())
        rel = ((got - ref).abs().max() / max(scale, 1e-30)).item()
        # Downstream of the backbone's ReLU gates: FBO, classifier, res5.
        group = (name.startswith(('pred_', 'lfb_', 'res5_'))
                 or '_fbonl_reduc' in name)
        worst[group] = max(worst[group], (rel, name))
    bounds = {True: 1e-3, False: 2e-2}
    for group, label in ((True, 'FBO, classifier, res5'),
                         (False, 'conv1, res2-res4, non-local')):
        rel, name = worst[group]
        log('train reference momentum, {}: worst rel err {:.3e} ({}; bound '
            '{:.0e})'.format(label, rel, name, bounds[group]))
    if not (loss_rel <= 1e-4 and worst[True][0] <= bounds[True]
            and worst[False][0] <= bounds[False]):
        raise AssertionError('train reference check failed')


def train_steps(label, spec, solver, bank, batches, params, per_step):
    """``make_train_step`` over ``batches`` from ``params`` (updated in
    place), the step's generator seeded ``SEED + i`` and its LR
    ``get_lr_at_iter(solver, i)``: each step's launches must be
    ``per_step`` and its loss finite, with a prob of the batch's rows.
    Returns (losses, ms per step, the launches of all steps, the
    optimizer state)."""
    import torch
    from lfb_tpu_torch.parallel import mesh
    from lfb_tpu_torch.train import optimizer
    from lfb_tpu_torch.train.optimizer import get_lr_at_iter
    from lfb_tpu_torch.train.steps import make_train_step, split_params
    dev = torch.device('cuda')
    trainable, frozen = split_params(spec, params)
    state = optimizer.init_state(params, set(frozen))
    step = make_train_step(spec, solver, bank=bank)
    reset_launches()
    stamps, losses = [], []
    for i, batch in enumerate(timed(batches, stamps)):
        before = read_launches()
        trainable, frozen, state, aux = step(
            trainable, frozen, state, batch,
            torch.Generator(device=dev).manual_seed(SEED + i),
            get_lr_at_iter(solver, i))
        after = read_launches()
        got = {k: after[k] - before[k] for k in after}
        if got != per_step:
            raise AssertionError('{} step {}: launches {} != {}'.format(
                label, i, got, per_step))
        losses.append(aux['loss'].item())
        rows = len(batch['labels']) * mesh.world_size()   # prob is gathered
        if not np.isfinite(losses[-1]) or tuple(aux['prob'].shape) != (
                rows, spec.num_classes):
            raise AssertionError('{} step {}: loss {} prob {}'.format(
                label, i, losses[-1], tuple(aux['prob'].shape)))
    ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    return losses, ms, read_launches(), state


def log_steps(label, ms, warmup, clips, losses):
    """Log a train run's ms per step over the steps after ``warmup``, its
    clips/s and the peak device memory since the last reset; returns (ms
    per step, peak GiB)."""
    import torch
    steady = statistics.mean(ms[warmup:])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log('{}: losses {}; ms per step {}; {:.1f} ms per step over the {} timed '
        'steps, {:.2f} clips/s; peak device memory {:.2f} GiB ({})'.format(
            label, ['{:.5f}'.format(x) for x in losses],
            ['{:.1f}'.format(m) for m in ms], steady, len(ms) - warmup,
            clips / (steady / 1e3), peak, card_line()))
    return steady, peak


def train_phase(cfg, bank, charades_bank, verb_bank, verb_lengths):
    """Phase 11: the flagship train step at B = 8 clips x 4 boxes with the
    AVA-scale device bank (``TPU.REMAT ''``); then at B = 16 under
    ``TPU.REMAT`` 'stage' and '' from the same params, batches and
    generators (and one f32 clip under both); then Charades stage 2
    (``MODEL.FREEZE_BACKBONE``) at B = 16 under 'stage' with windows from
    ``charades_bank``; then EPIC verb stage 2 (``epic_verb_cfg``, R50, B =
    16, crop 224) with windows from phase 6's ``verb_bank`` (video lengths
    ``verb_lengths``).  Returns the launch counts of the steps, the ms per
    step at B = 16 under 'stage', and that run (its batches, and its
    losses, updated params and momentum) for phase 14."""
    import torch
    from lfb_tpu_torch.config import charades_cfg, epic_verb_cfg, flagship_cfg
    from lfb_tpu_torch.models.spec import build_spec
    dev = torch.device('cuda')
    spec = build_spec(cfg, 'train')
    log('train spec: crop {}, T {}, dropout {} / FBO {}, {}'.format(
        spec.crop_size, spec.video_length, spec.dropout_rate,
        spec.fbo.dropout_rate, spec.compute_dtype))
    rng = np.random.default_rng(SEED + 6)
    batches = [make_batch(spec, rng, dev, n_clips=TRAIN_B, with_labels=True)
               for _ in range(TRAIN_WARMUP + TRAIN_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    losses, ms, launches, state = train_steps(
        'train', spec, cfg.SOLVER, bank, batches,
        perturbed_params(spec, dev), PER_FORWARD['train'])
    for name in ('conv1_w', 'pred_w', 'lfb_nl2_out_w'):
        if not state.momentum[name].any():
            raise AssertionError('train: zero momentum for ' + name)
    log('train: launches per step {}'.format(PER_FORWARD['train']))
    log_steps('train at B = {}'.format(TRAIN_B), ms, TRAIN_WARMUP,
              TRAIN_B, losses)
    del batches, state
    all_launches = [launches]

    # The released global batch under each remat mode.
    rng = np.random.default_rng(SEED + 15)
    batches = [make_batch(spec, rng, dev, n_clips=REMAT_B, with_labels=True)
               for _ in range(TRAIN_WARMUP + TRAIN_STEPS)]
    runs = {}
    for mode in REMAT_MODES:
        spec_m = build_spec(flagship_cfg({**CFG_OVERRIDES,
                                          'TPU.REMAT': mode}), 'train')
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        per_step = PER_FORWARD['train stage' if mode else 'train']
        params = perturbed_params(spec_m, dev)
        losses, ms, launches, state = train_steps(
            'train, TPU.REMAT {!r}'.format(mode), spec_m, cfg.SOLVER, bank,
            batches, params, per_step)
        log('train, TPU.REMAT {!r}: launches per step {}'.format(mode,
                                                                per_step))
        runs[mode] = log_steps('train at B = {}, TPU.REMAT {!r}'.format(
            REMAT_B, mode), ms, TRAIN_WARMUP, REMAT_B, losses) + (
            losses, {k: params[k] for k in state.momentum}, state.momentum)
        all_launches.append(launches)
        del params, state
    stage_run = (batches, runs['stage'][2:])
    del batches
    (stage_ms, stage_peak, *stage), (ms0, peak0, *plain) = (
        runs['stage'], runs[''])
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(stage[0], plain[0]))
    params_rel, momentum_rel = (worst_leaf(a, b)
                                for a, b in zip(stage[1:], plain[1:]))
    f32 = remat_f32_check(cfg, bank)
    log("train remat at B = {}: 'stage' {:.1f} ms per step, peak {:.2f} GiB; "
        "'' {:.1f} ms, peak {:.2f} GiB ({}); 'stage' vs '' over the {} steps "
        'in bf16: the losses rel {:.3e} (bound {:.0e}), the updated params '
        'worst rel {:.3e} ({}; bound {:.0e}), the momentum worst rel {:.3e} '
        '({}; bound {:.0e}); one f32 step of one clip, \'stage\' vs \'\': '
        'the params worst rel {:.3e} ({}; bound {:.0e}), the momentum {:.3e} '
        "({}; bound {:.0e}); '' vs '' again: the params {:.3e}, the momentum "
        '{:.3e}'.format(
            REMAT_B, stage_ms, stage_peak, ms0, peak0, card_line(),
            TRAIN_WARMUP + TRAIN_STEPS, loss_rel, REMAT_BF16_BOUNDS[0],
            *params_rel, REMAT_BF16_BOUNDS[1], *momentum_rel,
            REMAT_BF16_BOUNDS[2], *f32[0], REMAT_F32_BOUNDS[0], *f32[1],
            REMAT_F32_BOUNDS[1], f32[2][0], f32[3][0]))
    if not (all(x <= bound for x, bound in zip(
            (loss_rel, params_rel[0], momentum_rel[0], f32[0][0], f32[1][0]),
            REMAT_BF16_BOUNDS + REMAT_F32_BOUNDS)) and stage_peak < peak0):
        raise AssertionError('train remat: the modes disagree or the peaks')

    # Charades stage 2: only the head trains.
    cfg_c = charades_cfg({**CFG_OVERRIDES, 'MODEL.FREEZE_BACKBONE': True,
                          'TPU.REMAT': 'stage'})
    spec_c = build_spec(cfg_c, 'train')
    rng = np.random.default_rng(SEED + 16)
    batches = []
    for _ in range(CHARADES_TRAIN_WARMUP + CHARADES_TRAIN_STEPS):
        batch = make_clip_batch(spec_c, rng, dev, n_clips=REMAT_B)
        batch['labels'] = torch.from_numpy((rng.random(
            (REMAT_B, spec_c.num_classes)) < 0.05).astype(np.float32)).to(dev)
        batches.append(batch)
    params = perturbed_params(spec_c, dev)
    backbone = params['res4_5_branch2b_w'].clone()
    torch.cuda.reset_peak_memory_stats()
    losses, ms, launches, state = train_steps(
        'Charades train', spec_c, cfg_c.SOLVER, charades_bank, batches,
        params, PER_FORWARD['Charades train'])
    heads = ('pred_', 'lfb_nl', 'lfb_1x1')
    if not (state.momentum and all(
            k.startswith(heads) or '_fbonl_reduc' in k
            for k in state.momentum)
            and torch.equal(params['res4_5_branch2b_w'], backbone)
            and state.momentum['pred_w'].any()):
        raise AssertionError('Charades train: momentum on {} names, the '
                             'backbone moved or the head did not'.format(
                                 len(state.momentum)))
    log('Charades train (FREEZE_BACKBONE, TPU.REMAT stage): launches per step '
        '{}; momentum on the {} head tensors only, the backbone '
        'unchanged'.format(PER_FORWARD['Charades train'], len(state.momentum)))
    log_steps('Charades train at B = {}, crop {}'.format(
        REMAT_B, spec_c.crop_size), ms, CHARADES_TRAIN_WARMUP, REMAT_B,
        losses)
    all_launches.append(launches)
    del batches, params, state

    # EPIC verb stage 2: the whole R50 trains.
    cfg_v = epic_verb_cfg(CFG_OVERRIDES)
    spec_v = build_spec(cfg_v, 'train')
    rng = np.random.default_rng(SEED + 17)
    batches = []
    for _ in range(EPIC_TRAIN_WARMUP + EPIC_TRAIN_STEPS):
        batch = make_clip_batch(spec_v, rng, dev, n_clips=REMAT_B,
                                lengths=verb_lengths)
        batch['labels'] = torch.from_numpy(rng.integers(
            0, spec_v.num_classes, REMAT_B).astype(np.int32)).to(dev)
        batches.append(batch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, ms, launches, state = train_steps(
        'EPIC verb train', spec_v, cfg_v.SOLVER, verb_bank, batches,
        perturbed_params(spec_v, dev), PER_FORWARD['EPIC verb train'])
    if not all(state.momentum[k].any() for k in ('conv1_w', 'pred_w')):
        raise AssertionError('EPIC verb train: zero momentum')
    log('EPIC verb train (R50, crop {}, T {}, dropout {}, TPU.REMAT {!r}, '
        '{} classes): launches per step {}'.format(
            spec_v.crop_size, spec_v.video_length, spec_v.dropout_rate,
            cfg_v.TPU.REMAT, spec_v.num_classes,
            PER_FORWARD['EPIC verb train']))
    log_steps('EPIC verb train at B = {}'.format(REMAT_B), ms,
              EPIC_TRAIN_WARMUP, REMAT_B, losses)
    all_launches.append(launches)
    return ({k: sum(n[k] for n in all_launches) for k in launches},
            stage_ms, stage_run)


def remat_f32_check(cfg, bank):
    """One step of one f32 clip x 4 boxes (dropout 0) under 'stage', under
    '' and under '' again, from the same params and batch; returns
    :func:`worst_leaf` of the updated trainable params and of the momentum,
    'stage' against '', then '' against ''."""
    import torch
    from lfb_tpu_torch.config import flagship_cfg
    from lfb_tpu_torch.models.spec import build_spec
    dev = torch.device('cuda')
    runs = []
    for mode in REMAT_MODES + ('',):
        spec = build_spec(flagship_cfg({
            **CFG_OVERRIDES, 'TPU.COMPUTE_DTYPE': 'float32',
            'TRAIN.DROPOUT_RATE': 0.0, 'FBO_NL.DROPOUT_RATE': 0.0,
            'TPU.REMAT': mode}), 'train')
        batch = make_batch(spec, np.random.default_rng(SEED + 5), dev,
                           n_clips=1, with_labels=True)
        per_step = PER_FORWARD['train stage' if mode else 'train']
        params = perturbed_params(spec, dev)
        state = train_steps(
            'f32 train, TPU.REMAT {!r}'.format(mode), spec, cfg.SOLVER, bank,
            [batch], params, per_step)[3]
        runs.append(({k: params[k] for k in state.momentum}, state.momentum))
    return (worst_leaf(runs[0][0], runs[1][0]),
            worst_leaf(runs[0][1], runs[1][1]),
            worst_leaf(runs[2][0], runs[1][0]),
            worst_leaf(runs[2][1], runs[1][1]))


def worst_leaf(got, ref, zero_grad=('_phi_b',)):
    """The largest difference of a tensor of ``got`` from that of ``ref``,
    relative to the largest |value| of the ``ref`` tensor: (rel, name).  A
    bias whose name ends in one of ``zero_grad`` (``*_phi_b``) is held to the
    scale of its weight (``*_phi_w``): its exact gradient is zero
    (:func:`train_reference_check` says why)."""
    worst = (0.0, '')
    for name, want in ref.items():
        scale = want.abs().max().item()
        if name.endswith(zero_grad):
            scale = max(scale, ref[name[:-1] + 'w'].abs().max().item())
        diff = (got[name].float() - want.float()).abs().max().item()
        worst = max(worst, (diff / scale if scale else diff, name))
    return worst


def write_ava_split(root, rng):
    """Phase 12's AVA split, in the reference's file formats (frame lists,
    GT and predicted-box CSVs, the labelmap, an empty exclusions file), the
    same videos and boxes in its train and val lists (phase 13 trains on
    it):
    ``DISK_VIDEOS`` videos of ``DISK_FRAMES`` JPEG frames each, named
    ``<video>_%06d.jpg``, 640 x 360 (a camera pan over smooth colour
    gradients, with N(0, 2) noise, so a file is the size of a real frame's);
    1-6 boxes a keyframe, predicted with scores uniform over 0.8-1.0, each a
    GT box with 1-3 of the 80 classes.  Returns (the config overrides, the
    predicted scores by (video idx, sec), the mean JPEG bytes, seconds)."""
    import cv2
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    h, w = DISK_SIZE
    y, x = np.mgrid[0:h, 0:w + DISK_FRAMES].astype(np.float32)
    noise = [rng.normal(0, 2, (h, w, 3)).astype(np.float32) for _ in range(4)]
    names = ['vid{:02d}'.format(v) for v in range(DISK_VIDEOS)]
    jobs, lists = [], ['original_vido_id video_id frame_id path labels']
    for v, name in enumerate(names):
        os.makedirs(os.path.join(root, 'frames', name))
        base = np.stack([128 + 90 * np.sin(x / 97.0 + v),
                         128 + 90 * np.cos(y / 61.0 + 2 * v) + 0 * x,
                         128 + 60 * np.sin((x + y) / 143.0 + 3 * v)], -1)
        for i in range(DISK_FRAMES):
            rel = os.path.join(name, '{}_{:06d}.jpg'.format(name, i + 1))
            jobs.append((os.path.join(root, 'frames', rel), base, i))
            lists.append('{} {} {} {} ""'.format(name, v, i, rel))

    def write(job):
        path, base, i = job
        img = np.clip(base[:, i:i + w] + noise[i % 4], 0, 255)
        if not cv2.imwrite(path, img.astype(np.uint8)):
            raise IOError('could not write ' + path)
        return os.path.getsize(path)

    with ThreadPoolExecutor(8) as pool:
        sizes = list(pool.map(write, jobs))
    os.makedirs(os.path.join(root, 'frame_lists'))
    for split in ('train', 'val'):
        with open(os.path.join(root, 'frame_lists', split + '.csv'), 'w') as f:
            f.write('\n'.join(lists) + '\n')
    ann = os.path.join(root, 'annotations')
    os.makedirs(ann)
    gt, pred, scores = [], [], {}
    for v, name in enumerate(names):
        for sec in DISK_KEYFRAMES:
            boxes = set()
            while len(boxes) < int(rng.integers(1, 7)) or not boxes:
                x1, y1 = rng.uniform(0, 0.5, 2)
                boxes.add('{:.3f},{:.3f},{:.3f},{:.3f}'.format(
                    x1, y1, min(1.0, x1 + rng.uniform(0.2, 0.5)),
                    min(1.0, y1 + rng.uniform(0.2, 0.5))))
            for box in sorted(boxes):
                score = '{:.3f}'.format(rng.uniform(0.8, 1.0))
                scores.setdefault((v, sec), []).append(float(score))
                pred.append('{},{},{},,{}'.format(name, sec, box, score))
                for label in rng.choice(80, int(rng.integers(1, 4)),
                                        replace=False):
                    gt.append('{},{},{},{}'.format(name, sec, box, label + 1))
    for fname, rows in (('ava_val_v2.1.csv', gt),
                        ('ava_val_predicted_boxes.csv', pred),
                        ('ava_train_v2.1.csv', gt),
                        ('ava_train_predicted_boxes.csv', pred)):
        with open(os.path.join(ann, fname), 'w') as f:
            f.write('\n'.join(rows) + '\n')
    with open(os.path.join(
            ann, 'ava_action_list_v2.1_for_activitynet_2018.pbtxt'), 'w') as f:
        for c in range(1, 81):
            f.write('item {\n  name: "action%d"\n  id: %d\n}\n' % (c, c))
    open(os.path.join(ann, 'ava_val_excluded_timestamps_v2.1.csv'), 'w').close()
    opts = ['DATADIR', os.path.join(root, 'frames'),
            'AVA.FRAME_LIST_DIR', os.path.join(root, 'frame_lists'),
            'AVA.ANNOTATION_DIR', ann]
    return opts, scores, statistics.mean(sizes), time.perf_counter() - t0


def same_bank(a, b):
    """Whether two AVA host banks hold the same rows, bitwise."""
    return a.keys() == b.keys() and all(
        a[v].keys() == b[v].keys() and all(
            len(a[v][sec]) == len(b[v][sec]) and all(
                np.array_equal(x, y) for x, y in zip(a[v][sec], b[v][sec]))
            for sec in b[v]) for v in b)


def check_disk_outputs(out, scores, metrics, batch_size):
    """Phase 12's checks of what ``test_net`` left in ``out``: the bank
    (``val_lfb.pkl``) holds one finite 2048-d row for each predicted box at
    or above 0.9, keyed by (video idx, sec), and the rows of the last
    batch's padding; the detections CSV one line per (box at or above 0.85,
    class); the frame-mAP is finite, in [0, 1].  Returns the bank."""
    import pickle
    full_map = metrics['full_map']
    if not (np.isfinite(full_map) and 0.0 <= full_map <= 1.0):
        raise AssertionError('phase 12: frame-mAP {}'.format(full_map))

    with open(os.path.join(out, 'val_lfb.pkl'), 'rb') as f:
        bank = pickle.load(f)
    got = {(v, sec): len(feats) for v, secs in bank.items()
           for sec, feats in secs.items()}
    expect = {k: n for k, ss in sorted(scores.items())
              for n in [sum(s >= 0.9 for s in ss)] if n}
    # As in lfb_tpu, the last batch is padded with its first keyframe, whose
    # boxes the sweep then adds once per padded slot (construct_ava_lfb
    # keeps every row of box_mask 1).
    last = list(expect)[(len(expect) - 1) // batch_size * batch_size]
    padded = -len(expect) % batch_size
    expect[last] += padded * expect[last]
    if got != expect or not all(
            f.shape == (2048,) and np.isfinite(f).all()
            for secs in bank.values() for feats in secs.values()
            for f in feats):
        raise AssertionError('phase 12: the bank has rows {} for the '
                             'predicted boxes {}'.format(got, expect))
    csvs = [f for f in os.listdir(out) if f.startswith('detections_')]
    if len(csvs) != 1:
        raise AssertionError('phase 12: detections CSVs {}'.format(csvs))
    with open(os.path.join(out, csvs[0])) as f:
        lines = f.read().splitlines()
    keys = {'vid{:02d},{:04d}'.format(v, sec): n for (v, sec), ss
            in scores.items() for n in [sum(s >= 0.85 for s in ss)] if n}
    per_key = {}
    for line in lines:
        key = ','.join(line.split(',')[:2])
        per_key[key] = per_key.get(key, 0) + 1
    if per_key != {k: 80 * n for k, n in keys.items()}:
        raise AssertionError('phase 12: {} detection lines, {} '
                             'expected'.format(len(lines),
                                               80 * sum(keys.values())))
    log('phase 12 checks: the bank {} rows over {} (video, sec) keys, finite: '
        'one per predicted box at or above 0.9, and {} rows of the last '
        "batch's {} padded slots (keyframe {}); {} detection lines ({} boxes "
        'x 80 classes); frame-mAP {:.4f} (random weights)'.format(
            sum(got.values()), len(got), padded * expect[last] // (padded + 1),
            padded, last, len(lines), sum(keys.values()), full_map))
    return bank


def log_feed(feed, phase=12):
    """Log a ``DeviceFeed`` summary: the whole sweep, the batches after the
    first, and those after the first prefetch window (the steady state)."""
    if feed['card_ms'] is None or feed['steady'] is None:
        raise AssertionError('phase {}: a sweep ran off the card or within '
                             'one prefetch window: {}'.format(phase, feed))
    log('phase {} from disk, {label}: {batches} batches, the whole sweep '
        '{sweep_s:.2f} s, {sweep_clips_per_s:.1f} clips/s; the first batch '
        '{first_ms:.1f} ms'.format(phase, **feed))
    for name, means in (('after the first', feed),
                        ('steady (after the first prefetch window)',
                         feed['steady'])):
        log('phase {} from disk, {}, {}: {batches} batches, {wall_ms:.1f} ms '
            'per batch, {clips_per_s:.1f} clips/s; host per batch: decode + '
            "transforms {build_ms:.1f} ms (on the loader's threads), waiting "
            'for the batch {wait_ms:.1f} ms, to_device {to_device_ms:.1f} ms; '
            'the card {card_ms:.1f} ms per batch (CUDA events around each '
            'step), busy share {card_busy:.3f}'.format(
                phase, feed['label'], name, **means))


def disk_path(root, roi_dense):
    """Phase 12: the flagship from JPEG frames on disk through the entry
    points a user runs: ``tools.test_net.main`` (the bank sweep, FBO
    inference over the device bank, the detections CSV and the frame-mAP),
    then ``tools.lfb_loader.main`` reading the bank back; then the first
    ``MEMORY_BATCHES`` batches of the same two sweeps held in memory on the
    card, and the RoI forward on one of those batches' rows, logged beside
    ``roi_dense`` (phase 2's result at 4 boxes a clip).  The split and the
    weights go into ``root``.  Returns the launch counts."""
    import torch
    from lfb_tpu_torch.bank.lfb import extract_ava_bank
    from lfb_tpu_torch.core.config import clone, load_config
    from lfb_tpu_torch.data import loader as data_loader
    from lfb_tpu_torch.data.loader import DataLoader, get_input_db, to_device
    from lfb_tpu_torch.models.model import init_params
    from lfb_tpu_torch.models.spec import build_spec
    from lfb_tpu_torch.tools import lfb_loader, test_net
    from lfb_tpu_torch.train import checkpoints
    from lfb_tpu_torch.train.steps import make_eval_step
    dev = torch.device('cuda')
    rng = np.random.default_rng(SEED + 12)
    opts, scores, jpeg_bytes, write_s = write_ava_split(root, rng)
    n_bank = sum(s >= 0.9 for ss in scores.values() for s in ss)
    n_test = sum(s >= 0.85 for ss in scores.values() for s in ss)
    log('phase 12 split: {} videos x {} JPEG frames ({} x {}), mean {:.1f} '
        'KB a file, written in {:.1f} s; {} keyframes, {} predicted boxes, '
        '{} at or above 0.9 (the bank), {} at or above 0.85 (the '
        'test)'.format(DISK_VIDEOS, DISK_FRAMES, DISK_SIZE[1],
                       DISK_SIZE[0], jpeg_bytes / 1e3, write_s,
                       len(scores), sum(map(len, scores.values())),
                       n_bank, n_test))
    out = os.path.join(root, 'out')
    opts += ['NUM_GPUS', '1', 'TPU.REMAT', "''", 'TPU.DEVICE_BANK', 'True',
             'CHECKPOINT.DIR', out, 'LFB.WRITE_LFB', 'True']
    cfg = load_config(AVA_YAML, opts)
    specs = {'LFB.MODEL_PARAMS_FILE': build_spec(cfg, 'val',
                                                 lfb_infer_only=True),
             'TEST.PARAMS_FILE': build_spec(cfg, 'val')}
    for key, spec in specs.items():
        path = os.path.join(root, key.split('.')[0].lower() + '.pkl')
        checkpoints.save_params(path, perturbed_params(spec, dev),
                                model_iter=0, lr=0.0)
        opts += [key, path]
    log('phase 12 host: os.cpu_count() {}, DATALOADER.NUM_WORKERS {}, '
        'PREFETCH_BATCHES {}, TEST.BATCH_SIZE {}, '
        'TPU.MAX_BOXES_PER_CLIP {}'.format(
            os.cpu_count(), cfg.DATALOADER.NUM_WORKERS,
            cfg.DATALOADER.PREFETCH_BATCHES, cfg.TEST.BATCH_SIZE,
            cfg.TPU.MAX_BOXES_PER_CLIP))

    reset_launches()
    data_loader.SWEEPS.clear()
    t0 = time.perf_counter()
    metrics = test_net.main(['--config_file', AVA_YAML] + opts)
    t1 = time.perf_counter()
    launches = read_launches()
    feeds = list(data_loader.SWEEPS)
    if [f['label'] for f in feeds] != ['LFB sweep (val)',
                                       'test sweep (shift 1)']:
        raise AssertionError('phase 12: sweeps {}'.format(feeds))
    for feed in feeds:
        log_feed(feed)
    want = {k: feeds[0]['batches'] * PER_FORWARD['A'][k]
            + feeds[1]['batches'] * PER_FORWARD['B'][k]
            for k in PER_FORWARD['A']}
    log('phase 12 test_net.main: {:.1f} s; launches {} (want {}); '
        'frame-mAP {}'.format(t1 - t0, launches, want, metrics))
    if launches != want:
        raise AssertionError('phase 12: kernel launch counts {} != '
                             '{}'.format(launches, want))
    bank = check_disk_outputs(out, scores, metrics, cfg.TEST.BATCH_SIZE)
    loaded = lfb_loader.main(['--config_file', AVA_YAML, '--splits', 'val']
                             + opts + ['LFB.LOAD_LFB', 'True',
                                       'LFB.LOAD_LFB_PATH', out])['val']
    if not same_bank(loaded, bank):
        raise AssertionError('phase 12: lfb_loader read back another bank')
    log('phase 12: lfb_loader read the bank back bitwise')

    # The first batches of the same sweeps, held on the card.
    gen = torch.Generator(device=dev).manual_seed(cfg.RNG_SEED)
    spec_a, spec_b = specs['LFB.MODEL_PARAMS_FILE'], specs['TEST.PARAMS_FILE']
    params = {key: checkpoints.load_params_into(
        opts[opts.index(key) + 1], init_params(spec, gen), device=dev)[0]
        for key, spec in specs.items()}
    cfg_t = clone(cfg, {'AVA.FULL_EVAL': True,
                        'AVA.DETECTION_SCORE_THRESH': 0.85})
    sweeps = [get_input_db(cfg, 'val', lfb_infer_only=True, shift=1,
                           device=dev),
              get_input_db(cfg_t, 'val', shift=1, lfb=bank, device=dev)]
    host = []
    for db in sweeps:
        loader = DataLoader(db, cfg.TEST.BATCH_SIZE,
                            num_workers=cfg.DATALOADER.NUM_WORKERS,
                            prefetch=cfg.DATALOADER.PREFETCH_BATCHES,
                            seed=cfg.RNG_SEED)
        host.append(list(loader.batches(MEMORY_BATCHES)))
        loader.shutdown()
    ms_a, _, la = run_phase(
        '12 from memory, the bank sweep',
        lambda bs: extract_ava_bank(spec_a, params['LFB.MODEL_PARAMS_FILE'],
                                    bs),
        [to_device(b, dev) for b in host[0]], PER_FORWARD['A'])
    step = make_eval_step(spec_b, bank=sweeps[1].lfb, bank_seed=SEED)
    ms_b, _, lb = run_phase(
        '12 from memory, the test sweep',
        lambda bs: [step(params['TEST.PARAMS_FILE'], b) for b in bs],
        [to_device(b, dev) for b in host[1]], PER_FORWARD['B'])
    log('phase 12 ms per batch from disk (after the first; steady) '
        'against from memory (after the first): bank sweep {:.1f}; '
        '{:.1f} vs {:.1f}, test sweep {:.1f}; {:.1f} vs {:.1f}'.format(
            feeds[0]['wall_ms'], feeds[0]['steady']['wall_ms'], ms_a,
            feeds[1]['wall_ms'], feeds[1]['steady']['wall_ms'], ms_b))
    # The RoI forward on the rows of the first test batch.
    fmap = torch.relu(torch.randn((B, 16, 16, 2048), device=dev))
    check_roi_layout('a test batch of phase 12', fmap,
                     host[1][0]['proposals'], roi_dense, TIMING_ITERS)
    return {k: launches[k] + la[k] + lb[k] for k in launches}


def k400_pickle(path, dev):
    """A K400-style pretrained R101 pickle, as phase 8 makes the R50 one:
    the port's names of the BN-mode R101 (``_bn_rm`` / ``_bn_riv``),
    seeded perturbed weights, a 400-class classifier, a 2-D stem kernel and
    ``*_momentum`` blobs, without the FBO's blobs."""
    from lfb_tpu_torch.config import flagship_cfg
    from lfb_tpu_torch.models.spec import build_spec
    from lfb_tpu_torch.train import checkpoints
    bn_spec = build_spec(flagship_cfg({
        **CFG_OVERRIDES, 'MODEL.USE_AFFINE': False, 'NONLOCAL.USE_BN': True,
        'NONLOCAL.USE_AFFINE': False, 'MODEL.NUM_CLASSES': 400,
        'LFB.ENABLED': False}), 'test')
    rng = np.random.default_rng(SEED + 17)
    blobs = {k: v.cpu().numpy() for k, v in perturbed_params(bn_spec,
                                                              dev).items()}
    for name in blobs:
        if name.endswith('_bn_riv'):
            blobs[name] = 1 + 0.1 * np.abs(rng.standard_normal(
                blobs[name].shape, np.float32))
    blobs['conv1_w'] = np.ascontiguousarray(blobs['conv1_w'][:, :, 0])
    for name in ('conv1_w', 'res2_0_branch2a_w', 'pred_w'):
        blobs[name + '_momentum'] = np.ones_like(blobs[name])
    checkpoints.write_pkl(path, {'blobs': blobs})
    return len(blobs)


def expected_lrs(solver, start, stop, current_lr):
    """The LR of each iteration and the momentum rescales, (iteration, new
    LR / old LR), that ``lfb_tpu``'s trainer makes from ``current_lr``
    (``lfb_tpu/train/trainer.py:179-196``)."""
    from lfb_tpu_torch.train.optimizer import get_lr_at_iter
    lrs, scales = {}, []
    for it in range(start, stop):
        new = get_lr_at_iter(solver, it)
        if new != current_lr and current_lr > 0:
            ratio = max(new / max(current_lr, 1e-10),
                        current_lr / max(new, 1e-10))
            if (solver.SCALE_MOMENTUM and current_lr > 1e-7
                    and ratio > solver.SCALE_MOMENTUM_THRESHOLD):
                scales.append((it, new / current_lr))
        current_lr = lrs[it] = new
    return lrs, scales


def recording_trainer():
    """The port's ``Trainer``, keeping what its run did for phase 13's
    checks: the state it starts from (``start``: start_iter, LR, params and
    momentum, copied to the host), the LR of every iteration (``lrs``),
    every momentum rescale (``momentum_scales``: (iteration, new LR / old
    LR)), every drained loss (``losses``), every eval's metrics (``evals``)
    and the train sweep's :class:`DeviceFeed` (``feeds``).  ``made`` lists
    the trainers built while it stands in for ``train_net.Trainer``."""
    from unittest import mock
    from lfb_tpu_torch.data import loader as data_loader
    from lfb_tpu_torch.train import optimizer
    from lfb_tpu_torch.train import trainer as trainer_mod

    class RecordingTrainer(trainer_mod.Trainer):
        made = []

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.start = (self.start_iter, self.current_lr,
                          {k: v.cpu() for k, v in self.params().items()},
                          {k: v.cpu() for k, v in
                           self.mstate.momentum.items()})
            self.lrs, self.momentum_scales, self.losses, self.evals = (
                {}, [], {}, {})
            self.feeds = []
            update_train = self.train_meter.update_train

            def record_loss(loss, *rest):
                # The drain feeds the meter the losses in iteration order.
                self.losses[self.start_iter + len(self.losses)] = loss
                update_train(loss, *rest)

            self.train_meter.update_train = record_loss
            RecordingTrainer.made.append(self)

        def _update_lr(self, cur_iter):
            correct = optimizer.correct_momentum

            def record_scale(state, scale):
                self.momentum_scales.append((cur_iter, scale))
                return correct(state, scale)

            with mock.patch.object(optimizer, 'correct_momentum',
                                   record_scale):
                self.lrs[cur_iter] = super()._update_lr(cur_iter)
            return self.lrs[cur_iter]

        def evaluate(self, name='latest'):
            self.evals[name] = super().evaluate(name)
            return self.evals[name]

        def train(self):
            feeds = self.feeds

            class KeptFeed(data_loader.DeviceFeed):
                def __init__(self, *args, **kwargs):
                    super().__init__(*args, **kwargs)
                    feeds.append(self)

            with mock.patch.object(trainer_mod, 'DeviceFeed', KeptFeed):
                return super().train()

    return RecordingTrainer


def check_train_run(label, trainer, solver, start, stop, first_lr):
    """A ``train_net`` run's trainer: its LRs and momentum rescales as
    ``lfb_tpu``'s, a finite loss drained for every step, every parameter
    and momentum buffer on the card."""
    lrs, scales = expected_lrs(solver, start, stop, first_lr)
    if trainer.lrs != lrs or trainer.momentum_scales != scales:
        raise AssertionError('{}: LRs {} rescales {}, expected {} {}'.format(
            label, trainer.lrs, trainer.momentum_scales, lrs, scales))
    if sorted(trainer.losses) != list(range(start, stop)) or not all(
            np.isfinite(v) for v in trainer.losses.values()):
        raise AssertionError('{}: losses {}'.format(label, trainer.losses))
    if not all(v.device.type == trainer.device.type for v in
               list(trainer.params().values())
               + list(trainer.mstate.momentum.values())):
        raise AssertionError('{}: a tensor off {}'.format(label,
                                                          trainer.device))
    log('{}: LRs {} and momentum rescales {} as lfb_tpu takes them; losses '
        '{}'.format(label, {k: '{:.6g}'.format(v) for k, v in lrs.items()},
                    [(i, '{:.6g}'.format(r)) for i, r in scales],
                    {k: '{:.5f}'.format(v)
                     for k, v in trainer.losses.items()}))


def check_bank_pickles(out):
    """Both splits' bank pickles hold finite 2048-d rows; returns the row
    counts."""
    import pickle
    rows = {}
    for split in ('train', 'val'):
        with open(os.path.join(out, split + '_lfb.pkl'), 'rb') as f:
            bank = pickle.load(f)
        feats = [x for secs in bank.values() for fs in secs.values()
                 for x in fs]
        if not feats or not all(x.shape == (2048,) and np.isfinite(x).all()
                                for x in feats):
            raise AssertionError('phase 13: bad {} bank'.format(split))
        rows[split] = len(feats)
    return rows


def steady_window(label, rows, picks, memory_ms):
    """Log the train sweep's ``rows`` at ``picks`` (0-based iterations):
    wall ms per step, clips/s, the wait for the batch, the loader's build,
    to_device, the card's ms and its busy share; returns their means."""
    rows = [rows[i] for i in picks]
    m = {k: statistics.mean(r[k] for r in rows)
         for k in ('wall_ms', 'wait_ms', 'build_ms', 'to_device_ms',
                   'card_ms')}
    log('phase 13 from disk, steps {}-{} ({}): {:.1f} ms per step ({:.1f} '
        'clips/s), waiting for the batch {:.1f} ms, decode + transforms {:.1f} '
        "ms a batch on the loader's threads, to_device {:.1f} ms, the card "
        '{:.1f} ms per step, busy share {:.3f}; from memory (phase 11, B = {}, '
        'TPU.REMAT stage) {:.1f} ms per step ({})'.format(
            picks[0] + 1, picks[-1] + 1, label, m['wall_ms'],
            REMAT_B / (m['wall_ms'] / 1e3), m['wait_ms'], m['build_ms'],
            m['to_device_ms'], m['card_ms'], m['card_ms'] / m['wall_ms'],
            REMAT_B, memory_ms, card_line()))
    return m


def train_from_disk(root, memory_ms):
    """Phase 13: stage-2 training of the flagship from the JPEG frames of
    phase 12's split in ``root``, through ``tools.train_net.main`` with the
    released YAML, ``TPU.REMAT`` at its 'stage', B = 16: the two bank
    sweeps (phase 12's baseline pickle), 24 steps from a K400-style R101
    pickle (``CONVERT_MODEL``, ``RESET_START_ITER``) with a warm-up and two
    LR steps, checkpoints at 12 and 24, the train-time eval at 24; then the
    same command with ``SOLVER.MAX_ITER 26`` resumes at 24 (the banks read
    back from their pickles), takes a third LR step, checkpoints at 26 and
    tests the last checkpoint.  ``memory_ms`` is phase 11's ms per step at
    B = 16 under 'stage', logged beside the steps from disk.  Returns the
    launch counts."""
    import torch
    from unittest import mock
    from lfb_tpu_torch.core.config import load_config
    from lfb_tpu_torch.data import loader as data_loader
    from lfb_tpu_torch.tools import train_net
    from lfb_tpu_torch.train import checkpoints
    dev = torch.device('cuda')
    out = os.path.join(root, 'train_out')
    t0 = time.perf_counter()
    k400 = os.path.join(root, 'r101_k400_pretrained.pkl')
    n_blobs = k400_pickle(k400, dev)
    period, steps, resume_to = 12, 24, 26
    opts = ['DATADIR', os.path.join(root, 'frames'),
            'AVA.FRAME_LIST_DIR', os.path.join(root, 'frame_lists'),
            'AVA.ANNOTATION_DIR', os.path.join(root, 'annotations'),
            'NUM_GPUS', '1', 'TPU.DEVICE_BANK', 'True',
            'TRAIN.BATCH_SIZE', '16', 'TRAIN.CROP_SIZE', '224',
            'TRAIN.DROPOUT_RATE', '0.3', 'TRAIN.PARAMS_FILE', k400,
            'LFB.MODEL_PARAMS_FILE', os.path.join(root, 'lfb.pkl'),
            'SOLVER.MAX_ITER', str(steps),
            'CHECKPOINT.CHECKPOINT_PERIOD', str(period),
            'TRAIN.EVAL_PERIOD', str(steps), 'LOG_PERIOD', '2',
            'SOLVER.STEP_SIZES', '[14, 6, 5]',
            'SOLVER.WARMUP.WARMUP_END_ITER', '3',
            'TRAIN.TEST_AFTER_TRAIN', 'False', 'CHECKPOINT.DIR', out]
    cfg = load_config(AVA_YAML, opts)
    log('phase 13: {} ({} blobs) written in {:.1f} s; TPU.REMAT {!r}, '
        'TRAIN.BATCH_SIZE {}, crop {}, dropout {}, CONVERT_MODEL {}, '
        'RESET_START_ITER {}'.format(
            os.path.basename(k400), n_blobs, time.perf_counter() - t0,
            cfg.TPU.REMAT, cfg.TRAIN.BATCH_SIZE, cfg.TRAIN.CROP_SIZE,
            cfg.TRAIN.DROPOUT_RATE, cfg.CHECKPOINT.CONVERT_MODEL,
            cfg.TRAIN.RESET_START_ITER))
    if cfg.TPU.REMAT != 'stage':
        raise AssertionError('phase 13: TPU.REMAT {!r}'.format(cfg.TPU.REMAT))

    recording = recording_trainer()
    runs = {}
    for name, extra in (('train', []),
                        ('resumed', ['SOLVER.MAX_ITER', str(resume_to),
                                     'TRAIN.TEST_AFTER_TRAIN', 'True',
                                     'LFB.LOAD_LFB', 'True',
                                     'LFB.LOAD_LFB_PATH', out])):
        torch.cuda.reset_peak_memory_stats()
        data_loader.SWEEPS.clear()
        recording.made.clear()
        reset_launches()
        t0 = time.perf_counter()
        with mock.patch.object(train_net, 'Trainer', recording):
            result = train_net.main(['--config_file', AVA_YAML] + opts
                                    + extra)
        seconds = time.perf_counter() - t0
        (trainer,) = recording.made
        runs[name] = (trainer, result, read_launches(),
                      list(data_loader.SWEEPS), seconds,
                      torch.cuda.max_memory_allocated() / 2 ** 30)

    trainer, (last, _), launches, feeds, seconds, peak = runs['train']
    if trainer.start[0] != 0 or trainer.device.type != 'cuda':
        raise AssertionError('phase 13: start_iter {}, device {}'.format(
            trainer.start[0], trainer.device))
    check_train_run('phase 13, iterations 0-{}'.format(steps - 1), trainer,
                    cfg.SOLVER, 0, steps, trainer.start[1])
    bank_rows = check_bank_pickles(out)
    labels = [f['label'] for f in feeds]
    eval_label = 'eval sweep (iter{})'.format(steps)
    if labels != ['LFB sweep (val)', 'LFB sweep (train)', eval_label,
                  'train sweep']:
        raise AssertionError('phase 13: sweeps {}'.format(labels))
    by = dict(zip(labels, feeds))
    want = {k: (by['LFB sweep (val)']['batches']
                + by['LFB sweep (train)']['batches']) * PER_FORWARD['A'][k]
            + by[eval_label]['batches'] * PER_FORWARD['B'][k]
            + steps * PER_FORWARD['train stage'][k] for k in PER_FORWARD['A']}
    if launches != want:
        raise AssertionError('phase 13: launches {} != {}'.format(launches,
                                                                  want))
    eval_map = trainer.evals['iter{}'.format(steps)]['full_map']
    if not (np.isfinite(eval_map) and 0 <= eval_map <= 1
            and os.path.isfile(os.path.join(
                out, 'detections_iter{}.csv'.format(steps)))):
        raise AssertionError('phase 13: train-time eval {}'.format(
            trainer.evals))
    if last != os.path.join(os.path.abspath(out), 'checkpoints',
                            'c2_model_iter{}.pkl'.format(steps)):
        raise AssertionError('phase 13: last checkpoint {}'.format(last))
    for feed in feeds[:2]:
        log_feed(feed, phase=13)
    # The train sweep's steps without a checkpoint or the eval inside: all
    # those between the first step (which waits for the first batch) and
    # the checkpoint at 12, those among them after the first prefetch
    # window (the batches the loader began once training ran), and those
    # after the checkpoint.  The loader builds its window's batches side by
    # side, so they arrive in waves: a window of a few steps can fall inside
    # one wave and miss the wait before the next.
    window = cfg.DATALOADER.PREFETCH_BATCHES
    (feed,) = [f for f in trainer.feeds if f.label == 'train sweep']
    rows = feed.rows
    log('phase 13 from disk, the {} train steps: the train sweep {:.2f} s '
        '(checkpoints at {} and {} and the eval at {} included); per step, '
        'wall ms {}, waiting for the batch ms {}, the card ms {}'.format(
            steps, by['train sweep']['sweep_s'], period, steps, steps,
            ['{:.0f}'.format(r['wall_ms']) for r in rows],
            ['{:.0f}'.format(r['wait_ms']) for r in rows],
            ['{:.0f}'.format(r['card_ms']) for r in rows]))
    steady_window('after the first step', rows, list(range(1, period - 1)),
                  memory_ms)
    steady_window('after the first prefetch window', rows,
                  list(range(window, period - 1)), memory_ms)
    steady_window('after the checkpoint at {}'.format(period), rows,
                  list(range(period, steps - 1)), memory_ms)
    log('phase 13 train_net.main: {:.1f} s: the val bank sweep {:.2f} s, the '
        'train bank sweep {:.2f} s ({} / {} bank rows), {} steps {:.2f} s, the '
        'eval {:.2f} s ({} batches, frame-mAP {:.4f}); launches {}; peak '
        'device memory {:.2f} GiB'.format(
            seconds, by['LFB sweep (val)']['sweep_s'],
            by['LFB sweep (train)']['sweep_s'], bank_rows['val'],
            bank_rows['train'], steps, by['train sweep']['sweep_s'],
            by[eval_label]['sweep_s'], by[eval_label]['batches'], eval_map,
            launches, peak))
    first_launches = launches

    trainer, (last, test_metrics), launches, feeds, seconds, peak = \
        runs['resumed']
    saved = checkpoints.read_pkl(os.path.join(
        out, 'checkpoints', 'c2_model_iter{}.pkl'.format(steps)))['blobs']
    start_iter, start_lr, params, momentum = trainer.start
    if not (start_iter == steps and start_lr == float(saved['lr'])
            and sorted(momentum) == sorted(trainer.trainable)
            and all(np.array_equal(v.numpy(), saved[k])
                    for k, v in params.items())
            and all(np.array_equal(v.numpy(), saved[k + '_momentum'])
                    for k, v in momentum.items())):
        raise AssertionError('phase 13 resumed: start_iter {}, LR {}, or '
                             'params and momentum not those of the '
                             'checkpoint'.format(start_iter, start_lr))
    check_train_run('phase 13 resumed, iterations {}-{}'.format(
        steps, resume_to - 1), trainer, cfg.SOLVER, steps, resume_to,
        start_lr)
    names = sorted(f for f in os.listdir(os.path.join(out, 'checkpoints')))
    want_names = sorted('c2_model_iter{}.pkl'.format(i)
                        for i in (period, steps, resume_to))
    if names != want_names or last != os.path.join(
            os.path.abspath(out), 'checkpoints',
            'c2_model_iter{}.pkl'.format(resume_to)):
        raise AssertionError('phase 13: checkpoints {}, last {}'.format(
            names, last))
    test_map = test_metrics['full_map']
    csvs = [f for f in os.listdir(out) if f.startswith('detections_final_')]
    if not (np.isfinite(test_map) and 0 <= test_map <= 1 and len(csvs) == 1):
        raise AssertionError('phase 13: test {}, {}'.format(test_metrics,
                                                            csvs))
    labels = [f['label'] for f in feeds]
    if labels != ['train sweep', 'test sweep (shift 1)']:
        raise AssertionError('phase 13 resumed: sweeps {}'.format(labels))
    by = dict(zip(labels, feeds))
    want = {k: by['test sweep (shift 1)']['batches'] * PER_FORWARD['B'][k]
            + (resume_to - steps) * PER_FORWARD['train stage'][k]
            for k in PER_FORWARD['A']}
    if launches != want:
        raise AssertionError('phase 13 resumed: launches {} != {}'.format(
            launches, want))
    log('phase 13 resumed at {} from c2_model_iter{}.pkl (params and momentum '
        'bitwise): train_net.main {:.1f} s: {} steps {:.2f} s (a checkpoint '
        'at {} included), the test of {} {:.2f} s ({} batches, frame-mAP '
        '{:.4f}, {}); checkpoints {}; launches {}; peak device memory {:.2f} '
        'GiB'.format(
            steps, steps, seconds, resume_to - steps,
            by['train sweep']['sweep_s'], resume_to, os.path.basename(last),
            by['test sweep (shift 1)']['sweep_s'],
            by['test sweep (shift 1)']['batches'], test_map, csvs[0], names,
            launches, peak))
    return {k: first_launches[k] + launches[k] for k in launches}


def data_parallel_phase(cfg, bank, stage_run, stage_ms, root):
    """Phase 14: data parallelism (``lfb_tpu_torch.parallel``) on the one
    card.  (a) Phase 11's 'stage' steps at B = 16 again, from the same
    params, batches and generators, through the data-parallel step in an
    NCCL group of one rank, with phase 4's bank replicated and then
    row-sharded (``TPU.BANK_SHARDED``): the losses, updated params and
    momentum against phase 11's within ``REMAT_BF16_BOUNDS``, the launches
    per step 'stage''s, and the ms per step beside phase 11's (at world 1
    the collectives are the identity: any gap is their own cost).  (b) Two
    ranks spawned on the card over gloo (NCCL refuses two ranks on one
    card): :func:`dp_rank`.  Returns the launch counts of (a)."""
    import tempfile
    import torch
    from lfb_tpu_torch.bank.device_bank import shard_bank
    from lfb_tpu_torch.config import flagship_cfg
    from lfb_tpu_torch.models.spec import build_spec
    from lfb_tpu_torch.parallel import mesh
    dev = torch.device('cuda')
    spec = build_spec(flagship_cfg({**CFG_OVERRIDES, 'TPU.REMAT': 'stage'}),
                      'train')
    batches, (ref_losses, ref_params, ref_momentum) = stage_run
    all_launches = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir='build') as d:
        mesh.init_distributed(dev, world=1, rank=0,
                              init_method='file://' + os.path.join(d, 'store'))
        try:
            for label in ('replicated bank', 'TPU.BANK_SHARDED'):
                if label == 'TPU.BANK_SHARDED':
                    bank = shard_bank(bank)
                params = perturbed_params(spec, dev)
                losses, ms, launches, state = train_steps(
                    'phase 14 (a), ' + label, spec, cfg.SOLVER, bank,
                    batches, params, PER_FORWARD['train stage'])
                all_launches.append(launches)
                loss_rel = max(abs(a - b) / abs(b)
                               for a, b in zip(losses, ref_losses))
                params_rel = worst_leaf(
                    {k: params[k] for k in state.momentum}, ref_params)
                momentum_rel = worst_leaf(state.momentum, ref_momentum)
                steady = statistics.mean(ms[TRAIN_WARMUP:])
                log('phase 14 (a) NCCL, world 1, {}: ms per step {}; {:.1f} '
                    'over the {} timed steps (phase 11, one process: {:.1f}); '
                    'against phase 11 over the {} steps: the losses rel '
                    '{:.3e} (bound {:.0e}), the params worst rel {:.3e} ({}; '
                    'bound {:.0e}), the momentum {:.3e} ({}; bound {:.0e}); '
                    '{}'.format(label, ['{:.1f}'.format(m) for m in ms],
                                steady, len(ms) - TRAIN_WARMUP,
                                stage_ms, len(ms), loss_rel,
                                REMAT_BF16_BOUNDS[0], *params_rel,
                                REMAT_BF16_BOUNDS[1], *momentum_rel,
                                REMAT_BF16_BOUNDS[2], card_line()))
                if not (loss_rel <= REMAT_BF16_BOUNDS[0]
                        and params_rel[0] <= REMAT_BF16_BOUNDS[1]
                        and momentum_rel[0] <= REMAT_BF16_BOUNDS[2]):
                    raise AssertionError('phase 14 (a) {}: the data-parallel '
                                         'step disagrees'.format(label))
                del params, state
            rows = bank.feats.shape[0]
        finally:
            torch.distributed.destroy_process_group()
    log('phase 14 (a): {:.1f} s; the sharded bank holds {} rows on the one '
        'rank'.format(time.perf_counter() - t0, rows))
    del bank, batches, stage_run
    torch.cuda.empty_cache()

    run_ranks('phase 14 (b)', dp_rank, root)
    return {k: sum(n[k] for n in all_launches) for k in all_launches[0]}


def dp_batches(spec, dev):
    """Phase 14 (b)'s global batches: B = 16 clips x 4 boxes with bank
    windows in the batch and labels, where clips 8-15 (rank 1's) keep 2 of
    their 4 boxes: the other rows are padding, as the dataset lays it out
    (zeros, naming clip 0, ``box_mask`` 0), so the ranks hold 32 and 16
    valid boxes and rank 1's padding rows name clip -8 once localised."""
    rng = np.random.default_rng(SEED + 19)
    n = REMAT_B * BOXES_PER_CLIP
    rows = np.arange(n)
    pad = (rows >= n // DP_WORLD) & (rows % BOXES_PER_CLIP >= 2)
    batches = []
    for _ in range(DP_STEPS):
        batch = make_batch(spec, rng, dev, n_clips=REMAT_B, with_lfb=True,
                           with_labels=True)
        for key in ('proposals', 'labels', 'box_mask', 'lfb', 'metadata'):
            batch[key][pad] = 0
        batches.append(batch)
    return batches


def dp_sharded_windows(dev, rank):
    """A small AVA bank (16 videos x 40 s, 1-7 rows a second, so K = 5
    draws) built twice, one copy row-sharded over the group's ranks: this
    rank's 32 windows of 60 s, gathered from both with the same generator.
    Returns (bitwise equal, rows held by this rank, rows of the table)."""
    import torch
    from lfb_tpu_torch.bank.device_bank import AvaDeviceBank, shard_bank
    rng = np.random.default_rng(SEED + 20)
    host = {v: {sec: [rng.standard_normal(2048).astype(np.float32)
                      for _ in range(int(rng.integers(1, 8)))]
                for sec in range(902, 942)} for v in range(16)}
    whole, sharded = (AvaDeviceBank.build(host, window_size=60, k=5,
                                          device=dev) for _ in range(2))
    rows = whole.feats.shape[0]
    sharded = shard_bank(sharded)
    video = torch.from_numpy(rng.integers(0, 16, 64)).to(dev)
    sec = torch.from_numpy(rng.integers(905, 940, 64)).to(dev)
    mine = slice(rank * 32, rank * 32 + 32)
    a, b = (bank.gather(video[mine], sec[mine],
                        torch.Generator(device=dev).manual_seed(SEED))
            for bank in (whole, sharded))
    return torch.equal(a, b), sharded.feats.shape[0], rows


def dp_rank(rank, store, root, results):
    """One of phase 14 (b)'s two ranks, both on ``cuda:0``, in a gloo group
    (collectives through the host: these timings are no multi-GPU speed).
    Rank 0 first runs the flagship 'stage' step (dropout off, host windows)
    alone, before the group exists, on :func:`dp_batches`' global batches;
    then both ranks run it on their halves (8 clips each): the losses,
    updated params and momentum against the one process's within
    ``REMAT_BF16_BOUNDS``, each rank's launches per step those of one
    process ('stage').  Then a row-sharded bank's windows against the whole
    table's, bitwise (:func:`dp_sharded_windows`: gloo's all-gather and
    reduce-scatter on CUDA tensors).  Then ``get_lfb`` over phase 12's
    split in ``root`` at world 2: the bank's keys and rows against phase
    12's (``out/val_lfb.pkl``) within ``DP_BANK_BOUND``.  Rank r puts (r,
    its numbers) on ``results``."""
    import pickle
    import tempfile
    import torch
    from lfb_tpu_torch.bank.lfb import get_lfb
    from lfb_tpu_torch.config import flagship_cfg
    from lfb_tpu_torch.core.config import load_config
    from lfb_tpu_torch.models.spec import build_spec
    from lfb_tpu_torch.parallel import mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device('cuda', 0)
    cfg = flagship_cfg({**CFG_OVERRIDES, 'TPU.REMAT': 'stage',
                        'TRAIN.DROPOUT_RATE': 0.0,
                        'FBO_NL.DROPOUT_RATE': 0.0})
    spec = build_spec(cfg, 'train')
    batches = dp_batches(spec, dev)
    out = {}
    if rank == 0:
        params = perturbed_params(spec, dev)
        losses, ms, _, state = train_steps(
            'phase 14 (b), one process', spec, cfg.SOLVER, None, batches,
            params, PER_FORWARD['train stage'])
        ref = (losses, {k: params[k] for k in state.momentum},
               state.momentum, statistics.mean(ms[1:]))
        del params, state
    torch.distributed.init_process_group('gloo', init_method='file://' + store,
                                         world_size=DP_WORLD, rank=rank)
    try:
        params = perturbed_params(spec, dev)
        losses, ms, _, state = train_steps(
            'phase 14 (b), rank {}'.format(rank), spec, cfg.SOLVER, None,
            [mesh.shard_batch(b, rank, DP_WORLD) for b in batches], params,
            PER_FORWARD['train stage'])
        if rank == 0:
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref[0]))
            params_rel = worst_leaf({k: params[k] for k in state.momentum},
                                    ref[1])
            momentum_rel = worst_leaf(state.momentum, ref[2])
            log('phase 14 (b) gloo, 2 ranks on one card, 8 clips each: {:.1f} '
                'ms per step after the first (gloo through the host; one '
                'process at B = 16: {:.1f} ms); against one process over {} '
                'steps: the losses rel {:.3e} (bound {:.0e}), the params '
                'worst rel {:.3e} ({}; bound {:.0e}), the momentum {:.3e} '
                '({}; bound {:.0e}); each rank\'s launches per step {}; '
                '{}'.format(statistics.mean(ms[1:]), ref[3], DP_STEPS,
                            loss_rel, REMAT_BF16_BOUNDS[0], *params_rel,
                            REMAT_BF16_BOUNDS[1], *momentum_rel,
                            REMAT_BF16_BOUNDS[2], PER_FORWARD['train stage'],
                            card_line()))
            if not (loss_rel <= REMAT_BF16_BOUNDS[0]
                    and params_rel[0] <= REMAT_BF16_BOUNDS[1]
                    and momentum_rel[0] <= REMAT_BF16_BOUNDS[2]):
                raise AssertionError('phase 14 (b): two ranks disagree with '
                                     'one process')
            out['train'] = (loss_rel, params_rel[0], momentum_rel[0])
        del params, state, batches
        torch.cuda.empty_cache()
        same, rows, whole = dp_sharded_windows(dev, rank)
        if rank == 0:
            log('phase 14 (b) TPU.BANK_SHARDED at world 2 (gloo on CUDA '
                'tensors): {} of the {} rows a rank; the windows bitwise '
                'those of the whole table: {}'.format(rows, whole, same))
        if not same:
            raise AssertionError('phase 14 (b): the sharded bank\'s windows '
                                 'differ')

        opts = ['DATADIR', os.path.join(root, 'frames'),
                'AVA.FRAME_LIST_DIR', os.path.join(root, 'frame_lists'),
                'AVA.ANNOTATION_DIR', os.path.join(root, 'annotations'),
                'NUM_GPUS', str(DP_WORLD), 'TPU.REMAT', "''",
                'LFB.MODEL_PARAMS_FILE', os.path.join(root, 'lfb.pkl'),
                'LFB.WRITE_LFB', 'False']
        with tempfile.TemporaryDirectory(dir='build') as d:
            cfg = load_config(AVA_YAML, opts + ['CHECKPOINT.DIR', d])
            t0 = time.perf_counter()
            bank = get_lfb(cfg, cfg.LFB.MODEL_PARAMS_FILE, is_train=False,
                           device=dev)
            seconds = time.perf_counter() - t0
        if rank == 0:
            with open(os.path.join(root, 'out', 'val_lfb.pkl'), 'rb') as f:
                ref_bank = pickle.load(f)
            scale = max(np.abs(np.asarray(r)).max() for secs in
                        ref_bank.values() for rs in secs.values() for r in rs)
            same = bank.keys() == ref_bank.keys() and all(
                bank[v].keys() == ref_bank[v].keys() and all(
                    len(bank[v][t]) == len(ref_bank[v][t])
                    for t in ref_bank[v]) for v in ref_bank)
            err = max(np.abs(np.asarray(a) - np.asarray(b)).max()
                      for v in ref_bank for t in ref_bank[v]
                      for a, b in zip(bank[v][t], ref_bank[v][t])) / scale
            n_rows = sum(len(r) for secs in bank.values()
                         for r in secs.values())
            log('phase 14 (b) get_lfb at world 2 (gloo, one card): {:.1f} s; '
                '{} rows; the same keys and counts as phase 12\'s bank: {}; '
                'rows worst rel {:.3e} (bound {:.0e})'.format(
                    seconds, n_rows, same, err, DP_BANK_BOUND))
            if not (same and err <= DP_BANK_BOUND):
                raise AssertionError('phase 14 (b): the bank at world 2 '
                                     'differs from phase 12\'s')
            out['bank'] = err
    finally:
        torch.distributed.destroy_process_group()
    results.put((rank, out))


def true_bn_cfg(**overrides):
    """The flagship config in true-BN mode (:data:`TRUE_BN`)."""
    from lfb_tpu_torch.config import flagship_cfg
    return flagship_cfg({**CFG_OVERRIDES, **TRUE_BN, **overrides})


def true_bn_params(spec, device):
    """:func:`perturbed_params` with each residual branch's last BN scale
    (``*_branch2c_bn_s``) near 0, 0.02 + 0.002 N(0, 1), as the reference
    starts it (``MODEL.BN_INIT_GAMMA`` 0); the non-local blocks' scales
    start at 0 too and are drawn at 0.05 N(0, 1).  With batch statistics
    nothing grows from block to block, and at :func:`perturbed_params`'
    0.2 a random 101-layer BN net is chaotic: one f32 step's momentum on
    the card and on the CPU differed by up to 1.2e-1 of a tensor's largest
    value (PR 12), with the loss within 1e-7."""
    import torch
    params = perturbed_params(spec, device)
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    for name, value in params.items():
        if name.endswith('_branch2c_bn_s'):
            params[name] = 0.02 + 0.002 * torch.randn(
                value.shape, generator=g, device=device)
    return params


def rel_l2(got, ref):
    """The relative L2 distance of the tensors ``got`` from ``ref``, taken
    over all of them at once."""
    num = sum((got[k].double() - v.double()).square().sum().item()
              for k, v in ref.items())
    den = sum(v.double().square().sum().item() for v in ref.values())
    return (num / den) ** 0.5


def nudged(params):
    """``params`` with every weight (``*_w``) scaled by 1 + NUDGE."""
    return {k: v * (1 + NUDGE) if k.endswith('_w') else v
            for k, v in params.items()}


def running_stats(params):
    """The BN running statistics (``*_bn_rm``, ``*_bn_riv``) of ``params``."""
    return {k: v for k, v in params.items()
            if k.endswith(('_bn_rm', '_bn_riv'))}


def true_bn_phase():
    """Phase 15: true-BN training of the flagship at full width
    (:func:`true_bn_cfg`: every BN and the non-local blocks' BN normalize
    with batch statistics).  (a) :func:`true_bn_reference_check`; (b) at
    the released B = 16, crop 224, bf16, with ``TPU.REMAT 'stage'`` set, 1
    warm-up and 3 timed steps with windows in the batch: each step's
    launches those of a step without remat (8 attention forwards, not 13),
    ms per step, the peak memory, every running statistic moved and momentum
    on the BN scales; (c) ``compute_precise_bn_stats`` over 4 of those
    batches (ms per iteration, launches those of 4 forwards), then one eval
    forward (crop 256, 2 clips) with the new statistics in bf16 and in f32:
    finite, the probs within ``TRUE_BN_EVAL_BOUND``; (d)
    :func:`true_bn_rank` on two gloo ranks.  Returns the launches of (a),
    (b) and (c)."""
    import torch
    from lfb_tpu_torch.models.spec import build_spec
    from lfb_tpu_torch.train.precise_bn import compute_precise_bn_stats
    from lfb_tpu_torch.train.steps import make_eval_step
    dev = torch.device('cuda')
    t0 = time.perf_counter()
    all_launches = [true_bn_reference_check()]
    t1 = time.perf_counter()

    cfg = true_bn_cfg(**{'TPU.REMAT': 'stage'})
    spec = build_spec(cfg, 'train')
    if spec.use_affine or spec.nl.use_affine or spec.remat != 'stage':
        raise AssertionError('phase 15: not a true-BN spec under stage')
    rng = np.random.default_rng(SEED + 22)
    batches = [make_batch(spec, rng, dev, n_clips=REMAT_B, with_lfb=True,
                          with_labels=True)
               for _ in range(TRUE_BN_WARMUP + TRUE_BN_STEPS)]
    params = true_bn_params(spec, dev)
    before = {k: v.clone() for k, v in running_stats(params).items()}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, ms, launches, state = train_steps(
        'phase 15 (b)', spec, cfg.SOLVER, None, batches, params,
        PER_FORWARD['true-BN train'])
    all_launches.append(launches)
    unmoved = [k for k, v in before.items() if torch.equal(params[k], v)]
    if unmoved or not state.momentum['res2_0_branch2a_bn_s'].any():
        raise AssertionError('phase 15 (b): running statistics not written '
                             '({}) or no momentum on a BN scale'.format(
                                 unmoved[:3]))
    log("phase 15 (b) true BN, TPU.REMAT 'stage' (off under true BN): "
        'launches per step {} (remat would run 13 attention forwards); the '
        '{} running statistics moved'.format(PER_FORWARD['true-BN train'],
                                             len(before)))
    step_ms, peak = log_steps('phase 15 (b) true-BN train at B = {}, crop '
                              '{}, bf16'.format(REMAT_B, spec.crop_size), ms,
                              TRUE_BN_WARMUP, REMAT_B, losses)
    del state, before
    t2 = time.perf_counter()

    stamps = []
    reset_launches()
    new = compute_precise_bn_stats(spec, params, timed(batches, stamps),
                                   PRECISE_BN_ITERS)
    launches = read_launches()
    want = {k: n * PRECISE_BN_ITERS
            for k, n in PER_FORWARD['true-BN B'].items()}
    iter_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    if launches != want or len(iter_ms) != PRECISE_BN_ITERS:
        raise AssertionError('phase 15 (c): launches {} != {}'.format(
            launches, want))
    all_launches.append(launches)
    del batches
    probs = {}
    batch = make_batch(build_spec(cfg, 'test'), rng, dev, n_clips=2,
                       with_lfb=True)
    reset_launches()
    for dtype in ('bfloat16', 'float32'):
        spec_e = build_spec(true_bn_cfg(**{'TPU.COMPUTE_DTYPE': dtype}),
                            'test')
        probs[dtype] = make_eval_step(spec_e)(new, batch)['prob'].float()
    launches = read_launches()
    want = {k: 2 * n for k, n in PER_FORWARD['true-BN B'].items()}
    if launches != want:
        raise AssertionError('phase 15 (c) eval: launches {} != {}'.format(
            launches, want))
    all_launches.append(launches)
    err = (probs['bfloat16'] - probs['float32']).abs().max().item()
    log('phase 15 (c) precise BN over {} batches of {}: ms per iteration {} '
        '({:.1f} after the first); eval forward with the new statistics '
        '(crop {}, 2 clips): bf16 prob {} from f32 (bound {:.0e}), finite '
        '{}; {}'.format(PRECISE_BN_ITERS, REMAT_B,
                        ['{:.1f}'.format(m) for m in iter_ms],
                        statistics.mean(iter_ms[1:]),
                        build_spec(cfg, 'test').crop_size,
                        '{:.3e}'.format(err), TRUE_BN_EVAL_BOUND,
                        bool(torch.isfinite(probs['bfloat16']).all()),
                        card_line()))
    if not (err <= TRUE_BN_EVAL_BOUND
            and torch.isfinite(probs['bfloat16']).all()):
        raise AssertionError('phase 15 (c): the eval forward with the '
                             'precise-BN statistics is off')
    del params, new, batch, probs
    torch.cuda.empty_cache()
    t3 = time.perf_counter()

    run_ranks('phase 15 (d)', true_bn_rank)
    log('phase 15: (a) {:.1f} s, (b) {:.1f} s, (c) {:.1f} s, (d) {:.1f} s; '
        'the B = 16 step {:.1f} ms, peak {:.2f} GiB'.format(
            t1 - t0, t2 - t1, t3 - t2, time.perf_counter() - t3, step_ms,
            peak))
    return {k: sum(n[k] for n in all_launches) for k in all_launches[0]}


def one_step(device, spec, solver, params, batch):
    """One ``make_train_step`` step on ``device`` from a copy of ``params``
    at iteration 0's LR: (loss, updated trainable params, momentum, running
    statistics, seconds), all on the CPU."""
    import torch
    from lfb_tpu_torch.train import optimizer
    from lfb_tpu_torch.train.optimizer import get_lr_at_iter
    from lfb_tpu_torch.train.steps import make_train_step, split_params
    p = {k: v.to(device, copy=True) for k, v in params.items()}
    trainable, frozen = split_params(spec, p)
    state = optimizer.init_state(p, set(frozen))
    t0 = time.perf_counter()
    _, _, state, aux = make_train_step(spec, solver)(
        trainable, frozen, state, {k: v.to(device) for k, v in batch.items()},
        torch.Generator(device=device).manual_seed(SEED),
        get_lr_at_iter(solver, 0))
    loss = aux['loss'].item()
    seconds = time.perf_counter() - t0
    cpu = lambda d: {k: v.cpu() for k, v in d.items()}  # noqa: E731
    return (loss, cpu(trainable), cpu(state.momentum),
            cpu(running_stats(frozen)), seconds)


def true_bn_reference_check():
    """Phase 15 (a): one full-width f32 true-BN step (1 clip x 4 boxes, T
    32, crop 224, dropout 0, windows in the batch) on the card (kernels)
    against the same step on the CPU (plain versions), from the same
    params: the loss, the updated params and the running statistics the
    step wrote, each within ``TRUE_BN_F32_BOUNDS`` of its largest CPU
    value, and the momentum's relative L2 distance; each buffer's worst gap
    logged beside the floor, how far the card's own momentum moves when
    the weights are scaled by 1 + ``NUDGE``.  Returns the card step's
    launches."""
    import torch
    from lfb_tpu_torch.models.spec import build_spec
    cfg = true_bn_cfg(**F32_STEP)
    spec = build_spec(cfg, 'train')
    params = true_bn_params(spec, torch.device('cuda'))
    batch = make_batch(spec, np.random.default_rng(SEED + 21), 'cuda',
                       n_clips=1, with_lfb=True, with_labels=True)
    reset_launches()
    card = one_step('cuda', spec, cfg.SOLVER, params, batch)
    launches = read_launches()
    if launches != PER_FORWARD['true-BN train']:
        raise AssertionError('phase 15 (a): launches {} != {}'.format(
            launches, PER_FORWARD['true-BN train']))
    host = one_step('cpu', spec, cfg.SOLVER, params, batch)
    # How far one f32 rounding step of the weights moves the card's own
    # momentum: the floor under the card-vs-CPU gaps.
    nudge = one_step('cuda', spec, cfg.SOLVER, nudged(params), batch)
    floor = worst_leaf(nudge[2], card[2], TRUE_BN_ZERO_GRAD)
    loss_rel = abs(card[0] - host[0]) / abs(host[0])
    momentum = rel_l2(card[2], host[2])
    params_rel = worst_leaf(card[1], host[1])
    stats_rel = worst_leaf(card[3], host[3])
    bounds = TRUE_BN_F32_BOUNDS
    log('phase 15 (a) one f32 true-BN step, card vs CPU: loss {:.7f} / '
        '{:.7f}, rel {:.3e} (bound {:.0e}); updated params worst rel {:.3e} '
        '({}; bound {:.0e}); running statistics {:.3e} ({}; bound {:.0e}); '
        'momentum rel L2 {:.3e} (bound {:.0e}), worst buffer {:.3e} ({}); '
        'the card\'s momentum with the weights scaled by 1 + 2^-22 (the '
        'floor): rel L2 {:.3e}, worst buffer {:.3e} ({}); card {:.1f} s, CPU '
        '{:.1f} s'.format(
            card[0], host[0], loss_rel, bounds['loss'], *params_rel,
            bounds['params'], *stats_rel, bounds['stats'], momentum,
            bounds['momentum'],
            *worst_leaf(card[2], host[2], TRUE_BN_ZERO_GRAD),
            rel_l2(nudge[2], card[2]), *floor, card[4], host[4]))
    if not (loss_rel <= bounds['loss'] and momentum <= bounds['momentum']
            and params_rel[0] <= bounds['params']
            and stats_rel[0] <= bounds['stats']):
        raise AssertionError('phase 15 (a): the card\'s true-BN step '
                             'disagrees with the CPU\'s')
    return launches


def true_bn_rank(rank, store, results):
    """One of phase 15 (d)'s two ranks, both on ``cuda:0``, in a gloo group
    (the BN statistics' all-reduces and the gradients' through the host).
    Rank 0 first runs two f32 true-BN steps of the flagship (dropout off,
    windows in the batch) alone, before the group exists, on global batches
    of 2 clips x 4 boxes; then both ranks run them on their halves (1 clip
    each), taking the global batch's statistics.  Every rank must hold the
    same params, momentum and running statistics (``mesh.check_same``), and
    rank 0's losses, params and running statistics must be within
    ``TRUE_BN_DP_BOUND`` of the one process's, each tensor against its
    largest value, its momentum within ``TRUE_BN_F32_BOUNDS['momentum']``
    (relative L2 distance; each buffer's worst gap logged beside the floor,
    the one process's move when the weights are scaled by 1 + ``NUDGE``).
    Rank r puts (r, its numbers) on ``results``."""
    import torch
    from lfb_tpu_torch.models.spec import build_spec
    from lfb_tpu_torch.parallel import mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device('cuda', 0)
    cfg = true_bn_cfg(**F32_STEP)
    spec = build_spec(cfg, 'train')
    rng = np.random.default_rng(SEED + 23)
    batches = [make_batch(spec, rng, dev, n_clips=DP_WORLD, with_lfb=True,
                          with_labels=True) for _ in range(2)]

    def run(label, feed, nudge=False):
        params = true_bn_params(spec, dev)
        if nudge:
            params = nudged(params)
        losses, ms, _, state = train_steps(
            label, spec, cfg.SOLVER, None, feed, params,
            PER_FORWARD['true-BN train'])
        cpu = lambda d: {k: v.cpu() for k, v in d.items()}  # noqa: E731
        return (losses, cpu({k: params[k] for k in state.momentum}),
                cpu(state.momentum), cpu(running_stats(params)), ms)

    if rank == 0:
        ref = run('phase 15 (d), one process', batches)
        nudge = run('phase 15 (d), one process, nudged', batches, nudge=True)
        floor = worst_leaf(nudge[2], ref[2], TRUE_BN_ZERO_GRAD)
    torch.distributed.init_process_group('gloo', init_method='file://' + store,
                                         world_size=DP_WORLD, rank=rank)
    out = {}
    try:
        got = run('phase 15 (d), rank {}'.format(rank),
                  [mesh.shard_batch(b, rank, DP_WORLD) for b in batches])
        mesh.check_same({**got[1], **got[3], **{
            'momentum ' + k: v for k, v in got[2].items()}},
            'the true-BN params, momentum and running statistics')
        if rank == 0:
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got[0], ref[0]))
            worst = {'params': worst_leaf(got[1], ref[1]),
                     'running statistics': worst_leaf(got[3], ref[3])}
            momentum = rel_l2(got[2], ref[2])
            log('phase 15 (d) gloo, 2 ranks on one card, 1 clip each, 2 f32 '
                'true-BN steps: {:.1f} ms for the second step (one process, '
                '2 clips: {:.1f} ms); against one process: the losses rel '
                '{:.3e}; {} (bound {:.0e} of each tensor\'s largest value); '
                'the momentum rel L2 {:.3e} (bound {:.0e}), worst buffer '
                '{:.3e} ({}); the one process\'s momentum with the weights '
                'scaled by 1 + 2^-22 (the floor): rel L2 {:.3e}, worst buffer '
                '{:.3e} ({}); every rank the same; {}'.format(
                    got[4][1], ref[4][1], loss_rel,
                    ', '.join('{} worst rel {:.3e} ({})'.format(k, *v)
                              for k, v in worst.items()), TRUE_BN_DP_BOUND,
                    momentum, TRUE_BN_F32_BOUNDS['momentum'],
                    *worst_leaf(got[2], ref[2], TRUE_BN_ZERO_GRAD),
                    rel_l2(nudge[2], ref[2]), *floor, card_line()))
            if not (loss_rel <= TRUE_BN_DP_BOUND
                    and momentum <= TRUE_BN_F32_BOUNDS['momentum']
                    and all(v[0] <= TRUE_BN_DP_BOUND
                            for v in worst.values())):
                raise AssertionError('phase 15 (d): two ranks disagree with '
                                     'one process')
            out = {'momentum': momentum,
                   **{k: v[0] for k, v in worst.items()}}
    finally:
        torch.distributed.destroy_process_group()
    results.put((rank, out))


def run_ranks(label, fn, *args):
    """Spawn ``fn(rank, store, *args, results)`` on :data:`DP_WORLD` ranks
    with a file store under ``build/``; each rank puts (rank, result) on
    ``results``.  Raises unless every rank put one; returns {rank:
    result}."""
    import tempfile
    import torch
    t0 = time.perf_counter()
    ctx = torch.multiprocessing.get_context('spawn')
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir='build') as d:
        procs = torch.multiprocessing.start_processes(
            fn, args=(os.path.join(d, 'store'),) + args + (results,),
            nprocs=DP_WORLD, join=False, start_method='spawn')
        out = {}
        while len(out) < DP_WORLD:
            try:
                r, result = results.get(timeout=1.0)
                out[r] = result
            except queue.Empty:
                if procs.join(timeout=0):
                    break
        while not procs.join():
            pass
    if len(out) != DP_WORLD:
        raise AssertionError('{}: results of ranks {}'.format(label,
                                                              sorted(out)))
    log('{}: {:.1f} s for the two ranks, start-up included'.format(
        label, time.perf_counter() - t0))
    return out


class _Tee:
    """Writes to each of ``streams``."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for stream in self.streams:
            stream.write(text)

    def flush(self):
        for stream in self.streams:
            stream.flush()


def parity_dryrun_phase():
    """Phase 16: ``python -m lfb_tpu_torch.tools.parity_eval --dryrun DIR``
    (its ``main``, in this process, on ``cuda``) over the five
    ``DRYRUN_CONFIGS``: manifest-shaped random checkpoints, the synthetic
    splits of ``tests/synthetic.py``, bank inference for the LFB configs
    and the flagship's multi-crop test (2 flips x 1 scale x 3 shifts, the
    bank inferred again for each flip).  Each config timed; the output must
    hold ``DRYRUN SUMMARY: 5/5`` and a PARITY line for each config; the
    forward kernels must have run and no backward kernel.  Returns the
    launches."""
    import contextlib
    import io
    import tempfile
    from lfb_tpu_torch.tools import parity_eval
    seconds = {}
    dryrun_one = parity_eval.dryrun_one

    def timed_one(name, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return dryrun_one(name, *args, **kwargs)
        finally:
            seconds[name] = time.perf_counter() - t0

    out = io.StringIO()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir='build') as d:
        parity_eval.dryrun_one = timed_one
        reset_launches()
        try:
            with contextlib.redirect_stdout(_Tee(sys.stdout, out)):
                parity_eval.main(['--dryrun', d])
        finally:
            parity_eval.dryrun_one = dryrun_one
        launches = read_launches()
    text = out.getvalue()
    names = parity_eval.DRYRUN_CONFIGS
    log('phase 16 parity_eval --dryrun on cuda: {:.1f} s; per config {}; '
        'launches {}'.format(time.perf_counter() - t0, ', '.join(
            '{} {:.1f} s'.format(n, seconds.get(n, float('nan')))
            for n in names), launches))
    parity_lines = [line for line in text.splitlines()
                    if line.startswith('PARITY[')]
    if ('DRYRUN SUMMARY: {0}/{0}'.format(len(names)) not in text
            or len(parity_lines) != len(names) or len(names) != 5
            or not all(launches[k] > 0 for k in ('stem_conv', 'attention',
                                                  'roi_align_maxpool',
                                                  'affine_act'))
            or any(launches[k] for k in _NO_BWD)
            or launches['fused_bottleneck']):
        raise AssertionError('phase 16: {} PARITY lines, launches {}'.format(
            len(parity_lines), launches))
    return launches


# Phase 17 (c): the cost model's count of the probe's grid forward at B = 8,
# crop 224 (train mode, with its loss): convolutions 3.6266 TF, matmuls
# 0.3793 (the non-local projections, the FBO and the classifier), attention
# 0.2820 (q k^T and p v once each), as counted on the CPU
# (tests/test_torch_flops.py).
GRID_TF, GRID_TF_BOUND = 4.288, 2e-2
# gpu_smoke's PASS lines: attention forward and dq at two shapes, RoI,
# training, the step in a one-rank group and its conv1_w update, the bank.
GPU_SMOKE_PASSES = 9
# The flat rewrite's bound (mfu_probe's MISMATCH flag), relative to the
# conv's largest output.
FLAT_BOUND = 2e-2


def tools_phase():
    """Phase 17: the on-card tools at full width.  (a) ``python -m
    lfb_tpu_torch.tools.gpu_smoke`` in a subprocess (phase 14's process
    groups stay out of it): rc 0, the six checks' nine PASS lines, the pass
    line last.  (b) In
    this process, ``tools.mfu_probe``'s grid (its launches counted: each
    forward must launch phase B's kernels), conv and flat modes, tables
    printed.  (c) The grid's (8, 224) count within ``GRID_TF_BOUND`` of
    ``GRID_TF``; every per-op entry above the card's peak marked INVALID;
    no flat row beyond ``FLAT_BOUND``.  (d) :func:`drift_diagnostic`.
    Returns the grid's launches."""
    from lfb_tpu_torch.tools import mfu_probe
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'lfb_tpu_torch.tools.gpu_smoke'], cwd=here,
        capture_output=True, text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    for line in lines:
        log('  gpu_smoke: ' + line)
    passed = [line for line in lines if line.startswith('[PASS]')]
    if proc.returncode or not lines or (
            lines[-1] != 'GPU smoke: all checks passed') or (
                len(passed) != GPU_SMOKE_PASSES):
        log(proc.stderr[-3000:])
        raise AssertionError('phase 17: gpu_smoke rc {}, {} PASS lines'.format(
            proc.returncode, len(passed)))
    t1 = time.perf_counter()
    log('phase 17 (a) gpu_smoke: {} PASS lines in {:.1f} s'.format(
        len(passed), t1 - t0))

    reset_launches()
    grid = mfu_probe.run_grid()
    launches = read_launches()
    forwards = len(mfu_probe.GRID) * (mfu_probe.GRID_ITERS
                                      + mfu_probe.WARMUP)
    want = {name: n * forwards for name, n in PER_FORWARD['B'].items()}
    log('phase 17 grid: launches {} (want {}, {} forwards)'.format(
        launches, want, forwards))
    if launches != want:
        raise AssertionError('phase 17: grid launches {} != {}'.format(
            launches, want))
    tf = grid[mfu_probe.TRAIN_REGIME]['tf']
    log('phase 17 cost model at B = 8, crop 224: {:.4f} TF (want {} within '
        '{:.0%})'.format(tf, GRID_TF, GRID_TF_BOUND))
    if abs(tf - GRID_TF) > GRID_TF_BOUND * GRID_TF:
        raise AssertionError('phase 17: {:.4f} TF'.format(tf))
    t2 = time.perf_counter()
    entries = mfu_probe.run_conv(grid)
    unmarked = [e['sig'].label() for e in entries
                if e['mfu'] > 1.0 and not e['invalid']]
    if unmarked:
        raise AssertionError('phase 17: per-op rows above the peak, not '
                             'marked: {}'.format(unmarked))
    t3 = time.perf_counter()
    flat = mfu_probe.run_flat()
    if any(not r['err'] <= FLAT_BOUND for r in flat):
        raise AssertionError('phase 17: flat rewrite errors {}'.format(
            [r['err'] for r in flat]))
    t4 = time.perf_counter()
    drift_diagnostic()
    log('phase 17: {:.1f} s (gpu_smoke {:.1f}, grid {:.1f}, conv {:.1f} with '
        '{} entries, {} INVALID, flat {:.1f}, drift {:.1f})'.format(
            time.perf_counter() - t0, t1 - t0, t2 - t1, t3 - t2, len(entries),
            sum(e['invalid'] for e in entries), t4 - t3,
            time.perf_counter() - t4))
    return launches


def drift_diagnostic():
    """Phase 17 (d), logged and not bounded: :func:`drift_steps` in a
    process of its own with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (cuBLAS
    reproducible under deterministic algorithms)."""
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, '-c', 'import chip_smoke; chip_smoke.drift_steps()'],
        cwd=here, env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=':4096:8'),
        capture_output=True, text=True, timeout=600)
    if proc.returncode:
        log(proc.stderr[-3000:])
        raise AssertionError('phase 17 (d): rc {}'.format(proc.returncode))
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    for mode, r in result.items():
        log('phase 17 (d) two f32 train steps from one state, {}: bitwise '
            'equal {}; loss diff {:.3e}; params differing {} (max {:.3e}; '
            'first {}), momentum differing {} (max {:.3e}), of {} tensors; '
            'nondeterministic ops named: {}'.format(
                mode, r['bitwise'], r['loss_diff'], r['params_differ'],
                r['params_max'], r['params_names'], r['momentum_differ'],
                r['momentum_max'], r['tensors'], r['ops'] or 'none'))
    return result


def drift_steps():
    """Two f32 train steps of the flagship (1 clip x 4 boxes, T 32, crop
    224, dropout 0, ``TPU.REMAT ''``, windows in the batch) from the same
    params and batch, first as the port runs them, then under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``, which
    warns for each op that has no deterministic implementation; prints one
    JSON line: for each mode, whether the two steps agree bitwise, how many
    updated params and momentum buffers differ and by how much, and the ops
    the warnings name."""
    import warnings
    import torch
    from lfb_tpu_torch.config import flagship_cfg
    from lfb_tpu_torch.models.spec import build_spec
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = flagship_cfg({**CFG_OVERRIDES, **F32_STEP})
    spec = build_spec(cfg, 'train')
    params = perturbed_params(spec, torch.device('cuda'))
    batch = make_batch(spec, np.random.default_rng(SEED + 5), 'cuda',
                       n_clips=1, with_lfb=True, with_labels=True)
    result = {}
    for mode in ('as run', 'deterministic algorithms'):
        torch.use_deterministic_algorithms(mode != 'as run', warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            a, b = (one_step('cuda', spec, cfg.SOLVER, params, batch)
                    for _ in range(2))
        ops = sorted({str(w.message).split(' does not have')[0]
                      for w in caught
                      if 'deterministic implementation' in str(w.message)})
        r = {'ops': ops, 'loss_diff': abs(a[0] - b[0]),
             'tensors': len(a[1]) + len(a[2])}
        for key, i in (('params', 1), ('momentum', 2)):
            gaps = {k: (a[i][k] - b[i][k]).abs().max().item() for k in a[i]}
            differ = sorted(k for k, g in gaps.items() if g > 0)
            r[key + '_differ'] = len(differ)
            r[key + '_max'] = max(gaps.values())
            r[key + '_names'] = differ[:4]
        r['bitwise'] = (r['loss_diff'] == 0 and not r['params_differ']
                        and not r['momentum_differ'])
        result[mode] = r
    torch.use_deterministic_algorithms(False)
    print(json.dumps(result))


# Phase 18: the bank rehearsal (lfb_tpu_torch.tools.bank_rehearsal) at real
# scale.  The inference ladder's top rung cannot fit on an 80 GB card (at
# B = 448 res2's projection block holds three 28 GiB maps at once; B = 256
# has fitted since the stem's affine, ReLU and pool1 write only the pooled
# map); the rungs below it find the largest batch that fits.  Every rung's clips are a prefix of the top rung's draws, so the
# rungs below cost no host time to draw.  The train ladder's top rung is
# twice the released B = 16 step's peak (21.5 GiB) and more.  The bf16 bank's
# prob is held to the f32 bank's within phase 4's bf16 bound; after an OOM
# rung the allocator must hold no more than REHEARSAL_OOM_SLACK over what it
# held before the rung.
REHEARSAL_INFER = (448, 384, 320, 256, 224, 192, 160, 128, 96, 64, 32,
                   16)
REHEARSAL_TRAIN = (64, 48, 32, 16)
REHEARSAL_ITERS = 2
REHEARSAL_OOM_SLACK = 64 * 2 ** 20
BF16_BANK_BOUND = 2e-2
CHARADES_TRAIN_VIDEOS = 9800
CHARADES_TABLE_WIDTH = 600
# Launches per forward and per train step of the rehearsal's configs
# (``bank_rehearsal.flagship_cfg``: the Charades one keeps the flagship's
# backbone and 3 FBO layers, and has no RoI head).
REHEARSAL_PER_FORWARD = {
    'inference': PER_FORWARD['B'], 'extract': PER_FORWARD['A'],
    'train': PER_FORWARD['train'],
    'Charades inference': {**PER_FORWARD['B'], 'roi_align_maxpool': 0},
    'Charades train': {**PER_FORWARD['train'], 'roi_align_maxpool': 0,
                       'roi_align_maxpool_bwd': 0}}


def rehearsal_ladder(label, run, batches, per_forward, totals,
                     top_oom=False):
    """Run one ladder of the rehearsal (``run(batches)`` returns its
    results) with the launch counters at 0 before it.  Checks: no rung
    stalled, the last rung fits, every earlier one ran out of memory (with
    ``top_oom``, the first rung at least: a ladder whose top rung cannot
    fit).  An OOM rung may finish forwards before the one the allocator
    refuses (a batch whose first forward fits can fail on its second), so
    its launches are read, not predicted: after a ladder with OOM rungs the
    fitting rung runs again alone, its rate logged beside the first.  The
    counters of a ladder without OOM rungs, or of that second run, must
    read 1 + ``REHEARSAL_ITERS`` forwards (or steps) exactly.  Adds every
    launch to ``totals``; returns the ladder's results."""
    want = {k: n * (1 + REHEARSAL_ITERS) for k, n in per_forward.items()}

    def ladder(rungs):
        reset_launches()
        results = run(rungs)
        launches = read_launches()
        ooms = sum(bool(r.get('oom')) for r in results)
        fit = results[-1] if results else {}
        if any(r.get('stall') for r in results) \
                or 'clips_per_sec' not in fit or ooms != len(results) - 1 \
                or not np.isfinite(fit['clips_per_sec']) \
                or any(launches[k] < n for k, n in want.items()):
            raise AssertionError('phase 18 {}: ladder {}, launches {}'.format(
                label, results, launches))
        for k, n in launches.items():
            totals[k] = totals.get(k, 0) + n
        return results, launches, ooms

    results, launches, ooms = ladder(batches)
    log('phase 18 {}: {}; launches {}'.format(label, results, launches))
    if top_oom and not ooms:
        raise AssertionError('phase 18 {}: the top rung fit'.format(label))
    if ooms:
        again, launches, _ = ladder((results[-1]['batch'],))
        log('phase 18 {}: the fitting rung again: {}; launches {}'.format(
            label, again, launches))
    if launches != want:
        raise AssertionError('phase 18 {}: launches {} != {}'.format(
            label, launches, want))
    return results


def rehearsal_phase():
    """Phase 18: ``lfb_tpu_torch.tools.bank_rehearsal``'s functions at real
    scale, in process.  (a) AVA, 235 videos: the host bank drawn once
    (``synthesize_ava_host_bank``, rows tiled by ``fast_fill``), the f32
    bank built
    (``build_device_bank_timed``), the inference ladder
    ``REHEARSAL_INFER`` (its top rung must run out of memory and give the
    memory back), the extract ladder on the same rungs and the train ladder
    ``REHEARSAL_TRAIN``; then the bf16 bank and its inference ladder.  (b)
    The bf16 bank's feature bytes exactly half the f32 bank's, and one
    batch of 16 clips through both, same params and window seed: prob
    within ``BF16_BANK_BOUND``.  (c) ``--sharded``: in a one-rank NCCL
    group, the f32 bank row-sharded (``shard_bank``), the inference ladder
    at the fitting batch, and (b)'s batch again: prob bitwise equal to the
    unsharded bank's (else held at 1e-6).  (d) Charades at the train
    split's scale (9,800 videos): its f32 bank, a table width of 600, the
    inference and train ladders.  Each ladder through
    :func:`rehearsal_ladder`; the reports printed as the tool prints them,
    each headed by the card's name and power limit.  Returns the
    launches."""
    import gc
    import torch
    from lfb_tpu_torch.bank.device_bank import shard_bank
    from lfb_tpu_torch.models.spec import build_spec
    from lfb_tpu_torch.tools import bank_rehearsal as br
    from lfb_tpu_torch.tools.gpu_smoke import one_rank_group
    from lfb_tpu_torch.train.steps import make_eval_step
    dev = torch.device('cuda')
    gc.collect()
    torch.cuda.empty_cache()
    oom_rungs = []
    totals = {}
    t0 = time.perf_counter()
    log('phase 18: {:.2f} GiB allocated at the start'.format(
        torch.cuda.memory_allocated() / 2 ** 30))

    # (a) AVA at real scale, f32 then bf16; the rows tiled from one random
    # block (the same shapes and bytes as every row drawn, which takes the
    # card host's CPU 15 s).
    host_bank, rows = br.synthesize_ava_host_bank(AVA_VIDEOS, fast_fill=True)
    t1 = time.perf_counter()
    report = {'dataset': 'ava', 'videos': AVA_VIDEOS, 'bank_rows': rows,
              'sharded': False, 'runs': []}
    banks = {}
    for dtype in ('float32', 'bfloat16'):
        cfg = br.flagship_cfg('ava', dtype, False)
        bank, stats = br.build_device_bank_timed(cfg, host_bank, dev)
        banks[dtype] = bank
        run = {'bank_dtype': dtype, **stats}
        run['inference'] = rehearsal_ladder(
            'AVA {} inference'.format(dtype),
            lambda bs: br.run_inference_ladder(cfg, bank, AVA_VIDEOS, bs,
                                               REHEARSAL_ITERS, False, dev,
                                               oom_rungs),
            REHEARSAL_INFER, REHEARSAL_PER_FORWARD['inference'], totals,
            top_oom=True)
        if dtype == 'float32':
            run['extract'] = rehearsal_ladder(
                'AVA extract', lambda bs: br.run_extract(
                    cfg, AVA_VIDEOS, bs, REHEARSAL_ITERS, dev, oom_rungs),
                REHEARSAL_INFER, REHEARSAL_PER_FORWARD['extract'], totals)
            run['train'] = rehearsal_ladder(
                'AVA train', lambda bs: br.run_train_ladder(
                    cfg, bank, AVA_VIDEOS, bs, REHEARSAL_ITERS, False, dev,
                    oom_rungs),
                REHEARSAL_TRAIN, REHEARSAL_PER_FORWARD['train'], totals)
        report['runs'].append(run)
        del bank
    del host_bank
    t2 = time.perf_counter()

    # (b) The bf16 bank against the f32 bank on one batch.
    nbytes = {k: b.feats.numel() * b.feats.element_size()
              for k, b in banks.items()}
    if 2 * nbytes['bfloat16'] != nbytes['float32']:
        raise AssertionError('phase 18: bank bytes {}'.format(nbytes))
    cfg = br.flagship_cfg('ava', 'float32', False)
    spec = build_spec(cfg, 'test')
    params = perturbed_params(spec, dev)
    batch = br.make_batch(cfg, spec, B, AVA_VIDEOS, device=dev)
    reset_launches()
    prob = {k: make_eval_step(spec, bank=b, bank_seed=SEED)(params, batch)[
        'prob'].float() for k, b in banks.items()}
    launches = read_launches()
    d_bf16 = (prob['bfloat16'] - prob['float32']).abs().max().item()
    log('phase 18 (b): the bf16 bank {} bytes, the f32 bank {}; prob max '
        '|diff| {:.3e} (bound {}) over {} boxes'.format(
            nbytes['bfloat16'], nbytes['float32'], d_bf16, BF16_BANK_BOUND,
            prob['float32'].shape[0]))
    if not d_bf16 <= BF16_BANK_BOUND:
        raise AssertionError('phase 18 (b): prob {:.3e}'.format(d_bf16))
    del banks['bfloat16']
    gc.collect()
    torch.cuda.empty_cache()

    # (c) The f32 bank row-sharded in a one-rank NCCL group.
    fit_b = report['runs'][0]['inference'][-1]['batch']
    cfg_s = br.flagship_cfg('ava', 'float32', True)
    sharded = {**report, 'sharded': True, 'runs': [{
        k: v for k, v in report['runs'][0].items()
        if k not in ('inference', 'extract', 'train')}]}
    with one_rank_group(dev):
        sharded['runs'][0]['inference'] = rehearsal_ladder(
            'AVA f32 sharded inference',
            lambda bs: br.run_inference_ladder(cfg_s, banks['float32'],
                                               AVA_VIDEOS, bs,
                                               REHEARSAL_ITERS, True, dev),
            (fit_b,), REHEARSAL_PER_FORWARD['inference'], totals)
        reset_launches()
        got = make_eval_step(spec, bank=shard_bank(banks['float32']),
                             bank_seed=SEED)(params, batch)['prob'].float()
        for k, n in read_launches().items():
            launches[k] += n
    d_shard = (got - prob['float32']).abs().max().item()
    log('phase 18 (c): the sharded bank\'s prob {} the whole bank\'s (max '
        '|diff| {:.3e}; bound 1e-6)'.format(
            'bitwise equal to' if torch.equal(got, prob['float32'])
            else 'differs from', d_shard))
    if not d_shard <= 1e-6:
        raise AssertionError('phase 18 (c): prob {:.3e}'.format(d_shard))
    want = {k: 3 * n for k, n in REHEARSAL_PER_FORWARD['inference'].items()}
    if launches != want:
        raise AssertionError('phase 18 (b, c): launches {} != {}'.format(
            launches, want))
    for k, n in launches.items():
        totals[k] += n
    del banks, params, batch, prob, got
    gc.collect()
    torch.cuda.empty_cache()
    t3 = time.perf_counter()

    # (d) Charades at the train split's scale.
    host_bank, c_rows = br.synthesize_charades_host_bank(
        CHARADES_TRAIN_VIDEOS)
    cfg = br.flagship_cfg('charades', 'float32', False)
    bank, stats = br.build_device_bank_timed(cfg, host_bank, dev)
    del host_bank
    if stats['table_width'] != CHARADES_TABLE_WIDTH:
        raise AssertionError('phase 18 (d): table width {}'.format(
            stats['table_width']))
    charades = {'dataset': 'charades', 'videos': CHARADES_TRAIN_VIDEOS,
                'bank_rows': c_rows, 'sharded': False, 'runs': [{
                    'bank_dtype': 'float32', **stats}]}
    charades['runs'][0]['inference'] = rehearsal_ladder(
        'Charades inference', lambda bs: br.run_inference_ladder(
            cfg, bank, CHARADES_TRAIN_VIDEOS, bs, REHEARSAL_ITERS, False,
            dev, oom_rungs),
        REHEARSAL_INFER, REHEARSAL_PER_FORWARD['Charades inference'], totals)
    charades['runs'][0]['train'] = rehearsal_ladder(
        'Charades train', lambda bs: br.run_train_ladder(
            cfg, bank, CHARADES_TRAIN_VIDEOS, bs, REHEARSAL_ITERS, False,
            dev, oom_rungs),
        REHEARSAL_TRAIN, REHEARSAL_PER_FORWARD['Charades train'], totals)
    del bank
    br.forget_draws()
    gc.collect()
    torch.cuda.empty_cache()
    t4 = time.perf_counter()

    slack = [(r['ladder'], r['batch'],
              r['allocated_after'] - r['allocated_before'])
             for r in oom_rungs]
    log('phase 18 OOM rungs (ladder, batch, bytes allocated after less '
        'before): {}'.format(slack))
    if not slack or any(d > REHEARSAL_OOM_SLACK for _, _, d in slack):
        raise AssertionError('phase 18: OOM rungs {}'.format(slack))
    for r in (report, sharded, charades):
        print(card_line())
        print(json.dumps(r))
    log('phase 18: {:.1f} s (AVA host bank {:.1f}, AVA ladders {:.1f}, bf16 '
        'and sharded checks {:.1f}, Charades {:.1f})'.format(
            t4 - t0, t1 - t0, t2 - t1, t3 - t2, t4 - t3))
    return totals


def main():
    if sys.argv[1:]:
        raise SystemExit('chip_smoke: takes no arguments')
    t_start = time.perf_counter()
    preamble()
    import torch
    from lfb_tpu_torch.config import flagship_cfg
    cfg = flagship_cfg(CFG_OVERRIDES)
    results = check_kernels()
    reference_check(cfg)
    launches, bank = main_path(cfg)
    charades_launches, charades_bank = charades_path()
    path_launches = [launches, charades_launches]
    videos = epic_videos(np.random.default_rng(SEED + 10))
    verb_launches, verb_state = epic_verb_path(videos)
    path_launches += [verb_launches, epic_noun_path(videos)]
    checkpoint_phase(*verb_state)
    verb_bank = verb_state[2]
    del verb_state
    results.update(check_backward_kernels())
    train_reference_check(cfg)
    train_launches, stage_ms, stage_run = train_phase(
        cfg, bank, charades_bank, verb_bank, videos[3])
    path_launches.append(train_launches)
    del charades_bank, verb_bank
    import tempfile
    os.makedirs('build', exist_ok=True)
    with tempfile.TemporaryDirectory(dir='build') as root:
        path_launches.append(disk_path(root, results['roi_align_maxpool']))
        path_launches.append(train_from_disk(root, stage_ms))
        path_launches.append(data_parallel_phase(cfg, bank, stage_run,
                                                 stage_ms, root))
    del bank, stage_run
    torch.cuda.empty_cache()
    path_launches.append(true_bn_phase())
    path_launches.append(parity_dryrun_phase())
    path_launches.append(tools_phase())
    path_launches.append(rehearsal_phase())
    kernels = []
    for name, meta in KERNELS.items():
        r = results[name]
        kernels.append({'name': name, **meta,
                        'launches': sum(n[name] for n in path_launches),
                        'max_abs_err': r['err'], 'ms': r['ms'],
                        'device_ms': r['device_ms'],
                        'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
                        'bound_by': r['bound_by'],
                        'library_ms': r['library_ms'],
                        'library_device_ms': r.get('library_device_ms'),
                        'library': r.get('library'),
                        'tolerance': r['tolerance']})
    log('chip_smoke: {:.1f} s in all, phases 1-18'.format(
        time.perf_counter() - t_start))
    print(card_line())
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
