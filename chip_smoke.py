#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bihome_torch) on one NVIDIA H100.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), torch and CUDA
   versions, and turns TF32 off for matmuls and cuDNN convolutions.
2. Builds every CUDA kernel (K1-K5) from bihome_torch/csrc with nvcc (in
   parallel, into build/kernels/; beside them warp.cu with K3_FAULT
   planted, for step 16) and prints the build time and, per kernel (by
   its mangled name), ptxas's registers and spills.
3. Holds each kernel against its plain-torch version on the card and
   times kernel, plain version and, where one PyTorch call computes the
   same function, that call (median device time of 50 launches, each
   behind an L2-flushing 100 MB write, CUDA events tightly around each;
   bihome_torch/utils/timing.py), and prints the host's cost per call of
   each kernel's wrapper and of grid_sample:
   K1 and K3 at the eval shapes (batch 64; K3 also at the 128 datagen
   windows of the batch-128 configs), K2, K3, K4 and K5 at the training
   shapes (batch 64, both directions stacked: 128 images). K1
   and K2, whose Cin x Cmid products run on the tensor cores in 3xTF32,
   are held to the tensor-core bound (the largest of the bytes, the
   3xTF32 tensor work and the fp32 epilogue). K2's gradients are held to
   float64 on the ReLU masks its dx shows it took at the kink.
4. Drives the port's eval entry point (zeng-biHomE S-COCO config,
   synthetic images, batch 64, 4 steps) with the launch counters set to 0
   just before and read just after; fails unless K1 and K3 launched (and
   no other kernel), MACE is finite, and one batch's delta_hat matches the
   same batch, weights and DSAC draws through the plain path on the CPU.
   Then the same eval with the flagship's predict extras
   (PREDICT_EXTRAS: DSAC_PREDICT_REFINE at iters 1, 2 and 3,
   DSAC_PREDICT_BIDIRECTIONAL), each counted, its first 4 pairs held to
   the CPU on the same injected draws (one set per field) within 1e-2 px,
   its model time printed.
5. Drives the port's train entry point (the same config at full width,
   batch 64, 4 steps, the extractor from aux_clfbh.npz), counted the same
   way; fails unless K1-K4 launched (K5 not: the patches it warps are
   data), the loss is finite every
   step, the backbone's parameters and BN statistics moved and the frozen
   extractor's did not. Prints ms per step, pairs/s and peak memory.
6. One training step's loss and backbone gradients on the card against
   the CPU plain path in float64 (batch 4, the same conditioned weights,
   pairs and draws); then on the card with a planted fault in K4's or
   K2's output, which the same limits must catch. The CPU references
   (here and in steps 4, 9, 10, 11 and 12) run torch's CPU ops on one
   thread.
7. K3 and K4 at the PhotometricHead's shape (S-COCO nguyen-orig at
   bench.py's batch 128: the full 240x320 image, P = 16,384 points per
   image offset into it) against their plain versions, timed beside
   grid_sample and its grid gradient, with the bytes bound of the pixels
   the points touch.
8. The PDS photometric distortion on the card against the CPU plain
   path on the same draws (full frames, and the pairs of
   pds-coco/zeng-biHomE), within 1e-3 on the 0..255 scale.
9. The train entry point for each of PDS_RUNS (pds-coco zeng-biHomE,
   detone-orig, detone-biHomE, nguyen-orig, then S-COCO nguyen-orig, the
   PhotometricHead), at bench.py's batches, PDS_STEPS steps each, counted:
   each run must launch exactly its kernels (K1 and K2 only on zeng, K4
   only where a loss warps by the predicted deltas), with the checks of
   step 5. Prints ms per step, pairs/s and peak memory of each. After
   the runs of S-COCO nguyen-orig (PhotometricHead, L1) and
   pds-coco/detone-biHomE (the biHomE loss on the deltas, the distortion
   inside the step), the one-step check of step 6 at batch 8, with K4's
   du negated as the planted fault.
10. The eval entry point for pds-coco/detone-orig (batch 128, 4 steps):
   K3 only, and delta_hat against the CPU plain path within 1e-2 px.
11. The ResNet50-flavour slice. K1 and K2 at the wide PF head (x
   [128,64,128,128], Cmid 512, their own kernels) against their plain
   versions, timed and bounded as in step 3, each also with its kernels'
   times apart (torch.profiler): the wide K1 (weight prep, forward on
   wgmma), and the wide K2 (weight prep, dx and sums kernels on wgmma,
   the fixed-order reduction) beside the floor of its design, four
   3xTF32 products. zeng-biHomE with the
   ResNet50-flavour Rethinking backbone (R50_SET): eval at batch 64
   (K1 and K3; the first 4 pairs of batch 0 against the CPU plain path),
   train at batch 64 (exactly K1-K4), then the one-step check of step 6
   at batch R50_STEP_BATCH with both planted faults. K1 and K2 count the
   wide kernels' launches apart (``wide_launches``): the R50 paths must
   launch only those, the others only the narrow ones. Then ZHANG_RUNS,
   the four zhang configs (the ContentAware backbone; the TripletHead,
   or the biHomE loss on its deltas), each: train at batch 64, exactly
   K3 and K4 (after pds-coco/zhang-orig the one-step check at batch 8
   with K4's du negated), then eval at batch 64, K3 only, its first 4
   pairs against the CPU plain path.
12. The zeng-orig and CLEVR-Change slice. The narrow K1 and K2 at
   zeng-orig's OneLine shape (x [64,16,128,128], Cmid 128) and K3 and K4
   at the CLEVR TripletHead's (whole standardized 240x320 renders, batch
   64, P = 76,800), held and timed as in steps 3 and 7. The train entry
   point for pds-coco/zeng-orig (batch 64, PDS_STEPS steps: exactly the
   narrow K1, K2 and K3) with the one-step check of step 6 at batch 4 and
   K2's dw1 zeroed as the planted fault; the eval entry point for
   s-coco/zeng-orig (batch 64: K1 and K3; predict's RANSAC fit on the
   card), with RANSAC's time, share of the model time and peak memory,
   and batch 0 against the CPU plain path on the same injected draws
   (samples whose winner and inlier set match within 1e-2 px; the others
   counted); the train entry point for CLEVR-Change zhang (batch 64,
   synthetic 320x240 pairs: exactly K3 and K4) with the one-step check at
   batch CLEVR_STEP_BATCH and K4's du negated.
13. The file-fed slice. Worker processes, started before anything else,
   write FILE_IMAGES JPEGs at 640x480 (the synthetic generator's images,
   quality 90) into a temporary directory while the kernels build;
   then ``python -m bihome_torch.preprocess_offline --pack_only`` packs
   them at 320x240 (both times printed). pds-coco zeng-biHomE trains at
   batch 64 for PDS_STEPS steps from the JPEG folder and from the pack
   (``--feed stream``: decoded by the loader's producer thread, or
   gathered by the native reader, which must be the one in use; copied to
   the card through pinned memory), counted (exactly K1-K4) and checked as
   in step 5; each prints ms per step, pairs/s, peak memory and the loop's
   wait for its batch, and PDS_STEPS more steps of each, and of the
   device-pool run of step 9, are profiled for the device's idle share.
   Then the same config from the JPEG folder and from the pack through
   the device pool, JAX's default feed (``run_pool_path``, POOL_ARGS,
   POOL_STEPS steps): exactly K1-K4, at least two swaps, the trace of its
   third block written; each
   prints ms per step, pairs/s, the first pool's load, the pool's bytes on
   the card, the median wait per step off the swaps and each swap's wait,
   and the profiled block's idle share, beside the streamed rows. Resume
   on the card from the pack through the device pool (``run_resume``,
   RESUME_POOL images swapped at each epoch's end, the card's draw
   generator in the checkpoint): B, one epoch then resumed to two in
   its LOGGING.DIR, must start at step RESUME_STEPS with optimizer count
   RESUME_STEPS and match A's two epochs without a stop within
   RESUME_REL_L2 relative L2 (epoch-1 losses, each backbone tensor; with
   cuDNN's deterministic algorithms if the default ones miss it). The
   S-COCO zeng-biHomE eval reads the JPEG folder with ``--ckpt`` on B's
   directory and ``--log``: K1 and K3 only, finite MACE, delta_hat against
   the CPU plain path (first 4 pairs) within 1e-2 px, one log line per
   sample. Every other eval phase runs with an empty LOGGING.DIR, so its
   weights are the seeded init.
14. The bf16 slice (MODEL.DTYPE bfloat16). In step 3, K1 and K2 bf16 at
   the zeng shape (bf16 x [128,16,128,128], Cmid 128, the shape of the
   bf16 train and eval paths) against their plain bf16 versions, timed
   and bounded (bytes, bf16 tensor work at 989 TFLOP/s, the fp32
   epilogue); K2's inputs with the pixels near the ReLU kink zeroed, so
   that both take the same masks; the plain versions with each bf16
   rounding point left out must fail the same limits. After step 11,
   bench.py's four PDS
   configs train with ``--dtype bfloat16`` at its batches (BF16_RUNS,
   PDS_STEPS + PDS_STEPS steps), counted: zeng-biHomE launches K1 bf16,
   K2 bf16, K3 and K4 and neither float32 K1 nor K2, the others what
   their float32 runs launch; each prints its ms per step, pairs/s and
   peak memory beside its float32 run of this call. After zeng's run one
   bf16 step (batch 4) against the CPU's bf16 step, with K2 bf16's dw1
   zeroed as the planted fault (``compare_train_step_bf16``): the whole
   step, held to the spread of two bf16 roundings, then the step from the
   card's own pairs and PF-head input on, held tightly, the CPU's float32
   step the control it must reject. Then the bf16 evals (S-COCO
   zeng-biHomE at 64: K1 bf16 and K3; PDS detone-orig at 128: K3),
   delta_hat against the CPU plain path at bf16, whole and from the card's
   own input of the PF head or the regressor's fc, the CPU's float32 the
   control again.
15. The bf16 slice of every config (MODEL.DTYPE bfloat16 on the configs
   step 14 leaves out), after step 12's CLEVR run, from a generator of its
   own: K1 and K2 bf16 at the R50 head (bf16 x [128,64,128,128], Cmid
   512; their own kernels, counted under ``wide_bf16_launches``), held,
   planted and timed as in step 14; then BF16_EVERY_RUNS train with
   ``--dtype bfloat16`` (R50 zeng, PDS zeng-orig, detone-biHomE and
   zhang-biHomE at 64, S-COCO nguyen-orig at 128, CLEVR-Change at 64;
   PDS_STEPS steps each), counted (R50 zeng exactly the wide K1 and K2
   bf16, K3 and K4; zeng-orig the narrow K1 and K2 bf16 and K3; the others
   K3 and K4), each row beside its float32 run of this call; R50 zeng's
   step from the card's PF-head input against the CPU at bf16 (batch
   R50_STEP_BATCH), the CPU's float32 and the card with K2 bf16's dw1
   zeroed the controls it must reject (``compare_tail_step_bf16``); the
   bf16 evals of R50 zeng at 64 (the wide K1 bf16 and K3; delta_hat
   against the CPU at bf16, whole and from the PF head's input) and of
   S-COCO zeng-orig at 64 (the narrow K1 bf16 and K3; the RANSAC fit of
   the card's bf16 field against the CPU's fit of the same field on the
   same draws).
16. The K5 slice (K5_RUNS, VARIANT_RUNS), after step 15's evals, from a
   generator of its own: K3 and K5 at the shapes of the paths that run K5
   (128 patches of 128x128 upsampled 2x and 4x, P = 65,536 and 262,144,
   K3 and K5 on the grid broadcast over the batch as the path gives it,
   K3 also on the grid materialised, bit for bit; the masked loss warp,
   C = 2, P = 16,384, with K4) against their plain versions, timed beside
   grid_sample and its input and grid gradients and, upsampled, beside
   upsample_bilinear2d (align_corners) forward and backward, with their
   bytes bounds; K3's C > 1 kernel at the RGB window warp (64 windows of
   192x192x3 on pds-coco's geometry, P = 16,384) against its plain
   version and timed as image_2, and K3 built with K3_FAULT planted (one
   channel's tap read a pixel off), which the checks at C = 3 (the
   windows) and C = 2 (the masked loss warp) must catch; then the train
   entry point with
   ``--set`` overrides of the shipped configs (batch 64, PDS_STEPS steps):
   pds zeng-biHomE with SAMPLING_STRATEGY upsample-patch-2x (float32 and
   bf16) and -4x (float32), exactly K1-K5 (bf16: K1 and K2 bf16); pds
   zhang-biHomE with learned masks in the biHomE loss (FIX_MASK false,
   MASK_KEYS; float32 and bf16) and pds zhang-orig with learned masks (the
   TripletHead), exactly K3, K4 and K5; each with the checks of step 5 and
   its ms per step, pairs/s and peak memory. The one-step check of step 6
   at batch 4 on zhang-biHomE with learned masks and upsample-patch-2x
   (K5 on both of its paths), with K5's dimg negated and K4's du negated
   as the planted faults. Then the other variants of the biHomE loss on
   pds zhang-biHomE (l2, cosine with a margin, one-line on the OneLine
   backbone, a projection head, the 'dual' term, TRIPLET_LOSS '' with
   MSELoss, AUXILIARY_RESNET_BN_TRAIN with AUXILIARY_RESNET_FREEZE false),
   VARIANT_STEPS steps each: exactly K3 and K4, a finite loss, the
   backbone (and a projection head) moved, the extractor's parameters
   unchanged and its BN statistics moved only under BN_TRAIN.
17. The DSAC slice (run_dsac_slice), from a generator of its own: K3 and
   K4 at the loss warp of DSAC_N = 4 hypotheses ([512,128,128,1]: 2·B·n
   patches) and K3 at image_2 ([64,240,320,3], its C = 3 kernel),
   held to their plain versions and timed beside grid_sample (and its
   grid gradient); photometric_distort_full, the blob masks (exactly) and
   their composite, and image_2 on the card against the CPU on the same
   draws. Then the train entry point for pds zeng-biHomE at batch 64 with
   RANSAC_HYPOTHESIS_NO=4 and each SCORING_METHOD (DSAC_RUNS: the
   double-line loss, where the score CNN takes no gradient and must not
   move, and score_cnn on the one-line loss, where it must), PDS_STEPS
   steps each, exactly K1-K4, with the checks of step 5 and the DSAC
   forward's ms a step (CUDA events around dsac_deltas); the one-step
   check of step 6 at batch 4 for repr_error and the one-line score_cnn
   (the score CNN's gradients held too) with K4's du negated; the S-COCO
   zeng-biHomE eval at n 4 with soft_inliers_ratio, alone and with
   DSAC_PREDICT_REFINE (first 4 pairs against the CPU within 1e-2 px);
   HomographyNet (pds detone-orig with its backbone swapped, batch 128:
   exactly K3); pds zeng-biHomE with PhotometricDistort on both patches
   and AUGMENT_BLOB_POROSITY 0.5 (a YAML written for the run: exactly
   K1-K4); eval --vis (S-COCO zeng-biHomE, batch 64, one step: image_2 on
   the card, its files written).
18. The data-parallel slice (``run_ddp_slice``): DDP_RANKS ranks spawned
   (NCCL with a card each where the machine has DDP_RANKS cards, else
   gloo with both on one card, which says so: its times are no scaling
   number). pds zeng-biHomE (R34) at global batch DDP_BATCH: rank 0's
   first-step loss and gradients, after the sum over the ranks and before
   Adam, against the one-process step at DDP_BATCH on the card on the
   same weights and draws, within the limits of step 6; then with each
   DDP_FAULTS fault planted (every rank's statistics its own, as a plain
   DistributedDataParallel wrap computes them; the PF head's dgamma / dw2
   from the summed moments), which must fail them. The train entry point
   with ``--multihost`` for PDS_STEPS steps, through the whole pool, with
   ``--pool_shard`` and from step 17's blob YAML (DDP_TRAIN_RUNS): exactly
   K1-K4 in each rank, rank 0 alone writing (one record a step, one
   checkpoint), ms per step and pairs/s printed, and the whole-pool and
   blob runs' first logged losses (the trainer's own draws, made for the
   global batch and sliced on each rank; the blobs' donors gathered from
   every rank's patch_1) within the loss limit of step 6 of the first
   losses of the one-process runs of steps 9 and 17 on the same config,
   batch and seeds; the eval entry point with ``--multihost`` (S-COCO
   zeng, batch 64, PDS_STEPS iterations split over the ranks, ``--ckpt``
   on the first run): its ``--log`` lists each sample once.
19. The serving slice (``run_serving``): pds zeng-biHomE's predict (seeded
   weights) exported on the card with ``serving.export_predict`` at a
   symbolic batch, its graph holding ``bihome::pf_head_fwd``; saved and
   loaded in a fresh process, where at SERVING_BATCHES (a datagen batch)
   it must agree with the live serving function on the card within
   SERVING_LIMIT_PX, give the same bits on a second call and launch K1
   alone; then ``bench_serving``'s JSON line at batch 64.
20. The pretext and extractor slice (``run_pretrain_slice``), from a
   generator of its own: K3 at warp_gt's shape ([256,128,128,1], P =
   16,384) against its plain version, timed beside grid_sample with its
   bytes bound; ``python -m bihome_torch.pretrain_aux`` at its defaults
   (batch 256, a pool of 256, 128x128 patches) for PRETRAIN_ARGS' steps,
   for each pretext, gradcl with the basin, fine, hard-negative and rich
   terms, and gradpdscl at --layers 2 (PRETRAIN_RUNS), counted: exactly
   K3 (gradpds, which warps nothing, none), finite losses, every parameter
   and BN statistic moved, the file holding exactly conv1/bn1/layer1
   (layer2 too at --layers 2 and for rotnet's whole network, as JAX's
   writer keeps it), each printing ms per step, pairs/s and peak memory;
   one gradcl step with every extra term on the card against the CPU plain
   path, both float32, on the same weights and draws, within step 6's
   limits, then with K3's output shifted a row, which must fail them; pds
   zeng-biHomE trained from the gradpdscl file (exactly K1-K4, the
   extractor the file's and unchanged) and with a seeded resnet50
   extractor (MODEL.HEAD.AUXILIARY_RESNET resnet50: exactly K1-K4), each
   printed beside the resnet34 row of step 9. Step 18 also trains step
   17's blob YAML with ``--multihost`` (exactly K1-K4 in each rank; its
   first logged loss within step 6's loss limit of step 17's one-process
   first loss).
21. Prints each phase's wall time, one {"pds_distortion": ...,
   "train_runs": [...], "zeng_orig_eval": {...}, "file_data": {...},
   "file_runs": [...], "resume": [...], "file_eval_mace": x,
   "bf16_runs": [...], "bf16_step": {...}, "bf16_evals": {...},
   "predict_extras": {...}, "k5_runs": [...], "k5_step": {...},
   "variant_runs": {...}, "dsac": {...}, "ddp": {...}, "serving": {...},
   "pretrain": {...}, "phase_s": {...}} line,
   one {"kernels": [...]} line (launches summed over every path above,
   and by path, the narrow and wide bf16 K1 and K2 rows apart; K1 and K2
   with their wide
   kernels' figures and launches
   under "at_r50_head" and at zeng-orig's shape under "at_zeng_orig", K3
   and K4 at the CLEVR shape under "at_clevr", K3 and K5 at the upsample
   shapes under "at_upsample_2x" and "at_upsample_4x", K3, K4 and K5
   at the masked loss warp under "at_masked_loss_warp", K3 and K4 at the
   loss warp of 4 hypotheses under "at_dsac_n4", K3 at image_2 under
   "at_image_2", at the RGB window warp under "at_rgb_window" and at
   warp_gt's shape under "at_warp_gt", each with the launches of the paths
   that run that shape; K3's "generic_launches" over every path, which
   must be 0: each path's K3 runs its kernel for C = 1, 2 or 3), then as
   the last line
   {"ok": true,
   "device": {...}}.

The train runs go through the device pool (``--feed pool``, the
default) unless they name ``--feed stream``, one step per block
(``--steps_per_call 1``) unless they name another. The seeded synthetic
images of ``--synthetic`` are made once per size
(``synthetic.make_image_pool`` memoized for the script's run). Any failed
check raises, so the script exits non-zero. Without a CUDA device it
exits non-zero before printing any result.
"""

import concurrent.futures
import contextlib
import copy
import itertools
import json
import math
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from bihome_torch.utils.timing import host_us, kernel_ms, time_ms

CONFIG = 'config/s-coco/zeng-bihome-lr-1e-3.yaml'
BATCH = 64
STEPS = 4
# Published H100 SXM peaks (NVIDIA data sheet) for the roofline bound.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_TC_FLOP_PER_S = 495e12       # dense TF32 on the tensor cores
BF16_TC_FLOP_PER_S = 989e12       # dense bf16 on the tensor cores
# The one-step check (compare_train_step): the PF head's output conv scale
# of the conditioned network, the gradient limits, and the planted faults
# that must fail them. Readings (relative L2 over all gradients, worst
# tensor's relative L2): the sound step 4.4e-3 and 1.5e-2 on the card (H100),
# 8.4e-4 and 1.4e-3 on the CPU in float32; K2's dw1 zeroed 7.3e-2 and 3.5,
# K4's du negated 0.85 and 1.1. The loss reads 1.9e-5 of its terms.
PF_SCALE = 10.0
STEP_LOSS = 1e-3
STEP_L2 = 2e-2
STEP_PER_TENSOR = 0.1
FAULTS = ('K4 du negated', 'K2 dw1 zeroed')
# The kernels each path must launch (all others must not): zeng-biHomE runs
# K1-K4; the ResNet34 family has no PF head (no K1, K2), and K4 runs only
# where a loss warps by the predicted deltas (detone-biHomE's loss warp,
# the PhotometricHead's warp of the full image). K5 runs only where a
# warped source takes a gradient (K5_RUNS below); every shipped config
# warps data.
ZENG_KERNELS = ('fused_pf_head_fwd', 'fused_pf_head_bwd',
                'bilinear_sample_batched', 'bilinear_sample_bwd_uv')
WARP_KERNELS = ('bilinear_sample_batched', 'bilinear_sample_bwd_uv')
# The PDS-COCO configs that bench.py tracks and this port runs, at
# bench.py's batches, then S-COCO nguyen-orig, the PhotometricHead (the
# PDS nguyen-orig config is a NoOpHead with an L1 loss on the deltas).
PDS_RUNS = (('config/pds-coco/zeng-bihome-lr-1e-3.yaml', 64, ZENG_KERNELS),
            ('config/pds-coco/detone-orig-lr-5e-3.yaml', 128,
             ('bilinear_sample_batched',)),
            ('config/pds-coco/detone-bihome-lr-5e-3.yaml', 64, WARP_KERNELS),
            ('config/pds-coco/nguyen-orig-lr-5e-3.yaml', 128,
             ('bilinear_sample_batched',)),
            ('config/s-coco/nguyen-orig-lr-5e-3.yaml', 128, WARP_KERNELS))
PDS_STEPS = 3
# The ResNet50-flavour slice: zeng-biHomE with the ResNet50-flavour
# Rethinking backbone (its PF head Cin 64 / Cmid 512 runs the wide K1 and
# K2, counted apart from the narrow ones), and the zhang family (the
# ContentAware backbone; the TripletHead or the biHomE loss on its deltas:
# K3 and K4, never K1, K2 or K5).
R50_SET = ('MODEL.BACKBONE.RESNET_BLOCK=ResNet50',)
R50_STEP_BATCH = 2
# The kernels of one wide K1 and one wide K2 call (csrc/fused_head.cu),
# timed apart.
WIDE_K1_PARTS = ('pf_head_wide_prep_kernel', 'pf_head_fwd_wgmma_kernel')
WIDE_K2_PARTS = ('pf_head_wide_prep_kernel', 'pf_head_bwd_wide_dx_kernel',
                 'pf_head_bwd_wide_sums_kernel', 'reduce_rows_kernel')
# The kernels of one wide K2 bf16 call, timed apart (K1 wide bf16 is one).
WIDE_BF16_K2_PARTS = ('pf_head_bwd_wide_bf16_dx_kernel',
                      'pf_head_bwd_wide_bf16_sums_kernel',
                      'reduce_rows_kernel')
R50_KERNELS = ('fused_pf_head_fwd_wide', 'fused_pf_head_bwd_wide',
               'bilinear_sample_batched', 'bilinear_sample_bwd_uv')
ZHANG_RUNS = ('config/pds-coco/zhang-orig-lr-1e-2.yaml',
              'config/s-coco/zhang-orig-lr-1e-2.yaml',
              'config/pds-coco/zhang-bihome-lr-1e-2.yaml',
              'config/s-coco/zhang-bihome-lr-1e-2.yaml')
# The one-step checks of the later slices, each right after its train run,
# at batch 8, with K4's du negated as the planted fault: S-COCO nguyen-orig
# (the PhotometricHead, L1), pds-coco/detone-biHomE (the biHomE loss on
# the predicted deltas, the distortion inside the step) and
# pds-coco/zhang-orig (the TripletHead). On the CPU nguyen's float32 step
# reads 8.3e-3 relative L2 from float64 at batch 4 (worst tensor 1.8e-2),
# 3.1e-4 at batch 8 (2.0e-3), far inside STEP_L2.
STEP_CHECKS = ('config/s-coco/nguyen-orig-lr-5e-3.yaml',
               'config/pds-coco/detone-bihome-lr-5e-3.yaml',
               'config/pds-coco/zhang-orig-lr-1e-2.yaml')
STEP_CHECK_BATCH = 8
# The last slice: zeng-orig (the OneLine Rethinking backbone, whose PF head
# runs the narrow K1 and K2 at x [64,16,128,128]; the NoOp 'all_points'
# head, SmoothL1 on the field, RANSAC at predict) trained on PDS-COCO and
# evaluated on S-COCO, and CLEVR-Change zhang (ChangeAwarePrep pairs of
# whole 320x240 renders: the TripletHead's warps run K3 and K4 at
# [64,240,320,1], datagen nothing), each trained at batch 64 for PDS_STEPS
# steps with a one-step check: zeng-orig's at batch 4 with K2's dw1 zeroed
# as the planted fault, CLEVR's at CLEVR_STEP_BATCH (the CPU's float64
# step at 240x320) with K4's du negated.
ZENG_ORIG = ('config/pds-coco/zeng-orig-lr-1e-3.yaml',
             'config/s-coco/zeng-orig-lr-1e-3.yaml')
ZENG_ORIG_KERNELS = ('fused_pf_head_fwd', 'fused_pf_head_bwd',
                     'bilinear_sample_batched')
CLEVR = 'config/clevr-change/zhang-clevr-nsc-lr-1e-2.yaml'
CLEVR_STEP_BATCH = 2
# The file-fed slice: FILE_IMAGES JPEGs at COCO's usual 640x480 (FILE_HW),
# quality JPEG_QUALITY, the synthetic generator's images (seeded by
# FILE_SEED), written by worker processes beside the kernel build, and a
# 320x240 pack of them by preprocess_offline. pds-coco zeng-biHomE
# (FILE_CONFIG) trains from each at batch 64, streamed (--feed stream),
# and from each through the device pool, JAX's default feed
# (POOL_ARGS: a pool of 256 of the 512 images, swapped every 4 steps, 2
# steps a block, POOL_STEPS steps: swaps at steps 4 and 8, the third
# block profiled by --profile); it resumes on the card from the pack
# through the device pool (RESUME_STEPS steps an epoch, RESUME_POOL
# images swapped at each epoch's end, the resumed run held to the
# uninterrupted one within RESUME_REL_L2 relative L2 per tensor); the
# S-COCO eval reads the JPEG folder with the resumed checkpoint.
FILE_IMAGES = 512
FILE_HW = (480, 640)
FILE_SEED = 11
JPEG_QUALITY = 90
FILE_CONFIG = 'config/pds-coco/zeng-bihome-lr-1e-3.yaml'
RESUME_STEPS = 2
RESUME_POOL = 256
RESUME_REL_L2 = 1e-4
POOL_STEPS = 10
POOL_ARGS = ('--feed', 'pool', '--pool_size', '256', '--pool_refresh_steps',
             '4', '--steps_per_call', '2', '--profile')
# The flagship's predict extras: the S-COCO zeng-biHomE eval at 64 with
# DSAC_PREDICT_REFINE at iters 1, 2 and 3 (ITERS=2 aborted the TPU's
# backend, tools/probe_refine_iters.py) and with
# DSAC_PREDICT_BIDIRECTIONAL; K1 and K3 only, and delta_hat of batch 0's
# first 4 pairs against the CPU plain path on the same injected draws (one
# set per field) within the eval check's 1e-2 px. First readings (H100):
# 1.73e-3, 2.12e-3 and 4.00e-3 px at iters 1-3 (each IRLS round refits to
# 16,384 float32 points, summed in another order on each side),
# 4.48e-5 px bidirectional.
PREDICT_EXTRAS = {
    f'refine iters {k}': ('MODEL.HEAD.DSAC_PREDICT_REFINE=true',
                          f'MODEL.HEAD.DSAC_PREDICT_REFINE_ITERS={k}')
    for k in (1, 2, 3)}
PREDICT_EXTRAS['bidirectional'] = (
    'MODEL.HEAD.DSAC_PREDICT_BIDIRECTIONAL=true',)
# The bf16 slice (MODEL.DTYPE bfloat16, ``--dtype bfloat16``). K1 and K2
# bf16 against their plain bf16 versions (the Pallas kernels' rounding
# points, float32 sums): K1 within BF16_K1_L2 relative L2 and every output
# within BF16_K1_MAX of the largest (4 bf16 ulps); K2's dx within
# BF16_K2_DX_L2, its sums within BF16_K2_SUMS_L2; at most a BF16_DIFFER
# share of K1's outputs and K2's dx other bf16 values than the plain
# version's (first readings 2.65e-5, 3.05e-5, sums at most 1.4e-5; 8.6e-5
# and 1.1e-4 of the values differ). Each rounding point of the plain
# version left out in turn (``skipped_rounding``) must fail those limits:
# a kernel that missed one would. bench.py's four PDS
# configs (bench.py:148-167) train at its batches at bf16, beside their
# float32 runs above (zeng-biHomE must launch the bf16 K1 and K2 and
# neither float32 one); the bf16 evals (S-COCO zeng-biHomE at 64, PDS
# detone-orig at 128) hold the card's delta_hat within BF16_PREDICT_REL of
# the CPU's at bf16; one bf16 step of zeng-biHomE at batch 4 against the
# CPU's bf16 step (BF16_STEP_LOSS, BF16_STEP_PER_TENSOR) with K2 bf16's
# dw1 zeroed as the planted fault. Those limits are set by the spread of
# two legitimate bf16 roundings of the random 50-layer network: another
# float32 summation order flips a bf16 rounding, each flip reaches
# hundreds of sums in the next convolution, and through the batch
# statistics the two sides decorrelate to the size of bf16 noise. First
# readings (H100): the card's step against the CPU's at bf16 1.45e-2 of
# the loss's terms, worst tensor 0.594 relative L2; the CPU's own float32
# step 2.33e-2 and 0.702 from its bf16 one; dw1 zeroed 2.88. delta_hat
# 1.33e-2 (zeng) and 5.84e-3 (detone) from the CPU's at bf16, where the
# CPU's float32 stands 1.40e-2 and 4.87e-3 away.
BF16_K1_L2 = 3e-4
BF16_K1_MAX = 1.6e-2
BF16_K2_DX_L2 = 3e-4
BF16_K2_SUMS_L2 = 1e-4
BF16_DIFFER = 5e-4
BF16_ZENG_KERNELS = ('fused_pf_head_fwd_bf16', 'fused_pf_head_bwd_bf16',
                     'bilinear_sample_batched', 'bilinear_sample_bwd_uv')
BF16_RUNS = (('config/pds-coco/zeng-bihome-lr-1e-3.yaml', 64,
              BF16_ZENG_KERNELS),
             ('config/pds-coco/zhang-orig-lr-1e-2.yaml', 64, WARP_KERNELS),
             ('config/pds-coco/nguyen-orig-lr-5e-3.yaml', 128,
              ('bilinear_sample_batched',)),
             ('config/pds-coco/detone-orig-lr-5e-3.yaml', 128,
              ('bilinear_sample_batched',)))
BF16_EVALS = ((CONFIG, 64, ('bilinear_sample_batched',
                            'fused_pf_head_fwd_bf16')),
              ('config/pds-coco/detone-orig-lr-5e-3.yaml', 128,
               ('bilinear_sample_batched',)))
BF16_PREDICT_REL = 5e-2
BF16_STEP_LOSS = 5e-2
BF16_STEP_PER_TENSOR = 1.0
# The bf16 slice of every config: K1 and K2 bf16 at the R50 head (x
# [128,64,128,128] bf16, Cmid 512, their own kernels, counted under
# ``wide_bf16_launches``), held as the narrow ones; then, after every
# float32 run, the configs BF16_RUNS leaves out train at bf16 beside
# their float32 rows of the same call (BF16_EVERY_RUNS: config, batch,
# kernels, overrides), R50 zeng's step from the card's PF-head input
# against the CPU at bf16 (``compare_tail_step_bf16``, batch
# R50_STEP_BATCH), and the bf16 evals of R50 zeng (the wide K1 bf16, as
# BF16_EVALS) and of S-COCO zeng-orig (RANSAC on the bf16 field).
R50_BF16_KERNELS = ('fused_pf_head_fwd_wide_bf16',
                    'fused_pf_head_bwd_wide_bf16', 'bilinear_sample_batched',
                    'bilinear_sample_bwd_uv')
BF16_EVERY_RUNS = (
    (CONFIG, BATCH, R50_BF16_KERNELS, R50_SET),
    (ZENG_ORIG[0], BATCH, ('fused_pf_head_fwd_bf16', 'fused_pf_head_bwd_bf16',
                           'bilinear_sample_batched'), ()),
    ('config/pds-coco/detone-bihome-lr-5e-3.yaml', BATCH, WARP_KERNELS, ()),
    ('config/pds-coco/zhang-bihome-lr-1e-2.yaml', BATCH, WARP_KERNELS, ()),
    ('config/s-coco/nguyen-orig-lr-5e-3.yaml', 128, WARP_KERNELS, ()),
    (CLEVR, BATCH, WARP_KERNELS, ()))
# The tail checks: the step and the evals from the card's own input of
# the model's tail on (the PF head; the ResNet34 regressor's fc, its last
# stage printed beside it), the card against the CPU at bf16, which the
# CPU at float32 must miss. First readings (H100): the step's head and
# input gradients 4.17e-3 relative L2 (float32 8.15e-2), its loss 6.84e-3
# of the terms (float32 3.04e-3: the bf16 extractor's rounding noise,
# which the loss cannot tell from float32's); zeng's delta_hat 5.75e-6
# (float32 2.51e-3), detone's from the fc 0 (3.69e-3). From detone's last
# stage the card stood 3.17e-3 from the CPU and float32 4.66e-3: after a
# few cuDNN bf16 convolutions the card and the CPU part as far as bf16
# and float32 do, so no tail holds them there.
TAIL_MODULES = {'RethinkingBackbone': ('layer8',),
                'ResNet34Backbone': ('resnet34.fc', 'resnet34.layer4')}
BF16_TAIL_LOSS = 2e-2
BF16_TAIL_L2 = 2e-2
BF16_TAIL_PER_TENSOR = 5e-2
BF16_TAIL_PREDICT = 1e-3
# R50 zeng's step from its PF-head input (Cin 64, Cmid 512: the wide bf16
# kernels) holds the gradients to tighter limits: its float32 control
# stands nearer the bf16 reference than the ResNet34 head's. First
# readings (H100): the card 6.00e-3 relative L2, worst tensor 8.48e-3; the
# CPU's float32 1.78e-2 and 3.31e-2; K2 bf16's dw1 zeroed 1.29.
BF16_R50_TAIL = (1e-2, 2e-2)
# The paths that run K5, the warp's image gradient (``--set`` overrides of
# shipped configs): pds zeng-biHomE with the upsample-patch-2x (float32 and
# bf16) and -4x (float32) sampling strategies, whose warped patches are
# upsampled by K3 before the extractor, so that K5 scatters their gradient
# at 4 and 16 points per pixel; pds zhang-biHomE with learned masks
# (FIX_MASK false) in the biHomE loss (MASK_KEYS: each mask a second channel
# of the loss warp, K3/K4/K5 at C = 2; float32 and bf16); pds zhang-orig
# with learned masks (the TripletHead warps them, C = 1). Each at batch 64,
# PDS_STEPS steps, counted: exactly its kernels. Then the one-step check at
# batch 4 of zhang-biHomE with learned masks and upsample-patch-2x (both K5
# paths in one step) with K5's dimg negated and K4's du negated as the
# planted faults. Then the other variants of the biHomE loss
# (VARIANT_RUNS) on pds zhang-biHomE, VARIANT_STEPS steps each: exactly K3
# and K4, a finite loss, the backbone moved.
UPSAMPLE_2X = ('MODEL.HEAD.SAMPLING_STRATEGY=upsample-patch-2x',)
UPSAMPLE_4X = ('MODEL.HEAD.SAMPLING_STRATEGY=upsample-patch-4x',)
LEARNED_MASKS = ('MODEL.BACKBONE.FIX_MASK=false',)
MASK_KEYS = LEARNED_MASKS + ('MODEL.HEAD.MASK_KEYS=[mask_1, mask_2]',)
ZHANG_BIHOME = 'config/pds-coco/zhang-bihome-lr-1e-2.yaml'
K5 = ('bilinear_sample_bwd_img',)
K5_RUNS = ((PDS_RUNS[0][0], UPSAMPLE_2X, ZENG_KERNELS + K5, 'float32'),
           (PDS_RUNS[0][0], UPSAMPLE_2X, BF16_ZENG_KERNELS + K5, 'bfloat16'),
           (PDS_RUNS[0][0], UPSAMPLE_4X, ZENG_KERNELS + K5, 'float32'),
           (ZHANG_BIHOME, MASK_KEYS, WARP_KERNELS + K5, 'float32'),
           (ZHANG_BIHOME, MASK_KEYS, WARP_KERNELS + K5, 'bfloat16'),
           (ZHANG_RUNS[0], LEARNED_MASKS, WARP_KERNELS + K5, 'float32'))
K5_FAULTS = ('K5 dimg negated', 'K4 du negated')
VARIANT_RUNS = {
    'l2': ('MODEL.HEAD.TRIPLET_DISTANCE=l2',),
    'cosine': ('MODEL.HEAD.TRIPLET_DISTANCE=cosine',
               'MODEL.HEAD.TRIPLET_MARGIN=0.1'),
    'one-line': ('MODEL.BACKBONE.VARIANT=OneLine',
                 'MODEL.BACKBONE.TARGET_KEYS=[delta_hat_12]',
                 'MODEL.HEAD.DELTA_HAT_KEYS=[delta_hat_12]',
                 'MODEL.HEAD.TRIPLET_LOSS=one-line',
                 'MODEL.HEAD.TRIPLET_MARGIN=1.0'),
    'projection head': (
        'MODEL.HEAD.WITH_PROJECTION_HEAD=[[64, 64], [64, 32]]',),
    'dual': ('MODEL.HEAD.TRIPLET_LOSS=double-line-dual',),
    'multihead, MSELoss': ('MODEL.HEAD.TRIPLET_LOSS=', 'SOLVER.LOSS=MSELoss'),
    'BN_TRAIN, FREEZE false': ('MODEL.HEAD.AUXILIARY_RESNET_BN_TRAIN=true',
                               'MODEL.HEAD.AUXILIARY_RESNET_FREEZE=false')}
VARIANT_STEPS = 2
# The DSAC slice: pds zeng-biHomE at batch 64 with RANSAC_HYPOTHESIS_NO
# DSAC_N, once for each scoring method (DSAC_RUNS; the double-line loss,
# whose scores weigh nothing, so the score CNN's parameters take no
# gradient there, as in JAX), and on the one-line loss with the score CNN,
# whose parameters must move. Each launches exactly K1-K4, the biHomE loss
# warping 2·B·n = 512 patches. The one-step check (batch 4, K4's du negated
# planted) of DSAC_STEP_CHECKS; the S-COCO evals at n 4 of DSAC_EVALS
# (first 4 pairs against the CPU); HomographyNet (HOMOGRAPHY_NET: the
# detone-orig config with its backbone swapped, batch 128: exactly K3);
# the datagen leftovers (pds zeng-biHomE with PhotometricDistort on both
# patches and AUGMENT_BLOB_POROSITY 0.5, from a YAML written for the run:
# exactly K1-K4); and eval --vis (S-COCO zeng-biHomE, batch 64, one step:
# image_2 through K3's generic C > 1 kernel at [64,240,320,3]).
DSAC_N = 4
DSAC_SET = (f'MODEL.HEAD.RANSAC_HYPOTHESIS_NO={DSAC_N}',)
ONE_LINE_ZENG = ('MODEL.BACKBONE.VARIANT=OneLine',
                 'MODEL.BACKBONE.TARGET_KEYS=[pf_hat_12]',
                 'MODEL.HEAD.PF_KEYS=[pf_hat_12]',
                 'MODEL.HEAD.TRIPLET_LOSS=one-line',
                 'MODEL.HEAD.TRIPLET_MARGIN=1.0')
DSAC_RUNS = {
    method: DSAC_SET + (f'MODEL.HEAD.SCORING_METHOD={method}',)
    for method in ('repr_error', 'inliers_ratio', 'soft_inliers_ratio',
                   'score_cnn')}
DSAC_RUNS['score_cnn one-line'] = (
    DSAC_RUNS['score_cnn'] + ONE_LINE_ZENG)
DSAC_STEP_CHECKS = ('repr_error', 'score_cnn one-line')
DSAC_EVALS = {
    'soft_inliers_ratio': DSAC_SET + (
        'MODEL.HEAD.SCORING_METHOD=soft_inliers_ratio',)}
DSAC_EVALS['soft_inliers_ratio, refine'] = DSAC_EVALS[
    'soft_inliers_ratio'] + ('MODEL.HEAD.DSAC_PREDICT_REFINE=true',)
HOMOGRAPHY_NET = ('config/pds-coco/detone-orig-lr-5e-3.yaml', 128,
                  ('MODEL.BACKBONE.NAME=HomographyNet',))
BLOB_POROSITY = 0.5
# The data-parallel slice: pds zeng-biHomE (R34) at global batch DDP_BATCH
# over DDP_RANKS ranks (NCCL on a card each, else gloo on one shared card).
DDP_CONFIG = 'config/pds-coco/zeng-bihome-lr-1e-3.yaml'
DDP_RANKS = 2
DDP_BATCH = 64
DDP_FAULTS = ("each rank's BN and head statistics local",
              'head dgamma/dw2 from the summed moments')
DDP_KERNELS = ZENG_KERNELS
# The --multihost train runs: (name, config (None: step 17's blob YAML,
# leftover_config), extra arguments).
DDP_TRAIN_RUNS = (('whole pool', DDP_CONFIG, ()),
                  ('--pool_shard', DDP_CONFIG, ('--pool_shard',)),
                  ('blob', None, ()))
# The serving slice: pds zeng-biHomE's predict exported at a symbolic
# batch, loaded in a fresh process, held to the live predict at these
# batches within SERVING_LIMIT_PX (JAX's export check).
SERVING_BATCHES = (1, 64)
SERVING_LIMIT_PX = 1e-3
RANK_TIMEOUT_S = 600
# The pretext and extractor slice (phase 20): the extractor's pretext
# training at its defaults (batch 256, a pool of 256 320x240 images, 128x128
# patches) for PRETRAIN_ARGS' steps, each pretext, gradcl with every extra
# term, and gradpdscl at layer 2. Each launches K3 alone (the pair warp of
# the datagen and warp_gt), except gradpds, which crops and warps nothing.
PRETRAIN_ARGS = ('--steps', '20', '--unroll', '10')
PRETRAIN_RUNS = {
    'rotnet': ('--pretext', 'rotnet'),
    'grad': ('--pretext', 'grad'),
    'gradpi': ('--pretext', 'gradpi'),
    'gradpds': ('--pretext', 'gradpds'),
    'gradcl': ('--pretext', 'gradcl'),
    'gradpdscl': ('--pretext', 'gradpdscl'),
    'gradcl basin fine hard rich': (
        '--pretext', 'gradcl', '--basin_weight', '0.5', '--cl_fine_weight',
        '0.3', '--cl_hard_beta', '0.5', '--rich_target'),
    'gradpdscl layers 2': ('--pretext', 'gradpdscl', '--layers', '2'),
}
PRETRAIN_KERNELS = ('bilinear_sample_batched',)
# The one-step check of the basin-term gradcl step (float32, the card
# against the CPU plain path on the same weights and draws) at this batch,
# with K3's output shifted by one image row as the planted fault.
PRETRAIN_STEP_BATCH = 8
PRETRAIN_FAULT = 'K3 output shifted a row'
# The planted fault of K3's C > 1 kernels (a library built apart): channel
# 1's top-left tap read one pixel to the right.
K3_FAULT = ('channel 1 tap shifted a pixel',
            'o[k * kC + ci] = t00[ci] * w00',
            'o[k * kC + ci] = (ci == 1 ? t01 : t00)[ci] * w00')
# pds zeng-biHomE with a resnet50 extractor (seeded: no file).
R50_EXTRACTOR = ('MODEL.HEAD.AUXILIARY_RESNET=resnet50',
                 'MODEL.HEAD.AUXILIARY_RESNET_PATH=')


def kernel_counters():
    """Each kernel's launch counter: K1 and K2 count their narrow (Cin 16)
    and wide (Cin 64) kernels, float32 and bf16, apart."""
    from bihome_torch.ops import fused_head, warp

    return {
        'bilinear_sample_batched': (warp.bilinear_sample_batched, 'launches'),
        # K3's launches of its loop over any C > 1 or its generic form: no
        # path may launch one.
        'bilinear_sample_batched_generic': (warp.bilinear_sample_batched,
                                            'generic_launches'),
        'fused_pf_head_fwd': (fused_head.fused_pf_head_fwd, 'launches'),
        'fused_pf_head_fwd_wide': (fused_head.fused_pf_head_fwd,
                                   'wide_launches'),
        'fused_pf_head_bwd': (fused_head.fused_pf_head_bwd, 'launches'),
        'fused_pf_head_bwd_wide': (fused_head.fused_pf_head_bwd,
                                   'wide_launches'),
        'bilinear_sample_bwd_uv': (warp.bilinear_sample_bwd_uv, 'launches'),
        'bilinear_sample_bwd_img': (warp.bilinear_sample_bwd_img,
                                    'launches'),
        'fused_pf_head_fwd_bf16': (fused_head.fused_pf_head_fwd,
                                   'bf16_launches'),
        'fused_pf_head_bwd_bf16': (fused_head.fused_pf_head_bwd,
                                   'bf16_launches'),
        'fused_pf_head_fwd_wide_bf16': (fused_head.fused_pf_head_fwd,
                                        'wide_bf16_launches'),
        'fused_pf_head_bwd_wide_bf16': (fused_head.fused_pf_head_bwd,
                                        'wide_bf16_launches')}


def bound_ms(nbytes, flops, flop_per_s=FP32_FLOP_PER_S):
    """(ms, 'bytes' or 'operations'): the larger of bytes over HBM rate and
    flops over ``flop_per_s`` (the fp32 cores unless stated)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else 'operations')


@contextlib.contextmanager
def one_cpu_thread():
    """Run torch's CPU ops on one thread, so that the CPU references are
    the same in every run: computed on 8 threads, the eval batch's CPU
    delta_hat once came out pixels off on its first call, and right on
    the next, on the machine with the card."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _grid(u, v, h, w):
    return torch.stack([u * (2.0 / (w - 1)) - 1.0,
                        v * (2.0 / (h - 1)) - 1.0], dim=-1)[:, None]


def check_warp(dev, gen, n=BATCH):
    """K3 at the datagen shape: ``n`` grayscale 192x192 windows (64 for
    zeng-biHomE and detone-biHomE, 128 for detone-orig and nguyen-orig),
    the 128x128 warped patch grid of random corner perturbations (rho
    32)."""
    from bihome_torch import geometry
    from bihome_torch.ops import warp

    ws, ps, rho = 192, 128, 32
    windows = (torch.rand((n, ws, ws, 1), generator=gen) * 255).to(dev)
    corners = geometry.image_corners(ps, ps, batch_size=n) + rho
    delta = torch.randint(-rho, rho, (n, 4, 2), generator=gen).float()
    hom = geometry.four_point_to_homography(corners, delta)
    u, v = geometry.homography_grid(hom, (ps, ps), offset=corners[:, 0])
    u, v = u.to(dev), v.to(dev)
    got = warp.bilinear_sample_batched(windows, u, v)
    want = warp.bilinear_sample_plain(windows, u, v)
    err = (got - want).abs().max().item()
    print(f'K3 warp C=1 [{n},{ws},{ws},1] P={ps * ps}: max abs err {err:.3e}'
          f' (values 0..255, tolerance 1e-3)')
    if not err <= 1e-3:
        raise AssertionError(f'warp kernel disagrees with plain: {err}')

    # Small C=3 case, a third of the points outside the image.
    img3 = (torch.rand((2, 24, 30, 3), generator=gen) * 255).to(dev)
    u3 = (torch.rand((2, 999), generator=gen) * 50 - 10).to(dev)
    v3 = (torch.rand((2, 999), generator=gen) * 44 - 10).to(dev)
    err3 = (warp.bilinear_sample_batched(img3, u3, v3)
            - warp.bilinear_sample_plain(img3, u3, v3)).abs().max().item()
    print(f'K3 warp C=3 with out-of-bounds points: max abs err {err3:.3e}')
    if not err3 <= 1e-3:
        raise AssertionError(f'warp kernel disagrees (C=3): {err3}')

    # One PyTorch call for the same function, as a yardstick only.
    img_nchw = windows.permute(0, 3, 1, 2).contiguous()
    grid = _grid(u, v, ws, ws)

    def library():
        return torch.nn.functional.grid_sample(
            img_nchw, grid, mode='bilinear', padding_mode='zeros',
            align_corners=True)
    lib_err = (library()[:, :, 0].permute(0, 2, 1) - want).abs().max().item()
    ms = time_ms(lambda: warp.bilinear_sample_batched(windows, u, v))
    plain_ms = time_ms(lambda: warp.bilinear_sample_plain(windows, u, v))
    library_ms = time_ms(library)
    host = {'kernel': host_us(lambda: warp.bilinear_sample_batched(windows, u,
                                                                   v)),
            'grid_sample': host_us(library)}
    p = ps * ps
    nbytes = 4 * (n * ws * ws + 2 * n * p + n * p)
    flops = 15 * n * p          # 4 tap weights + 4 products + 3 adds + floors
    bms, by = bound_ms(nbytes, flops)
    print(f'K3 times (ms): kernel {ms:.4f}  plain {plain_ms:.4f}  '
          f'grid_sample {library_ms:.4f} (max abs diff {lib_err:.2e})  '
          f'bound {bms:.4f} ({by}); host us per call: kernel '
          f'{host["kernel"]:.1f}  grid_sample {host["grid_sample"]:.1f}')
    return {'name': 'bilinear_sample_batched', 'route': 'cuda',
            'source': 'bihome_torch/csrc/warp.cu',
            'replaces': 'bihome_tpu/ops/warp_pallas.py:55',
            'shape': [n, ws, ws, 1], 'points': p,
            'max_abs_err': max(err, err3), 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bms, 'bound_by': by, 'library_ms': library_ms,
            'host_us': host}


def check_pf_head(dev, gen, cin=16, cmid=128, n=2 * BATCH):
    """K1 at the eval shape: the DoubleLine [2B,Cin,128,128] activation
    (``n`` = 2B = 128 images, M = 2,097,152 pixels; zeng-orig's OneLine
    head takes ``n`` = B = 64), Cout 2, one gamma == 0 channel; Cin 16 /
    Cmid 128 (the ResNet34-flavour head) or Cin 64 / Cmid 512 (the
    ResNet50 one, its own kernel)."""
    from bihome_torch.ops import fused_head

    cout, hw = 2, 128

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(dev)
    x = rnd(n, cin, hw, hw)
    w1, b1 = rnd(cmid, cin, 1, 1, scale=0.3), rnd(cmid, scale=0.2)
    gamma, beta = rnd(cmid, scale=0.2, shift=1.0), rnd(cmid, scale=0.1)
    gamma[0] = 0.0
    w2, b2 = rnd(cout, cmid, 1, 1, scale=0.3), rnd(cout, scale=0.1)
    mean = rnd(cmid, scale=0.1)
    var = (torch.rand(cmid, generator=gen) + 0.5).to(dev)
    args = (x, w1, b1, gamma, beta, w2, b2, mean, var)
    got = fused_head.fused_pf_head_fwd(*args)
    want = fused_head.pf_head_fwd_plain(*args)
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    print(f'K1 PF head [{n},{cin},{hw},{hw}] Cmid={cmid}: max abs err '
          f'{err:.3e} (max |out| {scale:.2f}; tolerance 1e-4 * (1 + max))')
    if not err <= 1e-4 * (1.0 + scale):
        raise AssertionError(f'PF-head kernel disagrees with plain: {err}')
    ms = time_ms(lambda: fused_head.fused_pf_head_fwd(*args))
    plain_ms = time_ms(lambda: fused_head.pf_head_fwd_plain(*args))
    host = {'kernel': host_us(lambda: fused_head.fused_pf_head_fwd(*args))}
    m = n * hw * hw
    nbytes = 4 * (m * cin + m * cout + cmid * cin + 3 * cmid + cout * cmid
                  + cout + cmid)
    flops = 2 * m * (cin * cmid + cmid * cout)
    # K1 runs its [M,Cin] x [Cin,Cmid] product on the tensor cores in
    # 3xTF32 (three passes) and the epilogue (the sum of the two passes'
    # accumulators, the ReLU, Cout FMAs: 2 + 2 Cout flops per middle value)
    # on the fp32 cores beside them: its bound is the largest of the bytes,
    # the 3xTF32 tensor work and the epilogue. The fp32-core bound of the
    # whole function is shown beside it.
    tc3 = 3 * 2 * m * cin * cmid / TF32_TC_FLOP_PER_S * 1e3
    epilogue = m * cmid * (2 + 2 * cout) / FP32_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bms = max(t_bytes, tc3, epilogue)
    by = 'bytes' if bms == t_bytes else 'operations'
    bfp, byfp = bound_ms(nbytes, flops)
    print(f'K1 times (ms): kernel {ms:.4f}  plain {plain_ms:.4f}  '
          f'bound {bms:.4f} ({by}, tensor cores: 3xTF32 tensor work '
          f'{tc3:.4f}, fp32 epilogue {epilogue:.4f}, bytes {t_bytes:.4f}); '
          f'fp32-core bound {bfp:.4f} ({byfp}); host us per call: kernel '
          f'{host["kernel"]:.1f}')
    extra = {}
    if cin == 64:
        # The wide K1's two kernels; 'pf_head' catches any other kernel of
        # csrc/fused_head.cu (torch's own kernels of the BN fold aside).
        parts = kernel_ms(lambda: fused_head.fused_pf_head_fwd(*args),
                          WIDE_K1_PARTS + ('pf_head',))
        print('K1 wide by kernel (ms, torch.profiler): ' + ', '.join(
            f'{k} {parts.get(v, float("nan")):.4f}'
            for k, v in zip(('prep', 'forward'), WIDE_K1_PARTS))
            + f'; sum {sum(parts.values()):.4f}, total {ms:.4f}, bound '
            f'{bms:.4f}')
        if sorted(parts) != sorted(WIDE_K1_PARTS):
            raise AssertionError(f'K1 wide: the profiler saw {sorted(parts)}'
                                 f', not exactly {WIDE_K1_PARTS}')
        extra = {'kernel_ms': parts}
    return {'name': 'fused_pf_head_fwd', 'route': 'cuda',
            'source': 'bihome_torch/csrc/fused_head.cu',
            'replaces': 'bihome_tpu/ops/fused_head.py:93',
            'shape': [n, cin, hw, hw], 'cmid': cmid,
            'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bms, 'bound_by': by, 'library_ms': None,
            'host_us': host, **extra}


def reset_counts(counters):
    """Set every launch counter to 0; ``counters`` maps a name to the
    wrapper and its counter's attribute."""
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def read_counts(counters):
    return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}


def run_eval_path(counters, config=CONFIG, batch_size=BATCH, steps=STEPS,
                  expect=('bilinear_sample_batched', 'fused_pf_head_fwd'),
                  sets=(), check_pairs=None, synthetic=True, extra=()):
    """The port's eval entry point on the card (config overrides ``sets``,
    more arguments ``extra``; the synthetic images unless ``synthetic`` is
    off; LOGGING.DIR an empty directory, so the weights are the seeded
    init unless ``extra`` names a checkpoint), counted (the kernels in
    ``expect`` must launch, the others in ``counters`` must not); then one
    batch against the plain path on the CPU with the same weights and
    injected DSAC draws (heads without DSAC ignore them): the whole batch,
    or its first ``check_pairs`` pairs (eval-mode BN is per pair)."""
    from bihome_torch import eval as teval

    reset_counts(counters)
    args = ['--config_file', config, '--batch_size', str(batch_size),
            '--steps', str(steps), '--device', 'cuda', *extra]
    if synthetic:
        args.append('--synthetic')
    for item in sets:
        args += ['--set', item]
    with tempfile.TemporaryDirectory() as empty:
        result = teval.main(args + ['--set', f'LOGGING.DIR={empty}'])
    launches = read_counts(counters)
    print(f'launches on the eval path of {config} (batch {batch_size}, '
          f'{steps} steps): {launches}')
    for name, count in launches.items():
        if (count > 0) != (name in expect):
            raise AssertionError(
                f'{name} launched {count} times on the eval path of '
                f'{config}; expected {"some" if name in expect else "none"}')
    if not all(torch.isfinite(torch.as_tensor(result['maces']))):
        raise AssertionError('non-finite MACE')
    pairs_per_s = batch_size / (result['per_batch_ms'] / 1e3)
    print(f'eval: Mean mace {result["mean_mace"]}  Mean model time '
          f'{result["per_batch_ms"]} ms/batch  pairs/s {pairs_per_s:.1f}')

    model = result['model']
    batch = result['batches'][0]
    model_cpu = copy.deepcopy(model).cpu()
    k = check_pairs or batch_size
    # The DSAC draws of the 1->2 field, then of the 2->1 field (drawn
    # from only with DSAC_PREDICT_BIDIRECTIONAL).
    draws = torch.Generator().manual_seed(5)
    uniforms, uniforms21 = (torch.rand((batch_size, dsac_draws(model.head)),
                                       generator=draws) for _ in range(2))
    batch_cpu = {key: v[:k].cpu() for key, v in batch.items()}
    if result['built'].dtype == torch.bfloat16:
        delta_cuda = model.predict(batch, uniforms=uniforms.cuda()).cpu()
        with one_cpu_thread():
            delta_cpu = model_cpu.predict(batch_cpu, uniforms=uniforms[:k])
        result['bf16_predict'] = check_bf16_predict(
            delta_cuda[:k], delta_cpu, model, model_cpu, batch_cpu,
            uniforms[:k])
        return launches, result, pairs_per_s
    delta_cuda = model.predict(batch, uniforms=[
        uniforms.cuda(), uniforms21.cuda()]).cpu()
    with one_cpu_thread():
        delta_cpu = model_cpu.predict(batch_cpu, uniforms=[
            uniforms[:k], uniforms21[:k]])
    err = (delta_cuda[:k] - delta_cpu).abs().max().item()
    result['delta_err'] = err
    print(f'delta_hat CUDA vs CPU plain path, batch 0 (first {k} pairs): '
          f'max abs err {err:.3e} px (max |delta_hat| '
          f'{delta_cpu.abs().max().item():.2f}; tolerance 1e-2 px)')
    if not (delta_cuda.shape == (batch_size, 4, 2) and err <= 1e-2):
        raise AssertionError(f'CUDA predict disagrees with CPU: {err}')
    return launches, result, pairs_per_s


def check_bf16_predict(delta_cuda, delta_cpu, model, model_cpu, batch_cpu,
                       uniforms):
    """A bf16 model's delta_hat on the card against the CPU plain path at
    bf16, within BF16_PREDICT_REL relative L2, the CPU's float32 prediction
    of the same model beside it (the spread of two roundings); the
    backbone's outputs on the card are bf16. Then the same from the card's
    own input of the model's tail (``tail_from``: the PF head, or the
    ResNet34 regressor's fc) on: the card within BF16_TAIL_PREDICT of the
    CPU at bf16, which the CPU at float32 must miss (the regressor's last
    stage too, printed only)."""
    from bihome_torch.models import layers

    model32 = layers.set_compute_dtype(copy.deepcopy(model_cpu),
                                       torch.float32)
    with one_cpu_thread():
        delta32 = model32.predict(batch_cpu, uniforms=uniforms)
    rel, rel32 = _rel_l2(delta_cuda, delta_cpu), _rel_l2(delta32, delta_cpu)
    batch_card = {k: v.cuda() for k, v in batch_cpu.items()}
    with torch.no_grad():
        dtypes = {k: v.dtype for k, v in model.backbone(batch_card).items()}
    print(f'bf16 delta_hat, card vs CPU plain path at bf16 ({len(delta_cpu)}'
          f' pairs): relative L2 {rel:.2e} (limit {BF16_PREDICT_REL:.0e}); '
          f'CPU float32 vs CPU bf16 {rel32:.2e}; max |delta_hat| '
          f'{delta_cpu.abs().max().item():.2f}; backbone outputs {dtypes}')
    if not (rel <= BF16_PREDICT_REL
            and set(dtypes.values()) == {torch.bfloat16}):
        raise AssertionError(f'bf16 predict on the card disagrees with the '
                             f'CPU: {rel} (float32 {rel32}), {dtypes}')
    tails = {}
    for name in TAIL_MODULES[type(model.backbone).__name__]:
        inputs, tail = [], {}
        with torch.no_grad():
            with tail_from(model, inputs, name):
                model.predict(batch_card, uniforms=uniforms.cuda())
            with tail_from(model, inputs, name):
                tail['card'] = model.predict(batch_card,
                                             uniforms=uniforms.cuda()).cpu()
            with one_cpu_thread():
                for side, m in (('CPU bf16', model_cpu),
                                ('CPU float32', model32)):
                    with tail_from(m, inputs, name):
                        tail[side] = m.predict(batch_cpu, uniforms=uniforms)
        tails[name] = {side: _rel_l2(tail[side], tail['CPU bf16'])
                       for side in ('card', 'CPU float32')}
        print(f'bf16 delta_hat from the card\'s input of {name} '
              f'{[list(x.shape) for x in inputs]}: card vs CPU at bf16 '
              f'{tails[name]["card"]:.2e}, CPU float32 vs CPU at bf16 '
              f'{tails[name]["CPU float32"]:.2e}')
    held = tails[TAIL_MODULES[type(model.backbone).__name__][0]]
    print(f'bf16 tail prediction check: the card within '
          f'{BF16_TAIL_PREDICT:.0e} {held["card"] <= BF16_TAIL_PREDICT}, '
          f'float32 beyond it {held["CPU float32"] > BF16_TAIL_PREDICT}')
    if not held['card'] <= BF16_TAIL_PREDICT < held['CPU float32']:
        raise AssertionError(f'the bf16 tail prediction check fails: '
                             f'{tails}')
    return {'rel_l2': rel, 'float32_rel_l2': rel32, 'tails': tails}


def run_ransac_eval_path(counters, config=ZENG_ORIG[1], batch_size=BATCH,
                         steps=PDS_STEPS,
                         expect=('fused_pf_head_fwd',
                                 'bilinear_sample_batched'), sets=()):
    """The eval entry point of s-coco/zeng-orig on the card, counted (K1
    and K3 must launch, no other kernel): predict is the OneLine backbone
    and the RANSAC fit of its perspective field (64 hypotheses of 4 of the
    16,384 field points, an inlier count each, the weighted DLT refit of
    the winner), on the card, its draws from a generator there. Then:
    RANSAC's time beside the backbone's (CUDA events around each, per
    batch, the median) and its share of the model time; the peak memory
    of the eval run and of one fit; and batch 0 against the CPU plain path
    on the same weights, batch and injected draws. Samples whose winning
    hypothesis and inlier set match must agree within 1e-2 px; those whose
    winner or its inlier count differ are counted and printed (a
    degenerate hypothesis, its pole on the field, can count a few points
    apart in two roundings: tests/test_torch_ransac.py). LOGGING.DIR is an
    empty directory: the weights are the seeded init. At bf16 (``sets``
    MODEL.DTYPE=bfloat16; ``expect`` the narrow K1 bf16) the CPU fits the
    card's own bf16 field: two bf16 backbones part by more than the
    tolerance (``check_bf16_predict``), and the check is of the fit on a
    bf16 field, which both widen to float32 before the mapping."""
    from bihome_torch import eval as teval
    from bihome_torch.heads import ransac

    reset_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as empty:
        result = teval.main(['--config_file', config, '--synthetic',
                             '--batch_size', str(batch_size), '--steps',
                             str(steps), '--device', 'cuda', '--set',
                             f'LOGGING.DIR={empty}',
                             *(a for item in sets for a in ('--set', item))])
    launches = read_counts(counters)
    eval_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f'launches on the eval path of {config} {list(sets)} (batch '
          f'{batch_size}, {steps} steps): {launches}')
    for name, count in launches.items():
        if (count > 0) != (name in expect):
            raise AssertionError(
                f'{name} launched {count} times on the eval path of '
                f'{config}; expected {"some" if name in expect else "none"}')
    if not all(torch.isfinite(torch.as_tensor(result['maces']))):
        raise AssertionError('non-finite MACE')
    model, key = result['model'], result['model'].head.learning_keys[1]
    model_ms = result['per_batch_ms']
    parts = {'backbone': [], 'ransac': []}
    with torch.inference_mode():
        for i, batch in enumerate(result['batches']):
            gen = teval.dsac_generator(result['test_seed'], i, 'cuda')
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            pf = model.backbone(batch)[key]
            ev[1].record()
            ransac.perspective_field_to_delta(pf, generator=gen)
            ev[2].record()
            ev[2].synchronize()
            parts['backbone'].append(ev[0].elapsed_time(ev[1]))
            parts['ransac'].append(ev[1].elapsed_time(ev[2]))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ransac.perspective_field_to_delta(
            pf, generator=teval.dsac_generator(0, 0, 'cuda'))
        torch.cuda.synchronize()
        fit_peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    med = {k: sorted(v)[len(v) // 2] for k, v in parts.items()}
    share = med['ransac'] / model_ms
    pairs_per_s = batch_size / (model_ms / 1e3)
    print(f'eval {config}: Mean mace {result["mean_mace"]}  Mean model time '
          f'{model_ms} ms/batch  pairs/s {pairs_per_s:.1f}; backbone '
          f'{med["backbone"]:.3f} ms, RANSAC fit {med["ransac"]:.3f} ms (CUDA'
          f' events, median of {len(parts["ransac"])}), RANSAC {share:.1%} of'
          f' the model time; peak memory allocated {eval_peak_gb:.2f} GB in '
          f'the eval run, {fit_peak_gb:.2f} GB above the field for one fit')

    batch = result['batches'][0]
    cpu = copy.deepcopy(model).cpu()
    with torch.inference_mode():
        pf_card = model.backbone(batch)[key]
    n_points = pf_card.shape[1] * pf_card.shape[2]
    idx = ransac.draw_indices(batch_size, n_points, ransac.NUM_HYPOTHESES,
                              torch.Generator().manual_seed(5))
    delta_card = model.predict(batch, idx=idx.cuda()).cpu()
    with torch.inference_mode():
        fit_card = ransac.ransac_fit(*ransac.field_points(pf_card),
                                     idx=idx.cuda())
    bf16 = pf_card.dtype == torch.bfloat16
    with one_cpu_thread(), torch.inference_mode():
        pf_cpu = (pf_card.cpu() if bf16 else
                  cpu.backbone({k: v.cpu() for k, v in batch.items()})[key])
        fit_cpu = ransac.ransac_fit(*ransac.field_points(pf_cpu), idx=idx)
        delta_cpu = ransac.fit_to_delta(fit_cpu, pf_cpu.shape)
    if bf16 and not (fit_card.homography.dtype == fit_cpu.homography.dtype
                     == torch.float32):
        raise AssertionError('the fit of a bf16 field is not float32')
    counts_card = fit_card.counts.cpu()
    same_best = fit_card.best.cpu() == fit_cpu.best
    same_count = counts_card.amax(-1) == fit_cpu.counts.amax(-1)
    same_inliers = same_best & (fit_card.inliers.cpu()
                                == fit_cpu.inliers).all(-1)
    err = (delta_card - delta_cpu).abs().amax(dim=(1, 2))
    err_match = float(err[same_inliers].max()) if same_inliers.any() else 0.0
    differ = int((~(same_best & same_count)).sum())
    hyps_differ = int((counts_card != fit_cpu.counts).sum())
    field = "the card's bf16 field, " if bf16 else ''
    print(f'RANSAC delta_hat CUDA vs CPU plain path, batch 0 ({batch_size} '
          f'pairs, {field}mean |pf| '
          f'{float(pf_cpu.float().abs().mean()):.2f} px, the same '
          f'draws): max abs err {float(err.max()):.3e} px, {err_match:.3e} '
          f'px over the {int(same_inliers.sum())} samples whose winner and '
          f'inlier set match (tolerance 1e-2 px); samples whose winning '
          f'hypothesis or its inlier count differ: {differ}; hypotheses '
          f'whose inlier count differs: {hyps_differ} of '
          f'{counts_card.numel()}; winner inliers per sample '
          f'{int(fit_cpu.counts.amax(-1).min())}-'
          f'{int(fit_cpu.counts.amax(-1).max())} of {n_points}')
    if not (delta_card.shape == (batch_size, 4, 2) and err_match <= 1e-2
            and bool(torch.isfinite(delta_card).all())):
        raise AssertionError(f'CUDA RANSAC predict disagrees with CPU: '
                             f'{err_match}')
    summary = {'config': config, 'sets': list(sets), 'batch': batch_size,
               'mean_mace': result['mean_mace'], 'model_ms': model_ms,
               'pairs_per_s': pairs_per_s, 'backbone_ms': med['backbone'],
               'ransac_ms': med['ransac'], 'ransac_share': share,
               'eval_peak_gb': eval_peak_gb, 'ransac_fit_peak_gb': fit_peak_gb,
               'max_px_err': float(err.max()),
               'max_px_err_same_inliers': err_match,
               'samples_winner_or_count_differ': differ,
               'hypotheses_count_differ': hyps_differ}
    return launches, summary


def _rel_err(got, want, scale=None):
    """max |got - want| over the largest |want| (or ``scale``)."""
    scale = float(want.abs().max()) if scale is None else scale
    return float((got - want).abs().max()) / max(scale, 1e-30)


def _moments_float64(x, g, w1t, gis, c1, w2gis, images=16):
    """The plain moment pass (``pf_head_bwd_plain``) over ``images``
    images at a time, the sums added in float64: the card holds the
    float64 middle of 16 images, not of 128."""
    from bihome_torch.ops import fused_head as fh

    parts = [fh.pf_head_bwd_plain(x[i:i + images], g[i:i + images], w1t,
                                  gis, c1, w2gis)
             for i in range(0, x.shape[0], images)]
    return (torch.cat([p[0] for p in parts]),
            *(sum(p[k] for p in parts) for k in range(1, 5)))


def _kink_flips(got_dx, want_dx, bad, args64, scale):
    """The ReLU masks the kernel took otherwise than float64, read off its
    dx: at each pixel (n, h, w) of ``bad`` (dx off), the middle channels
    within 1e-5 of the kink in float64 whose flipped masks leave the least
    of dx's jump there. -> ([(n, h, w, channel, +1 / -1, mid)], the
    largest jump they leave, over ``scale``)."""
    x, g, w1, b1, gamma, beta, w2, mean, var = args64[:9]
    cmid, cin = w1.shape[:2]
    gis = gamma * torch.rsqrt(var + 1e-5)
    c1 = gis * (b1 - mean) + beta
    w1t = w1.reshape(cmid, cin)
    w2gis = w2.reshape(w2.shape[0], cmid).t() * gis[:, None]
    flips, left = [], 0.0
    for i, j, k in bad.tolist():
        xp, gp = x[i, :, j, k], g[i, :, j, k]
        mid = w1t @ xp
        pre = gis * mid + c1
        near = (pre.abs() < 1e-5).nonzero().flatten().tolist()
        if len(near) > 8:
            return flips, float('inf')
        jump = (got_dx[i, :, j, k] - want_dx[i, :, j, k]).double()
        terms = {c: (1.0 if pre[c] <= 0 else -1.0) * w1t[c] * (w2gis[c] @ gp)
                 for c in near}
        rest, chosen = min(
            (float((jump - sum(terms[c] for c in sub)).abs().max()), sub)
            for r in range(len(near) + 1)
            for sub in itertools.combinations(near, r))
        left = max(left, rest / scale)
        flips += [(i, j, k, c, 1.0 if pre[c] <= 0 else -1.0, mid[c])
                  for c in chosen]
    return flips, left


def check_pf_head_bwd(dev, gen, cin=16, cmid=128, n=2 * BATCH):
    """K2 at the training shape: x [n,Cin,128,128] (``n`` = 2B = 128, M =
    2,097,152 pixels, B = 64; zeng-orig's OneLine head ``n`` = B), a dense
    random cotangent g [n,2,128,128], batch statistics, one gamma == 0
    channel; Cin 16 / Cmid 128 or Cin 64 / Cmid 512 (the ResNet50-flavour
    head). The seven gradients through the kernel against the same algebra
    through the plain moment pass in float64, on the card, with the ReLU
    masks that the kernel's dx shows it took at the kink."""
    from bihome_torch.ops import fused_head as fh

    cout, hw = 2, 128

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(dev)
    x = torch.relu(rnd(n, cin, hw, hw))         # a ReLU output, as on the path
    w1, b1 = rnd(cmid, cin, 1, 1, scale=0.3), rnd(cmid, scale=0.2)
    gamma, beta = rnd(cmid, scale=0.2, shift=1.0), rnd(cmid, scale=0.1)
    gamma[0] = 0.0
    w2 = rnd(cout, cmid, 1, 1, scale=0.3)
    g = rnd(n, cout, hw, hw)
    mean, var = fh.batch_stats_affine(x, w1, b1)
    args = (x, g, w1, b1, gamma, beta, w2, mean, var, 1e-5, True)
    args64 = [a.double() if torch.is_tensor(a) else a for a in args]
    got = fh.pf_head_backward(*args)
    # The reference: the same algebra through the plain moment pass in
    # float64 (over 16 images at a time). The plain version in float32 is
    # measured against it too.
    want = [t.float() for t in fh.pf_head_backward(
        *args64, moments=_moments_float64)]
    plain32 = fh.pf_head_backward(*args, moments=fh.pf_head_bwd_plain)
    names = ('dx', 'dw1', 'db1', 'dgamma', 'dbeta', 'dw2', 'db2')

    def errors(res, ref):
        # db1 is 0 analytically (the batch mean absorbs b1): measure it on
        # the scale of the terms that cancel in it, dbeta's.
        return {name: _rel_err(a, b, float(ref[4].abs().max())
                               if name == 'db1' else None)
                for name, a, b in zip(names[1:], res[1:], ref[1:])}
    errs = errors(got, want)
    errs_plain = errors(plain32, want)
    inv_s = torch.rsqrt(var + 1e-5)
    gis = (gamma * inv_s).contiguous()
    c1 = (gis * (b1 - mean) + beta).contiguous()
    w1t = w1.reshape(cmid, cin).contiguous()
    # dx is per pixel. Where a middle channel's pre-ReLU value lies within
    # rounding of 0, the kernel and the plain version (sums in another
    # order) may take the ReLU mask differently, and dx there jumps by a
    # whole term: such pixels are allowed, and must be exactly those.
    off = ((got[0] - want[0]).abs() > 1e-4 * want[0].abs().max()).any(1)
    bad = off.nonzero()                                       # [k, 3] n,h,w
    pre = (x[bad[:, 0], :, bad[:, 1], bad[:, 2]] @ w1t.t()) * gis + c1
    at_kink = bool((pre.abs().amin(1) < 1e-5).all())
    keep = ~off[:, None].expand_as(got[0])
    dx_got, dx_want = got[0][keep], want[0][keep]
    errs['dx'] = _rel_err(dx_got, dx_want, float(want[0].abs().max()))
    # Each such flip moves the sums by one pixel's term (M0 by g, M1 by
    # mid g, dw1 by x e), which the batch-statistics corrections carry
    # into every gradient at up to a few 1e-3 of its largest value, in the
    # plain version in float32 as in the kernel (the first readings
    # printed). So the gradients are held to float64 on the kernel's own
    # masks: float64's, turned over at the flips that explain dx's jumps,
    # each of which must leave less than 1e-5 of max|dx|.
    flips, left = _kink_flips(got[0], want[0], bad, args64,
                              float(want[0].abs().max()))
    x64, g64 = args64[0], args64[1]

    def moments_on_kernel_masks(*margs):
        dx, m0, m1, db2, dw1 = _moments_float64(*margs)
        w2gis64 = margs[5]
        for i, j, k, c, sign, mid in flips:
            gp = g64[i, :, j, k]
            m0[c] += sign * gp
            m1[c] += sign * mid * gp
            dw1[:, c] += sign * x64[i, :, j, k] * (w2gis64[c] @ gp)
        return dx, m0, m1, db2, dw1
    want_k = [t.float() for t in fh.pf_head_backward(
        *args64, moments=moments_on_kernel_masks)]
    errs_k = errors(got, want_k)
    errs_k['dx'] = errs['dx']
    err = max(errs_k.values())
    # On the kernel's masks each gradient within 1e-4 of max|ref| (they
    # read 1e-7 to 3e-5 at the three shapes on the H100; float32's sums
    # over 1-2M pixels and the cancelling corrections); dx, off the kink
    # pixels, within 1e-3 (the wide K2's reads 8.6e-5).
    limits = {k: 1e-3 if k == 'dx' else 1e-4 for k in errs_k}
    # The kernel's own outputs (the one-pass moments) against float64.
    w2gis = (w2.reshape(cout, cmid).t() * gis[:, None]).contiguous()
    margs = (x, g, w1t, gis, c1, w2gis)
    raw = fh.fused_pf_head_bwd(*margs)
    raw64 = _moments_float64(*(a.double() for a in margs))
    raw_errs = {k: _rel_err(a, b.float()) for k, a, b in
                zip(('m0', 'm1', 'db2', 'dw1'), raw[1:], raw64[1:])}
    raw_errs['dx'] = _rel_err(raw[0][keep], raw64[0].float()[keep],
                              float(raw64[0].abs().max()))
    print('K2 PF head backward [%d,%d,%d,%d] Cmid=%d: error / max|ref| per '
          'gradient against float64 %s (the plain version in float32: %s); '
          'on the kernel\'s masks (%d kink flips read off dx, leaving %.2e '
          'of max|dx|) %s (limit 1e-4, dx 1e-3); the kernel\'s moments '
          'against float64 (dx off the kink pixels; M0 and M1 move with the '
          'mask there too): %s; dx off by more than 1e-4 max|dx| at %d of %d '
          'pixels, each with a middle channel within 1e-5 of the ReLU kink: '
          '%s' % (
              n, cin, hw, hw, cmid, ', '.join(
                  f'{k} {v:.2e}' for k, v in errs.items()), ', '.join(
                  f'{k} {v:.2e}' for k, v in errs_plain.items()), len(flips),
              left, ', '.join(f'{k} {v:.2e}' for k, v in errs_k.items()),
              ', '.join(f'{k} {v:.2e}' for k, v in raw_errs.items()),
              len(bad), off.numel(), at_kink))
    if not (all(errs_k[k] <= limits[k] for k in errs_k) and at_kink
            and left < 1e-5 and len(bad) <= 1e-4 * off.numel()):
        raise AssertionError(f'PF-head backward kernel disagrees: {errs_k}, '
                             f'{len(bad)} pixels off, at kink {at_kink}, '
                             f'flips leave {left}')
    ms = time_ms(lambda: fh.fused_pf_head_bwd(*margs))
    plain_ms = time_ms(lambda: fh.pf_head_bwd_plain(*margs))
    host = {'kernel': host_us(lambda: fh.fused_pf_head_bwd(*margs))}
    m = n * hw * hw
    nbytes = 4 * (m * cin + m * cout + m * cin + cmid * cin + 2 * cmid
                  + cmid * cout + cin * cmid + 2 * cmid * cout + cout)
    # mid, dx, dw1: 2*cin*cmid each; per middle channel: a (2), mask (1),
    # e (2*cout + 1), M0 (2*cout), M1 (1 + 2*cout); db2: cout.
    flops = m * (6 * cin * cmid + cmid * (5 + 6 * cout) + cout)
    # K2 runs its three products on the tensor cores in 3xTF32 and the
    # epilogue (5 + 6 Cout flops per middle value) on the fp32 cores beside
    # them: its bound is, as K1's, the largest of the bytes, the 3xTF32
    # tensor work and the epilogue. The fp32-core bound of the whole
    # function is shown beside it.
    bfp, byfp = bound_ms(nbytes, flops)
    tc3 = 3 * m * 6 * cin * cmid / TF32_TC_FLOP_PER_S * 1e3
    epilogue = m * cmid * (5 + 6 * cout) / FP32_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bms = max(t_bytes, tc3, epilogue)
    by = 'bytes' if bms == t_bytes else 'operations'
    print(f'K2 times (ms): kernel {ms:.4f}  plain {plain_ms:.4f}  '
          f'bound {bms:.4f} ({by}, tensor cores: 3xTF32 tensor work '
          f'{tc3:.4f}, fp32 epilogue {epilogue:.4f}, bytes {t_bytes:.4f}; '
          f'{flops / 1e9:.2f} GFLOP, {nbytes / 1e9:.3f} GB); fp32-core bound '
          f'{bfp:.4f} ({byfp}); host us per call: kernel '
          f'{host["kernel"]:.1f}')
    extra = {}
    if cin == 64:
        # The wide K2 computes mid twice (its dx and sums kernels): four
        # 3xTF32 products, the floor of its design above the bound's three.
        parts = kernel_ms(lambda: fh.fused_pf_head_bwd(*margs), WIDE_K2_PARTS)
        floor = 4 / 3 * tc3
        print('K2 wide by kernel (ms, torch.profiler): ' + ', '.join(
            f'{k} {parts.get(v, float("nan")):.4f}'
            for k, v in zip(('prep', 'dx', 'sums', 'reduce'), WIDE_K2_PARTS))
            + f'; sum {sum(parts.values()):.4f}, total {ms:.4f}, bound '
            f'{bms:.4f}, floor of four products {floor:.4f}')
        if len(parts) != len(WIDE_K2_PARTS):
            raise AssertionError(f'K2 wide: the profiler saw {sorted(parts)}'
                                 f' of {WIDE_K2_PARTS}')
        extra = {'kernel_ms': parts}
    return {'name': 'fused_pf_head_bwd', 'route': 'cuda',
            'source': 'bihome_torch/csrc/fused_head.cu',
            'replaces': 'bihome_tpu/ops/fused_head.py:110',
            'shape': [n, cin, hw, hw], 'cmid': cmid,
            'max_abs_err': max(float((a - b).abs().max()) for a, b in
                               zip((dx_got, *got[1:]), (dx_want, *want[1:]))),
            'max_rel_err': err, 'max_rel_err_float64_masks': max(
                errs.values()), 'plain_fp32_max_rel_err': max(
                errs_plain.values()), 'moments_max_rel_err': max(
                raw_errs.values()), 'kink_pixels': len(bad),
            'kink_flips': len(flips), 'ms': ms,
            'plain_ms': plain_ms,
            'bound_ms': bms, 'bound_by': by, 'library_ms': None,
            'host_us': host, **extra}


@contextlib.contextmanager
def skipped_rounding(k):
    """The plain PF head with its ``k``-th bf16 rounding point in call
    order left out (forward: g1t, w2, relu(a); backward: w1t, e, a_mat):
    the planted fault of the K1 and K2 bf16 checks (and of the CPU test of
    the plain versions against the Pallas kernels)."""
    from bihome_torch.ops import fused_head as fh

    rounded, calls = fh._rounded, [0]

    def skipping(t, dtype):
        calls[0] += 1
        return t if calls[0] - 1 == k else rounded(t, dtype)
    fh._rounded = skipping
    try:
        yield
    finally:
        fh._rounded = rounded


def _bf16_kernel(cin, direction):
    """(the kernels line's name, the wrapper's launch counter) of K1 or K2
    bf16 at the narrow (Cin 16) or the wide (Cin 64) head."""
    if cin == 64:
        return f'fused_pf_head_{direction}_wide_bf16', 'wide_bf16_launches'
    return f'fused_pf_head_{direction}_bf16', 'bf16_launches'


def check_pf_head_bf16(dev, gen, n=2 * BATCH, cin=16, cmid=128):
    """K1 bf16 at the zeng shape: a bf16 [n,16,128,128] activation (``n`` =
    2B = 128 for the DoubleLine train and eval batches of 64), Cmid 128,
    or at the R50 head's (Cin 64, Cmid 512, its own kernel), against its
    plain bf16 version (the Pallas kernel's rounding points, float32 sums)
    on the card: relative L2 within BF16_K1_L2 and every output within
    BF16_K1_MAX of the largest (4 bf16 ulps); the two round the same
    float32 values to bf16, summed in other orders."""
    from bihome_torch.ops import fused_head

    cout, hw = 2, 128
    name, counter = _bf16_kernel(cin, 'fwd')

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(dev)
    x = rnd(n, cin, hw, hw).to(torch.bfloat16)
    w1, b1 = rnd(cmid, cin, 1, 1, scale=0.3), rnd(cmid, scale=0.2)
    gamma, beta = rnd(cmid, scale=0.2, shift=1.0), rnd(cmid, scale=0.1)
    gamma[0] = 0.0
    w2, b2 = rnd(cout, cmid, 1, 1, scale=0.3), rnd(cout, scale=0.1)
    mean = rnd(cmid, scale=0.1)
    var = (torch.rand(cmid, generator=gen) + 0.5).to(dev)
    args = (x, w1, b1, gamma, beta, w2, b2, mean, var)
    before = getattr(fused_head.fused_pf_head_fwd, counter)
    got = fused_head.fused_pf_head_fwd(*args)
    if getattr(fused_head.fused_pf_head_fwd, counter) != before + 1:
        raise AssertionError(f'{name} did not launch')
    if got.dtype != torch.bfloat16:
        raise AssertionError(f'K1 bf16 returned {got.dtype}')

    def readings(want):
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        read = {'rel_l2': _rel_l2(got, want), 'max_abs_err': err,
                'differ': float((got != want).float().mean())}
        holds = (read['rel_l2'] <= BF16_K1_L2 and err <= BF16_K1_MAX * scale
                 and read['differ'] <= BF16_DIFFER)
        return read, holds, scale
    (read, holds, scale), planted = readings(
        fused_head.pf_head_fwd_plain(*args)), {}
    l2, err = read['rel_l2'], read['max_abs_err']
    print(f'K1 bf16 PF head [{n},{cin},{hw},{hw}] Cmid={cmid}: relative L2 '
          f'{l2:.2e} (limit {BF16_K1_L2:.0e}), max abs err {err:.3e} (max '
          f'|out| {scale:.2f}; limit {BF16_K1_MAX:.2e} of it), '
          f'{read["differ"]:.2e} of {got.numel()} outputs differ (limit '
          f'{BF16_DIFFER:.0e})')
    if not holds:
        raise AssertionError(f'K1 bf16 disagrees with plain: {read}')
    for k, point in enumerate(('g1t', 'w2', 'relu(a)')):
        with skipped_rounding(k):
            planted[point], holds, _ = readings(
                fused_head.pf_head_fwd_plain(*args))
        print(f'K1 bf16 against the plain version without bf16({point}): '
              f'relative L2 {planted[point]["rel_l2"]:.2e}, '
              f'{planted[point]["differ"]:.2e} differ, caught {not holds}')
        if holds:
            raise AssertionError(f'the K1 bf16 check misses bf16({point})')
    ms = time_ms(lambda: fused_head.fused_pf_head_fwd(*args))
    plain_ms = time_ms(lambda: fused_head.pf_head_fwd_plain(*args))
    host = {'kernel': host_us(lambda: fused_head.fused_pf_head_fwd(*args))}
    m = n * hw * hw
    nbytes = 2 * m * (cin + cout) + 4 * (cmid * cin + 3 * cmid + cout * cmid
                                         + cout + cmid)
    # The Cin x Cmid and Cmid x Cout products (bf16 on the tensor cores in
    # both K1 bf16), and an fp32 epilogue counted as the ReLU and Cout
    # FMAs per middle value (1 + 2 Cout: more than the kernels do, whose
    # Cout sums run on the tensor cores). The narrow bound is its bytes,
    # the wide one its tensor work, with or without that count.
    tc = 2 * m * (cin * cmid + cmid * cout) / BF16_TC_FLOP_PER_S * 1e3
    epilogue = m * cmid * (1 + 2 * cout) / FP32_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bms = max(t_bytes, tc, epilogue)
    by = 'bytes' if bms == t_bytes else 'operations'
    print(f'K1 bf16 times (ms): kernel {ms:.4f}  plain {plain_ms:.4f}  bound '
          f'{bms:.4f} ({by}: bytes {t_bytes:.4f}, bf16 tensor work '
          f'{tc:.4f}, fp32 epilogue {epilogue:.4f}; {nbytes / 1e6:.1f} MB); '
          f'host us per call: kernel {host["kernel"]:.1f}')
    return {'name': name, 'route': 'cuda',
            'source': 'bihome_torch/csrc/fused_head.cu',
            'replaces': 'bihome_tpu/ops/fused_head.py:93',
            'shape': [n, cin, hw, hw], 'cmid': cmid, 'dtype': 'bfloat16',
            'max_abs_err': err, 'rel_l2': l2, 'differ': read['differ'],
            'rounding_left_out': planted, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bms, 'bound_by': by, 'library_ms': None,
            'host_us': host}


def _off_the_kink(x, w1t, gis, c1, margin=1e-4, chunk=16):
    """Zero the pixels of bf16 x [N,Cin,H,W] whose pre-ReLU value of some
    middle channel, gis * (bf16(w1t) x) + c1 in float64, lies within
    ``margin`` of 0 (a zeroed pixel's is c1, which must be farther). Then
    every float32 order of the sums takes the same ReLU masks, and K2 bf16
    and its plain version can be held to each other's sums. Returns the
    number of pixels zeroed."""
    if not bool((c1.abs() > margin).all()):
        raise AssertionError('a c1 within the margin of the kink')
    w = w1t.to(torch.bfloat16).double()
    zeroed = 0
    for i in range(0, x.shape[0], chunk):
        xc = x[i:i + chunk]
        pre = (torch.einsum('ck,nkhw->nchw', w, xc.double())
               * gis.double()[:, None, None]
               + c1.double()[:, None, None])
        near = (pre.abs() < margin).any(1)                     # [n,h,w]
        zeroed += int(near.sum())
        xc.masked_fill_(near[:, None], 0.0)
    return zeroed


def check_pf_head_bwd_bf16(dev, gen, n=2 * BATCH, cin=16, cmid=128):
    """K2 bf16 at the zeng training shape: bf16 x (a ReLU output) and a
    dense bf16 cotangent g [n,2,128,128], Cmid 128, or at the R50 head's
    (Cin 64, Cmid 512, its own kernels), batch statistics, one gamma == 0
    channel, against its plain bf16 version on the card: dx within
    BF16_K2_DX_L2 relative L2, and dw1, M0, M1, db2 within
    BF16_K2_SUMS_L2. The pixels with a pre-ReLU value within 1e-4 of the
    kink are zeroed first (``_off_the_kink``; a beta whose c1 lies there
    is moved off it), so both take the same ReLU masks: the sums then
    differ by float32 order and by bf16(e)'s rare rounding flips only."""
    from bihome_torch.ops import fused_head as fh

    cout, hw = 2, 128
    name, counter = _bf16_kernel(cin, 'bwd')

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(dev)
    x = torch.relu(rnd(n, cin, hw, hw)).to(torch.bfloat16)
    w1, b1 = rnd(cmid, cin, 1, 1, scale=0.3), rnd(cmid, scale=0.2)
    gamma, beta = rnd(cmid, scale=0.2, shift=1.0), rnd(cmid, scale=0.1)
    gamma[0] = 0.0
    w2 = rnd(cout, cmid, 1, 1, scale=0.3)
    g = rnd(n, cout, hw, hw).to(torch.bfloat16)
    mean, var = fh.batch_stats_affine(x, w1, b1)
    inv_s = torch.rsqrt(var + 1e-5)
    gis = (gamma * inv_s).contiguous()
    # A zeroed pixel's pre-ReLU value is c1: keep every c1 off the kink.
    beta = beta + 3e-4 * ((gis * (b1 - mean) + beta).abs() <= 1e-4)
    c1 = (gis * (b1 - mean) + beta).contiguous()
    w1t = w1.reshape(cmid, cin).contiguous()
    zeroed = _off_the_kink(x, w1t, gis, c1)
    w2gis = (w2.reshape(cout, cmid).t() * gis[:, None]).contiguous()
    margs = (x, g, w1t, gis, c1, w2gis)
    before = getattr(fh.fused_pf_head_bwd, counter)
    got = fh.fused_pf_head_bwd(*margs)
    if getattr(fh.fused_pf_head_bwd, counter) != before + 1:
        raise AssertionError(f'{name} did not launch')
    want = fh.pf_head_bwd_plain(*margs)
    if got[0].dtype != torch.bfloat16:
        raise AssertionError(f'K2 bf16 returned dx in {got[0].dtype}')
    def held(got, want, names):
        """Relative L2 of each output and the share of dx's bf16 values
        that differ; whether they keep within the limits."""
        errs = {k: _rel_l2(a, b) for k, a, b in zip(names, got, want)
                if k != 'db1'}
        errs['dx differ'] = float((got[0] != want[0]).float().mean())
        limits = {k: BF16_K2_SUMS_L2 for k in errs}
        limits.update({'dx': BF16_K2_DX_L2, 'dx differ': BF16_DIFFER})
        return errs, all(errs[k] <= limits[k] for k in errs)
    names = ('dx', 'm0', 'm1', 'db2', 'dw1')
    errs, holds = held(got, want, names)
    print(f'K2 bf16 PF head backward [{n},{cin},{hw},{hw}] Cmid={cmid} '
          f'({zeroed} pixels within 1e-4 of the kink zeroed): relative L2 '
          + ', '.join(f'{k} {v:.2e}' for k, v in errs.items())
          + f' (limits dx {BF16_K2_DX_L2:.0e}, sums {BF16_K2_SUMS_L2:.0e}, '
          f'dx differ {BF16_DIFFER:.0e}); of {got[0].numel()} dx values')
    if not holds:
        raise AssertionError(f'K2 bf16 disagrees with plain: {errs}')
    # The whole backward (corrections included) on both; then the plain
    # version with each of its rounding points left out, which must fail.
    args = (x, g, w1, b1, gamma, beta, w2, mean, var, 1e-5, True)
    full = fh.pf_head_backward(*args)
    names = ('dx', 'dw1', 'db1', 'dgamma', 'dbeta', 'dw2', 'db2')
    full_errs, holds = held(full, fh.pf_head_backward(
        *args, moments=fh.pf_head_bwd_plain), names)
    print('K2 bf16 with the corrections against the plain version: relative '
          'L2 ' + ', '.join(f'{k} {v:.2e}' for k, v in full_errs.items()))
    if not holds:
        raise AssertionError(f'K2 bf16 backward disagrees: {full_errs}')
    planted = {}
    for k, point in enumerate(('w1t', 'e', 'a_mat')):
        with skipped_rounding(k):
            planted[point], holds = held(full, fh.pf_head_backward(
                *args, moments=fh.pf_head_bwd_plain), names)
        print(f'K2 bf16 against the plain version without bf16({point}): '
              + ', '.join(f'{key} {v:.2e}' for key, v in
                          planted[point].items()) + f'; caught {not holds}')
        if holds:
            raise AssertionError(f'the K2 bf16 check misses bf16({point})')
    ms = time_ms(lambda: fh.fused_pf_head_bwd(*margs))
    plain_ms = time_ms(lambda: fh.pf_head_bwd_plain(*margs))
    host = {'kernel': host_us(lambda: fh.fused_pf_head_bwd(*margs))}
    m = n * hw * hw
    nbytes = 2 * m * (2 * cin + cout) + 4 * (
        cmid * cin + 2 * cmid + cmid * cout + cin * cmid + 2 * cmid * cout
        + cout)
    # mid, dx, dw1 and M0 = sum mask g on the tensor cores (bf16: mask is
    # 0/1 and g bf16, both exact there, as the Pallas kernel's dot has
    # it); per middle value on the fp32 cores, as each kernel does it,
    # narrow and wide alike: the mask (1, mid against a per-channel
    # threshold, so no a = gis mid + c1), e (2 Cout: (gis w2) g and the
    # mask's multiply), M1 (1 + 2 Cout). db2: Cout. Counted with a's FMA
    # and e at 2 Cout + 1, as before the threshold, the narrow bound was
    # 0.0521 ms of operations at the zeng shape; it is now the bytes
    # (0.0426 ms; fp32 0.040). The wide bound is the tensor work either
    # way (0.4212 ms at the R50 shape; fp32 0.208 counted with a's FMA,
    # 0.160 without).
    tc = m * (6 * cin * cmid + 2 * cmid * cout) / BF16_TC_FLOP_PER_S * 1e3
    per_mid = 2 + 4 * cout
    epilogue = m * (cmid * per_mid + cout) / FP32_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bms = max(t_bytes, tc, epilogue)
    by = 'bytes' if bms == t_bytes else 'operations'
    print(f'K2 bf16 times (ms): kernel {ms:.4f}  plain {plain_ms:.4f}  bound '
          f'{bms:.4f} ({by}: bytes {t_bytes:.4f}, bf16 tensor work {tc:.4f},'
          f' fp32 epilogue {epilogue:.4f}; {nbytes / 1e6:.1f} MB); host us '
          f'per call: kernel {host["kernel"]:.1f}')
    extra = {}
    if cin == 64:
        # Its dx and sums kernels compute mid twice: four products, the
        # floor of its design above the bound's three.
        parts = kernel_ms(lambda: fh.fused_pf_head_bwd(*margs),
                          WIDE_BF16_K2_PARTS)
        print('K2 wide bf16 by kernel (ms, torch.profiler): ' + ', '.join(
            f'{k} {parts.get(v, float("nan")):.4f}' for k, v in zip(
                ('dx', 'sums', 'reduce'), WIDE_BF16_K2_PARTS))
            + f'; sum {sum(parts.values()):.4f}, total {ms:.4f}, floor of '
            f'four products {4 / 3 * tc:.4f}')
        if len(parts) != len(WIDE_BF16_K2_PARTS):
            raise AssertionError(f'K2 wide bf16: the profiler saw '
                                 f'{sorted(parts)} of {WIDE_BF16_K2_PARTS}')
        extra = {'kernel_ms': parts}
    return {'name': name, 'route': 'cuda',
            'source': 'bihome_torch/csrc/fused_head.cu',
            'replaces': 'bihome_tpu/ops/fused_head.py:110',
            'shape': [n, cin, hw, hw], 'cmid': cmid, 'dtype': 'bfloat16',
            'max_abs_err': max(float((a.float() - b.float()).abs().max())
                               for a, b in zip(got, want)),
            'rel_l2': errs, 'with_corrections_rel_l2': full_errs,
            'rounding_left_out': planted,
            'kink_pixels_zeroed': zeroed, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bms, 'bound_by': by, 'library_ms': None,
            'host_us': host, **extra}

def _loss_warp_points(dev, gen, n, ps):
    """The loss warp's sample points: the patch grid through homographies
    of corner offsets of a few pixels, as delta_hat gives them."""
    from bihome_torch import geometry

    corners = geometry.image_corners(ps, ps, batch_size=n)
    delta = torch.rand((n, 4, 2), generator=gen) * 16 - 8
    hom = geometry.four_point_to_homography(corners, delta)
    u, v = geometry.homography_grid(hom, (ps, ps))
    return u.to(dev), v.to(dev)


def check_warp_bwd(dev, gen):
    """K3, K4 and K5 at the loss-warp shape: 2B = 128 standardized 128x128
    patches, P = 16,384 points each, a dense random cotangent. K4 also on a
    block of exact-integer coordinates (its derivative there is 0); K5 also
    on a small C = 3 case with a third of the points outside, and its
    generic path on a sample past one block's shared memory. Returns K3's
    figures at this shape, and K4's and K5's entries."""
    from bihome_torch.ops import warp

    n, ps = 2 * BATCH, 128
    p = ps * ps
    images = torch.randn((n, ps, ps, 1), generator=gen).to(dev)
    u, v = _loss_warp_points(dev, gen, n, ps)
    u[:, :1024] = torch.round(u[:, :1024])      # exact integers in u ...
    v[:, :512] = torch.round(v[:, :512])        # ... and in both
    g = torch.randn((n, p, 1), generator=gen).to(dev)
    out = warp.bilinear_sample_batched(images, u, v)
    want_out = warp.bilinear_sample_plain(images, u, v)
    err3 = _rel_err(out, want_out)
    print(f'K3 warp at the loss warp [{n},{ps},{ps},1] P={p}: error / '
          f'max|ref| {err3:.2e} (values ~N(0,1); tolerance 1e-5)')
    if not err3 <= 1e-5:
        raise AssertionError(f'warp kernel disagrees at the loss warp: {err3}')
    du, dv = warp.bilinear_sample_bwd_uv(images, u, v, g)
    want_du, want_dv = warp.bilinear_sample_bwd_uv_plain(images, u, v, g)
    err4 = max(_rel_err(du, want_du), _rel_err(dv, want_dv))
    zero_ok = bool((du[:, :1024] == 0).all() and (dv[:, :512] == 0).all())
    print(f'K4 warp backward [{n},{ps},{ps},1] P={p}: error / max|ref| '
          f'{err4:.2e} (tolerance 1e-4); exact 0 at integer coordinates: '
          f'{zero_ok}')
    if not (err4 <= 1e-4 and zero_ok):
        raise AssertionError(f'warp backward (u, v) kernel disagrees: '
                             f'{err4}, zeros {zero_ok}')
    dimg = warp.bilinear_sample_bwd_img(u, v, g, tuple(images.shape))
    want_img = warp.bilinear_sample_bwd_img_plain(u, v, g,
                                                  tuple(images.shape))
    err5 = _rel_err(dimg, want_img)
    gen3 = torch.Generator().manual_seed(3)
    u3 = (torch.rand((2, 999), generator=gen3) * 50 - 10).to(dev)
    v3 = (torch.rand((2, 999), generator=gen3) * 44 - 10).to(dev)
    g3 = torch.randn((2, 999, 3), generator=gen3).to(dev)
    err5c3 = _rel_err(warp.bilinear_sample_bwd_img(u3, v3, g3, (2, 24, 30, 3)),
                      warp.bilinear_sample_bwd_img_plain(u3, v3, g3,
                                                         (2, 24, 30, 3)))
    # K5's generic path: a sample past one block's shared memory (128 x 240
    # x 2 floats, 245,760 bytes against the H100's 232,448).
    big = (2, 128, 240, 2)
    ug = (torch.rand((2, 20000), generator=gen3) * 260 - 10).to(dev)
    vg = (torch.rand((2, 20000), generator=gen3) * 148 - 10).to(dev)
    gg = torch.randn((2, 20000, 2), generator=gen3).to(dev)
    generic = warp.bilinear_sample_bwd_img.generic_launches
    err5big = _rel_err(warp.bilinear_sample_bwd_img(ug, vg, gg, big),
                       warp.bilinear_sample_bwd_img_plain(ug, vg, gg, big))
    took_generic = warp.bilinear_sample_bwd_img.generic_launches == generic + 1
    print(f'K5 warp image gradient: error / max|ref| {err5:.2e} (C=1), '
          f'{err5c3:.2e} (C=3, out-of-bounds points), {err5big:.2e} (the '
          f'generic path at {list(big)}: {took_generic}); tolerance 1e-4 '
          f'(shared atomics add in no fixed order)')
    if not (err5 <= 1e-4 and err5c3 <= 1e-4 and err5big <= 1e-4
            and took_generic):
        raise AssertionError(f'warp image-gradient kernel disagrees: '
                             f'{err5}, {err5c3}, {err5big} (generic path '
                             f'taken: {took_generic})')

    # One PyTorch call each for the same gradients, as yardsticks only:
    # grid_sample's backward (its convention at integers differs).
    img_nchw = images.permute(0, 3, 1, 2).contiguous()
    g_nchw = g.permute(0, 2, 1)[:, :, None, :].contiguous()
    grid = _grid(u, v, ps, ps).requires_grad_(True)
    out_grid = torch.nn.functional.grid_sample(
        img_nchw, grid, mode='bilinear', padding_mode='zeros',
        align_corners=True)
    img_req = img_nchw.clone().requires_grad_(True)
    out_img = torch.nn.functional.grid_sample(
        img_req, grid.detach(), mode='bilinear', padding_mode='zeros',
        align_corners=True)
    lib3 = time_ms(lambda: torch.nn.functional.grid_sample(
        img_nchw, grid.detach(), mode='bilinear', padding_mode='zeros',
        align_corners=True))
    ms3 = time_ms(lambda: warp.bilinear_sample_batched(images, u, v))
    plain3 = time_ms(lambda: warp.bilinear_sample_plain(images, u, v))
    host3 = {'kernel': host_us(lambda: warp.bilinear_sample_batched(images, u,
                                                                    v)),
             'grid_sample': host_us(lambda: torch.nn.functional.grid_sample(
                 img_nchw, grid.detach(), mode='bilinear',
                 padding_mode='zeros', align_corners=True))}
    lib4 = time_ms(lambda: torch.autograd.grad(out_grid, grid, g_nchw,
                                               retain_graph=True))
    lib5 = time_ms(lambda: torch.autograd.grad(out_img, img_req, g_nchw,
                                               retain_graph=True))
    ms4 = time_ms(lambda: warp.bilinear_sample_bwd_uv(images, u, v, g))
    host4 = {'kernel': host_us(lambda: warp.bilinear_sample_bwd_uv(images, u,
                                                                   v, g))}
    plain4 = time_ms(lambda: warp.bilinear_sample_bwd_uv_plain(images, u, v,
                                                               g))
    shape = tuple(images.shape)
    ms5 = time_ms(lambda: warp.bilinear_sample_bwd_img(u, v, g, shape))
    cluster5 = warp.bilinear_sample_bwd_img.last_cluster
    host5 = {'kernel': host_us(lambda: warp.bilinear_sample_bwd_img(u, v, g,
                                                                    shape))}
    plain5 = time_ms(lambda: warp.bilinear_sample_bwd_img_plain(u, v, g,
                                                                shape))
    # K3 as in check_warp.
    b3, by3 = bound_ms(4 * (n * ps * ps + 2 * n * p + n * p), 15 * n * p)
    # K4 reads the images, u, v and g and writes du and dv; per point ~30
    # flops (weights, 4 tap differences, 2 channel sums).
    b4, by4 = bound_ms(4 * (n * ps * ps + 2 * n * p + n * p + 2 * n * p),
                       30 * n * p)
    # K5 reads u, v and g and writes dimg once; per point 4 weights, 4
    # products with g, 4 adds.
    b5, by5 = bound_ms(4 * (2 * n * p + n * p + n * ps * ps), 20 * n * p)
    print(f'K3 times at the loss warp (ms): kernel {ms3:.4f}  plain '
          f'{plain3:.4f}  grid_sample {lib3:.4f}  bound {b3:.4f} ({by3}); '
          f'host us per call: kernel {host3["kernel"]:.1f}  grid_sample '
          f'{host3["grid_sample"]:.1f}')
    print(f'K4 times (ms): kernel {ms4:.4f}  plain {plain4:.4f}  '
          f'grid_sample grid-grad {lib4:.4f}  bound {b4:.4f} ({by4}); host '
          f'us per call: kernel {host4["kernel"]:.1f}')
    print(f'K5 times (ms): kernel {ms5:.4f} (S = {cluster5})  plain '
          f'{plain5:.4f}  grid_sample input-grad {lib5:.4f}  bound {b5:.4f} '
          f'({by5}); host us per call: kernel {host5["kernel"]:.1f}')
    common = {'route': 'cuda', 'source': 'bihome_torch/csrc/warp.cu'}
    k3 = {'max_abs_err': float((out - want_out).abs().max()),
          'max_rel_err': err3, 'ms': ms3, 'plain_ms': plain3, 'bound_ms': b3,
          'bound_by': by3, 'library_ms': lib3, 'host_us': host3}
    k4 = dict(common, name='bilinear_sample_bwd_uv',
              replaces='bihome_tpu/ops/warp_pallas.py:75',
              max_abs_err=max(float((du - want_du).abs().max()),
                              float((dv - want_dv).abs().max())),
              max_rel_err=err4, ms=ms4, plain_ms=plain4, bound_ms=b4,
              bound_by=by4, library_ms=lib4, host_us=host4)
    k5 = dict(common, name='bilinear_sample_bwd_img',
              replaces='bihome_tpu/ops/warp_pallas.py:101',
              max_abs_err=float((dimg - want_img).abs().max()),
              max_rel_err=max(err5, err5c3, err5big), ms=ms5,
              plain_ms=plain5, bound_ms=b5, bound_by=by5, library_ms=lib5,
              host_us=host5, cluster=cluster5,
              generic_path={'shape': list(big), 'max_rel_err': err5big})
    return k3, [k4, k5]


def check_warp_frame(dev, gen, name, image, u, v):
    """K3 and K4 on whole standardized frames ``image`` [N,H,W,1] at the
    points u, v [N,P], with a dense random cotangent, against their plain
    versions, timed beside grid_sample and its grid gradient. Their bound
    reads the pixels the taps touch, not the whole frame (whose bound is
    printed beside it). Returns K3's and K4's figures at this shape."""
    from bihome_torch.ops import warp

    n, h, w, _ = image.shape
    p = u.shape[1]
    g = torch.randn((n, p, 1), generator=gen).to(dev)
    out = warp.bilinear_sample_batched(image, u, v)
    want = warp.bilinear_sample_plain(image, u, v)
    err3 = _rel_err(out, want)
    du, dv = warp.bilinear_sample_bwd_uv(image, u, v, g)
    want_du, want_dv = warp.bilinear_sample_bwd_uv_plain(image, u, v, g)
    err4 = max(_rel_err(du, want_du), _rel_err(dv, want_dv))
    print(f'K3 at the {name} warp [{n},{h},{w},1] P={p}: error / max|ref| '
          f'{err3:.2e} (tolerance 1e-5); K4 there: {err4:.2e} (tolerance '
          f'1e-4)')
    if not (err3 <= 1e-5 and err4 <= 1e-4):
        raise AssertionError(f'warp kernels disagree at the {name} shape: '
                             f'{err3}, {err4}')
    img_nchw = image.permute(0, 3, 1, 2).contiguous()
    grid = _grid(u, v, h, w)
    g_nchw = g.permute(0, 2, 1)[:, :, None, :].contiguous()
    grid_req = grid.clone().requires_grad_(True)
    out_grid = torch.nn.functional.grid_sample(
        img_nchw, grid_req, mode='bilinear', padding_mode='zeros',
        align_corners=True)
    ms3 = time_ms(lambda: warp.bilinear_sample_batched(image, u, v))
    plain3 = time_ms(lambda: warp.bilinear_sample_plain(image, u, v))
    lib3 = time_ms(lambda: torch.nn.functional.grid_sample(
        img_nchw, grid, mode='bilinear', padding_mode='zeros',
        align_corners=True))
    ms4 = time_ms(lambda: warp.bilinear_sample_bwd_uv(image, u, v, g))
    plain4 = time_ms(lambda: warp.bilinear_sample_bwd_uv_plain(image, u, v,
                                                               g))
    lib4 = time_ms(lambda: torch.autograd.grad(out_grid, grid_req, g_nchw,
                                               retain_graph=True))
    host3 = host_us(lambda: warp.bilinear_sample_batched(image, u, v))
    host4 = host_us(lambda: warp.bilinear_sample_bwd_uv(image, u, v, g))
    touched = warp.touched_pixels(u, v, h, w)
    b3, by3 = bound_ms(4 * (touched + 3 * n * p), 15 * n * p)
    b4, by4 = bound_ms(4 * (touched + 5 * n * p), 30 * n * p)
    frame3, _ = bound_ms(4 * (n * h * w + 3 * n * p), 15 * n * p)
    frame4, _ = bound_ms(4 * (n * h * w + 5 * n * p), 30 * n * p)
    print(f'K3 times at the {name} warp (ms): kernel {ms3:.4f}  plain '
          f'{plain3:.4f}  grid_sample {lib3:.4f}  bound {b3:.4f} ({by3}; '
          f'{touched / (n * h * w):.3f} of the frame touched; reading the '
          f'whole frame {frame3:.4f}); host us per call {host3:.1f}')
    print(f'K4 times at the {name} warp (ms): kernel {ms4:.4f}  plain '
          f'{plain4:.4f}  grid_sample grid-grad {lib4:.4f}  bound {b4:.4f} '
          f'({by4}; whole frame {frame4:.4f}); host us per call {host4:.1f}')
    k3 = {'shape': [n, h, w, 1], 'points': p,
          'max_abs_err': float((out - want).abs().max()),
          'max_rel_err': err3, 'ms': ms3, 'plain_ms': plain3, 'bound_ms': b3,
          'bound_by': by3, 'library_ms': lib3,
          'host_us': {'kernel': host3}}
    k4 = {'shape': [n, h, w, 1], 'points': p,
          'max_abs_err': max(float((du - want_du).abs().max()),
                             float((dv - want_dv).abs().max())),
          'max_rel_err': err4, 'ms': ms4, 'plain_ms': plain4, 'bound_ms': b4,
          'bound_by': by4, 'library_ms': lib4,
          'host_us': {'kernel': host4}}
    return k3, k4


def check_warp_nguyen(dev, gen):
    """K3 and K4 at the PhotometricHead's shape (S-COCO nguyen-orig,
    bench.py's batch 128): the full standardized 240x320 image_1, the
    128x128 patch grid offset to each patch's corner, through the
    homography of non-integer corner deltas of a few pixels, P = 16,384
    points per image (about a sixth of the frame touched)."""
    from bihome_torch import geometry
    from bihome_torch.data import pipeline

    n, h, w, ps = 128, 240, 320, 128
    spec = pipeline.PairSpec(rho=32, patch_size=ps)
    corners, _ = pipeline.draw_corners_delta_batch(n, (h, w), spec, gen)
    corners = corners.float()
    delta_hat = torch.rand((n, 4, 2), generator=gen) * 16 - 8
    hom = geometry.four_point_to_homography(corners, delta_hat)
    u, v = geometry.homography_grid(hom, (ps, ps), offset=corners[:, 0])
    image = torch.randn((n, h, w, 1), generator=gen).to(dev)
    return check_warp_frame(dev, gen, 'PhotometricHead', image, u.to(dev),
                            v.to(dev))


def check_warp_clevr(dev, gen):
    """K3 and K4 at the CLEVR-Change TripletHead's shape: its warps of whole
    standardized 240x320 renders, batch 64, by the homography of the
    predicted deltas (non-integer, a few pixels) over the whole frame's
    grid, P = 76,800 points per image."""
    from bihome_torch import geometry

    n, h, w = BATCH, 240, 320
    corners = geometry.image_corners(h, w, batch_size=n)
    delta_hat = torch.rand((n, 4, 2), generator=gen) * 16 - 8
    hom = geometry.four_point_to_homography(corners, delta_hat)
    u, v = geometry.homography_grid(hom, (h, w))
    image = torch.randn((n, h, w, 1), generator=gen).to(dev)
    return check_warp_frame(dev, gen, 'CLEVR TripletHead', image, u.to(dev),
                            v.to(dev))


def check_warp_k5_paths(dev, gen):
    """K3 and K5 at the shapes of the paths that run K5, against their
    plain versions, with a dense random cotangent: 2B = 128 patches of
    128x128 upsampled 2x and 4x (the align_corners grid of
    ``heads/assembled.upsample_grid``, P = 65,536 and 262,144: 4 and 16
    points per pixel; K3 and K5 take it broadcast over the batch, one row
    read, as the path hands it over; K3 also on the grid materialised,
    which must give the same bits), and the masked loss warp (patch and
    mask as C = 2, K3's C = 2 kernel, the patch grid through homographies
    of a few pixels, P = 16,384; K4 there too). Each is timed beside
    grid_sample (forward, its input gradient, its grid gradient) and, at
    the upsample shapes, beside upsample_bilinear2d (align_corners) forward
    and backward. Returns {shape name: (K3's, K4's or None, K5's
    figures)}."""
    import torch.nn.functional as F
    from bihome_torch.heads.assembled import upsample_grid
    from bihome_torch.ops import warp

    n, ps = 2 * BATCH, 128
    cases = []
    for scale in (2, 4):
        u, v = upsample_grid(n, ps, ps, scale, dev)
        cases.append((f'upsample_{scale}x', scale,
                      torch.randn((n, ps, ps, 1), generator=gen).to(dev),
                      u, v))
    u, v = _loss_warp_points(dev, gen, n, ps)
    masked = torch.cat([torch.randn((n, ps, ps, 1), generator=gen),
                        torch.rand((n, ps, ps, 1), generator=gen)], dim=-1)
    cases.append(('masked_loss_warp', None, masked.to(dev), u, v))
    figures = {}
    for name, scale, images, ub, vb in cases:
        # ub, vb as K3 and K5 get them; u, v contiguous, as K4 gets them.
        u, v = ub.contiguous(), vb.contiguous()
        c = images.shape[-1]
        p = u.shape[1]
        shape = tuple(images.shape)
        g = torch.randn((n, p, c), generator=gen).to(dev)
        generic = warp.bilinear_sample_batched.generic_launches
        out = warp.bilinear_sample_batched(images, ub, vb)
        kernel3 = warp.bilinear_sample_batched.last_kernel
        broadcast = warp.uv_batch_stride(ub, vb) == 0
        if kernel3 != c or (
                warp.bilinear_sample_batched.generic_launches != generic):
            raise AssertionError(f'K3 at the {name} ran kernel {kernel3}, '
                                 f'not its C = {c} kernel')
        if broadcast and not torch.equal(
                out, warp.bilinear_sample_batched(images, u, v)):
            raise AssertionError(f'K3 at the {name}: one grid row and the '
                                 f'grid materialised give other bits')
        want = warp.bilinear_sample_plain(images, u, v)
        dimg = warp.bilinear_sample_bwd_img(ub, vb, g, shape)
        cluster5 = warp.bilinear_sample_bwd_img.last_cluster
        want_img = warp.bilinear_sample_bwd_img_plain(u, v, g, shape)
        err3, err5 = _rel_err(out, want), _rel_err(dimg, want_img)
        err4 = 0.0
        if scale is None:
            du, dv = warp.bilinear_sample_bwd_uv(images, u, v, g)
            want_du, want_dv = warp.bilinear_sample_bwd_uv_plain(images, u,
                                                                 v, g)
            err4 = max(_rel_err(du, want_du), _rel_err(dv, want_dv))
        print(f'K3/K4/K5 at the {name} [{n},{ps},{ps},{c}] P={p}: error / '
              f'max|ref| K3 {err3:.2e} (tolerance 1e-5; its C = {c} kernel'
              + ('; one grid row bit for bit the grid materialised'
                 if broadcast else '')
              + f'), K4 {err4:.2e}, K5 {err5:.2e} (tolerance 1e-4; shared '
              f'atomics add in no fixed order; S = {cluster5}, u/v batch '
              f'stride {warp.uv_batch_stride(ub, vb)})')
        if not (err3 <= 1e-5 and err4 <= 1e-4 and err5 <= 1e-4):
            raise AssertionError(f'warp kernels disagree at the {name} '
                                 f'shape: {err3}, {err4}, {err5}')
        img_nchw = images.permute(0, 3, 1, 2).contiguous()
        grid = _grid(u, v, ps, ps)
        g_nchw = g.permute(0, 2, 1)[:, :, None, :].contiguous()
        img_req = img_nchw.clone().requires_grad_(True)
        grid_req = grid.clone().requires_grad_(True)
        out_img = F.grid_sample(img_req, grid, mode='bilinear',
                                padding_mode='zeros', align_corners=True)
        out_grid = F.grid_sample(img_nchw, grid_req, mode='bilinear',
                                 padding_mode='zeros', align_corners=True)
        ms3 = time_ms(lambda: warp.bilinear_sample_batched(images, ub, vb))
        ms3_full = (time_ms(lambda: warp.bilinear_sample_batched(images, u, v))
                    if broadcast else ms3)
        plain3 = time_ms(lambda: warp.bilinear_sample_plain(images, u, v))
        lib3 = time_ms(lambda: F.grid_sample(
            img_nchw, grid, mode='bilinear', padding_mode='zeros',
            align_corners=True))
        ms5 = time_ms(lambda: warp.bilinear_sample_bwd_img(ub, vb, g, shape))
        plain5 = time_ms(lambda: warp.bilinear_sample_bwd_img_plain(
            ub, vb, g, shape))
        lib5 = time_ms(lambda: torch.autograd.grad(out_img, img_req, g_nchw,
                                                   retain_graph=True))
        host5 = host_us(lambda: warp.bilinear_sample_bwd_img(ub, vb, g,
                                                             shape))
        host3 = host_us(lambda: warp.bilinear_sample_batched(images, ub, vb))
        # K3 reads the images, u and v (one row where they broadcast over
        # the batch; the grid per sample counted apart) and writes the
        # samples; K5 reads u, v and g and writes dimg once; K4 reads the
        # images, u, v and g and writes du and dv.
        rows = 1 if broadcast else n
        b3, by3 = bound_ms(4 * (n * ps * ps * c + 2 * rows * p + n * p * c),
                           15 * n * p * c)
        b3n, _ = bound_ms(4 * (n * ps * ps * c + 2 * n * p + n * p * c),
                          15 * n * p * c)
        b5, by5 = bound_ms(4 * (2 * rows * p + n * p * c + n * ps * ps * c),
                           20 * n * p * c)
        b5n, _ = bound_ms(4 * (2 * n * p + n * p * c + n * ps * ps * c),
                          20 * n * p * c)
        base = {'shape': [n, ps, ps, c], 'points': p}
        k3 = dict(base, max_abs_err=float((out - want).abs().max()),
                  max_rel_err=err3, ms=ms3, plain_ms=plain3, bound_ms=b3,
                  bound_by=by3, library_ms=lib3, host_us={'kernel': host3},
                  kernel=kernel3, uv_batch_stride=0 if broadcast else p)
        if broadcast:
            k3.update(grid_materialised_ms=ms3_full,
                      bound_ms_grid_per_sample=b3n)
        k5 = dict(base, max_abs_err=float((dimg - want_img).abs().max()),
                  max_rel_err=err5, ms=ms5, plain_ms=plain5, bound_ms=b5,
                  bound_by=by5, bound_ms_grid_per_sample=b5n,
                  library_ms=lib5, host_us={'kernel': host5},
                  cluster=cluster5)
        line = (f'K3 at the {name} (ms): kernel {ms3:.4f}'
                + (f' (grid materialised {ms3_full:.4f})' if broadcast
                   else '')
                + f'  plain {plain3:.4f}  grid_sample {lib3:.4f}  bound '
                f'{b3:.4f} ({by3}'
                + (f'; {b3n:.4f} with a grid per sample' if broadcast
                   else '')
                + f'); K5: kernel {ms5:.4f}  plain {plain5:.4f}  '
                f'grid_sample input-grad {lib5:.4f}  bound {b5:.4f} ({by5}; '
                f'{b5n:.4f} with a grid per sample); host us per call K3 '
                f'{host3:.1f}, K5 {host5:.1f}')
        k4 = None
        if scale is None:
            ms4 = time_ms(lambda: warp.bilinear_sample_bwd_uv(images, u, v,
                                                              g))
            plain4 = time_ms(lambda: warp.bilinear_sample_bwd_uv_plain(
                images, u, v, g))
            lib4 = time_ms(lambda: torch.autograd.grad(
                out_grid, grid_req, g_nchw, retain_graph=True))
            host4 = host_us(lambda: warp.bilinear_sample_bwd_uv(images, u, v,
                                                                g))
            b4, by4 = bound_ms(
                4 * (n * ps * ps * c + 2 * n * p + n * p * c + 2 * n * p),
                30 * n * p * c)
            k4 = dict(base, max_abs_err=max(
                float((du - want_du).abs().max()),
                float((dv - want_dv).abs().max())), max_rel_err=err4,
                ms=ms4, plain_ms=plain4, bound_ms=b4, bound_by=by4,
                library_ms=lib4, host_us={'kernel': host4})
            line += (f'; K4: kernel {ms4:.4f}  plain {plain4:.4f}  '
                     f'grid_sample grid-grad {lib4:.4f}  bound {b4:.4f} '
                     f'({by4}); host us per call {host4:.1f}')
        else:
            oh = ps * scale
            g_up = g.reshape(n, oh, oh, c).permute(0, 3, 1, 2).contiguous()
            k3['upsample_ms'] = time_ms(lambda: F.interpolate(
                img_nchw, scale_factor=scale, mode='bilinear',
                align_corners=True))
            k5['upsample_backward_ms'] = time_ms(
                lambda: torch.ops.aten.upsample_bilinear2d_backward(
                    g_up, [oh, oh], [n, c, ps, ps], True))
            line += (f'; upsample_bilinear2d (align_corners) forward '
                     f'{k3["upsample_ms"]:.4f}, backward '
                     f'{k5["upsample_backward_ms"]:.4f}')
        print(line)
        figures[name] = (k3, k4, k5)
    return figures


def check_pds(dev, gen):
    """The PDS photometric distortion on the card against the CPU plain
    path, on the same draws: the distorted full images (64 synthetic
    240x320 frames) and the pairs of pds-coco/zeng-biHomE's spec
    (window-first, both copies distorted), on the 0..255 scale."""
    from bihome_torch import config as config_lib
    from bihome_torch.data import datasets, photometric, pipeline

    n = BATCH
    spec = config_lib.build_model(config_lib.load_config(
        PDS_RUNS[0][0])).pair_spec
    pool = torch.from_numpy(datasets.SyntheticDataset(seed=3).pool[:n])
    corners, delta = pipeline.draw_corners_delta_batch(
        n, tuple(pool.shape[1:3]), spec, gen)
    pds = [photometric.draw_photometric_params(n, spec.max_delta, gen)
           for _ in range(2)]
    images = pool.float()
    got = photometric.apply_photometric(images.to(dev), pds[0].to(dev))
    want = photometric.apply_photometric(images, pds[0])
    err_img = float((got.cpu() - want).abs().max())
    card, cpu = (pipeline.generate_pairs(pool.to(d), spec, corners=corners,
                                         delta=delta, photometric_params=pds)
                 for d in (dev, torch.device('cpu')))
    to_255 = spec.standardize_std * 255.0
    err_pair = max(float((card[k].cpu() - cpu[k]).abs().max()) * to_255
                   for k in ('patch_1', 'patch_2'))
    moved = float((want - images).abs().mean())
    print(f'PDS distortion [{n},240,320,3] on the card vs the CPU plain path,'
          f' same draws: max abs err {err_img:.3e} (0..255; mean change of '
          f'a pixel {moved:.2f}); pds-coco/zeng pairs: patch_1/patch_2 max '
          f'abs err {err_pair:.3e} on the 0..255 scale (tolerance 1e-3)')
    if not (err_img <= 1e-3 and err_pair <= 1e-3 and moved > 1.0):
        raise AssertionError(f'PDS distortion disagrees: {err_img}, '
                             f'{err_pair}')
    return {'image_max_abs_err': err_img, 'pairs_max_abs_err': err_pair}


def run_train_path(counters, log_dir, config=CONFIG, batch=BATCH,
                   steps=STEPS, expect=ZENG_KERNELS, sets=(), synthetic=True,
                   extra=()):
    """The port's train entry point on the card (config overrides
    ``sets``, more arguments ``extra``, which may name the feed; one step
    per block unless ``extra`` says otherwise; the synthetic images unless
    ``synthetic`` is off, then the splits the config or ``sets`` name),
    counted: the kernels in ``expect`` must launch and the others in
    ``counters`` must not."""
    from bihome_torch import train

    reset_counts(counters)
    # Each run starts from an empty allocator cache, not the blocks the
    # phases before it left (up to the R50 run's ~30 GB).
    reserved_gb = torch.cuda.memory_reserved() / 1e9
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = ['--config_file', config, '--batch_size', str(batch), '--steps',
            str(steps), '--epochs', '1', '--device', 'cuda', '--set',
            'MODEL.HEAD.AUXILIARY_RESNET_PATH=aux_clfbh.npz', '--set',
            f'LOGGING.DIR={log_dir}', '--steps_per_call', '1', *extra]
    if synthetic:
        args.append('--synthetic')
    for item in sets:
        args += ['--set', item]
    result = train.main(args)
    launches = read_counts(counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f'launches on the train path of {config} (batch {batch}, {steps} '
          f'steps, then {steps} eval steps): {launches}')
    for name, count in launches.items():
        if (count > 0) != (name in expect):
            raise AssertionError(
                f'{name} launched {count} times on the train path of '
                f'{config}; expected {"some" if name in expect else "none"}')
    losses = result['losses']
    print(f'train losses per step: {losses.tolist()}')
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError('non-finite training loss')
    model, initial = result['model'], result['initial_state']
    final = model.state_dict()
    moved = [k for k in final if k.startswith('backbone.')
             and not torch.equal(final[k].cpu(), initial[k])]
    params = {f'backbone.{k}' for k, _ in model.backbone.named_parameters()}
    stats = {k for k in final if k.startswith('backbone.')
             and k.endswith(('running_mean', 'running_var'))}
    # The extractor never trains; its BN statistics move only under
    # AUXILIARY_RESNET_BN_TRAIN. The projection head's parameters train.
    bn_train = result['built'].head_cfg.auxiliary_resnet_bn_train
    aux_keys = [k for k in final if k.startswith('auxiliary_resnet.')
                and not k.endswith('num_batches_tracked')]
    aux_stats = [k for k in aux_keys
                 if k.endswith(('running_mean', 'running_var'))]
    aux_same = all(torch.equal(final[k].cpu(), initial[k]) for k in aux_keys
                   if not (bn_train and k in aux_stats))
    aux_stats_moved = any(not torch.equal(final[k].cpu(), initial[k])
                          for k in aux_stats)
    head = [f'projection_head.{k}' for k, _ in
            (model.projection_head.named_parameters()
             if model.projection_head is not None else ())]
    head_moved = all(not torch.equal(final[k].cpu(), initial[k])
                     for k in head)
    print(f'moved: {len(params & set(moved))}/{len(params)} backbone '
          f'parameters, {len(stats & set(moved))}/{len(stats)} BN running '
          f'statistics; extractor parameters bitwise unchanged: '
          f'{aux_same if aux_keys else "(no extractor)"}, its BN '
          f'statistics moved: {aux_stats_moved} (AUXILIARY_RESNET_BN_TRAIN '
          f'{bn_train}); projection head moved: '
          f'{head_moved if head else "(none)"}')
    if not (params & set(moved) and stats & set(moved) and aux_same
            and aux_stats_moved == (bn_train and bool(aux_stats))
            and head_moved):
        raise AssertionError('training did not move the backbone (or the '
                             'projection head), or moved the extractor')
    step_ms = result['median_step_ms']
    wait_ms = result['median_wait_ms']
    pairs_per_s = batch / (step_ms / 1e3)
    spc = result['steps_per_call']
    print(f'train {config}: {step_ms:.2f} ms per step (median of steps '
          f'{spc + 1}-{steps}, each block of {spc} ended by a synchronize; '
          f'all: {[round(t, 2) for t in result["step_ms"]]}), pairs/s '
          f'{pairs_per_s:.1f}, peak memory allocated {peak_gb:.2f} GB; the '
          f'loop waited {wait_ms:.2f} ms per step for its batch (median of '
          f'steps 2-{steps}; all: {[round(t, 2) for t in result["wait_ms"]]})'
          f', {batch / ((step_ms + wait_ms) / 1e3):.1f} pairs/s with the '
          f'wait; {reserved_gb:.2f} GB reserved by the phases before')
    result['summary'] = {'config': config, 'sets': list(sets),
                         'dtype': str(result['built'].dtype).replace(
                             'torch.', ''),
                         'batch': batch, 'feed': feed_name(result),
                         'ms_per_step': step_ms, 'pairs_per_s': pairs_per_s,
                         'wait_ms_per_step': wait_ms,
                         'peak_gb': peak_gb, 'launches': launches}
    return launches, result


def _condition(model):
    """Scale the last BN of each residual branch by 1/4, as
    tests/test_torch_train_step.py and tests/test_torch_resnet34.py do,
    and a PF head's output conv by PF_SCALE, so that the field is a few
    pixels (the seeded init gives less than one; the DLT fit of sub-pixel
    deltas is ill-conditioned in float32). Undamped, the seeded network's
    float32 backward is ill-conditioned; damped, float32 follows float64
    closely (readings above) and a wrong gradient stands out."""
    from bihome_torch.models.backbones import RethinkingBackbone

    last_bn = 'bn2'                   # the ResNet34 regressor's BasicBlocks
    if isinstance(model.backbone, RethinkingBackbone):
        last_bn = ('upper_branch.7' if model.backbone.resnet_block
                   == 'ResNet50' else 'upper_branch.4')
    with torch.no_grad():
        for name, mod in model.backbone.named_modules():
            if (name.endswith(last_bn)
                    and isinstance(mod, torch.nn.BatchNorm2d)):
                mod.weight.mul_(0.25)
        if isinstance(model.backbone, RethinkingBackbone):
            model.backbone.layer8[3].weight.mul_(PF_SCALE)
            model.backbone.layer8[3].bias.mul_(PF_SCALE)


@contextlib.contextmanager
def tail_from(model, inputs, name=None):
    """The input of the model's tail (its backbone's module ``name``, by
    default the first TAIL_MODULES names) recorded into ``inputs`` call by
    call when that list is empty; else replaced, call by call, by its
    tensors, moved to the device and dtype the model hands the tail
    (float32 of the bf16 values in a float32 model), as leaves that take a
    gradient where autograd records. Yields the leaves fed."""
    name = name or TAIL_MODULES[type(model.backbone).__name__][0]
    record, fed = not inputs, []

    def hook(module, args):
        if record:
            inputs.append(args[0].detach().clone())
            return None
        leaf = inputs[len(fed)].to(device=args[0].device,
                                   dtype=args[0].dtype, copy=True)
        fed.append(leaf.requires_grad_(torch.is_grad_enabled()))
        return (leaf,) + tuple(args[1:])
    handle = model.backbone.get_submodule(name).register_forward_pre_hook(
        hook)
    try:
        yield fed
    finally:
        handle.remove()


def one_step_grads(built, state, data, device, dtype=torch.float32,
                   config=None, tail=None, pairs=None):
    """Loss and backbone gradients (float64, on the CPU) of one conditioned
    training step from ``state`` on ``device`` in ``dtype`` (parameters
    and inputs; the model's compute dtype is its config's MODEL.DTYPE),
    with the model of ``config`` (default the run's); ``data`` = (uint8
    pool rows, corners, delta, the photometric draws (pd1, pd2), DSAC
    uniforms or None). No optimizer. With ``tail`` (a list), the tail's
    inputs are recorded into it when it is empty (``tail_from``); else the
    tail runs from its tensors, and the gradients are the tail's
    parameters' and its inputs' (``input0``, ...). With ``pairs`` (a
    dict), the generated pairs are recorded into it (on the CPU) when it
    is empty; else they are its tensors, not generated here."""
    from bihome_torch import config as config_lib
    from bihome_torch.data import pipeline
    from bihome_torch.training import losses

    pool, corners, delta, pds, uniforms = data
    built = config_lib.build_model(config or built.config)
    model = built.model
    model.load_state_dict(state)
    _condition(model)
    model = model.to(device=device, dtype=dtype).train()
    if pairs:
        batch = {k: v.to(device) for k, v in pairs.items()}
    else:
        batch = pipeline.generate_pairs(pool.to(device), built.pair_spec,
                                        corners=corners, delta=delta,
                                        photometric_params=pds)
        if pairs is not None:
            pairs.update({k: v.cpu() for k, v in batch.items()})
    with (tail_from(model, tail) if tail is not None
          else contextlib.nullcontext([])) as fed:
        out = model({k: v.to(dtype) for k, v in batch.items()},
                    uniforms=uniforms)
    loss = losses.compute_loss(built.loss_name, out)
    loss.backward()
    if 'loss_comp/ln1' in out['metrics']:
        # The biHomE loss is ln1 + ln2 + mu*ln3, whose terms largely
        # cancel: its error is measured on the sum of their magnitudes.
        scale = sum(abs(out['metrics'][f'loss_comp/ln{i}'].item())
                    for i in (1, 2, 3))
    else:
        scale = abs(loss.item())
    # layer8.0.bias (the PF head's first conv bias) is left out: its
    # gradient is 0 analytically under batch statistics; so is the score
    # CNN's fc bias (it shifts every score, and softmax ignores a shift).
    params = model.backbone.named_parameters()
    grads = {n: p.grad.cpu().double() for n, p in params
             if n != 'layer8.0.bias' and (p.grad is not None or not fed)}
    if model.score_cnn is not None:
        grads.update({f'score_cnn.{n}': p.grad.cpu().double()
                      for n, p in model.score_cnn.named_parameters()
                      if n != 'fc.bias' and p.grad is not None})
    grads.update({f'input{i}': x.grad.cpu().double()
                  for i, x in enumerate(fed)})
    return loss.item(), scale, grads


def step_errors(got, ref):
    """(loss error / the reference's scale, the gradients' relative L2 over
    all tensors, the largest per-tensor relative L2, that tensor's name)."""
    (loss, _, grads), (loss_ref, scale, grads_ref) = got, ref
    per = {n: float((grads[n] - g).norm() / g.norm())
           for n, g in grads_ref.items()}
    flat = torch.cat([g.flatten() for g in grads.values()])
    flat_ref = torch.cat([g.flatten() for g in grads_ref.values()])
    worst = max(per, key=per.get)
    return (abs(loss - loss_ref) / scale,
            float((flat - flat_ref).norm() / flat_ref.norm()), per[worst],
            worst)


@contextlib.contextmanager
def planted_fault(name):
    """Spoil one kernel's output on the train path, to show that the step
    check catches it: K4's du negated, K5's dimg negated, or K2's dw1
    zeroed."""
    from bihome_torch.ops import fused_head as fh
    from bihome_torch.ops import warp

    if name in ('K4 du negated', 'K5 dimg negated'):
        owner, attr = warp.BilinearSample, 'backward'

        def spoiled(ctx, g):
            dimg, du, dv = original(ctx, g)
            # A constant grid (the upsample) has no du, an image that is
            # data no dimg.
            if name == 'K4 du negated':
                return dimg, (None if du is None else -du), dv
            return (None if dimg is None else -dimg), du, dv
        spoiled = staticmethod(spoiled)
    else:
        owner, attr = fh, 'pf_head_backward'

        def zero_dw1(*args):
            dx, m0, m1, db2, dw1 = fh.fused_pf_head_bwd(*args)
            return dx, m0, m1, db2, torch.zeros_like(dw1)

        def spoiled(*args):
            return original(*args, moments=zero_dw1)
    original, saved = getattr(owner, attr), vars(owner)[attr]
    setattr(owner, attr, spoiled)
    try:
        yield
    finally:
        setattr(owner, attr, saved)


def compare_train_step(result, batch=4, faults=FAULTS, config=None):
    """One step's loss and backbone gradients on the card (float32)
    against the plain path on the CPU in float64: the run's initial
    weights, conditioned (``_condition``), the same pairs, photometric
    draws (PDS) and DSAC draws; no optimizer; the model of ``config`` if
    given (the run's otherwise). Then the card's step again
    under each planted fault, which must fail the same limits: the loss
    within STEP_LOSS of the sum of its terms' magnitudes (of the loss
    itself for a tensor loss), the gradients within STEP_L2 relative L2
    over all tensors and within STEP_PER_TENSOR relative L2 for every
    tensor."""
    built, state = result['built'], result['initial_state']
    data = step_data(built, batch)
    cuda, cpu = torch.device('cuda'), torch.device('cpu')

    with one_cpu_thread():
        ref = one_step_grads(built, state, data, cpu, torch.float64,
                             config=config)
    runs = {'card': one_step_grads(built, state, data, cuda, config=config)}
    for fault in faults:
        with planted_fault(fault):
            runs[fault] = one_step_grads(built, state, data, cuda,
                                         config=config)
    readings = {}
    for name, run in runs.items():
        loss_err, l2, per, worst = readings[name] = step_errors(run, ref)
        print(f'one train step of {result["summary"]["config"]} (batch '
              f'{batch}), {name} against the CPU '
              f'plain path in float64: loss {run[0]:.6f} vs {ref[0]:.6f} '
              f'(terms {ref[1]:.4f}), error / terms {loss_err:.2e} (limit '
              f'{STEP_LOSS:.2g}); backbone gradients relative L2 {l2:.2e} '
              f'(limit {STEP_L2:.2g}), worst tensor {per:.2e} ({worst}; '
              f'limit {STEP_PER_TENSOR:.2g})')

    def holds(name):
        loss_err, l2, per, _ = readings[name]
        return (loss_err <= STEP_LOSS and l2 <= STEP_L2
                and per <= STEP_PER_TENSOR)
    if not holds('card'):
        raise AssertionError('CUDA training step strays from the float64 '
                             'plain path')
    caught = {fault: not holds(fault) for fault in faults}
    print(f'planted faults caught by the step check: {caught}')
    if not all(caught.values()):
        raise AssertionError(f'the step check misses a planted fault: '
                             f'{caught}')
    return readings


def dsac_draws(head):
    """The DSAC uniforms a field takes: n * points_per_hypothesis."""
    return head.hypothesis_no * head.points_per_hypothesis


def step_data(built, batch):
    """The one-step checks' inputs: (uint8 pool rows, corners, delta, the
    photometric draws, DSAC uniforms or None), drawn from seed 7."""
    from bihome_torch.data import datasets, pipeline

    gen = torch.Generator().manual_seed(7)
    if built.pair_spec.change_aware_keys:
        # CLEVR-Change: (original, changed) pairs, nothing drawn.
        pool = torch.from_numpy(clevr_pairs(built.config, batch))
        corners = delta = pds = None
    else:
        pool = torch.from_numpy(datasets.SyntheticDataset(seed=2).pool[:batch])
        corners, delta = pipeline.draw_corners_delta_batch(
            batch, tuple(pool.shape[1:3]), built.pair_spec, gen)
        pds = pipeline._draw_photometric(batch, built.pair_spec, gen)
    uniforms = ([torch.rand((batch, dsac_draws(built.head_cfg)),
                            generator=gen) for _ in range(2)]
                if built.needs_dsac_rng else None)
    return pool, corners, delta, pds, uniforms


def clevr_pairs(config, n):
    """The first ``n`` (original, changed) pairs of the synthetic CLEVR
    scenes (seed 0) in the order the pair sampler of ``config`` (its MODE
    and TRAIN_SEED) draws them."""
    from bihome_torch.data import clevr_change

    sampler_cfg = config['DATA']['SAMPLER']
    ds = clevr_change.SyntheticChangeDataset(image_size=(320, 240), seed=0)
    return clevr_change.ClevrPairLoader(
        ds, 1, n, mode=sampler_cfg.get('MODE', 'nsc'),
        random_seed=sampler_cfg.get('TRAIN_SEED')).pool(n)


def compare_train_step_bf16(result, batch=4):
    """One bf16 training step of the run's config on the card against the
    CPU plain path at bf16 (the kernels' plain bf16 versions, torch's CPU
    bf16 convolutions): the run's initial weights, conditioned, the same
    pairs and draws, as ``compare_train_step``. Limits: the loss within
    BF16_STEP_LOSS of the sum of its terms' magnitudes, every backbone
    tensor's gradient within BF16_STEP_PER_TENSOR relative L2. Then the
    card's step with K2 bf16's dw1 zeroed, which the limits must catch.
    The CPU's float32 step is measured against the same reference and
    printed beside it: the spread of two legitimate roundings."""
    built, state = result['built'], result['initial_state']
    data = step_data(built, batch)
    cuda, cpu = torch.device('cuda'), torch.device('cpu')
    config32 = copy.deepcopy(built.config)
    config32['MODEL']['DTYPE'] = 'float32'
    with one_cpu_thread():
        ref = one_step_grads(built, state, data, cpu)
        runs = {'CPU float32': one_step_grads(built, state, data, cpu,
                                              config=config32)}
    runs['card'] = one_step_grads(built, state, data, cuda)
    fault = 'K2 dw1 zeroed'
    with planted_fault(fault):
        runs[fault] = one_step_grads(built, state, data, cuda)
    readings = {}
    for name, run in runs.items():
        loss_err, l2, per, worst = readings[name] = step_errors(run, ref)
        print(f'one bf16 train step of {result["summary"]["config"]} (batch '
              f'{batch}), {name} against the CPU plain path at bf16: loss '
              f'{run[0]:.6f} vs {ref[0]:.6f} (terms {ref[1]:.4f}), error / '
              f'terms {loss_err:.2e} (limit {BF16_STEP_LOSS:.2g}); backbone '
              f'gradients relative L2 {l2:.2e}, worst tensor {per:.2e} '
              f'({worst}; limit {BF16_STEP_PER_TENSOR:.2g})')

    def holds(name):
        loss_err, _, per, _ = readings[name]
        return loss_err <= BF16_STEP_LOSS and per <= BF16_STEP_PER_TENSOR
    if not holds('card'):
        raise AssertionError('the bf16 training step on the card strays from '
                             'the CPU plain path at bf16')
    print(f'planted fault caught by the bf16 step check: {not holds(fault)}')
    if holds(fault):
        raise AssertionError(f'the bf16 step check misses {fault}')
    whole = {name: dict(zip(('loss_err', 'rel_l2', 'worst_rel_l2',
                             'worst_tensor'), r))
             for name, r in readings.items()}
    return {'whole_step': whole,
            'tail': compare_tail_step_bf16(result, built, state, data)}


def compare_tail_step_bf16(result, built, state, data,
                           limits=(BF16_TAIL_L2, BF16_TAIL_PER_TENSOR)):
    """The same step from the card's own pairs and PF-head input on: both
    recorded on the card (the bf16 datagen's gray values can round to
    other bf16 values on the two sides), then the head, the DSAC fit and
    the loss (the frozen extractor on the pairs and the warped patches)
    run from them on the card, on the CPU at bf16 (the reference) and on
    the CPU at float32 (the control), the gradients those of the head's
    parameters and of its input. Past the backbone's depth two bf16
    roundings stay close: the card must keep within BF16_TAIL_LOSS and
    ``limits`` (the gradients' relative L2 over all tensors and per
    tensor; BF16_TAIL_L2 and BF16_TAIL_PER_TENSOR unless stated), and the
    float32 control and the card with K2 bf16's dw1 zeroed must not."""
    tail_l2, tail_per_tensor = limits
    cuda, cpu = torch.device('cuda'), torch.device('cpu')
    config32 = copy.deepcopy(built.config)
    config32['MODEL']['DTYPE'] = 'float32'
    inputs, pairs = [], {}
    one_step_grads(built, state, data, cuda, tail=inputs, pairs=pairs)
    inputs = [x.cpu() for x in inputs]

    def run(device, **kwargs):
        return one_step_grads(built, state, data, device, tail=inputs,
                              pairs=pairs, **kwargs)
    with one_cpu_thread():
        ref = run(cpu)
        runs = {'CPU float32': run(cpu, config=config32)}
    runs['card'] = run(cuda)
    fault = 'K2 dw1 zeroed'
    with planted_fault(fault):
        runs[fault] = run(cuda)
    readings = {}
    for name, run in runs.items():
        loss_err, l2, per, worst = readings[name] = step_errors(run, ref)
        print(f'the bf16 step of {result["summary"]["config"]} from the '
              f'card\'s PF-head input {[list(x.shape) for x in inputs]}, '
              f'{name} against the CPU at bf16: loss error / terms '
              f'{loss_err:.2e} (limit {BF16_TAIL_LOSS:.0e}); head and input '
              f'gradients relative L2 {l2:.2e} (limit {tail_l2:.0e}), '
              f'worst tensor {per:.2e} ({worst}; limit '
              f'{tail_per_tensor:.0e})')

    def holds(name):
        loss_err, l2, per, _ = readings[name]
        return (loss_err <= BF16_TAIL_LOSS and l2 <= tail_l2
                and per <= tail_per_tensor)
    caught = {name: not holds(name) for name in ('CPU float32', fault)}
    print(f'the tail check holds the card: {holds("card")}; catches the '
          f'float32 control and the planted fault: {caught}')
    if not holds('card'):
        raise AssertionError('the bf16 step from the card\'s PF-head input '
                             'strays from the CPU at bf16')
    if not all(caught.values()):
        raise AssertionError(f'the bf16 tail check misses {caught}')
    return {name: dict(zip(('loss_err', 'rel_l2', 'worst_rel_l2',
                            'worst_tensor'), r))
            for name, r in readings.items()}


def feed_name(result):
    """'pool of' the dataset class a device-pool run read, or the class a
    streamed run read."""
    from bihome_torch.data import datasets

    feed = result['train_feed']
    if not hasattr(feed, 'loader'):
        return f'pool of {datasets.describe(feed.dataset)}'
    return datasets.describe(feed.loader.dataset)


def _write_jpeg_chunk(root, start, count):
    """JPEGs ``start`` .. ``start + count - 1`` of the file-fed phases:
    the synthetic generator's images at 640x480 (seeded by FILE_SEED +
    start), quality JPEG_QUALITY. Runs in a worker process; returns its
    seconds."""
    from PIL import Image

    from bihome_torch.data import synthetic

    begin = time.perf_counter()
    pool = synthetic.make_image_pool(count, FILE_HW[0], FILE_HW[1],
                                     seed=FILE_SEED + start)
    for i, img in enumerate(pool):
        Image.fromarray(img).save(os.path.join(root, f'{start + i:05d}.jpg'),
                                  quality=JPEG_QUALITY)
    return time.perf_counter() - begin


def finish_file_data(jobs, jpeg_dir, pack_dir):
    """Wait for the JPEG writers, then write the pack with the port's
    preprocess_offline (--pack_only, 320x240); print the times."""
    chunk_s = [job.result() for job in jobs]
    names = sorted(os.listdir(jpeg_dir))
    if len(names) != FILE_IMAGES:
        raise AssertionError(f'{len(names)} JPEGs written, not '
                             f'{FILE_IMAGES}')
    jpeg_mb = sum(os.path.getsize(os.path.join(jpeg_dir, n))
                  for n in names) / 1e6
    begin = time.perf_counter()
    subprocess.run([sys.executable, '-m', 'bihome_torch.preprocess_offline',
                    '--input_dir', jpeg_dir, '--output_dir', pack_dir,
                    '--pack_only'], check=True, timeout=600)
    pack_s = time.perf_counter() - begin
    pack_mb = os.path.getsize(os.path.join(pack_dir, 'pack.bhpk')) / 1e6
    print(f'file data: {FILE_IMAGES} JPEGs {FILE_HW[1]}x{FILE_HW[0]} '
          f'quality {JPEG_QUALITY} ({jpeg_mb:.1f} MB) written by '
          f'{len(jobs)} processes, {sum(chunk_s):.1f} process-seconds '
          f'(chunks of {FILE_IMAGES // len(jobs)}: {min(chunk_s):.2f}-'
          f'{max(chunk_s):.2f} s, beside the kernel build); the 320x240 pack '
          f'({pack_mb:.1f} MB) by preprocess_offline --pack_only in '
          f'{pack_s:.2f} s (one process, decode and resize included)')
    return {'jpegs': FILE_IMAGES, 'jpeg_mb': jpeg_mb,
            'jpeg_process_s': sum(chunk_s), 'jpeg_chunk_s_max': max(chunk_s),
            'pack_mb': pack_mb, 'pack_s': pack_s}


def profile_feed(result, steps=PDS_STEPS):
    """The device's idle share of ``steps`` more training steps of a
    finished train run (its model, optimizer and split; ``steps`` + 1
    batches, the first step outside the window: drawn from its device
    pool, or from a fresh stream of its split), each ended by a
    synchronize, under torch.profiler: device kernel ms per step and 1 -
    device / host window."""
    from bihome_torch import train
    from bihome_torch.training import trainer

    built, args = result['built'], result['args']
    device = next(result['model'].parameters()).device
    feed = result['train_feed']
    if isinstance(feed, train.PoolFeed):
        source = (trainer.draw_pool_batch(feed.pool, result['batch_size'],
                                          feed.draws)
                  for _ in range(steps + 1))
    else:
        feed, _ = train.make_feeds(built.config, built, args, device,
                                   result['batch_size'], steps + 1, 0, 0, 0)
        source = feed.epoch()
    gen, dsac_gen = (torch.Generator().manual_seed(s) for s in (0, 1))
    waits = []
    batches = train.timed(source, waits)

    def step(images):
        trainer.train_step(result['model'], result['optimizer'], images,
                           built.pair_spec, built.loss_name, gen, dsac_gen)
        torch.cuda.synchronize()

    step(next(batches))
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        begin = time.perf_counter()
        for images in batches:
            step(images)
        wall_ms = (time.perf_counter() - begin) * 1e3
    share = train.profiled_share(prof, wall_ms)
    out = {'host_ms_per_step': wall_ms / steps,
           'device_ms_per_step': share['device_ms'] / steps,
           'launches_per_step': share['launches'] / steps,
           'idle_share': share['idle_share'],
           'wait_ms_per_step': sum(waits[1:]) / steps}
    print(f'profiled {steps} steps of {feed_name(result)}: host '
          f'{out["host_ms_per_step"]:.2f} ms, device kernels '
          f'{out["device_ms_per_step"]:.2f} ms in '
          f'{out["launches_per_step"]:.0f} launches, waits '
          f'{out["wait_ms_per_step"]:.2f} ms per step; device idle share '
          f'{out["idle_share"]:.3f}')
    return out


def run_pool_path(counters, split, name, steps=POOL_STEPS):
    """FILE_CONFIG at batch 64 from ``split`` (the JPEG folder or the
    pack, called ``name``) through the device pool (POOL_ARGS), counted
    (exactly K1-K4) and checked as run_train_path checks; at least two
    swaps, and the trace of the third block written by --profile. Prints
    the first pool's load, the pool's bytes on the card, the median wait
    per step off the swaps and each swap's wait, and the profiled block's
    idle share. Returns the row of ``file_runs``, its launches under
    'launches'."""
    sets = (f'DATA.TRAIN_SPLIT={split}', f'DATA.TEST_SPLIT={split}')
    with tempfile.TemporaryDirectory() as log_dir:
        launches, result = run_train_path(
            counters, log_dir, FILE_CONFIG, BATCH, steps, ZENG_KERNELS, sets,
            synthetic=False, extra=POOL_ARGS)
        prof = result['profile']
        if not (prof and os.path.getsize(prof['trace']) > 0):
            raise AssertionError(f'--profile wrote no trace: {prof}')
        trace_mb = os.path.getsize(prof['trace']) / 1e6
    feed, spc = result['train_feed'], result['steps_per_call']
    swaps = result['swap_ms']
    if len(swaps) < 2 or not feed.refresh:
        raise AssertionError(f'the pool run swapped at {sorted(swaps)}')
    # A swap's wait is spread over the block after it.
    after_swap = {s + i for s in swaps for i in range(spc)}
    off_swaps = [w for i, w in enumerate(result['wait_ms'])
                 if i >= spc and i not in after_swap]
    pool_mb = feed.pool.numel() * feed.pool.element_size() / 1e6
    row = dict(result['summary'], feed=feed_name(result),
               launches=launches, steps_per_call=spc,
               first_pool_s=result['first_pool_s'], pool_mb=pool_mb,
               wait_ms_per_step=float(statistics.median(off_swaps)),
               swap_wait_ms={str(k): v for k, v in swaps.items()},
               trace_mb=trace_mb,
               profile={'block': prof['block'],
                        'host_ms_per_step': prof['wall_ms'] / prof['steps'],
                        'device_ms_per_step': (prof['device_ms']
                                               / prof['steps']),
                        'launches_per_step': prof['launches'] / prof['steps'],
                        'wait_ms_per_step': 0.0,
                        'idle_share': prof['idle_share']})
    print(f'pool from the {name}: first pool of {len(feed.pool)} '
          f'images loaded in {row["first_pool_s"]:.2f} s, {pool_mb:.1f} MB on '
          f'the card; {row["ms_per_step"]:.2f} ms per step '
          f'({row["pairs_per_s"]:.1f} pairs/s), median wait off the swaps '
          f'{row["wait_ms_per_step"]:.3f} ms per step; swaps (step: ms '
          f'waited) {row["swap_wait_ms"]}; the profiled block '
          f'{prof["block"]} ({prof["steps"]} steps): host '
          f'{prof["wall_ms"]:.2f} ms, device {prof["device_ms"]:.2f} ms, idle '
          f'share {prof["idle_share"]:.3f}; trace {trace_mb:.1f} MB')
    return row


def _rel_l2(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    norm = float(torch.linalg.vector_norm(want))
    return float(torch.linalg.vector_norm(got - want)) / max(norm, 1e-30)


def run_resume(counters, pack_dir, steps=RESUME_STEPS):
    """Resume on the card (FILE_CONFIG at batch 64 from the pack, through
    the device pool: RESUME_POOL images, swapped every ``steps`` steps, so
    at each epoch's end, and each checkpoint holds the card's draw
    generator): run A trains 2 epochs of ``steps`` steps; run B one epoch,
    then the same command with --epochs 2 in its LOGGING.DIR. B must
    resume at epoch 1,
    step ``steps``, optimizer count ``steps``; its losses in epoch 1 and
    its final backbone tensors must match A's within RESUME_REL_L2
    relative L2 (each tensor). When they do not, both runs are made again
    with cuDNN's deterministic algorithms (this phase only) and those
    must hold. Counted: exactly K1-K4 over the three runs. Returns the
    launches, B's log directory (kept in ``pack_dir``'s parent) and the
    readings."""
    from bihome_torch import train

    root = os.path.dirname(pack_dir)
    readings = []
    for deterministic in (False, True):
        torch.backends.cudnn.deterministic = deterministic
        reset_counts(counters)
        dirs = [os.path.join(root, f'resume_{name}_{int(deterministic)}')
                for name in ('a', 'b')]

        def run(log_dir, epochs):
            return train.main([
                '--config_file', FILE_CONFIG, '--batch_size', str(BATCH),
                '--steps', str(steps), '--epochs', str(epochs), '--device',
                'cuda', '--set', 'MODEL.HEAD.AUXILIARY_RESNET_PATH='
                'aux_clfbh.npz', '--set', f'LOGGING.DIR={log_dir}',
                '--set', f'DATA.TRAIN_SPLIT={pack_dir}',
                '--set', f'DATA.TEST_SPLIT={pack_dir}', '--feed', 'pool',
                '--pool_size', str(RESUME_POOL), '--pool_refresh_steps',
                str(steps), '--steps_per_call', '1'])

        whole = run(dirs[0], 2)
        first = run(dirs[1], 1)
        resumed = run(dirs[1], 2)
        launches = read_counts(counters)
        saved = torch.load(first['checkpoint'], weights_only=True)
        if not (resumed['start_step'] == steps
                and sorted(whole['swap_ms']) == [steps, 2 * steps]
                and saved['random']['train_draws']['device'] == 'cuda'
                and saved['optimizer']['count'] == steps
                and resumed['optimizer'].count == 2 * steps
                and first['losses'].shape[0] == steps):
            raise AssertionError('run B did not resume at step '
                                 f'{steps}: {resumed["start_step"]}')
        loss_err = _rel_l2(resumed['losses'], whole['losses'][steps:])
        want = whole['model'].backbone.state_dict()
        errs = {k: _rel_l2(v, want[k])
                for k, v in resumed['model'].backbone.state_dict().items()
                if v.is_floating_point()}
        worst = max(errs, key=errs.get)
        bitwise = (torch.equal(resumed['losses'], whole['losses'][steps:])
                   and all(torch.equal(v, want[k]) for k, v in
                           resumed['model'].backbone.state_dict().items()))
        # Epoch 0 is the same computation in A and B, no resume between:
        # how far two runs of it stray shows the algorithms' own spread.
        epoch0_err = _rel_l2(first['losses'], whole['losses'][:steps])
        reading = {'cudnn_deterministic': deterministic,
                   'epoch0_loss_rel_l2': epoch0_err,
                   'losses_a_epoch1': whole['losses'][steps:].tolist(),
                   'losses_b_epoch1': resumed['losses'].tolist(),
                   'loss_rel_l2': loss_err, 'worst_tensor': worst,
                   'worst_rel_l2': errs[worst], 'bitwise_equal': bitwise}
        readings.append(reading)
        print(f'resume (cudnn.deterministic={deterministic}): B resumed at '
              f'epoch 1, step {resumed["start_step"]}, optimizer count '
              f'{saved["optimizer"]["count"]}; epoch-1 losses A '
              f'{reading["losses_a_epoch1"]} B {reading["losses_b_epoch1"]} '
              f'(relative L2 {loss_err:.3e}); worst backbone tensor {worst} '
              f'{errs[worst]:.3e} (limit {RESUME_REL_L2}); bitwise equal: '
              f'{bitwise}; epoch-0 losses of A and B, no resume between, '
              f'{epoch0_err:.3e} apart')
        if loss_err <= RESUME_REL_L2 and errs[worst] <= RESUME_REL_L2:
            break
    torch.backends.cudnn.deterministic = False
    if not (loss_err <= RESUME_REL_L2 and errs[worst] <= RESUME_REL_L2):
        raise AssertionError(f'resumed run strays from the uninterrupted '
                             f'one: {readings}')
    for name, count in launches.items():
        if (count > 0) != (name in ZENG_KERNELS):
            raise AssertionError(f'{name} launched {count} times on the '
                                 'resume path')
    return launches, dirs[1], readings


def check_eval_log(log_path, n_samples):
    lines = open(log_path).read().splitlines()
    iters = [int(line.split(',')[0]) for line in lines]
    maces = [float(line.split(',')[1]) for line in lines]
    print(f'eval --log: {len(lines)} lines for {n_samples} samples')
    if not (iters == list(range(n_samples))
            and all(math.isfinite(m) for m in maces)):
        raise AssertionError(f'eval --log wrote {len(lines)} lines, not '
                             f'{n_samples}')

@contextlib.contextmanager
def timed_dsac(events):
    """CUDA events around each training-mode ``dsac_deltas`` call on the
    card (the DSAC forward of one field), appended to ``events``."""
    from bihome_torch.heads.assembled import AssembledModel

    original = AssembledModel.dsac_deltas

    def timed(self, pf, *args, **kwargs):
        if not (self.training and pf.is_cuda):
            return original(self, pf, *args, **kwargs)
        pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        pair[0].record()
        out = original(self, pf, *args, **kwargs)
        pair[1].record()
        events.append(pair)
        return out
    AssembledModel.dsac_deltas = timed
    try:
        yield events
    finally:
        AssembledModel.dsac_deltas = original


def dsac_ms_per_step(events, fields):
    """The median over the steps after the first of the DSAC forward's
    ms a step (``fields`` calls a step)."""
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in events]
    steps = [sum(ms[i:i + fields]) for i in range(0, len(ms), fields)]
    return statistics.median(steps[1:] if len(steps) > 1 else steps)


def check_warp_image_2(dev, gen, n=BATCH):
    """K3 at ``image_2``'s shape (eval --vis): ``n`` RGB 240x320 frames
    on 0..255 through K3's C = 3 kernel, each warped whole by the
    inverse of its pair's homography (corner offsets of rho 32 at a patch
    of 128, as the pairs draw them), P = 76,800 points per frame, against
    the plain version, timed beside grid_sample, with the bytes bound of
    the pixels the taps touch."""
    from bihome_torch import geometry
    from bihome_torch.data import pipeline

    h, w, c = 240, 320, 3
    spec = pipeline.PairSpec(rho=32, patch_size=128)
    corners, delta = pipeline.draw_corners_delta_batch(n, (h, w), spec, gen)
    hom = geometry.four_point_to_homography(corners.float(), delta.float())
    u, v = geometry.homography_grid(geometry.inv3x3(hom), (h, w))
    u, v = u.to(dev), v.to(dev)
    frames = (torch.rand((n, h, w, c), generator=gen) * 255).to(dev)
    return check_warp_rgb(dev, 'image_2', frames, u, v)


def check_warp_rgb(dev, name, frames, u, v, fault_lib=None):
    """K3 on RGB frames or windows ``frames`` [N,H,W,3] on 0..255 at the
    points u, v [N,P]: its C = 3 kernel (no generic launch) against the
    plain version within 1e-3, timed beside grid_sample, with the bytes
    bound of the pixels the taps touch; with ``fault_lib``, K3 built with
    K3_FAULT planted must miss the same tolerance."""
    import torch.nn.functional as F
    from bihome_torch.ops import warp

    n, h, w, c = frames.shape
    generic = warp.bilinear_sample_batched.generic_launches
    out = warp.bilinear_sample_batched(frames, u, v)
    kernel = warp.bilinear_sample_batched.last_kernel
    want = warp.bilinear_sample_plain(frames, u, v)
    err = float((out - want).abs().max())
    p = u.shape[1]
    print(f'K3 at the {name} [{n},{h},{w},{c}] P={p} (kernel {kernel}): '
          f'max abs err {err:.3e} (0..255; tolerance 1e-3)')
    if not (err <= 1e-3 and kernel == c
            and warp.bilinear_sample_batched.generic_launches == generic):
        raise AssertionError(f'warp kernel disagrees at the {name}: {err} '
                             f'(kernel {kernel})')
    planted = None
    if fault_lib is not None:
        planted = float((k3_entry(fault_lib, frames, u, v)
                         - want).abs().max())
        print(f'K3 at the {name} with {K3_FAULT[0]}: max abs err '
              f'{planted:.3e} (must exceed 1e-3)')
        if not planted > 1e-3:
            raise AssertionError(f'the {name} check misses {K3_FAULT[0]}')
    img_nchw = frames.permute(0, 3, 1, 2).contiguous()
    grid = _grid(u, v, h, w)
    ms = time_ms(lambda: warp.bilinear_sample_batched(frames, u, v))
    plain = time_ms(lambda: warp.bilinear_sample_plain(frames, u, v))
    lib = time_ms(lambda: F.grid_sample(img_nchw, grid, mode='bilinear',
                                        padding_mode='zeros',
                                        align_corners=True))
    host = host_us(lambda: warp.bilinear_sample_batched(frames, u, v))
    touched = warp.touched_pixels(u, v, h, w)
    # The touched pixels of each channel read once, u and v read, the
    # samples written; per point 4 weights and floors, per channel 4
    # products and 3 adds.
    b, by = bound_ms(4 * (touched * c + 2 * n * p + n * p * c),
                     (8 + 7 * c) * n * p)
    print(f'K3 times at the {name} (ms): kernel {ms:.4f}  plain '
          f'{plain:.4f}  grid_sample {lib:.4f}  bound {b:.4f} ({by}; '
          f'{touched / (n * h * w):.3f} of the frame touched); host us per '
          f'call {host:.1f}')
    figures = {'shape': [n, h, w, c], 'points': p, 'max_abs_err': err,
               'ms': ms, 'plain_ms': plain, 'bound_ms': b, 'bound_by': by,
               'library_ms': lib, 'host_us': {'kernel': host},
               'kernel': kernel}
    if planted is not None:
        figures['planted_fault'] = {'name': K3_FAULT[0],
                                    'max_abs_err': planted}
    return figures


def k3_entry(lib, images, u, v):
    """K3's C entry of a library built apart (``lib``) on these inputs."""
    from bihome_torch import profile_kernels

    run = profile_kernels.k3_call(lib, images, u, v)
    run()
    return run.out


def start_k3_fault_build(stack):
    """Build csrc/warp.cu with K3_FAULT planted on a thread of ``stack``'s,
    beside the kernels' own build; returns the future of its library."""
    from bihome_torch import profile_kernels
    from bihome_torch.ops import _cuda

    src = (_cuda.CSRC / 'warp.cu').read_text()
    if src.count(K3_FAULT[1]) != 1:
        raise AssertionError(f'{K3_FAULT[0]}: its line is not in warp.cu')
    faulty = {'warp_k3_fault': src.replace(K3_FAULT[1], K3_FAULT[2])}
    pool = stack.enter_context(concurrent.futures.ThreadPoolExecutor(1))
    return pool.submit(lambda: profile_kernels.build_sources(
        faulty, 'warp')['warp_k3_fault'])


def check_warp_k3_rgb(dev, gen, fault_lib, n=BATCH):
    """K3's C > 1 kernels on the paths that run them beside image_2: the
    RGB window warp of a patch_2 that PhotometricDistort distorts whole
    (``data/pipeline.patch_windows`` on pds-coco's geometry: 240x320 RGB
    frames, patch 128, rho 32: ``n`` windows of 192x192x3, P = 16,384),
    held and timed as image_2, and K3_FAULT planted at C = 3 there and at
    C = 2 on the masked loss warp's shape (2B patches and masks of 128x128,
    the loss warp's points), where the check of the K5 slice (error over
    max|ref| within 1e-5) must catch it."""
    from bihome_torch import geometry
    from bihome_torch.data import pipeline
    from bihome_torch.ops import warp

    spec = pipeline.PairSpec(rho=32, patch_size=128)
    corners, delta = pipeline.draw_corners_delta_batch(n, (240, 320), spec,
                                                       gen)
    hom = geometry.four_point_to_homography(corners.float(), delta.float())
    frames = (torch.rand((n, 240, 320, 3), generator=gen) * 255).to(dev)
    windows, u, v = pipeline.patch_windows(frames, hom.to(dev),
                                           corners[:, 0].float().to(dev),
                                           spec.patch_size, spec.rho)
    figures = check_warp_rgb(dev, 'RGB window warp', windows, u, v,
                             fault_lib)
    m, ps = 2 * BATCH, 128
    u2, v2 = _loss_warp_points(dev, gen, m, ps)
    masked = torch.cat([torch.randn((m, ps, ps, 1), generator=gen),
                        torch.rand((m, ps, ps, 1), generator=gen)],
                       dim=-1).to(dev)
    want = warp.bilinear_sample_plain(masked, u2, v2)
    sound = _rel_err(warp.bilinear_sample_batched(masked, u2, v2), want)
    planted = _rel_err(k3_entry(fault_lib, masked, u2, v2), want)
    print(f'K3 at the masked loss warp [{m},{ps},{ps},2]: error / max|ref| '
          f'{sound:.2e}, with {K3_FAULT[0]} {planted:.2e} (tolerance 1e-5)')
    if not (sound <= 1e-5 < planted):
        raise AssertionError(f'the C = 2 check misses {K3_FAULT[0]} '
                             f'({sound}, {planted})')
    figures['planted_fault_c2'] = {'max_rel_err': planted,
                                   'sound_max_rel_err': sound}
    return figures


def check_datagen_leftovers(dev, gen, n=BATCH):
    """The datagen leftovers on the card against the CPU plain path, on
    the same draws: ``photometric_distort_full`` on 64 synthetic 240x320
    frames (within 1e-3 on 0..255, as check_pds), the blob masks of 64
    128x128 noise images (exactly: the blur is a fixed-order sum) and
    their composite, and ``image_2`` of the S-COCO pairs (the frame warped
    whole by K3): within 1e-3 on 0..255 of the CPU's warp by the card's
    homography, and the two devices' homographies within 1e-3 px at the
    patch corners that define them. (The CPU's own image_2 stands further
    off: extrapolated to the frame's corners the two homographies part
    by ~1e-3 px, which moves a sample on a sharp edge by ~1e-2 on 0..255;
    both printed.)"""
    import dataclasses
    from bihome_torch import geometry
    from bihome_torch.data import blobs, datasets, photometric, pipeline

    cpu = torch.device('cpu')
    pool = torch.from_numpy(datasets.SyntheticDataset(seed=4).pool[:n])
    frames = pool.float()
    params = photometric.draw_photometric_full_params(n, gen)
    err_full = float((photometric.photometric_distort_full(
        frames.to(dev), params.to(dev)).cpu()
        - photometric.photometric_distort_full(frames, params)).abs().max())
    noise, shift = blobs.draw_blobs(n, (128, 128), gen)
    masks = [blobs.generate_blobs(noise.to(d), BLOB_POROSITY).cpu()
             for d in (dev, cpu)]
    differ = int((masks[0] != masks[1]).sum())
    share = float(masks[1].float().mean())
    patches = {k: torch.randn((n, 128, 128, 1), generator=gen)
               for k in ('patch_1', 'patch_2')}
    composite = [blobs.apply_blob_augmentation(
        {k: v.to(d) for k, v in patches.items()}, noise, shift,
        BLOB_POROSITY)['patch_2'].cpu() for d in (dev, cpu)]
    err_blob = float((composite[0] - composite[1]).abs().max())
    spec = dataclasses.replace(pipeline.PairSpec(), max_delta=0.0,
                               emit_images=('image_2',))
    corners, delta = pipeline.draw_corners_delta_batch(
        n, tuple(pool.shape[1:3]), spec, gen)
    card, host = (pipeline.generate_pairs(pool.to(d), spec, corners=corners,
                                          delta=delta) for d in (dev, cpu))
    image_2 = card['image_2'].cpu()
    hom = card['homography'].cpu()
    err_image_2 = float((image_2 - geometry.warp_image(frames, hom))
                        .abs().max())
    def apart(points):
        return float((geometry.transform_points(hom, points)
                      - geometry.transform_points(host['homography'], points))
                     .abs().max())
    err_hom = apart(corners.float())
    err_frame = apart(geometry.image_corners(240, 320, batch_size=n))
    err_direct = float((image_2 - host['image_2']).abs().max())
    print(f'datagen leftovers on the card vs the CPU plain path, same '
          f'draws: photometric_distort_full [{n},240,320,3] max abs err '
          f'{err_full:.3e} (0..255, tolerance 1e-3); blob masks '
          f'[{n},128,128] {differ} values differ (exact; {share:.3f} of '
          f'them blob), composite max abs err {err_blob:.1e}; image_2 '
          f'{list(image_2.shape)} max abs err {err_image_2:.3e} against the '
          f'CPU\'s warp by the card\'s homography (0..255, tolerance 1e-3), '
          f'the homographies {err_hom:.2e} px apart at the patch corners '
          f'(tolerance 1e-3; {err_frame:.2e} at the frame\'s), the CPU\'s '
          f'own image_2 {err_direct:.3e} away')
    if not (err_full <= 1e-3 and differ == 0 and err_blob == 0
            and err_image_2 <= 1e-3 and err_hom <= 1e-3
            and abs(share - BLOB_POROSITY) < 0.01):
        raise AssertionError(f'datagen leftovers disagree: {err_full}, '
                             f'{differ}, {err_blob}, {err_image_2}, '
                             f'{err_hom}')
    return {'photometric_full_max_abs_err': err_full,
            'blob_mask_values_differ': differ,
            'image_2_max_abs_err': err_image_2,
            'homography_corner_err_px': err_hom,
            'homography_frame_corner_err_px': err_frame,
            'image_2_vs_cpu_pairs_max_abs_err': err_direct}


def leftover_config(path, log_dir):
    """pds zeng-biHomE with PhotometricDistort on both patches after
    HomographyNetPrep (TRANSFORMS and TEST_TRANSFORM) and
    AUGMENT_BLOB_POROSITY BLOB_POROSITY, written into ``log_dir``: --set
    cannot add to a list."""
    import yaml
    from bihome_torch import config as config_lib

    config = config_lib.load_config(path)
    for key in ('TRANSFORMS', 'TEST_TRANSFORM'):
        transforms = list(config['DATA'][key])
        config['DATA'][key] = (transforms[:1] + [
            {'PhotometricDistort': [['patch_1', 'patch_2']]}]
            + transforms[1:])
    config['DATA']['AUGMENT_BLOB_POROSITY'] = BLOB_POROSITY
    out = os.path.join(log_dir, 'leftovers.yaml')
    with open(out, 'w') as f:
        yaml.safe_dump(config, f)
    return out


def run_dsac_slice(counters, paths, dev, gen):
    """The DSAC, HomographyNet and datagen-leftover runs; returns their
    figures and K3's and K4's entries at the loss warp of n = DSAC_N (and
    K3's at image_2)."""
    config = PDS_RUNS[0][0]
    n = 2 * BATCH * DSAC_N
    image = torch.randn((n, 128, 128, 1), generator=gen).to(dev)
    u, v = _loss_warp_points(dev, gen, n, 128)
    at_n4 = check_warp_frame(dev, gen, f'DSAC n{DSAC_N} loss', image, u, v)
    del image, u, v
    at_image_2 = check_warp_image_2(dev, gen)
    leftovers = check_datagen_leftovers(dev, gen)
    out = {'train_runs': {}, 'evals': {}, 'leftovers': leftovers}
    for name, sets in DSAC_RUNS.items():
        events = []
        with tempfile.TemporaryDirectory() as log_dir, timed_dsac(events):
            paths[f'train {" ".join((config, *sets))}'], result = (
                run_train_path(counters, log_dir, config, BATCH, PDS_STEPS,
                               ZENG_KERNELS, sets))
        row = result['summary']
        row['dsac_fwd_ms_per_step'] = dsac_ms_per_step(
            events, 1 if 'one-line' in name else 2)
        model, initial = result['model'], result['initial_state']
        if model.score_cnn is not None:
            moved = [k for k, _ in model.score_cnn.named_parameters()
                     if not torch.equal(model.score_cnn.state_dict()[k].cpu(),
                                        initial[f'score_cnn.{k}'])]
            row['score_cnn_moved'] = len(moved)
            # The double-line loss weighs nothing by the scores: no
            # gradient reaches the score CNN there (nor in JAX).
            want = 'one-line' in name
            print(f'score CNN parameters moved: {len(moved)} of '
                  f'{len(list(model.score_cnn.parameters()))} (expected '
                  f'{"all" if want else "none"})')
            if bool(moved) != want:
                raise AssertionError(f'the score CNN moved {len(moved)} '
                                     f'tensors on the {name} run')
        print(f'DSAC n={DSAC_N} {name}: {row["ms_per_step"]:.2f} ms per '
              f'step, {row["pairs_per_s"]:.1f} pairs/s, peak '
              f'{row["peak_gb"]:.2f} GB; DSAC forward '
              f'{row["dsac_fwd_ms_per_step"]:.2f} ms per step')
        out['train_runs'][name] = row
        if name in DSAC_STEP_CHECKS:
            out.setdefault('step_checks', {})[name] = compare_train_step(
                result, 4, ('K4 du negated',))
        del result, model
    for name, sets in DSAC_EVALS.items():
        paths[f'eval {" ".join((CONFIG, *sets))}'], result, pairs_per_s = (
            run_eval_path(counters, CONFIG, BATCH, PDS_STEPS, sets=sets,
                          check_pairs=4))
        out['evals'][name] = {'model_ms': result['per_batch_ms'],
                              'pairs_per_s': pairs_per_s,
                              'mean_mace': result['mean_mace'],
                              'delta_err_px': result['delta_err']}
        del result
    config, batch, sets = HOMOGRAPHY_NET
    with tempfile.TemporaryDirectory() as log_dir:
        paths[f'train {" ".join((config, *sets))}'], result = run_train_path(
            counters, log_dir, config, batch, PDS_STEPS,
            ('bilinear_sample_batched',), sets)
    out['homography_net'] = result['summary']
    del result
    with tempfile.TemporaryDirectory() as log_dir:
        path = leftover_config(PDS_RUNS[0][0], log_dir)
        name = (f'train {PDS_RUNS[0][0]} + PhotometricDistort, '
                f'AUGMENT_BLOB_POROSITY={BLOB_POROSITY}')
        paths[name], result = run_train_path(
            counters, log_dir, path, BATCH, PDS_STEPS, ZENG_KERNELS)
    spec = result['built'].pair_spec
    if not (spec.photometric_full_keys == ('patch_1', 'patch_2')
            and spec.blob_porosity == BLOB_POROSITY):
        raise AssertionError(f'the leftover run did not take its keys: '
                             f'{spec}')
    out['leftover_run'] = result['summary']
    # What the --multihost blob run's first logged loss is held to.
    out['leftover_first_loss'] = float(result['losses'][0])
    del result
    with tempfile.TemporaryDirectory() as vis_dir:
        paths[f'eval {CONFIG} --vis'], result, _ = run_eval_path(
            counters, CONFIG, BATCH, 1, check_pairs=4,
            extra=('--vis', '--vis_dir', vis_dir))
        names = os.listdir(vis_dir)
        want = {f'{i:05d}_{suffix}' for i in range(BATCH) for suffix in (
            'image_vis.png', 'patch_1_2_mask.gif', 'warped.npy',
            'patch_2.npy', 'mask_1.npy', 'mask_2.npy', 'pf.npy')}
        shape = list(result['batches'][0]['image_2'].shape)
        print(f'eval --vis wrote {len(names)} files for {BATCH} samples; '
              f'image_2 {shape}')
        if set(names) != want or shape != [BATCH, 240, 320, 3]:
            raise AssertionError(f'eval --vis wrote {sorted(names)[:8]}..., '
                                 f'image_2 {shape}')
        out['vis_files'] = len(names)
        del result
    return out, at_n4, at_image_2

def pretrain_file_modules(path):
    """The flax top-level module stems an extractor file holds, in order."""
    import numpy as np

    with np.load(path) as data:
        held = {k.split('/')[1].split('_')[0] for k in data.files}
    return [m for m in ('conv1', 'bn1', 'layer1', 'layer2') if m in held]


def run_pretrain_path(counters, name, extra, out_dir):
    """``python -m bihome_torch.pretrain_aux`` at its defaults with
    PRETRAIN_ARGS and ``extra`` on the card, counted: exactly K3 (none for
    gradpds), finite losses, every parameter and BN statistic moved, the
    file holding exactly what JAX's writer keeps (conv1/bn1/layer1, layer2
    too at --layers 2 and for rotnet's whole network). Returns its
    launches, its row and the file's path."""
    from bihome_torch import pretrain_aux

    reset_counts(counters)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    path = os.path.join(out_dir, f'aux_{name.replace(" ", "_")}.npz')
    result = pretrain_aux.main([*PRETRAIN_ARGS, *extra, '--device', 'cuda',
                                '--out', path])
    launches = read_counts(counters)
    args = result['args']
    expect = () if args.pretext == 'gradpds' else PRETRAIN_KERNELS
    print(f'launches on the pretext run {name}: {launches}')
    for kernel, count in launches.items():
        if (count > 0) != (kernel in expect):
            raise AssertionError(f'{kernel} launched {count} times on the '
                                 f'pretext run {name}')
    losses = result['losses']
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f'non-finite pretext loss: {losses.tolist()}')
    final, initial = result['model'].state_dict(), result['initial_state']
    still = [k for k in final if not k.endswith('num_batches_tracked')
             and torch.equal(final[k].cpu(), initial[k])]
    if still:
        raise AssertionError(f'{name}: {len(still)} tensors did not move, '
                             f'e.g. {still[:3]}')
    deep = args.layers == 2 or args.pretext == 'rotnet'
    want = ['conv1', 'bn1', 'layer1'] + (['layer2'] if deep else [])
    held = pretrain_file_modules(path)
    if held != want:
        raise AssertionError(f'{name}: the file holds {held}, not {want}')
    ms = result['median_step_ms']
    row = {'pretext': name, 'args': list(extra), 'batch': args.batch,
           'steps': args.steps, 'ms_per_step': ms,
           'pairs_per_s': args.batch / (ms / 1e3), 'peak_gb':
           result['peak_gb'], 'losses': [losses[0].item(),
                                         losses[-1].item()],
           'block_ms': result['block_ms'], 'file': held,
           'launches': launches}
    print(f'pretext {name}: {ms:.2f} ms per step (median of blocks 2-; '
          f'blocks {[round(t, 2) for t in result["block_ms"]]}), '
          f'{row["pairs_per_s"]:.1f} pairs/s, peak memory allocated '
          f'{row["peak_gb"]:.2f} GB; loss {row["losses"][0]:.4f} -> '
          f'{row["losses"][1]:.4f}; file {held}')
    return launches, row, path


@contextlib.contextmanager
def planted_k3_shift():
    """K3's output (every warp: the datagen's and warp_gt's) shifted by one
    row of the 128-pixel patch grid."""
    from bihome_torch.ops import warp

    owner = warp.BilinearSample
    original, saved = owner.forward, vars(owner)['forward']

    def shifted(ctx, images, u, v):
        return torch.roll(original(ctx, images, u, v), 128, dims=1)
    owner.forward = staticmethod(shifted)
    try:
        yield
    finally:
        owner.forward = saved


def pretrain_step_grads(pretext, state, pool, draws, device):
    """One pretext step's loss and gradients (float32, training mode, no
    optimizer) from ``state`` on ``draws``, the batch built on ``device``
    (K3 on the card, the plain gather on the CPU)."""
    from bihome_torch import pretrain_aux

    model = pretrain_aux.build_model(pretext, torch.float32)
    model.load_state_dict(state)
    model.to(device).train()
    with torch.no_grad():
        batch = pretrain_aux.make_batch(pretext, pool.to(device), draws)
    loss, _ = pretrain_aux.loss_and_acc(pretext, model, batch)
    loss.backward()
    loss = float(loss.detach())
    return (loss, abs(loss),
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()})


def compare_pretrain_step(batch=PRETRAIN_STEP_BATCH):
    """The gradcl step with the basin, fine and hard-negative terms and the
    rich target on the card against the CPU plain path, both float32, on
    the same seeded weights and draws, within the limits of
    :func:`compare_train_step` (the loss against its own size); then the
    card's step with K3's output shifted a row, which must fail them."""
    from bihome_torch import pretrain_aux
    from bihome_torch.data import synthetic

    pretext = pretrain_aux.Pretext('gradcl', rich_target=True,
                                   cl_fine_weight=0.3, cl_hard_beta=0.5,
                                   basin_weight=0.5)
    model = pretrain_aux.build_model(pretext, torch.float32, seed=11)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    pool = torch.from_numpy(synthetic.make_image_pool(16, 240, 320, seed=3))
    draws = pretrain_aux.draw(pretext, batch, pool.shape[0],
                              torch.Generator().manual_seed(13))
    with one_cpu_thread():
        ref = pretrain_step_grads(pretext, state, pool, draws,
                                  torch.device('cpu'))
    cuda = torch.device('cuda')
    runs = {'card': pretrain_step_grads(pretext, state, pool, draws, cuda)}
    with planted_k3_shift():
        runs[PRETRAIN_FAULT] = pretrain_step_grads(pretext, state, pool,
                                                   draws, cuda)
    readings = {}
    for name, run in runs.items():
        loss_err, l2, per, worst = readings[name] = step_errors(run, ref)
        print(f'one gradcl step (basin, fine, hard, rich; batch {batch}), '
              f'{name} against the CPU plain path in float32: loss '
              f'{run[0]:.6f} vs {ref[0]:.6f}, error / loss {loss_err:.2e} '
              f'(limit {STEP_LOSS:.2g}); gradients relative L2 {l2:.2e} '
              f'(limit {STEP_L2:.2g}), worst tensor {per:.2e} ({worst}; '
              f'limit {STEP_PER_TENSOR:.2g})')

    def holds(name):
        loss_err, l2, per, _ = readings[name]
        return (loss_err <= STEP_LOSS and l2 <= STEP_L2
                and per <= STEP_PER_TENSOR)
    if not holds('card'):
        raise AssertionError('the pretext step on the card strays from the '
                             'CPU plain path')
    if holds(PRETRAIN_FAULT):
        raise AssertionError('the pretext step check misses K3 shifted a '
                             'row')
    print(f'planted fault caught by the pretext step check: '
          f'{PRETRAIN_FAULT}')
    return {k: list(v) for k, v in readings.items()}


def check_warp_gt(dev, gen, n=256, ps=128):
    """K3 at warp_gt's shape: ``n`` standardized ps x ps patches warped by
    ground-truth corner offsets of up to 32 px (rho) over the patch grid,
    as ``pretrain/targets.warp_gt`` samples them."""
    from bihome_torch import geometry

    image = torch.randn((n, ps, ps, 1), generator=gen).to(dev)
    corners = geometry.image_corners(ps, ps, batch_size=n)
    delta = torch.randint(-32, 32, (n, 4, 2), generator=gen).float()
    hom = geometry.four_point_to_homography(corners, delta)
    u, v = geometry.homography_grid(hom, (ps, ps))
    k3, _ = check_warp_frame(dev, gen, 'warp_gt', image, u.to(dev),
                             v.to(dev))
    return k3


def run_pretrain_slice(counters, paths, runs, dev, gen):
    """Phase 20: K3 at warp_gt's shape; every PRETRAIN_RUNS run; the
    pretext step check; pds zeng-biHomE trained from the gradpdscl file
    (K1-K4, the extractor the file's and unchanged) and with a seeded
    resnet50 extractor (K1-K4), each beside the resnet34 row of this call.
    Returns the slice's figures and K3's entry at warp_gt."""
    import numpy as np

    at_warp_gt = check_warp_gt(dev, gen)
    out = {'runs': {}}
    with tempfile.TemporaryDirectory() as root:
        for name, extra in PRETRAIN_RUNS.items():
            paths[f'pretrain {name}'], row, path = run_pretrain_path(
                counters, name, extra, root)
            out['runs'][name] = row
            if name == 'gradpdscl':
                pds_file = path
        out['step_check'] = compare_pretrain_step()
        config = PDS_RUNS[0][0]
        r34 = next(r for r in runs if r['config'] == config
                   and r['dtype'] == 'float32' and not r['sets'])
        for label, sets in (('gradpdscl file', (
                f'MODEL.HEAD.AUXILIARY_RESNET_PATH={pds_file}',)),
                            ('resnet50 extractor', R50_EXTRACTOR)):
            with tempfile.TemporaryDirectory() as log_dir:
                paths[f'train {config} {label}'], result = run_train_path(
                    counters, log_dir, config, BATCH, PDS_STEPS,
                    ZENG_KERNELS, sets)
            row = result['summary']
            if label == 'gradpdscl file':
                kernel = np.load(pds_file)['params/conv1/kernel']
                got = result['initial_state']['auxiliary_resnet.conv1.weight']
                if not np.array_equal(got.numpy(),
                                      np.transpose(kernel, (3, 2, 0, 1))):
                    raise AssertionError('the extractor is not the '
                                         'gradpdscl file\'s')
            else:
                width = result['model'].auxiliary_resnet.layer1[0].conv3
                if width.out_channels != 256:
                    raise AssertionError('not a resnet50 extractor')
            row['resnet34_row'] = {k: r34[k] for k in (
                'ms_per_step', 'pairs_per_s', 'peak_gb')}
            print(f'pds zeng-biHomE at {BATCH} with the {label}: '
                  f'{row["ms_per_step"]:.2f} ms per step, '
                  f'{row["pairs_per_s"]:.1f} pairs/s, peak '
                  f'{row["peak_gb"]:.2f} GB; with aux_clfbh.npz (resnet34, '
                  f'this call) {r34["ms_per_step"]:.2f} ms, '
                  f'{r34["pairs_per_s"]:.1f} pairs/s, {r34["peak_gb"]:.2f} '
                  f'GB')
            out[label] = row
            del result
    return out, at_warp_gt


@contextlib.contextmanager
def planted_ddp_fault(name):
    """One wrong split of the statistics across ranks (DDP_FAULTS): every
    batch statistic and cotangent sum left to each rank's own slice (what
    a plain DistributedDataParallel wrap computes), or the PF head's
    parameter gradients (dgamma, dbeta, dw2, db1) taken from the moments
    summed over the ranks, which the gradient sum then counts twice."""
    from bihome_torch.ops import fused_head
    from bihome_torch.parallel import mesh

    if name == DDP_FAULTS[0]:
        owner, attr = mesh, 'sum_over_ranks'

        def spoiled(*tensors):
            return list(tensors)
    else:
        owner, attr = fused_head, 'moment_sums'
        original = fused_head.moment_sums

        def spoiled(m0, m1, m, device):
            _, summed = original(m0, m1, m, device)
            return summed[:2], summed
    saved = getattr(owner, attr)
    setattr(owner, attr, spoiled)
    try:
        yield
    finally:
        setattr(owner, attr, saved)


def ddp_step_grads(config, state, data, device):
    """This rank's part of :func:`one_step_grads` (float32 on the card):
    its slice of ``data``, the global batch's statistics, the gradients
    summed over the ranks (the biHomE loss sums over the batch); returns
    the global loss, the global sum of its terms' magnitudes and the
    gradients as float64 on the CPU."""
    from bihome_torch import config as config_lib
    from bihome_torch.data import pipeline
    from bihome_torch.parallel import dist_util, mesh
    from bihome_torch.training import losses, trainer

    pool, corners, delta, pds, uniforms = data
    shard = mesh.shard_batch
    built = config_lib.build_model(config)
    model = built.model
    model.load_state_dict(state)
    _condition(model)
    model = model.to(device).train()
    batch = pipeline.generate_pairs(
        shard(pool).to(device), built.pair_spec, corners=shard(corners),
        delta=shard(delta),
        photometric_params=tuple(None if p is None else shard(p)
                                 for p in pds))
    out = model(batch, uniforms=[shard(u) for u in uniforms])
    loss = losses.compute_loss(built.loss_name, out)
    loss.backward()
    scale = trainer.loss_scale(built.loss_name, dist_util.get_world_size())
    mesh.all_reduce_grads([p for p in model.parameters() if p.requires_grad],
                          scale)
    # The loss gathered apart from the statistics' sums (a planted fault
    # replaces those).
    parts = dist_util.all_gather(
        [loss.item() * scale] + [out['metrics'][f'loss_comp/ln{i}'].item()
                                 for i in (1, 2, 3)])
    totals = [sum(col) for col in zip(*parts)]
    grads = {n: p.grad.cpu().double()
             for n, p in model.backbone.named_parameters()
             if n != 'layer8.0.bias'}
    return totals[0], sum(abs(t) for t in totals[1:]), grads


def _ddp_rank(rank, world, ports, config, state, data, root):
    """One rank of the data-parallel slice: the step's gradients (clean and
    under each planted fault, saved by rank 0 into ``root``), the train
    entry point with ``--multihost`` for each of DDP_TRAIN_RUNS (through
    the whole pool, with ``--pool_shard``, and step 17's blob YAML, which
    the parent wrote into ``root``), then the eval entry point with
    ``--multihost`` on the first run's checkpoint; each run counted."""
    import argparse

    import torch.distributed as dist

    from bihome_torch import eval as teval
    from bihome_torch import train
    from bihome_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = kernel_counters()
    # The group as the entry points' --multihost --coordinator start it.
    device = mesh.init_from_args(argparse.Namespace(
        device='cuda', multihost=True, coordinator=f'127.0.0.1:{ports[0]}',
        num_processes=world, process_id=rank))
    backend = dist.get_backend()
    try:
        readings = {'card': ddp_step_grads(config, state, data, device)}
        for fault in DDP_FAULTS:
            with planted_ddp_fault(fault):
                readings[fault] = ddp_step_grads(config, state, data, device)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        torch.save(readings, os.path.join(root, 'readings.pt'))
    del readings
    blob_config = os.path.join(root, 'leftovers.yaml')
    coordinate = ['--multihost', '--num_processes', str(world),
                  '--process_id', str(rank), '--coordinator']
    out = {'backend': backend, 'device': str(device), 'runs': {}}
    for i, (name, config, extra) in enumerate(DDP_TRAIN_RUNS):
        reset_counts(counters)
        torch.cuda.reset_peak_memory_stats()
        result = train.main([
            '--config_file', config or blob_config, '--synthetic',
            '--batch_size', str(DDP_BATCH), '--steps', str(PDS_STEPS),
            '--epochs', '1', '--device', 'cuda', '--steps_per_call', '1',
            '--set', 'MODEL.HEAD.AUXILIARY_RESNET_PATH=aux_clfbh.npz',
            '--set', f'LOGGING.DIR={os.path.join(root, f"train{i}")}',
            '--set', 'LOGGING.STEP=1', *extra,
            *coordinate, f'127.0.0.1:{ports[1 + i]}'])
        out['runs'][name] = {
            'launches': read_counts(counters),
            'ms_per_step': result['median_step_ms'],
            'step_ms': result['step_ms'],
            'losses': result['losses'].tolist(),
            'peak_gb': torch.cuda.max_memory_allocated() / 1e9}
        del result
    reset_counts(counters)
    result = teval.main([
        '--config_file', CONFIG, '--synthetic', '--batch_size', str(BATCH),
        '--steps', str(PDS_STEPS), '--device', 'cuda', '--skip_timing',
        '--ckpt', os.path.join(root, 'train0'),
        '--log', os.path.join(root, 'mace.log'),
        *coordinate, f'127.0.0.1:{ports[1 + len(DDP_TRAIN_RUNS)]}'])
    out['eval'] = {'launches': read_counts(counters),
                   'mean_mace': result['mean_mace'],
                   'samples': len(result['maces'])}
    return out


def ddp_rank(rank, world, ports, config, state, data, root, queue):
    """:func:`_ddp_rank` in a spawned process; its result or its traceback
    goes to ``queue``."""
    import traceback

    try:
        queue.put((rank, 'ok', _ddp_rank(rank, world, ports, config, state,
                                          data, root)))
    except BaseException:
        queue.put((rank, 'error', traceback.format_exc()))


def free_ports(n):
    """``n`` distinct free TCP ports on localhost."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for sock in socks:
            sock.bind(('127.0.0.1', 0))
        return [sock.getsockname()[1] for sock in socks]
    finally:
        for sock in socks:
            sock.close()


def spawn_and_collect(target, args_of, count):
    """``count`` spawned processes running ``target(*args_of(i), queue)``;
    their results by index. Raises if one fails or outlives
    RANK_TIMEOUT_S; every process is stopped before returning."""
    import queue as queue_lib

    ctx = multiprocessing.get_context('spawn')
    results = ctx.Queue()
    procs = [ctx.Process(target=target, args=(*args_of(i), results))
             for i in range(count)]
    for proc in procs:
        proc.start()
    got, errors = {}, []
    try:
        for _ in range(count):
            index, status, value = results.get(timeout=RANK_TIMEOUT_S)
            if status != 'ok':
                errors.append(f'process {index}:\n{value}')
                break
            got[index] = value
    except queue_lib.Empty:
        errors.append(f'a process outlived {RANK_TIMEOUT_S} s')
    finally:
        for proc in procs:
            proc.join(timeout=60 if not errors else 5)
            if proc.is_alive():
                proc.kill()
                proc.join()
    if errors:
        raise AssertionError('\n'.join(errors))
    return [got[i] for i in range(count)]


def run_ddp_slice(paths, one_process_loss, one_process_blob_loss):
    """The data-parallel slice (DDP_CONFIG at global batch DDP_BATCH over
    DDP_RANKS spawned ranks): rank 0's first-step loss and gradients, after
    the gradient sum and before Adam, against the one-process step at
    DDP_BATCH on the card on the same weights and draws (the limits of
    :func:`compare_train_step`), and each DDP_FAULTS fault failing them;
    the train entry point with ``--multihost`` (whole pool and
    ``--pool_shard``), K1-K4 launched in each rank, rank 0 alone writing,
    the whole-pool run's first logged loss (the trainer's own draws, made
    for the global batch and sliced) within STEP_LOSS of its terms of
    ``one_process_loss``, the first loss of the one-process train run of
    DDP_CONFIG at DDP_BATCH on the same seeds, and the blob run's (step
    17's YAML: the occlusion rolls patch_1 over the global batch, its
    donors gathered from the ranks) within STEP_LOSS of its terms of
    ``one_process_blob_loss``, step 17's one-process first loss;
    the eval entry point with ``--multihost``, its ``--log`` listing each
    sample once. Returns the slice's figures."""
    from bihome_torch import config as config_lib
    from bihome_torch import train

    config = config_lib.load_config(DDP_CONFIG)
    config_lib.apply_overrides(
        config, ['MODEL.HEAD.AUXILIARY_RESNET_PATH=aux_clfbh.npz'])
    built = config_lib.build_model(config)
    train.init_model(built)
    state = {k: v.clone() for k, v in built.model.state_dict().items()}
    data = step_data(built, DDP_BATCH)
    ref = one_step_grads(built, state, data, torch.device('cuda'))
    cards = torch.cuda.device_count()
    shared = cards < DDP_RANKS
    print(f'DDP slice: {DDP_RANKS} ranks, '
          + ('gloo, both on one card (not a scaling number)' if shared
             else 'NCCL, a card each'))
    ports = free_ports(2 + len(DDP_TRAIN_RUNS))
    names = [name for name, _, _ in DDP_TRAIN_RUNS]
    with tempfile.TemporaryDirectory() as root:
        leftover_config(PDS_RUNS[0][0], root)
        begin = time.perf_counter()
        ranks = spawn_and_collect(
            ddp_rank, lambda r: (r, DDP_RANKS, ports, config, state, data,
                                 root), DDP_RANKS)
        wall_s = time.perf_counter() - begin
        readings = torch.load(os.path.join(root, 'readings.pt'))
        records = {name: open(os.path.join(root, f'train{i}',
                                           'metrics.jsonl')).read()
                   .splitlines() for i, name in enumerate(names)}
        files = {name: sorted(os.listdir(os.path.join(root, f'train{i}')))
                 for i, name in enumerate(names)}
        check_eval_log(os.path.join(root, 'mace.log'), BATCH * PDS_STEPS)
    errors = {}
    for name, run in readings.items():
        loss_err, l2, per, worst = errors[name] = step_errors(run, ref)
        print(f'DDP step ({DDP_RANKS} ranks, global batch {DDP_BATCH}), '
              f'{name}, rank 0 against the one-process step on the card: '
              f'loss {run[0]:.6f} vs {ref[0]:.6f}, error / terms '
              f'{loss_err:.2e} (limit {STEP_LOSS:.2g}); gradients relative '
              f'L2 {l2:.2e} (limit {STEP_L2:.2g}), worst tensor {per:.2e} '
              f'({worst}; limit {STEP_PER_TENSOR:.2g})')

    def holds(name):
        loss_err, l2, per, _ = errors[name]
        return (loss_err <= STEP_LOSS and l2 <= STEP_L2
                and per <= STEP_PER_TENSOR)
    if not holds('card'):
        raise AssertionError('the DDP step strays from the one-process step')
    caught = {fault: not holds(fault) for fault in DDP_FAULTS}
    print(f'planted DDP faults caught: {caught}')
    if not all(caught.values()):
        raise AssertionError(f'the DDP check misses a planted fault: {caught}')
    first_loss = {}
    for name, want in (('whole pool', one_process_loss),
                       ('blob', one_process_blob_loss)):
        first = json.loads(records[name][0])
        terms = sum(abs(first[f'loss_comp/ln{i}']) for i in (1, 2, 3))
        err = abs(first['loss/train'] - want) / terms
        first_loss[name] = {'multihost': first['loss/train'],
                            'one_process': want, 'error_over_terms': err}
        print(f'DDP train {name}, first logged loss '
              f'{first["loss/train"]:.6f} (global batch {DDP_BATCH}, the '
              f'trainer\'s own draws) against the one-process run\'s '
              f'{want:.6f}: error / terms {err:.2e} (limit {STEP_LOSS:.2g})')
        if not err <= STEP_LOSS:
            raise AssertionError(f'the --multihost {name} run\'s first loss '
                                 f'strays from the one-process run\'s')
    # Two epochs' records would repeat if another rank wrote: PDS_STEPS
    # step records and one test record, one checkpoint.
    for name, lines in records.items():
        if len(lines) != PDS_STEPS + 1 or files[name] != [
                'metrics.jsonl', f'model_{PDS_STEPS:06d}.pth']:
            raise AssertionError(f'{name}: {len(lines)} records, files '
                                 f'{files[name]}: not rank 0 alone')
    runs = {}
    for name in names:
        for r, rank in enumerate(ranks):
            launches = rank['runs'][name]['launches']
            paths[f'ddp train {DDP_CONFIG} {name} rank {r}'] = launches
            for kernel, count in launches.items():
                if (count > 0) != (kernel in DDP_KERNELS):
                    raise AssertionError(f'{kernel} launched {count} times '
                                         f'in rank {r} ({name})')
        ms = ranks[0]['runs'][name]['ms_per_step']
        runs[name] = {'ms_per_step': ms,
                      'pairs_per_s': DDP_BATCH / (ms / 1e3),
                      'step_ms_by_rank': [rk['runs'][name]['step_ms']
                                          for rk in ranks],
                      'losses_rank0': ranks[0]['runs'][name]['losses'],
                      'peak_gb_by_rank': [rk['runs'][name]['peak_gb']
                                          for rk in ranks]}
        print(f'DDP train {name}: {ms:.2f} ms per step at global batch '
              f'{DDP_BATCH}, {DDP_BATCH / (ms / 1e3):.1f} pairs/s over '
              f'{DDP_RANKS} ranks'
              + (' (two ranks sharing one card over gloo: not a scaling '
                 'number)' if shared else ''))
    for r, rank in enumerate(ranks):
        paths[f'ddp eval {CONFIG} rank {r}'] = rank['eval']['launches']
    print(f'DDP eval: mean mace {ranks[0]["eval"]["mean_mace"]} over '
          f'{ranks[0]["eval"]["samples"]} samples, the log written once')
    return {'backend': ranks[0]['backend'], 'shared_card': shared,
            'wall_s': wall_s,
            'step_check': {k: list(v) for k, v in errors.items()},
            'first_loss': first_loss,
            'runs': runs, 'eval_mace': ranks[0]['eval']['mean_mace']}


def serving_child(index, path, inputs, queue):
    """A fresh process: load the artifact at ``path``, call it twice on
    each batch of ``inputs`` (counted), then ``bench_serving`` at the
    largest batch; the outputs, whether the two calls agree bit for bit,
    the launches and the JSON line go to ``queue``."""
    import traceback

    try:
        from bihome_torch import bench_serving, serving

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        counters = kernel_counters()
        reset_counts(counters)
        predict = serving.load_exported(path)
        outs = {}
        for b, (p1, p2) in inputs.items():
            p1, p2 = p1.cuda(), p2.cuda()
            first, second = predict(p1, p2), predict(p1, p2)
            outs[b] = (first.cpu().numpy(), bool(torch.equal(first, second)))
        launches = read_counts(counters)
        line = bench_serving.main(['--artifact', path, '--batch',
                                   str(max(inputs)), '--json'])
        queue.put((index, 'ok', {'outs': outs, 'launches': launches,
                                 'bench': line}))
    except BaseException:
        queue.put((index, 'error', traceback.format_exc()))


def run_serving(paths):
    """The serving slice: pds zeng-biHomE's predict (seeded weights)
    exported on the card at a symbolic batch, its graph holding
    ``bihome::pf_head_fwd``, saved, loaded in a fresh process; at each of
    SERVING_BATCHES (a datagen batch) within SERVING_LIMIT_PX of the live
    serving function on the card and bit-identical across two calls, K1
    (and no other kernel) launched; ``bench_serving``'s JSON line at the
    largest batch."""
    from bihome_torch import config as config_lib
    from bihome_torch import serving, train
    from bihome_torch.export_model import check_batch

    cuda = torch.device('cuda')
    config = config_lib.load_config(DDP_CONFIG)
    built = config_lib.build_model(config)
    train.init_model(built)
    model = built.model.to(cuda).eval()
    begin = time.perf_counter()
    exported = serving.export_predict(built, model, 'b', device=cuda)
    export_s = time.perf_counter() - begin
    ops = serving.graph_ops(exported)
    if 'bihome.pf_head_fwd.default' not in ops:
        raise AssertionError(f'the artifact holds no bihome::pf_head_fwd: '
                             f'{ops}')
    live, _ = serving.make_serving_fn(built, model, 'b')
    p1, p2 = check_batch(built, max(SERVING_BATCHES), cuda)
    inputs, want = {}, {}
    with torch.no_grad():
        for b in SERVING_BATCHES:
            inputs[b] = (p1[:b].cpu(), p2[:b].cpu())
            want[b] = live(p1[:b], p2[:b]).cpu()
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, 'zeng.pt2')
        serving.save_exported(exported, path)
        size_mb = os.path.getsize(path) / 1e6
        shapes = serving.exported_input_shapes(path)
        child, = spawn_and_collect(serving_child,
                                   lambda i: (i, path, inputs), 1)
    errs = {}
    for b in SERVING_BATCHES:
        got, same = child['outs'][b]
        got = torch.from_numpy(got)
        errs[b] = float((got - want[b]).abs().max())
        print(f'serving artifact at batch {b}: max |artifact - live| '
              f'{errs[b]:.3e} px (limit {SERVING_LIMIT_PX:g}), two calls '
              f'bit-identical: {same}')
        if not (got.shape == (b, 4, 2) and errs[b] <= SERVING_LIMIT_PX
                and same):
            raise AssertionError(f'the artifact at batch {b} strays from '
                                 f'the live predict ({errs[b]}) or is not '
                                 f'deterministic ({same})')
    launches = child['launches']
    paths['serving artifact'] = launches
    if launches['fused_pf_head_fwd'] == 0 or any(
            count for name, count in launches.items()
            if name != 'fused_pf_head_fwd'):
        raise AssertionError(f'the artifact launched {launches}, not K1 '
                             'alone')
    print(f'serving: exported in {export_s:.1f} s, {size_mb:.1f} MB, inputs '
          f'{shapes}; launches in the fresh process {launches}')
    return {'export_s': export_s, 'size_mb': size_mb, 'err_px': errs,
            'bench': child['bench']}


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing run', file=sys.stderr)
        return 2
    with contextlib.ExitStack() as stack:
        return run(stack)


def run(stack):
    """Every phase; ``stack`` holds the file data's temporary directory
    and its writer processes, which it removes and stops at the end."""
    from bihome_torch.ops import _cuda, fused_head, warp

    # The file data of the file-fed phases, written by worker processes
    # (forked before this process touches the card) while the kernels
    # build and the phases before run.
    data_root = stack.enter_context(tempfile.TemporaryDirectory(
        prefix='bihome_files_'))
    jpeg_dir, pack_dir = (os.path.join(data_root, name)
                          for name in ('jpeg', 'pack'))
    os.makedirs(jpeg_dir)
    workers = min(8, os.cpu_count() or 1)
    writer = stack.enter_context(concurrent.futures.ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context('fork')))
    chunk = -(-FILE_IMAGES // workers)
    jpeg_jobs = [writer.submit(_write_jpeg_chunk, jpeg_dir, start,
                               min(chunk, FILE_IMAGES - start))
                 for start in range(0, FILE_IMAGES, chunk)]

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {torch.cuda.get_device_name(0)}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f'allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} '
          f'cudnn={torch.backends.cudnn.allow_tf32}')

    begin = time.perf_counter()
    phase_s = {}
    mark = [begin]

    def done(phase):
        """Record the wall time since the last phase ended."""
        now = time.perf_counter()
        phase_s[phase] = round(now - mark[0], 1)
        mark[0] = now
        print(f'phase {phase}: {phase_s[phase]} s')

    # The seeded synthetic images of ``--synthetic`` are the same in every
    # run of one image size: make each set once.
    from bihome_torch.data import synthetic
    make_image_pool, made = synthetic.make_image_pool, {}

    def cached_image_pool(*args, **kwargs):
        key = (args, tuple(sorted(kwargs.items())))
        if key not in made:
            made[key] = make_image_pool(*args, **kwargs)
        return made[key]
    synthetic.make_image_pool = cached_image_pool
    stack.callback(setattr, synthetic, 'make_image_pool', make_image_pool)

    k3_fault = start_k3_fault_build(stack)
    logs = _cuda.build(['warp', 'fused_head'])
    k3_fault_lib = k3_fault.result()
    print(f'built {sorted(logs)}')
    for name, log in logs.items():
        for line in log.splitlines():
            if ('entry function' in line or 'registers' in line
                    or 'spill' in line or 'wgmma' in line):
                print(f'  {name}: {line.strip()}')
    done('build')

    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(0)
    kernels = [check_warp(dev, gen), check_pf_head(dev, gen),
               check_pf_head_bwd(dev, gen)]
    k3_loss_warp, bwd_kernels = check_warp_bwd(dev, gen)
    kernels[0]['at_loss_warp'] = k3_loss_warp
    # K3 at the datagen windows of the batch-128 configs.
    kernels[0]['at_datagen_128'] = {
        k: v for k, v in check_warp(dev, torch.Generator().manual_seed(128),
                                    128).items()
        if k not in ('name', 'route', 'source', 'replaces')}
    kernels[0]['max_abs_err'] = max(kernels[0]['max_abs_err'],
                                    kernels[0]['at_datagen_128']['max_abs_err'])
    kernels += bwd_kernels
    # The bf16 kernels draw from a generator of their own, so the phases
    # after them get the draws they got before the bf16 slice.
    gen_bf16 = torch.Generator().manual_seed(12)
    kernels += [check_pf_head_bf16(dev, gen_bf16),
                check_pf_head_bwd_bf16(dev, gen_bf16)]
    done('kernel checks')
    counters = kernel_counters()
    paths = {}
    paths['eval'], _, _ = run_eval_path(counters)
    with tempfile.TemporaryDirectory() as log_dir:
        paths['train'], result = run_train_path(counters, log_dir)
    compare_train_step(result)
    del result
    done('zeng eval, train, step check')
    predict_extras = {}
    for name, sets in PREDICT_EXTRAS.items():
        paths[f'eval {CONFIG} {name}'], result, pairs_per_s = run_eval_path(
            counters, CONFIG, BATCH, PDS_STEPS, sets=sets, check_pairs=4)
        predict_extras[name] = {'model_ms': result['per_batch_ms'],
                                'pairs_per_s': pairs_per_s,
                                'mean_mace': result['mean_mace'],
                                'delta_err_px': result['delta_err']}
        del result
    print(f'predict extras (S-COCO zeng-biHomE at {BATCH}): '
          f'{json.dumps(predict_extras)}')
    done('predict extras')

    # The PDS slice: K3 and K4 at the PhotometricHead's shape, the
    # distortion on the card, the train runs of PDS_RUNS with the one-step
    # checks of STEP_CHECKS, the eval of pds-coco/detone-orig.
    kernels[0]['at_photometric_head'], kernels[3]['at_photometric_head'] = (
        check_warp_nguyen(dev, gen))
    pds_check = check_pds(dev, gen)
    runs = []
    for config, batch, expect in PDS_RUNS:
        with tempfile.TemporaryDirectory() as log_dir:
            paths[f'train {config}'], result = run_train_path(
                counters, log_dir, config, batch, PDS_STEPS, expect)
        runs.append(result['summary'])
        if (config, batch) == (DDP_CONFIG, DDP_BATCH):
            # What the --multihost run's first logged loss is held to.
            one_process_loss = float(result['losses'][0])
        if config == FILE_CONFIG:
            # The device-pool row beside the file-fed runs below.
            file_runs = [dict(result['summary'],
                              profile=profile_feed(result))]
        if config in STEP_CHECKS:
            compare_train_step(result, STEP_CHECK_BATCH, ('K4 du negated',))
        del result
    detone = PDS_RUNS[1]
    paths[f'eval {detone[0]}'], _, _ = run_eval_path(
        counters, detone[0], detone[1], STEPS, detone[2])
    done('PDS slice')

    # The ResNet50-flavour slice: K1 and K2 at the wide head, zeng-biHomE
    # with the ResNet50-flavour backbone (eval, train, the one-step check
    # with both planted faults), then the zhang runs.
    for k, check in ((kernels[1], check_pf_head), (kernels[2],
                                                   check_pf_head_bwd)):
        k['at_r50_head'] = {
            key: v for key, v in check(dev, gen, 64, 512).items()
            if key not in ('name', 'route', 'source', 'replaces')}
    done('wide kernel checks')
    r50 = f'{CONFIG} + {R50_SET[0]}'
    paths[f'eval {r50}'], _, _ = run_eval_path(
        counters, CONFIG, BATCH, PDS_STEPS,
        ('bilinear_sample_batched', 'fused_pf_head_fwd_wide'), R50_SET, 4)
    with tempfile.TemporaryDirectory() as log_dir:
        paths[f'train {r50}'], result = run_train_path(
            counters, log_dir, CONFIG, BATCH, PDS_STEPS, R50_KERNELS,
            R50_SET)
    runs.append(result['summary'])
    compare_train_step(result, batch=R50_STEP_BATCH)
    del result
    done('R50 zeng eval, train, step check')
    for config in ZHANG_RUNS:
        with tempfile.TemporaryDirectory() as log_dir:
            paths[f'train {config}'], result = run_train_path(
                counters, log_dir, config, BATCH, PDS_STEPS, WARP_KERNELS)
        runs.append(result['summary'])
        if config in STEP_CHECKS:
            compare_train_step(result, STEP_CHECK_BATCH, ('K4 du negated',))
        del result
        paths[f'eval {config}'], _, _ = run_eval_path(
            counters, config, BATCH, PDS_STEPS, ('bilinear_sample_batched',),
            check_pairs=4)
    done('zhang train, eval, step check')

    # The bf16 slice: bench.py's four PDS configs trained at bf16 at its
    # batches, beside their float32 runs above; the one bf16 step check
    # after zeng-biHomE's; the bf16 evals.
    bf16_runs, bf16_evals = [], {}

    def bf16_train(config, batch, expect, sets=()):
        """A train run at bf16, its row beside the float32 row of this
        call (the same config, batch and overrides)."""
        with tempfile.TemporaryDirectory() as log_dir:
            paths[f'train {" ".join((config, *sets))} bf16'], result = (
                run_train_path(counters, log_dir, config, batch, PDS_STEPS,
                               expect, sets, extra=('--dtype', 'bfloat16')))
        row = result['summary']
        f32 = next(r for r in runs if r['dtype'] == 'float32' and (
            r['config'], r['batch'], r['sets']) == (config, batch,
                                                    list(sets)))
        row['float32'] = {k: f32[k] for k in ('ms_per_step', 'pairs_per_s',
                                              'peak_gb')}
        bf16_runs.append(row)
        print(f'{config} {list(sets)} at {batch}: bf16 '
              f'{row["ms_per_step"]:.2f} ms per step, '
              f'{row["pairs_per_s"]:.1f} pairs/s, peak {row["peak_gb"]:.2f} '
              f'GB; float32 (this call) {f32["ms_per_step"]:.2f} ms, '
              f'{f32["pairs_per_s"]:.1f} pairs/s, {f32["peak_gb"]:.2f} GB')
        return result

    for config, batch, expect in BF16_RUNS:
        result = bf16_train(config, batch, expect)
        if config == BF16_RUNS[0][0]:
            bf16_step = compare_train_step_bf16(result)
        del result
    for config, batch, expect in BF16_EVALS:
        paths[f'eval {config} bf16'], result, _ = run_eval_path(
            counters, config, batch, PDS_STEPS, expect,
            ('MODEL.DTYPE=bfloat16',), check_pairs=4)
        bf16_evals[config] = result['bf16_predict']
        del result
    done('bf16 train, step check, eval')

    # The zeng-orig and CLEVR-Change slice: the narrow K1 and K2 at
    # zeng-orig's OneLine shape (64 images), K3 and K4 at the CLEVR
    # TripletHead's; the PDS zeng-orig train run and its step check, the
    # S-COCO zeng-orig eval (RANSAC), the CLEVR train run and its check.
    kernels[1]['at_zeng_orig'], kernels[2]['at_zeng_orig'] = (
        {key: v for key, v in entry.items()
         if key not in ('name', 'route', 'source', 'replaces')}
        for entry in (check_pf_head(dev, gen, 16, 128, BATCH),
                      check_pf_head_bwd(dev, gen, 16, 128, BATCH)))
    kernels[0]['at_clevr'], kernels[3]['at_clevr'] = check_warp_clevr(dev,
                                                                      gen)
    done('zeng-orig and CLEVR kernel checks')
    with tempfile.TemporaryDirectory() as log_dir:
        paths[f'train {ZENG_ORIG[0]}'], result = run_train_path(
            counters, log_dir, ZENG_ORIG[0], BATCH, PDS_STEPS,
            ZENG_ORIG_KERNELS)
    runs.append(result['summary'])
    compare_train_step(result, 4, ('K2 dw1 zeroed',))
    del result
    paths[f'eval {ZENG_ORIG[1]}'], zeng_orig_eval = run_ransac_eval_path(
        counters)
    done('zeng-orig train, step check, eval')
    with tempfile.TemporaryDirectory() as log_dir:
        paths[f'train {CLEVR}'], result = run_train_path(
            counters, log_dir, CLEVR, BATCH, PDS_STEPS, WARP_KERNELS)
    runs.append(result['summary'])
    compare_train_step(result, CLEVR_STEP_BATCH, ('K4 du negated',))
    del result
    done('CLEVR train, step check')

    # The bf16 slice of every config: K1 and K2 bf16 at the R50 head, from
    # a generator of their own (the phases before keep their draws); the
    # configs of BF16_EVERY_RUNS trained at bf16 beside their float32 rows
    # above, R50 zeng's step from its PF-head input; the bf16 evals of R50
    # zeng (the wide K1 bf16) and S-COCO zeng-orig (RANSAC on the bf16
    # field).
    gen_every = torch.Generator().manual_seed(13)
    kernels += [check_pf_head_bf16(dev, gen_every, 2 * BATCH, 64, 512),
                check_pf_head_bwd_bf16(dev, gen_every, 2 * BATCH, 64, 512)]
    done('wide bf16 kernel checks')
    for config, batch, expect, sets in BF16_EVERY_RUNS:
        result = bf16_train(config, batch, expect, sets)
        if sets == R50_SET:
            built = result['built']
            bf16_step['r50_tail'] = compare_tail_step_bf16(
                result, built, result['initial_state'],
                step_data(built, R50_STEP_BATCH), BF16_R50_TAIL)
        del result
    done('bf16 train of every config, R50 step check')
    paths[f'eval {r50} bf16'], result, _ = run_eval_path(
        counters, CONFIG, BATCH, PDS_STEPS,
        ('bilinear_sample_batched', 'fused_pf_head_fwd_wide_bf16'),
        R50_SET + ('MODEL.DTYPE=bfloat16',), check_pairs=4)
    bf16_evals[r50] = result['bf16_predict']
    del result
    paths[f'eval {ZENG_ORIG[1]} bf16'], bf16_evals[ZENG_ORIG[1]] = (
        run_ransac_eval_path(counters, expect=('fused_pf_head_fwd_bf16',
                                               'bilinear_sample_batched'),
                             sets=('MODEL.DTYPE=bfloat16',)))
    done('bf16 evals of R50 zeng and zeng-orig')

    # The K5 slice, from a generator of its own: K3, K4 and K5 at the shapes
    # of the paths that run K5; those paths (K5_RUNS), counted; the one-step
    # check of zhang-biHomE with learned masks and upsample-patch-2x (K5 on
    # both of its paths) with K5_FAULTS planted; the other variants of the
    # biHomE loss (VARIANT_RUNS).
    for name, (k3, k4, k5) in check_warp_k5_paths(
            dev, torch.Generator().manual_seed(17)).items():
        kernels[0][f'at_{name}'], kernels[4][f'at_{name}'] = k3, k5
        if k4 is not None:
            kernels[3][f'at_{name}'] = k4
    done('K5 kernel checks')
    # K3's C > 1 kernels beside image_2, from a generator of its own: the
    # RGB window warp, and K3_FAULT planted at C = 3 and C = 2.
    kernels[0]['at_rgb_window'] = check_warp_k3_rgb(
        dev, torch.Generator().manual_seed(22), k3_fault_lib)
    done('K3 C > 1 checks')
    k5_runs = []
    for config, sets, expect, dtype in K5_RUNS:
        with tempfile.TemporaryDirectory() as log_dir:
            paths[f'train {" ".join((config, *sets))} {dtype}'], result = (
                run_train_path(counters, log_dir, config, BATCH, PDS_STEPS,
                               expect, sets, extra=('--dtype', dtype)))
        k5_runs.append(result['summary'])
        if (config, sets, dtype) == (ZHANG_BIHOME, MASK_KEYS, 'float32'):
            upsampled = copy.deepcopy(result['built'].config)
            upsampled['MODEL']['HEAD']['SAMPLING_STRATEGY'] = (
                'upsample-patch-2x')
            k5_step = compare_train_step(result, 4, K5_FAULTS, upsampled)
        del result
    done('K5 train, step check')
    variant_runs = {}
    for name, sets in VARIANT_RUNS.items():
        with tempfile.TemporaryDirectory() as log_dir:
            paths[f'train {ZHANG_BIHOME} {name}'], result = run_train_path(
                counters, log_dir, ZHANG_BIHOME, BATCH, VARIANT_STEPS,
                WARP_KERNELS, sets)
        variant_runs[name] = result['summary']
        del result
    done('biHomE loss variants')

    # The DSAC slice, from a generator of its own: K3 and K4 at the loss
    # warp of n = DSAC_N hypotheses and K3 at image_2, the datagen
    # leftovers on the card against the CPU, then the runs of
    # run_dsac_slice.
    dsac, at_n4, at_image_2 = run_dsac_slice(
        counters, paths, dev, torch.Generator().manual_seed(19))
    kernels[0]['at_dsac_n4'], kernels[3]['at_dsac_n4'] = at_n4
    kernels[0]['at_image_2'] = at_image_2
    done('DSAC, HomographyNet, datagen leftovers')

    # The file-fed slice: the JPEG folder and its pack; pds-coco
    # zeng-biHomE trained from each (streamed, counted as the other train
    # paths, profiled for the idle share beside the device-pool run of
    # the PDS slice); resume on the card from the pack; the S-COCO eval
    # from the JPEG folder with the resumed checkpoint and --log.
    file_data = finish_file_data(jpeg_jobs, jpeg_dir, pack_dir)
    done('file data')
    from bihome_torch.data import datasets
    from bihome_torch.data.pack import PackDataset
    for name, split in (('JPEG folder', jpeg_dir), ('pack', pack_dir)):
        sets = (f'DATA.TRAIN_SPLIT={split}', f'DATA.TEST_SPLIT={split}')
        with tempfile.TemporaryDirectory() as log_dir:
            paths[f'train {FILE_CONFIG} from the {name}'], result = (
                run_train_path(counters, log_dir, FILE_CONFIG, BATCH,
                               PDS_STEPS, ZENG_KERNELS, sets,
                               synthetic=False, extra=('--feed', 'stream')))
        dataset = result['train_feed'].loader.dataset
        want = PackDataset if name == 'pack' else datasets.ImageFolderDataset
        native = getattr(dataset, 'native', None)
        if not (isinstance(dataset, want) and native in (None, True)):
            raise AssertionError(f'the {name} run read {feed_name(result)}'
                                 f' (native reader: {native})')
        file_runs.append(dict(result['summary'],
                              profile=profile_feed(result)))
        del result
    done('file-fed train')
    # The pool from the pack too: its pools take one native gather, so the
    # refresher's decode does not contend with the loop's host work.
    for name, split in (('JPEG folder', jpeg_dir), ('pack', pack_dir)):
        pool_run = run_pool_path(counters, split, name)
        paths[f'train {FILE_CONFIG} through the pool of the {name}'] = (
            pool_run.pop('launches'))
        file_runs.append(pool_run)
    done('file-fed pool train')
    paths[f'resume {FILE_CONFIG} from the pack'], resume_dir, resume = (
        run_resume(counters, pack_dir))
    done('resume')
    log_path = os.path.join(data_root, 'mace.log')
    paths[f'eval {CONFIG} from the JPEG folder'], eval_result, _ = (
        run_eval_path(counters, CONFIG, BATCH, PDS_STEPS,
                      sets=(f'DATA.TEST_SPLIT={jpeg_dir}',), check_pairs=4,
                      synthetic=False,
                      extra=('--ckpt', resume_dir, '--log', log_path)))
    check_eval_log(log_path, BATCH * PDS_STEPS)
    done('file-fed eval')

    # The data-parallel slice (spawned ranks) and the serving slice (the
    # artifact loaded in a spawned process).
    torch.cuda.empty_cache()
    ddp = run_ddp_slice(paths, one_process_loss,
                        dsac['leftover_first_loss'])
    done('DDP slice')
    served = run_serving(paths)
    done('serving')

    # The pretext and extractor slice, from a generator of its own: K3 at
    # warp_gt's shape, the pretext runs, their step check, pds zeng-biHomE
    # from the gradpdscl file and with a resnet50 extractor.
    pretrain, kernels[0]['at_warp_gt'] = run_pretrain_slice(
        counters, paths, runs, dev, torch.Generator().manual_seed(20))
    done('pretext and extractor slice')
    for row in file_runs:
        prof = row['profile']
        print(f'{row["config"]} at {row["batch"]} from {row["feed"]}: '
              f'{row["ms_per_step"]:.2f} ms per step ({row["pairs_per_s"]:.1f}'
              f' pairs/s), waits {row["wait_ms_per_step"]:.2f} ms per step, '
              f'peak {row["peak_gb"]:.2f} GB; profiled: host '
              f'{prof["host_ms_per_step"]:.2f} ms, device '
              f'{prof["device_ms_per_step"]:.2f} ms, waits '
              f'{prof["wait_ms_per_step"]:.2f} ms per step, idle share '
              f'{prof["idle_share"]:.3f}')

    # Launches by path; an entry at one shape counts the paths that run it.
    shape_paths = {'at_zeng_orig': [p for p in paths if 'zeng-orig' in p],
                   'at_clevr': [p for p in paths if 'clevr' in p],
                   'at_upsample_2x': [p for p in paths
                                      if 'upsample-patch-2x' in p],
                   'at_upsample_4x': [p for p in paths
                                      if 'upsample-patch-4x' in p],
                   'at_masked_loss_warp': [p for p in paths
                                           if 'MASK_KEYS' in p],
                   'at_dsac_n4': [p for p in paths if p.startswith('train')
                                  and DSAC_SET[0] in p],
                   'at_image_2': [p for p in paths if '--vis' in p],
                   'at_rgb_window': [p for p in paths
                                     if 'PhotometricDistort' in p
                                     or (p.startswith('ddp train')
                                         and ' blob ' in p)],
                   'at_warp_gt': [p for p in paths
                                  if p.startswith('pretrain')]}
    for k in kernels:
        entries = [(k, k['name'], list(paths))]
        if 'at_r50_head' in k:
            entries.append((k['at_r50_head'], f'{k["name"]}_wide',
                            list(paths)))
        entries += [(k[at], k['name'], names)
                    for at, names in shape_paths.items() if at in k]
        for entry, counter, names in entries:
            by_path = {path: paths[path][counter] for path in names}
            entry['launches'] = sum(by_path.values())
            entry['launches_by_path'] = by_path
    generic = {path: counts['bilinear_sample_batched_generic']
               for path, counts in paths.items()}
    kernels[0]['generic_launches'] = sum(generic.values())
    print(f'K3 generic launches (the loop over any C > 1 or the generic '
          f'form) over the {len(paths)} paths: {sum(generic.values())}')
    if any(generic.values()):
        raise AssertionError(f'K3 took a generic kernel on '
                             f'{[p for p, k in generic.items() if k]}')
    print(f'chip_smoke: all checks passed in '
          f'{time.perf_counter() - begin:.1f} s')
    print(json.dumps({'pds_distortion': pds_check, 'train_runs': runs,
                      'zeng_orig_eval': zeng_orig_eval,
                      'file_data': file_data, 'file_runs': file_runs,
                      'resume': resume, 'file_eval_mace':
                      eval_result['mean_mace'], 'bf16_runs': bf16_runs,
                      'bf16_step': bf16_step, 'bf16_evals': bf16_evals,
                      'predict_extras': predict_extras,
                      'k5_runs': k5_runs, 'k5_step': k5_step,
                      'variant_runs': variant_runs, 'dsac': dsac,
                      'ddp': ddp, 'serving': served,
                      'pretrain': pretrain, 'phase_s': phase_s}))
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
