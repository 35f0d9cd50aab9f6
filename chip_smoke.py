#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bihome_torch) on one NVIDIA H100.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), torch and CUDA
   versions, and turns TF32 off for matmuls and cuDNN convolutions.
2. Builds every CUDA kernel (K1-K5) from bihome_torch/csrc with nvcc (in
   parallel, into build/kernels/) and prints the build time and, per
   kernel (by its mangled name), ptxas's registers and spills.
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
5. Drives the port's train entry point (the same config at full width,
   batch 64, 4 steps, the extractor from aux_clfbh.npz), counted the same
   way; fails unless K1-K4 launched (K5 not), the loss is finite every
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
   (streamed: decoded by the loader's producer thread, or gathered by the
   native reader, which must be the one in use; copied to the card through
   pinned memory), counted (exactly K1-K4) and checked as in step 5; each
   prints ms per step, pairs/s, peak memory and the loop's wait for its
   batch, and PDS_STEPS more steps of each, and of the device-pool run of
   step 9, are profiled for the device's idle share. Resume on the card
   from the pack (``run_resume``): B, one epoch then resumed to two in
   its LOGGING.DIR, must start at step RESUME_STEPS with optimizer count
   RESUME_STEPS and match A's two epochs without a stop within
   RESUME_REL_L2 relative L2 (epoch-1 losses, each backbone tensor; with
   cuDNN's deterministic algorithms if the default ones miss it). The
   S-COCO zeng-biHomE eval reads the JPEG folder with ``--ckpt`` on B's
   directory and ``--log``: K1 and K3 only, finite MACE, delta_hat against
   the CPU plain path (first 4 pairs) within 1e-2 px, one log line per
   sample. Every other eval phase runs with an empty LOGGING.DIR, so its
   weights are the seeded init.
14. Prints each phase's wall time, one {"pds_distortion": ...,
   "train_runs": [...], "zeng_orig_eval": {...}, "file_data": {...},
   "file_runs": [...], "resume": [...], "file_eval_mace": x,
   "phase_s": {...}} line,
   one {"kernels": [...]} line (launches summed over every path above,
   and by path; K1 and K2 with their wide kernels' figures and launches
   under "at_r50_head" and at zeng-orig's shape under "at_zeng_orig", K3
   and K4 at the CLEVR shape under "at_clevr", each with the launches of
   the paths that run that shape), then as the last line {"ok": true,
   "device": {...}}.

Any failed check raises, so the script exits non-zero. Without a CUDA
device it exits non-zero before printing any result.
"""

import concurrent.futures
import contextlib
import copy
import itertools
import json
import math
import multiprocessing
import os
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
# the PhotometricHead's warp of the full image). K5 runs on no shipped
# config: every warped source is data.
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
# (FILE_CONFIG) trains from each at batch 64, streamed; it resumes on the
# card from the pack (RESUME_STEPS steps an epoch, the resumed run held
# to the uninterrupted one within RESUME_REL_L2 relative L2 per tensor);
# the S-COCO eval reads the JPEG folder with the resumed checkpoint.
FILE_IMAGES = 512
FILE_HW = (480, 640)
FILE_SEED = 11
JPEG_QUALITY = 90
FILE_CONFIG = 'config/pds-coco/zeng-bihome-lr-1e-3.yaml'
RESUME_STEPS = 2
RESUME_REL_L2 = 1e-4


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
    uniforms = torch.rand((batch_size, 128),
                          generator=torch.Generator().manual_seed(5))
    delta_cuda = model.predict(batch, uniforms=uniforms.cuda()).cpu()
    batch_cpu = {key: v[:k].cpu() for key, v in batch.items()}
    with one_cpu_thread():
        delta_cpu = model_cpu.predict(batch_cpu, uniforms=uniforms[:k])
    err = (delta_cuda[:k] - delta_cpu).abs().max().item()
    print(f'delta_hat CUDA vs CPU plain path, batch 0 (first {k} pairs): '
          f'max abs err {err:.3e} px (max |delta_hat| '
          f'{delta_cpu.abs().max().item():.2f}; tolerance 1e-2 px)')
    if not (delta_cuda.shape == (batch_size, 4, 2) and err <= 1e-2):
        raise AssertionError(f'CUDA predict disagrees with CPU: {err}')
    return launches, result, pairs_per_s


def run_ransac_eval_path(counters, config=ZENG_ORIG[1], batch_size=BATCH,
                         steps=PDS_STEPS):
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
    empty directory: the weights are the seeded init."""
    from bihome_torch import eval as teval
    from bihome_torch.heads import ransac

    reset_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as empty:
        result = teval.main(['--config_file', config, '--synthetic',
                             '--batch_size', str(batch_size), '--steps',
                             str(steps), '--device', 'cuda', '--set',
                             f'LOGGING.DIR={empty}'])
    launches = read_counts(counters)
    eval_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f'launches on the eval path of {config} (batch {batch_size}, '
          f'{steps} steps): {launches}')
    expect = ('fused_pf_head_fwd', 'bilinear_sample_batched')
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
    with one_cpu_thread(), torch.inference_mode():
        pf_cpu = cpu.backbone({k: v.cpu() for k, v in batch.items()})[key]
        fit_cpu = ransac.ransac_fit(*ransac.field_points(pf_cpu), idx=idx)
        delta_cpu = ransac.fit_to_delta(fit_cpu, pf_cpu.shape)
    counts_card = fit_card.counts.cpu()
    same_best = fit_card.best.cpu() == fit_cpu.best
    same_count = counts_card.amax(-1) == fit_cpu.counts.amax(-1)
    same_inliers = same_best & (fit_card.inliers.cpu()
                                == fit_cpu.inliers).all(-1)
    err = (delta_card - delta_cpu).abs().amax(dim=(1, 2))
    err_match = float(err[same_inliers].max()) if same_inliers.any() else 0.0
    differ = int((~(same_best & same_count)).sum())
    hyps_differ = int((counts_card != fit_cpu.counts).sum())
    print(f'RANSAC delta_hat CUDA vs CPU plain path, batch 0 ({batch_size} '
          f'pairs, mean |pf| {float(pf_cpu.abs().mean()):.2f} px, the same '
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
    summary = {'config': config, 'batch': batch_size,
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
    on a small C = 3 case with a third of the points outside. Returns K3's
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
    print(f'K5 warp image gradient: error / max|ref| {err5:.2e} (C=1), '
          f'{err5c3:.2e} (C=3, out-of-bounds points); tolerance 1e-4 '
          f'(atomics add in no fixed order)')
    if not (err5 <= 1e-4 and err5c3 <= 1e-4):
        raise AssertionError(f'warp image-gradient kernel disagrees: '
                             f'{err5}, {err5c3}')

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
    print(f'K5 times (ms): kernel {ms5:.4f} (with zeroing dimg)  plain '
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
              max_rel_err=max(err5, err5c3), ms=ms5, plain_ms=plain5,
              bound_ms=b5, bound_by=by5, library_ms=lib5, host_us=host5)
    return k3, [k4, k5]


def _touched_pixels(u, v, h, w):
    """Pixels, over all images, that some in-bounds tap of the points
    [N,P] reads: what a warp must read of its source on these points."""
    from bihome_torch.ops import warp

    _, taps = warp._taps(h, w, u, v)
    offset = torch.arange(u.shape[0], device=u.device)[:, None] * (h * w)
    seen = torch.zeros(u.shape[0] * h * w, dtype=torch.bool, device=u.device)
    for idx, valid, _ in taps:
        seen[(idx + offset)[valid]] = True
    return int(seen.sum())


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
    touched = _touched_pixels(u, v, h, w)
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
                   steps=STEPS, expect=ZENG_KERNELS, sets=(), synthetic=True):
    """The port's train entry point on the card (config overrides
    ``sets``; the synthetic pool on the device unless ``synthetic`` is
    off, then the splits the config or ``sets`` name, streamed), counted:
    the kernels in ``expect`` must launch and the others in ``counters``
    must not."""
    from bihome_torch import train

    reset_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    args = ['--config_file', config, '--batch_size', str(batch), '--steps',
            str(steps), '--epochs', '1', '--device', 'cuda', '--set',
            'MODEL.HEAD.AUXILIARY_RESNET_PATH=aux_clfbh.npz', '--set',
            f'LOGGING.DIR={log_dir}']
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
    aux_keys = [k for k in final if k.startswith('auxiliary_resnet.')]
    aux_same = all(torch.equal(final[k].cpu(), initial[k]) for k in aux_keys)
    print(f'moved: {len(params & set(moved))}/{len(params)} backbone '
          f'parameters, {len(stats & set(moved))}/{len(stats)} BN running '
          f'statistics; frozen extractor bitwise unchanged: '
          f'{aux_same if aux_keys else "(no extractor)"}')
    if not (params & set(moved) and stats & set(moved) and aux_same):
        raise AssertionError('training did not move the backbone, or moved '
                             'the frozen extractor')
    step_ms = result['median_step_ms']
    wait_ms = result['median_wait_ms']
    pairs_per_s = batch / (step_ms / 1e3)
    print(f'train {config}: {step_ms:.2f} ms per step (median of steps '
          f'2-{steps}, each ended by a synchronize; all: '
          f'{[round(t, 2) for t in result["step_ms"]]}), pairs/s '
          f'{pairs_per_s:.1f}, peak memory allocated {peak_gb:.2f} GB; the '
          f'loop waited {wait_ms:.2f} ms per step for its batch (median of '
          f'steps 2-{steps}; all: {[round(t, 2) for t in result["wait_ms"]]})'
          f', {batch / ((step_ms + wait_ms) / 1e3):.1f} pairs/s with the '
          f'wait')
    result['summary'] = {'config': config, 'sets': list(sets),
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


def one_step_grads(built, state, data, device, dtype=torch.float32):
    """Loss and backbone gradients (float64, on the CPU) of one conditioned
    training step from ``state`` on ``device`` in ``dtype``; ``data`` =
    (uint8 pool rows, corners, delta, the photometric draws (pd1, pd2),
    DSAC uniforms or None). No optimizer."""
    from bihome_torch import config as config_lib
    from bihome_torch.data import pipeline
    from bihome_torch.training import losses

    pool, corners, delta, pds, uniforms = data
    model = config_lib.build_model(built.config).model
    model.load_state_dict(state)
    _condition(model)
    model = model.to(device=device, dtype=dtype).train()
    batch = pipeline.generate_pairs(pool.to(device), built.pair_spec,
                                    corners=corners, delta=delta,
                                    photometric_params=pds)
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
    # gradient is 0 analytically under batch statistics.
    return loss.item(), scale, {n: p.grad.cpu().double() for n, p in
                                model.backbone.named_parameters()
                                if n != 'layer8.0.bias'}


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
    check catches it: K4's du negated, or K2's dw1 zeroed."""
    from bihome_torch.ops import fused_head as fh
    from bihome_torch.ops import warp

    if name == 'K4 du negated':
        owner, attr = warp.BilinearSample, 'backward'

        def spoiled(ctx, g):
            dimg, du, dv = original(ctx, g)
            return dimg, -du, dv
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


def compare_train_step(result, batch=4, faults=FAULTS):
    """One step's loss and backbone gradients on the card (float32)
    against the plain path on the CPU in float64: the run's initial
    weights, conditioned (``_condition``), the same pairs, photometric
    draws (PDS) and DSAC draws; no optimizer. Then the card's step again
    under each planted fault, which must fail the same limits: the loss
    within STEP_LOSS of the sum of its terms' magnitudes (of the loss
    itself for a tensor loss), the gradients within STEP_L2 relative L2
    over all tensors and within STEP_PER_TENSOR relative L2 for every
    tensor."""
    from bihome_torch import train
    from bihome_torch.data import datasets, pipeline

    built, state = result['built'], result['initial_state']
    gen = torch.Generator().manual_seed(7)
    if built.pair_spec.change_aware_keys:
        # CLEVR-Change: (original, changed) pairs, nothing drawn.
        pool = torch.from_numpy(train.make_pools(
            built.config, (320, 240), batch, batch)[0][:batch])
        corners = delta = pds = None
    else:
        pool = torch.from_numpy(datasets.SyntheticDataset(seed=2).pool[:batch])
        corners, delta = pipeline.draw_corners_delta_batch(
            batch, tuple(pool.shape[1:3]), built.pair_spec, gen)
        pds = pipeline._draw_photometric(batch, built.pair_spec, gen)
    uniforms = ([torch.rand((batch, 128), generator=gen) for _ in range(2)]
                if built.needs_dsac_rng else None)
    data = (pool, corners, delta, pds, uniforms)
    cuda, cpu = torch.device('cuda'), torch.device('cpu')

    with one_cpu_thread():
        ref = one_step_grads(built, state, data, cpu, torch.float64)
    runs = {'card': one_step_grads(built, state, data, cuda)}
    for fault in faults:
        with planted_fault(fault):
            runs[fault] = one_step_grads(built, state, data, cuda)
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


def feed_name(result):
    """'pool', or the dataset class a streamed train run read."""
    from bihome_torch.data import datasets

    feed = result['train_feed']
    if not hasattr(feed, 'loader'):
        return 'pool'
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
    finished train run (its model, optimizer and split; a fresh feed of
    ``steps`` + 1 batches, the first step outside the window), each ended
    by a synchronize as in the train loop, under torch.profiler: device
    kernel ms per step and 1 - device / host window."""
    from bihome_torch import train
    from bihome_torch.training import trainer

    built, args = result['built'], result['args']
    device = next(result['model'].parameters()).device
    feed, _ = train.make_feeds(built.config, built, args, device,
                               result['batch_size'], steps + 1, 0, 0, 0)
    gen, dsac_gen = (torch.Generator().manual_seed(s) for s in (0, 1))
    waits = []
    batches = train.timed(feed.epoch(), waits)

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
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    out = {'host_ms_per_step': wall_ms / steps,
           'device_ms_per_step': device_ms / steps,
           'launches_per_step': sum(e.count for e in kernels) / steps,
           'idle_share': 1 - device_ms / wall_ms,
           'wait_ms_per_step': sum(waits[1:]) / steps}
    print(f'profiled {steps} steps of {feed_name(result)}: host '
          f'{out["host_ms_per_step"]:.2f} ms, device kernels '
          f'{out["device_ms_per_step"]:.2f} ms in '
          f'{out["launches_per_step"]:.0f} launches, waits '
          f'{out["wait_ms_per_step"]:.2f} ms per step; device idle share '
          f'{out["idle_share"]:.3f}')
    return out


def _rel_l2(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    norm = float(torch.linalg.vector_norm(want))
    return float(torch.linalg.vector_norm(got - want)) / max(norm, 1e-30)


def run_resume(counters, pack_dir, steps=RESUME_STEPS):
    """Resume on the card (FILE_CONFIG at batch 64 from the pack): run A
    trains 2 epochs of ``steps`` steps; run B one epoch, then the same
    command with --epochs 2 in its LOGGING.DIR. B must resume at epoch 1,
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
                '--set', f'DATA.TEST_SPLIT={pack_dir}'])

        whole = run(dirs[0], 2)
        first = run(dirs[1], 1)
        resumed = run(dirs[1], 2)
        launches = read_counts(counters)
        saved = torch.load(first['checkpoint'], weights_only=True)
        if not (resumed['start_step'] == steps
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

    logs = _cuda.build(['warp', 'fused_head'])
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
    done('kernel checks')
    # Each kernel's launch counter: K1 and K2 count their narrow (Cin 16)
    # and wide (Cin 64) kernels apart.
    counters = {
        'bilinear_sample_batched': (warp.bilinear_sample_batched, 'launches'),
        'fused_pf_head_fwd': (fused_head.fused_pf_head_fwd, 'launches'),
        'fused_pf_head_fwd_wide': (fused_head.fused_pf_head_fwd,
                                   'wide_launches'),
        'fused_pf_head_bwd': (fused_head.fused_pf_head_bwd, 'launches'),
        'fused_pf_head_bwd_wide': (fused_head.fused_pf_head_bwd,
                                   'wide_launches'),
        'bilinear_sample_bwd_uv': (warp.bilinear_sample_bwd_uv, 'launches'),
        'bilinear_sample_bwd_img': (warp.bilinear_sample_bwd_img,
                                    'launches')}
    paths = {}
    paths['eval'], _, _ = run_eval_path(counters)
    with tempfile.TemporaryDirectory() as log_dir:
        paths['train'], result = run_train_path(counters, log_dir)
    compare_train_step(result)
    del result
    done('zeng eval, train, step check')

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
                               synthetic=False))
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
                   'at_clevr': [p for p in paths if 'clevr' in p]}
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
    print(f'chip_smoke: all checks passed in '
          f'{time.perf_counter() - begin:.1f} s')
    print(json.dumps({'pds_distortion': pds_check, 'train_runs': runs,
                      'zeng_orig_eval': zeng_orig_eval,
                      'file_data': file_data, 'file_runs': file_runs,
                      'resume': resume, 'file_eval_mace':
                      eval_result['mean_mace'], 'phase_s': phase_s}))
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
