#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bihome_torch) on one NVIDIA H100.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), torch and CUDA
   versions, and turns TF32 off for matmuls and cuDNN convolutions.
2. Builds every CUDA kernel (K1-K5) from bihome_torch/csrc with nvcc (in
   parallel, into build/kernels/) and prints the build time.
3. Holds each kernel against its plain-torch version on the card and
   times kernel, plain version and, where one PyTorch call computes the
   same function, that call (CUDA events, median of repeated launches):
   K1 and K3 at the eval shapes (batch 64), K2, K3, K4 and K5 at the
   training shapes (batch 64, both directions stacked: 128 images).
4. Drives the port's eval entry point (zeng-biHomE S-COCO config,
   synthetic images, batch 64, 4 steps) with the launch counters set to 0
   just before and read just after; fails unless K1 and K3 launched, MACE
   is finite, and one batch's delta_hat matches the same batch and weights
   through the plain path on the CPU.
5. Drives the port's train entry point (the same config at full width,
   batch 64, 4 steps, the extractor from aux_clfbh.npz), counted the same
   way; fails unless K1-K4 launched, the loss is finite every step, the
   backbone's parameters and BN statistics moved and the frozen
   extractor's did not. Prints ms per step, pairs/s and peak memory.
6. One training step's loss and backbone gradients on the card and on
   the CPU in float32, each against the CPU plain path in float64 (batch
   4, the same conditioned weights, pairs and draws); then on the card
   with a planted fault in K4's or K2's output, which the same limits
   must catch.
7. Prints one {"kernels": [...]} line, then as the last line
   {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero. Without a CUDA
device it exits non-zero before printing any result.
"""

import contextlib
import copy
import json
import statistics
import subprocess
import sys
import tempfile
import time

import torch

CONFIG = 'config/s-coco/zeng-bihome-lr-1e-3.yaml'
BATCH = 64
STEPS = 4
# Published H100 SXM peaks (NVIDIA data sheet) for the roofline bound.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
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


def time_ms(fn, reps=20, warmup=3):
    """Median device time of ``fn`` in ms, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else 'operations')


def _grid(u, v, h, w):
    return torch.stack([u * (2.0 / (w - 1)) - 1.0,
                        v * (2.0 / (h - 1)) - 1.0], dim=-1)[:, None]


def check_warp(dev, gen):
    """K3 at the eval datagen shape: 64 grayscale 192x192 windows, the
    128x128 warped patch grid of random corner perturbations (rho 32)."""
    from bihome_torch import geometry
    from bihome_torch.ops import warp

    n, ws, ps, rho = BATCH, 192, 128, 32
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
    p = ps * ps
    nbytes = 4 * (n * ws * ws + 2 * n * p + n * p)
    flops = 15 * n * p          # 4 tap weights + 4 products + 3 adds + floors
    bms, by = bound_ms(nbytes, flops)
    print(f'K3 times (ms): kernel {ms:.4f}  plain {plain_ms:.4f}  '
          f'grid_sample {library_ms:.4f} (max abs diff {lib_err:.2e})  '
          f'bound {bms:.4f} ({by})')
    return {'name': 'bilinear_sample_batched', 'route': 'cuda',
            'source': 'bihome_torch/csrc/warp.cu',
            'replaces': 'bihome_tpu/ops/warp_pallas.py:55',
            'max_abs_err': max(err, err3), 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bms, 'bound_by': by, 'library_ms': library_ms}


def check_pf_head(dev, gen):
    """K1 at the eval shape: the DoubleLine [2B,16,128,128] activation,
    M = 2,097,152 pixels, Cmid 128, Cout 2, one gamma == 0 channel."""
    from bihome_torch.ops import fused_head

    n, cin, cmid, cout, hw = 2 * BATCH, 16, 128, 2, 128

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
    m = n * hw * hw
    nbytes = 4 * (m * cin + m * cout + cmid * cin + 3 * cmid + cout * cmid
                  + cout + cmid)
    flops = 2 * m * (cin * cmid + cmid * cout)
    bms, by = bound_ms(nbytes, flops)
    print(f'K1 times (ms): kernel {ms:.4f}  plain {plain_ms:.4f}  '
          f'bound {bms:.4f} ({by})')
    return {'name': 'fused_pf_head_fwd', 'route': 'cuda',
            'source': 'bihome_torch/csrc/fused_head.cu',
            'replaces': 'bihome_tpu/ops/fused_head.py:93',
            'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bms, 'bound_by': by, 'library_ms': None}


def run_eval_path(counters):
    """The port's eval entry point on the card, counted; then one batch
    against the plain path on the CPU with the same weights and draws."""
    from bihome_torch import eval as teval

    for fn in counters.values():
        fn.launches = 0
    result = teval.main(['--config_file', CONFIG, '--synthetic',
                         '--batch_size', str(BATCH), '--steps', str(STEPS),
                         '--device', 'cuda'])
    launches = {name: fn.launches for name, fn in counters.items()}
    print(f'launches on the eval path: {launches}')
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f'{name} never launched on the eval path')
    if not all(torch.isfinite(torch.as_tensor(result['maces']))):
        raise AssertionError('non-finite MACE')
    pairs_per_s = BATCH / (result['per_batch_ms'] / 1e3)
    print(f'eval: Mean mace {result["mean_mace"]}  Mean model time '
          f'{result["per_batch_ms"]} ms/batch  pairs/s {pairs_per_s:.1f}')

    model = result['model']
    batch = result['batches'][0]
    gen = teval.dsac_generator(result['test_seed'], 0)
    delta_cuda = model.predict(batch, generator=gen).cpu()
    model_cpu = copy.deepcopy(model).cpu()
    batch_cpu = {k: v.cpu() for k, v in batch.items()}
    gen = teval.dsac_generator(result['test_seed'], 0)
    delta_cpu = model_cpu.predict(batch_cpu, generator=gen)
    err = (delta_cuda - delta_cpu).abs().max().item()
    print(f'delta_hat CUDA vs CPU plain path, batch 0: max abs err '
          f'{err:.3e} px (max |delta_hat| {delta_cpu.abs().max().item():.2f};'
          f' tolerance 1e-2 px)')
    if not (delta_cuda.shape == (BATCH, 4, 2) and err <= 1e-2):
        raise AssertionError(f'CUDA predict disagrees with CPU: {err}')
    return launches, result, pairs_per_s


def _rel_err(got, want, scale=None):
    """max |got - want| over the largest |want| (or ``scale``)."""
    scale = float(want.abs().max()) if scale is None else scale
    return float((got - want).abs().max()) / max(scale, 1e-30)


def check_pf_head_bwd(dev, gen):
    """K2 at the training shape: x [2B,16,128,128] (M = 2,097,152 pixels,
    B = 64), a dense random cotangent g [2B,2,128,128], batch statistics,
    one gamma == 0 channel. The seven gradients through the kernel against
    the same algebra through the plain moment pass, on the card."""
    from bihome_torch.ops import fused_head as fh

    n, cin, cmid, cout, hw = 2 * BATCH, 16, 128, 2, 128

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
    got = fh.pf_head_backward(*args)
    want = fh.pf_head_backward(*args, moments=fh.pf_head_bwd_plain)
    names = ('dx', 'dw1', 'db1', 'dgamma', 'dbeta', 'dw2', 'db2')
    errs = {}
    for name, a, b in zip(names[1:], got[1:], want[1:]):
        # db1 is 0 analytically (the batch mean absorbs b1): measure it on
        # the scale of the terms that cancel in it, dbeta's.
        errs[name] = _rel_err(a, b, float(want[4].abs().max())
                              if name == 'db1' else None)
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
    err = max(errs.values())
    print('K2 PF head backward [%d,%d,%d,%d]: error / max|ref| per output '
          '%s (tolerance 1e-3); dx off by more than 1e-4 max|dx| at %d of '
          '%d pixels, each with a middle channel within 1e-5 of the ReLU '
          'kink: %s' % (n, cin, hw, hw, ', '.join(
              f'{k} {v:.2e}' for k, v in errs.items()), len(bad),
              off.numel(), at_kink))
    if not (err <= 1e-3 and at_kink and len(bad) <= 1e-4 * off.numel()):
        raise AssertionError(f'PF-head backward kernel disagrees: {errs}, '
                             f'{len(bad)} pixels off, at kink {at_kink}')
    w2gis = (w2.reshape(cout, cmid).t() * gis[:, None]).contiguous()
    margs = (x, g, w1t, gis, c1, w2gis)
    ms = time_ms(lambda: fh.fused_pf_head_bwd(*margs))
    plain_ms = time_ms(lambda: fh.pf_head_bwd_plain(*margs), reps=5)
    m = n * hw * hw
    nbytes = 4 * (m * cin + m * cout + m * cin + cmid * cin + 2 * cmid
                  + cmid * cout + cin * cmid + 2 * cmid * cout + cout)
    # mid, dx, dw1: 2*cin*cmid each; per middle channel: a (2), mask (1),
    # e (2*cout + 1), M0 (2*cout), M1 (1 + 2*cout); db2: cout.
    flops = m * (6 * cin * cmid + cmid * (5 + 6 * cout) + cout)
    bms, by = bound_ms(nbytes, flops)
    print(f'K2 times (ms): kernel {ms:.4f}  plain {plain_ms:.4f}  '
          f'bound {bms:.4f} ({by}, {flops / 1e9:.2f} GFLOP, '
          f'{nbytes / 1e9:.3f} GB)')
    return {'name': 'fused_pf_head_bwd', 'route': 'cuda',
            'source': 'bihome_torch/csrc/fused_head.cu',
            'replaces': 'bihome_tpu/ops/fused_head.py:110',
            'max_abs_err': max(float((a - b).abs().max()) for a, b in
                               zip((dx_got, *got[1:]), (dx_want, *want[1:]))),
            'max_rel_err': err, 'kink_pixels': len(bad), 'ms': ms,
            'plain_ms': plain_ms,
            'bound_ms': bms, 'bound_by': by, 'library_ms': None}


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
    lib4 = time_ms(lambda: torch.autograd.grad(out_grid, grid, g_nchw,
                                               retain_graph=True))
    lib5 = time_ms(lambda: torch.autograd.grad(out_img, img_req, g_nchw,
                                               retain_graph=True))
    ms4 = time_ms(lambda: warp.bilinear_sample_bwd_uv(images, u, v, g))
    plain4 = time_ms(lambda: warp.bilinear_sample_bwd_uv_plain(images, u, v,
                                                               g))
    shape = tuple(images.shape)
    ms5 = time_ms(lambda: warp.bilinear_sample_bwd_img(u, v, g, shape))
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
          f'{plain3:.4f}  grid_sample {lib3:.4f}  bound {b3:.4f} ({by3})')
    print(f'K4 times (ms): kernel {ms4:.4f}  plain {plain4:.4f}  '
          f'grid_sample grid-grad {lib4:.4f}  bound {b4:.4f} ({by4})')
    print(f'K5 times (ms): kernel {ms5:.4f} (with zeroing dimg)  plain '
          f'{plain5:.4f}  grid_sample input-grad {lib5:.4f}  bound {b5:.4f} '
          f'({by5})')
    common = {'route': 'cuda', 'source': 'bihome_torch/csrc/warp.cu'}
    k3 = {'max_abs_err': float((out - want_out).abs().max()),
          'max_rel_err': err3, 'ms': ms3, 'plain_ms': plain3, 'bound_ms': b3,
          'bound_by': by3, 'library_ms': lib3}
    k4 = dict(common, name='bilinear_sample_bwd_uv',
              replaces='bihome_tpu/ops/warp_pallas.py:75',
              max_abs_err=max(float((du - want_du).abs().max()),
                              float((dv - want_dv).abs().max())),
              max_rel_err=err4, ms=ms4, plain_ms=plain4, bound_ms=b4,
              bound_by=by4, library_ms=lib4)
    k5 = dict(common, name='bilinear_sample_bwd_img',
              replaces='bihome_tpu/ops/warp_pallas.py:101',
              max_abs_err=float((dimg - want_img).abs().max()),
              max_rel_err=max(err5, err5c3), ms=ms5, plain_ms=plain5,
              bound_ms=b5, bound_by=by5, library_ms=lib5)
    return k3, [k4, k5]


def run_train_path(counters, log_dir):
    """The port's train entry point on the card, counted."""
    from bihome_torch import train

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    result = train.main(['--config_file', CONFIG, '--synthetic',
                         '--batch_size', str(BATCH), '--steps', str(STEPS),
                         '--epochs', '1', '--device', 'cuda',
                         '--set', 'MODEL.HEAD.AUXILIARY_RESNET_PATH='
                         'aux_clfbh.npz', '--set', f'LOGGING.DIR={log_dir}'])
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f'launches on the train path: {launches}')
    for name in ('fused_pf_head_fwd', 'fused_pf_head_bwd',
                 'bilinear_sample_batched', 'bilinear_sample_bwd_uv'):
        if launches[name] < 1:
            raise AssertionError(f'{name} never launched on the train path')
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
    aux_same = all(torch.equal(final[k].cpu(), initial[k]) for k in final
                   if k.startswith('auxiliary_resnet.'))
    print(f'moved: {len(params & set(moved))}/{len(params)} backbone '
          f'parameters, {len(stats & set(moved))}/{len(stats)} BN running '
          f'statistics; frozen extractor bitwise unchanged: {aux_same}')
    if not (params & set(moved) and stats & set(moved) and aux_same):
        raise AssertionError('training did not move the backbone, or moved '
                             'the frozen extractor')
    step_ms = result['median_step_ms']
    pairs_per_s = BATCH / (step_ms / 1e3)
    print(f'train: {step_ms:.2f} ms per step (median of steps 2-{STEPS}, '
          f'each ended by a synchronize; all: '
          f'{[round(t, 2) for t in result["step_ms"]]}), pairs/s '
          f'{pairs_per_s:.1f}, peak memory allocated {peak_gb:.2f} GB')
    return launches, result


def _condition(model):
    """Scale the last BN of each residual branch by 1/4, as
    tests/test_torch_train_step.py does, and the PF head's output conv by
    PF_SCALE, so that the field is a few pixels (the seeded init gives
    less than one; the DLT fit of sub-pixel deltas is ill-conditioned in
    float32). Undamped, the seeded network's float32 backward is
    ill-conditioned; damped, float32 follows float64 closely (readings
    above) and a wrong gradient stands out."""
    with torch.no_grad():
        for name, mod in model.backbone.named_modules():
            if (name.endswith('upper_branch.4')
                    and isinstance(mod, torch.nn.BatchNorm2d)):
                mod.weight.mul_(0.25)
        model.backbone.layer8[3].weight.mul_(PF_SCALE)
        model.backbone.layer8[3].bias.mul_(PF_SCALE)


def one_step_grads(built, state, data, device, dtype=torch.float32):
    """Loss and backbone gradients (float64, on the CPU) of one conditioned
    training step from ``state`` on ``device`` in ``dtype``; ``data`` =
    (uint8 pool rows, corners, delta, DSAC uniforms). No optimizer."""
    from bihome_torch import config as config_lib
    from bihome_torch.data import pipeline

    pool, corners, delta, uniforms = data
    model = config_lib.build_model(built.config).model
    model.load_state_dict(state)
    _condition(model)
    model = model.to(device=device, dtype=dtype).train()
    batch = pipeline.generate_pairs(pool.to(device), built.pair_spec,
                                    corners=corners, delta=delta)
    out = model({k: v.to(dtype) for k, v in batch.items()},
                uniforms=uniforms)
    out['loss'].backward()
    # The loss is ln1 + ln2 + mu*ln3, whose terms largely cancel: its error
    # is measured on the sum of their magnitudes.
    scale = sum(abs(out['metrics'][f'loss_comp/ln{i}'].item())
                for i in (1, 2, 3))
    # layer8.0.bias (the PF head's first conv bias) is left out: its
    # gradient is 0 analytically under batch statistics.
    return out['loss'].item(), scale, {n: p.grad.cpu().double() for n, p in
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


def compare_train_step(result, batch=4):
    """One step's loss and backbone gradients on the card (float32) and
    through the plain path on the CPU (float32), each against the plain
    path on the CPU in float64: the run's initial weights, conditioned
    (``_condition``), the same pairs and DSAC draws; no optimizer. Then the
    card's step again under each planted fault, which must fail the same
    limits: the loss within STEP_LOSS of the sum of its terms' magnitudes,
    the gradients within STEP_L2 relative L2 over all tensors and within
    STEP_PER_TENSOR relative L2 for every tensor."""
    from bihome_torch.data import datasets, pipeline

    built, state = result['built'], result['initial_state']
    gen = torch.Generator().manual_seed(7)
    pool = torch.from_numpy(datasets.SyntheticDataset(seed=2).pool[:batch])
    corners, delta = pipeline.draw_corners_delta_batch(
        batch, tuple(pool.shape[1:3]), built.pair_spec, gen)
    uniforms = [torch.rand((batch, 128), generator=gen) for _ in range(2)]
    data = (pool, corners, delta, uniforms)
    cuda, cpu = torch.device('cuda'), torch.device('cpu')

    ref = one_step_grads(built, state, data, cpu, torch.float64)
    runs = {'card': one_step_grads(built, state, data, cuda),
            'CPU fp32': one_step_grads(built, state, data, cpu)}
    for fault in FAULTS:
        with planted_fault(fault):
            runs[fault] = one_step_grads(built, state, data, cuda)
    readings = {}
    for name, run in runs.items():
        loss_err, l2, per, worst = readings[name] = step_errors(run, ref)
        print(f'one train step (batch {batch}), {name} against the CPU '
              f'plain path in float64: loss {run[0]:.6f} vs {ref[0]:.6f} '
              f'(terms {ref[1]:.4f}), error / terms {loss_err:.2e} (limit '
              f'{STEP_LOSS:.0e}); backbone gradients relative L2 {l2:.2e} '
              f'(limit {STEP_L2:.0e}), worst tensor {per:.2e} ({worst}; '
              f'limit {STEP_PER_TENSOR:.0e})')

    def holds(name):
        loss_err, l2, per, _ = readings[name]
        return (loss_err <= STEP_LOSS and l2 <= STEP_L2
                and per <= STEP_PER_TENSOR)
    if not holds('card'):
        raise AssertionError('CUDA training step strays from the float64 '
                             'plain path')
    caught = {fault: not holds(fault) for fault in FAULTS}
    print(f'planted faults caught by the step check: {caught}')
    if not all(caught.values()):
        raise AssertionError(f'the step check misses a planted fault: '
                             f'{caught}')
    return readings


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing run', file=sys.stderr)
        return 2
    from bihome_torch.ops import _cuda, fused_head, warp

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

    start = time.perf_counter()
    logs = _cuda.build(['warp', 'fused_head'])
    print(f'built {sorted(logs)} in {time.perf_counter() - start:.1f} s')
    for name, log in logs.items():
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'  {name}: {line.strip()}')

    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(0)
    kernels = [check_warp(dev, gen), check_pf_head(dev, gen),
               check_pf_head_bwd(dev, gen)]
    k3_loss_warp, bwd_kernels = check_warp_bwd(dev, gen)
    kernels[0]['at_loss_warp'] = k3_loss_warp
    kernels += bwd_kernels
    counters = {'bilinear_sample_batched': warp.bilinear_sample_batched,
                'fused_pf_head_fwd': fused_head.fused_pf_head_fwd,
                'fused_pf_head_bwd': fused_head.fused_pf_head_bwd,
                'bilinear_sample_bwd_uv': warp.bilinear_sample_bwd_uv,
                'bilinear_sample_bwd_img': warp.bilinear_sample_bwd_img}
    eval_launches, _, _ = run_eval_path(
        {k: counters[k] for k in ('bilinear_sample_batched',
                                  'fused_pf_head_fwd')})
    with tempfile.TemporaryDirectory() as log_dir:
        train_launches, result = run_train_path(counters, log_dir)
    compare_train_step(result)
    for k in kernels:
        by_path = {'eval': eval_launches.get(k['name'], 0),
                   'train': train_launches[k['name']]}
        k['launches'] = sum(by_path.values())
        k['launches_by_path'] = by_path
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0

if __name__ == '__main__':
    sys.exit(main())
