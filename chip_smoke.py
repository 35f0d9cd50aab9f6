#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bihome_torch) on one NVIDIA H100.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), torch and CUDA
   versions, and turns TF32 off for matmuls and cuDNN convolutions.
2. Builds every CUDA kernel of the eval path from bihome_torch/csrc with
   nvcc (in parallel, into build/kernels/) and prints the build time.
3. Holds each kernel against its plain-torch version on the card at the
   eval shapes (batch 64) and times kernel, plain version and, where one
   PyTorch call computes the same function, that call (CUDA events,
   median of repeated launches).
4. Drives the port's eval entry point (zeng-biHomE S-COCO config,
   synthetic images, batch 64, 4 steps) with the launch counters set to 0
   just before and read just after; fails unless every kernel of the path
   launched, MACE is finite, and one batch's delta_hat matches the same
   batch and weights through the plain path on the CPU.
5. Prints one {"kernels": [...]} line, then as the last line
   {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero. Without a CUDA
device it exits non-zero before printing any result.
"""

import copy
import json
import statistics
import subprocess
import sys
import time

import torch

CONFIG = 'config/s-coco/zeng-bihome-lr-1e-3.yaml'
BATCH = 64
STEPS = 4
# Published H100 SXM peaks (NVIDIA data sheet) for the roofline bound.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


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
    grid = torch.stack([u * (2.0 / (ws - 1)) - 1.0,
                        v * (2.0 / (ws - 1)) - 1.0], dim=-1)[:, None]

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
    kernels = [check_warp(dev, gen), check_pf_head(dev, gen)]
    counters = {'bilinear_sample_batched': warp.bilinear_sample_batched,
                'fused_pf_head_fwd': fused_head.fused_pf_head_fwd}
    launches, _, _ = run_eval_path(counters)
    for k in kernels:
        k['launches'] = launches[k['name']]
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
