"""Where the PF-head backward kernel (K2) spends its time on the card.

    python -m bihome_torch.profile_k2 [--batch_size 64] [--rounds 2]

No kernel profiler runs on the machine with the card, so this builds
variants of ``csrc/fused_head.cu`` with one part of K2 cut out, each with
nvcc (the port's flags) into its own library under ``build/kernels/``, and
times each against the kernel as built at the training shape (x
[2B,16,128,128], Cmid 128, Cout 2) with the timer of chip_smoke.py
(``bihome_torch/utils/timing.py``), in turns. What a cut saves is what that
part costs where it does not overlap the rest; the savings need not add
up. The variants compute wrong sums on purpose: only their times mean
anything. It also prints what the compiler made of K2 (the 16-byte-copy
kernel): its SASS instruction count by opcode, from cuobjdump. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import re
import subprocess
from pathlib import Path

import torch

from bihome_torch.ops import _cuda
from bihome_torch.ops import fused_head as fh
from bihome_torch.utils.timing import time_ms


def _cut(old: str, new: str):
    def apply(src: str) -> str:
        if old not in src:
            raise RuntimeError(f'profile_k2: {old!r} not in fused_head.cu')
        return src.replace(old, new)
    return apply


# Each cut turns the source into a variant without one part of K2.
CUTS = {
    'single-pass products (big*big only)': _cut(
        '  mma_tf32(hs, ab, bs);\n  mma_tf32(hs, as, bb);\n', ''),
    'dx single-pass': _cut(
        '        mma3(hh, hs, ab, as, bb, bs);\n      }\n'
        '      // Register r: k',
        '        mma_tf32(hh, ab, bb);\n      }\n      // Register r: k'),
    'no M0/M1 sums': _cut(
        '          m0[ch][o] = fmaf(mk, gv[o][px], m0[ch][o]);\n'
        '          m1[ch][o] = fmaf(mm, gv[o][px], m1[ch][o]);\n', ''),
    'no tensor-core products': lambda src: re.sub(
        r'asm\("mma\.sync.*?\);', ';', src, count=1, flags=re.S),
}


def _build(name: str, src: str):
    """Compile ``src`` as lib<name> into build/kernels and load it."""
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _cuda.BUILD_DIR / f'{name}.cu'
    cu.write_text(src)
    so = _cuda.BUILD_DIR / f'lib{name}.so'
    # The variants include nothing from csrc/, so they compile on their own.
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, '-o', str(so), str(cu)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in fh._SIGNATURES.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def sass_counts(so: Path) -> collections.Counter:
    """Opcode counts of the SASS of pf_head_bwd_kernel<true> in ``so``."""
    cuobjdump = Path(_cuda._nvcc()).with_name('cuobjdump')
    sass = subprocess.run([str(cuobjdump), '-sass', str(so)], check=True,
                          capture_output=True, text=True).stdout
    counts = collections.Counter()
    inside = False
    for line in sass.splitlines():
        if 'Function :' in line:
            inside = 'pf_head_bwd_kernelILb1' in line
            continue
        m = re.match(r'\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)',
                     line)
        if inside and m:
            counts[m.group(1)] += 1
    return counts


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--batch_size', type=int, default=64)
    parser.add_argument('--rounds', type=int, default=2)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_k2 needs a CUDA device')
    src = (_cuda.CSRC / 'fused_head.cu').read_text()
    libs = {'as built': _build('k2_as_built', src)}
    counts = sass_counts(_cuda.BUILD_DIR / 'libk2_as_built.so')
    print(f'K2 SASS: {sum(counts.values())} instructions; '
          + ', '.join(f'{op} {k}' for op, k in counts.most_common(12)))
    for i, (name, cut) in enumerate(CUTS.items()):
        libs[name] = _build(f'k2_variant{i}', cut(src))

    gen = torch.Generator().manual_seed(0)
    dev = torch.device('cuda')
    n, cin, cmid, cout, hw = 2 * args.batch_size, 16, 128, 2, 128 * 128
    x = torch.relu(torch.randn((n, cin, hw), generator=gen)).to(dev)
    g = torch.randn((n, cout, hw), generator=gen).to(dev)
    w1t = (torch.randn((cmid, cin), generator=gen) * 0.3).to(dev)
    gis = (torch.randn(cmid, generator=gen) * 0.2 + 1.0).to(dev)
    c1 = (torch.randn(cmid, generator=gen) * 0.1).to(dev)
    w2gis = (torch.randn((cmid, cout), generator=gen) * 0.3).to(dev)
    dx = torch.empty_like(x)

    def runner(lib):
        blocks = lib.pf_head_bwd_blocks(n, hw)
        partial = torch.empty((blocks, lib.pf_head_bwd_partial_cols()),
                              device=dev)
        sums = torch.empty(partial.shape[1], device=dev)

        def run():
            _cuda.check_status(lib.pf_head_bwd(
                x.data_ptr(), g.data_ptr(), w1t.data_ptr(), gis.data_ptr(),
                c1.data_ptr(), w2gis.data_ptr(), dx.data_ptr(),
                partial.data_ptr(), sums.data_ptr(), n, cin, hw, cmid, cout,
                blocks, torch.cuda.current_stream().cuda_stream), 'K2')
        return run

    runs = {name: runner(lib) for name, lib in libs.items()}
    times = {name: [] for name in runs}
    for _ in range(args.rounds):
        for name, run in runs.items():
            times[name].append(time_ms(run))
        times['as built'].append(time_ms(runs['as built']))
    print(f'K2 at x [{n},{cin},128,128] on {torch.cuda.get_device_name(0)}: '
          f'ms per call (every reading), and the median saved against the '
          f'kernel as built')
    base = sorted(times['as built'])[len(times['as built']) // 2]
    for name, ts in times.items():
        mid = sorted(ts)[len(ts) // 2]
        print(f'  {name:40s} {" ".join(f"{t:.4f}" for t in ts)}'
              + ('' if name == 'as built' else f'  saves {base - mid:.4f}'))


if __name__ == '__main__':
    main()
