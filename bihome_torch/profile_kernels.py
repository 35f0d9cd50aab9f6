"""Where a hand-written kernel spends its time on the card, and how it
compares with another version of its source.

    python -m bihome_torch.profile_kernels --kernel k1|k1w|k1wb|k2|k2w|k2wb|k4 \\
        [--baseline FILE] [--cmid C] [--batch_size 64] [--rounds 2] \\
        [--no_cuts]

No kernel profiler runs on the machine with the card, so this builds
variants of the kernel's source (``csrc/fused_head.cu`` for K1, K2 and
the ResNet50-flavour K1 and K2, ``k1w`` and ``k2w``, and their bf16
forms, ``k1wb`` and ``k2wb``; ``csrc/warp.cu`` for K4) with one part cut
out or done another way, each with nvcc (the port's flags) into its own
library under ``build/kernels/``, and times each
against the kernel as built at the main path's shape with the timer of
chip_smoke.py
(``bihome_torch/utils/timing.py``), in turns. What a cut saves is what
that part costs where it does not overlap the rest; the savings need not
add up. The cut variants compute wrong results on purpose: only their
times mean anything. ``--baseline FILE`` builds another version of the
same source (an earlier commit's, unpacked under ``build/``) and times it
beside the kernel as built, with the host cost per call of each (the C
entry point through ctypes, without the Python wrapper). It also prints
what the compiler made of the kernel (its 16-byte-copy or float2
variant): its SASS instruction count by opcode, from cuobjdump (for k1w
of its forward kernel, for k2w of its dx and sums kernels). For k1w and
k2w, whose C entries launch several kernels, it also reads each kernel's
device time apart under torch.profiler
(:func:`bihome_torch.utils.timing.kernel_ms`), for the kernel as built,
the baseline and each cut variant. For k1w it holds the outputs of the
kernel as built and the baseline against float64 (:func:`k1w_errors`);
for k2w it times the kernel as built with its sums grid at twice the
blocks and holds the sums of those three against float64
(:func:`k2w_sums_errors`). Shapes: K1 and K2 x [2B,16,128,128], Cmid 128
(K1: ``--cmid``), Cout 2 (K2 with a cotangent); k1w and k2w x
[2B,64,128,128], Cmid 512 (k1wb and k2wb in bf16, k2wb's dx, sums and
reduction kernels also timed apart); K4 the loss warp, 2B images of 128x128x1 at P
= 16,384 points each. ``--no_cuts`` times only the kernel as built and
the baseline. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import re
import subprocess
from pathlib import Path

import torch

from bihome_torch import geometry
from bihome_torch.ops import _cuda
from bihome_torch.ops import fused_head as fh
from bihome_torch.ops import warp
from bihome_torch.utils.timing import host_us, kernel_ms, time_ms


def _cut(old: str, new: str, then=None):
    """Replace ``old`` by ``new`` in the source (then apply ``then``)."""
    def apply(src: str) -> str:
        if old not in src:
            raise RuntimeError(f'profile_kernels: {old!r} not in the source')
        src = src.replace(old, new)
        return then(src) if then else src
    return apply


# With the tensor-core products cut, each accumulator keeps its input.
_NO_MMA = ('no tensor-core products', lambda src: re.sub(
    r'asm\("mma\.sync.*?\);', 'for (int i = 0; i < 4; ++i) d[i] = c[i];', src,
    count=1, flags=re.S))
_SINGLE_PASS = ('single-pass products (big*big only)', _cut(
    '  mma_tf32(hs, ab, bs, chs);\n  mma_tf32(hs, as, bb, hs);\n',
    '  for (int r = 0; r < 4; ++r) hs[r] = chs[r];\n'))
# The ResNet50-flavour kernels (k1w, k2w): every wgmma product of the file
# cut (each accumulator keeps what it held), or only the big*big pass of
# each 3xTF32 product.
WG_NO_PRODUCTS = ('no wgmma products', lambda src: re.sub(
    r'asm volatile\(\s*"\{\\n\.reg \.pred p;.*?\);', '(void)scale_d;', src,
    flags=re.S))
WG_SINGLE_PASS = ('single-pass wgmma products (big*big only)', _cut(
    'for (int pass = 0; pass < 3; ++pass)',
    'for (int pass = 2; pass < 3; ++pass)',
    _cut('pass != 0 ||', 'pass != 2 ||')))
K2W_NO_STREAM = ('dx: no weight chunk copies after the first', _cut(
    'const bool more = c + 1 < nch || next < ntiles;',
    'const bool more = false;', _cut(
        '      mbar_wait(s_bar', '      if (step == 0) mbar_wait(s_bar')))
# The wide forward's weight ring fed only the first chunk (later steps read
# whatever its buffers hold): what streaming the images from L2 costs.
K1W_NO_STREAM = ('no weight chunk copies after the first', _cut(
    'for (int s = 0; s < steps; ++s) {', 'for (int s = 0; s < 1; ++s) {',
    _cut('      mbar_wait(s_full + s % kFBufs',
         '      if (s == 0) mbar_wait(s_full + s % kFBufs')))
K1W_EPILOGUE = '      fwd_wide_epilogue(mid, s_p + 64 * c, tig, acc);\n'
K1W_CUTS = [
    WG_NO_PRODUCTS, WG_SINGLE_PASS, K1W_NO_STREAM,
    ('no ping-pong turns', _cut(
        '      named_sync(kFTurn + wg, 256);\n', '', _cut(
            '      named_arrive(kFTurn + (wg ^ 1), 256);\n', '', _cut(
                '  if (wg == 1) named_arrive(kFTurn, 256);', '', _cut(
                    '  if (wg == 0) named_sync(kFTurn, 256);', ''))))),
    ('no epilogue (one add per chunk)', _cut(
        K1W_EPILOGUE, '      acc[0][0] += mid[0] + mid[31];\n')),
    ('epilogue twice', _cut(K1W_EPILOGUE, 2 * K1W_EPILOGUE)),
]

# The ResNet50-flavour kernels at bf16 (k1wb, k2wb; mma.sync m16n8k16):
# every bf16 product cut, K1's epilogue (the ReLU, the rounding and the
# Cout = 2 sums) cut to one add, K1's stores, K2's M0 and M1 sums. Each cut
# also strikes the narrow bf16 kernels' same lines, which these entry
# points do not launch.
_NO_MMA_BF16 = ('no tensor-core products', lambda src: re.sub(
    r'asm\("mma\.sync\.aligned\.m16n8k16.*?\);',
    'for (int i = 0; i < 4; ++i) d[i] = c[i];', src, count=1, flags=re.S))
K1WB_CUTS = [
    _NO_MMA_BF16,
    ('no epilogue (one add per value)', _cut(
        '          const float rr = round_bf16(fmaxf(d[r], 0.0f));\n'
        '          const int px = r >> 1, ch = r & 1;\n'
        '          acc[mt][px][0] = fmaf(wo[0][ch], rr, acc[mt][px][0]);\n'
        '          acc[mt][px][1] = fmaf(wo[1][ch], rr, acc[mt][px][1]);\n',
        '          acc[mt][r >> 1][r & 1] += d[r];\n')),
    ('no stores', _cut('if (s < hw) on[s] = (uint16_t)',
                       'if (s < hw && v == -1.25e-30f) on[s] = (uint16_t)')),
]
K2WB_CUTS = [
    _NO_MMA_BF16,
    ('sums: no M0/M1', _cut(
        '            m0[ch][o] = fmaf(mk, gv[o][px], m0[ch][o]);\n'
        '            m1[ch][o] = fmaf(mm, gv[o][px], m1[ch][o]);\n', '')),
]

# Each turns the source into a variant without one part of the kernel, or
# with it done another way.
CUTS = {
    'k1': dict([
        ('one accumulator for all three passes (small terms first)', _cut(
            '    mma3(hh[mt], hs[mt], ab[mt][0], as[mt][0], bb[0], bs[0], '
            'c1r, zero);\n'
            '    mma3(hh[mt], hs[mt], ab[mt][1], as[mt][1], bb[1], bs[1]);\n',
            '    mma_tf32(hh[mt], as[mt][0], bb[0], c1r);\n'
            '    mma_tf32(hh[mt], ab[mt][0], bs[0], hh[mt]);\n'
            '    mma_tf32(hh[mt], as[mt][1], bb[1], hh[mt]);\n'
            '    mma_tf32(hh[mt], ab[mt][1], bs[1], hh[mt]);\n'
            '    mma_tf32(hh[mt], ab[mt][0], bb[0], hh[mt]);\n'
            '    mma_tf32(hh[mt], ab[mt][1], bb[1], hh[mt]);\n'
            '    for (int r = 0; r < 4; ++r) hs[mt][r] = 0.0f;\n',
            _cut('fmaxf(hh[mt][r] + hs[mt][r], 0.0f)',
                 'fmaxf(hh[mt][r], 0.0f)'))),
        ('n-tile loop software-pipelined by hand', _cut(
            '    for (int nt = 0; nt < ntn; ++nt) {\n'
            '      float hh[2][4], hs[2][4];\n'
            '      fwd_products(s_b, s_c, nt, lane, ab, as, hh, hs);\n'
            '      fwd_epilogue(s_c, nt, lane, hh, hs, acc);\n',
            '    float hh0[2][4], hs0[2][4], hh1[2][4], hs1[2][4];\n'
            '    fwd_products(s_b, s_c, 0, lane, ab, as, hh0, hs0);\n'
            '    for (int nt = 0; nt < ntn; nt += 2) {\n'
            '      fwd_products(s_b, s_c, nt + 1, lane, ab, as, hh1, hs1);\n'
            '      fwd_epilogue(s_c, nt, lane, hh0, hs0, acc);\n'
            '      if (nt + 2 < ntn) fwd_products(s_b, s_c, nt + 2, lane, ab, '
            'as, hh0, hs0);\n'
            '      fwd_epilogue(s_c, nt + 1, lane, hh1, hs1, acc);\n')),
        ('three blocks per SM (85 registers a thread)', _cut(
            '__launch_bounds__(kFwdThreads, 2)\npf_head_fwd_kernel(',
            '__launch_bounds__(kFwdThreads, 3)\npf_head_fwd_kernel(')),
        _SINGLE_PASS,
        ('no ReLU and output FMAs (one add per value)', _cut(
            '      const float a = fmaxf(hh[mt][r] + hs[mt][r], 0.0f);\n'
            '      const int px = r >> 1, ch = r & 1;\n'
            '      acc[mt][px][0] = fmaf(wo[0][ch], a, acc[mt][px][0]);\n'
            '      acc[mt][px][1] = fmaf(wo[1][ch], a, acc[mt][px][1]);\n',
            '      acc[mt][r >> 1][r & 1] += hh[mt][r] + hs[mt][r];\n')),
        ('no stores', _cut('if (s < hw) on[s] =',
                           'if (s < hw && v == -1.25e-30f) on[s] =')),
        ('no n-tile loop (loads, stores, per-tile work)', _cut(
            'for (int nt = 0; nt < ntn; ++nt) {',
            'for (int nt = 0; nt < 0; ++nt) {')),
        ('no x loads after the first tile', _cut(
            '    if (next < ntiles) {\n      load_fwd_tile<kVec>',
            '    if (next < 0) {\n      load_fwd_tile<kVec>')),
        _NO_MMA,
    ]),
    'k2': dict([
        _SINGLE_PASS,
        ('dx single-pass', _cut(
            '        mma3(hh, hs, ab, as, bb, bs);\n      }\n'
            '      // Register r: k',
            '        mma_tf32(hh, ab, bb, hh);\n      }\n'
            '      // Register r: k')),
        ('no M0/M1 sums', _cut(
            '          m0[ch][o] = fmaf(mk, gv[o][px], m0[ch][o]);\n'
            '          m1[ch][o] = fmaf(mm, gv[o][px], m1[ch][o]);\n', '')),
        _NO_MMA,
    ]),
    'k1w': dict(K1W_CUTS),
    'k2w': dict([WG_NO_PRODUCTS, WG_SINGLE_PASS, K2W_NO_STREAM]),
    'k1wb': dict(K1WB_CUTS),
    'k2wb': dict(K2WB_CUTS),
    'k4': {},
}
SOURCES = {'k1': 'fused_head', 'k1w': 'fused_head', 'k2': 'fused_head',
           'k2w': 'fused_head', 'k1wb': 'fused_head', 'k2wb': 'fused_head',
           'k4': 'warp'}
WIDE = ('k1w', 'k2w', 'k1wb', 'k2wb')
# The kernels whose SASS is counted (their mangled names start so).
SASS_NAMES = {'k1': ('pf_head_fwd_kernelILb1',),
              'k1w': ('pf_head_fwd_wgmma_kernelILb1',),
              'k2': ('pf_head_bwd_kernelILb1',),
              'k2w': ('pf_head_bwd_wide_dx_kernelILb1',
                      'pf_head_bwd_wide_sums_kernelILb1'),
              'k1wb': ('pf_head_fwd_wide_bf16_kernelILb1',),
              'k2wb': ('pf_head_bwd_wide_bf16_dx_kernelILb1',
                       'pf_head_bwd_wide_bf16_sums_kernelILb1'),
              'k4': ('bilinear_sample_bwd_uv_c1_kernelILb1',)}
# The kernels of the k1w entry point (the last: an earlier source's), and
# of the k2w one, timed apart.
K1W_KERNELS = ('pf_head_wide_prep_kernel', 'pf_head_fwd_wgmma_kernel',
               'pf_head_fwd_wide_kernel')
K2W_KERNELS = ('pf_head_wide_prep_kernel', 'pf_head_bwd_wide_dx_kernel',
               'pf_head_bwd_wide_sums_kernel', 'reduce_rows_kernel')
K2WB_KERNELS = ('pf_head_bwd_wide_bf16_dx_kernel',
                'pf_head_bwd_wide_bf16_sums_kernel', 'reduce_rows_kernel')
SIGNATURES = {'fused_head': fh._SIGNATURES, 'warp': warp._SIGNATURES}
# The k2w kernel as built, its sums grid at twice the C entry's blocks.
K2W_GRID2 = 'as built, sums grid at twice the blocks'
K2W_SUMS = ('dw1', 'm0', 'm1', 'db2')


def _build(sources: dict, entry_points: str) -> dict:
    """Compile each {name: source text} as lib<name> into build/kernels,
    all nvcc processes started together, and load each with the entry
    points of csrc/<entry_points>.cu (its source text as ``source``)."""
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu = _cuda.BUILD_DIR / f'{name}.cu'
        cu.write_text(src)
        so = _cuda.BUILD_DIR / f'lib{name}.so'
        # The sources include nothing from csrc/: each compiles on its own.
        procs[name] = (so, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, '-o', str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {name}:\n{log}')
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in SIGNATURES[entry_points].items():
            if not hasattr(lib, fn):  # an earlier source may lack an entry
                continue
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        lib.source = sources[name]
        libs[name] = lib
    return libs


def sass_counts(so: Path, kernel: str) -> collections.Counter:
    """Opcode counts of the SASS of the function whose mangled name
    starts with ``kernel`` in ``so``."""
    cuobjdump = Path(_cuda._nvcc()).with_name('cuobjdump')
    sass = subprocess.run([str(cuobjdump), '-sass', str(so)], check=True,
                          capture_output=True, text=True).stdout
    counts = collections.Counter()
    inside = False
    for line in sass.splitlines():
        if 'Function :' in line:
            inside = kernel in line
            continue
        m = re.match(r'\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)',
                     line)
        if inside and m:
            counts[m.group(1)] += 1
    return counts


def _runner_factory(kernel: str, batch: int, cmid: int):
    """(describe, lib -> call): the kernel's C entry point at the main
    path's shape on seeded inputs."""
    gen = torch.Generator().manual_seed(0)
    dev = torch.device('cuda')
    stream = lambda: torch.cuda.current_stream().cuda_stream
    n = 2 * batch
    if kernel == 'k4':
        ps, p = 128, 128 * 128
        images = torch.randn((n, ps, ps, 1), generator=gen).to(dev)
        # The patch grid through homographies of corner offsets of a few
        # pixels, as the loss warp samples it.
        corners = geometry.image_corners(ps, ps, batch_size=n)
        delta = torch.rand((n, 4, 2), generator=gen) * 16 - 8
        u, v = geometry.homography_grid(
            geometry.four_point_to_homography(corners, delta), (ps, ps))
        u, v = u.to(dev), v.to(dev)
        g = torch.randn((n, p, 1), generator=gen).to(dev)
        du, dv = torch.empty_like(u), torch.empty_like(v)

        def make(lib):
            return lambda: _cuda.check_status(lib.bilinear_sample_bwd_uv(
                images.data_ptr(), u.data_ptr(), v.data_ptr(), g.data_ptr(),
                du.data_ptr(), dv.data_ptr(), n, ps, ps, 1, p, stream()),
                'K4')
        return f'K4 at images [{n},{ps},{ps},1], P = {p}', make

    cin, cout, hw = (64 if kernel in WIDE else 16), 2, 128 * 128
    x = torch.relu(torch.randn((n, cin, hw), generator=gen)).to(dev)
    w1t = (torch.randn((cmid, cin), generator=gen) * 0.3).to(dev)
    c1 = (torch.randn(cmid, generator=gen) * 0.1).to(dev)
    if kernel == 'k1wb':
        xb = x.to(torch.bfloat16)
        w2 = (torch.randn((cout, cmid), generator=gen) * 0.3).to(dev)
        b2 = (torch.randn(cout, generator=gen) * 0.1).to(dev)
        out = torch.empty((n, cout, hw), dtype=torch.bfloat16, device=dev)

        def make(lib):
            return lambda: _cuda.check_status(lib.pf_head_fwd_wide_bf16(
                xb.data_ptr(), w1t.data_ptr(), c1.data_ptr(), w2.data_ptr(),
                b2.data_ptr(), out.data_ptr(), n, cin, hw, cmid, cout,
                stream()), 'K1 wide bf16')
        return f'K1 wide bf16 at x [{n},{cin},128,128], Cmid {cmid}', make
    if kernel == 'k1':
        w2 = (torch.randn((cout, cmid), generator=gen) * 0.3).to(dev)
        b2 = (torch.randn(cout, generator=gen) * 0.1).to(dev)
        out = torch.empty((n, cout, hw), device=dev)

        def make(lib):
            return lambda: _cuda.check_status(lib.pf_head_fwd(
                x.data_ptr(), w1t.data_ptr(), c1.data_ptr(), w2.data_ptr(),
                b2.data_ptr(), out.data_ptr(), n, cin, hw, cmid, cout,
                stream()), 'K1')
        return f'K1 at x [{n},{cin},128,128], Cmid {cmid}', make
    if kernel == 'k1w':
        w2 = (torch.randn((cout, cmid), generator=gen) * 0.3).to(dev)
        b2 = (torch.randn(cout, generator=gen) * 0.1).to(dev)
        img = torch.empty((cmid // 64, 4, 64 * 64), device=dev)

        def make(lib):
            out = torch.empty((n, cout, hw), device=dev)
            scratch = (img.data_ptr(),)
            if 'pf_head_fwd_wgmma_kernel' not in lib.source:
                # An earlier source (g1t split per tile): no img pointer.
                lib.pf_head_fwd_wide.argtypes = \
                    fh._SIGNATURES['pf_head_fwd_wide'][:6] \
                    + fh._SIGNATURES['pf_head_fwd_wide'][7:]
                scratch = ()

            def run():
                _cuda.check_status(lib.pf_head_fwd_wide(
                    x.data_ptr(), w1t.data_ptr(), c1.data_ptr(),
                    w2.data_ptr(), b2.data_ptr(), out.data_ptr(), *scratch,
                    n, cin, hw, cmid, cout, stream()), 'K1 wide')
            run.out = out
            return run
        make.inputs = (x, w1t, c1, w2, b2)
        return f'K1 wide at x [{n},{cin},128,128], Cmid {cmid}', make

    g = torch.randn((n, cout, hw), generator=gen).to(dev)
    gis = (torch.randn(cmid, generator=gen) * 0.2 + 1.0).to(dev)
    w2gis = (torch.randn((cmid, cout), generator=gen) * 0.3).to(dev)
    dx = torch.empty_like(x)

    if kernel == 'k2wb':
        xb, gb = x.to(torch.bfloat16), g.to(torch.bfloat16)
        dxb = torch.empty_like(xb)
        cols = fh.wide_sums_cols(cin, cmid, cout)

        def make(lib):
            blocks = lib.pf_head_bwd_wide_blocks(n, hw, cmid)
            partial = torch.empty((blocks, cols), device=dev)
            sums = torch.empty(cols, device=dev)
            return lambda: _cuda.check_status(lib.pf_head_bwd_wide_bf16(
                xb.data_ptr(), gb.data_ptr(), w1t.data_ptr(), gis.data_ptr(),
                c1.data_ptr(), w2gis.data_ptr(), dxb.data_ptr(),
                partial.data_ptr(), sums.data_ptr(), n, cin, hw, cmid, cout,
                blocks, stream()), 'K2 wide bf16')
        return f'K2 wide bf16 at x [{n},{cin},128,128], Cmid {cmid}', make
    if kernel == 'k2w':
        cols = fh.wide_sums_cols(cin, cmid, cout)
        img = torch.empty((cmid // 64, 4, 64 * 64), device=dev)

        def make(lib, grid=1):
            # grid: the sums kernel's blocks as a multiple of the entry's
            # own count.
            blocks = grid * lib.pf_head_bwd_wide_blocks(n, hw, cmid)
            partial = torch.empty((blocks, cols), device=dev)
            sums = torch.empty(cols, device=dev)
            scratch = (partial.data_ptr(), img.data_ptr())
            if not hasattr(lib, 'pf_head_wide_prep'):
                # An earlier source (no weight prep): no img pointer.
                lib.pf_head_bwd_wide.argtypes = \
                    fh._SIGNATURES['pf_head_bwd_wide'][1:]
                scratch = scratch[:1]

            def run():
                _cuda.check_status(lib.pf_head_bwd_wide(
                    x.data_ptr(), g.data_ptr(), w1t.data_ptr(),
                    gis.data_ptr(), c1.data_ptr(), w2gis.data_ptr(),
                    dx.data_ptr(), *scratch, sums.data_ptr(), n, cin, hw,
                    cmid, cout, blocks, stream()), 'K2 wide')
            run.sums = sums
            return run
        make.inputs = (x, g, w1t, gis, c1, w2gis)
        return f'K2 wide at x [{n},{cin},128,128], Cmid {cmid}', make

    def make(lib):
        blocks = lib.pf_head_bwd_blocks(n, hw)
        partial = torch.empty((blocks, lib.pf_head_bwd_partial_cols()),
                              device=dev)
        sums = torch.empty(partial.shape[1], device=dev)
        return lambda: _cuda.check_status(lib.pf_head_bwd(
            x.data_ptr(), g.data_ptr(), w1t.data_ptr(), gis.data_ptr(),
            c1.data_ptr(), w2gis.data_ptr(), dx.data_ptr(),
            partial.data_ptr(), sums.data_ptr(), n, cin, hw, cmid, cout,
            blocks, stream()), 'K2')
    return f'K2 at x [{n},{cin},128,128], Cmid {cmid}', make


def k1w_errors(inputs, runs: dict, images: int = 16) -> None:
    """Print each k1w run's output against K1's arithmetic in float64
    (out = w2 relu(g1t x + c1) + b2, ``images`` images at a time), as the
    largest absolute error beside max|out| (the card tests' tolerance is
    1e-4 (1 + max|out|))."""
    x, g1t, c1, w2, b2 = inputs
    ref = torch.cat([
        torch.einsum('oc,ncs->nos', w2.double(), torch.relu(
            torch.einsum('ck,nks->ncs', g1t.double(), xi.double())
            + c1.double()[:, None])) + b2.double()[:, None]
        for xi in x.split(images)])
    scale = float(ref.abs().max())
    for label, run in runs.items():
        run()
        torch.cuda.synchronize()
        err = float((run.out.double() - ref).abs().max())
        print(f'  {label}: max abs error against float64 {err:.3e} (max|out| '
              f'{scale:.3f}, tolerance {1e-4 * (1 + scale):.3e})')


def k2w_sums_errors(inputs, runs: dict, images: int = 16) -> None:
    """Print each k2w run's sums (dw1 | M0 | M1 | db2) against the plain
    moment pass in float64 (``images`` images at a time), as error over
    max|ref| per moment; how far the as-built sums and those of its sums
    grid at twice the blocks (the same tiles, summed in another order) lie
    apart; and how far mask flips could move dw1: the sum of |x e| over
    middle values whose float64 pre-activation lies within 1e-5 of the
    ReLU kink."""
    x, g, w1t, gis, c1, w2gis = (t.double() for t in inputs)
    n, cin, hw = x.shape
    cmid, cout = w2gis.shape
    ref, slack, near = [0.0] * 4, 0.0, 0
    for i in range(0, n, images):
        xi, gi = x[i:i + images], g[i:i + images]
        _, m0, m1, db2, dw1 = fh.pf_head_bwd_plain(
            xi[..., None], gi[..., None], w1t, gis, c1, w2gis)
        ref = [r + p for r, p in zip(ref, (dw1, m0, m1, db2))]
        pre = gis[:, None] * torch.einsum('ck,nks->ncs', w1t, xi) \
            + c1[:, None]
        kink = pre.abs() < 1e-5
        near += int(kink.sum())
        eun = torch.einsum('co,nos->ncs', w2gis, gi).abs() * kink
        slack = slack + torch.einsum('nks,ncs->kc', xi.abs(), eun)
    ref = [r.flatten() for r in ref]
    sizes = [r.numel() for r in ref]
    scale = [float(r.abs().max()) for r in ref]
    got = {}
    for label, run in runs.items():
        run()
        torch.cuda.synchronize()
        got[label] = torch.split(run.sums.double(), sizes)
        print(f'  {label}: sums against float64 (error / max|ref|): '
              + ', '.join(f'{k} {float((a - b).abs().max()) / s:.3e}'
                          for k, a, b, s in zip(K2W_SUMS, got[label], ref,
                                                scale)))
    print(f'  as built against {K2W_GRID2} (/ max|ref|): ' + ', '.join(
        f'{k} {float((a - b).abs().max()) / s:.3e}' for k, a, b, s in zip(
            K2W_SUMS, got['as built'], got[K2W_GRID2], scale))
        + f'; {near} middle values within 1e-5 of the kink, whose mask '
        f'flips could move dw1 by up to {float(slack.max()) / scale[0]:.3e}')


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--kernel', choices=sorted(CUTS), default='k2')
    parser.add_argument('--baseline', type=Path, default=None,
                        help='another version of the kernel\'s source file, '
                        'timed beside the one in csrc/')
    parser.add_argument('--cmid', type=int, default=None,
                        help='K1\'s middle width (default 128; K2 takes 128 '
                        'only, k1w, k2w, k1wb and k2wb 512)')
    parser.add_argument('--batch_size', type=int, default=64)
    parser.add_argument('--rounds', type=int, default=2)
    parser.add_argument('--no_cuts', action='store_true',
                        help='time only the kernel as built and the baseline')
    args = parser.parse_args(argv)
    cmid = args.cmid or (512 if args.kernel in WIDE else 128)
    if not torch.cuda.is_available():
        raise SystemExit('profile_kernels needs a CUDA device')
    name, source = args.kernel, SOURCES[args.kernel]
    src = (_cuda.CSRC / f'{source}.cu').read_text()
    labels = {f'{name}_as_built': 'as built'}
    sources = {f'{name}_as_built': src}
    if args.baseline is not None:
        labels[f'{name}_baseline'] = f'baseline {args.baseline}'
        sources[f'{name}_baseline'] = args.baseline.read_text()
    for i, (cut_name, cut) in enumerate(
            {} if args.no_cuts else CUTS[name].items()):
        labels[f'{name}_variant{i}'] = cut_name
        sources[f'{name}_variant{i}'] = cut(src)
    libs = {labels[k]: lib for k, lib in _build(sources, source).items()}
    for kernel in SASS_NAMES[name]:
        counts = sass_counts(_cuda.BUILD_DIR / f'lib{name}_as_built.so',
                             kernel)
        print(f'{name.upper()} SASS of {kernel}: {sum(counts.values())} '
              'instructions; ' + ', '.join(
                  f'{op} {k}' for op, k in counts.most_common(12))
              + f'; HGMMA {counts["HGMMA"]}, HMMA {counts["HMMA"]}')

    describe, make = _runner_factory(name, args.batch_size, cmid)
    runs = {label: make(lib) for label, lib in libs.items()}
    if name == 'k2w':
        runs[K2W_GRID2] = make(libs['as built'], grid=2)
    times = {label: [] for label in runs}
    for _ in range(args.rounds):
        for label, run in runs.items():
            times[label].append(time_ms(run))
        times['as built'].append(time_ms(runs['as built']))
    print(f'{describe} on {torch.cuda.get_device_name(0)}: ms per call '
          f'(every reading), and the median saved against the kernel as '
          f'built')
    base = sorted(times['as built'])[len(times['as built']) // 2]
    for label, ts in times.items():
        mid = sorted(ts)[len(ts) // 2]
        print(f'  {label:48s} {" ".join(f"{t:.4f}" for t in ts)}'
              + ('' if label == 'as built' else f'  saves {base - mid:.4f}'))
    if args.baseline is not None:
        hosts = {label: [] for label in runs
                 if label == 'as built' or label.startswith('baseline')}
        for _ in range(3):
            for label in hosts:
                hosts[label].append(host_us(runs[label]))
        print('  host us per call (C entry point, in turns): ' + '; '.join(
            f'{label} ' + ' '.join(f'{us:.2f}' for us in readings)
            for label, readings in hosts.items()))
    if name in ('k1w', 'k2w', 'k2wb'):
        names = {'k1w': K1W_KERNELS, 'k2w': K2W_KERNELS,
                 'k2wb': K2WB_KERNELS}[name]
        for label, run in runs.items():
            parts = kernel_ms(run, names)
            print(f'  {label}: device ms per call by kernel (profiler): '
                  + ', '.join(f'{k} {parts[k]:.4f}' for k in names
                              if k in parts)
                  + f'; sum {sum(parts.values()):.4f}')
    if name == 'k1w':
        k1w_errors(make.inputs, {
            label: run for label, run in runs.items()
            if label == 'as built' or label.startswith('baseline')})
    if name == 'k2w':
        k2w_sums_errors(make.inputs, {
            label: run for label, run in runs.items()
            if label in ('as built', K2W_GRID2)
            or label.startswith('baseline')})


if __name__ == '__main__':
    main()
