"""Where a hand-written kernel spends its time on the card, and how it
compares with another version of its source.

    python -m bihome_torch.profile_kernels \\
        --kernel k1|k1b|k1w|k1wb|k2|k2b|k2w|k2wb|k3|k4|k5 \\
        [--baseline FILE] \\
        [--cmid C] [--batch_size 64] [--rounds 2] \\
        [--no_cuts] [--phases] [--mma_rate] [--sass DIR]

No kernel profiler runs on the machine with the card, so this builds
variants of the kernel's source (``csrc/fused_head.cu`` for K1, K2 and
the ResNet50-flavour K1 and K2, ``k1w`` and ``k2w``, and their bf16
forms, ``k1wb`` and ``k2wb``; ``csrc/warp.cu`` for K3, K4 and K5) with one
part cut
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
= 16,384 points each; K5 (:func:`profile_k5`) at the four shapes of its
paths, 2B images of 128x128: the loss warp (C = 1 and, patch and mask,
C = 2; P = 16,384) and the upsample grid at 2x and 4x broadcast over the
batch (P = 65,536 and 262,144), also at S forced to 1-4, with its device
ops per call under torch.profiler (one kernel, no memset); K3
(:func:`profile_k3`) at the shapes of its C > 1 and upsample paths: image_2
(64 RGB frames of 240x320, P = 76,800), the RGB window warp (64 windows of
192x192x3 on pds-coco's geometry, P = 16,384), the masked loss warp (2B
patches of 128x128x2, P = 16,384) and the upsample grid at 2x and 4x (2B
patches of 128x128x1, the grid one row broadcast over the batch, and
materialised), beside grid_sample, interpolate, the bytes bound and the
plain version, with its host us per call and device ops per wrapper call.
``--no_cuts`` times only the kernel as built and the baseline. Needs a
CUDA device.

``k1b`` and ``k2b`` are the narrow (Cin 16) K1 and K2 at bf16, at the
zeng shape (x [2B,16,128,128] bf16, Cmid 128). For them and for k1wb and
k2wb the profiler also prints ptxas's report of each kernel (registers,
spills, shared memory), the host us per call of the Python wrapper as
built and, with ``--baseline``, of the baseline's wrapper
(``ops/fused_head.py`` beside the baseline's ``csrc/``, run on the
baseline's library) and how far the outputs of the two lie apart.
``--phases`` (k2b; k2wb at the R50 head) times the PF head's whole
backward at bf16 in parts with CUDA events: ``pf_head_backward`` with
and without the batch-statistics corrections, K2 alone through its
wrapper, each statement of the corrections, and the forward's
``batch_stats_affine`` (:func:`bwd_phases`). ``--mma_rate`` first
prints the rate and latency of mma.sync m16n8k16 bf16 on the card
(:func:`mma_rate`); ``--sass DIR`` writes the SASS of the kernel as built
there.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import importlib.util
import re
import subprocess
import types
from pathlib import Path

import torch

from bihome_torch import geometry
from bihome_torch.models.layers import widen
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

# The ResNet50-flavour kernels at bf16 (k1wb, k2wb; wgmma bf16, 64-pixel
# tiles per warpgroup). WG_NO_PRODUCTS cuts every wgmma of the file (here:
# mid, K1's Cmid x Cout product, dx, dw1, M0); the rest cut one part each,
# or change a choice of the design.
# With the loads after the first two tiles of each ring cut, the waits
# for them go too (the tensor memory accelerator would never complete
# their barriers); every kernel of the source then skips those waits.
_NO_LATER_WAITS = _cut(
    '  if (kVec) mbar_wait(bars + i % kStages, (i / kStages) & 1);',
    '  if (kVec && i < 2) mbar_wait(bars + i % kStages, (i / kStages) & 1);')
K1WB_CUTS = [
    WG_NO_PRODUCTS,
    ('no c1, ReLU and rounding (accumulator bits as A)', _cut(
        '                  cvt_relu_bf16x2(mid[h][4 * j + 2 * hh] + cc.x,\n'
        '                                  mid[h][4 * j + 2 * hh + 1] + '
        'cc.y);',
        '                  __float_as_uint(mid[h][4 * j + 2 * hh]) ^\n'
        '                  __float_as_uint(mid[h][4 * j + 2 * hh + 1]);')),
    ('no Cmid x Cout product', _cut(
        '          wgmma_bf16_rs_n8(acc, ra[h][ks], wo + kKStep * ks, 1);\n',
        '          acc[ks] += __uint_as_float(ra[h][ks][0] ^ ra[h][ks][3]);\n'
        )),
    ('no stores', _cut(
        '        if (s + 8 * h < hw) {\n          o0[s + 8 * h]',
        '        if (s + 8 * h < hw && acc[0] == -1.25e-30f) {\n'
        '          o0[s + 8 * h]')),
    ('no x loads after the first tiles (time only)', _cut(
        '      if (next < ntiles) {\n'
        '        load_wide_bf16_stage<kVec, false>(',
        '      if (next < 0) {\n        load_wide_bf16_stage<kVec, false>(',
        _NO_LATER_WAITS)),
    ('four warpgroups a block', _cut(
        'constexpr int kK1WG = 3;', 'constexpr int kK1WG = 4;')),
]
K2WB_CUTS = [
    WG_NO_PRODUCTS,
    ('dx: no epilogue (accumulator bits as A)', _cut(
        '              const float on = set_gt(mid[4 * j + 2 * hh + cc], '
        'p[cc].x);\n'
        '              e[cc] = on * fmaf(p[cc].y, gv[hh][0], p[cc].z * '
        'gv[hh][1]);\n',
        '              e[cc] = mid[4 * j + 2 * hh + cc];\n')),
    ('dx: no dx stores', _cut(
        '          if (s0 + 8 * b < hw) {\n'
        '            *reinterpret_cast<uint4*>(dn',
        '          if (s0 + 8 * b < hw && dxa[0] == -1.25e-30f) {\n'
        '            *reinterpret_cast<uint4*>(dn')),
    ('dx: no x, g loads after the first tiles (time only)', _cut(
        '      if (next < ntiles) {\n'
        '        load_wide_bf16_stage<kVec, true>(\n'
        '            ring +',
        '      if (next < 0) {\n        load_wide_bf16_stage<kVec, true>(\n'
        '            ring +', _NO_LATER_WAITS)),
    ('sums: no M1 sums', _cut(
        '        m1[hh][0] = fmaf(mm, g0, m1[hh][0]);\n'
        '        m1[hh][1] = fmaf(mm, g1, m1[hh][1]);\n', '')),
    ('sums: no M0 products', _cut(
        '    wgmma_bf16_rs_n8(m0, ma[ks], gd + kKStep * ks, 1);\n', '')),
    ('sums: no turns (warpgroups issue freely)', _cut(
        '      named_sync(kSumsTurn + wg, 128 * kSumsWG);\n', '', _cut(
            '      named_arrive(kSumsTurn + (wg ^ 1), 128 * kSumsWG);\n', '',
            _cut('  if (wg == 1) named_arrive(kSumsTurn, 128 * kSumsWG);', '',
                 _cut('  if (wg == 0) named_sync(kSumsTurn, 128 * kSumsWG);',
                      ''))))),
    ('sums: no x, g loads after the first tiles (time only)', _cut(
        '      if (next < ntiles) {\n        load_sums_stage<kVec>(',
        '      if (next < 0) {\n        load_sums_stage<kVec>(',
        _NO_LATER_WAITS)),
    ('dx: four warpgroups a block', _cut(
        'constexpr int kDxWG = 3;', 'constexpr int kDxWG = 4;')),
    ('sums: loads 3 tiles ahead', _cut(
        'constexpr int kSumsAhead = 2;', 'constexpr int kSumsAhead = 3;')),
]

# The narrow kernels' every mma.sync bf16 product cut (each accumulator
# keeps its input).
_NO_MMA_BF16 = ('no tensor-core products', lambda src: re.sub(
    r'asm\("mma\.sync\.aligned\.m16n8k16.*?\);',
    'for (int i = 0; i < 4; ++i) d[i] = c[i];', src, count=1, flags=re.S))
# The narrow kernels at bf16 (k1b, k2b: rings of cp.async stages,
# ldmatrix/stmatrix, M0 and K1's Cmid x Cout product on the tensor cores).
K1B_CUTS = [
    _NO_MMA_BF16,
    ('no ReLU and rounding (accumulator bits as A)', _cut(
        '    const uint32_t r[4] = {cvt_relu_bf16x2(d0[0], d0[1]),\n'
        '                           cvt_relu_bf16x2(d0[2], d0[3]),\n'
        '                           cvt_relu_bf16x2(d1[0], d1[1]),\n'
        '                           cvt_relu_bf16x2(d1[2], d1[3])};\n',
        '    const uint32_t r[4] = {__float_as_uint(d0[0]), '
        '__float_as_uint(d0[3]), __float_as_uint(d1[0]), '
        '__float_as_uint(d1[3])};\n')),
    ('no Cmid x Cout product', _cut(
        '    mma_bf16(acc[mt][parity], r, bw, acc[mt][parity]);\n',
        '    acc[mt][parity][0] += __uint_as_float(r[0] ^ r[1] ^ r[2] ^ r[3] '
        '^ bw[0]);\n')),
    ('step loop unrolled at Cmid 128 (wrong elsewhere)', _cut(
        '    for (int j = 0; j < steps; j += 2) {\n      fwd_bf16_load_step(',
        '#pragma unroll\n    for (int j = 0; j < 8; j += 2) {\n'
        '      fwd_bf16_load_step(')),
    ('no stores', _cut(
        '          if (s < hw) {\n            o0[s] =',
        '          if (s < hw && v0 == -1.25e-30f) {\n            o0[s] =')),
    ('no x loads after the first tile', _cut(
        '      if (next < ntiles) {\n        load_fwd_tile_bf16<kVec>(',
        '      if (next < 0) {\n        load_fwd_tile_bf16<kVec>(')),
    ('two stages in the ring (one tile ahead)', _cut(
        'constexpr int kB1Stages = 4;', 'constexpr int kB1Stages = 2;')),
    ('two m-tiles a warp (256-pixel tiles)', _cut(
        'constexpr int kB1MT = 4;', 'constexpr int kB1MT = 2;')),
    ('no tile barrier (races; time only)', _cut(
        "    __syncthreads();  // this tile's x in; the tile before done by "
        "all\n    {\n      const int next = tile + (kB1Stages - 1)",
        "    {\n      const int next = tile + (kB1Stages - 1)")),
]
K2B_CUTS = [
    _NO_MMA_BF16,
    ('no M1 sums', _cut(
        '      m1[ch][0] = fmaf(mm, g0, m1[ch][0]);\n'
        '      m1[ch][1] = fmaf(mm, g1, m1[ch][1]);\n', '')),
    ('no M0 product (and its mask pairs)', _cut(
        '    mma_bf16(m0, a, c.bg, m0);\n', '')),
    ('no e tile (stmatrix)', _cut(
        '    stsm_x4_trans(se + (p0 + (lane & 7) + ((lane >> 4) << 3)) '
        '* kB2SE +', '    if (r[0] == 0x7fc00001u) stsm_x4_trans(se + '
        '(p0 + (lane & 7) + ((lane >> 4) << 3)) * kB2SE +')),
    ('no tile barrier (races; time only)', _cut(
        '    __syncthreads();  // bf16(e) of the whole tile in; the next '
        'tile\'s x, g in\n', '')),
    ('no dx products (their ldmatrix and mma)', _cut(
        '    bwd_bf16_dx(se, s_aw, lane, warp, dxa);\n',
        '    for (int h = 0; h < 2; ++h)\n'
        '      for (int r = 0; r < 4; ++r) dxa[h][r] = 0.0f;\n')),
    ('no dx stores', _cut(
        '    bwd_bf16_dx_store<kVec>(dx, dxa, tile, tpi, hw, lane, warp);\n',
        '    if (dxa[0][0] == -1.25e-30f) bwd_bf16_dx_store<kVec>(dx, dxa, '
        'tile, tpi, hw, lane, warp);\n')),
    ('no x, g loads after the first tile', _cut(
        '      if (next < ntiles) {\n        load_tile_bf16<kVec>(',
        '      if (next < 0) {\n        load_tile_bf16<kVec>(')),
    ('two stages in the ring (one tile ahead)', _cut(
        'constexpr int kB2Stages = 4;', 'constexpr int kB2Stages = 2;')),
]


# Each turns the source into a variant without one part of the kernel, or
# with it done another way.
# K5's cluster kernel: every point flushes its own taps (no merge in
# registers), each tap a plain shared store instead of an atomic (what the
# atomics cost), or the shared copy unswizzled (what bank conflicts cost).
# S = 1 (one block a sample, no cluster) is a run of the kernel as built
# (the C entry's ``cluster`` argument).
K5_CUTS = [
    ('no register merge', _cut(
        'const bool same = k > 0 && t.r0 == r0 && m == mk;',
        'const bool same = false;')),
    ('shared atomics replaced by a plain store', _cut(
        '  atomicAdd(s + swizzle(i), a);\n}', '  s[swizzle(i)] = a;\n}')),
    ('no point loop (zeroing, syncs, reduction only)', _cut(
        '  while (q < q_end) {', '  while (q < 0) {')),
    ('no swizzle (bank conflicts)', _cut(
        'int swizzle(int a) { return a ^ ((a >> 5) & 31); }',
        'int swizzle(int a) { return a; }')),
]
# K3's C > 1 kernel done another way: the block's source footprint (the
# bounding box of its points' taps inside the image, C floats a pixel)
# copied into shared memory first where it fits in 12,000 floats, the taps
# then read from there (else from the image, as built). Threads past P stay
# for the block's barriers.
_K3_TILE_PROLOGUE = """\
  __shared__ float tile[kC > 0 ? 12000 : 1];
  __shared__ int box[4];
  bool tiled = false;
  int bx0 = 0, by0 = 0, bw = 0;
  if constexpr (kC > 0) {
    int lo_x = w, hi_x = -1, lo_y = h, hi_y = -1;
#pragma unroll
    for (int k = 0; k < kCnPoints; ++k) {
      const float fx = floorf(x[k]), fy = floorf(y[k]);
      if (q + k < p && fx >= -1.0f && fx <= (float)(w - 1) && fy >= -1.0f &&
          fy <= (float)(h - 1)) {
        const int ix = (int)fx, iy = (int)fy;
        lo_x = min(lo_x, max(ix, 0));
        hi_x = max(hi_x, min(ix + 1, w - 1));
        lo_y = min(lo_y, max(iy, 0));
        hi_y = max(hi_y, min(iy + 1, h - 1));
      }
    }
    if (threadIdx.x == 0) {
      box[0] = w; box[1] = -1; box[2] = h; box[3] = -1;
    }
    __syncthreads();
    lo_x = __reduce_min_sync(0xffffffffu, lo_x);
    hi_x = __reduce_max_sync(0xffffffffu, hi_x);
    lo_y = __reduce_min_sync(0xffffffffu, lo_y);
    hi_y = __reduce_max_sync(0xffffffffu, hi_y);
    if ((threadIdx.x & 31) == 0) {
      atomicMin(&box[0], lo_x); atomicMax(&box[1], hi_x);
      atomicMin(&box[2], lo_y); atomicMax(&box[3], hi_y);
    }
    __syncthreads();
    bx0 = box[0];
    by0 = box[2];
    bw = box[1] - box[0] + 1;
    const int bh = box[3] - box[2] + 1;
    tiled = bw > 0 && bh > 0 && bw * bh * kC <= 12000;
    if (tiled) {
      const int row = bw * kC;
      for (int i = threadIdx.x; i < row * bh; i += kCnThreads) {
        const int r = i / row;
        tile[i] = __ldg(im + ((by0 + r) * w + bx0) * kC + (i - r * row));
      }
    }
    __syncthreads();
  }
  if (q >= p) return;
"""
_K3_TILE_GATHER = """\
    if (tiled) {
      const int tx = (int)fminf(fmaxf(floorf(x[k]), -2.0f), (float)w + 1.0f);
      const int ty = (int)fminf(fmaxf(floorf(y[k]), -2.0f), (float)h + 1.0f);
      const float* s0 = tile + ((ty - by0) * bw + (tx - bx0)) * kCh;
      const float* s1 = s0 + bw * kCh;
#pragma unroll
      for (int ci = 0; ci < kCh; ++ci) {
        const float t00 = t.v00 ? s0[ci] : 0.0f;
        const float t01 = t.v01 ? s0[kCh + ci] : 0.0f;
        const float t10 = t.v10 ? s1[ci] : 0.0f;
        const float t11 = t.v11 ? s1[kCh + ci] : 0.0f;
        o[k * kCh + ci] = t00 * w00 + t01 * w01 + t10 * w10 + t11 * w11;
      }
    } else if constexpr (kC > 0) {
"""
_K3_TILE = _cut(
    '  if (q >= p) return;\n  const float* im = img', '  const float* im = img',
    _cut('  if (kVec) {\n    if constexpr (kCnPoints == 4)',
         '  if (kVec && q < p) {\n    if constexpr (kCnPoints == 4)',
         _cut('  float o[kCnPoints * kCh];\n',
              _K3_TILE_PROLOGUE + '  float o[kCnPoints * kCh];\n',
              _cut('    if constexpr (kC > 0) {\n      float t00[kC]',
                   _K3_TILE_GATHER + '      float t00[kC]'))))
# K3's C > 1 kernel (cut at its C > 1 shapes only): no tap gathers (what
# the gathers cost), no output stores (what the stores cost), the taps
# read channel by channel, the source tile above, other counts of points a
# thread and of threads a block.
K3_CUTS = [
    ('no tap gathers', _cut(
        '      fetch_tap<kC, kAligned>(p0, t.v00, t00);\n'
        '      fetch_tap<kC, kAligned>(p0 + kC, t.v01, t01);\n'
        '      fetch_tap<kC, kAligned>(p1, t.v10, t10);\n'
        '      fetch_tap<kC, kAligned>(p1 + kC, t.v11, t11);\n',
        '      for (int i = 0; i < kC; ++i) {\n'
        '        t00[i] = t.v00; t01[i] = t.v01; t10[i] = t.v10; '
        't11[i] = t.v11;\n      }\n')),
    ('no output stores', _cut(
        '      store_floats<kCnPoints * kC>(d, o);',
        '      if (o[0] == -1.25e-30f) store_floats<kCnPoints * kC>(d, o);')),
    ('taps channel by channel', _cut('constexpr bool kCnVecTaps = true;',
                                     'constexpr bool kCnVecTaps = false;')),
    ('source tile in shared memory', _K3_TILE),
    ('1 point a thread', _cut('constexpr int kCnPoints = 2;',
                              'constexpr int kCnPoints = 1;')),
    ('4 points a thread', _cut('constexpr int kCnPoints = 2;',
                               'constexpr int kCnPoints = 4;')),
    ('128 threads a block', _cut('constexpr int kCnThreads = 256;',
                                 'constexpr int kCnThreads = 128;')),
]
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
    'k1b': dict(K1B_CUTS),
    'k2b': dict(K2B_CUTS),
    'k3': dict(K3_CUTS),
    'k4': {},
    'k5': dict(K5_CUTS),
}
SOURCES = {k: 'warp' if k in ('k3', 'k4', 'k5') else 'fused_head'
           for k in CUTS}
WIDE = ('k1w', 'k2w', 'k1wb', 'k2wb')
# The bf16 kernels: ptxas's report, the Python wrapper's host cost and the
# outputs against the baseline's are printed for them.
BF16 = ('k1b', 'k2b', 'k1wb', 'k2wb')
# The kernels whose SASS is counted (their mangled names start so).
SASS_NAMES = {'k1': ('pf_head_fwd_kernelILb1',),
              'k1b': ('pf_head_fwd_bf16_kernelILb1',),
              'k2b': ('pf_head_bwd_bf16_kernelILb1',),
              'k1w': ('pf_head_fwd_wgmma_kernelILb1',),
              'k2': ('pf_head_bwd_kernelILb1',),
              'k2w': ('pf_head_bwd_wide_dx_kernelILb1',
                      'pf_head_bwd_wide_sums_kernelILb1'),
              'k1wb': ('pf_head_fwd_wide_bf16_kernelILb1',),
              'k2wb': ('pf_head_bwd_wide_bf16_dx_kernelILb1',
                       'pf_head_bwd_wide_bf16_sums_kernelILb1'),
              'k3': ('bilinear_sample_cn_kernelILi3ELb1ELb0',
                     'bilinear_sample_cn_kernelILi2ELb1ELb1',
                     'bilinear_sample_c1_kernelILb1'),
              'k4': ('bilinear_sample_bwd_uv_c1_kernelILb1',),
              'k5': ('bilinear_sample_bwd_img_cluster_kernelILi1ELb1',
                     'bilinear_sample_bwd_img_cluster_kernelILi2ELb1')}
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


def build_sources(sources: dict, entry_points: str) -> dict:
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
        lib.log = log
        libs[name] = lib
    return libs


def sass_text(so: Path, kernel: str) -> str:
    """The SASS (cuobjdump) of the function whose mangled name contains
    ``kernel`` in ``so``."""
    cuobjdump = Path(_cuda._nvcc()).with_name('cuobjdump')
    sass = subprocess.run([str(cuobjdump), '-sass', str(so)], check=True,
                          capture_output=True, text=True).stdout
    lines, inside = [], False
    for line in sass.splitlines():
        if 'Function :' in line:
            inside = kernel in line
        if inside:
            lines.append(line)
    return '\n'.join(lines)


def sass_counts(so: Path, kernel: str) -> collections.Counter:
    """Opcode counts of the SASS of the function whose mangled name
    starts with ``kernel`` in ``so``."""
    counts = collections.Counter()
    for line in sass_text(so, kernel).splitlines():
        m = re.match(r'\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)',
                     line)
        if m:
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
    if kernel == 'k1b':
        xb = x.to(torch.bfloat16)
        w2 = (torch.randn((cout, cmid), generator=gen) * 0.3).to(dev)
        b2 = (torch.randn(cout, generator=gen) * 0.1).to(dev)

        def make(lib):
            out = torch.empty((n, cout, hw), dtype=torch.bfloat16, device=dev)

            def run():
                _cuda.check_status(lib.pf_head_fwd_bf16(
                    xb.data_ptr(), w1t.data_ptr(), c1.data_ptr(),
                    w2.data_ptr(), b2.data_ptr(), out.data_ptr(), n, cin, hw,
                    cmid, cout, stream()), 'K1 bf16')
            run.outs = {'out': out}
            return run
        return f'K1 bf16 at x [{n},{cin},128,128], Cmid {cmid}', make
    if kernel == 'k1wb':
        xb = x.to(torch.bfloat16)
        w2 = (torch.randn((cout, cmid), generator=gen) * 0.3).to(dev)
        b2 = (torch.randn(cout, generator=gen) * 0.1).to(dev)

        def make(lib):
            out = torch.empty((n, cout, hw), dtype=torch.bfloat16, device=dev)

            def run():
                _cuda.check_status(lib.pf_head_fwd_wide_bf16(
                    xb.data_ptr(), w1t.data_ptr(), c1.data_ptr(),
                    w2.data_ptr(), b2.data_ptr(), out.data_ptr(), n, cin, hw,
                    cmid, cout, stream()), 'K1 wide bf16')
            run.outs = {'out': out}
            return run
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

    if kernel == 'k2b':
        xb, gb = x.to(torch.bfloat16), g.to(torch.bfloat16)

        def make(lib):
            # An earlier source sized the bf16 grid as the fp32 one's.
            blocks = getattr(lib, 'pf_head_bwd_bf16_blocks',
                             lib.pf_head_bwd_blocks)(n, hw)
            partial = torch.empty((blocks, lib.pf_head_bwd_partial_cols()),
                                  device=dev)
            sums = torch.empty(partial.shape[1], device=dev)
            dxb = torch.empty_like(xb)

            def run():
                _cuda.check_status(lib.pf_head_bwd_bf16(
                    xb.data_ptr(), gb.data_ptr(), w1t.data_ptr(),
                    gis.data_ptr(), c1.data_ptr(), w2gis.data_ptr(),
                    dxb.data_ptr(), partial.data_ptr(), sums.data_ptr(), n,
                    cin, hw, cmid, cout, blocks, stream()), 'K2 bf16')
            run.outs = {'dx': dxb, 'sums': sums}
            return run
        return f'K2 bf16 at x [{n},{cin},128,128], Cmid {cmid}', make
    if kernel == 'k2wb':
        xb, gb = x.to(torch.bfloat16), g.to(torch.bfloat16)
        cols = fh.wide_sums_cols(cin, cmid, cout)

        def make(lib):
            blocks = lib.pf_head_bwd_wide_blocks(n, hw, cmid)
            partial = torch.empty((blocks, cols), device=dev)
            sums = torch.empty(cols, device=dev)
            dxb = torch.empty_like(xb)

            def run():
                _cuda.check_status(lib.pf_head_bwd_wide_bf16(
                    xb.data_ptr(), gb.data_ptr(), w1t.data_ptr(),
                    gis.data_ptr(), c1.data_ptr(), w2gis.data_ptr(),
                    dxb.data_ptr(), partial.data_ptr(), sums.data_ptr(), n,
                    cin, hw, cmid, cout, blocks, stream()), 'K2 wide bf16')
            run.outs = {'dx': dxb, 'sums': sums}
            return run
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


def _rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def ptxas_report(log: str, kernel: str) -> list:
    """ptxas's lines (registers, spills, shared memory) about the function
    whose mangled name starts with ``kernel``, from nvcc's -Xptxas=-v log."""
    lines, inside = [], False
    for line in log.splitlines():
        if 'Compiling entry function' in line or 'Function properties' in line:
            inside = kernel in line
        if inside:
            lines.append(line.strip())
    return lines


def _wrapper_module(path: Path, lib, label: str):
    """``ops/fused_head.py`` at ``path`` loaded as a module of its own whose
    kernels run on ``lib`` (a library built by this profiler)."""
    spec = importlib.util.spec_from_file_location(
        f'profiled_fused_head_{label}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    shim = {k: v for k, v in vars(_cuda).items() if not k.startswith('__')}
    shim['library'] = lambda name, signatures: lib
    mod._cuda = types.SimpleNamespace(**shim)
    return mod


def _head_inputs(batch: int, cmid: int = 128, seed: int = 1,
                 cin: int = 16):
    """The PF head's inputs at bf16, at the zeng shape (Cin 16) or the R50
    one (Cin 64): x (a ReLU output) [2B,Cin,128,128], its cotangent g
    [2B,2,128,128], the torch conv weights, BN parameters and x's batch
    statistics."""
    gen = torch.Generator().manual_seed(seed)
    dev = torch.device('cuda')
    n, cout, hw = 2 * batch, 2, 128

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(dev)
    x = torch.relu(rnd(n, cin, hw, hw)).to(torch.bfloat16)
    g = rnd(n, cout, hw, hw).to(torch.bfloat16)
    w1, b1 = rnd(cmid, cin, 1, 1, scale=0.3), rnd(cmid, scale=0.2)
    gamma, beta = rnd(cmid, scale=0.2, shift=1.0), rnd(cmid, scale=0.1)
    w2, b2 = rnd(cout, cmid, 1, 1, scale=0.3), rnd(cout, scale=0.1)
    mean, var = fh.batch_stats_affine(x, w1, b1)
    return x, g, w1, b1, gamma, beta, w2, b2, mean, var


def wrapper_calls(kernel: str, batch: int, cmid: int, wrappers: dict):
    """{label: a call of the Python wrapper of K1 bf16 (k1b, k1wb) or K2
    bf16 (k2b, k2wb) in module ``wrappers[label]``} at the zeng shape (the
    R50 head's for k1wb and k2wb)."""
    cin = 64 if kernel in WIDE else 16
    x, g, w1, b1, gamma, beta, w2, b2, mean, var = _head_inputs(
        batch, cmid, cin=cin)
    if kernel in ('k1b', 'k1wb'):
        return {label: (lambda m=m: m.fused_pf_head_fwd(
            x, w1, b1, gamma, beta, w2, b2, mean, var))
            for label, m in wrappers.items()}
    gis = gamma * torch.rsqrt(var + 1e-5)
    c1 = (gis * (b1 - mean) + beta).contiguous()
    w1t = w1.reshape(cmid, cin).contiguous()
    w2gis = (w2.reshape(2, cmid).t() * gis[:, None]).contiguous()
    return {label: (lambda m=m: m.fused_pf_head_bwd(x, g, w1t, gis, c1, w2gis))
            for label, m in wrappers.items()}


def bwd_phases(batch: int, fh=fh, cin: int = 16, cmid: int = 128) -> None:
    """Device ms of the PF head's backward at bf16 at the zeng shape (or
    the R50 head's, Cin 64 and Cmid 512: the wide K2 bf16), in parts
    (CUDA events, ``time_ms``): the whole ``pf_head_backward`` with
    the batch-statistics corrections and without them, K2 bf16 alone, the
    statements of the corrections (``ops/fused_head.py``,
    ``pf_head_backward``'s ``train_stats`` branch, repeated here one by one
    on the same tensors), and the forward's ``batch_stats_affine``; ``fh``
    the wrapper module whose kernels run."""
    x, g, w1, b1, gamma, beta, w2, _, mean, var = _head_inputs(
        batch, cmid, cin=cin)
    eps, dt = 1e-5, x.dtype
    n, cin, cmid = x.shape[0], x.shape[1], w1.shape[0]
    m = x.numel() // cin
    inv_s = torch.rsqrt(var + eps)
    gis = gamma * inv_s
    cn = inv_s * (b1 - mean)
    c1 = (gamma * cn + beta).contiguous()
    w1t = w1.reshape(cmid, cin).contiguous()
    w1f = w1t.t()
    w2f = w2.reshape(2, cmid).t()
    w2gis = (w2f * gis[:, None]).contiguous()
    dx, m0, m1, _, _ = fh.fused_pf_head_bwd(x, g, w1t, gis, c1, w2gis)
    sum_da, sum_da_mid = (w2f * m0).sum(1), (w2f * m1).sum(1)
    sum_dan = inv_s * sum_da_mid + cn * sum_da
    k1 = gis * inv_s * (sum_dan / m)
    k0 = -gis * (sum_da / m) - gis * (sum_dan / m) * cn
    a_mat = (w1f * k1[None, :]) @ w1f.t()
    x3 = widen(x).reshape(n, cin, -1)
    corr = torch.matmul(fh._rounded(a_mat, dt), x3).reshape(x.shape)
    args = (x, g, w1, b1, gamma, beta, w2, mean, var, eps)
    parts = {
        'pf_head_backward, batch statistics (K2 + corrections)':
            lambda: fh.pf_head_backward(*args, True),
        'pf_head_backward, given statistics (no corrections)':
            lambda: fh.pf_head_backward(*args, False),
        f'K2{" wide" if cin == 64 else ""} bf16 alone (fused_pf_head_bwd)':
            lambda: fh.fused_pf_head_bwd(x, g, w1t, gis, c1, w2gis),
        'corrections: widen(x) [N,Cin,HW] float32':
            lambda: widen(x).reshape(n, cin, -1),
        'corrections: sx = x3.sum':
            lambda: x3.sum(dim=(0, 2)),
        'corrections: sxx = x3 x3^T summed':
            lambda: torch.matmul(x3, x3.transpose(1, 2)).sum(0),
        'corrections: corr = bf16(a_mat) x3':
            lambda: torch.matmul(fh._rounded(a_mat, dt), x3).reshape(x.shape),
        'corrections: dx = bf16(widen(dx) - corr + w1 k0)':
            lambda: (widen(dx) - corr
                     + (w1f @ k0)[None, :, None, None]).to(dt),
        'forward: batch_stats_affine(x, w1, b1)':
            lambda: fh.batch_stats_affine(x, w1, b1),
    }
    print(f'PF head backward at bf16, x {list(x.shape)}, Cmid {cmid}, on '
          f'{torch.cuda.get_device_name(0)}: device ms per call (CUDA events, '
          f'L2 flushed; two readings)')
    for label, fn in parts.items():
        print(f'  {label:56s} '
              + ' '.join(f'{time_ms(fn):.4f}' for _ in range(2)))


# What mma.sync m16n8k16 bf16 (the narrow bf16 kernels' product) reaches on
# the card: each warp issues ``iters`` rounds of kChains independent
# products (kChains 1: each waits for the one before, the latency).
MMA_RATE_SRC = r"""
#include <cuda_runtime.h>
#include <cstdint>
template <int kChains>
__global__ void mma_rate_kernel(float* out, int iters) {
  const uint32_t a[4] = {0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u};
  const uint32_t b[2] = {0x3f803f80u, 0x3f803f80u};
  float acc[kChains][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]),
            "+f"(acc[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < kChains; ++c) s += acc[c][0] + acc[c][3];
  if (s == 1.25f) out[0] = s;
}
extern "C" int mma_rate(float* out, int blocks, int threads, int iters,
                        int chains, void* stream) {
  if (chains == 1) {
    mma_rate_kernel<1><<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  } else {
    mma_rate_kernel<8><<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  }
  return (int)cudaGetLastError();
}
"""


def mma_rate() -> None:
    """Print mma.sync m16n8k16 bf16's rate on the card: TFLOP/s with 8
    independent products per warp at 2, 4 and 8 warps per SM
    sub-partition, and the latency of one product (ns) with one warp per
    SM and each product waiting for the one before."""
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _cuda.BUILD_DIR / 'mma_rate.cu'
    cu.write_text(MMA_RATE_SRC)
    so = _cuda.BUILD_DIR / 'libmma_rate.so'
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, '-o', str(so),
                    str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.mma_rate.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    out = torch.zeros(1, device='cuda')
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    iters = 4096

    def timed(blocks, threads, chains):
        run = lambda: _cuda.check_status(lib.mma_rate(
            out.data_ptr(), blocks, threads, iters, chains, stream), 'mma')
        run()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    print(f'mma.sync m16n8k16 bf16 on {torch.cuda.get_device_name(0)} '
          f'({sms} SMs):')
    for per_sm in (1, 2, 4):
        ms = timed(sms * per_sm, 256, 8)
        flops = sms * per_sm * 8 * iters * 8 * 2 * 16 * 8 * 16
        print(f'  8 chains a warp, {2 * per_sm} warps per sub-partition: '
              f'{flops / ms / 1e9:.1f} TFLOP/s')
    ms = timed(sms, 32, 1)
    print(f'  one warp per SM, dependent products: {ms * 1e6 / iters:.2f} '
          f'ns per product')


K5_SHAPES = ('1:1', 'upsample 2x', 'upsample 4x', 'masked loss warp, C = 2')
HBM_BYTES_PER_S = 3.35e12


def k5_inputs(batch: int) -> dict:
    """{shape: (u, v, g, (N, H, W, C))} at the shapes of K5's paths, 2B =
    128 patches of 128x128: the loss warp's points (the patch grid through
    homographies of corner offsets of a few pixels) at C = 1 and C = 2
    (patch and mask), and the upsample grid at 2x and 4x broadcast over
    the batch (``heads/assembled.upsample_grid``, as the path hands it to
    K5); dense random cotangents."""
    from bihome_torch.heads.assembled import upsample_grid

    gen = torch.Generator().manual_seed(0)
    dev = torch.device('cuda')
    n, ps = 2 * batch, 128
    corners = geometry.image_corners(ps, ps, batch_size=n)
    delta = torch.rand((n, 4, 2), generator=gen) * 16 - 8
    u, v = geometry.homography_grid(
        geometry.four_point_to_homography(corners, delta), (ps, ps))
    u, v = u.to(dev), v.to(dev)
    cases = {}
    for name, c in (('1:1', 1), ('masked loss warp, C = 2', 2)):
        cases[name] = (u, v, torch.randn((n, ps * ps, c),
                                         generator=gen).to(dev), (n, ps, ps, c))
    for scale in (2, 4):
        uu, vv = upsample_grid(n, ps, ps, scale, dev)
        cases[f'upsample {scale}x'] = (
            uu, vv, torch.randn((n, uu.shape[1], 1), generator=gen).to(dev),
            (n, ps, ps, 1))
    return {k: cases[k] for k in K5_SHAPES}


def k5_call(lib, u, v, g, shape, cluster: int = 0):
    """K5's C entry of ``lib`` on these inputs. An earlier source (the
    scatter form: [N,P] points only, dimg zeroed by the caller) gets the grid
    materialised and a ``zero_`` of dimg before each launch, as its wrapper
    did."""
    n, h, w, c = shape
    p = u.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    dimg = torch.empty(shape, device='cuda')
    if 'bilinear_sample_bwd_img_cluster_kernel' not in lib.source:
        lib.bilinear_sample_bwd_img.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
        uc, vc = u.contiguous(), v.contiguous()

        def run():
            dimg.zero_()
            _cuda.check_status(lib.bilinear_sample_bwd_img(
                uc.data_ptr(), vc.data_ptr(), g.data_ptr(), dimg.data_ptr(),
                n, h, w, c, p, stream), 'K5 (scatter)')
    else:
        stride = warp.uv_batch_stride(u, v)
        chosen = ctypes.c_int(0)

        def run():
            _cuda.check_status(lib.bilinear_sample_bwd_img(
                u.data_ptr(), v.data_ptr(), g.data_ptr(), dimg.data_ptr(), n,
                h, w, c, p, stride, cluster, ctypes.byref(chosen), stream),
                'K5')
        run.chosen = chosen
    run.dimg = dimg
    return run


def device_ops_per_call(fn, calls: int = 20) -> dict:
    """{device op name: launches per call of ``fn``} under torch.profiler
    (kernels and memsets)."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.count / calls for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def profile_k5(libs: dict, batch: int, rounds: int) -> None:
    """K5 at the four shapes of its paths: the kernel as built (its S by
    the rule, on the broadcast grid where the path gives one, and on that
    grid materialised), at S forced to 1-4, each cut variant and the
    baseline, in turns (``time_ms``); the errors against the plain version;
    both bound counts; host us per call of the C entries and of the
    wrapper; the device ops of one wrapper call under torch.profiler."""
    dev_name = torch.cuda.get_device_name(0)
    for shape_name, (u, v, g, shape) in k5_inputs(batch).items():
        n, h, w, c = shape
        p = u.shape[1]
        broadcast = u.stride() == (0, 1)
        runs = {}
        for label, lib in libs.items():
            runs[label] = k5_call(lib, u, v, g, shape)
            if label != 'as built':
                continue
            if broadcast:
                runs['as built, grid materialised'] = k5_call(
                    lib, u.contiguous(), v.contiguous(), g, shape)
            for s in (1, 2, 3, 4):
                runs[f'as built, S = {s}'] = k5_call(lib, u, v, g, shape, s)
        times = {label: [] for label in runs}
        for _ in range(rounds):
            for label, run in runs.items():
                times[label].append(time_ms(run))
            times['as built'].append(time_ms(runs['as built']))
        want = warp.bilinear_sample_bwd_img_plain(u, v, g, shape)
        scale = float(want.abs().max())
        rows = n if not broadcast else 1
        bound = {k: 4 * (2 * r * p + n * p * c + n * h * w * c)
                 / HBM_BYTES_PER_S * 1e3 for k, r in (('grid per sample', n),
                                                     ('one grid row', rows))}
        print(f'K5 at the {shape_name} [{n},{h},{w},{c}] P = {p} on {dev_name}'
              f': ms per call (every reading), the median saved against the '
              f'kernel as built; S by the rule '
              f'{runs["as built"].chosen.value if hasattr(runs["as built"], "chosen") else "-"}'
              f'; bound (bytes) {bound["grid per sample"]:.4f} with a grid '
              f'per sample, {bound["one grid row"]:.4f} with '
              f'{"one row" if broadcast else "the grid as given"}; plain '
              f'{time_ms(lambda: warp.bilinear_sample_bwd_img_plain(u, v, g, shape)):.4f}')
        base = sorted(times['as built'])[len(times['as built']) // 2]
        for label, ts in times.items():
            mid = sorted(ts)[len(ts) // 2]
            run = runs[label]
            run()
            torch.cuda.synchronize()
            err = float((run.dimg - want).abs().max()) / scale
            print(f'  {label:48s} {" ".join(f"{t:.4f}" for t in ts)}'
                  + ('' if label == 'as built' else f'  saves {base - mid:.4f}')
                  + (f'  error / max|ref| {err:.2e}'
                     if label.startswith(('as built', 'baseline')) else ''))
        hosts = {label: [] for label in runs
                 if label == 'as built' or label.startswith('baseline')}
        hosts['wrapper'] = []
        wrapper = lambda: warp.bilinear_sample_bwd_img(u, v, g, shape)
        for _ in range(3):
            for label in hosts:
                hosts[label].append(host_us(runs.get(label, wrapper)))
        print('  host us per call (C entry, and the Python wrapper as built; '
              'in turns): ' + '; '.join(
                  f'{label} ' + ' '.join(f'{us:.2f}' for us in readings)
                  for label, readings in hosts.items()))
        print('  device ops per wrapper call (torch.profiler): ' + ', '.join(
            f'{k} {x:g}' for k, x in device_ops_per_call(wrapper).items()))


K3_SHAPES = ('image_2', 'RGB window warp', 'masked loss warp', 'upsample 2x',
             'upsample 4x')


def k3_inputs(batch: int) -> dict:
    """{shape: (images, u, v, touched)} at the shapes of K3's
    C > 1 and upsample paths: ``batch`` RGB 240x320 frames on 0..255 warped
    whole by the inverse of their pairs' homographies (image_2, eval
    --vis), the (ps + 2 rho)^2 windows of the same frames and their warped
    second patches' points (``data/pipeline.patch_windows``, pds-coco's
    patch 128 and rho 32), 2B patches and masks of 128x128 on the loss
    warp's points, and 2B patches of 128x128 at the upsample grid of 2x and
    4x broadcast over the batch (``heads/assembled.upsample_grid``).
    ``touched``: the bytes bound reads only the pixels the taps touch
    (``ops/warp.touched_pixels``: the frames and windows), else the whole
    image."""
    from bihome_torch.data import pipeline
    from bihome_torch.heads.assembled import upsample_grid

    gen = torch.Generator().manual_seed(0)
    dev = torch.device('cuda')
    spec = pipeline.PairSpec(rho=32, patch_size=128)
    corners, delta = pipeline.draw_corners_delta_batch(batch, (240, 320),
                                                       spec, gen)
    hom = geometry.four_point_to_homography(corners.float(), delta.float())
    frames = (torch.rand((batch, 240, 320, 3), generator=gen) * 255).to(dev)
    u, v = geometry.homography_grid(geometry.inv3x3(hom), (240, 320))
    cases = {'image_2': (frames, u.to(dev), v.to(dev), True)}
    windows, u, v = pipeline.patch_windows(frames, hom.to(dev),
                                           corners[:, 0].float().to(dev),
                                           128, 32)
    cases['RGB window warp'] = (windows, u, v, True)
    n, ps = 2 * batch, 128
    corners = geometry.image_corners(ps, ps, batch_size=n)
    delta = torch.rand((n, 4, 2), generator=gen) * 16 - 8
    u, v = geometry.homography_grid(
        geometry.four_point_to_homography(corners, delta), (ps, ps))
    masked = torch.cat([torch.randn((n, ps, ps, 1), generator=gen),
                        torch.rand((n, ps, ps, 1), generator=gen)], dim=-1)
    cases['masked loss warp'] = (masked.to(dev), u.to(dev), v.to(dev),
                                 False)
    patches = torch.randn((n, ps, ps, 1), generator=gen).to(dev)
    for scale in (2, 4):
        cases[f'upsample {scale}x'] = (
            patches, *upsample_grid(n, ps, ps, scale, dev), False)
    return {k: cases[k] for k in K3_SHAPES}


def footprint_bytes(u, v, h: int, w: int, c: int, points: int = 512):
    """Per block of ``points`` consecutive points of an image (the ragged
    tail dropped), the bytes of the bounding box of its taps inside the
    image: what a tile of the source in shared memory would have to hold
    for that block. Points with no tap inside are left out."""
    n, p = u.shape
    blocks = p // points
    x0 = torch.floor(u[:, :blocks * points]).reshape(n, blocks, points)
    y0 = torch.floor(v[:, :blocks * points]).reshape(n, blocks, points)
    inside = (x0 >= -1) & (x0 <= w - 1) & (y0 >= -1) & (y0 <= h - 1)
    big = float(max(h, w) + 2)

    def extent(lo, hi, limit):
        low = torch.where(inside, lo.clamp(0, limit - 1), big).amin(-1)
        high = torch.where(inside, hi.clamp(0, limit - 1), -big).amax(-1)
        return (high - low + 1).clamp_min(0)
    area = extent(x0, x0 + 1, w) * extent(y0, y0 + 1, h)
    return (area * c * 4).flatten()


def k3_call(lib, images, u, v):
    """K3's C entry of ``lib`` on these inputs. An earlier source (no batch
    stride: [N,P] points only) gets the grid materialised, as its wrapper
    did."""
    n, h, w, c = images.shape
    p = u.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty((n, p, c), device='cuda')
    if 'bilinear_sample_cn_kernel' not in lib.source:
        lib.bilinear_sample.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
        uc, vc = u.contiguous(), v.contiguous()

        def run():
            _cuda.check_status(lib.bilinear_sample(
                images.data_ptr(), uc.data_ptr(), vc.data_ptr(),
                out.data_ptr(), n, h, w, c, p, stream), 'K3 (baseline)')
    else:
        stride = warp.uv_batch_stride(u, v)
        chosen = ctypes.c_int(0)

        def run():
            _cuda.check_status(lib.bilinear_sample(
                images.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(),
                n, h, w, c, p, stride, ctypes.byref(chosen), stream), 'K3')
        run.chosen = chosen
    run.out = out
    return run


def profile_k3(libs: dict, batch: int, rounds: int) -> None:
    """K3 at the five shapes of its C > 1 and upsample paths: the kernel as
    built (on the broadcast grid where the path gives one, and on that grid
    materialised), each cut variant (C > 1 only) and the baseline, in turns
    (``time_ms``); the errors against the plain version; the bytes bound;
    grid_sample (and at the upsample shapes interpolate, align_corners)
    and the plain version; host us per call of the C entries and of the
    wrapper; the device ops of one wrapper call under torch.profiler."""
    import torch.nn.functional as F

    dev_name = torch.cuda.get_device_name(0)
    for shape_name, (images, u, v, touched) in k3_inputs(batch).items():
        n, h, w, c = images.shape
        p = u.shape[1]
        broadcast = u.stride() == (0, 1)
        runs = {}
        for label, lib in libs.items():
            if c == 1 and not label.startswith(('as built', 'baseline')):
                continue          # the cuts change only the C > 1 kernel
            runs[label] = k3_call(lib, images, u, v)
            if label == 'as built' and broadcast:
                runs['as built, grid materialised'] = k3_call(
                    lib, images, u.contiguous(), v.contiguous())
        times = {label: [] for label in runs}
        for _ in range(rounds):
            for label, run in runs.items():
                times[label].append(time_ms(run))
            times['as built'].append(time_ms(runs['as built']))
        want = warp.bilinear_sample_plain(images, u, v)
        scale = float(want.abs().max())
        pixels = warp.touched_pixels(u, v, h, w) if touched else n * h * w
        rows = 1 if broadcast else n
        bound = 4 * (pixels * c + 2 * rows * p + n * p * c) / HBM_BYTES_PER_S
        bound_full = 4 * (pixels * c + 3 * n * p) / HBM_BYTES_PER_S
        img_nchw = images.permute(0, 3, 1, 2).contiguous()
        grid = torch.stack([u * (2.0 / (w - 1)) - 1.0,
                            v * (2.0 / (h - 1)) - 1.0], dim=-1)[:, None]
        lib_ms = time_ms(lambda: F.grid_sample(
            img_nchw, grid, mode='bilinear', padding_mode='zeros',
            align_corners=True))
        extra = ''
        if broadcast:
            up = p // (h * w)
            factor = int(round(up ** 0.5))
            extra = '; interpolate {:.4f}'.format(time_ms(
                lambda: F.interpolate(img_nchw, scale_factor=factor,
                                      mode='bilinear', align_corners=True)))
        chosen = runs['as built'].chosen
        runs['as built']()
        plain_ms = time_ms(lambda: warp.bilinear_sample_plain(images, u, v))
        print(f'K3 at the {shape_name} [{n},{h},{w},{c}] P = {p} on '
              f'{dev_name} (kernel {chosen.value}): ms per call (every '
              f'reading), the median saved against the kernel as built; '
              f'bound (bytes) {bound * 1e3:.4f}'
              + (f' (one grid row; {bound_full * 1e3:.4f} with a grid per '
                 f'sample)' if broadcast else '')
              + f', {pixels / (n * h * w):.3f} of the image read; '
              f'grid_sample {lib_ms:.4f}{extra}; plain {plain_ms:.4f}')
        base = sorted(times['as built'])[len(times['as built']) // 2]
        for label, ts in times.items():
            mid = sorted(ts)[len(ts) // 2]
            run = runs[label]
            run()
            torch.cuda.synchronize()
            err = float((run.out - want).abs().max())
            print(f'  {label:48s} {" ".join(f"{t:.4f}" for t in ts)}'
                  + ('' if label == 'as built' else f'  saves {base - mid:.4f}')
                  + (f'  max abs err {err:.2e} ({err / scale:.2e} of '
                     f'max|ref|)' if label.startswith(('as built', 'baseline'))
                     else ''))
        if broadcast:
            same = torch.equal(runs['as built'].out,
                               runs['as built, grid materialised'].out)
            print('  one grid row against the grid materialised: '
                  + ('bit for bit' if same else 'DIFFERENT'))
        if c > 1:
            kb = footprint_bytes(u, v, h, w, c).double() / 1024
            q = torch.quantile(kb, torch.tensor([0.5, 0.9], dtype=kb.dtype,
                                                device=kb.device))
            print(f'  source footprint of a block of 512 points (KB): median '
                  f'{q[0]:.1f}, p90 {q[1]:.1f}, max {kb.max():.1f}; over '
                  f'48 KB {float((kb > 48).double().mean()):.3f}, over 227 '
                  f'KB {float((kb > 227).double().mean()):.3f} of the blocks')
        hosts = {label: [] for label in runs
                 if label == 'as built' or label.startswith('baseline')}
        hosts['wrapper'] = []
        wrapper = lambda: warp.bilinear_sample_batched(images, u, v)
        for _ in range(3):
            for label in hosts:
                hosts[label].append(host_us(runs.get(label, wrapper)))
        print('  host us per call (C entry, and the Python wrapper as built; '
              'in turns): ' + '; '.join(
                  f'{label} ' + ' '.join(f'{us:.2f}' for us in readings)
                  for label, readings in hosts.items()))
        print('  device ops per wrapper call (torch.profiler): ' + ', '.join(
            f'{k} {x:g}' for k, x in device_ops_per_call(wrapper).items()))


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
    parser.add_argument('--mma_rate', action='store_true',
                        help='first print what mma.sync m16n8k16 bf16 '
                        'reaches on the card')
    parser.add_argument('--sass', type=Path, default=None,
                        help='a directory to write the SASS of the kernel as '
                        'built into')
    parser.add_argument('--phases', action='store_true',
                        help='k2b, k2wb: also time the PF head\'s whole '
                        'bf16 backward in parts')
    args = parser.parse_args(argv)
    cmid = args.cmid or (512 if args.kernel in WIDE else 128)
    if not torch.cuda.is_available():
        raise SystemExit('profile_kernels needs a CUDA device')
    if args.mma_rate:
        mma_rate()
    name, source = args.kernel, SOURCES[args.kernel]
    src = (_cuda.CSRC / f'{source}.cu').read_text()
    labels = {f'{name}_as_built': 'as built'}
    sources = {f'{name}_as_built': src}
    if args.baseline is not None:
        labels[f'{name}_baseline'] = f'baseline {args.baseline}'
        sources[f'{name}_baseline'] = args.baseline.read_text()
    for i, (cut_name, cut) in enumerate(
            {} if args.no_cuts else CUTS[name].items()):
        sources[f'{name}_variant{i}'] = cut(src)
        labels[f'{name}_variant{i}'] = cut_name
    libs = {labels[k]: lib for k, lib in build_sources(sources, source).items()}
    for kernel in SASS_NAMES[name]:
        so = _cuda.BUILD_DIR / f'lib{name}_as_built.so'
        counts = sass_counts(so, kernel)
        if args.sass is not None:
            args.sass.mkdir(parents=True, exist_ok=True)
            (args.sass / f'{kernel}.sass').write_text(sass_text(so, kernel))
        print(f'{name.upper()} SASS of {kernel}: {sum(counts.values())} '
              'instructions; ' + ', '.join(
                  f'{op} {k}' for op, k in counts.most_common(12))
              + f'; HGMMA {counts["HGMMA"]}, HMMA {counts["HMMA"]}')
        if name in BF16 or name in ('k3', 'k5'):
            for label in ('as built', f'baseline {args.baseline}'):
                if label in libs:
                    print(f'  ptxas, {label}: '
                          + ' | '.join(ptxas_report(libs[label].log, kernel)))
        # ptxas's warnings about the kernel's wgmma (C7514 and the like: a
        # wait after every wgmma of a function) as built.
        for line in libs['as built'].log.splitlines():
            if 'wgmma' in line and kernel in line:
                print(f'  ptxas, as built: {line.strip()}')

    if name == 'k5':
        profile_k5(libs, args.batch_size, args.rounds)
        return
    if name == 'k3':
        profile_k3(libs, args.batch_size, args.rounds)
        return
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
    if name in BF16:
        wrappers = {'as built': _wrapper_module(
            Path(fh.__file__), libs['as built'], 'as_built')}
        parent = (args.baseline.parent.parent / 'ops' / 'fused_head.py'
                  if args.baseline is not None else None)
        if parent is not None and parent.exists():
            wrappers['baseline'] = _wrapper_module(
                parent, libs[f'baseline {args.baseline}'], 'baseline')
        calls = wrapper_calls(name, args.batch_size, cmid, wrappers)
        hosts = {label: [] for label in calls}
        for _ in range(3):
            for label, call in calls.items():
                hosts[label].append(host_us(call))
        print('  host us per call of the Python wrapper (in turns): '
              + '; '.join(f'{label} ' + ' '.join(f'{us:.2f}' for us in ts)
                          for label, ts in hosts.items()))
        base_label = f'baseline {args.baseline}'
        if base_label in runs:
            for run in (runs['as built'], runs[base_label]):
                run()
            torch.cuda.synchronize()
            print('  as built against the baseline, relative L2 (share of '
                  'values that differ): ' + ', '.join(
                      f'{k} {_rel_l2(a, runs[base_label].outs[k]):.3e} '
                      f'({float((a != runs[base_label].outs[k]).float().mean()):.2e})'
                      for k, a in runs['as built'].outs.items()))
        if args.phases and name in ('k2b', 'k2wb'):
            bwd_phases(args.batch_size, wrappers['as built'],
                       *((64, cmid) if name == 'k2wb' else ()))
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
