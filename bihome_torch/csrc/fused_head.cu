// Perspective-field head on the H100: the forward (K1) and the backward
// (K2), both with their Cin x Cmid products on the tensor cores in 3xTF32.
//
// ---------------------------------------------------------------------------
// Forward (K1), eval mode: 1x1 conv -> BatchNorm (given statistics) -> ReLU
// -> 1x1 conv, fused so the [M, Cmid] middle never reaches device memory.
//
//   out[n,o,s] = b2[o] + sum_j w2[o,j] * relu(c1[j] + sum_k g1t[j,k] x[n,k,s])
//
// with BN folded into the first conv outside the kernel (by the wrapper):
// g1t = w1 * gamma/sqrt(var+eps) per output row, c1 = (b1-mean)*that+beta.
//
// Replaces the TPU kernel bihome_tpu/ops/fused_head.py:_fwd_kernel (driven
// by _run_fwd and fused_pf_head), which keeps pixels in lanes and channels
// in sublanes ([Cin, M] layout). The backbone's NCHW activation already has
// that layout per image: the kernel reads it in place, no transposed copy.
//
// Bound on the H100. At the zeng eval shape (M = 2B*128*128 = 2,097,152
// pixels for B = 64, Cin 16, Cmid 128, Cout 2) the call must move ~151 MB,
// 0.045 ms at 3.35 TB/s, and does 9.7 GFLOP, 8.6 of them in the [M,16] x
// [16,128] product: 0.144 ms on the fp32 cores alone. With the product on
// the tensor cores in 3xTF32 (3 x 8.6 GFLOP at 495 TFLOP/s: 0.052 ms) and
// the epilogue on the fp32 cores beside it (~0.024 ms), the bound is
// ~0.052 ms (operations).
//
// Precision: 3xTF32, as K2 (below): fp32-level error, so the port's fp32
// tolerances stand; tests/test_torch_fused_head.py measures 3xTF32 and
// single-pass TF32 on the CPU at this head's widths.
//
// Takes Cin = 16, Cout = 2 and any Cmid that is a multiple of 16 up to
// kFwdMaxCmid (128 for the ResNet34-flavour head, 512 for the
// ResNet50-flavour one).
//
// Design:
//   * orientation: pixels are the mma's M dimension and middle channels
//     its N, mid^T [16 px, 8 ch] = x^T [16 px, Cin] g1t^T [Cin, 8 ch]
//     (mma.sync.m16n8k8 tf32, K = Cin in two steps). A lane's accumulator
//     then holds 2 pixels x 2 channels, so the ReLU and the Cout = 2 output
//     sums run on it in place and stay in registers across all Cmid / 8
//     n-tiles; the 4 lanes that share a pixel pair fold their sums with 3
//     shuffles at the end. There is no cross-warp sum and no output buffer
//     in shared memory. (K2's orientation, channels as M with each warp
//     owning 16 of them, would need each tile's outputs summed over the
//     block's 8 warps through shared memory);
//   * persistent blocks of 256 threads (8 warps), as many as fit on the
//     card at once (two per SM at Cmid 128 and 512), walk tiles of 256
//     pixels within one image. A tile's x [16][256] comes in by cp.async
//     into a double buffer while the block works on the tile before:
//     16-byte copies when HW is a multiple of 4, else 4-byte ones; pixels
//     past the image's end are zero-filled, computed, and not stored;
//   * warp w owns pixels 32w..32w+31 of a tile, two m-tiles of 16. It
//     loads their A fragments from the x tile once per tile and splits
//     each value into (big, small) in registers: every x value is read by
//     exactly one warp, so a split copy in shared memory would buy no
//     reuse. The x tile's row stride, 264 words (8 mod 32), makes those
//     loads free of bank conflicts;
//   * g1t is split once per block, into shared memory in fragment order:
//     one conflict-free 16-byte load gives a lane its (big, small) B
//     fragment of an n-tile and k-step, and serves both m-tiles. c1 and w2
//     of the lane's two channels sit beside it (broadcast loads);
//   * per n-tile the big*big accumulator starts at c1 and the small-term
//     one at 0, so the epilogue is one add, the ReLU and two FMAs per
//     middle value on the fp32 cores; b2 is added at the store;
//   * tile indices are 32-bit: a 64-bit division per tile is a long
//     software routine on the card.
//
// What holds it back (H100 80GB HBM3, 700 W; python -m
// bihome_torch.profile_kernels --kernel k1 cuts each part out and times
// the rest): the tensor-core products. Each mma.sync.m16n8k8 tf32 costs its
// SM sub-partition ~8 cycles, a warp issues 12 of them per n-tile (3
// passes x 2 k-steps x 2 m-tiles), and the fp32 epilogue adds its own
// cycles on top rather than hiding under them, even with the next
// n-tile's products issued before it by hand (measured no faster, not
// kept); the loads and stores alone take ~0.06 ms and do hide. 3xTF32 on
// mma.sync is ~4x the 3xTF32 bound at this shape; wgmma (asynchronous, at
// the tensor cores' full rate) is the next step.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCin = 16;
constexpr int kCout = 2;

__device__ __forceinline__ uint32_t to_tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return r;
}

struct Split {
  uint32_t big, small;
};

__device__ __forceinline__ Split split(float a) {
  const uint32_t big = to_tf32(a);
  return {big, to_tf32(a - __uint_as_float(big))};
}

// d = a b + c on the tensor cores: m16n8k8, tf32 operands, fp32
// accumulator; d may be c.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b, const float* c) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// 3xTF32: hh = big*big + chh, hs = big*small + small*big + chs.
__device__ __forceinline__ void mma3(float* hh, float* hs, const uint32_t* ab,
                                     const uint32_t* as, const uint32_t* bb,
                                     const uint32_t* bs, const float* chh,
                                     const float* chs) {
  mma_tf32(hs, ab, bs, chs);
  mma_tf32(hs, as, bb, hs);
  mma_tf32(hh, ab, bb, chh);
}

// 3xTF32, accumulating: hh += big*big, hs += big*small + small*big.
__device__ __forceinline__ void mma3(float* hh, float* hs, const uint32_t* ab,
                                     const uint32_t* as, const uint32_t* bb,
                                     const uint32_t* bs) {
  mma3(hh, hs, ab, as, bb, bs, hh, hs);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

// Start the copies of pixels s0..s0+kPx-1 of rows 0..kRows-1 of one image's
// [kRows][hw] block src into dst (row stride kStride words), by a block of
// kThreads threads. Pixels past hw are filled with 0 (the source then
// points at ``any``, the tensor's start, and no byte of it is read). kVec:
// 16-byte copies (HW % 4 == 0 and src 16-byte aligned, so a chunk of 4
// pixels is all in or all out), else 4-byte ones.
template <int kRows, int kPx, int kStride, int kThreads, bool kVec>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          const float* any, int s0, int hw) {
  if (kVec) {
    for (int i = threadIdx.x; i < kRows * kPx / 4; i += kThreads) {
      const int k = i / (kPx / 4), q = i % (kPx / 4) * 4;
      const bool in = s0 + q < hw;
      cp_async16(dst + k * kStride + q,
                 in ? src + (long long)k * hw + s0 + q : any, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * kPx; i += kThreads) {
      const int k = i / kPx, p = i % kPx;
      const bool in = s0 + p < hw;
      cp_async4(dst + k * kStride + p,
                in ? src + (long long)k * hw + s0 + p : any, in ? 4 : 0);
    }
  }
}

constexpr int kFwdTile = 256;         // pixels per tile, within one image
constexpr int kFwdThreads = 256;      // 8 warps, 32 pixels each
constexpr int kFwdSX = kFwdTile + 8;  // row stride of the x tile (words)
constexpr int kFwdMaxCmid = 1024;

// K1's shared memory in bytes: the cp.async double buffer of x; g1t^T's B
// fragments, a uint4 (big, small at k and at k + 4) per lane, k-step and
// n-tile; and per n-tile and lane quad c1 and w2 of the quad's two
// channels, in 8 floats.
constexpr size_t fwd_smem_bytes(int cmid) {
  return sizeof(float) * 2 * kCin * kFwdSX +
         sizeof(uint4) * (size_t)(cmid / 8) * 2 * 32 +
         sizeof(float) * (size_t)(cmid / 8) * 4 * 8;
}

// K1's products of n-tile nt for a warp's two m-tiles: hh[mt] = c1 +
// big*big, hs[mt] = big*small + small*big. Register r of an m-tile is
// pixel gid + 8 (r >> 1), channel nt * 8 + 2 tig + (r & 1).
__device__ __forceinline__ void fwd_products(
    const uint4* s_b, const float* s_c, int nt, int lane,
    const uint32_t (&ab)[2][2][4], const uint32_t (&as)[2][2][4],
    float (&hh)[2][4], float (&hs)[2][4]) {
  const uint4 f0 = s_b[nt * 64 + lane];
  const uint4 f1 = s_b[nt * 64 + 32 + lane];
  const uint32_t bb[2][2] = {{f0.x, f0.z}, {f1.x, f1.z}};
  const uint32_t bs[2][2] = {{f0.y, f0.w}, {f1.y, f1.w}};
  const float2 c =
      *reinterpret_cast<const float2*>(s_c + (nt * 4 + (lane & 3)) * 8);
  const float c1r[4] = {c.x, c.y, c.x, c.y};
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    mma3(hh[mt], hs[mt], ab[mt][0], as[mt][0], bb[0], bs[0], c1r, zero);
    mma3(hh[mt], hs[mt], ab[mt][1], as[mt][1], bb[1], bs[1]);
  }
}

// K1's epilogue of n-tile nt on the fp32 cores: the ReLU, and the Cout = 2
// sums over the lane's two channels into acc[mt][pixel gid + 8 px][o].
__device__ __forceinline__ void fwd_epilogue(const float* s_c, int nt,
                                             int lane,
                                             const float (&hh)[2][4],
                                             const float (&hs)[2][4],
                                             float (&acc)[2][2][2]) {
  const float4 w =
      *reinterpret_cast<const float4*>(s_c + (nt * 4 + (lane & 3)) * 8 + 4);
  const float wo[2][2] = {{w.x, w.y}, {w.z, w.w}};  // [o][channel]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = fmaxf(hh[mt][r] + hs[mt][r], 0.0f);
      const int px = r >> 1, ch = r & 1;
      acc[mt][px][0] = fmaf(wo[0][ch], a, acc[mt][px][0]);
      acc[mt][px][1] = fmaf(wo[1][ch], a, acc[mt][px][1]);
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void load_fwd_tile(const float* x, float* sx,
                                              int tile, int tpi, int hw) {
  const int n = tile / tpi;
  const int s0 = (tile - n * tpi) * kFwdTile;
  copy_rows<kCin, kFwdTile, kFwdSX, kFwdThreads, kVec>(
      sx, x + (long long)n * kCin * hw, x, s0, hw);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <bool kVec>
__global__ void __launch_bounds__(kFwdThreads, 2)
pf_head_fwd_kernel(const float* __restrict__ x, const float* __restrict__ g1t,
                   const float* __restrict__ c1, const float* __restrict__ w2,
                   const float* __restrict__ b2, float* __restrict__ out,
                   int hw, int tpi, int ntiles, int cmid) {
  extern __shared__ __align__(16) float smem[];
  const int ntn = cmid / 8;                    // n-tiles of 8 channels
  float* s_x = smem;                           // [2][Cin][kFwdSX], cp.async
  uint4* s_b = reinterpret_cast<uint4*>(s_x + 2 * kCin * kFwdSX);
  float* s_c = reinterpret_cast<float*>(s_b + ntn * 2 * 32);

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int gid = lane >> 2, tig = lane & 3;

  int tile = blockIdx.x;
  if (tile < ntiles) load_fwd_tile<kVec>(x, s_x, tile, tpi, hw);
  // B fragment of g1t^T for n-tile nt, k-step ks, lane l: channel
  // nt * 8 + l / 4 at k = ks * 8 + l % 4 and at k + 4.
  for (int i = t; i < ntn * 64; i += kFwdThreads) {
    const int l = i & 31, ks = (i >> 5) & 1, nt = i >> 6;
    const float* row = g1t + (nt * 8 + (l >> 2)) * kCin + ks * 8 + (l & 3);
    const Split lo = split(row[0]), hi = split(row[4]);
    s_b[i] = make_uint4(lo.big, lo.small, hi.big, hi.small);
  }
  // The accumulator columns of lane quad q of n-tile nt are channels
  // nt * 8 + 2q and + 1: their c1 at 0, 1 and w2 at 4..7 ([o][channel]).
  for (int i = t; i < ntn * 4; i += kFwdThreads) {
    const int ch = (i >> 2) * 8 + 2 * (i & 3);
    float* c = s_c + i * 8;
    c[0] = c1[ch];
    c[1] = c1[ch + 1];
    c[2] = 0.0f;
    c[3] = 0.0f;
    c[4] = w2[ch];
    c[5] = w2[ch + 1];
    c[6] = w2[cmid + ch];
    c[7] = w2[cmid + ch + 1];
  }
  const float b2_0 = b2[0], b2_1 = b2[1];

  int buf = 0;
  for (; tile < ntiles; tile += gridDim.x) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // this tile's x in; the tile before done by all
    const int next = tile + gridDim.x;
    if (next < ntiles) {
      load_fwd_tile<kVec>(x, s_x + (buf ^ 1) * kCin * kFwdSX, next, tpi, hw);
    }
    const float* sx = s_x + buf * kCin * kFwdSX;

    // A fragments of the warp's m-tiles mt (pixels 32w + 16mt + 0..15),
    // both k-steps, split: register r is pixel gid + 8 (r & 1) at k = tig
    // + 4 (r >> 1) of the k-step.
    uint32_t ab[2][2][4], as[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const float* p = sx + (ks * 8 + tig) * kFwdSX + warp * 32 + mt * 16 +
                         gid;
        const float a[4] = {p[0], p[8], p[4 * kFwdSX], p[4 * kFwdSX + 8]};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const Split s = split(a[r]);
          ab[mt][ks][r] = s.big;
          as[mt][ks][r] = s.small;
        }
      }
    }

    // acc[mt][px][o]: output o of pixel gid + 8 px of m-tile mt, summed
    // over the lane's channels.
    float acc[2][2][2] = {};
    for (int nt = 0; nt < ntn; ++nt) {
      float hh[2][4], hs[2][4];
      fwd_products(s_b, s_c, nt, lane, ab, as, hh, hs);
      fwd_epilogue(s_c, nt, lane, hh, hs, acc);
    }

    // Fold the sums over the lane quad, leaving lane tig with pixel gid +
    // 8 (tig >> 1), output tig & 1: exchange the other pixel's pair with
    // lane tig ^ 2, then the other output with lane tig ^ 1.
    const int n = tile / tpi;
    const int s0 = (tile - n * tpi) * kFwdTile + warp * 32 + gid;
    const int px = tig >> 1, o = tig & 1;
    float* on = out + ((long long)n * kCout + o) * hw;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float keep[2];
#pragma unroll
      for (int oo = 0; oo < 2; ++oo) {
        const float mine = px ? acc[mt][1][oo] : acc[mt][0][oo];
        const float other = px ? acc[mt][0][oo] : acc[mt][1][oo];
        keep[oo] = mine + __shfl_xor_sync(0xffffffffu, other, 2);
      }
      const float mine = o ? keep[1] : keep[0];
      const float other = o ? keep[0] : keep[1];
      const float v = mine + __shfl_xor_sync(0xffffffffu, other, 1);
      const int s = s0 + mt * 16 + 8 * px;
      if (s < hw) on[s] = v + (o ? b2_1 : b2_0);
    }
    buf ^= 1;
  }
}

// ---------------------------------------------------------------------------
// Backward (K2): replaces bihome_tpu/ops/fused_head.py:_bwd_kernel (driven
// by _run_bwd). One pass over the pixels recomputes the middle and the ReLU
// mask from x and forms
//
//   mid[c,p] = sum_k w1t[c,k] x[k,p]         a = gis[c]*mid + c1[c]
//   mask = a > 0                              e = mask * sum_o w2gis[c,o] g[o,p]
//   dx[k,p] = sum_c w1t[c,k] e[c,p]           (written per pixel)
//   dw1[k,c] = sum_p x[k,p] e[c,p]            M0[c,o] = sum_p mask g[o,p]
//   M1[c,o] = sum_p mask*mid g[o,p]           db2[o] = sum_p g[o,p]
//
// The rank-Cin batch-statistics corrections stay outside, in torch, as they
// are XLA ops outside Pallas in JAX.
//
// Bound on the H100. At the zeng training shape (M = 2,097,152 pixels, Cin
// 16, Cmid 128, Cout 2) the pass does 30.3 GFLOP, 25.8 of them in the three
// Cin x Cmid products mid, dx and dw1, and must move 0.285 GB (x and g read,
// dx written). On the fp32 cores alone that is 0.45 ms of operations. With
// the three products on the tensor cores in 3xTF32 (3 x 25.8 GFLOP at 495
// TFLOP/s: 0.156 ms; the other 4.5 GFLOP on the fp32 cores beside them) the
// bound is bytes: 0.085 ms at 3.35 TB/s.
//
// Precision: 3xTF32. Each fp32 operand a is split into big = tf32(a) and
// small = tf32(a - big) (cvt.rna), and each product accumulates big*big +
// big*small + small*big in fp32, as CUTLASS's OpMultiplyAddFastF32 does;
// the two small terms go to an accumulator of their own. That keeps fp32
// error, so the port's fp32 tolerances stand. Single-pass TF32 (~1e-3
// relative per product) is not used: tests/test_torch_fused_head.py measures
// both on the CPU at this head's widths.
//
// Design:
//   * persistent blocks of 256 threads (8 warps), two per SM, walk tiles of
//     64 pixels within one image (the last tile of an image is masked). A
//     tile's x [16][64] and g [2][64] come in by cp.async into a double
//     buffer while the block works on the tile before: 16-byte copies when
//     HW is a multiple of 4, else 4-byte ones; pixels past the image's end
//     are zero-filled, so they add 0 to every sum;
//   * the three products are mma.sync.m16n8k8 tf32 (warp-level tensor-core
//     MMA). Each has Cin = 16 as one dimension, which fills a 16-row
//     mma.sync tile exactly, and mma.sync lets each product take an operand
//     from registers in the layout the one before left it in. (A version
//     with all three on wgmma, m64nNk8, one block of two warpgroups per SM
//     at 255 registers a thread, measured slower on the H100: its products,
//     epilogue and shared-memory traffic ran one after another, with no
//     second block to fill the gaps);
//   * once per tile, all threads split the x tile into (big, small) pairs,
//     written twice: in pixel order (A of dw1) and with the pixels of each
//     8 in the order 0,4,1,5,2,6,3,7 (B of mid), so that no warp splits x
//     again:
//       - mid: warp w owns middle channels 16w..16w+15. mid^T [16 ch, 64 px]
//         = w1t rows (A, registers for the whole kernel) x the x tile (B),
//         K = Cin. Row r of the warp's tile is channel 16w + 2r for r < 8
//         and 16w + 2(r - 8) + 1 above, so a lane holds two adjacent
//         channels; the permuted pixel order gives it pixels t and t + 4 of
//         each 8. The epilogue (a, mask, e, mask*mid; M0, M1 and db2 summed
//         per lane) runs on the accumulator registers;
//       - dw1 [16 k, the warp's 16 ch] += x tile (A) x e^T (B): B is exactly
//         the e values the lane holds in mid's accumulator, split once;
//       - dx: e goes to shared memory as (big, small) pairs [pixel][channel];
//         warp w then takes pixels 8w..8w+7 over all 128 channels (A = w1t^T,
//         split once into shared memory; B = e) and stores float2s;
//   * M0 and M1 (N = 2) and db2 stay on the fp32 cores, in registers across
//     all of the block's tiles with dw1, and are folded over the 4 lanes
//     that share channels at the end;
//   * row strides of the shared arrays (136 and 264 words) make every
//     fragment load and store free of bank conflicts;
//   * the tensor-core products, run as mma.sync among the epilogue's
//     fp32 work, take most of the kernel's time; python -m
//     bihome_torch.profile_kernels --kernel k2 cuts each part out and
//     times the rest;
//   * each block writes its sums to its own row of a [blocks, 2562] scratch
//     and a second kernel adds the rows in block order: deterministic, no
//     atomics.

constexpr int kCmid = 128;
constexpr int kTile = 64;          // pixels per tile, within one image
constexpr int kBwdThreads = 256;   // 8 warps, 16 middle channels each
constexpr int kSX = 136;           // row stride of split x [Cin][kTile][2]
constexpr int kSE = 264;           // row stride of split e [kTile][Cmid][2]
constexpr int kSW = 264;           // row stride of split w1t^T [Cin][Cmid][2]
// Partial-sum row: dw1 [Cin,Cmid], M0 [Cmid,Cout], M1 [Cmid,Cout], db2.
constexpr int kPartial = kCin * kCmid + 2 * kCmid * kCout + kCout;
// Shared memory in words: the cp.async double buffer of x and g, split x
// twice, split e, split w1t^T.
constexpr int kBwdSmemFloats = 2 * kCin * kTile + 2 * kCout * kTile +
                               2 * kCin * kSX + kTile * kSE + kCin * kSW;

// Start the copies of a tile's x [Cin][kTile] and g [Cout][kTile] into
// shared memory; pixels past the image's end are filled with 0.
template <bool kVec>
__device__ __forceinline__ void load_tile(const float* x, const float* g,
                                          float* sx, float* sg,
                                          long long tile, int tpi, int hw) {
  const long long n = tile / tpi;
  const int s0 = (int)(tile - n * tpi) * kTile;
  copy_rows<kCin, kTile, kTile, kBwdThreads, kVec>(sx, x + n * kCin * hw, x,
                                                   s0, hw);
  copy_rows<kCout, kTile, kTile, kBwdThreads, kVec>(sg, g + n * kCout * hw, g,
                                                    s0, hw);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <bool kVec>
__global__ void __launch_bounds__(kBwdThreads, 2)
pf_head_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ w1t, const float* __restrict__ gis,
                   const float* __restrict__ c1,
                   const float* __restrict__ w2gis, float* __restrict__ dx,
                   float* __restrict__ partial, int hw, int tpi,
                   long long ntiles) {
  extern __shared__ __align__(16) float smem[];
  float* s_x = smem;                          // [2][Cin][kTile], cp.async
  float* s_g = s_x + 2 * kCin * kTile;        // [2][Cout][kTile], cp.async
  // (big, small) pairs: x[k][p] at k * kSX + 2p (xA); the same with p
  // taken at its permuted position (xB); e[c][p] at p * kSE + 2c; w1t[c][k]
  // at k * kSW + 2c.
  uint32_t* s_xa = reinterpret_cast<uint32_t*>(s_g + 2 * kCout * kTile);
  uint32_t* s_xb = s_xa + kCin * kSX;
  uint32_t* s_e = s_xb + kCin * kSX;
  uint32_t* s_w = s_e + kTile * kSE;

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int gid = lane >> 2, tig = lane & 3;

  long long tile = blockIdx.x;
  if (tile < ntiles) {
    load_tile<kVec>(x, g, s_x, s_g, tile, tpi, hw);
  }
  for (int i = t; i < kCin * kCmid; i += kBwdThreads) {
    const int c = i / kCin, k = i % kCin;
    const Split s = split(w1t[i]);
    s_w[k * kSW + 2 * c] = s.big;
    s_w[k * kSW + 2 * c + 1] = s.small;
  }

  // The lane's two middle channels: rows gid and gid + 8 of the warp's
  // 16-row tiles.
  const int ca = warp * 16 + 2 * gid, cb = ca + 1;
  uint32_t am_b[2][4], am_s[2][4];  // A of mid^T, both k-steps
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const int k = ks * 8 + tig;
    const float a[4] = {w1t[ca * kCin + k], w1t[cb * kCin + k],
                        w1t[ca * kCin + k + 4], w1t[cb * kCin + k + 4]};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const Split s = split(a[r]);
      am_b[ks][r] = s.big;
      am_s[ks][r] = s.small;
    }
  }
  const float gis_c[2] = {gis[ca], gis[cb]};
  const float c1_c[2] = {c1[ca], c1[cb]};
  const float w2_c[2][2] = {{w2gis[ca * kCout], w2gis[ca * kCout + 1]},
                            {w2gis[cb * kCout], w2gis[cb * kCout + 1]}};

  // Block sums. dw1 n-tile nt, register r: k = gid + 8 (r >> 1), channel
  // 16w + 2 (2 tig + (r & 1)) + nt.
  float dw_hh[2][4] = {}, dw_hs[2][4] = {};
  float m0[2][2] = {}, m1[2][2] = {};  // [channel ca / cb][o]
  float db[2] = {};

  int buf = 0;
  for (; tile < ntiles; tile += gridDim.x) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // this tile's x and g in; the tile before done by all
    const long long next = tile + gridDim.x;
    if (next < ntiles) {
      load_tile<kVec>(x, g, s_x + (buf ^ 1) * kCin * kTile,
                      s_g + (buf ^ 1) * kCout * kTile, next, tpi, hw);
    }
    const float* sx = s_x + buf * kCin * kTile;
    const float* sg = s_g + buf * kCout * kTile;

    // Split the x tile once: pixels p..p+3 of channel k to xA, and each to
    // its position in xB, where the pixels of each 8 run 0,4,1,5,2,6,3,7.
    {
      const int k = t >> 4, p = (t & 15) * 4;
      const float4 v = *reinterpret_cast<const float4*>(sx + k * kTile + p);
      const Split sp[4] = {split(v.x), split(v.y), split(v.z), split(v.w)};
      uint32_t* xa = s_xa + k * kSX + 2 * p;
      *reinterpret_cast<uint4*>(xa) =
          make_uint4(sp[0].big, sp[0].small, sp[1].big, sp[1].small);
      *reinterpret_cast<uint4*>(xa + 4) =
          make_uint4(sp[2].big, sp[2].small, sp[3].big, sp[3].small);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = (p & ~7) + 2 * i + ((p & 7) >> 2);
        *reinterpret_cast<uint2*>(s_xb + k * kSX + 2 * q) =
            make_uint2(sp[i].big, sp[i].small);
      }
    }
    __syncthreads();  // xA, xB of the tile complete

#pragma unroll 2
    for (int j = 0; j < kTile / 8; ++j) {
      const int p0 = j * 8;
      // mid^T (B: xB, column n = position p0 + n): register r is channel
      // (r < 2 ? ca : cb), pixel p0 + tig + 4 (r & 1).
      float hh[4] = {0.0f, 0.0f, 0.0f, 0.0f}, hs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const uint2 b0 = *reinterpret_cast<const uint2*>(
            s_xb + (ks * 8 + tig) * kSX + 2 * (p0 + gid));
        const uint2 b1 = *reinterpret_cast<const uint2*>(
            s_xb + (ks * 8 + tig + 4) * kSX + 2 * (p0 + gid));
        const uint32_t bb[2] = {b0.x, b1.x}, bs[2] = {b0.y, b1.y};
        mma3(hh, hs, am_b[ks], am_s[ks], bb, bs);
      }
      const float gv[2][2] = {{sg[p0 + tig], sg[p0 + tig + 4]},
                              {sg[kTile + p0 + tig], sg[kTile + p0 + tig + 4]}};
      Split e[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ch = r >> 1, px = r & 1;
        const float mid = hh[r] + hs[r];
        const float a = fmaf(gis_c[ch], mid, c1_c[ch]);
        const float mk = a > 0.0f ? 1.0f : 0.0f;
        const float eun = fmaf(w2_c[ch][0], gv[0][px], w2_c[ch][1] * gv[1][px]);
        e[r] = split(mk * eun);
        const float mm = mk * mid;
#pragma unroll
        for (int o = 0; o < kCout; ++o) {
          m0[ch][o] = fmaf(mk, gv[o][px], m0[ch][o]);
          m1[ch][o] = fmaf(mm, gv[o][px], m1[ch][o]);
        }
      }
      db[0] += gv[0][0] + gv[0][1];
      db[1] += gv[1][0] + gv[1][1];
      // e to shared memory for dx: channels ca and cb are adjacent.
#pragma unroll
      for (int px = 0; px < 2; ++px) {
        *reinterpret_cast<uint4*>(s_e + (p0 + tig + 4 * px) * kSE + 2 * ca) =
            make_uint4(e[px].big, e[px].small, e[2 + px].big, e[2 + px].small);
      }
      // dw1 += x (A: xA rows k = gid, gid + 8; K = pixels p0 + tig, then
      // p0 + tig + 4) times e^T (B: the e just made; n-tile 0 holds the
      // channels ca of the 8 groups, n-tile 1 their cb).
      const uint32_t* xa = s_xa + gid * kSX + 2 * (p0 + tig);
      const uint2 a0 = *reinterpret_cast<const uint2*>(xa);
      const uint2 a1 = *reinterpret_cast<const uint2*>(xa + 8 * kSX);
      const uint2 a2 = *reinterpret_cast<const uint2*>(xa + 8);
      const uint2 a3 = *reinterpret_cast<const uint2*>(xa + 8 * kSX + 8);
      const uint32_t ab[4] = {a0.x, a1.x, a2.x, a3.x};
      const uint32_t as[4] = {a0.y, a1.y, a2.y, a3.y};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const uint32_t bb[2] = {e[2 * nt].big, e[2 * nt + 1].big};
        const uint32_t bs[2] = {e[2 * nt].small, e[2 * nt + 1].small};
        mma3(dw_hh[nt], dw_hs[nt], ab, as, bb, bs);
      }
    }
    __syncthreads();  // e of the whole tile in shared memory

    // dx for pixels 8w..8w+7: rows k = gid, gid + 8; K = the 128 channels.
    {
      float hh[4] = {0.0f, 0.0f, 0.0f, 0.0f}, hs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const uint32_t* ep = s_e + (warp * 8 + gid) * kSE;
#pragma unroll 4
      for (int ks = 0; ks < kCmid / 8; ++ks) {
        const int c = ks * 8 + tig;
        const uint2 w0 = *reinterpret_cast<const uint2*>(s_w + gid * kSW + 2 * c);
        const uint2 w1 =
            *reinterpret_cast<const uint2*>(s_w + (gid + 8) * kSW + 2 * c);
        const uint2 w2 =
            *reinterpret_cast<const uint2*>(s_w + gid * kSW + 2 * c + 8);
        const uint2 w3 = *reinterpret_cast<const uint2*>(
            s_w + (gid + 8) * kSW + 2 * c + 8);
        const uint32_t ab[4] = {w0.x, w1.x, w2.x, w3.x};
        const uint32_t as[4] = {w0.y, w1.y, w2.y, w3.y};
        const uint2 b0 = *reinterpret_cast<const uint2*>(ep + 2 * c);
        const uint2 b1 = *reinterpret_cast<const uint2*>(ep + 2 * c + 8);
        const uint32_t bb[2] = {b0.x, b1.x}, bs[2] = {b0.y, b1.y};
        mma3(hh, hs, ab, as, bb, bs);
      }
      // Register r: k = gid + 8 (r >> 1), pixel 8w + 2 tig + (r & 1).
      const long long n = tile / tpi;
      const int s = (int)(tile - n * tpi) * kTile + warp * 8 + 2 * tig;
      float* d0 = dx + (n * kCin + gid) * hw + s;
      float* d1 = d0 + 8LL * hw;
      if (kVec) {  // s even and HW % 4 == 0: both pixels in, or neither
        if (s < hw) {
          *reinterpret_cast<float2*>(d0) =
              make_float2(hh[0] + hs[0], hh[1] + hs[1]);
          *reinterpret_cast<float2*>(d1) =
              make_float2(hh[2] + hs[2], hh[3] + hs[3]);
        }
      } else {
        if (s < hw) {
          d0[0] = hh[0] + hs[0];
          d1[0] = hh[2] + hs[2];
        }
        if (s + 1 < hw) {
          d0[1] = hh[1] + hs[1];
          d1[1] = hh[3] + hs[3];
        }
      }
    }
    buf ^= 1;
  }

  // Fold M0, M1 and db2 over the 4 lanes of a group (same channels, other
  // pixels).
#pragma unroll
  for (int ch = 0; ch < 2; ++ch) {
#pragma unroll
    for (int o = 0; o < kCout; ++o) {
#pragma unroll
      for (int sh = 1; sh < 4; sh <<= 1) {
        m0[ch][o] += __shfl_xor_sync(0xffffffffu, m0[ch][o], sh);
        m1[ch][o] += __shfl_xor_sync(0xffffffffu, m1[ch][o], sh);
      }
    }
  }
#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
    db[0] += __shfl_xor_sync(0xffffffffu, db[0], sh);
    db[1] += __shfl_xor_sync(0xffffffffu, db[1], sh);
  }

  float* row = partial + (long long)blockIdx.x * kPartial;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = gid + 8 * (r >> 1);
      const int c = warp * 16 + 2 * (2 * tig + (r & 1)) + nt;
      row[k * kCmid + c] = dw_hh[nt][r] + dw_hs[nt][r];
    }
  }
  if (tig == 0) {
    float* m0row = row + kCin * kCmid;
    float* m1row = m0row + kCmid * kCout;
#pragma unroll
    for (int o = 0; o < kCout; ++o) {
      m0row[ca * kCout + o] = m0[0][o];
      m0row[cb * kCout + o] = m0[1][o];
      m1row[ca * kCout + o] = m1[0][o];
      m1row[cb * kCout + o] = m1[1][o];
    }
  }
  if (t == 0) {
    row[kPartial - 2] = db[0];
    row[kPartial - 1] = db[1];
  }
}

// out[j] = sum over rows b (in order) of partial[b, j].
__global__ void reduce_rows_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, int rows,
                                   int cols) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cols) return;
  float s = 0.0f;
  for (int b = 0; b < rows; ++b) s += partial[(long long)b * cols + j];
  out[j] = s;
}

}  // namespace

// Number of blocks pf_head_bwd launches for n images of hw pixels (the
// wrapper sizes the [blocks, pf_head_bwd_partial_cols()] scratch with it):
// two per SM, fewer if there are fewer tiles.
extern "C" int pf_head_bwd_blocks(long long n, int hw) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess) {
    return -1;
  }
  const long long ntiles = n * ((hw + kTile - 1) / kTile);
  const long long want = 2LL * sms;
  return (int)(ntiles < want ? (ntiles > 0 ? ntiles : 1) : want);
}

extern "C" int pf_head_bwd_partial_cols() { return kPartial; }

// x [N,Cin,HW], g [N,Cout,HW], w1t [Cmid,Cin], gis [Cmid], c1 [Cmid],
// w2gis [Cmid,Cout]; dx [N,Cin,HW]; partial [blocks, kPartial] scratch;
// sums [kPartial] = dw1 [Cin,Cmid] | M0 [Cmid,Cout] | M1 [Cmid,Cout] | db2.
extern "C" int pf_head_bwd(const float* x, const float* g, const float* w1t,
                           const float* gis, const float* c1,
                           const float* w2gis, float* dx, float* partial,
                           float* sums, long long n, int cin, int hw,
                           int cmid, int cout, int blocks, void* stream) {
  if (cin != kCin || cmid != kCmid || cout != kCout || hw <= 0 ||
      blocks <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int tpi = (hw + kTile - 1) / kTile;
  const long long ntiles = n * tpi;
  const bool vec = hw % 4 == 0 &&
                   (((uintptr_t)x | (uintptr_t)g | (uintptr_t)dx) & 15) == 0;
  const size_t smem = (size_t)kBwdSmemFloats * sizeof(float);
  auto kernel = vec ? pf_head_bwd_kernel<true> : pf_head_bwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kBwdThreads, smem, (cudaStream_t)stream>>>(
      x, g, w1t, gis, c1, w2gis, dx, partial, hw, tpi, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<(kPartial + 255) / 256, 256, 0,
                       (cudaStream_t)stream>>>(partial, sums, blocks,
                                               kPartial);
  return (int)cudaGetLastError();
}

// x [N,Cin,HW], g1t [Cmid,Cin], c1 [Cmid], w2 [Cout,Cmid], b2 [Cout],
// out [N,Cout,HW]; all contiguous float32 on the current device.
extern "C" int pf_head_fwd(const float* x, const float* g1t, const float* c1,
                           const float* w2, const float* b2, float* out,
                           long long n, int cin, int hw, int cmid, int cout,
                           void* stream) {
  const int tpi = hw > 0 ? (hw + kFwdTile - 1) / kFwdTile : 0;
  // Tile indices are 32-bit (room left for the block stride).
  if (cin != kCin || cout != kCout || cmid <= 0 || cmid % 16 != 0 ||
      cmid > kFwdMaxCmid || hw <= 0 || n < 0 || n * tpi > (1LL << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  const int ntiles = (int)(n * tpi);
  const bool vec = hw % 4 == 0 && ((uintptr_t)x & 15) == 0;
  const size_t smem = fwd_smem_bytes(cmid);
  auto kernel = vec ? pf_head_fwd_kernel<true> : pf_head_fwd_kernel<false>;
  // Persistent blocks: as many as fit on the card at once.
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess ||
      (err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kFwdThreads, smem)) != cudaSuccess) {
    return (int)err;
  }
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int blocks = ntiles < sms * per_sm ? ntiles : sms * per_sm;
  kernel<<<blocks, kFwdThreads, smem, (cudaStream_t)stream>>>(
      x, g1t, c1, w2, b2, out, hw, tpi, ntiles, cmid);
  return (int)cudaGetLastError();
}
