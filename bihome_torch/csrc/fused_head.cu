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
// kFwdMaxCmid (128 for the ResNet34-flavour head). The ResNet50-flavour
// head (Cin 64, Cmid 512) has kernels of its own, at the end of this file.
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

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
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
// [kRows][hw] block src into dst (row stride kStride words), by kThreads
// threads, of which this is number t (copy_rows: a block of kThreads, t =
// threadIdx.x).
// Pixels past hw are filled with 0 (the source then points at ``any``, the
// tensor's start, and no byte of it is read). kVec: 16-byte copies (HW % 4
// == 0 and src 16-byte aligned, so a chunk of 4 pixels is all in or all
// out), else 4-byte ones.
template <int kRows, int kPx, int kStride, int kThreads, bool kVec>
__device__ __forceinline__ void copy_rows_by(int t, float* dst,
                                             const float* src,
                                             const float* any, int s0,
                                             int hw) {
  if (kVec) {
    for (int i = t; i < kRows * kPx / 4; i += kThreads) {
      const int k = i / (kPx / 4), q = i % (kPx / 4) * 4;
      const bool in = s0 + q < hw;
      cp_async16(dst + k * kStride + q,
                 in ? src + (long long)k * hw + s0 + q : any, in ? 16 : 0);
    }
  } else {
    for (int i = t; i < kRows * kPx; i += kThreads) {
      const int k = i / kPx, p = i % kPx;
      const bool in = s0 + p < hw;
      cp_async4(dst + k * kStride + p,
                in ? src + (long long)k * hw + s0 + p : any, in ? 4 : 0);
    }
  }
}

template <int kRows, int kPx, int kStride, int kThreads, bool kVec>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          const float* any, int s0, int hw) {
  copy_rows_by<kRows, kPx, kStride, kThreads, kVec>(threadIdx.x, dst, src,
                                                     any, s0, hw);
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

// ---------------------------------------------------------------------------
// K1 and K2 at bfloat16 (MODEL.DTYPE bfloat16): the narrow head (Cin 16)
// on a bf16 activation, as the TPU kernels run when the PF head hands them
// bf16 x (bihome_tpu/models/backbones.py:69-73). Their rounding points are
// the Pallas kernels' (bihome_tpu/ops/fused_head.py):
//   * K1 (_fwd_kernel, :93-107, with _run_fwd's bf16 g1t, :201):
//       out = bf16(b2 + bf16(w2)^T bf16(relu(bf16(g1t) x + c1))),
//     the products on the tensor cores, the sums in fp32, c1 and b2 fp32;
//   * K2 (_bwd_kernel, :130-167): mid = bf16(w1t) x, the mask and
//     e = mask ((gis w2) g) in fp32, dx = bf16(bf16(w1) bf16(e)), and
//     dw1 = x bf16(e)^T, M0, M1, db2 summed in fp32 (the rank-Cin
//     corrections outside, as for the fp32 kernels).
// A product of two bf16 values is exact in fp32, so both match the Pallas
// kernels up to the order of the fp32 sums.
//
// Bounds on the H100 at the zeng training shape (x [128,16,128,128], M =
// 2,097,152 pixels, Cmid 128; the smoke recomputes them from its inputs):
//   * K1 reads 67.1 MB of x and writes 8.4 MB: 0.0225 ms of bytes at 3.35
//     TB/s, against 9.7 GFLOP of tensor work at 989 TFLOP/s (0.010 ms); its
//     fp32 work is gone (the ReLU and the rounding are one cvt per two
//     middle values, the Cmid x Cout product is on the tensor cores);
//   * K2 reads x and g and writes dx, 142.6 MB: 0.043 ms of bytes; its four
//     products (mid, dx, dw1 and M0 = sum mask g) are 26.9 GFLOP (0.027 ms
//     on the tensor cores); the rest, per middle value the mask (mid
//     against a per-channel threshold, no a = gis mid + c1), e and M1 (2 +
//     4 Cout flops), is 0.040 ms at 67 TFLOP/s on the fp32 cores. The
//     bound is the bytes.
//
// Both kernels use mma.sync.m16n8k16 bf16 (K = 16: one step over Cin),
// ldmatrix/stmatrix for the operands that live in shared memory, and
// persistent blocks that keep a ring of kB*Stages tiles in flight by
// cp.async (16-byte copies when HW % 8 == 0 and the pointers are 16-byte
// aligned, else plain loads; pixels past an image's end are zero-filled).
// One __syncthreads per tile both publishes the next tile's copies and
// frees the slot the tile before used.
//
// K1 (pf_head_fwd_bf16_kernel): 8 warps, tiles of 128 kB1MT pixels, warp
// w owns kB1MT m-tiles of 16 pixels and walks all Cmid channels 16 at a
// time, the next step's weights loaded while a step computes:
//   * mid^T [16 px, 8 ch] = x^T (A: one ldmatrix.x4.trans per m-tile and
//     tile, from the [Cin][px] tile) bf16(g1t)^T (B, from shared memory in
//     fragment order), the accumulator started at c1;
//   * cvt.rn.relu.bf16x2.f32 turns two accumulator values into the packed
//     bf16(relu(a)) pair (NaN stays NaN, as jnp.maximum keeps it), and the
//     accumulators of n-tiles 2j and 2j + 1 are then exactly the A fragment
//     of one m16n8k16 step over their 16 channels: out^T [16 px, 8] +=
//     bf16(relu(a))^T bf16(w2)^T (Cout 2 padded to 8 with zero columns);
//   * two output accumulators per m-tile (even and odd 16-channel steps)
//     keep two independent chains of products in flight; they are added,
//     b2 with them, at the tile's end and the lane quad's first lane
//     stores its pixels' two outputs;
//   * four m-tiles a warp measured faster than two (the shared weight
//     loads serve more products). With mid on wgmma (m64n64k16, A from
//     registers, B the g1t image), one m-tile ahead of the epilogue, and
//     the Cmid x Cout product on mma.sync or wgmma m64n8k16, K1 measured
//     slower (0.0745 against 0.0594 ms in one call): its fences, groups
//     and waits cost more than the products they free.
//
// What holds them back (H100 80GB HBM3, 700 W; python -m
// bihome_torch.profile_kernels --kernel k1b|k2b cuts each part out and
// times the rest): mma.sync's products do not overlap the fp32 and
// shared-memory work around them. mma.sync m16n8k16 bf16 reaches 630
// TFLOP/s with 8 independent products a warp (profile_kernels
// --mma_rate), which would take K2's 7.3 M products 0.047 ms, yet cutting
// them saves 0.10 of its 0.23 ms; the rest is the epilogue, about 8
// fp32 instructions per middle value (e, the mask, M1: 0.07 ms at one
// instruction per cycle on each SM sub-partition). K1 is bound neither
// by its loads (cut, they save 0.004 of 0.059 ms) nor by its products
// alone (0.020). The next step for both is wgmma with enough in flight
// that its waits hide (a warp-specialised producer, two tiles of
// accumulators).
//
// K2 (pf_head_bwd_bf16_kernel): 8 warps, two blocks per SM, tiles of 128
// pixels, warp w owns middle channels 16w..16w+15 (rows gid and gid + 8 of
// its tiles are channels ca = 16w + gid and cb = ca + 8):
//   * mid^T [16 ch, 8 px] = bf16(w1t) (A, registers) x the x tile (B: one
//     ldmatrix.x4.trans per 16 pixels);
//   * the mask without a's FMA: fmaf(gis, mid, c1) > 0 is monotone in mid,
//     so it is mid > t for a threshold t found once per channel by
//     bisection over the floats (relu_threshold); w1t's rows are negated
//     where gis < 0 (exact in bf16 and in the products), and M1 is negated
//     back at the end. This is the same mask bit for bit, except for an
//     infinite mid on a channel with gis == 0 (fmaf gives NaN there);
//   * per middle value the fp32 cores do the mask (set.gt: 1.0f or 0), e =
//     mask ((gis w2) g) (a multiply, an FMA and the mask's multiply, as
//     the Pallas kernel rounds it) and M1 (mask mid, 2 FMAs), from g
//     staged as fp32 per warp once per tile (one 16-byte load gives a lane
//     both outputs at its two pixels); db2 is summed there;
//   * M0 = sum mask g runs on the tensor cores: the mask packs as exact bf16
//     0/1 (the high halves of two set.gt results, one byte permutation)
//     into the A fragment of one m16n8k16 step over 16 pixels (the
//     accumulators of two 8-pixel halves of mid are that fragment), B is g
//     (Cout 2 padded to 8), and mask g is exact, so M0 is exact up to the
//     order of its fp32 sums. M1's operand mask mid is fp32 and stays on the
//     fp32 cores: a two-term bf16 split of it costs more instructions per
//     value than the two FMAs it would save;
//   * the 16-pixel chunks are software-pipelined: chunk j + 1's ldmatrix,
//     mid' products and g loads are issued before chunk j's epilogue;
//   * bf16(e) of 16 pixels (packed by cvt.rn.bf16x2.f32) is at once the B
//     operand of dw1 [16 k, 8 ch] += x (A: one ldmatrix.x4 per 16 pixels)
//     e^T, and goes by one stmatrix.x4.trans into a [pixel][channel] tile
//     (double-buffered), from which, after the tile's barrier, warp w
//     forms dx of pixels 16w..16w+15 over all 128 channels (A = bf16(w1),
//     from shared memory in fragment order; B by ldmatrix.x4; the two
//     8-pixel halves' chains of products interleaved). Spread over the
//     next tile's chunks instead, dx measured slower (an issue-bound
//     kernel gets no gaps to fill). All shared rows of x, g and e are 272
//     bytes apart, so every ldmatrix and stmatrix is free of bank
//     conflicts;
//   * dw1, M0, M1 and db2 stay in registers across the block's tiles; each
//     block writes one row of sums, added in block order by
//     reduce_rows_kernel (deterministic, no atomics).

constexpr int kB1MT = 4;                  // K1 bf16: m-tiles of 16 px a warp
constexpr int kB1Tile = 8 * 16 * kB1MT;   // K1 bf16: pixels per tile
constexpr int kB1Stages = 4;              // K1 bf16: tiles in the ring
constexpr int kB1SX = kB1Tile + 8;        // row stride of its x tiles
constexpr int kB2Tile = 128;              // K2 bf16: pixels per tile
constexpr int kB2Stages = 4;              // K2 bf16: tiles in the ring
constexpr int kB2SX = kB2Tile + 8;        // row stride of its x, g tiles
constexpr int kB2SE = kCmid + 8;          // row stride of its e tile
// K2 bf16's shared memory: the ring of x and g tiles, the two e tiles, g
// as fp32 per warp, and bf16(w1)'s A fragments for dx (a uint4 per k-step
// and lane).
constexpr int kBwdBf16SmemBytes =
    (int)sizeof(uint16_t) * (kB2Stages * (kCin + kCout) * kB2SX +
                             2 * kB2Tile * kB2SE) +
    (int)sizeof(float4) * (kBwdThreads / 32) * (kB2Tile / 2) +
    (int)sizeof(uint4) * (kCmid / 16) * 32;

// d = a b + c on the tensor cores: m16n8k16, bf16 operands, fp32
// accumulator; d may be c.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b, const float* c) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// The bf16 bits of a (round to nearest even, as torch's and XLA's casts).
__device__ __forceinline__ uint32_t bf16_bits(float a) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a));
}

// bf16(lo) in the low half, bf16(hi) in the high half: an mma operand
// register holding two elements, the lower-indexed one low.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

// pack_bf16 in one instruction (cvt puts its first operand high).
__device__ __forceinline__ uint32_t cvt_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// pack_bf16(relu(lo), relu(hi)) in one instruction; NaN stays NaN.
__device__ __forceinline__ uint32_t cvt_relu_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float bf16_value(uint16_t h) {
  return __uint_as_float((uint32_t)h << 16);
}

__device__ __forceinline__ uint32_t load_pair(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void cp_async16_bytes(void* dst, const void* src,
                                                 int bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Four 8x8 bf16 matrices from shared memory into mma fragments: lanes
// 8i..8i+7 give the addresses of matrix i's rows; register i of a lane is
// its (row lane / 4, elements 2 (lane % 4), + 1) of matrix i, or with
// ``trans`` its (rows 2 (lane % 4), + 1, element lane / 4). Volatile, and
// ordered with the barriers and cp.async waits (volatile too), but without
// a memory clobber, so that the compiler keeps plain loads in registers
// across them.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// The inverse of ldsm_x4_trans: register i of each lane (fragment layout)
// into matrix i, transposed (element (row, col) to memory row col).
__device__ __forceinline__ void stsm_x4_trans(void* p,
                                              const uint32_t (&r)[4]) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1,%2,%3,%4};\n"
      ::"r"(s), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]));
}

// Pixels s0..s0+kPx-1 of rows 0..kRows-1 of one image's bf16 [kRows][hw]
// block src into dst (row stride kStride halves); pixels past hw are 0.
// kVec (HW % 8 == 0, src 16-byte aligned): cp.async of 8 pixels, all in or
// all out; else plain loads and stores (cp.async has no 2-byte copy).
template <int kRows, int kPx, int kStride, int kThreads, bool kVec>
__device__ __forceinline__ void copy_rows_bf16(uint16_t* dst,
                                               const uint16_t* src,
                                               const uint16_t* any, int s0,
                                               int hw) {
  if (kVec) {
    for (int i = threadIdx.x; i < kRows * kPx / 8; i += kThreads) {
      const int k = i / (kPx / 8), q = i % (kPx / 8) * 8;
      const bool in = s0 + q < hw;
      cp_async16_bytes(dst + k * kStride + q,
                       in ? src + (long long)k * hw + s0 + q : any,
                       in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * kPx; i += kThreads) {
      const int k = i / kPx, p = i % kPx;
      dst[k * kStride + p] =
          s0 + p < hw ? src[(long long)k * hw + s0 + p] : (uint16_t)0;
    }
  }
}

// copy_rows_bf16 with the copies of each thread unrolled at compile time
// (the narrow bf16 kernels issue one or two per thread and tile, and the
// loop form costs more instructions than the copies).
template <int kRows, int kPx, int kStride, int kThreads, bool kVec>
__device__ __forceinline__ void copy_tile_bf16(uint16_t* dst,
                                               const uint16_t* src,
                                               const uint16_t* any, int s0,
                                               int hw) {
  constexpr int kChunks = kRows * kPx / 8;
  if (!kVec) {
    copy_rows_bf16<kRows, kPx, kStride, kThreads, false>(dst, src, any, s0,
                                                          hw);
    return;
  }
#pragma unroll
  for (int it = 0; it < (kChunks + kThreads - 1) / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (kChunks % kThreads == 0 || i < kChunks) {
      const int k = i / (kPx / 8), q = i % (kPx / 8) * 8;
      const bool in = s0 + q < hw;
      cp_async16_bytes(dst + k * kStride + q,
                       in ? src + (long long)k * hw + s0 + q : any,
                       in ? 16 : 0);
    }
  }
}

// K1 bf16's shared memory in bytes: the ring of x tiles; per 16-channel
// step j, bf16(g1t)^T's B fragments of n-tiles 2j and 2j + 1 (a uint4 per
// lane), the accumulators' c1 start of both n-tiles (two float4 per lane
// quad, in accumulator order, so that they are the products' C operands as
// loaded), and bf16(w2)^T's B fragment (a uint2 per lane); two steps more
// than Cmid has, which the step loop's prefetch reads and does not use.
constexpr size_t fwd_bf16_smem_bytes(int cmid) {
  return sizeof(uint16_t) * kB1Stages * kCin * kB1SX +
         (size_t)(cmid / 16 + 2) * (32 * sizeof(uint4) + 8 * sizeof(float4) +
                                    32 * sizeof(uint2));
}

template <bool kVec>
__device__ __forceinline__ void load_fwd_tile_bf16(const uint16_t* x,
                                                   uint16_t* sx, int tile,
                                                   int tpi, int hw) {
  const int n = tile / tpi;
  const int s0 = (tile - n * tpi) * kB1Tile;
  copy_tile_bf16<kCin, kB1Tile, kB1SX, kFwdThreads, kVec>(
      sx, x + (long long)n * kCin * hw, x, s0, hw);
}

// The shared operands of K1 bf16's 16-channel step j: bf16(g1t)^T's B
// fragments of n-tiles 2j and 2j + 1, their c1 starts (C operands) and
// bf16(w2)^T's B fragment.
struct FwdStep {
  uint4 b;
  float4 c0, c8;
  uint2 w;
};

__device__ __forceinline__ void fwd_bf16_load_step(FwdStep& f,
                                                   const uint4* s_b,
                                                   const float4* s_c,
                                                   const uint2* s_w, int j,
                                                   int lane) {
  const int tig = lane & 3;
  f.b = s_b[j * 32 + lane];
  f.c0 = s_c[(j * 4 + tig) * 2];
  f.c8 = s_c[(j * 4 + tig) * 2 + 1];
  f.w = s_w[j * 32 + lane];
}

// K1 bf16's step for the warp's kB1MT m-tiles: mid^T of n-tiles 2j and
// 2j + 1 from c1, bf16(relu) of both as one A fragment, and out^T += that
// bf16(w2)^T into acc[mt][parity].
__device__ __forceinline__ void fwd_bf16_step(const FwdStep& f,
                                              const uint32_t (&a)[kB1MT][4],
                                              float (&acc)[kB1MT][2][4],
                                              int parity) {
  const uint32_t b0[2] = {f.b.x, f.b.y}, b1[2] = {f.b.z, f.b.w};
  const uint32_t bw[2] = {f.w.x, f.w.y};
  const float c0[4] = {f.c0.x, f.c0.y, f.c0.z, f.c0.w};
  const float c8[4] = {f.c8.x, f.c8.y, f.c8.z, f.c8.w};
#pragma unroll
  for (int mt = 0; mt < kB1MT; ++mt) {
    float d0[4], d1[4];
    mma_bf16(d0, a[mt], b0, c0);
    mma_bf16(d1, a[mt], b1, c8);
    const uint32_t r[4] = {cvt_relu_bf16x2(d0[0], d0[1]),
                           cvt_relu_bf16x2(d0[2], d0[3]),
                           cvt_relu_bf16x2(d1[0], d1[1]),
                           cvt_relu_bf16x2(d1[2], d1[3])};
    mma_bf16(acc[mt][parity], r, bw, acc[mt][parity]);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kFwdThreads, 2)
pf_head_fwd_bf16_kernel(const uint16_t* __restrict__ x,
                        const float* __restrict__ g1t,
                        const float* __restrict__ c1,
                        const float* __restrict__ w2,
                        const float* __restrict__ b2,
                        uint16_t* __restrict__ out, int hw, int tpi,
                        int ntiles, int cmid) {
  extern __shared__ __align__(16) float smem[];
  const int steps = cmid / 16;                          // 16-channel steps
  uint16_t* s_x = reinterpret_cast<uint16_t*>(smem);  // [stage][Cin][kB1SX]
  uint4* s_b = reinterpret_cast<uint4*>(s_x + kB1Stages * kCin * kB1SX);
  float4* s_c = reinterpret_cast<float4*>(s_b + (steps + 2) * 32);
  uint2* s_w = reinterpret_cast<uint2*>(s_c + (steps + 2) * 8);

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int gid = lane >> 2, tig = lane & 3;

  for (int s = 0; s < kB1Stages - 1; ++s) {
    const int tile = blockIdx.x + s * gridDim.x;
    if (tile < ntiles) {
      load_fwd_tile_bf16<kVec>(x, s_x + s * kCin * kB1SX, tile, tpi, hw);
    }
    cp_async_commit();
  }
  // Step j, lane l: B (m16n8k16, col) of g1t^T for n-tiles 2j and 2j + 1,
  // channel 16j + 8h + l / 4 at k = 2 (l % 4), + 1 and k + 8, + 9.
  for (int i = t; i < steps * 32; i += kFwdThreads) {
    const int l = i & 31, j = i >> 5;
    const float* r0 = g1t + (16 * j + (l >> 2)) * kCin + 2 * (l & 3);
    const float* r1 = r0 + 8 * kCin;
    s_b[i] = make_uint4(pack_bf16(r0[0], r0[1]), pack_bf16(r0[8], r0[9]),
                        pack_bf16(r1[0], r1[1]), pack_bf16(r1[8], r1[9]));
    // B of out^T [16 px, 8] += relu^T w2^T: output l / 4 (0 past Cout) at
    // channels 16j + 2 (l % 4), + 1 and + 8, + 9.
    const int o = l >> 2, ch = 16 * j + 2 * (l & 3);
    s_w[i] = o < kCout ? make_uint2(pack_bf16(w2[o * cmid + ch],
                                              w2[o * cmid + ch + 1]),
                                    pack_bf16(w2[o * cmid + ch + 8],
                                              w2[o * cmid + ch + 9]))
                       : make_uint2(0u, 0u);
  }
  // Accumulator columns of lane quad q at step j: channels 16j + 2q, + 1
  // (n-tile 2j) and + 8, + 9 (n-tile 2j + 1), at both of its pixels.
  for (int i = t; i < steps * 4; i += kFwdThreads) {
    const int ch = (i >> 2) * 16 + 2 * (i & 3);
    s_c[2 * i] = make_float4(c1[ch], c1[ch + 1], c1[ch], c1[ch + 1]);
    s_c[2 * i + 1] = make_float4(c1[ch + 8], c1[ch + 9], c1[ch + 8],
                                 c1[ch + 9]);
  }
  const float b2_0 = b2[0], b2_1 = b2[1];

  int i = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++i) {
    cp_async_wait<kB1Stages - 2>();
    __syncthreads();  // this tile's x in; the tile before done by all
    {
      const int next = tile + (kB1Stages - 1) * gridDim.x;
      if (next < ntiles) {
        load_fwd_tile_bf16<kVec>(
            x, s_x + (i + kB1Stages - 1) % kB1Stages * kCin * kB1SX, next,
            tpi, hw);
      }
      cp_async_commit();
    }
    const uint16_t* sx = s_x + i % kB1Stages * kCin * kB1SX;

    // A (m16n8k16, row) of x^T for m-tile mt (pixels kB1MT 16 w + 16 mt +
    // 0..15): matrices (Cin 0-7, px 0-7), (Cin 0-7, px 8-15), (Cin 8-15, px
    // 0-7), (Cin 8-15, px 8-15), transposed.
    uint32_t a[kB1MT][4];
#pragma unroll
    for (int mt = 0; mt < kB1MT; ++mt) {
      ldsm_x4_trans(a[mt], sx + ((lane & 7) + ((lane >> 4) << 3)) * kB1SX +
                               (warp * kB1MT + mt) * 16 +
                               ((lane >> 3) & 1) * 8);
    }

    // acc[mt][parity]: out^T of m-tile mt over the even or odd steps (two
    // independent chains of products). Register r: pixel gid + 8 (r >> 1),
    // output 2 tig + (r & 1). The next step's operands are loaded while a
    // step computes (the padding steps make the last loads safe).
    float acc[kB1MT][2][4] = {};
    FwdStep cur, nxt;
    fwd_bf16_load_step(cur, s_b, s_c, s_w, 0, lane);
    for (int j = 0; j < steps; j += 2) {
      fwd_bf16_load_step(nxt, s_b, s_c, s_w, j + 1, lane);
      fwd_bf16_step(cur, a, acc, 0);
      fwd_bf16_load_step(cur, s_b, s_c, s_w, j + 2, lane);
      if (j + 1 < steps) fwd_bf16_step(nxt, a, acc, 1);
    }

    // The quad's first lane holds its pixels' outputs: store bf16(sum + b2).
    if (tig == 0) {
      const int n = tile / tpi;
      const int s0 = (tile - n * tpi) * kB1Tile + warp * kB1MT * 16 + gid;
      uint16_t* o0 = out + (long long)n * kCout * hw;
      uint16_t* o1 = o0 + hw;
#pragma unroll
      for (int mt = 0; mt < kB1MT; ++mt) {
#pragma unroll
        for (int px = 0; px < 2; ++px) {
          const int s = s0 + mt * 16 + 8 * px;
          const float v0 = acc[mt][0][2 * px] + acc[mt][1][2 * px];
          const float v1 = acc[mt][0][2 * px + 1] + acc[mt][1][2 * px + 1];
          if (s < hw) {
            o0[s] = (uint16_t)bf16_bits(v0 + b2_0);
            o1[s] = (uint16_t)bf16_bits(v1 + b2_1);
          }
        }
      }
    }
  }
}

// Ordered integer of a float (not NaN): -0 and +0 both 0.
__device__ __forceinline__ long long float_key(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? (long long)b : -(long long)(b & 0x7fffffff);
}

__device__ __forceinline__ float key_float(long long k) {
  return k >= 0 ? __int_as_float((int)k)
                : __int_as_float((int)(0x80000000u | (uint32_t)(-k)));
}

// The threshold t with fmaf(g, m, c1) > 0 exactly when m > t, for g =
// |gis| (monotone in m for g > 0): the largest float at which it is not
// positive, by bisection over the ordered floats. g == 0: c1 > 0 for every
// finite m (-inf or +inf); NaN g or c1, or no m positive: +inf.
__device__ float relu_threshold(float g, float c1) {
  const float inf = __int_as_float(0x7f800000);
  if (g == 0.0f) return c1 > 0.0f ? -inf : inf;
  if (!(fmaf(g, inf, c1) > 0.0f)) return inf;
  long long lo = float_key(-inf), hi = float_key(inf);
  while (hi - lo > 1) {  // not positive at lo, positive at hi
    const long long m = lo + (hi - lo) / 2;
    if (fmaf(g, key_float(m), c1) > 0.0f) {
      hi = m;
    } else {
      lo = m;
    }
  }
  return key_float(lo);
}

// 1.0f where a > b, else 0.0f (NaN: 0), in one instruction.
__device__ __forceinline__ float set_gt(float a, float b) {
  float r;
  asm("set.gt.f32.f32 %0, %1, %2;\n" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The bf16 pair (lo, hi) of two masks from set_gt (1.0f or 0.0f): their
// high halves, which are bf16 1.0 or 0, in one byte permutation.
__device__ __forceinline__ uint32_t mask_pair(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

template <bool kVec>
__device__ __forceinline__ void load_tile_bf16(const uint16_t* x,
                                               const uint16_t* g,
                                               uint16_t* sx, uint16_t* sg,
                                               int tile, int tpi, int hw) {
  const int n = tile / tpi;
  const int s0 = (tile - n * tpi) * kB2Tile;
  copy_tile_bf16<kCin, kB2Tile, kB2SX, kBwdThreads, kVec>(
      sx, x + (long long)n * kCin * hw, x, s0, hw);
  copy_tile_bf16<kCout, kB2Tile, kB2SX, kBwdThreads, kVec>(
      sg, g + (long long)n * kCout * hw, g, s0, hw);
}

// The operands of one of K2 bf16's 16-pixel chunks (p0..p0+15 of a tile),
// loaded one chunk ahead of its epilogue: mid'^T of both 8-pixel halves
// (registers as the accumulator: channel (r < 2 ? ca : cb), pixel p0 + 8h
// + 2 tig + (r & 1)), x's A fragment of dw1, g as fp32 at the lane's two
// pixel pairs ((g0, g0, g1, g1)), and g's B fragment of M0.
struct BwdChunk {
  float mid[2][4];
  uint32_t ax[4];
  float4 gv[2];
  uint32_t bg[2];
};

__device__ __forceinline__ void bwd_bf16_load_chunk(
    BwdChunk& c, const uint16_t* xq, const float4* gf, const uint16_t* sg,
    int p0, int lane, const uint32_t (&am)[4]) {
  const int gid = lane >> 2, tig = lane & 3;
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  // Matrices (Cin 0-7, px p0..+7), (Cin 8-15, p0..), (Cin 0-7, p0 + 8..),
  // (Cin 8-15, p0 + 8..): transposed they are B of mid'^T for the two
  // 8-pixel halves, as they are A of dw1 [16 k, 16 px].
  uint32_t bx[4];
  ldsm_x4_trans(bx, xq + p0);
  ldsm_x4(c.ax, xq + p0);
  mma_bf16(c.mid[0], am, bx, zero);
  mma_bf16(c.mid[1], am, bx + 2, zero);
  c.gv[0] = gf[p0 / 2 + tig];
  c.gv[1] = gf[p0 / 2 + 4 + tig];
  // B of M0 (col: output gid at pixels p0 + 2 tig, + 1 and + 8, + 9).
  const uint16_t* gp = sg + gid * kB2SX + p0 + 2 * tig;
  c.bg[0] = gid < kCout ? load_pair(gp) : 0u;
  c.bg[1] = gid < kCout ? load_pair(gp + 8) : 0u;
}

// K2 bf16's epilogue and products for one chunk of the warp's 16 channels:
// e, the mask, M1' and the chunk's share of dw1 and M0, and bf16(e) into
// the [pixel][channel] tile se.
__device__ __forceinline__ void bwd_bf16_chunk(
    const BwdChunk& c, uint16_t* se, int p0, int lane, int warp,
    const float (&thr)[2], const float (&w2_c)[2][2], float (&dw)[2][4],
    float (&m0)[4], float (&m1)[2][2]) {
  uint32_t eb[2][2], mk[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float e[4], on[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int ch = r >> 1;
      const float g0 = (r & 1) ? c.gv[h].y : c.gv[h].x;
      const float g1 = (r & 1) ? c.gv[h].w : c.gv[h].z;
      on[r] = set_gt(c.mid[h][r], thr[ch]);
      e[r] = on[r] * fmaf(w2_c[ch][0], g0, w2_c[ch][1] * g1);
      const float mm = on[r] * c.mid[h][r];
      m1[ch][0] = fmaf(mm, g0, m1[ch][0]);
      m1[ch][1] = fmaf(mm, g1, m1[ch][1]);
    }
    eb[h][0] = cvt_bf16x2(e[0], e[1]);
    eb[h][1] = cvt_bf16x2(e[2], e[3]);
    mk[h][0] = mask_pair(on[0], on[1]);
    mk[h][1] = mask_pair(on[2], on[3]);
  }
  // dw1 [16 k, 8 ch] += x (A) times bf16(e)^T (B, col: the lane's own eb;
  // n-tile 0 holds channels ca of the 8 groups, n-tile 1 their cb).
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const uint32_t b[2] = {eb[0][nt], eb[1][nt]};
    mma_bf16(dw[nt], c.ax, b, dw[nt]);
  }
  // M0 [16 ch, 8] += mask (A: rows ca, cb; K = the 16 pixels) times g.
  {
    const uint32_t a[4] = {mk[0][0], mk[0][1], mk[1][0], mk[1][1]};
    mma_bf16(m0, a, c.bg, m0);
  }
  // bf16(e) into the [pixel][channel] tile: matrices (ca rows, px p0..),
  // (cb rows, p0..), (ca, p0 + 8..), (cb, p0 + 8..), transposed.
  {
    const uint32_t r[4] = {eb[0][0], eb[0][1], eb[1][0], eb[1][1]};
    stsm_x4_trans(se + (p0 + (lane & 7) + ((lane >> 4) << 3)) * kB2SE +
                      warp * 16 + ((lane >> 3) & 1) * 8,
                  r);
  }
}

// K2 bf16's dx for pixels 16w..16w+15 of a tile whose bf16(e) is in se:
// rows k = gid, gid + 8; K = the 128 channels. A = bf16(w1) from s_aw in
// fragment order; B (col) by ldmatrix: pixel gid of half h at channels
// 32 kk + 8 i.., registers 2i, 2i + 1 the k-steps 2 kk and 2 kk + 1. The
// two halves' chains of products are interleaved.
__device__ __forceinline__ void bwd_bf16_dx(const uint16_t* se,
                                            const uint4* s_aw, int lane,
                                            int warp, float (&dxa)[2][4]) {
  uint4 aw[kCmid / 16];
#pragma unroll
  for (int ks = 0; ks < kCmid / 16; ++ks) aw[ks] = s_aw[ks * 32 + lane];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int r = 0; r < 4; ++r) dxa[h][r] = 0.0f;
  }
  const uint16_t* ep = se + (warp * 16 + (lane & 7)) * kB2SE + (lane >> 3) * 8;
#pragma unroll
  for (int kk = 0; kk < kCmid / 32; ++kk) {
    const uint32_t a0[4] = {aw[2 * kk].x, aw[2 * kk].y, aw[2 * kk].z,
                            aw[2 * kk].w};
    const uint32_t a1[4] = {aw[2 * kk + 1].x, aw[2 * kk + 1].y,
                            aw[2 * kk + 1].z, aw[2 * kk + 1].w};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t b[4];
      ldsm_x4(b, ep + 8 * h * kB2SE + 32 * kk);
      mma_bf16(dxa[h], a0, b, dxa[h]);
      mma_bf16(dxa[h], a1, b + 2, dxa[h]);
    }
  }
}

// Store K2 bf16's dx of pixels 16w..16w+15 of tile ``tile``: register r of
// half h is k = gid + 8 (r >> 1), pixel 16w + 8h + 2 tig + (r & 1).
template <bool kVec>
__device__ __forceinline__ void bwd_bf16_dx_store(uint16_t* dx,
                                                  const float (&dxa)[2][4],
                                                  int tile, int tpi, int hw,
                                                  int lane, int warp) {
  const int gid = lane >> 2, tig = lane & 3;
  const int n = tile / tpi;
  const int s0 = (tile - n * tpi) * kB2Tile + warp * 16 + 2 * tig;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* d = dxa[h];
    const int s = s0 + 8 * h;
    uint16_t* d0 = dx + ((long long)n * kCin + gid) * hw + s;
    uint16_t* d1 = d0 + 8LL * hw;
    if (kVec) {  // s even and HW % 8 == 0: both pixels in, or neither
      if (s < hw) {
        *reinterpret_cast<uint32_t*>(d0) = cvt_bf16x2(d[0], d[1]);
        *reinterpret_cast<uint32_t*>(d1) = cvt_bf16x2(d[2], d[3]);
      }
    } else {
      if (s < hw) {
        d0[0] = (uint16_t)bf16_bits(d[0]);
        d1[0] = (uint16_t)bf16_bits(d[2]);
      }
      if (s + 1 < hw) {
        d0[1] = (uint16_t)bf16_bits(d[1]);
        d1[1] = (uint16_t)bf16_bits(d[3]);
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kBwdThreads, 2)
pf_head_bwd_bf16_kernel(const uint16_t* __restrict__ x,
                        const uint16_t* __restrict__ g,
                        const float* __restrict__ w1t,
                        const float* __restrict__ gis,
                        const float* __restrict__ c1,
                        const float* __restrict__ w2gis,
                        uint16_t* __restrict__ dx,
                        float* __restrict__ partial, int hw, int tpi,
                        int ntiles) {
  extern __shared__ __align__(16) float smem[];
  uint16_t* s_x = reinterpret_cast<uint16_t*>(smem);  // [stage][Cin][kB2SX]
  uint16_t* s_g = s_x + kB2Stages * kCin * kB2SX;     // [stage][Cout][kB2SX]
  uint16_t* s_e = s_g + kB2Stages * kCout * kB2SX;    // [2][kB2Tile][kB2SE]
  // Per warp: g as fp32, (g0, g0, g1, g1) of each pixel pair.
  float4* s_gf = reinterpret_cast<float4*>(s_e + 2 * kB2Tile * kB2SE);
  uint4* s_aw = reinterpret_cast<uint4*>(s_gf + kBwdThreads / 32 * kB2Tile / 2);

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int gid = lane >> 2, tig = lane & 3;

  for (int s = 0; s < kB2Stages - 1; ++s) {
    const int tile = blockIdx.x + s * gridDim.x;
    if (tile < ntiles) {
      load_tile_bf16<kVec>(x, g, s_x + s * kCin * kB2SX,
                           s_g + s * kCout * kB2SX, tile, tpi, hw);
    }
    cp_async_commit();
  }

  // The lane's two middle channels ca, cb: rows gid and gid + 8 of the
  // warp's tiles. mid' = sign(gis) mid, so that the mask is mid' > thr.
  const int ca = warp * 16 + gid, cb = ca + 8;
  float sgn[2], thr[2];
#pragma unroll
  for (int ch = 0; ch < 2; ++ch) {
    const int c = ch ? cb : ca;
    sgn[ch] = gis[c] < 0.0f ? -1.0f : 1.0f;
    thr[ch] = relu_threshold(fabsf(gis[c]), c1[c]);
  }
  // A of mid'^T (m16n8k16, row; K = Cin): sign * bf16(w1t) of both rows at
  // k = 2 tig, + 1 and at k + 8, + 9.
  const float* wa = w1t + ca * kCin + 2 * tig;
  const float* wb = w1t + cb * kCin + 2 * tig;
  const uint32_t am[4] = {pack_bf16(sgn[0] * wa[0], sgn[0] * wa[1]),
                          pack_bf16(sgn[1] * wb[0], sgn[1] * wb[1]),
                          pack_bf16(sgn[0] * wa[8], sgn[0] * wa[9]),
                          pack_bf16(sgn[1] * wb[8], sgn[1] * wb[9])};
  // A of dx for k-step ks = t / 32 and lane t % 32 (rows k = gid, gid + 8;
  // K = the channels, 16 per step): bf16(w1)[k][c] = bf16(w1t[c][k]) at
  // c = 16 ks + 2 tig, + 1 and + 8, + 9.
  for (int i = t; i < kCmid / 16 * 32; i += kBwdThreads) {
    const int l = i & 31;
    const float* w = w1t + ((i >> 5) * 16 + 2 * (l & 3)) * kCin + (l >> 2);
    s_aw[i] = make_uint4(pack_bf16(w[0], w[kCin]),
                         pack_bf16(w[8], w[kCin + 8]),
                         pack_bf16(w[8 * kCin], w[9 * kCin]),
                         pack_bf16(w[8 * kCin + 8], w[9 * kCin + 8]));
  }
  const float w2_c[2][2] = {{w2gis[ca * kCout], w2gis[ca * kCout + 1]},
                            {w2gis[cb * kCout], w2gis[cb * kCout + 1]}};

  // Block sums. dw1 n-tile nt, register r: k = gid + 8 (r >> 1), channel
  // 16w + 8 nt + 2 tig + (r & 1). M0 (tensor cores), register r: channel
  // (r < 2 ? ca : cb), output 2 tig + (r & 1) (tig 0 holds Cout 2). M1'
  // per lane, [channel ca / cb][o]; db2 per lane.
  float dw[2][4] = {};
  float m0[4] = {};
  float m1[2][2] = {};
  float db[2] = {};
  float4* gf = s_gf + warp * (kB2Tile / 2);

  cp_async_wait<kB2Stages - 2>();
  __syncthreads();  // the first tile in; s_aw written
  int i = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++i) {
    {
      // The tile kB2Stages - 1 ahead, into the slot of the tile before.
      const int next = tile + (kB2Stages - 1) * gridDim.x;
      const int slot = (i + kB2Stages - 1) % kB2Stages;
      if (next < ntiles) {
        load_tile_bf16<kVec>(x, g, s_x + slot * kCin * kB2SX,
                             s_g + slot * kCout * kB2SX, next, tpi, hw);
      }
      cp_async_commit();
    }
    const uint16_t* sx = s_x + i % kB2Stages * kCin * kB2SX;
    const uint16_t* sg = s_g + i % kB2Stages * kCout * kB2SX;
    uint16_t* se = s_e + (i & 1) * kB2Tile * kB2SE;

    // g as fp32 for this warp; db2.
#pragma unroll
    for (int it = 0; it < kB2Tile / 64; ++it) {
      const int q = lane + 32 * it;
      const uint32_t g0 = load_pair(sg + 2 * q);
      const uint32_t g1 = load_pair(sg + kB2SX + 2 * q);
      const float4 v = make_float4(
          __uint_as_float(g0 << 16), __uint_as_float(g0 & 0xffff0000u),
          __uint_as_float(g1 << 16), __uint_as_float(g1 & 0xffff0000u));
      gf[q] = v;
      db[0] += v.x + v.y;
      db[1] += v.z + v.w;
    }
    __syncwarp();

    // The 16-pixel chunks, software-pipelined: chunk j + 1's operands and
    // mid' products are issued before chunk j's epilogue.
    const uint16_t* xq = sx + (lane & 15) * kB2SX + ((lane >> 4) << 3);
    BwdChunk c[2];
    bwd_bf16_load_chunk(c[0], xq, gf, sg, 0, lane, am);
#pragma unroll
    for (int j = 0; j < kB2Tile / 16; ++j) {
      if (j + 1 < kB2Tile / 16) {
        bwd_bf16_load_chunk(c[(j + 1) & 1], xq, gf, sg, 16 * (j + 1), lane,
                            am);
      }
      bwd_bf16_chunk(c[j & 1], se, 16 * j, lane, warp, thr, w2_c, dw, m0,
                     m1);
    }
    cp_async_wait<kB2Stages - 2>();
    __syncthreads();  // bf16(e) of the whole tile in; the next tile's x, g in

    float dxa[2][4];
    bwd_bf16_dx(se, s_aw, lane, warp, dxa);
    bwd_bf16_dx_store<kVec>(dx, dxa, tile, tpi, hw, lane, warp);
  }

  // Fold M1' over the 4 lanes of a group (same channels, other pixels),
  // db2 over warp 0's lanes.
#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
#pragma unroll
      for (int o = 0; o < kCout; ++o) {
        m1[ch][o] += __shfl_xor_sync(0xffffffffu, m1[ch][o], sh);
      }
    }
  }
#pragma unroll
  for (int sh = 1; sh < 32; sh <<= 1) {
    db[0] += __shfl_xor_sync(0xffffffffu, db[0], sh);
    db[1] += __shfl_xor_sync(0xffffffffu, db[1], sh);
  }

  float* row = partial + (long long)blockIdx.x * kPartial;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = gid + 8 * (r >> 1);
      const int c = warp * 16 + 8 * nt + 2 * tig + (r & 1);
      row[k * kCmid + c] = dw[nt][r];
    }
  }
  if (tig == 0) {
    float* m0row = row + kCin * kCmid;
    float* m1row = m0row + kCmid * kCout;
#pragma unroll
    for (int o = 0; o < kCout; ++o) {
      m0row[ca * kCout + o] = m0[o];
      m0row[cb * kCout + o] = m0[2 + o];
      m1row[ca * kCout + o] = sgn[0] * m1[0][o];
      m1row[cb * kCout + o] = sgn[1] * m1[1][o];
    }
  }
  if (t == 0) {
    row[kPartial - 2] = db[0];
    row[kPartial - 1] = db[1];
  }
}

// ---------------------------------------------------------------------------
// The ResNet50-flavour head: Cin = 64, Cmid a multiple of 128 (512), Cout 2.
// The same functions as K1 and K2 above; the TPU kernels run them on a
// grid of 4096-pixel programs (_TP_WIDE, bihome_tpu/ops/fused_head.py:55).
//
// Bound on the H100 at M = 2B*128*128 = 2,097,152 pixels (B = 64):
//   * forward: the Cin x Cmid product is 137.4 GFLOP; in 3xTF32 on the
//     tensor cores (3 x 137.4 at 495 TFLOP/s) 0.833 ms, against 0.165 ms of
//     bytes (x read, the output written): operations;
//   * backward: three such products (mid, dx, dw1), 2.50 ms in 3xTF32,
//     against 0.33 ms of bytes (x and g read, dx written): operations.
//
// Why the narrow kernels cannot simply be widened: at Cin 64 the forward's
// split g1t fragments alone are (Cmid/8)(Cin/8) x 32 lanes x 16 B = 262 KB
// at Cmid 512, and the narrow backward's split e tile and split w1t^T 264
// KB each, beyond the 227 KB a block may hold. So the weights are split
// once per call into wgmma operand images (pf_head_wide_prep_kernel) and
// stream through shared memory in chunks of 64 middle channels, and both
// directions run their products on wgmma (described before their kernels
// below):
//   * forward (pf_head_fwd_wgmma_kernel): pixels are the product's M
//     dimension (as in K1), two warpgroups of 64 pixels a tile, each
//     holding its split x as A fragments in registers; the epilogue of K1
//     (c1, ReLU, the Cout = 2 sums) runs on mid's accumulator in
//     registers;
//   * backward: a dx kernel with pixels as M, whose e goes from mid's
//     accumulator straight into dx's A operand (no reduction across
//     blocks), and a sums kernel with channels as M over 128-channel chunks
//     (dw1 needs no transposed e), so mid is computed twice.

constexpr int kWCin = 64;
constexpr int kWKs = kWCin / 8;       // k-steps of the Cin contraction
constexpr int kWTile = 128;           // pixels per tile: 8 warps x 16
constexpr int kWThreads = 256;
constexpr int kWSX = kWTile + 8;      // row stride of the x tile (words)
constexpr int kWSumChunk = 128;       // channels per block of the sums kernel
constexpr int kWSTile = 64;           // pixels per tile of the sums kernel
constexpr int kWMaxCmid = 1024;

// The x tile's A fragments for warp w's 16 pixels, all k-steps, split:
// register r is pixel 16w + gid + 8 (r & 1) at k = ks*8 + tig + 4 (r >> 1).
__device__ __forceinline__ void wide_a_fragments(const float* sx, int warp,
                                                 int lane,
                                                 uint32_t (&ab)[kWKs][4],
                                                 uint32_t (&as)[kWKs][4]) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kWKs; ++ks) {
    const float* p = sx + (ks * 8 + tig) * kWSX + warp * 16 + gid;
    const float a[4] = {p[0], p[8], p[4 * kWSX], p[4 * kWSX + 8]};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const Split s = split(a[r]);
      ab[ks][r] = s.big;
      as[ks][r] = s.small;
    }
  }
}

// ---------------------------------------------------------------------------
// The wide kernels on wgmma (sm_90a; PTX ISA "Asynchronous Warpgroup Level
// Matrix Multiply-Accumulate", wgmma.mma_async .m64nNk8 .tf32 and its
// matrix descriptor). Each 64 x 64 x 8 step is one
//   wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32
// of a warpgroup (4 warps, 128 threads): D [64, 64] fp32 in 32 registers a
// thread (warp w of the group rows 16w..16w+15, laid out per 8 columns as
// mma.m16n8's accumulator), A [64, 8] from 4 registers a thread (the
// mma.m16n8k8 tf32 A fragment per warp) or from shared memory, B [8, 64]
// from shared memory. tf32 operands in shared memory must be K-major: the
// transpose bits exist only for 16-bit types, and an MN-major tf32
// descriptor reads wrong numbers without a fault. So every operand in
// shared memory here is an "image" of 64 rows (M or N) by 64 K values in
// the no-swizzle canonical layout: core matrices of 8 rows x 16 bytes (4
// K values), 128 contiguous bytes each, core matrix (K quad kc, row group
// rg) at (kc * 8 + rg) * 128 bytes. The descriptor's leading byte offset
// (between K-adjacent core matrices) is then 1024 bytes, its stride byte
// offset (between row groups) 128, and k-step ks starts 2048 ks bytes in.
// tests/test_torch_cuda_kernels.py checks one such tile against
// torch.matmul with A from registers and from shared memory.
//
// 3xTF32 as above: each fp32 operand is split into big = tf32(a) and
// small = tf32(a - big) (cvt.rna, the low 13 bits zero) and each product
// takes three passes, small*big, big*small, then big*big, into one
// accumulator (a second one would spill).
//
//   * pf_head_wide_prep_kernel splits the first conv's weights (w1t for
//     the backward, the BN-folded g1t for the forward) once per call into
//     two images per 64 middle channels, written to a scratch buffer of
//     their own (img of the C entries): w1t itself (rows = channels, K =
//     Cin: B of the forward's and the dx kernel's mid, A of the sums
//     kernel's mid), and w1 = w1t^T (rows = Cin, K = channels, within each
//     8 in the order 0,2,4,6,1,3,5,7: the order in which mid's accumulator
//     hands e on as A, register r of n-block j being A register ((r & 1)
//     << 1) | (r >> 1) of k-step j). Each chunk's four images (big, small
//     of each) are one contiguous 64 KB block, and the forward and the dx
//     kernel copy each image pair with one 1-D bulk copy (cp.async.bulk,
//     completion counted on an mbarrier): no tensor map, no split per
//     tile (the forward reads the first pair only);
//   * forward (pf_head_fwd_wgmma_kernel), described before it below;
//   * dx kernel (pf_head_bwd_wide_dx_kernel): persistent blocks of two
//     warpgroups, one block per SM, walk 128-pixel tiles; warpgroup w owns
//     pixels 64w..64w+63 and holds their split x as A fragments in
//     registers. Per 64-channel chunk: mid^T [px, ch] = x^T w1t^T (48
//     wgmma m64n32k8, in two commit groups of 32 channels), the epilogue
//     (mask, e) in registers, dx^T [px, Cin] += e w1 (24 m64n64k8, e as A
//     straight from mid's accumulator). The epilogue of mid's first half
//     runs while the tensor cores do its second, that of the second while
//     they do dx over the first; and chunk c + 1's mid is issued before
//     chunk c's dx is waited for, so the tensor cores are not left idle
//     across the step's barriers. The weight images are double-buffered
//     in two streams: chunk c + 1's w1t images start as soon as chunk c -
//     1's mid is done, its w1 images once chunk c - 1's dx is (512 KB of
//     images a tile at Cmid 512, 8.6 GB a call at M = 2M, from L2);
//   * sums kernel (pf_head_bwd_wide_sums_kernel): the grid's y takes
//     128-channel chunks, warpgroup w 64 of them, with w1t's images
//     resident in shared memory as A. Each 64-pixel tile's x is split once
//     into two images: x^T (rows = pixels, K = Cin: B of mid [ch, px]) and
//     x (rows = Cin, K = pixels in the order above: B of dw1^T [ch, Cin] +=
//     e x^T, e as A from mid's accumulator). The images are
//     double-buffered: the next tile's are split while dw1's products
//     run, and the epilogue's second half (32 pixels) is formed while the
//     tensor cores do dw1 over the first. M0, M1 and db2 are summed from
//     the epilogue on the fp32 cores. Sums run in two levels, over a tile
//     (a fresh accumulator), then over the block's tiles; each block
//     writes its row of the scratch, and reduce_rows_kernel adds the rows
//     in order: deterministic, no atomics;
//   * both kernels fence shared memory written by threads or cp.async
//     (fence.proxy.async) before wgmma reads it, issue wgmma.fence before
//     products whose A registers or accumulators were just written, and
//     wait_group (with the groups still allowed in flight counted) before
//     an epilogue reads an accumulator or registers are reused;
//   * so mid is computed twice: four products, a floor of 3.33 ms in
//     3xTF32 at M = 2M (dx and sums 1.67 ms each), against the function's
//     bound of 2.50.
//
// What holds it back (H100 80GB HBM3, 700 W; python -m
// bihome_torch.profile_kernels --kernel k2w cuts each part out and times
// the rest, kernel by kernel): at x [128,64,128,128], Cmid 512 the dx
// kernel takes ~2.8 ms and the sums kernel ~3.8, against 1.67 each of
// tensor work. In both the products and the fp32 work (epilogue, splits,
// loads) add up rather than overlap: cutting the products leaves ~1.3 and
// ~1.9 ms. The two warpgroups of a block meet at every step's barriers, so
// their epilogues fall together; a warpgroup's own epilogue overlaps only
// the half of its products issued before it. Streaming the weight images
// by 16-byte cp.async cost the dx kernel ~0.7 ms more than the bulk copies
// do now (~0.2). The sums kernel's mid has both operands in shared memory
// (A from shared memory costs it as much shared-memory bandwidth as
// tensor time). Measured no faster, not kept: each dx block starting its
// walk at its own chunk (the SMs then read different L2 lines), and the
// sums grid ordered so that a tile group's four chunk blocks run together
// and share x through L2. Warp-specialised warpgroups that take turns on
// the tensor cores, and one pass for mid (ROADMAP), are the next steps.

constexpr int kWImg = 64 * 64;        // floats of one 64 x 64 operand image
constexpr int kWPrep = 4 * kWImg;     // floats of one chunk's four images
constexpr int kWSXS = kWSTile + 4;    // row stride of the sums kernel's x

// Offset in floats of element (row r, K index k) of a 64 x 64 image.
__host__ __device__ constexpr int img_at(int r, int k) {
  return (((k >> 2) * 8 + (r >> 3)) * 8 + (r & 7)) * 4 + (k & 3);
}

// K position of channel (or pixel) k in the accumulator-to-A order: within
// each 8, k-index t is 2t and t + 4 is 2t + 1.
__host__ __device__ constexpr int perm_k(int k) {
  return (k & ~7) | ((k & 1) << 2) | ((k >> 1) & 3);
}

// Descriptor of an image in shared memory (no swizzle; LBO 1024 bytes, SBO
// 128 bytes, both in 16-byte units). k-step ks: add 128 ks (2048 bytes).
__device__ __forceinline__ uint64_t img_desc(const float* img) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(img);
  return (uint64_t)((a >> 4) & 0x3FFF) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most kPending committed groups are still in flight.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Reads of an accumulator after wgmma_wait stay after it.
template <int kN>
__device__ __forceinline__ void fence_acc(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#define WG_D32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_D32_OPS(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),    \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),    \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
      "+f"(d[31])

// d = a b (scale_d 0) or d += a b: A [64, 8] from registers, B from the
// image descriptor b.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WG_D32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// The same with A from the image descriptor a.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_D32
      ", %32, %33, p, 1, 1;\n}\n"
      : WG_D32_OPS(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

#define WG_D16                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_D16_OPS(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

// The same at N = 32 (m64n32k8: 16 accumulator registers a thread).
__device__ __forceinline__ void wgmma_rs32(float (&d)[16],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " WG_D16
      ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : WG_D16_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " WG_D16
      ", %16, %17, p, 1, 1;\n}\n"
      : WG_D16_OPS(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

// Copy nfloats (a multiple of 4 * kThreads) from src to dst by 16-byte
// cp.async; both 16-byte aligned.
template <int kThreads>
__device__ __forceinline__ void copy_flat(float* dst, const float* src,
                                          int nfloats) {
  for (int i = threadIdx.x * 4; i < nfloats; i += kThreads * 4) {
    cp_async16(dst + i, src + i, 16);
  }
}

// mbarrier-tracked bulk copies (PTX ISA: mbarrier, cp.async.bulk): one
// thread starts a copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) and sets the barrier to expect them; waiters spin on the phase.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred ready;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 ready, [%1], %2;\n"
        "selp.u32 %0, 1, 0, ready;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// The weight images of channels 64 c .. 64 c + 63 at img + c * kWPrep:
// [0] w1t big, [1] w1t small (rows = channels, K = Cin), [2] w1 big, [3]
// w1 small (rows = Cin, K = channels at perm_k).
__global__ void pf_head_wide_prep_kernel(const float* __restrict__ w1t,
                                         float* __restrict__ img, int cmid) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cmid * kWCin) return;
  const int c = i / kWCin, k = i % kWCin, cl = c & 63;
  const Split s = split(w1t[i]);
  float* chunk = img + (long long)(c >> 6) * kWPrep;
  chunk[img_at(cl, k)] = __uint_as_float(s.big);
  chunk[kWImg + img_at(cl, k)] = __uint_as_float(s.small);
  chunk[2 * kWImg + img_at(k, perm_k(cl))] = __uint_as_float(s.big);
  chunk[3 * kWImg + img_at(k, perm_k(cl))] = __uint_as_float(s.small);
}

// The wide forward (K1 at Cin 64), out = w2 relu(g1t x + c1) + b2 on
// wgmma, g1t's images made by pf_head_wide_prep_kernel once per call:
//   * persistent blocks, one per SM, of two consumer warpgroups and one
//     producer warp walk 128-pixel tiles (within one image); warpgroup w
//     owns pixels 64w..64w+63 of each tile. It copies its own half of the
//     tile's x by cp.async (zero-filled past the image's end), splits it
//     once into A fragments in registers (wide_a_fragments), then starts
//     the copy of its half of its next tile, which lands while the tile's
//     products run. The warpgroups meet at no block-wide barrier after
//     the start;
//   * per 64-channel chunk, mid^T [64 px, 64 ch] = x^T g1t^T is 24 wgmma
//     m64n64k8 (3 passes x 8 k-steps, small*big, big*small, then big*big
//     into one accumulator), B from the chunk's g1t images, then the
//     epilogue of K1 on the accumulator in registers: c1, the ReLU and 2
//     FMAs per middle value into the lane's 2 pixels x 2 outputs;
//   * the warpgroups take turns (two named barriers, "ping-pong"): each
//     issues a chunk's products, hands the turn to the other, waits for
//     its own products and runs their epilogue while the tensor cores work
//     on the other's. Without the turns both warpgroups' products share
//     the tensor cores, finish together, and both epilogues leave them
//     idle together;
//   * the weight images stream through a ring of kFBufs 32 KB buffers: the
//     producer warp's lane 0 waits for a buffer's "empty" barrier (one
//     arrival per consumer warp, once its products over the buffer are
//     done) and starts the bulk copy of the next chunk into it, counted on
//     the buffer's "full" barrier;
//   * at a tile's end the lane quad folds its sums (3 shuffles), adds b2
//     and stores.
// Bound at x [128,64,128,128], Cmid 512: 3 x 137.4 GFLOP in 3xTF32 at 495
// TFLOP/s, 0.833 ms (operations; bytes 0.165 ms). The images come from L2
// (256 KB a tile at Cmid 512, 4.3 GB a call).
//
// What holds it back (H100 80GB HBM3, 700 W; python -m
// bihome_torch.profile_kernels --kernel k1w cuts each part out and times
// the rest): the epilogue's fp32 work slows the products rather than
// hiding under them (run twice, it adds as much again), so the kernel
// takes about the products' time plus the epilogue's. The weight stream
// costs little. With a second accumulator in flight across the chunk loop
// (chunk c + 1 issued before chunk c's epilogue) ptxas serialised every
// wgmma (C7514: a wait after each), so each chunk's products are waited
// for whole.
constexpr int kFBufs = 4;                     // buffers of the weight ring
constexpr int kFThreads = kWThreads + 32;     // + the producer warp
constexpr uint32_t kFChunkBytes = 2 * kWImg * sizeof(float);  // 32 KB
constexpr int kFTurn = 3;  // named barriers 3, 4: warpgroup 0's, 1's turn

// mid^T of one chunk for the warpgroup's 64 pixels into d (register 4j + r:
// pixel 16 warp + gid + 8 (r >> 1), channel 8j + 2 tig + (r & 1) of the
// chunk), B from the chunk's g1t images at w (big, then small).
__device__ __forceinline__ void fwd_wide_products(
    float (&d)[32], const uint32_t (&ab)[kWKs][4],
    const uint32_t (&as)[kWKs][4], const float* w) {
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
    for (int ks = 0; ks < kWKs; ++ks) {
      const uint32_t(&a)[4] = pass == 0 ? as[ks] : ab[ks];
      wgmma_rs(d, a, img_desc(w + (pass == 1 ? kWImg : 0)) + 128 * ks,
               pass != 0 || ks != 0);
    }
  }
}

// K1's epilogue over one chunk's mid^T: acc[px][o] += w2[o][ch] relu(mid +
// c1[ch]) over the lane's 16 channels; p holds (c1, w2[0], w2[1], 0) of the
// chunk's 64 channels.
__device__ __forceinline__ void fwd_wide_epilogue(const float (&m)[32],
                                                  const float4* p, int tig,
                                                  float (&acc)[2][2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 q[2] = {p[8 * j + 2 * tig], p[8 * j + 2 * tig + 1]};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 v = q[r & 1];
      const float a = fmaxf(m[4 * j + r] + v.x, 0.0f);
      acc[r >> 1][0] = fmaf(v.y, a, acc[r >> 1][0]);
      acc[r >> 1][1] = fmaf(v.z, a, acc[r >> 1][1]);
    }
  }
}

// Named barriers (bar.sync / bar.arrive id, threads): wait until
// ``threads`` threads have arrived at barrier id, or arrive without waiting.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Start warpgroup wg's copies of its 64 pixels of a tile's x into the
// tile's x buffer sx [Cin][kWSX] (columns 64 wg ..), by its 128 threads.
template <bool kVec>
__device__ __forceinline__ void load_wide_fwd_half(const float* x, float* sx,
                                                   int tile, int tpi, int hw,
                                                   int wg, int t) {
  const int n = tile / tpi;
  const int s0 = (tile - n * tpi) * kWTile + 64 * wg;
  copy_rows_by<kWCin, 64, kWSX, 128, kVec>(
      t & 127, sx + 64 * wg, x + (long long)n * kWCin * hw, x, s0, hw);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// out [N,2,HW] over persistent 128-pixel tiles (see above); wimg: g1t's
// images [Cmid/64][4][64*64].
template <bool kVec>
__global__ void __launch_bounds__(kFThreads, 1)
pf_head_fwd_wgmma_kernel(const float* __restrict__ x,
                         const float* __restrict__ wimg,
                         const float* __restrict__ c1,
                         const float* __restrict__ w2,
                         const float* __restrict__ b2, float* __restrict__ out,
                         int hw, int tpi, int ntiles, int cmid) {
  extern __shared__ __align__(128) float smem[];
  float* s_w = smem;                                  // [kFBufs][2 * kWImg]
  float* s_x = s_w + kFBufs * 2 * kWImg;              // [Cin][kWSX]
  float4* s_p = reinterpret_cast<float4*>(s_x + kWCin * kWSX);  // [cmid]
  uint64_t* s_full = reinterpret_cast<uint64_t*>(s_p + cmid);   // [kFBufs]
  uint64_t* s_empty = s_full + kFBufs;                          // [kFBufs]

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, wg = warp >> 2;
  const int nch = cmid / 64;
  // The block's weight steps, one per tile and chunk.
  const int steps = ((ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * nch;

  if (wg < 2) load_wide_fwd_half<kVec>(x, s_x, blockIdx.x, tpi, hw, wg, t);
  for (int c = t; c < cmid; c += kFThreads) {
    s_p[c] = make_float4(c1[c], w2[c], w2[cmid + c], 0.0f);
  }
  if (t == 0) {
    for (int b = 0; b < kFBufs; ++b) {
      mbar_init(s_full + b);
      mbar_init(s_empty + b, 8);  // the 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers initialised, c1 and w2 in

  if (wg == 2) {  // the producer warp: no block-wide barrier after this
    if (lane == 0) {
      for (int s = 0; s < steps; ++s) {
        const int b = s % kFBufs;
        if (s >= kFBufs) mbar_wait(s_empty + b, ((s / kFBufs) + 1) & 1);
        bulk_load(s_w + b * 2 * kWImg, wimg + (long long)(s % nch) * kWPrep,
                  kFChunkBytes, s_full + b);
      }
    }
    return;
  }

  const int gid = lane >> 2, tig = lane & 3;
  uint32_t ab[kWKs][4], as[kWKs][4];  // x^T's A fragments, split
  float mid[32];
  int s = 0;
  if (wg == 1) named_arrive(kFTurn, 256);  // warpgroup 0 issues first
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    // The warpgroup's half of the tile in, split into A fragments; then
    // the copy of its half of the next tile into the same columns.
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    named_sync(1 + wg, 128);
    wide_a_fragments(s_x, warp, lane, ab, as);
    named_sync(1 + wg, 128);
    if (tile + (int)gridDim.x < ntiles) {
      load_wide_fwd_half<kVec>(x, s_x, tile + gridDim.x, tpi, hw, wg, t);
    }

    // Per chunk: this warpgroup's turn, its products issued, the other's
    // turn, then the wait and the epilogue, which run while the tensor
    // cores work on the other warpgroup's products.
    float acc[2][2] = {};  // [pixel gid + 8 px][o], over the lane's channels
    for (int c = 0; c < nch; ++c, ++s) {
      mbar_wait(s_full + s % kFBufs, (s / kFBufs) & 1);
      named_sync(kFTurn + wg, 256);
      wgmma_fence();
      fwd_wide_products(mid, ab, as, s_w + (s % kFBufs) * 2 * kWImg);
      wgmma_commit();
      named_arrive(kFTurn + (wg ^ 1), 256);
      wgmma_wait<0>();
      fence_acc(mid);
      // The warp is done with step s's buffer.
      __syncwarp();
      if (lane == 0) mbar_arrive(s_empty + s % kFBufs);
      fwd_wide_epilogue(mid, s_p + 64 * c, tig, acc);
    }

    // Fold over the lane quad: lane tig keeps pixel gid + 8 (tig >> 1),
    // output tig & 1.
    const int px = tig >> 1, o = tig & 1;
    float keep[2];
#pragma unroll
    for (int oo = 0; oo < 2; ++oo) {
      const float mine = px ? acc[1][oo] : acc[0][oo];
      const float other = px ? acc[0][oo] : acc[1][oo];
      keep[oo] = mine + __shfl_xor_sync(0xffffffffu, other, 2);
    }
    const float mine = o ? keep[1] : keep[0];
    const float other = o ? keep[0] : keep[1];
    const float v = mine + __shfl_xor_sync(0xffffffffu, other, 1);
    const int n = tile / tpi;
    const int sp = (tile - n * tpi) * kWTile + warp * 16 + gid + 8 * px;
    if (sp < hw) out[((long long)n * kCout + o) * hw + sp] = v + b2[o];
  }
  if (wg == 0) named_sync(kFTurn, 256);  // warpgroup 1's last turn
}

// Start the copies of a 128-pixel tile's x [Cin][128] (row stride kWSX)
// and g [Cout][128].
template <bool kVec>
__device__ __forceinline__ void load_wide_dx_tile(const float* x,
                                                  const float* g, float* sx,
                                                  float* sg, int tile, int tpi,
                                                  int hw) {
  const int n = tile / tpi;
  const int s0 = (tile - n * tpi) * kWTile;
  copy_rows<kWCin, kWTile, kWSX, kWThreads, kVec>(
      sx, x + (long long)n * kWCin * hw, x, s0, hw);
  copy_rows<kCout, kWTile, kWTile, kWThreads, kVec>(
      sg, g + (long long)n * kCout * hw, g, s0, hw);
}

// dx [N,64,HW] over persistent 128-pixel tiles (see above).
template <bool kVec>
__global__ void __launch_bounds__(kWThreads, 1)
pf_head_bwd_wide_dx_kernel(const float* __restrict__ x,
                           const float* __restrict__ g,
                           const float* __restrict__ wimg,
                           const float* __restrict__ gis,
                           const float* __restrict__ c1,
                           const float* __restrict__ w2gis,
                           float* __restrict__ dx, int hw, int tpi,
                           int ntiles, int cmid) {
  extern __shared__ __align__(128) float smem[];
  // [2 buffers][kWPrep]: a chunk's w1t and w1 images, by bulk copies.
  float* s_w = smem;
  float* s_x = s_w + 2 * kWPrep;                     // [Cin][kWSX]
  float* s_g = s_x + kWCin * kWSX;                   // [Cout][kWTile]
  float4* s_p = reinterpret_cast<float4*>(s_g + kCout * kWTile);  // [cmid]
  // Barriers of the bulk copies into buffer b: w1t images, w1 images.
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(s_p + cmid);  // [2][2]

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int nch = cmid / 64;
  constexpr uint32_t kHalfBytes = 2 * kWImg * sizeof(float);  // 32 KB

  int tile = blockIdx.x;
  load_wide_dx_tile<kVec>(x, g, s_x, s_g, tile, tpi, hw);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (t == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(s_bar + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    bulk_load(s_w, wimg, kHalfBytes, s_bar);
    bulk_load(s_w + 2 * kWImg, wimg + 2 * kWImg, kHalfBytes, s_bar + 1);
  }
  for (int c = t; c < cmid; c += kWThreads) {
    s_p[c] = make_float4(gis[c], c1[c], w2gis[2 * c], w2gis[2 * c + 1]);
  }
  __syncthreads();  // the barriers initialised

  uint32_t ab[kWKs][4], as[kWKs][4];  // x^T's A fragments, split
  float gv[2][2];                     // [pixel gid + 8 px][o]
  // dx^T: register 4j + r is pixel 16 warp + gid + 8 (r >> 1), k = 8j +
  // 2 tig + (r & 1).
  float dxa[32];
  int step = 0;
  for (; tile < ntiles; tile += gridDim.x) {
    const int next = tile + gridDim.x;
    for (int c = 0; c < nch; ++c, ++step) {
      const bool more = c + 1 < nch || next < ntiles;  // a step after this
      const long long cn = (long long)((c + 1) % nch) * kWPrep;
      float* w_now = s_w + (step & 1) * 4 * kWImg;
      float* w_next = s_w + ((step + 1) & 1) * 4 * kWImg;
      // Chunk c's w1t images (copied during the step before) and, at c ==
      // 0, the tile's x are in; mid of chunk c - 1 is done in both
      // warpgroups, so its w1t buffer takes chunk c + 1's.
      mbar_wait(s_bar + 2 * (step & 1), (step >> 1) & 1);
      if (c == 0) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      if (c == 0) {
        wide_a_fragments(s_x, warp, lane, ab, as);
#pragma unroll
        for (int px = 0; px < 2; ++px) {
          gv[px][0] = s_g[warp * 16 + gid + 8 * px];
          gv[px][1] = s_g[kWTile + warp * 16 + gid + 8 * px];
        }
      }
      if (more && t == 0) {
        bulk_load(w_next, wimg + cn, kHalfBytes, s_bar + 2 * ((step + 1) & 1));
      }

      // mid^T [px, ch] in two halves of 32 channels, each its own commit
      // group, so that the epilogue of one half and dx's products over it
      // run while the tensor cores work on the next: register 4j + r of
      // half h is pixel gid + 8 (r >> 1), channel 64c + 32h + 8j + 2 tig +
      // (r & 1). (B of half h: the w1t image from row 32h, 512 h bytes in.)
      float mid[2][16];
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
          for (int ks = 0; ks < kWKs; ++ks) {
            const uint32_t(&a)[4] = pass == 0 ? as[ks] : ab[ks];
            wgmma_rs32(mid[h], a,
                       img_desc(w_now + (pass == 1 ? kWImg : 0) + 128 * h) +
                           128 * ks,
                       pass != 0 || ks != 0);
          }
        }
        wgmma_commit();
      }

      // dx's products of chunk c - 1, the two groups before mid's, done in
      // both warpgroups (its e registers and w1 buffer free), and chunk c's
      // w1 images in for all threads: then chunk c + 1's w1 and, at c == 0,
      // the next tile's x (every warp has read this tile's) start.
      wgmma_wait<2>();
      mbar_wait(s_bar + 2 * (step & 1) + 1, (step >> 1) & 1);
      __syncthreads();
      if (more && t == 0) {
        bulk_load(w_next + 2 * kWImg, wimg + cn + 2 * kWImg, kHalfBytes,
                  s_bar + 2 * ((step + 1) & 1) + 1);
      }
      if (c == 0 && next < ntiles) {
        load_wide_dx_tile<kVec>(x, g, s_x, s_g, next, tpi, hw);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      }

      uint32_t eb[8][4], es[8][4];  // A of dx^T, k-step j: channels 8j..
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        wgmma_wait<1>();  // mid's half h in (h = 1: dx's first half behind)
        fence_acc(mid[h]);
#pragma unroll
        for (int j = 4 * h; j < 4 * h + 4; ++j) {
          const int ch = c * 64 + 8 * j + 2 * tig;
          const float4 pc[2] = {s_p[ch], s_p[ch + 1]};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float4 q = pc[r & 1];
            const int px = r >> 1;
            const float a = fmaf(q.x, mid[h][4 * (j - 4 * h) + r], q.y);
            const float eun = fmaf(q.z, gv[px][0], q.w * gv[px][1]);
            const Split e = split(a > 0.0f ? eun : 0.0f);
            const int slot = ((r & 1) << 1) | (r >> 1);
            eb[j][slot] = e.big;
            es[j][slot] = e.small;
          }
        }
        wgmma_fence();
#pragma unroll
        for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
          for (int j = 4 * h; j < 4 * h + 4; ++j) {
            const uint32_t(&a)[4] = pass == 0 ? es[j] : eb[j];
            wgmma_rs(dxa, a,
                     img_desc(w_now + (pass == 1 ? 3 : 2) * kWImg) + 128 * j,
                     c != 0 || pass != 0 || j != 0);
          }
        }
        wgmma_commit();
      }
    }
    wgmma_wait<0>();
    fence_acc(dxa);

    const int n = tile / tpi;
    const int s0 = (tile - n * tpi) * kWTile + warp * 16 + gid;
    float* dn = dx + (long long)n * kWCin * hw;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int s = s0 + 8 * (r >> 1);
        const int k = 8 * j + 2 * tig + (r & 1);
        if (s < hw) dn[(long long)k * hw + s] = dxa[4 * j + r];
      }
    }
  }
}

// Start the copies of a 64-pixel tile's x [Cin][64] (row stride kWSXS)
// and g [Cout][64].
template <bool kVec>
__device__ __forceinline__ void load_wide_sums_tile(const float* x,
                                                    const float* g, float* sx,
                                                    float* sg, long long tile,
                                                    int tpi, int hw) {
  const long long n = tile / tpi;
  const int s0 = (int)(tile - n * tpi) * kWSTile;
  copy_rows<kWCin, kWSTile, kWSXS, kWThreads, kVec>(
      sx, x + n * kWCin * hw, x, s0, hw);
  copy_rows<kCout, kWSTile, kWSTile, kWThreads, kVec>(
      sg, g + n * kCout * hw, g, s0, hw);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Split a 64-pixel tile's raw x [Cin][kWSXS] into its four images at img:
// x^T big, small (rows = pixels, K = Cin), then x big, small (rows = Cin, K
// = pixels at perm_k); copy its g [Cout][64] to sg. By all kWThreads.
__device__ __forceinline__ void split_sums_tile(const float* s_x,
                                                const float* s_graw,
                                                float* img, float* sg) {
  const int t = threadIdx.x;
  // x^T: thread (pixel p, Cin k..k+3) stores one 16-byte row piece.
#pragma unroll
  for (int it = 0; it < kWCin * kWSTile / (4 * kWThreads); ++it) {
    const int idx = t + it * kWThreads;
    const int p = idx & 63, k = (idx >> 6) * 4;
    Split sp[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) sp[i] = split(s_x[(k + i) * kWSXS + p]);
    *reinterpret_cast<uint4*>(img + img_at(p, k)) =
        make_uint4(sp[0].big, sp[1].big, sp[2].big, sp[3].big);
    *reinterpret_cast<uint4*>(img + kWImg + img_at(p, k)) =
        make_uint4(sp[0].small, sp[1].small, sp[2].small, sp[3].small);
  }
  // x: thread (Cin k, pixels 8j..8j+7) stores K quads 2j and 2j + 1.
#pragma unroll
  for (int it = 0; it < kWCin * kWSTile / (8 * kWThreads); ++it) {
    const int idx = t + it * kWThreads;
    const int k = (idx & 7) | ((idx >> 6) << 3), j = (idx >> 3) & 7;
    const float4 lo =
        *reinterpret_cast<const float4*>(s_x + k * kWSXS + 8 * j);
    const float4 hi =
        *reinterpret_cast<const float4*>(s_x + k * kWSXS + 8 * j + 4);
    const Split v[8] = {split(lo.x), split(lo.y), split(lo.z), split(lo.w),
                        split(hi.x), split(hi.y), split(hi.z), split(hi.w)};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* dst = img + 2 * kWImg + img_at(k, 8 * j + 4 * h);
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(v[h].big, v[h + 2].big, v[h + 4].big, v[h + 6].big);
      *reinterpret_cast<uint4*>(dst + kWImg) = make_uint4(
          v[h].small, v[h + 2].small, v[h + 4].small, v[h + 6].small);
    }
  }
  if (t < kCout * kWSTile) sg[t] = s_graw[t];
}

// dw1, M0, M1 and db2 of middle channels 128 blockIdx.y .. + 127 over the
// 64-pixel tiles blockIdx.x, + gridDim.x, ... Block (b, chunk) writes its
// sums into row b of partial [gridDim.x][cols] (cols = Cin*Cmid + 4*Cmid +
// 2): its chunk's columns of dw1 [Cin][Cmid], M0 and M1 [Cmid][2]; db2 from
// the blocks of chunk 0.
template <bool kVec>
__global__ void __launch_bounds__(kWThreads, 1)
pf_head_bwd_wide_sums_kernel(const float* __restrict__ x,
                             const float* __restrict__ g,
                             const float* __restrict__ wimg,
                             const float* __restrict__ gis,
                             const float* __restrict__ c1,
                             const float* __restrict__ w2gis,
                             float* __restrict__ partial, int hw, int tpi,
                             long long ntiles, int cmid) {
  extern __shared__ __align__(128) float smem[];
  float* s_a = smem;                    // [warpgroup][big, small] w1t images
  // [2 buffers][x^T big, x^T small, x big, x small] images of a tile.
  float* s_img = s_a + 4 * kWImg;
  float* s_x = s_img + 8 * kWImg;       // [Cin][kWSXS] raw, cp.async
  float* s_graw = s_x + kWCin * kWSXS;  // [Cout][64] raw, cp.async
  float* s_g = s_graw + kCout * kWSTile;  // [2 buffers][Cout][64]

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wg = t >> 7;
  // The thread's two channels: rows gid and gid + 8 of its warp's 16.
  const int ca = blockIdx.y * 128 + wg * 64 + (warp & 3) * 16 + gid;
  const int cb = ca + 8;

  long long tile = blockIdx.x;
  if (tile >= ntiles) return;  // (the grid has at most one block per tile)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    copy_flat<kWThreads>(s_a + h * 2 * kWImg,
                         wimg + (long long)(2 * blockIdx.y + h) * kWPrep,
                         2 * kWImg);
  }
  load_wide_sums_tile<kVec>(x, g, s_x, s_graw, tile, tpi, hw);
  const float gis_c[2] = {gis[ca], gis[cb]};
  const float c1_c[2] = {c1[ca], c1[cb]};
  const float w2_c[2][2] = {{w2gis[ca * kCout], w2gis[ca * kCout + 1]},
                            {w2gis[cb * kCout], w2gis[cb * kCout + 1]}};
  const float* a_big = s_a + wg * 2 * kWImg;

  // The first tile's images, then the raw copy of the second.
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  split_sums_tile(s_x, s_graw, s_img, s_g);
  fence_async_smem();
  __syncthreads();
  if (tile + gridDim.x < ntiles) {
    load_wide_sums_tile<kVec>(x, g, s_x, s_graw, tile + gridDim.x, tpi, hw);
  }

  // dw1^T [ch, Cin]: register 4j + r is channel (r < 2 ? ca : cb), k = 8j +
  // 2 tig + (r & 1). Two levels: over a tile (tdw), then the block's tiles.
  float dw[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dw[i] = 0.0f;
  float m0[2][2] = {}, m1[2][2] = {};  // [channel ca / cb][o]
  float db[2] = {};

  for (int buf = 0; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    const float* xt = s_img + buf * 4 * kWImg;  // x^T big, small
    const float* xp = xt + 2 * kWImg;           // x big, small
    const float* sg = s_g + buf * kCout * kWSTile;

    // mid [ch, px]: register 4j + r is channel (r < 2 ? ca : cb), pixel 8j +
    // 2 tig + (r & 1).
    float mid[32];
    wgmma_fence();
#pragma unroll
    for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
      for (int ks = 0; ks < kWKs; ++ks) {
        wgmma_ss(mid, img_desc(a_big + (pass == 0 ? kWImg : 0)) + 128 * ks,
                 img_desc(xt + (pass == 1 ? kWImg : 0)) + 128 * ks,
                 pass != 0 || ks != 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(mid);

    // The epilogue in two halves of 32 pixels: dw1's products over the
    // first run while the second is formed.
    uint32_t eb[8][4], es[8][4];  // A of dw1^T, k-step j: pixels 8j..
    float tm0[2][2] = {}, tm1[2][2] = {}, tdb[2] = {};
    float tdw[32];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 4 * h; j < 4 * h + 4; ++j) {
        const float2 g0 = *reinterpret_cast<const float2*>(sg + 8 * j + 2 * tig);
        const float2 g1 =
            *reinterpret_cast<const float2*>(sg + kWSTile + 8 * j + 2 * tig);
        const float gp[2][2] = {{g0.x, g1.x}, {g0.y, g1.y}};  // [pixel][o]
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int ch = r >> 1, px = r & 1;
          const float m = mid[4 * j + r];
          const float a = fmaf(gis_c[ch], m, c1_c[ch]);
          const float mk = a > 0.0f ? 1.0f : 0.0f;
          const float eun =
              fmaf(w2_c[ch][0], gp[px][0], w2_c[ch][1] * gp[px][1]);
          const Split e = split(mk * eun);
          const int slot = ((r & 1) << 1) | (r >> 1);
          eb[j][slot] = e.big;
          es[j][slot] = e.small;
          const float mm = mk * m;
#pragma unroll
          for (int o = 0; o < kCout; ++o) {
            tm0[ch][o] = fmaf(mk, gp[px][o], tm0[ch][o]);
            tm1[ch][o] = fmaf(mm, gp[px][o], tm1[ch][o]);
          }
        }
        tdb[0] += g0.x + g0.y;
        tdb[1] += g1.x + g1.y;
      }
      wgmma_fence();
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
        for (int j = 4 * h; j < 4 * h + 4; ++j) {
          const uint32_t(&a)[4] = pass == 0 ? es[j] : eb[j];
          wgmma_rs(tdw, a, img_desc(xp + (pass == 1 ? kWImg : 0)) + 128 * j,
                   pass != 0 || j != 0);
        }
      }
      wgmma_commit();
    }

    // While dw1's products run: the next tile's images into the other
    // buffer (its last readers, the tile before's products, are done).
    const long long next = tile + gridDim.x;
    if (next < ntiles) {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();  // the next tile's raw x and g in for all threads
      split_sums_tile(s_x, s_graw, s_img + (buf ^ 1) * 4 * kWImg,
                      s_g + (buf ^ 1) * kCout * kWSTile);
      fence_async_smem();
    }
    wgmma_wait<0>();
    fence_acc(tdw);
#pragma unroll
    for (int i = 0; i < 32; ++i) dw[i] += tdw[i];
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
#pragma unroll
      for (int o = 0; o < kCout; ++o) {
        m0[ch][o] += tm0[ch][o];
        m1[ch][o] += tm1[ch][o];
      }
    }
    db[0] += tdb[0];
    db[1] += tdb[1];
    __syncthreads();  // the next images complete; this tile's products done
    if (next + gridDim.x < ntiles) {
      load_wide_sums_tile<kVec>(x, g, s_x, s_graw, next + gridDim.x, tpi, hw);
    }
  }

  // Fold M0, M1 and db2 over the 4 lanes that share rows (other pixels).
#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
#pragma unroll
      for (int o = 0; o < kCout; ++o) {
        m0[ch][o] += __shfl_xor_sync(0xffffffffu, m0[ch][o], sh);
        m1[ch][o] += __shfl_xor_sync(0xffffffffu, m1[ch][o], sh);
      }
    }
    db[0] += __shfl_xor_sync(0xffffffffu, db[0], sh);
    db[1] += __shfl_xor_sync(0xffffffffu, db[1], sh);
  }

  const long long cols = (long long)kWCin * cmid + 4LL * cmid + kCout;
  float* row = partial + (long long)blockIdx.x * cols;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = 8 * j + 2 * tig + (r & 1);
      row[(long long)k * cmid + (r < 2 ? ca : cb)] = dw[4 * j + r];
    }
  }
  if (tig == 0) {
    float* m0row = row + (long long)kWCin * cmid;
    float* m1row = m0row + 2 * cmid;
#pragma unroll
    for (int o = 0; o < kCout; ++o) {
      m0row[ca * kCout + o] = m0[0][o];
      m0row[cb * kCout + o] = m0[1][o];
      m1row[ca * kCout + o] = m1[0][o];
      m1row[cb * kCout + o] = m1[1][o];
    }
  }
  if (blockIdx.y == 0 && t == 0) {
    row[cols - 2] = db[0];
    row[cols - 1] = db[1];
  }
}

// One 64 x 64 x 64 product d = a b^T on wgmma, for the card tests: a
// [64][64] (M x K), b [64][64] (N x K), d [64][64], TF32 values, one
// warpgroup. mode & 1: A from shared memory (wgmma_ss*), else from
// registers (wgmma_rs*); mode & 2: as two m64n32k8 halves of N (B from
// image row 32h), else one m64n64k8.
__global__ void __launch_bounds__(128, 1)
wgmma_tile_test_kernel(const float* __restrict__ a,
                       const float* __restrict__ b, float* __restrict__ d,
                       int mode) {
  __shared__ __align__(128) float s_a[kWImg];
  __shared__ __align__(128) float s_b[kWImg];
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  for (int i = t; i < kWImg; i += 128) {
    s_a[img_at(i / 64, i % 64)] = a[i];
    s_b[img_at(i / 64, i % 64)] = b[i];
  }
  fence_async_smem();
  __syncthreads();
  uint32_t af[kWKs][4];
#pragma unroll
  for (int ks = 0; ks < kWKs; ++ks) {
    const float* p = a + (warp * 16 + gid) * 64 + ks * 8 + tig;
    af[ks][0] = __float_as_uint(p[0]);
    af[ks][1] = __float_as_uint(p[8 * 64]);
    af[ks][2] = __float_as_uint(p[4]);
    af[ks][3] = __float_as_uint(p[8 * 64 + 4]);
  }
  float acc[32];
  float half[2][16];
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kWKs; ++ks) {
    const uint64_t da = img_desc(s_a) + 128 * ks;
    switch (mode) {
      case 0: wgmma_rs(acc, af[ks], img_desc(s_b) + 128 * ks, ks != 0); break;
      case 1: wgmma_ss(acc, da, img_desc(s_b) + 128 * ks, ks != 0); break;
      case 2:
        wgmma_rs32(half[0], af[ks], img_desc(s_b) + 128 * ks, ks != 0);
        wgmma_rs32(half[1], af[ks], img_desc(s_b + 128) + 128 * ks, ks != 0);
        break;
      default:
        wgmma_ss32(half[0], da, img_desc(s_b) + 128 * ks, ks != 0);
        wgmma_ss32(half[1], da, img_desc(s_b + 128) + 128 * ks, ks != 0);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  fence_acc(half[0]);
  fence_acc(half[1]);
  if (mode & 2) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = half[i / 16][i % 16];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      d[(warp * 16 + gid + 8 * (r >> 1)) * 64 + 8 * j + 2 * tig + (r & 1)] =
          acc[4 * j + r];
    }
  }
}

constexpr size_t fwd_wgmma_smem_bytes(int cmid) {
  return sizeof(float) * (kFBufs * 2 * kWImg + kWCin * kWSX) +
         sizeof(float4) * (size_t)cmid + 2 * kFBufs * sizeof(uint64_t);
}

constexpr size_t bwd_wide_dx_smem_bytes(int cmid) {
  return sizeof(float) * (2 * kWPrep + kWCin * kWSX + kCout * kWTile) +
         sizeof(float4) * (size_t)cmid + 4 * sizeof(uint64_t);
}

constexpr size_t kWSumsSmemBytes =
    sizeof(float) * (12 * kWImg + kWCin * kWSXS + 3 * kCout * kWSTile);


// ---------------------------------------------------------------------------
// The ResNet50-flavour head at bfloat16 (Cin 64, Cmid a multiple of 128 up
// to 512, Cout 2): K1 and K2 on bf16 x, as the TPU kernels run when the
// PF head hands the wide head bf16 x (bihome_tpu/models/backbones.py:66-73,
// the grid of _TP_WIDE = 4096-pixel programs). The rounding points are the
// narrow bf16 kernels' (above):
//   * K1: out = bf16(b2 + bf16(w2)^T bf16(relu(bf16(g1t) x + c1)));
//   * K2: mid = bf16(w1t) x, the mask and e in fp32, dx = bf16(bf16(w1)
//     bf16(e)), dw1 = x bf16(e)^T, M0, M1 and db2 summed in fp32 (the
//     rank-Cin corrections outside, as for every K2).
//
// Bounds on the H100 at the R50 zeng training shape (x [128,64,128,128],
// M = 2,097,152 pixels, Cmid 512; the smoke recomputes them from its
// inputs), at 989 TFLOP/s of bf16 tensor work, 67 TFLOP/s on the fp32
// cores and 3.35 TB/s:
//   * K1: the Cin x Cmid product is 137.4 GFLOP (0.139 ms), the epilogue
//     (ReLU, rounding, the Cout = 2 sums) 5 flops per middle value (5.4
//     GFLOP, 0.080 ms), the bytes 268 MB of x and 8.4 MB out (0.083 ms):
//     operations, ~0.139 ms;
//   * K2: three such products (mid, dx, dw1), 412 GFLOP (0.417 ms), the
//     fp32 work 2 + 4 Cout = 10 flops per middle value with the threshold
//     mask (0.160 ms), the bytes x, g and dx, 545 MB (0.163 ms):
//     operations, ~0.42 ms. The design below computes mid twice (a floor
//     of ~0.56 ms of tensor work).
//
// Design: every product on wgmma bf16 (m64nNk16; a product of two bf16
// values is exact in fp32, so only the order of the fp32 sums differs from
// the Pallas kernels). Each 16-bit operand in shared memory is a "tile" of
// 64-column rows, 128 bytes each, in the 128-byte swizzle (tile_at: the
// 16-byte piece p of row r at p ^ (r % 8)), which every 8 rows read or
// written at one column piece spreads over all banks. wgmma reads such a
// tile K-major (rows = M or N, columns = K) or, through its transpose
// bit, MN-major (rows = K, columns = M or N), so one copy serves both
// ways:
//   * the x tile [Cin][64 px], as it lies in device memory, is B of mid
//     [ch, px] (MN-major) and B of dw1^T [ch, Cin] (K-major), and by
//     ldmatrix.trans the register A of mid^T [px, ch];
//   * a chunk of bf16(w1t) [64 ch][Cin] is B of mid^T (K-major) and B of
//     dx^T [px, Cin] (MN-major: K = channels), and by ldmatrix the
//     register A of mid;
//   * g [Cout (8 rows, 2 used)][64 px] is B of M0 [ch, 8] (K-major).
// An accumulator [64, 64] is, per 16 columns, the register A operand of
// the next product's k16 step (as in FlashAttention-3's P V), so e and
// relu(a) go from mid's accumulator to the next product in registers; x^T
// (K1, dx) and bf16(w1t') (sums) are A from registers too (ldmatrix), so
// each product reads only its B operand from shared memory (an m64n64k16
// with both operands there needs all of the SM's 128 bytes a cycle).
// Warpgroups walk 64-pixel tiles (within one image; past its end
// zero-filled, computed and not stored) through rings of stages, the
// block's weights resident in shared memory. Where HW % 8 == 0 (and x, g,
// dx are 16-byte aligned) one thread starts each stage's copies on the
// tensor memory accelerator (2-D tensor maps of x and g, which write the
// tiles in their swizzle and zero-fill past the image's end), counted on
// the stage's mbarrier; else the warpgroup copies them with plain loads.
// The mask is the narrow K2 bf16's (relu_threshold above): mid' =
// sign(gis) mid against a per-channel threshold, w1t's rows negated
// where gis < 0 and w2gis' = sign(gis) w2gis, so e' = sign(gis) e
// (exact), dx = sum w1t' e' needs no sign, and dw1 and M1 take theirs at
// the end.
//   * K1 (pf_head_fwd_wide_bf16_kernel): blocks of three warpgroups, one
//     per SM, each warpgroup on its own tiles and ring (no barrier between
//     them after the start). Per pair of 64-channel chunks: mid^T [64 px,
//     64 ch] = x^T g1t^T of both (4 m64n64k16 each), then per chunk and 16
//     channels c1 added and bf16(relu) formed by cvt.rn.relu.bf16x2
//     straight into the A operand of out^T [64 px, 8] += relu bf16(w2)^T
//     (m64n8k16, w2 padded to 8 rows), issued at once, so the second
//     chunk's mid and the out^T products run under the epilogue; b2 added
//     at the store;
//   * K2 in two kernels, as the float32 wide K2: dw1 wants channels as M
//     (its e as A from mid's accumulator, K = pixels) and dx pixels as M
//     (K = channels), and one pass holding dw1 for all Cmid 512 channels
//     in registers (64 x 512 fp32, 128 KB: half the register file) beside
//     two warpgroups' mid and dx accumulators (32 KB each) would leave
//     ~64 registers a thread for the operands, addresses and the epilogue
//     even with setmaxnreg at 240/240/24, with no room to keep two chunks
//     in flight. So mid is computed twice:
//       - dx (pf_head_bwd_wide_bf16_dx_kernel): blocks of three
//         warpgroups, one per SM, on their own tiles and rings, all of
//         bf16(w1t') resident (64 KB at Cmid 512). Per chunk: mid'^T (4
//         m64n64k16), then per 16 channels the mask and e' packed into the
//         A operand of dx^T [64 px, Cin] += bf16(e') bf16(w1t') (one
//         m64n64k16, B MN-major), issued at once; the next chunk's mid
//         goes out behind the last of them. dx goes by stmatrix.trans into
//         the x tile it came from and out by 16-byte stores;
//       - sums (pf_head_bwd_wide_bf16_sums_kernel): blocks of two
//         warpgroups, one per SM, 128 channels each (their bf16(w1t')
//         tiles resident; the grid's y takes 256-channel groups), on one
//         ring of 128-pixel tiles (two 64-pixel sub-tiles, one loaded by
//         each warpgroup; g staged once as fp32 per pixel pair, db2 summed
//         there). Per sub-tile and 64-channel half (a unit): mid [64 ch, 64
//         px] (4 m64n64k16, B = x MN-major), the epilogue (the mask, e',
//         M1' on the fp32 cores), and dw1'^T [64 ch, Cin] += bf16(e') x^T
//         (4 m64n64k16) and M0 [64 ch, 8] += mask g^T (4 m64n8k16; the
//         mask is exact bf16 0/1). The warpgroups take turns (named
//         barriers): in its turn one issues the dw1 and M0 products of its
//         unit before and the mid of the next, then runs that epilogue
//         while the other's products run. Each block writes one row of
//         sums, added in block order by reduce_rows_kernel
//         (deterministic, no atomics).
//
// What holds them back (H100 80GB HBM3, 700 W; python -m
// bihome_torch.profile_kernels --kernel k1wb|k2wb cuts each part out and
// times the rest): the products and the fp32 work add up rather than
// overlap, as they did on mma.sync, whatever the schedule: more
// warpgroups a block, chunks in flight two at a time, products issued
// per 16 channels under the epilogue, turns between warpgroups each moved
// the times by a few percent. At x [128,64,128,128], Cmid 512: K1 ~0.29
// ms, ~0.12 without products, ~0.26 without its epilogue; the dx kernel
// ~0.62 (~0.21 without products, ~0.39 without the epilogue: the products
// alone at ~70% of the tensor cores' rate); the sums kernel ~0.78 (~0.35
// without products; M1's fp32 sums ~0.07, M0's products ~0.04).

constexpr int kWBMaxCmid = 512;
constexpr int kWBTile = 64;                    // pixels per warpgroup tile
constexpr int kWBTileBytes = kWCin * kWBTile * 2;  // an x tile: 8 KB
constexpr int kWBChunkBytes = 64 * kWCin * 2;  // a 64-channel weight tile
constexpr int kK1WG = 3;        // warpgroups of a K1 block
constexpr int kDxWG = 3;        // of a dx block
constexpr int kWBStages = 3;    // K1 and dx: tiles in a warpgroup's ring
constexpr int kSumsSub = 2;     // sums: 64-pixel sub-tiles of a tile
constexpr int kSumsAhead = 2;   // sums: tiles loaded ahead
constexpr int kWBSStages = kSumsAhead + 2;  // its ring
// A ring stage of K1 and dx: the x tile, then a g tile (8 rows of 64
// pixels, 1 KB); of the sums kernel: kSumsSub of those, then g as fp32
// per pixel pair (512 bytes a sub-tile, 1 KB aligned).
constexpr int kWBStage = kWBTileBytes + 1024;
constexpr int kWBSStage =
    kSumsSub * kWBStage + (kSumsSub * 512 + 1023) / 1024 * 1024;

// Byte offset of element (r, c) of a bf16 tile of 64-column rows (128
// bytes a row, the tile 1024-byte aligned) in the 128-byte swizzle: the
// 16-byte piece c / 8 of row r at piece (c / 8) ^ (r % 8).
__host__ __device__ constexpr int tile_at(int r, int c) {
  return (r << 7) + ((((c >> 3) ^ r) & 7) << 4) + ((c & 7) << 1);
}

// wgmma descriptor of a tile (layout type 1: the 128-byte swizzle; 8-row
// groups 1024 bytes apart (SBO); LBO unused: each operand's K extent
// (K-major use: rows = M or N, columns = K) or M/N extent (MN-major use:
// rows = K, columns = M or N) lies within a row). A K-major k16 step is
// 32 bytes along the rows (add kKStep to the descriptor), an MN-major one
// two row groups (add kMNStep).
__device__ __forceinline__ uint64_t tile_desc(const void* p) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
constexpr int kKStep = 2;
constexpr int kMNStep = 128;

// The dynamic shared memory from its first 1024-byte boundary (the tiles'
// alignment; the launches ask for 1 KB more).
__device__ __forceinline__ uint8_t* smem_1k(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// d = a b (scale_d 0) or d += a b on bf16 wgmma, [64, 64] x k16: A and B
// from tile descriptors, kTA / kTB 1 where that operand is MN-major.
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[32], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : WG_D32_OPS(d)
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTA), "n"(kTB));
}

// The same with A from registers (per warp the mma.m16n8k16 A fragment of
// its 16 rows).
template <int kTB>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : WG_D32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
        "n"(kTB));
}

// [64, 8] x k16 (m64n8k16), A from registers, B K-major.
__device__ __forceinline__ void wgmma_bf16_rs_n8(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// k-step ks of the A operand (K = the 64 columns of an accumulator d
// [64, 64]): columns 16 ks .. 16 ks + 15 are its column groups 2 ks and 2
// ks + 1, each two rows of pairs. slot(j, h): register of group j's row
// half h (gid, gid + 8) in k-step j / 2.
__device__ __forceinline__ int a_slot(int j, int h) {
  return ((j & 1) << 1) | h;
}

// Pixels s0..s0+63 of rows 0..kRows-1 of one image's bf16 [kRows][hw]
// block src into the tile dst (tile_at); pixels past hw are 0. By a
// warpgroup's 128 threads (t), with plain loads and stores: the path of
// an HW that is not a multiple of 8 (or a misaligned x, g or dx), which
// the tensor maps below cannot describe.
template <int kRows>
__device__ __forceinline__ void load_tile64(uint8_t* dst, const uint16_t* src,
                                            int s0, int hw, int t) {
  for (int i = t; i < kRows * 64; i += 128) {
    const int r = i >> 6, c = i & 63;
    *reinterpret_cast<uint16_t*>(dst + tile_at(r, c)) =
        s0 + c < hw ? src[(long long)r * hw + s0 + c] : (uint16_t)0;
  }
}

// The A operand of mid^T [px, ch] (K = Cin) for the warp's 16 pixels of
// an x tile (rows Cin, columns px), all four k-steps, by ldmatrix.trans:
// k-step ks, matrices (Cin 16 ks.., px 16 warp..), (Cin 16 ks.., px + 8),
// (Cin 16 ks + 8.., px), (Cin 16 ks + 8.., px + 8).
__device__ __forceinline__ void x_fragments(const uint8_t* tile, int warp,
                                            int lane, uint32_t (&a)[4][4]) {
  const int m = lane >> 3;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    ldsm_x4_trans(a[ks], tile + tile_at(16 * ks + 8 * (m >> 1) + (lane & 7),
                                        16 * warp + 8 * (m & 1)));
  }
}

// The tensor maps of x as [N * 64 rows][HW] and g as [N * 2 rows][HW]
// (bf16): boxes of 64 pixels by all 64 (x) or 2 (g) rows, which the tensor
// memory accelerator writes in the 128-byte swizzle of tile_at, pixels
// past HW as 0 (bf16_tile_map).
struct WideMaps {
  CUtensorMap x, g;
};

// The barrier expects ``bytes`` more (and counts one arrival).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// The box at (pixel c0, row c1) of a tensor map into dst, counted on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// The x (and g) tile of tile ``tile`` (64 pixels of one image) into a ring
// stage. kVec: by the tensor memory accelerator, started by thread t == 0
// and counted on bar (wait_stage); else by the warpgroup's 128 threads,
// done on return.
template <bool kVec, bool kG>
__device__ __forceinline__ void load_wide_bf16_stage(
    uint8_t* st, const WideMaps& maps, uint64_t* bar, const uint16_t* x,
    const uint16_t* g, int tile, int tpi, int hw, int t) {
  const int n = tile / tpi;
  const int s0 = (tile - n * tpi) * kWBTile;
  if (kVec) {
    if (t == 0) {
      mbar_expect_tx(bar, kWBTileBytes + (kG ? kCout * 128 : 0));
      tma_load_2d(st, &maps.x, s0, n * kWCin, bar);
      if (kG) tma_load_2d(st + kWBTileBytes, &maps.g, s0, n * kCout, bar);
    }
  } else {
    load_tile64<kWCin>(st, x + (long long)n * kWCin * hw, s0, hw, t);
    if (kG) {
      load_tile64<kCout>(st + kWBTileBytes, g + (long long)n * kCout * hw, s0,
                         hw, t);
    }
  }
}

// Wait until the i-th tile of a ring of kStages stages has landed (kVec: on
// its stage's barrier; the plain loads are done when they return).
template <bool kVec, int kStages>
__device__ __forceinline__ void wait_stage(uint64_t* bars, int i) {
  if (kVec) mbar_wait(bars + i % kStages, (i / kStages) & 1);
}

// The x and g sub-tiles of sums tile ``tile`` (64 kSumsSub pixels of one
// image; tpi such tiles an image) into a ring stage. kVec: all by the
// tensor memory accelerator, started by the block's thread 0 and counted
// on bar; else sub-tile q by warpgroup q's 128 threads (t).
template <bool kVec>
__device__ __forceinline__ void load_sums_stage(uint8_t* st,
                                                const WideMaps& maps,
                                                uint64_t* bar,
                                                const uint16_t* x,
                                                const uint16_t* g, int tile,
                                                int tpi, int hw, int q,
                                                int t) {
  const int n = tile / tpi;
  const int s0 = (tile - n * tpi) * kWBTile * kSumsSub;
  if (kVec) {
    if (q == 0 && t == 0) {
      mbar_expect_tx(bar, kSumsSub * (kWBTileBytes + kCout * 128));
#pragma unroll
      for (int k = 0; k < kSumsSub; ++k) {
        tma_load_2d(st + k * kWBStage, &maps.x, s0 + kWBTile * k, n * kWCin,
                    bar);
        tma_load_2d(st + k * kWBStage + kWBTileBytes, &maps.g,
                    s0 + kWBTile * k, n * kCout, bar);
      }
    }
  } else {
    load_tile64<kWCin>(st + q * kWBStage, x + (long long)n * kWCin * hw,
                       s0 + kWBTile * q, hw, t);
    load_tile64<kCout>(st + q * kWBStage + kWBTileBytes,
                       g + (long long)n * kCout * hw, s0 + kWBTile * q, hw, t);
  }
}

// bf16(sign * w[c][k]) of rows c0..c0+rows-1 of a float32 [*][64] matrix
// into 64-channel tiles at dst (row c - c0 of tile (c - c0) / 64), by
// ``threads`` threads; sign -1 where neg[c] < 0 (neg null: no signs).
__device__ __forceinline__ void pack_weight_tiles(uint8_t* dst,
                                                  const float* __restrict__ w,
                                                  const float* neg, int c0,
                                                  int rows, int threads) {
  for (int i = threadIdx.x; i < rows * kWCin; i += threads) {
    const int c = i >> 6, k = i & 63;
    const float v = w[(long long)(c0 + c) * kWCin + k];
    const float s = neg != nullptr && neg[c0 + c] < 0.0f ? -v : v;
    *reinterpret_cast<uint16_t*>(dst + (c >> 6) * kWBChunkBytes +
                                 tile_at(c & 63, k)) = (uint16_t)bf16_bits(s);
  }
}

// K1's shared memory: bf16(g1t) tiles, bf16(w2) tiles [8][64] per chunk
// (rows 2..7 zero), each warpgroup's ring of x tiles, c1, and each ring's
// barriers.
constexpr size_t fwd_wide_bf16_smem_bytes(int cmid) {
  return 1024 + (size_t)(cmid / 64) * (kWBChunkBytes + 1024) +
         (size_t)kK1WG * kWBStages * (kWBTileBytes + sizeof(uint64_t)) +
         sizeof(float) * (size_t)cmid;
}

template <bool kVec>
__global__ void __launch_bounds__(kK1WG * 128, 1)
pf_head_fwd_wide_bf16_kernel(const __grid_constant__ WideMaps maps,
                             const uint16_t* __restrict__ x,
                             const float* __restrict__ g1t,
                             const float* __restrict__ c1,
                             const float* __restrict__ w2,
                             const float* __restrict__ b2,
                             uint16_t* __restrict__ out, int hw, int tpi,
                             int ntiles, int cmid) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const int nch = cmid / 64;
  uint8_t* s_w = smem_1k(smem_raw);                  // [nch] g1t tiles
  uint8_t* s_w2 = s_w + nch * kWBChunkBytes;         // [nch][8][64]
  uint8_t* s_ring = s_w2 + nch * 1024;
  float* s_c1 = reinterpret_cast<float*>(s_ring + kK1WG * kWBStages *
                                                      kWBTileBytes);
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(s_c1 + cmid);

  const int t = threadIdx.x;
  const int wg = t >> 7, tw = t & 127;
  const int lane = t & 31, warp = (t >> 5) & 3;
  const int gid = lane >> 2, tig = lane & 3;
  const int stride = gridDim.x * kK1WG;
  uint8_t* ring = s_ring + wg * kWBStages * kWBTileBytes;
  uint64_t* bars = s_bar + wg * kWBStages;

  int tile = blockIdx.x * kK1WG + wg;
  if (kVec && tw == 0) {
    for (int s = 0; s < kWBStages; ++s) mbar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int s = 0; s < kWBStages - 1; ++s) {
    const int tl = tile + s * stride;
    if (tl < ntiles) {
      load_wide_bf16_stage<kVec, false>(ring + s * kWBTileBytes, maps,
                                        bars + s, x, nullptr, tl, tpi, hw, tw);
    }
  }
  pack_weight_tiles(s_w, g1t, nullptr, 0, cmid, kK1WG * 128);
  for (int i = t; i < cmid * 8; i += kK1WG * 128) {
    const int c = i >> 3, o = i & 7;
    *reinterpret_cast<uint16_t*>(s_w2 + (c >> 6) * 1024 + tile_at(o, c & 63)) =
        o < kCout ? (uint16_t)bf16_bits(w2[o * cmid + c]) : (uint16_t)0;
  }
  for (int c = t; c < cmid; c += kK1WG * 128) s_c1[c] = c1[c];
  const float b2_0 = b2[0], b2_1 = b2[1];
  fence_async_smem();
  __syncthreads();  // the weights in; no block-wide barrier after this

  int i = 0;
  for (; tile < ntiles; tile += stride, ++i) {
    wait_stage<kVec, kWBStages>(bars, i);
    fence_async_smem();
    named_sync(1 + wg, 128);  // this tile's x in; the tile before done
    {
      const int next = tile + (kWBStages - 1) * stride;
      if (next < ntiles) {
        load_wide_bf16_stage<kVec, false>(
            ring + (i + kWBStages - 1) % kWBStages * kWBTileBytes, maps,
            bars + (i + kWBStages - 1) % kWBStages, x, nullptr, next, tpi,
            hw, tw);
      }
    }
    uint32_t xa[4][4];
    x_fragments(ring + i % kWBStages * kWBTileBytes, warp, lane, xa);

    // mid[h]: mid^T of chunk c + h (register 4j + r: pixel 16 warp + gid +
    // 8 (r >> 1), channel 64 (c + h) + 8j + 2 tig + (r & 1)); ra[h]: its
    // bf16(relu(mid + c1)) as the A operand of out^T, per k-step; acc:
    // out^T (register r: pixel gid + 8 (r >> 1), output 2 tig + (r & 1)).
    float mid[2][32];
    uint32_t ra[2][4][4];
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int c = 0; c < nch; c += 2) {
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint64_t wb = tile_desc(s_w + (c + h) * kWBChunkBytes);
#pragma unroll
        for (int ks = 0; ks < kWCin / 16; ++ks) {
          wgmma_bf16_rs<0>(mid[h], xa[ks], wb + kKStep * ks, ks != 0);
        }
        wgmma_commit();
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // mid of chunk c + h in (and every product before it). Each 16
        // channels' out^T product is issued as soon as its operand is
        // formed.
        wgmma_wait<1>();
        fence_acc(mid[h]);
        const uint64_t wo = tile_desc(s_w2 + (c + h) * 1024);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
          for (int j = 2 * ks; j < 2 * ks + 2; ++j) {
            const float2 cc = *reinterpret_cast<const float2*>(
                s_c1 + 64 * (c + h) + 8 * j + 2 * tig);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              ra[h][ks][a_slot(j, hh)] =
                  cvt_relu_bf16x2(mid[h][4 * j + 2 * hh] + cc.x,
                                  mid[h][4 * j + 2 * hh + 1] + cc.y);
            }
          }
          wgmma_fence();
          wgmma_bf16_rs_n8(acc, ra[h][ks], wo + kKStep * ks, 1);
        }
        wgmma_commit();
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (tig == 0) {
      const int n = tile / tpi;
      const int s = (tile - n * tpi) * kWBTile + 16 * warp + gid;
      uint16_t* o0 = out + (long long)n * kCout * hw;
      uint16_t* o1 = o0 + hw;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (s + 8 * h < hw) {
          o0[s + 8 * h] = (uint16_t)bf16_bits(acc[2 * h] + b2_0);
          o1[s + 8 * h] = (uint16_t)bf16_bits(acc[2 * h + 1] + b2_1);
        }
      }
    }
  }
}

// The dx kernel's shared memory: bf16(w1t') tiles, (thr, w2gis'[0],
// w2gis'[1], 0) per channel, each warpgroup's ring of x and g tiles.
constexpr size_t bwd_wide_bf16_dx_smem_bytes(int cmid) {
  return 1024 + (size_t)(cmid / 64) * kWBChunkBytes +
         sizeof(float4) * (size_t)cmid +
         (size_t)kDxWG * kWBStages * (kWBStage + sizeof(uint64_t));
}

// The sign of gis[c] (the mask's orientation; +1 at 0) and w2gis' of it.
__device__ __forceinline__ float4 mask_params(const float* gis,
                                              const float* c1,
                                              const float* w2gis, int c) {
  const float s = gis[c] < 0.0f ? -1.0f : 1.0f;
  return make_float4(relu_threshold(fabsf(gis[c]), c1[c]),
                     s * w2gis[c * kCout], s * w2gis[c * kCout + 1], s);
}

template <bool kVec>
__global__ void __launch_bounds__(kDxWG * 128, 1)
pf_head_bwd_wide_bf16_dx_kernel(const __grid_constant__ WideMaps maps,
                                const uint16_t* __restrict__ x,
                                const uint16_t* __restrict__ g,
                                const float* __restrict__ w1t,
                                const float* __restrict__ gis,
                                const float* __restrict__ c1,
                                const float* __restrict__ w2gis,
                                uint16_t* __restrict__ dx, int hw, int tpi,
                                int ntiles, int cmid) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const int nch = cmid / 64;
  uint8_t* s_w = smem_1k(smem_raw);                  // [nch] w1t' tiles
  float4* s_p = reinterpret_cast<float4*>(s_w + nch * kWBChunkBytes);
  uint8_t* s_ring = reinterpret_cast<uint8_t*>(s_p + cmid);
  uint64_t* s_bar =
      reinterpret_cast<uint64_t*>(s_ring + kDxWG * kWBStages * kWBStage);

  const int t = threadIdx.x;
  const int wg = t >> 7, tw = t & 127;
  const int lane = t & 31, warp = (t >> 5) & 3;
  const int gid = lane >> 2, tig = lane & 3;
  const int stride = gridDim.x * kDxWG;
  uint8_t* ring = s_ring + wg * kWBStages * kWBStage;
  uint64_t* bars = s_bar + wg * kWBStages;

  int tile = blockIdx.x * kDxWG + wg;
  if (kVec && tw == 0) {
    for (int s = 0; s < kWBStages; ++s) mbar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int s = 0; s < kWBStages - 1; ++s) {
    const int tl = tile + s * stride;
    if (tl < ntiles) {
      load_wide_bf16_stage<kVec, true>(ring + s * kWBStage, maps, bars + s, x,
                                       g, tl, tpi, hw, tw);
    }
  }
  pack_weight_tiles(s_w, w1t, gis, 0, cmid, kDxWG * 128);
  for (int c = t; c < cmid; c += kDxWG * 128) {
    s_p[c] = mask_params(gis, c1, w2gis, c);
  }
  fence_async_smem();
  __syncthreads();  // the weights in; no block-wide barrier after this

  int i = 0;
  for (; tile < ntiles; tile += stride, ++i) {
    wait_stage<kVec, kWBStages>(bars, i);
    fence_async_smem();
    named_sync(1 + wg, 128);  // this tile in; the tile before stored
    {
      const int next = tile + (kWBStages - 1) * stride;
      if (next < ntiles) {
        load_wide_bf16_stage<kVec, true>(
            ring + (i + kWBStages - 1) % kWBStages * kWBStage, maps,
            bars + (i + kWBStages - 1) % kWBStages, x, g, next, tpi, hw, tw);
      }
    }
    uint8_t* st = ring + i % kWBStages * kWBStage;
    uint32_t xa[4][4];
    x_fragments(st, warp, lane, xa);
    // g at the lane's pixels 16 warp + gid + 8 h: gv[h][o].
    float gv[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 0; o < kCout; ++o) {
        gv[h][o] = bf16_value(*reinterpret_cast<const uint16_t*>(
            st + kWBTileBytes + tile_at(o, 16 * warp + gid + 8 * h)));
      }
    }

    // mid: mid'^T of chunk c (register 4j + r: pixel 16 warp + gid + 8 (r
    // >> 1), channel 64 c + 8j + 2 tig + (r & 1)); ea: its bf16(e') as the
    // A operand of dx^T, per k-step; dxa: dx^T (register 4j + r: that
    // pixel, Cin index 8j + 2 tig + (r & 1)). Chunk c + 1's mid is issued
    // behind chunk c's dx products.
    float mid[32];
    uint32_t ea[4][4];
    float dxa[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wgmma_bf16_rs<0>(mid, xa[ks], tile_desc(s_w) + kKStep * ks, ks != 0);
    }
    wgmma_commit();
    for (int c = 0; c < nch; ++c) {
      // mid' of chunk c in, and every product before it. Each 16 channels'
      // dx products are issued as soon as their e' is formed, and run
      // while the epilogue forms the next 16 channels'.
      wgmma_wait<0>();
      fence_acc(mid);
      const uint64_t wd = tile_desc(s_w + c * kWBChunkBytes);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
        for (int j = 2 * ks; j < 2 * ks + 2; ++j) {
          const float4* q = s_p + 64 * c + 8 * j + 2 * tig;
          const float4 p[2] = {q[0], q[1]};
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float e[2];
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const float on = set_gt(mid[4 * j + 2 * hh + cc], p[cc].x);
              e[cc] = on * fmaf(p[cc].y, gv[hh][0], p[cc].z * gv[hh][1]);
            }
            ea[ks][a_slot(j, hh)] = cvt_bf16x2(e[0], e[1]);
          }
        }
        wgmma_fence();
        wgmma_bf16_rs<1>(dxa, ea[ks], wd + kMNStep * ks, c != 0 || ks != 0);
      }
      if (c + 1 < nch) {
        const uint64_t wb = tile_desc(s_w + (c + 1) * kWBChunkBytes);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          wgmma_bf16_rs<0>(mid, xa[ks], wb + kKStep * ks, ks != 0);
        }
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_acc(dxa);
    named_sync(1 + wg, 128);  // every product of the tile done: x free

    // dx^T by stmatrix.trans into the x tile ([Cin][px], tile_at): per
    // call Cin groups j, j + 1 at pixels 16 warp + 0..7 and + 8..15; lane l
    // gives row l & 7 of matrix l >> 3.
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const uint32_t r[4] = {cvt_bf16x2(dxa[4 * j], dxa[4 * j + 1]),
                             cvt_bf16x2(dxa[4 * j + 2], dxa[4 * j + 3]),
                             cvt_bf16x2(dxa[4 * j + 4], dxa[4 * j + 5]),
                             cvt_bf16x2(dxa[4 * j + 6], dxa[4 * j + 7])};
      const int m = lane >> 3;
      stsm_x4_trans(st + tile_at(8 * (j + (m >> 1)) + (lane & 7),
                                 16 * warp + 8 * (m & 1)),
                    r);
    }
    named_sync(1 + wg, 128);
    {
      const int n = tile / tpi;
      const int s0 = (tile - n * tpi) * kWBTile;
      uint16_t* dn = dx + (long long)n * kWCin * hw;
      if (kVec) {
#pragma unroll
        for (int k = tw; k < kWCin * 8; k += 128) {
          const int r = k >> 3, b = k & 7;
          if (s0 + 8 * b < hw) {
            *reinterpret_cast<uint4*>(dn + (long long)r * hw + s0 + 8 * b) =
                *reinterpret_cast<const uint4*>(st + tile_at(r, 8 * b));
          }
        }
      } else {
        for (int k = tw; k < kWCin * 64; k += 128) {
          const int r = k >> 6, p = k & 63;
          if (s0 + p < hw) {
            dn[(long long)r * hw + s0 + p] =
                *reinterpret_cast<const uint16_t*>(st + tile_at(r, p));
          }
        }
      }
    }
  }
}

// The sums kernel's blocks: kSumsWG warpgroups of 128 channels each, on
// one ring of x and g tiles, taking turns at the tensor cores (named
// barriers kSumsTurn + w: warpgroup w's turn).
constexpr int kSumsWG = 2;
constexpr int kSumsTurn = 1;
static_assert(kSumsWG == kSumsSub, "each warpgroup loads one sub-tile");

constexpr size_t kWBSumsSmemBytes =
    1024 + 2 * kSumsWG * kWBChunkBytes +
    (size_t)kWBSStages * (kWBSStage + sizeof(uint64_t));

// The sums kernel's epilogue over pixels 16 ks .. 16 ks + 15 of mid' [64
// ch, 64 px] of one half (register 4j + r: channel 16 warp + gid + 8 (r >>
// 1) of the half, pixel 8j + 2 tig + (r & 1)): the mask, e' and M1'
// (fp32), and bf16(e') and the mask as k-step ks of the A operands (K =
// pixels) of dw1'^T and M0.
__device__ __forceinline__ void sums_epilogue(const float (&mid)[32],
                                              const float4* gf, int tig,
                                              const float4 (&p)[2], int ks,
                                              float (&m1)[2][2],
                                              uint32_t (&ea)[4][4],
                                              uint32_t (&ma)[4][4]) {
#pragma unroll
  for (int j = 2 * ks; j < 2 * ks + 2; ++j) {
    // (g0, g1) of pixels 8j + 2 tig and + 1.
    const float4 gq = gf[4 * j + tig];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float e[2], on[2];
#pragma unroll
      for (int px = 0; px < 2; ++px) {
        const float v = mid[4 * j + 2 * hh + px];
        const float g0 = px ? gq.z : gq.x, g1 = px ? gq.w : gq.y;
        on[px] = set_gt(v, p[hh].x);
        e[px] = on[px] * fmaf(p[hh].y, g0, p[hh].z * g1);
        const float mm = on[px] * v;
        m1[hh][0] = fmaf(mm, g0, m1[hh][0]);
        m1[hh][1] = fmaf(mm, g1, m1[hh][1]);
      }
      ea[j >> 1][a_slot(j, hh)] = cvt_bf16x2(e[0], e[1]);
      ma[j >> 1][a_slot(j, hh)] = mask_pair(on[0], on[1]);
    }
  }
}

// dw1'^T and M0 of half h over one 64-pixel sub-tile (x and g tiles at
// xg), A from the epilogue's registers.
__device__ __forceinline__ void sums_products(float (&dw)[32], float (&m0)[4],
                                              const uint32_t (&ea)[4][4],
                                              const uint32_t (&ma)[4][4],
                                              const uint8_t* xg) {
  const uint64_t xd = tile_desc(xg), gd = tile_desc(xg + kWBTileBytes);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    wgmma_bf16_rs<0>(dw, ea[ks], xd + kKStep * ks, 1);
    wgmma_bf16_rs_n8(m0, ma[ks], gd + kKStep * ks, 1);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kSumsWG * 128, 1)
pf_head_bwd_wide_bf16_sums_kernel(const __grid_constant__ WideMaps maps,
                                  const uint16_t* __restrict__ x,
                                  const uint16_t* __restrict__ g,
                                  const float* __restrict__ w1t,
                                  const float* __restrict__ gis,
                                  const float* __restrict__ c1,
                                  const float* __restrict__ w2gis,
                                  float* __restrict__ partial, int hw,
                                  int tpi, int ntiles, int cmid) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* s_w = smem_1k(smem_raw);  // [kSumsWG][2] w1t' tiles
  uint8_t* s_ring = s_w + 2 * kSumsWG * kWBChunkBytes;
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(s_ring + kWBSStages *
                                                             kWBSStage);

  const int t = threadIdx.x;
  const int wg = t >> 7, tw = t & 127;
  const int lane = t & 31, warp = (t >> 5) & 3;
  const int gid = lane >> 2, tig = lane & 3;
  // The block's row of sums (its tiles: row, row + rows, ...); its
  // channels from cb, warpgroup wg's cw..cw+127. A warpgroup past Cmid
  // (Cmid an odd multiple of 128) computes on zero weights and stores
  // nothing: no branch around its products, which ptxas would serialise.
  const int row = blockIdx.x, rows = gridDim.x;
  const int cb = blockIdx.y * 128 * kSumsWG;
  const int cw = cb + 128 * wg;
  const bool active = cw < cmid;

  // Rows 2..7 of each g tile stay 0 (B of M0 has 8 rows); the first
  // sub-tile (x and g) starts at 0 (the first turn's products, and the
  // last ones of a block without tiles, read it with zero A operands).
  for (int i = t; i < kWBSStages * kSumsSub * 48; i += kSumsWG * 128) {
    const int s = i / 48, r = 2 + (i % 48) / 8, b = i % 8;
    *reinterpret_cast<uint4*>(s_ring + s / kSumsSub * kWBSStage +
                              s % kSumsSub * kWBStage + kWBTileBytes +
                              tile_at(r, 8 * b)) = make_uint4(0, 0, 0, 0);
  }
  for (int i = t; i < kWBStage / 16; i += kSumsWG * 128) {
    reinterpret_cast<uint4*>(s_ring)[i] = make_uint4(0, 0, 0, 0);
  }
  if (kVec && t == 0) {
    for (int s = 0; s < kWBSStages; ++s) mbar_init(s_bar + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_async_smem();
  __syncthreads();  // before the loads write the same bytes
  int tile = row;
  for (int s = 0; s < kSumsAhead; ++s) {
    const int tl = tile + s * rows;
    if (tl < ntiles) {
      load_sums_stage<kVec>(s_ring + s * kWBSStage, maps, s_bar + s, x, g, tl,
                            tpi, hw, wg, tw);
    }
  }
  pack_weight_tiles(s_w, w1t, gis, cb, min(128 * kSumsWG, cmid - cb),
                    kSumsWG * 128);
  if (!active) {
    for (int i = tw; i < 2 * kWBChunkBytes / 16; i += 128) {
      reinterpret_cast<uint4*>(s_w + 2 * wg * kWBChunkBytes)[i] =
          make_uint4(0, 0, 0, 0);
    }
  }
  // The lane's channels: half h, row half hh: cw + 64 h + 16 warp + gid +
  // 8 hh; (thr, w2gis'[0], w2gis'[1], sign) of each.
  float4 p[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      p[h][hh] = active ? mask_params(gis, c1, w2gis,
                                      cw + 64 * h + 16 * warp + gid + 8 * hh)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  fence_async_smem();
  __syncthreads();

  // Block sums: dw[h] dw1'^T of half h (register 4j + r: channel row gid +
  // 8 (r >> 1), Cin index 8j + 2 tig + (r & 1)); m0[h] M0 (register r:
  // that channel, output 2 tig + (r & 1): tig 0 holds Cout 2); m1[h][hh][o]
  // M1' per lane; db per thread of warp 0.
  float dw[2][32];
  float m0[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int r = 0; r < 32; ++r) dw[h][r] = 0.0f;
#pragma unroll
    for (int r = 0; r < 4; ++r) m0[h][r] = 0.0f;
  }
  float m1[2][2][2] = {};
  float db[2] = {0.0f, 0.0f};
  // A of mid [ch, px] (K = Cin): bf16(w1t') of the warp's 16 channels of
  // half h, all k-steps, by ldmatrix: matrices (ch 16 warp.., Cin 16 ks..),
  // (ch + 8, Cin), (ch, Cin 16 ks + 8..), (ch + 8, Cin + 8).
  uint32_t aw[2][4][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int m = lane >> 3;
      ldsm_x4(aw[h][ks], s_w + (2 * wg + h) * kWBChunkBytes +
                             tile_at(16 * warp + 8 * (m & 1) + (lane & 7),
                                     16 * ks + 8 * (m >> 1)));
    }
  }
  float mid[32];
  // The epilogue's A operands of dw1 and M0; 0 until the first epilogue,
  // so that the first tile's first turn adds nothing.
  uint32_t ea[4][4] = {}, ma[4][4] = {};
  // The sub-tile (x, g) of the last unit, whose dw1 and M0 are still to
  // issue.
  const uint8_t* pend = s_ring;
  if (wg == 1) named_arrive(kSumsTurn, 128 * kSumsWG);  // warpgroup 0 first
  int i = 0;
  for (; tile < ntiles; tile += rows, ++i) {
    wait_stage<kVec, kWBSStages>(s_bar, i);
    fence_async_smem();
    __syncthreads();  // this tile in; every product of the tile 2 back done
    {
      // Into the slot of the tile two back.
      const int next = tile + kSumsAhead * rows;
      if (next < ntiles) {
        load_sums_stage<kVec>(
            s_ring + (i + kSumsAhead) % kWBSStages * kWBSStage, maps,
            s_bar + (i + kSumsAhead) % kWBSStages, x, g, next, tpi, hw, wg,
            tw);
      }
    }
    uint8_t* st = s_ring + i % kWBSStages * kWBSStage;
    float4* gf = reinterpret_cast<float4*>(st + kSumsSub * kWBStage);
    if (t < 32) {
      // g as fp32, (g0, g1) of pixels 2t and 2t + 1 of each sub-tile; db2.
#pragma unroll
      for (int q = 0; q < kSumsSub; ++q) {
        const uint8_t* gt = st + q * kWBStage + kWBTileBytes;
        const uint32_t g0 = load_pair(
            reinterpret_cast<const uint16_t*>(gt + tile_at(0, 2 * t)));
        const uint32_t g1 = load_pair(
            reinterpret_cast<const uint16_t*>(gt + tile_at(1, 2 * t)));
        const float4 v = make_float4(
            __uint_as_float(g0 << 16), __uint_as_float(g1 << 16),
            __uint_as_float(g0 & 0xffff0000u),
            __uint_as_float(g1 & 0xffff0000u));
        gf[32 * q + t] = v;
        db[0] += v.x + v.z;
        db[1] += v.y + v.w;
      }
    }
    __syncthreads();  // gf written

    // Units (sub-tile q, half h): in this warpgroup's turn, the dw1 and M0
    // products of the unit before and the mid' of this one; then, while
    // the other warpgroup's products run, its epilogue. Each 16 pixels'
    // operands of dw1 and M0 go out with the next unit's products.
#pragma unroll
    for (int u = 0; u < 2 * kSumsSub; ++u) {
      const int q = u >> 1, h = u & 1;
      named_sync(kSumsTurn + wg, 128 * kSumsWG);
      wgmma_fence();
      if (u > 0) {
        sums_products(dw[h ^ 1], m0[h ^ 1], ea, ma,
                      st + ((u - 1) >> 1) * kWBStage);
      } else {
        sums_products(dw[1], m0[1], ea, ma, pend);
      }
      const uint64_t xd = tile_desc(st + q * kWBStage);
#pragma unroll
      for (int ks = 0; ks < kWCin / 16; ++ks) {
        wgmma_bf16_rs<1>(mid, aw[h][ks], xd + kMNStep * ks, ks != 0);
      }
      wgmma_commit();
      named_arrive(kSumsTurn + (wg ^ 1), 128 * kSumsWG);
      wgmma_wait<0>();
      fence_acc(mid);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        sums_epilogue(mid, gf + 32 * q, tig, p[h], ks, m1[h], ea, ma);
      }
    }
    pend = st + (kSumsSub - 1) * kWBStage;
  }
  wgmma_fence();
  sums_products(dw[1], m0[1], ea, ma, pend);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(dw[0]);
  fence_acc(dw[1]);
  fence_acc(m0[0]);
  fence_acc(m0[1]);
  if (wg == 0) named_sync(kSumsTurn, 128 * kSumsWG);  // warpgroup 1's last

  // Fold M1' over the 4 lanes of a group (same channels, other pixels),
  // db2 over warp 0.
#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int o = 0; o < kCout; ++o) {
          m1[h][hh][o] += __shfl_xor_sync(0xffffffffu, m1[h][hh][o], sh);
        }
      }
    }
  }
#pragma unroll
  for (int sh = 1; sh < 32; sh <<= 1) {
    db[0] += __shfl_xor_sync(0xffffffffu, db[0], sh);
    db[1] += __shfl_xor_sync(0xffffffffu, db[1], sh);
  }

  const long long cols = (long long)kWCin * cmid + 4LL * cmid + kCout;
  float* prow = partial + (long long)row * cols;
  float* m0row = prow + (long long)kWCin * cmid;
  float* m1row = m0row + 2 * cmid;
  if (active) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int c = cw + 64 * h + 16 * warp + gid + 8 * hh;
        const float s = p[h][hh].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int k = 8 * j + 2 * tig + cc;
            prow[(long long)k * cmid + c] = s * dw[h][4 * j + 2 * hh + cc];
          }
        }
        if (tig == 0) {
#pragma unroll
          for (int o = 0; o < kCout; ++o) {
            m0row[c * kCout + o] = m0[h][2 * hh + o];
            m1row[c * kCout + o] = s * m1[h][hh][o];
          }
        }
      }
    }
  }
  if (cb == 0 && t == 0) {
    prow[cols - 2] = db[0];
    prow[cols - 1] = db[1];
  }
}

// One 64 x 64 x 64 product d = a b^T on bf16 wgmma, for the card tests: a
// [64][64] (M x K), b [64][64] (N x K) bf16, d [64][64] fp32, one
// warpgroup, each operand in a tile as the kernels above hold theirs.
// mode 0: A and B K-major tiles; 1: A and B MN-major ([K][M], [K][N]);
// 2: A from registers, B K-major; 3: A from registers, B MN-major; 4: A
// from registers, B K-major, N = 8 (m64n8k16: d's columns 0..7, the rest
// 0).
__global__ void __launch_bounds__(128, 1)
wgmma_bf16_tile_test_kernel(const uint16_t* __restrict__ a,
                            const uint16_t* __restrict__ b,
                            float* __restrict__ d, int mode) {
  __shared__ __align__(1024) uint8_t s_a[kWBTileBytes];
  __shared__ __align__(1024) uint8_t s_b[kWBTileBytes];
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const bool mn = mode == 1 || mode == 3;  // B MN-major (A too at mode 1)
  for (int i = t; i < 64 * 64; i += 128) {
    const int r = i >> 6, k = i & 63;
    *reinterpret_cast<uint16_t*>(s_a + (mode == 1 ? tile_at(k, r)
                                                  : tile_at(r, k))) = a[i];
    *reinterpret_cast<uint16_t*>(s_b + (mn ? tile_at(k, r) : tile_at(r, k))) =
        b[i];
  }
  fence_async_smem();
  __syncthreads();
  uint32_t af[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint16_t* p = a + (warp * 16 + gid) * 64 + ks * 16 + 2 * tig;
    af[ks][0] = load_pair(p);
    af[ks][1] = load_pair(p + 8 * 64);
    af[ks][2] = load_pair(p + 8);
    af[ks][3] = load_pair(p + 8 * 64 + 8);
  }
  float acc[32];
  float n8[4];
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    switch (mode) {
      case 0:
        wgmma_bf16_ss<0, 0>(acc, tile_desc(s_a) + kKStep * ks,
                            tile_desc(s_b) + kKStep * ks, ks != 0);
        break;
      case 1:
        wgmma_bf16_ss<1, 1>(acc, tile_desc(s_a) + kMNStep * ks,
                            tile_desc(s_b) + kMNStep * ks, ks != 0);
        break;
      case 2:
        wgmma_bf16_rs<0>(acc, af[ks], tile_desc(s_b) + kKStep * ks,
                         ks != 0);
        break;
      case 3:
        wgmma_bf16_rs<1>(acc, af[ks], tile_desc(s_b) + kMNStep * ks,
                         ks != 0);
        break;
      default:
        wgmma_bf16_rs_n8(n8, af[ks], tile_desc(s_b) + kKStep * ks, ks != 0);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  fence_acc(n8);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float v = mode == 4 ? (j == 0 ? n8[r] : 0.0f) : acc[4 * j + r];
      d[(warp * 16 + gid + 8 * (r >> 1)) * 64 + 8 * j + 2 * tig + (r & 1)] = v;
    }
  }
}

// Blocks of a narrow backward over n images of hw pixels in tiles of
// `tile`: two per SM, fewer if there are fewer tiles.
int bwd_blocks(long long n, int hw, int tile) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess) {
    return -1;
  }
  const long long ntiles = n * ((hw + tile - 1) / tile);
  const long long want = 2LL * sms;
  return (int)(ntiles < want ? (ntiles > 0 ? ntiles : 1) : want);
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the library
// links no libcuda itself); null where the driver has none.
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
    }
  }
  return encode;
}

// The tensor map of a bf16 [rows][hw] array at base (16-byte aligned, hw a
// multiple of 8): boxes of box_rows rows by 64 pixels, in the 128-byte
// swizzle, pixels past hw read as 0 (WideMaps).
cudaError_t bf16_tile_map(CUtensorMap* map, const void* base, long long rows,
                          int hw, int box_rows) {
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)hw, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)hw * sizeof(uint16_t)};
  const cuuint32_t box[2] = {(cuuint32_t)kWBTile, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// Blocks of the wide bf16 K1 or dx kernel (wgs warpgroups each): one per
// SM, fewer if there are fewer warpgroup tiles; -1 without a device.
int wide_bf16_blocks(int ntiles, int wgs) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess) {
    return -1;
  }
  const int want = (ntiles + wgs - 1) / wgs;
  return want < sms ? want : sms;
}

}  // namespace

// Number of blocks pf_head_bwd (pf_head_bwd_bf16: pf_head_bwd_bf16_blocks)
// launches for n images of hw pixels (the wrapper sizes the [blocks,
// pf_head_bwd_partial_cols()] scratch with it): two per SM, fewer if there
// are fewer tiles.
extern "C" int pf_head_bwd_blocks(long long n, int hw) {
  return bwd_blocks(n, hw, kTile);
}

extern "C" int pf_head_bwd_bf16_blocks(long long n, int hw) {
  return bwd_blocks(n, hw, kB2Tile);
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

// K1 at bfloat16: x [N,Cin,HW] bf16, g1t [Cmid,Cin], c1 [Cmid], w2
// [Cout,Cmid], b2 [Cout] float32 (g1t and w2 rounded to bf16 inside), out
// [N,Cout,HW] bf16; all contiguous on the current device. The same shapes
// as pf_head_fwd.
extern "C" int pf_head_fwd_bf16(const void* x, const float* g1t,
                                const float* c1, const float* w2,
                                const float* b2, void* out, long long n,
                                int cin, int hw, int cmid, int cout,
                                void* stream) {
  const int tpi = hw > 0 ? (hw + kB1Tile - 1) / kB1Tile : 0;
  if (cin != kCin || cout != kCout || cmid <= 0 || cmid % 16 != 0 ||
      cmid > kFwdMaxCmid || hw <= 0 || n < 0 || n * tpi > (1LL << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  const int ntiles = (int)(n * tpi);
  const bool vec = hw % 8 == 0 && ((uintptr_t)x & 15) == 0;
  const size_t smem = fwd_bf16_smem_bytes(cmid);
  auto kernel =
      vec ? pf_head_fwd_bf16_kernel<true> : pf_head_fwd_bf16_kernel<false>;
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
      (const uint16_t*)x, g1t, c1, w2, b2, (uint16_t*)out, hw, tpi, ntiles,
      cmid);
  return (int)cudaGetLastError();
}

// K2 at bfloat16: x [N,Cin,HW] and g [N,Cout,HW] bf16, w1t [Cmid,Cin], gis
// [Cmid], c1 [Cmid], w2gis [Cmid,Cout] float32; dx [N,Cin,HW] bf16; partial
// [blocks, kPartial] scratch (blocks from pf_head_bwd_bf16_blocks);
// sums [kPartial] float32 as pf_head_bwd's. The same shapes as pf_head_bwd.
extern "C" int pf_head_bwd_bf16(const void* x, const void* g,
                                const float* w1t, const float* gis,
                                const float* c1, const float* w2gis, void* dx,
                                float* partial, float* sums, long long n,
                                int cin, int hw, int cmid, int cout,
                                int blocks, void* stream) {
  const int tpi = hw > 0 ? (hw + kB2Tile - 1) / kB2Tile : 0;
  if (cin != kCin || cmid != kCmid || cout != kCout || hw <= 0 || n < 0 ||
      blocks <= 0 || n * tpi > (1LL << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  const int ntiles = (int)(n * tpi);
  const bool vec = hw % 8 == 0 &&
                   (((uintptr_t)x | (uintptr_t)g | (uintptr_t)dx) & 15) == 0;
  auto kernel =
      vec ? pf_head_bwd_bf16_kernel<true> : pf_head_bwd_bf16_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdBf16SmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kBwdThreads, kBwdBf16SmemBytes, (cudaStream_t)stream>>>(
      (const uint16_t*)x, (const uint16_t*)g, w1t, gis, c1, w2gis,
      (uint16_t*)dx, partial, hw, tpi, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<(kPartial + 255) / 256, 256, 0,
                       (cudaStream_t)stream>>>(partial, sums, blocks,
                                               kPartial);
  return (int)cudaGetLastError();
}

// Rows of the per-block sums pf_head_bwd_wide takes (the x extent of the
// sums kernel's grid): one block per SM for each of the Cmid / 128 chunks,
// fewer if there are fewer 64-pixel tiles.
extern "C" int pf_head_bwd_wide_blocks(long long n, int hw, int cmid) {
  int device = 0, sms = 0;
  if (cmid <= 0 || cmid % kWSumChunk != 0 ||
      cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess) {
    return -1;
  }
  const long long ntiles = n * ((hw + kWSTile - 1) / kWSTile);
  return (int)(ntiles < sms ? (ntiles > 0 ? ntiles : 1) : sms);
}

// The weight images of the wide backward (see pf_head_wide_prep_kernel):
// w1t [Cmid,64] -> img [Cmid/64][4][64*64]; Cmid a multiple of 64.
extern "C" int pf_head_wide_prep(const float* w1t, float* img, int cmid,
                                 void* stream) {
  if (cmid <= 0 || cmid % 64 != 0 || cmid > kWMaxCmid ||
      ((uintptr_t)img & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  pf_head_wide_prep_kernel<<<cmid * kWCin / 256, 256, 0,
                             (cudaStream_t)stream>>>(w1t, img, cmid);
  return (int)cudaGetLastError();
}

// The ResNet50-flavour forward: x [N,64,HW], g1t [Cmid,64], c1 [Cmid],
// w2 [2,Cmid], b2 [2], out [N,2,HW]; Cmid a multiple of 128 up to 1024.
// Scratch: img [Cmid/64][4][64*64] (16-byte aligned), g1t's weight images.
// Two launches: the weight prep, the forward over persistent tiles.
extern "C" int pf_head_fwd_wide(const float* x, const float* g1t,
                                const float* c1, const float* w2,
                                const float* b2, float* out, float* img,
                                long long n, int cin, int hw, int cmid,
                                int cout, void* stream) {
  const int tpi = hw > 0 ? (hw + kWTile - 1) / kWTile : 0;
  if (cin != kWCin || cout != kCout || cmid <= 0 || cmid % kWSumChunk != 0 ||
      cmid > kWMaxCmid || hw <= 0 || n < 0 || n * tpi > (1LL << 30) ||
      ((uintptr_t)img & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  const bool vec = hw % 4 == 0 && ((uintptr_t)x & 15) == 0;
  const size_t smem = fwd_wgmma_smem_bytes(cmid);
  auto kernel =
      vec ? pf_head_fwd_wgmma_kernel<true> : pf_head_fwd_wgmma_kernel<false>;
  int device = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess ||
      (err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess) {
    return (int)err;
  }
  if ((err = (cudaError_t)pf_head_wide_prep(g1t, img, cmid, stream)) !=
      cudaSuccess) {
    return (int)err;
  }
  // Persistent blocks, one per SM.
  const int ntiles = (int)(n * tpi);
  kernel<<<ntiles < sms ? ntiles : sms, kFThreads, smem,
           (cudaStream_t)stream>>>(x, img, c1, w2, b2, out, hw, tpi, ntiles,
                                   cmid);
  return (int)cudaGetLastError();
}

// The ResNet50-flavour backward: x [N,64,HW], g [N,2,HW], w1t [Cmid,64],
// gis, c1 [Cmid], w2gis [Cmid,2]; dx [N,64,HW]; sums [cols] = dw1 [64,Cmid]
// | M0 [Cmid,2] | M1 [Cmid,2] | db2, cols = 64*Cmid + 4*Cmid + 2. Scratch:
// partial [blocks, cols] per-block sums, img [Cmid/64][4][64*64] weight
// images (16-byte aligned). Four launches: the weight prep, dx, the sums
// per block, their fixed-order reduction.
extern "C" int pf_head_bwd_wide(const float* x, const float* g,
                                const float* w1t, const float* gis,
                                const float* c1, const float* w2gis,
                                float* dx, float* partial, float* img,
                                float* sums, long long n, int cin, int hw,
                                int cmid, int cout, int blocks,
                                void* stream) {
  const int tpi = hw > 0 ? (hw + kWTile - 1) / kWTile : 0;
  if (cin != kWCin || cout != kCout || cmid <= 0 || cmid % kWSumChunk != 0 ||
      cmid > kWMaxCmid || hw <= 0 || n <= 0 || blocks <= 0 ||
      n * tpi > (1LL << 30) || ((uintptr_t)img & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec = hw % 4 == 0 &&
                   (((uintptr_t)x | (uintptr_t)g | (uintptr_t)dx) & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int cols = kWCin * cmid + 4 * cmid + kCout;
  const size_t dx_smem = bwd_wide_dx_smem_bytes(cmid);
  auto dx_kernel = vec ? pf_head_bwd_wide_dx_kernel<true>
                       : pf_head_bwd_wide_dx_kernel<false>;
  auto sums_kernel = vec ? pf_head_bwd_wide_sums_kernel<true>
                         : pf_head_bwd_wide_sums_kernel<false>;
  int device = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(dx_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)dx_smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(sums_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kWSumsSmemBytes)) != cudaSuccess ||
      (err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess) {
    return (int)err;
  }
  if ((err = (cudaError_t)pf_head_wide_prep(w1t, img, cmid, stream)) !=
      cudaSuccess) {
    return (int)err;
  }
  // Persistent dx blocks, one per SM.
  const int ntiles = (int)(n * tpi);
  dx_kernel<<<ntiles < sms ? ntiles : sms, kWThreads, dx_smem, s>>>(
      x, g, img, gis, c1, w2gis, dx, hw, tpi, ntiles, cmid);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int stpi = (hw + kWSTile - 1) / kWSTile;
  sums_kernel<<<dim3(blocks, cmid / kWSumChunk), kWThreads, kWSumsSmemBytes,
                s>>>(x, g, img, gis, c1, w2gis, partial, hw, stpi, n * stpi,
                     cmid);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<(cols + 255) / 256, 256, 0, s>>>(partial, sums, blocks,
                                                        cols);
  return (int)cudaGetLastError();
}

// K1 at bfloat16 on the ResNet50-flavour head: x [N,64,HW] bf16, g1t
// [Cmid,64], c1 [Cmid], w2 [2,Cmid], b2 [2] float32 (g1t and w2 rounded to
// bf16 inside), out [N,2,HW] bf16; Cmid a multiple of 128 up to 512; all
// contiguous on the current device.
extern "C" int pf_head_fwd_wide_bf16(const void* x, const float* g1t,
                                     const float* c1, const float* w2,
                                     const float* b2, void* out, long long n,
                                     int cin, int hw, int cmid, int cout,
                                     void* stream) {
  const int tpi = hw > 0 ? (hw + kWBTile - 1) / kWBTile : 0;
  if (cin != kWCin || cout != kCout || cmid <= 0 || cmid % kWSumChunk != 0 ||
      cmid > kWBMaxCmid || hw <= 0 || n < 0 || n * tpi > (1LL << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  const int ntiles = (int)(n * tpi);
  const bool vec = hw % 8 == 0 && ((uintptr_t)x & 15) == 0;
  const size_t smem = fwd_wide_bf16_smem_bytes(cmid);
  auto kernel = vec ? pf_head_fwd_wide_bf16_kernel<true>
                    : pf_head_fwd_wide_bf16_kernel<false>;
  WideMaps maps = {};
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && vec) {
    err = bf16_tile_map(&maps.x, x, n * kWCin, hw, kWCin);
  }
  if (err != cudaSuccess) return (int)err;
  const int blocks = wide_bf16_blocks(ntiles, kK1WG);
  if (blocks <= 0) return (int)cudaErrorNoDevice;
  kernel<<<blocks, kK1WG * 128, smem, (cudaStream_t)stream>>>(
      maps, (const uint16_t*)x, g1t, c1, w2, b2, (uint16_t*)out, hw, tpi,
      ntiles, cmid);
  return (int)cudaGetLastError();
}

// K2 at bfloat16 on the ResNet50-flavour head: x [N,64,HW] and g [N,2,HW]
// bf16, w1t [Cmid,64], gis, c1 [Cmid], w2gis [Cmid,2] float32; dx
// [N,64,HW] bf16; partial [blocks, cols] scratch (blocks from
// pf_head_bwd_wide_blocks); sums [cols] float32 as pf_head_bwd_wide's.
// Cmid a multiple of 128 up to 512. Three launches: dx, the sums per
// block, their fixed-order reduction.
extern "C" int pf_head_bwd_wide_bf16(const void* x, const void* g,
                                     const float* w1t, const float* gis,
                                     const float* c1, const float* w2gis,
                                     void* dx, float* partial, float* sums,
                                     long long n, int cin, int hw, int cmid,
                                     int cout, int blocks, void* stream) {
  const int tpi = hw > 0 ? (hw + kWBTile - 1) / kWBTile : 0;
  if (cin != kWCin || cout != kCout || cmid <= 0 || cmid % kWSumChunk != 0 ||
      cmid > kWBMaxCmid || hw <= 0 || n <= 0 || blocks <= 0 ||
      n * tpi > (1LL << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec = hw % 8 == 0 &&
                   (((uintptr_t)x | (uintptr_t)g | (uintptr_t)dx) & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int cols = kWCin * cmid + 4 * cmid + kCout;
  const size_t dx_smem = bwd_wide_bf16_dx_smem_bytes(cmid);
  auto dx_kernel = vec ? pf_head_bwd_wide_bf16_dx_kernel<true>
                       : pf_head_bwd_wide_bf16_dx_kernel<false>;
  auto sums_kernel = vec ? pf_head_bwd_wide_bf16_sums_kernel<true>
                         : pf_head_bwd_wide_bf16_sums_kernel<false>;
  // x and g by the tensor memory accelerator where HW % 8 == 0.
  WideMaps maps = {};
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(dx_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)dx_smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(sums_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kWBSumsSmemBytes)) != cudaSuccess ||
      (vec && ((err = bf16_tile_map(&maps.x, x, n * kWCin, hw, kWCin)) !=
                   cudaSuccess ||
               (err = bf16_tile_map(&maps.g, g, n * kCout, hw, kCout)) !=
                   cudaSuccess))) {
    return (int)err;
  }
  const int ntiles = (int)(n * tpi);
  const int dx_blocks = wide_bf16_blocks(ntiles, kDxWG);
  if (dx_blocks <= 0) return (int)cudaErrorNoDevice;
  dx_kernel<<<dx_blocks, kDxWG * 128, dx_smem, s>>>(
      maps, (const uint16_t*)x, (const uint16_t*)g, w1t, gis, c1, w2gis,
      (uint16_t*)dx, hw, tpi, ntiles, cmid);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 grid(blocks, (cmid + 128 * kSumsWG - 1) / (128 * kSumsWG));
  const int stpi = (hw + kWBTile * kSumsSub - 1) / (kWBTile * kSumsSub);
  sums_kernel<<<grid, 128 * kSumsWG, kWBSumsSmemBytes, s>>>(
      maps, (const uint16_t*)x, (const uint16_t*)g, w1t, gis, c1, w2gis,
      partial, hw, stpi, (int)(n * stpi), cmid);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<(cols + 255) / 256, 256, 0, s>>>(partial, sums, blocks,
                                                        cols);
  return (int)cudaGetLastError();
}

// For the card tests: d [64][64] = a [64][64] b[64][64]^T on one warpgroup
// through wgmma tf32 (see wgmma_tile_test_kernel for mode).
extern "C" int wgmma_tf32_tile(const float* a, const float* b, float* d,
                               int mode, void* stream) {
  wgmma_tile_test_kernel<<<1, 128, 0, (cudaStream_t)stream>>>(a, b, d, mode);
  return (int)cudaGetLastError();
}

// For the card tests: d [64][64] = a [64][64] b [64][64]^T (bf16 operands)
// on one warpgroup through wgmma bf16 (see wgmma_bf16_tile_test_kernel for
// mode).
extern "C" int wgmma_bf16_tile(const void* a, const void* b, float* d,
                               int mode, void* stream) {
  wgmma_bf16_tile_test_kernel<<<1, 128, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)a, (const uint16_t*)b, d, mode);
  return (int)cudaGetLastError();
}
