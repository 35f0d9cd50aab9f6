// Perspective-field head forward, eval mode: 1x1 conv -> BatchNorm (given
// statistics) -> ReLU -> 1x1 conv, fused so the [M, Cmid] middle never
// reaches device memory.
//
//   out[n,o,s] = b2[o] + sum_j w2[o,j] * relu(c1[j] + sum_k g1t[j,k] x[n,k,s])
//
// with BN folded into the first conv outside the kernel (by the wrapper):
// g1t = w1 * gamma/sqrt(var+eps) per output row, c1 = (b1-mean)*that+beta.
//
// Replaces the TPU kernel bihome_tpu/ops/fused_head.py:_fwd_kernel (driven
// by _run_fwd and fused_pf_head), which keeps pixels in lanes and channels
// in sublanes ([Cin, M] layout). The backbone's NCHW activation already has
// that layout per image: for a fixed channel the pixels are contiguous, so
// thread t reading pixel s+t of channel k coalesces, and the wrapper makes
// no transposed copy.
//
// Bound on the H100: operations. At the zeng eval shape (M = 2B*128*128 =
// 2,097,152 pixels for B=64, Cin=16, Cmid=128, Cout=2) the call moves
// ~151 MB but does 2*M*(Cin*Cmid + Cmid*Cout) ~ 9.7 GFLOP, ~0.14 ms on the
// fp32 CUDA cores against ~45 us of HBM traffic. This first version stays
// on the fp32 cores: one thread per pixel, the Cin inputs in registers, the
// folded weights in shared memory (every thread of a warp reads the same
// weight, a broadcast), and the two outputs accumulated in registers over
// the Cmid middle channels. Tensor cores (the [M,16]x[16,128] product is a
// natural wgmma tile) are later work.

#include <cuda_runtime.h>

namespace {

template <int CIN, int COUT>
__global__ void pf_head_fwd_kernel(const float* __restrict__ x,
                                   const float* __restrict__ g1t,
                                   const float* __restrict__ c1,
                                   const float* __restrict__ w2,
                                   const float* __restrict__ b2,
                                   float* __restrict__ out, long long m,
                                   int hw, int cmid) {
  extern __shared__ __align__(16) float smem[];
  float* s_g1t = smem;                  // [cmid, CIN]
  float* s_c1 = s_g1t + cmid * CIN;     // [cmid]
  float* s_w2 = s_c1 + cmid;            // [COUT, cmid]
  for (int i = threadIdx.x; i < cmid * CIN; i += blockDim.x) s_g1t[i] = g1t[i];
  for (int i = threadIdx.x; i < cmid; i += blockDim.x) s_c1[i] = c1[i];
  for (int i = threadIdx.x; i < COUT * cmid; i += blockDim.x) s_w2[i] = w2[i];
  __syncthreads();

  const long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= m) return;  // ragged edge: M need not be a multiple of 256
  const long long n = pix / hw;
  const long long s = pix - n * hw;
  const float* xp = x + n * CIN * hw + s;
  float xv[CIN];
#pragma unroll
  for (int k = 0; k < CIN; ++k) xv[k] = xp[(long long)k * hw];

  float acc[COUT];
#pragma unroll
  for (int o = 0; o < COUT; ++o) acc[o] = 0.0f;
  for (int j = 0; j < cmid; ++j) {
    const float* g = s_g1t + j * CIN;
    float a = 0.0f;
#pragma unroll
    for (int k = 0; k < CIN; ++k) a = fmaf(g[k], xv[k], a);
    a = fmaxf(a + s_c1[j], 0.0f);
#pragma unroll
    for (int o = 0; o < COUT; ++o) acc[o] = fmaf(s_w2[o * cmid + j], a, acc[o]);
  }
  float* op = out + n * COUT * hw + s;
#pragma unroll
  for (int o = 0; o < COUT; ++o) op[(long long)o * hw] = acc[o] + b2[o];
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
// Bound on the H100: operations. At the zeng training shape (M = 2,097,152
// pixels, Cin 16, Cmid 128, Cout 2) the pass does ~14.5 kflop per pixel
// (~30 GFLOP, ~0.45 ms at 67 TFLOP/s fp32) against ~0.29 GB of x, g and dx
// traffic (~0.09 ms). The cross-pixel sums cannot live in a thread's
// registers and Hopper's blocks run in no order, so the design is:
//
//   * a block of 256 threads walks pixel tiles of 32 (grid-stride, a few
//     blocks per SM); per tile, each warp computes e, mask and mask*mid for
//     16 of the 128 middle channels of all 32 pixels (lane = pixel) into
//     shared memory, rows padded to 33 floats so both the pixel-major writes
//     and the channel-major reads are free of bank conflicts;
//   * the block then does the small products from shared memory: dx for
//     the tile (thread = pixel x two input channels), and dw1, M0, M1, db2
//     accumulated in registers across all of the block's tiles (thread =
//     middle channel x half of the outputs);
//   * each block writes its sums to its own row of a [blocks, 2562] scratch
//     and a second kernel adds the rows in block order: deterministic, no
//     atomics.
//
// The weights sit in shared memory and every read of them is uniform across
// a warp (a broadcast). All of it runs on the fp32 cores; tensor cores are
// later work.

constexpr int kBwdTile = 32;       // pixels per tile (one per lane)
constexpr int kBwdThreads = 256;   // 8 warps
constexpr int kPad = kBwdTile + 1; // padded row of the [Cmid][tile] arrays
constexpr int kCin = 16;
constexpr int kCmid = 128;
constexpr int kCout = 2;
// Partial-sum row: dw1 [Cin,Cmid], M0 [Cmid,Cout], M1 [Cmid,Cout], db2.
constexpr int kPartial = kCin * kCmid + 2 * kCmid * kCout + kCout;

__global__ void __launch_bounds__(kBwdThreads)
pf_head_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ w1t, const float* __restrict__ gis,
                   const float* __restrict__ c1,
                   const float* __restrict__ w2gis, float* __restrict__ dx,
                   float* __restrict__ partial, long long m, int hw,
                   long long ntiles) {
  extern __shared__ __align__(16) float smem[];
  float* s_w1t = smem;                        // [Cmid][Cin]
  float* s_gis = s_w1t + kCmid * kCin;        // [Cmid]
  float* s_c1 = s_gis + kCmid;                // [Cmid]
  float* s_w2 = s_c1 + kCmid;                 // [Cmid][Cout]
  float* s_x = s_w2 + kCmid * kCout;          // [tile][Cin+1]
  float* s_g = s_x + kBwdTile * (kCin + 1);   // [Cout][tile]
  float* s_e = s_g + kCout * kBwdTile;        // [Cmid][kPad]
  float* s_mk = s_e + kCmid * kPad;           // [Cmid][kPad] mask
  float* s_mm = s_mk + kCmid * kPad;          // [Cmid][kPad] mask*mid

  const int t = threadIdx.x;
  for (int i = t; i < kCmid * kCin; i += kBwdThreads) s_w1t[i] = w1t[i];
  for (int i = t; i < kCmid; i += kBwdThreads) {
    s_gis[i] = gis[i];
    s_c1[i] = c1[i];
  }
  for (int i = t; i < kCmid * kCout; i += kBwdThreads) s_w2[i] = w2gis[i];

  const int lane = t & 31;
  const int warp = t >> 5;
  // Reduction role: middle channel rc, half rh (0: dw1 rows 0-7 and M0;
  // 1: dw1 rows 8-15 and M1).
  const int rc = t & (kCmid - 1);
  const int rh = t >> 7;
  float acc_dw1[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc_dw1[j] = 0.0f;
  float acc_m[kCout] = {0.0f, 0.0f};
  float acc_db2 = 0.0f;

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long pix0 = tile * kBwdTile;
    __syncthreads();  // weights loaded / previous tile's reads done
    // Stage x and g of the tile; pixels past M read as 0 and so add 0.
    for (int i = t; i < kCin * kBwdTile; i += kBwdThreads) {
      const int k = i / kBwdTile;
      const int p = i - k * kBwdTile;
      const long long pix = pix0 + p;
      float val = 0.0f;
      if (pix < m) {
        const long long n = pix / hw;
        val = x[(n * kCin + k) * hw + (pix - n * hw)];
      }
      s_x[p * (kCin + 1) + k] = val;
    }
    if (t < kCout * kBwdTile) {
      const int o = t / kBwdTile;
      const int p = t - o * kBwdTile;
      const long long pix = pix0 + p;
      float val = 0.0f;
      if (pix < m) {
        const long long n = pix / hw;
        val = g[(n * kCout + o) * hw + (pix - n * hw)];
      }
      s_g[o * kBwdTile + p] = val;
    }
    __syncthreads();

    // Phase A: lane = pixel, warp = 16 middle channels.
    {
      float xv[kCin];
#pragma unroll
      for (int k = 0; k < kCin; ++k) xv[k] = s_x[lane * (kCin + 1) + k];
      const float g0 = s_g[lane];
      const float g1 = s_g[kBwdTile + lane];
      const int c0 = warp * (kCmid / 8);
      for (int c = c0; c < c0 + kCmid / 8; ++c) {
        const float* w = s_w1t + c * kCin;
        float mid = 0.0f;
#pragma unroll
        for (int k = 0; k < kCin; ++k) mid = fmaf(w[k], xv[k], mid);
        const float a = fmaf(s_gis[c], mid, s_c1[c]);
        const float mk = a > 0.0f ? 1.0f : 0.0f;
        const float eun = fmaf(s_w2[c * kCout], g0, s_w2[c * kCout + 1] * g1);
        s_e[c * kPad + lane] = mk * eun;
        s_mk[c * kPad + lane] = mk;
        s_mm[c * kPad + lane] = mk * mid;
      }
    }
    __syncthreads();

    // Phase B1: dx of the tile; lane = pixel, warp = input channels 2w, 2w+1.
    {
      const int k = warp * 2;
      float d0 = 0.0f, d1 = 0.0f;
      for (int c = 0; c < kCmid; ++c) {
        const float e = s_e[c * kPad + lane];
        d0 = fmaf(s_w1t[c * kCin + k], e, d0);
        d1 = fmaf(s_w1t[c * kCin + k + 1], e, d1);
      }
      const long long pix = pix0 + lane;
      if (pix < m) {
        const long long n = pix / hw;
        const long long s = pix - n * hw;
        dx[(n * kCin + k) * hw + s] = d0;
        dx[(n * kCin + k + 1) * hw + s] = d1;
      }
    }

    // Phase B2: the cross-pixel sums; thread = (middle channel, half).
    {
      const float* er = s_e + rc * kPad;
      const float* mr = (rh == 0 ? s_mk : s_mm) + rc * kPad;
      for (int p = 0; p < kBwdTile; ++p) {
        const float e = er[p];
        const float* xr = s_x + p * (kCin + 1) + rh * 8;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc_dw1[j] = fmaf(xr[j], e, acc_dw1[j]);
        const float mv = mr[p];
        acc_m[0] = fmaf(mv, s_g[p], acc_m[0]);
        acc_m[1] = fmaf(mv, s_g[kBwdTile + p], acc_m[1]);
      }
      if (t < kCout) {
        for (int p = 0; p < kBwdTile; ++p) acc_db2 += s_g[t * kBwdTile + p];
      }
    }
  }

  float* row = partial + (long long)blockIdx.x * kPartial;
#pragma unroll
  for (int j = 0; j < 8; ++j) row[(rh * 8 + j) * kCmid + rc] = acc_dw1[j];
  float* mrow = row + kCin * kCmid + rh * kCmid * kCout;
  mrow[rc * kCout] = acc_m[0];
  mrow[rc * kCout + 1] = acc_m[1];
  if (t < kCout) row[kPartial - kCout + t] = acc_db2;
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

// Number of blocks pf_head_bwd launches for m pixels (the wrapper sizes the
// [blocks, pf_head_bwd_partial_cols()] scratch with it).
extern "C" int pf_head_bwd_blocks(long long m) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess) {
    return -1;
  }
  const long long ntiles = (m + kBwdTile - 1) / kBwdTile;
  const long long want = 3LL * sms;
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
  const long long m = n * hw;
  const long long ntiles = (m + kBwdTile - 1) / kBwdTile;
  const size_t smem =
      (size_t)(kCmid * kCin + 2 * kCmid + kCmid * kCout +
               kBwdTile * (kCin + 1) + kCout * kBwdTile + 3 * kCmid * kPad) *
      sizeof(float);
  auto kernel = pf_head_bwd_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kBwdThreads, smem, (cudaStream_t)stream>>>(
      x, g, w1t, gis, c1, w2gis, dx, partial, m, hw, ntiles);
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
  if (cin != 16 || cout != 2 || cmid <= 0 || hw <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long m = n * hw;
  if (m == 0) return 0;
  const size_t smem = (size_t)(cmid * cin + cmid + cout * cmid) * sizeof(float);
  auto kernel = pf_head_fwd_kernel<16, 2>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = 256;
  const long long blocks = (m + threads - 1) / threads;
  kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      x, g1t, c1, w2, b2, out, m, hw, cmid);
  return (int)cudaGetLastError();
}
