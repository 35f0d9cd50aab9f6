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

}  // namespace

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
