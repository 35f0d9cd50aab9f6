// Bilinear sampling with zero padding, batched: images [N,H,W,C] (NHWC,
// float32) sampled at P points per image -> out [N,P,C].
//
// Replaces the TPU kernel bihome_tpu/ops/warp_pallas.py:_fwd_kernel (driven
// by _forward and tent_sample_batched), which computes the same function as
// two tent-weight contractions so the TPU matrix unit does the work. On
// Hopper that contraction would spend H+W multiply-adds per point; this is
// the 4-tap gather of bihome_tpu/geometry.py:bilinear_sample instead, each
// tap zero outside the image.
//
// Bound on the H100: bytes. At the eval datagen shape (N=64 windows of
// 192x192x1, P=16384) the call must move 22 MB (image read once, u/v read,
// output written), 0.0066 ms at 3.35 TB/s, against ~15 flops per point; at
// the loss warp (N=128 patches of 128x128x1) 34 MB, 0.0100 ms.
//
// Design for C = 1, the only C on the zeng path (bilinear_sample_c1_kernel):
// a 2-D grid, blockIdx.y = image, so a thread finds its image without a
// 64-bit division and addresses its taps with 32-bit offsets inside it.
// Each thread takes 2 consecutive points: float2 loads of u and v and a
// float2 store of out when P is even (every image's row is then 8-byte
// aligned), else scalar loads, the last thread of an image taking only the
// point below P. (4 points a thread with float4 measured slower on the H100
// at the datagen shape than 2, and than grid_sample: fewer threads in
// flight for the same gathers.) The taps are gathers through the read-only
// path (__ldg); neighbouring points map to neighbouring pixels, so they
// mostly hit L1/L2. Their positions, weights and validity come from
// taps_c1, which K4's C = 1 kernel shares. C > 1 keeps the generic kernel,
// one thread per point.
//
// floorf, not an integer cast, gives the top-left tap: coordinates go
// negative near the border and a cast rounds toward zero.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

namespace cg = cooperative_groups;

namespace {

__global__ void bilinear_sample_kernel(const float* __restrict__ img,
                                       const float* __restrict__ u,
                                       const float* __restrict__ v,
                                       float* __restrict__ out,
                                       int h, int w, int c, long long p,
                                       long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long b = i / p;
  const float x = u[i];
  const float y = v[i];
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx1 = x - x0f;
  const float wy1 = y - y0f;
  const float wx0 = 1.0f - wx1;
  const float wy0 = 1.0f - wy1;
  // Any tap more than one pixel outside is invalid either way; clamping
  // the float first keeps the conversion defined for huge coordinates.
  const int x0 = (int)fminf(fmaxf(x0f, -2.0f), (float)w + 1.0f);
  const int y0 = (int)fminf(fmaxf(y0f, -2.0f), (float)h + 1.0f);
  const bool vx0 = x0 >= 0 && x0 < w;
  const bool vx1 = x0 + 1 >= 0 && x0 + 1 < w;
  const bool vy0 = y0 >= 0 && y0 < h;
  const bool vy1 = y0 + 1 >= 0 && y0 + 1 < h;
  const float w00 = wy0 * wx0;
  const float w01 = wy0 * wx1;
  const float w10 = wy1 * wx0;
  const float w11 = wy1 * wx1;
  const float* base = img + b * (long long)h * w * c;
  const long long r0 = (long long)y0 * w;
  const long long r1 = (long long)(y0 + 1) * w;
  for (int ci = 0; ci < c; ++ci) {
    const float t00 = (vy0 && vx0) ? base[(r0 + x0) * c + ci] : 0.0f;
    const float t01 = (vy0 && vx1) ? base[(r0 + x0 + 1) * c + ci] : 0.0f;
    const float t10 = (vy1 && vx0) ? base[(r1 + x0) * c + ci] : 0.0f;
    const float t11 = (vy1 && vx1) ? base[(r1 + x0 + 1) * c + ci] : 0.0f;
    out[i * c + ci] = t00 * w00 + t01 * w01 + t10 * w10 + t11 * w11;
  }
}

// The 4 taps of one point of a single-channel image, for the C = 1
// kernels: the bilinear weights, the offset r0 of the top-left tap (y0, x0)
// inside the image (32-bit: their launch requires (h + 2) * w < 2^31), and
// which taps lie inside the image. Any tap more than one pixel outside is
// invalid either way; clamping the float first keeps the conversion
// defined for huge coordinates.
struct TapsC1 {
  float wx0, wx1, wy0, wy1;
  int r0;
  bool v00, v01, v10, v11;
};

__device__ __forceinline__ TapsC1 taps_c1(int h, int w, float x, float y) {
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  TapsC1 t;
  t.wx1 = x - x0f;
  t.wy1 = y - y0f;
  t.wx0 = 1.0f - t.wx1;
  t.wy0 = 1.0f - t.wy1;
  const int x0 = (int)fminf(fmaxf(x0f, -2.0f), (float)w + 1.0f);
  const int y0 = (int)fminf(fmaxf(y0f, -2.0f), (float)h + 1.0f);
  const bool vx0 = (unsigned)x0 < (unsigned)w;
  const bool vx1 = (unsigned)(x0 + 1) < (unsigned)w;
  const bool vy0 = (unsigned)y0 < (unsigned)h;
  const bool vy1 = (unsigned)(y0 + 1) < (unsigned)h;
  t.v00 = vy0 && vx0;
  t.v01 = vy0 && vx1;
  t.v10 = vy1 && vx0;
  t.v11 = vy1 && vx1;
  t.r0 = y0 * w + x0;
  return t;
}

// The tap values (x: (y0,x0), y: (y0,x0+1), z: (y0+1,x0), w: (y0+1,x0+1)),
// each 0 outside the image.
__device__ __forceinline__ float4 fetch_c1(const float* __restrict__ img,
                                           int w, const TapsC1& t) {
  const int r1 = t.r0 + w;
  return make_float4(t.v00 ? __ldg(img + t.r0) : 0.0f,
                     t.v01 ? __ldg(img + t.r0 + 1) : 0.0f,
                     t.v10 ? __ldg(img + r1) : 0.0f,
                     t.v11 ? __ldg(img + r1 + 1) : 0.0f);
}

// One point of a single-channel image, as bilinear_sample_kernel computes
// it for C = 1.
__device__ __forceinline__ float sample_c1(const float* __restrict__ img,
                                          int h, int w, float x, float y) {
  const TapsC1 t = taps_c1(h, w, x, y);
  const float4 v = fetch_c1(img, w, t);
  return v.x * (t.wy0 * t.wx0) + v.y * (t.wy0 * t.wx1) +
         v.z * (t.wy1 * t.wx0) + v.w * (t.wy1 * t.wx1);
}

constexpr int kC1Threads = 256;

// C = 1: grid (ceil(P / (2 * 256)), N); thread = points 2q, 2q + 1 of image
// blockIdx.y. kVec: P even and u, v, out 8-byte aligned.
template <bool kVec>
__global__ void __launch_bounds__(kC1Threads)
bilinear_sample_c1_kernel(const float* __restrict__ img,
                          const float* __restrict__ u,
                          const float* __restrict__ v,
                          float* __restrict__ out, int h, int w, int p) {
  const int q = (blockIdx.x * kC1Threads + threadIdx.x) * 2;
  if (q >= p) return;
  const long long row = (long long)blockIdx.y * p;
  const float* im = img + (long long)blockIdx.y * h * w;
  const float* ur = u + row;
  const float* vr = v + row;
  float* orow = out + row;
  if (kVec) {
    const float2 uu = __ldg(reinterpret_cast<const float2*>(ur + q));
    const float2 vv = __ldg(reinterpret_cast<const float2*>(vr + q));
    float2 o;
    o.x = sample_c1(im, h, w, uu.x, vv.x);
    o.y = sample_c1(im, h, w, uu.y, vv.y);
    *reinterpret_cast<float2*>(orow + q) = o;
  } else {
    const int end = q + 2 < p ? q + 2 : p;
    for (int i = q; i < end; ++i) {
      orow[i] = sample_c1(im, h, w, __ldg(ur + i), __ldg(vr + i));
    }
  }
}

// ---------------------------------------------------------------------------
// Backward with respect to the sample points (K4): replaces
// bihome_tpu/ops/warp_pallas.py:_bwd_uv_kernel, which contracts the
// derivative of the tent weights, dtent(d) = -sign(d) on |d| < 1 and 0
// elsewhere, against the image. In gather form that is the difference of
// the same 4 taps K3 reads:
//
//   du = sum_c g_c * (wy0 * (I[y0,x0+1] - I[y0,x0]) + wy1 * (I[y0+1,x0+1] -
//                     I[y0+1,x0]))
//   dv = sum_c g_c * (wx0 * (I[y0+1,x0] - I[y0,x0]) + wx1 * (I[y0+1,x0+1] -
//                     I[y0,x0+1]))
//
// each tap 0 outside the image, and du = 0 where u - floor(u) is exactly 0
// (dv likewise): dtent is 0 at d = 0 and at |d| = 1, the TPU convention
// (bihome_tpu/geometry.py:_tent_dw agrees).
//
// Bound on the H100: bytes. At the loss-warp shape (N = 128 images of
// 128x128x1, P = 16,384) the call must read the images, u, v and g and
// write du and dv, ~50 MB (~15 us), against ~30 flops per point.
//
// Design for C = 1, the loss warp's C (bilinear_sample_bwd_uv_c1_kernel):
// K3's C = 1 layout. A 2-D grid, blockIdx.y = image, so no 64-bit division
// and 32-bit tap offsets inside the image; 2 consecutive points a thread,
// with float2 loads of u, v and g and float2 stores of du and dv when P is
// even and every pointer 8-byte aligned, else scalar accesses, the last
// thread of an image taking only the point below P; the taps through
// __ldg, their positions, weights and validity from K3's taps_c1, so the
// two kernels cannot drift apart. C > 1 keeps the generic kernel below:
// one thread per point, a loop over the channels.
__global__ void bilinear_sample_bwd_uv_kernel(
    const float* __restrict__ img, const float* __restrict__ u,
    const float* __restrict__ v, const float* __restrict__ g,
    float* __restrict__ du, float* __restrict__ dv, int h, int w, int c,
    long long p, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long b = i / p;
  const float x = u[i];
  const float y = v[i];
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx1 = x - x0f;
  const float wy1 = y - y0f;
  const float wx0 = 1.0f - wx1;
  const float wy0 = 1.0f - wy1;
  const int x0 = (int)fminf(fmaxf(x0f, -2.0f), (float)w + 1.0f);
  const int y0 = (int)fminf(fmaxf(y0f, -2.0f), (float)h + 1.0f);
  const bool vx0 = x0 >= 0 && x0 < w;
  const bool vx1 = x0 + 1 >= 0 && x0 + 1 < w;
  const bool vy0 = y0 >= 0 && y0 < h;
  const bool vy1 = y0 + 1 >= 0 && y0 + 1 < h;
  const float* base = img + b * (long long)h * w * c;
  const long long r0 = (long long)y0 * w;
  const long long r1 = (long long)(y0 + 1) * w;
  float su = 0.0f, sv = 0.0f;
  for (int ci = 0; ci < c; ++ci) {
    const float t00 = (vy0 && vx0) ? base[(r0 + x0) * c + ci] : 0.0f;
    const float t01 = (vy0 && vx1) ? base[(r0 + x0 + 1) * c + ci] : 0.0f;
    const float t10 = (vy1 && vx0) ? base[(r1 + x0) * c + ci] : 0.0f;
    const float t11 = (vy1 && vx1) ? base[(r1 + x0 + 1) * c + ci] : 0.0f;
    const float gc = g[i * c + ci];
    su = fmaf(gc, wy0 * (t01 - t00) + wy1 * (t11 - t10), su);
    sv = fmaf(gc, wx0 * (t10 - t00) + wx1 * (t11 - t01), sv);
  }
  du[i] = wx1 == 0.0f ? 0.0f : su;
  dv[i] = wy1 == 0.0f ? 0.0f : sv;
}

// K4 at one point of a single-channel image with cotangent g: (du, dv).
__device__ __forceinline__ float2 sample_grad_c1(
    const float* __restrict__ img, int h, int w, float x, float y, float g) {
  const TapsC1 t = taps_c1(h, w, x, y);
  const float4 v = fetch_c1(img, w, t);
  return make_float2(
      t.wx1 == 0.0f ? 0.0f : g * (t.wy0 * (v.y - v.x) + t.wy1 * (v.w - v.z)),
      t.wy1 == 0.0f ? 0.0f : g * (t.wx0 * (v.z - v.x) + t.wx1 * (v.w - v.y)));
}

// K4, C = 1: grid (ceil(P / (2 * 256)), N); thread = points 2q, 2q + 1 of
// image blockIdx.y. kVec: P even and u, v, g, du, dv 8-byte aligned.
template <bool kVec>
__global__ void __launch_bounds__(kC1Threads)
bilinear_sample_bwd_uv_c1_kernel(const float* __restrict__ img,
                                 const float* __restrict__ u,
                                 const float* __restrict__ v,
                                 const float* __restrict__ g,
                                 float* __restrict__ du,
                                 float* __restrict__ dv, int h, int w,
                                 int p) {
  const int q = (blockIdx.x * kC1Threads + threadIdx.x) * 2;
  if (q >= p) return;
  const long long row = (long long)blockIdx.y * p;
  const float* im = img + (long long)blockIdx.y * h * w;
  if (kVec) {
    const float2 uu = __ldg(reinterpret_cast<const float2*>(u + row + q));
    const float2 vv = __ldg(reinterpret_cast<const float2*>(v + row + q));
    const float2 gg = __ldg(reinterpret_cast<const float2*>(g + row + q));
    const float2 a = sample_grad_c1(im, h, w, uu.x, vv.x, gg.x);
    const float2 b = sample_grad_c1(im, h, w, uu.y, vv.y, gg.y);
    *reinterpret_cast<float2*>(du + row + q) = make_float2(a.x, b.x);
    *reinterpret_cast<float2*>(dv + row + q) = make_float2(a.y, b.y);
  } else {
    const int end = q + 2 < p ? q + 2 : p;
    for (int i = q; i < end; ++i) {
      const float2 d = sample_grad_c1(im, h, w, __ldg(u + row + i),
                                      __ldg(v + row + i), __ldg(g + row + i));
      du[row + i] = d.x;
      dv[row + i] = d.y;
    }
  }
}

// The C = 1 kernels take a call when the grid's y dimension holds the
// images and 32-bit offsets hold a point's index and its taps.
bool c1_path(int n, int h, int w, int c, long long p) {
  return c == 1 && n <= 65535 && p <= (1LL << 30) &&
         (long long)(h + 2) * w < (1LL << 31);
}

dim3 c1_grid(int n, long long p) {
  return dim3((unsigned)((p + 2 * kC1Threads - 1) / (2 * kC1Threads)),
              (unsigned)n);
}

// ---------------------------------------------------------------------------
// Backward with respect to the image (K5): replaces
// bihome_tpu/ops/warp_pallas.py:_bwd_img_kernel (the pallas_call of
// _backward, warp_pallas.py:197-204),
//
//   dimg[b,y,x,c] = sum_p wy[p,y] * wx[p,x] * g[b,p,c],
//
// which the TPU kernel contracts on the matrix unit, one sample's whole
// dimg resident in VMEM while its sequential grid adds each block of points
// into it, written once. It runs where the sampled image takes a gradient:
// the biHomE loss's upsample-patch-{2,4}x strategies (the warped patches
// upsampled, 4 or 16 points per pixel, on one grid shared by the batch),
// its MASK_KEYS masks (C = 2, riding with the patch) and the TripletHead's
// learned masks (FIX_MASK false).
//
// Bound on the H100: bytes. u, v and g are read once, dimg written once
// (~20 flops a point). At the batch-128 upsample-4x shape (128 images of
// 128x128x1, P = 262,144) g is 134.2 MB and dimg 8.4 MB; a grid
// materialised per sample adds 268 MB, one grid row shared by the batch
// 2.1 MB: 0.1227 ms against 0.0432 at 3.35 TB/s.
//
// Design (bilinear_sample_bwd_img_cluster_kernel): one thread-block cluster
// of S blocks per sample. Each block zeroes its own float32 copy of the
// sample's dimg (H*W*C values) in dynamic shared memory, 64 KB at
// 128x128x1 and 128 KB at C = 2, streams 1/S of the sample's points in
// groups of 4 consecutive points a thread, the next group's loads in flight
// while one is added (16-byte loads of u, v and g when P % 4 == 0 and the
// pointers are 16-byte aligned, else scalar loads, the last group of a
// sample taking the points below P), and adds each tap into its copy with
// a shared-memory atomic. A float atomicAdd in shared memory is no single
// instruction on this card: it compiles to a compare-and-swap loop (LDS,
// FADD, ATOMS.CAST.SPIN), so the atomics, not the bytes, set the time;
// the design spends registers and threads to issue fewer of them and to
// hide their latency. In registers first, a thread merges the taps of
// consecutive points that land on the same 4 pixels (the same top-left tap
// and the same valid taps), every channel at once: on the upsample grid 4
// consecutive points share their row pair and mostly their column pair,
// so at 4x a group of 4 flushes ~1.75 times instead of 4; a point
// elsewhere simply flushes what is held. The copy is swizzled (swizzle()
// below) so that the lanes of a warp, 4 points apart, hit distinct banks.
// After cluster.sync(), block r sums rows [r*H/S, (r+1)*H/S) over the S
// copies, read through distributed shared memory (map_shared_rank) in rank
// order, and writes them to dimg once, with 16-byte stores where
// W*C % 4 == 0; a last cluster.sync() keeps each copy alive until its peers
// have read it. No global atomic and no memset: the kernel writes every
// element of dimg (the wrapper allocates it with torch.empty), one launch a
// call. The cross-block sum has a fixed order; within a block the shared
// atomics add in an order that varies from run to run, so results may
// differ in the last bits between runs.
//
// S: the largest of 4, 3, 2 and 1 for which every cluster of the call is
// resident at once (cudaOccupancyMaxActiveClusters), else 1. A block's
// zeroing and its share of the reduction are a whole image's whatever S
// is, so more blocks per sample pay only while they fit in one wave. At
// batch 128, C = 1 (2 blocks an SM) that is S = 2: 256 blocks on 132 SMs;
// at C = 2 (1 block an SM) S = 1: 128 blocks, where S = 2 took two waves
// and 1.15x the time on the H100.
//
// Batch stride: u and v are read at u + b * uv_stride, uv_stride = P, or 0
// when one grid serves the whole batch (the upsample): every sample then
// reads the same grid row, from L2 after the first.
//
// Limit: a sample's dimg must fit in one block's shared memory, H*W*C*4
// bytes at most the card's opt-in maximum per block
// (cudaDevAttrMaxSharedMemoryPerBlockOptin, 232,448 bytes, 58,112 floats,
// on the H100), and P at most 2^30. A larger sample takes the generic path,
// bilinear_sample_bwd_img_scatter_kernel: one thread per point adds its 4
// weighted taps (those inside the image) into dimg with global atomicAdd,
// after the entry zeroes dimg (cudaMemsetAsync). No path of the port runs
// it: the largest image K5 sees is 128x128x2 (128 KB).
__global__ void bilinear_sample_bwd_img_scatter_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ g, float* __restrict__ dimg, int h, int w,
    int c, long long p, long long uv_stride, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long b = i / p;
  const long long j = b * uv_stride + (i - b * p);
  const float x = u[j];
  const float y = v[j];
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx1 = x - x0f;
  const float wy1 = y - y0f;
  const float wx0 = 1.0f - wx1;
  const float wy0 = 1.0f - wy1;
  const int x0 = (int)fminf(fmaxf(x0f, -2.0f), (float)w + 1.0f);
  const int y0 = (int)fminf(fmaxf(y0f, -2.0f), (float)h + 1.0f);
  const bool vx0 = x0 >= 0 && x0 < w;
  const bool vx1 = x0 + 1 >= 0 && x0 + 1 < w;
  const bool vy0 = y0 >= 0 && y0 < h;
  const bool vy1 = y0 + 1 >= 0 && y0 + 1 < h;
  float* base = dimg + b * (long long)h * w * c;
  const long long r0 = (long long)y0 * w;
  const long long r1 = (long long)(y0 + 1) * w;
  for (int ci = 0; ci < c; ++ci) {
    const float gc = g[i * c + ci];
    if (vy0 && vx0) atomicAdd(base + (r0 + x0) * c + ci, wy0 * wx0 * gc);
    if (vy0 && vx1) atomicAdd(base + (r0 + x0 + 1) * c + ci, wy0 * wx1 * gc);
    if (vy1 && vx0) atomicAdd(base + (r1 + x0) * c + ci, wy1 * wx0 * gc);
    if (vy1 && vx1) atomicAdd(base + (r1 + x0 + 1) * c + ci, wy1 * wx1 * gc);
  }
}

constexpr int kMaxCluster = 4;
constexpr int kMaxDevices = 64;

// Threads of a K5 block, and its blocks an SM: two blocks of 512 at C = 1
// (64 KB of shared memory each), one of 1024 where one block fills the
// SM's shared memory; 32 warps an SM and at most 64 registers a thread
// either way. The atomics' compare-and-swap loops are latency-bound: on
// the H100, 256 threads at C = 1 took 1.3-1.4x as long as 512 at each
// shape of K5's paths, and 768 at C = 2 1.2x as long as 1024.
template <int kC>
__host__ __device__ constexpr int img_threads() {
  return kC == 1 ? 512 : 1024;
}

template <int kC>
__host__ __device__ constexpr int img_blocks_per_sm() {
  return kC == 1 ? 2 : 1;
}

// The shared copy's layout: value a (pixel * C + channel) lives at
// swizzle(a), its low 5 bits XORed with the next 5. The lanes of a warp
// take consecutive groups of points, so their taps lie 4 * C values apart
// (1:1 warps, the masked loss warp) or 1-2 apart (the upsample), and
// unswizzled those would fall into 32 / (4 * C) of the 32 banks; swizzled,
// every stride up to 32 hits 32 banks. A bijection on whole rows of 32
// values: the copy is rounded up to them.
__device__ __forceinline__ int swizzle(int a) { return a ^ ((a >> 5) & 31); }

// The taps of a point that lie inside the image, as bits 0-3 in TapsC1's
// order (v00, v01, v10, v11).
__device__ __forceinline__ unsigned tap_mask(const TapsC1& t) {
  return (unsigned)t.v00 | ((unsigned)t.v01 << 1) | ((unsigned)t.v10 << 2) |
         ((unsigned)t.v11 << 3);
}

__device__ __forceinline__ void shared_add(float* s, int i, float a) {
  atomicAdd(s + swizzle(i), a);
}

// A group of up to 4 consecutive points of one sample, as loaded: their
// coordinates and (kC > 0) their cotangents, point-major.
template <int kC>
struct PointGroup {
  float x[4], y[4];
  float g[kC > 0 ? 4 * kC : 1];
  int first, n;  // the group's first point, how many of its 4 are below P
};

template <int kC, bool kVec>
__device__ __forceinline__ PointGroup<kC> load_group(
    const float* __restrict__ ub, const float* __restrict__ vb,
    const float* __restrict__ gb, int p, int q) {
  PointGroup<kC> pg;
  pg.first = 4 * q;
  if (kVec) {
    pg.n = 4;
    const float4 uu = __ldg(reinterpret_cast<const float4*>(ub) + q);
    const float4 vv = __ldg(reinterpret_cast<const float4*>(vb) + q);
    pg.x[0] = uu.x; pg.x[1] = uu.y; pg.x[2] = uu.z; pg.x[3] = uu.w;
    pg.y[0] = vv.x; pg.y[1] = vv.y; pg.y[2] = vv.z; pg.y[3] = vv.w;
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const float4 gg =
          __ldg(reinterpret_cast<const float4*>(gb) + q * kC + j);
      pg.g[4 * j] = gg.x; pg.g[4 * j + 1] = gg.y;
      pg.g[4 * j + 2] = gg.z; pg.g[4 * j + 3] = gg.w;
    }
  } else {
    pg.n = min(4, p - pg.first);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool in = k < pg.n;
      const int i = pg.first + k;
      pg.x[k] = in ? __ldg(ub + i) : 0.0f;
      pg.y[k] = in ? __ldg(vb + i) : 0.0f;
#pragma unroll
      for (int ci = 0; ci < kC; ++ci) {
        pg.g[k * kC + ci] = in ? __ldg(gb + (long long)i * kC + ci) : 0.0f;
      }
    }
  }
  return pg;
}

// The cotangent of point k of a group at channel ci.
template <int kC>
__device__ __forceinline__ float group_g(const PointGroup<kC>& pg,
                                         const float* __restrict__ gb, int c,
                                         int k, int ci) {
  if (kC > 0) return pg.g[k * kC + ci];
  return __ldg(gb + (long long)(pg.first + k) * c + ci);
}

// Adds the held taps a[j] (channel c0 + j) onto the pixels (top-left r0,
// its right, below, below right) of the shared copy s, those in mask m.
template <int kHeld>
__device__ __forceinline__ void flush_taps(float* s, int w, int c, int c0,
                                           int r0, unsigned m,
                                           const float4 (&a)[kHeld]) {
  const int i = r0 * c + c0;
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    if (m & 1u) shared_add(s, i + j, a[j].x);
    if (m & 2u) shared_add(s, i + c + j, a[j].y);
    if (m & 4u) shared_add(s, i + w * c + j, a[j].z);
    if (m & 8u) shared_add(s, i + (w + 1) * c + j, a[j].w);
  }
}

// Adds the taps of a group into the shared copy s. The taps of
// consecutive points that land on the same pixels (the same top-left tap
// and the same valid taps) are summed in registers, every channel at once
// where kC > 0 (one channel a pass for any C), and flushed with shared
// atomics when the next point's differ, and at the end.
template <int kC>
__device__ __forceinline__ void add_group(float* s, int h, int w, int c,
                                          const float* __restrict__ gb,
                                          const PointGroup<kC>& pg) {
  constexpr int kHeld = kC > 0 ? kC : 1;
  const int passes = kC > 0 ? 1 : c;
  for (int c0 = 0; c0 < passes; ++c0) {
    float4 a[kHeld];
    int r0 = 0;
    unsigned mk = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < pg.n) {
        const TapsC1 t = taps_c1(h, w, pg.x[k], pg.y[k]);
        const unsigned m = tap_mask(t);
        const float w00 = t.wy0 * t.wx0, w01 = t.wy0 * t.wx1;
        const float w10 = t.wy1 * t.wx0, w11 = t.wy1 * t.wx1;
        const bool same = k > 0 && t.r0 == r0 && m == mk;
        if (k > 0 && !same) flush_taps<kHeld>(s, w, c, c0, r0, mk, a);
#pragma unroll
        for (int j = 0; j < kHeld; ++j) {
          const float gv = group_g<kC>(pg, gb, c, k, c0 + j);
          const float4 b = make_float4(w00 * gv, w01 * gv, w10 * gv, w11 * gv);
          if (same) {
            a[j].x += b.x; a[j].y += b.y; a[j].z += b.z; a[j].w += b.w;
          } else {
            a[j] = b;
          }
        }
        r0 = t.r0;
        mk = m;
      }
    }
    flush_taps<kHeld>(s, w, c, c0, r0, mk, a);
  }
}

// out[j] = v[j ^ r]: a quad of the swizzled copy back in order.
__device__ __forceinline__ float4 unswizzle_quad(float4 v, int r) {
  if (r & 1) v = make_float4(v.y, v.x, v.w, v.z);
  if (r & 2) v = make_float4(v.z, v.w, v.x, v.y);
  return v;
}

// K5: grid N * S blocks in clusters of S (cudaLaunchKernelEx), block rank r
// of cluster b working on sample b; dynamic shared memory H*W*C floats
// rounded up to 32. kC: the channel count (1 or 2), or 0 for any (the
// cotangents then read as the taps are added). kVec: P % 4 == 0 and u, v,
// g 16-byte aligned.
template <int kC, bool kVec>
__global__ void __launch_bounds__(img_threads<kC>(), img_blocks_per_sm<kC>())
bilinear_sample_bwd_img_cluster_kernel(const float* __restrict__ u,
                                       const float* __restrict__ v,
                                       const float* __restrict__ g,
                                       float* __restrict__ dimg, int h, int w,
                                       int c_any, int p,
                                       long long uv_stride) {
  constexpr int kThreads = img_threads<kC>();
  extern __shared__ float4 s4[];
  float* s = reinterpret_cast<float*>(s4);
  cg::cluster_group cluster = cg::this_cluster();
  const int nblocks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / nblocks;
  const int c = kC > 0 ? kC : c_any;
  const int size = h * w * c;
  for (int i = threadIdx.x; i < (size + 31) / 32 * 8; i += kThreads) {
    s4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();

  const float* ub = u + (long long)b * uv_stride;
  const float* vb = v + (long long)b * uv_stride;
  const float* gb = g + (long long)b * p * c;
  const int groups = (p + 3) / 4;
  const int q_end = (int)((long long)groups * (rank + 1) / nblocks);
  // One group a thread ahead: the next group's loads are in flight while
  // this one's taps are added.
  int q = (int)((long long)groups * rank / nblocks) + threadIdx.x;
  PointGroup<kC> cur;
  if (q < q_end) cur = load_group<kC, kVec>(ub, vb, gb, p, q);
  while (q < q_end) {
    const int qn = q + kThreads;
    PointGroup<kC> next;
    next.n = 0;
    if (qn < q_end) next = load_group<kC, kVec>(ub, vb, gb, p, qn);
    add_group<kC>(s, h, w, c, gb, cur);
    cur = next;
    q = qn;
  }
  cluster.sync();

  // Block r's band of rows, summed over the S copies in rank order.
  const int lo = (int)((long long)h * rank / nblocks) * w * c;
  const int hi = (int)((long long)h * (rank + 1) / nblocks) * w * c;
  float* out = dimg + (long long)b * size;
  const float* peer[kMaxCluster];
#pragma unroll
  for (int k = 0; k < kMaxCluster; ++k) {
    peer[k] = k < nblocks ? cluster.map_shared_rank(s, k) : s;
  }
  if ((w * c) % 4 == 0 && (reinterpret_cast<uintptr_t>(dimg) & 15) == 0) {
    // Values 4t..4t+3 lie in one row of 32 of the copy, as a quad
    // permuted by the row's swizzle.
    for (int t4 = lo / 4 + threadIdx.x; t4 < hi / 4; t4 += kThreads) {
      const int a = 4 * t4;
      const int m = (a >> 5) & 31;
      const int at = (a ^ (m & 28)) >> 2;
      float4 acc = reinterpret_cast<const float4*>(peer[0])[at];
#pragma unroll
      for (int k = 1; k < kMaxCluster; ++k) {
        if (k < nblocks) {
          const float4 o = reinterpret_cast<const float4*>(peer[k])[at];
          acc.x += o.x; acc.y += o.y; acc.z += o.z; acc.w += o.w;
        }
      }
      reinterpret_cast<float4*>(out)[t4] = unswizzle_quad(acc, m & 3);
    }
  } else {
    for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
      const int at = swizzle(i);
      float acc = peer[0][at];
#pragma unroll
      for (int k = 1; k < kMaxCluster; ++k) {
        if (k < nblocks) acc += peer[k][at];
      }
      out[i] = acc;
    }
  }
  cluster.sync();
}

// The cluster kernel's launch for one call: its configuration (S blocks a
// cluster, S from the rule of the note above unless `cluster` forces it).
template <int kC, bool kVec>
int launch_bwd_img_cluster(const float* u, const float* v, const float* g,
                           float* dimg, int n, int h, int w, int c, int p,
                           long long uv_stride, int cluster, int dev,
                           int optin_bytes, int* chosen,
                           cudaStream_t stream) {
  auto kernel = bilinear_sample_bwd_img_cluster_kernel<kC, kVec>;
  const size_t bytes = (size_t)((h * w * c + 31) / 32 * 32) * sizeof(float);
  // The attribute once per device; the rule's S per (device, shape) seen.
  static std::mutex mu;
  static bool attr_set[kMaxDevices] = {};
  static std::map<std::tuple<int, size_t, int>, int> rule;
  std::lock_guard<std::mutex> lock(mu);
  cudaError_t err = cudaSuccess;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin_bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = true;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(img_threads<kC>());
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int s = cluster;
  if (s == 0) {
    const auto key = std::make_tuple(dev, bytes, n);
    const auto found = rule.find(key);
    if (found != rule.end()) {
      s = found->second;
    } else {
      s = 1;
      for (int cand = 4; cand >= 1; --cand) {
        attr.val.clusterDim.x = cand;
        cfg.gridDim = dim3((unsigned)(n * cand));
        int active = 0;
        err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
        if (err != cudaSuccess) return (int)err;
        if (active >= n) {
          s = cand;
          break;
        }
      }
      rule[key] = s;
    }
  }
  *chosen = s;
  attr.val.clusterDim.x = s;
  cfg.gridDim = dim3((unsigned)(n * s));
  err = cudaLaunchKernelEx(&cfg, kernel, u, v, g, dimg, h, w, c, p,
                           uv_stride);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// img [N,H,W,C], u/v [N,P], g [N,P,C] -> du/dv [N,P].
extern "C" int bilinear_sample_bwd_uv(const float* img, const float* u,
                                      const float* v, const float* g,
                                      float* du, float* dv, int n, int h,
                                      int w, int c, long long p,
                                      void* stream) {
  const long long total = (long long)n * p;
  if (total == 0) return 0;
  if (c1_path(n, h, w, c, p)) {
    const bool vec = p % 2 == 0 && (((uintptr_t)u | (uintptr_t)v |
                                     (uintptr_t)g | (uintptr_t)du |
                                     (uintptr_t)dv) & 7) == 0;
    auto kernel = vec ? bilinear_sample_bwd_uv_c1_kernel<true>
                      : bilinear_sample_bwd_uv_c1_kernel<false>;
    kernel<<<c1_grid(n, p), kC1Threads, 0, (cudaStream_t)stream>>>(
        img, u, v, g, du, dv, h, w, (int)p);
    return (int)cudaGetLastError();
  }
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  bilinear_sample_bwd_uv_kernel<<<(unsigned)blocks, threads, 0,
                                  (cudaStream_t)stream>>>(
      img, u, v, g, du, dv, h, w, c, p, total);
  return (int)cudaGetLastError();
}

// u/v [N,P] at batch stride uv_stride (P, or 0: one grid row for the whole
// batch), g [N,P,C] -> dimg [N,H,W,C], every element written. cluster: the
// blocks of a sample's cluster (1-4), or 0 for the rule of K5's note.
// *chosen: the S that ran, 0 where the generic path did.
extern "C" int bilinear_sample_bwd_img(const float* u, const float* v,
                                       const float* g, float* dimg, int n,
                                       int h, int w, int c, long long p,
                                       long long uv_stride, int cluster,
                                       int* chosen, void* stream) {
  *chosen = 0;
  if (cluster < 0 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  const long long size = (long long)h * w * c;
  if (n == 0 || size == 0) return 0;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if ((size + 31) / 32 * 32 * (long long)sizeof(float) <= optin &&
      p <= (1LL << 30) &&
      (long long)n * kMaxCluster < (1LL << 31) && dev < kMaxDevices) {
    const bool vec = p % 4 == 0 &&
                     (((uintptr_t)u | (uintptr_t)v | (uintptr_t)g) & 15) == 0;
    auto launch = c == 1   ? (vec ? launch_bwd_img_cluster<1, true>
                                  : launch_bwd_img_cluster<1, false>)
                  : c == 2 ? (vec ? launch_bwd_img_cluster<2, true>
                                  : launch_bwd_img_cluster<2, false>)
                           : (vec ? launch_bwd_img_cluster<0, true>
                                  : launch_bwd_img_cluster<0, false>);
    return launch(u, v, g, dimg, n, h, w, c, (int)p, uv_stride, cluster, dev,
                  optin, chosen, (cudaStream_t)stream);
  }
  err = cudaMemsetAsync(dimg, 0, (size_t)(n * size) * sizeof(float),
                        (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)n * p;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  bilinear_sample_bwd_img_scatter_kernel<<<(unsigned)blocks, threads, 0,
                                           (cudaStream_t)stream>>>(
      u, v, g, dimg, h, w, c, p, uv_stride, total);
  return (int)cudaGetLastError();
}

// img [N,H,W,C], u/v [N,P] -> out [N,P,C].
extern "C" int bilinear_sample(const float* img, const float* u,
                               const float* v, float* out, int n, int h,
                               int w, int c, long long p, void* stream) {
  const long long total = (long long)n * p;
  if (total == 0) return 0;
  if (c1_path(n, h, w, c, p)) {
    const bool vec =
        p % 2 == 0 &&
        (((uintptr_t)u | (uintptr_t)v | (uintptr_t)out) & 7) == 0;
    auto kernel = vec ? bilinear_sample_c1_kernel<true>
                      : bilinear_sample_c1_kernel<false>;
    kernel<<<c1_grid(n, p), kC1Threads, 0, (cudaStream_t)stream>>>(
        img, u, v, out, h, w, (int)p);
    return (int)cudaGetLastError();
  }
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  bilinear_sample_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(img, u, v, out, h, w, c,
                                                   p, total);
  return (int)cudaGetLastError();
}
