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

#include <cuda_runtime.h>

#include <cstdint>

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

// ---------------------------------------------------------------------------
// Backward with respect to the image (K5): replaces
// bihome_tpu/ops/warp_pallas.py:_bwd_img_kernel,
//
//   dimg[b,h,w,c] = sum_p wy[p,h] * wx[p,w] * g[b,p,c],
//
// which the TPU kernel contracts on the matrix unit with the sum carried
// across its sequential grid. Here it is the scatter form: one thread per
// point adds its 4 weighted taps (those inside the image) into dimg, NHWC
// like K3's input, with atomicAdd. The wrapper zeroes dimg first. The
// order of the atomics changes from run to run, so the float sums differ
// in their last bits between runs. Bound on the H100: bytes (dimg written
// and read back by the atomics, u, v, g read). It runs where the sampled
// image takes a gradient: the biHomE loss's upsample-patch-{2,4}x
// strategies (the warped patches upsampled 4 or 16 points per pixel), its
// MASK_KEYS masks (C = 2, riding with the patch) and the TripletHead's
// learned masks (FIX_MASK false); the shipped configs warp only data.
__global__ void bilinear_sample_bwd_img_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ g, float* __restrict__ dimg, int h, int w,
    int c, long long p, long long total) {
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

// u/v [N,P], g [N,P,C] -> dimg [N,H,W,C] += the scattered taps (the caller
// passes it zeroed).
extern "C" int bilinear_sample_bwd_img(const float* u, const float* v,
                                       const float* g, float* dimg, int n,
                                       int h, int w, int c, long long p,
                                       void* stream) {
  const long long total = (long long)n * p;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  bilinear_sample_bwd_img_kernel<<<(unsigned)blocks, threads, 0,
                                   (cudaStream_t)stream>>>(
      u, v, g, dimg, h, w, c, p, total);
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
