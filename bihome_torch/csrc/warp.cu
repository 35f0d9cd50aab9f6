// Bilinear sampling with zero padding, batched: images [N,H,W,C] (NHWC,
// float32) sampled at P points per image -> out [N,P,C].
//
// Replaces the TPU kernel bihome_tpu/ops/warp_pallas.py:_fwd_kernel (driven
// by _forward and tent_sample_batched), which computes the same function as
// two tent-weight contractions so the TPU matrix unit does the work. On
// Hopper that contraction would spend H+W multiply-adds per point; this is
// the 4-tap gather of bihome_tpu/geometry.py:bilinear_sample instead, one
// thread per point, each tap zero outside the image.
//
// Bound on the H100: bytes. At the eval datagen shape (N=64 windows of
// 192x192x1, P=16384) the call must move ~22 MB (image read once, u/v read,
// output written) against ~20 flops per point, so it is a few microseconds
// of HBM traffic. Neighbouring threads take neighbouring points, so u/v
// loads and output stores coalesce; the taps are gathers that mostly hit
// L1/L2 because neighbouring points map to neighbouring pixels.
//
// floorf, not an integer cast, gives the top-left tap: coordinates go
// negative near the border and a cast rounds toward zero.

#include <cuda_runtime.h>

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
// write du and dv, ~50 MB (~15 us), against ~30 flops per point. One thread
// per point; neighbouring threads take neighbouring points, so the point
// arrays coalesce and the taps mostly hit L1/L2.
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
// and read back by the atomics, u, v, g read); zeng training never asks for
// this gradient, because the sampled patches are data.
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

}  // namespace

// img [N,H,W,C], u/v [N,P], g [N,P,C] -> du/dv [N,P].
extern "C" int bilinear_sample_bwd_uv(const float* img, const float* u,
                                      const float* v, const float* g,
                                      float* du, float* dv, int n, int h,
                                      int w, int c, long long p,
                                      void* stream) {
  const long long total = (long long)n * p;
  if (total == 0) return 0;
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

extern "C" int bilinear_sample(const float* img, const float* u,
                               const float* v, float* out, int n, int h,
                               int w, int c, long long p, void* stream) {
  const long long total = (long long)n * p;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  bilinear_sample_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(img, u, v, out, h, w, c,
                                                   p, total);
  return (int)cudaGetLastError();
}
