// The first design of the fused augmentation (K5): one 1024-thread block
// per patch, the grayscale sum and the transform each reading the patch
// from device memory. The port does not call it. It is kept so that
// chip_smoke.py can time the redesign in augment.cu beside it, in turns,
// within one run; augment.cu's header says what held it back.
//
// Replaces the Pallas TPU kernel `fused_augment` / `_augment_kernel` of
// cvcs_tpu/ops/pallas_augment.py, with the semantics augment.cu states,
// except that the grayscale mean is the f32 sum divided by P*P.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads) augment_kernel_v1(
    const uint8_t* __restrict__ img, const int* __restrict__ flips,
    const int* __restrict__ rots, const float* __restrict__ factors,
    const float* __restrict__ band_mean, const float* __restrict__ band_std,
    float* __restrict__ out, int P, int C) {
  __shared__ float partial[kThreads / 32];
  __shared__ float gray_mean;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int npix = P * P;
  const uint8_t* src = img + (size_t)b * npix * C;
  float* dst = out + (size_t)b * npix * C;
  const int c1 = 1 % C;
  const int c2 = 2 % C;

  // 1. mean of the floored grayscale (exact: integer terms, sums < 2^24)
  float s = 0.f;
  for (int i = tid; i < npix; i += kThreads) {
    const uint8_t* px = src + (size_t)i * C;
    const float gray =
        __fadd_rn(__fadd_rn(__fmul_rn(0.2989f, (float)px[0]),
                            __fmul_rn(0.587f, (float)px[c1])),
                  __fmul_rn(0.114f, (float)px[c2]));
    s += floorf(gray);
  }
  s = warp_sum(s);
  if ((tid & 31) == 0) partial[tid >> 5] = s;
  __syncthreads();
  if (tid < 32) {
    float t = tid < kThreads / 32 ? partial[tid] : 0.f;
    t = warp_sum(t);
    if (tid == 0) gray_mean = t / (float)npix;
  }
  __syncthreads();

  // 2. dihedral transform on the load, blend, clip, floor, normalise
  const float f = factors[b];
  const float blend = __fmul_rn(__fsub_rn(1.f, f), gray_mean);
  const int fl = flips[b];
  int k = rots[b];
  k = k < 0 ? 0 : (k > 3 ? 3 : k);
  const int pm = P - 1;
  for (int i = tid; i < npix; i += kThreads) {
    const int y = i / P;
    const int x = i - y * P;
    int sy, sx;
    if (k == 0) {
      sy = y; sx = x;
    } else if (k == 1) {
      sy = x; sx = pm - y;
    } else if (k == 2) {
      sy = pm - y; sx = pm - x;
    } else {
      sy = pm - x; sx = y;
    }
    if (fl & 2) sy = pm - sy;
    if (fl & 1) sx = pm - sx;
    const uint8_t* px = src + ((size_t)sy * P + sx) * C;
    float* o = dst + (size_t)i * C;
    for (int c = 0; c < C; ++c) {
      float v = __fadd_rn(__fmul_rn(f, (float)px[c]), blend);
      v = floorf(fminf(fmaxf(v, 0.f), 255.f));
      o[c] = __fdiv_rn(__fsub_rn(v, band_mean[c]), band_std[c]);
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. images (B, P, P, C) uint8;
// flips, rots (B,) int32; factors (B,) f32; band_mean, band_std (C,) f32;
// out (B, P, P, C) f32. Returns a cudaError_t (0 = launched).
extern "C" int cvcs_fused_augment_v1(const void* images, const void* flips,
                                     const void* rots, const void* factors,
                                     const void* band_mean,
                                     const void* band_std, void* out, int B,
                                     int P, int C, void* stream) {
  if (B < 1 || P < 1 || C < 1) return (int)cudaErrorInvalidValue;
  augment_kernel_v1<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(images), static_cast<const int*>(flips),
      static_cast<const int*>(rots), static_cast<const float*>(factors),
      static_cast<const float*>(band_mean),
      static_cast<const float*>(band_std), static_cast<float*>(out), P, C);
  return (int)cudaGetLastError();
}
