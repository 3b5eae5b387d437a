// The first design of the weighted-CE backward (K4): one thread per
// pixel, its row in registers, a grid capped at 1024 blocks. The port
// does not call it. It is kept so that chip_smoke.py can time the
// redesign in fused_ce.cu beside it, in turns, within one run;
// fused_ce.cu's header says what held it back.
//
// Replaces the Pallas TPU kernel `_ce_bwd_kernel` of
// cvcs_tpu/ops/pallas_ce.py:76-85 with the semantics fused_ce.cu states.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxClasses = 32;
constexpr int kMaxBlocks = 1024;

template <bool kVec4>
__device__ __forceinline__ void load_row(const float* __restrict__ row, int C,
                                         float (&v)[kMaxClasses]) {
  if (kVec4) {
#pragma unroll
    for (int q = 0; q < kMaxClasses / 4; ++q) {
      if (4 * q < C) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(row) + q);
        v[4 * q] = t.x;
        v[4 * q + 1] = t.y;
        v[4 * q + 2] = t.z;
        v[4 * q + 3] = t.w;
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < kMaxClasses; ++c) {
      if (c < C) v[c] = __ldg(row + c);
    }
  }
}

__device__ __forceinline__ float row_max(const float (&v)[kMaxClasses], int C) {
  float m = v[0];
#pragma unroll
  for (int c = 1; c < kMaxClasses; ++c) {
    if (c < C) m = fmaxf(m, v[c]);
  }
  return m;
}

__device__ __forceinline__ float label_weight(const float* __restrict__ w,
                                              int label, int C) {
  return (label >= 0 && label < C) ? __ldg(w + label) : 0.f;
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads) ce_bwd_v1(
    const float* __restrict__ logits, const int* __restrict__ labels,
    const float* __restrict__ w, const float* __restrict__ g,
    const float* __restrict__ wsum, float* __restrict__ dlogits, long long N,
    int C) {
  const float scale = __ldg(g) / fmaxf(__ldg(wsum), 1e-12f);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x; p < N;
       p += stride) {
    const int label = __ldg(labels + p);
    const float wl = label_weight(w, label, C);
    float* out = dlogits + p * C;
    float v[kMaxClasses];
    if (wl == 0.f) {
#pragma unroll
      for (int c = 0; c < kMaxClasses; ++c) v[c] = 0.f;
    } else {
      load_row<kVec4>(logits + p * C, C, v);
      const float m = row_max(v, C);
      float e = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxClasses; ++c) {
        if (c < C) {
          v[c] = expf(v[c] - m);
          e += v[c];
        }
      }
      const float coef = wl * scale;
#pragma unroll
      for (int c = 0; c < kMaxClasses; ++c) {
        if (c < C) v[c] = (v[c] / e - (c == label ? 1.f : 0.f)) * coef;
      }
    }
    if (kVec4) {
#pragma unroll
      for (int q = 0; q < kMaxClasses / 4; ++q) {
        if (4 * q < C) {
          reinterpret_cast<float4*>(out)[q] =
              make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < kMaxClasses; ++c) {
        if (c < C) out[c] = v[c];
      }
    }
  }
}

int grid_for(long long N) {
  const long long blocks = (N + kThreads - 1) / kThreads;
  return (int)(blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks));
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// The arguments of cvcs_ce_bwd in fused_ce.cu.
extern "C" int cvcs_ce_bwd_v1(const void* logits, const void* labels,
                              const void* weights, const void* g,
                              const void* wsum, void* dlogits, long long N,
                              int C, void* stream) {
  if (N < 0 || C < 1 || C > kMaxClasses) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = grid_for(N);
  const float* x = static_cast<const float*>(logits);
  const int* l = static_cast<const int*>(labels);
  const float* w = static_cast<const float*>(weights);
  const float* gp = static_cast<const float*>(g);
  const float* ws = static_cast<const float*>(wsum);
  float* dx = static_cast<float*>(dlogits);
  if (C % 4 == 0 && aligned16(logits) && aligned16(dlogits)) {
    ce_bwd_v1<true><<<grid, kThreads, 0, st>>>(x, l, w, gp, ws, dx, N, C);
  } else {
    ce_bwd_v1<false><<<grid, kThreads, 0, st>>>(x, l, w, gp, ws, dx, N, C);
  }
  return (int)cudaGetLastError();
}
