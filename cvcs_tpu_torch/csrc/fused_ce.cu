// Fused weighted softmax cross-entropy, forward sums (K3) and backward (K4),
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of cvcs_tpu/ops/pallas_ce.py, both
// launched through `_grid_call`:
//   K3, `_ce_fwd_kernel`: S = sum_p w[l_p] * (lse_p - x_p[l_p]) and
//       W = sum_p w[l_p] over all pixels p; the loss is S / max(W, 1e-12);
//   K4, `_ce_bwd_kernel`: dx_p = (softmax(x_p) - onehot(l_p)) * w[l_p] * g
//       / max(W, 1e-12).
// w is the effective class weight vector (the caller zeroes the ignored
// class); a label outside [0, C) has weight 0 and never indexes w (this
// covers 255-coded void and -1).
//
// Layout. The TPU kernel transposes the logits to class-major (C, N) and
// pads N to its tile with ignored pixels so that classes sit in sublanes.
// Here the NHWC logits are read in place: pixel-major (N, C), C contiguous
// f32 per pixel (64 bytes at C = 16), one thread per pixel, the row held
// in registers (C <= 32) and loaded as float4 when C is a multiple of 4.
// A bounds check replaces the padding.
//
// K3's sum. The TPU kernel adds into one (1, 1) block across its in-order
// grid; CUDA blocks run in no order. Here each block reduces its pixels
// (a fixed grid-stride assignment, then a fixed shuffle tree) to one
// (S, W) partial, and a second one-block kernel adds the partials in
// index order and writes S, W and the loss. No atomics: repeats are
// bit-equal. The loss stays on the device.
//
// K4 reads g and W from device memory (no host synchronisation), writes
// exact zero rows for weight-0 pixels, and recomputes the softmax from the
// logits instead of storing it in the forward.
//
// Neither kernel reads the logits of a weight-0 pixel (ignored class, void
// label): K3 skips it, K4 writes its zero row.
//
// What bounds both on the H100: memory. With N_w pixels of nonzero weight,
// K3 reads 4*N_w*C + 4*N bytes and does about 5 operations per logit read;
// K4 also writes 4*N*C bytes. Accurate
// expf/logf (no --use_fast_math): the f32 tolerances against the plain
// version depend on it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxClasses = 32;
constexpr int kMaxBlocks = 1024;   // first-pass partials

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

__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kThreads / 32];
  __shared__ float sb[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = threadIdx.x < kThreads / 32 ? sa[threadIdx.x] : 0.f;
    b = threadIdx.x < kThreads / 32 ? sb[threadIdx.x] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
  }
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads) ce_fwd_partials(
    const float* __restrict__ logits, const int* __restrict__ labels,
    const float* __restrict__ w, float2* __restrict__ partials, long long N,
    int C) {
  float s = 0.f, ws = 0.f;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x; p < N;
       p += stride) {
    const int label = __ldg(labels + p);
    const float wl = label_weight(w, label, C);
    if (wl == 0.f) continue;   // adds nothing: its row is never read
    float v[kMaxClasses];
    load_row<kVec4>(logits + p * C, C, v);
    const float m = row_max(v, C);
    float e = 0.f, t = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxClasses; ++c) {
      if (c < C) {
        e += expf(v[c] - m);
        if (c == label) t = v[c];
      }
    }
    s += wl * (logf(e) + m - t);
    ws += wl;
  }
  block_sum2(s, ws);
  if (threadIdx.x == 0) partials[blockIdx.x] = make_float2(s, ws);
}

__global__ void __launch_bounds__(kThreads) ce_fwd_finish(
    const float2* __restrict__ partials, int n_partials,
    float* __restrict__ loss_sum, float* __restrict__ wsum,
    float* __restrict__ loss) {
  float s = 0.f, ws = 0.f;
  for (int i = threadIdx.x; i < n_partials; i += kThreads) {
    const float2 v = partials[i];
    s += v.x;
    ws += v.y;
  }
  block_sum2(s, ws);
  if (threadIdx.x == 0) {
    *loss_sum = s;
    *wsum = ws;
    *loss = s / fmaxf(ws, 1e-12f);
  }
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads) ce_bwd(
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

// Plain C entry points, loaded with ctypes. logits (N, C) f32 contiguous;
// labels (N,) int32; weights (C,) f32, the ignored class already zeroed.
// Each returns a cudaError_t (0 = launched).

// Bytes of first-pass workspace K3 needs for N pixels.
extern "C" long long cvcs_ce_workspace(long long N) {
  return (long long)grid_for(N) * (long long)sizeof(float2);
}

// K3: loss_sum, wsum and loss are 0-d f32 device tensors.
extern "C" int cvcs_ce_fwd(const void* logits, const void* labels,
                           const void* weights, void* workspace,
                           void* loss_sum, void* wsum, void* loss,
                           long long N, int C, void* stream) {
  if (N < 0 || C < 1 || C > kMaxClasses) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = grid_for(N);
  const float* x = static_cast<const float*>(logits);
  const int* l = static_cast<const int*>(labels);
  const float* w = static_cast<const float*>(weights);
  float2* part = static_cast<float2*>(workspace);
  if (C % 4 == 0 && aligned16(logits)) {
    ce_fwd_partials<true><<<grid, kThreads, 0, st>>>(x, l, w, part, N, C);
  } else {
    ce_fwd_partials<false><<<grid, kThreads, 0, st>>>(x, l, w, part, N, C);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ce_fwd_finish<<<1, kThreads, 0, st>>>(part, grid, static_cast<float*>(loss_sum),
                                        static_cast<float*>(wsum),
                                        static_cast<float*>(loss));
  return (int)cudaGetLastError();
}

// K4: g (the loss's incoming gradient) and wsum are 0-d f32 device
// tensors; dlogits (N, C) f32.
extern "C" int cvcs_ce_bwd(const void* logits, const void* labels,
                           const void* weights, const void* g,
                           const void* wsum, void* dlogits, long long N, int C,
                           void* stream) {
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
    ce_bwd<true><<<grid, kThreads, 0, st>>>(x, l, w, gp, ws, dx, N, C);
  } else {
    ce_bwd<false><<<grid, kThreads, 0, st>>>(x, l, w, gp, ws, dx, N, C);
  }
  return (int)cudaGetLastError();
}
