// Fused weighted softmax cross-entropy, forward sums (K3) and backward (K4),
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of cvcs_tpu/ops/pallas_ce.py, both
// launched through `_grid_call`:
//   K3, `_ce_fwd_kernel` (:52-73): S = sum_p w[l_p] * (lse_p - x_p[l_p])
//       and W = sum_p w[l_p] over all pixels p; the loss is
//       S / max(W, 1e-12);
//   K4, `_ce_bwd_kernel` (:76-85): dx_p = (softmax(x_p) - onehot(l_p)) *
//       w[l_p] * g / max(W, 1e-12).
// w is the effective class weight vector (the caller zeroes the ignored
// class); a label outside [0, C) has weight 0 and never indexes w (this
// covers 255-coded void and -1).
//
// Layout. The TPU kernel transposes the logits to class-major (C, N) and
// pads N to its tile with ignored pixels so that classes sit in sublanes.
// Here the NHWC logits are read in place: pixel-major (N, C), C contiguous
// f32 per pixel (64 bytes at C = 16), C <= 32. A bounds check replaces the
// padding.
//
// What bounds both on the H100: memory. With N_w pixels of nonzero weight,
// K3 reads 4*N_w*C + 4*N bytes and does about 5 operations per logit read;
// K4 also writes 4*N*C bytes (56 MB at the Unetv2 recipe step's
// 10 x 224 x 224 x 16 logits: 0.0168 ms at 3.35 TB/s). Neither reads the
// logits of a weight-0 pixel (ignored class, void label): K3 skips it, K4
// writes its zero row. Accurate expf/logf (no --use_fast_math): the f32
// tolerances against the plain version depend on it.
//
// K3 (`ce_fwd_partials`, `ce_fwd_finish`): one thread per pixel, the row
// held in registers and loaded as float4 when C is a multiple of 4. The
// TPU kernel adds into one (1, 1) block across its in-order grid; CUDA
// blocks run in no order. Here each block reduces its pixels (a fixed
// grid-stride assignment, then a fixed shuffle tree) to one (S, W)
// partial, and a second one-block kernel adds the partials in index order
// and writes S, W and the loss. No atomics: repeats are bit-equal. The
// loss stays on the device.
//
// K4 (`ce_bwd_groups`), redesigned for Hopper. It reads g and W from
// device memory (no host synchronisation), writes exact zero rows for
// weight-0 pixels, and recomputes the softmax from the logits instead of
// storing it in the forward. What held the first design back
// (fused_ce_v1.cu, one thread per pixel, like K3): each warp-wide load or
// store touched 32 rows 64 bytes apart, every 32-byte sector half used
// per instruction; label, weight and row were three dependent round trips;
// a grid capped at 1024 blocks left each thread two pixels in turn, so
// few rows were in flight; weight-0 rows took the same per-thread loop.
// This design:
// * A group of G = C/4 lanes per pixel (rounded up to a power of two),
//   each lane one float4 of the row: one warp instruction reads or writes
//   32/G whole rows, 512 contiguous bytes at C = 16. The row max and sum
//   go across the group with __shfl_xor_sync in a fixed tree, so a row's
//   result never depends on the grid, and repeats are bit-equal.
// * Labels read ahead: one coalesced 128-byte load per warp and 32
//   pixels, handed to the lane groups by shuffles; the weights staged in
//   shared memory. Then each lane issues the loads of kRows rows before it
//   uses any, so kRows loads are in flight per thread; a weight-0 row
//   loads nothing and stores zeros.
// * A persistent grid sized from the SM count and the kernel's occupancy;
//   each warp walks tiles of pixels.
// * C off 4, or logits or dlogits not 16-byte aligned: the same kernel
//   with one float per lane and G = C rounded up to a power of two.

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

// K4. kVec floats per lane (4: float4 rows, C % 4 == 0 and aligned; 1:
// any C), kGroup lanes per pixel (a power of two >= C / kVec).
template <int kVec, int kGroup>
__global__ void __launch_bounds__(kThreads) ce_bwd_groups(
    const float* __restrict__ logits, const int* __restrict__ labels,
    const float* __restrict__ w, const float* __restrict__ g,
    const float* __restrict__ wsum, float* __restrict__ dlogits, long long N,
    int C) {
  constexpr int kRows = kVec == 4 ? 4 : 8;      // row loads in flight a lane
  constexpr int kStep = 32 / kGroup;            // pixels per warp instruction
  constexpr int kTile = kRows * kStep;          // pixels per warp iteration
  constexpr int kLab = (kTile + 31) / 32;       // label registers a lane
  __shared__ float ws[kMaxClasses];
  if (threadIdx.x < C) ws[threadIdx.x] = w[threadIdx.x];
  __syncthreads();
  const float scale = __ldg(g) / fmaxf(__ldg(wsum), 1e-12f);
  const int lane = threadIdx.x & 31;
  const int q = lane % kGroup;                  // this lane's slice of a row
  const int sub = lane / kGroup;                // its pixel within a step
  const int c0 = q * kVec;                      // its first class
  const bool active = c0 < C;
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  for (long long tile = (long long)blockIdx.x * (kThreads / 32) +
                        (threadIdx.x >> 5);
       tile * kTile < N; tile += warps) {
    const long long base = tile * kTile;
    int lab[kLab];
#pragma unroll
    for (int k = 0; k < kLab; ++k) {
      const long long p = base + lane + 32 * k;
      lab[k] = (lane + 32 * k < kTile && p < N) ? __ldg(labels + p) : -1;
    }
    float v[kRows][kVec];
    int lj[kRows];
    float wl[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int i = j * kStep + sub;            // pixel within the tile
      lj[j] = __shfl_sync(0xffffffffu, lab[j / kGroup], i & 31);
      wl[j] = (lj[j] >= 0 && lj[j] < C) ? ws[lj[j]] : 0.f;
      const float* row = logits + (base + i) * C + c0;
      if (wl[j] != 0.f && active) {
        if constexpr (kVec == 4) {
          const float4 t = __ldg(reinterpret_cast<const float4*>(row));
          v[j][0] = t.x;
          v[j][1] = t.y;
          v[j][2] = t.z;
          v[j][3] = t.w;
        } else {
          v[j][0] = __ldg(row);
        }
      } else {
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          v[j][c] = wl[j] != 0.f ? -INFINITY : 0.f;   // -inf: a lane past C
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      float m = v[j][0];
#pragma unroll
      for (int c = 1; c < kVec; ++c) m = fmaxf(m, v[j][c]);
#pragma unroll
      for (int o = kGroup / 2; o > 0; o >>= 1) {
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      }
      float e = 0.f;
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        v[j][c] = expf(v[j][c] - m);
        e += v[j][c];
      }
#pragma unroll
      for (int o = kGroup / 2; o > 0; o >>= 1) {
        e += __shfl_xor_sync(0xffffffffu, e, o);
      }
      const float coef = wl[j] * scale;
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        v[j][c] = wl[j] == 0.f
                      ? 0.f
                      : (v[j][c] / e - (c0 + c == lj[j] ? 1.f : 0.f)) * coef;
      }
      const long long p = base + j * kStep + sub;
      if (p < N && active) {
        float* out = dlogits + p * C + c0;
        if constexpr (kVec == 4) {
          *reinterpret_cast<float4*>(out) =
              make_float4(v[j][0], v[j][1], v[j][2], v[j][3]);
        } else {
          out[0] = v[j][0];
        }
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

struct BwdArgs {
  const float* x;
  const int* l;
  const float* w;
  const float* g;
  const float* ws;
  float* dx;
  long long N;
  int C;
  cudaStream_t st;
};

// K4's persistent grid: as many blocks as the card holds at once (SM count
// times the instance's occupancy, looked up once per device), fewer when N
// has fewer tiles.
template <int kVec, int kGroup>
int launch_bwd(const BwdArgs& a) {
  constexpr int kMaxDevices = 64;
  static int resident[kMaxDevices];   // 0: not looked up yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int blocks = dev < kMaxDevices ? resident[dev] : 0;
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ce_bwd_groups<kVec, kGroup>, kThreads, 0);
    }
    if (err != cudaSuccess) return (int)err;
    blocks = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < kMaxDevices) resident[dev] = blocks;
  }
  constexpr long long kTilePixels =
      (long long)(kVec == 4 ? 4 : 8) * (32 / kGroup) * (kThreads / 32);
  const long long need = (a.N + kTilePixels - 1) / kTilePixels;
  const int grid = (int)(need < blocks ? need : blocks);
  ce_bwd_groups<kVec, kGroup><<<grid, kThreads, 0, a.st>>>(
      a.x, a.l, a.w, a.g, a.ws, a.dx, a.N, a.C);
  return (int)cudaGetLastError();
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
  const bool vec4 = C % 4 == 0 && aligned16(logits) && aligned16(dlogits);
  const int lanes = vec4 ? C / 4 : C;
  const int group = lanes <= 1 ? 1 : lanes <= 2 ? 2 : lanes <= 4 ? 4
                  : lanes <= 8 ? 8 : lanes <= 16 ? 16 : 32;
  const BwdArgs a{static_cast<const float*>(logits),
                  static_cast<const int*>(labels),
                  static_cast<const float*>(weights),
                  static_cast<const float*>(g),
                  static_cast<const float*>(wsum),
                  static_cast<float*>(dlogits), N, C,
                  static_cast<cudaStream_t>(stream)};
  if (vec4) {
    switch (group) {
      case 1: return launch_bwd<4, 1>(a);
      case 2: return launch_bwd<4, 2>(a);
      case 4: return launch_bwd<4, 4>(a);
      default: return launch_bwd<4, 8>(a);
    }
  }
  switch (group) {
    case 1: return launch_bwd<1, 1>(a);
    case 2: return launch_bwd<1, 2>(a);
    case 4: return launch_bwd<1, 4>(a);
    case 8: return launch_bwd<1, 8>(a);
    case 16: return launch_bwd<1, 16>(a);
    default: return launch_bwd<1, 32>(a);
  }
}
