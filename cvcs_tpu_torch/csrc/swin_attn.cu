// Swin fused window attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_pallas` / `_make_kernel` of
// cvcs_tpu/ops/pallas_swin.py. One launch computes the pre-MLP half of a
// Swin block over the rolled, window-padded map x (B, Hp, Wp, C):
//
//   LayerNorm (f32 stats, fast variance, eps 1e-6) -> x Wqkv + bqkv ->
//   per window and head softmax(q k^T / sqrt(d) + bias) v -> x Wout + bout
//
// with the casting points of the TPU kernel: the LN output, the QKV
// projection, the softmax probabilities and each head's output are rounded
// to the element type E; every product is accumulated in f32.
//
// Design: one thread block per (image, window). A window holds T <= 64
// tokens, so the block loops over the heads with every operand of one head
// in shared memory; each window's output is written by exactly one block
// (no atomics, deterministic). The LN is recomputed while each K-chunk of
// the QKV product is staged, so shared memory stays small whatever C is
// (63 KB at head dim 32) and several blocks share an SM. The merged head
// outputs go to a global scratch the caller allocates (B*nWin*T*C
// elements), which stays in L2 between the head loop and the output
// projection. All products run on the CUDA cores in f32; at the main
// path's shapes the work is bound by operations, and tensor cores (mma /
// wgmma) are the step that would move it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 thread grid
constexpr int kMaxT = 64;      // tokens per window (win <= 8)
constexpr int kKC = 32;        // K chunk of the staged products
constexpr int kMaxD = 64;      // head dim: 3d <= 16 * kMaxJ
constexpr int kMaxJ = 12;      // QKV columns per thread
constexpr int kOutN = 64;      // output-projection column chunk
constexpr float kLnEps = 1e-6f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename E>
__device__ __forceinline__ E from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// the value a cast to E and back gives (round to nearest even)
template <typename E>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<E>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__host__ __device__ inline int smem_floats(int d) {
  const int n3 = 3 * d;
  const int nb = n3 > kOutN ? n3 : kOutN;
  return 2 * kMaxT                  // LN mean, rstd
         + kMaxT * (kKC + 1)        // A chunk
         + kKC * nb                 // B chunk
         + 3 * kMaxT * (d + 1)      // q, k, v of one head
         + kMaxT * (kMaxT + 1);     // scores / probabilities
}

template <typename E>
__global__ void __launch_bounds__(kThreads, 2) swin_attn_fwd_kernel(
    const E* __restrict__ x, const float* __restrict__ ln_s,
    const float* __restrict__ ln_b, const E* __restrict__ wqkv,
    const E* __restrict__ bqkv, const E* __restrict__ wout,
    const E* __restrict__ bout, const float* __restrict__ bias,
    E* __restrict__ out, E* __restrict__ scratch, int Hp, int Wp, int C,
    int heads, int win, float qk_scale) {
  extern __shared__ float smem[];
  const int T = win * win;
  const int d = C / heads;
  const int n3 = 3 * d;
  const int nb = n3 > kOutN ? n3 : kOutN;
  const int nwx = Wp / win;
  const int nwin = (Hp / win) * nwx;
  const int blk = blockIdx.x;  // b * nwin + w, windows row-major
  const int b = blk / nwin;
  const int w = blk - b * nwin;
  const int wy = w / nwx;
  const int wx = w - wy * nwx;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float* mu = smem;
  float* rs = mu + kMaxT;
  float* As = rs + kMaxT;              // [kMaxT][kKC + 1]
  float* Bs = As + kMaxT * (kKC + 1);  // [kKC][nb]
  float* Qs = Bs + kKC * nb;           // [kMaxT][d + 1]
  float* Ks = Qs + kMaxT * (d + 1);
  float* Vs = Ks + kMaxT * (d + 1);
  float* Ss = Vs + kMaxT * (d + 1);    // [kMaxT][kMaxT + 1]
  const int as_ld = kKC + 1;
  const int qk_ld = d + 1;
  const int s_ld = kMaxT + 1;

  // token t of this window sits at pixel (wy*win + t/win, wx*win + t%win)
  auto tok = [&](int t) -> size_t {
    const int r = t / win;
    const int c = t - r * win;
    return ((size_t)(b * Hp + wy * win + r) * Wp + (wx * win + c)) * C;
  };
  const E* scr = scratch + (size_t)blk * T * C;

  // 1. LayerNorm statistics, one warp per token
  for (int t = warp; t < T; t += kThreads / 32) {
    const E* xt = x + tok(t);
    float s = 0.f, s2 = 0.f;
    for (int k = lane; k < C; k += 32) {
      const float v = to_f(xt[k]);
      s += v;
      s2 += v * v;
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    if (lane == 0) {
      const float m = s / C;
      mu[t] = m;
      rs[t] = rsqrtf(fmaxf(s2 / C - m * m, 0.f) + kLnEps);
    }
  }
  __syncthreads();

  for (int h = 0; h < heads; ++h) {
    // 2. q, k, v of head h: (T, C) LN tokens x (C, 3d) columns of Wqkv
    float acc[4][kMaxJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < C; k0 += kKC) {
      for (int i = tid; i < kMaxT * kKC; i += kThreads) {
        const int t = i / kKC;
        const int kk = i - t * kKC;
        const int k = k0 + kk;
        float v = 0.f;
        if (t < T && k < C) {
          const float xv = to_f(x[tok(t) + k]);
          v = round_to<E>((xv - mu[t]) * rs[t] * ln_s[k] + ln_b[k]);
        }
        As[t * as_ld + kk] = v;
      }
      for (int i = tid; i < kKC * n3; i += kThreads) {
        const int kk = i / n3;
        const int n = i - kk * n3;
        const int k = k0 + kk;
        const int part = n / d;
        const int col = part * C + h * d + (n - part * d);
        Bs[kk * nb + n] = k < C ? to_f(wqkv[(size_t)k * 3 * C + col]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kKC; ++kk) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[(ty + 16 * i) * as_ld + kk];
#pragma unroll
        for (int j = 0; j < kMaxJ; ++j) {
          if (tx + 16 * j < n3) {
            const float bv = Bs[kk * nb + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], bv, acc[i][j]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      const int n = tx + 16 * j;
      if (n < n3) {
        const int part = n / d;
        const int jj = n - part * d;
        const float bv = to_f(bqkv[part * C + h * d + jj]);
        float* dst = part == 0 ? Qs : (part == 1 ? Ks : Vs);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = ty + 16 * i;
          if (row < T) dst[row * qk_ld + jj] = round_to<E>(acc[i][j] + bv);
        }
      }
    }
    __syncthreads();

    // 3. scores: q k^T * scale + bias, f32
    {
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
      for (int c = 0; c < d; ++c) {
        float a[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = ty + 16 * i;
          a[i] = Qs[(row < T ? row : 0) * qk_ld + c];  // rows past T: dropped
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          kv[j] = Ks[(col < T ? col : 0) * qk_ld + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], kv[j], sc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          if (row < T && col < T) {
            float s = sc[i][j] * qk_scale;
            if (bias != nullptr) s += bias[((size_t)w * T + row) * T + col];
            Ss[row * s_ld + col] = s;
          }
        }
      }
    }
    __syncthreads();

    // 4. softmax over keys, one warp per query row
    for (int row = warp; row < T; row += kThreads / 32) {
      float* sr = Ss + row * s_ld;
      float m = -INFINITY;
      for (int c = lane; c < T; c += 32) m = fmaxf(m, sr[c]);
      m = warp_max(m);
      float sum = 0.f;
      for (int c = lane; c < T; c += 32) {
        const float e = expf(sr[c] - m);
        sr[c] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int c = lane; c < T; c += 32) sr[c] = round_to<E>(sr[c] / sum);
    }
    __syncthreads();

    // 5. head output P v -> merged-heads scratch, columns h*d .. h*d+d
    {
      float o[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
      for (int c = 0; c < T; ++c) {
        float p[4], v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = ty + 16 * i;
          p[i] = row < T ? Ss[row * s_ld + c] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          v[j] = col < d ? Vs[c * qk_ld + col] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) o[i][j] = fmaf(p[i], v[j], o[i][j]);
      }
      E* sw = scratch + (size_t)blk * T * C + h * d;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          if (row < T && col < d) sw[(size_t)row * C + col] = from_f<E>(o[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // 6. output projection: merged heads (T, C) x Wout (C, C) + bout
  for (int n0 = 0; n0 < C; n0 += kOutN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < C; k0 += kKC) {
      for (int i = tid; i < kMaxT * kKC; i += kThreads) {
        const int t = i / kKC;
        const int kk = i - t * kKC;
        const int k = k0 + kk;
        As[t * as_ld + kk] =
            (t < T && k < C) ? to_f(scr[(size_t)t * C + k]) : 0.f;
      }
      for (int i = tid; i < kKC * kOutN; i += kThreads) {
        const int kk = i / kOutN;
        const int n = i - kk * kOutN;
        const int k = k0 + kk;
        Bs[kk * nb + n] = (k < C && n0 + n < C)
                              ? to_f(wout[(size_t)k * C + n0 + n])
                              : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kKC; ++kk) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[(ty + 16 * i) * as_ld + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[kk * nb + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < C) {
        const float bo = to_f(bout[col]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = ty + 16 * i;
          if (row < T) out[tok(row) + col] = from_f<E>(acc[i][j] + bo);
        }
      }
    }
  }
}

template <typename E>
int launch(const void* x, const void* ln_s, const void* ln_b,
           const void* wqkv, const void* bqkv, const void* wout,
           const void* bout, const void* bias, void* out, void* scratch,
           int B, int Hp, int Wp, int C, int heads, int win, float qk_scale,
           cudaStream_t stream) {
  const int d = C / heads;
  const int smem = smem_floats(d) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      swin_attn_fwd_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * (Hp / win) * (Wp / win);
  swin_attn_fwd_kernel<E><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const E*>(x), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<const E*>(wqkv),
      static_cast<const E*>(bqkv), static_cast<const E*>(wout),
      static_cast<const E*>(bout), static_cast<const float*>(bias),
      static_cast<E*>(out), static_cast<E*>(scratch), Hp, Wp, C, heads, win,
      qk_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype 0 = float32, 1 = bfloat16.
// bias is (nWin, T, T) float32 or null. scratch holds B*nWin*T*C elements.
// Returns a cudaError_t (0 = launched).
extern "C" int cvcs_swin_attn_fwd(int dtype, const void* x, const void* ln_s,
                                  const void* ln_b, const void* wqkv,
                                  const void* bqkv, const void* wout,
                                  const void* bout, const void* bias,
                                  void* out, void* scratch, int B, int Hp,
                                  int Wp, int C, int heads, int win,
                                  float qk_scale, void* stream) {
  if (win < 1 || win * win > kMaxT || heads < 1 || C % heads != 0 ||
      C / heads > kMaxD || Hp % win != 0 || Wp % win != 0 || B < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, ln_s, ln_b, wqkv, bqkv, wout, bout, bias, out,
                         scratch, B, Hp, Wp, C, heads, win, qk_scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, ln_s, ln_b, wqkv, bqkv, wout, bout, bias,
                                 out, scratch, B, Hp, Wp, C, heads, win,
                                 qk_scale, s);
  return (int)cudaErrorInvalidValue;
}
