// Swin fused window attention, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bwd_pallas` / `_make_bwd_kernel` of
// cvcs_tpu/ops/pallas_swin.py (per-window core `_attn_bwd_core`). Given the
// forward's inputs (the rolled, window-padded map x (B, Hp, Wp, C), the LN,
// QKV and output-projection parameters, the additive mask) and the output
// cotangent g, one call returns dx in the element type E and the f32
// gradients of ln scale, ln bias, wqkv, bqkv, wout and bout.
//
// Casting points are the TPU kernel's: the recomputed LN output and qkv,
// da = g wout^T, the probabilities p (p32 stays f32 for ds), the recomputed
// head outputs o, ds and the merged dq/dk/dv are rounded to E; every
// product accumulates in f32; dx is computed in f32 and then rounded.
//
// Design. The TPU kernel carries its weight-gradient sums from one grid
// step to the next (its grid runs in order). CUDA blocks run in parallel
// and in no order, so here every sum over tokens is owned by one thread
// that loops over its tokens in a fixed order, and split sums are added
// by a second pass in a fixed order: no atomics, and repeats are
// bit-equal. One call launches, on the caller's stream, these kernels
// (their names carry the prefix swin_bwd_, so a profile can tell them
// apart from the forward's):
//
//   1. ln_fwd:    LN statistics (mu, rstd) and the rounded LN output, one
//                 warp per token;
//   2. gemm:      qkv = ln wqkv + bqkv (rounded);
//   3. gemm:      da = g wout^T (rounded);
//   4. attn_bwd:  one block per (image, window, head): scores, softmax,
//                 o = p v, dp = do v^T, dv = p^T do, ds, dq = ds k,
//                 dk = ds^T q, all in shared memory (T <= 64, d <= 64);
//   5. gemm:      dln = dq2 wqkv^T (f32);
//   6. ln_bwd:    dx from dln, one warp per token;
//   7. gemm:      dwqkv = ln^T dq2 and dwout = o^T g, split over tokens
//                 into per-split f32 partials;
//   8. colsum:    dbqkv = sum dq2, dbout = sum g, dlns = sum dln * xhat,
//                 dlnb = sum dln, split the same way;
//   9. reduce:    the partials of each gradient summed in split order.
//
// Intermediates (LN output, qkv, da, o, dq2, dln) go through a workspace
// the caller allocates (`cvcs_swin_attn_bwd_workspace` bytes). What bounds
// it on the H100: about 22*N*C^2 + 12*N*T*C operations for N tokens, on
// CUDA cores in f32 here, far below the tensor-core bound; the products
// (steps 2, 3, 5 and 7) are the time, and `mma`/`wgmma` is the step that
// would move them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 thread grid, 4 x 4 outputs each
constexpr int kMaxT = 64;      // tokens per window (win <= 8)
constexpr int kMaxD = 64;      // head dim
constexpr int kTile = 64;      // GEMM output tile (64 x 64)
constexpr int kKC = 32;        // GEMM K chunk staged in shared memory
constexpr int kSums = 264;     // blocks a split sum aims for (2 per SM)
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

// 1. LN statistics and rounded LN output, one warp per token.
template <typename E>
__global__ void swin_bwd_ln_fwd(const E* __restrict__ x,
                                const float* __restrict__ ln_s,
                                const float* __restrict__ ln_b,
                                float* __restrict__ mu, float* __restrict__ rs,
                                E* __restrict__ ln, int P, int C) {
  const int p = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= P) return;
  const E* xt = x + (size_t)p * C;
  float s = 0.f, s2 = 0.f;
  for (int k = lane; k < C; k += 32) {
    const float v = to_f(xt[k]);
    s += v;
    s2 += v * v;
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float m = s / C;
  const float r = rsqrtf(fmaxf(s2 / C - m * m, 0.f) + kLnEps);
  if (lane == 0) {
    mu[p] = m;
    rs[p] = r;
  }
  E* out = ln + (size_t)p * C;
  for (int k = lane; k < C; k += 32)
    out[k] = from_f<E>((to_f(xt[k]) - m) * r * ln_s[k] + ln_b[k]);
}

// 6. dx = rs * (dxh - mean(dxh) - xhat * mean(dxh * xhat)), dxh = dln * lns,
// one warp per token.
template <typename E>
__global__ void swin_bwd_ln_bwd(const E* __restrict__ x,
                                const float* __restrict__ mu,
                                const float* __restrict__ rs,
                                const float* __restrict__ ln_s,
                                const float* __restrict__ dln,
                                E* __restrict__ dx, int P, int C) {
  const int p = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= P) return;
  const E* xt = x + (size_t)p * C;
  const float* gt = dln + (size_t)p * C;
  const float m = mu[p];
  const float r = rs[p];
  float s1 = 0.f, s2 = 0.f;
  for (int k = lane; k < C; k += 32) {
    const float xh = (to_f(xt[k]) - m) * r;
    const float dxh = gt[k] * ln_s[k];
    s1 += dxh;
    s2 += dxh * xh;
  }
  const float m1 = warp_sum(s1) / C;
  const float m2 = warp_sum(s2) / C;
  E* out = dx + (size_t)p * C;
  for (int k = lane; k < C; k += 32) {
    const float xh = (to_f(xt[k]) - m) * r;
    const float dxh = gt[k] * ln_s[k];
    out[k] = from_f<E>(r * (dxh - m1 - xh * m2));
  }
}

// GEMM on the CUDA cores: out[m, n] = sum_k A(m, k) B(k, n) over the K
// range of split blockIdx.z, f32 accumulation in k order.
//   A(m, k) = A[k * lda + m] if A_M_CONTIG else A[m * lda + k]
//   B(k, n) = B[k * ldb + n] if B_N_CONTIG else B[n * ldb + k]
// EPI 0: f32 to out + blockIdx.z * M * N; 1: rounded to E; 2: rounded to E
// after adding bias[n].
template <typename E, bool A_M_CONTIG, bool B_N_CONTIG, int EPI>
__global__ void __launch_bounds__(kThreads) swin_bwd_gemm(
    const E* __restrict__ A, const E* __restrict__ Bm,
    const E* __restrict__ bias, void* __restrict__ out, int M, int N, int K,
    int lda, int ldb, int k_per_split) {
  __shared__ float As[kKC][kTile + 1];
  __shared__ float Bs[kKC][kTile + 1];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  const int kb = blockIdx.z * k_per_split;
  const int ke = min(K, kb + k_per_split);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += kKC) {
    for (int i = tid; i < kKC * kTile; i += kThreads) {
      int kk, mm;
      if (A_M_CONTIG) {
        kk = i / kTile;
        mm = i - kk * kTile;
      } else {
        mm = i / kKC;
        kk = i - mm * kKC;
      }
      const int m = m0 + mm, k = k0 + kk;
      float v = 0.f;
      if (m < M && k < ke)
        v = to_f(A_M_CONTIG ? A[(size_t)k * lda + m] : A[(size_t)m * lda + k]);
      As[kk][mm] = v;
    }
    for (int i = tid; i < kKC * kTile; i += kThreads) {
      int kk, nn;
      if (B_N_CONTIG) {
        kk = i / kTile;
        nn = i - kk * kTile;
      } else {
        nn = i / kKC;
        kk = i - nn * kKC;
      }
      const int n = n0 + nn, k = k0 + kk;
      float v = 0.f;
      if (n < N && k < ke)
        v = to_f(B_N_CONTIG ? Bm[(size_t)k * ldb + n]
                            : Bm[(size_t)n * ldb + k]);
      Bs[kk][nn] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKC; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      if (EPI == 0) {
        static_cast<float*>(out)[(size_t)blockIdx.z * M * N +
                                 (size_t)m * N + n] = acc[i][j];
      } else if (EPI == 1) {
        static_cast<E*>(out)[(size_t)m * N + n] = from_f<E>(acc[i][j]);
      } else {
        static_cast<E*>(out)[(size_t)m * N + n] =
            from_f<E>(acc[i][j] + to_f(bias[n]));
      }
    }
  }
}

// acc = A (M x K) B (K x N) from shared memory with strides, for the
// block's 16 x 16 threads (rows ty + 16 i, columns tx + 16 j, M, N <= 64).
// ROUND_A rounds each A element to E first (p from p32).
template <bool ROUND_A, typename E>
__device__ __forceinline__ void block_mm(const float* A, int sam, int sak,
                                         const float* B, int sbk, int sbn,
                                         int M, int N, int K,
                                         float acc[4][4]) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < K; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      float v = row < M ? A[row * sam + k * sak] : 0.f;
      a[i] = ROUND_A ? round_to<E>(v) : v;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      b[j] = col < N ? B[k * sbk + col * sbn] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__host__ __device__ inline int attn_smem_floats(int d) {
  return 4 * kMaxT * (d + 1) + 2 * kMaxT * (kMaxT + 1);
}

// 4. Attention backward of one (image, window, head). Reads q, k, v from the
// recomputed qkv and do from da; writes the rounded head output o to
// `a_out` and the rounded dq, dk, dv to `dq2` (all in pixel order).
template <typename E>
__global__ void __launch_bounds__(kThreads) swin_bwd_attn(
    const E* __restrict__ qkv, const E* __restrict__ da,
    const float* __restrict__ bias, E* __restrict__ a_out,
    E* __restrict__ dq2, int Hp, int Wp, int C, int heads, int win,
    float scale) {
  extern __shared__ float smem[];
  const int T = win * win;
  const int d = C / heads;
  const int h = blockIdx.x % heads;
  const int blk = blockIdx.x / heads;  // b * nwin + w, windows row-major
  const int nwx = Wp / win;
  const int nwin = (Hp / win) * nwx;
  const int b = blk / nwin;
  const int w = blk - b * nwin;
  const int wy = w / nwx;
  const int wx = w - wy * nwx;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ld = d + 1;
  const int lds = kMaxT + 1;
  float* Qs = smem;
  float* Ks = Qs + kMaxT * ld;
  float* Vs = Ks + kMaxT * ld;
  float* Ds = Vs + kMaxT * ld;   // do
  float* Ss = Ds + kMaxT * ld;   // scores, then p32
  float* Ps = Ss + kMaxT * lds;  // dp, then ds
  const int C3 = 3 * C;

  // token t of this window sits at pixel (wy*win + t/win, wx*win + t%win)
  auto pix = [&](int t) -> size_t {
    const int r = t / win;
    const int c = t - r * win;
    return (size_t)(b * Hp + wy * win + r) * Wp + (wx * win + c);
  };

  for (int i = tid; i < T * d; i += kThreads) {
    const int t = i / d;
    const int c = i - t * d;
    const size_t p = pix(t);
    const E* row = qkv + p * C3 + h * d + c;
    Qs[t * ld + c] = to_f(row[0]);
    Ks[t * ld + c] = to_f(row[C]);
    Vs[t * ld + c] = to_f(row[2 * C]);
    Ds[t * ld + c] = to_f(da[p * C + h * d + c]);
  }
  __syncthreads();

  float acc[4][4];
  // scores s = q k^T * scale + bias
  block_mm<false, E>(Qs, ld, 1, Ks, 1, ld, T, T, d, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      if (row < T && col < T) {
        float s = acc[i][j] * scale;
        if (bias != nullptr) s += bias[((size_t)w * T + row) * T + col];
        Ss[row * lds + col] = s;
      }
    }
  }
  __syncthreads();

  // p32 = softmax over keys, one warp per query row
  for (int row = warp; row < T; row += kThreads / 32) {
    float* sr = Ss + row * lds;
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
    for (int c = lane; c < T; c += 32) sr[c] = sr[c] / sum;
  }
  __syncthreads();

  // o = p v -> a_out (rounded); dp = do v^T -> Ps; dv = p^T do -> dq2
  block_mm<true, E>(Ss, lds, 1, Vs, ld, 1, T, d, T, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      if (row < T && col < d)
        a_out[pix(row) * C + h * d + col] = from_f<E>(acc[i][j]);
    }
  }
  block_mm<false, E>(Ds, ld, 1, Vs, 1, ld, T, T, d, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      if (row < T && col < T) Ps[row * lds + col] = acc[i][j];
    }
  }
  block_mm<true, E>(Ss, 1, lds, Ds, ld, 1, T, d, T, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      if (row < T && col < d)
        dq2[pix(row) * C3 + 2 * C + h * d + col] = from_f<E>(acc[i][j]);
    }
  }
  __syncthreads();

  // ds = p32 * (dp - sum(dp * p32)) * scale, rounded; one warp per row
  for (int row = warp; row < T; row += kThreads / 32) {
    const float* pr = Ss + row * lds;
    float* dr = Ps + row * lds;
    float r = 0.f;
    for (int c = lane; c < T; c += 32) r += dr[c] * pr[c];
    r = warp_sum(r);
    for (int c = lane; c < T; c += 32)
      dr[c] = round_to<E>(pr[c] * (dr[c] - r) * scale);
  }
  __syncthreads();

  // dq = ds k; dk = ds^T q
  block_mm<false, E>(Ps, lds, 1, Ks, ld, 1, T, d, T, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      if (row < T && col < d)
        dq2[pix(row) * C3 + h * d + col] = from_f<E>(acc[i][j]);
    }
  }
  block_mm<false, E>(Ps, 1, lds, Qs, ld, 1, T, d, T, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      if (row < T && col < d)
        dq2[pix(row) * C3 + C + h * d + col] = from_f<E>(acc[i][j]);
    }
  }
}

// 8. Column sums of a (P x M) matrix over the rows of split blockIdx.y.
template <typename E>
__global__ void swin_bwd_colsum(const E* __restrict__ in,
                                float* __restrict__ part, int P, int M,
                                int rows_per_split) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= M) return;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(P, r0 + rows_per_split);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += to_f(in[(size_t)r * M + col]);
  part[(size_t)blockIdx.y * M + col] = s;
}

// 8. The LN parameter grads: sum dln * xhat and sum dln per column.
template <typename E>
__global__ void swin_bwd_ln_grad(const float* __restrict__ dln,
                                 const E* __restrict__ x,
                                 const float* __restrict__ mu,
                                 const float* __restrict__ rs,
                                 float* __restrict__ part_s,
                                 float* __restrict__ part_b, int P, int C,
                                 int rows_per_split) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= C) return;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(P, r0 + rows_per_split);
  float ss = 0.f, sb = 0.f;
  for (int r = r0; r < r1; ++r) {
    const size_t i = (size_t)r * C + col;
    const float g = dln[i];
    ss += g * ((to_f(x[i]) - mu[r]) * rs[r]);
    sb += g;
  }
  part_s[(size_t)blockIdx.y * C + col] = ss;
  part_b[(size_t)blockIdx.y * C + col] = sb;
}

// 9. out[i] = sum over splits s = 0, 1, ... of part[s * M + i].
__global__ void swin_bwd_reduce(const float* __restrict__ part,
                                float* __restrict__ out, int S, int M) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += part[(size_t)k * M + i];
  out[i] = s;
}

int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// How a sum over P tokens is split: S splits of `per` tokens each
// (a multiple of `align`), enough to give about kSums blocks in all.
struct Split {
  int S, per;
};
Split split_for(int P, int blocks_per_split, int align) {
  int S = cdiv(kSums, blocks_per_split);
  S = S < 1 ? 1 : S;
  const int max_s = cdiv(P, 256);
  S = S > max_s ? max_s : S;
  int per = cdiv(cdiv(P, S), align) * align;
  return Split{cdiv(P, per), per};
}

// The workspace, carved in order; every piece 256-byte aligned.
struct Plan {
  int P, C;
  Split sw_qkv, sw_out, sc_qkv, sc_out, sc_ln;
  size_t mu, rs, ln, qkv, da, a, dq2, dln, p_wqkv, p_wout, p_bqkv, p_bout,
      p_lns, p_lnb, total;
};

size_t take(size_t& off, size_t bytes) {
  const size_t at = off;
  off += (bytes + 255) / 256 * 256;
  return at;
}

Plan make_plan(int es, int B, int Hp, int Wp, int C) {
  Plan pl;
  pl.P = B * Hp * Wp;
  pl.C = C;
  const int P = pl.P;
  pl.sw_qkv = split_for(P, cdiv(C, kTile) * cdiv(3 * C, kTile), kKC);
  pl.sw_out = split_for(P, cdiv(C, kTile) * cdiv(C, kTile), kKC);
  pl.sc_qkv = split_for(P, cdiv(3 * C, kThreads), 1);
  pl.sc_out = split_for(P, cdiv(C, kThreads), 1);
  pl.sc_ln = pl.sc_out;
  size_t off = 0;
  pl.mu = take(off, (size_t)P * 4);
  pl.rs = take(off, (size_t)P * 4);
  pl.ln = take(off, (size_t)P * C * es);
  pl.qkv = take(off, (size_t)P * 3 * C * es);
  pl.da = take(off, (size_t)P * C * es);
  pl.a = take(off, (size_t)P * C * es);
  pl.dq2 = take(off, (size_t)P * 3 * C * es);
  pl.dln = take(off, (size_t)P * C * 4);
  pl.p_wqkv = take(off, (size_t)pl.sw_qkv.S * C * 3 * C * 4);
  pl.p_wout = take(off, (size_t)pl.sw_out.S * C * C * 4);
  pl.p_bqkv = take(off, (size_t)pl.sc_qkv.S * 3 * C * 4);
  pl.p_bout = take(off, (size_t)pl.sc_out.S * C * 4);
  pl.p_lns = take(off, (size_t)pl.sc_ln.S * C * 4);
  pl.p_lnb = take(off, (size_t)pl.sc_ln.S * C * 4);
  pl.total = off;
  return pl;
}

#define CHECK_LAUNCH()                          \
  do {                                          \
    cudaError_t e_ = cudaGetLastError();        \
    if (e_ != cudaSuccess) return (int)e_;      \
  } while (0)

// Sum S partials of M floats into out (S == 1: the partial is out itself).
int finish(const float* part, float* out, int S, int M, cudaStream_t st) {
  if (S == 1) return 0;
  swin_bwd_reduce<<<cdiv(M, kThreads), kThreads, 0, st>>>(part, out, S, M);
  return (int)cudaGetLastError();
}

template <typename E>
int launch(const void* x_, const void* ln_s_, const void* ln_b_,
           const void* wqkv_, const void* bqkv_, const void* wout_,
           const void* bias_, const void* g_, void* dx_, void* dlns_,
           void* dlnb_, void* dwqkv_, void* dbqkv_, void* dwout_,
           void* dbout_, void* ws_, int B, int Hp, int Wp, int C, int heads,
           int win, float scale, cudaStream_t st) {
  const E* x = static_cast<const E*>(x_);
  const float* ln_s = static_cast<const float*>(ln_s_);
  const float* ln_b = static_cast<const float*>(ln_b_);
  const E* wqkv = static_cast<const E*>(wqkv_);
  const E* bqkv = static_cast<const E*>(bqkv_);
  const E* wout = static_cast<const E*>(wout_);
  const float* bias = static_cast<const float*>(bias_);
  const E* g = static_cast<const E*>(g_);
  E* dx = static_cast<E*>(dx_);
  float* dlns = static_cast<float*>(dlns_);
  float* dlnb = static_cast<float*>(dlnb_);
  float* dwqkv = static_cast<float*>(dwqkv_);
  float* dbqkv = static_cast<float*>(dbqkv_);
  float* dwout = static_cast<float*>(dwout_);
  float* dbout = static_cast<float*>(dbout_);
  char* ws = static_cast<char*>(ws_);

  const Plan pl = make_plan((int)sizeof(E), B, Hp, Wp, C);
  const int P = pl.P;
  const int C3 = 3 * C;
  float* mu = reinterpret_cast<float*>(ws + pl.mu);
  float* rs = reinterpret_cast<float*>(ws + pl.rs);
  E* ln = reinterpret_cast<E*>(ws + pl.ln);
  E* qkv = reinterpret_cast<E*>(ws + pl.qkv);
  E* da = reinterpret_cast<E*>(ws + pl.da);
  E* a = reinterpret_cast<E*>(ws + pl.a);
  E* dq2 = reinterpret_cast<E*>(ws + pl.dq2);
  float* dln = reinterpret_cast<float*>(ws + pl.dln);
  auto part = [&](size_t off, int S, float* out) {
    return S > 1 ? reinterpret_cast<float*>(ws + off) : out;
  };
  float* p_wqkv = part(pl.p_wqkv, pl.sw_qkv.S, dwqkv);
  float* p_wout = part(pl.p_wout, pl.sw_out.S, dwout);
  float* p_bqkv = part(pl.p_bqkv, pl.sc_qkv.S, dbqkv);
  float* p_bout = part(pl.p_bout, pl.sc_out.S, dbout);
  float* p_lns = part(pl.p_lns, pl.sc_ln.S, dlns);
  float* p_lnb = part(pl.p_lnb, pl.sc_ln.S, dlnb);

  const int warps_blocks = cdiv((long long)P * 32, kThreads);
  swin_bwd_ln_fwd<E><<<warps_blocks, kThreads, 0, st>>>(x, ln_s, ln_b, mu, rs,
                                                      ln, P, C);
  CHECK_LAUNCH();
  swin_bwd_gemm<E, false, true, 2>
      <<<dim3(cdiv(C3, kTile), cdiv(P, kTile), 1), kThreads, 0, st>>>(
          ln, wqkv, bqkv, qkv, P, C3, C, C, C3, C);
  CHECK_LAUNCH();
  swin_bwd_gemm<E, false, false, 1>
      <<<dim3(cdiv(C, kTile), cdiv(P, kTile), 1), kThreads, 0, st>>>(
          g, wout, nullptr, da, P, C, C, C, C, C);
  CHECK_LAUNCH();

  const int d = C / heads;
  const int smem = attn_smem_floats(d) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      swin_bwd_attn<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * (Hp / win) * (Wp / win) * heads;
  swin_bwd_attn<E><<<(unsigned)blocks, kThreads, smem, st>>>(
      qkv, da, bias, a, dq2, Hp, Wp, C, heads, win, scale);
  CHECK_LAUNCH();

  swin_bwd_gemm<E, false, false, 0>
      <<<dim3(cdiv(C, kTile), cdiv(P, kTile), 1), kThreads, 0, st>>>(
          dq2, wqkv, nullptr, dln, P, C, C3, C3, C3, C3);
  CHECK_LAUNCH();
  swin_bwd_ln_bwd<E><<<warps_blocks, kThreads, 0, st>>>(x, mu, rs, ln_s, dln,
                                                      dx, P, C);
  CHECK_LAUNCH();

  swin_bwd_gemm<E, true, true, 0>
      <<<dim3(cdiv(C3, kTile), cdiv(C, kTile), pl.sw_qkv.S), kThreads, 0,
         st>>>(ln, dq2, nullptr, p_wqkv, C, C3, P, C, C3, pl.sw_qkv.per);
  CHECK_LAUNCH();
  swin_bwd_gemm<E, true, true, 0>
      <<<dim3(cdiv(C, kTile), cdiv(C, kTile), pl.sw_out.S), kThreads, 0,
         st>>>(a, g, nullptr, p_wout, C, C, P, C, C, pl.sw_out.per);
  CHECK_LAUNCH();
  swin_bwd_colsum<E><<<dim3(cdiv(C3, kThreads), pl.sc_qkv.S), kThreads, 0,
                     st>>>(dq2, p_bqkv, P, C3, pl.sc_qkv.per);
  CHECK_LAUNCH();
  swin_bwd_colsum<E><<<dim3(cdiv(C, kThreads), pl.sc_out.S), kThreads, 0,
                     st>>>(g, p_bout, P, C, pl.sc_out.per);
  CHECK_LAUNCH();
  swin_bwd_ln_grad<E><<<dim3(cdiv(C, kThreads), pl.sc_ln.S), kThreads, 0,
                      st>>>(dln, x, mu, rs, p_lns, p_lnb, P, C,
                            pl.sc_ln.per);
  CHECK_LAUNCH();

  int rc;
  if ((rc = finish(p_wqkv, dwqkv, pl.sw_qkv.S, C * C3, st))) return rc;
  if ((rc = finish(p_wout, dwout, pl.sw_out.S, C * C, st))) return rc;
  if ((rc = finish(p_bqkv, dbqkv, pl.sc_qkv.S, C3, st))) return rc;
  if ((rc = finish(p_bout, dbout, pl.sc_out.S, C, st))) return rc;
  if ((rc = finish(p_lns, dlns, pl.sc_ln.S, C, st))) return rc;
  return finish(p_lnb, dlnb, pl.sc_ln.S, C, st);
}

bool shape_ok(int B, int Hp, int Wp, int C, int heads, int win) {
  return win >= 1 && win * win <= kMaxT && heads >= 1 && C % heads == 0 &&
         C / heads <= kMaxD && Hp % win == 0 && Wp % win == 0 && B >= 1;
}

}  // namespace

// Bytes of workspace `cvcs_swin_attn_bwd` needs for these shapes (0 if it
// cannot run them). dtype 0 = float32, 1 = bfloat16.
extern "C" size_t cvcs_swin_attn_bwd_workspace(int dtype, int B, int Hp,
                                               int Wp, int C, int heads) {
  if ((dtype != 0 && dtype != 1) || !shape_ok(B, Hp, Wp, C, heads, 1))
    return 0;
  return make_plan(dtype == 0 ? 4 : 2, B, Hp, Wp, C).total;
}

// Plain C entry point, loaded with ctypes. bias is (nWin, T, T) float32 or
// null; ln_s, ln_b are float32; the other inputs and dx are of the element
// type; the six parameter grads are float32. Returns a cudaError_t
// (0 = launched).
extern "C" int cvcs_swin_attn_bwd(int dtype, const void* x, const void* ln_s,
                                  const void* ln_b, const void* wqkv,
                                  const void* bqkv, const void* wout,
                                  const void* bias, const void* g, void* dx,
                                  void* dlns, void* dlnb, void* dwqkv,
                                  void* dbqkv, void* dwout, void* dbout,
                                  void* workspace, int B, int Hp, int Wp,
                                  int C, int heads, int win, float scale,
                                  void* stream) {
  if (!shape_ok(B, Hp, Wp, C, heads, win)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, ln_s, ln_b, wqkv, bqkv, wout, bias, g, dx, dlns,
                         dlnb, dwqkv, dbqkv, dwout, dbout, workspace, B, Hp,
                         Wp, C, heads, win, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, ln_s, ln_b, wqkv, bqkv, wout, bias, g,
                                 dx, dlns, dlnb, dwqkv, dbqkv, dwout, dbout,
                                 workspace, B, Hp, Wp, C, heads, win, scale,
                                 s);
  return (int)cudaErrorInvalidValue;
}
