// Building blocks shared by the Swin window-attention kernels, forward
// (csrc/swin_attn.cu, K1) and backward (csrc/swin_attn_bwd.cu, K2), for
// Hopper (sm_90a).
//
// * Element conversions (E = float or __nv_bfloat16; from_f rounds to
//   nearest even, as the TPU kernel's casting points do).
// * `load_tile`: a tile of a row-major matrix into shared memory, whole
//   16-byte chunks by cp.async where the rows are aligned, the ragged
//   edge element by element with zeros beyond it.
// * `warp_mma_k16`: one warp's product of a 16-deep slice of two tiles in
//   shared memory into accumulators laid out as mma.m16n8k16's C fragment
//   (g = lane / 4, t = lane % 4: [0], [1] at row g, columns 2t, 2t + 1;
//   [2], [3] at row g + 8). For bf16 it is ldmatrix (.trans for a
//   transposed operand) and mma.sync bf16 x bf16 -> f32; for f32 the same
//   outputs by FMA in k order, so the f32 instance runs the same tiling,
//   indexing and casting points without TF32.
// * `gemm_body`: C = A B + epilogue, a 64 x 96 or 128 x 96 block tile
//   (six warps of 32 x 32 or 64 x 32; the launcher takes the larger where
//   it still gives two blocks per SM) and a K slice of 32, a three-stage
//   cp.async ring, either operand stored
//   transposed (read by ldmatrix.trans, never copied), an f32, rounded or
//   rounded-plus-bias epilogue staged through shared memory so that rows
//   leave in 16-byte stores, and a K range per blockIdx.z for split
//   sums. Each source wraps it in a __global__ of its own name, so a
//   profile tells K1's GEMMs from K2's.
// * `mask_pair`: two neighbouring entries of the additive (nWin, T, T)
//   mask in one 8-byte load.
// * `ln_rows_body`: the TPU kernel's LayerNorm (f32 statistics, the fast
//   variance max(E[x^2] - mu^2, 0), eps 1e-6), one 16-byte chunk a thread
//   where the rows allow, the output rounded to E.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace swin {

constexpr int kMaxT = 64;  // tokens per window (win <= 8)
constexpr int kMaxD = 64;  // head dim
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The elements of one 16-byte chunk, and the padding of a shared-memory
// row: one chunk keeps every row 16-byte aligned for cp.async and
// ldmatrix and moves successive rows to other banks.
template <typename E>
__host__ __device__ constexpr int chunk() {
  return 16 / (int)sizeof(E);
}

// Writes v0 to p[0] and, if `two`, v1 to p[1], rounded to E; one paired
// store where the address allows it.
template <typename E>
__device__ __forceinline__ void put2(E* p, float v0, float v1, bool two) {
  if (two && ((uintptr_t)p & (2 * sizeof(E) - 1)) == 0) {
    if constexpr (std::is_same<E, float>::value) {
      *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
    }
    return;
  }
  p[0] = from_f<E>(v0);
  if (two) p[1] = from_f<E>(v1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(s)),
               "l"(g));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A ROWS x COLS tile of a row-major matrix g (element (r, c) at
// g[r * ld + c]) into shared memory s (row stride sld), zero where
// r >= nr or c >= nc. vec: g and ld keep every 16-byte chunk aligned, so
// whole in-range chunks go by cp.async (the caller commits and waits).
template <typename E, int ROWS, int COLS, int NT>
__device__ __forceinline__ void load_tile(E* s, int sld, const E* g,
                                          size_t ld, int nr, int nc, bool vec,
                                          int tid) {
  constexpr int CH = chunk<E>();
  constexpr int CPR = COLS / CH;
#pragma unroll 2
  for (int i = tid; i < ROWS * CPR; i += NT) {
    const int r = i / CPR;
    const int c = (i - r * CPR) * CH;
    E* dst = s + r * sld + c;
    if (vec && r < nr && c + CH <= nc) {
      cp_async16(dst, g + (size_t)r * ld + c);
    } else {
#pragma unroll
      for (int j = 0; j < CH; ++j)
        dst[j] = (r < nr && c + j < nc) ? g[(size_t)r * ld + c + j]
                                        : from_f<E>(0.f);
    }
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The additive mask of window w at (row, c0) and (row, c0 + 1), zero past
// T or without a mask; one 8-byte load where the pair is aligned (T even).
__device__ __forceinline__ float2 mask_pair(const float* __restrict__ bias,
                                            int w, int T, int row, int c0) {
  float2 b = make_float2(0.f, 0.f);
  if (bias == nullptr || row >= T) return b;
  const float* r = bias + ((size_t)w * T + row) * T;
  if (c0 + 1 < T && ((uintptr_t)(r + c0) & 7) == 0)
    return *reinterpret_cast<const float2*>(r + c0);
  if (c0 < T) b.x = r[c0];
  if (c0 + 1 < T) b.y = r[c0 + 1];
  return b;
}

template <int MI, int NI>
__device__ __forceinline__ void zero(float (&acc)[MI][NI][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// acc[mi][ni] += A(m0 + 16 mi + [0, 16), k0 + [0, 16)) *
//                B(k0 + [0, 16), n0 + 8 ni + [0, 8)), both in shared memory:
//   A(m, k) = A_KM ? a[k * lda + m] : a[m * lda + k]
//   B(k, n) = B_KM ? b[k * ldb + n] : b[n * ldb + k]
// NI is even (ldmatrix.x4 fetches two 8-column B fragments at a time).
template <typename E, bool A_KM, bool B_KM, int MI, int NI>
__device__ __forceinline__ void warp_mma_k16(float (&acc)[MI][NI][4],
                                             const E* a, int lda, const E* b,
                                             int ldb, int m0, int n0, int k0,
                                             int lane) {
  static_assert(NI % 2 == 0, "NI must be even");
  if constexpr (std::is_same<E, float>::value) {
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll 4
    for (int kk = 0; kk < 16; ++kk) {
      const int k = k0 + kk;
      float av[MI][2], bv[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + 16 * i + g + 8 * h;
          av[i][h] = A_KM ? a[k * lda + m] : a[m * lda + k];
        }
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n0 + 8 * j + 2 * t + h;
          bv[j][h] = B_KM ? b[k * ldb + n] : b[n * ldb + k];
        }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          acc[i][j][0] = fmaf(av[i][0], bv[j][0], acc[i][j][0]);
          acc[i][j][1] = fmaf(av[i][0], bv[j][1], acc[i][j][1]);
          acc[i][j][2] = fmaf(av[i][1], bv[j][0], acc[i][j][2]);
          acc[i][j][3] = fmaf(av[i][1], bv[j][1], acc[i][j][3]);
        }
    }
  } else {
    // lane -> the row of one of the four 8 x 8 matrices it addresses
    const int r = lane & 7;
    const int q = lane >> 3;
    uint32_t af[MI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      if (A_KM)
        ldsm_x4_t(af[i], a + (k0 + r + (q >> 1) * 8) * lda + m0 + 16 * i +
                             (q & 1) * 8);
      else
        ldsm_x4(af[i], a + (m0 + 16 * i + r + (q & 1) * 8) * lda + k0 +
                           (q >> 1) * 8);
    }
#pragma unroll
    for (int j = 0; j < NI / 2; ++j) {
      uint32_t bf[4];
      if (B_KM)
        ldsm_x4_t(bf, b + (k0 + r + (q & 1) * 8) * ldb + n0 + 16 * j +
                          (q >> 1) * 8);
      else
        ldsm_x4(bf, b + (n0 + 16 * j + r + (q >> 1) * 8) * ldb + k0 +
                        (q & 1) * 8);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        mma_bf16(acc[i][2 * j], af[i], bf[0], bf[1]);
        mma_bf16(acc[i][2 * j + 1], af[i], bf[2], bf[3]);
      }
    }
  }
}

// -- the GEMM ---------------------------------------------------------------

constexpr int kBM = 64;            // block tile rows of the small tile;
                                   // the large one has 2 * kBM
constexpr int kBN = 96;            // block tile columns (Swin's C and 3C
                                   // are multiples of 96)
constexpr int kBK = 32;            // K slice per pipeline stage
constexpr int kStages = 3;         // cp.async ring
constexpr int kGemmThreads = 192;  // 2 x 3 warps of (16 MI) x 32
constexpr int kFill = 264;         // blocks that fill an H100 twice over

enum Epi { kF32 = 0, kRound = 1, kBiasRound = 2 };

template <typename E>
struct GemmArgs {
  const E* a;
  const E* b;
  const E* bias;  // kBiasRound: (N,)
  void* out;      // kF32: float, split z at out + z * M * N; else E
  int M, N, K;
  int lda, ldb;
  int k_per_split;  // a multiple of kBK
  int vec_a, vec_b;
};

// MI: the 16-row fragments of a warp's tile, 2 or 4: the block tile has
// 32 * MI rows.
template <typename E, bool A_KM, int MI>
__host__ __device__ constexpr int a_stage() {
  return A_KM ? kBK * (32 * MI + chunk<E>()) : 32 * MI * (kBK + chunk<E>());
}
template <typename E, bool B_KM>
__host__ __device__ constexpr int b_stage() {
  return B_KM ? kBK * (kBN + chunk<E>()) : kBN * (kBK + chunk<E>());
}
// The element an epilogue writes: f32 partial sums or E.
template <typename E, int EPI>
using Out = typename std::conditional<EPI == kF32, float, E>::type;

// the ring, and after the main loop the output tile (32 MI x kBN)
template <typename E, bool A_KM, bool B_KM, int EPI, int MI>
__host__ __device__ constexpr int gemm_smem_bytes() {
  using O = Out<E, EPI>;
  constexpr int ring =
      kStages * (a_stage<E, A_KM, MI>() + b_stage<E, B_KM>()) * (int)sizeof(E);
  constexpr int tile = 32 * MI * (kBN + chunk<O>()) * (int)sizeof(O);
  return ring > tile ? ring : tile;
}

// out[m, n] = epilogue(sum over k in split blockIdx.z of A(m, k) B(k, n)),
// A(m, k) = A_KM ? a[k * lda + m] : a[m * lda + k], likewise B.
template <typename E, bool A_KM, bool B_KM, int EPI, int MI>
__device__ __forceinline__ void gemm_body(const GemmArgs<E>& p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* smem = reinterpret_cast<E*>(smem_raw);
  constexpr int BM = 32 * MI;
  constexpr int PAD = chunk<E>();
  constexpr int AS = a_stage<E, A_KM, MI>();
  constexpr int BS = b_stage<E, B_KM>();
  constexpr int ALD = A_KM ? BM + PAD : kBK + PAD;
  constexpr int BLD = B_KM ? kBN + PAD : kBK + PAD;
  E* As = smem;
  E* Bs = smem + kStages * AS;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / 3;  // 0..1
  const int wn = warp % 3;  // 0..2
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * kBN;
  const int kb = blockIdx.z * p.k_per_split;
  const int ke = min(p.K, kb + p.k_per_split);
  const int nk = ke > kb ? (ke - kb + kBK - 1) / kBK : 0;

  auto load = [&](int stage, int k0) {
    E* as = As + stage * AS;
    E* bs = Bs + stage * BS;
    if (A_KM)
      load_tile<E, kBK, BM, kGemmThreads>(as, ALD,
                                           p.a + (size_t)k0 * p.lda + m0,
                                           p.lda, ke - k0, p.M - m0, p.vec_a,
                                           tid);
    else
      load_tile<E, BM, kBK, kGemmThreads>(as, ALD,
                                           p.a + (size_t)m0 * p.lda + k0,
                                           p.lda, p.M - m0, ke - k0, p.vec_a,
                                           tid);
    if (B_KM)
      load_tile<E, kBK, kBN, kGemmThreads>(bs, BLD,
                                           p.b + (size_t)k0 * p.ldb + n0,
                                           p.ldb, ke - k0, p.N - n0, p.vec_b,
                                           tid);
    else
      load_tile<E, kBN, kBK, kGemmThreads>(bs, BLD,
                                           p.b + (size_t)n0 * p.ldb + k0,
                                           p.ldb, p.N - n0, ke - k0, p.vec_b,
                                           tid);
  };

  float acc[MI][4][4];
  zero(acc);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, kb + s * kBK);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `it` landed; stage it - 1 is free
    const int nxt = it + kStages - 1;
    if (nxt < nk) load(nxt % kStages, kb + nxt * kBK);
    cp_async_commit();
    const E* as = As + (it % kStages) * AS;
    const E* bs = Bs + (it % kStages) * BS;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16)
      warp_mma_k16<E, A_KM, B_KM, MI, 4>(acc, as, ALD, bs, BLD, wm * 16 * MI,
                                         wn * 32, kk, lane);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the output tile now

  // the epilogue's values into a tile in shared memory, then whole rows
  // out in 16-byte chunks
  using O = Out<E, EPI>;
  constexpr int OCH = chunk<O>();
  constexpr int OLD = kBN + OCH;
  O* tile = reinterpret_cast<O*>(smem_raw);
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 16 * MI + 16 * i + g + 8 * h;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = wn * 32 + 8 * j + 2 * t;
        const int n = n0 + cl;
        float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (EPI == kBiasRound) {
          if (n < p.N) v0 += to_f(p.bias[n]);
          if (n + 1 < p.N) v1 += to_f(p.bias[n + 1]);
        }
        put2<O>(tile + r * OLD + cl, v0, v1, true);
      }
    }
  __syncthreads();
  O* out = static_cast<O*>(p.out) +
           (EPI == kF32 ? (size_t)blockIdx.z * p.M * p.N : 0);
  const bool vec = p.N % OCH == 0 && (uintptr_t)out % 16 == 0;
  constexpr int CPR = kBN / OCH;
  for (int c = tid; c < BM * CPR; c += kGemmThreads) {
    const int r = c / CPR;
    const int cc = (c - r * CPR) * OCH;
    const int m = m0 + r;
    const int n = n0 + cc;
    if (m >= p.M || n >= p.N) continue;
    const O* src = tile + r * OLD + cc;
    O* dst = out + (size_t)m * p.N + n;
    if (vec && n + OCH <= p.N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < OCH && n + e < p.N; ++e) dst[e] = src[e];
    }
  }
}

// -- LayerNorm --------------------------------------------------------------

constexpr int kLnThreads = 256;  // threads of an ln_rows_body block

// ln = LN(x) rounded to E; mu, rs (f32 statistics) written where not null.
// vec (x and ln 16-byte aligned, C a whole number of at most kLnThreads
// chunks): one 16-byte chunk a thread, a block holding whole tokens
// (kLnThreads / (C / chunk) of them), so every thread's load is in flight
// at once; each thread adds its token's partial sums from shared memory
// in chunk order. Otherwise one warp a token, element by element.
template <typename E>
__device__ __forceinline__ void ln_rows_body(const E* __restrict__ x,
                                             const float* __restrict__ ln_s,
                                             const float* __restrict__ ln_b,
                                             float* __restrict__ mu,
                                             float* __restrict__ rs,
                                             E* __restrict__ ln, int P, int C,
                                             int vec) {
  constexpr int CH = chunk<E>();
  float s = 0.f, s2 = 0.f;
  if (vec) {
    __shared__ float part[2][kLnThreads];
    const int nch = C / CH;
    const int tpb = kLnThreads / nch;  // tokens a block
    const int tl = threadIdx.x / nch;
    const int c = (threadIdx.x - tl * nch) * CH;
    const long long pt = (long long)blockIdx.x * tpb + tl;
    const bool live = tl < tpb && pt < P;
    float v[CH];
    if (live) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + pt * C + c);
      const E* e = reinterpret_cast<const E*>(&raw);
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        v[j] = to_f(e[j]);
        s += v[j];
        s2 += v[j] * v[j];
      }
    }
    part[0][threadIdx.x] = s;
    part[1][threadIdx.x] = s2;
    __syncthreads();
    if (!live) return;
    s = s2 = 0.f;
    for (int i = tl * nch; i < (tl + 1) * nch; ++i) {
      s += part[0][i];
      s2 += part[1][i];
    }
    const float m = s / C;
    const float r = rsqrtf(fmaxf(s2 / C - m * m, 0.f) + kLnEps);
    if (c == 0 && mu != nullptr) {
      mu[pt] = m;
      rs[pt] = r;
    }
    uint4 raw;
    E* e = reinterpret_cast<E*>(&raw);
#pragma unroll
    for (int j = 0; j < CH; ++j)
      e[j] = from_f<E>((v[j] - m) * r * ln_s[c + j] + ln_b[c + j]);
    *reinterpret_cast<uint4*>(ln + pt * C + c) = raw;
    return;
  }
  const int p = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (p >= P) return;
  const E* xt = x + (size_t)p * C;
  for (int k = lane; k < C; k += 32) {
    const float v = to_f(xt[k]);
    s += v;
    s2 += v * v;
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float m = s / C;
  const float r = rsqrtf(fmaxf(s2 / C - m * m, 0.f) + kLnEps);
  if (lane == 0 && mu != nullptr) {
    mu[p] = m;
    rs[p] = r;
  }
  E* out = ln + (size_t)p * C;
  for (int k = lane; k < C; k += 32)
    out[k] = from_f<E>((to_f(xt[k]) - m) * r * ln_s[k] + ln_b[k]);
}

// whether ln_rows_body may take its 16-byte path for rows of C elements
template <typename E>
inline int ln_vec_ok(const void* x, const void* ln, int C) {
  return (uintptr_t)x % 16 == 0 && (uintptr_t)ln % 16 == 0 &&
         C % chunk<E>() == 0 && C / chunk<E>() <= kLnThreads;
}

// the kLnThreads-thread blocks ln_rows_body needs for P tokens
template <typename E>
inline int ln_blocks(int P, int C, int vec) {
  const int per_block = vec ? kLnThreads / (C / chunk<E>()) : kLnThreads / 32;
  return (int)(((long long)P + per_block - 1) / per_block);
}

// -- host side ---------------------------------------------------------------

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// a row of ld elements starting at p keeps every 16-byte chunk aligned
template <typename E>
inline int vec_ok(const void* p, long long ld) {
  return ((uintptr_t)p % 16 == 0) && (ld % chunk<E>() == 0);
}

// Launches a GEMM over the (N, M) tiles and `splits` K ranges: `k128`
// (a __global__ wrapping gemm_body<E, A_KM, B_KM, EPI, 4>) where its grid
// still fills the card twice, else `k64` (the same with MI = 2). Each
// output sums its K range in the same order either way, so the choice
// never changes a result.
template <typename E, bool A_KM, bool B_KM, int EPI>
inline int gemm_launch(void (*k64)(GemmArgs<E>), void (*k128)(GemmArgs<E>),
                       GemmArgs<E> p, int splits, cudaStream_t st) {
  splits = splits < 1 ? 1 : splits;
  const bool big = (long long)cdiv(p.M, 2 * kBM) * cdiv(p.N, kBN) * splits >=
                   kFill;
  const int smem = big ? gemm_smem_bytes<E, A_KM, B_KM, EPI, 4>()
                       : gemm_smem_bytes<E, A_KM, B_KM, EPI, 2>();
  void (*kern)(GemmArgs<E>) = big ? k128 : k64;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  p.vec_a = vec_ok<E>(p.a, p.lda);
  p.vec_b = vec_ok<E>(p.b, p.ldb);
  if (splits == 1) p.k_per_split = cdiv(p.K, kBK) * kBK;
  const dim3 grid(cdiv(p.N, kBN), cdiv(p.M, big ? 2 * kBM : kBM), splits);
  kern<<<grid, kGemmThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace swin
