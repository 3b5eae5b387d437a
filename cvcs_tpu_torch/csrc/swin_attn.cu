// Swin fused window attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_pallas` / `_make_kernel` of
// cvcs_tpu/ops/pallas_swin.py (:176). One op call computes the pre-MLP
// half of a Swin block over the rolled, window-padded map x (B, Hp, Wp, C):
//
//   LayerNorm (f32 stats, fast variance, eps 1e-6) -> x Wqkv + bqkv ->
//   per window and head softmax(q k^T / sqrt(d) + bias) v -> x Wout + bout
//
// with the casting points of the TPU kernel: the LN output, the QKV
// projection, the softmax probabilities and each head's output are rounded
// to the element type E; every product is accumulated in f32.
//
// What bounds it on the H100: 8*N*C^2 + 4*N*T*C operations for N tokens
// against 2*N*C elements in and out, so the two projections (8*N*C^2) are
// most of the work and at C >= 192 the op is bound by the tensor cores'
// rate. Only the attention itself is per-window work: LN and both
// projections are per token. So one op call launches, on the caller's
// stream, four kernels (names carry swin_attn_fwd, so a profile tells them
// from the backward's swin_bwd_ ones):
//
//   1. swin_attn_fwd_ln:   LN of every token, rounded, into the workspace
//                          (one warp per token);
//   2. swin_attn_fwd_gemm: qkv = ln Wqkv + bqkv, rounded: a tensor-core
//                          GEMM over all N tokens (swin_tiles.cuh);
//   3. swin_attn_fwd_core: one block of four warps per (image, window,
//                          head), one warp per 16 query rows: S = q k^T on
//                          mma.sync, scale, mask, softmax in f32 registers
//                          (T <= 64 is one KV tile: no online rescaling), P
//                          rounded, O = P v on mma.sync, O rounded into the
//                          merged-heads workspace;
//   4. swin_attn_fwd_gemm: out = o Wout + bout, rounded, into `out`.
//
// The grid covers output tiles of (N, 3C) and (window, head) pairs, so the
// card fills at every stage whatever the number of windows (stage 4 of a
// p-224 training step: 10 windows, yet 96 GEMM blocks and 240 attention
// blocks). The LN output is written once rather than applied on the GEMM's
// A-tile load: the GEMM then stages both operands by cp.async alone, and
// the same GEMM serves every product of K1 and K2 (K2 keeps the LN output
// for its weight gradient anyway); it costs one more pass over N*C
// elements. Every product is on mma.sync with bf16 operands and f32
// accumulation; the f32 instance runs the same kernels with an FMA inner
// product (not TF32). Nothing is summed across blocks: repeats are
// bit-equal.
//
// Measured on the H100 (PERF.md section 6): the GEMMs run at about
// 100-180 TFLOP/s, so from stage 2 on they are most of an op call; at
// stage 1 (C = 96) the call is bound by the round trips of the LN output,
// qkv and the head outputs through device memory; at the training shapes
// every kernel is a few microseconds and the launches set the pace.
// wgmma with a TMA pipeline, and the LN folded into the QKV GEMM's A-tile
// load, are the next steps.

#include "swin_tiles.cuh"

namespace {

using namespace swin;

constexpr int kCoreThreads = 128;  // four warps: 16 query rows each

template <typename E>
__global__ void __launch_bounds__(kLnThreads)
    swin_attn_fwd_ln(const E* __restrict__ x, const float* __restrict__ ln_s,
                     const float* __restrict__ ln_b, E* __restrict__ ln, int P,
                     int C, int vec) {
  ln_rows_body<E>(x, ln_s, ln_b, nullptr, nullptr, ln, P, C, vec);
}

template <typename E, bool A_KM, bool B_KM, int EPI, int MI>
__global__ void __launch_bounds__(kGemmThreads)
    swin_attn_fwd_gemm(GemmArgs<E> p) {
  gemm_body<E, A_KM, B_KM, EPI, MI>(p);
}

template <typename E, bool A_KM, bool B_KM, int EPI>
int gemm(const GemmArgs<E>& p, cudaStream_t st) {
  return gemm_launch<E, A_KM, B_KM, EPI>(
      swin_attn_fwd_gemm<E, A_KM, B_KM, EPI, 2>,
      swin_attn_fwd_gemm<E, A_KM, B_KM, EPI, 4>, p, 1, st);
}

template <typename E, int DP>
__host__ __device__ constexpr int core_smem_bytes() {
  // q, k, v of one head (64 x DP) and each warp's 16 x 64 probabilities
  return (3 * kMaxT * (DP + chunk<E>()) + 4 * 16 * (kMaxT + chunk<E>())) *
         (int)sizeof(E);
}

// Attention of one (image, window, head): q, k, v from the qkv workspace
// (N, 3C) in pixel order, the rounded head output into o (N, C). DP: the
// head dim padded to a multiple of 16 with zero columns.
template <typename E, int DP>
__global__ void __launch_bounds__(kCoreThreads)
    swin_attn_fwd_core(const E* __restrict__ qkv,
                       const float* __restrict__ bias, E* __restrict__ o,
                       int Hp, int Wp, int C, int heads, int win, float scale,
                       int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int CH = chunk<E>();
  constexpr int LD = DP + CH;     // q, k, v row stride
  constexpr int PLD = kMaxT + CH;  // probability row stride
  E* Qs = reinterpret_cast<E*>(smem_raw);
  E* Ks = Qs + kMaxT * LD;
  E* Vs = Ks + kMaxT * LD;
  E* Ps = Vs + kMaxT * LD;  // [4 warps][16][PLD]

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
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t C3 = 3 * (size_t)C;

  // token t of this window sits at pixel (wy*win + t/win, wx*win + t%win)
  auto pix = [&](int t) -> size_t {
    const int r = t / win;
    const int c = t - r * win;
    return (size_t)(b * Hp + wy * win + r) * Wp + (wx * win + c);
  };

  // q, k, v: rows >= T and columns >= d are zero
  constexpr int CPR = DP / CH;
  for (int i = tid; i < 3 * kMaxT * CPR; i += kCoreThreads) {
    const int part = i / (kMaxT * CPR);
    const int rem = i - part * kMaxT * CPR;
    const int t = rem / CPR;
    const int c = (rem - t * CPR) * CH;
    E* dst = Qs + part * kMaxT * LD + t * LD + c;
    const E* src = t < T ? qkv + pix(t) * C3 + part * C + h * d + c : qkv;
    if (vec && t < T && c + CH <= d) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int j = 0; j < CH; ++j)
        dst[j] = (t < T && c + j < d) ? src[j] : from_f<E>(0.f);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int r0 = warp * 16;  // this warp's query rows r0 .. r0 + 15
  if (r0 >= T) return;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  // S = q k^T: 16 rows x 64 keys, K = DP
  float s[1][8][4];
  zero(s);
#pragma unroll
  for (int k0 = 0; k0 < DP; k0 += 16)
    warp_mma_k16<E, false, false, 1, 8>(s, Qs, LD, Ks, LD, r0, 0, k0, lane);

  // scale, mask, softmax over keys in f32; a row lives on the four lanes
  // of one quad (16 keys each), the reductions are two shuffles
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c0 = 8 * j + 2 * t4;
      const float2 b = mask_pair(bias, w, T, r0 + g + 8 * hh, c0);
      const float v0 = c0 < T ? s[0][j][2 * hh] * scale + b.x : -INFINITY;
      const float v1 =
          c0 + 1 < T ? s[0][j][2 * hh + 1] * scale + b.y : -INFINITY;
      s[0][j][2 * hh] = v0;
      s[0][j][2 * hh + 1] = v1;
      mx[hh] = fmaxf(mx[hh], fmaxf(v0, v1));
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float ex = expf(s[0][j][e] - mx[e >> 1]);
      s[0][j][e] = ex;
      sum[e >> 1] += ex;
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
  }
  E* Pw = Ps + warp * 16 * PLD;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      put2<E>(Pw + (g + 8 * hh) * PLD + 8 * j + 2 * t4,
              s[0][j][2 * hh] / sum[hh], s[0][j][2 * hh + 1] / sum[hh], true);
  __syncwarp();

  // O = P v: 16 rows x DP, K = the keys (P and v are zero past T)
  float acc[1][DP / 8][4];
  zero(acc);
#pragma unroll
  for (int k0 = 0; k0 < T; k0 += 16)
    warp_mma_k16<E, false, true, 1, DP / 8>(acc, Pw, PLD, Vs, LD, 0, 0, k0,
                                            lane);
  // O, rounded, through the warp's tile (P is consumed) so that each row
  // of the head leaves in 16-byte stores
  __syncwarp();
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      put2<E>(Pw + (g + 8 * hh) * PLD + 8 * j + 2 * t4, acc[0][j][2 * hh],
              acc[0][j][2 * hh + 1], true);
  __syncwarp();
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR;
    const int c = (i - r * CPR) * CH;
    if (r0 + r >= T || c >= d) continue;
    E* dst = o + pix(r0 + r) * C + h * d + c;
    const E* src = Pw + r * PLD + c;
    if (vec && c + CH <= d) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < CH && c + e < d; ++e) dst[e] = src[e];
    }
  }
}

template <typename E, int DP>
int launch_core(const E* qkv, const float* bias, E* o, int B, int Hp, int Wp,
                int C, int heads, int win, float scale, cudaStream_t st) {
  const int smem = core_smem_bytes<E, DP>();
  cudaError_t err =
      cudaFuncSetAttribute(swin_attn_fwd_core<E, DP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int d = C / heads;
  const int vec = vec_ok<E>(qkv, 3LL * C) && d % chunk<E>() == 0 &&
                  C % chunk<E>() == 0;
  const long long blocks = (long long)B * (Hp / win) * (Wp / win) * heads;
  swin_attn_fwd_core<E, DP><<<(unsigned)blocks, kCoreThreads, smem, st>>>(
      qkv, bias, o, Hp, Wp, C, heads, win, scale, vec);
  return (int)cudaGetLastError();
}

template <typename E>
int launch(const void* x_, const void* ln_s, const void* ln_b,
           const void* wqkv, const void* bqkv, const void* wout,
           const void* bout, const void* bias_, void* out, void* scratch,
           int B, int Hp, int Wp, int C, int heads, int win, float scale,
           cudaStream_t st) {
  const E* x = static_cast<const E*>(x_);
  const float* bias = static_cast<const float*>(bias_);
  const int P = B * Hp * Wp;
  E* qkv = static_cast<E*>(scratch);      // P x 3C
  E* ln = qkv + (size_t)P * 3 * C;        // P x C: the LN output, then o
  E* o = ln;

  const int vec = ln_vec_ok<E>(x, ln, C);
  swin_attn_fwd_ln<E><<<ln_blocks<E>(P, C, vec), kLnThreads, 0, st>>>(
      x, static_cast<const float*>(ln_s), static_cast<const float*>(ln_b), ln,
      P, C, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  GemmArgs<E> g{};
  g.a = ln;
  g.b = static_cast<const E*>(wqkv);
  g.bias = static_cast<const E*>(bqkv);
  g.out = qkv;
  g.M = P;
  g.N = 3 * C;
  g.K = C;
  g.lda = C;
  g.ldb = 3 * C;
  int rc = gemm<E, false, true, kBiasRound>(g, st);
  if (rc) return rc;

  const int d = C / heads;
  if (d <= 16)
    rc = launch_core<E, 16>(qkv, bias, o, B, Hp, Wp, C, heads, win, scale, st);
  else if (d <= 32)
    rc = launch_core<E, 32>(qkv, bias, o, B, Hp, Wp, C, heads, win, scale, st);
  else if (d <= 48)
    rc = launch_core<E, 48>(qkv, bias, o, B, Hp, Wp, C, heads, win, scale, st);
  else
    rc = launch_core<E, 64>(qkv, bias, o, B, Hp, Wp, C, heads, win, scale, st);
  if (rc) return rc;

  g.a = o;
  g.b = static_cast<const E*>(wout);
  g.bias = static_cast<const E*>(bout);
  g.out = out;
  g.N = C;
  g.ldb = C;
  return gemm<E, false, true, kBiasRound>(g, st);
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype 0 = float32, 1 = bfloat16.
// bias is (nWin, T, T) float32 or null. scratch holds 4*B*Hp*Wp*C elements
// of the element type (qkv, then the LN output and the head outputs).
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
