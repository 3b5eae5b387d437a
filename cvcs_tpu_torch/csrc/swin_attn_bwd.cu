// Swin fused window attention, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bwd_pallas` / `_make_bwd_kernel` of
// cvcs_tpu/ops/pallas_swin.py (:436; per-window core `_attn_bwd_core`).
// Given the forward's inputs (the rolled, window-padded map x (B, Hp, Wp,
// C), the LN, QKV and output-projection parameters, the additive mask) and
// the output cotangent g, one call returns dx in the element type E and
// the f32 gradients of ln scale, ln bias, wqkv, bqkv, wout and bout.
//
// Casting points are the TPU kernel's: the recomputed LN output and qkv,
// da = g wout^T, the probabilities p (p32 stays f32 for ds), the recomputed
// head outputs o, ds and the merged dq/dk/dv are rounded to E; every
// product accumulates in f32; dx is computed in f32 and then rounded.
//
// Design. The TPU kernel carries its weight-gradient sums from one grid
// step to the next (its grid runs in order). CUDA blocks run in parallel
// and in no order, so here every sum over tokens is split into fixed
// ranges, each owned by one block, and the ranges are added by a second
// pass in a fixed order: no atomics, and repeats are bit-equal. One call
// launches, on the caller's stream, these kernels (their names carry the
// prefix swin_bwd_, so a profile can tell them apart from the forward's):
//
//   1. ln_fwd:    LN statistics (mu, rstd) and the rounded LN output, one
//                 warp per token;
//   2. gemm:      qkv = ln wqkv + bqkv (rounded);
//   3. gemm:      da = g wout^T (rounded);
//   4. attn:      one block of four warps per (image, window, head):
//                 s = q k^T, softmax, o = p v, dp = do v^T, ds, dq = ds k,
//                 dv = p^T do, dk = ds^T q, every product on mma.sync;
//   5. gemm:      dln = dq2 wqkv^T (f32), split over its 3C-deep sum
//                 into partials where its grid alone would not fill the
//                 card;
//   6. ln_bwd:    dx from dln (the partials added in order), one warp per
//                 token;
//   7. gemm:      dwqkv = ln^T dq2 and dwout = o^T g, split over tokens
//                 into per-split f32 partials;
//   8. colsum:    dbqkv = sum dq2, dbout = sum g, dlns = sum dln * xhat,
//                 dlnb = sum dln, split the same way (one launch);
//   9. reduce:    the partials of each gradient summed in split order (one
//                 launch for all six).
//
// Intermediates (LN output, qkv, da, o, dq2, dln) go through a workspace
// the caller allocates (`cvcs_swin_attn_bwd_workspace` bytes). What bounds
// it on the H100: about 22*N*C^2 + 12*N*T*C operations for N tokens, most
// of them the GEMMs of steps 2, 3, 5 and 7, so the tensor cores' rate.
// Those GEMMs are the tensor-core template of swin_tiles.cuh (shared with
// K1, instantiated here as swin_bwd_gemm): a 64 x 96 or 128 x 96 tile, a
// cp.async ring, the NN, NT and TN operand layouts read by ldmatrix /
// ldmatrix.trans from the staged tiles (no transposed copies); step 4
// does all six of its products on mma.sync with bf16 operands and f32
// accumulation. The f32 instance runs the same kernels with an FMA inner
// product (not TF32). Steps 1, 6, 8 and 9 pass over N*C elements once or
// twice each. Measured on the H100 (PERF.md section 6): at the p-224
// training shapes a call's GEMMs take under 0.1 ms at 65-100 TFLOP/s, and
// its ten launches, their gaps and the wrapper's host cost set its time,
// not the tensor cores' rate.

#include "swin_tiles.cuh"

namespace {

using namespace swin;

constexpr int kThreads = 256;      // the per-token and column-sum kernels
constexpr int kAttnThreads = 128;  // four warps: 16 rows each
constexpr int kSums = 264;         // blocks a split sum aims for (2 per SM)

// 1. LN statistics and rounded LN output, one warp per token.
template <typename E>
__global__ void __launch_bounds__(kLnThreads)
    swin_bwd_ln_fwd(const E* __restrict__ x, const float* __restrict__ ln_s,
                    const float* __restrict__ ln_b, float* __restrict__ mu,
                    float* __restrict__ rs, E* __restrict__ ln, int P, int C,
                    int vec) {
  ln_rows_body<E>(x, ln_s, ln_b, mu, rs, ln, P, C, vec);
}

// Steps 2, 3, 5 and 7.
template <typename E, bool A_KM, bool B_KM, int EPI, int MI>
__global__ void __launch_bounds__(kGemmThreads) swin_bwd_gemm(GemmArgs<E> p) {
  gemm_body<E, A_KM, B_KM, EPI, MI>(p);
}

template <typename E, bool A_KM, bool B_KM, int EPI>
int gemm(const GemmArgs<E>& p, int splits, cudaStream_t st) {
  return gemm_launch<E, A_KM, B_KM, EPI>(
      swin_bwd_gemm<E, A_KM, B_KM, EPI, 2>,
      swin_bwd_gemm<E, A_KM, B_KM, EPI, 4>, p, splits, st);
}

template <typename E, int DP>
__host__ __device__ constexpr int attn_smem_bytes() {
  // q, k, v, do (64 x DP) and p, ds (64 x 64)
  return (4 * kMaxT * (DP + chunk<E>()) + 2 * kMaxT * (kMaxT + chunk<E>())) *
         (int)sizeof(E);
}

// 4. Attention backward of one (image, window, head). Reads q, k, v from
// the recomputed qkv and do from da; writes the rounded head output o to
// `a_out` and the rounded dq, dk, dv to `dq2` (all in pixel order). Warp w
// owns query rows 16w .. 16w + 15 for s, dp, o, ds and dq, and key rows
// 16w .. 16w + 15 for dv and dk. DP: the head dim padded to a multiple of
// 16 with zero columns; rows past T are zero.
template <typename E, int DP>
__global__ void __launch_bounds__(kAttnThreads)
    swin_bwd_attn(const E* __restrict__ qkv, const E* __restrict__ da,
                  const float* __restrict__ bias, E* __restrict__ a_out,
                  E* __restrict__ dq2, int Hp, int Wp, int C, int heads,
                  int win, float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int CH = chunk<E>();
  constexpr int LD = DP + CH;
  constexpr int PLD = kMaxT + CH;
  E* Qs = reinterpret_cast<E*>(smem_raw);
  E* Ks = Qs + kMaxT * LD;
  E* Vs = Ks + kMaxT * LD;
  E* Ds = Vs + kMaxT * LD;    // do
  E* Ps = Ds + kMaxT * LD;    // p, rounded
  E* DSs = Ps + kMaxT * PLD;  // ds, rounded

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
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const size_t C3 = 3 * (size_t)C;

  // token t of this window sits at pixel (wy*win + t/win, wx*win + t%win)
  auto pix = [&](int t) -> size_t {
    const int r = t / win;
    const int c = t - r * win;
    return (size_t)(b * Hp + wy * win + r) * Wp + (wx * win + c);
  };

  // rows r0 + g, r0 + g + 8 of a 16 x DP accumulator, rounded, to
  // dst[pix(row) * ld + off + h * d + col] for row < T and col < d
  auto store_rows = [&](const float(&acc)[1][DP / 8][4], E* dst, size_t ld,
                        size_t off, int r0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + g + 8 * hh;
      if (row >= T) continue;
      E* p = dst + pix(row) * ld + off + h * d;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * t4;
        if (col < d)
          put2<E>(p + col, acc[0][j][2 * hh], acc[0][j][2 * hh + 1],
                  col + 1 < d);
      }
    }
  };

  constexpr int CPR = DP / CH;
  for (int i = tid; i < 4 * kMaxT * CPR; i += kAttnThreads) {
    const int part = i / (kMaxT * CPR);
    const int rem = i - part * kMaxT * CPR;
    const int t = rem / CPR;
    const int c = (rem - t * CPR) * CH;
    E* dst = Qs + part * kMaxT * LD + t * LD + c;
    const E* src = qkv;
    if (t < T)
      src = part < 3 ? qkv + pix(t) * C3 + part * C + h * d + c
                     : da + pix(t) * C + h * d + c;
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

  const int r0 = warp * 16;  // this warp's rows
  const bool active = r0 < T;
  const int TQ = (T + 15) & ~15;  // rows of p and ds that warps write
  if (active) {
    // s = q k^T * scale + bias -> p32 (f32, in registers)
    float s[1][8][4];
    zero(s);
#pragma unroll
    for (int k0 = 0; k0 < DP; k0 += 16)
      warp_mma_k16<E, false, false, 1, 8>(s, Qs, LD, Ks, LD, r0, 0, k0, lane);
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
    // p32 in s; p (rounded, zero on rows past T) to shared memory
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const bool live = r0 + g + 8 * hh < T;
        s[0][j][2 * hh] = live ? s[0][j][2 * hh] / sum[hh] : 0.f;
        s[0][j][2 * hh + 1] = live ? s[0][j][2 * hh + 1] / sum[hh] : 0.f;
        put2<E>(Ps + (r0 + g + 8 * hh) * PLD + 8 * j + 2 * t4,
                s[0][j][2 * hh], s[0][j][2 * hh + 1], true);
      }

    // dp = do v^T
    float dp[1][8][4];
    zero(dp);
#pragma unroll
    for (int k0 = 0; k0 < DP; k0 += 16)
      warp_mma_k16<E, false, false, 1, 8>(dp, Ds, LD, Vs, LD, r0, 0, k0,
                                          lane);
    // ds = p32 * (dp - sum(dp * p32)) * scale, rounded
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) rsum[e >> 1] += dp[0][j][e] * s[0][j][e];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rsum[hh] += __shfl_xor_sync(0xffffffffu, rsum[hh], 1);
      rsum[hh] += __shfl_xor_sync(0xffffffffu, rsum[hh], 2);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        put2<E>(DSs + (r0 + g + 8 * hh) * PLD + 8 * j + 2 * t4,
                s[0][j][2 * hh] * (dp[0][j][2 * hh] - rsum[hh]) * scale,
                s[0][j][2 * hh + 1] * (dp[0][j][2 * hh + 1] - rsum[hh]) *
                    scale,
                true);
    __syncwarp();

    // o = p v -> a_out; dq = ds k -> dq2[:, 0:C]
    float acc[1][DP / 8][4];
    zero(acc);
#pragma unroll
    for (int k0 = 0; k0 < TQ; k0 += 16)
      warp_mma_k16<E, false, true, 1, DP / 8>(acc, Ps, PLD, Vs, LD, r0, 0, k0,
                                              lane);
    store_rows(acc, a_out, C, 0, r0);
    zero(acc);
#pragma unroll
    for (int k0 = 0; k0 < TQ; k0 += 16)
      warp_mma_k16<E, false, true, 1, DP / 8>(acc, DSs, PLD, Ks, LD, r0, 0,
                                              k0, lane);
    store_rows(acc, dq2, C3, 0, r0);
  }
  __syncthreads();  // every row of p and ds is in shared memory
  if (!active) return;

  // dv = p^T do -> dq2[:, 2C:3C]; dk = ds^T q -> dq2[:, C:2C]
  float acc[1][DP / 8][4];
  zero(acc);
#pragma unroll
  for (int k0 = 0; k0 < TQ; k0 += 16)
    warp_mma_k16<E, true, true, 1, DP / 8>(acc, Ps, PLD, Ds, LD, r0, 0, k0,
                                           lane);
  store_rows(acc, dq2, C3, 2 * C, r0);
  zero(acc);
#pragma unroll
  for (int k0 = 0; k0 < TQ; k0 += 16)
    warp_mma_k16<E, true, true, 1, DP / 8>(acc, DSs, PLD, Qs, LD, r0, 0, k0,
                                           lane);
  store_rows(acc, dq2, C3, C, r0);
}

// 6. dx = rs * (dxh - mean(dxh) - xhat * mean(dxh * xhat)), dxh = dln * lns,
// one warp per token. dln arrives as S partial sums over K ranges (S x P x
// C, the first at dln itself): they are added in range order and the sum
// is written back to dln for the LN parameter grads.
template <typename E>
__global__ void __launch_bounds__(kThreads)
    swin_bwd_ln_bwd(const E* __restrict__ x, const float* __restrict__ mu,
                    const float* __restrict__ rs,
                    const float* __restrict__ ln_s, float* __restrict__ dln,
                    E* __restrict__ dx, int P, int C, int S) {
  const int p = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (p >= P) return;
  const E* xt = x + (size_t)p * C;
  float* gt = dln + (size_t)p * C;
  const size_t stride = (size_t)P * C;
  const float m = mu[p];
  const float r = rs[p];
  float s1 = 0.f, s2 = 0.f;
  for (int k = lane; k < C; k += 32) {
    float gk = gt[k];
    for (int sp = 1; sp < S; ++sp) gk += gt[sp * stride + k];
    if (S > 1) gt[k] = gk;
    const float xh = (to_f(xt[k]) - m) * r;
    const float dxh = gk * ln_s[k];
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

// 8. The column sums, one launch: blockIdx.z 0 sums dq2 (P x 3C) into the
// dbqkv partials, 1 sums g (P x C) into the dbout partials, 2 sums dln * xhat
// and dln into the LN parameter grads' partials; each over the rows of
// split blockIdx.y. A block takes 32 columns: its eight warps sum every
// eighth row of the split, and warp 0 adds the eight sums in warp order.
template <typename E>
__global__ void __launch_bounds__(kThreads)
    swin_bwd_colsum(const E* __restrict__ dq2, const E* __restrict__ g,
                    const float* __restrict__ dln, const E* __restrict__ x,
                    const float* __restrict__ mu, const float* __restrict__ rs,
                    float* __restrict__ p_bqkv, float* __restrict__ p_bout,
                    float* __restrict__ p_lns, float* __restrict__ p_lnb, int P,
                    int C, int rows_qkv, int s_qkv, int rows_c, int s_c) {
  __shared__ float part[2][kThreads / 32][33];
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int task = blockIdx.z;
  const int M = task == 0 ? 3 * C : C;
  const int rows = task == 0 ? rows_qkv : rows_c;
  if ((int)blockIdx.y >= (task == 0 ? s_qkv : s_c) ||
      (int)blockIdx.x * 32 >= M)
    return;  // the whole block
  const int col = blockIdx.x * 32 + tx;
  const int r0 = blockIdx.y * rows;
  const int r1 = min(P, r0 + rows);
  float sa = 0.f, sb = 0.f;
  if (col < M) {
    if (task < 2) {
      const E* in = task == 0 ? dq2 : g;
      for (int r = r0 + ty; r < r1; r += kThreads / 32)
        sa += to_f(in[(size_t)r * M + col]);
    } else {
      for (int r = r0 + ty; r < r1; r += kThreads / 32) {
        const size_t i = (size_t)r * C + col;
        const float gr = dln[i];
        sa += gr * ((to_f(x[i]) - mu[r]) * rs[r]);
        sb += gr;
      }
    }
  }
  part[0][ty][tx] = sa;
  part[1][ty][tx] = sb;
  __syncthreads();
  if (ty != 0 || col >= M) return;
  sa = sb = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    sa += part[0][w][tx];
    sb += part[1][w][tx];
  }
  const size_t out = (size_t)blockIdx.y * M + col;
  if (task == 0) {
    p_bqkv[out] = sa;
  } else if (task == 1) {
    p_bout[out] = sa;
  } else {
    p_lns[out] = sa;
    p_lnb[out] = sb;
  }
}

// 9. For each gradient j = blockIdx.y whose sum was split: out[i] = the sum
// over splits s = 0, 1, ... of part[s * M + i].
struct Reduce {
  const float* part[6];
  float* out[6];
  int S[6], M[6];
  int n;
};

__global__ void __launch_bounds__(kThreads) swin_bwd_reduce(Reduce r) {
  const int j = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= r.n || i >= r.M[j]) return;
  const float* part = r.part[j];
  float s = 0.f;
  for (int k = 0; k < r.S[j]; ++k) s += part[(size_t)k * r.M[j] + i];
  r.out[j][i] = s;
}

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
  Split sw_qkv, sw_out, sc_qkv, sc_out, sd;
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
  pl.sw_qkv = split_for(P, cdiv(C, kBM) * cdiv(3 * C, kBN), kBK);
  pl.sw_out = split_for(P, cdiv(C, kBM) * cdiv(C, kBN), kBK);
  pl.sc_qkv = split_for(P, cdiv(3 * C, 32), 1);
  pl.sc_out = split_for(P, cdiv(C, 32), 1);
  // dln = dq2 wqkv^T sums over 3C: split it where its grid is small, at
  // least four K slices a split
  const int dln_blocks = cdiv(P, kBM) * cdiv(C, kBN);
  int sd = dln_blocks >= kFill ? 1 : cdiv(kFill, dln_blocks);
  const int max_sd = cdiv(3 * C, 4 * kBK);
  sd = sd > max_sd ? max_sd : sd;
  const int sd_per = cdiv(cdiv(3 * C, sd), kBK) * kBK;
  pl.sd = Split{cdiv(3 * C, sd_per), sd_per};
  size_t off = 0;
  pl.mu = take(off, (size_t)P * 4);
  pl.rs = take(off, (size_t)P * 4);
  pl.ln = take(off, (size_t)P * C * es);
  pl.qkv = take(off, (size_t)P * 3 * C * es);
  pl.da = take(off, (size_t)P * C * es);
  pl.a = take(off, (size_t)P * C * es);
  pl.dq2 = take(off, (size_t)P * 3 * C * es);
  pl.dln = take(off, (size_t)pl.sd.S * P * C * 4);
  pl.p_wqkv = take(off, (size_t)pl.sw_qkv.S * C * 3 * C * 4);
  pl.p_wout = take(off, (size_t)pl.sw_out.S * C * C * 4);
  pl.p_bqkv = take(off, (size_t)pl.sc_qkv.S * 3 * C * 4);
  pl.p_bout = take(off, (size_t)pl.sc_out.S * C * 4);
  pl.p_lns = take(off, (size_t)pl.sc_out.S * C * 4);
  pl.p_lnb = take(off, (size_t)pl.sc_out.S * C * 4);
  pl.total = off;
  return pl;
}

#define CHECK_LAUNCH()                          \
  do {                                          \
    cudaError_t e_ = cudaGetLastError();        \
    if (e_ != cudaSuccess) return (int)e_;      \
  } while (0)


template <typename E, int DP>
int launch_attn(const E* qkv, const E* da, const float* bias, E* a, E* dq2,
                int B, int Hp, int Wp, int C, int heads, int win, float scale,
                cudaStream_t st) {
  const int smem = attn_smem_bytes<E, DP>();
  cudaError_t err =
      cudaFuncSetAttribute(swin_bwd_attn<E, DP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int d = C / heads;
  const int vec = vec_ok<E>(qkv, 3LL * C) && vec_ok<E>(da, C) &&
                  d % chunk<E>() == 0;
  const long long blocks = (long long)B * (Hp / win) * (Wp / win) * heads;
  swin_bwd_attn<E, DP><<<(unsigned)blocks, kAttnThreads, smem, st>>>(
      qkv, da, bias, a, dq2, Hp, Wp, C, heads, win, scale, vec);
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
  float* p_lns = part(pl.p_lns, pl.sc_out.S, dlns);
  float* p_lnb = part(pl.p_lnb, pl.sc_out.S, dlnb);

  const int warps_blocks = cdiv((long long)P * 32, kThreads);
  const int vec = ln_vec_ok<E>(x, ln, C);
  swin_bwd_ln_fwd<E><<<ln_blocks<E>(P, C, vec), kLnThreads, 0, st>>>(
      x, ln_s, ln_b, mu, rs, ln, P, C, vec);
  CHECK_LAUNCH();
  auto args = [](const E* lhs, const E* rhs, const E* add, void* out, int M,
                 int N, int K, int lda, int ldb) {
    GemmArgs<E> p{};
    p.a = lhs;
    p.b = rhs;
    p.bias = add;
    p.out = out;
    p.M = M;
    p.N = N;
    p.K = K;
    p.lda = lda;
    p.ldb = ldb;
    return p;
  };
  int rc;
  // 2. qkv = ln wqkv + bqkv; 3. da = g wout^T
  if ((rc = gemm<E, false, true, kBiasRound>(
           args(ln, wqkv, bqkv, qkv, P, C3, C, C, C3), 1, st)))
    return rc;
  if ((rc = gemm<E, false, false, kRound>(
           args(g, wout, nullptr, da, P, C, C, C, C), 1, st)))
    return rc;

  // 4. the attention backward, one block per (image, window, head)
  const int d = C / heads;
  if (d <= 16)
    rc = launch_attn<E, 16>(qkv, da, bias, a, dq2, B, Hp, Wp, C, heads, win,
                            scale, st);
  else if (d <= 32)
    rc = launch_attn<E, 32>(qkv, da, bias, a, dq2, B, Hp, Wp, C, heads, win,
                            scale, st);
  else if (d <= 48)
    rc = launch_attn<E, 48>(qkv, da, bias, a, dq2, B, Hp, Wp, C, heads, win,
                            scale, st);
  else
    rc = launch_attn<E, 64>(qkv, da, bias, a, dq2, B, Hp, Wp, C, heads, win,
                            scale, st);
  if (rc) return rc;

  // 5. dln = dq2 wqkv^T, in pl.sd.S partials; 6. dx (adds them)
  GemmArgs<E> pw = args(dq2, wqkv, nullptr, dln, P, C, C3, C3, C3);
  pw.k_per_split = pl.sd.per;
  if ((rc = gemm<E, false, false, kF32>(pw, pl.sd.S, st))) return rc;
  swin_bwd_ln_bwd<E><<<warps_blocks, kThreads, 0, st>>>(x, mu, rs, ln_s, dln,
                                                      dx, P, C, pl.sd.S);
  CHECK_LAUNCH();

  // 7. dwqkv = ln^T dq2, dwout = o^T g, split over tokens
  pw = args(ln, dq2, nullptr, p_wqkv, C, C3, P, C, C3);
  pw.k_per_split = pl.sw_qkv.per;
  if ((rc = gemm<E, true, true, kF32>(pw, pl.sw_qkv.S, st))) return rc;
  pw = args(a, g, nullptr, p_wout, C, C, P, C, C);
  pw.k_per_split = pl.sw_out.per;
  if ((rc = gemm<E, true, true, kF32>(pw, pl.sw_out.S, st))) return rc;

  // 8. column sums
  const int sc = pl.sc_qkv.S > pl.sc_out.S ? pl.sc_qkv.S : pl.sc_out.S;
  swin_bwd_colsum<E><<<dim3(cdiv(C3, 32), sc, 3), kThreads, 0, st>>>(
      dq2, g, dln, x, mu, rs, p_bqkv, p_bout, p_lns, p_lnb, P, C,
      pl.sc_qkv.per, pl.sc_qkv.S, pl.sc_out.per, pl.sc_out.S);
  CHECK_LAUNCH();

  // 9. the split sums, added in split order (a sum of one split is its
  // gradient already)
  Reduce red{};
  int widest = 0;
  const struct {
    const float* part;
    float* out;
    int S, M;
  } sums[6] = {{p_wqkv, dwqkv, pl.sw_qkv.S, C * C3},
               {p_wout, dwout, pl.sw_out.S, C * C},
               {p_bqkv, dbqkv, pl.sc_qkv.S, C3},
               {p_bout, dbout, pl.sc_out.S, C},
               {p_lns, dlns, pl.sc_out.S, C},
               {p_lnb, dlnb, pl.sc_out.S, C}};
  for (const auto& u : sums) {
    if (u.S == 1) continue;
    red.part[red.n] = u.part;
    red.out[red.n] = u.out;
    red.S[red.n] = u.S;
    red.M[red.n] = u.M;
    widest = u.M > widest ? u.M : widest;
    ++red.n;
  }
  if (red.n == 0) return 0;
  swin_bwd_reduce<<<dim3(cdiv(widest, kThreads), red.n), kThreads, 0, st>>>(
      red);
  return (int)cudaGetLastError();
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
