// Fused augmentation + normalisation (K5), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_augment` / `_augment_kernel` of
// cvcs_tpu/ops/pallas_augment.py:52-104. One pass from uint8 to f32 per
// patch:
//
//   uint8 -> f32; flip left-right (flips bit 0), flip up-down (bit 1), then
//   rot90 x k counter-clockwise (k clipped to 0..3); contrast jitter
//   (torchvision adjust_contrast: blend with the mean of the floored
//   ITU-R 601 grayscale of bands 0, 1 % C, 2 % C, clip to [0, 255], floor);
//   per-band (x - mean) / std.
//
// What bounds it on the H100: memory. B*P*P*C bytes read and 4*B*P*P*C
// written (120 MB for a 160-patch chunk of 224 x 224 x 3: 0.036 ms at
// 3.35 TB/s), a few operations per byte.
//
// What held the first design back (augment_v1.cu, one 1024-thread block
// per patch): 160 patches made 1.2 waves on 132 SMs; the patch was read
// twice (grayscale sum, then transform); every load was one byte; for odd
// rot90 counts consecutive threads read source pixels a row (P*C bytes)
// apart; every store was a scalar f32 with the C = 3 interleave; an
// integer divide per pixel and an IEEE divide per element.
//
// This design:
// * A thread-block cluster per patch (up to 8 CTAs, one per band of
//   output rows): a 160-patch chunk is 1,280 CTAs.
// * Each CTA stages in shared memory exactly the source region its band
//   maps from under the dihedral transform: a row band of the source for
//   even rot90 counts, a column band for odd ones (one segment per source
//   row), copied as the aligned 16-byte windows that hold it, one
//   cp.async each (the few bytes a window holds beside a segment that is
//   not 16-byte aligned are read and not used: an aligned 16-byte block
//   never crosses a page). The regions of a cluster partition the patch,
//   so each source byte is read from device memory once (the windows at a
//   segment's ends twice).
// * The grayscale mean from the same staged bytes: each CTA sums the
//   floored grayscale of its region in integers (exact in any order, for
//   any P), the CTAs add their partials through distributed shared memory
//   after one cluster barrier, and the mean is the f32 sum times the f32
//   reciprocal of P*P: the rounding of XLA's mean in the JAX kernel and of
//   torch's mean on the card, so the kernel is bit-equal to its plain twin
//   run on the card for P <= 256 (f32 sums of integers below 2^24).
// * The per-element arithmetic becomes a table. After the mean, an output
//   element depends only on its band and its source byte, so each CTA
//   builds out = (floor(clip(f * x + (1 - f) * mean)) - mean_c) / std_c for
//   the 256 byte values of each band (C <= 16; above, a 256-entry blend
//   table and the divide per element) with the same round-to-nearest
//   intrinsics as before, so nvcc contracts nothing into a fused
//   multiply-add and the table is bit-equal to computing each element.
// * Coalesced 16-byte stores: each thread writes 4 consecutive floats of
//   the band's flattened (rows x P x C) output, mapping each to its
//   (pixel, band) source byte in shared memory, so the C = 3 interleave
//   costs nothing in device memory. Per 4 floats, two divides done as
//   multiply-highs, then a source cursor that steps with the output.
// * 40 registers a thread (__launch_bounds__ with kMinBlocks), so that six
//   256-thread CTAs share an SM and cover each other's barriers.
// * A band too large to stage at once (from P = 512 at C = 4) is staged
//   in pieces of rows, and its grayscale sum is then read from device memory
//   in a first pass: such a patch is read twice. Where even one row's
//   region does not fit, the CTA reads its source bytes from device memory
//   directly. Every (B, P, C) runs on this kernel.
//
// The launch plan (cluster size, rows per band, rows per staged piece,
// shared memory) is `make_plan` below; ops/augment.py's `band_plan`
// mirrors it for the CPU tests, and `cvcs_augment_plan` exports it so
// that the card tests hold the two equal.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;             // the portable cluster size
constexpr int kStageBudget = 96 * 1024;    // staged source bytes per CTA
constexpr int kLutMaxC = 16;               // bands with a full table
constexpr int kMinBlocks = 6;              // CTAs an SM should hold (40 registers)

struct Plan {
  int cluster;      // CTAs per patch
  int band_rows;    // output rows per CTA
  int stage_rows;   // output rows staged at once; 0: read from device memory
  int smem;         // dynamic shared memory bytes
};

__host__ __device__ inline long long seg_pitch(long long len) {
  return ((len + 15) & ~15LL) + 16;   // room for a 16-byte misalignment
}

// Staged bytes for `rows` output rows: the larger of the even-rot90 region
// (rows source rows of P*C bytes) and the odd one (P source rows of
// rows*C bytes), each segment padded to its own 16-byte windows.
__host__ __device__ inline long long stage_bytes(long long rows, int P,
                                                 int C) {
  const long long even = rows * seg_pitch((long long)P * C);
  const long long odd = (long long)P * seg_pitch(rows * C);
  return even > odd ? even : odd;
}

inline int table_bytes(int C) { return (C <= kLutMaxC ? C : 1) * 256 * 4; }

Plan make_plan(int P, int C) {
  Plan pl;
  pl.cluster = P < kMaxCluster ? P : kMaxCluster;
  pl.band_rows = (P + pl.cluster - 1) / pl.cluster;
  int rows = pl.band_rows;
  if (stage_bytes(rows, P, C) > kStageBudget) {
    int lo = 0, hi = rows;    // the most rows within the budget, 0 if none
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (stage_bytes(mid, P, C) <= kStageBudget) lo = mid; else hi = mid - 1;
    }
    rows = lo;
  }
  pl.stage_rows = rows;
  pl.smem = table_bytes(C) + (rows ? (int)stage_bytes(rows, P, C) : 0);
  return pl;
}

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(s)),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// floor of the ITU-R 601 grayscale of one pixel's bands 0, 1 % C, 2 % C
__device__ __forceinline__ unsigned gray_floor(const uint8_t* px, int c1,
                                               int c2) {
  const float g = __fadd_rn(__fadd_rn(__fmul_rn(0.2989f, (float)px[0]),
                                      __fmul_rn(0.587f, (float)px[c1])),
                            __fmul_rn(0.114f, (float)px[c2]));
  return (unsigned)floorf(g);
}

struct Map {
  int oy, yy, yx, ox, xy, xx;
};

__device__ __forceinline__ Map dihedral_map(int fl, int k, int P) {
  const int pm = P - 1;
  k = k < 0 ? 0 : (k > 3 ? 3 : k);
  Map m;
  if (k == 0) {
    m = {0, 1, 0, 0, 0, 1};            // (y, x)
  } else if (k == 1) {
    m = {0, 0, 1, pm, -1, 0};          // (x, pm - y)
  } else if (k == 2) {
    m = {pm, -1, 0, pm, 0, -1};        // (pm - y, pm - x)
  } else {
    m = {pm, 0, -1, 0, 1, 0};          // (pm - x, y)
  }
  if (fl & 2) m = {pm - m.oy, -m.yy, -m.yx, m.ox, m.xy, m.xx};
  if (fl & 1) m = {m.oy, m.yy, m.yx, pm - m.ox, -m.xy, -m.xx};
  return m;
}

// Idx: the index type of a patch's flattened elements: 32 bits while
// P^3 and (P*C)^2 are below 2^32 (the fast divisions are exact there),
// else 64.
template <typename Idx>
__global__ void __launch_bounds__(kThreads, kMinBlocks) augment_kernel(
    const uint8_t* __restrict__ img, const int* __restrict__ flips,
    const int* __restrict__ rots, const float* __restrict__ factors,
    const float* __restrict__ band_mean, const float* __restrict__ band_std,
    float* __restrict__ out, int P, int C, Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long warp_sum[kThreads / 32];
  __shared__ unsigned long long part;      // this CTA's grayscale sum
  __shared__ float mean_s;

  constexpr bool kNarrow = sizeof(Idx) == 4;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long b = blockIdx.x / plan.cluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int PC = P * C;
  const int c1 = 1 % C, c2 = 2 % C;
  const Idx npix_c = (Idx)P * P * C;
  const uint8_t* src = img + (size_t)b * npix_c;
  float* dst = out + (size_t)b * npix_c;

  // output pixel (y, x) reads source (sy, sx) = (oy + yy*y + yx*x,
  // ox + xy*y + xx*x): rot90 x k, then the flips, each applied to the map
  const Map m = dihedral_map(flips[b], rots[b], P);
  const bool odd = m.yy == 0;     // odd k: sy follows x, sx follows y

  // n / C and n / P: a multiply-high by ceil(2^32 / d) in the 32-bit
  // instance (exact while n * d < 2^32, which the host checks), a divide
  // in the 64-bit one
  const unsigned long long mc = 0xffffffffULL / C + 1, mp = 0xffffffffULL / P + 1;
  auto div_c = [&](Idx n) -> Idx {
    return kNarrow ? (Idx)((n * mc) >> 32) : n / C;
  };
  auto div_p = [&](Idx n) -> Idx {
    return kNarrow ? (Idx)((n * mp) >> 32) : n / P;
  };

  const int y_lo = min(P, rank * plan.band_rows);
  const int y_hi = min(P, y_lo + plan.band_rows);
  const bool lut = C <= kLutMaxC;
  float* table = reinterpret_cast<float*>(smem);
  unsigned char* stage = smem + (lut ? C : 1) * 256 * 4;
  const bool staged = plan.stage_rows != 0;
  const bool one_piece = staged && plan.stage_rows >= y_hi - y_lo;

  // The staged region of output rows [ys, ys + rows): nseg segments of len
  // bytes; segment j starts at byte goff0 + j * P*C of the patch, and at
  // j * pitch + lead(j) of `stage`, lead(j) = its address mod 16.
  int nseg = 0, len = 0, pitch = 0, s0 = 0, lead0 = 0;
  const int pc16 = PC & 15;
  auto lead = [&](int j) { return (lead0 + j * pc16) & 15; };
  auto stage_piece = [&](int ys, int rows) {
    // the source rows (even k) or columns (odd k) that rows [ys, ys + rows)
    // read: o + d*y for y in the band, d = +-1
    const int o = odd ? m.ox : m.oy, d = odd ? m.xy : m.yy;
    s0 = d > 0 ? o + ys : o - (ys + rows - 1);
    long long goff0;
    if (odd) {
      nseg = P; len = rows * C; goff0 = (long long)s0 * C;
    } else {
      nseg = rows; len = PC; goff0 = (long long)s0 * PC;
    }
    pitch = (int)seg_pitch(len);
    lead0 = (int)((reinterpret_cast<uintptr_t>(src) + goff0) & 15);
    const int nw = (len + 30) >> 4;       // 16-byte windows a segment may span
    for (int idx = tid; idx < nseg * nw; idx += kThreads) {
      const int j = idx / nw;
      const int w = idx - j * nw;
      const uint8_t* seg = src + goff0 + (long long)j * PC;
      const uint8_t* win = seg - lead(j) + 16 * w;
      unsigned char* sdst = stage + j * pitch + 16 * w;
      // every window that holds a byte of the segment, whole: an aligned
      // 16-byte block never crosses a page, and the bytes it holds outside
      // the segment land in the segment's padding, never read
      if (win < seg + len) cp_async16(sdst, win);
    }
    cp_async_wait_all();
    __syncthreads();
  };

  // 1. this CTA's part of the patch's grayscale sum: its staged region
  //    when the band is staged in one piece, else its own source rows
  //    (either way the CTAs of a cluster partition the patch)
  unsigned long long gsum = 0;
  if (one_piece && y_hi > y_lo) {
    stage_piece(y_lo, y_hi - y_lo);
    const int ppseg = len / C;
    for (int j = warp; j < nseg; j += kThreads / 32) {
      const unsigned char* row = stage + j * pitch + lead(j);
      for (int t = lane; t < ppseg; t += 32) {
        gsum += gray_floor(row + t * C, c1, c2);
      }
    }
  } else if (y_hi > y_lo) {
    const long long npx = (long long)(y_hi - y_lo) * P;
    const uint8_t* rows = src + (long long)y_lo * PC;
    for (long long q = tid; q < npx; q += kThreads) {
      gsum += gray_floor(rows + q * C, c1, c2);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) gsum += __shfl_xor_sync(0xffffffffu, gsum, o);
  if (lane == 0) warp_sum[warp] = gsum;
  __syncthreads();
  if (tid == 0) {
    unsigned long long t = 0;
    for (int w = 0; w < kThreads / 32; ++w) t += warp_sum[w];
    part = t;
  }

  // 2. the patch's grayscale mean from the cluster's partials (the
  //    barriers are the unaligned forms: warps arrive here diverged)
  cluster_arrive();
  cluster_wait();
  if (tid == 0) {
    unsigned long long t = 0;
    for (int r = 0; r < plan.cluster; ++r) {
      t += *cluster.map_shared_rank(&part, r);
    }
    mean_s = __fmul_rn((float)t,
                       __frcp_rn((float)((unsigned long long)P * P)));
  }
  cluster_arrive();   // this CTA is done reading its peers' partials
  __syncthreads();

  // 3. the table: out = (floor(clip(f * x + blend)) - mean_c) / std_c for
  //    x = 0..255 and each band (or only the blend, above kLutMaxC bands)
  const float f = factors[b];
  const float blend = __fmul_rn(__fsub_rn(1.f, f), mean_s);
  for (int e = tid; e < (lut ? C : 1) * 256; e += kThreads) {
    float v = __fadd_rn(__fmul_rn(f, (float)(e & 255)), blend);
    v = floorf(fminf(fmaxf(v, 0.f), 255.f));
    table[e] = lut ? __fdiv_rn(__fsub_rn(v, band_mean[e >> 8]),
                               band_std[e >> 8])
                   : v;
  }
  __syncthreads();

  // 4. write the band a staged piece at a time, 4 consecutive floats of
  //    its flattened output per thread step. A source cursor steps with
  //    the output: the channel-0 byte of output pixel (y, x)'s source, in
  //    the stage (or, unstaged, in the patch).
  auto src_at = [&](int y, int x) -> Idx {
    const int sy = m.oy + m.yy * y + m.yx * x;
    const int sx = m.ox + m.xy * y + m.xx * x;
    if (!staged) return ((Idx)sy * P + sx) * C;
    const int j = odd ? sy : sy - s0;
    return (Idx)(j * pitch + lead(j) + (odd ? sx - s0 : sx) * C);
  };
  auto fetch = [&](Idx at, int ch) -> float {
    const uint8_t byte = staged ? stage[at + ch] : __ldg(src + at + ch);
    return lut ? table[ch * 256 + byte]
               : __fdiv_rn(__fsub_rn(table[byte], band_mean[ch]),
                           band_std[ch]);
  };
  const int piece = staged ? plan.stage_rows : y_hi - y_lo;
  for (int ys = y_lo; ys < y_hi; ys += piece) {
    const int rows = min(piece, y_hi - ys);
    if (staged && !one_piece) {
      __syncthreads();              // every thread is done with the last piece
      stage_piece(ys, rows);
    }
    // the cursor's step for x + 1: along a staged row (even k) or across
    // segments (odd k), constant unless the segments' leads differ
    const bool fixed = !(staged && odd && pc16 != 0);
    const Idx dx = (Idx)(long long)(
        odd ? m.yx * (staged ? pitch : PC) : m.xx * C);
    const Idx f0 = (Idx)ys * PC;
    const Idx f1 = (Idx)(ys + rows) * PC;
    const int head = (int)((reinterpret_cast<uintptr_t>(dst + f0) >> 2) & 3);
    const Idx nwin = (head + (f1 - f0) + 3) / 4;
    for (Idx w = tid; w < nwin; w += kThreads) {
      // the window [f0 + 4w - head, + 4) clipped to [f0, f1); only the
      // first one can start before f0
      const Idx fs = w == 0 ? f0 : f0 + 4 * w - head;
      const Idx fe = min(f1, f0 + 4 * w + 4 - head);
      const Idx i = div_c(fs);
      int ch = (int)(fs - i * C);
      const Idx yq = div_p(i);
      int y = (int)yq, x = (int)(i - yq * P);
      Idx at = src_at(y, x);
      auto step = [&]() {
        if (++ch == C) {
          ch = 0;
          if (++x == P) {
            x = 0;
            at = src_at(++y, 0);
          } else {
            at = fixed ? at + dx : src_at(y, x);
          }
        }
      };
      if (fe - fs == 4) {                         // a whole, aligned window
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] = fetch(at, ch);
          step();
        }
        *reinterpret_cast<float4*>(dst + fs) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
        for (Idx g = fs; g < fe; ++g) {
          dst[g] = fetch(at, ch);
          step();
        }
      }
    }
  }
  cluster_wait();     // peers may read `part` until they have arrived
}


}  // namespace

// The launch plan for (P, C): out[0..3] = cluster size, output rows per
// CTA, output rows staged at once (0: none), dynamic shared memory bytes.
extern "C" void cvcs_augment_plan(int P, int C, int* out) {
  const Plan pl = make_plan(P, C);
  out[0] = pl.cluster;
  out[1] = pl.band_rows;
  out[2] = pl.stage_rows;
  out[3] = pl.smem;
}

// Plain C entry point, loaded with ctypes. images (B, P, P, C) uint8;
// flips, rots (B,) int32; factors (B,) f32; band_mean, band_std (C,) f32;
// out (B, P, P, C) f32, 4-byte aligned. Returns a cudaError_t (0 =
// launched).
extern "C" int cvcs_fused_augment(const void* images, const void* flips,
                                  const void* rots, const void* factors,
                                  const void* band_mean, const void* band_std,
                                  void* out, int B, int P, int C,
                                  void* stream) {
  if (B < 1 || P < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const Plan plan = make_plan(P, C);
  if ((long long)B * plan.cluster > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned long long p = P, pc = (unsigned long long)P * C;
  const bool wide = p * p * p >= (1ULL << 32) || pc * pc >= (1ULL << 32);
  if (plan.smem > 48 * 1024) {     // the opt-in, on the current device
    const cudaError_t err = cudaFuncSetAttribute(
        wide ? (const void*)augment_kernel<unsigned long long>
             : (const void*)augment_kernel<unsigned>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
    if (err != cudaSuccess) {
      cudaGetLastError();          // leave no error for the next launch
      return (int)err;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * plan.cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)plan.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const uint8_t* im = static_cast<const uint8_t*>(images);
  const int* fp = static_cast<const int*>(flips);
  const int* rp = static_cast<const int*>(rots);
  const float* fa = static_cast<const float*>(factors);
  const float* mu = static_cast<const float*>(band_mean);
  const float* sd = static_cast<const float*>(band_std);
  float* o = static_cast<float*>(out);
  const cudaError_t err =
      wide ? cudaLaunchKernelEx(&cfg, augment_kernel<unsigned long long>, im,
                                fp, rp, fa, mu, sd, o, P, C, plan)
           : cudaLaunchKernelEx(&cfg, augment_kernel<unsigned>, im, fp, rp,
                                fa, mu, sd, o, P, C, plan);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}
