// Chunked RWKV6 WKV recurrence for Hopper (sm_90a), every chunk in parallel.
// Bound with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py:_kernel.
//
//   r/k/v [B,T,H,HD] (f32 or bf16, one dtype), logw [B,T,H,HD] (f32 or
//   bf16), u [H,HD] f32, S0 [B,H,HD,HD] f32, all contiguous;
//   y [B,T,H,HD] f32, S_T [B,H,HD,HD] f32. T is a multiple of the chunk C.
//   Per (b, h) and chunk c, with L the inclusive cumsum of logw along time
//   within the chunk, Lprev = L - logw and Ltot = L at the chunk's end:
//     A[t,s] = sum_i r[t,i] k[s,i] exp(Lprev[t,i] - L[s,i])   for s < t
//     A[t,t] = sum_i r[t,i] u[i] k[t,i]                        (the bonus)
//     U_c    = (k * exp(Ltot - L))^T v
//     S_c    = exp(Ltot) * S_{c-1} + U_c                       (S_{-1} = S0)
//     y      = A v + (r * exp(Lprev)) S_{c-1}
//
// What bounds it on this card. At the RWKV6-3B denoiser's shape (B=8,
// T=256, H=40, HD=64, C=64, f32) one call moves 115 MB (34 us at
// 3.35 TB/s) and does 2.6 G operations (38.5 us at 67 TFLOP/s, counting an
// expf as one). The pairwise scores are most of it: 165 M exp-FMA triples,
// one accurate expf each, which the SM's 16 special-function lanes a clock
// take about 40 us to issue at 1.98 GHz whatever else the kernel does.
// The three products (A v, (r exp(Lprev)) S, U) are 1.3 G multiply-adds.
//
// What the design does about it:
// - Every chunk in parallel. One block per (b, h, chunk): 1,280 blocks of
//   8 warps at the RWKV6 shape, two per SM (108,800 bytes of shared memory
//   each). Only the state chain S_c = exp(Ltot_c) S_{c-1} + U_c is
//   sequential, and it is elementwise: the blocks of one (b, h) form a
//   thread-block cluster (at most 8), each writes its U_c and exp(Ltot_c)
//   to its own shared memory, and after a cluster barrier the blocks fold
//   the chain together through distributed shared memory: each takes 1/G
//   of S's rows through every chunk and writes the S entering chunk j into
//   block j's shared memory, so every block reads and writes one share
//   (no block is read by all the others at once). Longer T runs groups of
//   at most 8 chunks one after another in the same cluster, each thread
//   carrying its entries of S to the next group in S_T's buffer, with a
//   block barrier between groups (the next group's tiles land where the
//   last product of this one reads). Nothing
//   beyond the inputs and outputs touches device memory.
// - The pairwise scores in register tiles. A thread owns a 4x4 tile of
//   (t, s) rows and reads r, Lprev (rows t) and k, L (rows s) as 16-byte
//   vectors: 16 loads for 64 triples. Only tiles that touch the strict
//   lower triangle are assigned, in jobs that keep each warp on one code
//   path (at C = 64): warps 0-6 take 112 tiles below the diagonal, two
//   lanes each (interleaved halves of the head dim, summed by a lane
//   shuffle); warp 7 the 16 tiles on it, two lanes each, which form only
//   the 6 pairs with s < t and the bonus terms of their 4 rows, then the
//   last 8 tiles below it, four lanes each. An exponent is formed only
//   where s < t: the upper triangle, where Lprev[t] - L[s] > 0 and exp
//   overflows, is skipped, not masked, and exp(Lprev) * exp(-L) is never
//   formed (L reaches -512 in a chunk). Accurate expf, no fast math.
// - The three products on the tensor cores as three TF32 mma.sync.m16n8k8
//   products each (tf32_mma.cuh): A v and (r exp(Lprev)) S into one
//   accumulator, U as (k exp(Ltot - L))^T v. None of them feeds an
//   exponent, and the CPU emulation of this arithmetic
//   (tests/test_torch_kernels.py) stays within 1e-6 of the output's scale
//   of the plain version, against a 2e-5 tolerance. A v stops at the
//   diagonal (A is zero above it).
// - The cumulative sum stays in time order per channel, as the plain
//   version's (one thread per channel, the chunk's values in registers,
//   64 dependent adds). A shuffle scan reorders the sum that feeds the
//   exponents: at decays down to -50 it misses the tolerance
//   (tests/test_torch_kernels.py).
// - Shared row pitches: r and Lprev/L HD + 4 floats, k, v, U and S HD + 8,
//   A C + 4, which makes every mma fragment read conflict-free (A
//   operands at 4 mod 32, B operands and the transposed k at 8 mod 32).
// - Tiles arrive by 16-byte cp.async (f32) in the order they are needed:
//   logw, then r and k during the cumulative sum, then v during the
//   scores.
//
// What is left: 0.162 ms per call at the RWKV6 shape on an H100 SXM at
// 700 W, 4.2x the 38.5 us bound. Accurate expf costs about a dozen
// instructions per exp-FMA triple, so the scores are bound by the issue
// rate (about 59 us of the card's time for 165 M triples) before the
// special-function lanes. A v is unbalanced across warps (the last m-tile
// has 4x the k-steps of the first), and a block's tile loads overlap only
// the other block's work, not its own.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;  // the portable cluster size

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// shared-memory layout in floats for head dim HD and chunk C
template <int HD, int C>
struct Smem {
  static constexpr int PR = HD + 4;  // r, then r exp(Lprev)
  static constexpr int PK = HD + 8;  // k, then k exp(Ltot - L)
  static constexpr int PV = HD + 8;  // v
  static constexpr int PL = HD + 4;  // L, and logw then Lprev
  static constexpr int PA = C + 4;   // A
  static constexpr int PU = HD + 8;  // U_c
  static constexpr int PS = HD + 8;  // S entering the chunk
  static constexpr int R = 0;
  static constexpr int K = R + C * PR;
  static constexpr int V = K + C * PK;
  static constexpr int LU = V + C * PV;                    // L, then U_c
  static constexpr int LS = LU + cmax(C * PL, HD * PU);    // Lprev, then S
  static constexpr int A = LS + cmax(C * PL, HD * PS);
  static constexpr int EL = A + C * PA;                    // exp(Ltot)
  static constexpr int floats = EL + HD;
};

// threads per 4x4 score tile below the diagonal: the largest power of two
// that keeps every tile (and one thread per diagonal tile) inside the block
// and gives each thread at least one 4-column slice of the head dim
__host__ __device__ constexpr int score_split(int below, int diag, int slices) {
  int s = 1;
  while (2 * s <= slices && 2 * s <= 32 && below * 2 * s + diag <= kThreads)
    s *= 2;
  return s;
}

// an [M, N] product in m16n8 tiles over the warps: each warp with work
// takes NQ n-tiles of one m-tile
template <int M, int N>
struct WarpTiles {
  static constexpr int tiles = (M / 16) * (N / 8);
  static constexpr int NQ = tiles >= kWarps ? tiles / kWarps : 1;
  static constexpr int warps = tiles / NQ;
  __device__ static int m0(int warp) { return warp * NQ / (N / 8) * 16; }
  __device__ static int n0(int warp) { return warp * NQ % (N / 8) * 8; }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// a [C, HD] tile of a [B,T,H,HD] tensor (row stride `row` elements, first
// element at `base`) into shared rows of pitch P, as f32, then a commit
// group: 16-byte asynchronous copies for 16-byte aligned f32 (the group
// completes later), element by element otherwise (an empty group)
template <int HD, int C, int P>
__device__ __forceinline__ void load_tile(float* dst, const void* src,
                                          int64_t base, int64_t row,
                                          bool bf16, int tid) {
  if (!bf16 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float* f = static_cast<const float*>(src) + base;
#pragma unroll 4
    for (int idx = tid; idx < C * HD / 4; idx += kThreads) {
      const int t = idx / (HD / 4), i = 4 * (idx % (HD / 4));
      cp_async16(dst + t * P + i, f + t * row + i);
    }
    cp_async_commit();
    return;
  }
#pragma unroll 4
  for (int idx = tid; idx < C * HD; idx += kThreads) {
    const int t = idx / HD, i = idx % HD;
    const int64_t g = base + (int64_t)t * row + i;
    dst[t * P + i] = bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(src)[g])
                          : static_cast<const float*>(src)[g];
  }
  cp_async_commit();
}

// acc[q] += a b over k < kend, three TF32 products per multiply-add, for
// one warp's NQ n-tiles of one m-tile: a(row in the m-tile, k) and
// b(k, column in the warp's n range) read shared memory
template <int NQ, class FA, class FB>
__device__ __forceinline__ void mma3(float (&acc)[NQ][4], int kend, FA a,
                                     FB b, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < kend; k0 += 8) {
    uint32_t ab[4], as[4];
    split(a(g, k0 + t), ab[0], as[0]);
    split(a(g + 8, k0 + t), ab[1], as[1]);
    split(a(g, k0 + t + 4), ab[2], as[2]);
    split(a(g + 8, k0 + t + 4), ab[3], as[3]);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      uint32_t b0, b0s, b1, b1s;
      split(b(k0 + t, 8 * q + g), b0, b0s);
      split(b(k0 + t + 4, 8 * q + g), b1, b1s);
      mma(acc[q], as, b0, b1);
      mma(acc[q], ab, b0s, b1s);
      mma(acc[q], ab, b0, b1);
    }
  }
}

// acc[a][b] += sum over the head-dim slices part, part + stride, ... (4
// columns each) of r[t0+a] k[s0+b] exp(Lprev[t0+a] - L[s0+b]): all 16 pairs
// of a tile below the diagonal; of a tile on it (DIAG) the 6 with s < t,
// and on its diagonal the bonus r[t] u k[t]
template <int HD, int C, bool DIAG>
__device__ __forceinline__ void score_tile(const float* smem, int t0, int s0,
                                           int part, int stride,
                                           float (&acc)[4][4],
                                           const float* __restrict__ u) {
  using SM = Smem<HD, C>;
  for (int i = 4 * part; i < HD; i += 4 * stride) {
    float4 rt[4], lt[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      rt[a] = *reinterpret_cast<const float4*>(smem + SM::R + (t0 + a) * SM::PR + i);
      lt[a] = *reinterpret_cast<const float4*>(smem + SM::LS + (t0 + a) * SM::PL + i);
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float4 ks = *reinterpret_cast<const float4*>(smem + SM::K + (s0 + b) * SM::PK + i);
      const float4 ls = *reinterpret_cast<const float4*>(smem + SM::LU + (s0 + b) * SM::PL + i);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (DIAG && b == a) {
          const float u0 = __ldg(u + i), u1 = __ldg(u + i + 1);
          const float u2 = __ldg(u + i + 2), u3 = __ldg(u + i + 3);
          float x = acc[a][a];
          x = fmaf(rt[a].x * u0, ks.x, x);
          x = fmaf(rt[a].y * u1, ks.y, x);
          x = fmaf(rt[a].z * u2, ks.z, x);
          x = fmaf(rt[a].w * u3, ks.w, x);
          acc[a][a] = x;
        }
        if (DIAG && b >= a) continue;
        float x = acc[a][b];
        x = fmaf(rt[a].x * ks.x, expf(lt[a].x - ls.x), x);
        x = fmaf(rt[a].y * ks.y, expf(lt[a].y - ls.y), x);
        x = fmaf(rt[a].z * ks.z, expf(lt[a].z - ls.z), x);
        x = fmaf(rt[a].w * ks.w, expf(lt[a].w - ls.w), x);
        acc[a][b] = x;
      }
    }
  }
}

// the tile (tb, sb), sb < tb, that is number `it` of the 4x4 tiles below
// the diagonal, counted row by row: (1,0), (2,0), (2,1), (3,0), ...
__device__ __forceinline__ void below_tile(int it, int& tb, int& sb) {
  tb = 1;
  while (it >= tb) { it -= tb; ++tb; }
  sb = it;
}

// one tile of A by PARTS consecutive lanes (every lane of the warp takes
// part in some job), each summing a share of the head dim, reduced by lane
// shuffles and written by the first lane
template <int HD, int C, bool DIAG, int PARTS>
__device__ __forceinline__ void score_job(float* smem, int t0, int s0,
                                          int part, const float* u) {
  using SM = Smem<HD, C>;
  float acc[4][4] = {};
  score_tile<HD, C, DIAG>(smem, t0, s0, part, PARTS, acc, u);
#pragma unroll
  for (int m = 1; m < PARTS; m <<= 1)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        acc[a][b] += __shfl_xor_sync(0xffffffffu, acc[a][b], m);
  if (part == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (!DIAG || b <= a) smem[SM::A + (t0 + a) * SM::PA + s0 + b] = acc[a][b];
  }
}

template <int HD, int C>
__global__ void __launch_bounds__(kThreads, 2)
wkv_kernel(const void* __restrict__ r, const void* __restrict__ k,
           const void* __restrict__ v, const void* __restrict__ logw,
           const float* __restrict__ u, const float* __restrict__ s0,
           float* __restrict__ y, float* __restrict__ s_out, int T, int H,
           int rkv_bf16, int logw_bf16) {
  using SM = Smem<HD, C>;
  using YT = WarpTiles<C, HD>;   // y [C, HD]
  using UT = WarpTiles<HD, HD>;  // U [HD, HD]
  extern __shared__ __align__(16) float smem[];
  float* Rs = smem + SM::R;
  float* Ks = smem + SM::K;
  float* Vs = smem + SM::V;
  float* Ls = smem + SM::LU;   // L, then U_c
  float* Us = smem + SM::LU;
  float* Lp = smem + SM::LS;   // logw, then Lprev, then S
  float* Ss = smem + SM::LS;
  float* As = smem + SM::A;
  float* eL = smem + SM::EL;

  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();    // chunks per group
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = T / C;
  const int64_t row = (int64_t)H * HD;  // t stride
  const int64_t base = (int64_t)b * T * row + (int64_t)h * HD;
  const int64_t sbase = ((int64_t)b * H + h) * HD * HD;
  const float* uh = u + (int64_t)h * HD;
  const bool bf_in = rkv_bf16 != 0, bf_w = logw_bf16 != 0;

  for (int c0 = 0; c0 < nc; c0 += G) {
    const int c = c0 + rank;
    const int n_here = min(G, nc - c0);
    const bool active = c < nc;
    float yacc[YT::NQ][4] = {};
    if (active) {
      // the chunk's tiles in, in the order they are needed (r and k arrive
      // during the cumulative sum, v during the scores); A cleared
      const int64_t cbase = base + (int64_t)c * C * row;
      load_tile<HD, C, SM::PL>(Lp, logw, cbase, row, bf_w, tid);
      load_tile<HD, C, SM::PR>(Rs, r, cbase, row, bf_in, tid);
      load_tile<HD, C, SM::PK>(Ks, k, cbase, row, bf_in, tid);
      load_tile<HD, C, SM::PV>(Vs, v, cbase, row, bf_in, tid);
      for (int idx = tid; idx < C * SM::PA; idx += kThreads) As[idx] = 0.f;
      cp_async_wait<3>();
      __syncthreads();

      // the cumulative sum in time order, one thread per channel
      if (tid < HD) {
        float acc = 0.f;
#pragma unroll
        for (int t0 = 0; t0 < C; t0 += 16) {
          float lw[16];
#pragma unroll
          for (int t = 0; t < 16; ++t) lw[t] = Lp[(t0 + t) * SM::PL + tid];
#pragma unroll
          for (int t = 0; t < 16; ++t) {
            acc += lw[t];
            Ls[(t0 + t) * SM::PL + tid] = acc;
            Lp[(t0 + t) * SM::PL + tid] = acc - lw[t];
          }
        }
      }
      cp_async_wait<1>();
      __syncthreads();

      // strictly-lower A in 4x4 register tiles
      if constexpr (C == 64) {
        // warp-uniform jobs: warps 0-6 take the tiles 0..111 below the
        // diagonal, two lanes each; warp 7 the 16 diagonal tiles, two lanes
        // each, then the tiles 112..119, four lanes each
        int tb, sb;
        if (warp < kWarps - 1) {
          below_tile(tid / 2, tb, sb);
          score_job<HD, C, false, 2>(smem, 4 * tb, 4 * sb, tid & 1, uh);
        } else {
          score_job<HD, C, true, 2>(smem, 4 * (lane / 2), 4 * (lane / 2),
                                    lane & 1, uh);
          below_tile(112 + lane / 4, tb, sb);
          score_job<HD, C, false, 4>(smem, 4 * tb, 4 * sb, lane & 3, uh);
        }
      } else {
        constexpr int NB = C / 4, BELOW = NB * (NB - 1) / 2;
        constexpr int SPLIT = score_split(BELOW, NB, HD / 4);
        float acc[4][4] = {};
        int t0 = 0, s0r = 0;
        if (tid < BELOW * SPLIT) {
          int tb, sb;
          below_tile(tid / SPLIT, tb, sb);
          t0 = 4 * tb;
          s0r = 4 * sb;
          score_tile<HD, C, false>(smem, t0, s0r, tid % SPLIT, SPLIT, acc, uh);
        } else if (tid < BELOW * SPLIT + NB) {
          t0 = 4 * (tid - BELOW * SPLIT);
          score_tile<HD, C, true>(smem, t0, t0, 0, 1, acc, uh);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int bb = 0; bb <= a; ++bb)
              As[(t0 + a) * SM::PA + t0 + bb] = acc[a][bb];
        }
        // the SPLIT partial sums of a tile below the diagonal sit in
        // consecutive lanes
#pragma unroll
        for (int m = 1; m < SPLIT; m <<= 1)
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int bb = 0; bb < 4; ++bb)
              acc[a][bb] += __shfl_xor_sync(0xffffffffu, acc[a][bb], m);
        if (tid < BELOW * SPLIT && tid % SPLIT == 0) {
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int bb = 0; bb < 4; ++bb)
              As[(t0 + a) * SM::PA + s0r + bb] = acc[a][bb];
        }
      }
      __syncthreads();

      cp_async_wait<0>();
      __syncthreads();  // v is in

      // y = A v (A is zero above the diagonal: stop there), beside the
      // decays of r and k in place
      if (warp < YT::warps) {
        const int m0 = YT::m0(warp), n0 = YT::n0(warp);
        mma3<YT::NQ>(
            yacc, m0 + 16,
            [&](int rr, int cc) { return As[(m0 + rr) * SM::PA + cc]; },
            [&](int rr, int cc) { return Vs[rr * SM::PV + n0 + cc]; }, lane);
      }
      for (int idx = tid; idx < C * HD; idx += kThreads) {
        const int t = idx / HD, i = idx % HD;
        Rs[t * SM::PR + i] *= expf(Lp[t * SM::PL + i]);
        Ks[t * SM::PK + i] *=
            expf(Ls[(C - 1) * SM::PL + i] - Ls[t * SM::PL + i]);
      }
      for (int i = tid; i < HD; i += kThreads) eL[i] = expf(Ls[(C - 1) * SM::PL + i]);
      __syncthreads();

      // U_c = (k exp(Ltot - L))^T v, over L's tile
      if (warp < UT::warps) {
        const int m0 = UT::m0(warp), n0 = UT::n0(warp);
        float uacc[UT::NQ][4] = {};
        mma3<UT::NQ>(
            uacc, C,
            [&](int rr, int cc) { return Ks[cc * SM::PK + m0 + rr]; },
            [&](int rr, int cc) { return Vs[rr * SM::PV + n0 + cc]; }, lane);
        const int g = lane >> 2, t = lane & 3;
#pragma unroll
        for (int q = 0; q < UT::NQ; ++q) {
          float* u0 = Us + (m0 + g) * SM::PU + n0 + 8 * q + 2 * t;
          u0[0] = uacc[q][0];
          u0[1] = uacc[q][1];
          u0[8 * SM::PU] = uacc[q][2];
          u0[8 * SM::PU + 1] = uacc[q][3];
        }
      }
    }
    cluster.sync();  // every chunk's U_c and exp(Ltot_c) are in

    // the state chain, split over the cluster by rows: block p folds the
    // rows i = p, p + G, ... of S over the group's chunks, reading each
    // chunk's U_j and exp(Ltot_j) from block j and writing the S entering
    // chunk j into block j's Ss (distributed shared memory both ways, every
    // block reading and writing a 1/G share). S enters the group from S0
    // or from s_out, where the same thread left its entries after the
    // previous group; after the last group s_out holds S_T.
    {
      const int rows = (HD - rank + G - 1) / G;
      for (int it = tid; it < rows * (HD / 4); it += kThreads) {
        const int i = rank + G * (it / (HD / 4)), col = 4 * (it % (HD / 4));
        const int64_t gi = sbase + i * HD + col;
        float4 st = c0 == 0 ? *reinterpret_cast<const float4*>(s0 + gi)
                            : *reinterpret_cast<const float4*>(s_out + gi);
        for (int j0 = 0; j0 < n_here; j0 += 4) {  // 4 chunks' loads in flight
          float4 uj[4];
          float ej[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j0 + j < n_here) {
              uj[j] = *reinterpret_cast<const float4*>(
                  cluster.map_shared_rank(Us, j0 + j) + i * SM::PU + col);
              ej[j] = cluster.map_shared_rank(eL, j0 + j)[i];
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j0 + j < n_here) {
              *reinterpret_cast<float4*>(cluster.map_shared_rank(Ss, j0 + j) +
                                         i * SM::PS + col) = st;
              st.x = __fadd_rn(__fmul_rn(ej[j], st.x), uj[j].x);
              st.y = __fadd_rn(__fmul_rn(ej[j], st.y), uj[j].y);
              st.z = __fadd_rn(__fmul_rn(ej[j], st.z), uj[j].z);
              st.w = __fadd_rn(__fmul_rn(ej[j], st.w), uj[j].w);
            }
          }
        }
        *reinterpret_cast<float4*>(s_out + gi) = st;
      }
    }
    cluster.sync();  // every block's Ss is written; no U_j is read again

    // y += (r exp(Lprev)) S, written into [B,T,H,HD]
    if (active && warp < YT::warps) {
      const int m0 = YT::m0(warp), n0 = YT::n0(warp);
      mma3<YT::NQ>(
          yacc, HD,
          [&](int rr, int cc) { return Rs[(m0 + rr) * SM::PR + cc]; },
          [&](int rr, int cc) { return Ss[rr * SM::PS + n0 + cc]; }, lane);
      const int g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int q = 0; q < YT::NQ; ++q) {
        float* y0 = y + base + ((int64_t)c * C + m0 + g) * row + n0 + 8 * q + 2 * t;
        *reinterpret_cast<float2*>(y0) = make_float2(yacc[q][0], yacc[q][1]);
        *reinterpret_cast<float2*>(y0 + 8 * row) = make_float2(yacc[q][2], yacc[q][3]);
      }
    }
    // the next group's loads overwrite Rs and Ss (as logw), which every
    // warp has just read: no warp starts them before all are done
    if (c0 + G < nc) __syncthreads();
  }
}

template <int HD, int C>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, const void* s0, void* y, void* s_out, int B, int T,
           int H, int rkv_bf16, int logw_bf16, cudaStream_t stream) {
  const int bytes = (int)sizeof(float) * Smem<HD, C>::floats;
  // The limit belongs to the current device, so it is set on every launch.
  cudaError_t e = cudaFuncSetAttribute(
      wkv_kernel<HD, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const int nc = T / C;
  const int groups = (nc + kMaxCluster - 1) / kMaxCluster;
  const int G = (nc + groups - 1) / groups;  // chunks per group = cluster size
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G, H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, wkv_kernel<HD, C>, r, k, v, logw,
                         (const float*)u, (const float*)s0, (float*)y,
                         (float*)s_out, T, H, rkv_bf16, logw_bf16);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int HD>
int dispatch_chunk(int chunk, const void* r, const void* k, const void* v,
                   const void* logw, const void* u, const void* s0, void* y,
                   void* s_out, int B, int T, int H, int rkv_bf16,
                   int logw_bf16, cudaStream_t s) {
  switch (chunk) {
    case 16: return launch<HD, 16>(r, k, v, logw, u, s0, y, s_out, B, T, H, rkv_bf16, logw_bf16, s);
    case 32: return launch<HD, 32>(r, k, v, logw, u, s0, y, s_out, B, T, H, rkv_bf16, logw_bf16, s);
    case 64: return launch<HD, 64>(r, k, v, logw, u, s0, y, s_out, B, T, H, rkv_bf16, logw_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// hd in {16, 32, 64}, chunk in {16, 32, 64} dividing T > 0 (HEAD_DIMS and
// CHUNKS in rwkv6_scan.py). dtype codes: 0 = float32, 1 = bfloat16, for
// r/k/v and for logw. Returns the launch's error, else cudaGetLastError()
// after it (0 = cudaSuccess); the Python wrapper raises on anything else.
extern "C" int rwkv6_wkv_launch(const void* r, const void* k, const void* v,
                                const void* logw, const void* u,
                                const void* s0, void* y, void* s_out, int B,
                                int T, int H, int hd, int chunk,
                                int rkv_dtype, int logw_dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((chunk != 16 && chunk != 32 && chunk != 64) || T <= 0 || T % chunk != 0)
    return (int)cudaErrorInvalidValue;
  if ((rkv_dtype != 0 && rkv_dtype != 1) || (logw_dtype != 0 && logw_dtype != 1))
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: return dispatch_chunk<16>(chunk, r, k, v, logw, u, s0, y, s_out, B, T, H, rkv_dtype, logw_dtype, s);
    case 32: return dispatch_chunk<32>(chunk, r, k, v, logw, u, s0, y, s_out, B, T, H, rkv_dtype, logw_dtype, s);
    case 64: return dispatch_chunk<64>(chunk, r, k, v, logw, u, s0, y, s_out, B, T, H, rkv_dtype, logw_dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
