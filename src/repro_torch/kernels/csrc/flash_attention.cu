// Blocked online-softmax attention for Hopper (sm_90a): Q K^T on the CUDA
// cores, P V on the tensor cores. Bound with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_kernel.
//
//   q [B,H,S,hd], k/v [B,K,T,hd] (contiguous, K divides H), f32 or bf16;
//   out [B,H,S,hd] in q's dtype. q-head h reads kv-head h / (H/K) (GQA).
//   Any head dim 1 <= hd <= 256 (the reference's documented range): an
//   instance HD >= hd (the wrapper's instance_for) runs it. hd == HD takes
//   the instance's exact variant (kPad false: HD-long global rows at
//   compile time, the code it had before other head dims were taken);
//   hd < HD its padded variant (kPad true: hd-long global rows at run
//   time, shared tiles HD wide with columns hd..HD-1 zero, only hd columns
//   stored). A zero column adds an exact zero to each score's FMA chain
//   and to P V's accumulators, so hd through HD gives the bits of an
//   instance of hd itself wherever the two share block_keys and m_tiles
//   (64 through 72; 224 through 256).
//   Causal (key position <= query position) or bidirectional; key positions
//   >= T are masked in the kernel, so ragged S and T need no host padding.
//   Softmax and accumulation in f32.
//
// Why Q K^T stays on the CUDA cores. The kernel is held to its f32 plain
// version (an f32 GEMM, then softmax, then an f32 GEMM) within
// 2e-5 * max(1, max|out|). At DiT-XL/2's own activations (logits up to
// about 480, |v| up to 50) that is below the f32 rounding of the logits
// themselves: on an H100 the plain version sits about 2e-3 from the
// float64 answer against a tolerance of about 1e-3, so only its own
// arithmetic (one f32 FMA chain per score, over the head dim in order)
// stays inside it. Scores from the tensor cores (three TF32 products, the
// operands split a = big + small) missed the plain version by up to 2.6e-3
// on every call of a solve, as PyTorch's SDPA (the same 3xTF32 products)
// does on more than 550 of 560 (launch/attention_precision.py). So the
// scores are the plain version's FMA chains; P V, where the tolerance is
// not below the noise, runs on the tensor cores with three TF32 products
// each (big*big + big*small + small*big; small*small, about 2^-22 |p v|,
// is dropped): one TF32 product alone misses the tolerance by 8-11x even
// at randn inputs
// (tests/test_torch_kernels.py::test_three_tf32_products_hold_attention_f32).
// bf16 values are exact in TF32, so for bf16 V the small products are
// skipped at compile time; P stays f32 (two products).
//
// What bounds it on this card. At the DiT shape (B 8, H = K 16, S = T 256,
// hd 72, f32, bidirectional) Q K^T is 2*B*H*S*T*hd = 1.21 GFLOP of f32 FMA
// work, 18.0 us at 67 TFLOP/s on the CUDA cores; P V is 3 x 1.21 GFLOP of
// TF32 work, 7.3 us at 495 TFLOP/s; q/k/v/o are 37.7 MB, 11.3 us at
// 3.35 TB/s. The CUDA-core half bounds this design, and feeding it from
// shared memory costs as much as the FMAs: the SM reads 32 words a cycle
// and does 128 FMAs, so a thread must use each word it loads 4 times. The
// function's own bound at f32 accuracy, both products as 3xTF32 on the
// tensor cores, is 14.6 us (chip_smoke.py's bound_ms); Q K^T's 18.0 us on
// the CUDA cores keeps this design above it.
//
// What the design does about it (FlashAttention-2 style):
// - Work split. One block per (b, h, q tile), 4 warps; each warp takes 32
//   query rows, two 16-row m-tiles of mma.m16n8k8 (16 rows for hd > 80,
//   where the registers do not hold two). A loop over 64-key tiles inside
//   the block takes the place of the TPU's sequential innermost grid axis
//   (32-key tiles above hd 128: block_keys). At hd 256 a thread holds 128
//   f32 accumulators of O and one block fits an SM (166,400 bytes of shared
//   memory); at hd 224 (zamba2-7b's shared attention, 2 * 3584 / 32) 112
//   and 145,920 bytes, still one block an SM: both instances are right, not
//   tuned.
//   The running max and sum and the output accumulator stay in registers;
//   the [S, T] scores never leave the SM. At the DiT shape: 256 blocks of
//   128 rows and 95 KB of shared memory, 2 per SM: one wave on 132 SMs.
// - Scores in the tensor cores' layout. Each thread computes the 64 scores
//   that the accumulator fragments of its two m-tiles put in its registers:
//   rows g + 8i (i = 0..3) of its warp's 32, keys 8n + 2t and 8n + 2t + 1
//   (lane = 4g + t), reading Q and K as 16-byte vectors along the head dim:
//   20 shared loads for 256 FMAs (0.31 words per FMA), 64 independent FMA
//   chains in flight.
// - P feeds P V with no trip through shared memory. The f32 accumulator
//   fragment holds columns (2t, 2t+1) of row g; the TF32 A fragment wants
//   k-slots (t, t+4). P V sums over keys, so the kernel takes key 2t of an
//   8-key step as k-slot t and key 2t+1 as slot t+4, and reads V's rows in
//   the same order (rows 2t and 2t+1 for the B fragment's slots t and t+4).
//   The permutation is exact. Both m-tiles share each B fragment of V.
// - The split of P and V into TF32 halves rounds big by two full-rate
//   integer instructions, since cvt.rna.tf32.f32 runs at a quarter of the
//   rate.
// - Tiles arrive by 16-byte cp.async (zero-filled for rows >= T). K is
//   double-buffered: tile j+1 loads while tile j is computed; V, single-
//   buffered to leave room for 2 blocks per SM, loads during the next
//   tile's Q K^T. bf16 tiles stage through registers (load, convert, store
//   as f32), so both types share one f32 shared-memory layout.
// - Shared row stride hd + 4 floats for Q, K and V. A quarter-warp's 16-byte
//   reads of K hit rows 2t (t = 0..3) at one column, of Q rows g and g+1,
//   and V's B-fragment words sit at row 2t (or 2t+1), column g: all are
//   conflict-free when 2 * stride = 8 or 24 (mod 32), i.e. stride = 4 or 12
//   (mod 16), which hd + 4 is for every hd that is a multiple of 8. Rows
//   start on 16 bytes.
// - Masks: keys >= T get -inf and their (zero-filled) V rows add nothing,
//   so 0 * garbage never makes a NaN; causal blocks stop their key loop at
//   the block's last query row, and a warp skips the math of a tile none of
//   its rows can see; a row that has seen no valid key keeps the shift at
//   0; query rows >= S are not written. The softmax is the plain version's:
//   the scale multiplies the f32 score, then accurate expf (no fast math).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "tf32_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;  // 128

// keys per tile: 64; 32 above head dim 128, where the Q tile and three
// 64-key tiles would need (64 + 192) * 260 * 4 = 266,240 bytes of shared
// memory at hd 256, over the 232,448 a block can have (at 32: 166,400;
// hd 224: 145,920)
template <int HD> __host__ __device__ constexpr int block_keys() { return HD <= 128 ? 64 : 32; }

// shared row stride of Q, K and V tiles, in floats (see the note above)
template <int HD> __host__ __device__ constexpr int row_stride() { return HD + 4; }
// 16-row m-tiles per warp: two share each K and V value read from shared
// memory (half the shared traffic per FMA) where the registers allow it
template <int HD> __host__ __device__ constexpr int m_tiles() { return HD <= 80 ? 2 : 1; }
template <int HD> __host__ __device__ constexpr int block_rows() {
  return 16 * m_tiles<HD>() * kWarps;
}
// the Q tile, two K tiles (double-buffered) and one V tile
template <int HD> __host__ __device__ constexpr int smem_floats() {
  return (block_rows<HD>() + 3 * block_keys<HD>()) * row_stride<HD>();
}

// N-byte asynchronous copy global -> shared; reads nothing and writes zeros
// when !in
template <int N>
__device__ __forceinline__ void cp_async(float* dst, const void* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(d), "l"(src), "r"(in ? 16 : 0) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(d), "l"(src), "r"(in ? 4 : 0) : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Rows row0 .. row0+ROWS-1 of a [len, HD] matrix (kPad: [len, hd]) into
// shared rows of `stride` floats, as f32; rows >= len (and columns >= hd)
// become zeros. f32 goes by cp.async, bf16 through registers. `vec`:
// every base pointer is 16-byte aligned (kPad: and so is every row, hd *
// sizeof(T) a multiple of 16), so rows move in 16-byte pieces (else
// element by element).
template <typename T, int HD, int ROWS, bool kPad>
__device__ __forceinline__ void load_rows(float* dst, int stride, const T* src,
                                          int row0, int len, int hd,
                                          bool vec) {
  if (vec) {
    constexpr int kVec = 16 / sizeof(T);
    constexpr int kChunks = HD / kVec;
    for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i - r * kChunks) * kVec;
      bool in = row0 + r < len;
      const T* g;
      if constexpr (kPad) {
        in = in && c < hd;
        g = src + (in ? (int64_t)(row0 + r) * hd + c : 0);
      } else {
        g = src + (int64_t)(in ? row0 + r : 0) * HD + c;
      }
      float* s = dst + r * stride + c;
      if constexpr (std::is_same<T, float>::value) {
        cp_async<16>(s, g, in);
      } else {
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (in) raw = *reinterpret_cast<const uint4*>(g);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
        const float2 c2 = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
        *reinterpret_cast<float4*>(s) = make_float4(a.x, a.y, b.x, b.y);
        *reinterpret_cast<float4*>(s + 4) = make_float4(c2.x, c2.y, d.x, d.y);
      }
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * HD; i += kThreads) {
      const int r = i / HD, c = i - r * HD;
      bool in = row0 + r < len;
      const T* g;
      if constexpr (kPad) {
        in = in && c < hd;
        g = src + (in ? (int64_t)(row0 + r) * hd + c : 0);
      } else {
        g = src + (int64_t)(in ? row0 + r : 0) * HD + c;
      }
      float* s = dst + r * stride + c;
      if constexpr (std::is_same<T, float>::value) {
        cp_async<4>(s, g, in);
      } else {
        *s = in ? __bfloat162float(*g) : 0.f;
      }
    }
  }
}

template <typename T, int HD, bool kPad>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int H, int K,
             int S, int T_len, int causal, float scale, int vec, int hd) {
  static_assert(HD % 8 == 0, "head dim must be a multiple of 8");
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int KS = HD / 8;  // 8-column tiles of P*V
  constexpr int BK = block_keys<HD>();
  constexpr int NT = BK / 8;  // 8-key column tiles of S = k-steps of P*V
  constexpr int MT = m_tiles<HD>();
  constexpr int BQ = block_rows<HD>();
  constexpr int SR = row_stride<HD>();
  constexpr int kTile = BK * SR;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // [BQ][SR]
  float* Ks = smem + BQ * SR;     // 2 x [BK][SR]
  float* Vs = Ks + 2 * kTile;     // [BK][SR]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / K);
  const int row0 = q0 + 16 * MT * warp;  // the warp's first query row

  // global rows are HD long (kPad: hd)
  const int row_len = kPad ? hd : HD;
  const T* qb = q + (((int64_t)b * H + h) * S) * row_len;
  const T* kb = k + (((int64_t)b * K + kvh) * T_len) * row_len;
  const T* vb = v + (((int64_t)b * K + kvh) * T_len) * row_len;

  int k_end = T_len;
  if (causal) k_end = min(T_len, q0 + BQ);  // later keys are masked for every row
  const int n_tiles = (k_end + BK - 1) / BK;

  // Commit groups, in order: {Q, K0}, {V0}, then per tile j: {K(j+1)} at
  // its start and {V(j+1)} at its end, so that K(j+1) loads during tile j
  // and V(j+1) during tile j+1's Q K^T.
  load_rows<T, HD, BQ, kPad>(Qs, SR, qb, q0, S, hd, vec);
  load_rows<T, HD, BK, kPad>(Ks, SR, kb, 0, T_len, hd, vec);
  cp_async_commit();
  load_rows<T, HD, BK, kPad>(Vs, SR, vb, 0, T_len, hd, vec);
  cp_async_commit();

  // this thread's query rows: g + 8i (i < 2 MT) of the warp's 16 MT, the
  // rows of the m16n8k8 fragments it holds (m-tile i / 2, half i % 2)
  const float* qrow = Qs + (16 * MT * warp + g) * SR;
  float o[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < KS; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
  float m_run[2 * MT], l_run[2 * MT];  // per row; l_run: this thread's part
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r) { m_run[r] = -INFINITY; l_run[r] = 0.f; }

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    if (j + 1 < n_tiles)
      load_rows<T, HD, BK, kPad>(Ks + ((j + 1) & 1) * kTile, SR, kb, k0 + BK, T_len,
                           hd, vec);
    cp_async_commit();
    cp_async_wait<2>();  // K(j) has landed (V(j) and K(j+1) may be in flight)
    __syncthreads();

    const float* Kt = Ks + (j & 1) * kTile;
    // a warp whose rows are all padding, or (causal) see no key of this
    // tile, skips the math but not the barriers
    const bool live = row0 < S && (!causal || k0 <= row0 + 16 * MT - 1);
    float sc[MT][NT][4];  // P after the softmax
    float alpha[2 * MT];
    if (live) {
      // S = Q K^T on the CUDA cores, one f32 FMA chain per score over the
      // head dim in order. sc[mt][n][e]: row 16 mt + g + 8 (e >> 1) of the
      // warp's rows, key k0 + 8n + 2t + (e & 1): the accumulator layout of
      // mma.m16n8k8.
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NT; ++n) sc[mt][n][0] = sc[mt][n][1] = sc[mt][n][2] = sc[mt][n][3] = 0.f;
      const float* krow = Kt + 2 * t * SR;
#pragma unroll 2
      for (int d = 0; d < HD; d += 4) {
        float4 a[2 * MT];
#pragma unroll
        for (int r = 0; r < 2 * MT; ++r)
          a[r] = *reinterpret_cast<const float4*>(qrow + 8 * r * SR + d);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4 kk = *reinterpret_cast<const float4*>(krow + (8 * n + e) * SR + d);
#pragma unroll
            for (int r = 0; r < 2 * MT; ++r) {
              float& acc = sc[r >> 1][n][(r & 1) * 2 + e];
              acc = fmaf(a[r].x, kk.x, acc);
              acc = fmaf(a[r].y, kk.y, acc);
              acc = fmaf(a[r].z, kk.z, acc);
              acc = fmaf(a[r].w, kk.w, acc);
            }
          }
        }
      }

      const bool need_mask = k0 + BK > T_len || (causal && k0 + BK - 1 > row0);
      float m_tile[2 * MT];
#pragma unroll
      for (int r = 0; r < 2 * MT; ++r) m_tile[r] = -INFINITY;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 2 * mt + (e >> 1);
            float x = __fmul_rn(sc[mt][n][e], scale);
            if (need_mask) {
              const int key = k0 + 8 * n + 2 * t + (e & 1);
              const int qpos = row0 + g + 8 * r;
              if (key >= T_len || (causal && key > qpos)) x = -INFINITY;
            }
            sc[mt][n][e] = x;
            m_tile[r] = fmaxf(m_tile[r], x);
          }
        }
      }
      float shift[2 * MT];
#pragma unroll
      for (int r = 0; r < 2 * MT; ++r) {
        m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 1));
        m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 2));
        const float m_new = fmaxf(m_run[r], m_tile[r]);
        // a row with no valid key so far keeps m = -inf; use 0 as the shift
        // so exp(-inf - shift) = 0 instead of NaN
        shift[r] = (m_new == -INFINITY) ? 0.f : m_new;
        alpha[r] = expf(m_run[r] - shift[r]);
        m_run[r] = m_new;
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 2 * mt + (e >> 1);
            const float p = expf(sc[mt][n][e] - shift[r]);
            l_run[r] += p;
            sc[mt][n][e] = p;
          }
        }
#pragma unroll
        for (int n = 0; n < KS; ++n) {
          o[mt][n][0] *= alpha[2 * mt]; o[mt][n][1] *= alpha[2 * mt];
          o[mt][n][2] *= alpha[2 * mt + 1]; o[mt][n][3] *= alpha[2 * mt + 1];
        }
      }
    }

    cp_async_wait<1>();  // V(j) has landed
    __syncthreads();
    if (live) {
      // O += P V on the tensor cores. k-step js covers keys 8js .. 8js+7:
      // key 8js+2t is slot t, key 8js+2t+1 slot t+4, so the A fragment is
      // sc[mt][js] reordered; both m-tiles share each B fragment of V.
      const float* vrow = Vs + 2 * t * SR + g;
#pragma unroll
      for (int js = 0; js < NT; ++js) {
        uint32_t pb[MT][4], ps[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          split(sc[mt][js][0], pb[mt][0], ps[mt][0]);  // row g,   slot t
          split(sc[mt][js][2], pb[mt][1], ps[mt][1]);  // row g+8, slot t
          split(sc[mt][js][1], pb[mt][2], ps[mt][2]);  // row g,   slot t+4
          split(sc[mt][js][3], pb[mt][3], ps[mt][3]);  // row g+8, slot t+4
        }
#pragma unroll
        for (int n = 0; n < KS; ++n) {
          // B fragment: keys 8js+2t and 8js+2t+1, head dim 8n+g
          const float x0 = vrow[8 * js * SR + 8 * n];
          const float x1 = vrow[8 * js * SR + SR + 8 * n];
          if constexpr (kF32) {
            uint32_t b0, b0s, b1, b1s;
            split(x0, b0, b0s);
            split(x1, b1, b1s);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma(o[mt][n], ps[mt], b0, b1);
              mma(o[mt][n], pb[mt], b0s, b1s);
              mma(o[mt][n], pb[mt], b0, b1);
            }
          } else {  // bf16 v is exact in TF32; P is not
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma(o[mt][n], ps[mt], __float_as_uint(x0), __float_as_uint(x1));
              mma(o[mt][n], pb[mt], __float_as_uint(x0), __float_as_uint(x1));
            }
          }
        }
      }
    }
    __syncthreads();  // V(j) and K(j) consumed
    if (j + 1 < n_tiles)
      load_rows<T, HD, BK, kPad>(Vs, SR, vb, k0 + BK, T_len, hd, vec);
    cp_async_commit();
  }

  // o[mt][n][e]: row 16 mt + g + 8 (e >> 1), head dim 8n + 2t + (e & 1).
  // kPad writes only the hd columns: pairs where hd is even (each pair
  // then starts on its own 2-element boundary), else one by one.
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int qpos = row0 + g + 8 * r;
    if (qpos >= S) continue;
    T* orow = out + (((int64_t)b * H + h) * S + qpos) * row_len + 2 * t;
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      const int col = 8 * n + 2 * t;
      if (kPad && col >= hd) continue;
      const float x = o[r >> 1][n][(r & 1) * 2] * inv;
      const float y = o[r >> 1][n][(r & 1) * 2 + 1] * inv;
      if (!kPad || hd % 2 == 0) {
        if constexpr (kF32) {
          *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(x, y);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) = __floats2bfloat162_rn(x, y);
        }
      } else {
        if constexpr (kF32) {
          orow[8 * n] = x;
          if (col + 1 < hd) orow[8 * n + 1] = y;
        } else {
          orow[8 * n] = __float2bfloat16_rn(x);
          if (col + 1 < hd) orow[8 * n + 1] = __float2bfloat16_rn(y);
        }
      }
    }
  }
}

template <typename T, int HD, bool kPad>
int launch_variant(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int K, int S, int T_len, int hd, int causal,
                   float scale, cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * smem_floats<HD>();
  // The limit belongs to the current device, so it is set on every launch.
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, HD, kPad>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const int vec = (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16) == 0 &&
                  (hd * sizeof(T)) % 16 == 0;
  constexpr int BQ = block_rows<HD>();
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_kernel<T, HD, kPad><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, H, K, S, T_len,
      causal, scale, vec, hd);
  return (int)cudaGetLastError();
}

// hd == HD: the exact variant; hd < HD: the padded one
template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int K, int S, int T_len, int hd, int causal, float scale,
           cudaStream_t stream) {
  if (hd == HD)
    return launch_variant<T, HD, false>(q, k, v, out, B, H, K, S, T_len, hd,
                                        causal, scale, stream);
  return launch_variant<T, HD, true>(q, k, v, out, B, H, K, S, T_len, hd,
                                     causal, scale, stream);
}

template <typename T>
int dispatch(int inst, int hd, const void* q, const void* k, const void* v,
             void* out, int B, int H, int K, int S, int T_len, int causal,
             float scale, cudaStream_t s) {
  if (hd < 1 || hd > inst) return (int)cudaErrorInvalidValue;
  switch (inst) {
    case 16: return launch<T, 16>(q, k, v, out, B, H, K, S, T_len, hd, causal, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, B, H, K, S, T_len, hd, causal, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, B, H, K, S, T_len, hd, causal, scale, s);
    case 72: return launch<T, 72>(q, k, v, out, B, H, K, S, T_len, hd, causal, scale, s);
    case 80: return launch<T, 80>(q, k, v, out, B, H, K, S, T_len, hd, causal, scale, s);
    case 96: return launch<T, 96>(q, k, v, out, B, H, K, S, T_len, hd, causal, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, B, H, K, S, T_len, hd, causal, scale, s);
    case 224: return launch<T, 224>(q, k, v, out, B, H, K, S, T_len, hd, causal, scale, s);
    case 256: return launch<T, 256>(q, k, v, out, B, H, K, S, T_len, hd, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// inst must be one of the instances in dispatch() (HEAD_DIMS in
// flash_attention.py) and 1 <= hd <= inst (instance_for picks the
// smallest). dtype: 0 = float32, 1 = bfloat16. Returns cudaErrorInvalidValue
// for what no instance runs (no launch), else cudaGetLastError() after the
// launch (0 = cudaSuccess); the Python wrapper raises on anything else.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int H,
                                      int K, int S, int T_len, int hd,
                                      int inst, int causal, float scale,
                                      int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(inst, hd, q, k, v, out, B, H, K, S, T_len, causal, scale, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(inst, hd, q, k, v, out, B, H, K, S, T_len, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
