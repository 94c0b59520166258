// Blocked online-softmax attention for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_kernel.
//
//   q [B,H,S,hd], k/v [B,K,T,hd] (contiguous, K divides H), f32 or bf16;
//   out [B,H,S,hd] in q's dtype. q-head h reads kv-head h / (H/K) (GQA).
//   Causal (key position <= query position) or bidirectional; key positions
//   >= T are masked in the kernel, so ragged S and T need no host padding.
//   Softmax and accumulation in f32 with plain f32 FMAs on the CUDA cores
//   (no TF32), so the kernel holds against the f32 plain version.
//
// What bounds it on this card: operations. At the DiT-XL/2 shape (B=8,
// H=K=16, S=T=256, hd=72) the work is 4*B*H*S*T*hd = 2.4 GFLOP against
// 21 MB of q/k/v/o in f32: about 115 flop per byte, well above the
// 67 TFLOP/s / 3.35 TB/s = 20 flop-per-byte balance of f32 outside the
// tensor cores. The least time is 4*B*H*S*T*hd / 67 TFLOP/s.
//
// What the design does about it: the [S,T] score matrix never leaves the
// SM. One block per (b, h, 64-row q tile); a loop over 32-key tiles inside
// the block takes the place of the TPU's sequential innermost grid axis.
// The q tile and each k/v tile are staged once in shared memory (f32,
// rows padded by one word so the row-wise reads of eight query rows hit
// eight banks); four threads share a query row, each computing the scores
// of 8 of the tile's 32 keys and owning every fourth output column (hd/4
// accumulators in registers). The running max and sum are reduced across
// the four threads with warp shuffles and never touch device memory.
// Causal blocks stop their key loop at the block's last query row. This
// is the simple, exact-f32 first version: wgmma, TMA, register tiling and
// pipelined loads are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 32;                 // keys per tile
constexpr int TPR = 4;                 // threads per query row
constexpr int kThreads = BQ * TPR;     // 256
constexpr int KPT = BK / TPR;          // keys per thread per tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int HD>
constexpr int smem_floats() {
  return BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int H, int K,
             int S, int T_len, int causal, float scale) {
  static_assert(HD % TPR == 0, "head dim must be a multiple of 4");
  constexpr int CW = HD / TPR;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                          // [BQ][HD+1]
  float* Ks = Qs + BQ * (HD + 1);            // [BK][HD+1]
  float* Vs = Ks + BK * (HD + 1);            // [BK][HD]
  float* Ps = Vs + BK * HD;                  // [BQ][BK+1]

  const int tid = threadIdx.x;
  const int r = tid / TPR;                   // query row in the tile
  const int c = tid % TPR;                   // lane in the row's group
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / K);
  const int qpos = q0 + r;

  const T* qb = q + (((int64_t)b * H + h) * S) * HD;
  const T* kb = k + (((int64_t)b * K + kvh) * T_len) * HD;
  const T* vb = v + (((int64_t)b * K + kvh) * T_len) * HD;

  for (int idx = tid; idx < BQ * HD; idx += kThreads) {
    const int row = idx / HD, d = idx % HD;
    Qs[row * (HD + 1) + d] = (q0 + row < S) ? to_f32(qb[(int64_t)(q0 + row) * HD + d]) : 0.f;
  }

  float acc[CW];
#pragma unroll
  for (int j = 0; j < CW; ++j) acc[j] = 0.f;
  float m_run = -INFINITY;
  float l_run = 0.f;

  int k_end = T_len;
  if (causal) k_end = min(T_len, q0 + BQ);  // later keys are masked for every row

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // previous tile fully consumed (and Qs written)
    for (int idx = tid; idx < BK * HD; idx += kThreads) {
      const int key = idx / HD, d = idx % HD;
      const bool in = k0 + key < T_len;
      const int64_t off = (int64_t)(k0 + key) * HD + d;
      Ks[key * (HD + 1) + d] = in ? to_f32(kb[off]) : 0.f;
      Vs[key * HD + d] = in ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    // scores of this thread's keys c, c+4, ..., for query row r
    float s[KPT];
#pragma unroll
    for (int i = 0; i < KPT; ++i) s[i] = 0.f;
    const float* qrow = Qs + r * (HD + 1);
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int i = 0; i < KPT; ++i) s[i] = fmaf(qd, Ks[(c + TPR * i) * (HD + 1) + d], s[i]);
    }
    float m_tile = -INFINITY;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int kpos = k0 + c + TPR * i;
      const bool valid = kpos < T_len && (!causal || kpos <= qpos);
      s[i] = valid ? s[i] * scale : -INFINITY;
      m_tile = fmaxf(m_tile, s[i]);
    }
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 2));
    const float m_new = fmaxf(m_run, m_tile);
    // a row with no valid key so far keeps m = -inf; use 0 as the shift so
    // exp(-inf - shift) = 0 instead of NaN
    const float shift = (m_new == -INFINITY) ? 0.f : m_new;
    float psum = 0.f;
    float* prow = Ps + r * (BK + 1);
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const float p = expf(s[i] - shift);
      psum += p;
      prow[c + TPR * i] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float alpha = expf(m_run - shift);
    l_run = alpha * l_run + psum;
    m_run = m_new;
    __syncwarp();  // the row's p values come from the four lanes of this warp
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[j] *= alpha;
    for (int kk = 0; kk < BK; ++kk) {
      const float p = prow[kk];
      const float* vrow = Vs + kk * HD;
#pragma unroll
      for (int j = 0; j < CW; ++j) acc[j] = fmaf(p, vrow[j * TPR + c], acc[j]);
    }
    __syncwarp();  // Ps row reused by the next tile
  }

  if (qpos < S) {
    const float inv = 1.f / fmaxf(l_run, 1e-30f);
    T* orow = out + (((int64_t)b * H + h) * S + qpos) * HD;
#pragma unroll
    for (int j = 0; j < CW; ++j) orow[j * TPR + c] = from_f32<T>(acc[j] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int K, int S, int T_len, int causal, float scale,
           cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * smem_floats<HD>();
  // The limit belongs to the current device, so it is set on every launch.
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, H, K, S, T_len,
      causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* out,
             int B, int H, int K, int S, int T_len, int causal, float scale,
             cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, B, H, K, S, T_len, causal, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, B, H, K, S, T_len, causal, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, B, H, K, S, T_len, causal, scale, s);
    case 72: return launch<T, 72>(q, k, v, out, B, H, K, S, T_len, causal, scale, s);
    case 80: return launch<T, 80>(q, k, v, out, B, H, K, S, T_len, causal, scale, s);
    case 96: return launch<T, 96>(q, k, v, out, B, H, K, S, T_len, causal, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, B, H, K, S, T_len, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// hd must be one of the instances in dispatch() (HEAD_DIMS in
// flash_attention.py). dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = cudaSuccess); the Python wrapper raises on anything else.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int H,
                                      int K, int S, int T_len, int hd,
                                      int causal, float scale, int dtype,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(hd, q, k, v, out, B, H, K, S, T_len, causal, scale, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(hd, q, k, v, out, B, H, K, S, T_len, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
