// Chunked RWKV6 WKV recurrence for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py:_kernel.
//
//   r/k/v [B,T,H,HD] (f32 or bf16, one dtype), logw [B,T,H,HD] (f32 or
//   bf16), u [H,HD] f32, S0 [B,H,HD,HD] f32, all contiguous;
//   y [B,T,H,HD] f32, S_T [B,H,HD,HD] f32. T is a multiple of the chunk C.
//   Per (b, h) and chunk, with L the inclusive cumsum of logw along time
//   and Lprev = L - logw:
//     A[t,s] = sum_i r[t,i] k[s,i] exp(Lprev[t,i] - L[s,i])   for s < t
//     y      = A v + diag(r u k^T) v + (r * exp(Lprev)) S
//     S     <- exp(Ltot) * S + (k * exp(Ltot - L))^T v
//
// What bounds it on this card: about equally bytes and operations. At the
// RWKV6-3B denoiser's shape (B=8, T=256, H=40, HD=64, C=64) one call
// moves 115 MB (r/k/v/logw and y in f32, S0 and S_T) and does about
// 2.5 GFLOP, most of it the pairwise sum of A (one expf per (t, s, i)
// with s < t) and the two [C,HD]x[HD,HD] products: 34 us of HBM time
// against 38 us at 67 TFLOP/s, f32 outside the tensor cores.
//
// What the design does about it: nothing leaves the SM between chunks.
// One block per (b, h) loops over the chunks itself (the TPU kernel's
// sequential grid axis); S stays in shared memory across them, and the
// pairwise tensor [C, C, HD] the TPU kernel materialises in VMEM is
// never formed: each A[t][s] is one dot product over HD with the decay
// inside. The r/k/v/logw tiles are read straight from the [B,T,H,HD]
// layout (row stride H*HD), without the reference's host-side transpose,
// and y is written back in the same layout. Rows of the tiles read by
// different lanes at one column are padded by one word, so a warp's 32
// rows fall in 32 banks. Exponents are formed only where they are <= 0:
// the upper triangle of A (where Lprev[t] - L[s] > 0 and exp overflows to
// inf, which times a masked 0 gives NaN) is skipped, not masked, and
// exp(Lprev) * exp(-L) is never formed as a product (L reaches -512 in a
// chunk). Accurate expf, no fast math. This is the simple first version:
// register tiling, tensor-core products and overlapped loads are later
// work.
//
// Shared memory at C = HD = 64 is 115,712 bytes (r, k, L and Lprev tiles
// padded, v, A and S not), over the 48 KB default: the launch raises the
// limit with cudaFuncSetAttribute.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// floats of shared memory for head dim HD and chunk C: r, k, L, Lprev
// tiles [C][HD+1], v [C][HD], A [C][C] (its diagonal holds the bonus
// term), S [HD][HD]
template <int HD>
constexpr int smem_floats(int C) {
  return 4 * C * (HD + 1) + C * HD + C * C + HD * HD;
}

template <typename TI, typename TW, int HD>
__global__ void __launch_bounds__(kThreads)
wkv_kernel(const TI* __restrict__ r, const TI* __restrict__ k,
           const TI* __restrict__ v, const TW* __restrict__ logw,
           const float* __restrict__ u, const float* __restrict__ s0,
           float* __restrict__ y, float* __restrict__ s_out, int T, int H,
           int C) {
  constexpr int P = HD + 1;  // padded row pitch
  extern __shared__ float smem[];
  float* Rs = smem;          // [C][P] r, then r * exp(Lprev)
  float* Ks = Rs + C * P;    // [C][P] k, then k * exp(Ltot - L)
  float* Ls = Ks + C * P;    // [C][P] L
  float* Lp = Ls + C * P;    // [C][P] logw, then Lprev = L - logw
  float* Vs = Lp + C * P;    // [C][HD]
  float* As = Vs + C * HD;   // [C][C] A below the diagonal, bonus on it
  float* Ss = As + C * C;    // [HD][HD]

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int64_t row = (int64_t)H * HD;                  // t stride
  const int64_t base = (int64_t)b * T * row + (int64_t)h * HD;
  const int64_t sbase = ((int64_t)b * H + h) * HD * HD;
  const float* uh = u + (int64_t)h * HD;

  for (int idx = tid; idx < HD * HD; idx += kThreads) Ss[idx] = s0[sbase + idx];

  for (int t0 = 0; t0 < T; t0 += C) {
    __syncthreads();  // the previous chunk is done with every tile; S0 is in
    for (int idx = tid; idx < C * HD; idx += kThreads) {
      const int t = idx / HD, i = idx % HD;
      const int64_t g = base + (int64_t)(t0 + t) * row + i;
      Rs[t * P + i] = to_f32(r[g]);
      Ks[t * P + i] = to_f32(k[g]);
      Lp[t * P + i] = to_f32(logw[g]);
      Vs[t * HD + i] = to_f32(v[g]);
    }
    __syncthreads();

    // per-channel inclusive scan along time, in order
    for (int i = tid; i < HD; i += kThreads) {
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        const float lw = Lp[t * P + i];
        acc += lw;
        Ls[t * P + i] = acc;
        Lp[t * P + i] = acc - lw;
      }
    }
    __syncthreads();

    // strictly-lower A: a warp takes 32 consecutive s of one row t, so
    // r[t] and Lprev[t] are broadcast and k[s], L[s] hit 32 banks
    for (int idx = tid; idx < C * C; idx += kThreads) {
      const int t = idx / C, s = idx % C;
      if (s >= t) continue;
      const float* rt = Rs + t * P;
      const float* lt = Lp + t * P;
      const float* ks = Ks + s * P;
      const float* ls = Ls + s * P;
      float acc = 0.f;
#pragma unroll 8
      for (int i = 0; i < HD; ++i) acc = fmaf(rt[i] * ks[i], expf(lt[i] - ls[i]), acc);
      As[t * C + s] = acc;
    }
    for (int t = tid; t < C; t += kThreads) {  // bonus term on the diagonal
      float acc = 0.f;
#pragma unroll 8
      for (int i = 0; i < HD; ++i) acc = fmaf(Rs[t * P + i] * uh[i], Ks[t * P + i], acc);
      As[t * C + t] = acc;
    }
    __syncthreads();

    // raw r and k are done with: decay them in place
    for (int idx = tid; idx < C * HD; idx += kThreads) {
      const int t = idx / HD, i = idx % HD;
      Rs[t * P + i] *= expf(Lp[t * P + i]);
      Ks[t * P + i] *= expf(Ls[(C - 1) * P + i] - Ls[t * P + i]);
    }
    __syncthreads();

    // y = A v + diag v + (r exp(Lprev)) S, written into [B,T,H,HD]
    for (int idx = tid; idx < C * HD; idx += kThreads) {
      const int t = idx / HD, j = idx % HD;
      const float* at = As + t * C;
      float a = 0.f;
      for (int s = 0; s < t; ++s) a = fmaf(at[s], Vs[s * HD + j], a);
      a += at[t] * Vs[t * HD + j];
      float c = 0.f;
      const float* rt = Rs + t * P;
#pragma unroll 8
      for (int i = 0; i < HD; ++i) c = fmaf(rt[i], Ss[i * HD + j], c);
      y[base + (int64_t)(t0 + t) * row + j] = a + c;
    }
    __syncthreads();  // every y has read the old S

    // S <- exp(Ltot) S + (k exp(Ltot - L))^T v
    for (int idx = tid; idx < HD * HD; idx += kThreads) {
      const int i = idx / HD, j = idx % HD;
      float acc = 0.f;
      for (int t = 0; t < C; ++t) acc = fmaf(Ks[t * P + i], Vs[t * HD + j], acc);
      Ss[idx] = expf(Ls[(C - 1) * P + i]) * Ss[idx] + acc;
    }
  }
  // each thread writes the S entries it updated last
  for (int idx = tid; idx < HD * HD; idx += kThreads) s_out[sbase + idx] = Ss[idx];
}

template <typename TI, typename TW, int HD>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, const void* s0, void* y, void* s_out, int B, int T,
           int H, int C, cudaStream_t stream) {
  // The limit belongs to the current device, so it is set on every launch.
  cudaError_t e = cudaFuncSetAttribute(
      wkv_kernel<TI, TW, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * smem_floats<HD>(kMaxChunk)));
  if (e != cudaSuccess) return (int)e;
  const size_t bytes = sizeof(float) * smem_floats<HD>(C);
  dim3 grid(H, B);
  wkv_kernel<TI, TW, HD><<<grid, kThreads, bytes, stream>>>(
      (const TI*)r, (const TI*)k, (const TI*)v, (const TW*)logw,
      (const float*)u, (const float*)s0, (float*)y, (float*)s_out, T, H, C);
  return (int)cudaGetLastError();
}

template <typename TI, typename TW>
int dispatch(int hd, const void* r, const void* k, const void* v,
             const void* logw, const void* u, const void* s0, void* y,
             void* s_out, int B, int T, int H, int C, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<TI, TW, 16>(r, k, v, logw, u, s0, y, s_out, B, T, H, C, s);
    case 32: return launch<TI, TW, 32>(r, k, v, logw, u, s0, y, s_out, B, T, H, C, s);
    case 64: return launch<TI, TW, 64>(r, k, v, logw, u, s0, y, s_out, B, T, H, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TI>
int dispatch_logw(int logw_dtype, int hd, const void* r, const void* k,
                  const void* v, const void* logw, const void* u,
                  const void* s0, void* y, void* s_out, int B, int T, int H,
                  int C, cudaStream_t s) {
  if (logw_dtype == 0)
    return dispatch<TI, float>(hd, r, k, v, logw, u, s0, y, s_out, B, T, H, C, s);
  if (logw_dtype == 1)
    return dispatch<TI, __nv_bfloat16>(hd, r, k, v, logw, u, s0, y, s_out, B, T, H, C, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// hd in {16, 32, 64}, chunk in {16, 32, 64} dividing T (HEAD_DIMS and
// CHUNKS in rwkv6_scan.py). dtype codes: 0 = float32, 1 = bfloat16, for
// r/k/v and for logw. Returns cudaGetLastError() after the launch (0 =
// cudaSuccess); the Python wrapper raises on anything else.
extern "C" int rwkv6_wkv_launch(const void* r, const void* k, const void* v,
                                const void* logw, const void* u,
                                const void* s0, void* y, void* s_out, int B,
                                int T, int H, int hd, int chunk,
                                int rkv_dtype, int logw_dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((chunk != 16 && chunk != 32 && chunk != 64) || T % chunk != 0)
    return (int)cudaErrorInvalidValue;
  if (rkv_dtype == 0)
    return dispatch_logw<float>(logw_dtype, hd, r, k, v, logw, u, s0, y, s_out, B, T, H, chunk, s);
  if (rkv_dtype == 1)
    return dispatch_logw<__nv_bfloat16>(logw_dtype, hd, r, k, v, logw, u, s0, y, s_out, B, T, H, chunk, s);
  return (int)cudaErrorInvalidValue;
}
