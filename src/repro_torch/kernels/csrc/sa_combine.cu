// SA-Solver state combines for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernels
//   src/repro/kernels/sa_update.py:_kernel   (sa_update)
//   src/repro/kernels/sa_fused.py:_kernel    (sa_fused_update)
//
//   sa_update:  out  = decay*x + noise*xi + sum_{j<P} b_j * buf[j]
//   sa_fused:   pred = c[0,0]*x + c[0,1]*xi + sum_j c[0,2+j] * buf[j]
//               corr = c[1,0]*x + c[1,1]*xi + sum_j c[1,2+j] * buf[j]
//
// over the flattened latent (n elements), buf stacked as [P, n]. f32
// accumulation in the reference's order (decay*x + noise*xi first, then the
// b_j terms in j order, each product rounded before its add, as the plain
// PyTorch chain does), output in the operand dtype (f32 or bf16).
//
// What bounds it on this card: bytes. Each element is read P+2 times and
// written once (twice for sa_fused) against 2(P+2) (4(P+2)) flops, about
// 0.1 flop per byte, three orders of magnitude below the H100's
// flop-per-byte balance. The least time is (P+2 reads + writes) * n *
// itemsize / 3.35 TB/s.
//
// What the design does about it: one pass, each operand byte read once and
// each output written once; 16-byte vector loads and stores (4 f32 or 8 bf16
// elements per thread per operand) wherever every operand pointer and the
// row stride n are 16-byte aligned, a masked scalar tail otherwise (no
// host-side padding or copy); a grid-stride loop so one launch covers any n.
// The coefficients (P+2 or 2(P+2) floats) are read once per thread block
// into shared memory. P <= 5 is a template parameter, so the row loop
// unrolls and the accumulators stay in registers. The TPU's (8, 128) tile
// grain (choose_tile / lane_align) has no counterpart here.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks on each of 132 SMs

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Elements per 16-byte vector.
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < Vec<T>::N; ++k) out[k] = to_f32(e[k]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int k = 0; k < Vec<T>::N; ++k) e[k] = from_f32<T>(in[k]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// acc = c0*x + c1*xi, then acc += c[2+j]*b_j; explicit round-to-nearest
// intrinsics keep nvcc from contracting into FMAs, so the kernel rounds
// exactly where the plain chain does.
__device__ __forceinline__ float head(const float* c, float x, float xi) {
  return __fadd_rn(__fmul_rn(c[0], x), __fmul_rn(c[1], xi));
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
sa_update_kernel(const T* __restrict__ x, const T* __restrict__ buf,
                 const T* __restrict__ xi, const float* __restrict__ coeffs,
                 T* __restrict__ out, int64_t n, int vectorized) {
  __shared__ float c[P + 2];
  if (threadIdx.x < P + 2) c[threadIdx.x] = coeffs[threadIdx.x];
  __syncthreads();
  constexpr int V = Vec<T>::N;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n_vec = vectorized ? n / V : 0;
  for (int64_t v = tid; v < n_vec; v += stride) {
    const int64_t base = v * V;
    float xv[V], xiv[V], acc[V], bv[V];
    load_vec(x + base, xv);
    load_vec(xi + base, xiv);
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = head(c, xv[k], xiv[k]);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      load_vec(buf + (int64_t)j * n + base, bv);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(c[2 + j], bv[k]));
    }
    store_vec(out + base, acc);
  }
  // scalar path: the whole range when unaligned, else the ragged tail
  for (int64_t e = n_vec * V + tid; e < n; e += stride) {
    float acc = head(c, to_f32(x[e]), to_f32(xi[e]));
#pragma unroll
    for (int j = 0; j < P; ++j)
      acc = __fadd_rn(acc, __fmul_rn(c[2 + j], to_f32(buf[(int64_t)j * n + e])));
    out[e] = from_f32<T>(acc);
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
sa_fused_kernel(const T* __restrict__ x, const T* __restrict__ buf,
                const T* __restrict__ xi, const float* __restrict__ coeffs,
                T* __restrict__ pred, T* __restrict__ corr, int64_t n,
                int vectorized) {
  __shared__ float c[2 * (P + 2)];  // row 0 predictor, row 1 corrector
  if (threadIdx.x < 2 * (P + 2)) c[threadIdx.x] = coeffs[threadIdx.x];
  __syncthreads();
  const float* cp = c;
  const float* cc = c + (P + 2);
  constexpr int V = Vec<T>::N;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n_vec = vectorized ? n / V : 0;
  for (int64_t v = tid; v < n_vec; v += stride) {
    const int64_t base = v * V;
    float xv[V], xiv[V], ap[V], ac[V], bv[V];
    load_vec(x + base, xv);
    load_vec(xi + base, xiv);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      ap[k] = head(cp, xv[k], xiv[k]);
      ac[k] = head(cc, xv[k], xiv[k]);
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      load_vec(buf + (int64_t)j * n + base, bv);  // one read feeds both sums
#pragma unroll
      for (int k = 0; k < V; ++k) {
        ap[k] = __fadd_rn(ap[k], __fmul_rn(cp[2 + j], bv[k]));
        ac[k] = __fadd_rn(ac[k], __fmul_rn(cc[2 + j], bv[k]));
      }
    }
    store_vec(pred + base, ap);
    store_vec(corr + base, ac);
  }
  for (int64_t e = n_vec * V + tid; e < n; e += stride) {
    const float xe = to_f32(x[e]), xie = to_f32(xi[e]);
    float ap = head(cp, xe, xie);
    float ac = head(cc, xe, xie);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float b = to_f32(buf[(int64_t)j * n + e]);
      ap = __fadd_rn(ap, __fmul_rn(cp[2 + j], b));
      ac = __fadd_rn(ac, __fmul_rn(cc[2 + j], b));
    }
    pred[e] = from_f32<T>(ap);
    corr[e] = from_f32<T>(ac);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T>
int grid_for(int64_t n, int vectorized) {
  const int64_t work = vectorized ? (n + Vec<T>::N - 1) / Vec<T>::N : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return (int)blocks;
}

template <typename T, int P>
void launch_update(const void* x, const void* buf, const void* xi,
                   const void* coeffs, void* out, int64_t n, cudaStream_t s) {
  const int vec = aligned16(x) && aligned16(buf) && aligned16(xi) &&
                  aligned16(out) && (n % Vec<T>::N == 0);
  sa_update_kernel<T, P><<<grid_for<T>(n, vec), kThreads, 0, s>>>(
      (const T*)x, (const T*)buf, (const T*)xi, (const float*)coeffs,
      (T*)out, n, vec);
}

template <typename T, int P>
void launch_fused(const void* x, const void* buf, const void* xi,
                  const void* coeffs, void* pred, void* corr, int64_t n,
                  cudaStream_t s) {
  const int vec = aligned16(x) && aligned16(buf) && aligned16(xi) &&
                  aligned16(pred) && aligned16(corr) &&
                  (n % Vec<T>::N == 0);
  sa_fused_kernel<T, P><<<grid_for<T>(n, vec), kThreads, 0, s>>>(
      (const T*)x, (const T*)buf, (const T*)xi, (const float*)coeffs,
      (T*)pred, (T*)corr, n, vec);
}

template <typename T>
int dispatch_update(int P, const void* x, const void* buf, const void* xi,
                    const void* coeffs, void* out, int64_t n, cudaStream_t s) {
  switch (P) {
    case 1: launch_update<T, 1>(x, buf, xi, coeffs, out, n, s); break;
    case 2: launch_update<T, 2>(x, buf, xi, coeffs, out, n, s); break;
    case 3: launch_update<T, 3>(x, buf, xi, coeffs, out, n, s); break;
    case 4: launch_update<T, 4>(x, buf, xi, coeffs, out, n, s); break;
    case 5: launch_update<T, 5>(x, buf, xi, coeffs, out, n, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_fused(int P, const void* x, const void* buf, const void* xi,
                   const void* coeffs, void* pred, void* corr, int64_t n,
                   cudaStream_t s) {
  switch (P) {
    case 1: launch_fused<T, 1>(x, buf, xi, coeffs, pred, corr, n, s); break;
    case 2: launch_fused<T, 2>(x, buf, xi, coeffs, pred, corr, n, s); break;
    case 3: launch_fused<T, 3>(x, buf, xi, coeffs, pred, corr, n, s); break;
    case 4: launch_fused<T, 4>(x, buf, xi, coeffs, pred, corr, n, s); break;
    case 5: launch_fused<T, 5>(x, buf, xi, coeffs, pred, corr, n, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = cudaSuccess); the Python wrapper raises on anything else.
extern "C" int sa_update_launch(const void* x, const void* buf, const void* xi,
                                const void* coeffs, void* out, long long n,
                                int P, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_update<float>(P, x, buf, xi, coeffs, out, n, s);
  if (dtype == 1) return dispatch_update<__nv_bfloat16>(P, x, buf, xi, coeffs, out, n, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int sa_fused_launch(const void* x, const void* buf, const void* xi,
                               const void* coeffs, void* pred, void* corr,
                               long long n, int P, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_fused<float>(P, x, buf, xi, coeffs, pred, corr, n, s);
  if (dtype == 1) return dispatch_fused<__nv_bfloat16>(P, x, buf, xi, coeffs, pred, corr, n, s);
  return (int)cudaErrorInvalidValue;
}
