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
// over the flattened latent (n elements), buf stacked as [P, n]; or L
// lanes of their own operands and coefficients in one launch (blockIdx.y
// the lane; sa_update_lanes, sa_fused_update_lanes). f32
// accumulation in the reference's order (decay*x + noise*xi first, then the
// b_j terms in j order, each product rounded before its add, as the plain
// PyTorch chain does), output in the operand dtype (f32 or bf16).
//
// What bounds it on this card: bytes. Each element is read P+2 times and
// written once (twice for sa_fused) against 2(P+2) (4(P+2)) flops, about
// 0.1 flop per byte, three orders of magnitude below the H100's
// flop-per-byte balance. The least time is (P+2 reads + writes) * n *
// itemsize / 3.35 TB/s. At the main path's latent (n = 32,768) that is
// 0.23-0.27 us, below the per-launch floor: there the kernel is bound by
// the latency of one round trip to memory, and what counts is that every
// SM issues its loads at once.
//
// What the design does about it:
// - One pass, each operand byte read once through the read-only path
//   (ld.global.nc) and each output written once, with plain stores: the
//   next kernel reads the outputs, so no hint pushes them out of L2.
// - 16-byte vectors (4 f32 or 8 bf16 elements) wherever every operand
//   pointer and the row stride n are 16-byte aligned; a scalar loop
//   otherwise (ragged n, views that start off alignment), correct and
//   slow, with no host-side padding or copy.
// - The coefficients (P+2, or 2(P+2) for sa_fused) go straight into
//   registers by warp-uniform read-only loads, issued together with the
//   operand loads: no shared-memory staging, no barrier before the first
//   operand load.
// - The geometry comes from the wrapper (kernels/sa_update.py,
//   combine_geometry): at small n one vector per thread in blocks of
//   32-256 threads, so the grid spans every SM; at large n blocks of 256
//   threads, the grid capped at two resident blocks per SM on the vector
//   path (16 on the scalar one), a grid-stride loop beyond that. A thread
//   issues all P+2 16-byte loads of a vector before its first multiply;
//   each load instruction of a warp reads 512 contiguous bytes. (Two
//   vectors per thread per step were tried and ran no faster past the L2.)
// - P <= 5 is a template parameter, so the loops unroll and the
//   accumulators stay in registers. The TPU's (8, 128) tile grain
//   (choose_tile / lane_align) has no counterpart here.
// - P >= 6 (the reference's kernels take any P) runs one kernel with P a
//   runtime argument, for both entries: each block stages its lane's
//   R x (P+2) coefficients in shared memory, and a thread loads one
//   history row's 16-byte vector (or element) at a time and adds it
//   before the next load, in the same order and rounding as the
//   instances. It is right, not tuned: no P+2 loads in flight.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMinBlocksPerSM = 2;  // the vector path's resident blocks in combine_geometry

// A 16-byte vector of T as f32 values, and one T element, in and out.
template <typename T> struct Elem;

template <> struct Elem<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ static float load(const float* p) { return __ldg(p); }
  __device__ static void store(float* p, float v) { *p = v; }
};

template <> struct Elem<__nv_bfloat16> {
  static constexpr int N = 8;
  // element 2i is the low half of word i; bf16 -> f32 is exact
  __device__ static void unpack(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint32_t bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ static uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = bits(f[2 * i]) | (bits(f[2 * i + 1]) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static float load(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }
  __device__ static void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
};

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// acc = c0*x + c1*xi, then acc += c[2+j]*b_j; explicit round-to-nearest
// intrinsics keep nvcc from contracting into FMAs, so the kernel rounds
// exactly where the plain chain does.
__device__ __forceinline__ float head(const float* c, float x, float xi) {
  return __fadd_rn(__fmul_rn(c[0], x), __fmul_rn(c[1], xi));
}

template <typename T, int P, int R>
__device__ __forceinline__ void combine(
    const T* __restrict__ x, const T* __restrict__ buf,
    const T* __restrict__ xi, const float* __restrict__ coeffs,
    T* const (&out)[R], int64_t n, int vectorized) {
  float c[R][P + 2];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < P + 2; ++j) c[r][j] = __ldg(coeffs + r * (P + 2) + j);
  constexpr int V = Elem<T>::N;
  const int64_t n_vec = vectorized ? n / V : 0;
  const int64_t threads = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < n_vec;
       v += threads) {
    // all P+2 loads before the first multiply
    const uint4 rx = load16(x + v * V), rxi = load16(xi + v * V);
    uint4 rb[P];
#pragma unroll
    for (int j = 0; j < P; ++j) rb[j] = load16(buf + j * n + v * V);
    float xv[V], xiv[V], bv[V], acc[R][V];
    Elem<T>::unpack(rx, xv);
    Elem<T>::unpack(rxi, xiv);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int k = 0; k < V; ++k) acc[r][k] = head(c[r], xv[k], xiv[k]);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      Elem<T>::unpack(rb[j], bv);  // one read feeds every row
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int k = 0; k < V; ++k)
          acc[r][k] = __fadd_rn(acc[r][k], __fmul_rn(c[r][2 + j], bv[k]));
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      *reinterpret_cast<uint4*>(out[r] + v * V) = Elem<T>::pack(acc[r]);
  }
  // scalar path: the whole range when not vectorized, else nothing (the
  // vector path needs n % V == 0)
  for (int64_t e = n_vec * V + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       e < n; e += threads) {
    float b[P];
#pragma unroll
    for (int j = 0; j < P; ++j) b[j] = Elem<T>::load(buf + j * n + e);
    const float xe = Elem<T>::load(x + e), xie = Elem<T>::load(xi + e);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float acc = head(c[r], xe, xie);
#pragma unroll
      for (int j = 0; j < P; ++j) acc = __fadd_rn(acc, __fmul_rn(c[r][2 + j], b[j]));
      Elem<T>::store(out[r] + e, acc);
    }
  }
}

// blockIdx.y is the lane: lane l's operands are x[l], buf[l] (its own
// [P, n] history), xi[l], coeffs[l] and out[l], each lane n elements
// apart. A solo combine is one lane (gridDim.y = 1). The reference runs its
// per-lane step under jax.vmap, which gives the Pallas kernels a lane grid
// axis with per-lane coefficients. blockIdx.x runs over the lane's n
// elements with the same geometry and arithmetic at any lane count, so
// lane l's output equals a one-lane launch on lane l's operands bit for
// bit. Every lane's base pointer is 16-byte aligned when the first lane's
// is and n is a multiple of the vector width, which the alignment check
// already asks.
template <typename T, int P>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocksPerSM)
sa_update_kernel(const T* __restrict__ x, const T* __restrict__ buf,
                 const T* __restrict__ xi, const float* __restrict__ coeffs,
                 T* __restrict__ out, int64_t n, int vectorized) {
  const int64_t l = blockIdx.y;
  T* const outs[1] = {out + l * n};
  combine<T, P, 1>(x + l * n, buf + l * P * n, xi + l * n, coeffs + l * (P + 2),
                   outs, n, vectorized);
}

template <typename T, int P>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocksPerSM)
sa_fused_kernel(const T* __restrict__ x, const T* __restrict__ buf,
                const T* __restrict__ xi, const float* __restrict__ coeffs,
                T* __restrict__ pred, T* __restrict__ corr, int64_t n,
                int vectorized) {
  const int64_t l = blockIdx.y;
  // coeffs row 0 predictor, row 1 corrector
  T* const outs[2] = {pred + l * n, corr + l * n};
  combine<T, P, 2>(x + l * n, buf + l * P * n, xi + l * n,
                   coeffs + l * 2 * (P + 2), outs, n, vectorized);
}

// P >= 6: P at run time, R = 1 (sa_update) or 2 (sa_fused), lane l =
// blockIdx.y as above. The lane's R x (P+2) coefficients are staged in
// shared memory (dynamic, R * (P+2) floats); the arithmetic is
// combine()'s, one history row at a time.
template <typename T, int R>
__global__ void __launch_bounds__(kMaxThreads)
sa_rows_kernel(const T* __restrict__ x, const T* __restrict__ buf,
               const T* __restrict__ xi, const float* __restrict__ coeffs,
               T* __restrict__ out0, T* __restrict__ out1, int64_t n, int P,
               int vectorized) {
  extern __shared__ float c[];  // [R][P+2]
  const int W = P + 2;
  const int64_t l = blockIdx.y;
  for (int i = threadIdx.x; i < R * W; i += blockDim.x)
    c[i] = __ldg(coeffs + l * R * W + i);
  __syncthreads();
  x += l * n;
  xi += l * n;
  buf += l * P * n;
  T* const out[2] = {out0 + l * n, R == 2 ? out1 + l * n : nullptr};
  constexpr int V = Elem<T>::N;
  const int64_t n_vec = vectorized ? n / V : 0;
  const int64_t threads = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < n_vec;
       v += threads) {
    float xv[V], xiv[V], bv[V], acc[R][V];
    Elem<T>::unpack(load16(x + v * V), xv);
    Elem<T>::unpack(load16(xi + v * V), xiv);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int k = 0; k < V; ++k) acc[r][k] = head(c + r * W, xv[k], xiv[k]);
    for (int j = 0; j < P; ++j) {
      Elem<T>::unpack(load16(buf + j * n + v * V), bv);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int k = 0; k < V; ++k)
          acc[r][k] = __fadd_rn(acc[r][k], __fmul_rn(c[r * W + 2 + j], bv[k]));
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      *reinterpret_cast<uint4*>(out[r] + v * V) = Elem<T>::pack(acc[r]);
  }
  for (int64_t e = n_vec * V + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       e < n; e += threads) {
    const float xe = Elem<T>::load(x + e), xie = Elem<T>::load(xi + e);
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = head(c + r * W, xe, xie);
    for (int j = 0; j < P; ++j) {
      const float b = Elem<T>::load(buf + j * n + e);
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r] = __fadd_rn(acc[r], __fmul_rn(c[r * W + 2 + j], b));
    }
#pragma unroll
    for (int r = 0; r < R; ++r) Elem<T>::store(out[r] + e, acc[r]);
  }
}

constexpr int kMaxLanes = 65535;  // gridDim.y
// the runtime-P kernel's coefficients fit the static shared-memory default
constexpr int kMaxCoeffBytes = 48 * 1024;

struct Launch {
  const void *x, *buf, *xi, *coeffs;
  void *out0, *out1;  // out1 null: sa_update
  long long n;        // elements per lane
  int blocks, threads, vectorized;
  int lanes;          // gridDim.y
  cudaStream_t stream;
};

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// What the kernels can run: blocks of 32, 64, 128 or 256 threads; the
// vector path only where every pointer and n are 16-byte aligned.
template <typename T>
bool runnable(const Launch& a) {
  if (a.n < 0 || a.blocks < 1 || a.lanes < 1 || a.lanes > kMaxLanes) return false;
  if (a.threads != 32 && a.threads != 64 && a.threads != 128 && a.threads != 256)
    return false;
  if (a.vectorized == 0) return true;
  return a.vectorized == 1 && a.n % Elem<T>::N == 0 && aligned16(a.x) &&
         aligned16(a.buf) && aligned16(a.xi) && aligned16(a.out0) &&
         (!a.out1 || aligned16(a.out1));
}

template <typename T, int P>
int launch(const Launch& a) {
  const dim3 grid(a.blocks, a.lanes);
  if (a.out1)
    sa_fused_kernel<T, P><<<grid, a.threads, 0, a.stream>>>(
        (const T*)a.x, (const T*)a.buf, (const T*)a.xi, (const float*)a.coeffs,
        (T*)a.out0, (T*)a.out1, a.n, a.vectorized);
  else
    sa_update_kernel<T, P><<<grid, a.threads, 0, a.stream>>>(
        (const T*)a.x, (const T*)a.buf, (const T*)a.xi, (const float*)a.coeffs,
        (T*)a.out0, a.n, a.vectorized);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows(const Launch& a, int P) {
  const int R = a.out1 ? 2 : 1;
  const size_t bytes = sizeof(float) * R * ((size_t)P + 2);
  if (bytes > (size_t)kMaxCoeffBytes) return (int)cudaErrorInvalidValue;
  const dim3 grid(a.blocks, a.lanes);
  if (a.out1)
    sa_rows_kernel<T, 2><<<grid, a.threads, bytes, a.stream>>>(
        (const T*)a.x, (const T*)a.buf, (const T*)a.xi, (const float*)a.coeffs,
        (T*)a.out0, (T*)a.out1, a.n, P, a.vectorized);
  else
    sa_rows_kernel<T, 1><<<grid, a.threads, bytes, a.stream>>>(
        (const T*)a.x, (const T*)a.buf, (const T*)a.xi, (const float*)a.coeffs,
        (T*)a.out0, nullptr, a.n, P, a.vectorized);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Launch& a, int P) {
  if (!runnable<T>(a)) return (int)cudaErrorInvalidValue;
  switch (P) {
    case 1: return launch<T, 1>(a);
    case 2: return launch<T, 2>(a);
    case 3: return launch<T, 3>(a);
    case 4: return launch<T, 4>(a);
    case 5: return launch<T, 5>(a);
    default: return P >= 6 ? launch_rows<T>(a, P) : (int)cudaErrorInvalidValue;
  }
}

int dispatch(const Launch& a, int P, int dtype) {
  if (dtype == 0) return dispatch<float>(a, P);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, P);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. P >= 1 (1..5 template instances;
// from 6 the runtime-P kernel, while its R x (P+2) coefficients fit 48 KB
// of shared memory). blocks and threads come from combine_geometry;
// vectorized says that every pointer and n are 16-byte aligned. lanes (1..65535) combines of n elements each: x, xi and the
// outputs [lanes, n], buf [lanes, P, n], coeffs [lanes, P+2] (sa_update)
// or [lanes, 2, P+2] (sa_fused); a solo combine is lanes = 1. Returns
// cudaErrorInvalidValue for what the kernels cannot run (no launch), else
// cudaGetLastError() after the launch (0 = cudaSuccess); the Python
// wrapper raises on anything but 0.
extern "C" int sa_update_launch(const void* x, const void* buf, const void* xi,
                                const void* coeffs, void* out, long long n,
                                int P, int dtype, int blocks, int threads,
                                int vectorized, int lanes, void* stream) {
  const Launch a{x, buf, xi, coeffs, out, nullptr, n, blocks, threads,
                 vectorized, lanes, (cudaStream_t)stream};
  return dispatch(a, P, dtype);
}

extern "C" int sa_fused_launch(const void* x, const void* buf, const void* xi,
                               const void* coeffs, void* pred, void* corr,
                               long long n, int P, int dtype, int blocks,
                               int threads, int vectorized, int lanes,
                               void* stream) {
  if (!corr) return (int)cudaErrorInvalidValue;
  const Launch a{x, buf, xi, coeffs, pred, corr, n, blocks, threads,
                 vectorized, lanes, (cudaStream_t)stream};
  return dispatch(a, P, dtype);
}
