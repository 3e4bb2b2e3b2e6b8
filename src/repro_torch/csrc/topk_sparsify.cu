// Approximate top-k sparsification kernels for Hopper (sm_90a): the
// 128-threshold count and the threshold mask.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   count_ge_kernel<T>  <- src/repro/kernels/topk_compress/kernel.py _count_kernel
//   mask_kernel<T>      <- src/repro/kernels/topk_compress/kernel.py _mask_kernel
// (reached through ops.count_ge / ops.apply_threshold <- ops.topk_sparsify:
// three counts, one for each bisection round, and one mask a call).
//
// Function.  For x of n elements (f32 or bf16, compared in f32):
//   count_ge:  counts[j] = #{i : |x_i| >= t_j} for 128 thresholds t_j in
//              any order, as exact 64-bit integers (the TPU kernel sums f32
//              counts, exact only below 2^24);
//   mask:      o_i = |x_i| >= t ? x_i : +0.0 in x's type, one f32 threshold
//              read on the device.
// NaN elements are counted nowhere and dropped by the mask (every
// comparison with NaN is false), as in the reference.
//
// Design.  The TPU count broadcasts a (8192, 128) compare in VMEM per
// block and carries the counts across a sequential grid.  Here blocks run
// in parallel over a grid-stride loop: lane j of every warp owns the four
// thresholds j, j + 32, j + 64, j + 96 in registers, and the warp's 128
// loaded elements reach every lane by shuffles, so each element meets all
// 128 thresholds without shared-memory traffic.  Counts stay in 32-bit
// registers, are summed per block in shared memory and added to the
// 64-bit result with one atomic per block and threshold: integer sums, so
// the result is exact and independent of order.  The mask is a streaming
// pass: each thread issues its two 16-byte loads before its first store,
// on a grid that covers x once (one block for each 512 vectors), and a
// scalar loop takes the tail; where x or o does not start on 16 bytes (a
// view at an offset), the scalar loop takes all of x.  On the H100 this
// one-shot grid ran at F.hardshrink's speed, where a persistent grid of
// every resident block (with one or four loads in flight), the evict-first
// hints on loads or stores, and the threshold staged once a block through
// shared memory were slower.
//
// Bound.  Bytes: the count reads x once (4 or 2 bytes an element), the
// mask reads and writes it once.  The count as written does 128 compares
// and 128 adds an element on the CUDA cores, which at f32 rates is above
// the byte time; a design that sorts the 128 thresholds once and finds
// each element's rank (7 compares and one add) would be bound by bytes.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream, never synchronises, allocates nothing, and returns
// cudaGetLastError() so a refused launch is reported by the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNCand = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = 4;  // elements a lane loads per step
constexpr unsigned kFull = 0xffffffffu;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
count_ge_kernel(const T* __restrict__ x, long long n, const float* __restrict__ t,
                unsigned long long* __restrict__ counts) {
  __shared__ unsigned long long block_counts[kNCand];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < kNCand; j += kThreads) block_counts[j] = 0ull;
  const float t0 = t[lane], t1 = t[lane + 32], t2 = t[lane + 64], t3 = t[lane + 96];
  unsigned c0 = 0, c1 = 0, c2 = 0, c3 = 0;

  const long long step = (long long)gridDim.x * kWarps * 32 * kPerLane;
  for (long long base = ((long long)blockIdx.x * kWarps + warp) * 32 * kPerLane;
       base < n; base += step) {
    float a[kPerLane];
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const long long i = base + u * 32 + lane;
      a[u] = i < n ? fabsf(to_f32<T>(x[i])) : __int_as_float(0x7fffffff);  // NaN
    }
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
#pragma unroll 8
      for (int e = 0; e < 32; ++e) {
        const float ae = __shfl_sync(kFull, a[u], e);
        c0 += ae >= t0;
        c1 += ae >= t1;
        c2 += ae >= t2;
        c3 += ae >= t3;
      }
    }
  }
  __syncthreads();  // block_counts is zeroed
  atomicAdd(&block_counts[lane], (unsigned long long)c0);
  atomicAdd(&block_counts[lane + 32], (unsigned long long)c1);
  atomicAdd(&block_counts[lane + 64], (unsigned long long)c2);
  atomicAdd(&block_counts[lane + 96], (unsigned long long)c3);
  __syncthreads();
  for (int j = threadIdx.x; j < kNCand; j += kThreads) {
    if (block_counts[j]) atomicAdd(&counts[j], block_counts[j]);
  }
}

// 16 bytes of elements of type T
template <typename T> struct Vec {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

template <typename T>
__device__ __forceinline__ T keep_or_zero(T v, float thr) {
  return fabsf(to_f32<T>(v)) >= thr ? v : T(0.0f);  // T(0) is +0.0
}

// 16-byte loads of a thread in flight at once, all issued before any store
constexpr int kMaskLoads = 2;

// One pass over x: block b owns the kThreads * kMaskLoads 16-byte vectors
// from b * kThreads * kMaskLoads on (vector u of a thread kThreads apart,
// so each load is coalesced); the grid covers the vectors once.  The
// scalar part (the tail, or all of x when x or o is not on 16 bytes)
// strides over the same grid.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mask_kernel(const T* __restrict__ x, long long n, const float* __restrict__ t,
            T* __restrict__ o, int aligned) {
  using V = Vec<T>;
  const float thr = __ldg(t);
  const long long nvec = aligned ? n / V::kN : 0;
  const long long base = (long long)blockIdx.x * kThreads * kMaskLoads + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(o);
  uint4 raw[kMaskLoads];
#pragma unroll
  for (int u = 0; u < kMaskLoads; ++u) {
    const long long j = base + u * kThreads;
    if (j < nvec) raw[u] = xv[j];
  }
#pragma unroll
  for (int u = 0; u < kMaskLoads; ++u) {
    const long long j = base + u * kThreads;
    if (j < nvec) {
      V& e = *reinterpret_cast<V*>(&raw[u]);
#pragma unroll
      for (int q = 0; q < V::kN; ++q) e.v[q] = keep_or_zero<T>(e.v[q], thr);
      ov[j] = raw[u];
    }
  }
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = nvec * V::kN + (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride)
    o[i] = keep_or_zero<T>(x[i], thr);
}

int grid_for(long long work, long long per_block) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (work + per_block - 1) / per_block;
  const long long cap = 8LL * sms;
  if (blocks > cap) blocks = cap;
  return (int)(blocks < 1 ? 1 : blocks);
}

// The mask's grid: one block for each kThreads * kMaskLoads vectors (or
// scalar elements where x is not on 16 bytes), at least one.
long long mask_grid(long long work) {
  const long long per_block = (long long)kThreads * kMaskLoads;
  const long long blocks = (work + per_block - 1) / per_block;
  return blocks < 1 ? 1 : blocks;
}

}  // namespace

extern "C" {

// x: n contiguous elements, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// t: 128 f32 thresholds; counts: 128 uint64, zeroed by the caller.
int repro_count_ge(const void* x, long long n, const float* t, void* counts,
                   int is_bf16, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = grid_for(n, (long long)kThreads * kPerLane);
  auto* c = static_cast<unsigned long long*>(counts);
  if (is_bf16)
    count_ge_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), n, t, c);
  else
    count_ge_kernel<float><<<grid, kThreads, 0, st>>>(static_cast<const float*>(x), n, t, c);
  return (int)cudaGetLastError();
}

// x and o: n contiguous elements of one type, at any element offset; t:
// one f32 threshold on the device.
int repro_apply_threshold(const void* x, long long n, const float* t, void* o,
                          int is_bf16, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(o)) % 16 == 0;
  const long long grid = mask_grid(aligned ? n / (is_bf16 ? 8 : 4) : n);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    mask_kernel<__nv_bfloat16><<<(unsigned)grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), n, t, static_cast<__nv_bfloat16*>(o), aligned);
  else
    mask_kernel<float><<<(unsigned)grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), n, t, static_cast<float*>(o), aligned);
  return (int)cudaGetLastError();
}

}  // extern "C"
