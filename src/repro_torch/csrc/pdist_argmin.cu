// Nearest centroid for Hopper (sm_90a): for every point, the index and the
// distance of its nearest centroid under l2 (squared), l1 or l-infinity.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   pdist_argmin_kernel<T, M>  <- src/repro/kernels/pdist_argmin/kernel.py _pdist_kernel
// (reached through ops.pdist_argmin <- the E-step of ml/clustering.py:
// kmeans, distributed_kmeans, consensus_kmeans and kmeans_pp_init).
//
// Function.  For X (N, d) and C (K, d), both f32 or both bf16, on the card:
//   dist[n] = min_k D(x_n, c_k),  idx[n] = the first k attaining it,
//   D = sum_j (x_j - c_j)^2 (l2, squared), sum_j |x_j - c_j| (l1),
//       max_j |x_j - c_j| (linf),
// computed in f32 (bf16 is widened exactly).  l2 is the direct form, as
// the JAX package's ref.py and clustering E-step write it, not the TPU
// kernel's expanded |x|^2 - 2 x.c + |c|^2 (kernel.py:23-30): the direct
// form is never negative and has no cancellation when |x| >> |x - c|.
// Each centroid's sum runs over j in increasing order with one fused
// multiply-add per term, so it agrees with the plain version up to the
// order of summation (and the rounding an FMA saves), not bitwise.
//
// Design.  The TPU kernel keeps all of C resident in VMEM (K <= 1024,
// d <= 512: 2 MB) and streams blocks of 128 points.  A Hopper block has
// at most 227 KB of shared memory, so here C passes through shared memory
// in tiles of kTileK centroids by kTileD coordinates (8 KB).  One thread
// owns one point: the block's 128 points are in flight together, each
// thread keeps kTileK running sums in registers while it walks the tile's
// coordinates four at a time (a 16-byte shared load serves four terms of
// one centroid, broadcast to the warp), and after each centroid tile it
// folds the tile's sums into its running minimum in increasing k with a
// strict '<', so ties go to the first index as jnp.argmin's do.  Columns
// past d and rows past K are staged as zeros and never win; points past N
// are masked, so nothing needs padding.  Offsets are 64-bit (N d may pass
// 2^31).
//
// Bound.  Operations: 3 N K d f32 operations (subtract, multiply, add; a
// subtract, an absolute value and an add or max for l1 and linf), against
// N d + K d elements read and 8 N bytes written.  At the KDD Cup 1999
// shape (N 4,898,432, d 42, K 1,000) that is 6.2e11 operations, 9.2 ms at
// the card's 67 TFLOP/s of f32 outside the tensor cores, while the bytes
// take 0.26 ms: the kernel is bound by arithmetic.  It does two f32
// instructions per term (a subtract and an FMA) and one 16-byte shared
// load per four terms, on the CUDA cores.  The expanded form on the tensor
// cores would cut the arithmetic to one matrix product; that is a later
// change.
//
// Plain C interface for ctypes: the entry point launches on the given
// stream, never synchronises, allocates nothing, and returns
// cudaGetLastError() so a refused launch is reported by the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;  // points per block, one per thread
constexpr int kTileK = 16;   // centroids staged per tile
constexpr int kTileD = 128;  // coordinates staged per tile (a multiple of 4)

enum Metric { kL2 = 0, kL1 = 1, kLinf = 2 };

struct Bf16 {};  // tag: elements are bf16 bit patterns (uint16_t)

template <typename T> struct Elem;

template <> struct Elem<float> {
  using Storage = float;
  __device__ static __forceinline__ float load(const Storage* p) { return __ldg(p); }
};

// bf16 -> f32 is exact: the bf16 bits are the high half of the f32.
template <> struct Elem<Bf16> {
  using Storage = uint16_t;
  __device__ static __forceinline__ float load(const Storage* p) {
    return __uint_as_float(((unsigned)__ldg(p)) << 16);
  }
};

template <int M>
__device__ __forceinline__ float accumulate(float acc, float x, float c) {
  const float delta = x - c;
  if (M == kL2) return fmaf(delta, delta, acc);
  if (M == kL1) return acc + fabsf(delta);
  return fmaxf(acc, fabsf(delta));
}

template <typename T, int M>
__global__ void __launch_bounds__(kBlock)
pdist_argmin_kernel(const typename Elem<T>::Storage* __restrict__ X,
                    const typename Elem<T>::Storage* __restrict__ C,
                    int* __restrict__ idx_out, float* __restrict__ dist_out,
                    long long N, int K, int d) {
  __shared__ __align__(16) float tile[kTileK * kTileD];
  const long long n = (long long)blockIdx.x * kBlock + threadIdx.x;
  const bool valid = n < N;
  const typename Elem<T>::Storage* x = X + (valid ? n : 0) * (long long)d;

  float best = __int_as_float(0x7f800000);  // +inf
  int best_k = 0;
  for (int k0 = 0; k0 < K; k0 += kTileK) {
    float acc[kTileK];
#pragma unroll
    for (int t = 0; t < kTileK; ++t) acc[t] = 0.0f;
    for (int j0 = 0; j0 < d; j0 += kTileD) {
      const int dn = min(kTileD, d - j0);
      const int dn4 = (dn + 3) & ~3;  // zero columns up to a multiple of 4
      __syncthreads();  // the previous tile is no longer read
      for (int e = threadIdx.x; e < kTileK * dn4; e += kBlock) {
        const int t = e / dn4, j = e - t * dn4;
        const int k = k0 + t;
        tile[t * kTileD + j] =
            (k < K && j < dn) ? Elem<T>::load(C + (long long)k * d + j0 + j) : 0.0f;
      }
      __syncthreads();
      if (valid) {
        for (int j = 0; j < dn4; j += 4) {
          // the point's four coordinates, zero past d (a zero column of the
          // tile then adds 0, or |0| to a max, which changes nothing)
          float xv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            xv[q] = (j + q < dn) ? Elem<T>::load(x + j0 + j + q) : 0.0f;
#pragma unroll
          for (int t = 0; t < kTileK; ++t) {
            const float4 c = *reinterpret_cast<const float4*>(&tile[t * kTileD + j]);
            float a = acc[t];
            a = accumulate<M>(a, xv[0], c.x);
            a = accumulate<M>(a, xv[1], c.y);
            a = accumulate<M>(a, xv[2], c.z);
            a = accumulate<M>(a, xv[3], c.w);
            acc[t] = a;
          }
        }
      }
    }
    // fold the tile in increasing k; a strict '<' keeps the first index
#pragma unroll
    for (int t = 0; t < kTileK; ++t) {
      if (k0 + t < K && acc[t] < best) {
        best = acc[t];
        best_k = k0 + t;
      }
    }
  }
  if (valid) {
    idx_out[n] = best_k;
    dist_out[n] = best;
  }
}

template <typename T>
int launch(const void* X, const void* C, int* idx, float* dist, long long N,
           int K, int d, int metric, cudaStream_t st) {
  using St = typename Elem<T>::Storage;
  const dim3 grid((unsigned)((N + kBlock - 1) / kBlock));
  const St* x = static_cast<const St*>(X);
  const St* c = static_cast<const St*>(C);
  switch (metric) {
    case kL2: pdist_argmin_kernel<T, kL2><<<grid, kBlock, 0, st>>>(x, c, idx, dist, N, K, d); break;
    case kL1: pdist_argmin_kernel<T, kL1><<<grid, kBlock, 0, st>>>(x, c, idx, dist, N, K, d); break;
    case kLinf: pdist_argmin_kernel<T, kLinf><<<grid, kBlock, 0, st>>>(x, c, idx, dist, N, K, d); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// X (N, d), C (K, d): contiguous, both f32 (is_bf16 = 0) or both bf16
// (is_bf16 = 1); idx (N,) int32 and dist (N,) f32 out.  metric: 0 l2
// (squared), 1 l1, 2 linf.  N, K, d >= 1; the wrapper checks the rest.
int repro_pdist_argmin(const void* X, const void* C, void* idx, void* dist,
                       long long N, int K, int d, int metric, int is_bf16,
                       void* stream) {
  if (N < 1 || K < 1 || d < 1 || (N + kBlock - 1) / kBlock > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* i = static_cast<int*>(idx);
  float* o = static_cast<float*>(dist);
  return is_bf16 ? launch<Bf16>(X, C, i, o, N, K, d, metric, st)
                 : launch<float>(X, C, i, o, N, K, d, metric, st);
}

}  // extern "C"
