// Nearest centroid on the CUDA cores for Hopper (sm_90a): for every point,
// the index and the distance of its nearest centroid under l1 or
// l-infinity (the route of both).
//
// Replaces the Pallas TPU kernel of the JAX package, for metrics "l1" and
// "linf":
//   nearest_cc_kernel<T, M, DP>  <- src/repro/kernels/pdist_argmin/kernel.py _pdist_kernel
//   nearest_wide_kernel<T, M> + nearest_wide_merge_kernel<M>  (the same, d > 58,108)
// (reached through ops.pdist_argmin <- the E-step of ml/clustering.py
// kmeans(metric="l1" | "linf"), the only clustering entry point that takes
// those metrics).  l2 goes to pdist_argmin_tc.cu; the route is a fixed
// function of the metric (kernels/pdist_argmin/kernel.py ROUTES).
//
// Function.  For X (N, d) and C (K, d), both f32 or both bf16, on the card:
//   dist[n] = min_k D(x_n, c_k),  idx[n] = the first k attaining it,
//   D = sum_j |x_j - c_j| (l1), max_j |x_j - c_j| (linf),
// computed in f32 (bf16 is widened exactly).  Each centroid's sum runs over
// j in increasing order with one add (or max) a term, and the minimum
// over k in increasing order with a strict '<', so ties take the first
// index as jnp.argmin's do.  Zero columns past d add |0 - 0| = 0 and change
// nothing, so the result is bitwise that of any kernel that sums in that
// order, the first design of this file included.  Past d = 58,108 (rows
// wider than one staged centroid row) the sum runs in increasing j within
// each split of d and the splits are added in increasing order; l-infinity
// is exact in any order.
//
// Design.  Neither l1 nor linf has a matrix-product form, so the kernel
// stays on the CUDA cores, and its bound is instruction issue: a subtract,
// then an add or a max whose |.| is an operand modifier, two f32
// instructions a term.  So the design keeps everything else off the issue
// slots:
//   - a persistent grid of as many blocks as fit on the SMs (the occupancy
//     calculator), each owning one contiguous range of points, so that C is
//     staged into shared memory once a block when it fits beside three
//     blocks an SM (K rows of d rounded up to 4 floats; 5.4 KB at K 32 x d
//     42) and in tiles of as many rows as fit otherwise;
//   - a block's points pass in chunks of 256 (two a thread: t and t + 128):
//     the chunk, contiguous in X, comes in with coalesced 16-byte loads into
//     shared memory, and each thread copies its points into registers, DP
//     columns a point (the least of 16, 32, 48, 64 that holds d); the next
//     chunk's 16-byte loads go into registers before this chunk's work, so
//     their latency hides behind it; the loop over j is unrolled at compile
//     time, one branch a group of four columns;
//   - four centroid rows at a time are read from shared memory as 16-byte
//     broadcasts: one broadcast feeds 8 terms, and eight running sums a
//     thread keep the adds' latency hidden.
// Above d = 64 the points do not fit in registers: the kernel with DP = 0
// takes the columns in chunks of 64, re-reading each point's chunk from
// device memory (the cache) for every centroid; that path serves shapes off
// the clustering path (d <= 64 there).  Past d = 58,108 a row of C no
// longer fits in shared memory, and at such widths N is small (a point is
// 232 KB or more), so a grid over points alone would leave most SMs idle:
// nearest_wide_kernel cuts d into splits as well (the wrapper sizes them
// for eight blocks an SM), carries 16 centroids' partials for its points
// in registers across the split's 64-column chunks of C, and a merge kernel
// folds the splits (scratch of nsplit x K x N floats the wrapper
// allocates).
//
// Bound.  Instruction issue: 2 N K d f32 instructions at 132 SMs x 128
// lanes x 1.98 GHz = 33.45 T instructions/s, or bytes past d = 58,108 where
// N is small: at 4,096 x 100,000 against 16, X's 1.64 GB at 3.35 TB/s
// (0.491 ms) against 0.392 ms of issue.  Issue at kmeans(metric="l1")'s
// 320,000 x 42 against 32 centroids 0.025715 ms, at the KDD Cup 1999 shape
// (4,898,432 x 42 against 1,000) 12.30 ms.  Bytes: N d + K d elements read,
// 8 N bytes written (0.0168 ms at the first shape).
//
// Plain C interface for ctypes: the entry points launch on the given
// stream, never synchronise, allocate nothing, and return
// cudaGetLastError() so a refused launch is reported by the caller.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// The launch shape was chosen on an H100 among 21 variants (64 to 256
// threads, 1 to 4 points a thread, 2 to 8 centroids a step, room for 1 to 8
// blocks an SM, with and without the next pass loaded ahead; PERF.md §6).
constexpr int kThreads = 128;
constexpr int kP = 2;                    // points a thread
constexpr int kNC = 4;                   // centroids a step
constexpr int kMinBlocks = 3;            // C is tiled to leave room for this many blocks
constexpr int kChunk = kThreads * kP;    // points a pass
constexpr int kChunkCols = 64;           // DP = 0: columns a chunk
constexpr int kSmemMax = 232448;         // dynamic shared memory a block may use
constexpr int kSmemPerSm = 233472;       // shared memory of an SM; each block reserves 1 KB
constexpr int kMaxDevices = 64;

enum Metric { kL1 = 1, kLinf = 2 };  // METRICS.index in kernels/pdist_argmin/ref.py

struct Bf16 {};  // tag: elements are bf16 bit patterns (uint16_t)

template <typename T> struct Elem;

template <> struct Elem<float> {
  using Storage = float;
  static constexpr int kVec = 4;  // elements a 16-byte load
  __device__ static __forceinline__ float load(const Storage* p) { return __ldg(p); }
  __device__ static __forceinline__ void unpack(uint4 w, float* out) {
    out[0] = __uint_as_float(w.x);
    out[1] = __uint_as_float(w.y);
    out[2] = __uint_as_float(w.z);
    out[3] = __uint_as_float(w.w);
  }
};

// bf16 -> f32 is exact: the bf16 bits are the high half of the f32.
template <> struct Elem<Bf16> {
  using Storage = uint16_t;
  static constexpr int kVec = 8;
  __device__ static __forceinline__ float load(const Storage* p) {
    return __uint_as_float(((unsigned)__ldg(p)) << 16);
  }
  __device__ static __forceinline__ void unpack(uint4 w, float* out) {
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(u[i] << 16);
      out[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};

template <int M>
__device__ __forceinline__ float accumulate(float acc, float x, float c) {
  const float delta = x - c;
  if (M == kL1) return acc + fabsf(delta);
  return fmaxf(acc, fabsf(delta));
}

// rows [k0, k0 + kn) of C into cs, rows d4 floats apart, zero past d
template <typename T>
__device__ __forceinline__ void stage_c(float* cs, const typename Elem<T>::Storage* C, int k0,
                                        int kn, int d, int d4) {
  for (int i = threadIdx.x; i < kn * d4; i += kThreads) {
    const int r = i / d4, j = i - r * d4;
    cs[i] = j < d ? Elem<T>::load(C + (long long)(k0 + r) * d + j) : 0.0f;
  }
}

// One block a contiguous range of `per` points; see the note above.
// DP > 0: points in registers, DP columns; DP = 0: columns in chunks of 64.
template <typename T, int M, int DP>
__global__ void __launch_bounds__(kThreads)
nearest_cc_kernel(const typename Elem<T>::Storage* __restrict__ X,
                  const typename Elem<T>::Storage* __restrict__ C, int* __restrict__ idx_out,
                  float* __restrict__ dist_out, long long N, int K, int d, long long per,
                  int kc) {
  using E = Elem<T>;
  using St = typename E::Storage;
  constexpr int kCols = DP > 0 ? DP : kChunkCols;
  extern __shared__ __align__(16) float smem[];
  const int d4 = (d + 3) & ~3;
  float* cs = smem;            // kc rows of d4
  float* xs = smem + kc * d4;  // DP > 0: the pass's points, d floats each
  const int nct = (K + kc - 1) / kc;
  const long long lo = (long long)blockIdx.x * per;
  const long long hi = lo + per < N ? lo + per : N;
  if (lo >= hi) return;
  if (nct == 1) {  // C whole, once
    stage_c<T>(cs, C, 0, K, d, d4);
    __syncthreads();
  }

  // DP > 0 on a 16-byte aligned X: a pass's 16-byte vectors, loaded into
  // registers one pass ahead (kVecs a thread at most: kP DP elements)
  constexpr int kVecs = DP > 0 ? (kP * DP + E::kVec - 1) / E::kVec : 1;
  const bool aligned = (reinterpret_cast<uintptr_t>(X) & 15) == 0;
  uint4 pre[kVecs];
  auto fetch = [&](long long b) {
    const long long nv = (long long)(hi - b < kChunk ? hi - b : kChunk) * d / E::kVec;
    const uint4* src = reinterpret_cast<const uint4*>(X + b * d);
#pragma unroll
    for (int t = 0; t < kVecs; ++t) {
      const int i = threadIdx.x + t * kThreads;
      pre[t] = i < nv ? __ldg(src + i) : make_uint4(0, 0, 0, 0);
    }
  };
  if (DP > 0 && aligned) fetch(lo);

  for (long long base = lo; base < hi; base += kChunk) {
    const int cnt = (int)(hi - base < kChunk ? hi - base : kChunk);
    float x[kP][kCols];
    if constexpr (DP > 0) {
      __syncthreads();  // the previous pass is done with xs (and C is staged)
      const St* src = X + base * d;
      const long long total = (long long)cnt * d;
      long long head = 0;
      if (aligned) {
        const long long nv = total / E::kVec;
#pragma unroll
        for (int t = 0; t < kVecs; ++t) {
          const int i = threadIdx.x + t * kThreads;
          if (i < nv) E::unpack(pre[t], xs + (long long)i * E::kVec);
        }
        head = nv * E::kVec;
      }
      for (long long i = head + threadIdx.x; i < total; i += kThreads) xs[i] = E::load(src + i);
      __syncthreads();
      if (aligned && base + kChunk < hi) fetch(base + kChunk);  // in flight meanwhile
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int n = threadIdx.x + p * kThreads;
#pragma unroll
        for (int j = 0; j < DP; ++j) x[p][j] = (n < cnt && j < d) ? xs[n * d + j] : 0.0f;
      }
    }
    float best[kP];
    int best_k[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      best[p] = __int_as_float(0x7f800000);  // +inf
      best_k[p] = 0;
    }

    for (int ct = 0; ct < nct; ++ct) {
      const int k0 = ct * kc;
      const int kn = min(kc, K - k0);
      if (nct > 1) {
        __syncthreads();
        stage_c<T>(cs, C, k0, kn, d, d4);
        __syncthreads();
      }
      // NC centroids from row kk of the tile: the running sums, then the
      // fold in increasing k
      auto centroids = [&](int kk, auto nc) {
        constexpr int NC = decltype(nc)::value;
        float acc[NC][kP];
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int p = 0; p < kP; ++p) acc[c][p] = 0.0f;
        // DP > 0: one chunk, every column is in x
        for (int j0 = 0; j0 < (DP > 0 ? 1 : d); j0 += kCols) {
          if constexpr (DP == 0) {  // this chunk of the thread's points
#pragma unroll
            for (int p = 0; p < kP; ++p) {
              const long long n = base + threadIdx.x + p * kThreads;
              const St* xr = X + (n < hi ? n : lo) * d + j0;
#pragma unroll
              for (int j = 0; j < kCols; ++j) x[p][j] = j0 + j < d ? E::load(xr + j) : 0.0f;
            }
          }
#pragma unroll
          for (int q = 0; q < kCols / 4; ++q) {
            if (j0 + 4 * q < d) {
#pragma unroll
              for (int c = 0; c < NC; ++c) {
                const float4 cv =
                    *reinterpret_cast<const float4*>(cs + (kk + c) * d4 + j0 + 4 * q);
#pragma unroll
                for (int p = 0; p < kP; ++p) {
                  float a = acc[c][p];
                  a = accumulate<M>(a, x[p][4 * q + 0], cv.x);
                  a = accumulate<M>(a, x[p][4 * q + 1], cv.y);
                  a = accumulate<M>(a, x[p][4 * q + 2], cv.z);
                  a = accumulate<M>(a, x[p][4 * q + 3], cv.w);
                  acc[c][p] = a;
                }
              }
            }
          }
        }
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int p = 0; p < kP; ++p)
            if (acc[c][p] < best[p]) {  // strict: the first index keeps a tie
              best[p] = acc[c][p];
              best_k[p] = k0 + kk + c;
            }
      };
      int kk = 0;
      for (; kk + kNC <= kn; kk += kNC) centroids(kk, std::integral_constant<int, kNC>{});
      for (; kk < kn; ++kk) centroids(kk, std::integral_constant<int, 1>{});
    }
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int n = threadIdx.x + p * kThreads;
      if (n < cnt) {
        idx_out[base + n] = best_k[p];
        dist_out[base + n] = best[p];
      }
    }
  }
}

// Rows wider than one staged centroid row (d > kMaxDStaged): the grid is
// (256-point tiles, groups of kWideNC centroids, splits of d).  A block's
// threads own two points each (t, t + 128) and carry their kP x kWideNC
// partials in registers across the split's 64-column chunks; each chunk of
// the group's centroid rows is staged in shared memory and read as 16-byte
// broadcasts, the points' columns come from device memory through the
// cache.  Within a split the terms are added (or maxed) in increasing j;
// part[(split * K + k) * N + n] holds the split's partial, and
// nearest_wide_merge_kernel folds the splits in increasing order (l1: a sum,
// linf: a max, exact in any order) and takes the first least k.
constexpr int kWideNC = 16;                    // centroids a block carries
constexpr int kMaxDStaged = kSmemMax / 4 - 4;  // the widest row stage_c stages (58,108)

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
nearest_wide_kernel(const typename Elem<T>::Storage* __restrict__ X,
                    const typename Elem<T>::Storage* __restrict__ C, float* __restrict__ part,
                    long long N, int K, int d, int jlen) {
  using E = Elem<T>;
  __shared__ __align__(16) float cs[kWideNC][kChunkCols];
  const long long n0 = (long long)blockIdx.x * kChunk;
  const int kg = blockIdx.y * kWideNC;
  const int split = blockIdx.z;
  const long long jb = (long long)split * jlen;
  const int j_beg = (int)jb, j_end = (int)(jb + jlen < d ? jb + jlen : d);
  long long rows[kP];
  bool live[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const long long n = n0 + threadIdx.x + p * kThreads;
    live[p] = n < N;
    rows[p] = (live[p] ? n : n0) * (long long)d;
  }
  float acc[kWideNC][kP];
#pragma unroll
  for (int c = 0; c < kWideNC; ++c)
#pragma unroll
    for (int p = 0; p < kP; ++p) acc[c][p] = 0.0f;

  for (int j0 = j_beg; j0 < j_end; j0 += kChunkCols) {
    const int cols = min(kChunkCols, j_end - j0);
    __syncthreads();  // the last chunk is read
    for (int i = threadIdx.x; i < kWideNC * kChunkCols; i += kThreads) {
      const int r = i / kChunkCols, j = i - r * kChunkCols;
      cs[r][j] = (kg + r < K && j < cols) ? E::load(C + (long long)(kg + r) * d + j0 + j) : 0.0f;
    }
    __syncthreads();
    for (int q = 0; q < kChunkCols / 4; ++q) {
      if (4 * q >= cols) break;
      float x[kP][4];
#pragma unroll
      for (int p = 0; p < kP; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[p][e] = 4 * q + e < cols ? E::load(X + rows[p] + j0 + 4 * q + e) : 0.0f;
#pragma unroll
      for (int c = 0; c < kWideNC; ++c) {
        const float4 cv = *reinterpret_cast<const float4*>(&cs[c][4 * q]);
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          float a = acc[c][p];
          a = accumulate<M>(a, x[p][0], cv.x);
          a = accumulate<M>(a, x[p][1], cv.y);
          a = accumulate<M>(a, x[p][2], cv.z);
          a = accumulate<M>(a, x[p][3], cv.w);
          acc[c][p] = a;
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kWideNC; ++c) {
    if (kg + c >= K) break;
#pragma unroll
    for (int p = 0; p < kP; ++p)
      if (live[p])
        part[((long long)split * K + kg + c) * N + n0 + threadIdx.x + p * kThreads] = acc[c][p];
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads)
nearest_wide_merge_kernel(const float* __restrict__ part, int* __restrict__ idx_out,
                          float* __restrict__ dist_out, long long N, int K, int nsplit) {
  for (long long n = (long long)blockIdx.x * kThreads + threadIdx.x; n < N;
       n += (long long)gridDim.x * kThreads) {
    float best = __int_as_float(0x7f800000);  // +inf
    int best_k = 0;
    for (int k = 0; k < K; ++k) {
      float a = part[(long long)k * N + n];
      for (int sp = 1; sp < nsplit; ++sp) {
        const float b = part[((long long)sp * K + k) * N + n];
        a = M == kL1 ? a + b : fmaxf(a, b);
      }
      if (a < best) {  // strict: the first index keeps a tie
        best = a;
        best_k = k;
      }
    }
    idx_out[n] = best_k;
    dist_out[n] = best;
  }
}

template <typename T, int M>
int launch_wide(const void* X, const void* C, int* idx, float* dist, float* part, long long N,
                int K, int d, int jlen, int nsplit, cudaStream_t st) {
  using St = typename Elem<T>::Storage;
  const long long tiles = (N + kChunk - 1) / kChunk;
  const long long groups = (K + kWideNC - 1) / kWideNC;
  if (tiles > 0x7fffffffLL || groups > 65535 || nsplit > 65535)
    return (int)cudaErrorInvalidConfiguration;
  nearest_wide_kernel<T, M><<<dim3((unsigned)tiles, (unsigned)groups, (unsigned)nsplit),
                              kThreads, 0, st>>>(static_cast<const St*>(X),
                                                 static_cast<const St*>(C), part, N, K, d, jlen);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (N + kThreads - 1) / kThreads;
  nearest_wide_merge_kernel<M><<<(unsigned)(blocks < 65535 ? blocks : 65535), kThreads, 0, st>>>(
      part, idx, dist, N, K, nsplit);
  return (int)cudaGetLastError();
}

int cached_sms() {
  static int sms[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (dev >= kMaxDevices) return 132;
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev] > 0 ? sms[dev] : 132;
}

template <typename T, int M, int DP>
int launch_dp(const void* X, const void* C, int* idx, float* dist, long long N, int K, int d,
              cudaStream_t st) {
  using St = typename Elem<T>::Storage;
  auto kern = nearest_cc_kernel<T, M, DP>;
  // raise the shared-memory limit once a device, so that a launch being
  // captured into a CUDA graph makes no other such call
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices || !raised[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) raised[dev] = true;
  }
  const long long d4 = (d + 3) & ~3;
  const long long xs_bytes = DP > 0 ? (long long)kChunk * d * 4 : 0;
  long long room = ((kSmemPerSm / kMinBlocks - 1024) - xs_bytes) / (d4 * 4);
  if (room < 1) room = (kSmemMax - xs_bytes) / (d4 * 4);
  if (room < 1) return (int)cudaErrorInvalidValue;  // the wrapper refuses such d
  const int kc = (int)(room < K ? room : K);
  const size_t smem = (size_t)(kc * d4 * 4 + xs_bytes);
  // blocks an SM at this shared-memory size, asked once a size and device
  // (so that a launch being captured into a CUDA graph repeats no query)
  static size_t asked[kMaxDevices] = {};
  static int occupancy[kMaxDevices] = {};
  int per_sm = 0;
  if (dev < kMaxDevices && asked[dev] == smem + 1) {
    per_sm = occupancy[dev];
  } else {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) {
      asked[dev] = smem + 1;
      occupancy[dev] = per_sm;
    }
  }
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // every block a contiguous range of points, a multiple of 8 (so that each
  // range starts on 16 bytes of X when X does)
  const long long chunks = (N + kChunk - 1) / kChunk;
  long long blocks = (long long)per_sm * cached_sms();
  if (blocks > chunks) blocks = chunks;
  long long per = (N + blocks - 1) / blocks;
  per = (per + 7) & ~7LL;
  blocks = (N + per - 1) / per;
  kern<<<(unsigned)blocks, kThreads, smem, st>>>(static_cast<const St*>(X),
                                                  static_cast<const St*>(C), idx, dist, N, K, d,
                                                  per, kc);
  return (int)cudaGetLastError();
}

template <typename T, int M>
int launch_metric(const void* X, const void* C, int* idx, float* dist, long long N, int K, int d,
                  cudaStream_t st) {
  if (d <= 16) return launch_dp<T, M, 16>(X, C, idx, dist, N, K, d, st);
  if (d <= 32) return launch_dp<T, M, 32>(X, C, idx, dist, N, K, d, st);
  if (d <= 48) return launch_dp<T, M, 48>(X, C, idx, dist, N, K, d, st);
  if (d <= 64) return launch_dp<T, M, 64>(X, C, idx, dist, N, K, d, st);
  return launch_dp<T, M, 0>(X, C, idx, dist, N, K, d, st);
}

template <typename T>
int launch(const void* X, const void* C, int* idx, float* dist, long long N, int K, int d,
           int metric, cudaStream_t st) {
  switch (metric) {
    case kL1: return launch_metric<T, kL1>(X, C, idx, dist, N, K, d, st);
    case kLinf: return launch_metric<T, kLinf>(X, C, idx, dist, N, K, d, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_w(const void* X, const void* C, int* idx, float* dist, float* part, long long N,
             int K, int d, int jlen, int nsplit, int metric, cudaStream_t st) {
  switch (metric) {
    case kL1: return launch_wide<T, kL1>(X, C, idx, dist, part, N, K, d, jlen, nsplit, st);
    case kLinf: return launch_wide<T, kLinf>(X, C, idx, dist, part, N, K, d, jlen, nsplit, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// X (N, d), C (K, d): contiguous, both f32 (is_bf16 = 0) or both bf16
// (is_bf16 = 1); idx (N,) int32 and dist (N,) f32 out.  metric: 1 l1,
// 2 linf (0, l2, is refused: it runs on pdist_argmin_tc.cu).  N, K >= 1,
// 1 <= d <= 58,108 (one centroid row, d rounded up to 4 floats, within a
// block's shared memory; wider rows take repro_pdist_argmin_wide); the
// wrapper checks the rest.
int repro_pdist_argmin(const void* X, const void* C, void* idx, void* dist, long long N, int K,
                       int d, int metric, int is_bf16, void* stream) {
  if (N < 1 || K < 1 || d < 1 || d > kMaxDStaged) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* i = static_cast<int*>(idx);
  float* o = static_cast<float*>(dist);
  return is_bf16 ? launch<Bf16>(X, C, i, o, N, K, d, metric, st)
                 : launch<float>(X, C, i, o, N, K, d, metric, st);
}

// The same for any d >= 1, in splits of jlen columns (a positive multiple
// of 64; nsplit = ceil(d / jlen) <= 65,535): part (nsplit, K, N) f32 is
// scratch the wrapper allocates.  Two launches, the split kernel and the
// merge.
int repro_pdist_argmin_wide(const void* X, const void* C, void* idx, void* dist, void* part,
                            long long N, int K, int d, int jlen, int nsplit, int metric,
                            int is_bf16, void* stream) {
  if (N < 1 || K < 1 || d < 1 || jlen < 1 || jlen % kChunkCols || nsplit < 1 ||
      (long long)(nsplit - 1) * jlen >= d || (long long)nsplit * jlen < d)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* i = static_cast<int*>(idx);
  float* o = static_cast<float*>(dist);
  float* pt = static_cast<float*>(part);
  return is_bf16 ? launch_w<Bf16>(X, C, i, o, pt, N, K, d, jlen, nsplit, metric, st)
                 : launch_w<float>(X, C, i, o, pt, N, K, d, jlen, nsplit, metric, st);
}

}  // extern "C"
