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
// block and carries the counts across a sequential grid.  Here the
// resident blocks run a grid-stride loop, and the count ranks instead of
// comparing each element with every threshold.  Each block first sorts
// the 128 thresholds (a stable rank sort: thread j counts the thresholds
// that precede t_j under an integer key that orders like the floats, ties
// -0.0 with +0.0 and puts NaN after +inf) into shared memory, padded one
// word every 32 (s_j at word j + j / 32).  An element's rank r = #{j :
// |x| >= s_j} is 7 branch-free halving steps and one last compare: the
// first two from registers (s_31, s_63, s_95), the other six each a load
// at a constant offset from a pointer into the padded list, a compare and
// a predicated add to the pointer; the padding puts a warp's loads of one
// step in distinct banks.  A NaN element fails every compare and ranks 0.
// Its bin (its padded position, r = bin - bin / 33) gains one by a
// shared-memory atomic at a constant offset from the same pointer, in the
// block's histogram; rank 0, never needed, lands on a spare word, so no
// branch is taken.  About 25 instructions an element.  At the block's end
// the bins are summed by rank, suffix sums give counts[perm[j]] =
// #{elements of rank > j}, and each goes out as one 64-bit atomic per
// block and threshold: integer sums, so the result is exact and
// independent of order.  Each thread keeps four 16-byte loads in flight
// (a vector past the end reads as NaN); where x does not start on 16
// bytes the head before the first boundary and the tail are counted one
// element at a time.  Slower on the H100: a breadth-first search tree (6
// instructions a level: the address 2e + p is rebuilt each time), and
// with it all ranks of a load group before their atomics or a third level
// in registers; an index in place of the pointer with a branch around the
// atomic; two or eight histograms a block.  The mask is a streaming
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
// mask reads and writes it once.  The count's work an element is 8
// compares and about 25 instructions, 6 of them shared-memory loads and
// one a shared-memory atomic: at the rate an H100 starts instructions
// that takes about as long as the f32 bytes, and longer than the bf16
// bytes, so the count is near its byte bound in f32, where 128 compares an
// element took 1.6x the byte time, and bound by instructions in bf16.
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
constexpr unsigned kFull = 0xffffffffu;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of elements of type T
template <typename T> struct Vec {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

// the count's 16-byte loads in flight a thread
constexpr int kCountLoads = 4;
// words of the padded sorted thresholds: s_j at word j + j / 32
constexpr int kPadded = kNCand + kNCand / 32;

// An integer that orders thresholds like the floats they are, with -0.0
// and +0.0 equal and every NaN after +inf.
__device__ __forceinline__ int order_key(float t) {
  if (t != t) return 0x7fffffff;
  if (t == 0.0f) return 0;
  const int b = __float_as_int(t);
  return b >= 0 ? b : b ^ 0x7fffffff;  // negatives: larger magnitude, smaller key
}

struct CountSmem {
  float t[kNCand];   // the thresholds as given
  int perm[kNCand];  // perm[j]: the given index of s_j
  unsigned warp_sum[kNCand / 32];
  // words [0, kPadded): s_j's bits at j + j / 32 (word 131 is unused);
  // then the block's histogram, bin b >= 1 at kPadded + b - 1
  unsigned sh[2 * kPadded];
};

// Counts one magnitude a.  Its bin is base + (a >= s_base), the base that
// 7 halving steps find (a >= s_j for every j < base, for none > base),
// padded as the thresholds are; bin b holds the rank r = #{j : a >= s_j}
// = b - b / 33 (bin 0, rank 0).  s_31, s_63 and s_95 (the first two
// steps) come from registers; the other six steps are each a load at a
// constant offset from the pointer p = s + bin, a compare and an add to
// p.  The bin's count is kPadded - 1 words past p, so rank 0, which is
// never needed, lands on the unused word 131 of s: no branch, and a
// warp's increments of one word are one shared-memory operation.
__device__ __forceinline__ void count_one(float a, const unsigned* s, float s31, float s63,
                                          float s95) {
  const bool upper = a >= s63;
  const unsigned* p = s + (upper ? 66 : 0);  // 64 + 64 / 32
  if (a >= (upper ? s95 : s31)) p += 33;
#pragma unroll
  for (int half = 16; half > 0; half >>= 1)
    if (a >= __uint_as_float(p[half - 1])) p += half;  // no step below 32 crosses a pad
  if (a >= __uint_as_float(*p)) ++p;
  atomicAdd(const_cast<unsigned*>(p) + kPadded - 1, 1u);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
count_ge_kernel(const T* __restrict__ x, long long n, const float* __restrict__ t,
                unsigned long long* __restrict__ counts) {
  using V = Vec<T>;
  __shared__ CountSmem sm;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // sort the thresholds: s_{rank_j} = t_j, a stable rank sort
  if (tid < kNCand) sm.t[tid] = t[tid];
  for (int i = tid; i < kPadded; i += kThreads) sm.sh[kPadded + i] = 0u;
  __syncthreads();
  if (tid < kNCand) {
    const int kj = order_key(sm.t[tid]);
    int rank = 0;
    for (int i = 0; i < kNCand; ++i) {
      const int ki = order_key(sm.t[i]);
      rank += (ki < kj) | ((ki == kj) & (i < tid));
    }
    sm.sh[rank + (rank >> 5)] = __float_as_uint(sm.t[tid]);
    sm.perm[rank] = tid;
  }
  __syncthreads();
  const unsigned* s = sm.sh;
  const float s31 = __uint_as_float(s[31]), s63 = __uint_as_float(s[63 + 1]),
              s95 = __uint_as_float(s[95 + 2]);

  // the head before the first 16-byte boundary and the tail, one element a thread
  long long head = (long long)(((16u - ((unsigned)(uintptr_t)x & 15u)) & 15u) / sizeof(T));
  if (head > n) head = n;
  const long long nvec = (n - head) / V::kN;
  const long long tail0 = head + nvec * V::kN;
  const long long gtid = (long long)blockIdx.x * kThreads + tid;
  const long long gstride = (long long)gridDim.x * kThreads;
  for (long long i = gtid; i < head; i += gstride)
    count_one(fabsf(to_f32<T>(x[i])), s, s31, s63, s95);
  for (long long i = tail0 + gtid; i < n; i += gstride)
    count_one(fabsf(to_f32<T>(x[i])), s, s31, s63, s95);

  // the body: kCountLoads vectors a thread in flight, kThreads apart; a
  // vector past the end reads as NaN (all bits set), which ranks 0
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  const long long per_block = (long long)kThreads * kCountLoads;
  for (long long base = (long long)blockIdx.x * per_block + tid; base < nvec;
       base += (long long)gridDim.x * per_block) {
    uint4 raw[kCountLoads];
#pragma unroll
    for (int u = 0; u < kCountLoads; ++u) {
      const long long j = base + u * kThreads;
      raw[u] = j < nvec ? xv[j] : make_uint4(~0u, ~0u, ~0u, ~0u);
    }
#pragma unroll
    for (int u = 0; u < kCountLoads; ++u) {
      const V& e = *reinterpret_cast<const V*>(&raw[u]);
#pragma unroll
      for (int q = 0; q < V::kN; ++q)
        count_one(fabsf(to_f32<T>(e.v[q])), s, s31, s63, s95);
    }
  }
  __syncthreads();

  // thread j: the elements of rank r = j + 1 (bin r + r / 32, and for r
  // a multiple of 32 also the bin before it); then the counts of s_j, the
  // suffix sums over ranks j + 1..128, by a shuffle scan in each of four
  // warps
  unsigned v = 0u;
  if (tid < kNCand) {
    const int r = tid + 1, b = r + (r >> 5);
    const unsigned* hist = sm.sh + kPadded - 1;  // hist[b] is bin b
    if (r < kNCand) v += hist[b];
    if ((r & 31) == 0) v += hist[b - 1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned o = __shfl_down_sync(kFull, v, off);
      if (lane + off < 32) v += o;
    }
    if (lane == 0) sm.warp_sum[warp] = v;
  }
  __syncthreads();
  if (tid < kNCand) {
    unsigned long long c = v;
    for (int w = warp + 1; w < kNCand / 32; ++w) c += sm.warp_sum[w];
    if (c) atomicAdd(&counts[sm.perm[tid]], c);
  }
}

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

// The count's grid: every block that can be resident at once (so the
// per-block set-up is paid once an SM slot), fewer where x is small, and
// enough that no block sees 2^31 elements (its bins are 32-bit).
template <typename T>
long long count_grid(long long n) {
  static int resident[64];  // by device; 0 until first asked
  int dev = 0;
  cudaGetDevice(&dev);
  int& cap = resident[dev & 63];
  if (cap == 0) {
    int sms = 132, per_sm = 1;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, count_ge_kernel<T>, kThreads, 0);
    cap = sms * (per_sm < 1 ? 1 : per_sm);
  }
  const long long per_block = (long long)kThreads * kCountLoads * Vec<T>::kN;
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > cap) blocks = cap;
  const long long least = (n >> 31) + 1;
  return blocks < least ? least : blocks;
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
  auto* c = static_cast<unsigned long long*>(counts);
  const long long grid = is_bf16 ? count_grid<__nv_bfloat16>(n) : count_grid<float>(n);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    count_ge_kernel<__nv_bfloat16><<<(unsigned)grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), n, t, c);
  else
    count_ge_kernel<float><<<(unsigned)grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), n, t, c);
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
