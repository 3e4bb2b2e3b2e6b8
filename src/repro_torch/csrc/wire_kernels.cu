// Wire-encode kernels for Hopper (sm_90a): fused top-k encode/select,
// per-row absmax, the int8 quantize->dequantize pass and the whole int8
// wire encode of a leaf.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   topk_encode_kernel<true>   <- src/repro/kernels/topk_compress/kernel.py _encode_kernel
//   topk_encode_kernel<false>  <- src/repro/kernels/topk_compress/kernel.py _select_kernel
//   absmax_kernel              <- src/repro/kernels/int8_quant/kernel.py    _absmax_kernel
//   quant_dequant_kernel       <- src/repro/kernels/int8_quant/kernel.py    _quant_kernel
//   int8_encode_kernel         <- src/repro/kernels/int8_quant/kernel.py    _quant_kernel
//                                 (with _absmax_kernel, the scale, the EF
//                                 add and the residual around it)
//
// The int8 wire encode (repro_int8_encode) of rows m (and EF residuals r):
// c = m + r, s = max(max |c|, 1e-12) * (1/127) per row, out =
// clip(rint(c / s), +-127) * s, res = c - out.  The Pallas design takes two
// streaming passes because a grid carries the running max across steps in
// VMEM.  On Hopper it takes two routes by row length n:
//   * route A, n <= kOneLaunchMax = 16,384: ONE launch, one block a row.
//     Each thread holds 1, 2 or up to kVecMax = 4 float4s of c in
//     registers (at most 1,024 threads: 16 of the 64 registers a thread
//     has at that size), so m and r are read once, the max meets in the warp
//     (__reduce_max_sync) and shared memory, every warp turns it into the
//     scale, and out and res are written from the same registers: 16
//     bytes an element with EF, 8 without.  No atomic, no fill.
//   * route B, longer rows: absmax_kernel<true> on c = m + r with its
//     grid and atomics into a per-row word of max bits that the entry
//     point zeroes on the stream, then quant_dequant_kernel<true, ef>,
//     whose prologue turns the bits into the scale (written by each row's
//     first block) and which writes out and res: 24 bytes an element with
//     EF, 12 without.
//
// Layout.  Every kernel takes a (rows, n) row-major f32 matrix: one row per
// node of one parameter leaf (rows = 1 for an unstacked leaf), so a whole
// round of K node messages is one launch per leaf, whatever K is.  grid.y
// walks the rows: gridDim.y = min(rows, 65,535), each block a grid-stride
// loop over the rows blockIdx.y, blockIdx.y + gridDim.y, ... (rows are
// independent, so the result does not depend on the split; route A of the
// int8 encode puts its rows on grid.x, which has no such cap).  grid.x
// blocks stride over the row's elements: one float4 a thread across
// the row for quant (grid_for); encode, select and absmax take a grid of a
// few blocks an SM shared among the rows (spread_grid), each block a
// grid-stride loop with several 16-byte loads in flight a thread.  Each
// row is split into a scalar head up to the first 16-byte boundary, a
// float4 body and a scalar tail, so rows of any length and offset take
// 16-byte loads where they can.
//
// Bound.  All are elementwise or reductions with a handful of
// operations per element, far below the card's ~20 flops/byte balance
// point in f32: they are bound by device-memory bytes.  Per element the
// encode moves 12 bytes (read c, write o and res), the select 8, absmax 4,
// quant-dequant 8 and the int8 encode 16 with EF (read m and r, write out
// and res) or 8 without, at 3.35 TB/s on an H100 SXM.  The design streams
// each byte once: no shared-memory staging, reductions in registers,
// the warp (__reduce_*_sync) and the block, then one atomic per block and
// row.  On grid_for's grid a 2^24 row ends in 131,072 warps, and one
// atomic each on one word serializes at L2: about 95,000 at k = 1 %, at
// 1.0-1.6 ns each on the H100 the whole time of the first encode and
// select, the bytes streaming underneath.  spread_grid puts 4 blocks an
// SM there, 528 atomics on an H100.
//
// Numerics (bitwise with the plain PyTorch versions and the jitted JAX
// reference):
//   * dropped top-k entries are written as +0.0 (keep ? c : 0.0f), as XLA
//     writes them under jit; res = c - o;
//   * the survivor count is an integer sum: exact, order-free; a row of
//     one block writes it, a row of several adds to a count that the entry
//     point zeroes on the stream first, so no count carries over a call;
//   * absmax reduces the bit patterns of |x| as unsigned integers, which
//     order exactly like the non-negative floats they encode, so the max
//     is exact and independent of reduction order;
//   * quant-dequant uses a correctly rounded divide (__fdiv_rn), rintf
//     (round half to even, like jnp.round / torch.round) and a separate
//     multiply (__fmul_rn), so no flag or contraction changes a bit; a NaN
//     quotient (c = +-inf in a row whose scale is inf, or a NaN scale)
//     goes through int8 as 0, as the plain version's clamp, which passes
//     NaN on, and its cast to int8 give it;
//   * the encode's scale is max(m, 1e-12f) * (1.0f/127.0f) with a NaN
//     max kept NaN (fmaxf would give 1e-12 where clamp_min gives NaN), its
//     add and subtract __fadd_rn / __fsub_rn.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream, never synchronises, allocates nothing, and returns
// cudaGetLastError() so a refused launch is reported by the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
// the most blocks a launch may have on grid.y
constexpr long long kMaxGridY = 65535;

struct RowSplit {
  long long head;   // scalar elements before the first 16-byte boundary
  long long body4;  // float4 vectors after the head
  long long tail0;  // first element of the scalar tail
};

__device__ __forceinline__ RowSplit split_row(const float* row, long long n) {
  long long head =
      (long long)(((16u - ((unsigned)(uintptr_t)row & 15u)) & 15u) >> 2);
  if (head > n) head = n;
  RowSplit s;
  s.head = head;
  s.body4 = (n - head) >> 2;
  s.tail0 = head + (s.body4 << 2);
  return s;
}

template <bool kResidual>
__device__ __forceinline__ int encode_one(float v, float thr, float* o,
                                          float* res, long long i) {
  const bool keep = fabsf(v) >= thr;
  const float ov = keep ? v : 0.0f;
  o[i] = ov;
  if (kResidual) res[i] = v - ov;
  return keep ? 1 : 0;
}

// encode_one on the float4 at j: one 16-byte store to o (and res)
template <bool kResidual>
__device__ __forceinline__ int encode4(float4 v, float thr, float4* o4,
                                       float4* r4, long long j) {
  const bool k0 = fabsf(v.x) >= thr, k1 = fabsf(v.y) >= thr;
  const bool k2 = fabsf(v.z) >= thr, k3 = fabsf(v.w) >= thr;
  float4 ov;
  ov.x = k0 ? v.x : 0.0f;
  ov.y = k1 ? v.y : 0.0f;
  ov.z = k2 ? v.z : 0.0f;
  ov.w = k3 ? v.w : 0.0f;
  o4[j] = ov;
  if (kResidual) {
    float4 rv;
    rv.x = v.x - ov.x;
    rv.y = v.y - ov.y;
    rv.z = v.z - ov.z;
    rv.w = v.w - ov.w;
    r4[j] = rv;
  }
  return (int)k0 + (int)k1 + (int)k2 + (int)k3;
}

// 16-byte loads in flight a thread in encode and select
constexpr int kEncodeLoads = 4;
// encode's and select's blocks an SM, shared among the rows
constexpr int kEncodeBlocksPerSm = 4;

// On spread_grid's grid: each block a grid-stride loop over its row's
// float4 body, kEncodeLoads loads in flight a thread, 16-byte stores; the
// count in a register, summed by the warp (__reduce_add_sync), the block
// (shared memory), then written by the row's only block or added by one
// atomicAdd a block and row.  On the H100, 2 to 8 loads in flight, 2 to 16
// blocks an SM and streaming stores (__stcs) all ran within a few percent
// of each other, at 2^24 and at 2.5e8 elements a row.
template <bool kResidual>
__global__ void __launch_bounds__(kThreads)
    topk_encode_kernel(const float* __restrict__ c, const float* __restrict__ t,
                       float* __restrict__ o, float* __restrict__ res,
                       int* __restrict__ count, long long rows, long long n) {
  __shared__ int warp_kept[kThreads / 32];
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const float thr = t[row];
    const float* cr = c + row * n;
    float* orow = o + row * n;
    float* rrow = kResidual ? res + row * n : nullptr;
    const RowSplit s = split_row(cr, n);

    int kept = 0;
    for (long long i = tid; i < s.head; i += stride)
      kept += encode_one<kResidual>(cr[i], thr, orow, rrow, i);
    for (long long i = s.tail0 + tid; i < n; i += stride)
      kept += encode_one<kResidual>(cr[i], thr, orow, rrow, i);

    // the body: c, o and res rows share their offset mod 16 (the wrapper
    // checks that every base pointer is 16-byte aligned)
    const float4* c4 = reinterpret_cast<const float4*>(cr + s.head);
    float4* o4 = reinterpret_cast<float4*>(orow + s.head);
    float4* r4 = kResidual ? reinterpret_cast<float4*>(rrow + s.head) : nullptr;
    const long long per_block = (long long)kThreads * kEncodeLoads;
    for (long long base = (long long)blockIdx.x * per_block + threadIdx.x;
         base < s.body4; base += (long long)gridDim.x * per_block) {
      float4 v[kEncodeLoads];
#pragma unroll
      for (int u = 0; u < kEncodeLoads; ++u) {
        const long long j = base + u * kThreads;
        v[u] = j < s.body4 ? c4[j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < kEncodeLoads; ++u) {
        const long long j = base + u * kThreads;
        if (j < s.body4) kept += encode4<kResidual>(v[u], thr, o4, r4, j);
      }
    }

    kept = __reduce_add_sync(kFull, kept);
    if ((threadIdx.x & 31) == 0) warp_kept[threadIdx.x >> 5] = kept;
    __syncthreads();
    if (threadIdx.x < 32) {
      kept = threadIdx.x < kThreads / 32 ? warp_kept[threadIdx.x] : 0;
      kept = __reduce_add_sync(kFull, kept);
      if (threadIdx.x == 0) {
        if (gridDim.x == 1)
          count[row] = kept;
        else if (kept != 0)
          atomicAdd(count + row, kept);
      }
    }
    __syncthreads();  // warp_kept is read before the next row writes it
  }
}

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

__device__ __forceinline__ unsigned max4(float4 v) {
  return max(max(abs_bits(v.x), abs_bits(v.y)), max(abs_bits(v.z), abs_bits(v.w)));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y), __fsub_rn(a.z, b.z),
                     __fsub_rn(a.w, b.w));
}

// The int8 scale of a row from the bits of its max |c|: clamp_min(m,
// 1e-12) * (1/127) as the plain version computes it, a NaN max kept NaN.
__device__ __forceinline__ float scale_of(unsigned bits) {
  const float m = __uint_as_float(bits);
  return __fmul_rn(isnan(m) ? m : fmaxf(m, 1e-12f), 1.0f / 127.0f);
}

// 16-byte loads in flight a thread in absmax
constexpr int kAbsmaxLoads = 4;
// absmax's blocks an SM, shared among the rows
constexpr int kAbsmaxBlocksPerSm = 4;

// Its own grid (spread_grid): a few blocks an SM, split among the rows,
// each a grid-stride loop over its row's float4 body with kAbsmaxLoads
// loads in flight a thread; the max goes through the warp
// (__reduce_max_sync), then the block (shared memory), then one atomicMax
// per block and row.  On the H100, 2 to 16 loads in flight and 4 to 16
// blocks an SM all ran within a few percent of each other.  kSum: the max
// of |x + r| (the int8 encode's route B), the sum rounded as __fadd_rn.
template <bool kSum>
__global__ void __launch_bounds__(kThreads)
    absmax_kernel(const float* __restrict__ x, const float* __restrict__ r,
                  unsigned* __restrict__ out, long long rows, long long n) {
  __shared__ unsigned warp_max[kThreads / 32];
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const float* xr = x + row * n;
    const float* rr = kSum ? r + row * n : nullptr;
    const RowSplit s = split_row(xr, n);

    unsigned m = 0u;
    for (long long i = tid; i < s.head; i += stride)
      m = max(m, abs_bits(kSum ? __fadd_rn(xr[i], rr[i]) : xr[i]));
    for (long long i = s.tail0 + tid; i < n; i += stride)
      m = max(m, abs_bits(kSum ? __fadd_rn(xr[i], rr[i]) : xr[i]));
    const float4* x4 = reinterpret_cast<const float4*>(xr + s.head);
    const float4* r4 = kSum ? reinterpret_cast<const float4*>(rr + s.head) : nullptr;
    const long long per_block = (long long)kThreads * kAbsmaxLoads;
    for (long long base = (long long)blockIdx.x * per_block + threadIdx.x;
         base < s.body4; base += (long long)gridDim.x * per_block) {
      float4 v[kAbsmaxLoads];
#pragma unroll
      for (int u = 0; u < kAbsmaxLoads; ++u) {
        const long long j = base + u * kThreads;
        v[u] = j < s.body4 ? x4[j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (kSum && j < s.body4) v[u] = add4(v[u], r4[j]);
      }
#pragma unroll
      for (int u = 0; u < kAbsmaxLoads; ++u)
        m = max(m, max4(v[u]));
    }
    m = __reduce_max_sync(kFull, m);
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x < 32) {
      m = threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : 0u;
      m = __reduce_max_sync(kFull, m);
      if (threadIdx.x == 0 && m != 0u) atomicMax(out + row, m);
    }
    __syncthreads();  // warp_max is read before the next row writes it
  }
}

__device__ __forceinline__ float quant_one(float v, float s) {
  const float q = rintf(__fdiv_rn(v, s));
  const float c = isnan(q) ? 0.0f : fminf(fmaxf(q, -127.0f), 127.0f);
  return __fmul_rn((float)(int8_t)c, s);
}

__device__ __forceinline__ float4 quant4(float4 v, float s) {
  return make_float4(quant_one(v.x, s), quant_one(v.y, s), quant_one(v.z, s),
                     quant_one(v.w, s));
}

// element i of a row: out (and res) of c = x (+ r)
template <bool kResidual>
__device__ __forceinline__ void quant_at(const float* x, const float* r, float* o,
                                         float* res, long long i, float s) {
  const float c = kResidual ? __fadd_rn(x[i], r[i]) : x[i];
  const float v = quant_one(c, s);
  o[i] = v;
  if (kResidual) res[i] = __fsub_rn(c, v);
}

// One float4 a thread on grid_for's grid.  kFromBits: the row's scale
// from the max bits of absmax_kernel<kResidual> (route B of the encode),
// written to scale by the row's first block; otherwise read from scale.
// kResidual: x + r is quantized and res = (x + r) - out written.
template <bool kFromBits, bool kResidual>
__global__ void __launch_bounds__(kThreads)
    quant_dequant_kernel(const float* __restrict__ x, const float* __restrict__ r,
                         const unsigned* __restrict__ bits,
                         float* __restrict__ scale, float* __restrict__ out,
                         float* __restrict__ res, long long rows, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const float s = kFromBits ? scale_of(bits[row]) : scale[row];
    if (kFromBits && blockIdx.x == 0 && threadIdx.x == 0) scale[row] = s;
    const float* xr = x + row * n;
    const float* rr = kResidual ? r + row * n : nullptr;
    float* orow = out + row * n;
    float* resrow = kResidual ? res + row * n : nullptr;
    const RowSplit sp = split_row(xr, n);

    for (long long i = tid; i < sp.head; i += stride)
      quant_at<kResidual>(xr, rr, orow, resrow, i, s);
    for (long long i = sp.tail0 + tid; i < n; i += stride)
      quant_at<kResidual>(xr, rr, orow, resrow, i, s);
    const float4* x4 = reinterpret_cast<const float4*>(xr + sp.head);
    const float4* r4 = kResidual ? reinterpret_cast<const float4*>(rr + sp.head) : nullptr;
    float4* o4 = reinterpret_cast<float4*>(orow + sp.head);
    float4* res4 = kResidual ? reinterpret_cast<float4*>(resrow + sp.head) : nullptr;
    for (long long i = tid; i < sp.body4; i += stride) {
      const float4 c = kResidual ? add4(x4[i], r4[i]) : x4[i];
      const float4 o = quant4(c, s);
      o4[i] = o;
      if (kResidual) res4[i] = sub4(c, o);
    }
  }
}

// The largest row the encode takes in one launch (route A): 1,024
// threads of kVecMax float4s.
constexpr int kEncodeThreadsMax = 1024;
constexpr int kVecMax = 4;
constexpr long long kOneLaunchMax = (long long)kEncodeThreadsMax * kVecMax * 4;

// Route A: one block a row (blockIdx.x), blockDim.x a multiple of 32 with
// blockDim.x * kVec >= the row's float4s.  Thread t holds the float4s t +
// u * blockDim.x of the body and, for t < 6, one scalar of the head or the
// tail (at most 3 each), all as c = m + r in registers.
template <int kVec, bool kResidual>
__global__ void __launch_bounds__(kEncodeThreadsMax)
    int8_encode_kernel(const float* __restrict__ m, const float* __restrict__ r,
                       float* __restrict__ out, float* __restrict__ res,
                       float* __restrict__ scale, long long n) {
  __shared__ unsigned warp_max[kEncodeThreadsMax / 32];
  const long long row = blockIdx.x;
  const float* mr = m + row * n;
  const float* rr = kResidual ? r + row * n : nullptr;
  float* orow = out + row * n;
  float* resrow = kResidual ? res + row * n : nullptr;
  const RowSplit sp = split_row(mr, n);
  const int t = threadIdx.x;

  const float4* m4 = reinterpret_cast<const float4*>(mr + sp.head);
  const float4* r4 = kResidual ? reinterpret_cast<const float4*>(rr + sp.head) : nullptr;
  float4 c[kVec];
  unsigned mx = 0u;
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    const long long j = t + (long long)u * blockDim.x;
    c[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (j < sp.body4) c[u] = kResidual ? add4(m4[j], r4[j]) : m4[j];
  }
  long long is = -1;  // this thread's scalar of the head or the tail
  if (t < sp.head)
    is = t;
  else if (t - sp.head < n - sp.tail0)
    is = sp.tail0 + (t - sp.head);
  float cs = 0.0f;
  if (is >= 0) cs = kResidual ? __fadd_rn(mr[is], rr[is]) : mr[is];
#pragma unroll
  for (int u = 0; u < kVec; ++u) mx = max(mx, max4(c[u]));
  mx = max(mx, abs_bits(cs));

  // the row's max: each warp's in shared memory, then every warp reduces
  // them all, so no second barrier is needed to hand it out
  mx = __reduce_max_sync(kFull, mx);
  if ((t & 31) == 0) warp_max[t >> 5] = mx;
  __syncthreads();
  const int lane = t & 31;
  mx = lane < (int)(blockDim.x >> 5) ? warp_max[lane] : 0u;
  mx = __reduce_max_sync(kFull, mx);
  const float s = scale_of(mx);
  if (t == 0) scale[row] = s;

  float4* o4 = reinterpret_cast<float4*>(orow + sp.head);
  float4* res4 = kResidual ? reinterpret_cast<float4*>(resrow + sp.head) : nullptr;
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    const long long j = t + (long long)u * blockDim.x;
    if (j < sp.body4) {
      const float4 o = quant4(c[u], s);
      o4[j] = o;
      if (kResidual) res4[j] = sub4(c[u], o);
    }
  }
  if (is >= 0) {
    const float o = quant_one(cs, s);
    orow[is] = o;
    if (kResidual) resrow[is] = __fsub_rn(cs, o);
  }
}

template <int kVec>
void launch_encode(const float* m, const float* r, float* out, float* res, float* scale,
                   long long rows, long long n, unsigned threads, cudaStream_t st) {
  if (r != nullptr)
    int8_encode_kernel<kVec, true><<<(unsigned)rows, threads, 0, st>>>(m, r, out, res, scale, n);
  else
    int8_encode_kernel<kVec, false><<<(unsigned)rows, threads, 0, st>>>(m, nullptr, out, nullptr,
                                                                     scale, n);
}

// grid.y of a launch over `rows` rows: one block row a row up to
// kMaxGridY, past it each block row loops over several
unsigned grid_rows(long long rows) {
  return (unsigned)(rows < kMaxGridY ? rows : kMaxGridY);
}

// One float4 per thread across the row, at least one block per row.
dim3 grid_for(long long rows, long long n) {
  long long per_block = (long long)kThreads * 4;
  long long bx = (n + per_block - 1) / per_block;
  if (bx < 1) bx = 1;
  return dim3((unsigned)bx, grid_rows(rows), 1);
}

// A grid of blocks_per_sm blocks an SM split among the rows (at least one
// a row), fewer where a row needs fewer: a block covers kThreads × loads
// float4s a trip.  absmax's grid and encode's.
dim3 spread_grid(long long rows, long long n, int loads, int blocks_per_sm) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long per_block = (long long)kThreads * loads * 4;
  long long bx = (n + per_block - 1) / per_block;
  long long cap = (long long)blocks_per_sm * sms / rows;
  if (cap < 1) cap = 1;
  if (bx > cap) bx = cap;
  if (bx < 1) bx = 1;
  return dim3((unsigned)bx, grid_rows(rows), 1);
}

}  // namespace

extern "C" {

// res == nullptr selects the residual-free kernel (_select_kernel).
// count (rows int32s) needs no zeroing: a row of one block writes its own;
// where rows take several blocks, count is zeroed on the stream first.
int repro_topk_encode(const float* c, const float* t, float* o, float* res,
                      int* count, long long rows, long long n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = spread_grid(rows, n, kEncodeLoads, kEncodeBlocksPerSm);
  if (grid.x > 1) {
    const cudaError_t e = cudaMemsetAsync(count, 0, rows * sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
  }
  if (res != nullptr)
    topk_encode_kernel<true><<<grid, kThreads, 0, st>>>(c, t, o, res, count, rows, n);
  else
    topk_encode_kernel<false><<<grid, kThreads, 0, st>>>(c, t, o, nullptr, count, rows, n);
  return (int)cudaGetLastError();
}

// out must hold `rows` zeroed f32s (bit pattern 0 = +0.0).
int repro_absmax(const float* x, float* out, long long rows, long long n,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  absmax_kernel<false><<<spread_grid(rows, n, kAbsmaxLoads, kAbsmaxBlocksPerSm),
                         kThreads, 0, st>>>(
      x, nullptr, reinterpret_cast<unsigned*>(out), rows, n);
  return (int)cudaGetLastError();
}

int repro_quant_dequant(const float* x, const float* scale, float* out,
                        long long rows, long long n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  quant_dequant_kernel<false, false><<<grid_for(rows, n), kThreads, 0, st>>>(
      x, nullptr, nullptr, const_cast<float*>(scale), out, nullptr, rows, n);
  return (int)cudaGetLastError();
}

// The longest row repro_int8_encode takes in one launch.
long long repro_int8_encode_one_launch_max(void) { return kOneLaunchMax; }

// The int8 wire encode of rows m (rows, n), with EF residuals r (or
// r == nullptr, and then res too): out, res and scale (rows f32s).  Rows of
// at most kOneLaunchMax elements take one launch (route A; bits is unused
// and may be null); longer rows take absmax then quant-dequant (route B),
// through bits, `rows` unsigned words that are zeroed on the stream here.
int repro_int8_encode(const float* m, const float* r, float* out, float* res,
                      float* scale, unsigned* bits, long long rows, long long n,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= kOneLaunchMax) {
    // the fewest float4s a thread (1, 2 or 4) that cover the row's body
    // (at most n / 4) with 1,024 threads: more threads, fewer serial
    // divides each, and a small row runs at the launch floor
    const long long body4 = n >> 2;
    int vec = 1;
    while (vec < kVecMax && body4 > (long long)kEncodeThreadsMax * vec) vec *= 2;
    long long threads = (body4 + vec - 1) / vec;
    threads = threads < 32 ? 32 : (threads + 31) / 32 * 32;
    const unsigned th = (unsigned)threads;
    if (vec == 1)
      launch_encode<1>(m, r, out, res, scale, rows, n, th, st);
    else if (vec == 2)
      launch_encode<2>(m, r, out, res, scale, rows, n, th, st);
    else
      launch_encode<4>(m, r, out, res, scale, rows, n, th, st);
    return (int)cudaGetLastError();
  }
  const cudaError_t e = cudaMemsetAsync(bits, 0, rows * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid = spread_grid(rows, n, kAbsmaxLoads, kAbsmaxBlocksPerSm);
  if (r != nullptr) {
    absmax_kernel<true><<<grid, kThreads, 0, st>>>(m, r, bits, rows, n);
    quant_dequant_kernel<true, true><<<grid_for(rows, n), kThreads, 0, st>>>(
        m, r, bits, scale, out, res, rows, n);
  } else {
    absmax_kernel<false><<<grid, kThreads, 0, st>>>(m, nullptr, bits, rows, n);
    quant_dequant_kernel<true, false><<<grid_for(rows, n), kThreads, 0, st>>>(
        m, nullptr, bits, scale, out, nullptr, rows, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
