// Decode attention for Hopper (sm_90a): one query token per row against a
// dense KV cache view, the G query heads of a GQA group together, with the
// keys split over blocks (flash-decoding) and the partials merged on the
// device.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   decode_split_kernel<T, D>  <- src/repro/kernels/decode_attention/kernel.py _decode_kernel
//   decode_merge_kernel<T, D>     (its _finalize, across the splits)
// (reached through ops.decode_attention <- models/attention._decode_attend,
// once per layer of every continuous-batching decode step).
//
// Function.  For q (B, Hkv*G, D), k and v (B, S, Hkv, D) and valid_len (B,)
// int32, all on the card:
//   out[b, h*G+g] = sum_s p_s v[b, s, h] / sum_s p_s,
//   p_s = exp(q[b, h*G+g] . k[b, s, h] * D^-1/2 - m)   over keys s < valid_len[b],
// with m the maximum.  The dot product is taken first and then multiplied
// by D^-1/2, all in f32 (kernel.py:55-57); masked keys contribute exactly
// 0; a row with valid_len 0 gives 0 (the divide is guarded by l > 0,
// kernel.py:76); the output is rounded once, from f32, to q's type.
//
// Design.  The TPU kernel walks the grid (B, Hkv, Sp/bk) in order and
// carries (m, l, acc) across the S steps in VMEM.  Here the grid is (Hkv,
// B, n_split): block (h, b, i) takes the keys [i * chunk, (i + 1) * chunk)
// of row b that lie below valid_len[b] (read on the device), one warp per
// query head of the group (blockDim = 32 G).  The wrapper picks chunk, a
// multiple of the 64-row tile, from S and the card's SM count, so that the
// serving shape (B 16 x Hkv 4) launches at least two blocks an SM where one
// block per (h, b) left half the card idle.  Each step stages a tile of K
// and V rows into shared memory with 16-byte cp.async copies, two stages
// deep, so the next tile is in flight while this one is used; the G heads
// share every K/V byte staged.  Rows are padded by 16 bytes, which makes
// the lanes' 16-byte reads of eight different rows fall in distinct banks.
// Scores: lane j takes keys j and j + 32 of the tile against its warp's
// query, held in f32 registers up to D 64 (at D 128 read from shared
// memory); m and l live in registers in f32, uniform across the warp.
// P.V takes four keys a step (one 16-byte read of p); acc (D floats) is
// spread across the lanes, lane owning the D / 32 columns from lane * D /
// 32, so that it reads them from a staged V row in one load.  A split that
// starts at or past valid_len[b] writes the empty partial (m = -1e30, l =
// 0, acc = 0).  Each split writes (m, l, unnormalised acc) in f32 to
// scratch that the wrapper allocates; decode_merge_kernel then rescales
// each by exp(m_i - max_i m_i), sums, divides by l where l > 0 and rounds
// once (with a single split its weight is exp(0) = 1).  Both kernels
// launch on the caller's stream and nothing synchronises, so a CUDA graph
// replays the pair.
//
// Bound.  Bytes: per call the kernels must read K and V for the valid rows,
// 2 * sum_b valid_b * Hkv * D * sizeof(T), plus q, valid_len and the output;
// the arithmetic is 4 flops per K/V element pair and G heads, ~2G flops per
// byte, far below the card's balance point.  At the serving shape (16
// slots x 1024 positions x 4 kv heads x 64, bf16) the full view is 16.8 MB,
// about 5.0 us at 3.35 TB/s; the partials add B Hq n_split (D + 2) f32
// written and read once (0.8 MB there).
//
// Plain C interface for ctypes: the entry points launch on the given
// stream, never synchronise, allocate nothing, and return
// cudaGetLastError() so a refused launch is reported by the caller.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kTile = 64;         // K/V rows staged per step (two per lane)
constexpr int kStages = 2;        // cp.async ring
constexpr int kRowPad = 16;       // bytes of padding after each staged row
constexpr float kNegInf = -1e30f; // the TPU kernel's NEG_INF
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMergeWarps = 4;    // (row, head) pairs a merge block
constexpr int kMaxDevices = 64;

struct Bf16 {};  // tag: elements are bf16 bit patterns (uint16_t)

template <typename T> struct Elem;

template <> struct Elem<float> {
  using Storage = float;
  static constexpr int kPerChunk = 4;  // elements in 16 bytes
  __device__ static __forceinline__ void unpack(const uint4 r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ static __forceinline__ float load(const Storage* p) { return *p; }
  __device__ static __forceinline__ void store(Storage* p, float x) { *p = x; }
  // N consecutive elements (N in 1, 2, 4) from an N-element-aligned address
  template <int N>
  __device__ static __forceinline__ void load_n(const Storage* p, float* f) {
    if constexpr (N == 4) {
      const float4 r = *reinterpret_cast<const float4*>(p);
      f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
    } else if constexpr (N == 2) {
      const float2 r = *reinterpret_cast<const float2*>(p);
      f[0] = r.x; f[1] = r.y;
    } else {
      f[0] = *p;
    }
  }
};

// bf16 -> f32 is exact: the bf16 bits are the high half of the f32.
__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

template <> struct Elem<Bf16> {
  using Storage = uint16_t;
  static constexpr int kPerChunk = 8;
  __device__ static __forceinline__ void unpack(const uint4 r, float* f) {
    f[0] = bf16_lo(r.x); f[1] = bf16_hi(r.x);
    f[2] = bf16_lo(r.y); f[3] = bf16_hi(r.y);
    f[4] = bf16_lo(r.z); f[5] = bf16_hi(r.z);
    f[6] = bf16_lo(r.w); f[7] = bf16_hi(r.w);
  }
  __device__ static __forceinline__ float load(const Storage* p) {
    return __uint_as_float(((unsigned)*p) << 16);
  }
  template <int N>
  __device__ static __forceinline__ void load_n(const Storage* p, float* f) {
    if constexpr (N == 4) {
      const uint2 r = *reinterpret_cast<const uint2*>(p);
      f[0] = bf16_lo(r.x); f[1] = bf16_hi(r.x); f[2] = bf16_lo(r.y); f[3] = bf16_hi(r.y);
    } else if constexpr (N == 2) {
      const unsigned r = *reinterpret_cast<const unsigned*>(p);
      f[0] = bf16_lo(r); f[1] = bf16_hi(r);
    } else {
      f[0] = load(p);
    }
  }
  // f32 -> bf16, round to nearest even (NaN kept quiet)
  __device__ static __forceinline__ void store(Storage* p, float x) {
    const unsigned u = __float_as_uint(x);
    if ((u & 0x7fffffffu) > 0x7f800000u) {
      *p = (uint16_t)((u >> 16) | 0x40u);
      return;
    }
    *p = (uint16_t)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
  }
};

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// q . k for one staged key row; q as f32 in registers (16-byte aligned
// shared memory at D 128, where registers would not hold it)
template <typename T, int D, typename Q>
__device__ __forceinline__ float dot_row(const Q& q, const unsigned char* __restrict__ row) {
  constexpr int kN = Elem<T>::kPerChunk;
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < D / kN; ++c) {
    float kf[kN];
    Elem<T>::unpack(reinterpret_cast<const uint4*>(row)[c], kf);
#pragma unroll
    for (int i = 0; i < kN; ++i) s = fmaf(q[c * kN + i], kf[i], s);
  }
  return s;
}

template <typename T, int D>
struct Layout {
  using S = typename Elem<T>::Storage;
  static constexpr int kRowBytes = D * (int)sizeof(S);       // multiple of 16
  static constexpr int kChunksPerRow = kRowBytes / 16;
  static constexpr int kStagedRow = kRowBytes + kRowPad;
  static constexpr int kTileBytes = kTile * kStagedRow;
  // acc floats per lane: lane owns columns lane * kEpl + i (D >= 32), or
  // column lane (D < 32, lanes below D)
  static constexpr int kEpl = D >= 32 ? D / 32 : 1;
  static constexpr size_t smem(int G) {
    return (size_t)kStages * 2 * kTileBytes        // K and V tiles, two stages
           + (size_t)G * D * sizeof(float)         // q, f32
           + (size_t)G * kTile * sizeof(float);    // p per head
  }
};

// The partial of split blockIdx.z over keys [z * chunk, (z + 1) * chunk) ∩
// [0, valid_len[b]), for the rows b = blockIdx.y, blockIdx.y + gridDim.y,
// ... below B (gridDim.y is at most 65,535; rows are independent).
template <typename T, int D>
__global__ void decode_split_kernel(
    const typename Elem<T>::Storage* __restrict__ q,
    const typename Elem<T>::Storage* __restrict__ k,
    const typename Elem<T>::Storage* __restrict__ v,
    const int* __restrict__ valid_len, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int B, int S, int Hkv, int G, int chunk, float scale) {
  using L = Layout<T, D>;
  using St = typename Elem<T>::Storage;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* kv = smem;  // stage s: K at s * 2 tiles, V one tile later
  float* qs = reinterpret_cast<float*>(smem + kStages * 2 * L::kTileBytes);
  float* ps = qs + G * D;

  const int h = blockIdx.x;
  const int split = blockIdx.z;
  const int n_split = gridDim.z;
  const int g = threadIdx.x >> 5;  // this warp's query head in the group
  const int lane = threadIdx.x & 31;
  const int nthreads = blockDim.x;

  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    int n = valid_len[b];
    n = n < 0 ? 0 : (n > S ? S : n);
    const long long s_beg = (long long)split * chunk;
    const int s_end = (int)(s_beg + chunk < n ? s_beg + chunk : n);

    float m = kNegInf, l = 0.0f;
    float acc[L::kEpl];
#pragma unroll
    for (int i = 0; i < L::kEpl; ++i) acc[i] = 0.0f;

    if (s_beg < s_end) {
      // q[b, h*G + g, :] for every g, widened to f32
      const St* qb = q + ((long long)b * Hkv + h) * G * D;
      for (int i = threadIdx.x; i < G * D; i += nthreads) qs[i] = Elem<T>::load(qb + i);

      const long long row_stride = (long long)Hkv * D;  // elements between keys s, s+1
      const St* kb = k + (long long)b * S * row_stride + (long long)h * D;
      const St* vb = v + (long long)b * S * row_stride + (long long)h * D;
      auto stage = [&](int t0, int st) {
        const int rows = min(kTile, s_end - t0);
        unsigned char* ks = kv + st * 2 * L::kTileBytes;
        unsigned char* vs = ks + L::kTileBytes;
        for (int c = threadIdx.x; c < rows * L::kChunksPerRow; c += nthreads) {
          const int r = c / L::kChunksPerRow;
          const int cc = c - r * L::kChunksPerRow;
          const long long off = (long long)(t0 + r) * row_stride;
          cp_async16(ks + r * L::kStagedRow + cc * 16, reinterpret_cast<const uint4*>(kb + off) + cc);
          cp_async16(vs + r * L::kStagedRow + cc * 16, reinterpret_cast<const uint4*>(vb + off) + cc);
        }
      };
      float* pg = ps + g * kTile;
      __syncthreads();  // qs is written
      // this warp's query: in registers up to D 64, else read from qs
      constexpr int kQR = D <= 64 ? D : 1;
      float qreg[kQR];
#pragma unroll
      for (int i = 0; i < kQR; ++i) qreg[i] = qs[g * D + i];
      const float* qsm = qs + g * D;

      stage((int)s_beg, 0);
      cp_async_commit();
      int it = 0;
      for (int t0 = (int)s_beg; t0 < s_end; t0 += kTile, ++it) {
        if (t0 + kTile < s_end) stage(t0 + kTile, (it + 1) % kStages);
        cp_async_commit();
        cp_async_wait<1>();  // tile it has landed
        __syncthreads();     // for every thread
        const unsigned char* ks = kv + (it % kStages) * 2 * L::kTileBytes;
        const unsigned char* vs = ks + L::kTileBytes;
        const int rows = min(kTile, s_end - t0);

        float s0 = kNegInf, s1 = kNegInf;
        const bool ok0 = lane < rows, ok1 = lane + 32 < rows;
        if constexpr (D <= 64) {
          if (ok0) s0 = dot_row<T, D>(qreg, ks + lane * L::kStagedRow) * scale;
          if (ok1) s1 = dot_row<T, D>(qreg, ks + (lane + 32) * L::kStagedRow) * scale;
        } else {
          if (ok0) s0 = dot_row<T, D>(qsm, ks + lane * L::kStagedRow) * scale;
          if (ok1) s1 = dot_row<T, D>(qsm, ks + (lane + 32) * L::kStagedRow) * scale;
        }
        const float m_new = fmaxf(m, warp_max(fmaxf(s0, s1)));
        const float alpha = expf(m - m_new);
        const float p0 = ok0 ? expf(s0 - m_new) : 0.0f;
        const float p1 = ok1 ? expf(s1 - m_new) : 0.0f;
        pg[lane] = p0;
        pg[lane + 32] = p1;
        l = l * alpha + warp_sum(p0 + p1);
        m = m_new;
        __syncwarp();

#pragma unroll
        for (int i = 0; i < L::kEpl; ++i) acc[i] *= alpha;
        if (D >= 32 || lane < D) {
          const St* vcol = reinterpret_cast<const St*>(vs) + lane * L::kEpl;
          constexpr int kRowElems = L::kStagedRow / (int)sizeof(St);
          int j = 0;
          for (; j + 4 <= rows; j += 4) {  // four keys a step: one 16-byte load of p
            const float4 p4 = *reinterpret_cast<const float4*>(pg + j);
            const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              float vv[L::kEpl];
              Elem<T>::template load_n<L::kEpl>(vcol + (j + u) * kRowElems, vv);
#pragma unroll
              for (int i = 0; i < L::kEpl; ++i) acc[i] = fmaf(pj[u], vv[i], acc[i]);
            }
          }
          for (; j < rows; ++j) {
            float vv[L::kEpl];
            Elem<T>::template load_n<L::kEpl>(vcol + j * kRowElems, vv);
#pragma unroll
            for (int i = 0; i < L::kEpl; ++i) acc[i] = fmaf(pg[j], vv[i], acc[i]);
          }
        }
        __syncthreads();  // stage it % kStages is free for tile it + 2
      }
      cp_async_wait<0>();
    }

    const long long row = ((long long)b * Hkv + h) * G + g;  // (b, query head)
    const long long pi = row * n_split + split;
    if (lane == 0) {
      part_ml[2 * pi] = m;
      part_ml[2 * pi + 1] = l;
    }
    float* pa = part_acc + pi * D;
    if (D >= 32 || lane < D) {
#pragma unroll
      for (int i = 0; i < L::kEpl; ++i) pa[lane * L::kEpl + i] = acc[i];
    }
    __syncthreads();  // shared memory is read before the next row stages into it
  }
}

// out[row] = sum_i w_i acc_i / sum_i w_i l_i (by 1 where that is 0),
// w_i = exp(m_i - max_i m_i): one warp per (b, query head) row.
template <typename T, int D>
__global__ void decode_merge_kernel(const float* __restrict__ part_acc,
                                    const float* __restrict__ part_ml,
                                    typename Elem<T>::Storage* __restrict__ out, int rows,
                                    int n_split) {
  using St = typename Elem<T>::Storage;
  constexpr int kEpl = (D + 31) / 32;
  const int row = blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* ml = part_ml + (long long)row * n_split * 2;
  float mx = kNegInf;
  for (int i = lane; i < n_split; i += 32) mx = fmaxf(mx, ml[2 * i]);
  mx = warp_max(mx);
  float l = 0.0f;
  for (int i = lane; i < n_split; i += 32) l += expf(ml[2 * i] - mx) * ml[2 * i + 1];
  l = warp_sum(l);
  float acc[kEpl];
#pragma unroll
  for (int j = 0; j < kEpl; ++j) acc[j] = 0.0f;
  const float* pa = part_acc + (long long)row * n_split * D;
  for (int i = 0; i < n_split; ++i) {
    const float w = expf(ml[2 * i] - mx);
#pragma unroll
    for (int j = 0; j < kEpl; ++j) {
      const int d = lane + 32 * j;
      if (D >= 32 || d < D) acc[j] = fmaf(w, pa[(long long)i * D + d], acc[j]);
    }
  }
  const float denom = l > 0.0f ? l : 1.0f;
  St* ob = out + (long long)row * D;
#pragma unroll
  for (int j = 0; j < kEpl; ++j) {
    const int d = lane + 32 * j;
    if (D >= 32 || d < D) Elem<T>::store(ob + d, acc[j] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* valid_len,
           float* part_acc, float* part_ml, int B, int S, int Hkv, int G, int chunk,
           int n_split, cudaStream_t st) {
  using St = typename Elem<T>::Storage;
  const size_t smem = Layout<T, D>::smem(G);
  // D^-1/2 rounded once to f32, as the JAX package's Python-float constant
  const float scale = (float)(1.0 / std::sqrt((double)D));
  auto kern = decode_split_kernel<T, D>;
  // raise the shared-memory limit once a device, so that a launch being
  // captured into a CUDA graph makes no other runtime call
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024 && (dev >= kMaxDevices || !raised[dev])) {
    // to the most any group size takes, since it is raised only once
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Layout<T, D>::smem(8));
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) raised[dev] = true;
  }
  // grid.y holds at most 65,535 blocks: past that, each loops over rows
  const unsigned by = (unsigned)(B < 65535 ? B : 65535);
  kern<<<dim3((unsigned)Hkv, by, (unsigned)n_split), 32 * G, smem, st>>>(
      static_cast<const St*>(q), static_cast<const St*>(k),
      static_cast<const St*>(v), valid_len, part_acc, part_ml, B, S, Hkv, G, chunk, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const int* vl, float* pa,
               float* pml, int B, int S, int Hkv, int G, int D, int chunk, int n_split,
               cudaStream_t st) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, vl, pa, pml, B, S, Hkv, G, chunk, n_split, st);
    case 16: return launch<T, 16>(q, k, v, vl, pa, pml, B, S, Hkv, G, chunk, n_split, st);
    case 32: return launch<T, 32>(q, k, v, vl, pa, pml, B, S, Hkv, G, chunk, n_split, st);
    case 64: return launch<T, 64>(q, k, v, vl, pa, pml, B, S, Hkv, G, chunk, n_split, st);
    case 128: return launch<T, 128>(q, k, v, vl, pa, pml, B, S, Hkv, G, chunk, n_split, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int D>
int launch_merge(const float* pa, const float* pml, void* out, int rows, int n_split,
                 cudaStream_t st) {
  using St = typename Elem<T>::Storage;
  const unsigned blocks = (unsigned)((rows + kMergeWarps - 1) / kMergeWarps);
  decode_merge_kernel<T, D><<<blocks, 32 * kMergeWarps, 0, st>>>(
      pa, pml, static_cast<St*>(out), rows, n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_merge(const float* pa, const float* pml, void* out, int rows, int n_split,
                   int D, cudaStream_t st) {
  switch (D) {
    case 8: return launch_merge<T, 8>(pa, pml, out, rows, n_split, st);
    case 16: return launch_merge<T, 16>(pa, pml, out, rows, n_split, st);
    case 32: return launch_merge<T, 32>(pa, pml, out, rows, n_split, st);
    case 64: return launch_merge<T, 64>(pa, pml, out, rows, n_split, st);
    case 128: return launch_merge<T, 128>(pa, pml, out, rows, n_split, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Hkv*G, D), k/v (B, S, Hkv, D): contiguous, 16-byte aligned, f32
// (is_bf16 = 0) or bf16 (is_bf16 = 1); valid_len (B,) int32.  G in 1..8, D
// in {8, 16, 32, 64, 128}; chunk a positive multiple of 64 with n_split =
// ceil(S / chunk).  Writes the f32 partials, part_ml (B*Hkv*G, n_split, 2)
// as (m, l) and part_acc (B*Hkv*G, n_split, D), for repro_decode_merge.
// The wrapper checks the rest.
int repro_decode_attention(const void* q, const void* k, const void* v,
                           const int* valid_len, void* part_acc, void* part_ml, int B,
                           int S, int Hkv, int G, int D, int chunk, int n_split, int is_bf16,
                           void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || G < 1 || G > 8 || chunk < 1 || chunk % kTile ||
      n_split < 1 || n_split > 65535 || (long long)(n_split - 1) * chunk >= S ||
      (long long)n_split * chunk < S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part_acc);
  float* pml = static_cast<float*>(part_ml);
  return is_bf16 ? dispatch_d<Bf16>(q, k, v, valid_len, pa, pml, B, S, Hkv, G, D, chunk, n_split, st)
                 : dispatch_d<float>(q, k, v, valid_len, pa, pml, B, S, Hkv, G, D, chunk, n_split, st);
}

// out (rows, D) in q's type from the partials of repro_decode_attention,
// rows = B * Hkv * G.
int repro_decode_merge(const void* part_acc, const void* part_ml, void* out, int rows,
                       int n_split, int D, int is_bf16, void* stream) {
  if (rows < 1 || n_split < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pa = static_cast<const float*>(part_acc);
  const float* pml = static_cast<const float*>(part_ml);
  return is_bf16 ? dispatch_merge<Bf16>(pa, pml, out, rows, n_split, D, st)
                 : dispatch_merge<float>(pa, pml, out, rows, n_split, D, st);
}

// dynamic shared memory of a split-kernel launch (bytes), or -1
int repro_decode_attention_smem(int D, int G, int is_bf16) {
  switch (D) {
    case 8: return (int)(is_bf16 ? Layout<Bf16, 8>::smem(G) : Layout<float, 8>::smem(G));
    case 16: return (int)(is_bf16 ? Layout<Bf16, 16>::smem(G) : Layout<float, 16>::smem(G));
    case 32: return (int)(is_bf16 ? Layout<Bf16, 32>::smem(G) : Layout<float, 32>::smem(G));
    case 64: return (int)(is_bf16 ? Layout<Bf16, 64>::smem(G) : Layout<float, 64>::smem(G));
    case 128: return (int)(is_bf16 ? Layout<Bf16, 128>::smem(G) : Layout<float, 128>::smem(G));
    default: return -1;
  }
}

}  // extern "C"
