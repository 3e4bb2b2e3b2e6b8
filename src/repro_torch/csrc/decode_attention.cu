// Decode attention for Hopper (sm_90a): one query token per row against a
// dense KV cache view, the G query heads of a GQA group together.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   decode_attention_kernel<T, D>  <- src/repro/kernels/decode_attention/kernel.py _decode_kernel
// (reached through ops.decode_attention <- models/attention._decode_attend,
// once per layer of every continuous-batching decode step).
//
// Function.  For q (B, Hkv*G, D), k and v (B, S, Hkv, D) and valid_len (B,)
// int32, all on the card:
//   out[b, h*G+g] = sum_s p_s v[b, s, h] / sum_s p_s,
//   p_s = exp(q[b, h*G+g] . k[b, s, h] * D^-1/2 - m)   over keys s < valid_len[b],
// with m the running maximum.  The dot product is taken first and then
// multiplied by D^-1/2, all in f32 (kernel.py:55-57); masked keys contribute
// exactly 0; a row with valid_len 0 gives 0 (the divide is guarded by l > 0,
// kernel.py:76); the output is rounded once, from f32, to q's type.
//
// Design.  The TPU kernel walks the grid (B, Hkv, Sp/bk) in order and
// carries (m, l, acc) across the S steps in VMEM.  Here one block owns one
// (kv head h, row b) pair and loops over S itself: grid (Hkv, B), one warp
// per query head of the group (blockDim = 32 G).  Each step stages a tile
// of kTile rows of K and V into shared memory with 16-byte loads (a row is
// D * sizeof(T) bytes, a multiple of 16), so the G heads share every K/V
// byte read from device memory — the point of the GQA layout.  Rows are
// padded by 16 bytes, which makes the lanes' 16-byte reads of eight
// different rows fall in distinct banks.  Scores: lane j takes keys j and
// j + 32 of the tile.  m and l live in registers in f32, uniform across the
// warp; acc (D floats) is spread across the lanes, lane owning d = lane +
// 32 i.  The block reads valid_len[b] itself (no host sync, no (B, S) bias
// row), stops at the last valid tile and masks the ragged tail, so S needs
// no padding to a multiple of the tile.
//
// Bound.  Bytes: per call the kernel must read K and V for the valid rows,
// 2 * sum_b valid_b * Hkv * D * sizeof(T), plus q, valid_len and the output;
// the arithmetic is 4 flops per K/V element pair and G heads, ~2G flops per
// byte, far below the card's balance point.  At the serving shape (16
// slots x 1024 positions x 4 kv heads x 64, bf16) the full view is 16.8 MB,
// about 5.0 us at 3.35 TB/s.  The design reads each valid K/V byte once and
// nothing past valid_len.  Known weak spot: B x Hkv = 64 blocks at that
// shape leave half of the 132 SMs idle; a split over S with a small merge
// pass (flash-decoding) is the fix, for a later change.
//
// Plain C interface for ctypes: the entry point launches on the given
// stream, never synchronises, allocates nothing, and returns
// cudaGetLastError() so a refused launch is reported by the caller.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kTile = 64;         // K/V rows staged per step (two per lane)
constexpr int kRowPad = 16;       // bytes of padding after each staged row
constexpr float kNegInf = -1e30f; // the TPU kernel's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

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

// q . k for one staged key row; q in shared memory as f32 (16-byte aligned)
template <typename T, int D>
__device__ __forceinline__ float dot_row(const float* __restrict__ q,
                                         const unsigned char* __restrict__ row) {
  constexpr int kN = Elem<T>::kPerChunk;
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < D / kN; ++c) {
    float kf[kN];
    Elem<T>::unpack(reinterpret_cast<const uint4*>(row)[c], kf);
#pragma unroll
    for (int i = 0; i < kN; i += 4) {
      const float4 qv = reinterpret_cast<const float4*>(q)[(c * kN + i) / 4];
      s = fmaf(qv.x, kf[i + 0], s);
      s = fmaf(qv.y, kf[i + 1], s);
      s = fmaf(qv.z, kf[i + 2], s);
      s = fmaf(qv.w, kf[i + 3], s);
    }
  }
  return s;
}

template <typename T, int D>
struct Layout {
  using S = typename Elem<T>::Storage;
  static constexpr int kRowBytes = D * (int)sizeof(S);       // multiple of 16
  static constexpr int kChunksPerRow = kRowBytes / 16;
  static constexpr int kStagedRow = kRowBytes + kRowPad;
  static constexpr int kEpl = (D + 31) / 32;                 // acc floats per lane
  static constexpr size_t smem(int G) {
    return 2 * (size_t)kTile * kStagedRow          // K and V tiles
           + (size_t)G * D * sizeof(float)         // q, f32
           + (size_t)G * kTile * sizeof(float);    // p per head
  }
};

template <typename T, int D>
__global__ void decode_attention_kernel(
    const typename Elem<T>::Storage* __restrict__ q,
    const typename Elem<T>::Storage* __restrict__ k,
    const typename Elem<T>::Storage* __restrict__ v,
    const int* __restrict__ valid_len,
    typename Elem<T>::Storage* __restrict__ out, int S, int Hkv, int G,
    float scale) {
  using L = Layout<T, D>;
  using St = typename Elem<T>::Storage;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ks = smem;
  unsigned char* vs = ks + kTile * L::kStagedRow;
  float* qs = reinterpret_cast<float*>(vs + kTile * L::kStagedRow);
  float* ps = qs + G * D;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = threadIdx.x >> 5;  // this warp's query head in the group
  const int lane = threadIdx.x & 31;
  const int nthreads = blockDim.x;

  // q[b, h*G + g, :] for every g, widened to f32
  const St* qb = q + ((long long)b * Hkv + h) * G * D;
  for (int i = threadIdx.x; i < G * D; i += nthreads) qs[i] = Elem<T>::load(qb + i);

  int n = valid_len[b];
  n = n < 0 ? 0 : (n > S ? S : n);

  float m = kNegInf, l = 0.0f;
  float acc[L::kEpl];
#pragma unroll
  for (int i = 0; i < L::kEpl; ++i) acc[i] = 0.0f;

  const long long row_stride = (long long)Hkv * D;  // elements between keys s, s+1
  const St* kb = k + (long long)b * S * row_stride + (long long)h * D;
  const St* vb = v + (long long)b * S * row_stride + (long long)h * D;
  const float* qg = qs + g * D;
  float* pg = ps + g * kTile;

  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int rows = min(kTile, n - t0);
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int c = threadIdx.x; c < rows * L::kChunksPerRow; c += nthreads) {
      const int r = c / L::kChunksPerRow;
      const int cc = c - r * L::kChunksPerRow;
      const long long off = (long long)(t0 + r) * row_stride;
      const uint4 kv4 = reinterpret_cast<const uint4*>(kb + off)[cc];
      const uint4 vv4 = reinterpret_cast<const uint4*>(vb + off)[cc];
      reinterpret_cast<uint4*>(ks + r * L::kStagedRow)[cc] = kv4;
      reinterpret_cast<uint4*>(vs + r * L::kStagedRow)[cc] = vv4;
    }
    __syncthreads();

    float s0 = kNegInf, s1 = kNegInf;
    const bool ok0 = lane < rows, ok1 = lane + 32 < rows;
    if (ok0) s0 = dot_row<T, D>(qg, ks + lane * L::kStagedRow) * scale;
    if (ok1) s1 = dot_row<T, D>(qg, ks + (lane + 32) * L::kStagedRow) * scale;
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
    for (int j = 0; j < rows; ++j) {
      const float p = pg[j];
      const St* vrow = reinterpret_cast<const St*>(vs + j * L::kStagedRow);
#pragma unroll
      for (int i = 0; i < L::kEpl; ++i) {
        const int d = lane + 32 * i;
        if (D >= 32 || d < D) acc[i] = fmaf(p, Elem<T>::load(vrow + d), acc[i]);
      }
    }
  }

  const float denom = l > 0.0f ? l : 1.0f;
  St* ob = out + (((long long)b * Hkv + h) * G + g) * D;
#pragma unroll
  for (int i = 0; i < L::kEpl; ++i) {
    const int d = lane + 32 * i;
    if (D >= 32 || d < D) Elem<T>::store(ob + d, acc[i] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* valid_len,
           void* out, int B, int S, int Hkv, int G, cudaStream_t st) {
  using St = typename Elem<T>::Storage;
  const size_t smem = Layout<T, D>::smem(G);
  // D^-1/2 rounded once to f32, as the JAX package's Python-float constant
  const float scale = (float)(1.0 / std::sqrt((double)D));
  auto kern = decode_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3((unsigned)Hkv, (unsigned)B, 1), 32 * G, smem, st>>>(
      static_cast<const St*>(q), static_cast<const St*>(k),
      static_cast<const St*>(v), valid_len, static_cast<St*>(out), S, Hkv, G,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const int* vl,
               void* out, int B, int S, int Hkv, int G, int D, cudaStream_t st) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, vl, out, B, S, Hkv, G, st);
    case 16: return launch<T, 16>(q, k, v, vl, out, B, S, Hkv, G, st);
    case 32: return launch<T, 32>(q, k, v, vl, out, B, S, Hkv, G, st);
    case 64: return launch<T, 64>(q, k, v, vl, out, B, S, Hkv, G, st);
    case 128: return launch<T, 128>(q, k, v, vl, out, B, S, Hkv, G, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Hkv*G, D), k/v (B, S, Hkv, D), out like q: contiguous, 16-byte
// aligned, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); valid_len (B,) int32.
// G in 1..8, D in {8, 16, 32, 64, 128}; the wrapper checks the rest.
int repro_decode_attention(const void* q, const void* k, const void* v,
                           const int* valid_len, void* out, int B, int S,
                           int Hkv, int G, int D, int is_bf16, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || G < 1 || G > 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_d<Bf16>(q, k, v, valid_len, out, B, S, Hkv, G, D, st)
                 : dispatch_d<float>(q, k, v, valid_len, out, B, S, Hkv, G, D, st);
}

}  // extern "C"
