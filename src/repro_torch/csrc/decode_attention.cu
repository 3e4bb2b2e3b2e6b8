// Decode attention for Hopper (sm_90a): one query token per row against a
// dense KV cache view, the G query heads of a GQA group together, with the
// keys split over blocks (flash-decoding) and the partials merged on the
// device.  Any G >= 1 (MQA included) and any head width D from 8 to 256
// that is a multiple of 8 (the wrapper pads other widths with zero columns
// and passes the true width for the scale).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   decode_split_kernel<T, Dc, kExact>  <- src/repro/kernels/decode_attention/kernel.py _decode_kernel
//   decode_merge_kernel<T, kEpl>           (its _finalize, across the splits)
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
// query head of the group (blockDim = 32 G) up to G 8; a larger group is
// taken in passes of at most 8 heads inside the same block (G 71: 9 passes
// of 8), each pass re-staging the split's K and V tiles, which then come
// from L2, so that device memory still delivers each K/V byte once and no
// two blocks share a (row, kv head, split).  The wrapper picks chunk, a
// multiple of the 64-row tile, from S and the card's SM count, so that the
// serving shape (B 16 x Hkv 4) launches at least two blocks an SM where one
// block per (h, b) left half the card idle.  Each step stages a tile of K
// and V rows into shared memory with 16-byte cp.async copies, two stages
// deep, so the next tile is in flight while this one is used; the G heads
// share every K/V byte staged.  Rows are padded by 16 bytes, which makes
// the lanes' 16-byte reads of eight different rows fall in distinct banks.
// Widths: D 8, 16, 32, 64 and 128 have exact instantiations; any other D
// runs in the width class Dc of 32, 64, 128 or 256 above it, its staged
// rows Dc columns wide and zero past D (the zeros add exactly 0), so the
// loops over a row stay unrolled.  At Dc 256 a tile is 32 keys, so that two
// stages of K and V fit in shared memory in f32 (142,336 bytes at 8 heads).
// Scores: lane j takes keys j and j + 32 of the tile (j alone at Dc 256)
// against its warp's query, held in f32 registers up to Dc 64 (above, read
// from shared memory); m and l live in registers in f32, uniform across the warp.
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
// the arithmetic is 4 flops per K/V element pair and G heads, ~G flops per
// byte in bf16 (G / 2 in f32), below the CUDA cores' balance point (20
// flops a byte at 67 TFLOP/s) up to G ~ 20 in bf16; a larger group (Falcon-
// 7B's G 71) is bound by operations.  At the serving shape (16
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
constexpr int kMaxWarps = 8;      // query heads a split block takes at once
constexpr int kMaxD = 256;        // the widest head
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
  // N consecutive elements (N in 1, 2, 4, 8) from an N-element-aligned address
  template <int N>
  __device__ static __forceinline__ void load_n(const Storage* p, float* f) {
    if constexpr (N == 8) {
      load_n<4>(p, f);
      load_n<4>(p + 4, f + 4);
    } else if constexpr (N == 4) {
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
    if constexpr (N == 8) {
      unpack(*reinterpret_cast<const uint4*>(p), f);
    } else if constexpr (N == 4) {
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
// shared memory above D 64, where registers would not hold it)
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

// The staged layout of width class Dc: head widths D <= Dc (D = Dc where
// the instantiation is exact) are staged into rows of Dc columns whose
// columns D..Dc-1 are zero, so the loops over a row are unrolled for Dc.
template <typename T, int Dc>
struct Layout {
  using S = typename Elem<T>::Storage;
  static constexpr int kRowBytes = Dc * (int)sizeof(S);      // multiple of 16
  static constexpr int kChunksPerRow = kRowBytes / 16;
  static constexpr int kStagedRow = kRowBytes + kRowPad;
  // keys a staged tile: 64 (two a lane), 32 (one a lane) at Dc 256, where
  // two stages of 64 f32 rows would not fit in shared memory
  static constexpr int kTileRows = Dc > 128 ? 32 : kTile;
  static constexpr int kKeys = kTileRows / 32;
  static constexpr int kTileBytes = kTileRows * kStagedRow;
  // acc floats per lane: lane owns columns lane * kEpl + i (Dc >= 32), or
  // column lane (Dc < 32, lanes below Dc)
  static constexpr int kEpl = Dc >= 32 ? Dc / 32 : 1;
  static constexpr size_t smem(int W) {
    return (size_t)kStages * 2 * kTileBytes        // K and V tiles, two stages
           + (size_t)W * Dc * sizeof(float)        // q of the pass's heads, f32
           + (size_t)W * kTileRows * sizeof(float); // p per head
  }
};

// The partial of split blockIdx.z over keys [z * chunk, (z + 1) * chunk) ∩
// [0, valid_len[b]), for the rows b = blockIdx.y, blockIdx.y + gridDim.y,
// ... below B (gridDim.y is at most 65,535; rows are independent).  The
// block's W warps take the group's G heads W at a time (passes), warp w
// head p0 + w of pass p0; a pass re-stages the split's K and V tiles (from
// L2 after the first); kPasses is false where one pass takes the group
// (W = G <= kMaxWarps), and the pass loop compiles away.  kExact: D = Dc;
// else D_ (a multiple of 8 below Dc) and the staged rows are zero past D.
template <typename T, int Dc, bool kExact, bool kPasses>
__global__ void __launch_bounds__(32 * kMaxWarps)
decode_split_kernel(const typename Elem<T>::Storage* __restrict__ q,
                    const typename Elem<T>::Storage* __restrict__ k,
                    const typename Elem<T>::Storage* __restrict__ v,
                    const int* __restrict__ valid_len, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int B, int S, int Hkv, int G, int D_,
                    int chunk, float scale) {
  using L = Layout<T, Dc>;
  using St = typename Elem<T>::Storage;
  constexpr int kTR = L::kTileRows;
  const int D = kExact ? Dc : D_;
  const int cpr = kExact ? L::kChunksPerRow : D * (int)sizeof(St) / 16;  // chunks a row
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* kv = smem;  // stage s: K at s * 2 tiles, V one tile later
  const int W = blockDim.x >> 5;
  float* qs = reinterpret_cast<float*>(smem + kStages * 2 * L::kTileBytes);
  float* ps = qs + W * Dc;

  const int h = blockIdx.x;
  const int split = blockIdx.z;
  const int n_split = gridDim.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nthreads = blockDim.x;
  if (!kExact) {  // columns D..Dc-1 of every staged row read as zero
    for (int i = threadIdx.x; i < kStages * 2 * L::kTileBytes / 16; i += nthreads)
      reinterpret_cast<uint4*>(kv)[i] = make_uint4(0, 0, 0, 0);
  }

  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    int n = valid_len[b];
    n = n < 0 ? 0 : (n > S ? S : n);
    const long long s_beg = (long long)split * chunk;
    const int s_end = (int)(s_beg + chunk < n ? s_beg + chunk : n);

    auto pass = [&](int p0) {
      const int g = p0 + warp;  // this warp's query head in the group
      const bool active = !kPasses || g < G;
      float m = kNegInf, l = 0.0f;
      float acc[L::kEpl];
#pragma unroll
      for (int i = 0; i < L::kEpl; ++i) acc[i] = 0.0f;

      if (s_beg < s_end) {
        // q[b, h*G + p0 + w, :] for every warp w, widened to f32, zero past
        // D and past G
        const St* qb = q + ((long long)b * Hkv + h) * G * D;
        if (kExact && !kPasses) {  // W = G, Dc = D: the group's rows as they lie
          for (int i = threadIdx.x; i < G * D; i += nthreads) qs[i] = Elem<T>::load(qb + i);
        } else {
          for (int i = threadIdx.x; i < W * Dc; i += nthreads) {
            const int gg = p0 + i / Dc, c = i % Dc;
            qs[i] = (gg < G && c < D) ? Elem<T>::load(qb + (long long)gg * D + c) : 0.0f;
          }
        }

        const long long row_stride = (long long)Hkv * D;  // elements between keys s, s+1
        const St* kb = k + (long long)b * S * row_stride + (long long)h * D;
        const St* vb = v + (long long)b * S * row_stride + (long long)h * D;
        auto stage = [&](int t0, int st) {
          const int rows = min(kTR, s_end - t0);
          unsigned char* ks = kv + st * 2 * L::kTileBytes;
          unsigned char* vs = ks + L::kTileBytes;
          for (int c = threadIdx.x; c < rows * cpr; c += nthreads) {
            const int r = c / cpr;
            const int cc = c - r * cpr;
            const long long off = (long long)(t0 + r) * row_stride;
            cp_async16(ks + r * L::kStagedRow + cc * 16,
                       reinterpret_cast<const uint4*>(kb + off) + cc);
            cp_async16(vs + r * L::kStagedRow + cc * 16,
                       reinterpret_cast<const uint4*>(vb + off) + cc);
          }
        };
        float* pg = ps + warp * kTR;
        __syncthreads();  // qs is written (and the zeroed rows)
        // this warp's query: in registers up to Dc 64, else read from qs
        constexpr int kQR = Dc <= 64 ? Dc : 1;
        float qreg[kQR];
#pragma unroll
        for (int i = 0; i < kQR; ++i) qreg[i] = qs[warp * Dc + i];
        const float* qsm = qs + warp * Dc;

        stage((int)s_beg, 0);
        cp_async_commit();
        int it = 0;
        for (int t0 = (int)s_beg; t0 < s_end; t0 += kTR, ++it) {
          if (t0 + kTR < s_end) stage(t0 + kTR, (it + 1) % kStages);
          cp_async_commit();
          cp_async_wait<1>();  // tile it has landed
          __syncthreads();     // for every thread
          const unsigned char* ks = kv + (it % kStages) * 2 * L::kTileBytes;
          const unsigned char* vs = ks + L::kTileBytes;
          const int rows = min(kTR, s_end - t0);

          if (active) {
            // lane takes keys lane + 32 u of the tile
            float sc[L::kKeys];
            bool ok[L::kKeys];
            float mx = kNegInf;
#pragma unroll
            for (int u = 0; u < L::kKeys; ++u) {
              ok[u] = lane + 32 * u < rows;
              sc[u] = kNegInf;
              const unsigned char* krow = ks + (lane + 32 * u) * L::kStagedRow;
              if constexpr (Dc <= 64) {
                if (ok[u]) sc[u] = dot_row<T, Dc>(qreg, krow) * scale;
              } else {
                if (ok[u]) sc[u] = dot_row<T, Dc>(qsm, krow) * scale;
              }
              mx = u == 0 ? sc[0] : fmaxf(mx, sc[u]);
            }
            const float m_new = fmaxf(m, warp_max(mx));
            const float alpha = expf(m - m_new);
            float psum = 0.0f;
#pragma unroll
            for (int u = 0; u < L::kKeys; ++u) {
              const float p = ok[u] ? expf(sc[u] - m_new) : 0.0f;
              pg[lane + 32 * u] = p;
              psum = u == 0 ? p : psum + p;
            }
            l = l * alpha + warp_sum(psum);
            m = m_new;
            __syncwarp();

#pragma unroll
            for (int i = 0; i < L::kEpl; ++i) acc[i] *= alpha;
            if (Dc >= 32 || lane < Dc) {
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
          }
          __syncthreads();  // stage it % kStages is free for tile it + 2
        }
        cp_async_wait<0>();
      }

      if (active) {
        const long long row = ((long long)b * Hkv + h) * G + g;  // (b, query head)
        const long long pi = row * n_split + split;
        if (lane == 0) {
          part_ml[2 * pi] = m;
          part_ml[2 * pi + 1] = l;
        }
        float* pa = part_acc + pi * D;
#pragma unroll
        for (int i = 0; i < L::kEpl; ++i) {
          const int col = Dc >= 32 ? lane * L::kEpl + i : lane;
          if (col < D) pa[col] = acc[i];
        }
      }
      __syncthreads();  // shared memory is read before the next pass stages into it
    };
    if constexpr (kPasses) {
      for (int p0 = 0; p0 < G; p0 += W) pass(p0);
    } else {
      pass(0);
    }
  }
}

// out[row] = sum_i w_i acc_i / sum_i w_i l_i (by 1 where that is 0),
// w_i = exp(m_i - max_i m_i): one warp per (b, query head) row; lane owns
// columns lane + 32 j below D.  kD: the head width where it is exact (its
// loops unrolled as they were before the domain was widened), 0 for D_.
template <typename T, int kD, int kEpl>
__global__ void decode_merge_kernel(const float* __restrict__ part_acc,
                                    const float* __restrict__ part_ml,
                                    typename Elem<T>::Storage* __restrict__ out, int rows,
                                    int n_split, int D_) {
  using St = typename Elem<T>::Storage;
  const int D = kD > 0 ? kD : D_;
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
      if (kD >= 32 || d < D) acc[j] = fmaf(w, pa[(long long)i * D + d], acc[j]);
    }
  }
  const float denom = l > 0.0f ? l : 1.0f;
  St* ob = out + (long long)row * D;
#pragma unroll
  for (int j = 0; j < kEpl; ++j) {
    const int d = lane + 32 * j;
    if (kD >= 32 || d < D) Elem<T>::store(ob + d, acc[j] / denom);
  }
}

// warps a split block: the group's heads in ceil(G / kMaxWarps) passes of
// as even a size as they allow
int warps_for(int G) {
  const int passes = (G + kMaxWarps - 1) / kMaxWarps;
  return (G + passes - 1) / passes;
}

template <typename T, int Dc, bool kExact, bool kPasses>
int launch(const void* q, const void* k, const void* v, const int* valid_len,
           float* part_acc, float* part_ml, int B, int S, int Hkv, int G, int D, int chunk,
           int n_split, int scale_d, cudaStream_t st) {
  using St = typename Elem<T>::Storage;
  using L = Layout<T, Dc>;
  const int W = warps_for(G);
  const size_t smem = L::smem(W);
  // (1/sqrt(scale_d)) rounded once to f32, as the JAX package's Python-float
  // constant D^-1/2 of the true head width
  const float scale = (float)(1.0 / std::sqrt((double)scale_d));
  auto kern = decode_split_kernel<T, Dc, kExact, kPasses>;
  // raise the shared-memory limit once a device, so that a launch being
  // captured into a CUDA graph makes no other runtime call
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024 && (dev >= kMaxDevices || !raised[dev])) {
    // to the most any group size takes, since it is raised only once
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::smem(kMaxWarps));
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) raised[dev] = true;
  }
  // grid.y holds at most 65,535 blocks: past that, each loops over rows
  const unsigned by = (unsigned)(B < 65535 ? B : 65535);
  kern<<<dim3((unsigned)Hkv, by, (unsigned)n_split), 32 * W, smem, st>>>(
      static_cast<const St*>(q), static_cast<const St*>(k), static_cast<const St*>(v),
      valid_len, part_acc, part_ml, B, S, Hkv, G, D, chunk, scale);
  return (int)cudaGetLastError();
}

// exact instantiations for the widths of every config before this domain
// was widened (their times stand), width classes for the rest
template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const int* vl, float* pa,
               float* pml, int B, int S, int Hkv, int G, int D, int chunk, int n_split,
               int scale_d, cudaStream_t st) {
#define REPRO_SPLIT(DC, EXACT)                                                              \
  (G > kMaxWarps                                                                            \
       ? launch<T, DC, EXACT, true>(q, k, v, vl, pa, pml, B, S, Hkv, G, D, chunk, n_split,  \
                                    scale_d, st)                                            \
       : launch<T, DC, EXACT, false>(q, k, v, vl, pa, pml, B, S, Hkv, G, D, chunk, n_split, \
                                     scale_d, st))
  switch (D) {
    case 8: return REPRO_SPLIT(8, true);
    case 16: return REPRO_SPLIT(16, true);
    case 32: return REPRO_SPLIT(32, true);
    case 64: return REPRO_SPLIT(64, true);
    case 128: return REPRO_SPLIT(128, true);
    default: break;
  }
  if (D < 32) return REPRO_SPLIT(32, false);
  if (D < 64) return REPRO_SPLIT(64, false);
  if (D < 128) return REPRO_SPLIT(128, false);
  return REPRO_SPLIT(256, false);
#undef REPRO_SPLIT
}

template <typename T, int kD, int kEpl>
int launch_merge(const float* pa, const float* pml, void* out, int rows, int n_split, int D,
                 cudaStream_t st) {
  using St = typename Elem<T>::Storage;
  const unsigned blocks = (unsigned)((rows + kMergeWarps - 1) / kMergeWarps);
  decode_merge_kernel<T, kD, kEpl><<<blocks, 32 * kMergeWarps, 0, st>>>(
      pa, pml, static_cast<St*>(out), rows, n_split, D);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_merge(const float* pa, const float* pml, void* out, int rows, int n_split,
                   int D, cudaStream_t st) {
  switch (D) {  // the exact widths
    case 8: return launch_merge<T, 8, 1>(pa, pml, out, rows, n_split, D, st);
    case 16: return launch_merge<T, 16, 1>(pa, pml, out, rows, n_split, D, st);
    case 32: return launch_merge<T, 32, 1>(pa, pml, out, rows, n_split, D, st);
    case 64: return launch_merge<T, 64, 2>(pa, pml, out, rows, n_split, D, st);
    case 128: return launch_merge<T, 128, 4>(pa, pml, out, rows, n_split, D, st);
    default: break;
  }
  if (D <= 32) return launch_merge<T, 0, 1>(pa, pml, out, rows, n_split, D, st);
  if (D <= 64) return launch_merge<T, 0, 2>(pa, pml, out, rows, n_split, D, st);
  if (D <= 128) return launch_merge<T, 0, 4>(pa, pml, out, rows, n_split, D, st);
  return launch_merge<T, 0, 8>(pa, pml, out, rows, n_split, D, st);
}

template <typename T>
size_t smem_of(int D, int G) {
  const int W = warps_for(G);
  switch (D) {
    case 8: return Layout<T, 8>::smem(W);
    case 16: return Layout<T, 16>::smem(W);
    case 32: return Layout<T, 32>::smem(W);
    case 64: return Layout<T, 64>::smem(W);
    case 128: return Layout<T, 128>::smem(W);
    default: break;
  }
  if (D < 32) return Layout<T, 32>::smem(W);
  if (D < 64) return Layout<T, 64>::smem(W);
  if (D < 128) return Layout<T, 128>::smem(W);
  return Layout<T, 256>::smem(W);
}

bool head_width_ok(int D) { return D >= 8 && D <= kMaxD && D % 8 == 0; }

}  // namespace

extern "C" {

// q (B, Hkv*G, D), k/v (B, S, Hkv, D): contiguous, 16-byte aligned, f32
// (is_bf16 = 0) or bf16 (is_bf16 = 1); valid_len (B,) int32.  Any G >= 1;
// D a multiple of 8 from 8 to 256 (the wrapper pads other widths with zero
// columns); scale_d the true head width, whose D^-1/2 scales the logits;
// chunk a positive multiple of 64 with n_split = ceil(S / chunk).  Writes
// the f32 partials, part_ml (B*Hkv*G, n_split, 2) as (m, l) and part_acc
// (B*Hkv*G, n_split, D), for repro_decode_merge.  The wrapper checks the
// rest.
int repro_decode_attention(const void* q, const void* k, const void* v,
                           const int* valid_len, void* part_acc, void* part_ml, int B,
                           int S, int Hkv, int G, int D, int chunk, int n_split, int scale_d,
                           int is_bf16, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || G < 1 || !head_width_ok(D) || scale_d < 1 || chunk < 1 ||
      chunk % kTile || n_split < 1 || n_split > 65535 ||
      (long long)(n_split - 1) * chunk >= S || (long long)n_split * chunk < S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part_acc);
  float* pml = static_cast<float*>(part_ml);
  return is_bf16 ? dispatch_d<Bf16>(q, k, v, valid_len, pa, pml, B, S, Hkv, G, D, chunk,
                                    n_split, scale_d, st)
                 : dispatch_d<float>(q, k, v, valid_len, pa, pml, B, S, Hkv, G, D, chunk,
                                     n_split, scale_d, st);
}

// out (rows, D) in q's type from the partials of repro_decode_attention,
// rows = B * Hkv * G, D from 1 to 256.
int repro_decode_merge(const void* part_acc, const void* part_ml, void* out, int rows,
                       int n_split, int D, int is_bf16, void* stream) {
  if (rows < 1 || n_split < 1 || D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pa = static_cast<const float*>(part_acc);
  const float* pml = static_cast<const float*>(part_ml);
  return is_bf16 ? dispatch_merge<Bf16>(pa, pml, out, rows, n_split, D, st)
                 : dispatch_merge<float>(pa, pml, out, rows, n_split, D, st);
}

// dynamic shared memory of a split-kernel launch (bytes), or -1
int repro_decode_attention_smem(int D, int G, int is_bf16) {
  if (!head_width_ok(D) || G < 1) return -1;
  return (int)(is_bf16 ? smem_of<Bf16>(D, G) : smem_of<float>(D, G));
}

}  // extern "C"
