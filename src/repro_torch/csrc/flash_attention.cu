// Forward flash attention for Hopper (sm_90a): the cache-free train and
// prefill attention core, GQA, causal or bidirectional, sliding window,
// query offset.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   flash_attention_kernel<T, D>  <- src/repro/kernels/flash_attention/kernel.py _flash_kernel
// (reached through ops.flash_attention <- models/attention.attn_apply(...,
// use_kernel=True) on the cache-free branch with T >= 128, once a layer).
//
// Function.  For q (B, T, Hq, D), k and v (B, S, Hkv, D), Hq = G * Hkv,
// read through their strides in the model layout:
//   out[b, t, h] = sum_s p_s v[b, s, h / G] / sum_s p_s,
//   p_s = exp(q[b, t, h] . k[b, s, h / G] * D^-1/2 - m)
// over the keys s that row t sees: s < S, and with qpos = t + q_offset,
// s <= qpos when causal and s > qpos - window when window > 0.  As in
// kernel.py:78-98: logits are f32, masked logits are -1e30 and their p is
// then set to exactly 0 (a row whose keys are all masked in a tile has
// m = -1e30 and exp(s - m) = 1 there), the running (m, l, acc) are f32,
// and the end divides by l where l > 0 and by 1 elsewhere, so a row that
// sees no key gives 0.  The output is rounded once, from f32, to q's type
// (__float2bfloat16_rn for bf16).
//
// Design.  The TPU grid walks (B, Hq, T/bq, S/bk) with the S dimension in
// order, carrying (m, l, acc) in VMEM.  Here one block owns one (b, h,
// 64-row query tile) and loops over the key tiles itself; blocks never
// share state.  The block's 8 warps each own 8 query rows.  Each step
// stages 64 keys of K and V into shared memory as f32 (K rows padded by 4
// floats, so the lanes' 16-byte reads of eight different rows fall in
// distinct banks).  Scores: lane j takes keys j and j + 32 for all 8 rows
// of its warp, so every staged K chunk feeds 8 rows; the query tile is
// read from shared memory as a broadcast.  P goes through shared memory
// (one 8 x 64 slice a warp) and P.V runs with lane d owning output columns
// d, d + 32, ...  Everything is f32 on the CUDA cores: tensor cores (bf16
// or TF32 inputs) would not hold the 2e-5 f32 limit, and are for a later
// change.
//
// Block skipping.  The key loop starts at the window's left edge of the
// tile's first row and stops at the causal diagonal of its last row, so
// causal attention does about half the work of dense.  Tiles inside that
// range whose rows are partly masked are masked per element; a tile that
// the TPU kernel would skip contributes nothing here either (a fully
// masked row keeps m, l and acc unchanged), so the two agree up to the
// order of f32 sums.  Heavy query tiles (late rows, long causal prefix)
// are launched first: blockIdx.x counts the tiles of a (b, h) backwards.
//
// Bound.  Operations: 4 B Hq D per (query, visible key) pair, about
// 4 B Hq D T (T + 1) / 2 for causal T = S; bytes: q, k, v and the output
// once.  At train/prefill lengths the operations dominate by ~3x for bf16
// at the tensor cores' rate, and by far more on the CUDA cores that this
// simple design uses.
//
// Plain C interface for ctypes: the entry point launches on the given
// stream, never synchronises, allocates nothing, and returns
// cudaGetLastError() (or the error of raising the shared-memory limit) so
// a refused launch is reported by the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kBQ = 64;            // query rows a block
constexpr int kBK = 64;            // keys a step (two a lane)
constexpr int kWarps = 8;
constexpr int kRows = kBQ / kWarps; // query rows a warp
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);  // exact: the bf16 bits are the high half
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// element strides (b, t, h) of a (B, T, H, D) operand whose D is contiguous
struct Strides {
  long long b, t, h;
};

template <int D>
struct Layout {
  static constexpr int kKRow = D + 4;            // padded staged K row (floats)
  static constexpr int kEpl = (D + 31) / 32;     // output columns a lane
  static constexpr size_t kQ = (size_t)kBQ * D;  // floats of each region
  static constexpr size_t kK = (size_t)kBK * kKRow;
  static constexpr size_t kV = (size_t)kBK * D;
  static constexpr size_t kP = (size_t)kWarps * kRows * kBK;
  static constexpr size_t smem = (kQ + kK + kV + kP) * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       Strides sq, Strides sk, Strides sv, int T_, int S, int Hq,
                       int G, int causal, int window, int q_offset, float scale) {
  using L = Layout<D>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + L::kQ;
  float* vs = ks + L::kK;
  float* ps = vs + L::kV;

  const int nqt = (T_ + kBQ - 1) / kBQ;
  const int qt = nqt - 1 - (int)(blockIdx.x % nqt);  // heavy tiles first
  const int bh = (int)(blockIdx.x / nqt);
  const int h = bh % Hq;
  const int b = bh / Hq;
  const int hk = h / G;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = qt * kBQ;
  const int rows = min(kBQ, T_ - q0);

  // the query tile, widened to f32 (rows past T are zero and never stored)
  const T* qb = q + b * sq.b + h * sq.h;
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    qs[i] = r < rows ? to_f32<T>(qb[(long long)(q0 + r) * sq.t + d]) : 0.0f;
  }

  // keys any row of the tile can see: [kbeg, kend)
  const long long qpos_lo = (long long)q0 + q_offset;
  const long long qpos_hi = (long long)q0 + rows - 1 + q_offset;
  long long kbeg = 0, kend = S;
  if (window > 0) kbeg = qpos_lo - window + 1 > 0 ? qpos_lo - window + 1 : 0;
  if (causal) kend = qpos_hi + 1 < S ? qpos_hi + 1 : S;

  float m[kRows], l[kRows], acc[kRows][L::kEpl];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < L::kEpl; ++i) acc[r][i] = 0.0f;
  }

  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  const float* qw = qs + warp * kRows * D;  // this warp's rows
  float* pw = ps + warp * kRows * kBK;

  for (long long k0 = kbeg; k0 < kend; k0 += kBK) {
    const int nk = (int)min((long long)kBK, kend - k0);
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int i = threadIdx.x; i < nk * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      ks[r * L::kKRow + d] = to_f32<T>(kb[(k0 + r) * sk.t + d]);
      vs[r * D + d] = to_f32<T>(vb[(k0 + r) * sv.t + d]);
    }
    __syncthreads();

    // scores of keys k0 + lane and k0 + lane + 32 for the warp's rows
    float s0[kRows], s1[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s0[r] = s1[r] = 0.0f;
    const float* k_0 = ks + lane * L::kKRow;
    const float* k_1 = ks + (lane + 32) * L::kKRow;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float4 a = *reinterpret_cast<const float4*>(k_0 + c);
      const float4 e = *reinterpret_cast<const float4*>(k_1 + c);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(qw + r * D + c);
        s0[r] = fmaf(x.x, a.x, s0[r]);
        s0[r] = fmaf(x.y, a.y, s0[r]);
        s0[r] = fmaf(x.z, a.z, s0[r]);
        s0[r] = fmaf(x.w, a.w, s0[r]);
        s1[r] = fmaf(x.x, e.x, s1[r]);
        s1[r] = fmaf(x.y, e.y, s1[r]);
        s1[r] = fmaf(x.z, e.z, s1[r]);
        s1[r] = fmaf(x.w, e.w, s1[r]);
      }
    }

    const long long kp0 = k0 + lane, kp1 = k0 + lane + 32;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = q0 + warp * kRows + r;
      const long long qpos = (long long)t + q_offset;
      const bool row_ok = t < T_;
      bool ok0 = row_ok && lane < nk;
      bool ok1 = row_ok && lane + 32 < nk;
      if (causal) {
        ok0 = ok0 && kp0 <= qpos;
        ok1 = ok1 && kp1 <= qpos;
      }
      if (window > 0) {
        ok0 = ok0 && kp0 > qpos - window;
        ok1 = ok1 && kp1 > qpos - window;
      }
      const float x0 = ok0 ? s0[r] * scale : kNegInf;
      const float x1 = ok1 ? s1[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(x0, x1)));
      const float alpha = expf(m[r] - m_new);
      const float p0 = ok0 ? expf(x0 - m_new) : 0.0f;
      const float p1 = ok1 ? expf(x1 - m_new) : 0.0f;
      l[r] = alpha * l[r] + warp_sum(p0 + p1);
      m[r] = m_new;
      pw[r * kBK + lane] = p0;
      pw[r * kBK + lane + 32] = p1;
#pragma unroll
      for (int i = 0; i < L::kEpl; ++i) acc[r][i] *= alpha;
    }
    __syncwarp();

    // acc += P . V over the staged keys
    for (int j = 0; j < nk; ++j) {
      float vj[L::kEpl];
#pragma unroll
      for (int i = 0; i < L::kEpl; ++i) {
        const int d = lane + 32 * i;
        vj[i] = (D >= 32 || d < D) ? vs[j * D + d] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = pw[r * kBK + j];
#pragma unroll
        for (int i = 0; i < L::kEpl; ++i) acc[r][i] = fmaf(p, vj[i], acc[r][i]);
      }
    }
    __syncwarp();
  }

  // out is contiguous (B, T, Hq, D)
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = q0 + warp * kRows + r;
    if (t >= T_) continue;
    const float denom = l[r] > 0.0f ? l[r] : 1.0f;
    T* ob = out + (((long long)b * T_ + t) * Hq + h) * D;
#pragma unroll
    for (int i = 0; i < L::kEpl; ++i) {
      const int d = lane + 32 * i;
      if (D >= 32 || d < D) ob[d] = from_f32<T>(acc[r][i] / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           const long long* strides, int B, int T_, int S, int Hq, int G,
           int causal, int window, int q_offset, cudaStream_t st) {
  const size_t smem = Layout<D>::smem;
  auto kern = flash_attention_kernel<T, D>;
  // raise the shared-memory limit once a device, so that a launch being
  // captured into a CUDA graph makes no other runtime call
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024 && (dev >= kMaxDevices || !raised[dev])) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) raised[dev] = true;
  }
  const long long nqt = (T_ + kBQ - 1) / kBQ;
  const long long blocks = (long long)B * Hq * nqt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  // D^-1/2 rounded once to f32, as the JAX package's Python-float constant
  const float scale = (float)(1.0 / std::sqrt((double)D));
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  kern<<<dim3((unsigned)blocks), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, sk, sv, T_, S, Hq, G, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out,
               const long long* strides, int B, int T_, int S, int Hq, int G, int D,
               int causal, int window, int q_offset, cudaStream_t st) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, out, strides, B, T_, S, Hq, G, causal, window, q_offset, st);
    case 16: return launch<T, 16>(q, k, v, out, strides, B, T_, S, Hq, G, causal, window, q_offset, st);
    case 32: return launch<T, 32>(q, k, v, out, strides, B, T_, S, Hq, G, causal, window, q_offset, st);
    case 64: return launch<T, 64>(q, k, v, out, strides, B, T_, S, Hq, G, causal, window, q_offset, st);
    case 128: return launch<T, 128>(q, k, v, out, strides, B, T_, S, Hq, G, causal, window, q_offset, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, T, Hq, D), k/v (B, S, Hq/G, D) of one type, f32 (is_bf16 = 0) or
// bf16 (is_bf16 = 1), each with a contiguous last dimension and element
// strides (b, t, h) given in strides[0..2] (q), [3..5] (k), [6..8] (v);
// out contiguous (B, T, Hq, D).  D in {8, 16, 32, 64, 128}; the wrapper
// checks the rest.
int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                          const long long* strides, int B, int T, int S, int Hq,
                          int G, int D, int causal, int window, int q_offset,
                          int is_bf16, void* stream) {
  if (B < 1 || T < 1 || S < 1 || Hq < 1 || G < 1 || Hq % G) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? dispatch_d<__nv_bfloat16>(q, k, v, out, strides, B, T, S, Hq, G, D,
                                         causal, window, q_offset, st)
             : dispatch_d<float>(q, k, v, out, strides, B, T, S, Hq, G, D, causal,
                                 window, q_offset, st);
}

}  // extern "C"
