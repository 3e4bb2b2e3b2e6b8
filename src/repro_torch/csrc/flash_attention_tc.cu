// Forward flash attention in bf16 on Hopper's tensor cores (sm_90a,
// wgmma): the cache-free train and prefill attention core, GQA, causal or
// bidirectional, sliding window, query offset.
//
// Replaces the Pallas TPU kernel of the JAX package, for bf16 operands:
//   flash_attention_tc_kernel<Dc, kExact>  <- src/repro/kernels/flash_attention/kernel.py _flash_kernel
// (reached through ops.flash_attention <- models/attention.attn_apply(...,
// use_kernel=True) on the cache-free branch with T >= 128, once a layer).
// f32 operands go to flash_attention_tf32.cu's 3xTF32 kernel, which holds
// the 2e-5 f32 limit; the route is a fixed function of the type
// (kernels/flash_attention/kernel.py ROUTES).
//
// Function.  For q (B, T, Hq, D), k and v (B, S, Hkv, D) in bf16, Hq =
// G * Hkv, read through their strides in the model layout:
//   out[b, t, h] = sum_s p_s v[b, s, h / G] / sum_s p_s,
//   p_s = exp(q[b, t, h] . k[b, s, h / G] * D^-1/2 - m)
// over the keys s that row t sees: s < S, and with qpos = t + q_offset,
// s <= qpos when causal and s > qpos - window when window > 0.  Masking as
// kernel.py:78-98: a masked logit is -1e30 and its p exactly 0, the running
// (m, l) and the output accumulators are f32, and the end divides by l
// where l > 0 and by 1 elsewhere, so a row that sees no key gives 0.  The
// logits are exact f32 sums of exact bf16 x bf16 products; p is rounded to
// bf16 for the P.V product (the rounding the plain _sdpa makes with
// probs.to(v.dtype)), while l sums the f32 p.  The output is rounded once,
// from f32, to bf16.
//
// Design.  One block owns one (b, h, 128-row query tile) and loops over
// key tiles itself (64 keys, 128 at D 128); blocks never share state.  Its
// two consumer warpgroups own 64 query rows each, wgmma's M.  The query
// tile is staged once into shared memory; K and V tiles go through a
// three-stage ring filled by 16-byte cp.async copies (zero-filled past the
// last key) that every thread shares, so the next tile is in flight while
// the current one is multiplied.  Per-stage mbarriers replace a barrier of
// the whole block: a thread's copies arrive on the stage's "full" barrier
// as they land, and each thread arrives on its "empty" barrier once its
// warpgroup is done with the tile, so a warpgroup may run a tile ahead of
// the other.  Every operand sits in shared memory as 64-column blocks of
// 128-byte rows in the 128-byte swizzle that the wgmma descriptors name
// (16-byte chunk c of row r at chunk c ^ (r % 8)), so the copies and the
// tensor cores meet no bank conflicts.  Per tile and warpgroup:
//   S = Q.K^T: wgmma m64n64k16 for each 64 keys, both operands K-major from
//     shared memory, D/16 steps (D 8 reads the zero columns 8..15: zeros add
//     exactly 0);
//   O += P.V of the previous tile, issued right after S (FA3's intra-
//     warpgroup pipelining): P in bf16 registers as wgmma's A operand (the
//     S accumulator layout is the A fragment layout), V as B from shared
//     memory in MN-major layout (the transpose bit), m64n64k16 for each 64
//     columns of D; O stays in f32 registers;
//   online softmax on the accumulator fragments while that P.V runs: a
//     thread holds parts of two rows, so the row max takes two shuffles
//     within the quad and the row sum is kept per thread until the end; the
//     mask is applied only on tiles that straddle the causal diagonal, the
//     window's edge or S (a masked logit becomes -inf there, so 2^(-inf) = 0
//     is its p); then O is rescaled and P packed to bf16.
// Each branch retires the products it issued before it reads O, and the
// warpgroup index is made warp-uniform, so that ptxas keeps the products
// asynchronous.  D < 64 pads the shared rows to 64 columns with zeros (the
// padded output columns are never stored).  Head widths: D 8, 16, 32, 64
// and 128 have exact instantiations; any other multiple of 8 up to 256
// runs in the width class of 64, 128 or 256 above it, its shared rows
// zeroed past D (zero columns add exactly 0 to Q.K^T, and the P.V columns
// past D are never stored).  At 256 a 64-key K or V tile is 32 KB, so
// three stages of both and the 128-row query tile would not fit in shared
// memory: K and V pass through rings of their own, two stages each (197,696
// bytes), V of a tile staged an iteration before its P.V; the O
// accumulator is 128 f32 registers a thread.  As in flash_attention.cu: the
// key loop runs from the window's left edge of the tile's first row to the
// causal diagonal of its last row, a warpgroup skips the tiles none of its
// rows sees, and heavy query tiles are launched first.  A view whose base
// or strides are not 16-byte multiples is staged by plain loads and stores
// instead of cp.async.
//
// Bound.  Operations: 4 B Hq D per (query, visible key) pair, about
// 4 B Hq D T (T + 1) / 2 for causal T = S, at 989 TFLOP/s dense bf16; at
// train/prefill lengths that is ~3x the time of moving q, k, v and the
// output once.  Not yet done (FA3's remaining steps): a producer warp with
// TMA, the two warpgroups' softmax phases scheduled against each other's
// products (ping-pong), and 128-key products as one m64n128k16.
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

constexpr float kNegInf = -1e30f;    // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;

// element strides (b, t, h) of a (B, T, H, D) operand whose D is contiguous
struct Strides {
  long long b, t, h;
};


// The tiles of width Dc: an exact head width (8, 16, 32, 64, 128) or a
// width class (64, 128, 256) whose rows are zero past the true D.
template <int Dc>
struct Shape {
  // Dc 256: K and V in rings of their own, two stages each (a query tile of
  // 128 rows and three 64 KB K/V stages would not fit in shared memory);
  // else one ring of three K/V stages: tile it + 1 lands while P.V of it - 1
  // runs
  static constexpr bool kSplit = Dc == 256;
  static constexpr int kStages = kSplit ? 2 : 3;
  static constexpr int kBars = (kSplit ? 4 : 2) * kStages;  // full and empty mbarriers
  static constexpr int kWG = 2;                     // consumer warpgroups a block
  static constexpr int kBQ = 64 * kWG;              // query rows a block
  static constexpr int kThreads = 128 * kWG;
  // keys a tile: 128 at Dc 128 (one block an SM either way, by registers),
  // else 64 (two blocks an SM up to Dc 64)
  static constexpr int kBK = Dc == 128 ? 128 : 64;
  static constexpr int kNB = Dc < 64 ? 1 : Dc / 64;  // 64-column blocks of a row
  static constexpr int kKS = (Dc + 15) / 16;         // k-steps of Q.K^T
  static constexpr int kChunks = Dc / 8;             // 16-byte chunks of a row
  static constexpr int kHalves = kBK / 64;           // 64-key products of a tile
  static constexpr int kQRegion = kNB * 64 * 128;    // 64 query rows
  static constexpr int kKVRegion = kNB * kBK * 128;  // one K or V tile
  static constexpr size_t smem =
      1024 + (size_t)kWG * kQRegion + (size_t)kStages * 2 * kKVRegion + kBars * 8;
  static constexpr int kMinBlocks = Dc <= 64 ? 2 : 1;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src, or 16 zero bytes when bytes is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// one arrival, once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// shared-memory writes of this thread (generic proxy) become visible to
// the tensor cores' reads (async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; byte offsets >> 4
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  uint64_t d = 0;
  d |= (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

// d (64 x 64, f32) (+)= A (64 x 16, K-major, shared) . B (16 x 64, K-major, shared)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers) . B (16 x 64, MN-major, shared)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the SFU; 2^-inf = +0, so a masked logit of -inf gives p = 0 exactly
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stage this thread's share of `rows` rows of C 16-byte chunks (rows >=
// valid are zero) into a swizzled region: 16-byte chunk c of row r lands in
// column block c / 8 (blocks `rows` x 128 bytes apart) at chunk (c % 8) ^
// (r % 8).  With `aligned` every write is a cp.async; otherwise plain loads
// and stores.
template <int kThreads>
__device__ __forceinline__ void stage_rows(uint8_t* region, const __nv_bfloat16* src,
                                           long long row_stride, int valid, int rows, int C,
                                           bool aligned) {
  const uint32_t base = smem_addr(region);
  for (int i = threadIdx.x; i < rows * C; i += kThreads) {
    const int r = i / C, c = i - r * C;
    const uint32_t off = (c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
    if (aligned) {  // rows >= valid are zero-filled
      cp_async16(base + off, src + (r < valid ? r * row_stride + c * 8 : 0), r < valid ? 16 : 0);
    } else if (r >= valid) {
      *reinterpret_cast<uint4*>(region + off) = make_uint4(0, 0, 0, 0);
    } else {
      const uint16_t* e = reinterpret_cast<const uint16_t*>(src + r * row_stride + c * 8);
      uint4 w;
      w.x = (uint32_t)e[0] | ((uint32_t)e[1] << 16);
      w.y = (uint32_t)e[2] | ((uint32_t)e[3] << 16);
      w.z = (uint32_t)e[4] | ((uint32_t)e[5] << 16);
      w.w = (uint32_t)e[6] | ((uint32_t)e[7] << 16);
      *reinterpret_cast<uint4*>(region + off) = w;
    }
  }
}

// O += P . V for the tile whose V sits at v_sh: P from registers (A),
// V from shared memory in MN-major layout (B)
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[Shape<D>::kNB][32],
                                        const uint32_t (&pa)[Shape<D>::kBK / 16][4],
                                        uint32_t v_sh) {
  constexpr int kBK = Shape<D>::kBK;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
    for (int nb = 0; nb < Shape<D>::kNB; ++nb)
      wgmma_rs(o[nb], pa[kk],
               desc_sw128(v_sh + nb * kBK * 128 + kk * 2048, kBK * 128, 1024));
  }
  wgmma_commit();
}

// kExact: the head width is Dc; else D_, a multiple of 8 below Dc, whose
// rows are staged into zeroed columns.  The exact widths keep their own
// instantiation: class 64 and 128 at D 64 and 128 (a run-time D, the chunk
// loops no longer unrolled) took 18 % and 25 % longer at tinyllama-1.1b's
// and qwen2-1.5b's prefill (kernels/timing.py, NVIDIA H100 80GB HBM3).
template <int Dc, bool kExact>
__global__ void __launch_bounds__(Shape<Dc>::kThreads, Shape<Dc>::kMinBlocks)
flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ out, Strides sq, Strides sk,
                          Strides sv, int T_, int S, int Hq, int G, int D_, int causal,
                          int window, int q_offset, float scale_log2, int aligned) {
  using Sh = Shape<Dc>;
  constexpr int kNB = Sh::kNB, kH = Sh::kHalves, kBK = Sh::kBK;
  constexpr int kWG = Sh::kWG, kBQ = Sh::kBQ, kThreads = Sh::kThreads;
  constexpr int kStages = Sh::kStages;
  const int D = kExact ? Dc : D_;
  const int C = kExact ? Sh::kChunks : D / 8;  // 16-byte chunks of a row
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 bytes of shared address
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;                         // kWG regions of 64 query rows
  // stage s: K, then V (kSplit: the K ring, then the V ring)
  uint8_t* kvs = smem + kWG * Sh::kQRegion;
  auto k_at = [&](int st) {
    return kvs + (Sh::kSplit ? st : 2 * st) * Sh::kKVRegion;
  };
  auto v_at = [&](int st) {
    return kvs + (Sh::kSplit ? kStages + st : 2 * st + 1) * Sh::kKVRegion;
  };
  // full[s]: the stage's tile (kSplit: its K) has landed; empty[s]: every
  // thread is done with it; kSplit: fullV[s], emptyV[s] the same for V
  uint64_t* bars = reinterpret_cast<uint64_t*>(kvs + kStages * 2 * Sh::kKVRegion);
  const uint32_t full0 = smem_addr(bars), empty0 = smem_addr(bars + kStages);
  const uint32_t fullv0 = smem_addr(bars + 2 * kStages), emptyv0 = smem_addr(bars + 3 * kStages);

  const int nqt = (T_ + kBQ - 1) / kBQ;
  const int qt = nqt - 1 - (int)(blockIdx.x % nqt);  // heavy tiles first
  const int bh = (int)(blockIdx.x / nqt);
  const int h = bh % Hq;
  const int b = bh / Hq;
  const int hk = h / G;
  const int q0 = qt * kBQ;
  const int rows = min(kBQ, T_ - q0);

  // warp-uniform as the compiler sees it, so that it keeps the wgmma
  // asynchronous inside the branches that depend on the warpgroup
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  if (Dc < 64 || D < Dc) {  // padded columns must read as zero
    for (int i = threadIdx.x; i < (int)((Sh::smem - 1024 - Sh::kBars * 8) / 16); i += kThreads)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
    fence_async_shared();
  }
  if (threadIdx.x == 0) {
    for (int st = 0; st < Sh::kBars; ++st) mbar_init(full0 + 8 * st, kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // keys any row of the block can see: [kbeg, kend)
  const long long qpos_lo = (long long)q0 + q_offset;
  const long long qpos_hi = (long long)q0 + rows - 1 + q_offset;
  long long kbeg = 0, kend = S;
  if (window > 0) kbeg = qpos_lo - window + 1 > 0 ? qpos_lo - window + 1 : 0;
  if (causal) kend = qpos_hi + 1 < S ? qpos_hi + 1 : S;
  const int ntiles = kend > kbeg ? (int)((kend - kbeg + kBK - 1) / kBK) : 0;

  // this warpgroup's rows and the keys they see: [wbeg, wend)
  const int wrows = max(0, min(64, rows - 64 * wg));
  const long long wq_lo = qpos_lo + 64 * wg;
  const long long wq_hi = wq_lo + wrows - 1;
  long long wbeg = 0, wend = S;
  if (window > 0) wbeg = wq_lo - window + 1 > 0 ? wq_lo - window + 1 : 0;
  if (causal) wend = wq_hi + 1 < S ? wq_hi + 1 : S;

  const __nv_bfloat16* kb = k + b * sk.b + hk * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + hk * sv.h;
  // every thread copies its share of tile it's K (parts & 1) and V (parts &
  // 2) into stage it % kStages, then arrives on the stage's full barrier
  // (kSplit: K's, then V's)
  auto arrive_full = [&](uint32_t bar) {
    if (aligned) {
      mbar_arrive_cp_async(bar);
    } else {
      fence_async_shared();
      mbar_arrive(bar);
    }
  };
  auto stage_tile = [&](int it, int parts) {
    const long long k0 = kbeg + (long long)it * kBK;
    const int valid = (int)min((long long)kBK, kend - k0);
    const int st = it % kStages;
    if (parts & 1) {
      stage_rows<kThreads>(k_at(st), kb + k0 * sk.t, sk.t, valid, kBK, C, aligned);
      if (Sh::kSplit) arrive_full(full0 + 8 * st);
    }
    if (parts & 2) {
      stage_rows<kThreads>(v_at(st), vb + k0 * sv.t, sv.t, valid, kBK, C, aligned);
      arrive_full((Sh::kSplit ? fullv0 : full0) + 8 * st);
    }
  };
  if (ntiles > 0) {  // the query tile lands with tile 0
    const __nv_bfloat16* qb = q + b * sq.b + h * sq.h + (long long)q0 * sq.t;
    for (int w = 0; w < kWG; ++w)
      stage_rows<kThreads>(qs + w * Sh::kQRegion, qb + (long long)w * 64 * sq.t, sq.t,
                           rows - 64 * w, 64, C, aligned);
    stage_tile(0, 3);
  }

  float o[kNB][32];
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[nb][i] = 0.0f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;  // rows g, g + 8
  uint32_t pa[kBK / 16][4];  // bf16 P of the last tile, the A operand of P.V
  bool pending = false;      // pa's P.V is not issued yet

  const uint32_t q_sh = smem_addr(qs + wg * Sh::kQRegion);
  const long long qpos_a = wq_lo + 16 * warp + g;  // this thread's two rows
  const long long qpos_b = qpos_a + 8;

  // Per tile and warpgroup, after FA3's intra-warpgroup pipelining: issue
  // S = Q.K^T of this tile, then P.V of the previous one, and run this
  // tile's softmax while that product is on the tensor cores.
  // No barrier of the whole block inside the loop: a warpgroup may run a
  // tile ahead of the other, so that their softmax phases need not collide.
  // kSplit: tile it's K is released at the end of iteration it and tile it
  // + 1's K staged at the start of iteration it, as the shared ring does;
  // tile it - 1's V, read by the P.V issued in iteration it, is released at
  // its end, and tile it + 1's V staged then, a whole iteration before its
  // P.V
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      // stage (it + 1) % kStages last held tile it + 1 - kStages: every
      // thread has released it (its K) at the end of its iteration it - 1
      if (it + 1 >= kStages)
        mbar_wait(empty0 + 8 * ((it + 1) % kStages), ((it + 1) / kStages - 1) & 1);
      stage_tile(it + 1, Sh::kSplit ? 1 : 3);
    }
    mbar_wait(full0 + 8 * (it % kStages), (it / kStages) & 1);
    if (Sh::kSplit && it >= 1)  // the V of tile it - 1, for its P.V
      mbar_wait(fullv0 + 8 * ((it - 1) % kStages), ((it - 1) / kStages) & 1);
    fence_async_shared();  // the landed tile, to the tensor cores' reads

    const long long k0 = kbeg + (long long)it * kBK;
    const uint32_t kv_sh = smem_addr(k_at(it % kStages));
    const uint32_t vprev_sh = smem_addr(v_at((it + kStages - 1) % kStages));
    if (wrows > 0 && k0 < wend && k0 + kBK > wbeg) {
      float s[kH][32];
#pragma unroll
      for (int hf = 0; hf < kH; ++hf) {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[hf][i] = 0.0f;
        fence_regs(s[hf]);
      }
      wgmma_fence();
#pragma unroll
      for (int hf = 0; hf < kH; ++hf) {
#pragma unroll
        for (int kk = 0; kk < Sh::kKS; ++kk)
          wgmma_ss(s[hf],
                   desc_sw128(q_sh + (kk >> 2) * 64 * 128 + (kk & 3) * 32, 16, 1024),
                   desc_sw128(kv_sh + (kk >> 2) * kBK * 128 + hf * 64 * 128 + (kk & 3) * 32,
                              16, 1024),
                   kk > 0);
      }
      wgmma_commit();
      // the softmax of this tile: p (f32) in s, the running (m, l), and the
      // factors al_a, al_b that rescale o to the new maxima
      float al_a, al_b;
      auto softmax = [&]() {
        // mask where the tile straddles an edge (a masked logit is -inf here,
        // so the row max ignores it and 2^(-inf) = 0 is its p), row maxima;
        // s[hf][4j + e] is row g, key k0 + 64 hf + 8j + 2 t4 + e; s[hf][4j + 2 + e] row g + 8
        const bool full = k0 + kBK <= S && (!causal || k0 + kBK - 1 <= wq_lo) &&
                          (window <= 0 || k0 > wq_hi - window);
        // four partial maxima and sums a row: short dependence chains
        float mxa[4], mxb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) mxa[i] = mxb[i] = -INFINITY;
#pragma unroll
        for (int hf = 0; hf < kH; ++hf) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (!full) {
                const long long key = k0 + 64 * hf + 8 * j + 2 * t4 + e;
                bool oka = key < S, okb = key < S;
                if (causal) {
                  oka = oka && key <= qpos_a;
                  okb = okb && key <= qpos_b;
                }
                if (window > 0) {
                  oka = oka && key > qpos_a - window;
                  okb = okb && key > qpos_b - window;
                }
                if (!oka) s[hf][4 * j + e] = -INFINITY;
                if (!okb) s[hf][4 * j + 2 + e] = -INFINITY;
              }
              mxa[(2 * j + e) & 3] = fmaxf(mxa[(2 * j + e) & 3], s[hf][4 * j + e]);
              mxb[(2 * j + e) & 3] = fmaxf(mxb[(2 * j + e) & 3], s[hf][4 * j + 2 + e]);
            }
          }
        }
        float mx_a = fmaxf(fmaxf(mxa[0], mxa[1]), fmaxf(mxa[2], mxa[3]));
        float mx_b = fmaxf(fmaxf(mxb[0], mxb[1]), fmaxf(mxb[2], mxb[3]));
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
        // the running maxima stay >= -1e30, as the TPU kernel's (a row that has
        // seen no key keeps m = -1e30, alpha = 1 and p = 0)
        const float mn_a = fmaxf(m_a, mx_a * scale_log2), mn_b = fmaxf(m_b, mx_b * scale_log2);
        al_a = ex2(m_a - mn_a);
        al_b = ex2(m_b - mn_b);
        m_a = mn_a;
        m_b = mn_b;
        float sa[4] = {0.0f, 0.0f, 0.0f, 0.0f}, sb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int hf = 0; hf < kH; ++hf) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float pa_ = ex2(fmaf(s[hf][4 * j + e], scale_log2, -mn_a));
              const float pb_ = ex2(fmaf(s[hf][4 * j + 2 + e], scale_log2, -mn_b));
              s[hf][4 * j + e] = pa_;
              s[hf][4 * j + 2 + e] = pb_;
              sa[(2 * j + e) & 3] += pa_;
              sb[(2 * j + e) & 3] += pb_;
            }
          }
        }
        l_a = l_a * al_a + ((sa[0] + sa[1]) + (sa[2] + sa[3]));
        l_b = l_b * al_b + ((sb[0] + sb[1]) + (sb[2] + sb[3]));
      };
      // each branch retires every product it issued before o is read, so
      // that the compiler keeps the products asynchronous
      if (pending) {
        issue_pv<Dc>(o, pa, vprev_sh);
        wgmma_wait<1>();  // S has landed; P.V of the previous tile runs on
#pragma unroll
        for (int hf = 0; hf < kH; ++hf) fence_regs(s[hf]);
        softmax();
        wgmma_wait<0>();  // the previous tile's P.V is in o
      } else {
        wgmma_wait<0>();
#pragma unroll
        for (int hf = 0; hf < kH; ++hf) fence_regs(s[hf]);
        softmax();
      }
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        fence_regs(o[nb]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[nb][4 * j + 0] *= al_a;
          o[nb][4 * j + 1] *= al_a;
          o[nb][4 * j + 2] *= al_b;
          o[nb][4 * j + 3] *= al_b;
        }
      }
      // key chunk jj of the tile is half of k-step jj / 2: A registers 0, 1
      // (jj even) or 2, 3
#pragma unroll
      for (int hf = 0; hf < kH; ++hf) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int jj = 8 * hf + j;
          pa[jj >> 1][(jj & 1) * 2 + 0] = pack_bf16(s[hf][4 * j + 0], s[hf][4 * j + 1]);
          pa[jj >> 1][(jj & 1) * 2 + 1] = pack_bf16(s[hf][4 * j + 2], s[hf][4 * j + 3]);
        }
      }
      pending = true;
    } else if (pending) {  // past this warpgroup's last tile: flush
      wgmma_fence();
      issue_pv<Dc>(o, pa, vprev_sh);
      wgmma_wait<0>();
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) fence_regs(o[nb]);
      pending = false;
    }
    if constexpr (Sh::kSplit) {
      // tile it's K and tile it - 1's V are done with; V of tile it + 1 goes
      // into the stage that V of tile it - 1 held
      mbar_arrive(empty0 + 8 * (it % kStages));
      if (it >= 1) mbar_arrive(emptyv0 + 8 * ((it - 1) % kStages));
      if (it + 1 < ntiles) {
        if (it + 1 >= kStages)
          mbar_wait(emptyv0 + 8 * ((it + 1) % kStages), ((it + 1) / kStages - 1) & 1);
        stage_tile(it + 1, 2);
      }
    } else {
      // tile it - 1 is done with (its P.V has retired, or never ran)
      if (it >= 1) mbar_arrive(empty0 + 8 * ((it - 1) % kStages));
    }
  }
  if (pending) {
    if (Sh::kSplit)
      mbar_wait(fullv0 + 8 * ((ntiles - 1) % kStages), ((ntiles - 1) / kStages) & 1);
    wgmma_fence();
    issue_pv<Dc>(o, pa, smem_addr(v_at((ntiles - 1) % kStages)));
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) fence_regs(o[nb]);
  }

  if (wrows == 0) return;
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float den_a = l_a > 0.0f ? l_a : 1.0f;
  const float den_b = l_b > 0.0f ? l_b : 1.0f;
  // out is contiguous (B, T, Hq, D)
  const int t_a = q0 + 64 * wg + 16 * warp + g, t_b = t_a + 8;
  __nv_bfloat16* oa = out + (((long long)b * T_ + t_a) * Hq + h) * D;
  __nv_bfloat16* ob = out + (((long long)b * T_ + t_b) * Hq + h) * D;
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = nb * 64 + 8 * j + 2 * t4;
      if (col >= D) continue;
      if (t_a < T_)
        *reinterpret_cast<uint32_t*>(oa + col) =
            pack_bf16(o[nb][4 * j + 0] / den_a, o[nb][4 * j + 1] / den_a);
      if (t_b < T_)
        *reinterpret_cast<uint32_t*>(ob + col) =
            pack_bf16(o[nb][4 * j + 2] / den_b, o[nb][4 * j + 3] / den_b);
    }
  }
}

template <int Dc, bool kExact>
int launch(const void* q, const void* k, const void* v, void* out, const long long* strides,
           int B, int T_, int S, int Hq, int G, int D, int causal, int window, int q_offset,
           int aligned, int scale_d, cudaStream_t st) {
  using Sh = Shape<Dc>;
  const size_t smem = Sh::smem;
  auto kern = flash_attention_tc_kernel<Dc, kExact>;
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
  const long long nqt = (T_ + Sh::kBQ - 1) / Sh::kBQ;
  const long long blocks = (long long)B * Hq * nqt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  // D^-1/2 of the true head width rounded once to f32, as the JAX package's
  // Python-float constant, then folded with log2(e) for exp2
  const float scale = (float)(1.0 / std::sqrt((double)scale_d));
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  kern<<<dim3((unsigned)blocks), Sh::kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), sq, sk, sv,
      T_, S, Hq, G, D, causal, window, q_offset, scale * kLog2e, aligned);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, T, Hq, D), k/v (B, S, Hq/G, D), bf16, each with a contiguous last
// dimension and element strides (b, t, h) given in strides[0..2] (q),
// [3..5] (k), [6..8] (v); out contiguous (B, T, Hq, D) bf16.  aligned = 1
// when every base pointer and stride is a multiple of 16 bytes (cp.async),
// 0 otherwise.  D a multiple of 8 from 8 to 256 (the wrapper pads other
// widths with zero columns); scale_d the true head width, whose D^-1/2
// scales the logits.  The wrapper checks the rest.
int repro_flash_attention_tc(const void* q, const void* k, const void* v, void* out,
                             const long long* strides, int B, int T, int S, int Hq, int G,
                             int D, int causal, int window, int q_offset, int aligned,
                             int scale_d, void* stream) {
  if (B < 1 || T < 1 || S < 1 || Hq < 1 || G < 1 || Hq % G || D < 8 || D > 256 || D % 8 ||
      scale_d < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_TC(DC, EXACT) \
  launch<DC, EXACT>(q, k, v, out, strides, B, T, S, Hq, G, D, causal, window, q_offset, \
                    aligned, scale_d, st)
  switch (D) {  // the exact widths of every config before the domain was widened
    case 8: return REPRO_TC(8, true);
    case 16: return REPRO_TC(16, true);
    case 32: return REPRO_TC(32, true);
    case 64: return REPRO_TC(64, true);
    case 128: return REPRO_TC(128, true);
    default: break;
  }
  if (D < 64) return REPRO_TC(64, false);
  if (D < 128) return REPRO_TC(128, false);
  return REPRO_TC(256, false);
#undef REPRO_TC
}

// dynamic shared memory of a launch at head width D (bytes), or -1
int repro_flash_attention_tc_smem(int D) {
  if (D < 8 || D > 256 || D % 8) return -1;
  switch (D) {
    case 8: return (int)Shape<8>::smem;
    case 16: return (int)Shape<16>::smem;
    case 32: return (int)Shape<32>::smem;
    default: break;
  }
  return (int)(D <= 64 ? Shape<64>::smem : D <= 128 ? Shape<128>::smem : Shape<256>::smem);
}

}  // extern "C"
