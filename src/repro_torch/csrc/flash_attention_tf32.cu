// Forward flash attention in f32 on Hopper's tensor cores (sm_90a, wgmma
// TF32, three products a term: "3xTF32"): the cache-free train and prefill
// attention core, GQA, causal or bidirectional, sliding window, query
// offset.
//
// Replaces the Pallas TPU kernel of the JAX package, for f32 operands:
//   flash_tf32_prep_kernel<Dc> + flash_attention_tf32_kernel<Dc>
//       (flash_attention_tf32_wide_kernel<256> above D 128)
//       <- src/repro/kernels/flash_attention/kernel.py _flash_kernel
// (reached through ops.flash_attention <- models/attention.attn_apply(...,
// use_kernel=True) on the cache-free branch with T >= 128, once a layer;
// every f32-compute config takes it).  bf16 operands go to
// flash_attention_tc.cu; the route is a fixed function of the type
// (kernels/flash_attention/kernel.py ROUTES).
//
// Function.  For q (B, T, Hq, D), k and v (B, S, Hkv, D) in f32, Hq =
// G * Hkv, read through their strides in the model layout:
//   out[b, t, h] = sum_s p_s v[b, s, h / G] / sum_s p_s,
//   p_s = exp(q[b, t, h] . k[b, s, h / G] * D^-1/2 - m)
// over the keys s that row t sees: s < S, and with qpos = t + q_offset,
// s <= qpos when causal and s > qpos - window when window > 0.  Masking as
// kernel.py:78-98: a masked logit is -1e30 (-inf on tiles that straddle an
// edge) and its p exactly 0, the running (m, l) and the output
// accumulators are f32, and the end divides by l where l > 0 and by 1
// elsewhere, so a row that sees no key gives 0.
//
// 3xTF32.  A TF32 product keeps 11 significant bits of each factor, which
// alone would miss the 2e-5 f32 limit by far.  Each f32 value v is split
// into hi = tf32(v) and lo = tf32(v - hi), both rounded to nearest (ties
// to even), so that |v - hi| <= 2^-11 |v| and |v - hi - lo| <= 2^-22 |v|;
// every product of two TF32 values is exact in f32.  A product x.y is
// taken as lo_x.hi_y + hi_x.lo_y + hi_x.hi_y, in that order.  What it drops
// is lo_x.lo_y and the split's remainders: per term at most 3.01 2^-22
// |x_j y_j| = 12.04 2^-24 |x_j y_j|.  The tensor cores sum in f32 but round
// toward zero, so a long chain of their sums drifts one way; the kernel
// keeps each chain short and adds the chains in f32 with rounding to
// nearest:
//   a logit: each k-step's 3 products (8 head columns) go into a fresh
//     accumulator, at most 3 truncations of 2^-23 of the k-step's absolute
//     sum, and the D/8 k-steps are added with D/8 - 1 roundings of 2^-24
//     of the running sum, so
//       |s~ - s| <= (18.04 + D/8) 2^-24 D^-1/2 sum_j |q_j k_j|,
//     within the (D + 1) 2^-24 D^-1/2 sum_j |q_j k_j| of an f32 dot
//     product at D >= 32;
//   a P.V entry: each 64-key tile's 24 products (8 k-steps of 3) go into a
//     fresh accumulator and o = alpha o + P.V is one f32 fma, so a tile adds
//     at most (12.04 + 2 . 24 + 1) 2^-24 = 3.6e-6 of sum_s p_s |v_s|, i.e.
//     relative to l at most 3.6e-6 max_s |v_s| a tile;
//   a logit error e moves the output by at most 2 e max_s |v_s| (p_s / l
//     moves by e relative at most).
// Those bounds are worst cases of aligned signs; at N(0, 1) inputs the
// errors are random-signed and far smaller.  Why not one chain: at q, k ~
// N(0, 4), T 2048, a single chain of truncating sums over all of D and all
// tiles reads 3.8e-5 from the exact (f64) answer, past the 2e-5 limit,
// where these short chains read 4.1e-6 and f32 attention_ref 8.5e-6
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6).
// tests/test_torch_flash_attention.py emulates the arithmetic on the CPU
// and holds it to the JAX kernel and attention_ref, with a 1xTF32 control
// that must fail.
//
// Design.  TF32 wgmma has no transpose bit: both operands must be K-major.
// S = Q.K^T is K-major as it stands (a key's row is D-contiguous); P.V is
// not, because V's rows are D-contiguous, so V has to be transposed.
//   flash_tf32_prep_kernel: once a call, one block a (b, hkv, 64-key tile)
//     writes the tile into device memory exactly as shared memory will hold
//     it: K as hi and lo planes, 32-column blocks of 64 keys x 128 bytes,
//     and V^T as hi and lo planes, 64-row blocks (a row a head column d,
//     zero past D) of 2 x 32 keys; every block in the 128-byte swizzle that
//     the wgmma descriptors name (16-byte chunk c of row r at chunk c ^ (r %
//     8)), zero past S.  Within each group of 8 keys V^T holds the keys in
//     the order [0, 2, 4, 6, 1, 3, 5, 7]: the S accumulator fragment holds
//     keys 2 t4 and 2 t4 + 1 of each 8-key chunk, where the TF32 A fragment
//     wants positions t4 and t4 + 4, so with V^T so ordered P passes from
//     the accumulators to wgmma's A registers with no shuffle (the mask
//     stays on S's natural key order).  Writes are coalesced (one thread an
//     output float); reads of k, v go through the cache.
//   flash_attention_tf32_kernel: one block owns one (b, h, query tile) of
//     64 rows a consumer warpgroup (two warpgroups, one at D 128, where a
//     tile is 128 KB) and loops over the key tiles itself; blocks never
//     share state.  The query tile is read once, split into hi and lo
//     planes in shared memory (wgmma's A from shared memory: the Q
//     fragments of both planes would take D registers a thread).  Key tiles
//     pass through a ring in shared memory (two stages; one at D 128) as
//     two bulk copies a tile (the TMA, no tensor map: the prepared tile is
//     contiguous), K and V^T each on its own "full" mbarrier, so the next
//     tile's K lands while this tile's softmax and P.V run and its V^T while
//     the next S runs; thread 0 refills a stage once every thread has
//     arrived on its "empty" mbarrier.  Per tile and warpgroup:
//       S = Q.K^T: 3 wgmma m64n64k8 TF32 (lo.hi, hi.lo, hi.hi) for each 8
//         head columns, both operands from shared memory, into one of two
//         fresh accumulators, each k-step added to S while the next runs;
//       the online softmax on the accumulator fragments, as
//         flash_attention_tc.cu does it (a thread holds parts of rows g and
//         g + 8; the row max takes two shuffles within the quad; p = 2^(s
//         scale log2(e) - m); the mask only on tiles that straddle the
//         causal diagonal, the window's edge or S);
//       P split into hi and lo in registers as wgmma's A fragments;
//       P.V: 3 wgmma m64n64k8 TF32 (P lo.V hi, P hi.V lo, P hi.V hi) for
//         each 8 keys and 64 head columns, V^T from shared memory, into a
//         fresh accumulator; then O = alpha O + P.V.
//     The key loop runs over whole 64-key tiles (the prepared ones) from the
//     window's left edge of the tile's first row to the causal diagonal of
//     its last row, a warpgroup skips the tiles none of its rows sees, and
//     heavy query tiles are launched first.  D < 64 computes 64 output
//     columns against V^T rows that the prep wrote as zero; the padded
//     columns are never stored.
//   Head widths: D 8, 16 and 32 run tiles of their own width; any other
//     multiple of 8 up to 128 runs in the width class of 64 or 128 at or
//     above it (Q staged zero past D, K and V^T written zero past D by the
//     prep: the extra k-steps add exact zeros).  Above 128 (class 256) the
//     tiles do not fit: Q's hi and lo planes alone are 128 KB at 64 rows,
//     and a 64-key tile of K and V^T is 256 KB.  There
//     flash_attention_tf32_wide_kernel streams each tile as eight 32 KB
//     parts (K's 64-column quarters, then V^T's 64-row quarters, each hi
//     then lo) through a ring of two, one warpgroup a block, S summed
//     over the quarters' k-steps as above and P.V a quarter at a time.
//
// Bound.  Operations: 4 B Hq D per (query, visible key) pair, three times
// over at the TF32 rate (495 TFLOP/s dense): at B 8 x T 2048, Hq 32, D 64,
// causal, 3 x 1.375e11 operations in 0.8334 ms (the same operations in f32
// on the CUDA cores: 2.0523 ms); bytes: q, k, v and the output once, and
// the prep's 2 x (k + v) planes written and read once more.  Not yet done:
// a producer warp and ping-pong of the two warpgroups, and the split of q
// and P into planes in fewer instructions.
//
// Plain C interface for ctypes: the entry points launch on the given
// stream, never synchronise, allocate nothing, and return
// cudaGetLastError() (or the error of raising the shared-memory limit) so
// a refused launch is reported by the caller.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kBK = 64;              // keys a tile (wgmma's N for S)
constexpr int kColBlock = 64 * 128;  // 64 rows of 128 bytes (32 f32 columns)
constexpr int kPrepThreads = 256;
constexpr float kNegInf = -1e30f;    // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;

// element strides (b, t, h) of a (B, T, H, D) operand whose D is contiguous
struct Strides {
  long long b, t, h;
};

// The tiles of width Dc: 8, 16 and 32 for those head widths alone, or a
// width class (64, 128, 256) for any D up to Dc, its K, Q and V^T rows
// zero past D.  At Dc 256 (kSplit) a prepared tile is eight 32 KB parts, K's
// four 64-column quarters and then V^T's four 64-row quarters, each its hi
// plane and then its lo plane, streamed through a ring of two parts.
template <int Dc>
struct Shape {
  static constexpr bool kSplit = Dc == 256;
  static constexpr int kWG = Dc >= 128 ? 1 : 2;      // consumer warpgroups
  static constexpr int kBQ = 64 * kWG;               // query rows a block
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kStages = Dc == 128 ? 1 : 2;  // key tiles in flight (not kSplit)
  static constexpr int kKB = (Dc + 31) / 32;         // 32-column blocks of a K or Q row
  static constexpr int kNB = Dc < 64 ? 1 : Dc / 64;  // 64-row blocks of V^T (and of O)
  static constexpr int kKS = Dc / 8;                 // k-steps of Q.K^T
  static constexpr int kQRegion = 2 * kKB * kColBlock;     // one warpgroup's Q, hi and lo
  static constexpr int kKPart = 2 * kKB * kColBlock;       // a tile's K, hi and lo
  static constexpr int kVPart = 2 * kNB * 2 * kColBlock;   // a tile's V^T, hi and lo
  static constexpr int kTile = kKPart + kVPart;            // bytes of a prepared tile
  static constexpr int kPart = 4 * kColBlock;              // kSplit: a quarter, hi and lo
  static constexpr int kParts = kTile / kPart;             // kSplit: parts a tile
  static constexpr int kRing = 2;                          // kSplit: parts in flight
  static constexpr int kPRegion = 4 * kColBlock;           // kSplit: P (64 keys), hi and lo
  static constexpr int kBarBytes = kSplit ? 2 * kRing * 8 : 4 * kStages * 8;
  static constexpr size_t smem =
      1024 + (size_t)kWG * kQRegion +
      (kSplit ? (size_t)kRing * kPart + kPRegion : (size_t)kStages * kTile) + kBarBytes;
};

// f32 -> the nearest TF32 value (ties to even), low 13 bits zero
__device__ __forceinline__ float tf32_rn(float v) {
  uint32_t u = __float_as_uint(v);
  if ((u & 0x7f800000u) != 0x7f800000u) u = (u + 0xfffu + ((u >> 13) & 1u)) & 0xffffe000u;
  return __uint_as_float(u);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// the producer's arrival, announcing the bytes the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
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
// one bulk copy (the TMA, no tensor map) of `bytes` contiguous bytes,
// completing on `bar`
__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                              uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
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
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; byte offsets >> 4
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  uint64_t d = 0;
  d |= (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)(16 >> 4) << 16;    // leading byte offset (unused when swizzled)
  d |= (uint64_t)(1024 >> 4) << 32;  // stride byte offset: 8 rows of 128 bytes
  d |= (uint64_t)1 << 62;
  return d;
}

// d (64 x 64, f32) = A (64 x 8, TF32, K-major, shared) . B (8 x 64, K-major,
// shared) + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) = A (64 x 8, TF32 registers) . B (8 x 64, K-major, shared)
// + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// 2^x on the SFU; 2^-inf = +0, so a masked logit of -inf gives p = 0 exactly
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one 64-key tile on the S accumulator fragments
// (s[4j + e] is row g, key k0 + 8j + 2 t4 + e; s[4j + 2 + e] row g + 8;
// qpos_a and qpos_b the rows' query positions): the mask where the tile
// straddles an edge (full false; a masked logit is -inf, so 2^(-inf) = 0
// is its p), the row maxima over the quad, the running (m, l), p in s, and
// al_a, al_b, the factors that rescale o to the new maxima.
__device__ __forceinline__ void tile_softmax(float (&s)[32], long long k0, bool full, int S,
                                             int causal, int window, long long qpos_a,
                                             long long qpos_b, int t4, float scale_log2,
                                             float& m_a, float& m_b, float& l_a, float& l_b,
                                             float& al_a, float& al_b) {
  float mxa[4], mxb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) mxa[i] = mxb[i] = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (!full) {
        const long long key = k0 + 8 * j + 2 * t4 + e;
        bool oka = key < S, okb = key < S;
        if (causal) {
          oka = oka && key <= qpos_a;
          okb = okb && key <= qpos_b;
        }
        if (window > 0) {
          oka = oka && key > qpos_a - window;
          okb = okb && key > qpos_b - window;
        }
        if (!oka) s[4 * j + e] = -INFINITY;
        if (!okb) s[4 * j + 2 + e] = -INFINITY;
      }
      mxa[(2 * j + e) & 3] = fmaxf(mxa[(2 * j + e) & 3], s[4 * j + e]);
      mxb[(2 * j + e) & 3] = fmaxf(mxb[(2 * j + e) & 3], s[4 * j + 2 + e]);
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
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float pa = ex2(fmaf(s[4 * j + e], scale_log2, -mn_a));
      const float pb = ex2(fmaf(s[4 * j + 2 + e], scale_log2, -mn_b));
      s[4 * j + e] = pa;
      s[4 * j + 2 + e] = pb;
      sa[(2 * j + e) & 3] += pa;
      sb[(2 * j + e) & 3] += pb;
    }
  }
  l_a = l_a * al_a + ((sa[0] + sa[1]) + (sa[2] + sa[3]));
  l_b = l_b * al_b + ((sb[0] + sb[1]) + (sb[2] + sb[3]));
}

// The end of a warpgroup's rows: l summed over the quad, O divided by l
// where l > 0 (by 1 elsewhere, so a row that sees no key gives 0), rows t_a
// and t_a + 8 below T stored to out, contiguous (B, T, Hq, D), up to D.
template <int kNB>
__device__ __forceinline__ void store_rows(float* __restrict__ out, const float (&o)[kNB][32],
                                           float l_a, float l_b, long long bT, int T_, int Hq,
                                           int h, int D, int t_a, int t4) {
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float den_a = l_a > 0.0f ? l_a : 1.0f;
  const float den_b = l_b > 0.0f ? l_b : 1.0f;
  const int t_b = t_a + 8;
  float* oa = out + ((bT + t_a) * Hq + h) * D;
  float* ob = out + ((bT + t_b) * Hq + h) * D;
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = nb * 64 + 8 * j + 2 * t4;
      if (col >= D) continue;
      if (t_a < T_)
        *reinterpret_cast<float2*>(oa + col) =
            make_float2(o[nb][4 * j + 0] / den_a, o[nb][4 * j + 1] / den_a);
      if (t_b < T_)
        *reinterpret_cast<float2*>(ob + col) =
            make_float2(o[nb][4 * j + 2] / den_b, o[nb][4 * j + 3] / den_b);
    }
  }
}

// byte offset of element (row r, column c) in a region of 32-column blocks
// of 64 rows x 128 bytes, 128-byte swizzle
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 5) * kColBlock + r * 128 + ((((c >> 2) & 7) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

// The key at physical position pk of a tile's V^T rows: within each group of
// 8, positions 0..3 hold keys 0, 2, 4, 6 and positions 4..7 keys 1, 3, 5, 7.
__device__ __forceinline__ int key_at(int pk) {
  const int lo = pk & 7;
  return (pk & ~7) | (lo < 4 ? 2 * lo : 2 * (lo - 4) + 1);
}

// One block a (64-key tile, b * Hkv + hkv): the prepared tile, one thread an
// output float (hi plane, then lo; K, then V^T), zero past S and past D.
// grid.y holds at most 65,535 blocks, so each block takes the (b, hkv)
// pairs blockIdx.y, blockIdx.y + gridDim.y, ... below BH = B * Hkv.
template <int Dc>
__global__ void __launch_bounds__(kPrepThreads)
flash_tf32_prep_kernel(const float* __restrict__ k, const float* __restrict__ v,
                       float* __restrict__ image, Strides sk, Strides sv, int S, int Hkv,
                       long long BH, int D) {
  using Sh = Shape<Dc>;
  constexpr int kKFloats = Sh::kKPart / 4, kPlaneK = kKFloats / 2;
  constexpr int kVFloats = Sh::kVPart / 4, kPlaneV = kVFloats / 2;
  const int kt = blockIdx.x;
  for (long long bk = blockIdx.y; bk < BH; bk += gridDim.y) {
    const long long b = bk / Hkv, hk = bk % Hkv;
    const long long k0 = (long long)kt * kBK;
    const float* kb = k + b * sk.b + hk * sk.h;
    const float* vb = v + b * sv.b + hk * sv.h;
    float* out = image + ((size_t)bk * gridDim.x + kt) * (Sh::kTile / 4);
    for (int f = threadIdx.x; f < kKFloats + kVFloats; f += kPrepThreads) {
      float x = 0.0f;
      bool lo;
      if (f < kKFloats) {  // K: plane, 32-column block, key row, swizzled float
        int g, cb;
        if (Sh::kSplit) {  // quarter, plane, 32-column block of the quarter
          const int h = f & 8191;
          lo = h >= 4096;
          g = h & 4095;
          cb = (f >> 13) * 2 + (g >> 11);
        } else {
          lo = f >= kPlaneK;
          g = lo ? f - kPlaneK : f;
          cb = g >> 11;
        }
        const int r = (g >> 5) & 63, w = g & 31;
        const int c = cb * 32 + ((((w >> 2) ^ r) & 7) << 2) + (w & 3);
        if (c < D && k0 + r < S) x = kb[(k0 + r) * sk.t + c];
      } else {  // V^T: plane, 64-row block, 32-key block, head-column row, swizzled float
        const int f2 = f - kKFloats;
        int g, nb;
        if (Sh::kSplit) {  // quarter (64-row block), plane
          const int h = f2 & 8191;
          lo = h >= 4096;
          g = h & 4095;
          nb = f2 >> 13;
        } else {
          lo = f2 >= kPlaneV;
          g = lo ? f2 - kPlaneV : f2;
          nb = g >> 12;
        }
        const int kb2 = (g >> 11) & 1, rr = (g >> 5) & 63, w = g & 31;
        const int pk = kb2 * 32 + ((((w >> 2) ^ rr) & 7) << 2) + (w & 3);
        const int d = nb * 64 + rr, r = key_at(pk);
        if (d < D && k0 + r < S) x = vb[(k0 + r) * sv.t + d];
      }
      const float hi = tf32_rn(x);
      out[f] = lo ? tf32_rn(x - hi) : hi;
    }
  }
}

template <int Dc>
__global__ void __launch_bounds__(Shape<Dc>::kThreads, 1)
flash_attention_tf32_kernel(const float* __restrict__ q, const uint8_t* __restrict__ image,
                            float* __restrict__ out, Strides sq, int T_, int S, int Hq, int G,
                            int D, int nkt, int causal, int window, int q_offset,
                            float scale_log2) {
  using Sh = Shape<Dc>;
  constexpr int kWG = Sh::kWG, kBQ = Sh::kBQ, kThreads = Sh::kThreads, kStages = Sh::kStages;
  constexpr int kNB = Sh::kNB, kKB = Sh::kKB;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 bytes of shared address
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;                               // kWG regions: hi plane, lo plane
  const uint32_t ks0 = smem_addr(smem + kWG * Sh::kQRegion);   // K stages
  const uint32_t vs0 = ks0 + kStages * Sh::kKPart;             // V^T stages
  const uint32_t bar0 = vs0 + kStages * Sh::kVPart;
  // fullK[s], fullV[s]: the stage's part has landed; emptyK[s], emptyV[s]:
  // every thread is done with it
  const uint32_t fullK = bar0, fullV = bar0 + 8 * kStages;
  const uint32_t emptyK = bar0 + 16 * kStages, emptyV = bar0 + 24 * kStages;

  const int nqt = (T_ + kBQ - 1) / kBQ;
  const int qt = nqt - 1 - (int)(blockIdx.x % nqt);  // heavy tiles first
  const int bh = (int)(blockIdx.x / nqt);
  const int h = bh % Hq;
  const int b = bh / Hq;
  const int Hkv = Hq / G;
  const int hk = h / G;
  const int q0 = qt * kBQ;
  const int rows = min(kBQ, T_ - q0);

  // warp-uniform as the compiler sees it, so that it keeps the wgmma
  // asynchronous inside the branches that depend on the warpgroup
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  // key tiles any row of the block can see: [kt0, kt0 + ntiles)
  const long long qpos_lo = (long long)q0 + q_offset;
  const long long qpos_hi = (long long)q0 + rows - 1 + q_offset;
  long long kbeg = 0, kend = S;
  if (window > 0) kbeg = qpos_lo - window + 1 > 0 ? qpos_lo - window + 1 : 0;
  if (causal) kend = qpos_hi + 1 < S ? qpos_hi + 1 : S;
  const int kt0 = (int)(kbeg / kBK);
  const int ntiles = kend > kbeg ? (int)((kend + kBK - 1) / kBK) - kt0 : 0;

  // this warpgroup's rows and the keys they see: [wbeg, wend)
  const int wrows = max(0, min(64, rows - 64 * wg));
  const long long wq_lo = qpos_lo + 64 * wg;
  const long long wq_hi = wq_lo + wrows - 1;
  long long wbeg = 0, wend = S;
  if (window > 0) wbeg = wq_lo - window + 1 > 0 ? wq_lo - window + 1 : 0;
  if (causal) wend = wq_hi + 1 < S ? wq_hi + 1 : S;

  const uint8_t* tiles = image + ((size_t)(b * Hkv + hk) * nkt + kt0) * Sh::kTile;
  // thread 0 brings a tile's K (or V^T) part into its stage with one bulk
  // copy that completes on the stage's full barrier
  auto fetch = [&](int it, bool vpart) {
    const int st = it % kStages;
    const uint32_t bar = (vpart ? fullV : fullK) + 8 * st;
    const int bytes = vpart ? Sh::kVPart : Sh::kKPart;
    mbar_expect_tx(bar, bytes);
    bulk_copy_g2s((vpart ? vs0 + st * Sh::kVPart : ks0 + st * Sh::kKPart),
                  tiles + (size_t)it * Sh::kTile + (vpart ? Sh::kKPart : 0), bytes, bar);
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(fullK + 8 * st, 1);
      mbar_init(fullV + 8 * st, 1);
      mbar_init(emptyK + 8 * st, kThreads);
      mbar_init(emptyV + 8 * st, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (ntiles > 0) {
      fetch(0, false);
      fetch(0, true);
    }
  }

  // the query tile, split into hi and lo planes (rows past T and columns
  // past D are zero; the rows are never stored)
  const float* qb = q + b * sq.b + h * sq.h;
  for (int i = threadIdx.x; i < kBQ * Dc; i += kThreads) {
    const int r = i / Dc, c = i - r * Dc;
    const float x = r < rows && c < D ? qb[(long long)(q0 + r) * sq.t + c] : 0.0f;
    const float hi = tf32_rn(x);
    uint8_t* reg = qs + (r >> 6) * Sh::kQRegion + swz(r & 63, c);
    *reinterpret_cast<float*>(reg) = hi;
    *reinterpret_cast<float*>(reg + kKB * kColBlock) = tf32_rn(x - hi);
  }
  fence_async_shared();
  __syncthreads();

  float o[kNB][32];
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[nb][i] = 0.0f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;  // rows g, g + 8
  const uint32_t qh_sh = smem_addr(qs + wg * Sh::kQRegion);
  const uint32_t ql_sh = qh_sh + kKB * kColBlock;
  const long long qpos_a = wq_lo + 16 * warp + g;  // this thread's two rows
  const long long qpos_b = qpos_a + 8;

  for (int it = 0; it < ntiles; ++it) {
    const int st = it % kStages;
    const uint32_t ph = (it / kStages) & 1;
    const long long k0 = (long long)(kt0 + it) * kBK;
    const bool active = wrows > 0 && k0 < wend && k0 + kBK > wbeg;
    const uint32_t k_sh = ks0 + st * Sh::kKPart;
    const uint32_t v_sh = vs0 + st * Sh::kVPart;
    // tile it + 1's part goes into the stage that tile it + 1 - kStages
    // held, once every thread has released it
    auto refill = [&](bool vpart) {
      if (threadIdx.x == 0 && it + 1 < ntiles) {
        if (it + 1 >= kStages)
          mbar_wait((vpart ? emptyV : emptyK) + 8 * ((it + 1) % kStages),
                    ((it + 1) / kStages - 1) & 1);
        fetch(it + 1, vpart);
      }
      __syncwarp();
    };

    float s[32];
    mbar_wait(fullK + 8 * st, ph);
    if (active) {
      // each k-step's three products into a fresh accumulator (the tensor
      // cores round their f32 sums toward zero, so a long chain of them
      // drifts), the k-steps then added in f32 with rounding to nearest;
      // two accumulators, so that k-step kk + 1 runs while kk is added
      float part[2][32];
      auto issue = [&](int kk) {
        const uint32_t off = (kk >> 2) * kColBlock + (kk & 3) * 32;
        const uint32_t kl = k_sh + kKB * kColBlock;
        wgmma_fence();
        wgmma_ss(part[kk & 1], desc_sw128(ql_sh + off), desc_sw128(k_sh + off), 0);
        wgmma_ss(part[kk & 1], desc_sw128(qh_sh + off), desc_sw128(kl + off), 1);
        wgmma_ss(part[kk & 1], desc_sw128(qh_sh + off), desc_sw128(k_sh + off), 1);
        wgmma_commit();
      };
      issue(0);
#pragma unroll
      for (int kk = 0; kk < Sh::kKS; ++kk) {
        if (kk + 1 < Sh::kKS) {
          issue(kk + 1);
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        fence_regs(part[kk & 1]);
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = kk == 0 ? part[0][i] : s[i] + part[kk & 1][i];
      }
    }
    mbar_arrive(emptyK + 8 * st);
    refill(false);

    uint32_t ph_[8][4], pl_[8][4];  // P's hi and lo A fragments, a k-step each 8 keys
    float alpha_a = 1.0f, alpha_b = 1.0f;  // this tile's rescaling of o
    if (active) {
      const bool full = k0 + kBK <= S && (!causal || k0 + kBK - 1 <= wq_lo) &&
                        (window <= 0 || k0 > wq_hi - window);
      tile_softmax(s, k0, full, S, causal, window, qpos_a, qpos_b, t4, scale_log2, m_a, m_b,
                   l_a, l_b, alpha_a, alpha_b);
      // the A fragment of k-step j holds (row g, position t4), (g + 8, t4),
      // (g, t4 + 4), (g + 8, t4 + 4); V^T holds keys 2 t4 and 2 t4 + 1 of
      // the 8 at those positions, which are s[4j], s[4j + 2], s[4j + 1],
      // s[4j + 3]
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p4[4] = {s[4 * j + 0], s[4 * j + 2], s[4 * j + 1], s[4 * j + 3]};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float hi = tf32_rn(p4[r]);
          ph_[j][r] = __float_as_uint(hi);
          pl_[j][r] = __float_as_uint(tf32_rn(p4[r] - hi));
        }
      }
    }

    mbar_wait(fullV + 8 * st, ph);
    if (active) {
      // this tile's P.V into a fresh accumulator, 64 head columns at a
      // time, then o = alpha o + P.V in f32 with rounding to nearest (not a
      // chain of the tensor cores' truncating sums across all tiles)
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        float pv[32];
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t vh = v_sh + (nb * 2 + (j >> 2)) * kColBlock + (j & 3) * 32;
          const uint32_t vl = vh + kNB * 2 * kColBlock;
          wgmma_rs(pv, pl_[j], desc_sw128(vh), j > 0);
          wgmma_rs(pv, ph_[j], desc_sw128(vl), 1);
          wgmma_rs(pv, ph_[j], desc_sw128(vh), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(pv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[nb][4 * j + 0] = fmaf(o[nb][4 * j + 0], alpha_a, pv[4 * j + 0]);
          o[nb][4 * j + 1] = fmaf(o[nb][4 * j + 1], alpha_a, pv[4 * j + 1]);
          o[nb][4 * j + 2] = fmaf(o[nb][4 * j + 2], alpha_b, pv[4 * j + 2]);
          o[nb][4 * j + 3] = fmaf(o[nb][4 * j + 3], alpha_b, pv[4 * j + 3]);
        }
      }
    }
    mbar_arrive(emptyV + 8 * st);
    refill(true);
  }

  if (wrows == 0) return;
  store_rows(out, o, l_a, l_b, (long long)b * T_, T_, Hq, h, D, q0 + 64 * wg + 16 * warp + g, t4);
}

// Head widths above 128 (width class 256): one warpgroup of 64 query rows
// a block, its Q tile as hi and lo planes in shared memory (128 KB), and
// each prepared tile streamed through a ring of two 32 KB parts (Shape's
// kSplit layout): K's four 64-column quarters, then V^T's four 64-row
// quarters.  Per tile: S = Q.K^T a quarter at a time, each k-step's three
// products into a fresh accumulator added to S in f32 (as the narrow
// kernel, but one accumulator: the O tile holds 128 registers a thread);
// the softmax; P's hi and lo planes written to shared memory in V^T's key
// order (wgmma's A from shared memory: as register fragments they would
// take 64 more registers, past the 255 a thread has); then P.V a quarter at
// a time into a fresh accumulator and O = alpha O + P.V.  Thread 0 refills
// a slot with part P + 2 once every thread has released part P, so the
// next part lands while this one is used.
template <int Dc>
__global__ void __launch_bounds__(Shape<Dc>::kThreads, 1)
flash_attention_tf32_wide_kernel(const float* __restrict__ q, const uint8_t* __restrict__ image,
                                 float* __restrict__ out, Strides sq, int T_, int S, int Hq,
                                 int G, int D, int nkt, int causal, int window, int q_offset,
                                 float scale_log2) {
  using Sh = Shape<Dc>;
  static_assert(Sh::kSplit && Sh::kWG == 1, "the wide kernel takes the split layout");
  constexpr int kBQ = Sh::kBQ, kThreads = Sh::kThreads, kNB = Sh::kNB, kKB = Sh::kKB;
  constexpr int kRing = Sh::kRing, kParts = Sh::kParts, kQuarters = kParts / 2;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 bytes of shared address
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;                                 // hi plane, lo plane
  const uint32_t ring0 = smem_addr(smem + Sh::kQRegion);
  uint8_t* ps = smem + Sh::kQRegion + kRing * Sh::kPart;  // P: hi plane, lo plane
  const uint32_t full0 = smem_addr(ps + Sh::kPRegion), empty0 = full0 + 8 * kRing;

  const int nqt = (T_ + kBQ - 1) / kBQ;
  const int qt = nqt - 1 - (int)(blockIdx.x % nqt);  // heavy tiles first
  const int bh = (int)(blockIdx.x / nqt);
  const int h = bh % Hq;
  const int b = bh / Hq;
  const int Hkv = Hq / G;
  const int hk = h / G;
  const int q0 = qt * kBQ;
  const int rows = min(kBQ, T_ - q0);
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  // key tiles the block's rows see: [kt0, kt0 + ntiles)
  const long long qpos_lo = (long long)q0 + q_offset;
  const long long qpos_hi = (long long)q0 + rows - 1 + q_offset;
  long long kbeg = 0, kend = S;
  if (window > 0) kbeg = qpos_lo - window + 1 > 0 ? qpos_lo - window + 1 : 0;
  if (causal) kend = qpos_hi + 1 < S ? qpos_hi + 1 : S;
  const int kt0 = (int)(kbeg / kBK);
  const int ntiles = kend > kbeg ? (int)((kend + kBK - 1) / kBK) - kt0 : 0;
  const long long nparts = (long long)ntiles * kParts;

  const uint8_t* tiles = image + ((size_t)(b * Hkv + hk) * nkt + kt0) * Sh::kTile;
  // thread 0 brings part P (tile P / kParts, part P % kParts) into slot P % kRing
  auto fetch = [&](long long P) {
    const int sl = (int)(P % kRing);
    mbar_expect_tx(full0 + 8 * sl, Sh::kPart);
    bulk_copy_g2s(ring0 + sl * Sh::kPart,
                  tiles + (size_t)(P / kParts) * Sh::kTile + (size_t)(P % kParts) * Sh::kPart,
                  Sh::kPart, full0 + 8 * sl);
  };
  if (threadIdx.x == 0) {
    for (int sl = 0; sl < kRing; ++sl) {
      mbar_init(full0 + 8 * sl, 1);
      mbar_init(empty0 + 8 * sl, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (long long P = 0; P < kRing && P < nparts; ++P) fetch(P);
  }
  // part P has landed: its slot's address
  auto acquire = [&](long long P) {
    mbar_wait(full0 + 8 * (int)(P % kRing), (uint32_t)((P / kRing) & 1));
    return ring0 + (int)(P % kRing) * Sh::kPart;
  };
  // this thread is done with part P; thread 0 refills its slot with P + kRing
  auto release = [&](long long P) {
    const int sl = (int)(P % kRing);
    mbar_arrive(empty0 + 8 * sl);
    if (threadIdx.x == 0 && P + kRing < nparts) {
      mbar_wait(empty0 + 8 * sl, (uint32_t)((P / kRing) & 1));
      fetch(P + kRing);
    }
    __syncwarp();
  };

  // the query tile, split into hi and lo planes (rows past T and columns
  // past D are zero; the rows are never stored)
  const float* qb = q + b * sq.b + h * sq.h;
  for (int i = threadIdx.x; i < kBQ * Dc; i += kThreads) {
    const int r = i / Dc, c = i - r * Dc;
    const float x = r < rows && c < D ? qb[(long long)(q0 + r) * sq.t + c] : 0.0f;
    const float hi = tf32_rn(x);
    uint8_t* reg = qs + swz(r, c);
    *reinterpret_cast<float*>(reg) = hi;
    *reinterpret_cast<float*>(reg + kKB * kColBlock) = tf32_rn(x - hi);
  }
  fence_async_shared();
  __syncthreads();

  float o[kNB][32];
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[nb][i] = 0.0f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;  // rows g, g + 8
  const uint32_t qh_sh = smem_addr(qs);
  const uint32_t ql_sh = qh_sh + kKB * kColBlock;
  const long long qpos_a = qpos_lo + 16 * warp + g;  // this thread's two rows
  const long long qpos_b = qpos_a + 8;

  for (int it = 0; it < ntiles; ++it) {
    const long long P0 = (long long)it * kParts;
    const long long k0 = (long long)(kt0 + it) * kBK;
    // [kbeg, kend) meets every tile of the loop; a row that sees no key of
    // a tile gets p = 0 from its masked (-inf) logits
    const bool active = k0 < kend && k0 + kBK > kbeg;

    // S, a quarter of the head columns (8 k-steps) a part
    float s[32];
    for (int qq = 0; qq < kQuarters; ++qq) {
      const uint32_t kh = acquire(P0 + qq);
      fence_async_shared();
      if (active) {
#pragma unroll
        for (int kq = 0; kq < 8; ++kq) {
          const int kk = qq * 8 + kq;
          const uint32_t qoff = (kk >> 2) * kColBlock + (kk & 3) * 32;
          const uint32_t koff = (kq >> 2) * kColBlock + (kq & 3) * 32;
          const uint32_t kl = kh + 2 * kColBlock;
          float part[32];
          wgmma_fence();
          wgmma_ss(part, desc_sw128(ql_sh + qoff), desc_sw128(kh + koff), 0);
          wgmma_ss(part, desc_sw128(qh_sh + qoff), desc_sw128(kl + koff), 1);
          wgmma_ss(part, desc_sw128(qh_sh + qoff), desc_sw128(kh + koff), 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(part);
#pragma unroll
          for (int i = 0; i < 32; ++i) s[i] = kk == 0 ? part[i] : s[i] + part[i];
        }
      }
      release(P0 + qq);
    }

    float alpha_a = 1.0f, alpha_b = 1.0f;  // this tile's rescaling of o
    if (active) {
      const bool full = k0 + kBK <= S && (!causal || k0 + kBK - 1 <= qpos_lo) &&
                        (window <= 0 || k0 > qpos_lo + rows - 1 - window);
      tile_softmax(s, k0, full, S, causal, window, qpos_a, qpos_b, t4, scale_log2, m_a, m_b,
                   l_a, l_b, alpha_a, alpha_b);
      // P's hi and lo planes, K-major (a row a query row): key 8j + 2 t4 + e
      // at position 8j + t4 + 4e, V^T's key order
      __syncthreads();  // the last tile's P.V has read P
      const int ra = 16 * warp + g;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int pos = 8 * j + t4 + 4 * e;
#pragma unroll
          for (int hb = 0; hb < 2; ++hb) {
            const float p = s[4 * j + 2 * hb + e];
            const float hi = tf32_rn(p);
            uint8_t* at = ps + swz(ra + 8 * hb, pos);
            *reinterpret_cast<float*>(at) = hi;
            *reinterpret_cast<float*>(at + 2 * kColBlock) = tf32_rn(p - hi);
          }
        }
      }
      fence_async_shared();
      __syncthreads();
    }

    // P.V, 64 head columns (a V^T quarter) a part, each into a fresh
    // accumulator, then o = alpha o + P.V in f32 with rounding to nearest
    const uint32_t ph_sh = smem_addr(ps), pl_sh = ph_sh + 2 * kColBlock;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      const uint32_t v_sh = acquire(P0 + kQuarters + nb);
      fence_async_shared();
      if (active) {
        float pv[32];
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t poff = (j >> 2) * kColBlock + (j & 3) * 32;
          const uint32_t vh = v_sh + (j >> 2) * kColBlock + (j & 3) * 32;
          const uint32_t vl = vh + 2 * kColBlock;
          wgmma_ss(pv, desc_sw128(pl_sh + poff), desc_sw128(vh), j > 0);
          wgmma_ss(pv, desc_sw128(ph_sh + poff), desc_sw128(vl), 1);
          wgmma_ss(pv, desc_sw128(ph_sh + poff), desc_sw128(vh), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(pv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[nb][4 * j + 0] = fmaf(o[nb][4 * j + 0], alpha_a, pv[4 * j + 0]);
          o[nb][4 * j + 1] = fmaf(o[nb][4 * j + 1], alpha_a, pv[4 * j + 1]);
          o[nb][4 * j + 2] = fmaf(o[nb][4 * j + 2], alpha_b, pv[4 * j + 2]);
          o[nb][4 * j + 3] = fmaf(o[nb][4 * j + 3], alpha_b, pv[4 * j + 3]);
        }
      }
      release(P0 + kQuarters + nb);
    }
  }

  store_rows(out, o, l_a, l_b, (long long)b * T_, T_, Hq, h, D, q0 + 16 * warp + g, t4);
}

template <int Dc>
int launch_prep(const void* k, const void* v, void* image, const long long* strides, int B,
                int S, int Hkv, int D, cudaStream_t st) {
  const long long nkt = (S + kBK - 1) / kBK;
  if (nkt > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const Strides sk{strides[0], strides[1], strides[2]};
  const Strides sv{strides[3], strides[4], strides[5]};
  const long long bh = (long long)B * Hkv;
  const unsigned by = (unsigned)(bh < 65535 ? bh : 65535);  // the rest loop on grid.y
  flash_tf32_prep_kernel<Dc><<<dim3((unsigned)nkt, by), kPrepThreads, 0, st>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), static_cast<float*>(image),
      sk, sv, S, Hkv, bh, D);
  return (int)cudaGetLastError();
}

template <int Dc>
int launch_main(const void* q, const void* image, void* out, const long long* strides, int B,
                int T_, int S, int Hq, int G, int D, int causal, int window, int q_offset,
                int scale_d, cudaStream_t st) {
  using Sh = Shape<Dc>;
  const size_t smem = Sh::smem;
  void (*kern)(const float*, const uint8_t*, float*, Strides, int, int, int, int, int, int,
               int, int, int, float);
  if constexpr (Sh::kSplit) {
    kern = flash_attention_tf32_wide_kernel<Dc>;
  } else {
    kern = flash_attention_tf32_kernel<Dc>;
  }
  // raise the shared-memory limit once a device, so that a launch being
  // captured into a CUDA graph makes no other runtime call
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices || !raised[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) raised[dev] = true;
  }
  const long long nqt = (T_ + Sh::kBQ - 1) / Sh::kBQ;
  const long long blocks = (long long)B * Hq * nqt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int nkt = (S + kBK - 1) / kBK;
  // D^-1/2 of the true head width rounded once to f32, as the JAX package's
  // Python-float constant, then folded with log2(e) for exp2
  const float scale = (float)(1.0 / std::sqrt((double)scale_d));
  const Strides sq{strides[0], strides[1], strides[2]};
  kern<<<dim3((unsigned)blocks), Sh::kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const uint8_t*>(image), static_cast<float*>(out),
      sq, T_, S, Hq, G, D, nkt, causal, window, q_offset, scale * kLog2e);
  return (int)cudaGetLastError();
}

// D 8, 16 and 32 run tiles of their own width; any other D the width class
// (64, 128, 256) above it.
#define REPRO_TF32_DISPATCH(CALL)  \
  switch (D) {                     \
    case 8: return CALL(8);        \
    case 16: return CALL(16);      \
    case 32: return CALL(32);      \
    default: break;                \
  }                                \
  if (D <= 64) return CALL(64);    \
  if (D <= 128) return CALL(128);  \
  return CALL(256);

bool head_width_ok(int D) { return D >= 8 && D <= 256 && D % 8 == 0; }

template <int Dc>
long long tile_bytes() { return Shape<Dc>::kTile; }

}  // namespace

extern "C" {

// Bytes of the prepared tiles of k/v (B, S, Hkv, D): the image the prep
// kernel writes and the main kernel reads (the wrapper allocates it), or -1.
long long repro_flash_tf32_image_bytes(int B, int S, int Hkv, int D) {
  if (B < 1 || S < 1 || Hkv < 1 || !head_width_ok(D)) return -1;
  const long long tiles = (long long)B * Hkv * ((S + kBK - 1) / kBK);
#define REPRO_TILE(DC) tiles * tile_bytes<DC>()
  REPRO_TF32_DISPATCH(REPRO_TILE)
#undef REPRO_TILE
}

// k/v (B, S, Hkv, D) f32 with a contiguous last dimension and element
// strides (b, t, h) in strides[0..2] (k), [3..5] (v): the prepared tiles
// into image (repro_flash_tf32_image_bytes, 16-byte aligned).
int repro_flash_tf32_prep(const void* k, const void* v, void* image, const long long* strides,
                          int B, int S, int Hkv, int D, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || !head_width_ok(D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_PREP(DC) launch_prep<DC>(k, v, image, strides, B, S, Hkv, D, st)
  REPRO_TF32_DISPATCH(REPRO_PREP)
#undef REPRO_PREP
}

// q (B, T, Hq, D) f32 with a contiguous last dimension and element strides
// (b, t, h) in strides[0..2]; image the prepared k/v tiles of (B, S, Hq/G,
// D); out contiguous (B, T, Hq, D) f32.  D a multiple of 8 from 8 to 256
// (the wrapper pads other widths with zero columns); scale_d the true head
// width, whose D^-1/2 scales the logits.  The wrapper checks the rest.
int repro_flash_attention_tf32(const void* q, const void* image, void* out,
                               const long long* strides, int B, int T, int S, int Hq, int G,
                               int D, int causal, int window, int q_offset, int scale_d,
                               void* stream) {
  if (B < 1 || T < 1 || S < 1 || Hq < 1 || G < 1 || Hq % G || !head_width_ok(D) || scale_d < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_MAIN(DC)                                                                     \
  launch_main<DC>(q, image, out, strides, B, T, S, Hq, G, D, causal, window, q_offset, \
                         scale_d, st)
  REPRO_TF32_DISPATCH(REPRO_MAIN)
#undef REPRO_MAIN
}

// dynamic shared memory of a main-kernel launch at head width D (bytes), or -1
int repro_flash_attention_tf32_smem(int D) {
  if (!head_width_ok(D)) return -1;
#define REPRO_SMEM(DC) (int)Shape<DC>::smem
  REPRO_TF32_DISPATCH(REPRO_SMEM)
#undef REPRO_SMEM
}

}  // extern "C"
