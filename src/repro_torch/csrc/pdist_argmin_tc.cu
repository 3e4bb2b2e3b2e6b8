// Nearest centroid under l2 on Hopper's tensor cores (sm_90a, wgmma): for
// every point, the first index of its nearest centroid and that squared
// distance.
//
// Replaces the Pallas TPU kernel of the JAX package, for metric "l2":
//   nearest_tc_kernel<T, KS, kMulti> + recheck_kernel<T>
//       <- src/repro/kernels/pdist_argmin/kernel.py _pdist_kernel
// (reached through ops.pdist_argmin <- the E-step of ml/clustering.py:
// kmeans, distributed_kmeans, consensus_kmeans and kmeans_pp_init).  l1
// and l-infinity have no matrix-product form and stay on pdist_argmin.cu's
// CUDA-core kernel; the route is a fixed function of the metric
// (kernels/pdist_argmin/kernel.py ROUTES).
//
// Function.  For X (N, d) and C (K, d), both f32 or both bf16:
//   idx[n] = the first k minimising |x_n - c_k|^2,
//   dist[n] = sum_j (x_nj - c_idx j)^2 in f32 (the direct form),
// the same function as pdist_argmin.cu's l2 kernel and the plain version,
// up to the order of summation.
//
// Design.  As the TPU kernel does (kernel.py:23-30), the search runs in
// the expanded form e_k = |c_k|^2 - 2 x.c_k (|x|^2 is the same for every
// k) with the cross term as a matrix product:
//   prep_kernel: once a call, C is written to device memory as -2C (exact)
//     in the tiles the tensor cores read, |c_k|^2 in f32 (+inf past K, so
//     padded columns never win), and max_k |c_k|^2.  f32 is split into
//     hi = tf32(v) and lo = tf32(v - hi), both rounded to nearest (ties
//     to even) so their low 13 bits are zero; bf16 is used as it is;
//   nearest_tc_kernel: a block takes 256 points, four consumer warpgroups
//     of 64 rows (wgmma's M).  Its points are loaded once, split the same
//     way, into registers as wgmma's A fragments.  The centroids pass in
//     n-tiles of 64 (K padded to a multiple of 64) through a four-stage
//     ring in shared memory: one thread brings each tile with one bulk
//     copy (the TMA, no tensor map: the prepared tile is contiguous),
//     completing on the stage's "full" mbarrier, and refills a stage once
//     every thread has arrived on its "empty" mbarrier, so no barrier of
//     the whole block runs in the loop and a warpgroup may run two tiles
//     ahead of the slowest.  Tiles are 128-byte rows in the 128-byte
//     swizzle, K-major; d is padded to the product's depth (8 for TF32, 16
//     for bf16) and walked in chunks of 256 bytes (64 f32 or 128 bf16
//     columns) when it is deeper.  Per n-tile and 32-byte k-step: in f32
//     three m64n64k8 TF32 products, lo.hi + hi.lo + hi.hi ("3xTF32"), into
//     one f32 accumulator; in bf16 one m64n64k16 product, exact in f32.
//     The epilogue, in registers and without branches, adds |c_k|^2 and
//     keeps each row's best and second-best value over all K in
//     increasing k with a strict '<' (ties go to the first index, as
//     jnp.argmin's do); the four threads of a quad then merge theirs.  One
//     thread a row recomputes the winner's distance in the direct form (d
//     work a point, in recheck_kernel's order of summation);
//   the guard: the expanded form cancels when |x| >> |x - c|, and the
//     port is held to the direct form.  A row whose expanded gap (second -
//     best) is at most
//       tol = (A dp + B) 2^-23 (|x|^2 + max_k |c_k|^2),
//     (A, B) = (8, 16) for f32 and (4, 8) for bf16, dp the padded depth,
//     is appended to a flag list on the device (an atomic count).  tol is
//     above twice a first-order bound on |e_k - exact|: per term the
//     3xTF32 split loses 3.01 2^-22 |x_j||2c_j|, the tensor cores' f32 sum
//     of 3 dp (bf16: dp) exact products at most 2^-23 of the absolute sum
//     per addition (truncation allowed), |c|^2 d 2^-24 of itself, the last
//     add 2^-24; with sum_j |x_j c_j| <= (|x|^2 + |c|^2) / 2 that bound is
//     (7.01 dp + 14.05) 2^-24 (|x|^2 + max|c|^2) in f32 and (3 dp + 2)
//     2^-24 (...) in bf16.  A gap above tol therefore orders the exact
//     distances of the best and every other centroid;
//   recheck_kernel: one thread a flagged row re-runs the direct form over
//     all K, as pdist_argmin.cu's l2 kernel does (C staged through shared
//     memory in 16 x 128 tiles, increasing k, strict '<'), and overwrites
//     that row.  It walks the flag list with a grid sized to the SMs and
//     reads the count on the device, so no host synchronisation is needed
//     and the three launches replay in a CUDA graph.  Wherever the direct
//     form's own top-2 gap clears its rounding, the index equals the
//     direct form's.
//
// Bound.  The products: 3 (bf16: 1) x 2 N K d operations at 495 TF32
// (989 bf16) TFLOP/s dense; at the KDD Cup 1999 shape (N 4,898,432, d 42,
// K 1,000) 1.234e12 operations, 2.49 ms, against 0.26 ms to read X once.
// What the design pays on top: K padded to 1,024 and d to 48 (1.17x the
// products), the epilogue on the CUDA cores (five instructions a value),
// the centroid tiles streamed from L2 once a block (512 KB a block of 256
// points at the KDD shape, 9.8 GB in all), and the direct-form recheck of
// the flagged rows.
//
// Plain C interface for ctypes: the entry point launches on the given
// stream, never synchronises, allocates nothing, and returns
// cudaGetLastError() (or the error of raising the shared-memory limit) so
// a refused launch is reported by the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWG = 4;                  // consumer warpgroups a block
constexpr int kBM = 64 * kWG;           // points a block
constexpr int kThreads = 128 * kWG;
constexpr int kBN = 64;                 // centroids an n-tile (wgmma's N)
constexpr int kChunkSteps = 8;          // 32-byte k-steps a depth chunk
constexpr int kColBlock = kBN * 128;    // 64 rows of 128 bytes
constexpr int kPlane = 2 * kColBlock;   // one operand's depth chunk
constexpr int kStages = 4;              // ring of centroid tiles (bulk copies)
constexpr int kPrepThreads = 128;
constexpr int kRecheckThreads = 128;  // flagged rows a recheck block walks at once
constexpr int kTileK = 16;            // recheck: centroids staged per tile
constexpr int kTileD = 128;           // recheck: coordinates staged per tile
constexpr int kMaxDevices = 64;
constexpr float kTwoM23 = 1.1920928955078125e-07f;  // 2^-23

struct Bf16 {};  // tag: elements are bf16 bit patterns (uint16_t)

template <typename T> struct Elem;

template <> struct Elem<float> {
  using Storage = float;
  static constexpr int kBytes = 4;
  static constexpr int kPlanes = 2;  // hi, lo
  static constexpr int kTolA = 8, kTolB = 16;  // the guard's (A, B), see the note
  __device__ static __forceinline__ float load(const Storage* p) { return __ldg(p); }
};

// bf16 -> f32 is exact: the bf16 bits are the high half of the f32.
template <> struct Elem<Bf16> {
  using Storage = uint16_t;
  static constexpr int kBytes = 2;
  static constexpr int kPlanes = 1;
  static constexpr int kTolA = 4, kTolB = 8;
  __device__ static __forceinline__ float load(const Storage* p) {
    return __uint_as_float(((unsigned)__ldg(p)) << 16);
  }
};

template <typename T>
__host__ __device__ constexpr int stage_bytes() { return Elem<T>::kPlanes * kPlane; }
template <typename T>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + (size_t)kStages * stage_bytes<T>() + 16 * kStages;  // + the mbarriers
}

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
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  uint64_t d = 0;
  d |= (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

// d (64 x 64, f32) += A (64 x 8, TF32 registers) . B (8 x 64, K-major, shared)
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers) . B (16 x 64, K-major, shared)
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Once a call, one thread a centroid row k < Kp: -2 c_k into the tiles the
// tensor cores read (tile s = n-tile * nch + depth chunk; plane 0 hi, plane
// 1 lo in f32; column block cb of 64 rows x 128 bytes; 16-byte chunk c of
// row r at chunk c ^ (r % 8)), zero past K and past d; |c_k|^2 (+inf past
// K); max_k |c_k|^2 as the bits of a non-negative f32 (zeroed by the caller).
template <typename T>
__global__ void __launch_bounds__(kPrepThreads)
prep_kernel(const typename Elem<T>::Storage* __restrict__ C, int K, int Kp, int d, int nch,
            uint8_t* __restrict__ image, float* __restrict__ c2, unsigned* __restrict__ cmax2) {
  using E = Elem<T>;
  constexpr int kChunkElems = kChunkSteps * 32 / E::kBytes;
  const int k = blockIdx.x * kPrepThreads + threadIdx.x;
  if (k >= Kp) return;
  const bool valid = k < K;
  const int nt = k / kBN, r = k % kBN;
  float s = 0.0f;
  for (int j = 0; j < nch * kChunkElems; ++j) {
    const float v = (valid && j < d) ? E::load(C + (long long)k * d + j) : 0.0f;
    s = fmaf(v, v, s);
    const float m = -2.0f * v;  // exact
    const int ch = j / kChunkElems;
    const int byte = (j - ch * kChunkElems) * E::kBytes;
    const int cb = byte >> 7, c16 = (byte >> 4) & 7;
    uint8_t* at = image + (size_t)(nt * nch + ch) * E::kPlanes * kPlane + cb * kColBlock +
                  r * 128 + (((c16 ^ (r & 7)) << 4) | (byte & 15));
    if constexpr (E::kPlanes == 2) {
      const float hi = tf32_rn(m);
      *reinterpret_cast<float*>(at) = hi;
      *reinterpret_cast<float*>(at + kPlane) = tf32_rn(m - hi);
    } else {
      *reinterpret_cast<uint16_t*>(at) = (uint16_t)(__float_as_uint(m) >> 16);
    }
  }
  c2[k] = valid ? s : __int_as_float(0x7f800000);
  if (valid) atomicMax(cmax2, __float_as_uint(s));
}

// KS: the k-steps a depth chunk holds (a thread keeps KS A fragments).
// One chunk (kMulti false): KS is the depth's exact k-step count and the
// fragments are loaded once, before the loop, so the compiler sees no
// write to them between products; several chunks: KS = 8, each reloaded.
template <typename T, int KS, bool kMulti>
__global__ void __launch_bounds__(kThreads, 1)
nearest_tc_kernel(const typename Elem<T>::Storage* __restrict__ X,
                  const typename Elem<T>::Storage* __restrict__ C,
                  const uint8_t* __restrict__ image, const float* __restrict__ c2,
                  const unsigned* __restrict__ cmax2, long long N, int d, int nks, int nch,
                  int ntiles, int* __restrict__ idx_out, float* __restrict__ dist_out,
                  int* __restrict__ list, int* __restrict__ count) {
  using E = Elem<T>;
  using St = typename E::Storage;
  constexpr int kStage = stage_bytes<T>();
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 bytes of shared address
  const uint32_t ring0 = smem_addr(smem_raw) + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // full[s]: tile landed in stage s; empty[s]: every thread is done with it
  const uint32_t full0 = ring0 + kStages * kStage, empty0 = full0 + 8 * kStages;

  // warp-uniform as the compiler sees it, so that it keeps the wgmma
  // asynchronous
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long row_a = (long long)blockIdx.x * kBM + 64 * wg + 16 * warp + g;
  const long long row_b = row_a + 8;
  const int total = ntiles * nch;

  // thread 0 brings tile s (n-tile s / nch, depth chunk s % nch; one
  // contiguous image of kStage bytes) into stage s % kStages with one bulk
  // copy that completes on the stage's full barrier
  auto fetch = [&](int s) {
    const uint32_t bar = full0 + 8 * (s % kStages);
    mbar_expect_tx(bar, kStage);
    bulk_copy_g2s(ring0 + (s % kStages) * kStage, image + (size_t)s * kStage, kStage, bar);
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < min(kStages, total); ++s) fetch(s);
  }
  __syncthreads();

  // this thread's A fragments of depth chunk ch: k-step ks holds rows
  // (a, b) = (g, g + 8) of the warp's 16, columns t4 and t4 + 4 of the
  // step (TF32: registers 0..3 = (a, t4), (b, t4), (a, t4 + 4), (b, t4 + 4))
  // or column pairs 2 t4 and 2 t4 + 8 (bf16, two to a register)
  uint32_t ah[KS][4];
  uint32_t al[E::kPlanes == 2 ? KS : 1][4];
  auto load_x = [&](int ch) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int kg = ch * kChunkSteps + ks;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long row = (q & 1) ? row_b : row_a;
        const St* xr = X + (row < N ? row : 0) * (long long)d;
        if constexpr (E::kPlanes == 2) {
          const int col = kg * 8 + t4 + ((q & 2) ? 4 : 0);
          const float v = (row < N && col < d) ? E::load(xr + col) : 0.0f;
          const float hi = tf32_rn(v);
          ah[ks][q] = __float_as_uint(hi);
          al[ks][q] = __float_as_uint(tf32_rn(v - hi));
        } else {
          const int col = kg * 16 + 2 * t4 + ((q & 2) ? 8 : 0);
          const uint32_t lo = (row < N && col < d) ? __ldg(xr + col) : 0u;
          const uint32_t hi = (row < N && col + 1 < d) ? __ldg(xr + col + 1) : 0u;
          ah[ks][q] = lo | (hi << 16);
        }
      }
    }
  };

  if constexpr (!kMulti) load_x(0);
  const float inf = __int_as_float(0x7f800000);
  // rows a (0) and b (1): best and second-best expanded value, best index
  float b1[2] = {inf, inf}, b2[2] = {inf, inf};
  int i1[2] = {0, 0};
  float acc[32];
  for (int s = 0; s < total; ++s) {
    const int nt = s / nch, ch = s - nt * nch;
    if constexpr (kMulti) load_x(ch);
    // thread 0 refills the stage of tile s - 2 with tile s - 2 + kStages
    // once every thread has released it, so that a warpgroup may run up to
    // two tiles ahead of the slowest
    if (threadIdx.x == 0 && s >= 2 && s - 2 + kStages < total) {
      mbar_wait(empty0 + 8 * ((s - 2) % kStages), ((s - 2) / kStages) & 1);
      fetch(s - 2 + kStages);
    }
    mbar_wait(full0 + 8 * (s % kStages), (s / kStages) & 1);
    const int steps = kMulti ? min(KS, nks - ch * kChunkSteps) : KS;
    const uint32_t st = ring0 + (s % kStages) * kStage;
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (ks < steps) {
        const uint32_t off = (ks >> 2) * kColBlock + (ks & 3) * 32;
        const uint64_t bh = desc_sw128(st + off, 16, 1024);
        if constexpr (E::kPlanes == 2) {
          const uint64_t bl = desc_sw128(st + kPlane + off, 16, 1024);
          wgmma_tf32(acc, al[ks], bh);
          wgmma_tf32(acc, ah[ks], bl);
          wgmma_tf32(acc, ah[ks], bh);
        } else {
          wgmma_bf16(acc, ah[ks], bh);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty0 + 8 * (s % kStages));  // this thread is done with the stage
    if (ch == nch - 1) {
      // acc[4j + e] is row a, centroid nt*64 + 8j + 2 t4 + e; acc[4j + 2 + e]
      // row b.  Branch-free, in increasing k: the second best is the least
      // of the old second and the larger of the old best and v (a tie with
      // the best makes it equal to the best), and a strict '<' moves the
      // index
      const float* c2t = c2 + nt * kBN;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 cc = __ldg(reinterpret_cast<const float2*>(c2t + 8 * j + 2 * t4));
        const int k0 = nt * kBN + 8 * j + 2 * t4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float v = acc[4 * j + e] + ((e & 1) ? cc.y : cc.x);
          b2[r] = fminf(b2[r], fmaxf(b1[r], v));
          i1[r] = v < b1[r] ? k0 + (e & 1) : i1[r];
          b1[r] = fminf(b1[r], v);
        }
      }
    }
  }

  // merge the quad's four column sets: the lower (value, index) wins, and
  // the second best is the best of what is left
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1) {
      const float o1 = __shfl_xor_sync(0xffffffffu, b1[r], m);
      const float o2 = __shfl_xor_sync(0xffffffffu, b2[r], m);
      const int oi = __shfl_xor_sync(0xffffffffu, i1[r], m);
      if (o1 < b1[r] || (o1 == b1[r] && oi < i1[r])) {
        b2[r] = fminf(b1[r], o2);
        b1[r] = o1;
        i1[r] = oi;
      } else {
        b2[r] = fminf(b2[r], o1);
      }
    }
  }

  // thread t4 = 0 finishes row a, t4 = 1 row b: the winner's distance in
  // the direct form, summed in increasing j as recheck_kernel sums it (so
  // a row gets the same bits whichever kernel finishes it), |x|^2, and the
  // guard
  if (t4 >= 2) return;
  const long long row = t4 ? row_b : row_a;
  if (row >= N) return;
  const int k = t4 ? i1[1] : i1[0];
  const float gap = t4 ? b2[1] - b1[1] : b2[0] - b1[0];
  const St* x = X + row * (long long)d;
  const St* c = C + (long long)k * d;
  float dist = 0.0f, x2 = 0.0f;
#pragma unroll 8
  for (int j = 0; j < d; ++j) {
    const float xv = E::load(x + j);
    const float delta = xv - E::load(c + j);
    dist = fmaf(delta, delta, dist);
    x2 = fmaf(xv, xv, x2);
  }
  idx_out[row] = k;
  dist_out[row] = dist;
  const float dp = (float)(nks * 32 / E::kBytes);
  const float tol = (E::kTolA * dp + E::kTolB) * kTwoM23 * (x2 + __uint_as_float(*cmax2));
  if (!(gap > tol)) list[atomicAdd(count, 1)] = (int)row;
}

// One thread a flagged row, a block's rows gathered through the flag
// list: the direct form over all K exactly as pdist_argmin.cu's l2 kernel
// computes it (C staged through shared memory in tiles of kTileK
// centroids by kTileD coordinates, kTileK running sums a thread, folded
// in increasing k with a strict '<'); overwrites that row's index and
// distance.  The grid is fixed (sized to the SMs) and walks the list in
// strides, reading the count on the device.
template <typename T>
__global__ void __launch_bounds__(kRecheckThreads)
recheck_kernel(const typename Elem<T>::Storage* __restrict__ X,
               const typename Elem<T>::Storage* __restrict__ C, int K, int d,
               const int* __restrict__ list, const int* __restrict__ count,
               int* __restrict__ idx_out, float* __restrict__ dist_out) {
  using E = Elem<T>;
  __shared__ __align__(16) float tile[kTileK * kTileD];
  const int n_flagged = *count;
  for (int base = blockIdx.x * kRecheckThreads; base < n_flagged;
       base += gridDim.x * kRecheckThreads) {
    const int i = base + threadIdx.x;
    const bool valid = i < n_flagged;
    const long long row = valid ? list[i] : 0;
    const typename E::Storage* x = X + row * (long long)d;
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
        for (int e = threadIdx.x; e < kTileK * dn4; e += kRecheckThreads) {
          const int t = e / dn4, j = e - t * dn4;
          const int k = k0 + t;
          tile[t * kTileD + j] =
              (k < K && j < dn) ? E::load(C + (long long)k * d + j0 + j) : 0.0f;
        }
        __syncthreads();
        if (valid) {
          for (int j = 0; j < dn4; j += 4) {
            float xv[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) xv[q] = (j + q < dn) ? E::load(x + j0 + j + q) : 0.0f;
#pragma unroll
            for (int t = 0; t < kTileK; ++t) {
              const float4 c = *reinterpret_cast<const float4*>(&tile[t * kTileD + j]);
              float a = acc[t];
              a = fmaf(xv[0] - c.x, xv[0] - c.x, a);
              a = fmaf(xv[1] - c.y, xv[1] - c.y, a);
              a = fmaf(xv[2] - c.z, xv[2] - c.z, a);
              a = fmaf(xv[3] - c.w, xv[3] - c.w, a);
              acc[t] = a;
            }
          }
        }
      }
#pragma unroll
      for (int t = 0; t < kTileK; ++t) {
        if (k0 + t < K && acc[t] < best) {
          best = acc[t];
          best_k = k0 + t;
        }
      }
    }
    if (valid) {
      idx_out[row] = best_k;
      dist_out[row] = best;
    }
  }
}

int cached_sms() {
  static int sms[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (dev >= kMaxDevices) return 132;
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev] > 0 ? sms[dev] : 132;
}

int steps_of(int d, int bytes) { return (d * bytes + 31) / 32; }

template <typename T, int KS, bool kMulti>
int launch_main(const void* X, const void* C, const uint8_t* image, const float* c2,
                const unsigned* cmax2, long long N, int d, int nks, int nch, int ntiles,
                int* idx, float* dist, int* list, int* count, cudaStream_t st) {
  using St = typename Elem<T>::Storage;
  auto kern = nearest_tc_kernel<T, KS, kMulti>;
  constexpr size_t smem = smem_bytes<T>();
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
  const dim3 grid((unsigned)((N + kBM - 1) / kBM));
  kern<<<grid, kThreads, smem, st>>>(static_cast<const St*>(X), static_cast<const St*>(C),
                                     image, c2, cmax2, N, d, nks, nch, ntiles, idx, dist,
                                     list, count);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* X, const void* C, int* idx, float* dist, long long N, int K, int d,
           uint8_t* image, float* c2, int* scratch, int* list, cudaStream_t st) {
  using St = typename Elem<T>::Storage;
  const int nks = steps_of(d, Elem<T>::kBytes);
  const int nch = (nks + kChunkSteps - 1) / kChunkSteps;
  const int ntiles = (K + kBN - 1) / kBN;
  const int Kp = ntiles * kBN;
  unsigned* cmax2 = reinterpret_cast<unsigned*>(scratch);
  int* count = scratch + 1;
  prep_kernel<T><<<(Kp + kPrepThreads - 1) / kPrepThreads, kPrepThreads, 0, st>>>(
      static_cast<const St*>(C), K, Kp, d, nch, image, c2, cmax2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the A fragments a thread keeps: the depth's k-steps, or 8 a chunk
#define REPRO_MAIN(KS, MULTI)                                                          \
  launch_main<T, KS, MULTI>(X, C, image, c2, cmax2, N, d, nks, nch, ntiles, idx, dist, \
                            list, count, st)
  int status;
  switch (nch > 1 ? 0 : nks) {
    case 1: status = REPRO_MAIN(1, false); break;
    case 2: status = REPRO_MAIN(2, false); break;
    case 3: status = REPRO_MAIN(3, false); break;
    case 4: status = REPRO_MAIN(4, false); break;
    case 5: status = REPRO_MAIN(5, false); break;
    case 6: status = REPRO_MAIN(6, false); break;
    case 7: status = REPRO_MAIN(7, false); break;
    case 8: status = REPRO_MAIN(8, false); break;
    default: status = REPRO_MAIN(8, true); break;
  }
#undef REPRO_MAIN
  if (status != 0) return status;
  recheck_kernel<T><<<8 * cached_sms(), kRecheckThreads, 0, st>>>(
      static_cast<const St*>(X), static_cast<const St*>(C), K, d, list, count, idx, dist);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the centroid tiles a call needs (the wrapper allocates them),
// or -1 for an unsupported shape.
long long repro_pdist_argmin_tc_image_bytes(int K, int d, int is_bf16) {
  if (K < 1 || d < 1) return -1;
  const int bytes = is_bf16 ? 2 : 4;
  const long long nks = steps_of(d, bytes);
  const long long nch = (nks + kChunkSteps - 1) / kChunkSteps;
  const long long ntiles = (K + kBN - 1) / kBN;
  return ntiles * nch * (is_bf16 ? 1 : 2) * kPlane;
}

// X (N, d), C (K, d): contiguous, both f32 (is_bf16 = 0) or both bf16
// (is_bf16 = 1); idx (N,) int32 and dist (N,) f32 out.  Scratch from the
// caller: image (repro_pdist_argmin_tc_image_bytes, 16-byte aligned),
// c2 (ceil(K / 64) * 64 f32), scratch (2 int32, zeroed: max |c|^2 and the
// flag count), list (N int32).  N, K, d >= 1 and N < 2^31.
int repro_pdist_argmin_tc(const void* X, const void* C, void* idx, void* dist, long long N,
                          int K, int d, int is_bf16, void* image, void* c2, void* scratch,
                          void* list, void* stream) {
  if (N < 1 || K < 1 || d < 1 || N > 0x7fffffffLL || (long long)K + kBN > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* i = static_cast<int*>(idx);
  float* o = static_cast<float*>(dist);
  uint8_t* im = static_cast<uint8_t*>(image);
  float* c = static_cast<float*>(c2);
  int* sc = static_cast<int*>(scratch);
  int* l = static_cast<int*>(list);
  return is_bf16 ? launch<Bf16>(X, C, i, o, N, K, d, im, c, sc, l, st)
                 : launch<float>(X, C, i, o, N, K, d, im, c, sc, l, st);
}

}  // extern "C"
