// The wg design of the attention kernels K2 (csrc/fused_mha_fwd.cu) and K5
// (csrc/fused_mha_bwd.cu): every head dim up to 128 other than 4 and 8, at
// the next of D = 16, 32, 64, 128 (the head's columns d .. D - 1 read as
// zero), on what Hopper added to the tensor cores.
//
//   * Products on wgmma. A block holds one or two consumer warpgroups of 64
//     own rows each (queries in K2 and in K5's dq kernel, keys in its dk/dv
//     kernel) and one producer warp. Every product is wgmma.mma_async with
//     the sum in registers: the scores (S = Q K^T, dP = dO V^T, and their
//     transposes in the dk/dv kernel) with both operands in shared memory,
//     the products fed back (P V, dS K, P^T dO, dS^T Q) with P or dS as the
//     A operand straight from the scores' accumulator layout. f32 runs as
//     .tf32 (k = 8), bf16 as .bf16 (k = 16).
//   * Loads by TMA. The producer warp keeps the other side's tiles (K and V,
//     or Q and dO) in a ring of shared-memory slots, one
//     cp.async.bulk.tensor per 16-byte column chunk of a tile, completion
//     on the slot's mbarrier; the consumers free a slot on another mbarrier
//     once their wgmmas on it have retired. The own rows come in the same
//     way once. A head whose rows TMA cannot describe (its stride in bytes
//     no multiple of 16: bf16 heads of 12 or 20, f32 heads of 6) is copied
//     by the same warp with cp.async (zero-filled past d), then the slot's
//     barrier is arrived on by every lane.
//   * One layout. Every tile of R rows lies in shared memory as [16-byte
//     column chunk][row][16 bytes]: wgmma's no-swizzle core matrices (8 rows
//     of 16 bytes) with no gaps, which is what the chunk-wise TMA writes. As
//     a K-major operand (the head dim contracted) its descriptor strides are
//     R * 16 bytes between chunks and 128 between 8-row groups; bf16 takes
//     the same tile as a transposed (MN-major) B operand contracted over its
//     rows, 128 bytes between 8-row groups and R * 16 between chunks.
//   * f32 is split, never rounded: each operand x is taken as hi = x rounded
//     to TF32 and lo = the rest cut to TF32, and each product is hi hi + hi
//     lo + lo hi (the lo lo term, below 2^-22 of the product, left out), as
//     the mma.sync designs compute it (csrc/mha_tiles.cuh). The consumers
//     split each tile after it lands: hi in place, lo beside it. .tf32 takes
//     no transposed operand, so a tile contracted over its rows (V in P V, K
//     in dS K, dO and Q in the dk/dv kernel) is also written transposed,
//     [4-row chunk][column][4 rows], the rows of each group of 8 in the
//     order PAIR_SLOTS (ops/attention.py): the A fragment of a k = 8 step
//     holds the scores' columns 2 tig and 2 tig + 1 at slots tig and tig + 4,
//     so the fed-back P is the accumulator's registers reordered, no
//     shuffle. In f32 q is multiplied by 1 / sqrt(d) before it is split, as
//     the JAX kernel scales it. bf16 operands are exact and the scale is on
//     the f32 scores.
//   * The fed-back P or dS stays f32: TF32 hi + lo (three products with the
//     split tile) in f32, a bf16 hi (cut) + lo (the rest, rounded) pair in
//     bf16 (two products with the tile), as the mma.sync designs feed it.
//
// Heads above 128 take the stream design (Stream, below; its kernels in the
// same two sources), built from these pieces: two consumer warpgroups and a
// producer warpgroup (setmaxnreg), the whole tile a TMA copy (bf16: a 5-d
// map whose box lands the same core-matrix layout), f32 split once in
// device memory (stream_prep_kernel) instead of in shared memory and its
// tiles swizzled by TMA (desc_s64, desc_v128).
#pragma once

#include <cuda.h>
#include <stdint.h>

#include "mha_tiles.cuh"

namespace mha {
namespace wg {

// ---------------------------------------------------------------------------
// the designs' sizes: consumer warpgroups (64 own rows each), rows of the
// other side a slot, slots; f32 tiles also take their split copies, so the
// widest f32 heads take one warpgroup and shorter tiles (227 KB of shared
// memory a block)
// ---------------------------------------------------------------------------
// floats after each 4-row chunk of a transposed f32 tile: with them the
// split's transposed stores meet two-way bank conflicts instead of four-way
constexpr int kTPad = 4;

template <typename T, int D>
struct Cfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kK = kF32 ? 8 : 16;    // the contraction of a step
  // K2: Q own; K, V a slot; f32: Klo, V^T hi, V^T lo
  static constexpr int kFwdWG = kF32 && D == 128 ? 1 : 2;
  static constexpr int kFwdKT = kF32 && D == 128 ? 32 : 64;
  static constexpr int kFwdSlots = 2;
  // K5 dq: Q, dO own; K, V a slot; f32: Klo, Vlo, K^T hi, K^T lo
  static constexpr int kDqWG = kF32 && D == 128 ? 1 : 2;
  static constexpr int kDqKT = (kF32 ? D >= 64 : D == 128) ? 32 : 64;
  static constexpr int kDqSlots = kF32 && D == 128 ? 1 : 2;
  // K5 dk/dv: K, V own; Q, dO a slot; f32: Qlo, dOlo, Q^T hi / lo, dO^T hi
  // / lo
  static constexpr int kKvWG = D == 128 ? 1 : 2;
  static constexpr int kKvKT =
      D == 128 ? (kF32 ? 16 : 32) : D == 64 && kF32 ? 32 : 64;
  static constexpr int kKvSlots = 2;

  static constexpr size_t tile(int rows) {
    return static_cast<size_t>(rows) * D * sizeof(T);
  }
  // floats of an f32 work tile of `rows` rows (room for the transposed
  // layout's padding)
  __host__ __device__ static constexpr int work(int rows) {
    return rows * D + rows / 4 * kTPad;
  }
  // shared memory of each kernel: own tiles, slots, f32 work tiles, then
  // the barriers
  static constexpr size_t fwd_smem() {
    return (kF32 ? 2 : 1) * tile(64 * kFwdWG) + kFwdSlots * 2 * tile(kFwdKT) +
           (kF32 ? 3 : 0) * work(kFwdKT) * sizeof(float) + 128;
  }
  static constexpr size_t dq_smem() {
    return (kF32 ? 4 : 2) * tile(64 * kDqWG) + kDqSlots * 2 * tile(kDqKT) +
           (kF32 ? 4 : 0) * work(kDqKT) * sizeof(float) + 128;
  }
  static constexpr size_t kv_smem() {
    return (kF32 ? 4 : 2) * tile(64 * kKvWG) + kKvSlots * 2 * tile(kKvKT) +
           (kF32 ? 6 : 0) * work(kKvKT) * sizeof(float) + 128;
  }
};

constexpr size_t kMaxSmem = 232448;
static_assert(Cfg<float, 128>::fwd_smem() <= kMaxSmem &&
                  Cfg<float, 128>::dq_smem() <= kMaxSmem &&
                  Cfg<float, 128>::kv_smem() <= kMaxSmem &&
                  Cfg<float, 64>::fwd_smem() <= kMaxSmem &&
                  Cfg<float, 64>::dq_smem() <= kMaxSmem &&
                  Cfg<float, 64>::kv_smem() <= kMaxSmem,
              "the wg design's shared memory");

// ---------------------------------------------------------------------------
// the stream design (head dims above 128; csrc/fused_mha_fwd.cu and
// csrc/fused_mha_bwd.cu say how it runs): a block of two consumer
// warpgroups and a producer warpgroup owns OC output columns (192 or 256;
// wider heads in column chunks of OC, a grid axis). The other side's rows
// stream through a ring of slots in stages: a score stage holds a tile of
// them at SC dims (kSCW) of each of its kNP parts, a value stage at VC of
// the block's columns. RES (bf16 heads up to 256 wide): the block's own
// rows stay resident, loaded once, and a score stage holds the other
// side's whole tile; the dq and dk/dv kernels then feed their fed-back
// products from the same stage. Else the own rows stream in each score
// stage too, 128 bytes of each row. f32 operands come split once in device
// memory (stream_prep_kernel: TF32 hi and lo, the parts), so f32 runs the
// loop bf16 runs, its tiles in TMA's swizzled layouts (desc_s64, desc_v128):
// a row's 64 bytes a score stage, a transposed row's 128 bytes a value
// stage, each one piece of a copy, where the bf16 tiles' core-matrix layout
// takes 16 bytes a piece.
// ---------------------------------------------------------------------------
template <typename T, int OC, bool RES = false>
struct Stream {
  static constexpr bool kF32 = sizeof(T) == 4;
  static_assert(!(kF32 && RES), "f32 heads stream");
  static constexpr int kK = kF32 ? 8 : 16;    // the contraction of a step
  static constexpr int kNP = kF32 ? 2 : 1;    // parts of an operand
  static constexpr int kSC = 128 / static_cast<int>(sizeof(T)) / kNP;
  static constexpr int kSCW = RES ? OC : kSC;   // dims a score stage
  static constexpr int kWG = 2;               // consumer warpgroups
  // K2: 64 queries a warpgroup; (q and) k, or v^T (f32) / v (bf16)
  static constexpr int kFwdRows = 128;
  static constexpr int kFwdKT = 64;
  static constexpr int kFwdVC = kF32 ? 64 : OC;
  static constexpr int kFwdSlots = RES ? 4 : 6;
  // K5 dq: 64 queries a warpgroup; (q, dO,) k, v, or k^T / k
  static constexpr int kDqRows = 128;
  static constexpr int kDqKT = kF32 ? 64 : 32;
  static constexpr int kDqVC = kF32 ? 64 : OC;
  static constexpr int kDqSlots = RES ? 3 : kF32 ? 4 : 5;
  // K5 dk/dv: the block's 64 keys, dV on warpgroup 0, dK on 1; (k, v,) q,
  // dO, or q^T and dO^T / q and dO
  static constexpr int kKvRows = 64;
  static constexpr int kKvKT = kF32 ? 64 : 32;
  static constexpr int kKvVC = kF32 ? 32 : OC;
  static constexpr int kKvSlots = RES ? 4 : 6;

  // f32 value tiles come in two copies of 32 rows (stream_tile_t)
  static_assert(!kF32 || (kFwdKT == 64 && kDqKT == 64 && kKvKT == 64),
                "f32 tiles of 64 rows");

  __host__ __device__ static constexpr int mx(int a, int b) {
    return a > b ? a : b;
  }
  // elements of the resident own rows (RES)
  __host__ __device__ static constexpr int fwd_own() {
    return RES ? kFwdRows * OC : 0;
  }
  __host__ __device__ static constexpr int dq_own() {
    return RES ? 2 * kDqRows * OC : 0;
  }
  __host__ __device__ static constexpr int kv_own() {
    return RES ? 2 * kKvRows * OC : 0;
  }
  // elements of a slot (every part): a score stage's own rows (streamed)
  // and other side's tile, or a value stage
  __host__ __device__ static constexpr int fwd_slot() {
    return kNP * mx((RES ? 0 : kFwdRows * kSC) + kFwdKT * kSCW,
                    kFwdKT * kFwdVC);
  }
  __host__ __device__ static constexpr int dq_slot() {
    return kNP * mx(2 * ((RES ? 0 : kDqRows * kSC) + kDqKT * kSCW),
                    RES ? 0 : kDqKT * kDqVC);
  }
  __host__ __device__ static constexpr int kv_slot() {
    return kNP * mx(2 * ((RES ? 0 : kKvRows * kSC) + kKvKT * kSCW),
                    RES ? 0 : 2 * kKvKT * kKvVC);
  }
  // floats of the dk/dv kernel's P^T buffers (two, by the tile's parity)
  __host__ __device__ static constexpr int kv_pbuf() {
    return 2 * kKvRows * kKvKT;
  }
  // bytes before the first tile: f32's swizzled tiles start on 1024-byte
  // boundaries (stream_base)
  static constexpr size_t kAlign = kF32 ? 1024 : 0;
  // shared memory of each kernel: (the alignment,) own rows, slots, (P^T),
  // the barriers
  static constexpr size_t fwd_smem() {
    return kAlign + (static_cast<size_t>(fwd_own()) +
                     kFwdSlots * fwd_slot()) * sizeof(T) + 256;
  }
  static constexpr size_t dq_smem() {
    return kAlign + (static_cast<size_t>(dq_own()) +
                     kDqSlots * dq_slot()) * sizeof(T) + 256;
  }
  static constexpr size_t kv_smem() {
    return kAlign + (static_cast<size_t>(kv_own()) +
                     kKvSlots * kv_slot()) * sizeof(T) +
           static_cast<size_t>(kv_pbuf()) * 4 + 256;
  }
  static constexpr bool fits() {
    return fwd_smem() <= kMaxSmem && dq_smem() <= kMaxSmem &&
           kv_smem() <= kMaxSmem;
  }
};
static_assert(Stream<float, 256>::fits() && Stream<float, 192>::fits() &&
                  Stream<__nv_bfloat16, 256>::fits() &&
                  Stream<__nv_bfloat16, 192>::fits() &&
                  Stream<__nv_bfloat16, 256, true>::fits() &&
                  Stream<__nv_bfloat16, 192, true>::fits(),
              "the stream design's shared memory");

// the prepared f32 operands: head-major (B, H, L, dp) with dp = d padded
// to 16 (columns past d zero), and transposed (B, H, d, L8) with L8 = L
// padded to 8 (rows past L zero), the rows of each 8 in PAIR_SLOTS order
inline size_t stream_dp(int d) {
  return (static_cast<size_t>(d) + 15) / 16 * 16;
}
inline size_t stream_l8(int L) {
  return (static_cast<size_t>(L) + 7) / 8 * 8;
}

// x (B, L, H d) f32 times f, split into TF32 hi (rounded) and lo (the rest,
// cut), as split_tile splits a tile: written head-major to hi / lo (when
// hi is not null) and transposed to thi / tlo (when thi is not null). Grid
// (ceil(H dp / 32), ceil(L8 / 32), B), 32 x 8 threads; a block transposes
// its 32 x 32 tile through shared memory. Static: K5's two translation
// units (csrc/fused_mha_bwd.cu, fused_mha_bwd_stream.cu) both include it.
static __global__ void __launch_bounds__(256)
stream_prep_kernel(const float* __restrict__ x, float* __restrict__ hi,
                   float* __restrict__ lo, float* __restrict__ thi,
                   float* __restrict__ tlo, int L, int L8, int H, int d,
                   int dp, float f) {
  __shared__ float sh[32][33], sl[32][33];
  const int b = blockIdx.z, cv0 = blockIdx.x * 32, l0 = blockIdx.y * 32;
  const size_t C = static_cast<size_t>(H) * d;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int l = l0 + i, cv = cv0 + threadIdx.x;
    const int h = cv / dp, j = cv % dp;
    const size_t at = (static_cast<size_t>(b) * L + l) * C + h * d + j;
    const float a = l < L && h < H && j < d ? x[at] * f : 0.f;
    unsigned uh, ul;
    split_tf32(a, uh, ul);
    if (hi != nullptr && l < L && h < H) {
      const size_t o =
          ((static_cast<size_t>(b) * H + h) * L + l) * dp + j;
      hi[o] = __uint_as_float(uh);
      lo[o] = __uint_as_float(ul);
    }
    sh[i][threadIdx.x] = __uint_as_float(uh);
    sl[i][threadIdx.x] = __uint_as_float(ul);
  }
  if (thi == nullptr) return;
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int cv = cv0 + i, l = l0 + threadIdx.x;
    const int h = cv / dp, j = cv % dp;
    if (h >= H || j >= d || l >= L8) continue;
    const int pos = (l & ~7) | ((l & 1) << 2) | ((l & 7) >> 1);
    const size_t o = ((static_cast<size_t>(b) * H + h) * d + j) * L8 + pos;
    thi[o] = sh[threadIdx.x][i];
    tlo[o] = sl[threadIdx.x][i];
  }
}

inline cudaError_t stream_prep(const void* x, float* hi, float* lo,
                               float* thi, float* tlo, int B, int L, int H,
                               int d, float f, cudaStream_t stream) {
  const int dp = static_cast<int>(stream_dp(d));
  const int l8 = static_cast<int>(stream_l8(L));
  stream_prep_kernel<<<dim3((H * dp + 31) / 32, (l8 + 31) / 32, B),
                       dim3(32, 8), 0, stream>>>(
      static_cast<const float*>(x), hi, lo, thi, tlo, L, l8, H, d, dp, f);
  return cudaGetLastError();
}

// the stream design's output columns a block for head dim d (above 128):
// 192 up to 192, 256 up to 256; wider heads in column chunks of whichever
// of the two pads d the least (256 on a tie: fewer chunks)
inline int stream_out(int d) {
  if (d <= 192) return 192;
  if (d <= 256) return 256;
  const int p192 = (d + 191) / 192 * 192, p256 = (d + 255) / 256 * 256;
  return p192 < p256 ? 192 : 256;
}
template <class F>
cudaError_t at_stream_width(int oc, F&& f) {
  if (oc == 192) return f(std::integral_constant<int, 192>{});
  return f(std::integral_constant<int, 256>{});
}
// whether the stream design keeps a block's own rows resident: bf16 heads
// of one column chunk (d up to 256)
inline bool stream_resident(int d, bool bf16) { return bf16 && d <= 256; }

// ---------------------------------------------------------------------------
// barriers, TMA, wgmma
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// arrive, and expect `bytes` more of TMA before the phase completes
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}
// until the phase of this parity has completed; a wait past ~2^35 clocks
// (some 20 s) traps, so that a fault shows as a failed launch and not as a
// hung card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 35)) {
      __trap();
    }
  }
}
// this thread's writes to shared memory, seen by the async proxy (wgmma)
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the consumer warpgroups alone (named barrier 1)
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_addr(bar))
      : "memory");
}
// a whole tile by one copy from a 5-d map (csrc/mha_wg.cuh: make_map5)
__device__ __forceinline__ void tma_load5(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving a register's reads or writes across an
// in-flight wgmma (before the fence, after the wait)
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(unsigned (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// a shared-memory matrix descriptor, no swizzle: start, the byte offsets
// between core matrices along the contraction (lbo) and along the rows or
// columns (sbo)
__device__ __forceinline__ uint64_t desc(const void* p, unsigned lbo,
                                         unsigned sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}
// step s of a K-major operand: rows r0 .. of a tile of R rows (one step:
// two 16-byte chunks)
template <int R>
__device__ __forceinline__ uint64_t desc_k(const void* tile, int s,
                                           int r0 = 0) {
  return desc(static_cast<const char*>(tile) + (2 * s * R + r0) * 16, R * 16,
              128);
}
// step s of an f32 tile written transposed (rows contracted, 8 a step):
// [4-row chunk][column of D][4], kTPad floats after each chunk
template <int D>
__device__ __forceinline__ uint64_t desc_t(const void* tile, int s) {
  constexpr int kChunk = D * 16 + kTPad * 4;   // bytes
  return desc(static_cast<const char*>(tile) + 2 * s * kChunk, kChunk, 128);
}
// step s of a bf16 tile of R rows as the transposed B operand (rows
// contracted, 16 a step)
template <int R>
__device__ __forceinline__ uint64_t desc_mn(const void* tile, int s) {
  return desc(static_cast<const char*>(tile) + s * 256, 128, R * 16);
}

// wgmma.mma_async, d += a b: ss (both operands in shared memory, K-major)
// for the scores at N = the other side's rows, rs (a from registers) for
// the fed-back products at N = D, or the stream design's value columns
// (bf16: b transposed)
// (generated: one specialisation a shape)
template <int N> __device__ void wg_ss_tf32(float (&d)[N / 2], uint64_t a, uint64_t b, int acc);
template <> __device__ __forceinline__ void wg_ss_tf32<16>(float (&d)[8], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(acc));
}
template <> __device__ __forceinline__ void wg_ss_tf32<32>(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}
template <> __device__ __forceinline__ void wg_ss_tf32<64>(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}
template <int N> __device__ void wg_ss_bf16(float (&d)[N / 2], uint64_t a, uint64_t b, int acc);
template <> __device__ __forceinline__ void wg_ss_bf16<16>(float (&d)[8], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(acc));
}
template <> __device__ __forceinline__ void wg_ss_bf16<32>(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}
template <> __device__ __forceinline__ void wg_ss_bf16<64>(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}
template <int N> __device__ void wg_rs_tf32(float (&d)[N / 2], const unsigned (&a)[4], uint64_t b, int acc);
template <> __device__ __forceinline__ void wg_rs_tf32<16>(float (&d)[8], const unsigned (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
template <> __device__ __forceinline__ void wg_rs_tf32<32>(float (&d)[16], const unsigned (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
template <> __device__ __forceinline__ void wg_rs_tf32<64>(float (&d)[32], const unsigned (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
template <> __device__ __forceinline__ void wg_rs_tf32<128>(float (&d)[64], const unsigned (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
template <int N> __device__ void wg_rs_bf16(float (&d)[N / 2], const unsigned (&a)[4], uint64_t b, int acc);
template <> __device__ __forceinline__ void wg_rs_bf16<16>(float (&d)[8], const unsigned (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
template <> __device__ __forceinline__ void wg_rs_bf16<32>(float (&d)[16], const unsigned (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
template <> __device__ __forceinline__ void wg_rs_bf16<64>(float (&d)[32], const unsigned (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
template <> __device__ __forceinline__ void wg_rs_bf16<128>(float (&d)[64], const unsigned (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <> __device__ __forceinline__ void wg_rs_bf16<192>(float (&d)[96], const unsigned (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
template <> __device__ __forceinline__ void wg_rs_bf16<256>(float (&d)[128], const unsigned (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// ---------------------------------------------------------------------------
// loads (the producer warp)
// ---------------------------------------------------------------------------
// rows row0 .. row0 + R - 1, columns col0 .. col0 + D - 1 of one head into
// a tile [chunk][row][16 bytes]: TMA (vec 0: lane 0, one copy a chunk, by
// the head's map (d, L, H, B): columns from d on and rows past the tensor
// read as zero), or, for heads whose stride TMA cannot take (d * sizeof(T)
// no multiple of 16: bf16 heads of 12 or 20, f32 heads of 6; or where the
// map was refused), cp.async by the warp's lanes, vec (2, 4, 8, 16) bytes a
// copy, zero-filled past nrows and d (2: through registers). src: the
// head's column 0 of row 0 (row stride C).
template <typename T, int D, int R, int V>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, int row0,
                                          int nrows, int C, int d,
                                          int lane, int col0) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  constexpr int kPer = V / static_cast<int>(sizeof(T));   // elements a copy
  constexpr int kPieces = 16 / V;                         // copies a chunk
#pragma unroll 4
  for (int i = lane; i < R * (D / E) * kPieces; i += 32) {
    const int p = i % kPieces, r = (i / kPieces) % R, c = i / (kPieces * R);
    const int col = col0 + c * E + p * kPer, row = row0 + r;
    const bool valid = row < nrows && col < d;
    const T* s = valid ? src + static_cast<size_t>(row) * C + col : src;
    char* t = reinterpret_cast<char*>(dst + (c * R + r) * E) + p * V;
    if constexpr (V >= 4) {
      cp_async<V>(t, s, valid);
    } else {
      *reinterpret_cast<unsigned short*>(t) =
          valid ? *reinterpret_cast<const unsigned short*>(s)
                : static_cast<unsigned short>(0);
    }
  }
}

template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(T* dst, const CUtensorMap* map,
                                          uint64_t* bar, const T* src,
                                          int row0, int nrows, int h, int b,
                                          int C, int d, int vec, int lane,
                                          int col0 = 0) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  if (vec == 0) {
    if (lane == 0) {
#pragma unroll 1
      for (int c = 0; c < D / E; ++c)
        tma_load(dst + c * R * E, map, bar, col0 + c * E, row0, h, b);
    }
  } else if (vec == 16) {   // TMA refused the tensor (make_map)
    copy_tile<T, D, R, 16>(dst, src, row0, nrows, C, d, lane, col0);
  } else if (vec == 8) {
    copy_tile<T, D, R, 8>(dst, src, row0, nrows, C, d, lane, col0);
  } else if (vec == 4) {
    copy_tile<T, D, R, 4>(dst, src, row0, nrows, C, d, lane, col0);
  } else {
    copy_tile<T, D, R, 2>(dst, src, row0, nrows, C, d, lane, col0);
  }
}
// after the lanes' load_tile calls for one barrier phase: TMA arrives once
// with the bytes to expect (before the copies); without TMA every lane
// arrives (the barrier's count: 1 with TMA, 32 without), its cp.async
// copies tracked by the barrier (the arrival comes when they have landed,
// so the warp goes on to the next slot), its copies through registers
// fenced first. The consumers fence cp.async data for wgmma after their
// wait (landed()).
__device__ __forceinline__ void loaded(uint64_t* bar, int vec) {
  if (vec == 0) return;
  if (vec == 2) {
    fence_async();
    mbar_arrive(bar);
    return;
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}
// a barrier's arrivals a phase
__device__ __forceinline__ unsigned arrivals(int vec) {
  return vec == 0 ? 1 : 32;
}
// a consumer's wait for a slot (or the own tiles) to land
__device__ __forceinline__ void landed(uint64_t* bar, unsigned parity,
                                       int vec) {
  mbar_wait(bar, parity);
  if (vec != 0) fence_async();   // cp.async writes, read by wgmma
}

// the stream design's tensor maps: bf16 the inputs' (m[i] for operand i),
// f32 the prepared parts' (m[2 i] hi, m[2 i + 1] lo); the dk/dv kernel's
// six f32 operands take all twelve
struct StreamMaps {
  CUtensorMap m[12];
};

// the f32 stream design's tiles, swizzled by TMA as wgmma's K-major
// swizzled layouts read them (start on the swizzle's 512- or 1024-byte
// boundary, stream_base): step s (8 dims) of a score tile, R rows of 16
// dims (64 bytes, 64-byte swizzle), from its row r0 on; step s (8 keys) of
// a value tile of W columns of a prepared transposed operand, two halves of
// W rows x 32 keys (128 bytes, 128-byte swizzle)
__device__ __forceinline__ uint64_t desc_s64(const void* tile, int s,
                                             int r0 = 0) {
  return desc(static_cast<const char*>(tile) + r0 * 64 + s * 32, 16, 512) |
         (2ull << 62);
}
template <int W>
__device__ __forceinline__ uint64_t desc_v128(const void* tile, int s) {
  return desc(static_cast<const char*>(tile) + (s >> 2) * W * 128 +
                  (s & 3) * 32,
              16, 1024) |
         (1ull << 62);
}
// step s of a score tile of R rows: bf16's core-matrix layout, f32's
// swizzled one
template <typename T, int R>
__device__ __forceinline__ uint64_t desc_score(const void* tile, int s,
                                               int r0 = 0) {
  if constexpr (sizeof(T) == 4)
    return desc_s64(tile, s, r0);
  else
    return desc_k<R>(tile, s, r0);
}
// the stream design's first tile: f32 rounds the block's shared memory up
// to 1024 bytes (Stream::kAlign)
template <typename T>
__device__ __forceinline__ unsigned char* stream_base(unsigned char* smem) {
  if constexpr (sizeof(T) == 4)
    return smem + ((1024u - (smem_addr(smem) & 1023u)) & 1023u);
  else
    return smem;
}
// the stream design's tiles, one TMA copy each (lane 0): bf16 rows row0
// .. of a head-major input at the 16-byte chunks from col0 on, laid
// [chunk][row][16 bytes] by a 5-d map whose box is the tile (with vec != 0
// copied by cp.async, load_tile); f32 rows row0 .. x dims col0 .. col0 + 15
// of a prepared head-major operand, swizzled (map_prep). stream_tile_t:
// columns col0 .. col0 + W - 1 x rows (keys or queries) row0 .. row0 + 63
// of a prepared transposed operand, swizzled, two copies of 32 rows
// (map_prep_t)
template <typename T, int W, int R>
__device__ __forceinline__ void stream_tile(T* dst, const CUtensorMap* map,
                                            uint64_t* bar, const T* src,
                                            int row0, int nrows, int h, int b,
                                            int C, int d, int vec, int lane,
                                            int col0) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  if constexpr (sizeof(T) == 4) {
    if (lane == 0) tma_load(dst, map, bar, col0, row0, h, b);
  } else if (vec != 0) {
    load_tile<T, W, R>(dst, map, bar, src, row0, nrows, h, b, C, d, vec,
                       lane, col0);
  } else if (lane == 0) {
    tma_load5(dst, map, bar, 0, row0, col0 / E, h, b);
  }
}
template <int W>
__device__ __forceinline__ void stream_tile_t(float* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int row0,
                                              int col0, int h, int b,
                                              int lane) {
  if (lane == 0) {
    tma_load(dst, map, bar, row0, col0, h, b);
    tma_load(dst + W * 32, map, bar, row0 + 32, col0, h, b);
  }
}

// the producer warpgroup gives up registers, the two consumer warpgroups
// take them (a block's 384 threads get 168 each at launch: 40 and 232 use
// the same 64,512)
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}
// all but the newest committed group of wgmma done
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// the f32 split (the consumer threads, after a tile lands)
// ---------------------------------------------------------------------------
// a tile of R rows [chunk][row][4 floats]: x times f, split into hi
// (rounded to TF32) and lo (the rest, cut to TF32). kSame: hi in place, lo
// into `lo` in the same layout; kTrans: hi and lo transposed into thi /
// tlo, [4-row chunk][column][4 rows] (kTPad floats after each chunk), the
// rows of each 8 in PAIR_SLOTS order (row 2 j at slot j, row 2 j + 1 at
// slot j + 4). A warp takes 8 rows of 4 chunks: its reads are 4 runs of
// 128 bytes.
template <int R, int D, bool kSame, bool kTrans>
__device__ __forceinline__ void split_tile(float* x, float* lo, float* thi,
                                           float* tlo, float f, int tid,
                                           int nthreads) {
  constexpr int NCH = D / 4;
  for (int i = tid; i < R * NCH; i += nthreads) {
    const int c = (i >> 3) % NCH, r = (i & 7) + 8 * (i / (8 * NCH));
    float4* px = reinterpret_cast<float4*>(x) + c * R + r;
    const float4 v = *px;
    const float a[4] = {v.x * f, v.y * f, v.z * f, v.w * f};
    unsigned hi[4], lw[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(a[e], hi[e], lw[e]);
    if constexpr (kSame) {
      *reinterpret_cast<uint4*>(px) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      reinterpret_cast<uint4*>(lo)[c * R + r] =
          make_uint4(lw[0], lw[1], lw[2], lw[3]);
    }
    if constexpr (kTrans) {
      const int k = (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
      const int base = (k >> 2) * (D * 4 + kTPad) + (k & 3) + 16 * c;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        reinterpret_cast<unsigned*>(thi)[base + 4 * e] = hi[e];
        reinterpret_cast<unsigned*>(tlo)[base + 4 * e] = lw[e];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the fed-back operand from the scores' accumulator layout: a thread holds
// rows g, g + 8 of its warp's 16 at columns 8 j + 2 tig (+1), registers
// p[4 j .. 4 j + 3] = (g, 2 tig), (g, 2 tig + 1), (g + 8, 2 tig), (g + 8,
// 2 tig + 1)
// ---------------------------------------------------------------------------
// f32, step j (columns 8 j ..): a0..a3 = (g, slot tig), (g + 8, slot tig),
// (g, slot tig + 4), (g + 8, slot tig + 4), slot tig holding column 2 tig
// and slot tig + 4 column 2 tig + 1; hi cut to TF32, lo the rest (read by
// the tensor cores as TF32)
template <int N>
__device__ __forceinline__ void feed_tf32(unsigned (&hi)[N / 8][4],
                                          unsigned (&lo)[N / 8][4],
                                          const float (&p)[N / 2]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float v[4] = {p[4 * j], p[4 * j + 2], p[4 * j + 1], p[4 * j + 3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hi[j][i] = __float_as_uint(v[i]) & 0xffffe000u;
      lo[j][i] = __float_as_uint(v[i] - __uint_as_float(hi[j][i]));
    }
  }
}
// bf16, step j (columns 16 j ..): a0..a3 = (g, 2 tig, 2 tig + 1), (g + 8,
// ..), (g, 8 + 2 tig, ..), (g + 8, 8 + 2 tig, ..) in the columns' own
// order; hi cut to bf16, lo the rest rounded to bf16
template <int N>
__device__ __forceinline__ void feed_bf16(unsigned (&hi)[N / 16][4],
                                          unsigned (&lo)[N / 16][4],
                                          const float (&p)[N / 2]) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = p[8 * j + 2 * i], y = p[8 * j + 2 * i + 1];
      const unsigned hx = __float_as_uint(x) & 0xffff0000u;
      const unsigned hy = __float_as_uint(y) & 0xffff0000u;
      hi[j][i] = __byte_perm(hx, hy, 0x7632);
      const __nv_bfloat162 l = __floats2bfloat162_rn(
          x - __uint_as_float(hx), y - __uint_as_float(hy));
      lo[j][i] = *reinterpret_cast<const unsigned*>(&l);
    }
}

// rows row (of g) and row + 8 of out = acc x f[hf], columns below d; out:
// the head's column 0 of row 0, row stride ld
template <int D, typename OutT>
__device__ __forceinline__ void store_rows(OutT* out,
                                           const float (&acc)[D / 2],
                                           const float (&f)[2], int row,
                                           int nrows, int ld, int d,
                                           int tig) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row + 8 * hf;
    if (r >= nrows) continue;
    OutT* p = out + static_cast<size_t>(r) * ld;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * tig;
      const float x = acc[4 * j + 2 * hf] * f[hf];
      const float y = acc[4 * j + 2 * hf + 1] * f[hf];
      if (col + 1 < d && (d & 1) == 0) {
        if constexpr (std::is_same_v<OutT, float>)
          *reinterpret_cast<float2*>(p + col) = make_float2(x, y);
        else
          *reinterpret_cast<__nv_bfloat162*>(p + col) =
              __floats2bfloat162_rn(x, y);
        continue;
      }
      if constexpr (std::is_same_v<OutT, float>) {
        if (col < d) p[col] = x;
        if (col + 1 < d) p[col + 1] = y;
      } else {
        if (col < d) p[col] = __float2bfloat16_rn(x);
        if (col + 1 < d) p[col + 1] = __float2bfloat16_rn(y);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host: the tensor maps
// ---------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// how the producer copies a head's rows (load_tile): 0 (TMA) where a
// head's row of d elements is a multiple of 16 bytes (the tensors start on
// 16 bytes), else the bytes of a cp.async copy
inline int copy_mode(int d, int elem) {
  return d * elem % 16 == 0 ? 0 : copy_bytes(d * elem);
}

// launches that took cp.async because a tensor map was refused, and the
// last refusal's CUresult, for the wrappers' reports
inline int& tma_refused() {
  static int n = 0;
  return n;
}
inline int& tma_error() {
  static int e = 0;
  return e;
}

// the map of a (B, L, H * d) tensor as (d, L, H, B), boxes of one 16-byte
// chunk of `rows` rows, for copy mode vec (none without TMA); false if the
// encoding is refused (its CUresult in tma_error())
inline bool make_map(CUtensorMap* map, const void* base, bool bf16, int B,
                     int L, int H, int d, int rows, int vec) {
  if (vec != 0) return true;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) {
    tma_error() = -1;
    return false;
  }
  const int elem = bf16 ? 2 : 4;
  const cuuint64_t C = static_cast<cuuint64_t>(H) * d;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {C * elem, static_cast<cuuint64_t>(d) * elem,
                                 C * elem * L};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(16 / elem),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map,
      bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      4, const_cast<void*>(base), dims, strides, box, one,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) tma_error() = static_cast<int>(r);
  return r == CUDA_SUCCESS;
}

// a 5-d map whose box is a whole tile of the stream design: dims
// innermost first (dim 0: the 16 bytes of a core-matrix row, contiguous),
// strides of dims 1-4 in bytes, box (16 bytes, b1, b2, 1, 1), so that the
// tile lands [dim 2][dim 1][16 bytes]; false if refused
inline bool make_map5(CUtensorMap* map, const void* base, bool bf16,
                      const cuuint64_t (&dims)[5],
                      const cuuint64_t (&strides)[4], cuuint32_t b1,
                      cuuint32_t b2) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) {
    tma_error() = -1;
    return false;
  }
  const cuuint32_t box[5] = {bf16 ? 8u : 4u, b1, b2, 1, 1};
  const cuuint32_t one[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map,
      bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      5, const_cast<void*>(base), dims, strides, box, one,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) tma_error() = static_cast<int>(r);
  return r == CUDA_SUCCESS;
}
// a bf16 input (B, L, H d) as tiles of `rows` rows x `cols` columns
// (chunks of 8: columns past d and rows past L read as zero); d * 2 a
// multiple of 16
inline bool map_in(CUtensorMap* map, const void* base, int B, int L, int H,
                   int d, int rows, int cols) {
  const cuuint64_t C = static_cast<cuuint64_t>(H) * d;
  return make_map5(map, base, true,
                   {8, static_cast<cuuint64_t>(L),
                    static_cast<cuuint64_t>(d) / 8,
                    static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)},
                   {C * 2, 16, static_cast<cuuint64_t>(d) * 2, C * 2 * L},
                   rows, cols / 8);
}
// a 4-d f32 map (dims innermost first, strides of dims 1-3 in bytes) with
// boxes (b0, b1, 1, 1) in TMA's swizzle `sw`; false if refused
inline bool make_map_sw(CUtensorMap* map, const float* base,
                        const cuuint64_t (&dims)[4],
                        const cuuint64_t (&strides)[3], cuuint32_t b0,
                        cuuint32_t b1, CUtensorMapSwizzle sw) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) {
    tma_error() = -1;
    return false;
  }
  const cuuint32_t box[4] = {b0, b1, 1, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(base), dims,
      strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) tma_error() = static_cast<int>(r);
  return r == CUDA_SUCCESS;
}
// a prepared head-major operand (B, H, L, dp) as tiles of `rows` rows x 16
// columns (a score stage's), 64-byte swizzle (desc_s64)
inline bool map_prep(CUtensorMap* map, const float* base, int B, int L,
                     int H, int d, int rows) {
  const cuuint64_t dp = stream_dp(d), l = static_cast<cuuint64_t>(L);
  return make_map_sw(map, base,
                     {dp, l, static_cast<cuuint64_t>(H),
                      static_cast<cuuint64_t>(B)},
                     {dp * 4, dp * 4 * l, dp * 4 * l * H}, 16, rows,
                     CU_TENSOR_MAP_SWIZZLE_64B);
}
// a prepared transposed operand (B, H, d, L8) as halves of 32 rows of the
// operand (its contiguous dim) x `cols` columns, 128-byte swizzle
// (desc_v128; stream_tile_t copies two a tile)
inline bool map_prep_t(CUtensorMap* map, const float* base, int B, int L,
                       int H, int d, int cols) {
  const cuuint64_t l8 = stream_l8(L), dd = static_cast<cuuint64_t>(d);
  return make_map_sw(map, base,
                     {l8, dd, static_cast<cuuint64_t>(H),
                      static_cast<cuuint64_t>(B)},
                     {l8 * 4, l8 * 4 * dd, l8 * 4 * dd * H}, 32, cols,
                     CU_TENSOR_MAP_SWIZZLE_128B);
}

// f(D) at the smallest D of 16, 32, 64, 128 that holds head dim d
template <class F>
cudaError_t at_width(int d, F&& f) {
  if (d <= 16) return f(std::integral_constant<int, 16>{});
  if (d <= 32) return f(std::integral_constant<int, 32>{});
  if (d <= 64) return f(std::integral_constant<int, 64>{});
  return f(std::integral_constant<int, 128>{});
}

}  // namespace wg
}  // namespace mha
