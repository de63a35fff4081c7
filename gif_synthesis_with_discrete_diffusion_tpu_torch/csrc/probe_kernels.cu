// The measurement probes' kernels (Hopper): a small f32 product for the
// build-cache probe, and chains of dependent bf16 tensor-core products for
// the depth / packing probe.
//
// Replace the TPU kernels of the JAX package's scripts:
//   probe_matmul  <- scripts/compile_cache_probe.py: kern
//                    o = (a @ a) * 2, a (n, n) f32
//   probe_chain   <- scripts/depth_pack_probe.py: _chain_kernel (one chain)
//                    and _pair_kernel (two independent chains an iteration)
//                    x <- bf16(0.01 * (x @ w)[:, :k]), `iters` times, f32
//                    accumulation, then sum(x); x (m, k) bf16, w (k, n) bf16
//
// probe_matmul. At (256, 256) the work is 33.6 MFLOP, 0.5 us at the card's
// f32 rate, so what bounds a launch is latency: the round trips to L2 and
// the launch itself. A block owns a 32 x 16 output tile and issues every
// load of its row and column panels at once (cp.async, one commit group a
// 64-deep chunk, four chunks in flight: all of n <= 256), then computes each
// chunk as it lands. Its eight warps split every chunk's depth, each thread
// keeping a 4 x 4 register tile (16 independent FMA chains), and the eight
// partial tiles are added in a fixed order at the end; 128 blocks at
// n = 256. The arithmetic is f32 FMAs on the CUDA cores: exact f32 products
// and f32 sums, so within 1e-4 of the plain version by far. Plain TF32 on
// the tensor cores would miss that (10-bit mantissas: ~5e-4 a product), and
// split TF32 (three products, as the codebook kernel) would save at most a
// fraction of the 0.5 us of arithmetic, under the round trip.
//
// probe_chain. The TPU kernel parks x and all of w in one core's on-chip
// memory and loops. Here w (2 MB at (64, 16384), 8 MB at (128, 32768)) fits
// no block's 227 KB but does fit the card's shared memory taken together, so
// at most one block an SM owns a column slab of w, staged into shared
// memory once and kept there for all iterations. Two designs:
//
// * local (one or two chains, k <= 128, slabs of at most 256 columns, where
//   the chains' copies fit: one chain at the QK and packed shapes and the
//   depth curve's first two, the pair at the QK shape): every block also
//   keeps x and the head w[:, :k] of each chain and computes the chains'
//   next x itself (chain_local_kernel<K, NC>). A row of the next x
//   depends on the same row of x alone, so each warp owns 32 rows of one
//   chain and runs them on its own, 8 warps a chain: the pair's 16 warps
//   put two warps of each chain on every SM sub-partition, so that the two
//   chains' products overlap. A warp reads its rows of x into registers as
//   mma fragments once an iteration; the head's product (32, k) x (k, k),
//   rounded, is written over x as each head sub-tile is done; then the
//   slab's products of its two row tiles accumulate into one tile in the
//   tensor cores (the checksum sums over rows) and from there into the
//   checksum's partial sums in registers. x never leaves the SM; there is
//   no grid barrier, no block barrier and no L2 round trip in the loop
//   (two warp barriers), and no cooperative launch. Every block runs the
//   same instructions on the same x and heads, so every block's x is
//   bitwise the same. The head is work above the bound ((m, k) x (k, k) a
//   block an iteration; the bound counts the full product once). One
//   instantiation a depth (16 to 128) and count of chains, so that the
//   contraction unrolls; a thread of the pair's 512 has 128 registers,
//   hence its narrower sub-tiles.
// * exchange (where the local copy does not fit: k = 256, 512 at n = 2048,
//   the pair at (256, 128, 32768)): a persistent cooperative grid; the
//   blocks that own the head's columns write the next x (scaled, rounded to
//   bf16) to a double-buffered scratch that stays in the 50 MB L2, a grid
//   barrier ends the iteration, and every block re-stages x from L2
//   (cp.async.cg: past the L1, which other SMs' writes would leave stale).
//   The local copy of x and w[:, :k] takes 270 KB at k = 256 and 800 KB at
//   k = 512 (the pair's at (256, 128, 32768) 2 x 188 KB), and a cluster's
//   shared memory spans 16 SMs, not 132.
//
// mode 1 runs the loop with the products skipped and mode 2 the loop's own
// synchronisation alone (local: the warp barriers; exchange: the grid
// barriers), so the probe can print each share.
//
// Products: mma.sync.m16n8k16, bf16 operands from shared memory through
// ldmatrix (rows padded by 16 bytes: conflict-free), f32 accumulators.
// Not wgmma: its 64-row tiles belong to four warps at once, so the next x of
// a warpgroup's rows would need a barrier among those warps, where mma.sync
// lets each warp own its 32 rows. A warp walks the head and its slab 64
// columns at a time (the local pair: the head 32 columns and the slab 64,
// 16 and 16 above k = 64); in the exchange design a contraction deeper
// than 256, or than shared memory holds, is staged in equal chunks, and
// with two chains (NC = 2) both advance inside the same k-step, so their
// mma's interleave.
//
// Only the first k of n columns feed the chain. So that no column's product
// is dead, every iteration's full product is summed into `checksum`, one
// f32 per chain and group of 16 columns (sum over rows, columns of the group
// and iterations), in a fixed order: per-thread partial sums (in registers
// in the local design, in shared memory in the exchange design), added up
// once at the end.
//
// Rounding as the JAX kernels': exact products of bf16 values, f32 sums (in
// the tensor cores' order, not the plain version's), * 0.01f in f32, then
// one rounding to bf16.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// ----------------------------------------------------------- P2 / P3 ----

constexpr int kThreads = 256;
constexpr int kSub = 64;        // columns per accumulator sub-tile
constexpr int kMaxChunk = 256;  // contraction depth staged at a time
constexpr int kGroup = 16;      // columns per checksum entry
constexpr int kPad = 8;         // bf16 of padding per shared row (16 bytes)
constexpr int kMaxRows = 256;   // 8 warps x 32 rows
constexpr int kMaxSmem = 232448;

struct ChainParams {
  const __nv_bfloat16* x0;    // (m, k): the first x of every chain
  const __nv_bfloat16* w[2];  // (k, n) per chain
  __nv_bfloat16* xbuf;        // (2, NC, m, k) scratch: the next x, by parity
  float* checksum;            // (NC, n / 16)
  float* out;                 // (1,): sum of the final x over the chains
  int m, k, n, iters, slab, mode;
  int kc;  // contraction depth staged at a time: divides k
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col); d[0], d[1]: row g, columns 2t,
// 2t + 1; d[2], d[3]: row g + 8 (g = lane / 4, t = lane % 4)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned scaled_pair(float lo, float hi) {
  const __nv_bfloat162 v =
      __halves2bfloat162(__float2bfloat16_rn(0.01f * lo),
                         __float2bfloat16_rn(0.01f * hi));
  return *reinterpret_cast<const unsigned*>(&v);
}

template <int NC>
__global__ void __launch_bounds__(kThreads, 1) chain_kernel(ChainParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kThreads];
  cg::grid_group grid = cg::this_grid();
  if (p.mode == 2) {  // the barriers alone
    for (int it = 0; it < p.iters; ++it) grid.sync();
    return;
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kc = p.kc;
  const int nchunks = p.k / kc;
  const int xs_ld = kc + kPad, ws_ld = p.slab + kPad;
  const int groups = p.slab / kGroup;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [NC][m][xs_ld]
  __nv_bfloat16* ws = xs + NC * p.m * xs_ld;                   // [NC][k][ws_ld]
  float* cs = reinterpret_cast<float*>(ws + NC * p.k * ws_ld);
  // cs: [NC][groups][kThreads], each thread's own partial sums

  const int c0 = blockIdx.x * p.slab;  // this block's first column
  const int width = p.n - c0 < p.slab ? p.n - c0 : p.slab;
  for (int i = tid; i < NC * groups * kThreads; i += kThreads) cs[i] = 0.f;
  // the slab of w: staged once, kept for all iterations
  const int wvec = p.slab / 8;
  for (int c = 0; c < NC; ++c)
    for (int i = tid; i < p.k * wvec; i += kThreads) {
      const int r = i / wvec, j = i % wvec;
      __nv_bfloat16* dst = ws + (c * p.k + r) * ws_ld + j * 8;
      if (c0 + j * 8 < p.n)
        cp_async16(dst, p.w[c] + static_cast<size_t>(r) * p.n + c0 + j * 8);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }

  const size_t state = static_cast<size_t>(p.m) * p.k;  // one chain's x
  const int row0 = warp * 32;
  const bool active = row0 < p.m;
  const int g = lane >> 2, t = lane & 3;
  const int xvec = kc / 8;

  for (int it = 0; it < p.iters; ++it) {
    const __nv_bfloat16* src = p.xbuf + (it & 1) * NC * state;
    __nv_bfloat16* dst = p.xbuf + ((it + 1) & 1) * NC * state;
    for (int ct = 0; ct < width; ct += kSub) {
      float acc[NC][2][8][4];
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[c][mt][nt][e] = 0.f;

      for (int ch = 0; ch < nchunks; ++ch) {
        if (nchunks > 1 || ct == 0) {
          // stage x (this chunk of its columns) from L2; one chunk stays
          // for the whole iteration, several are re-staged per sub-tile
          __syncthreads();  // the previous chunk is consumed
          for (int c = 0; c < NC; ++c) {
            const __nv_bfloat16* from = it == 0 ? p.x0 : src + c * state;
            for (int i = tid; i < p.m * xvec; i += kThreads) {
              const int r = i / xvec, j = i % xvec;
              cp_async16(xs + (c * p.m + r) * xs_ld + j * 8,
                         from + static_cast<size_t>(r) * p.k + ch * kc + j * 8);
            }
          }
          cp_async_wait_all();  // w's slab too, the first time
          __syncthreads();
        }
        if (active && p.mode == 0) {
          for (int kk = 0; kk < kc; kk += 16) {
            unsigned a[NC][2][4];
#pragma unroll
            for (int c = 0; c < NC; ++c)
#pragma unroll
              for (int mt = 0; mt < 2; ++mt)
                ldmatrix_x4(a[c][mt],
                            xs + (c * p.m + row0 + mt * 16 + (lane & 15)) * xs_ld +
                                kk + (lane >> 4) * 8);
#pragma unroll
            for (int np = 0; np < 4; ++np) {
              if (ct + np * 16 < width) {
#pragma unroll
                for (int c = 0; c < NC; ++c) {
                  unsigned b[4];
                  ldmatrix_x4_trans(
                      b, ws + (c * p.k + ch * kc + kk + (lane & 15)) * ws_ld +
                             ct + np * 16 + (lane >> 4) * 8);
#pragma unroll
                  for (int mt = 0; mt < 2; ++mt) {
                    mma_bf16(acc[c][mt][2 * np], a[c][mt], b[0], b[1]);
                    mma_bf16(acc[c][mt][2 * np + 1], a[c][mt], b[2], b[3]);
                  }
                }
              }
            }
          }
        }
      }

      if (active) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            if (ct + np * 16 < width) {
              float v = 0.f;
#pragma unroll
              for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                  for (int e = 0; e < 4; ++e) v += acc[c][mt][2 * np + h][e];
              cs[(c * groups + ct / kGroup + np) * kThreads + tid] += v;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int col = c0 + ct + np * 16 + h * 8 + 2 * t;
                if (col < p.k) {  // the head: the chain's next x
#pragma unroll
                  for (int mt = 0; mt < 2; ++mt) {
                    const float(&d)[4] = acc[c][mt][2 * np + h];
                    __nv_bfloat16* q =
                        dst + c * state +
                        static_cast<size_t>(row0 + mt * 16 + g) * p.k + col;
                    *reinterpret_cast<unsigned*>(q) = scaled_pair(d[0], d[1]);
                    *reinterpret_cast<unsigned*>(q + 8 * p.k) =
                        scaled_pair(d[2], d[3]);
                  }
                }
              }
            }
          }
      }
    }
    grid.sync();  // the next x is whole, and visible in L2
  }

  if (p.iters == 0) {  // nothing was staged: drain w's copies
    cp_async_wait_all();
  }
  __syncthreads();
  for (int i = tid; i < NC * groups; i += kThreads) {
    const int c = i / groups, col = c0 + (i % groups) * kGroup;
    if (col < p.n) {
      float s = 0.f;
      for (int j = 0; j < kThreads; ++j) s += cs[i * kThreads + j];
      p.checksum[c * (p.n / kGroup) + col / kGroup] = s;
    }
  }

  if (blockIdx.x == 0) {  // sum of the final x, in a fixed order
    float s = 0.f;
    for (int c = 0; c < NC; ++c) {
      const unsigned short* fin = reinterpret_cast<const unsigned short*>(
          p.iters == 0 ? p.x0 : p.xbuf + (p.iters & 1) * NC * state + c * state);
      for (size_t i = tid; i < state; i += kThreads)
        s += __bfloat162float(__ushort_as_bfloat16(__ldcg(fin + i)));
    }
    red[tid] = s;
    __syncthreads();
    for (int stride = kThreads / 2; stride > 0; stride /= 2) {
      if (tid < stride) red[tid] += red[tid + stride];
      __syncthreads();
    }
    if (tid == 0) p.out[0] = red[0];
  }
}

// ---------------------------------------------- P2 / P3, the local design ----

constexpr int kLocalMaxK = 128;  // the deepest chain kept in every block
constexpr int kLocalSubs = 4;    // 64-column sub-tiles of a slab: at most 256
// dynamic shared memory a block, beside the kernel's static reduction buffer
constexpr int kLocalSmem = kMaxSmem - kThreads * 4;
constexpr int kLocalRows = 32;                // rows of x a warp owns
constexpr int kLocalTiles = kLocalRows / 16;  // its 16-row tiles
constexpr int kRowWarps = kMaxRows / kLocalRows;  // the warps of a chain
// the checksum's groups of a slab of at most 256 columns
constexpr int kLocalGroups = kLocalSubs * kSub / kGroup;

// the columns of a sub-tile of the head's products, and of the slab's (one
// accumulator tile for all of a warp's rows), at depth K with NC chains: a
// thread of one chain has 255 registers, of the pair (512 threads) 128,
// within which x's fragments, a sub-tile's accumulators and the checksum
// partials stay
template <int K, int NC>
constexpr int kHeadSub = NC == 1 ? 64 : K > 64 ? 16 : 32;
template <int K, int NC>
constexpr int kSlabSub = NC == 1 || K <= 64 ? 64 : 16;

struct LocalParams {
  const __nv_bfloat16* x0;    // (m, K): the first x of every chain
  const __nv_bfloat16* w[2];  // (K, n) per chain
  __nv_bfloat16* xout;        // (2, NC, m, K): the final x of every chain
                              // in the first and in the last block
  float* checksum;            // (NC, n / 16)
  float* out;                 // (1,): sum of the final x, chain by chain
  int m, n, iters, slab, mode;
};

// d = a (16 x 16, row) * b (16 x 8, col), the sum started from 0
__device__ __forceinline__ void mma_bf16_first(float (&d)[4],
                                               const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

// acc = this warp's rows of x (their fragments a, K deep) times the SUB
// columns from ct of a (K, *) operand in shared memory; the 16-column
// groups at or past `width` are not computed (and not read)
template <int K, int SUB>
__device__ __forceinline__ void local_product(
    float (&acc)[kLocalTiles][SUB / 8][4],
    const unsigned (&a)[K / 16][kLocalTiles][4], const __nv_bfloat16* ws,
    int ws_ld, int ct, int width, int lane) {
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
#pragma unroll
    for (int np = 0; np < SUB / 16; ++np) {
      if (ct + np * 16 < width) {
        unsigned b[4];
        ldmatrix_x4_trans(b, ws + (kk + (lane & 15)) * ws_ld + ct + np * 16 +
                                 (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < kLocalTiles; ++mt) {
          if (kk == 0) {
            mma_bf16_first(acc[mt][2 * np], a[0][mt], b[0], b[1]);
            mma_bf16_first(acc[mt][2 * np + 1], a[0][mt], b[2], b[3]);
          } else {
            mma_bf16(acc[mt][2 * np], a[kk / 16][mt], b[0], b[1]);
            mma_bf16(acc[mt][2 * np + 1], a[kk / 16][mt], b[2], b[3]);
          }
        }
      }
    }
  }
}

// acc = the sum over this warp's rows of x (their fragments a, K deep)
// times the SUB columns from ct of a (K, *) operand in shared memory: the
// row tiles' products accumulate into one tile (the checksum sums over
// rows); the 16-column groups at or past `width` are not computed
template <int K, int SUB>
__device__ __forceinline__ void local_rows_product(
    float (&acc)[SUB / 8][4], const unsigned (&a)[K / 16][kLocalTiles][4],
    const __nv_bfloat16* ws, int ws_ld, int ct, int width, int lane) {
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
#pragma unroll
    for (int np = 0; np < SUB / 16; ++np) {
      if (ct + np * 16 < width) {
        unsigned b[4];
        ldmatrix_x4_trans(b, ws + (kk + (lane & 15)) * ws_ld + ct + np * 16 +
                                 (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < kLocalTiles; ++mt) {
          if (kk == 0 && mt == 0) {
            mma_bf16_first(acc[2 * np], a[0][0], b[0], b[1]);
            mma_bf16_first(acc[2 * np + 1], a[0][0], b[2], b[3]);
          } else {
            mma_bf16(acc[2 * np], a[kk / 16][mt], b[0], b[1]);
            mma_bf16(acc[2 * np + 1], a[kk / 16][mt], b[2], b[3]);
          }
        }
      }
    }
  }
}

// One iteration of a chain over this warp's kLocalRows rows from row0: the
// chain's x, head and slab at xs, hs and ws in shared memory, its checksum
// partials in `part`. x's fragments are read into registers; the head's
// product, rounded, is the next x: an m16n8 accumulator tile holds its rows
// as the A fragment of an m16n8k16 product does, so two n-tiles of 8
// columns packed to bf16 pairs are the fragment of one 16-deep tile of the
// next x (f[0] row g, columns 2t, 2t + 1; f[1] row g + 8; f[2], f[3] the
// same 8 columns on; g = lane / 4, t = lane % 4), written over x as each
// head sub-tile is done. Then the slab's products go into the partials.
template <int K, int NC>
__device__ __forceinline__ void local_iteration(
    __nv_bfloat16* xs, const __nv_bfloat16* hs, const __nv_bfloat16* ws,
    int ws_ld, int row0, int width, int lane, bool products,
    float (&part)[kLocalGroups]) {
  constexpr int x_ld = K + kPad;
  constexpr int sub = kHeadSub<K, NC>, slab_sub = kSlabSub<K, NC>;
  unsigned a[K / 16][kLocalTiles][4];
#pragma unroll
  for (int kk = 0; kk < K; kk += 16)
#pragma unroll
    for (int mt = 0; mt < kLocalTiles; ++mt)
      ldmatrix_x4(a[kk / 16][mt], xs + (row0 + mt * 16 + (lane & 15)) * x_ld +
                                      kk + (lane >> 4) * 8);
  __syncwarp();  // every lane holds its fragments of this x
  // the head: this warp's rows of the next x, written over x
#pragma unroll
  for (int hp = 0; hp < K; hp += sub) {
    float acc[kLocalTiles][sub / 8][4] = {};
    if (products) local_product<K, sub>(acc, a, hs, x_ld, hp, K, lane);
#pragma unroll
    for (int q = 0; q < sub / 16; ++q) {
      if (hp + q * 16 < K) {  // a sub-tile may pass K (K = 16, 48)
#pragma unroll
        for (int mt = 0; mt < kLocalTiles; ++mt) {
          const float(&lo)[4] = acc[mt][2 * q];
          const float(&hi)[4] = acc[mt][2 * q + 1];
          unsigned* f = reinterpret_cast<unsigned*>(
              xs + (row0 + mt * 16 + (lane >> 2)) * x_ld + hp + q * 16 +
              2 * (lane & 3));
          f[0] = scaled_pair(lo[0], lo[1]);
          f[4 * x_ld] = scaled_pair(lo[2], lo[3]);
          f[4] = scaled_pair(hi[0], hi[1]);
          f[4 * x_ld + 4] = scaled_pair(hi[2], hi[3]);
        }
      }
    }
  }
  // the slab: every column's product into the checksum, summed over the
  // rows in the tensor cores
#pragma unroll
  for (int ct = 0; ct < kLocalGroups * kGroup; ct += slab_sub) {
    if (ct < width) {
      float acc[slab_sub / 8][4] = {};
      if (products)
        local_rows_product<K, slab_sub>(acc, a, ws, ws_ld, ct, width, lane);
#pragma unroll
      for (int np = 0; np < slab_sub / 16; ++np) {
        if (ct + np * 16 < width) {
          const float(&lo)[4] = acc[2 * np];
          const float(&hi)[4] = acc[2 * np + 1];
          part[ct / kGroup + np] += ((lo[0] + hi[0]) + (lo[1] + hi[1])) +
                                    ((lo[2] + hi[2]) + (lo[3] + hi[3]));
        }
      }
    }
  }
  __syncwarp();  // the next x is whole: the next iteration may read it
}

// NC chains (1 or 2) of depth K on 8 warps each: warp w advances rows
// 32 (w % 8) to 32 (w % 8) + 31 of chain w / 8.
template <int K, int NC>
__global__ void __launch_bounds__(NC * kThreads, 1)
chain_local_kernel(LocalParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kThreads];
  if (p.mode == 2) {  // the loop's own synchronisation alone
    for (int it = 0; it < p.iters; ++it) {
      __syncwarp();
      __syncwarp();
    }
    return;
  }
  constexpr int x_ld = K + kPad;
  constexpr int threads = NC * kThreads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ws_ld = p.slab + kPad;
  const int groups = p.slab / kGroup;
  // per chain: x [m][x_ld], the head w[:, :K] [K][x_ld], the slab
  // [K][ws_ld]; then cs [NC][groups][kThreads], the partial sums of each
  // chain's threads, written once
  const int hs = p.m * x_ld, ws = hs + K * x_ld, chain = ws + K * ws_ld;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* cs = reinterpret_cast<float*>(xs + NC * chain);

  const int c0 = blockIdx.x * p.slab;  // this block's first column
  const int width = p.n - c0 < p.slab ? p.n - c0 : p.slab;
  // x, the heads and the slabs: staged once, kept for all iterations
  constexpr int xvec = K / 8;
  const int wvec = p.slab / 8;
#pragma unroll  // p.w[c] at a constant index: the parameters stay in place
  for (int c = 0; c < NC; ++c) {
    __nv_bfloat16* base = xs + c * chain;
    for (int i = tid; i < p.m * xvec; i += threads) {
      const int r = i / xvec, j = i % xvec;
      cp_async16(base + r * x_ld + j * 8,
                 p.x0 + static_cast<size_t>(r) * K + j * 8);
    }
    for (int i = tid; i < K * xvec; i += threads) {
      const int r = i / xvec, j = i % xvec;
      cp_async16(base + hs + r * x_ld + j * 8,
                 p.w[c] + static_cast<size_t>(r) * p.n + j * 8);
    }
    for (int i = tid; i < K * wvec; i += threads) {
      const int r = i / wvec, j = i % wvec;
      __nv_bfloat16* dst = base + ws + r * ws_ld + j * 8;
      if (c0 + j * 8 < p.n)
        cp_async16(dst, p.w[c] + static_cast<size_t>(r) * p.n + c0 + j * 8);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int c = warp / kRowWarps, row0 = warp % kRowWarps * kLocalRows;
  __nv_bfloat16* x = xs + c * chain;
  float part[kLocalGroups] = {};
  if (row0 < p.m) {
    for (int it = 0; it < p.iters; ++it)
      local_iteration<K, NC>(x, x + hs, x + ws, ws_ld, row0, width, lane,
                             p.mode == 0, part);
  }
#pragma unroll
  for (int gi = 0; gi < kLocalGroups; ++gi)
    if (gi < groups)
      cs[(c * groups + gi) * kThreads + tid % kThreads] = part[gi];

  __syncthreads();
  const int gw = width / kGroup;  // the groups of this block's columns
  for (int i = tid; i < NC * gw; i += threads) {
    const int cc = i / gw, gi = i % gw;
    float s = 0.f;
    for (int j = 0; j < kThreads; ++j)
      s += cs[(cc * groups + gi) * kThreads + j];
    p.checksum[cc * (p.n / kGroup) + c0 / kGroup + gi] = s;
  }
  // the final x of every chain in the first and in the last block (the
  // same bits)
  const bool first = blockIdx.x == 0, last = blockIdx.x == gridDim.x - 1;
  const int state = p.m * K;
  if (first || last) {
    for (int i = tid; i < NC * state; i += threads) {
      const int cc = i / state, e = i % state;
      const __nv_bfloat16 v = xs[cc * chain + e / K * x_ld + e % K];
      if (first) p.xout[i] = v;
      if (last) p.xout[NC * state + i] = v;
    }
  }
  if (first) {  // sum of the final x, chain by chain, in a fixed order
    float s = 0.f;
    if (tid < kThreads)
      for (int cc = 0; cc < NC; ++cc)
        for (int i = tid; i < state; i += kThreads)
          s += __bfloat162float(xs[cc * chain + i / K * x_ld + i % K]);
    if (tid < kThreads) red[tid] = s;
    __syncthreads();
    for (int stride = kThreads / 2; stride > 0; stride /= 2) {
      if (tid < stride) red[tid] += red[tid + stride];
      __syncthreads();
    }
    if (tid == 0) p.out[0] = red[0];
  }
}

template <int K, int NC>
int launch_local(const LocalParams& p, int blocks, size_t smem,
                 cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      chain_local_kernel<K, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  chain_local_kernel<K, NC><<<blocks, NC * kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the contraction unrolled: one instantiation a depth
template <int NC>
int launch_local_depth(const LocalParams& p, int k, int blocks, size_t smem,
                       cudaStream_t s) {
  switch (k) {
    case 16: return launch_local<16, NC>(p, blocks, smem, s);
    case 32: return launch_local<32, NC>(p, blocks, smem, s);
    case 48: return launch_local<48, NC>(p, blocks, smem, s);
    case 64: return launch_local<64, NC>(p, blocks, smem, s);
    case 80: return launch_local<80, NC>(p, blocks, smem, s);
    case 96: return launch_local<96, NC>(p, blocks, smem, s);
    case 112: return launch_local<112, NC>(p, blocks, smem, s);
    default: return launch_local<128, NC>(p, blocks, smem, s);
  }
}

// ---------------------------------------------------------------- P1 ----

constexpr int kP1Rows = 32;      // output rows a block
constexpr int kP1Cols = 16;      // output columns a block
constexpr int kP1Chunk = 64;     // contraction depth of a stage
constexpr int kP1Stages = 4;     // stages in flight: all of n <= 256
constexpr int kP1Splits = 8;     // warps, each a share of every chunk's depth
constexpr int kP1Threads = 32 * kP1Splits;
// A's rows padded by 4 floats: a thread's 4 rows lie 16 banks apart
constexpr int kP1Ald = kP1Chunk + 4;
constexpr int kP1StageFloats = kP1Rows * kP1Ald + kP1Chunk * kP1Cols;
constexpr int kP1Smem = kP1Stages * kP1StageFloats * 4;
constexpr int kP1Rld = kP1Cols + 4;  // the partial tiles' rows, padded

__device__ __forceinline__ void cp_async_zfill16(void* dst, const void* src,
                                                 bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_zfill4(void* dst, const void* src,
                                                bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one chunk of A's row panel and column panel into a stage, 0 outside a;
// kVec: n % 4 == 0, so 16-byte copies never straddle the edge
template <bool kVec>
__device__ __forceinline__ void p1_stage(float* st, const float* a, int n,
                                         int row0, int col0, int k0) {
  float* as = st;                     // [kP1Rows][kP1Ald]
  float* bs = st + kP1Rows * kP1Ald;  // [kP1Chunk][kP1Cols]
  constexpr int v = kVec ? 4 : 1;
  for (int i = threadIdx.x; i < kP1Rows * kP1Chunk / v; i += kP1Threads) {
    const int r = i / (kP1Chunk / v), j = i % (kP1Chunk / v) * v;
    const bool ok = row0 + r < n && k0 + j < n;
    const float* src = ok ? a + static_cast<size_t>(row0 + r) * n + k0 + j : a;
    if (kVec)
      cp_async_zfill16(as + r * kP1Ald + j, src, ok);
    else
      cp_async_zfill4(as + r * kP1Ald + j, src, ok);
  }
  for (int i = threadIdx.x; i < kP1Chunk * kP1Cols / v; i += kP1Threads) {
    const int r = i / (kP1Cols / v), j = i % (kP1Cols / v) * v;
    const bool ok = k0 + r < n && col0 + j < n;
    const float* src = ok ? a + static_cast<size_t>(k0 + r) * n + col0 + j : a;
    if (kVec)
      cp_async_zfill16(bs + r * kP1Cols + j, src, ok);
    else
      cp_async_zfill4(bs + r * kP1Cols + j, src, ok);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kP1Threads)
probe_matmul_kernel(const float* __restrict__ a, float* __restrict__ o,
                    int n) {
  extern __shared__ __align__(16) float p1s[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.y * kP1Rows, col0 = blockIdx.x * kP1Cols;
  const int chunks = (n + kP1Chunk - 1) / kP1Chunk;
  // every load at once, as far as the stages go: one commit group a chunk
#pragma unroll
  for (int s = 0; s < kP1Stages; ++s) {
    if (s < chunks)
      p1_stage<kVec>(p1s + s * kP1StageFloats, a, n, row0, col0,
                     s * kP1Chunk);
    cp_async_commit();
  }
  // this thread's 4 x 4 tile: rows 4 (lane / 4), columns 4 (lane % 4); its
  // warp's share of each chunk: 8 deep
  const int r4 = (lane >> 2) * 4, c4 = (lane & 3) * 4;
  float acc[4][4] = {};
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kP1Stages - 1>();  // chunk c has landed
    __syncthreads();
    const float* as = p1s + (c % kP1Stages) * kP1StageFloats;
    const float* bs = as + kP1Rows * kP1Ald;
#pragma unroll
    for (int kk = 0; kk < kP1Chunk / kP1Splits; kk += 4) {
      const int k = warp * (kP1Chunk / kP1Splits) + kk;
      float4 av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = *reinterpret_cast<const float4*>(as + (r4 + i) * kP1Ald + k);
        bv[i] = *reinterpret_cast<const float4*>(bs + (k + i) * kP1Cols + c4);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ai[4] = {av[i].x, av[i].y, av[i].z, av[i].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[i][0] = fmaf(ai[q], bv[q].x, acc[i][0]);
          acc[i][1] = fmaf(ai[q], bv[q].y, acc[i][1]);
          acc[i][2] = fmaf(ai[q], bv[q].z, acc[i][2]);
          acc[i][3] = fmaf(ai[q], bv[q].w, acc[i][3]);
        }
      }
    }
    __syncthreads();  // the stage is consumed
    if (c + kP1Stages < chunks)
      p1_stage<kVec>(p1s + (c % kP1Stages) * kP1StageFloats, a, n, row0, col0,
                     (c + kP1Stages) * kP1Chunk);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();
  // the eight warps' partial tiles, added in a fixed order
  float* part = p1s;  // [kP1Splits][kP1Rows][kP1Rld]
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(part + (warp * kP1Rows + r4 + i) * kP1Rld +
                               c4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
  for (int e = tid; e < kP1Rows * kP1Cols; e += kP1Threads) {
    const int r = e / kP1Cols, c = e % kP1Cols;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kP1Splits; ++w)
      s += part[(w * kP1Rows + r) * kP1Rld + c];
    if (row0 + r < n && col0 + c < n)
      o[static_cast<size_t>(row0 + r) * n + col0 + c] = s * 2.f;
  }
}

// ------------------------------------------------------------- plans ----

// the column slab a block owns: the narrowest multiple of 16 that covers n
// with at most one block an SM
int slab_width(int n, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (sms < 1 || n < 1) return -static_cast<int>(cudaErrorInvalidValue);
  int slab = (n + sms - 1) / sms;
  slab = (slab + kGroup - 1) / kGroup * kGroup;
  *blocks = (n + slab - 1) / slab;
  return slab;
}

// a chain's design on the current device (ops/probe_kernels.py:
// chain_design states the same rule): the local design for one or two
// chains with k <= kLocalMaxK and slabs of at most 256 columns where every
// chain's x, head, slab and partial sums fit; else the exchange design, x
// staged kc deep, the deepest that fits beside the slab
struct ChainPlan {
  int design;  // 0: local; 1: exchange
  int slab, blocks, kc;
  size_t smem;
};

int plan_chain(int m, int k, int n, int nc, ChainPlan* plan) {
  if (m < 32 || m > kMaxRows || m % 32 != 0 || k < 16 || k % 16 != 0 ||
      (k > kMaxChunk && k % kMaxChunk != 0) || n % kGroup != 0 || k > n ||
      nc < 1 || nc > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slab = slab_width(n, &plan->blocks);
  if (slab < 0) return -slab;
  plan->slab = slab;
  const size_t checks = static_cast<size_t>(slab / kGroup) * kThreads * 4;
  const size_t local = static_cast<size_t>(m) * (k + kPad) * 2 +
                       static_cast<size_t>(k) * (k + kPad) * 2 +
                       static_cast<size_t>(k) * (slab + kPad) * 2 + checks;
  if (k <= kLocalMaxK && slab <= kLocalSubs * kSub &&
      nc * local <= kLocalSmem) {
    plan->design = 0;
    plan->kc = k;
    plan->smem = nc * local;
    return 0;
  }
  plan->design = 1;
  for (int kc = k < kMaxChunk ? k : kMaxChunk;; kc /= 2) {
    plan->kc = kc;
    plan->smem = static_cast<size_t>(nc) *
                 (static_cast<size_t>(m) * (kc + kPad) * 2 +
                  static_cast<size_t>(k) * (slab + kPad) * 2 + checks);
    if (plan->smem <= kMaxSmem) return 0;
    if (kc % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// o = (a @ a) * 2 for a (n, n) f32. Returns a cudaError_t.
extern "C" int probe_matmul(const float* a, float* o, int n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = n % 4 == 0;
  const void* fn =
      vec ? reinterpret_cast<const void*>(probe_matmul_kernel<true>)
          : reinterpret_cast<const void*>(probe_matmul_kernel<false>);
  static bool ready[2] = {false, false};  // the shared-memory attribute set
  if (!ready[vec]) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kP1Smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[vec] = true;
  }
  const dim3 grid((n + kP1Cols - 1) / kP1Cols, (n + kP1Rows - 1) / kP1Rows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    probe_matmul_kernel<true><<<grid, kP1Threads, kP1Smem, s>>>(a, o, n);
  else
    probe_matmul_kernel<false><<<grid, kP1Threads, kP1Smem, s>>>(a, o, n);
  return static_cast<int>(cudaGetLastError());
}

// The design of a chain of shape (m, k) x (k, n), nc chains, on the current
// device: 0 local, 1 exchange; through `info` the slab, the blocks, x's
// staging depth and the shared-memory bytes a block. Negative: a
// cudaError_t.
extern "C" int probe_chain_design(int m, int k, int n, int nc, int* info) {
  ChainPlan plan;
  const int err = plan_chain(m, k, n, nc, &plan);
  if (err) return -err;
  info[0] = plan.slab;
  info[1] = plan.blocks;
  info[2] = plan.kc;
  info[3] = static_cast<int>(plan.smem);
  return plan.design;
}

// One launch of the chain (w2 == nullptr: one chain; else two independent
// chains an iteration), in the design of probe_chain_design, which it
// writes to `design`. mode 0: the probe; 1: the loop with the products
// skipped; 2: the loop's synchronisation alone. checksum (NC, n / 16) and
// out (1,) must be zero on entry; xbuf holds 2 * NC * m * k bf16: the
// exchange design's next x by parity, the local design's final x (of every
// chain) of the first and the last block. Returns a cudaError_t:
// cudaErrorInvalidValue for a shape the kernel does not take, and the
// launch's own refusal of a grid that cannot be co-resident.
extern "C" int probe_chain(const void* x, const void* w1, const void* w2,
                           void* xbuf, float* checksum, float* out, int m,
                           int k, int n, int iters, int mode, int* design,
                           void* stream) {
  const int nc = w2 != nullptr ? 2 : 1;
  if (iters < 0 || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  ChainPlan plan;
  const int bad = plan_chain(m, k, n, nc, &plan);
  if (bad) return bad;
  *design = plan.design;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan.design == 0) {
    LocalParams p;
    p.x0 = static_cast<const __nv_bfloat16*>(x);
    p.w[0] = static_cast<const __nv_bfloat16*>(w1);
    p.w[1] = static_cast<const __nv_bfloat16*>(w2);
    p.xout = static_cast<__nv_bfloat16*>(xbuf);
    p.checksum = checksum;
    p.out = out;
    p.m = m;
    p.n = n;
    p.iters = iters;
    p.slab = plan.slab;
    p.mode = mode;
    return nc == 2 ? launch_local_depth<2>(p, k, plan.blocks, plan.smem, s)
                   : launch_local_depth<1>(p, k, plan.blocks, plan.smem, s);
  }
  ChainParams p;
  p.x0 = static_cast<const __nv_bfloat16*>(x);
  p.w[0] = static_cast<const __nv_bfloat16*>(w1);
  p.w[1] = static_cast<const __nv_bfloat16*>(w2);
  p.xbuf = static_cast<__nv_bfloat16*>(xbuf);
  p.checksum = checksum;
  p.out = out;
  p.m = m;
  p.k = k;
  p.n = n;
  p.iters = iters;
  p.slab = plan.slab;
  p.mode = mode;
  p.kc = plan.kc;
  const void* fn = nc == 2 ? reinterpret_cast<const void*>(chain_kernel<2>)
                           : reinterpret_cast<const void*>(chain_kernel<1>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(plan.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&p};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      fn, dim3(plan.blocks), dim3(kThreads), args, plan.smem, s));
}
