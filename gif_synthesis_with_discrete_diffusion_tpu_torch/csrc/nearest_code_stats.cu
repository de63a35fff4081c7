// VQ codebook nearest-neighbour lookup with its usage statistics (Hopper).
//
// Replaces the TPU kernel gif_synthesis_with_discrete_diffusion_tpu/ops/
// codebook_kernel.py: _kernel (via _nearest_code_stats_pallas /
// nearest_code_stats).
//
// x: (N, D), e: (K, D), both f32 and contiguous. For each row n:
//   idx[n] = argmin_k ||e_k||^2 - 2 x_n . e_k   (the first k on ties, as
//            jnp.argmin; ||x_n||^2 is constant in k and dropped)
// and, accumulated into zeroed outputs,
//   n_total[k] += 1 and encode_sum[k, :] += x_n   for k = idx[n].
//
// What bounds it: 2 N K D operations (17.2 GFLOP at N = 16384, K = 4096,
// D = 128), against N K distances that must never reach device memory
// (268 MB of f32 at that shape). The products run on the tensor cores in
// split TF32: each f32 value v is hi (v rounded to TF32) + lo (the rest, cut
// to TF32), which misses v by less than 2^-21 of it, and x . e is taken as
// hi.lo + lo.hi + hi.hi by three mma.m16n8k8 .tf32 an 8-deep step (lo.lo,
// ~2^-22 of the product, is dropped): ops/megakernel.py: split_matmul's
// arithmetic, held on the CPU by nearest_code_stats_kernel_arithmetic. So
// the work as this design does it is 3 x 2 N K D at the TF32 rate.
//
// The design:
//   * a block keeps its BM rows of x resident in shared memory for the whole
//     call, split once into hi and lo and laid out in the mma's A-fragment
//     order (a lane reads its four hi and four lo words as two 16-byte
//     loads, conflict-free); the contraction is padded with zeros to a
//     multiple of a stage's depth (so up to D = 384 x stays resident);
//   * E streams through shared memory in stages of BN codes x CH dims by
//     cp.async, in a ring of ST, so the next stage lands under this one's
//     mma; a lane splits the E values of its B fragments as it reads them
//     (a padded row of CH + 4 floats makes those reads conflict-free), and
//     sums their squares, so ||e||^2 is taken once per code and block from
//     the staged tile;
//   * a warp owns 16 MT rows x 32 codes of a tile; after a tile's last
//     chunk its accumulators become ||e||^2 - 2 acc and update a running
//     (min, index) per row in registers; at the end the lanes and warps
//     that share a row are combined in a fixed order, ties to the smaller
//     index, and padded codes never win;
//   * two shapes of block, by D, so that x and the ring fit the 227 KB of a
//     block: up to D = 128, BM = 128 rows (MT = 4, 2 x 4 warps, 128 codes a
//     tile) and stages of 64 dims in a ring of two (a block barrier every
//     16 mma k-steps; 32 dims in a ring of three or four, a warp on 32 rows
//     x 64 codes, measured slower: probes/sampler_codebook_variants.py,
//     VARIANTS); up to D = 384, BM = 32 (MT = 2, 1 x 8 warps, 256 codes a
//     tile), stages of 32 dims in a ring of three;
//   * above D = 384 x no longer fits beside the ring, and the block streams
//     it (XS): a stage holds the tile's BN codes and the block's BM rows of
//     x, both CH dims deep, as they are in device memory (rows padded to
//     CH + 4 floats: the A-fragment reads are conflict-free too), and a
//     lane splits its x values as it reads them, as it splits E's. The
//     D <= 128 block shape (BM = 128, 128 codes a tile, 64 dims a stage in
//     a ring of two), so x is read once per tile of 128 codes (from L2). A
//     plain tiled product with the argmin epilogue; every D runs.
// The order of the sums does not depend on the block shape, the tile or the
// shard: a code's ||e||^2 and each (row, code) product add the same 8-deep
// mma steps in increasing order of the dims, the stages of a tile in order.
//
// The statistics: each block adds its own rows into n_total and encode_sum
// with float atomics (the wrapper zeroes both), the rows read again from x.
// The counts are integers and exact; encode_sum's sums come in no fixed
// order, so they agree with a sequential sum to f32 rounding (the tests hold
// them to 1e-4).
//
// Two more entries serve a codebook sharded by codes over the model ranks
// of tensor parallelism, where a row's nearest code among this rank's codes
// may lose to another rank's, so the fused statistics would count it wrong:
//   * nearest_code_dist: the same kernel without the statistics, writing
//     each row's local index and its distance ||e||^2 - 2 x.e (f32). A
//     code's distance comes from its own values alone, by the same split
//     TF32 products in the same order whichever tile or shard it lies in,
//     so the minimum over the shards, ties to the lower shard, is the
//     unsharded kernel's index exactly;
//   * code_stats: n_total and encode_sum of the codes [lo, lo + K) from the
//     rows' given global indices (the winners over the shards): a grid-
//     stride pass over x, one float atomic an element of a row that falls
//     in the range. It moves N D floats and does N D adds, bound by the
//     bytes (and by the atomics of a code many rows chose).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNt = 4;             // 8-code n-tiles a warp: 32 codes

// MT m-tiles a warp, WR warps along the rows, stages of CH dims of E in a
// ring of ST; XS: x streamed beside E (else resident)
template <int MT, int WR, int CH, int ST, bool XS = false>
struct Shape {
  static constexpr int kWc = 8 / WR;          // warps along the codes
  static constexpr int kBm = 16 * MT * WR;    // rows a block
  static constexpr int kBn = 8 * kNt * kWc;   // codes a tile
  static constexpr int kChunk = CH;           // dims of a staged chunk of E
  static constexpr int kKs = CH / 8;          // mma k-steps a chunk
  static constexpr int kEs = CH + 4;          // floats a staged code: lanes
                                              // (g, tig) read banks 4 g +
                                              // tig, all distinct
  static constexpr int kStages = ST;
  static constexpr int kStageFloats = (kBn + (XS ? kBm : 0)) * kEs;
  static_assert(CH % 32 == 0 && ST >= 2, "stage shape");
};

__device__ __forceinline__ void split_tf32(float v, unsigned& hi,
                                           unsigned& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint4& a,
                                         unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the smaller distance, and on a tie the smaller index
__device__ __forceinline__ bool better(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// vec: bit 0, e's rows start on 16 bytes; bit 1, x's do
template <int MT, int WR, int CH, int ST, bool XS = false>
__global__ void __launch_bounds__(kThreads, 1)
nearest_code_kernel(const float* __restrict__ x, const float* __restrict__ e,
                    int N, int K, int D, int vec, int* __restrict__ idx_out,
                    float* __restrict__ dist_out, float* __restrict__ n_total,
                    float* __restrict__ encode_sum) {
  using S = Shape<MT, WR, CH, ST, XS>;
  constexpr int kBm = S::kBm, kBn = S::kBn, kWc = S::kWc;
  constexpr int kChunk = S::kChunk, kKs = S::kKs, kEs = S::kEs,
                kStages = S::kStages;
  extern __shared__ uint4 smem4[];
  const int dc = (D + kChunk - 1) / kChunk * kChunk;   // padded contraction
  const int ks_all = dc / 8;
  // x (resident): [m-tile][k-step][hi, lo][lane][4 registers]
  unsigned* xs = reinterpret_cast<unsigned*>(smem4);
  float* ring = reinterpret_cast<float*>(xs + (XS ? 0 : kBm * dc * 2));
  __shared__ float red_d[kWc][kBm];
  __shared__ int red_i[kWc][kBm];
  __shared__ int rows_idx[kBm];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wr = warp / kWc, wc = warp % kWc;
  const int row0 = blockIdx.x * kBm;
  const int nch = dc / kChunk;
  const int n_tiles = (K + kBn - 1) / kBn;
  const int n_stages = n_tiles * nch;

  // stage t: codes of tile t / nch, dims of chunk t % nch, into ring slot
  // t % kStages (XS: then the block's rows of x); padded codes, rows and
  // dims land as zeros
  auto copy_stage = [&](int t) {
    float* buf = ring + (t % kStages) * S::kStageFloats;
    const int c0 = (t / nch) * kBn, d0 = (t % nch) * kChunk;
    if constexpr (XS) {
      float* xb = buf + kBn * kEs;
      if (vec & 2) {
        for (int i = tid; i < kBm * (kChunk / 4); i += kThreads) {
          const int r = i / (kChunk / 4), d = d0 + 4 * (i % (kChunk / 4));
          const bool ok = row0 + r < N && d < D;
          cp_async16(xb + r * kEs + (d - d0),
                     ok ? x + static_cast<size_t>(row0 + r) * D + d : x, ok);
        }
      } else {
        for (int i = tid; i < kBm * kChunk; i += kThreads) {
          const int r = i / kChunk, d = d0 + i % kChunk;
          const bool ok = row0 + r < N && d < D;
          cp_async4(xb + r * kEs + (d - d0),
                    ok ? x + static_cast<size_t>(row0 + r) * D + d : x, ok);
        }
      }
    }
    if (vec & 1) {
      for (int i = tid; i < kBn * (kChunk / 4); i += kThreads) {
        const int c = i / (kChunk / 4), d = d0 + 4 * (i % (kChunk / 4));
        const bool ok = c0 + c < K && d < D;
        cp_async16(buf + c * kEs + (d - d0),
                   ok ? e + static_cast<size_t>(c0 + c) * D + d : e, ok);
      }
    } else {
      for (int i = tid; i < kBn * kChunk; i += kThreads) {
        const int c = i / kChunk, d = d0 + i % kChunk;
        const bool ok = c0 + c < K && d < D;
        cp_async4(buf + c * kEs + (d - d0),
                  ok ? e + static_cast<size_t>(c0 + c) * D + d : e, ok);
      }
    }
  };
  // kStages - 1 stages in flight ahead of the one computed
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_stages) copy_stage(t);
    cp_async_commit();
  }

  // x, split once, in the A-fragment order of mma.m16n8k8: register
  // (r >= 8) + 2 (k >= 4) of lane (r % 8) * 4 + k % 4 holds (r, k)
  if constexpr (!XS) for (int i = tid; i < kBm * dc; i += kThreads) {
    const int r = i / dc, d = i % dc;
    const int row = row0 + r;
    const float v = row < N && d < D ? x[static_cast<size_t>(row) * D + d]
                                     : 0.f;
    unsigned hi, lo;
    split_tf32(v, hi, lo);
    const int rr = r & 15, kk = d & 7;
    const int at = (((r >> 4) * ks_all + (d >> 3)) * 2) * 128 +
                   ((rr & 7) * 4 + (kk & 3)) * 4 + (rr >> 3) + 2 * (kk >> 2);
    xs[at] = hi;
    xs[at + 128] = lo;
  }

  float acc[MT][kNt][4];
  float ss[kNt];   // this lane's share of ||e||^2 of code g of each n-tile
  float best[MT][2];
  int best_i[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
    best[m][0] = best[m][1] = INFINITY;
    best_i[m][0] = best_i[m][1] = 0x7fffffff;
  }
#pragma unroll
  for (int n = 0; n < kNt; ++n) ss[n] = 0.f;

  for (int t = 0; t < n_stages; ++t) {
    cp_async_wait<kStages - 2>();   // this thread's copies of stage t landed
    __syncthreads();   // everyone's have, and stage t - 1 (its slot) is read
    if (t + kStages - 1 < n_stages) copy_stage(t + kStages - 1);
    cp_async_commit();
    const float* buf = ring + (t % kStages) * S::kStageFloats +
                       (wc * 8 * kNt + g) * kEs + tig;
    const int ch = t % nch;
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) {
      unsigned bh[kNt][2], bl[kNt][2];
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
        const float b0 = buf[n * 8 * kEs + ks * 8];
        const float b1 = buf[n * 8 * kEs + ks * 8 + 4];
        ss[n] = fmaf(b0, b0, ss[n]);
        ss[n] = fmaf(b1, b1, ss[n]);
        split_tf32(b0, bh[n][0], bl[n][0]);
        split_tf32(b1, bh[n][1], bl[n][1]);
      }
      const int kstep = ch * kKs + ks;
      uint4 ah[MT], al[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if constexpr (XS) {
          // rows g, g + 8 of the m-tile at dims tig, tig + 4 of the k-step
          const float* a = ring + (t % kStages) * S::kStageFloats +
                           (kBn + (wr * MT + m) * 16 + g) * kEs + ks * 8 +
                           tig;
          split_tf32(a[0], ah[m].x, al[m].x);
          split_tf32(a[8 * kEs], ah[m].y, al[m].y);
          split_tf32(a[4], ah[m].z, al[m].z);
          split_tf32(a[8 * kEs + 4], ah[m].w, al[m].w);
        } else {
          const uint4* a = reinterpret_cast<const uint4*>(
              xs + (((wr * MT + m) * ks_all + kstep) * 2) * 128) + lane;
          ah[m] = a[0];
          al[m] = a[32];
        }
      }
      // hi.lo, lo.hi, then hi.hi, each over all MT x kNt tiles, so that
      // no mma waits on the one before it
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < kNt; ++n)
          mma_tf32(acc[m][n], ah[m], bl[n][0], bl[n][1]);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < kNt; ++n)
          mma_tf32(acc[m][n], al[m], bh[n][0], bh[n][1]);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < kNt; ++n)
          mma_tf32(acc[m][n], ah[m], bh[n][0], bh[n][1]);
    }
    if (ch != nch - 1) continue;

    // the tile's distances: ||e||^2 - 2 acc, codes in increasing order
    const int cbase = (t / nch) * kBn + wc * 8 * kNt;
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      float q = ss[n];
      q += __shfl_xor_sync(0xffffffffu, q, 1);
      q += __shfl_xor_sync(0xffffffffu, q, 2);   // ||e||^2 of code g
      const float q0 = __shfl_sync(0xffffffffu, q, 8 * tig);
      const float q1 = __shfl_sync(0xffffffffu, q, 8 * tig + 4);
      ss[n] = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int code = cbase + 8 * n + 2 * tig + c;
        if (code >= K) continue;   // padded codes never win
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // the product by -2 is exact
            const float dist = fmaf(-2.f, acc[m][n][2 * h + c], c ? q1 : q0);
            if (better(dist, code, best[m][h], best_i[m][h])) {
              best[m][h] = dist;
              best_i[m][h] = code;
            }
          }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
    }
  }

  // a row's lanes (the quad) and then its kWc warps
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, best[m][h], off);
        const int oi = __shfl_xor_sync(0xffffffffu, best_i[m][h], off);
        if (better(od, oi, best[m][h], best_i[m][h])) {
          best[m][h] = od;
          best_i[m][h] = oi;
        }
      }
      if (tig == 0) {
        const int r = (wr * MT + m) * 16 + g + 8 * h;
        red_d[wc][r] = best[m][h];
        red_i[wc][r] = best_i[m][h];
      }
    }
  __syncthreads();
  for (int r = tid; r < kBm; r += kThreads) {
    float bd = red_d[0][r];
    int bi = red_i[0][r];
    for (int w = 1; w < kWc; ++w)
      if (better(red_d[w][r], red_i[w][r], bd, bi)) {
        bd = red_d[w][r];
        bi = red_i[w][r];
      }
    rows_idx[r] = bi;
    const int row = row0 + r;
    if (row < N) {
      idx_out[row] = bi;
      if (dist_out != nullptr) dist_out[row] = bd;
      if (n_total != nullptr) atomicAdd(&n_total[bi], 1.f);
    }
  }
  if (n_total == nullptr) return;   // the same for the whole block
  __syncthreads();
  for (int i = tid; i < kBm * D; i += kThreads) {
    const int r = i / D, d = i % D;
    if (row0 + r < N)
      atomicAdd(&encode_sum[static_cast<size_t>(rows_idx[r]) * D + d],
                x[static_cast<size_t>(row0 + r) * D + d]);
  }
}

template <int MT, int WR, int CH, int ST, bool XS = false>
cudaError_t launch(const float* x, const float* e, int N, int K, int D,
                   int vec, int* idx, float* dist, float* n_total,
                   float* encode_sum, cudaStream_t stream) {
  using S = Shape<MT, WR, CH, ST, XS>;
  const int dc = (D + CH - 1) / CH * CH;
  const size_t smem = (XS ? 0 : static_cast<size_t>(S::kBm) * dc * 2 *
                                    sizeof(unsigned))
                      + static_cast<size_t>(ST) * S::kStageFloats
                      * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      nearest_code_kernel<MT, WR, CH, ST, XS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  nearest_code_kernel<MT, WR, CH, ST, XS><<<(N + S::kBm - 1) / S::kBm,
                                            kThreads, smem, stream>>>(
      x, e, N, K, D, vec, idx, dist, n_total, encode_sum);
  return cudaGetLastError();
}

cudaError_t launch_by_dim(const float* x, const float* e, int N, int K,
                          int D, int vec, int* idx, float* dist,
                          float* n_total, float* encode_sum, void* stream) {
  if (N <= 0 || K <= 0 || D <= 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (D > 384)
    return launch<4, 2, 64, 2, true>(x, e, N, K, D, vec, idx, dist, n_total,
                                     encode_sum, s);
  return D <= 128 ? launch<4, 2, 64, 2>(x, e, N, K, D, vec, idx, dist,
                                        n_total, encode_sum, s)
                  : launch<2, 1, 32, 3>(x, e, N, K, D, vec, idx, dist,
                                        n_total, encode_sum, s);
}

__global__ void __launch_bounds__(kThreads)
code_stats_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                  int N, int D, int lo, int K, float* __restrict__ n_total,
                  float* __restrict__ encode_sum) {
  const size_t total = static_cast<size_t>(N) * D;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * kThreads) {
    const int r = static_cast<int>(i / D), d = static_cast<int>(i % D);
    const int k = idx[r] - lo;
    if (k < 0 || k >= K) continue;
    if (d == 0) atomicAdd(&n_total[k], 1.f);
    atomicAdd(&encode_sum[static_cast<size_t>(k) * D + d], x[i]);
  }
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for a bad shape (N, K or D
// not positive), else the launch's status. vec: bit 0, e's address and row
// length are multiples of 16 bytes; bit 1, x's. n_total (K) and encode_sum
// (K, D) must be zero on entry. Any D.
extern "C" int nearest_code_stats(const float* x, const float* e, int N,
                                  int K, int D, int vec, int* idx,
                                  float* n_total, float* encode_sum,
                                  void* stream) {
  return static_cast<int>(launch_by_dim(x, e, N, K, D, vec, idx, nullptr,
                                        n_total, encode_sum, stream));
}

// Each row's nearest code among e's K and its distance; no statistics.
extern "C" int nearest_code_dist(const float* x, const float* e, int N,
                                 int K, int D, int vec, int* idx,
                                 float* dist, void* stream) {
  return static_cast<int>(launch_by_dim(x, e, N, K, D, vec, idx, dist,
                                        nullptr, nullptr, stream));
}

// n_total (K) and encode_sum (K, D), zero on entry, of the codes
// [lo, lo + K) from the rows' global indices idx (N).
extern "C" int code_stats(const float* x, const int* idx, int N, int D,
                          int lo, int K, float* n_total, float* encode_sum,
                          void* stream) {
  if (N <= 0 || K <= 0 || D <= 0) return static_cast<int>(
      cudaErrorInvalidValue);
  const size_t total = static_cast<size_t>(N) * D;
  const int blocks = static_cast<int>(
      (total + kThreads - 1) / kThreads < 132 * 16
          ? (total + kThreads - 1) / kThreads : 132 * 16);
  code_stats_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      x, idx, N, D, lo, K, n_total, encode_sum);
  return static_cast<int>(cudaGetLastError());
}
