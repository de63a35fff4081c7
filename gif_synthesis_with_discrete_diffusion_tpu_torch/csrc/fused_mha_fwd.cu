// Non-causal multi-head attention forward for the D3PM denoiser (Hopper),
// for f32 and bf16 inputs.
//
// Replaces the TPU kernel gif_synthesis_with_discrete_diffusion_tpu/ops/
// attention.py: _kernel (via _fused_mha_fwd_impl / fused_mha).
//
// q: (B, Lq, C), k/v: (B, Lk, C), o: (B, Lq, C), all of one type (f32 or
// bf16) and contiguous; C = H * d, any head dim d. Per (batch row,
// head): o = softmax(q k^T / sqrt(d)) v over the Lk keys, as the TPU kernel
// computes
// it: the inputs taken to f32, the softmax and P V in f32, o rounded to the
// input type once. When lse is not null it also receives each (batch row,
// head, query)'s log-sum-exp of the scores in base 2, (B, H, Lq) f32, which
// the backward (csrc/fused_mha_bwd.cu) uses to recompute the probabilities.
//
// What bounds it: with D = 4 a query-key pair costs 8 multiply-adds (QK^T
// and P V) and one exponential, so at 1.07e9 pairs a self-attention call
// (64 rows of 1024 tokens, 16 heads) the exponentials alone take 0.257 ms
// at the 4.18e12 / s this card issues (EXP_PROBE_H100.json), as long as
// the f32 products 0.256 ms on the CUDA cores. The score matrix, if written
// out, is 4 GiB: it stays in registers.
//
// Design: the products run on the tensor cores (csrc/mha_tiles.cuh: f32
// split into TF32 hi + lo, never rounded; bf16 exact), so what is left on
// the other units is one exponential, one FFMA, a max and an add a score.
// One block of 4 warps per (128 queries, head, batch row); a warp holds 32
// queries as mma A fragments. The head's keys and values pass through
// shared memory 64 at a time (already split; double-buffered, the next
// tile's loads in flight while the warp works on this one, one barrier a
// tile). Per tile a warp computes its 32 x 64 scores into registers with
// mma.sync, takes the tile's row maximum from them, rescales its running
// sum and P V once (online softmax), and feeds the exponentials back as
// the A operand of the P V mma in the accumulator layout (V staged in the
// matching key order: no shuffles). One exponential a score; the row sum
// divides once at the end.
//
// Under kFewKeys (256) keys (cross-attention over 1 or 77 condition
// tokens, bound by bytes: q read and o written once) the tensor-core layout
// does not pay (measured: probes/attention_variants.py, variant tc_all):
// those shapes keep the CUDA-core design of the kernel's first port, one
// thread per query with its q, its running softmax and P V in registers,
// keys and values staged 128 at a time as f32, two sweeps a tile (the
// tile's maximum, then exp2 and accumulate), f32 FMAs.
//
// For bf16 inputs with lse asked for (training), o32 also receives o in f32:
// the backward's Dr = rowsum(dO * O) must see O before its rounding (with
// the bf16 O it misses by more than a bf16 step of dQ).
//
// Head dims other than 4 and 8 up to 128 (VQ-Diffusion-B's 64, 12, 16, 32,
// 128) take the wg design (csrc/mha_wg.cuh) at the next of D = 16, 32, 64,
// 128, with the same online softmax over tiles of keys, for any number of
// keys: at d = 64 a query-key pair costs 128 multiply-adds against its one
// exponential, so the products bound it (f32: 3 TF32 products each; bf16:
// one, and P V's hi + lo pair). One block per (64 or 128 queries, head,
// batch row): a producer warp brings the block's q rows once and the keys
// and values a tile at a time (64 keys; 32 at f32 D = 128) by TMA into two
// slots; each consumer warpgroup takes 64 queries, computes a tile's scores
// with wgmma from shared memory into registers, takes the tile's row
// maximum there, rescales its running sum and o's accumulator, and feeds
// the exponentials back as the A operand of the P V wgmma. In f32 the
// consumers split each tile into TF32 hi + lo after it lands (q scaled
// first), v also transposed, since .tf32 takes no transposed operand. A few
// keys (cross-attention over 1 or 77 tokens) take the same kernel, the
// tile's missing keys masked.
//
// Head dims above 128 take the split design (csrc/mha_tiles.cuh: kSplitOut,
// kSplitChunk): a block of 4 warps per (64 queries, 128 output columns,
// head, batch row); per tile of 64 keys the ring brings the queries' and
// keys' dims 64 at a time (the scores summed over the whole head dim in the
// warp's registers), then the values' 128 columns of the block, and the
// online softmax and P V run as the mma.sync wide tiles (csrc/mha_tiles.cuh:
// WTf32, WBf16) compute them. Every column chunk
// recomputes the same scores (the same products in the same order, so the
// same values): at d = 256 a third of the products the kernel runs are that
// recompute, which the function's bound does not count. The chunk of
// columns 0 .. 127 writes lse.
#include "mha_tiles.cuh"
#include "mha_wg.cuh"

namespace {

using namespace mha;

// under this many keys K2 takes the CUDA-core design
constexpr int kFewKeys = 256;

// One tile of keys for the warp's queries: scores, the online softmax's
// rescale, exponentials, P V. MASKED: the tile holds n < kTile keys.
template <class Op, bool MASKED>
__device__ __forceinline__ void fwd_tile(
    const typename Op::RowsA& qa, const typename Op::DotTile& ks,
    const typename Op::PairTile& vs, int n, float c, float (&m)[kMT][2],
    float (&l)[kMT][2], typename Op::Acc& acc, int g, int tig) {
  const int nbv = MASKED ? (n + 7) >> 3 : kNB;
  float s[kNB][kMT][4];
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) {
    if (!MASKED || nb < nbv) {
      Op::mma_dot(s[nb], qa, ks, nb, g, tig);
      if (MASKED) {
        const int key = 8 * nb + 2 * tig;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          if (key >= n) s[nb][mt][0] = s[nb][mt][2] = -INFINITY;
          if (key + 1 >= n) s[nb][mt][1] = s[nb][mt][3] = -INFINITY;
        }
      }
    } else {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[nb][mt][j] = -INFINITY;
    }
  }
  float mc[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float x = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
        x = fmaxf(x, fmaxf(s[nb][mt][2 * hf], s[nb][mt][2 * hf + 1]));
      // the tile holds a key, so the new maximum is finite
      const float mn = fmaxf(m[mt][hf], quad_max(x));
      const float corr = ex2((m[mt][hf] - mn) * c);   // 0 on the first tile
      m[mt][hf] = mn;
      mc[mt][hf] = mn * c;
      l[mt][hf] *= corr;
      Op::scale_rows(acc, mt, hf, corr);
    }
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) {
    if (MASKED && nb >= nbv) continue;
    float p[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p[mt][j] = ex2(fmaf(s[nb][mt][j], c, -mc[mt][j >> 1]));
    Op::mma_pair(acc, p, vs, nb, g, tig);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      l[mt][0] += p[mt][0] + p[mt][1];
      l[mt][1] += p[mt][2] + p[mt][3];
    }
  }
}

// grid (ceil(Lq / kRowsBlock), H, B), kThreads threads
template <class Op, int D>
__global__ void __launch_bounds__(kThreads, Op::kMinBlocks)
fused_mha_fwd_kernel(const typename Op::T* __restrict__ q,
                     const typename Op::T* __restrict__ k,
                     const typename Op::T* __restrict__ v,
                     typename Op::T* __restrict__ o, float* __restrict__ o32,
                     float* __restrict__ lse, int Lq, int Lk, int C,
                     float c) {
  using T = typename Op::T;
  __shared__ typename Op::DotTile ks[2];
  __shared__ typename Op::PairTile vs[2];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int h = blockIdx.y;
  const size_t b = blockIdx.z;
  const int row0 = blockIdx.x * kRowsBlock + warp * kRowsWarp;
  const bool busy = row0 < Lq;   // warp-uniform

  typename Op::RowsA qa;
  Op::load_a(qa, q + b * Lq * C + h * D, row0, Lq, C, g, tig);
  typename Op::Acc acc;
  Op::zero(acc);
  float m[kMT][2], l[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      m[mt][hf] = -INFINITY;
      l[mt][hf] = 0.f;
    }

  // threads 0 .. kTile - 1 stage a key row each, the others a value row
  const int col = threadIdx.x % kTile;
  const bool stage_v = threadIdx.x >= kTile;
  const T* src = (stage_v ? v : k) + (b * Lk + col) * C + h * D;
  typename Op::Row r;
  Op::load_row(r, src, col < Lk);
  if (stage_v)
    Op::put_pair(vs[0], col, r);
  else
    Op::put_dot(ks[0], col, r);
  __syncthreads();

  const int ntiles = (Lk + kTile - 1) / kTile;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kTile;
    const bool more = t + 1 < ntiles;
    if (more)
      Op::load_row(r, src + static_cast<size_t>(k0 + kTile) * C,
                   k0 + kTile + col < Lk);
    if (busy) {
      const int n = min(kTile, Lk - k0);
      if (n == kTile)
        fwd_tile<Op, false>(qa, ks[t & 1], vs[t & 1], n, c, m, l, acc, g,
                            tig);
      else
        fwd_tile<Op, true>(qa, ks[t & 1], vs[t & 1], n, c, m, l, acc, g,
                           tig);
    }
    if (more) {
      if (stage_v)
        Op::put_pair(vs[(t + 1) & 1], col, r);
      else
        Op::put_dot(ks[(t + 1) & 1], col, r);
    }
    __syncthreads();
  }
  if (!busy) return;

  float inv[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[mt][hf] = quad_sum(l[mt][hf]);
      inv[mt][hf] = 1.f / l[mt][hf];
    }
  Op::store(o + b * Lq * C + h * D, acc, inv, row0, Lq, C, g, tig);
  if (o32 != nullptr)
    Op::store(o32 + b * Lq * C + h * D, acc, inv, row0, Lq, C, g, tig);
  if (lse != nullptr && tig == 0) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = row0 + 16 * mt + 8 * hf + g;
        if (row < Lq)
          lse[(b * gridDim.y + h) * Lq + row] =
              m[mt][hf] * c + log2f(l[mt][hf]);
      }
  }
}

template <int D>
__device__ __forceinline__ float dot(const float (&q)[D], const float4* k) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < D / 4; ++j) {
    const float4 kk = k[j];
    s = fmaf(q[4 * j + 0], kk.x, s);
    s = fmaf(q[4 * j + 1], kk.y, s);
    s = fmaf(q[4 * j + 2], kk.z, s);
    s = fmaf(q[4 * j + 3], kk.w, s);
  }
  return s;
}

constexpr int kFmaBlock = 128;   // queries (threads) a block
constexpr int kFmaTile = 128;    // keys a staged tile

// The CUDA-core design for few keys; grid (ceil(Lq / kFmaBlock), H, B).
template <typename T, int D>
__global__ void __launch_bounds__(kFmaBlock)
fused_mha_fwd_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         float* __restrict__ o32, float* __restrict__ lse,
                         int Lq, int Lk, int C, float c) {
  constexpr int V4 = D / 4;  // float4 per head row
  __shared__ float4 ks[kFmaTile * V4];
  __shared__ float4 vs[kFmaTile * V4];

  const int h = blockIdx.y;
  const size_t b = blockIdx.z;
  const int row = blockIdx.x * kFmaBlock + threadIdx.x;
  const bool active = row < Lq;

  float qr[D];
#pragma unroll
  for (int j = 0; j < V4; ++j) {
    const float4 t = active ? load4(q + (b * Lq + row) * C + h * D + 4 * j)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[4 * j + 0] = t.x * c;
    qr[4 * j + 1] = t.y * c;
    qr[4 * j + 2] = t.z * c;
    qr[4 * j + 3] = t.w * c;
  }

  float m = -INFINITY, l = 0.f, acc[D];
#pragma unroll
  for (int j = 0; j < D; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += kFmaTile) {
    const int n = min(kFmaTile, Lk - k0);
    __syncthreads();  // the previous tile is consumed
    if (threadIdx.x < n) {
      const size_t off = (b * Lk + k0 + threadIdx.x) * C + h * D;
#pragma unroll
      for (int j = 0; j < V4; ++j) {
        ks[threadIdx.x * V4 + j] = load4(k + off + 4 * j);
        vs[threadIdx.x * V4 + j] = load4(v + off + 4 * j);
      }
    }
    __syncthreads();

    float tmax = -INFINITY;
#pragma unroll 4
    for (int j = 0; j < n; ++j) tmax = fmaxf(tmax, dot<D>(qr, ks + j * V4));
    const float m_new = fmaxf(m, tmax);
    const float corr = exp2f(m - m_new);  // 0 on the first tile
    l *= corr;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float p = exp2f(dot<D>(qr, ks + j * V4) - m_new);
      l += p;
#pragma unroll
      for (int jj = 0; jj < V4; ++jj) {
        const float4 vv = vs[j * V4 + jj];
        acc[4 * jj + 0] = fmaf(p, vv.x, acc[4 * jj + 0]);
        acc[4 * jj + 1] = fmaf(p, vv.y, acc[4 * jj + 1]);
        acc[4 * jj + 2] = fmaf(p, vv.z, acc[4 * jj + 2]);
        acc[4 * jj + 3] = fmaf(p, vv.w, acc[4 * jj + 3]);
      }
    }
    m = m_new;
  }

  if (active) {
    const float inv = 1.f / l;
    const size_t off = (b * Lq + row) * C + h * D;
#pragma unroll
    for (int j = 0; j < V4; ++j) {
      const float4 r = make_float4(acc[4 * j + 0] * inv, acc[4 * j + 1] * inv,
                                   acc[4 * j + 2] * inv, acc[4 * j + 3] * inv);
      store4(o + off + 4 * j, r);
      if (o32 != nullptr) store4(o32 + off + 4 * j, r);
    }
    if (lse != nullptr) lse[(b * gridDim.y + h) * Lq + row] = m + log2f(l);
  }
}

// The wg design (csrc/mha_wg.cuh): grid (ceil(Lq / own rows), H, B),
// 128 threads a consumer warpgroup and a producer warp. Maps (d, L, H, B) of
// q, k, v with boxes of the own rows (q) and of a slot's rows (k, v), read
// when vec is 0; else the producer copies with cp.async, vec bytes a copy
// (csrc/mha_wg.cuh: load_tile).
// scale = 1 / sqrt(d); c: the base-2 factor of the scores (log2(e), times
// scale in bf16, where q is not scaled).
template <typename T, int D>
__global__ void __launch_bounds__(32 * (4 * wg::Cfg<T, D>::kFwdWG + 1), 1)
fused_mha_fwd_wg_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv,
                        const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        float* __restrict__ o32, float* __restrict__ lse,
                        int Lq, int Lk, int C, int d, int vec, float scale,
                        float c) {
  using G = wg::Cfg<T, D>;
  constexpr bool F32 = G::kF32;
  constexpr int NW = G::kFwdWG, KT = G::kFwdKT, NS = G::kFwdSlots;
  constexpr int R0 = 64 * NW, NC = 128 * NW;
  constexpr int KE = KT * D, QE = R0 * D;   // elements of a tile
  extern __shared__ __align__(1024) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* qlo = qs + QE;                              // f32: q's lo
  T* ring = qs + (F32 ? 2 : 1) * QE;             // slot i: k at 2 i, v 2 i + 1
  float* work = reinterpret_cast<float*>(ring + NS * 2 * KE);
  constexpr int WE = G::work(KT);                 // floats a work tile
  float* klo = work;                             // f32: k's lo, v^T hi, lo
  float* vth = work + WE;
  float* vtl = work + 2 * WE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(ring + NS * 2 * KE) +
      (F32 ? 3 * WE * sizeof(float) : 0));
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + NS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int blk0 = blockIdx.x * R0;
  const int ntiles = (Lk + KT - 1) / KT;
  if (threadIdx.x == 0) {
    wg::mbar_init(qbar, wg::arrivals(vec));
    for (int i = 0; i < NS; ++i) {
      wg::mbar_init(&full[i], wg::arrivals(vec));
      wg::mbar_init(&empty[i], NC);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * NW) {   // the producer
    const T* kh = k + static_cast<size_t>(b) * Lk * C + h * d;
    const T* vh = v + static_cast<size_t>(b) * Lk * C + h * d;
    if (vec == 0 && lane == 0) wg::mbar_expect(qbar, QE * sizeof(T));
    wg::load_tile<T, D, R0>(qs, &mq, qbar,
                            q + static_cast<size_t>(b) * Lq * C + h * d, blk0,
                            Lq, h, b, C, d, vec, lane);
    wg::loaded(qbar, vec);
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % NS;
      if (t >= NS) wg::mbar_wait(&empty[s], (t / NS - 1) & 1);
      T* kt = ring + 2 * s * KE;
      if (vec == 0 && lane == 0) wg::mbar_expect(&full[s], 2 * KE * sizeof(T));
      wg::load_tile<T, D, KT>(kt, &mk, &full[s], kh, t * KT, Lk, h, b, C, d,
                              vec, lane);
      wg::load_tile<T, D, KT>(kt + KE, &mv, &full[s], vh, t * KT, Lk, h, b, C,
                              d, vec, lane);
      wg::loaded(&full[s], vec);
    }
    return;
  }

  // the consumers: warpgroup w takes own rows 64 w ..
  const int tid = threadIdx.x, w = warp >> 2;
  const int g = lane >> 2, tig = lane & 3;
  const int row = blk0 + 64 * w + 16 * (warp & 3) + g;   // and row + 8
  wg::landed(qbar, 0, vec);
  if constexpr (F32) {
    wg::split_tile<R0, D, true, false>(reinterpret_cast<float*>(qs),
                                       reinterpret_cast<float*>(qlo), nullptr,
                                       nullptr, scale, tid, NC);
    wg::fence_async();
    wg::consumers_sync(NC);
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % NS;
    wg::landed(&full[s], (t / NS) & 1, vec);
    T* kt = ring + 2 * s * KE;
    T* vt = kt + KE;
    if constexpr (F32) {
      wg::split_tile<KT, D, true, false>(reinterpret_cast<float*>(kt), klo,
                                         nullptr, nullptr, 1.f, tid, NC);
      wg::split_tile<KT, D, false, true>(reinterpret_cast<float*>(vt),
                                         nullptr, vth, vtl, 1.f, tid, NC);
      wg::fence_async();
      wg::consumers_sync(NC);
    }
    // S = q k^T over the head dim
    float sc[KT / 2];
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) sc[i] = 0.f;
    wg::hold(sc);
    wg::wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / G::kK; ++ks) {
      const uint64_t aq = wg::desc_k<R0>(qs, ks, 64 * w);
      const uint64_t bk = wg::desc_k<KT>(kt, ks);
      if constexpr (F32) {
        wg::wg_ss_tf32<KT>(sc, aq, bk, 1);
        wg::wg_ss_tf32<KT>(sc, aq, wg::desc_k<KT>(klo, ks), 1);
        wg::wg_ss_tf32<KT>(sc, wg::desc_k<R0>(qlo, ks, 64 * w), bk, 1);
      } else {
        wg::wg_ss_bf16<KT>(sc, aq, bk, 1);
      }
    }
    wg::wg_commit();
    wg::wg_wait();
    wg::hold(sc);

    const int n = min(KT, Lk - t * KT);
    if (n < KT) {
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        const int key = 8 * j + 2 * tig;
        if (key >= n) sc[4 * j] = sc[4 * j + 2] = -INFINITY;
        if (key + 1 >= n) sc[4 * j + 1] = sc[4 * j + 3] = -INFINITY;
      }
    }
    // online softmax: the tile's row maximum, the running sums rescaled
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float x = -INFINITY;
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
        x = fmaxf(x, fmaxf(sc[4 * j + 2 * hf], sc[4 * j + 2 * hf + 1]));
      const float mn = fmaxf(m[hf], quad_max(x));   // finite: a key a tile
      const float corr = ex2((m[hf] - mn) * c);      // 0 on the first tile
      m[hf] = mn;
      l[hf] *= corr;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 2 * hf] *= corr;
        acc[4 * j + 2 * hf + 1] *= corr;
      }
      const float mc = mn * c;
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(fmaf(sc[4 * j + 2 * hf + e], c, -mc));
          sc[4 * j + 2 * hf + e] = p;
          l[hf] += p;
        }
    }
    // acc += P v, P fed back from the registers, over the tile's steps
    // that hold a key
    const int steps = (n + G::kK - 1) / G::kK;
    if constexpr (F32) {
      unsigned ph[KT / 8][4], pl[KT / 8][4];
      wg::feed_tf32<KT>(ph, pl, sc);
      wg::hold(acc);
      wg::wg_fence();
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        if (j >= steps) break;
        wg::wg_rs_tf32<D>(acc, ph[j], wg::desc_t<D>(vth, j), 1);
        wg::wg_rs_tf32<D>(acc, ph[j], wg::desc_t<D>(vtl, j), 1);
        wg::wg_rs_tf32<D>(acc, pl[j], wg::desc_t<D>(vth, j), 1);
      }
      wg::wg_commit();
      wg::wg_wait();
      wg::hold(acc);
      wg::hold(ph);
      wg::hold(pl);
    } else {
      unsigned ph[KT / 16][4], pl[KT / 16][4];
      wg::feed_bf16<KT>(ph, pl, sc);
      wg::hold(acc);
      wg::wg_fence();
#pragma unroll
      for (int j = 0; j < KT / 16; ++j) {
        if (j >= steps) break;
        wg::wg_rs_bf16<D>(acc, ph[j], wg::desc_mn<KT>(vt, j), 1);
        wg::wg_rs_bf16<D>(acc, pl[j], wg::desc_mn<KT>(vt, j), 1);
      }
      wg::wg_commit();
      wg::wg_wait();
      wg::hold(acc);
      wg::hold(ph);
      wg::hold(pl);
    }
    wg::mbar_arrive(&empty[s]);
    if constexpr (F32) wg::consumers_sync(NC);   // the work tiles are free
  }

  float inv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] = quad_sum(l[hf]);
    inv[hf] = 1.f / l[hf];
  }
  const size_t qoff = static_cast<size_t>(b) * Lq * C + h * d;
  wg::store_rows<D>(o + qoff, acc, inv, row, Lq, C, d, tig);
  if (o32 != nullptr) wg::store_rows<D>(o32 + qoff, acc, inv, row, Lq, C, d,
                                        tig);
  if (lse != nullptr && tig == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      if (row + 8 * hf < Lq)
        lse[(static_cast<size_t>(b) * gridDim.y + h) * Lq + row + 8 * hf] =
            m[hf] * c + log2f(l[hf]);
  }
}

// The split design (head dims above 128): grid (ceil(Lq / kWRowsBlock),
// H * n_oc, B), n_oc = ceil(d / kSplitOut) column chunks (blockIdx.y = h
// n_oc + chunk), kThreads threads, dynamic shared memory of two ring slots
// (the larger of a contraction stage, q and k at kSplitChunk dims, and a
// value stage, kSplitOut columns). vec: the bytes of a copy into shared
// memory; other arguments as the wg kernel's.
template <template <int> class W>
__global__ void __launch_bounds__(kThreads)
fused_mha_fwd_split_kernel(const typename W<kSplitChunk>::T* __restrict__ q,
                           const typename W<kSplitChunk>::T* __restrict__ k,
                           const typename W<kSplitChunk>::T* __restrict__ v,
                           typename W<kSplitChunk>::T* __restrict__ o,
                           float* __restrict__ o32, float* __restrict__ lse,
                           int Lq, int Lk, int C, int d, int vec,
                           float scale, float c) {
  using OpC = W<kSplitChunk>;
  using OpO = W<kSplitOut>;
  using T = typename OpC::T;
  constexpr int SC = OpC::S, SO = OpO::S, kTileC = kWTile * SC;
  constexpr int kSlot =
      2 * kTileC > kWTile * SO ? 2 * kTileC : kWTile * SO;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int n_ic = (d + kSplitChunk - 1) / kSplitChunk;
  const int n_oc = (d + kSplitOut - 1) / kSplitOut;
  const int h = blockIdx.y / n_oc, oc = blockIdx.y % n_oc;
  const int H = gridDim.y / n_oc;
  const size_t b = blockIdx.z;
  const int blk0 = blockIdx.x * kWRowsBlock;
  const int r0 = warp * kWRows;
  const bool busy = blk0 + r0 < Lq;
  const T* qh = q + b * Lq * C + h * d;
  const T* kh = k + b * Lk * C + h * d;
  const T* vh = v + b * Lk * C + h * d;
  const int dout = min(kSplitOut, d - oc * kSplitOut);

  // stage u of tile t = u / per: contraction chunk j = u % per of q and k,
  // or (j = n_ic) the tile's values at the block's columns
  const int per = n_ic + 1;
  const int ntiles = (Lk + kWTile - 1) / kWTile;
  const int n_st = ntiles * per;
  auto issue = [&](int u) {
    T* slot = ring + (u & 1) * kSlot;
    const int t = u / per, j = u % per;
    if (j < n_ic) {
      const int dj = min(kSplitChunk, d - j * kSplitChunk);
      stage<T, kSplitChunk, SC>(slot, qh + j * kSplitChunk, blk0, Lq, C, dj,
                                vec);
      stage<T, kSplitChunk, SC>(slot + kTileC, kh + j * kSplitChunk,
                                t * kWTile, Lk, C, dj, vec);
    } else {
      stage<T, kSplitOut, SO>(slot, vh + oc * kSplitOut, t * kWTile, Lk, C,
                              dout, vec);
    }
    cp_async_commit();
  };

  const float fq = OpC::kScaledQ ? scale : 1.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[kSplitOut / 8][4], s[kWNB][4];
#pragma unroll
  for (int dc = 0; dc < kSplitOut / 8; ++dc)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[dc][j] = 0.f;

  issue(0);
  for (int u = 0; u < n_st; ++u) {
    if (u + 1 < n_st) {
      issue(u + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* slot = ring + (u & 1) * kSlot;
    const int t = u / per, j = u % per;
    const int n = min(kWTile, Lk - t * kWTile);
    const int nbv = (n + 7) >> 3;
    if (busy && j < n_ic) {
      if (j == 0) {
#pragma unroll
        for (int nb = 0; nb < kWNB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
      }
#pragma unroll 1
      for (int kc = 0; kc < kSplitChunk / OpC::kK; ++kc) {
        typename OpC::Frag a;
        OpC::load_a(a, slot, r0, kc, fq, g, tig);
#pragma unroll
        for (int nb = 0; nb < kWNB; ++nb)
          if (nb < nbv) OpC::dot(s[nb], a, slot + kTileC, nb, kc, 1.f, g, tig);
      }
    } else if (busy) {
#pragma unroll
      for (int nb = 0; nb < kWNB; ++nb) {
        const int key = 8 * nb + 2 * tig;
        if (key >= n) s[nb][0] = s[nb][2] = -INFINITY;
        if (key + 1 >= n) s[nb][1] = s[nb][3] = -INFINITY;
      }
      float mc[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float x = -INFINITY;
#pragma unroll
        for (int nb = 0; nb < kWNB; ++nb)
          x = fmaxf(x, fmaxf(s[nb][2 * hf], s[nb][2 * hf + 1]));
        const float mn = fmaxf(m[hf], quad_max(x));
        const float corr = ex2((m[hf] - mn) * c);   // 0 on the first tile
        m[hf] = mn;
        mc[hf] = mn * c;
        l[hf] *= corr;
#pragma unroll
        for (int dc = 0; dc < kSplitOut / 8; ++dc) {
          acc[dc][2 * hf] *= corr;
          acc[dc][2 * hf + 1] *= corr;
        }
      }
#pragma unroll
      for (int nb = 0; nb < kWNB; ++nb) {
        if (nb >= nbv) continue;
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = ex2(fmaf(s[nb][e], c, -mc[e >> 1]));
        typename OpO::Frag pa;
        OpO::make_p(pa, p);
        OpO::pair(acc, pa, slot, nb, 1.f, g, tig);
        l[0] += p[0] + p[1];
        l[1] += p[2] + p[3];
      }
    }
    // the slot staged next was read in this stage
    __syncthreads();
  }
  if (!busy) return;

  float inv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] = quad_sum(l[hf]);
    inv[hf] = 1.f / l[hf];
  }
  const int row0 = blk0 + r0;
  const size_t ooff = b * Lq * C + h * d + oc * kSplitOut;
  store_wide<kSplitOut>(o + ooff, acc, inv, row0, Lq, C, dout, g, tig);
  if (o32 != nullptr)
    store_wide<kSplitOut>(o32 + ooff, acc, inv, row0, Lq, C, dout, g, tig);
  if (lse != nullptr && oc == 0 && tig == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = row0 + g + 8 * hf;
      if (row < Lq) lse[(b * H + h) * Lq + row] = m[hf] * c + log2f(l[hf]);
    }
  }
}

template <template <int> class W>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         void* o, float* o32, float* lse, int B, int Lq,
                         int Lk, int C, int H, int d, cudaStream_t stream) {
  using T = typename W<kSplitChunk>::T;
  const int n_oc = (d + kSplitOut - 1) / kSplitOut;
  if (static_cast<long long>(H) * n_oc > 65535) return cudaErrorInvalidValue;
  const size_t tc = 2 * static_cast<size_t>(kWTile) * W<kSplitChunk>::S;
  const size_t to = static_cast<size_t>(kWTile) * W<kSplitOut>::S;
  const size_t smem = 2 * (tc > to ? tc : to) * sizeof(T);
  const cudaError_t attr = cudaFuncSetAttribute(
      fused_mha_fwd_split_kernel<W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  const float c = W<kSplitChunk>::kScaledQ ? kLog2e : kLog2e * scale;
  fused_mha_fwd_split_kernel<W>
      <<<dim3((Lq + kWRowsBlock - 1) / kWRowsBlock, H * n_oc, B), kThreads,
         smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                         static_cast<const T*>(v), static_cast<T*>(o), o32,
                         lse, Lq, Lk, C, d,
                         copy_bytes(d * static_cast<int>(sizeof(T))), scale,
                         c);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_wg(const void* q, const void* k, const void* v, void* o,
                      float* o32, float* lse, int B, int Lq, int Lk, int C,
                      int H, int d, cudaStream_t stream) {
  using G = wg::Cfg<T, D>;
  constexpr int NW = G::kFwdWG, R0 = 64 * NW;
  constexpr bool bf16 = !G::kF32;
  int vec = wg::copy_mode(d, static_cast<int>(sizeof(T)));
  CUtensorMap mq{}, mk{}, mv{};
  if (!(wg::make_map(&mq, q, bf16, B, Lq, H, d, R0, vec) &&
        wg::make_map(&mk, k, bf16, B, Lk, H, d, G::kFwdKT, vec) &&
        wg::make_map(&mv, v, bf16, B, Lk, H, d, G::kFwdKT, vec))) {
    ++wg::tma_refused();   // the map was refused: copy by cp.async
    vec = copy_bytes(d * static_cast<int>(sizeof(T)));
  }
  constexpr size_t smem = G::fwd_smem();
  const cudaError_t attr = cudaFuncSetAttribute(
      fused_mha_fwd_wg_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  const float c = bf16 ? kLog2e * scale : kLog2e;
  fused_mha_fwd_wg_kernel<T, D>
      <<<dim3((Lq + R0 - 1) / R0, H, B), 32 * (4 * NW + 1), smem, stream>>>(
          mq, mk, mv, static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), o32, lse, Lq, Lk, C,
          d, vec, scale, c);
  return cudaGetLastError();
}

template <class Op, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* o32, float* lse, int B, int Lq, int Lk, int C,
                   int H, cudaStream_t stream) {
  using T = typename Op::T;
  // softmax(x) = 2^(x log2 e) / sum: scores times log2(e) / sqrt(D)
  const float c = kLog2e / sqrtf(static_cast<float>(D));
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  if (Lk < kFewKeys)
    fused_mha_fwd_fma_kernel<T, D>
        <<<dim3((Lq + kFmaBlock - 1) / kFmaBlock, H, B), kFmaBlock, 0,
           stream>>>(qt, kt, vt, static_cast<T*>(o), o32, lse, Lq, Lk, C, c);
  else
    fused_mha_fwd_kernel<Op, D>
        <<<dim3((Lq + kRowsBlock - 1) / kRowsBlock, H, B), kThreads, 0,
           stream>>>(qt, kt, vt, static_cast<T*>(o), o32, lse, Lq, Lk, C, c);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for a bad shape, else the
// launch's status. Any head dim: 4 and 8, the wg design up to 128, the
// split design above. bf16 selects the input type (0: f32, 1: bf16); lse
// and o32 (f32, o's shape) may be null.
extern "C" int fused_mha_fwd(const void* q, const void* k, const void* v,
                             void* o, float* o32, float* lse, int B, int Lq,
                             int Lk, int C, int H, int bf16, void* stream) {
  if (H <= 0 || C % H != 0 || Lq <= 0 || Lk <= 0 || B <= 0 || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = C / H;
  cudaError_t err = cudaErrorInvalidValue;
  if (d > kMaxHeadDim)
    err = bf16 ? launch_split<WBf16>(q, k, v, o, o32, lse, B, Lq, Lk, C, H,
                                     d, s)
               : launch_split<WTf32>(q, k, v, o, o32, lse, B, Lq, Lk, C, H,
                                     d, s);
  else if (d == 4 && !bf16)
    err = launch<Tf32<4>, 4>(q, k, v, o, o32, lse, B, Lq, Lk, C, H, s);
  else if (d == 8 && !bf16)
    err = launch<Tf32<8>, 8>(q, k, v, o, o32, lse, B, Lq, Lk, C, H, s);
  else if (d == 4)
    err = launch<Bf16<4>, 4>(q, k, v, o, o32, lse, B, Lq, Lk, C, H, s);
  else if (d == 8)
    err = launch<Bf16<8>, 8>(q, k, v, o, o32, lse, B, Lq, Lk, C, H, s);
  else if (!bf16)
    err = wg::at_width(d, [&](auto w) {
      return launch_wg<float, decltype(w)::value>(q, k, v, o, o32, lse, B, Lq,
                                                  Lk, C, H, d, s);
    });
  else
    err = wg::at_width(d, [&](auto w) {
      return launch_wg<__nv_bfloat16, decltype(w)::value>(
          q, k, v, o, o32, lse, B, Lq, Lk, C, H, d, s);
    });
  return static_cast<int>(err);
}

// The wg design's sizes at instantiation D (16, 32, 64, 128), f32 (bf16 =
// 0) or bf16: out[0 .. 5] = K2's consumer warpgroups and keys a tile, the
// dq kernel's, the dk/dv kernel's (ops/attention.py: wg_tiles). Returns 0,
// or cudaErrorInvalidValue for another D.
extern "C" int fused_mha_wg_tiles(int D, int bf16, int* out) {
  if (D != 16 && D != 32 && D != 64 && D != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(wg::at_width(D, [&](auto w) {
    constexpr int W = decltype(w)::value;
    auto put = [&](auto cfg) {
      using G = decltype(cfg);
      const int v[6] = {G::kFwdWG, G::kFwdKT, G::kDqWG,
                        G::kDqKT,  G::kKvWG,  G::kKvKT};
      for (int i = 0; i < 6; ++i) out[i] = v[i];
    };
    if (bf16)
      put(wg::Cfg<__nv_bfloat16, W>{});
    else
      put(wg::Cfg<float, W>{});
    return cudaSuccess;
  }));
}

// Launches of this library that took cp.async because a tensor map was
// refused, and the last refusal's CUresult (-1: no entry point), for the
// wrapper's reports.
extern "C" int fused_mha_tma_refused(int* error) {
  *error = mha::wg::tma_error();
  return mha::wg::tma_refused();
}
