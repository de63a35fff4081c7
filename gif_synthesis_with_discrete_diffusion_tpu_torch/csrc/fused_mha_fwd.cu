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
// Head dims above 128 take the stream design (csrc/mha_wg.cuh: Stream) on
// the same wgmma and TMA. What bounds it there: at d = 256 a pair costs 512
// multiply-adds against one exponential, and the rows that feed them are
// long (512 bytes of bf16, 1 KB of f32 split into hi + lo a row), so the
// bytes each product reads into shared memory decide the time. A block of
// two consumer warpgroups (64 queries each; registers moved to them from
// the producer warpgroup by setmaxnreg: an OC-column accumulator is 128
// registers a thread at OC = 256) owns 128 queries and OC output columns
// (192 for d up to 192, 256 up to 256). Every score is computed once: each
// warpgroup sums a tile's S over the whole head dim in increasing order of
// the dims into one set of registers, runs the online softmax once and
// feeds the same P to every output column it owns. bf16 heads up to 256
// keep q resident (64 KB); the keys and values come by tile through a ring
// of four slots, one TMA copy a tile (a 5-d map whose box lands the
// no-swizzle core-matrix layout). f32 cannot hold its q's hi and lo (256
// KB at d = 256): a pass before the kernel splits q (times 1 / sqrt(d)),
// k and v once into TF32 hi and lo in device memory (v transposed, since
// .tf32 takes no transposed operand), and score stages stream 16 dims of
// both sides' hi and lo at a time, value stages 64 of the block's columns
// of v^T, in TMA's swizzled layouts (a row's 64 or 128 bytes one piece of
// a copy, where the core-matrix layout takes 16 bytes a piece). One group
// of wgmma stays in flight across stages. Wider heads run
// in column chunks of 192 or 256 (a grid axis), each chunk's blocks
// computing the scores again (at d = 512 a third of K2's products). The
// chunk of columns 0 .. OC - 1 writes lse.
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

// The stream design (head dims above 128, csrc/mha_wg.cuh: Stream): grid
// (ceil(Lq / 128), H * n_oc, B), blockIdx.y = h n_oc + oc, the head's
// output columns in n_oc chunks of OC; two consumer warpgroups of 64
// queries and a producer warpgroup (384 threads), RES: q resident. Maps
// (csrc/mha_wg.cuh: StreamMaps, a tile a box; bf16 5-d, f32 swizzled) of
// q, k and v: bf16 the
// inputs', read when vec is 0 (else the producer copies by cp.async,
// load_tile); f32 the prepared hi and lo of q (times scale) and k,
// head-major, and of v transposed. Arguments otherwise as the wg kernel's.
template <typename T, int OC, bool RES>
__global__ void __launch_bounds__(128 * 3, 1)
fused_mha_fwd_stream_kernel(const __grid_constant__ wg::StreamMaps maps,
                            const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o,
                            float* __restrict__ o32, float* __restrict__ lse,
                            int Lq, int Lk, int C, int d, int vec,
                            float c) {
  using G = wg::Stream<T, OC, RES>;
  constexpr bool F32 = G::kF32;
  constexpr int NP = G::kNP, R0 = G::kFwdRows, KT = G::kFwdKT;
  constexpr int SC = G::kSCW, VC = G::kFwdVC, NV = OC / VC;
  constexpr int NS = G::kFwdSlots, NC = 128 * G::kWG, SE = G::fwd_slot();
  // elements of a score stage's own rows, before its tile of keys
  constexpr int OWN = RES ? 0 : NP * R0 * SC;
  extern __shared__ __align__(1024) unsigned char smem[];
  T* own = reinterpret_cast<T*>(wg::stream_base<T>(smem));   // RES: q, resident
  T* ring = own + G::fwd_own();
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + NS * SE);
  uint64_t* empty = full + NS;
  uint64_t* obar = empty + NS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_oc = (d + OC - 1) / OC;
  const int h = blockIdx.y / n_oc, oc = blockIdx.y % n_oc;
  const int H = gridDim.y / n_oc, b = blockIdx.z;
  const int blk0 = blockIdx.x * R0, col0 = oc * OC;
  // stage j of tile t: j < n_sc the scores' dims j SC .., else the values'
  // columns col0 + (j - n_sc) VC ..
  const int n_sc = RES ? 1 : (d + SC - 1) / SC, per = n_sc + NV;
  const int ntiles = (Lk + KT - 1) / KT;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      wg::mbar_init(&full[i], wg::arrivals(vec));
      wg::mbar_init(&empty[i], NC);
    }
    wg::mbar_init(obar, wg::arrivals(vec));
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * G::kWG) {   // the producer warpgroup: one warp loads
    wg::producer_regs();
    if (warp != 4 * G::kWG) return;
    const T* qh = q + static_cast<size_t>(b) * Lq * C + h * d;
    const T* kh = k + static_cast<size_t>(b) * Lk * C + h * d;
    const T* vh = v + static_cast<size_t>(b) * Lk * C + h * d;
    if constexpr (RES) {
      if (vec == 0 && lane == 0) wg::mbar_expect(obar, R0 * OC * sizeof(T));
      wg::stream_tile<T, OC, R0>(own, &maps.m[0], obar, qh, blk0, Lq, h, b,
                                 C, d, vec, lane, 0);
      wg::loaded(obar, vec);
    }
    for (int u = 0; u < ntiles * per; ++u) {
      const int s = u % NS, t = u / per, j = u % per;
      if (u >= NS) wg::mbar_wait(&empty[s], (u / NS - 1) & 1);
      T* slot = ring + s * SE;
      if (j < n_sc) {
        if (vec == 0 && lane == 0)
          wg::mbar_expect(&full[s], (OWN + NP * KT * SC) * sizeof(T));
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          if constexpr (!RES)
            wg::stream_tile<T, SC, R0>(slot + p * R0 * SC, &maps.m[p],
                                       &full[s], qh, blk0, Lq, h, b, C, d,
                                       vec, lane, j * SC);
          wg::stream_tile<T, SC, KT>(slot + OWN + p * KT * SC,
                                     &maps.m[NP + p], &full[s], kh, t * KT,
                                     Lk, h, b, C, d, vec, lane, j * SC);
        }
      } else {
        const int c0 = col0 + (j - n_sc) * VC;
        if (vec == 0 && lane == 0)
          wg::mbar_expect(&full[s], NP * KT * VC * sizeof(T));
        if constexpr (F32) {
          wg::stream_tile_t<VC>(slot, &maps.m[4], &full[s], t * KT, c0, h,
                                b, lane);
          wg::stream_tile_t<VC>(slot + KT * VC, &maps.m[5], &full[s], t * KT,
                                c0, h, b, lane);
        } else {
          wg::stream_tile<T, VC, KT>(slot, &maps.m[2], &full[s], vh, t * KT,
                                     Lk, h, b, C, d, vec, lane, c0);
        }
      }
      wg::loaded(&full[s], vec);
    }
    return;
  }

  // the consumers: warpgroup w takes queries 64 w ..; one group of wgmma
  // stays in flight across stages (its slot released when the next group
  // has been issued)
  wg::consumer_regs();
  const int w = warp >> 2, g = lane >> 2, tig = lane & 3;
  const int row = blk0 + 64 * w + 16 * (warp & 3) + g;   // and row + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NV][VC / 2];
#pragma unroll
  for (int cc = 0; cc < NV; ++cc)
#pragma unroll
    for (int i = 0; i < VC / 2; ++i) acc[cc][i] = 0.f;
  if constexpr (RES) wg::landed(obar, 0, vec);
  int pend = -1;   // the slot the group in flight reads
  auto next_group = [&](int s) {
    wg::wg_commit();
    wg::wg_wait1();
    if (pend >= 0) wg::mbar_arrive(&empty[pend]);
    pend = s;
  };
  auto all_groups = [&]() {
    wg::wg_wait();
    wg::mbar_arrive(&empty[pend]);
    pend = -1;
  };

  for (int t = 0; t < ntiles; ++t) {
    // S = q k^T over the head dim, a score stage at a time
    float sc[KT / 2];
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) sc[i] = 0.f;
    wg::hold(sc);
    for (int j = 0; j < n_sc; ++j) {
      const int u = t * per + j, s = u % NS;
      wg::landed(&full[s], (u / NS) & 1, vec);
      const T* qt = RES ? own : ring + s * SE;
      const T* kt = ring + s * SE + OWN;
      wg::wg_fence();
#pragma unroll
      for (int ks = 0; ks < SC / G::kK; ++ks) {
        const uint64_t aq = wg::desc_score<T, R0>(qt, ks, 64 * w);
        const uint64_t bk = wg::desc_score<T, KT>(kt, ks);
        if constexpr (F32) {   // hi hi, hi lo, lo hi
          const uint64_t bl = wg::desc_score<T, KT>(kt + KT * SC, ks);
          const uint64_t al = wg::desc_score<T, R0>(qt + R0 * SC, ks, 64 * w);
          wg::wg_ss_tf32<KT>(sc, aq, bk, 1);
          wg::wg_ss_tf32<KT>(sc, aq, bl, 1);
          wg::wg_ss_tf32<KT>(sc, al, bk, 1);
        } else {
          wg::wg_ss_bf16<KT>(sc, aq, bk, 1);
        }
      }
      next_group(s);
    }
    all_groups();
    wg::hold(sc);

    // the tile's keys past Lk masked (selects: no branch around the
    // registers the products feed from)
    const int n = Lk - t * KT;
#pragma unroll
    for (int j = 0; j < KT / 2; ++j) {
      const int key = 8 * (j >> 2) + 2 * tig + (j & 1);
      sc[j] = key < n ? sc[j] : -INFINITY;
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
      for (int cc = 0; cc < NV; ++cc)
#pragma unroll
        for (int j = 0; j < VC / 8; ++j) {
          acc[cc][4 * j + 2 * hf] *= corr;
          acc[cc][4 * j + 2 * hf + 1] *= corr;
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
    // acc += P v, a value stage (VC of the block's columns) at a time, P fed
    // back from the registers (every step: P is 0 past the keys)
    constexpr int NJ = KT / G::kK;
    unsigned ph[NJ][4], pl[NJ][4];
    if constexpr (F32)
      wg::feed_tf32<KT>(ph, pl, sc);
    else
      wg::feed_bf16<KT>(ph, pl, sc);
#pragma unroll
    for (int cc = 0; cc < NV; ++cc) wg::hold(acc[cc]);
#pragma unroll
    for (int cc = 0; cc < NV; ++cc) {
      const int u = t * per + n_sc + cc, s = u % NS;
      wg::landed(&full[s], (u / NS) & 1, vec);
      const T* vt = ring + s * SE;
      wg::wg_fence();
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if constexpr (F32) {
          wg::wg_rs_tf32<VC>(acc[cc], ph[j], wg::desc_v128<VC>(vt, j), 1);
          wg::wg_rs_tf32<VC>(acc[cc], ph[j],
                             wg::desc_v128<VC>(vt + KT * VC, j), 1);
          wg::wg_rs_tf32<VC>(acc[cc], pl[j], wg::desc_v128<VC>(vt, j), 1);
        } else {
          wg::wg_rs_bf16<VC>(acc[cc], ph[j], wg::desc_mn<KT>(vt, j), 1);
          wg::wg_rs_bf16<VC>(acc[cc], pl[j], wg::desc_mn<KT>(vt, j), 1);
        }
      }
      next_group(s);
    }
    all_groups();
#pragma unroll
    for (int cc = 0; cc < NV; ++cc) wg::hold(acc[cc]);
    wg::hold(ph);
    wg::hold(pl);
  }

  float inv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] = quad_sum(l[hf]);
    inv[hf] = 1.f / l[hf];
  }
  const size_t qoff = static_cast<size_t>(b) * Lq * C + h * d;
#pragma unroll
  for (int cc = 0; cc < NV; ++cc) {
    const int c0 = col0 + cc * VC;
    wg::store_rows<VC>(o + qoff + c0, acc[cc], inv, row, Lq, C, d - c0, tig);
    if (o32 != nullptr)
      wg::store_rows<VC>(o32 + qoff + c0, acc[cc], inv, row, Lq, C, d - c0,
                         tig);
  }
  if (lse != nullptr && oc == 0 && tig == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      if (row + 8 * hf < Lq)
        lse[(static_cast<size_t>(b) * H + h) * Lq + row + 8 * hf] =
            m[hf] * c + log2f(l[hf]);
  }
}

// the f32 stream design's prepared operands in `prep` (floats; the
// wrapper's ops/attention.py: stream_prep_floats): q times 1 / sqrt(d) and
// k head-major, hi then lo, then v transposed, hi then lo
template <typename T, int OC, bool RES>
cudaError_t launch_stream(const void* q, const void* k, const void* v,
                          void* o, float* o32, float* lse, int B, int Lq,
                          int Lk, int C, int H, int d, float* prep,
                          cudaStream_t stream) {
  using G = wg::Stream<T, OC, RES>;
  constexpr bool bf16 = !G::kF32;
  const int n_oc = (d + OC - 1) / OC;
  if (static_cast<long long>(H) * n_oc > 65535) return cudaErrorInvalidValue;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  int vec = 0;
  wg::StreamMaps maps{};
  if constexpr (bf16) {
    vec = wg::copy_mode(d, 2);
    constexpr int SC = G::kSCW, KT = G::kFwdKT;
    if (vec == 0 &&
        !(wg::map_in(&maps.m[0], q, B, Lq, H, d, G::kFwdRows,
                     RES ? OC : SC) &&
          wg::map_in(&maps.m[1], k, B, Lk, H, d, KT, SC) &&
          wg::map_in(&maps.m[2], v, B, Lk, H, d, KT, G::kFwdVC))) {
      ++wg::tma_refused();   // the map was refused: copy by cp.async
      vec = copy_bytes(d * 2);
    }
  } else {
    if (prep == nullptr) return cudaErrorInvalidValue;
    const size_t nq = static_cast<size_t>(B) * H * Lq * wg::stream_dp(d);
    const size_t nk = static_cast<size_t>(B) * H * Lk * wg::stream_dp(d);
    const size_t nt = static_cast<size_t>(B) * H * d * wg::stream_l8(Lk);
    float* p[6] = {prep, prep + nq, prep + 2 * nq, prep + 2 * nq + nk,
                   prep + 2 * (nq + nk), prep + 2 * (nq + nk) + nt};
    cudaError_t err = wg::stream_prep(q, p[0], p[1], nullptr, nullptr, B, Lq,
                                      H, d, scale, stream);
    if (err == cudaSuccess)
      err = wg::stream_prep(k, p[2], p[3], nullptr, nullptr, B, Lk, H, d,
                            1.f, stream);
    if (err == cudaSuccess)
      err = wg::stream_prep(v, nullptr, nullptr, p[4], p[5], B, Lk, H, d,
                            1.f, stream);
    if (err != cudaSuccess) return err;
    constexpr int R0 = G::kFwdRows, KT = G::kFwdKT;
    if (!(wg::map_prep(&maps.m[0], p[0], B, Lq, H, d, R0) &&
          wg::map_prep(&maps.m[1], p[1], B, Lq, H, d, R0) &&
          wg::map_prep(&maps.m[2], p[2], B, Lk, H, d, KT) &&
          wg::map_prep(&maps.m[3], p[3], B, Lk, H, d, KT) &&
          wg::map_prep_t(&maps.m[4], p[4], B, Lk, H, d, G::kFwdVC) &&
          wg::map_prep_t(&maps.m[5], p[5], B, Lk, H, d, G::kFwdVC))) {
      ++wg::tma_refused();   // no cp.async path for the prepared operands
      return cudaErrorNotSupported;
    }
  }
  constexpr size_t smem = G::fwd_smem();
  const cudaError_t attr = cudaFuncSetAttribute(
      fused_mha_fwd_stream_kernel<T, OC, RES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const float c = bf16 ? kLog2e * scale : kLog2e;
  fused_mha_fwd_stream_kernel<T, OC, RES>
      <<<dim3((Lq + G::kFwdRows - 1) / G::kFwdRows, H * n_oc, B),
         128 * (G::kWG + 1), smem, stream>>>(
          maps, static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), o32, lse, Lq, Lk, C,
          d, vec, c);
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
// stream design above. bf16 selects the input type (0: f32, 1: bf16); lse
// and o32 (f32, o's shape) may be null. prep: the f32 stream design's
// prepared operands (launch_stream), else it may be null.
extern "C" int fused_mha_fwd(const void* q, const void* k, const void* v,
                             void* o, float* o32, float* lse, int B, int Lq,
                             int Lk, int C, int H, int bf16, float* prep,
                             void* stream) {
  if (H <= 0 || C % H != 0 || Lq <= 0 || Lk <= 0 || B <= 0 || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = C / H;
  cudaError_t err = cudaErrorInvalidValue;
  if (d > kMaxHeadDim)
    err = wg::at_stream_width(wg::stream_out(d), [&](auto w) {
      constexpr int OC = decltype(w)::value;
      if (!bf16)
        return launch_stream<float, OC, false>(q, k, v, o, o32, lse, B, Lq,
                                               Lk, C, H, d, prep, s);
      return wg::stream_resident(d, true)
                 ? launch_stream<__nv_bfloat16, OC, true>(
                       q, k, v, o, o32, lse, B, Lq, Lk, C, H, d, prep, s)
                 : launch_stream<__nv_bfloat16, OC, false>(
                       q, k, v, o, o32, lse, B, Lq, Lk, C, H, d, prep, s);
    });
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

// The stream design's sizes at head dim d (above 128), f32 (bf16 = 0) or
// bf16: out[4 i .. 4 i + 3] = consumer warpgroups, the other side's rows a
// tile, slots and shared-memory bytes of K2 (i = 0), the dq kernel (1) and
// the dk/dv kernel (2) (ops/attention.py: stream_tiles). Returns 0, or
// cudaErrorInvalidValue for a head dim of another design.
extern "C" int fused_mha_stream_tiles(int d, int bf16, int* out) {
  if (d <= kMaxHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(wg::at_stream_width(wg::stream_out(d), [&](auto w) {
    constexpr int W = decltype(w)::value;
    auto put = [&](auto cfg) {
      using G = decltype(cfg);
      const int v[12] = {G::kWG, G::kFwdKT, G::kFwdSlots,
                         static_cast<int>(G::fwd_smem()),
                         G::kWG, G::kDqKT, G::kDqSlots,
                         static_cast<int>(G::dq_smem()),
                         G::kWG, G::kKvKT, G::kKvSlots,
                         static_cast<int>(G::kv_smem())};
      for (int i = 0; i < 12; ++i) out[i] = v[i];
    };
    if (!bf16)
      put(wg::Stream<float, W>{});
    else if (wg::stream_resident(d, true))
      put(wg::Stream<__nv_bfloat16, W, true>{});
    else
      put(wg::Stream<__nv_bfloat16, W>{});
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
