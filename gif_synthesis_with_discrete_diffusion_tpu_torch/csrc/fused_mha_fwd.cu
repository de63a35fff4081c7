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
// Head dims other than 4 and 8 (VQ-Diffusion-B's 64, 12, 16, 32, 128) take
// the wide design (csrc/mha_tiles.cuh: WTf32, WBf16) at the next of D = 16,
// 32, 64, 128, with the same online softmax over tiles of 64 keys, for any
// number of keys: at d = 64 a query-key pair costs 128 multiply-adds
// against its one exponential, so the products bound it (f32: 3 TF32
// products each; bf16: one, and P V's hi + lo pair). One block of 4 warps
// per (64 queries, head, batch row): the block's q rows and the keys and
// values, 64 at a time (double-buffered, the next tile's cp.async in
// flight while the warps work on this one), stay in shared memory as they
// are in device memory; a warp takes 16 queries. Its registers hold o's
// accumulator (D / 2 a thread) and a tile's scores; the fragments of q are
// loaded once a tile and head-dim chunk. A few keys (cross-attention over 1
// or 77 tokens) take the same kernel, the tile's missing keys masked.
//
// Head dims above 128 take the split design (csrc/mha_tiles.cuh: kSplitOut,
// kSplitChunk): a block of 4 warps per (64 queries, 128 output columns,
// head, batch row); per tile of 64 keys the ring brings the queries' and
// keys' dims 64 at a time (the scores summed over the whole head dim in the
// warp's registers), then the values' 128 columns of the block, and the
// online softmax and P V run as in the wide design. Every column chunk
// recomputes the same scores (the same products in the same order, so the
// same values): at d = 256 a third of the products the kernel runs are that
// recompute, which the function's bound does not count. The chunk of
// columns 0 .. 127 writes lse.
#include "mha_tiles.cuh"

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

// The wide design: grid (ceil(Lq / kWRowsBlock), H, B), kThreads threads,
// dynamic shared memory of 5 tiles (q, then keys and values twice). d: the
// head dim (<= D), vec: the bytes of a copy into shared memory; scale = 1 /
// sqrt(d); c: the base-2 factor of the scores (log2(e), times scale where q
// is not scaled).
template <class Op>
__global__ void __launch_bounds__(kThreads)
fused_mha_fwd_wide_kernel(const typename Op::T* __restrict__ q,
                          const typename Op::T* __restrict__ k,
                          const typename Op::T* __restrict__ v,
                          typename Op::T* __restrict__ o,
                          float* __restrict__ o32, float* __restrict__ lse,
                          int Lq, int Lk, int C, int d, int vec, float scale,
                          float c) {
  using T = typename Op::T;
  constexpr int D = Op::D_, S = Op::S, kTileElems = kWTile * S;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* kv = qs + kTileElems;   // buffer i: keys at 2 i, values at 2 i + 1

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int h = blockIdx.y;
  const size_t b = blockIdx.z;
  const int blk0 = blockIdx.x * kWRowsBlock;
  const int r0 = warp * kWRows;               // the warp's rows in qs
  const bool busy = blk0 + r0 < Lq;           // warp-uniform
  const T* qh = q + b * Lq * C + h * d;
  const T* kh = k + b * Lk * C + h * d;
  const T* vh = v + b * Lk * C + h * d;

  stage<T, D, S>(qs, qh, blk0, Lq, C, d, vec);
  stage<T, D, S>(kv, kh, 0, Lk, C, d, vec);
  stage<T, D, S>(kv + kTileElems, vh, 0, Lk, C, d, vec);
  cp_async_commit();

  const float fq = Op::kScaledQ ? scale : 1.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int dc = 0; dc < D / 8; ++dc)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[dc][j] = 0.f;

  const int ntiles = (Lk + kWTile - 1) / kWTile;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kWTile;
    if (t + 1 < ntiles) {
      T* nxt = kv + ((t + 1) & 1) * 2 * kTileElems;
      stage<T, D, S>(nxt, kh, k0 + kWTile, Lk, C, d, vec);
      stage<T, D, S>(nxt + kTileElems, vh, k0 + kWTile, Lk, C, d, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (busy) {
      const T* ks = kv + (t & 1) * 2 * kTileElems;
      const T* vs = ks + kTileElems;
      const int n = min(kWTile, Lk - k0);
      const int nbv = (n + 7) >> 3;
      float s[kWNB][4];
#pragma unroll
      for (int nb = 0; nb < kWNB; ++nb)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[nb][j] = 0.f;
#pragma unroll 1
      for (int kc = 0; kc < D / Op::kK; ++kc) {
        typename Op::Frag a;
        Op::load_a(a, qs, r0, kc, fq, g, tig);
#pragma unroll
        for (int nb = 0; nb < kWNB; ++nb)
          if (nb < nbv) Op::dot(s[nb], a, ks, nb, kc, 1.f, g, tig);
      }
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
        // the tile holds a key, so the new maximum is finite
        const float mn = fmaxf(m[hf], quad_max(x));
        const float corr = ex2((m[hf] - mn) * c);   // 0 on the first tile
        m[hf] = mn;
        mc[hf] = mn * c;
        l[hf] *= corr;
#pragma unroll
        for (int dc = 0; dc < D / 8; ++dc) {
          acc[dc][2 * hf] *= corr;
          acc[dc][2 * hf + 1] *= corr;
        }
      }
#pragma unroll
      for (int nb = 0; nb < kWNB; ++nb) {
        if (nb >= nbv) continue;
        float p[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          p[j] = ex2(fmaf(s[nb][j], c, -mc[j >> 1]));
        typename Op::Frag pa;
        Op::make_p(pa, p);
        Op::pair(acc, pa, vs, nb, 1.f, g, tig);
        l[0] += p[0] + p[1];
        l[1] += p[2] + p[3];
      }
    }
    // the buffer staged next was read in this tile
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
  const size_t qoff = b * Lq * C + h * d;
  store_wide<D>(o + qoff, acc, inv, row0, Lq, C, d, g, tig);
  if (o32 != nullptr)
    store_wide<D>(o32 + qoff, acc, inv, row0, Lq, C, d, g, tig);
  if (lse != nullptr && tig == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = row0 + g + 8 * hf;
      if (row < Lq) lse[(b * gridDim.y + h) * Lq + row] =
          m[hf] * c + log2f(l[hf]);
    }
  }
}

// The split design (head dims above 128): grid (ceil(Lq / kWRowsBlock),
// H * n_oc, B), n_oc = ceil(d / kSplitOut) column chunks (blockIdx.y = h
// n_oc + chunk), kThreads threads, dynamic shared memory of two ring slots
// (the larger of a contraction stage, q and k at kSplitChunk dims, and a
// value stage, kSplitOut columns). Arguments as the wide kernel's.
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

template <class Op>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o,
                        float* o32, float* lse, int B, int Lq, int Lk, int C,
                        int H, int d, cudaStream_t stream) {
  using T = typename Op::T;
  const size_t smem = 5 * static_cast<size_t>(kWTile) * Op::S * sizeof(T);
  const cudaError_t attr = cudaFuncSetAttribute(
      fused_mha_fwd_wide_kernel<Op>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  const float c = Op::kScaledQ ? kLog2e : kLog2e * scale;
  fused_mha_fwd_wide_kernel<Op>
      <<<dim3((Lq + kWRowsBlock - 1) / kWRowsBlock, H, B), kThreads, smem,
         stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                   static_cast<const T*>(v), static_cast<T*>(o), o32, lse, Lq,
                   Lk, C, d, copy_bytes(d * static_cast<int>(sizeof(T))),
                   scale, c);
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
// launch's status. Any head dim: 4 and 8, the wide design up to 128, the
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
    err = wide<WTf32>(d, [&](auto op) {
      return launch_wide<decltype(op)>(q, k, v, o, o32, lse, B, Lq, Lk, C, H,
                                       d, s);
    });
  else
    err = wide<WBf16>(d, [&](auto op) {
      return launch_wide<decltype(op)>(q, k, v, o, o32, lse, B, Lq, Lk, C, H,
                                       d, s);
    });
  return static_cast<int>(err);
}
