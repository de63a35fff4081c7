// Non-causal multi-head attention backward for the D3PM denoiser (Hopper),
// for f32 and bf16 inputs.
//
// Replaces the TPU kernel gif_synthesis_with_discrete_diffusion_tpu/ops/
// attention.py: _bwd_kernel (via _fused_mha_bwd_impl, the backward of the
// custom VJP around fused_mha).
//
// q, dout, dq: (B, Lq, C); k, v, dk, dv: (B, Lk, C); all of one type (f32
// or bf16) and contiguous, C = H * D, any head dim (below, the design for
// D = 4 and 8; the wg design up to 128 at the end; above 128 the stream
// design, csrc/fused_mha_bwd_stream.cu). o:
// (B, Lq, C) f32, the forward's
// output; lse: (B, H, Lq) f32, its per-row log-sum-exp of the scores in
// base 2 (csrc/fused_mha_fwd.cu). With s = q k^T / sqrt(D) and P = softmax(s):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - Dr),  Dr = rowsum(dO * O),
//   dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D).
// Dr = rowsum(dO * O) equals the TPU kernel's rowsum(dP * P) in exact
// arithmetic (O = P V), and costs D multiplies per row instead of a pass
// over the keys; O is read in f32 whatever the input type (for bf16 inputs
// the forward's f32 copy: the rounded O would move Dr by more than a bf16
// step of dQ). Everything is f32 inside; the gradients are rounded to the
// input type once.
//
// What bounds it: per (query, key) pair five products of depth D (S, dP in
// both kernels below, and dV, dK, dQ) and one exponential in each kernel.
// P, dP, dS, written out, would be (B, H, Lq, Lk) f32 each (1 GiB per call
// at B = 16, L = 1024), so both kernels recompute P from q, k and the saved
// log-sum-exp in registers.
//
// Design: every product on the tensor cores (csrc/mha_tiles.cuh: f32 split
// into TF32 hi + lo, bf16 exact; P and dS fed back in the accumulator
// layout), no float atomics, so two launches give the same bits.
//  * dq kernel: a warp per 32 query rows (A fragments of q and dO); keys and
//    values staged 64 at a time; per 8 keys S = q K^T and dP = dO V^T
//    (two dot products), P, dS, then dQ += dS K (a pair product).
//  * dk/dv kernel: a warp per 32 key rows (A fragments of k and v), S^T =
//    K Q^T and dP^T = V dO^T computed directly with keys as rows, so that P^T
//    and dS^T come out as the A operand of dV += P^T dO and dK += dS^T Q.
//    The queries (q, dO, and per query its lse and Dr; past the chunk's end
//    lse = +inf, so P = 0) are staged 64 at a time. With few keys
//    (cross-attention over 1 or 77 condition tokens) there would be only
//    B * H * ceil(Lk / 128) blocks, each looping over every query: the query
//    range is then cut into `splits` chunks, each chunk writes its partial
//    sums (f32), and a third kernel adds the chunks in a fixed order.
//
// Head dims other than 4 and 8 up to 128 take the wg design
// (csrc/mha_wg.cuh) at the next of D = 16, 32, 64, 128: the same two
// kernels and the same split of the queries on wgmma, each with a producer
// warp that brings the block's own rows (q and dO, or k and v) once and the
// other side's tiles into a ring of two slots by TMA, and one or two
// consumer warpgroups of 64 own rows. Per tile the dq kernel computes S = q
// K^T and dP = dO V^T (both operands in shared memory), P and dS in
// registers, and dQ += dS K with dS fed back from the registers; the dk/dv
// kernel computes S^T = K q^T and dP^T = V dO^T with the keys as rows, so
// that P^T and dS^T come out as the A operand of dV += P^T dO and dK +=
// dS^T q. In f32 each tile is split into TF32 hi + lo after it lands, the
// operands contracted over their rows (k in dq; q and dO in dk/dv) also
// transposed. The dq kernel also writes Dr = rowsum(dO * O) of its rows to
// `dr` (B, H, Lq), which the dk/dv kernel reads beside lse: O is read once.
// Where every key fits in the dq kernel's one tile (at most 64 keys, 32 at
// D = 128 and at f32 D = 64), it takes the TPU kernel's own Dr = rowsum(dP
// * P) with P divided by its row sum from its registers instead: over one
// key (the label's cross-attention) P = 1 and dS = 0 exactly, as in the
// TPU kernel, where dO * O, summed in another order than dP, leaves dS a
// rounding noise that dK adds up over every query.
//
// Head dims above 128 take the stream design, csrc/fused_mha_bwd_stream.cu:
// a translation unit of its own, compiled in parallel with this one and
// linked into the same library (ops/cuda_build.py), which fused_mha_bwd
// below calls there.
#include "mha_tiles.cuh"
#include "mha_wg.cuh"

// csrc/fused_mha_bwd_stream.cu: fused_mha_bwd's arguments at a head dim
// above 128
int mha_bwd_stream(const void* q, const void* k, const void* v,
                   const float* o, const float* lse, const void* dout,
                   void* dq, void* dk, void* dv, float* scratch, float* dr,
                   int B, int Lq, int Lk, int C, int H, int splits, int bf16,
                   float* prep, cudaStream_t stream);

namespace {

using namespace mha;

// grid (ceil(Lq / kRowsBlock), H, B), kThreads threads
template <class Op, int D>
__global__ void __launch_bounds__(kThreads)
mha_bwd_dq_kernel(const typename Op::T* __restrict__ q,
                  const typename Op::T* __restrict__ k,
                  const typename Op::T* __restrict__ v,
                  const float* __restrict__ o,
                  const float* __restrict__ lse,
                  const typename Op::T* __restrict__ dout,
                  typename Op::T* __restrict__ dq, int Lq, int Lk, int C,
                  float c, float scale) {
  using T = typename Op::T;
  __shared__ typename Op::DotTile ks[2], vs[2];
  __shared__ typename Op::PairTile kn[2];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int h = blockIdx.y;
  const size_t b = blockIdx.z;
  const int row0 = blockIdx.x * kRowsBlock + warp * kRowsWarp;
  const bool busy = row0 < Lq;

  const size_t qoff = b * Lq * C + h * D;
  typename Op::RowsA qa, da;
  Op::load_a(qa, q + qoff, row0, Lq, C, g, tig);
  Op::load_a(da, dout + qoff, row0, Lq, C, g, tig);
  float l2[kMT][2], dr[kMT][2];
  Op::row_dot_part(dr, dout + qoff, o + qoff, row0, Lq, C, g, tig);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = row0 + 16 * mt + 8 * hf + g;
      dr[mt][hf] = quad_sum(dr[mt][hf]);
      l2[mt][hf] = row < Lq ? lse[(b * gridDim.y + h) * Lq + row] : 0.f;
    }
  typename Op::Acc acc;
  Op::zero(acc);

  // threads 0 .. kTile - 1 stage a key row each (both layouts), the
  // others a value row
  const int col = threadIdx.x % kTile;
  const bool stage_v = threadIdx.x >= kTile;
  const T* src = (stage_v ? v : k) + (b * Lk + col) * C + h * D;
  typename Op::Row r;
  Op::load_row(r, src, col < Lk);
  for (int t = 0;; ++t) {
    if (stage_v) {
      Op::put_dot(vs[t & 1], col, r);
    } else {
      Op::put_dot(ks[t & 1], col, r);
      Op::put_pair(kn[t & 1], col, r);
    }
    __syncthreads();
    const int k0 = t * kTile;
    const bool more = k0 + kTile < Lk;
    if (more)
      Op::load_row(r, src + static_cast<size_t>(k0 + kTile) * C,
                   k0 + kTile + col < Lk);
    if (busy) {
      const int n = min(kTile, Lk - k0);
      const int nbv = (n + 7) >> 3;
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        if (nb >= nbv) break;
        float s[kMT][4], dp[kMT][4];
        Op::mma_dot(s, qa, ks[t & 1], nb, g, tig);
        Op::mma_dot(dp, da, vs[t & 1], nb, g, tig);
        const int key = k0 + 8 * nb + 2 * tig;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float p = key + (j & 1) < Lk
                ? ex2(fmaf(s[mt][j], c, -l2[mt][j >> 1])) : 0.f;
            s[mt][j] = p * (dp[mt][j] - dr[mt][j >> 1]);   // dS
          }
        Op::mma_pair(acc, s, kn[t & 1], nb, g, tig);
      }
    }
    if (!more) break;
    // the buffer written next was last read two tiles ago: every warp has
    // passed the barrier above since
  }
  if (!busy) return;
  float f[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) f[mt][0] = f[mt][1] = scale;
  Op::store(dq + qoff, acc, f, row0, Lq, C, g, tig);
}

// grid (ceil(Lk / kRowsBlock), H, B * splits), kThreads threads; chunk s of
// the queries, [s * q_chunk, min(Lq, (s + 1) * q_chunk)), writes its partial
// sums dk_part / dv_part[s], each (B, Lk, C) of type OutT.
template <class Op, int D, typename OutT>
__global__ void __launch_bounds__(kThreads)
mha_bwd_dkdv_kernel(const typename Op::T* __restrict__ q,
                    const typename Op::T* __restrict__ k,
                    const typename Op::T* __restrict__ v,
                    const float* __restrict__ o,
                    const float* __restrict__ lse,
                    const typename Op::T* __restrict__ dout,
                    OutT* __restrict__ dk_part, OutT* __restrict__ dv_part,
                    int B, int Lq, int Lk, int C, int q_chunk, float c,
                    float scale) {
  using T = typename Op::T;
  __shared__ typename Op::DotTile qs[2], dos[2];
  __shared__ typename Op::PairTile qn[2], don[2];
  __shared__ __align__(16) float2 stat[2][kTile];   // (lse, Dr) per query

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int h = blockIdx.y;
  const int H = gridDim.y;
  const size_t b = blockIdx.z % B;
  const size_t split = blockIdx.z / B;
  const int row0 = blockIdx.x * kRowsBlock + warp * kRowsWarp;
  const bool busy = row0 < Lk;
  const int q_begin = split * q_chunk;
  const int q_end = min(Lq, q_begin + q_chunk);

  const size_t koff = b * Lk * C + h * D;
  typename Op::RowsA ka, va;
  Op::load_a(ka, k + koff, row0, Lk, C, g, tig);
  Op::load_a(va, v + koff, row0, Lk, C, g, tig);
  typename Op::Acc dk, dv;
  Op::zero(dk);
  Op::zero(dv);

  // threads 0 .. kTile - 1 stage a query's q row each, the others its dO
  // row, its O row (for Dr) and its lse
  const int col = threadIdx.x % kTile;
  const bool stage_do = threadIdx.x >= kTile;
  const size_t qoff = (b * Lq + q_begin + col) * C + h * D;
  const float* lsep = lse + (b * H + h) * Lq + q_begin + col;
  typename Op::Row r;
  float4 ro[D / 4];
  float lr = 0.f;
  auto fetch = [&](int i0) {   // query q_begin + i0 + col
    const bool valid = q_begin + i0 + col < q_end;
    const size_t off = qoff + static_cast<size_t>(i0) * C;
    Op::load_row(r, (stage_do ? dout : q) + off, valid);
    if (stage_do) {
#pragma unroll
      for (int j = 0; j < D / 4; ++j)
        ro[j] = valid ? load4(o + off + 4 * j)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      lr = valid ? lsep[i0] : INFINITY;
    }
  };
  fetch(0);
  for (int t = 0;; ++t) {
    const int buf = t & 1;
    if (stage_do) {
      Op::put_dot(dos[buf], col, r);
      Op::put_pair(don[buf], col, r);
      stat[buf][col] = make_float2(lr, Op::dot_row(r, ro));
    } else {
      Op::put_dot(qs[buf], col, r);
      Op::put_pair(qn[buf], col, r);
    }
    __syncthreads();
    const int i0 = t * kTile;
    const bool more = q_begin + i0 + kTile < q_end;
    if (more) fetch(i0 + kTile);
    if (busy) {
      const int nbv = (min(kTile, q_end - q_begin - i0) + 7) >> 3;
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        if (nb >= nbv) break;
        float p[kMT][4], ds[kMT][4];
        Op::mma_dot(p, ka, qs[buf], nb, g, tig);     // S^T
        Op::mma_dot(ds, va, dos[buf], nb, g, tig);   // dP^T
        // (lse, Dr) of the lane's queries 8 nb + 2 tig, 8 nb + 2 tig + 1
        const float4 st =
            *reinterpret_cast<const float4*>(&stat[buf][8 * nb + 2 * tig]);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float ls = (j & 1) ? st.z : st.x;
            const float d = (j & 1) ? st.w : st.y;
            p[mt][j] = ex2(fmaf(p[mt][j], c, -ls));
            ds[mt][j] = p[mt][j] * (ds[mt][j] - d);
          }
        Op::mma_pair(dv, p, don[buf], nb, g, tig);
        Op::mma_pair(dk, ds, qn[buf], nb, g, tig);
      }
    }
    if (!more) break;
  }
  if (!busy) return;
  const size_t off = split * B * Lk * C + koff;
  float fk[kMT][2], fv[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    fk[mt][0] = fk[mt][1] = scale;
    fv[mt][0] = fv[mt][1] = 1.f;
  }
  Op::store(dk_part + off, dk, fk, row0, Lk, C, g, tig);
  Op::store(dv_part + off, dv, fv, row0, Lk, C, g, tig);
}

// ---------------------------------------------------------------------------
// the wg design (csrc/mha_wg.cuh)
// ---------------------------------------------------------------------------
// dq: grid (ceil(Lq / own rows), H, B), a producer warp and one or two
// consumer warpgroups of 64 queries; maps (d, L, H, B) of q and dO (boxes of
// the own rows), k and v (boxes of a slot's keys), read when vec is 0
// (csrc/mha_wg.cuh: load_tile).
// Writes dQ and each row's Dr to `dr` (B, H, Lq).
template <typename T, int D>
__global__ void __launch_bounds__(32 * (4 * wg::Cfg<T, D>::kDqWG + 1), 1)
mha_bwd_dq_wg_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     const __grid_constant__ CUtensorMap mdo,
                     const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ o,
                     const float* __restrict__ lse,
                     const T* __restrict__ dout, T* __restrict__ dq,
                     float* __restrict__ dr, int Lq, int Lk, int C, int d,
                     int vec, float scale, float c) {
  using G = wg::Cfg<T, D>;
  constexpr bool F32 = G::kF32;
  constexpr int NW = G::kDqWG, KT = G::kDqKT, NS = G::kDqSlots;
  constexpr int R0 = 64 * NW, NC = 128 * NW;
  constexpr int KE = KT * D, QE = R0 * D;
  extern __shared__ __align__(1024) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + QE;
  T* qlo = dos + QE;                       // f32: q's and dO's lo
  T* dolo = qlo + QE;
  T* ring = qs + (F32 ? 4 : 2) * QE;       // slot i: k at 2 i, v at 2 i + 1
  float* work = reinterpret_cast<float*>(ring + NS * 2 * KE);
  constexpr int WE = G::work(KT);           // floats a work tile
  float* klo = work;                       // f32: k's lo, v's lo, k^T hi, lo
  float* vlo = work + WE;
  float* kth = work + 2 * WE;
  float* ktl = work + 3 * WE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(ring + NS * 2 * KE) +
      (F32 ? 4 * WE * sizeof(float) : 0));
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + NS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int blk0 = blockIdx.x * R0;
  const int ntiles = (Lk + KT - 1) / KT;
  const size_t qoff = static_cast<size_t>(b) * Lq * C + h * d;
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
    if (vec == 0 && lane == 0) wg::mbar_expect(qbar, 2 * QE * sizeof(T));
    wg::load_tile<T, D, R0>(qs, &mq, qbar, q + qoff, blk0, Lq, h, b, C, d,
                            vec, lane);
    wg::load_tile<T, D, R0>(dos, &mdo, qbar, dout + qoff, blk0, Lq, h, b, C,
                            d, vec, lane);
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

  const int tid = threadIdx.x, w = warp >> 2;
  const int g = lane >> 2, tig = lane & 3;
  const int row = blk0 + 64 * w + 16 * (warp & 3) + g;   // and row + 8
  // lse and Dr of the rows. With every key in one tile (one_group:
  // cross-attention over few keys), the TPU kernel's own formulas from the
  // registers below: P divided by its row sum, Dr = rowsum(dP * P), so that
  // over one key P = 1 and dS = 0 exactly. Else Dr = rowsum(dO * O) from
  // device memory (dO in the input type, O in f32), the lane's columns
  // tig, tig + 4, ...
  const bool one_group = Lk <= KT;
  float l2[2], drr[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row + 8 * hf;
    float x = 0.f;
    if (r < Lq && !one_group) {
      const size_t off = qoff + static_cast<size_t>(r) * C;
      for (int j = tig; j < d; j += 4) {
        float u;
        if constexpr (F32)
          u = dout[off + j];
        else
          u = __bfloat162float(dout[off + j]);
        x = fmaf(u, o[off + j], x);
      }
    }
    drr[hf] = quad_sum(x);
    l2[hf] = r < Lq ? lse[(static_cast<size_t>(b) * H + h) * Lq + r] : 0.f;
    if (r < Lq && tig == 0 && !one_group)
      dr[(static_cast<size_t>(b) * H + h) * Lq + r] = drr[hf];
  }
  wg::landed(qbar, 0, vec);
  if constexpr (F32) {
    wg::split_tile<R0, D, true, false>(reinterpret_cast<float*>(qs),
                                       reinterpret_cast<float*>(qlo), nullptr,
                                       nullptr, scale, tid, NC);
    wg::split_tile<R0, D, true, false>(reinterpret_cast<float*>(dos),
                                       reinterpret_cast<float*>(dolo),
                                       nullptr, nullptr, 1.f, tid, NC);
    wg::fence_async();
    wg::consumers_sync(NC);
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % NS;
    wg::landed(&full[s], (t / NS) & 1, vec);
    T* kt = ring + 2 * s * KE;
    T* vt = kt + KE;
    if constexpr (F32) {
      wg::split_tile<KT, D, true, true>(reinterpret_cast<float*>(kt), klo,
                                        kth, ktl, 1.f, tid, NC);
      wg::split_tile<KT, D, true, false>(reinterpret_cast<float*>(vt), vlo,
                                         nullptr, nullptr, 1.f, tid, NC);
      wg::fence_async();
      wg::consumers_sync(NC);
    }
    // S = q k^T and dP = dO v^T over the head dim
    float sc[KT / 2], dp[KT / 2];
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) sc[i] = dp[i] = 0.f;
    wg::hold(sc);
    wg::hold(dp);
    wg::wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / G::kK; ++ks) {
      const uint64_t aq = wg::desc_k<R0>(qs, ks, 64 * w);
      const uint64_t ad = wg::desc_k<R0>(dos, ks, 64 * w);
      const uint64_t bk = wg::desc_k<KT>(kt, ks);
      const uint64_t bv = wg::desc_k<KT>(vt, ks);
      if constexpr (F32) {
        wg::wg_ss_tf32<KT>(sc, aq, bk, 1);
        wg::wg_ss_tf32<KT>(sc, aq, wg::desc_k<KT>(klo, ks), 1);
        wg::wg_ss_tf32<KT>(sc, wg::desc_k<R0>(qlo, ks, 64 * w), bk, 1);
        wg::wg_ss_tf32<KT>(dp, ad, bv, 1);
        wg::wg_ss_tf32<KT>(dp, ad, wg::desc_k<KT>(vlo, ks), 1);
        wg::wg_ss_tf32<KT>(dp, wg::desc_k<R0>(dolo, ks, 64 * w), bv, 1);
      } else {
        wg::wg_ss_bf16<KT>(sc, aq, bk, 1);
        wg::wg_ss_bf16<KT>(dp, ad, bv, 1);
      }
    }
    wg::wg_commit();
    wg::wg_wait();
    wg::hold(sc);
    wg::hold(dp);

    // P in place of the scores (0 past the keys), then dS
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = t * KT + 8 * j + 2 * tig + (i & 1);
        sc[4 * j + i] =
            key < Lk ? ex2(fmaf(sc[4 * j + i], c, -l2[i >> 1])) : 0.f;
      }
    if (one_group) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
          sum += sc[4 * j + 2 * hf] + sc[4 * j + 2 * hf + 1];
        sum = quad_sum(sum);
        float x = 0.f;
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& p = sc[4 * j + 2 * hf + e];
            p = __fdiv_rn(p, sum);
            x = fmaf(p, dp[4 * j + 2 * hf + e], x);
          }
        drr[hf] = quad_sum(x);
        const int r = row + 8 * hf;
        if (r < Lq && tig == 0)
          dr[(static_cast<size_t>(b) * H + h) * Lq + r] = drr[hf];
      }
    }
#pragma unroll
    for (int i = 0; i < KT / 2; ++i)
      sc[i] = sc[i] * (dp[i] - drr[(i >> 1) & 1]);
    // acc += dS k, dS fed back from the registers
    if constexpr (F32) {
      unsigned fh[KT / 8][4], fl[KT / 8][4];
      wg::feed_tf32<KT>(fh, fl, sc);
      wg::hold(acc);
      wg::wg_fence();
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        wg::wg_rs_tf32<D>(acc, fh[j], wg::desc_t<D>(kth, j), 1);
        wg::wg_rs_tf32<D>(acc, fh[j], wg::desc_t<D>(ktl, j), 1);
        wg::wg_rs_tf32<D>(acc, fl[j], wg::desc_t<D>(kth, j), 1);
      }
      wg::wg_commit();
      wg::wg_wait();
      wg::hold(acc);
      wg::hold(fh);
      wg::hold(fl);
    } else {
      unsigned fh[KT / 16][4], fl[KT / 16][4];
      wg::feed_bf16<KT>(fh, fl, sc);
      wg::hold(acc);
      wg::wg_fence();
#pragma unroll
      for (int j = 0; j < KT / 16; ++j) {
        wg::wg_rs_bf16<D>(acc, fh[j], wg::desc_mn<KT>(kt, j), 1);
        wg::wg_rs_bf16<D>(acc, fl[j], wg::desc_mn<KT>(kt, j), 1);
      }
      wg::wg_commit();
      wg::wg_wait();
      wg::hold(acc);
      wg::hold(fh);
      wg::hold(fl);
    }
    wg::mbar_arrive(&empty[s]);
    if constexpr (F32) wg::consumers_sync(NC);   // the work tiles are free
  }
  const float f[2] = {scale, scale};
  wg::store_rows<D>(dq + qoff, acc, f, row, Lq, C, d, tig);
}

// dk/dv: grid (ceil(Lk / own rows), H, B * splits), a producer warp and one
// or two consumer warpgroups of 64 keys; maps of k and v (boxes of the own
// rows), q and dO (boxes of a slot's queries). Chunk s of the queries
// writes its partial sums dk_part / dv_part[s] (B, Lk, C) of type OutT, as
// mha_bwd_dkdv_kernel; lse and Dr of a slot's queries are read from device
// memory (past the chunk lse = +inf, so that P = 0).
template <typename T, int D, typename OutT>
__global__ void __launch_bounds__(32 * (4 * wg::Cfg<T, D>::kKvWG + 1), 1)
mha_bwd_dkdv_wg_kernel(const __grid_constant__ CUtensorMap mq,
                       const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv,
                       const __grid_constant__ CUtensorMap mdo,
                       const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const float* __restrict__ lse,
                       const float* __restrict__ dr,
                       const T* __restrict__ dout,
                       OutT* __restrict__ dk_part, OutT* __restrict__ dv_part,
                       int B, int Lq, int Lk, int C, int q_chunk, int d,
                       int vec, float scale, float c) {
  using G = wg::Cfg<T, D>;
  constexpr bool F32 = G::kF32;
  constexpr int NW = G::kKvWG, KT = G::kKvKT, NS = G::kKvSlots;
  constexpr int R0 = 64 * NW, NC = 128 * NW;
  constexpr int KE = KT * D, OE = R0 * D;
  extern __shared__ __align__(1024) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + OE;
  T* klo = vs + OE;                        // f32: k's and v's lo
  T* vlo = klo + OE;
  T* ring = ks + (F32 ? 4 : 2) * OE;       // slot i: q at 2 i, dO at 2 i + 1
  float* work = reinterpret_cast<float*>(ring + NS * 2 * KE);
  constexpr int WE = G::work(KT);           // floats a work tile
  float* qlo = work;                       // f32: lo of q, dO; q^T, dO^T
  float* dolo = work + WE;
  float* qth = work + 2 * WE;
  float* qtl = work + 3 * WE;
  float* doth = work + 4 * WE;
  float* dotl = work + 5 * WE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(ring + NS * 2 * KE) +
      (F32 ? 6 * WE * sizeof(float) : 0));
  uint64_t* kbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + NS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, H = gridDim.y;
  const int b = blockIdx.z % B, split = blockIdx.z / B;
  const int blk0 = blockIdx.x * R0;
  const int q_begin = split * q_chunk;
  const int q_end = min(Lq, q_begin + q_chunk);
  const int ntiles = (q_end - q_begin + KT - 1) / KT;
  const size_t koff = static_cast<size_t>(b) * Lk * C + h * d;
  if (threadIdx.x == 0) {
    wg::mbar_init(kbar, wg::arrivals(vec));
    for (int i = 0; i < NS; ++i) {
      wg::mbar_init(&full[i], wg::arrivals(vec));
      wg::mbar_init(&empty[i], NC);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * NW) {   // the producer
    const T* qh = q + static_cast<size_t>(b) * Lq * C + h * d;
    const T* dh = dout + static_cast<size_t>(b) * Lq * C + h * d;
    if (vec == 0 && lane == 0) wg::mbar_expect(kbar, 2 * OE * sizeof(T));
    wg::load_tile<T, D, R0>(ks, &mk, kbar, k + koff, blk0, Lk, h, b, C, d,
                            vec, lane);
    wg::load_tile<T, D, R0>(vs, &mv, kbar, v + koff, blk0, Lk, h, b, C, d,
                            vec, lane);
    wg::loaded(kbar, vec);
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % NS;
      if (t >= NS) wg::mbar_wait(&empty[s], (t / NS - 1) & 1);
      T* qt = ring + 2 * s * KE;
      const int r0 = q_begin + t * KT;
      if (vec == 0 && lane == 0) wg::mbar_expect(&full[s], 2 * KE * sizeof(T));
      wg::load_tile<T, D, KT>(qt, &mq, &full[s], qh, r0, q_end, h, b, C, d,
                              vec, lane);
      wg::load_tile<T, D, KT>(qt + KE, &mdo, &full[s], dh, r0, q_end, h, b, C,
                              d, vec, lane);
      wg::loaded(&full[s], vec);
    }
    return;
  }

  const int tid = threadIdx.x, w = warp >> 2;
  const int g = lane >> 2, tig = lane & 3;
  const int row = blk0 + 64 * w + 16 * (warp & 3) + g;   // keys row, row + 8
  const float* lseh = lse + (static_cast<size_t>(b) * H + h) * Lq;
  const float* drh = dr + (static_cast<size_t>(b) * H + h) * Lq;
  wg::landed(kbar, 0, vec);
  if constexpr (F32) {
    wg::split_tile<R0, D, true, false>(reinterpret_cast<float*>(ks),
                                       reinterpret_cast<float*>(klo), nullptr,
                                       nullptr, 1.f, tid, NC);
    wg::split_tile<R0, D, true, false>(reinterpret_cast<float*>(vs),
                                       reinterpret_cast<float*>(vlo), nullptr,
                                       nullptr, 1.f, tid, NC);
    wg::fence_async();
    wg::consumers_sync(NC);
  }
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % NS;
    wg::landed(&full[s], (t / NS) & 1, vec);
    T* qt = ring + 2 * s * KE;
    T* dt = qt + KE;
    if constexpr (F32) {
      wg::split_tile<KT, D, true, true>(reinterpret_cast<float*>(qt), qlo, qth,
                                        qtl, scale, tid, NC);
      wg::split_tile<KT, D, true, true>(reinterpret_cast<float*>(dt), dolo,
                                        doth, dotl, 1.f, tid, NC);
      wg::fence_async();
      wg::consumers_sync(NC);
    }
    // S^T = k q^T and dP^T = v dO^T over the head dim, keys as rows
    float st[KT / 2], dpt[KT / 2];
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) st[i] = dpt[i] = 0.f;
    wg::hold(st);
    wg::hold(dpt);
    wg::wg_fence();
#pragma unroll
    for (int kc = 0; kc < D / G::kK; ++kc) {
      const uint64_t ak = wg::desc_k<R0>(ks, kc, 64 * w);
      const uint64_t av = wg::desc_k<R0>(vs, kc, 64 * w);
      const uint64_t bq = wg::desc_k<KT>(qt, kc);
      const uint64_t bd = wg::desc_k<KT>(dt, kc);
      if constexpr (F32) {
        wg::wg_ss_tf32<KT>(st, ak, bq, 1);
        wg::wg_ss_tf32<KT>(st, ak, wg::desc_k<KT>(qlo, kc), 1);
        wg::wg_ss_tf32<KT>(st, wg::desc_k<R0>(klo, kc, 64 * w), bq, 1);
        wg::wg_ss_tf32<KT>(dpt, av, bd, 1);
        wg::wg_ss_tf32<KT>(dpt, av, wg::desc_k<KT>(dolo, kc), 1);
        wg::wg_ss_tf32<KT>(dpt, wg::desc_k<R0>(vlo, kc, 64 * w), bd, 1);
      } else {
        wg::wg_ss_bf16<KT>(st, ak, bq, 1);
        wg::wg_ss_bf16<KT>(dpt, av, bd, 1);
      }
    }
    wg::wg_commit();
    wg::wg_wait();
    wg::hold(st);
    wg::hold(dpt);

    // P^T and dS^T in place, from each query's lse and Dr (past the chunk
    // lse = +inf, so that P = 0)
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = q_begin + t * KT + 8 * j + 2 * tig + e;
        const bool valid = qi < q_end;
        const float ls = valid ? lseh[qi] : INFINITY;
        const float dd = valid ? drh[qi] : 0.f;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = 4 * j + 2 * hf + e;
          st[i] = ex2(fmaf(st[i], c, -ls));
          dpt[i] = st[i] * (dpt[i] - dd);
        }
      }
    // dv += P^T dO, dk += dS^T q, fed back from the registers (every step:
    // skipping the steps past the chunk's queries measured slower)
    if constexpr (F32) {
      unsigned ph[KT / 8][4], pl[KT / 8][4], sh[KT / 8][4], sl[KT / 8][4];
      wg::feed_tf32<KT>(ph, pl, st);
      wg::feed_tf32<KT>(sh, sl, dpt);
      wg::hold(dk);
      wg::hold(dv);
      wg::wg_fence();
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        wg::wg_rs_tf32<D>(dv, ph[j], wg::desc_t<D>(doth, j), 1);
        wg::wg_rs_tf32<D>(dv, ph[j], wg::desc_t<D>(dotl, j), 1);
        wg::wg_rs_tf32<D>(dv, pl[j], wg::desc_t<D>(doth, j), 1);
        wg::wg_rs_tf32<D>(dk, sh[j], wg::desc_t<D>(qth, j), 1);
        wg::wg_rs_tf32<D>(dk, sh[j], wg::desc_t<D>(qtl, j), 1);
        wg::wg_rs_tf32<D>(dk, sl[j], wg::desc_t<D>(qth, j), 1);
      }
      wg::wg_commit();
      wg::wg_wait();
      wg::hold(dk);
      wg::hold(dv);
      wg::hold(ph);
      wg::hold(pl);
      wg::hold(sh);
      wg::hold(sl);
    } else {
      unsigned ph[KT / 16][4], pl[KT / 16][4], sh[KT / 16][4], sl[KT / 16][4];
      wg::feed_bf16<KT>(ph, pl, st);
      wg::feed_bf16<KT>(sh, sl, dpt);
      wg::hold(dk);
      wg::hold(dv);
      wg::wg_fence();
#pragma unroll
      for (int j = 0; j < KT / 16; ++j) {
        wg::wg_rs_bf16<D>(dv, ph[j], wg::desc_mn<KT>(dt, j), 1);
        wg::wg_rs_bf16<D>(dv, pl[j], wg::desc_mn<KT>(dt, j), 1);
        wg::wg_rs_bf16<D>(dk, sh[j], wg::desc_mn<KT>(qt, j), 1);
        wg::wg_rs_bf16<D>(dk, sl[j], wg::desc_mn<KT>(qt, j), 1);
      }
      wg::wg_commit();
      wg::wg_wait();
      wg::hold(dk);
      wg::hold(dv);
      wg::hold(ph);
      wg::hold(pl);
      wg::hold(sh);
      wg::hold(sl);
    }
    wg::mbar_arrive(&empty[s]);
    if constexpr (F32) wg::consumers_sync(NC);   // the work tiles are free
  }
  const size_t off = static_cast<size_t>(split) * B * Lk * C + koff;
  const float fk = F32 ? 1.f : scale;
  const float f_k[2] = {fk, fk}, f_v[2] = {1.f, 1.f};
  wg::store_rows<D>(dk_part + off, dk, f_k, row, Lk, C, d, tig);
  wg::store_rows<D>(dv_part + off, dv, f_v, row, Lk, C, d, tig);
}

template <typename T, int D>
cudaError_t launch_wg(const void* q_, const void* k_, const void* v_,
                      const float* o, const float* lse, const void* dout_,
                      void* dq_, void* dk_, void* dv_, float* scratch,
                      float* dr, int B, int Lq, int Lk, int C, int H,
                      int splits, int d, cudaStream_t stream) {
  using G = wg::Cfg<T, D>;
  constexpr bool bf16 = !G::kF32;
  constexpr int NQ = G::kDqWG, NK = G::kKvWG, RQ = 64 * NQ, RK = 64 * NK;
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  const T* dout = static_cast<const T*>(dout_);
  T* dk = static_cast<T*>(dk_);
  T* dv = static_cast<T*>(dv_);
  int vec = wg::copy_mode(d, static_cast<int>(sizeof(T)));
  // the dq kernel's maps (own q and dO, slots of k and v), then the dk/dv
  // kernel's (own k and v, slots of q and dO)
  CUtensorMap mq{}, mk{}, mv{}, mdo{}, nq{}, nk{}, nv{}, ndo{};
  if (!(wg::make_map(&mq, q, bf16, B, Lq, H, d, RQ, vec) &&
        wg::make_map(&mdo, dout, bf16, B, Lq, H, d, RQ, vec) &&
        wg::make_map(&mk, k, bf16, B, Lk, H, d, G::kDqKT, vec) &&
        wg::make_map(&mv, v, bf16, B, Lk, H, d, G::kDqKT, vec) &&
        wg::make_map(&nk, k, bf16, B, Lk, H, d, RK, vec) &&
        wg::make_map(&nv, v, bf16, B, Lk, H, d, RK, vec) &&
        wg::make_map(&nq, q, bf16, B, Lq, H, d, G::kKvKT, vec) &&
        wg::make_map(&ndo, dout, bf16, B, Lq, H, d, G::kKvKT, vec))) {
    ++wg::tma_refused();   // the map was refused: copy by cp.async
    vec = copy_bytes(d * static_cast<int>(sizeof(T)));
  }
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  const float c = bf16 ? kLog2e * scale : kLog2e;
  constexpr size_t smem_dq = G::dq_smem(), smem_kv = G::kv_smem();
  cudaError_t err = cudaFuncSetAttribute(
      mha_bwd_dq_wg_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_dq));
  if (err != cudaSuccess) return err;
  mha_bwd_dq_wg_kernel<T, D>
      <<<dim3((Lq + RQ - 1) / RQ, H, B), 32 * (4 * NQ + 1), smem_dq,
         stream>>>(mq, mk, mv, mdo, q, k, v, o, lse, dout,
                   static_cast<T*>(dq_), dr, Lq, Lk, C, d, vec, scale, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int q_chunk = (Lq + splits - 1) / splits;
  const size_t n = static_cast<size_t>(B) * Lk * C;
  float* dk_part = scratch;
  float* dv_part = scratch + splits * n;
  const dim3 grid((Lk + RK - 1) / RK, H, B * splits);
  const int threads = 32 * (4 * NK + 1);
  if (splits == 1) {
    err = cudaFuncSetAttribute(mha_bwd_dkdv_wg_kernel<T, D, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_kv));
    if (err != cudaSuccess) return err;
    mha_bwd_dkdv_wg_kernel<T, D, T><<<grid, threads, smem_kv, stream>>>(
        nq, nk, nv, ndo, q, k, v, lse, dr, dout, dk, dv, B, Lq, Lk, C,
        q_chunk, d, vec, scale, c);
  } else {
    err = cudaFuncSetAttribute(mha_bwd_dkdv_wg_kernel<T, D, float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_kv));
    if (err != cudaSuccess) return err;
    mha_bwd_dkdv_wg_kernel<T, D, float>
        <<<grid, threads, smem_kv, stream>>>(
            nq, nk, nv, ndo, q, k, v, lse, dr, dout, dk_part, dv_part, B, Lq,
            Lk, C, q_chunk, d, vec, scale, c);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t want = (n + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  sum_splits_kernel<T><<<blocks, 256, 0, stream>>>(dk_part, dv_part, dk, dv,
                                                   n, splits);
  return cudaGetLastError();
}

template <class Op, int D>
cudaError_t launch(const void* q_, const void* k_, const void* v_,
                   const float* o, const float* lse, const void* dout_,
                   void* dq_, void* dk_, void* dv_, float* scratch, int B,
                   int Lq, int Lk, int C, int H, int splits,
                   cudaStream_t stream) {
  using T = typename Op::T;
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  const T* dout = static_cast<const T*>(dout_);
  T* dq = static_cast<T*>(dq_);
  T* dk = static_cast<T*>(dk_);
  T* dv = static_cast<T*>(dv_);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const float c = kLog2e * scale;
  mha_bwd_dq_kernel<Op, D>
      <<<dim3((Lq + kRowsBlock - 1) / kRowsBlock, H, B), kThreads, 0,
         stream>>>(q, k, v, o, lse, dout, dq, Lq, Lk, C, c, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int q_chunk = (Lq + splits - 1) / splits;
  const size_t n = static_cast<size_t>(B) * Lk * C;
  float* dk_part = scratch;
  float* dv_part = scratch + splits * n;
  const dim3 grid((Lk + kRowsBlock - 1) / kRowsBlock, H, B * splits);
  if (splits == 1)
    mha_bwd_dkdv_kernel<Op, D, T><<<grid, kThreads, 0, stream>>>(
        q, k, v, o, lse, dout, dk, dv, B, Lq, Lk, C, q_chunk, c, scale);
  else
    mha_bwd_dkdv_kernel<Op, D, float><<<grid, kThreads, 0, stream>>>(
        q, k, v, o, lse, dout, dk_part, dv_part, B, Lq, Lk, C, q_chunk, c,
        scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t want = (n + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  sum_splits_kernel<T><<<blocks, 256, 0, stream>>>(dk_part, dv_part, dk, dv,
                                                   n, splits);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for a bad shape, else the
// first failed launch's status. bf16 selects the
// input type (0: f32, 1: bf16); o is the forward's output in f32. With
// splits > 1, scratch holds 2 * splits * B * Lk * C floats; with splits ==
// 1 it may be null. dr: (B, H, Lq) f32 scratch for head dims other than 4
// and 8 (else it may be null). prep: above head dim 128 in f32, the stream
// design's prepared operands (ops/attention.py: stream_prep_floats floats;
// else it may be null); with a tensor map refused there, f32 returns
// cudaErrorNotSupported (its prepared operands have no cp.async path).
extern "C" int fused_mha_bwd(const void* q, const void* k, const void* v,
                             const float* o, const float* lse,
                             const void* dout, void* dq, void* dk, void* dv,
                             float* scratch, float* dr, int B, int Lq, int Lk,
                             int C, int H, int splits, int bf16, float* prep,
                             void* stream) {
  if (H <= 0 || C % H != 0 || Lq <= 0 || Lk <= 0 || B <= 0 || H > 65535 ||
      splits <= 0 || splits > Lq || static_cast<long long>(B) * splits > 65535
      || (splits > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = C / H;
  if (d > kMaxHeadDim)   // the stream design
    return mha_bwd_stream(q, k, v, o, lse, dout, dq, dk, dv, scratch, dr, B,
                          Lq, Lk, C, H, splits, bf16, prep, s);
  if (d != 4 && d != 8) {
    if (dr == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(wg::at_width(d, [&](auto w) {
      constexpr int D = decltype(w)::value;
      return bf16 ? launch_wg<__nv_bfloat16, D>(q, k, v, o, lse, dout, dq, dk,
                                                dv, scratch, dr, B, Lq, Lk, C,
                                                H, splits, d, s)
                  : launch_wg<float, D>(q, k, v, o, lse, dout, dq, dk, dv,
                                        scratch, dr, B, Lq, Lk, C, H, splits,
                                        d, s);
    }));
  }
  cudaError_t err = cudaErrorInvalidValue;
  if (d == 4 && !bf16)
    err = launch<Tf32<4>, 4>(q, k, v, o, lse, dout, dq, dk, dv, scratch, B,
                             Lq, Lk, C, H, splits, s);
  else if (d == 8 && !bf16)
    err = launch<Tf32<8>, 8>(q, k, v, o, lse, dout, dq, dk, dv, scratch, B,
                             Lq, Lk, C, H, splits, s);
  else if (d == 4)
    err = launch<Bf16<4>, 4>(q, k, v, o, lse, dout, dq, dk, dv, scratch, B,
                             Lq, Lk, C, H, splits, s);
  else if (d == 8)
    err = launch<Bf16<8>, 8>(q, k, v, o, lse, dout, dq, dk, dv, scratch, B,
                             Lq, Lk, C, H, splits, s);
  return static_cast<int>(err);
}

// Launches of this library that took cp.async because a tensor map was
// refused, and the last refusal's CUresult (-1: no entry point), for the
// wrapper's reports.
extern "C" int fused_mha_bwd_tma_refused(int* error) {
  *error = mha::wg::tma_error();
  return mha::wg::tma_refused();
}
