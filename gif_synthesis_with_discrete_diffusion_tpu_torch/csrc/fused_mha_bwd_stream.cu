// Non-causal multi-head attention backward for the D3PM denoiser (Hopper)
// at head dims above 128, for f32 and bf16 inputs: the stream design of
// csrc/fused_mha_bwd.cu's K5, a translation unit of its own so that it
// compiles in parallel with that one, linked into the same library
// (ops/cuda_build.py: load's units); fused_mha_bwd calls mha_bwd_stream,
// at the end.
//
// Replaces the TPU kernel gif_synthesis_with_discrete_diffusion_tpu/ops/
// attention.py: _bwd_kernel (via _fused_mha_bwd_impl, the backward of the
// custom VJP around fused_mha) at those head dims. The function, the
// arguments and the two kernels (a dq kernel, a dk/dv kernel, no float
// atomics) are csrc/fused_mha_bwd.cu's; what bounds it there is K2's
// (csrc/fused_mha_fwd.cu): the bytes each product reads into shared
// memory.
//
// Head dims above 128 take the stream design (csrc/mha_wg.cuh: Stream):
// the same two kernels on wgmma and TMA, two consumer warpgroups and a
// producer warpgroup a block (setmaxnreg moves the registers), every score
// computed once. The dq kernel's warpgroups take 64 queries each, compute
// S and dP once a tile of keys over the whole head dim, in increasing order
// of the dims, then dQ over the block's OC output columns (192 up to d =
// 192, 256 up to 256) from the same dS. The dk/dv kernel's block owns 64
// keys: warpgroup 0 computes S^T and P^T and sums dV, warpgroup 1 computes
// dP^T and, with P^T passed through shared memory, dS^T, and sums dK. bf16
// heads up to 256 keep the block's own rows resident (q and dO, 128 KB; k
// and v, 64 KB) and take one stage a tile: the other side's whole tile,
// which the fed-back products read again. f32 heads stream, as K2's do
// (csrc/fused_mha_fwd.cu): q (times 1 / sqrt(d)), dO, k and v split once
// into TF32 hi and lo in device memory, k, q and dO also transposed for the
// products contracted over their rows. Wider heads run in column chunks of
// 192 or 256 (a grid axis), each chunk computing S and dP again. Dr =
// rowsum(dO * O) spans the head: the dq blocks of chunk 0 write it; over at
// most one tile of keys (32, 64 in f32) the TPU kernel's rowsum(dP * P), as
// the wg design takes it.
#include "mha_tiles.cuh"
#include "mha_wg.cuh"

namespace {

using namespace mha;

// ---------------------------------------------------------------------------
// the stream design (head dims above 128, csrc/mha_wg.cuh: Stream)
// ---------------------------------------------------------------------------
// dq: grid (ceil(Lq / 128), H * n_oc, B), blockIdx.y = h n_oc + oc; two
// consumer warpgroups of 64 queries and a producer warpgroup. RES: q and
// dO resident, a stage the tile's k and v, whose k dQ's products read
// again. Else a score stage holds some dims of q and dO (the block's rows)
// and of k and v (a tile of keys), a value stage the tile's k at VC of the
// block's columns. Maps (csrc/mha_wg.cuh: StreamMaps), operands q, dO, k,
// v, then k for the value stages: bf16 the inputs', f32 the prepared parts
// (q times scale; k transposed for the value stages). Writes dQ at the
// block's columns and, in the blocks of chunk 0, each row's Dr to `dr` (B,
// H, Lq), as mha_bwd_dq_wg_kernel.
template <typename T, int OC, bool RES>
__global__ void __launch_bounds__(128 * 3, 1)
mha_bwd_dq_stream_kernel(const __grid_constant__ wg::StreamMaps maps,
                         const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ o,
                         const float* __restrict__ lse,
                         const T* __restrict__ dout, T* __restrict__ dq,
                         float* __restrict__ dr, int Lq, int Lk, int C, int d,
                         int vec, float scale, float c) {
  using G = wg::Stream<T, OC, RES>;
  constexpr bool F32 = G::kF32;
  constexpr int NP = G::kNP, R0 = G::kDqRows, KT = G::kDqKT;
  constexpr int SC = G::kSCW, VC = G::kDqVC, NV = OC / VC;
  constexpr int NS = G::kDqSlots, NC = 128 * G::kWG, SE = G::dq_slot();
  // elements of a score stage's own rows (q, dO), before its tiles of k, v
  constexpr int OWN = RES ? 0 : 2 * NP * R0 * SC;
  extern __shared__ __align__(1024) unsigned char smem[];
  // RES: q, dO resident
  T* own = reinterpret_cast<T*>(wg::stream_base<T>(smem));
  T* ring = own + G::dq_own();
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + NS * SE);
  uint64_t* empty = full + NS;
  uint64_t* obar = empty + NS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_oc = (d + OC - 1) / OC;
  const int h = blockIdx.y / n_oc, oc = blockIdx.y % n_oc;
  const int H = gridDim.y / n_oc, b = blockIdx.z;
  const int blk0 = blockIdx.x * R0, col0 = oc * OC;
  // RES: one stage a tile (k and v whole; dQ's products read its k again)
  const int n_sc = RES ? 1 : (d + SC - 1) / SC;
  const int per = n_sc + (RES ? 0 : NV);
  const int ntiles = (Lk + KT - 1) / KT;
  const size_t qoff = static_cast<size_t>(b) * Lq * C + h * d;
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
    const T* kh = k + static_cast<size_t>(b) * Lk * C + h * d;
    const T* vh = v + static_cast<size_t>(b) * Lk * C + h * d;
    // a score stage: q, dO (R0 rows each), k, v (KT rows), each in NP parts
    const T* src[4] = {q + qoff, dout + qoff, kh, vh};
    if constexpr (RES) {
      if (vec == 0 && lane == 0)
        wg::mbar_expect(obar, 2 * R0 * OC * sizeof(T));
#pragma unroll
      for (int x = 0; x < 2; ++x)
        wg::stream_tile<T, OC, R0>(own + x * R0 * OC, &maps.m[x], obar,
                                   src[x], blk0, Lq, h, b, C, d, vec, lane,
                                   0);
      wg::loaded(obar, vec);
    }
    for (int u = 0; u < ntiles * per; ++u) {
      const int s = u % NS, t = u / per, j = u % per;
      if (u >= NS) wg::mbar_wait(&empty[s], (u / NS - 1) & 1);
      T* slot = ring + s * SE;
      if (j < n_sc) {
        if (vec == 0 && lane == 0)
          wg::mbar_expect(&full[s],
                          (OWN + 2 * NP * KT * SC) * sizeof(T));
#pragma unroll
        for (int p = 0; p < NP; ++p) {
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            if constexpr (!RES)
              wg::stream_tile<T, SC, R0>(slot + (x * NP + p) * R0 * SC,
                                         &maps.m[x * NP + p], &full[s],
                                         src[x], blk0, Lq, h, b, C, d, vec,
                                         lane, j * SC);
            wg::stream_tile<T, SC, KT>(
                slot + OWN + (x * NP + p) * KT * SC,
                &maps.m[(2 + x) * NP + p], &full[s], src[2 + x], t * KT, Lk,
                h, b, C, d, vec, lane, j * SC);
          }
        }
      } else {
        const int c0 = col0 + (j - n_sc) * VC;
        if (vec == 0 && lane == 0)
          wg::mbar_expect(&full[s], NP * KT * VC * sizeof(T));
        if constexpr (F32) {
          wg::stream_tile_t<VC>(slot, &maps.m[8], &full[s], t * KT, c0, h,
                                b, lane);
          wg::stream_tile_t<VC>(slot + KT * VC, &maps.m[9], &full[s], t * KT,
                                c0, h, b, lane);
        } else {
          wg::stream_tile<T, VC, KT>(slot, &maps.m[4], &full[s], kh, t * KT,
                                     Lk, h, b, C, d, vec, lane, c0);
        }
      }
      wg::loaded(&full[s], vec);
    }
    return;
  }

  wg::consumer_regs();
  const int w = warp >> 2, g = lane >> 2, tig = lane & 3;
  const int row = blk0 + 64 * w + 16 * (warp & 3) + g;   // and row + 8
  // lse and Dr of the rows, as mha_bwd_dq_wg_kernel takes them (every key
  // in one tile: the TPU kernel's rowsum(dP * P) below)
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
    if (r < Lq && tig == 0 && !one_group && oc == 0)
      dr[(static_cast<size_t>(b) * H + h) * Lq + r] = drr[hf];
  }
  float acc[NV][VC / 2];
#pragma unroll
  for (int cc = 0; cc < NV; ++cc)
#pragma unroll
    for (int i = 0; i < VC / 2; ++i) acc[cc][i] = 0.f;
  if constexpr (RES) wg::landed(obar, 0, vec);
  int pend = -1;   // the slot the group of wgmma in flight reads
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
    // S = q k^T and dP = dO v^T over the head dim, a score stage at a time
    float sc[KT / 2], dp[KT / 2];
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) sc[i] = dp[i] = 0.f;
    wg::hold(sc);
    wg::hold(dp);
    int s_sc = 0;   // RES: the tile's stage, which dQ's products read again
    for (int j = 0; j < n_sc; ++j) {
      const int u = t * per + j, s = u % NS;
      wg::landed(&full[s], (u / NS) & 1, vec);
      const T* qt = RES ? own : ring + s * SE;   // q, dO: R0 rows a part
      const T* dt = qt + NP * R0 * SC;
      const T* kt = ring + s * SE + OWN;         // k, v: KT rows a part
      const T* vt = kt + NP * KT * SC;
      wg::wg_fence();
#pragma unroll
      for (int ks = 0; ks < SC / G::kK; ++ks) {
        const uint64_t aq = wg::desc_score<T, R0>(qt, ks, 64 * w);
        const uint64_t ad = wg::desc_score<T, R0>(dt, ks, 64 * w);
        const uint64_t bk = wg::desc_score<T, KT>(kt, ks);
        const uint64_t bv = wg::desc_score<T, KT>(vt, ks);
        if constexpr (F32) {   // hi hi, hi lo, lo hi
          const uint64_t kl = wg::desc_score<T, KT>(kt + KT * SC, ks);
          const uint64_t vl = wg::desc_score<T, KT>(vt + KT * SC, ks);
          const uint64_t ql = wg::desc_score<T, R0>(qt + R0 * SC, ks, 64 * w);
          const uint64_t dl = wg::desc_score<T, R0>(dt + R0 * SC, ks, 64 * w);
          wg::wg_ss_tf32<KT>(sc, aq, bk, 1);
          wg::wg_ss_tf32<KT>(sc, aq, kl, 1);
          wg::wg_ss_tf32<KT>(sc, ql, bk, 1);
          wg::wg_ss_tf32<KT>(dp, ad, bv, 1);
          wg::wg_ss_tf32<KT>(dp, ad, vl, 1);
          wg::wg_ss_tf32<KT>(dp, dl, bv, 1);
        } else {
          wg::wg_ss_bf16<KT>(sc, aq, bk, 1);
          wg::wg_ss_bf16<KT>(dp, ad, bv, 1);
        }
      }
      if constexpr (RES) {
        wg::wg_commit();
        s_sc = s;
      } else {
        next_group(s);
      }
    }
    if constexpr (RES)
      wg::wg_wait();
    else
      all_groups();
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
        if (r < Lq && tig == 0 && oc == 0)
          dr[(static_cast<size_t>(b) * H + h) * Lq + r] = drr[hf];
      }
    }
#pragma unroll
    for (int i = 0; i < KT / 2; ++i)
      sc[i] = sc[i] * (dp[i] - drr[(i >> 1) & 1]);
    // acc += dS k, a value stage at a time, dS fed back from the registers
    constexpr int NJ = KT / G::kK;
    unsigned fh[NJ][4], fl[NJ][4];
    if constexpr (F32)
      wg::feed_tf32<KT>(fh, fl, sc);
    else
      wg::feed_bf16<KT>(fh, fl, sc);
#pragma unroll
    for (int cc = 0; cc < NV; ++cc) wg::hold(acc[cc]);
#pragma unroll
    for (int cc = 0; cc < NV; ++cc) {
      int s = s_sc;
      if constexpr (!RES) {
        const int u = t * per + n_sc + cc;
        s = u % NS;
        wg::landed(&full[s], (u / NS) & 1, vec);
      }
      const T* kt = ring + s * SE;   // RES: the score stage's k
      wg::wg_fence();
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if constexpr (F32) {
          wg::wg_rs_tf32<VC>(acc[cc], fh[j], wg::desc_v128<VC>(kt, j), 1);
          wg::wg_rs_tf32<VC>(acc[cc], fh[j],
                             wg::desc_v128<VC>(kt + KT * VC, j), 1);
          wg::wg_rs_tf32<VC>(acc[cc], fl[j], wg::desc_v128<VC>(kt, j), 1);
        } else {
          wg::wg_rs_bf16<VC>(acc[cc], fh[j], wg::desc_mn<KT>(kt, j), 1);
          wg::wg_rs_bf16<VC>(acc[cc], fl[j], wg::desc_mn<KT>(kt, j), 1);
        }
      }
      next_group(s);
    }
    all_groups();
#pragma unroll
    for (int cc = 0; cc < NV; ++cc) wg::hold(acc[cc]);
    wg::hold(fh);
    wg::hold(fl);
  }
  const float f[2] = {scale, scale};
#pragma unroll
  for (int cc = 0; cc < NV; ++cc) {
    const int c0 = col0 + cc * VC;
    wg::store_rows<VC>(dq + qoff + c0, acc[cc], f, row, Lq, C, d - c0, tig);
  }
}

// dk/dv: grid (ceil(Lk / 64), H * n_oc, B * splits); the block's 64 keys,
// warpgroup 0 summing dV and warpgroup 1 dK at the block's columns, and a
// producer warpgroup. RES: k and v resident, a stage the tile's q and dO,
// which dV's and dK's products read again. Else a score stage holds some
// dims of k and v (the block's keys) and of q and dO (a tile of queries), a
// value stage the tile's q and dO at VC of the block's columns. Maps:
// operands k, v, q, dO, then q and dO for the value stages: bf16 the
// inputs', f32 the prepared parts (q times scale; q and dO transposed for
// the value stages). Warpgroup 0 computes S^T = k q^T and P^T, warpgroup 1
// dP^T = v dO^T; P^T passes to warpgroup 1 through shared memory (two
// buffers, by the tile's parity), which forms dS^T. Chunk s of the queries
// (q_chunk a multiple of the tile) writes its partial sums as
// mha_bwd_dkdv_wg_kernel.
template <typename T, int OC, bool RES, typename OutT>
__global__ void __launch_bounds__(128 * 3, 1)
mha_bwd_dkdv_stream_kernel(const __grid_constant__ wg::StreamMaps maps,
                           const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const float* __restrict__ lse,
                           const float* __restrict__ dr,
                           const T* __restrict__ dout,
                           OutT* __restrict__ dk_part,
                           OutT* __restrict__ dv_part, int B, int Lq, int Lk,
                           int C, int q_chunk, int d, int vec, float scale,
                           float c) {
  using G = wg::Stream<T, OC, RES>;
  constexpr bool F32 = G::kF32;
  constexpr int NP = G::kNP, R0 = G::kKvRows, KT = G::kKvKT;
  constexpr int SC = G::kSCW, VC = G::kKvVC, NV = OC / VC;
  constexpr int NS = G::kKvSlots, NC = 128 * G::kWG, SE = G::kv_slot();
  // elements of a score stage's own rows (k, v), before its tiles of q, dO
  constexpr int OWN = RES ? 0 : 2 * NP * R0 * SC;
  extern __shared__ __align__(1024) unsigned char smem[];
  // RES: k, v resident
  T* own = reinterpret_cast<T*>(wg::stream_base<T>(smem));
  T* ring = own + G::kv_own();
  float* pbuf = reinterpret_cast<float*>(ring + NS * SE);
  uint64_t* full = reinterpret_cast<uint64_t*>(pbuf + G::kv_pbuf());
  uint64_t* empty = full + NS;
  uint64_t* obar = empty + NS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_oc = (d + OC - 1) / OC;
  const int h = blockIdx.y / n_oc, oc = blockIdx.y % n_oc;
  const int H = gridDim.y / n_oc;
  const int b = blockIdx.z % B, split = blockIdx.z / B;
  const int blk0 = blockIdx.x * R0, col0 = oc * OC;
  const int q_begin = split * q_chunk;
  const int q_end = min(Lq, q_begin + q_chunk);
  // RES: one stage a tile (q and dO whole; dV's and dK's products read it
  // again)
  const int n_sc = RES ? 1 : (d + SC - 1) / SC;
  const int per = n_sc + (RES ? 0 : NV);
  const int ntiles = q_end > q_begin ? (q_end - q_begin + KT - 1) / KT : 0;
  const size_t koff = static_cast<size_t>(b) * Lk * C + h * d;
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
    const T* dh = dout + static_cast<size_t>(b) * Lq * C + h * d;
    // a score stage: k, v (R0 rows each), q, dO (KT rows), each in NP parts
    const T* src[4] = {k + koff, v + koff, qh, dh};
    if constexpr (RES) {
      if (vec == 0 && lane == 0)
        wg::mbar_expect(obar, 2 * R0 * OC * sizeof(T));
#pragma unroll
      for (int x = 0; x < 2; ++x)
        wg::stream_tile<T, OC, R0>(own + x * R0 * OC, &maps.m[x], obar,
                                   src[x], blk0, Lk, h, b, C, d, vec, lane,
                                   0);
      wg::loaded(obar, vec);
    }
    for (int u = 0; u < ntiles * per; ++u) {
      const int s = u % NS, t = u / per, j = u % per;
      const int r0 = q_begin + t * KT;
      if (u >= NS) wg::mbar_wait(&empty[s], (u / NS - 1) & 1);
      T* slot = ring + s * SE;
      if (j < n_sc) {
        if (vec == 0 && lane == 0)
          wg::mbar_expect(&full[s],
                          (OWN + 2 * NP * KT * SC) * sizeof(T));
#pragma unroll
        for (int p = 0; p < NP; ++p) {
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            if constexpr (!RES)
              wg::stream_tile<T, SC, R0>(slot + (x * NP + p) * R0 * SC,
                                         &maps.m[x * NP + p], &full[s],
                                         src[x], blk0, Lk, h, b, C, d, vec,
                                         lane, j * SC);
            wg::stream_tile<T, SC, KT>(
                slot + OWN + (x * NP + p) * KT * SC,
                &maps.m[(2 + x) * NP + p], &full[s], src[2 + x], r0, q_end,
                h, b, C, d, vec, lane, j * SC);
          }
        }
      } else {
        const int c0 = col0 + (j - n_sc) * VC;
        if (vec == 0 && lane == 0)
          wg::mbar_expect(&full[s], 2 * NP * KT * VC * sizeof(T));
        if constexpr (F32) {
#pragma unroll
          for (int x = 0; x < 4; ++x)   // q^T hi, lo, dO^T hi, lo
            wg::stream_tile_t<VC>(slot + x * KT * VC, &maps.m[8 + x],
                                  &full[s], r0, c0, h, b, lane);
        } else {
          wg::stream_tile<T, VC, KT>(slot, &maps.m[4], &full[s], qh, r0,
                                     q_end, h, b, C, d, vec, lane, c0);
          wg::stream_tile<T, VC, KT>(slot + KT * VC, &maps.m[5], &full[s], dh,
                                     r0, q_end, h, b, C, d, vec, lane, c0);
        }
      }
      wg::loaded(&full[s], vec);
    }
    return;
  }

  // warpgroup w: 0 sums dV, 1 dK, over the same 64 keys
  wg::consumer_regs();
  const int w = warp >> 2, wt = threadIdx.x & 127;
  const int g = lane >> 2, tig = lane & 3;
  const int row = blk0 + 16 * (warp & 3) + g;   // keys row, row + 8
  const float* lseh = lse + (static_cast<size_t>(b) * H + h) * Lq;
  const float* drh = dr + (static_cast<size_t>(b) * H + h) * Lq;
  float acc[NV][VC / 2];
#pragma unroll
  for (int cc = 0; cc < NV; ++cc)
#pragma unroll
    for (int i = 0; i < VC / 2; ++i) acc[cc][i] = 0.f;
  if constexpr (RES) wg::landed(obar, 0, vec);
  int pend = -1;   // the slot the group of wgmma in flight reads
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
    // warpgroup 0: S^T = k q^T; 1: dP^T = v dO^T (keys as rows)
    float sc[KT / 2];
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) sc[i] = 0.f;
    wg::hold(sc);
    int s_sc = 0;   // RES: the tile's stage, which dV and dK read again
    for (int j = 0; j < n_sc; ++j) {
      const int u = t * per + j, s = u % NS;
      wg::landed(&full[s], (u / NS) & 1, vec);
      const T* slot = ring + s * SE;
      const T* ah = (RES ? own : slot) + w * NP * R0 * SC;   // k or v
      const T* bh = slot + OWN + w * NP * KT * SC;           // q or dO
      wg::wg_fence();
#pragma unroll
      for (int ks = 0; ks < SC / G::kK; ++ks) {
        const uint64_t a = wg::desc_score<T, R0>(ah, ks);
        const uint64_t bb = wg::desc_score<T, KT>(bh, ks);
        if constexpr (F32) {   // hi hi, hi lo, lo hi
          const uint64_t bl = wg::desc_score<T, KT>(bh + KT * SC, ks);
          const uint64_t al = wg::desc_score<T, R0>(ah + R0 * SC, ks);
          wg::wg_ss_tf32<KT>(sc, a, bb, 1);
          wg::wg_ss_tf32<KT>(sc, a, bl, 1);
          wg::wg_ss_tf32<KT>(sc, al, bb, 1);
        } else {
          wg::wg_ss_bf16<KT>(sc, a, bb, 1);
        }
      }
      if constexpr (RES) {
        wg::wg_commit();
        s_sc = s;
      } else {
        next_group(s);
      }
    }
    if constexpr (RES)
      wg::wg_wait();
    else
      all_groups();
    wg::hold(sc);

    // warpgroup 0: P^T from each query's lse (past the chunk lse = +inf, so
    // that P = 0), into the tile's P^T buffer; warpgroup 1 reads it there
    // and forms dS^T = P^T (dP^T - Dr)
    float* pb = pbuf + (t & 1) * R0 * KT;
    if (w == 0) {
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = q_begin + t * KT + 8 * j + 2 * tig + e;
          const float ls = qi < q_end ? lseh[qi] : INFINITY;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int i = 4 * j + 2 * hf + e;
            sc[i] = ex2(fmaf(sc[i], c, -ls));
            pb[i * 128 + wt] = sc[i];
          }
        }
    }
    wg::consumers_sync(NC);
    if (w == 1) {
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = q_begin + t * KT + 8 * j + 2 * tig + e;
          const float dd = qi < q_end ? drh[qi] : 0.f;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int i = 4 * j + 2 * hf + e;
            sc[i] = pb[i * 128 + wt] * (sc[i] - dd);
          }
        }
    }
    // dv += P^T dO (warpgroup 0), dk += dS^T q (1), a value stage at a
    // time, fed back from the registers
    constexpr int NJ = KT / G::kK;
    unsigned fh[NJ][4], fl[NJ][4];
    if constexpr (F32)
      wg::feed_tf32<KT>(fh, fl, sc);
    else
      wg::feed_bf16<KT>(fh, fl, sc);
#pragma unroll
    for (int cc = 0; cc < NV; ++cc) wg::hold(acc[cc]);
#pragma unroll
    for (int cc = 0; cc < NV; ++cc) {
      int s = s_sc;
      if constexpr (!RES) {
        const int u = t * per + n_sc + cc;
        s = u % NS;
        wg::landed(&full[s], (u / NS) & 1, vec);
      }
      // q, dO (RES: the score stage's): dO for warpgroup 0, q for 1
      const T* x = ring + s * SE + (1 - w) * NP * KT * VC;
      wg::wg_fence();
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if constexpr (F32) {
          wg::wg_rs_tf32<VC>(acc[cc], fh[j], wg::desc_v128<VC>(x, j), 1);
          wg::wg_rs_tf32<VC>(acc[cc], fh[j], wg::desc_v128<VC>(x + KT * VC, j),
                             1);
          wg::wg_rs_tf32<VC>(acc[cc], fl[j], wg::desc_v128<VC>(x, j), 1);
        } else {
          wg::wg_rs_bf16<VC>(acc[cc], fh[j], wg::desc_mn<KT>(x, j), 1);
          wg::wg_rs_bf16<VC>(acc[cc], fl[j], wg::desc_mn<KT>(x, j), 1);
        }
      }
      next_group(s);
    }
    all_groups();
#pragma unroll
    for (int cc = 0; cc < NV; ++cc) wg::hold(acc[cc]);
    wg::hold(fh);
    wg::hold(fl);
  }
  const size_t off = static_cast<size_t>(split) * B * Lk * C + koff;
  const float fk = F32 || w == 0 ? 1.f : scale;
  const float f[2] = {fk, fk};
  OutT* out = (w ? dk_part : dv_part) + off;
#pragma unroll
  for (int cc = 0; cc < NV; ++cc) {
    const int c0 = col0 + cc * VC;
    wg::store_rows<VC>(out + c0, acc[cc], f, row, Lk, C, d - c0, tig);
  }
}

// the f32 stream design's prepared operands in `prep` (floats; the
// wrapper's ops/attention.py: stream_prep_floats), hi then lo of each: q
// (times 1 / sqrt(d)), dO, k, v head-major, k^T, then q^T (times 1 /
// sqrt(d)) and dO^T
template <typename T, int OC, bool RES>
cudaError_t launch_stream(const void* q_, const void* k_, const void* v_,
                          const float* o, const float* lse, const void* dout_,
                          void* dq_, void* dk_, void* dv_, float* scratch,
                          float* dr, int B, int Lq, int Lk, int C, int H,
                          int splits, int d, float* prep,
                          cudaStream_t stream) {
  using G = wg::Stream<T, OC, RES>;
  constexpr bool bf16 = !G::kF32;
  const int n_oc = (d + OC - 1) / OC;
  if (static_cast<long long>(H) * n_oc > 65535) return cudaErrorInvalidValue;
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  const T* dout = static_cast<const T*>(dout_);
  T* dk = static_cast<T*>(dk_);
  T* dv = static_cast<T*>(dv_);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  // the dq kernel's maps (its rows of q and dO, tiles of k and v), then the
  // dk/dv kernel's (its rows of k and v, tiles of q and dO)
  wg::StreamMaps mq{}, mk{};
  int vec = 0;
  constexpr int SC = G::kSCW, OWNC = RES ? OC : SC;
  if constexpr (bf16) {
    vec = wg::copy_mode(d, 2);
    auto map = [&](CUtensorMap* m, const T* x, int L, int rows, int cols) {
      return wg::map_in(m, x, B, L, H, d, rows, cols);
    };
    if (vec == 0 &&
        !(map(&mq.m[0], q, Lq, G::kDqRows, OWNC) &&
          map(&mq.m[1], dout, Lq, G::kDqRows, OWNC) &&
          map(&mq.m[2], k, Lk, G::kDqKT, SC) &&
          map(&mq.m[3], v, Lk, G::kDqKT, SC) &&
          map(&mq.m[4], k, Lk, G::kDqKT, G::kDqVC) &&
          map(&mk.m[0], k, Lk, G::kKvRows, OWNC) &&
          map(&mk.m[1], v, Lk, G::kKvRows, OWNC) &&
          map(&mk.m[2], q, Lq, G::kKvKT, SC) &&
          map(&mk.m[3], dout, Lq, G::kKvKT, SC) &&
          map(&mk.m[4], q, Lq, G::kKvKT, G::kKvVC) &&
          map(&mk.m[5], dout, Lq, G::kKvKT, G::kKvVC))) {
      ++wg::tma_refused();   // the map was refused: copy by cp.async
      vec = copy_bytes(d * 2);
    }
  } else {
    if (prep == nullptr) return cudaErrorInvalidValue;
    const size_t nq = static_cast<size_t>(B) * H * Lq * wg::stream_dp(d);
    const size_t nk = static_cast<size_t>(B) * H * Lk * wg::stream_dp(d);
    const size_t tk = static_cast<size_t>(B) * H * d * wg::stream_l8(Lk);
    const size_t tq = static_cast<size_t>(B) * H * d * wg::stream_l8(Lq);
    float* qn = prep;            // hi, lo of q, then of dO
    float* kn = prep + 4 * nq;   // hi, lo of k, then of v
    float* kt = kn + 4 * nk;     // hi, lo of k^T
    float* qt = kt + 2 * tk;     // hi, lo of q^T, then of dO^T
    cudaError_t err = wg::stream_prep(q, qn, qn + nq, qt, qt + tq, B, Lq, H,
                                      d, scale, stream);
    if (err == cudaSuccess)
      err = wg::stream_prep(dout, qn + 2 * nq, qn + 3 * nq, qt + 2 * tq,
                            qt + 3 * tq, B, Lq, H, d, 1.f, stream);
    if (err == cudaSuccess)
      err = wg::stream_prep(k, kn, kn + nk, kt, kt + tk, B, Lk, H, d, 1.f,
                            stream);
    if (err == cudaSuccess)
      err = wg::stream_prep(v, kn + 2 * nk, kn + 3 * nk, nullptr, nullptr, B,
                            Lk, H, d, 1.f, stream);
    if (err != cudaSuccess) return err;
    bool ok = true;
    for (int i = 0; i < 4; ++i) {   // hi, lo of q, dO; of k, v
      ok = ok &&
           wg::map_prep(&mq.m[i], qn + i * nq, B, Lq, H, d, G::kDqRows) &&
           wg::map_prep(&mq.m[4 + i], kn + i * nk, B, Lk, H, d, G::kDqKT) &&
           wg::map_prep(&mk.m[i], kn + i * nk, B, Lk, H, d, G::kKvRows) &&
           wg::map_prep(&mk.m[4 + i], qn + i * nq, B, Lq, H, d, G::kKvKT) &&
           wg::map_prep_t(&mk.m[8 + i], qt + i * tq, B, Lq, H, d, G::kKvVC);
    }
    ok = ok && wg::map_prep_t(&mq.m[8], kt, B, Lk, H, d, G::kDqVC) &&
         wg::map_prep_t(&mq.m[9], kt + tk, B, Lk, H, d, G::kDqVC);
    if (!ok) {
      ++wg::tma_refused();   // no cp.async path for the prepared operands
      return cudaErrorNotSupported;
    }
  }
  const float c = bf16 ? kLog2e * scale : kLog2e;
  constexpr size_t smem_dq = G::dq_smem(), smem_kv = G::kv_smem();
  constexpr int threads = 128 * (G::kWG + 1);
  cudaError_t err = cudaFuncSetAttribute(
      mha_bwd_dq_stream_kernel<T, OC, RES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_dq));
  if (err != cudaSuccess) return err;
  mha_bwd_dq_stream_kernel<T, OC, RES>
      <<<dim3((Lq + G::kDqRows - 1) / G::kDqRows, H * n_oc, B), threads,
         smem_dq, stream>>>(mq, q, k, v, o, lse, dout, static_cast<T*>(dq_),
                            dr, Lq, Lk, C, d, vec, scale, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // query chunks of whole tiles (a transposed tile's rows in PAIR_SLOTS
  // order come 8 at a time)
  const int q_chunk = ((Lq + splits - 1) / splits + G::kKvKT - 1) /
                      G::kKvKT * G::kKvKT;
  const size_t n = static_cast<size_t>(B) * Lk * C;
  float* dk_part = scratch;
  float* dv_part = scratch + splits * n;
  const dim3 grid((Lk + G::kKvRows - 1) / G::kKvRows, H * n_oc, B * splits);
  if (splits == 1) {
    err = cudaFuncSetAttribute(mha_bwd_dkdv_stream_kernel<T, OC, RES, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_kv));
    if (err != cudaSuccess) return err;
    mha_bwd_dkdv_stream_kernel<T, OC, RES, T>
        <<<grid, threads, smem_kv, stream>>>(
        mk, q, k, v, lse, dr, dout, dk, dv, B, Lq, Lk, C, q_chunk, d, vec,
        scale, c);
  } else {
    err = cudaFuncSetAttribute(mha_bwd_dkdv_stream_kernel<T, OC, RES, float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_kv));
    if (err != cudaSuccess) return err;
    mha_bwd_dkdv_stream_kernel<T, OC, RES, float>
        <<<grid, threads, smem_kv, stream>>>(
            mk, q, k, v, lse, dr, dout, dk_part, dv_part, B, Lq, Lk, C,
            q_chunk, d, vec, scale, c);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t want = (n + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  sum_splits_kernel<T><<<blocks, 256, 0, stream>>>(dk_part, dv_part, dk, dv,
                                                   n, splits);
  return cudaGetLastError();
}

}  // namespace

// csrc/fused_mha_bwd.cu: fused_mha_bwd at a head dim above 128 (its
// arguments, checked there; dr required)
int mha_bwd_stream(const void* q, const void* k, const void* v,
                   const float* o, const float* lse, const void* dout,
                   void* dq, void* dk, void* dv, float* scratch, float* dr,
                   int B, int Lq, int Lk, int C, int H, int splits, int bf16,
                   float* prep, cudaStream_t s) {
  const int d = C / H;
  if (dr == nullptr || d <= kMaxHeadDim)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      wg::at_stream_width(wg::stream_out(d), [&](auto w) {
        constexpr int OC = decltype(w)::value;
        if (!bf16)
          return launch_stream<float, OC, false>(
              q, k, v, o, lse, dout, dq, dk, dv, scratch, dr, B, Lq, Lk, C,
              H, splits, d, prep, s);
        return wg::stream_resident(d, true)
                   ? launch_stream<__nv_bfloat16, OC, true>(
                         q, k, v, o, lse, dout, dq, dk, dv, scratch, dr, B,
                         Lq, Lk, C, H, splits, d, prep, s)
                   : launch_stream<__nv_bfloat16, OC, false>(
                         q, k, v, o, lse, dout, dq, dk, dv, scratch, dr, B,
                         Lq, Lk, C, H, splits, d, prep, s);
      }));
}
