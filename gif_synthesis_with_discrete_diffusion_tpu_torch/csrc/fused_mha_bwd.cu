// Non-causal multi-head attention backward for the D3PM denoiser (Hopper),
// for f32 and bf16 inputs.
//
// Replaces the TPU kernel gif_synthesis_with_discrete_diffusion_tpu/ops/
// attention.py: _bwd_kernel (via _fused_mha_bwd_impl, the backward of the
// custom VJP around fused_mha).
//
// q, dout, dq: (B, Lq, C); k, v, dk, dv: (B, Lk, C); all of one type (f32
// or bf16) and contiguous, C = H * D. o: (B, Lq, C) f32, the forward's
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
#include "mha_tiles.cuh"

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

// out[i] = sum over s of part[s * n + i], in order s = 0, 1, ...
template <typename OutT>
__global__ void sum_splits_kernel(const float* __restrict__ dk_part,
                                  const float* __restrict__ dv_part,
                                  OutT* __restrict__ dk,
                                  OutT* __restrict__ dv, size_t n,
                                  int splits) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float a = 0.f, e = 0.f;
    for (int s = 0; s < splits; ++s) {
      a += dk_part[s * n + i];
      e += dv_part[s * n + i];
    }
    if constexpr (std::is_same_v<OutT, float>) {
      dk[i] = a;
      dv[i] = e;
    } else {
      dk[i] = __float2bfloat16_rn(a);
      dv[i] = __float2bfloat16_rn(e);
    }
  }
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

// Returns a cudaError_t: cudaErrorInvalidValue for a head dim other than 4
// or 8 or a bad shape, else the first failed launch's status. bf16 selects
// the input type (0: f32, 1: bf16); o is the forward's output in f32. With
// splits > 1, scratch holds 2 * splits * B * Lk * C floats; with splits ==
// 1 it may be null.
extern "C" int fused_mha_bwd(const void* q, const void* k, const void* v,
                             const float* o, const float* lse,
                             const void* dout, void* dq, void* dk, void* dv,
                             float* scratch, int B, int Lq, int Lk, int C,
                             int H, int splits, int bf16, void* stream) {
  if (H <= 0 || C % H != 0 || Lq <= 0 || Lk <= 0 || B <= 0 || H > 65535 ||
      splits <= 0 || splits > Lq || static_cast<long long>(B) * splits > 65535
      || (splits > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = C / H;
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
