// Non-causal multi-head attention backward for the D3PM denoiser (Hopper).
//
// Replaces the TPU kernel gif_synthesis_with_discrete_diffusion_tpu/ops/
// attention.py: _bwd_kernel (via _fused_mha_bwd_impl, the backward of the
// custom VJP around fused_mha).
//
// q, o, dout, dq: (B, Lq, C); k, v, dk, dv: (B, Lk, C); all f32 and
// contiguous, C = H * D. lse: (B, H, Lq), the forward's per-row log-sum-exp
// of the scores in base 2 (csrc/fused_mha_fwd.cu). With s = q k^T / sqrt(D)
// and P = softmax(s):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - Dr),  Dr = rowsum(dO * O),
//   dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D).
// Dr = rowsum(dO * O) equals the TPU kernel's rowsum(dP * P) in exact
// arithmetic (O = P V), and costs D multiplies per row instead of a pass
// over the keys.
//
// What bounds it: as in the forward, the head dim D = 4 leaves a tensor-core
// product 12 of its 16 deep contraction idle, and P, dP, dS, written out,
// would be (B, H, Lq, Lk) f32 each (1 GiB per call at B = 16, L = 1024). So
// both kernels recompute P from q, k and the saved log-sum-exp in registers
// (one exp2 per score, log2(e) / sqrt(D) folded into q) and are bound by
// FMA and SFU issue, not by device memory: ~2.5x the forward's work.
//
// Design: no float atomics, so the result is deterministic.
//  * dq kernel: one thread per query row (the forward's layout), keys and
//    values staged through shared memory kTile at a time as float4; the
//    thread sums dS_ij k_j in registers.
//  * dk/dv kernel: one thread per key row, the queries (scaled q, dO, lse,
//    Dr) staged through shared memory; the thread sums P_ij dO_i and
//    dS_ij q_i. With few keys (cross-attention over 1 or 77 condition
//    tokens) there would be only B * H * Lk threads, each looping over every
//    query: the query range is then cut into `splits` chunks, each chunk
//    writes its partial sums, and a third kernel adds the chunks in a fixed
//    order.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 128;  // threads (rows) per block
constexpr int kTile = 128;   // keys (dq) or queries (dk/dv) per shared tile
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
__device__ __forceinline__ float dot(const float (&a)[D], const float4* b) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < D / 4; ++j) {
    const float4 bb = b[j];
    s = fmaf(a[4 * j + 0], bb.x, s);
    s = fmaf(a[4 * j + 1], bb.y, s);
    s = fmaf(a[4 * j + 2], bb.z, s);
    s = fmaf(a[4 * j + 3], bb.w, s);
  }
  return s;
}

template <int D>
__device__ __forceinline__ void axpy(float (&acc)[D], float a,
                                     const float4* x) {
#pragma unroll
  for (int j = 0; j < D / 4; ++j) {
    const float4 xx = x[j];
    acc[4 * j + 0] = fmaf(a, xx.x, acc[4 * j + 0]);
    acc[4 * j + 1] = fmaf(a, xx.y, acc[4 * j + 1]);
    acc[4 * j + 2] = fmaf(a, xx.z, acc[4 * j + 2]);
    acc[4 * j + 3] = fmaf(a, xx.w, acc[4 * j + 3]);
  }
}

template <int D>
__device__ __forceinline__ void load_row(float (&r)[D], const float* p,
                                         float scale) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int j = 0; j < D / 4; ++j) {
    const float4 t = p4[j];
    r[4 * j + 0] = t.x * scale;
    r[4 * j + 1] = t.y * scale;
    r[4 * j + 2] = t.z * scale;
    r[4 * j + 3] = t.w * scale;
  }
}

template <int D>
__device__ __forceinline__ void store_row(float* p, const float (&r)[D],
                                          float scale) {
  float4* p4 = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int j = 0; j < D / 4; ++j)
    p4[j] = make_float4(r[4 * j + 0] * scale, r[4 * j + 1] * scale,
                        r[4 * j + 2] * scale, r[4 * j + 3] * scale);
}

// grid (ceil(Lq / kBlock), H, B)
template <int D>
__global__ void __launch_bounds__(kBlock)
mha_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ o,
                  const float* __restrict__ lse,
                  const float* __restrict__ dout, float* __restrict__ dq,
                  int Lq, int Lk, int C, float q_scale, float scale) {
  constexpr int V4 = D / 4;
  __shared__ float4 ks[kTile * V4];
  __shared__ float4 vs[kTile * V4];

  const int h = blockIdx.y;
  const size_t b = blockIdx.z;
  const int row = blockIdx.x * kBlock + threadIdx.x;
  const bool active = row < Lq;

  float qr[D], dor[D], acc[D];
  float l2 = 0.f, dr = 0.f;
#pragma unroll
  for (int j = 0; j < D; ++j) qr[j] = dor[j] = acc[j] = 0.f;
  if (active) {
    const size_t off = (b * Lq + row) * C + h * D;
    float orow[D];
    load_row<D>(qr, q + off, q_scale);
    load_row<D>(dor, dout + off, 1.f);
    load_row<D>(orow, o + off, 1.f);
#pragma unroll
    for (int j = 0; j < D; ++j) dr = fmaf(dor[j], orow[j], dr);
    l2 = lse[(b * gridDim.y + h) * Lq + row];
  }

  for (int k0 = 0; k0 < Lk; k0 += kTile) {
    const int n = min(kTile, Lk - k0);
    __syncthreads();  // the previous tile is consumed
    if (threadIdx.x < n) {
      const size_t off = (b * Lk + k0 + threadIdx.x) * C + h * D;
      const float4* kp = reinterpret_cast<const float4*>(k + off);
      const float4* vp = reinterpret_cast<const float4*>(v + off);
#pragma unroll
      for (int j = 0; j < V4; ++j) {
        ks[threadIdx.x * V4 + j] = kp[j];
        vs[threadIdx.x * V4 + j] = vp[j];
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float p = exp2f(dot<D>(qr, ks + j * V4) - l2);
      const float ds = p * (dot<D>(dor, vs + j * V4) - dr);
      axpy<D>(acc, ds, ks + j * V4);
    }
  }
  if (active) store_row<D>(dq + (b * Lq + row) * C + h * D, acc, scale);
}

// grid (ceil(Lk / blockDim.x), H, B * splits); chunk s of the queries,
// [s * q_chunk, min(Lq, (s + 1) * q_chunk)), writes the partial sums
// dk_part / dv_part[s] of shape (B, Lk, C).
template <int D>
__global__ void __launch_bounds__(kBlock)
mha_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ lse,
                    const float* __restrict__ dout,
                    float* __restrict__ dk_part, float* __restrict__ dv_part,
                    int B, int Lq, int Lk, int C, int q_chunk,
                    float q_scale) {
  constexpr int V4 = D / 4;
  __shared__ float4 qs[kTile * V4];   // q * log2(e) / sqrt(D)
  __shared__ float4 dos[kTile * V4];  // dO
  __shared__ float2 stat[kTile];      // (lse, Dr) per query

  const int h = blockIdx.y;
  const int H = gridDim.y;
  const size_t b = blockIdx.z % B;
  const size_t split = blockIdx.z / B;
  const int key = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = key < Lk;
  const int q_begin = split * q_chunk;
  const int q_end = min(Lq, q_begin + q_chunk);

  float kr[D], vr[D], dk[D], dv[D];
#pragma unroll
  for (int j = 0; j < D; ++j) kr[j] = vr[j] = dk[j] = dv[j] = 0.f;
  if (active) {
    const size_t off = (b * Lk + key) * C + h * D;
    load_row<D>(kr, k + off, 1.f);
    load_row<D>(vr, v + off, 1.f);
  }

  for (int q0 = q_begin; q0 < q_end; q0 += kTile) {
    const int n = min(kTile, q_end - q0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const size_t row = b * Lq + q0 + i;
      const size_t off = row * C + h * D;
      float qq[D], dd[D], oo[D];
      load_row<D>(qq, q + off, q_scale);
      load_row<D>(dd, dout + off, 1.f);
      load_row<D>(oo, o + off, 1.f);
      float dr = 0.f;
#pragma unroll
      for (int j = 0; j < D; ++j) dr = fmaf(dd[j], oo[j], dr);
#pragma unroll
      for (int j = 0; j < V4; ++j) {
        qs[i * V4 + j] = make_float4(qq[4 * j], qq[4 * j + 1], qq[4 * j + 2],
                                     qq[4 * j + 3]);
        dos[i * V4 + j] = make_float4(dd[4 * j], dd[4 * j + 1], dd[4 * j + 2],
                                      dd[4 * j + 3]);
      }
      stat[i] = make_float2(lse[(b * H + h) * Lq + q0 + i], dr);
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const float2 st = stat[i];
      const float p = exp2f(dot<D>(kr, qs + i * V4) - st.x);
      axpy<D>(dv, p, dos + i * V4);
      const float ds = p * (dot<D>(vr, dos + i * V4) - st.y);
      axpy<D>(dk, ds, qs + i * V4);
    }
  }
  if (active) {
    const size_t off = ((split * B + b) * Lk + key) * C + h * D;
    // qs carries log2(e) / sqrt(D); dK wants 1 / sqrt(D): times ln 2
    store_row<D>(dk_part + off, dk, kLn2);
    store_row<D>(dv_part + off, dv, 1.f);
  }
}

// out[i] = sum over s of part[s * n + i], in order s = 0, 1, ...
__global__ void sum_splits_kernel(const float* __restrict__ dk_part,
                                  const float* __restrict__ dv_part,
                                  float* __restrict__ dk,
                                  float* __restrict__ dv, size_t n,
                                  int splits) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float a = 0.f, c = 0.f;
    for (int s = 0; s < splits; ++s) {
      a += dk_part[s * n + i];
      c += dv_part[s * n + i];
    }
    dk[i] = a;
    dv[i] = c;
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* o, const float* lse, const float* dout,
                   float* dq, float* dk, float* dv, float* scratch, int B,
                   int Lq, int Lk, int C, int H, int splits,
                   cudaStream_t stream) {
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const float q_scale = 1.4426950408889634f * scale;
  mha_bwd_dq_kernel<D><<<dim3((Lq + kBlock - 1) / kBlock, H, B), kBlock, 0,
                         stream>>>(q, k, v, o, lse, dout, dq, Lq, Lk, C,
                                   q_scale, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t n = static_cast<size_t>(B) * Lk * C;
  float* dk_part = splits > 1 ? scratch : dk;
  float* dv_part = splits > 1 ? scratch + splits * n : dv;
  const int q_chunk = (Lq + splits - 1) / splits;
  // a whole warp for a handful of keys; a full block otherwise
  const int threads = Lk <= 32 ? 32 : kBlock;
  mha_bwd_dkdv_kernel<D><<<dim3((Lk + threads - 1) / threads, H, B * splits),
                           threads, 0, stream>>>(
      q, k, v, o, lse, dout, dk_part, dv_part, B, Lq, Lk, C, q_chunk,
      q_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;

  const size_t want = (n + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  sum_splits_kernel<<<blocks, 256, 0, stream>>>(dk_part, dv_part, dk, dv, n,
                                                splits);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for a head dim other than 4
// or 8 or a bad shape, else the first failed launch's status. With
// splits > 1, scratch holds 2 * splits * B * Lk * C floats; with splits ==
// 1 it may be null.
extern "C" int fused_mha_bwd(const float* q, const float* k, const float* v,
                             const float* o, const float* lse,
                             const float* dout, float* dq, float* dk,
                             float* dv, float* scratch, int B, int Lq, int Lk,
                             int C, int H, int splits, void* stream) {
  if (H <= 0 || C % H != 0 || Lq <= 0 || Lk <= 0 || B <= 0 || H > 65535 ||
      splits <= 0 || splits > Lq || static_cast<long long>(B) * splits > 65535
      || (splits > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C / H) {
    case 4:
      return static_cast<int>(launch<4>(q, k, v, o, lse, dout, dq, dk, dv,
                                        scratch, B, Lq, Lk, C, H, splits, s));
    case 8:
      return static_cast<int>(launch<8>(q, k, v, o, lse, dout, dq, dk, dv,
                                        scratch, B, Lq, Lk, C, H, splits, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
