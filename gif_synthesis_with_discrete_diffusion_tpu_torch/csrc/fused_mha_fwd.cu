// Non-causal multi-head attention forward for the D3PM denoiser (Hopper).
//
// Replaces the TPU kernel gif_synthesis_with_discrete_diffusion_tpu/ops/
// attention.py: _kernel (via _fused_mha_fwd_impl / fused_mha).
//
// q: (B, Lq, C), k/v: (B, Lk, C), o: (B, Lq, C), all f32 and contiguous;
// C = H * D. Per (batch row, head): o = softmax(q k^T / sqrt(D)) v over the
// Lk keys, softmax in f32. When lse is not null it also receives each
// (batch row, head, query)'s log-sum-exp of the scores in base 2,
// (B, H, Lq) f32, which the backward (csrc/fused_mha_bwd.cu) uses to
// recompute the probabilities; the sampling path passes null and pays one
// untaken branch per thread.
//
// What bounds it: at the denoiser's head dim D = 4 a tensor-core product
// would waste 12 of its 16 deep contraction, and the score matrix, if
// written out, is (B, H, L, L) f32 = 4 GiB per layer at the honest shape.
// So this kernel is CUDA-core FMAs plus one exp2 per (query, key), with the
// scores never leaving registers; it is bound by FMA and SFU issue, not by
// device memory.
//
// Design: one CTA per (block of kBlockQ queries, head, batch row); one
// thread per query row keeps its D-wide q in registers, with 1/sqrt(D) and
// log2(e) folded in, and an online softmax (m, l, acc[D]) in f32. The keys
// and values of that head are staged through shared memory kTileK at a
// time as float4 (at D = 4 a head is exactly 16 bytes, so one load per key);
// every thread of a warp then reads the same key, a broadcast. Each tile
// takes two sweeps: the tile's score maximum, then exp2 and accumulate, so
// there is one exp2 per score and one rescale per tile.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 128;
constexpr int kTileK = 128;

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

template <int D>
__global__ void __launch_bounds__(kBlockQ)
fused_mha_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int Lq, int Lk, int C,
                     float q_scale) {
  constexpr int V4 = D / 4;  // float4 per head row
  __shared__ float4 ks[kTileK * V4];
  __shared__ float4 vs[kTileK * V4];

  const int h = blockIdx.y;
  const size_t b = blockIdx.z;
  const int row = blockIdx.x * kBlockQ + threadIdx.x;
  const bool active = row < Lq;

  float qr[D];
  if (active) {
    const float4* qp =
        reinterpret_cast<const float4*>(q + (b * Lq + row) * C + h * D);
#pragma unroll
    for (int j = 0; j < V4; ++j) {
      const float4 t = qp[j];
      qr[4 * j + 0] = t.x * q_scale;
      qr[4 * j + 1] = t.y * q_scale;
      qr[4 * j + 2] = t.z * q_scale;
      qr[4 * j + 3] = t.w * q_scale;
    }
  } else {
#pragma unroll
    for (int j = 0; j < D; ++j) qr[j] = 0.f;
  }

  float m = -INFINITY, l = 0.f, acc[D];
#pragma unroll
  for (int j = 0; j < D; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += kTileK) {
    const int n = min(kTileK, Lk - k0);
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
    float4* op = reinterpret_cast<float4*>(o + (b * Lq + row) * C + h * D);
#pragma unroll
    for (int j = 0; j < V4; ++j)
      op[j] = make_float4(acc[4 * j + 0] * inv, acc[4 * j + 1] * inv,
                          acc[4 * j + 2] * inv, acc[4 * j + 3] * inv);
    if (lse != nullptr) lse[(b * gridDim.y + h) * Lq + row] = m + log2f(l);
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, int B, int Lq, int Lk, int C, int H,
                   cudaStream_t stream) {
  const dim3 grid((Lq + kBlockQ - 1) / kBlockQ, H, B);
  // softmax(x) = 2^(x log2 e) / sum: fold 1/sqrt(D) and log2(e) into q
  const float q_scale = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  fused_mha_fwd_kernel<D><<<grid, kBlockQ, 0, stream>>>(q, k, v, o, lse, Lq,
                                                        Lk, C, q_scale);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for a head dim other than
// 4 or 8, else the launch's status. lse may be null.
extern "C" int fused_mha_fwd(const float* q, const float* k, const float* v,
                             float* o, float* lse, int B, int Lq, int Lk,
                             int C, int H, void* stream) {
  if (H <= 0 || C % H != 0 || Lq <= 0 || Lk <= 0 || B <= 0 || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C / H) {
    case 4:
      return static_cast<int>(launch<4>(q, k, v, o, lse, B, Lq, Lk, C, H, s));
    case 8:
      return static_cast<int>(launch<8>(q, k, v, o, lse, B, Lq, Lk, C, H, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
