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
// What bounds it: 2 N K D FLOP (17.2 GFLOP at N = 16384, K = 4096,
// D = 128), against N K distances that must never reach device memory
// (268 MB of f32 at that shape). The TPU kernel holds all of E (2 MB) in
// VMEM; a block cannot. So a block keeps its BM rows of x in shared memory
// for the whole call, streams E through shared memory BK codes at a time,
// and each thread computes a 4 x 4 tile of distances with FMAs (no TF32:
// that would move the argmin), keeping a running (min, index) per row.
// Compute-bound on FMA issue and shared-memory reads.
//
// The statistics: each block adds its own rows into n_total and encode_sum
// with float atomics (the wrapper zeroes both). The counts are integers and
// exact; encode_sum's sums come in no fixed order, so they agree with a
// sequential sum to f32 rounding (the tests hold them to 1e-4).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;    // rows of x per block
constexpr int BK = 64;    // codes per shared tile
constexpr int NT = 256;   // threads: 16 row groups x 16 code groups
constexpr int TM = 4;     // rows per thread
constexpr int TK = 4;     // codes per thread, strided by 16
constexpr int kMaxD = 384;
// shared row strides: the transposed stores of 32 consecutive d would hit
// one bank with a stride of 64; BK + 1 spreads them, BM + 4 keeps the
// float4 reads of x aligned and cuts the conflict to 4-way (once per block)
constexpr int XS = BM + 4;
constexpr int ES = BK + 1;

__device__ __forceinline__ bool better(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

__global__ void __launch_bounds__(NT)
nearest_code_kernel(const float* __restrict__ x, const float* __restrict__ e,
                    int N, int K, int D, int* __restrict__ idx_out,
                    float* __restrict__ n_total,
                    float* __restrict__ encode_sum) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [D][XS], x transposed
  float* es = xs + D * XS;                      // [D][ES], e transposed
  float* esq = es + D * ES;                     // [BK]
  __shared__ float red_d[16][BM];
  __shared__ int red_i[16][BM];
  __shared__ int rows_idx[BM];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // code group: codes tx, tx + 16, ...
  const int ty = tid / 16;  // row group: rows 4 ty .. 4 ty + 3
  const int row0 = blockIdx.x * BM;

  for (int i = tid; i < BM * D; i += NT) {
    const int r = i / D, d = i % D;
    const int row = row0 + r;
    xs[d * XS + r] = row < N ? x[static_cast<size_t>(row) * D + d] : 0.f;
  }

  float best[TM];
  int best_i[TM];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    best[m] = INFINITY;
    best_i[m] = 0x7fffffff;
  }

  for (int c0 = 0; c0 < K; c0 += BK) {
    __syncthreads();  // the previous code tile is consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int c = i / D, d = i % D;
      const int code = c0 + c;
      es[d * ES + c] = code < K ? e[static_cast<size_t>(code) * D + d] : 0.f;
    }
    __syncthreads();
    if (tid < BK) {
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(es[d * ES + tid], es[d * ES + tid], s);
      esq[tid] = s;
    }

    float acc[TM][TK];
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int c = 0; c < TK; ++c) acc[m][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 xv = *reinterpret_cast<const float4*>(&xs[d * XS + 4 * ty]);
      const float xr[TM] = {xv.x, xv.y, xv.z, xv.w};
      float er[TK];
#pragma unroll
      for (int c = 0; c < TK; ++c) er[c] = es[d * ES + tx + 16 * c];
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int c = 0; c < TK; ++c) acc[m][c] = fmaf(xr[m], er[c], acc[m][c]);
    }
    __syncthreads();  // esq is written
#pragma unroll
    for (int c = 0; c < TK; ++c) {
      const int code = c0 + tx + 16 * c;
      if (code >= K) continue;  // padded codes never win
      const float q = esq[tx + 16 * c];
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        // ||e||^2 - 2 x.e; the product by -2 is exact
        const float dist = fmaf(-2.f, acc[m][c], q);
        if (better(dist, code, best[m], best_i[m])) {
          best[m] = dist;
          best_i[m] = code;
        }
      }
    }
  }

  // the 16 code groups of each row: smallest distance, then smallest index
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    red_d[tx][4 * ty + m] = best[m];
    red_i[tx][4 * ty + m] = best_i[m];
  }
  __syncthreads();
  if (tid < BM) {
    float bd = red_d[0][tid];
    int bi = red_i[0][tid];
    for (int g = 1; g < 16; ++g)
      if (better(red_d[g][tid], red_i[g][tid], bd, bi)) {
        bd = red_d[g][tid];
        bi = red_i[g][tid];
      }
    rows_idx[tid] = bi;
    const int row = row0 + tid;
    if (row < N) {
      idx_out[row] = bi;
      atomicAdd(&n_total[bi], 1.f);
    }
  }
  __syncthreads();
  for (int i = tid; i < BM * D; i += NT) {
    const int r = i / D, d = i % D;
    if (row0 + r < N)
      atomicAdd(&encode_sum[static_cast<size_t>(rows_idx[r]) * D + d],
                xs[d * XS + r]);
  }
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for a bad shape (D above
// 384), else the launch's status. n_total (K) and encode_sum (K, D) must be
// zero on entry.
extern "C" int nearest_code_stats(const float* x, const float* e, int N,
                                  int K, int D, int* idx, float* n_total,
                                  float* encode_sum, void* stream) {
  if (N <= 0 || K <= 0 || D <= 0 || D > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(D) * (XS + ES) + BK) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      nearest_code_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nearest_code_kernel<<<(N + BM - 1) / BM, NT, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      x, e, N, K, D, idx, n_total, encode_sum);
  return static_cast<int>(cudaGetLastError());
}
