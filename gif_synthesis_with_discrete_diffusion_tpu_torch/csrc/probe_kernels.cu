// The measurement probes' kernels (Hopper): a small f32 product for the
// build-cache probe, and chains of dependent bf16 tensor-core products for
// the depth / packing probe.
//
// Replace the TPU kernels of the JAX package's scripts:
//   probe_matmul  <- scripts/compile_cache_probe.py: kern
//                    o = (a @ a) * 2, a (n, n) f32
//   probe_chain   <- scripts/depth_pack_probe.py: _chain_kernel (one chain)
//                    and _pair_kernel (two independent chains an iteration)
//                    x <- bf16(0.01 * (x @ w)[:, :k]), `iters` times, f32
//                    accumulation, then sum(x); x (m, k) bf16, w (k, n) bf16
//
// probe_matmul exists to give the build-cache probe a kernel of the class it
// caches: 16 x 16 shared tiles, one f32 FMA chain a thread, nothing more.
//
// probe_chain. The TPU kernel parks x and all of w in one core's on-chip
// memory and loops. Here w (2 MB at (64, 16384), 8 MB at (128, 32768)) fits
// no block's 227 KB but does fit the card's shared memory taken together, so
// a persistent cooperative grid of at most one block an SM gives every block
// a column slab of w, staged into shared memory ONCE and kept there for all
// iterations. The chain's next x is only the first k columns of the product
// yet every block needs all of it, so the blocks that own those columns
// write it (scaled, rounded to bf16) to a double-buffered scratch that stays
// in the 50 MB L2, a grid barrier ends the iteration, and every block
// re-stages x from L2 (cp.async.cg: past the L1, which other SMs' writes
// would leave stale). The other ways through were not taken: recomputing
// the (m, k) x (k, k) head in every block needs w[:, :k] in every block
// (512 KB at k = 512), and a cluster's shared memory spans 16 SMs, not 132.
// What bounds an iteration on this card is therefore the exchange (the
// barrier and the re-staging of x), not the tensor cores; mode 1 runs the
// loop with the products skipped and mode 2 the barriers alone, so the
// probe can print each share.
//
// Products: mma.sync.m16n8k16, bf16 operands from shared memory through
// ldmatrix (rows padded by 16 bytes: conflict-free), f32 accumulators. A
// warp owns 32 rows and walks its slab 64 columns at a time; a contraction
// deeper than 256, or than shared memory holds, is staged in equal chunks.
// With two chains (NC = 2) both advance inside the same k-step, so their
// mma's interleave.
//
// Only the first k of n columns feed the chain. So that no column's product
// is dead, every iteration's full product is summed into `checksum`, one
// f32 per chain and group of 16 columns (sum over rows, columns of the group
// and iterations), in a fixed order: per-thread partial sums in shared
// memory, added up once at the end.
//
// Rounding as the JAX kernels': exact products of bf16 values, f32 sums (in
// the tensor cores' order, not the plain version's), * 0.01f in f32, then
// one rounding to bf16.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------- P1 ----

constexpr int kTile = 16;

__global__ void __launch_bounds__(kTile* kTile)
probe_matmul_kernel(const float* __restrict__ a, float* __restrict__ o,
                    int n) {
  __shared__ float lhs[kTile][kTile + 1];
  __shared__ float rhs[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int row = blockIdx.y * kTile + ty;
  const int col = blockIdx.x * kTile + tx;
  float acc = 0.f;
  for (int k0 = 0; k0 < n; k0 += kTile) {
    lhs[ty][tx] = (row < n && k0 + tx < n) ? a[row * n + k0 + tx] : 0.f;
    rhs[ty][tx] = (k0 + ty < n && col < n) ? a[(k0 + ty) * n + col] : 0.f;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTile; ++kk) acc = fmaf(lhs[ty][kk], rhs[kk][tx], acc);
    __syncthreads();
  }
  if (row < n && col < n) o[row * n + col] = acc * 2.f;
}

// ----------------------------------------------------------- P2 / P3 ----

constexpr int kThreads = 256;
constexpr int kSub = 64;        // columns per accumulator sub-tile
constexpr int kMaxChunk = 256;  // contraction depth staged at a time
constexpr int kGroup = 16;      // columns per checksum entry
constexpr int kPad = 8;         // bf16 of padding per shared row (16 bytes)
constexpr int kMaxRows = 256;   // 8 warps x 32 rows
constexpr int kMaxSmem = 232448;

struct ChainParams {
  const __nv_bfloat16* x0;    // (m, k): the first x of every chain
  const __nv_bfloat16* w[2];  // (k, n) per chain
  __nv_bfloat16* xbuf;        // (2, NC, m, k) scratch: the next x, by parity
  float* checksum;            // (NC, n / 16)
  float* out;                 // (1,): sum of the final x over the chains
  int m, k, n, iters, slab, mode;
  int kc;  // contraction depth staged at a time: divides k
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col); d[0], d[1]: row g, columns 2t,
// 2t + 1; d[2], d[3]: row g + 8 (g = lane / 4, t = lane % 4)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned scaled_pair(float lo, float hi) {
  const __nv_bfloat162 v =
      __halves2bfloat162(__float2bfloat16_rn(0.01f * lo),
                         __float2bfloat16_rn(0.01f * hi));
  return *reinterpret_cast<const unsigned*>(&v);
}

template <int NC>
__global__ void __launch_bounds__(kThreads, 1) chain_kernel(ChainParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kThreads];
  cg::grid_group grid = cg::this_grid();
  if (p.mode == 2) {  // the barriers alone
    for (int it = 0; it < p.iters; ++it) grid.sync();
    return;
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kc = p.kc;
  const int nchunks = p.k / kc;
  const int xs_ld = kc + kPad, ws_ld = p.slab + kPad;
  const int groups = p.slab / kGroup;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [NC][m][xs_ld]
  __nv_bfloat16* ws = xs + NC * p.m * xs_ld;                   // [NC][k][ws_ld]
  float* cs = reinterpret_cast<float*>(ws + NC * p.k * ws_ld);
  // cs: [NC][groups][kThreads], each thread's own partial sums

  const int c0 = blockIdx.x * p.slab;  // this block's first column
  const int width = p.n - c0 < p.slab ? p.n - c0 : p.slab;
  for (int i = tid; i < NC * groups * kThreads; i += kThreads) cs[i] = 0.f;
  // the slab of w: staged once, kept for all iterations
  const int wvec = p.slab / 8;
  for (int c = 0; c < NC; ++c)
    for (int i = tid; i < p.k * wvec; i += kThreads) {
      const int r = i / wvec, j = i % wvec;
      __nv_bfloat16* dst = ws + (c * p.k + r) * ws_ld + j * 8;
      if (c0 + j * 8 < p.n)
        cp_async16(dst, p.w[c] + static_cast<size_t>(r) * p.n + c0 + j * 8);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }

  const size_t state = static_cast<size_t>(p.m) * p.k;  // one chain's x
  const int row0 = warp * 32;
  const bool active = row0 < p.m;
  const int g = lane >> 2, t = lane & 3;
  const int xvec = kc / 8;

  for (int it = 0; it < p.iters; ++it) {
    const __nv_bfloat16* src = p.xbuf + (it & 1) * NC * state;
    __nv_bfloat16* dst = p.xbuf + ((it + 1) & 1) * NC * state;
    for (int ct = 0; ct < width; ct += kSub) {
      float acc[NC][2][8][4];
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[c][mt][nt][e] = 0.f;

      for (int ch = 0; ch < nchunks; ++ch) {
        if (nchunks > 1 || ct == 0) {
          // stage x (this chunk of its columns) from L2; one chunk stays
          // for the whole iteration, several are re-staged per sub-tile
          __syncthreads();  // the previous chunk is consumed
          for (int c = 0; c < NC; ++c) {
            const __nv_bfloat16* from = it == 0 ? p.x0 : src + c * state;
            for (int i = tid; i < p.m * xvec; i += kThreads) {
              const int r = i / xvec, j = i % xvec;
              cp_async16(xs + (c * p.m + r) * xs_ld + j * 8,
                         from + static_cast<size_t>(r) * p.k + ch * kc + j * 8);
            }
          }
          cp_async_wait_all();  // w's slab too, the first time
          __syncthreads();
        }
        if (active && p.mode == 0) {
          for (int kk = 0; kk < kc; kk += 16) {
            unsigned a[NC][2][4];
#pragma unroll
            for (int c = 0; c < NC; ++c)
#pragma unroll
              for (int mt = 0; mt < 2; ++mt)
                ldmatrix_x4(a[c][mt],
                            xs + (c * p.m + row0 + mt * 16 + (lane & 15)) * xs_ld +
                                kk + (lane >> 4) * 8);
#pragma unroll
            for (int np = 0; np < 4; ++np) {
              if (ct + np * 16 < width) {
#pragma unroll
                for (int c = 0; c < NC; ++c) {
                  unsigned b[4];
                  ldmatrix_x4_trans(
                      b, ws + (c * p.k + ch * kc + kk + (lane & 15)) * ws_ld +
                             ct + np * 16 + (lane >> 4) * 8);
#pragma unroll
                  for (int mt = 0; mt < 2; ++mt) {
                    mma_bf16(acc[c][mt][2 * np], a[c][mt], b[0], b[1]);
                    mma_bf16(acc[c][mt][2 * np + 1], a[c][mt], b[2], b[3]);
                  }
                }
              }
            }
          }
        }
      }

      if (active) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            if (ct + np * 16 < width) {
              float v = 0.f;
#pragma unroll
              for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                  for (int e = 0; e < 4; ++e) v += acc[c][mt][2 * np + h][e];
              cs[(c * groups + ct / kGroup + np) * kThreads + tid] += v;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int col = c0 + ct + np * 16 + h * 8 + 2 * t;
                if (col < p.k) {  // the head: the chain's next x
#pragma unroll
                  for (int mt = 0; mt < 2; ++mt) {
                    const float(&d)[4] = acc[c][mt][2 * np + h];
                    __nv_bfloat16* q =
                        dst + c * state +
                        static_cast<size_t>(row0 + mt * 16 + g) * p.k + col;
                    *reinterpret_cast<unsigned*>(q) = scaled_pair(d[0], d[1]);
                    *reinterpret_cast<unsigned*>(q + 8 * p.k) =
                        scaled_pair(d[2], d[3]);
                  }
                }
              }
            }
          }
      }
    }
    grid.sync();  // the next x is whole, and visible in L2
  }

  if (p.iters == 0) {  // nothing was staged: drain w's copies
    cp_async_wait_all();
  }
  __syncthreads();
  for (int i = tid; i < NC * groups; i += kThreads) {
    const int c = i / groups, col = c0 + (i % groups) * kGroup;
    if (col < p.n) {
      float s = 0.f;
      for (int j = 0; j < kThreads; ++j) s += cs[i * kThreads + j];
      p.checksum[c * (p.n / kGroup) + col / kGroup] = s;
    }
  }

  if (blockIdx.x == 0) {  // sum of the final x, in a fixed order
    float s = 0.f;
    for (int c = 0; c < NC; ++c) {
      const unsigned short* fin = reinterpret_cast<const unsigned short*>(
          p.iters == 0 ? p.x0 : p.xbuf + (p.iters & 1) * NC * state + c * state);
      for (size_t i = tid; i < state; i += kThreads)
        s += __bfloat162float(__ushort_as_bfloat16(__ldcg(fin + i)));
    }
    red[tid] = s;
    __syncthreads();
    for (int stride = kThreads / 2; stride > 0; stride /= 2) {
      if (tid < stride) red[tid] += red[tid + stride];
      __syncthreads();
    }
    if (tid == 0) p.out[0] = red[0];
  }
}

// the column slab a block owns: the narrowest multiple of 16 that covers n
// with at most one block an SM
int slab_width(int n, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (sms < 1 || n < 1) return -static_cast<int>(cudaErrorInvalidValue);
  int slab = (n + sms - 1) / sms;
  slab = (slab + kGroup - 1) / kGroup * kGroup;
  *blocks = (n + slab - 1) / slab;
  return slab;
}

}  // namespace

// o = (a @ a) * 2 for a (n, n) f32. Returns a cudaError_t.
extern "C" int probe_matmul(const float* a, float* o, int n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (n + kTile - 1) / kTile;
  probe_matmul_kernel<<<dim3(tiles, tiles), dim3(kTile, kTile), 0,
                        static_cast<cudaStream_t>(stream)>>>(a, o, n);
  return static_cast<int>(cudaGetLastError());
}

// The chain's plan on the current device: the slab width, and through
// `blocks` the grid. Negative: a cudaError_t.
extern "C" int probe_chain_plan(int n, int* blocks) {
  return slab_width(n, blocks);
}

// One launch of the chain (w2 == nullptr: one chain; else two independent
// chains an iteration). mode 0: the probe; 1: the loop with the products
// skipped; 2: the grid barriers alone. checksum (NC, n / 16) and out (1,)
// must be zero on entry; xbuf holds 2 * NC * m * k bf16. Returns a
// cudaError_t: cudaErrorInvalidValue for a shape the kernel does not take,
// and the launch's own refusal of a grid that cannot be co-resident.
extern "C" int probe_chain(const void* x, const void* w1, const void* w2,
                           void* xbuf, float* checksum, float* out, int m,
                           int k, int n, int iters, int mode, void* stream) {
  const int nc = w2 != nullptr ? 2 : 1;
  if (m < 32 || m > kMaxRows || m % 32 != 0 || k < 16 || k % 16 != 0 ||
      (k > kMaxChunk && k % kMaxChunk != 0) || n % kGroup != 0 || k > n ||
      iters < 0 || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const int slab = slab_width(n, &blocks);
  if (slab < 0) return -slab;
  // x's staging depth: the deepest that fits beside the slab of w
  int kc = k < kMaxChunk ? k : kMaxChunk;
  size_t smem = 0;
  for (;; kc /= 2) {
    smem = static_cast<size_t>(nc) *
           (static_cast<size_t>(m) * (kc + kPad) * 2 +
            static_cast<size_t>(k) * (slab + kPad) * 2 +
            static_cast<size_t>(slab / kGroup) * kThreads * sizeof(float));
    if (smem <= kMaxSmem) break;
    if (kc % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  ChainParams p;
  p.x0 = static_cast<const __nv_bfloat16*>(x);
  p.w[0] = static_cast<const __nv_bfloat16*>(w1);
  p.w[1] = static_cast<const __nv_bfloat16*>(w2);
  p.xbuf = static_cast<__nv_bfloat16*>(xbuf);
  p.checksum = checksum;
  p.out = out;
  p.m = m;
  p.k = k;
  p.n = n;
  p.iters = iters;
  p.slab = slab;
  p.mode = mode;
  p.kc = kc;
  const void* fn = nc == 2 ? reinterpret_cast<const void*>(chain_kernel<2>)
                           : reinterpret_cast<const void*>(chain_kernel<1>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&p};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      fn, dim3(blocks), dim3(kThreads), args, smem,
      static_cast<cudaStream_t>(stream)));
}
