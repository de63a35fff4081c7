// One D3PM reverse-sampling step (Hopper): the sampler-step kernel K1.
//
// Replaces the TPU kernel gif_synthesis_with_discrete_diffusion_tpu/ops/
// sampler_kernel.py: _kernel (via fused_sample_step). Per (batch row b,
// position l), over the K-1 classes of the cond logits zc (row b) and, under
// classifier-free guidance, the uncond logits zu (row b + B):
//   lc = max(zc - lse(zc), -70), lu = max(zu - lse(zu), -70),
//   r  = max(ln - lse(ln), -70) with ln = lu + g (lc - lu)   (r = lc at g 1),
//   the analytic absorbing-state posterior from the 10-scalar schedule row,
//   the MASK class (index K-1, no logit) apart, and Gumbel-max over all K
//   classes (the first class on ties; the MASK class only if strictly
//   greater). This is fused_sample_step_reference's order of clamps, the JAX
//   kernel's.
//
// What bounds it on this card: bytes. There is no matrix product; one step
// at the serving shape reads (2B, K-1, L) = (64, 4096, 1024) f32 logits,
// 1.07 GB, and writes (B, L) tokens. Like the TPU kernel, this one reads the
// logits from device memory once:
//   * a block of 256 threads takes one (b, l); its two class rows (each
//     contiguous, 16 KB at K = 4097) go to registers at once, as float4
//     (class c = 4 (j * 256 + tid) + e: C chunks j a thread and branch,
//     C = ceil((K-1) / 1024) exactly, one instantiation for each of 1-8),
//     so a block keeps 32 KB of loads in flight and every pass after the
//     first reads registers, never memory; rows whose address or stride is
//     no multiple of 16 bytes take element loads in the same kernel;
//   * the kernel is bound by latency (the passes' block reductions, and
//     the loads of a block, which nothing inside it overlaps), so
//     residency decides: up to K-1 = 4096 a thread may hold 64 registers
//     (the guided build then spills 8 bytes) and an SM four blocks (128 KB
//     of loads in flight); three blocks an SM at 80 registers, without a
//     spill, or two of 512 threads, measured slower
//     (probes/sampler_codebook_variants.py, VARIANTS), and so did a
//     persistent grid that staged the next (b, l)'s rows by cp.async in
//     shared memory under this one's passes;
//   * each reduction is a maximum first, then a sum of exponentials (no
//     online rescale, one exponential an element and sum), by warp shuffles
//     and then across the 8 warps through shared memory in a fixed order, so
//     that every thread holds the same value;
//   * pass 0 takes both branches' maxima and minima and the maximum of the
//     guided logits zg = zu + g (zc - zu); pass 1 the three sums. Where no
//     class reaches the -70 clamp in either branch (the minima say so), ln
//     is zg shifted by a constant and lse(ln) follows from pass 1's sums
//     (csrc/megakernel_step.cu's tail takes the same rule); otherwise a full
//     guided pass runs;
//   * the posterior's normaliser overwrites the cond logits in registers
//     with q = r - log q(x_t | x_0), and the last pass reads q.
// Transcendentals a (class, position) of a batch row, at guidance != 1,
// sampled: 3 exponentials (pass 1), 1 (normaliser), 1 exponential and 1
// logarithm (the posterior's log-add-exp), 2 logarithms (the Gumbel noise):
// 8, by the special function unit's approximations (relative error ~1e-6:
// they feed a log-sum-exp, noise or a comparison).
//
// Above K-1 = 8192 (kMaxChunks chunks a thread) the two rows no longer
// fit a block's registers, and sample_step_wide_kernel takes them: the same
// passes in the same order, each thread on the same classes (chunk i =
// tid, tid + 256, ...), so that every reduction adds the same terms in the
// same order as a register kernel with that many chunks would. The rows
// are staged in shared memory by cp.async (16-byte copies where the rows
// allow them, all of a block's copies in flight together) where both fit
// a block (K-1 up to 28,896 under guidance at the card's 227 KB), else
// every pass re-reads them from device memory, where L2 holds a block's
// rows between its passes (256 KB at K-1 = 32,768). No pass writes the
// rows: the normaliser's q is recomputed from them in the last pass (the
// same operations, so the same values). One block an SM at K-1 = 16,384
// (128 KB of shared memory), so this design is bound by each block's
// latency, not by bytes.
//
// Random draws: Philox4x32-10 keyed by the step's seed (low, high 32 bits),
// counter (class / 4, position, batch row, 0), the four words for the four
// classes of a float4 chunk; the MASK class draws word 0 of counter
// (0xFFFFFFFF, position, batch row, 0). No counter wraps at any B, K or L
// the kernel takes, and the noise of a class does not depend on which thread
// draws it (csrc/megakernel_step.cu draws the same).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 8;   // the register design: K-1 <= 4 * 256 * 8
constexpr float kNeg30 = -69.07755278982137f;   // log(1e-30)
constexpr float kClamp = -70.f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const float* logits;        // class-contiguous rows
  long long sb, sl;           // batch-row and position strides, elements
  const long long* tokens;    // (B, L)
  const float* sched;         // (10,)
  long long* out;             // (B, L)
  float* post;                // (B, K, L) or null
  int B, L, kv;               // kv = K - 1 classes with a logit
  unsigned seed_lo, seed_hi;
  float guidance;
  int sample;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// csrc/megakernel_step.cu's rounds, each product's two halves from one
// 32 x 32 -> 64-bit multiply
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned long long p0 = 0xD2511F53ull * c.x;
    const unsigned long long p1 = 0xCD9E8D57ull * c.z;
    const unsigned hi0 = static_cast<unsigned>(p0 >> 32),
                   lo0 = static_cast<unsigned>(p0);
    const unsigned hi1 = static_cast<unsigned>(p1 >> 32),
                   lo1 = static_cast<unsigned>(p1);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ float gumbel_of(unsigned bits) {
  const float u = static_cast<float>(bits >> 8) * (1.f / 16777216.f);
  return -__logf(-__logf(u + 1e-30f) + 1e-30f);
}

__device__ __forceinline__ float laddexp(float a, float b) {
  const float m = fmaxf(a, b);
  return m + logf(expf(a - m) + expf(b - m));
}

// N values reduced over the block by max (MAX) or sum; every thread returns
// the same values. red: kWarps * N floats of shared memory that no other
// reduction between two barriers uses.
template <int N, bool MAX>
__device__ __forceinline__ void block_reduce(float (&v)[N], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v[i], off);
      v[i] = MAX ? fmaxf(v[i], o) : v[i] + o;
    }
    if (lane == 0) red[warp * N + i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float r = red[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      r = MAX ? fmaxf(r, red[w * N + i]) : r + red[w * N + i];
    v[i] = r;
  }
}

// the larger score, and on a tie the smaller class
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <bool VEC>
__device__ __forceinline__ void load_chunk(const float* row, int c0, int kv,
                                           float (&z)[4]) {
  if (VEC && c0 + 3 < kv) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(row + c0));
    z[0] = v.x;
    z[1] = v.y;
    z[2] = v.z;
    z[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) z[e] = c0 + e < kv ? __ldcs(row + c0 + e) : 0.f;
  }
}

// whether class 4 (j kThreads + tid) + e has a logit: every chunk but the
// last of a thread is whole, since the launcher takes C = ceil(kv / (4
// kThreads)) exactly (the test on the last chunk alone is what keeps the
// kernel near its bound)
template <int C>
__device__ __forceinline__ bool has_logit(int j, int e, int kv) {
  return j < C - 1 || 4 * (j * kThreads + static_cast<int>(threadIdx.x)) + e < kv;
}

// C float4 chunks a thread and branch; CFG: two branches; VEC: 16-byte loads
template <int C, bool CFG, bool VEC>
__global__ void __launch_bounds__(kThreads, C <= 4 ? 4 : 2)
sample_step_kernel(const Params p) {
  __shared__ float red[8][kWarps * 5];
  const int l = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int kv = p.kv;
  const float g = p.guidance;
  const float* rc = p.logits + static_cast<long long>(b) * p.sb +
                    static_cast<long long>(l) * p.sl;
  const float* ru = rc + static_cast<long long>(p.B) * p.sb;

  // the two rows, read once
  float zc[C][4], zu[C][4];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int c0 = 4 * (j * kThreads + tid);
    load_chunk<VEC>(rc, c0, kv, zc[j]);
    if constexpr (CFG) load_chunk<VEC>(ru, c0, kv, zu[j]);
  }

  // pass 0: maxima of zc, zu, zg and minima of zc, zu (as maxima of -z)
  constexpr int N0 = CFG ? 5 : 1;
  float mx[N0];
#pragma unroll
  for (int i = 0; i < N0; ++i) mx[i] = -INFINITY;
#pragma unroll
  for (int j = 0; j < C; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!has_logit<C>(j, e, kv)) continue;
      mx[0] = fmaxf(mx[0], zc[j][e]);
      if constexpr (CFG) {
        mx[1] = fmaxf(mx[1], zu[j][e]);
        mx[2] = fmaxf(mx[2], fmaf(g, zc[j][e] - zu[j][e], zu[j][e]));
        mx[3] = fmaxf(mx[3], -zc[j][e]);
        mx[4] = fmaxf(mx[4], -zu[j][e]);
      }
    }
  block_reduce<N0, true>(mx, red[0]);

  // pass 1: the sums of exponentials under those maxima, as 2^(z log2 e -
  // m log2 e): one FMA and one ex2 an exponential
  constexpr int N1 = CFG ? 3 : 1;
  float s[N1], sh[N1];
#pragma unroll
  for (int i = 0; i < N1; ++i) {
    s[i] = 0.f;
    sh[i] = -mx[i] * kLog2e;
  }
#pragma unroll
  for (int j = 0; j < C; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!has_logit<C>(j, e, kv)) continue;
      s[0] += ex2(fmaf(zc[j][e], kLog2e, sh[0]));
      if constexpr (CFG) {
        s[1] += ex2(fmaf(zu[j][e], kLog2e, sh[1]));
        s[2] += ex2(fmaf(fmaf(g, zc[j][e] - zu[j][e], zu[j][e]), kLog2e,
                         sh[2]));
      }
    }
  block_reduce<N1, false>(s, red[1]);
  const float lse_c = logf(s[0]) + mx[0];
  float lse_u = 0.f, lse_n = 0.f;
  if constexpr (CFG) {
    lse_u = logf(s[1]) + mx[1];
    // no class under the clamp in either branch: ln = zg - (lse_u + g
    // (lse_c - lse_u)), so lse(ln) follows from lse(zg)
    if (-mx[3] - lse_c >= kClamp && -mx[4] - lse_u >= kClamp) {
      lse_n = (logf(s[2]) + mx[2]) - (lse_u + g * (lse_c - lse_u));
    } else {
      float m[1] = {-INFINITY}, t[1] = {0.f};
#pragma unroll
      for (int j = 0; j < C; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!has_logit<C>(j, e, kv)) continue;
          const float lc = fmaxf(zc[j][e] - lse_c, kClamp);
          const float lu = fmaxf(zu[j][e] - lse_u, kClamp);
          m[0] = fmaxf(m[0], fmaf(g, lc - lu, lu));
        }
      block_reduce<1, true>(m, red[2]);
      const float shn = -m[0] * kLog2e;
#pragma unroll
      for (int j = 0; j < C; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!has_logit<C>(j, e, kv)) continue;
          const float lc = fmaxf(zc[j][e] - lse_c, kClamp);
          const float lu = fmaxf(zu[j][e] - lse_u, kClamp);
          t[0] += ex2(fmaf(fmaf(g, lc - lu, lu), kLog2e, shn));
        }
      block_reduce<1, false>(t, red[3]);
      lse_n = logf(t[0]) + m[0];
    }
  }

  // the schedule row and x_t: log q(x_t | x_0 = class) is qt_v at the
  // token's class, else ct_ct (x_t masked; the MASK token is no class here)
  // or ct_bt; log q(x_t | x_{t-1}) alike
  const float* sr = p.sched;
  const float s6 = sr[6], s7 = sr[7], s8 = sr[8], s9 = sr[9];
  const float qt_v = laddexp(sr[0], sr[1]), qt1_v = laddexp(sr[3], sr[4]);
  const size_t pos = static_cast<size_t>(b) * p.L + l;
  const int tok = static_cast<int>(p.tokens[pos]);
  const bool is_mask = tok == kv;
  const float qt_o = is_mask ? sr[2] : sr[1], qt1_o = is_mask ? sr[5] : sr[4];

  // the posterior's normaliser: q = r - log q(x_t | x_0) replaces zc
  float mq[1] = {kNeg30};
#pragma unroll
  for (int j = 0; j < C; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int cls = 4 * (j * kThreads + tid) + e;
      float r = fmaxf(zc[j][e] - lse_c, kClamp);
      if constexpr (CFG) {
        const float lu = fmaxf(zu[j][e] - lse_u, kClamp);
        r = fmaxf(fmaf(g, r - lu, lu) - lse_n, kClamp);
      }
      zc[j][e] = r - (cls == tok ? qt_v : qt_o);
      if (has_logit<C>(j, e, kv)) mq[0] = fmaxf(mq[0], zc[j][e]);
    }
  block_reduce<1, true>(mq, red[4]);
  float sq[1] = {0.f};
  const float shq = -mq[0] * kLog2e;
#pragma unroll
  for (int j = 0; j < C; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (has_logit<C>(j, e, kv)) sq[0] += ex2(fmaf(zc[j][e], kLog2e, shq));
  block_reduce<1, false>(sq, red[5]);
  // the MASK class's log(1e-30) term joins the sum once
  const float lse_q = logf(sq[0] + expf(kNeg30 - mq[0])) + mq[0];

  // the posterior, the noise and the argmax over the K-1 classes:
  // post = log(e^a + e^ct_bt') + log q(x_t | x_{t-1}) + lse_q with
  // a = q - lse_q + ct_at', one ex2 and one lg2 a class
  const float a0 = s6 - lse_q;
  const uint2 key = make_uint2(p.seed_lo, p.seed_hi);
  float best = -INFINITY;
  int best_i = 0;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int blk = j * kThreads + tid;
    if (!has_logit<C>(j, 0, kv)) continue;
    uint4 rnd = make_uint4(0u, 0u, 0u, 0u);
    if (p.sample)
      rnd = philox4x32_10(make_uint4(static_cast<unsigned>(blk),
                                     static_cast<unsigned>(l),
                                     static_cast<unsigned>(b), 0u), key);
    const unsigned bits[4] = {rnd.x, rnd.y, rnd.z, rnd.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!has_logit<C>(j, e, kv)) continue;
      const int cls = 4 * blk + e;
      const float av = zc[j][e] + a0;
      const float lg = lg2(1.f + ex2(-fabsf(av - s7) * kLog2e));
      float post = fmaf(lg, kLn2, fmaxf(av, s7) +
                                      (cls == tok ? qt1_v : qt1_o) + lse_q);
      post = fminf(fmaxf(post, kClamp), 0.f);
      if (p.post != nullptr)
        p.post[(static_cast<size_t>(b) * (kv + 1) + cls) * p.L + l] = post;
      if (p.sample) post += gumbel_of(bits[e]);
      if (post > best) {
        best = post;
        best_i = cls;
      }
    }
  }
  // the block's argmax, ties to the smaller class
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
    if (better(ob, oi, best, best_i)) {
      best = ob;
      best_i = oi;
    }
  }
  float* rv = red[6];
  int* ri = reinterpret_cast<int*>(red[7]);
  if ((tid & 31) == 0) {
    rv[tid >> 5] = best;
    ri[tid >> 5] = best_i;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w)
      if (better(rv[w], ri[w], best, best_i)) {
        best = rv[w];
        best_i = ri[w];
      }
    float pm = laddexp(kNeg30 - lse_q + s9, s8) + (is_mask ? 0.f : kNeg30) +
               lse_q;
    pm = fminf(fmaxf(pm, kClamp), 0.f);
    if (p.post != nullptr)
      p.post[(static_cast<size_t>(b) * (kv + 1) + kv) * p.L + l] = pm;
    if (p.sample)
      pm += gumbel_of(philox4x32_10(
          make_uint4(0xFFFFFFFFu, static_cast<unsigned>(l),
                     static_cast<unsigned>(b), 0u), key).x);
    p.out[pos] = pm > best ? kv : best_i;
  }
}

// where the wide kernel reads its rows from: 0 = shared memory (rows
// staged once), 1 = device memory (every pass)
enum RowsIn { kShared = 0, kDevice = 1 };

// float4 chunk i (classes 4 i .. 4 i + 3, zero past kv) of a row
template <bool VEC, int IN>
__device__ __forceinline__ void wide_chunk(const float* row,
                                           const float4* staged, int i,
                                           int kv, float (&z)[4]) {
  if constexpr (IN == kShared) {
    const float4 v = staged[i];
    z[0] = v.x;
    z[1] = v.y;
    z[2] = v.z;
    z[3] = v.w;
  } else {
    const int c0 = 4 * i;
    if (VEC && c0 + 3 < kv) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(row + c0));
      z[0] = v.x;
      z[1] = v.y;
      z[2] = v.z;
      z[3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) z[e] = c0 + e < kv ? __ldg(row + c0 + e) : 0.f;
    }
  }
}

// a row's kv4 float4 chunks into shared memory (zero past kv): 16-byte
// cp.async where the row allows it, element copies for the rest
template <bool VEC>
__device__ __forceinline__ void stage_row(float4* dst, const float* row,
                                          int kv, int kv4) {
  for (int i = threadIdx.x; i < kv4; i += kThreads) {
    const int c0 = 4 * i;
    if (VEC && c0 + 3 < kv) {
      const unsigned d =
          static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(row + c0));
    } else {
      float z[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) z[e] = c0 + e < kv ? row[c0 + e] : 0.f;
      dst[i] = make_float4(z[0], z[1], z[2], z[3]);
    }
  }
}

// K-1 above the register design's 8192 (the header); CFG, VEC as
// sample_step_kernel; IN: where the rows are read from. Dynamic shared
// memory: the staged rows, (CFG ? 2 : 1) kv4 float4 (IN == kShared).
template <bool CFG, bool VEC, int IN>
__global__ void __launch_bounds__(kThreads)
sample_step_wide_kernel(const Params p) {
  extern __shared__ float4 rows4[];
  __shared__ float red[8][kWarps * 5];
  const int l = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int kv = p.kv, kv4 = (kv + 3) / 4;
  const float g = p.guidance;
  const float* rc = p.logits + static_cast<long long>(b) * p.sb +
                    static_cast<long long>(l) * p.sl;
  const float* ru = rc + static_cast<long long>(p.B) * p.sb;
  const float4* sc = rows4;
  const float4* su = rows4 + kv4;
  if constexpr (IN == kShared) {
    stage_row<VEC>(rows4, rc, kv, kv4);
    if constexpr (CFG) stage_row<VEC>(rows4 + kv4, ru, kv, kv4);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  // chunk i of both rows
  auto chunk = [&](int i, float (&zc)[4], float (&zu)[4]) {
    wide_chunk<VEC, IN>(rc, sc, i, kv, zc);
    if constexpr (CFG) wide_chunk<VEC, IN>(ru, su, i, kv, zu);
  };

  // pass 0: maxima of zc, zu, zg and minima of zc, zu (as maxima of -z)
  constexpr int N0 = CFG ? 5 : 1;
  float mx[N0];
#pragma unroll
  for (int i = 0; i < N0; ++i) mx[i] = -INFINITY;
  for (int i = tid; i < kv4; i += kThreads) {
    float zc[4], zu[4];
    chunk(i, zc, zu);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (4 * i + e >= kv) continue;
      mx[0] = fmaxf(mx[0], zc[e]);
      if constexpr (CFG) {
        mx[1] = fmaxf(mx[1], zu[e]);
        mx[2] = fmaxf(mx[2], fmaf(g, zc[e] - zu[e], zu[e]));
        mx[3] = fmaxf(mx[3], -zc[e]);
        mx[4] = fmaxf(mx[4], -zu[e]);
      }
    }
  }
  block_reduce<N0, true>(mx, red[0]);

  // pass 1: the sums of exponentials under those maxima
  constexpr int N1 = CFG ? 3 : 1;
  float s[N1], sh[N1];
#pragma unroll
  for (int i = 0; i < N1; ++i) {
    s[i] = 0.f;
    sh[i] = -mx[i] * kLog2e;
  }
  for (int i = tid; i < kv4; i += kThreads) {
    float zc[4], zu[4];
    chunk(i, zc, zu);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (4 * i + e >= kv) continue;
      s[0] += ex2(fmaf(zc[e], kLog2e, sh[0]));
      if constexpr (CFG) {
        s[1] += ex2(fmaf(zu[e], kLog2e, sh[1]));
        s[2] += ex2(fmaf(fmaf(g, zc[e] - zu[e], zu[e]), kLog2e, sh[2]));
      }
    }
  }
  block_reduce<N1, false>(s, red[1]);
  const float lse_c = logf(s[0]) + mx[0];
  float lse_u = 0.f, lse_n = 0.f;
  if constexpr (CFG) {
    lse_u = logf(s[1]) + mx[1];
    if (-mx[3] - lse_c >= kClamp && -mx[4] - lse_u >= kClamp) {
      lse_n = (logf(s[2]) + mx[2]) - (lse_u + g * (lse_c - lse_u));
    } else {
      float m[1] = {-INFINITY}, t[1] = {0.f};
      for (int i = tid; i < kv4; i += kThreads) {
        float zc[4], zu[4];
        chunk(i, zc, zu);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (4 * i + e >= kv) continue;
          const float lc = fmaxf(zc[e] - lse_c, kClamp);
          const float lu = fmaxf(zu[e] - lse_u, kClamp);
          m[0] = fmaxf(m[0], fmaf(g, lc - lu, lu));
        }
      }
      block_reduce<1, true>(m, red[2]);
      const float shn = -m[0] * kLog2e;
      for (int i = tid; i < kv4; i += kThreads) {
        float zc[4], zu[4];
        chunk(i, zc, zu);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (4 * i + e >= kv) continue;
          const float lc = fmaxf(zc[e] - lse_c, kClamp);
          const float lu = fmaxf(zu[e] - lse_u, kClamp);
          t[0] += ex2(fmaf(fmaf(g, lc - lu, lu), kLog2e, shn));
        }
      }
      block_reduce<1, false>(t, red[3]);
      lse_n = logf(t[0]) + m[0];
    }
  }

  const float* sr = p.sched;
  const float s6 = sr[6], s7 = sr[7], s8 = sr[8], s9 = sr[9];
  const float qt_v = laddexp(sr[0], sr[1]), qt1_v = laddexp(sr[3], sr[4]);
  const size_t pos = static_cast<size_t>(b) * p.L + l;
  const int tok = static_cast<int>(p.tokens[pos]);
  const bool is_mask = tok == kv;
  const float qt_o = is_mask ? sr[2] : sr[1], qt1_o = is_mask ? sr[5] : sr[4];
  // q = r - log q(x_t | x_0) of chunk i, as the register kernel's
  // normaliser computes it
  auto qchunk = [&](int i, float (&q)[4]) {
    float zc[4], zu[4];
    chunk(i, zc, zu);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float r = fmaxf(zc[e] - lse_c, kClamp);
      if constexpr (CFG) {
        const float lu = fmaxf(zu[e] - lse_u, kClamp);
        r = fmaxf(fmaf(g, r - lu, lu) - lse_n, kClamp);
      }
      q[e] = r - (4 * i + e == tok ? qt_v : qt_o);
    }
  };

  float mq[1] = {kNeg30};
  for (int i = tid; i < kv4; i += kThreads) {
    float q[4];
    qchunk(i, q);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * i + e < kv) mq[0] = fmaxf(mq[0], q[e]);
  }
  block_reduce<1, true>(mq, red[4]);
  float sq[1] = {0.f};
  const float shq = -mq[0] * kLog2e;
  for (int i = tid; i < kv4; i += kThreads) {
    float q[4];
    qchunk(i, q);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * i + e < kv) sq[0] += ex2(fmaf(q[e], kLog2e, shq));
  }
  block_reduce<1, false>(sq, red[5]);
  const float lse_q = logf(sq[0] + expf(kNeg30 - mq[0])) + mq[0];

  const float a0 = s6 - lse_q;
  const uint2 key = make_uint2(p.seed_lo, p.seed_hi);
  float best = -INFINITY;
  int best_i = 0;
  for (int i = tid; i < kv4; i += kThreads) {
    float q[4];
    qchunk(i, q);
    uint4 rnd = make_uint4(0u, 0u, 0u, 0u);
    if (p.sample)
      rnd = philox4x32_10(make_uint4(static_cast<unsigned>(i),
                                     static_cast<unsigned>(l),
                                     static_cast<unsigned>(b), 0u), key);
    const unsigned bits[4] = {rnd.x, rnd.y, rnd.z, rnd.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int cls = 4 * i + e;
      if (cls >= kv) continue;
      const float av = q[e] + a0;
      const float lg = lg2(1.f + ex2(-fabsf(av - s7) * kLog2e));
      float post = fmaf(lg, kLn2, fmaxf(av, s7) +
                                      (cls == tok ? qt1_v : qt1_o) + lse_q);
      post = fminf(fmaxf(post, kClamp), 0.f);
      if (p.post != nullptr)
        p.post[(static_cast<size_t>(b) * (kv + 1) + cls) * p.L + l] = post;
      if (p.sample) post += gumbel_of(bits[e]);
      if (post > best) {
        best = post;
        best_i = cls;
      }
    }
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
    if (better(ob, oi, best, best_i)) {
      best = ob;
      best_i = oi;
    }
  }
  float* rv = red[6];
  int* ri = reinterpret_cast<int*>(red[7]);
  if ((tid & 31) == 0) {
    rv[tid >> 5] = best;
    ri[tid >> 5] = best_i;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w)
      if (better(rv[w], ri[w], best, best_i)) {
        best = rv[w];
        best_i = ri[w];
      }
    float pm = laddexp(kNeg30 - lse_q + s9, s8) + (is_mask ? 0.f : kNeg30) +
               lse_q;
    pm = fminf(fmaxf(pm, kClamp), 0.f);
    if (p.post != nullptr)
      p.post[(static_cast<size_t>(b) * (kv + 1) + kv) * p.L + l] = pm;
    if (p.sample)
      pm += gumbel_of(philox4x32_10(
          make_uint4(0xFFFFFFFFu, static_cast<unsigned>(l),
                     static_cast<unsigned>(b), 0u), key).x);
    p.out[pos] = pm > best ? kv : best_i;
  }
}

// the wide kernel's staged rows, bytes: (CFG ? 2 : 1) rows of kv4 float4
inline size_t wide_rows_bytes(int kv, bool cfg) {
  return static_cast<size_t>(cfg ? 2 : 1) * ((kv + 3) / 4) * sizeof(float4);
}

// kShared where the staged rows fit a block's shared memory beside the
// kernel's own, else kDevice; -1 on an error
int wide_rows_in(int kv, bool cfg) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, sample_step_wide_kernel<true, true,
                                                           kShared>) !=
      cudaSuccess)
    return -1;
  return wide_rows_bytes(kv, cfg) + attr.sharedSizeBytes <=
                 static_cast<size_t>(optin)
             ? kShared
             : kDevice;
}

template <bool CFG, bool VEC, int IN>
cudaError_t launch_wide(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.L, p.B);
  const size_t smem = IN == kShared ? wide_rows_bytes(p.kv, CFG) : 0;
  if (IN == kShared) {
    const cudaError_t err = cudaFuncSetAttribute(
        sample_step_wide_kernel<CFG, VEC, IN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  sample_step_wide_kernel<CFG, VEC, IN><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool CFG, bool VEC>
cudaError_t launch_wide(const Params& p, int in, cudaStream_t stream) {
  return in == kShared ? launch_wide<CFG, VEC, kShared>(p, stream)
                       : launch_wide<CFG, VEC, kDevice>(p, stream);
}

// the guided kernel with 16-byte loads for exactly `chunks` chunks
template <int C>
cudaError_t blocks_per_sm(int chunks, int* n) {
  if constexpr (C < kMaxChunks)
    if (chunks > C) return blocks_per_sm<C + 1>(chunks, n);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, sample_step_kernel<C, true, true>, kThreads, 0);
}

template <int C, bool CFG>
cudaError_t launch(const Params& p, bool vec, cudaStream_t stream) {
  const dim3 grid(p.L, p.B);
  if (vec)
    sample_step_kernel<C, CFG, true><<<grid, kThreads, 0, stream>>>(p);
  else
    sample_step_kernel<C, CFG, false><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// the kernel for exactly `chunks` chunks a thread and branch
template <int C>
cudaError_t launch(const Params& p, int chunks, bool cfg, bool vec,
                   cudaStream_t stream) {
  if constexpr (C < kMaxChunks)
    if (chunks > C) return launch<C + 1>(p, chunks, cfg, vec, stream);
  return cfg ? launch<C, true>(p, vec, stream)
             : launch<C, false>(p, vec, stream);
}

}  // namespace

// The largest K-1 the register design takes; above it the wide kernel.
extern "C" int sample_step_register_classes() {
  return 4 * kThreads * kMaxChunks;
}

// Where a step over rows of kv classes keeps them: 0 registers, 1 shared
// memory, 2 device memory (read by every pass); -1 on an error.
extern "C" int sample_step_design(int kv, int use_cfg) {
  if (kv <= sample_step_register_classes()) return 0;
  const int in = wide_rows_in(kv, use_cfg != 0);
  return in < 0 ? -1 : 1 + in;
}

// Blocks an SM holds of the guided kernel with 16-byte loads for rows of
// kv classes (its registers decide), or -1 on an error (or above the
// register design).
extern "C" int sample_step_blocks_per_sm(int kv) {
  if (kv > sample_step_register_classes()) return -1;
  int n = -1;
  const cudaError_t err =
      blocks_per_sm<1>((kv + 4 * kThreads - 1) / (4 * kThreads), &n);
  return err == cudaSuccess ? n : -1;
}

// Returns a cudaError_t: cudaErrorInvalidValue for a shape the kernel does
// not take, else the launch's status. logits: class-contiguous rows, row
// (b, l) at logits + b sb + l sl (uncond rows b + B under CFG); vec: the
// pointer and both strides are multiples of 16 bytes. post: (B, K, L) or
// null. Any kv >= 1: up to sample_step_register_classes() the register
// design, above it the wide kernel.
extern "C" int fused_sample_step(const float* logits, long long sb,
                                 long long sl, const long long* tokens,
                                 const float* sched, long long* out,
                                 float* post, int B, int L, int kv,
                                 int use_cfg, int sample, int vec,
                                 unsigned seed_lo, unsigned seed_hi,
                                 float guidance, void* stream) {
  if (B < 1 || B > 65535 || L < 1 || kv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{logits, sb, sl, tokens, sched, out, post, B, L, kv,
                 seed_lo, seed_hi, guidance, sample};
  const auto s = static_cast<cudaStream_t>(stream);
  if (kv > sample_step_register_classes()) {
    const int in = wide_rows_in(kv, use_cfg != 0);
    if (in < 0) {
      const cudaError_t err = cudaGetLastError();
      return static_cast<int>(err != cudaSuccess ? err : cudaErrorUnknown);
    }
    cudaError_t err;
    if (use_cfg)
      err = vec ? launch_wide<true, true>(p, in, s)
                : launch_wide<true, false>(p, in, s);
    else
      err = vec ? launch_wide<false, true>(p, in, s)
                : launch_wide<false, false>(p, in, s);
    return static_cast<int>(err);
  }
  return static_cast<int>(launch<1>(
      p, (kv + 4 * kThreads - 1) / (4 * kThreads), use_cfg, vec, s));
}
