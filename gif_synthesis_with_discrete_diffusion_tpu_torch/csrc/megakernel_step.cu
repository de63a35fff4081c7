// One whole D3PM reverse step in one kernel launch (Hopper).
//
// Replaces the TPU kernels gif_synthesis_with_discrete_diffusion_tpu/ops/
// megakernel.py: _kernel_packed (both classifier-free-guidance branches of a
// batch row in one program; here megakernel_step_packed_kernel) and _kernel
// (one program per (row, branch); here megakernel_step_branch_kernel), with
// their shared sampler tail _sample_block.
//
// One step: token embedding + positions -> n_layer x [AdaLN -> self-
// attention -> cross-attention over the condition's K/V (or a per-layer bias
// when the condition is one token) -> LN -> GELU2 MLP] -> LN -> logits ->
// log_softmax (x2 under CFG) -> CFG combine -> analytic absorbing-state
// posterior -> (Gumbel-)argmax. It reads the packed weights (bf16 or f32),
// the f32 tables and the (B, L) int64 tokens and writes (B, L) int64 tokens.
// The logits and the posterior stay in registers; the class axis is walked
// in chunks of 64, once per reduction (four passes under CFG, three
// without), each pass recomputing its logits from the (row, 64) hidden tile.
//
// What bounds it: operations. At the serving shape (B=32, L=1024, 19 layers,
// 4096 classes) a step is ~0.5 TFLOP of multiply-adds against ~10 MB of
// inputs. Operands that the TPU kernels round to bf16 (q / sqrt(d), k, v, the
// softmax probabilities after the division by their row sum) are rounded at
// the same places; a product of two bf16 values is exact in f32, so only the
// order of the sums differs. Self-attention, two thirds of the operations,
// runs on the tensor cores through mma.sync in TF32 (which holds a bf16
// exactly) with the tile shapes that fit a head dim of 4 (phase S below);
// every other product is CUDA-core FMAs on f32 registers. What the
// attention phase is short of is instruction slots and the exponential
// unit, not the tensor pipe: three sweeps over the keys cost two exp2 per
// (query, key, head).
//
// Layout. The TPU keeps a row's (L, 64) state in fast memory; a block here
// has 227 KB, and the state of all rows (16 MB at the serving shape) fits
// the 50 MB L2 instead. So the step is one cooperative launch of a
// persistent grid (as many 256-thread blocks as can be co-resident), and per
// layer three phases separated by grid-wide barriers:
//   A  per tile of 64 rows: (layer 0: gather the embedding) AdaLN-LN -> QKV
//      -> q/k/v through bf16 into head-major scratch (R, 16, L, 4);
//   S  per (row-branch, head, 256 queries): a warp per 32 queries, keys
//      staged through shared memory 512 at a time, three sweeps (row
//      maximum, row sum, then exp / sum -> bf16 -> PV: an online rescale
//      would round the probabilities elsewhere), output to scratch;
//   B  per tile of 64 rows: proj + residual -> cross-attention or bias ->
//      LN -> MLP (hidden chunk by hidden chunk) + residual -> hidden state.
// Then the tail per tile. Every small product is one primitive: a (64 x 64)
// activation tile in shared memory times a (64 x 64) weight tile staged
// into shared memory as f32, 4 x 4 outputs a thread.
//
// The two kernels differ in what a tile's 64 rows are. Packed (K3): 32
// tokens of one batch row for both branches, so the embedding is gathered
// once, a weight tile serves both branches, and the tail has both branches'
// hidden states in the same thread. Branch grid (K4): 64 tokens of one
// (row, branch); with two branches the tail's work item reads both
// branches' final hidden states from the scratch and computes both logits.
//
// Random draws: Philox4x32-10 keyed by the step's seed, counter (class / 4,
// position, batch row); the MASK class draws from its own counter.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kC = 64;          // n_embd
constexpr int kH = 16;          // heads (of dim 4)
constexpr int kThreads = 256;
constexpr int kRows = 64;       // rows of a tile work item
constexpr int kLda = 68;        // row stride of an activation tile
constexpr int kQTile = 256;     // queries of an attention work item
constexpr int kKeyTile = 512;   // keys staged at a time
constexpr int kSmemBytes = (2 * kRows * kLda + kC * kC) * 4;
constexpr float kNeg30 = -69.07755278982137f;   // log(1e-30)
constexpr float kClamp = -70.f;
constexpr float kLnEps = 1e-6f;
constexpr float kNegBig = -3.0e38f;
constexpr float kQScale = 0.5f;                 // 1 / sqrt(head dim)

// the pointer and integer tables of the C interface (ops/megakernel.py)
enum Ptr {
  P_SCHED, P_TOKENS, P_OUT, P_ADALN, P_KC, P_VC, P_EMB, P_POS, P_WQKV,
  P_BQKV, P_WPROJ, P_BPROJ, P_WQC, P_BQC, P_WPROJC, P_BPROJC, P_LN2S,
  P_LN2B, P_WFC, P_BFC, P_WPJ, P_BPJ, P_LNOS, P_LNOB, P_WLOG, P_BLOG, P_X,
  P_Q, P_K, P_V, P_O, P_STAMPS
};
enum Int {
  I_B, I_L, I_NBR, I_NLAYER, I_KV, I_SP, I_SVALID, I_HIDDEN, I_WBF16,
  I_SAMPLE, I_CROSSBIAS, I_PACKED, I_SEEDLO, I_SEEDHI
};

struct Params {
  const float* sched;
  const long long* tokens;
  long long* out;
  const float *adaln, *kc, *vc, *emb, *pos;
  const void *wqkv, *wproj, *wq_c, *wproj_c, *wfc, *wpj, *wlog;
  const float *bqkv, *bproj, *bq_c, *bproj_c, *ln2_s, *ln2_b, *bfc, *bpj,
      *lno_s, *lno_b, *blog;
  float* x;
  __nv_bfloat16 *q, *k, *v;
  float* o;
  unsigned long long* stamps;
  int B, L, n_br, n_layer, kv, sp, s_valid, hidden;
  int w_bf16, sample, cross_bias;
  unsigned seed_lo, seed_hi;
  float guidance;
};

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// sum over the 16 lanes that share a tile row
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float laddexp(float a, float b) {
  const float mx = fmaxf(a, b);
  return mx + logf(expf(a - mx) + expf(b - mx));
}

// the rows of a tile work item that this thread owns: row ty + 16 i
struct RowMap {
  int b;        // batch row
  int rb[4];    // row-branch index b * n_br + branch
  int tok[4];   // position
  bool ok[4];   // position < L
};

template <bool PACKED>
__device__ __forceinline__ int tile_items(const Params& p) {
  return PACKED ? p.B * ((p.L + 31) / 32)
                : p.B * p.n_br * ((p.L + kRows - 1) / kRows);
}

template <bool PACKED>
__device__ __forceinline__ RowMap map_rows(const Params& p, int item,
                                           int ty) {
  RowMap m;
  if (PACKED) {
    const int ntile = (p.L + 31) / 32;
    m.b = item / ntile;
    const int t0 = (item % ntile) * 32;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m.rb[i] = m.b * 2 + (i >> 1);
      m.tok[i] = t0 + ty + 16 * (i & 1);
      m.ok[i] = m.tok[i] < p.L;
    }
  } else {
    const int ntile = (p.L + kRows - 1) / kRows;
    const int per = p.n_br * ntile;
    m.b = item / per;
    const int rem = item % per;
    const int br = rem / ntile;
    const int t0 = (rem % ntile) * kRows;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m.rb[i] = m.b * p.n_br + br;
      m.tok[i] = t0 + ty + 16 * i;
      m.ok[i] = m.tok[i] < p.L;
    }
  }
  return m;
}

// stage a (64 x 64) tile of a row-major weight (row stride ld) as f32:
// rows row0.., columns col0.. of which the first ncol exist
__device__ __forceinline__ void load_w(float* Ws, const void* w, int bf16,
                                       size_t base, int ld, int col0,
                                       int ncol) {
  for (int e = threadIdx.x; e < kC * kC; e += kThreads) {
    const int k = e >> 6, c = e & 63;
    float val = 0.f;
    if (c < ncol) {
      const size_t idx = base + static_cast<size_t>(k) * ld + col0 + c;
      val = bf16 ? __bfloat162float(
                       static_cast<const __nv_bfloat16*>(w)[idx])
                 : static_cast<const float*>(w)[idx];
    }
    Ws[e] = val;
  }
}

// acc[i][j] += sum_k As[ty + 16 i][k] * Ws[k][4 tx + j]
__device__ __forceinline__ void gemm64(const float* As, const float* Ws,
                                       int ty, int tx, float (&acc)[4][4]) {
#pragma unroll 2
  for (int k = 0; k < kC; k += 4) {
    float a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 t = ld4(As + (ty + 16 * i) * kLda + k);
      a[i][0] = t.x; a[i][1] = t.y; a[i][2] = t.z; a[i][3] = t.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 w = ld4(Ws + (k + kk) * kC + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(a[i][kk], w.x, acc[i][0]);
        acc[i][1] = fmaf(a[i][kk], w.y, acc[i][1]);
        acc[i][2] = fmaf(a[i][kk], w.z, acc[i][2]);
        acc[i][3] = fmaf(a[i][kk], w.w, acc[i][3]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// (x - mean) * rsqrt(var + eps) of a 64-wide row spread over 16 lanes
__device__ __forceinline__ float4 ln_row(float4 x) {
  const float mu = sum16(x.x + x.y + x.z + x.w) * (1.f / kC);
  const float4 d = make_float4(x.x - mu, x.y - mu, x.z - mu, x.w - mu);
  const float var =
      sum16(d.x * d.x + d.y * d.y + d.z * d.z + d.w * d.w) * (1.f / kC);
  const float r = rsqrtf(var + kLnEps);
  return make_float4(d.x * r, d.y * r, d.z * r, d.w * r);
}

// LN(x) * scale + shift into the thread's slot of an activation tile;
// plus1: the AdaLN form LN(x) * (1 + scale) + shift
__device__ __forceinline__ void store_norm(float* As, int row, int tx,
                                           float4 x, float4 sc, float4 sh,
                                           bool plus1) {
  const float4 n = ln_row(x);
  const float o = plus1 ? 1.f : 0.f;
  *reinterpret_cast<float4*>(As + row * kLda + tx * 4) =
      make_float4(n.x * (o + sc.x) + sh.x, n.y * (o + sc.y) + sh.y,
                  n.z * (o + sc.z) + sh.z, n.w * (o + sc.w) + sh.w);
}

__device__ __forceinline__ float4 bf16x4_to_f32(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* dst, float a,
                                             float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

__device__ __forceinline__ float dot4(const float (&q)[4], float4 k) {
  return fmaf(q[3], k.w, fmaf(q[2], k.z, fmaf(q[1], k.y, q[0] * k.x)));
}

// ---------------------------------------------------------------------------
// phase A: (embedding) -> AdaLN-LN -> QKV -> q/k/v scratch
// ---------------------------------------------------------------------------
template <bool PACKED>
__device__ void phase_qkv(const Params& p, int layer, float* As, float* Ws) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n_items = tile_items<PACKED>(p);
  const float* ada = p.adaln + static_cast<size_t>(layer) * 4 * kC;
  const float4 sc = ld4(ada + tx * 4), sh = ld4(ada + kC + tx * 4);
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const RowMap m = map_rows<PACKED>(p, item, ty);
    float4 xr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m.ok[i]) {
        float* xp =
            p.x + (static_cast<size_t>(m.rb[i]) * p.L + m.tok[i]) * kC +
            tx * 4;
        if (layer != 0) {
          xr[i] = ld4(xp);
        } else {
          if (PACKED && i >= 2) {   // the other branch of the same token
            xr[i] = xr[i & 1];
          } else {
            const long long t =
                p.tokens[static_cast<size_t>(m.b) * p.L + m.tok[i]];
            xr[i] = add4(
                ld4(p.emb + static_cast<size_t>(t) * kC + tx * 4),
                ld4(p.pos + static_cast<size_t>(m.tok[i]) * kC + tx * 4));
          }
          *reinterpret_cast<float4*>(xp) = xr[i];
        }
      }
      store_norm(As, ty + 16 * i, tx, xr[i], sc, sh, true);
    }
    for (int c = 0; c < 3; ++c) {
      __syncthreads();
      load_w(Ws, p.wqkv, p.w_bf16, static_cast<size_t>(layer) * kC * 3 * kC,
             3 * kC, c * kC, kC);
      __syncthreads();
      float acc[4][4];
      zero(acc);
      gemm64(As, Ws, ty, tx, acc);
      const float4 bias =
          ld4(p.bqkv + static_cast<size_t>(layer) * 3 * kC + c * kC + tx * 4);
      __nv_bfloat16* dst = c == 0 ? p.q : (c == 1 ? p.k : p.v);
      const float s = c == 0 ? kQScale : 1.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (m.ok[i])
          store_bf16x4(
              dst + ((static_cast<size_t>(m.rb[i]) * kH + tx) * p.L +
                     m.tok[i]) * 4,
              (acc[i][0] + bias.x) * s, (acc[i][1] + bias.y) * s,
              (acc[i][2] + bias.z) * s, (acc[i][3] + bias.w) * s);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// phase S: self-attention on the tensor cores, one warp per 32 queries
// ---------------------------------------------------------------------------
// q / sqrt(d), k, v and the probabilities are bf16 values, which TF32 holds
// exactly, so a TF32 mma with f32 accumulation computes the same products as
// f32 FMAs. With a head dim of 4, QK^T is mma.m16n8k4 (16 queries x 8 keys,
// contraction 4: no padding). Its accumulator layout (a thread holds keys
// 2t and 2t+1 of rows g and g+8) is, with the keys of a block of 8 taken in
// the order 0 2 4 6 1 3 5 7, the A layout of mma.m16n8k8, so PV follows
// without a shuffle; V fills 4 of its 8 output columns.
__device__ __forceinline__ void mma_qk(float (&d)[4], unsigned a0,
                                       unsigned a1, unsigned b0) {
  asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "f"(0.f));
}

__device__ __forceinline__ void mma_pv(float (&c)[4], unsigned a0,
                                       unsigned a1, unsigned a2, unsigned a3,
                                       unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// max / sum over the 4 lanes that share an accumulator row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// a warp's running softmax state for its two tiles of 16 queries: rows g and
// g + 8 of each tile
struct AttnState {
  float ml[2][2];    // row maximum x log2(e), in the making until sweep 0 ends
  float l[2][2];     // row sum, then its reciprocal
  float acc[2][4];   // P V
};

// One block of 8 keys for the warp's 32 queries. SWEEP 0: row maximum; 1: row
// sum of exp(s - max); 2: exp(s - max) / sum -> bf16 -> P V. MASKED: the
// chunk's last block, of which only the keys below n exist.
template <int SWEEP, bool MASKED>
__device__ __forceinline__ void attn_block(const float* ks, const float* vs,
                                           int kb, int n, int g, int tig,
                                           const unsigned (&qa)[2][2],
                                           AttnState& st) {
  constexpr float kLog2e = 1.4426950408889634f;
  const unsigned kf = __float_as_uint(ks[(kb + g) * 4 + tig]);
  unsigned v0 = 0u, v1 = 0u;
  if (SWEEP == 2) {
    const float2 vv = *reinterpret_cast<const float2*>(
        vs + ((kb >> 1) + tig) * 8 + (g & 3) * 2);
    v0 = g < 4 ? __float_as_uint(vv.x) : 0u;
    v1 = g < 4 ? __float_as_uint(vv.y) : 0u;
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    float s[4];
    mma_qk(s, qa[mt][0], qa[mt][1], kf);
    if (MASKED) {
      if (kb + 2 * tig >= n) s[0] = s[2] = -INFINITY;
      if (kb + 2 * tig + 1 >= n) s[1] = s[3] = -INFINITY;
    }
    if (SWEEP == 0) {
      st.ml[mt][0] = fmaxf(st.ml[mt][0], fmaxf(s[0], s[1]));
      st.ml[mt][1] = fmaxf(st.ml[mt][1], fmaxf(s[2], s[3]));
    } else {
      const float e0 = ex2(fmaf(s[0], kLog2e, -st.ml[mt][0]));
      const float e1 = ex2(fmaf(s[1], kLog2e, -st.ml[mt][0]));
      const float e2 = ex2(fmaf(s[2], kLog2e, -st.ml[mt][1]));
      const float e3 = ex2(fmaf(s[3], kLog2e, -st.ml[mt][1]));
      if (SWEEP == 1) {
        st.l[mt][0] += e0 + e1;
        st.l[mt][1] += e2 + e3;
      } else {
        // exp / sum -> bf16, two at a time; a bf16 is the top half of a TF32
        const __nv_bfloat162 lo =
            __floats2bfloat162_rn(e0 * st.l[mt][0], e1 * st.l[mt][0]);
        const __nv_bfloat162 hi =
            __floats2bfloat162_rn(e2 * st.l[mt][1], e3 * st.l[mt][1]);
        const unsigned ul = *reinterpret_cast<const unsigned*>(&lo);
        const unsigned uh = *reinterpret_cast<const unsigned*>(&hi);
        mma_pv(st.acc[mt], ul << 16, uh << 16, ul & 0xffff0000u,
               uh & 0xffff0000u, v0, v1);
      }
    }
  }
}

// One sweep over all keys of a (row-branch, head): chunks of kKeyTile keys
// staged as f32, ks as [key][4], vs (sweep 2 only) as [key / 2][4][2].
template <int SWEEP>
__device__ __forceinline__ void attn_sweep(const uint2* kg, const uint2* vg,
                                           int L, float* ks, float* vs, int g,
                                           int tig,
                                           const unsigned (&qa)[2][2],
                                           AttnState& st) {
  for (int k0 = 0; k0 < L; k0 += kKeyTile) {
    const int n = min(kKeyTile, L - k0);
    const int n8 = (n + 7) & ~7, nfull = n & ~7;
    __syncthreads();
    for (int j = threadIdx.x; j < n8; j += kThreads) {
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(ks + j * 4) =
          j < n ? bf16x4_to_f32(kg[k0 + j]) : z;
      if (SWEEP == 2) {
        const float4 vv = j < n ? bf16x4_to_f32(vg[k0 + j]) : z;
        float* d = vs + (j >> 1) * 8 + (j & 1);
        d[0] = vv.x; d[2] = vv.y; d[4] = vv.z; d[6] = vv.w;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kb = 0; kb < nfull; kb += 8)
      attn_block<SWEEP, false>(ks, vs, kb, n, g, tig, qa, st);
    if (nfull < n8) attn_block<SWEEP, true>(ks, vs, nfull, n, g, tig, qa, st);
  }
}

__device__ void phase_self_attention(const Params& p, float* ks, float* vs) {
  constexpr float kLog2e = 1.4426950408889634f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int nq = (p.L + kQTile - 1) / kQTile;
  const int n_items = p.B * p.n_br * kH * nq;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int qt = item % nq;
    const int h = (item / nq) % kH;
    const int r = item / (nq * kH);
    const size_t base = (static_cast<size_t>(r) * kH + h) * p.L;
    const uint2* kg = reinterpret_cast<const uint2*>(p.k) + base;
    const uint2* vg = reinterpret_cast<const uint2*>(p.v) + base;
    const unsigned short* qg =
        reinterpret_cast<const unsigned short*>(p.q) + base * 4;
    // this warp's queries: rows q0 + 16 mt + g (+ 8), two tiles of 16
    const int q0 = qt * kQTile + warp * 32;
    unsigned qa[2][2];
    AttnState st;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = q0 + 16 * mt + g + 8 * hf;
        qa[mt][hf] = row < p.L
            ? static_cast<unsigned>(qg[static_cast<size_t>(row) * 4 + tig])
                  << 16
            : 0u;
        st.ml[mt][hf] = -INFINITY;
        st.l[mt][hf] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) st.acc[mt][c] = 0.f;
    }
    attn_sweep<0>(kg, vg, p.L, ks, vs, g, tig, qa, st);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        st.ml[mt][hf] = quad_max(st.ml[mt][hf]) * kLog2e;
    attn_sweep<1>(kg, vg, p.L, ks, vs, g, tig, qa, st);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        st.l[mt][hf] = 1.f / quad_sum(st.l[mt][hf]);
    attn_sweep<2>(kg, vg, p.L, ks, vs, g, tig, qa, st);
    if (tig < 2) {   // output columns 2 tig, 2 tig + 1 of the head's 4
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = q0 + 16 * mt + g + 8 * hf;
          if (row < p.L)
            *reinterpret_cast<float2*>(
                p.o + (static_cast<size_t>(r) * p.L + row) * kC + h * 4 +
                2 * tig) =
                make_float2(st.acc[mt][2 * hf], st.acc[mt][2 * hf + 1]);
        }
    }
  }
  __syncthreads();
}

// cross-attention of one (row, head) over the first s_valid of the
// condition's keys, read from device memory (a warp reads whole rows)
__device__ __forceinline__ float4 cross_attend(const Params& p,
                                               const float* kc,
                                               const float* vc,
                                               const float (&q)[4]) {
  float mx = -INFINITY;
  for (int j = 0; j < p.s_valid; ++j) {
    const float4 k = __ldg(reinterpret_cast<const float4*>(kc + j * kC));
    mx = fmaxf(mx, dot4(q, make_float4(bf16r(k.x), bf16r(k.y), bf16r(k.z),
                                       bf16r(k.w))));
  }
  float l = 0.f;
  for (int j = 0; j < p.s_valid; ++j) {
    const float4 k = __ldg(reinterpret_cast<const float4*>(kc + j * kC));
    l += expf(dot4(q, make_float4(bf16r(k.x), bf16r(k.y), bf16r(k.z),
                                  bf16r(k.w))) - mx);
  }
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < p.s_valid; ++j) {
    const float4 k = __ldg(reinterpret_cast<const float4*>(kc + j * kC));
    const float4 v = __ldg(reinterpret_cast<const float4*>(vc + j * kC));
    const float pj = bf16r(
        expf(dot4(q, make_float4(bf16r(k.x), bf16r(k.y), bf16r(k.z),
                                 bf16r(k.w))) - mx) / l);
    o.x = fmaf(pj, bf16r(v.x), o.x);
    o.y = fmaf(pj, bf16r(v.y), o.y);
    o.z = fmaf(pj, bf16r(v.z), o.z);
    o.w = fmaf(pj, bf16r(v.w), o.w);
  }
  return o;
}

// ---------------------------------------------------------------------------
// phase B: proj + residual -> cross -> LN -> MLP + residual
// ---------------------------------------------------------------------------
template <bool PACKED>
__device__ void phase_mlp(const Params& p, int layer, float* As, float* Hs,
                          float* Ws) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n_items = tile_items<PACKED>(p);
  const size_t lw = static_cast<size_t>(layer) * kC * kC;   // a (C, C) layer
  const size_t lb = static_cast<size_t>(layer) * kC + tx * 4;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const RowMap m = map_rows<PACKED>(p, item, ty);
    float4 xr[4];
    float acc[4][4];
    // attention output -> proj -> residual
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t off =
          (static_cast<size_t>(m.rb[i]) * p.L + m.tok[i]) * kC + tx * 4;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      xr[i] = m.ok[i] ? ld4(p.x + off) : z;
      *reinterpret_cast<float4*>(As + (ty + 16 * i) * kLda + tx * 4) =
          m.ok[i] ? ld4(p.o + off) : z;
    }
    load_w(Ws, p.wproj, p.w_bf16, lw, kC, 0, kC);
    __syncthreads();
    zero(acc);
    gemm64(As, Ws, ty, tx, acc);
    {
      const float4 bias = ld4(p.bproj + lb);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xr[i] = make_float4(xr[i].x + acc[i][0] + bias.x,
                            xr[i].y + acc[i][1] + bias.y,
                            xr[i].z + acc[i][2] + bias.z,
                            xr[i].w + acc[i][3] + bias.w);
    }
    if (p.cross_bias) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xr[i] = add4(xr[i], ld4(p.kc + (static_cast<size_t>(m.rb[i]) *
                                            p.n_layer + layer) * p.sp * kC +
                                tx * 4));
    } else {
      const float* ada = p.adaln + (static_cast<size_t>(layer) * 2 + 1) * 2 * kC;
      const float4 sc = ld4(ada + tx * 4), sh = ld4(ada + kC + tx * 4);
      __syncthreads();   // the proj product has read As and Ws
#pragma unroll
      for (int i = 0; i < 4; ++i)
        store_norm(As, ty + 16 * i, tx, xr[i], sc, sh, true);
      load_w(Ws, p.wq_c, p.w_bf16, lw, kC, 0, kC);
      __syncthreads();
      zero(acc);
      gemm64(As, Ws, ty, tx, acc);
      const float4 bq = ld4(p.bq_c + lb);
      __syncthreads();   // the query product has read As and Ws
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
        if (m.ok[i]) {
          const float q[4] = {bf16r((acc[i][0] + bq.x) * kQScale),
                              bf16r((acc[i][1] + bq.y) * kQScale),
                              bf16r((acc[i][2] + bq.z) * kQScale),
                              bf16r((acc[i][3] + bq.w) * kQScale)};
          const size_t off = (static_cast<size_t>(m.rb[i]) * p.n_layer +
                              layer) * p.sp * kC + tx * 4;
          o = cross_attend(p, p.kc + off, p.vc + off, q);
        }
        *reinterpret_cast<float4*>(As + (ty + 16 * i) * kLda + tx * 4) = o;
      }
      load_w(Ws, p.wproj_c, p.w_bf16, lw, kC, 0, kC);
      __syncthreads();
      zero(acc);
      gemm64(As, Ws, ty, tx, acc);
      const float4 bias = ld4(p.bproj_c + lb);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xr[i] = make_float4(xr[i].x + acc[i][0] + bias.x,
                            xr[i].y + acc[i][1] + bias.y,
                            xr[i].z + acc[i][2] + bias.z,
                            xr[i].w + acc[i][3] + bias.w);
    }
    // LN -> MLP, one chunk of 64 hidden units at a time
    {
      const float4 sc = ld4(p.ln2_s + lb), sh = ld4(p.ln2_b + lb);
      __syncthreads();   // the last product has read As and Ws
#pragma unroll
      for (int i = 0; i < 4; ++i)
        store_norm(As, ty + 16 * i, tx, xr[i], sc, sh, false);
    }
    float out[4][4];
    zero(out);
    for (int c = 0; c < p.hidden / kC; ++c) {
      load_w(Ws, p.wfc, p.w_bf16, static_cast<size_t>(layer) * kC * p.hidden,
             p.hidden, c * kC, kC);
      __syncthreads();
      zero(acc);
      gemm64(As, Ws, ty, tx, acc);
      const float4 bias =
          ld4(p.bfc + static_cast<size_t>(layer) * p.hidden + c * kC + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float hv[4] = {acc[i][0] + bias.x, acc[i][1] + bias.y,
                       acc[i][2] + bias.z, acc[i][3] + bias.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)   // GELU2: h * sigmoid(1.702 h)
          hv[j] = hv[j] / (1.f + expf(-1.702f * hv[j]));
        *reinterpret_cast<float4*>(Hs + (ty + 16 * i) * kLda + tx * 4) =
            make_float4(hv[0], hv[1], hv[2], hv[3]);
      }
      __syncthreads();   // Hs is whole, the fc product has read Ws
      load_w(Ws, p.wpj, p.w_bf16,
             (static_cast<size_t>(layer) * p.hidden + c * kC) * kC, kC, 0, kC);
      __syncthreads();
      gemm64(Hs, Ws, ty, tx, out);
      __syncthreads();   // the product has read Hs and Ws
    }
    const float4 bias = ld4(p.bpj + lb);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (m.ok[i])
        *reinterpret_cast<float4*>(
            p.x + (static_cast<size_t>(m.rb[i]) * p.L + m.tok[i]) * kC +
            tx * 4) =
            make_float4(xr[i].x + out[i][0] + bias.x,
                        xr[i].y + out[i][1] + bias.y,
                        xr[i].z + out[i][2] + bias.z,
                        xr[i].w + out[i][3] + bias.w);
  }
}

// ---------------------------------------------------------------------------
// the tail: LN -> logits -> log_softmax -> CFG -> posterior -> argmax
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ float gumbel_of(unsigned bits) {
  const float u = static_cast<float>(bits >> 8) * (1.f / 16777216.f);
  return -logf(-logf(u + 1e-30f) + 1e-30f);
}

// running log-sum-exp (m, s) over four more values, the valid ones
__device__ __forceinline__ void lse_update(float& m, float& s,
                                           const float (&z)[4],
                                           const bool (&ok)[4]) {
  float mn = m;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (ok[j]) mn = fmaxf(mn, z[j]);
  float add = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (ok[j]) add += expf(z[j] - mn);
  s = s * expf(m - mn) + add;
  m = mn;
}

// combine (m, s) over the 16 lanes of a row; returns log(sum) + max
__device__ __forceinline__ float lse_finish(float m, float s, float m0,
                                            float s0) {
  float mt = m;
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
  mt = fmaxf(mt, m0);
  const float st = sum16(s * expf(m - mt)) + s0 * expf(m0 - mt);
  return logf(st) + mt;
}

// MODE 0: packed tile (32 tokens x 2 branches, 2 tokens a thread);
// MODE 1: branch grid with CFG (64 tokens, cond tile in Hs, uncond in As);
// MODE 2: no CFG (64 tokens, one tile).
template <int MODE>
__device__ void phase_tail(const Params& p, float* As, float* Hs, float* Ws) {
  constexpr int NT = MODE == 0 ? 2 : 4;
  constexpr bool CFG = MODE != 2;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int tile = MODE == 0 ? 32 : kRows;
  const int ntile = (p.L + tile - 1) / tile;
  const int n_items = p.B * ntile;
  const int kv = p.kv;
  const int nchunk = (kv + kC - 1) / kC;
  const float g = p.guidance;
  const float4 sc = ld4(p.lno_s + tx * 4), sh = ld4(p.lno_b + tx * 4);
  const float* s = p.sched;
  const float ct_at = s[0], ct_bt = s[1], ct_ct = s[2], at = s[3], bt = s[4],
              ct = s[5], ct_at_p = s[6], ct_bt_p = s[7], ct_ct_p = s[8],
              om_ct_ct_p = s[9];
  const float qt_v = laddexp(ct_at, ct_bt), qt1_v = laddexp(at, bt);
  const uint2 key = make_uint2(p.seed_lo, p.seed_hi);

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int b = item / ntile;
    const int t0 = (item % ntile) * tile;
    int tok[NT];
    bool ok[NT];
    long long cur[NT];
    __syncthreads();   // the previous item's products have read the tiles
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // row ty + 16 i of the tile(s)
      const int t = t0 + ty + 16 * (MODE == 0 ? (i & 1) : i);
      const bool in = t < p.L;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      if (MODE == 1) {
        const size_t oc = (static_cast<size_t>(b * 2) * p.L + t) * kC + tx * 4;
        const size_t ou = oc + static_cast<size_t>(p.L) * kC;
        store_norm(Hs, ty + 16 * i, tx, in ? ld4(p.x + oc) : z, sc, sh, false);
        store_norm(As, ty + 16 * i, tx, in ? ld4(p.x + ou) : z, sc, sh, false);
      } else {
        const int rb = MODE == 0 ? b * 2 + (i >> 1) : b;
        const size_t off = (static_cast<size_t>(rb) * p.L + t) * kC + tx * 4;
        store_norm(As, ty + 16 * i, tx, in ? ld4(p.x + off) : z, sc, sh,
                   false);
      }
      if (i < NT) {
        tok[i] = t;
        ok[i] = in;
        cur[i] = in ? p.tokens[static_cast<size_t>(b) * p.L + t] : 0;
      }
    }

    // per-token results of the passes
    float lse_c[NT], lse_u[NT], lse_n[NT], lse_q[NT];
    float best[NT];
    int best_i[NT];
    const int n_pass = 4;
    for (int pass = 0; pass < n_pass; ++pass) {
      if (!CFG && pass == 1) continue;
      float m1[NT], s1[NT], m2[NT], s2[NT];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        m1[t] = m2[t] = kNegBig;
        s1[t] = s2[t] = 0.f;
        if (pass == 3) {
          best[t] = -INFINITY;
          best_i[t] = 0;
        }
      }
      for (int c = 0; c < nchunk; ++c) {
        const int c0 = c * kC;
        __syncthreads();
        load_w(Ws, p.wlog, p.w_bf16, 0, kv, c0, min(kC, kv - c0));
        __syncthreads();
        float acc[4][4], acc2[4][4];
        zero(acc);
        gemm64(As, Ws, ty, tx, acc);
        if (MODE == 1) {
          zero(acc2);
          gemm64(Hs, Ws, ty, tx, acc2);
        }
        const int col = c0 + tx * 4;
        bool cv[4];
        float bias[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cv[j] = col + j < kv;
          bias[j] = cv[j] ? p.blog[col + j] : 0.f;
        }
        uint4 rnd = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          // this token's logits: cond zc, uncond zu
          float zc[4], zu[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (MODE == 0) {
              zc[j] = acc[t][j] + bias[j];
              zu[j] = acc[t + 2][j] + bias[j];
            } else if (MODE == 1) {
              zc[j] = acc2[t][j] + bias[j];
              zu[j] = acc[t][j] + bias[j];
            } else {
              zc[j] = acc[t][j] + bias[j];
              zu[j] = 0.f;
            }
          }
          if (pass == 0) {
            lse_update(m1[t], s1[t], zc, cv);
            if (CFG) lse_update(m2[t], s2[t], zu, cv);
            continue;
          }
          // the guided log-probabilities before their normaliser
          float r[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float lc = fmaxf(zc[j] - lse_c[t], kClamp);
            if (CFG) {
              const float lu = fmaxf(zu[j] - lse_u[t], kClamp);
              r[j] = lu + g * (lc - lu);
            } else {
              r[j] = lc;
            }
          }
          if (pass == 1) {
            lse_update(m1[t], s1[t], r, cv);
            continue;
          }
          const bool is_mask = cur[t] == kv;
          float q[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (CFG) r[j] = fmaxf(r[j] - lse_n[t], kClamp);
            const bool is_v = cur[t] == col + j;
            q[j] = r[j] - (is_mask ? ct_ct : (is_v ? qt_v : ct_bt));
          }
          if (pass == 2) {
            lse_update(m1[t], s1[t], q, cv);
            continue;
          }
          if (p.sample)
            rnd = philox4x32_10(
                make_uint4(static_cast<unsigned>(col >> 2),
                           static_cast<unsigned>(tok[t]),
                           static_cast<unsigned>(b), 0u), key);
          const unsigned bits[4] = {rnd.x, rnd.y, rnd.z, rnd.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool is_v = cur[t] == col + j;
            const float qt1 = is_mask ? ct : (is_v ? qt1_v : bt);
            float post = laddexp(q[j] - lse_q[t] + ct_at_p, ct_bt_p) + qt1 +
                         lse_q[t];
            post = fminf(fmaxf(post, kClamp), 0.f);
            if (p.sample) post += gumbel_of(bits[j]);
            if (cv[j] && post > best[t]) {
              best[t] = post;
              best_i[t] = col + j;
            }
          }
        }
      }
      // close the pass: combine the 16 lanes of each token
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        if (pass == 0) {
          lse_c[t] = lse_finish(m1[t], s1[t], kNegBig, 0.f);
          lse_u[t] = CFG ? lse_finish(m2[t], s2[t], kNegBig, 0.f) : 0.f;
        } else if (pass == 1) {
          lse_n[t] = lse_finish(m1[t], s1[t], kNegBig, 0.f);
        } else if (pass == 2) {
          // the MASK class's log(1e-30) term joins the sum once
          lse_q[t] = lse_finish(m1[t], s1[t], kNeg30, 1.f);
        } else {
#pragma unroll
          for (int off = 8; off > 0; off >>= 1) {
            const float ob = __shfl_xor_sync(0xffffffffu, best[t], off);
            const int oi = __shfl_xor_sync(0xffffffffu, best_i[t], off);
            if (ob > best[t] || (ob == best[t] && oi < best_i[t])) {
              best[t] = ob;
              best_i[t] = oi;
            }
          }
          if (tx == 0 && ok[t]) {
            const bool is_mask = cur[t] == kv;
            float pm = laddexp(kNeg30 - lse_q[t] + om_ct_ct_p, ct_ct_p) +
                       (is_mask ? 0.f : kNeg30) + lse_q[t];
            pm = fminf(fmaxf(pm, kClamp), 0.f);
            if (p.sample)
              pm += gumbel_of(philox4x32_10(
                  make_uint4(0xFFFFFFFFu, static_cast<unsigned>(tok[t]),
                             static_cast<unsigned>(b), 0u), key).x);
            p.out[static_cast<size_t>(b) * p.L + tok[t]] =
                pm > best[t] ? kv : best_i[t];
          }
        }
      }
    }
  }
}

__device__ __forceinline__ void stamp(const Params& p, int& i) {
  if (p.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.stamps[i] = t;
  }
  ++i;
}

template <bool PACKED>
__device__ void step_body(const Params& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);
  float* Hs = As + kRows * kLda;
  float* Ws = Hs + kRows * kLda;
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kKeyTile * 4;
  cg::grid_group grid = cg::this_grid();
  int si = 0;
  stamp(p, si);
  for (int layer = 0; layer < p.n_layer; ++layer) {
    phase_qkv<PACKED>(p, layer, As, Ws);
    grid.sync();
    stamp(p, si);
    phase_self_attention(p, ks, vs);
    grid.sync();
    stamp(p, si);
    phase_mlp<PACKED>(p, layer, As, Hs, Ws);
    grid.sync();
    stamp(p, si);
  }
  if (PACKED)
    phase_tail<0>(p, As, Hs, Ws);
  else if (p.n_br == 2)
    phase_tail<1>(p, As, Hs, Ws);
  else
    phase_tail<2>(p, As, Hs, Ws);
  if (p.stamps != nullptr) {   // uniform over the grid
    grid.sync();
    stamp(p, si);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
megakernel_step_packed_kernel(const Params p) { step_body<true>(p); }

__global__ void __launch_bounds__(kThreads, 2)
megakernel_step_branch_kernel(const Params p) { step_body<false>(p); }

// blocks that can be co-resident, per device and kernel; 0 until asked (which
// also raises that device's dynamic shared memory limit for the kernel),
// negative cudaError_t when the device cannot run the kernel
constexpr int kMaxDevices = 64;
int g_grid_cap[kMaxDevices][2] = {};

int grid_cap(int packed) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return -static_cast<int>(cudaErrorInvalidDevice);
  int& cap = g_grid_cap[dev][packed ? 1 : 0];
  if (cap != 0) return cap;
  const void* fn = packed
      ? reinterpret_cast<const void*>(megakernel_step_packed_kernel)
      : reinterpret_cast<const void*>(megakernel_step_branch_kernel);
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                        kSmemBytes);
  if (err != cudaSuccess) return cap = -static_cast<int>(err);
  if (!coop) return cap = -static_cast<int>(cudaErrorNotSupported);
  if (per_sm < 1 || sms < 1)
    return cap = -static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  return cap = per_sm * sms;
}

}  // namespace

// The persistent grid's size on the current device (blocks per SM x SMs),
// or a negative cudaError_t.
extern "C" int megakernel_grid_blocks(int packed) { return grid_cap(packed); }

// One reverse step on `stream`. ptrs, ints and floats are host tables in the
// order of enum Ptr, enum Int and {guidance}. Returns a cudaError_t: a grid
// that cannot be co-resident is refused (a grid-wide barrier would hang).
extern "C" int megakernel_step(const void* const* ptrs, const unsigned* ints,
                               const float* floats, void* stream) {
  Params p;
  p.sched = static_cast<const float*>(ptrs[P_SCHED]);
  p.tokens = static_cast<const long long*>(ptrs[P_TOKENS]);
  p.out = static_cast<long long*>(const_cast<void*>(ptrs[P_OUT]));
  p.adaln = static_cast<const float*>(ptrs[P_ADALN]);
  p.kc = static_cast<const float*>(ptrs[P_KC]);
  p.vc = static_cast<const float*>(ptrs[P_VC]);
  p.emb = static_cast<const float*>(ptrs[P_EMB]);
  p.pos = static_cast<const float*>(ptrs[P_POS]);
  p.wqkv = ptrs[P_WQKV];
  p.bqkv = static_cast<const float*>(ptrs[P_BQKV]);
  p.wproj = ptrs[P_WPROJ];
  p.bproj = static_cast<const float*>(ptrs[P_BPROJ]);
  p.wq_c = ptrs[P_WQC];
  p.bq_c = static_cast<const float*>(ptrs[P_BQC]);
  p.wproj_c = ptrs[P_WPROJC];
  p.bproj_c = static_cast<const float*>(ptrs[P_BPROJC]);
  p.ln2_s = static_cast<const float*>(ptrs[P_LN2S]);
  p.ln2_b = static_cast<const float*>(ptrs[P_LN2B]);
  p.wfc = ptrs[P_WFC];
  p.bfc = static_cast<const float*>(ptrs[P_BFC]);
  p.wpj = ptrs[P_WPJ];
  p.bpj = static_cast<const float*>(ptrs[P_BPJ]);
  p.lno_s = static_cast<const float*>(ptrs[P_LNOS]);
  p.lno_b = static_cast<const float*>(ptrs[P_LNOB]);
  p.wlog = ptrs[P_WLOG];
  p.blog = static_cast<const float*>(ptrs[P_BLOG]);
  p.x = static_cast<float*>(const_cast<void*>(ptrs[P_X]));
  p.q = static_cast<__nv_bfloat16*>(const_cast<void*>(ptrs[P_Q]));
  p.k = static_cast<__nv_bfloat16*>(const_cast<void*>(ptrs[P_K]));
  p.v = static_cast<__nv_bfloat16*>(const_cast<void*>(ptrs[P_V]));
  p.o = static_cast<float*>(const_cast<void*>(ptrs[P_O]));
  p.stamps =
      static_cast<unsigned long long*>(const_cast<void*>(ptrs[P_STAMPS]));
  p.B = static_cast<int>(ints[I_B]);
  p.L = static_cast<int>(ints[I_L]);
  p.n_br = static_cast<int>(ints[I_NBR]);
  p.n_layer = static_cast<int>(ints[I_NLAYER]);
  p.kv = static_cast<int>(ints[I_KV]);
  p.sp = static_cast<int>(ints[I_SP]);
  p.s_valid = static_cast<int>(ints[I_SVALID]);
  p.hidden = static_cast<int>(ints[I_HIDDEN]);
  p.w_bf16 = static_cast<int>(ints[I_WBF16]);
  p.sample = static_cast<int>(ints[I_SAMPLE]);
  p.cross_bias = static_cast<int>(ints[I_CROSSBIAS]);
  p.seed_lo = ints[I_SEEDLO];
  p.seed_hi = ints[I_SEEDHI];
  p.guidance = floats[0];
  const bool packed = ints[I_PACKED] != 0;
  if (p.B < 1 || p.L < 1 || p.n_layer < 1 || p.kv < 1 || p.hidden < kC ||
      p.hidden % kC != 0 || p.s_valid < 1 || p.s_valid > p.sp ||
      (p.n_br != 1 && p.n_br != 2) || (packed && p.n_br != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cap = grid_cap(packed ? 1 : 0);
  if (cap < 0) return -cap;
  const long long tiles =
      packed ? static_cast<long long>(p.B) * ((p.L + 31) / 32)
             : static_cast<long long>(p.B) * p.n_br *
                   ((p.L + kRows - 1) / kRows);
  const long long attn = static_cast<long long>(p.B) * p.n_br * kH *
                         ((p.L + kQTile - 1) / kQTile);
  const long long items = tiles > attn ? tiles : attn;
  const int grid = static_cast<int>(items < cap ? items : cap);
  const void* fn = packed
      ? reinterpret_cast<const void*>(megakernel_step_packed_kernel)
      : reinterpret_cast<const void*>(megakernel_step_branch_kernel);
  void* args[] = {&p};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(kThreads), args, kSmemBytes,
      static_cast<cudaStream_t>(stream)));
}
