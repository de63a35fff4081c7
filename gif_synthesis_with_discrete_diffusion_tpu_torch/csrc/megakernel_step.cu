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
// in chunks of 128, once per reduction (three passes; a fourth under CFG
// where a log-probability falls under the clamp), each pass recomputing its
// logits from the (row, 64) hidden tile.
//
// What bounds it: operations. At the serving shape (B=32, L=1024, 19 layers,
// 4096 classes) a step is ~0.5 TFLOP of multiply-adds against ~10 MB of
// inputs. Every product runs on the tensor cores through mma.sync, and none
// rounds where the TPU kernels do not:
//  - Self-attention (phase S), two thirds of the operations and of the time.
//    q / sqrt(d), k, v and the softmax probabilities (after the division by
//    their row sum) are rounded to bf16 where the TPU kernels round them; a
//    product of two bf16 values is exact in f32, so bf16 mma with f32
//    accumulation differs from the plain version only in the order of the
//    sums. With a head dim of 4 an mma yields only 16 x 8 scores, and the
//    rounding after the division costs a sweep over the keys for the row sum
//    before the sweep for the probabilities, so the phase is short of three
//    things at once: the special function unit (16 ex2 a clock an SM; the
//    row sum and the probabilities each take one exponential per (query,
//    key, head)), mma issue (one QK^T mma per 128 scores, in every sweep)
//    and plain issue slots. What the design does: a quarter of the row
//    sum's exponentials go to a polynomial on the FMA pipe (MK_POLY1 of
//    every 16; 1.75 special-function exponentials per (query, key, head) are
//    left); the sweep for the row maximum is replaced by an upper bound of a
//    query's scores wherever that provably lies near the maximum, and kept
//    where not (shift_by_bound); P V takes the packed bf16 probabilities as
//    they leave the rounding (no unpack); a head's keys and values are
//    staged once for all its queries.
//  - Every other product (phases A and B, the logits) has f32 activations.
//    They are split into two TF32 halves (hi + lo, exact to 2^-21) and both
//    are multiplied by the weight tile (bf16 weights are TF32 values; f32
//    weights are split too), summed in the f32 accumulator: see mma_tile.
//    These phases are bound by mma issue and by what surrounds a product
//    (a block-wide barrier each, the epilogues). With bf16 weights phases A
//    and B take wgmma instead at every width but the serving one (below).
//
// Widths. One library is built per exact (n_embd, head dim): MK_C and MK_D,
// by default 64 and 4. The kernels take every n_embd from 1 to 2048 (the
// JAX kernels' reach: one layer's bf16 weights, 28 n_embd^2 bytes, fill
// their 100 MiB of VMEM near 1935), every head dim that divides it, any MLP
// width, any depth (the weights stream from device memory). In device
// memory an n_embd-wide row (every table, weight and the x / o scratch)
// and an MLP row are padded with zero columns to a multiple of 8 (kC; the
// tables are made so, ops/megakernel.py: storage_width), so that every
// load stays aligned; the padded columns stay exactly zero through every
// phase (zero weights and biases in and out), LayerNorm takes its mean and
// variance over the true n_embd (kCT), and phase A scatters only the true
// columns into the heads.
// A row is walked in chunks of 64 columns (kNCH of them; the last one may
// be part padding), a contraction in 64-deep weight tiles, the MLP in
// chunks of 64 hidden units (the last one ragged). A head's q / k / v are
// padded with zero dims to a multiple of 8 (heads of 1-4: to 4, on the
// head-dim-4 layout); heads wider than 128 walk the output dims of P V in
// chunks of at most 128 (kNOC), each recomputing the scores from the same
// shift and row sum, so every chunk rounds the same bf16 probabilities.
//
// With bf16 weights (what the route packs), at every width but the serving
// one (MK_WG; the units under "#if MK_WG"), every product of phases A and
// B runs on wgmma (wg_product, the units after chunk_product), and a
// tile's activations live in device memory: each block owns two slabs
// (the scratch's act and hact), which hold each activation once split into
// three bf16 planes; TMA brings them and the weights through an mbarrier
// ring, 256 output columns a pass, so that a tile re-reads its activations
// once per pass. Where two blocks share an SM (n_embd up to 64) a pass is
// 128 columns and the tile's planes stay in shared memory (kActShared),
// the MLP's hidden units in hact. The tile keeps its
// 64 rows, so that every epilogue, the packed row order and the tail are
// the shared tile's own. LayerNorm reads a row three times from device
// memory (sum, squares about the mean, output; ln_row's arithmetic, a
// float4 a lane in registers). The residual stream is the hidden state x
// itself: each product's epilogue adds its columns there, as the
// registers' copy does. The MLP's hidden units go whole to hact before its
// projection sums over them; the cross-attention's output waits there
// too. A product's 64-deep stages are each summed from zero and added in
// f32 (the tensor cores' accumulation truncates, and a 2048-deep chain
// lost the lo half's precision).
// With f32 weights the activations stay in shared memory up to n_embd 512
// (the tile As, the code above, on mma.sync). Above it (MK_WIDE; the units
// under "#if MK_WIDE") a tile's 64 rows no longer fit the block beside the
// weight tiles (237,568 B at 520 against 232,448), and a row no longer fits
// a thread's registers for its LayerNorm: the slabs hold f32 chunks (64
// rows x 64 columns), and every product stages its A operand's 64-column
// chunk by cp.async into a 64 x 72 buffer beside the weight tile it meets
// (chunk_product), once per 64 output columns, on mma.sync, as the tail's
// logits are at either type and width (up to 512 from the shared tile).
// Phase S streams keys 16 a tile where two tiles of 32 do not fit (heads
// over ~900 dims), and through one buffer where two of 16 do not (heads
// over ~1800).
//
// The serving width (n_embd 64 in 16 heads of 4) keeps the code written for
// it (MK_SERVING: the units under "#if MK_SERVING" below), which this
// source generalises: the general code compiled at that width (MK_GENERAL=1
// forces it) ran 6-10 % slower on an H100, every phase slower, with phase
// S's own code the same and with the phases compiled as functions of their
// own (MK_NOINLINE) too (PERF.md). Every unit outside those blocks, the
// tables, the small helpers, the sampler's tail helpers, the launch and the
// C interface, is the same code at every width.
//
// Layout. The TPU keeps a row's (L, C) state in fast memory; a block here
// has 227 KB, and the state of all rows goes to device memory instead: at
// the serving shape (16 MB) it fits the 50 MB L2, at n_embd 256 and B = 32
// under CFG (64 MB for x alone) it does not, and moves through HBM. So the
// step is one cooperative launch of a persistent grid (as many 256-thread
// blocks as can be co-resident: two an SM at n_embd 64, one from 96 on),
// and per layer three phases separated by grid-wide barriers:
//   A  per tile of 64 rows: (layer 0: gather the embedding) AdaLN-LN -> QKV
//      -> q/k/v through bf16 into head-major scratch (R, H, L, DS), DS the
//      head dim padded to a multiple of 8 (4 at head dim 4) with zeros, and
//      the largest |k| per (row-branch, head, dim);
//   S  per (row-branch, head): the head's keys and values staged in shared
//      memory as bf16, whole where they fit (every head dim 4 grid, and the
//      wider heads up to the block's shared memory), else streamed in tiles
//      of 64 keys through two cp.async buffers; 256 queries at a time, a
//      warp per 32: the softmax shift, then two sweeps (row sum, then exp /
//      sum -> bf16 -> PV: an online rescale would round the probabilities
//      elsewhere), output to scratch;
//   B  per tile of 64 rows: proj + residual -> cross-attention or bias ->
//      LN -> MLP (hidden chunk by hidden chunk) + residual -> hidden state.
// Then the tail per tile. Every small product is one primitive (mma_tile): a
// (64 x 64) f32 activation tile in shared memory times a (64 x 64 or 128)
// weight tile, the next weight tile copied into a second buffer (bf16
// weights: by cp.async, as they are) while this one is multiplied;
// epilogues (bias, GELU2, residual, log-sum-exp, CFG, posterior, noise,
// argmax) work on the mma accumulator layout and reduce over a row by quad
// shuffles plus a combine across the four warps that share the row.
//
// The two kernels differ in what a tile's 64 rows are in phases A and B.
// Packed (K3): 32 tokens of one batch row for both branches, so the
// embedding is gathered once and a weight tile serves both branches. Branch
// grid (K4): 64 tokens of one (row, branch). The tail is the same for both:
// under CFG a tile is 32 tokens x 2 branches gathered from the hidden state,
// so that one thread holds both branches' logits of a token. Row for row
// both kernels do the same arithmetic in the same order.
//
// Random draws: Philox4x32-10 keyed by the step's seed, counter (class / 4,
// position, batch row); the MASK class draws from its own counter. The noise
// of a class does not depend on which thread or block draws it.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#ifndef MK_C
#define MK_C 64
#endif
#ifndef MK_D
#define MK_D 4
#endif
#if MK_C == 64 && MK_D == 4 && !defined(MK_GENERAL)
#define MK_SERVING 1
#else
#define MK_SERVING 0
#endif
// n_embd above 512: the activations of the products with f32 weights live
// in device memory too (the units under "#if MK_WIDE"; the header's
// "Widths" paragraph)
#if MK_C > 512
#define MK_WIDE 1
#else
#define MK_WIDE 0
#endif
// every width but the serving one: the products of phases A and B with
// bf16 weights run on wgmma (the units under "#if MK_WG"), with the
// attention kernels' wgmma, TMA and mbarrier helpers (mha::wg)
#define MK_WG (!MK_SERVING)
#if MK_WG
#include "mha_wg.cuh"
#endif

namespace cg = cooperative_groups;

namespace {
#if MK_SERVING

constexpr int kC = 64;          // n_embd
constexpr int kH = 16;          // heads (of dim 4)
#else   // MK_SERVING

constexpr int kCT = MK_C;       // n_embd
constexpr int kD = MK_D;        // head dim
constexpr int kH = kCT / kD;    // heads
// the row stride of every n_embd-wide table and scratch: n_embd padded
// with zero columns to a multiple of 8
constexpr int kC = (kCT + 7) / 8 * 8;
#if MK_WIDE
static_assert(kCT <= 2048, "n_embd");
#else
static_assert(kCT >= 1 && kCT <= 512, "n_embd");
#endif
static_assert(kD >= 1 && kCT % kD == 0, "head dim");
#endif  // MK_SERVING
constexpr int kThreads = 256;
constexpr int kRows = 64;       // rows of a tile work item
#if MK_SERVING
constexpr int kLda = 72;        // row stride of an activation tile (8 mod 32)
#elif MK_WIDE
constexpr int kNCH = (kC + 63) / 64;   // 64-column chunks of a row
constexpr int kLdh = 72;               // row stride of a staged 64-wide tile
// the activation tiles are slabs in device memory, 64 rows x kNCH chunks,
// chunk-major (element (r, c) at 4096 (c / 64) + 64 r + c % 64); a product
// stages a slab's 64-column chunk beside each weight tile, row stride kLda
constexpr int kLda = kLdh;
constexpr int kSlabChunk = kRows * 64;
#else   // MK_SERVING
constexpr int kNCH = (kC + 63) / 64;   // 64-column chunks of a row
constexpr int kLda = 64 * kNCH + 8;    // row stride of the activation tile
constexpr int kLdh = 72;               // row stride of the 64-wide tile Hs
constexpr int kSlabChunk = kRows * 64;
#endif  // MK_SERVING
constexpr int kTileBytes = kRows * kLda * 4;
// a staged weight tile of 64 x NB, as 32 rows of NB (k, k + 1) pairs
constexpr int kWBytes = 32 * (2 * 64 + 8) * 4 * 2;   // two of NB = 64
#if MK_SERVING
constexpr int kSmemBytes = 2 * kTileBytes + 2 * kWBytes;
constexpr int kMaxSeq = kSmemBytes / 16;   // phase S holds a head's K and V
#elif MK_WIDE
// two weight tiles, the two staged activation chunks beside them, and the
// tail's table of partial sums (64 rows x 4 warps of float2); one block an
// SM, which takes all of a block's 227 KB for phase S
constexpr int kStepBytes = 2 * kWBytes + 2 * kTileBytes + kRows * 4 * 8;
constexpr int kMinBlocks = 1;
constexpr int kSmemBytes = 232448;
static_assert(kStepBytes <= kSmemBytes, "the tiles fit a block");
#else   // MK_SERVING
constexpr int kStepBytes = kTileBytes + kRows * kLdh * 4 + 2 * kWBytes;
// two blocks an SM where both fit the SM's 228 KB (1 KB a block reserved),
// else one, which may as well take all the 227 KB a block can have (phase S
// stages more keys whole); two blocks take what the wgmma products need
// where that is more: 106 KB (1023 B of alignment, the activations' planes,
// 24 KB, and a ring of two 40 KB stages with their barriers: kActShared,
// kRingStages)
constexpr int kMinBlocks = 2 * (kStepBytes + 1024) <= 233472 ? 2 : 1;
constexpr int kWgPairBytes = 106 * 1024;
constexpr int kSmemBytes =
    kMinBlocks == 1 ? 232448
                    : (kStepBytes > kWgPairBytes ? kStepBytes : kWgPairBytes);
static_assert(kStepBytes <= kSmemBytes, "the tiles fit a block");
static_assert(kMinBlocks == 1 || 2 * (kSmemBytes + 1024) <= 233472,
              "two blocks an SM");
#endif  // MK_SERVING
constexpr float kNeg30 = -69.07755278982137f;   // log(1e-30)
constexpr float kClamp = -70.f;
constexpr float kLnEps = 1e-6f;
constexpr float kNegBig = -3.0e38f;
#if MK_SERVING
constexpr float kQScale = 0.5f;                 // 1 / sqrt(head dim)
#endif  // MK_SERVING
static_assert(32 * (2 * 128 + 8) * 4 <= kWBytes, "a 128-column tile fits");
#if !MK_SERVING
// Phase S. A head's dims in the q/k/v scratch (zero padded); in shared
// memory a key's (or value's) row of kRowS bf16, an odd number of 16-byte
// units, so that 8 rows of a fragment load or an ldmatrix hit distinct
// banks. Heads of 1-4 dims take the head-dim-4 layout (16 bytes a key, K as
// [key][4], V as pairs of keys), staged whole up to kMaxSeq keys; the wider
// heads have no limit (streamed where they do not fit).
constexpr int kDS = kD <= 4 ? 4 : (kD + 7) / 8 * 8;
constexpr int kRowS = kDS == 4 ? 4 : 8 * ((kDS / 8) | 1);
constexpr int kKeyBytes = 4 * kRowS;          // K and V of a key
constexpr int kQ16 = kDS == 4 ? 0 : kDS / 16;  // 16-deep QK^T steps
constexpr int kQ8 = kDS == 4 ? 1 : (kDS % 16) / 8;   // and 8-deep ones
constexpr int kQA = 4 * kQ16 + 2 * kQ8;       // A registers of a 16-query tile
constexpr int kNTV = kDS == 4 ? 1 : kDS / 8;  // PV's 8-dim output tiles
// Heads wider than 128 (kWide) hold neither their queries' A fragments nor
// all of P V's output in registers: the queries are read from the q scratch
// step by step, and P V's output tiles are taken kNTA at a time, in kNOC
// chunks of at most 128 dims, each from a sweep of its own over the keys
constexpr bool kWide = kDS > 128;
constexpr int kNOC = kWide ? (kNTV + 15) / 16 : 1;
constexpr int kNTA = (kNTV + kNOC - 1) / kNOC;
#if MK_WIDE
// keys of a streamed tile: 64, 32 or 16, the most of which two tiles fit,
// through two buffers (the next tile's copy in flight while this one is
// read); heads wider than ~1800 dims, where two tiles of 16 keys do not
// fit, stream tiles of 16 through one buffer (kSBuf)
constexpr int kSKT = 2 * 64 * kKeyBytes <= kSmemBytes   ? 64
                     : 2 * 32 * kKeyBytes <= kSmemBytes ? 32
                                                        : 16;
constexpr int kSBuf = 2 * kSKT * kKeyBytes <= kSmemBytes ? 2 : 1;
#else
// keys of a streamed tile: 64, or 32 where two tiles of 64 do not fit
constexpr int kSKT = 2 * 64 * kKeyBytes <= kSmemBytes ? 64 : 32;
constexpr int kSBuf = 2;
#endif
constexpr int kMaxSeq = kDS == 4 ? kSmemBytes / 16 : 1 << 16;
static_assert(kDS == 4 || kSBuf * kSKT * kKeyBytes <= kSmemBytes,
              "the streamed tiles fit");

// MK_NOINLINE: the phases compiled as functions of their own, each with its
// own register allocation (bit 0 phase A, 1 phase S, 2 phase B, 3 the
// tail); the kernels' parameters then stay in parameter space
// (__grid_constant__), read through the reference the phases take
#ifndef MK_NOINLINE
#define MK_NOINLINE 0
#endif
#if MK_NOINLINE & 1
#define MK_PHASE_A __noinline__
#else
#define MK_PHASE_A
#endif
#if MK_NOINLINE & 2
#define MK_PHASE_S __noinline__
#else
#define MK_PHASE_S
#endif
#if MK_NOINLINE & 4
#define MK_PHASE_B __noinline__
#else
#define MK_PHASE_B
#endif
#if MK_NOINLINE & 8
#define MK_PHASE_T __noinline__
#else
#define MK_PHASE_T
#endif
// (and wherever bf16 weights take wgmma: the TMA copies read the tensor
// maps there)
#if MK_NOINLINE || MK_WG
#define MK_KERNEL_PARAMS const __grid_constant__ Params
#else
#define MK_KERNEL_PARAMS const Params
#endif
#endif  // !MK_SERVING

// the pointer and integer tables of the C interface (ops/megakernel.py)
enum Ptr {
  P_SCHED, P_TOKENS, P_OUT, P_ADALN, P_KC, P_VC, P_EMB, P_POS, P_WQKV,
  P_BQKV, P_WPROJ, P_BPROJ, P_WQC, P_BQC, P_WPROJC, P_BPROJC, P_LN2S,
  P_LN2B, P_WFC, P_BFC, P_WPJ, P_BPJ, P_LNOS, P_LNOB, P_WLOG, P_BLOG, P_X,
  P_Q, P_K, P_V, P_O, P_KMAX, P_STAMPS, P_ACT, P_HACT
};
enum Int {
  I_B, I_L, I_NBR, I_NLAYER, I_KV, I_SP, I_SVALID, I_HIDDEN, I_WBF16,
  I_SAMPLE, I_CROSSBIAS, I_PACKED, I_SEEDLO, I_SEEDHI, I_GRID
};
#if MK_WG
// the tensor maps of the products with bf16 weights (wg_maps): the two
// slabs' bf16 planes and the six weights of phases A and B
enum Map {
  M_ACT, M_HACT, M_WQKV, M_WPROJ, M_WQC, M_WPROJC, M_WFC, M_WPJ, kMaps
};
#endif
#if MK_SERVING

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
  unsigned* kmax;   // (R, 16, 4) bit patterns of max over keys |k|, per layer
  unsigned long long* stamps;
  int B, L, n_br, n_layer, kv, sp, s_valid, hidden;
  int w_bf16, sample, cross_bias;
  unsigned seed_lo, seed_hi;
  float guidance;
};
#else   // MK_SERVING

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
  unsigned* kmax;   // (R, H, D) bit patterns of max over keys |k|, per layer
  unsigned long long* stamps;
  int B, L, n_br, n_layer, kv, sp, s_valid, hidden;
  int w_bf16, sample, cross_bias;
  unsigned seed_lo, seed_hi;
  float guidance;
  float qscale;     // fl32(1 / sqrt(head dim)), rounded once from double
  int keys_whole;   // phase S stages a head's keys whole (else streams them)
#if MK_WG
  // per block: the activation slab and the MLP's, megakernel_slab_floats
  // apiece (slab_floats)
  float *act, *hact;
  // bf16 weights: the TMA copies' tensor maps (enum Map)
  CUtensorMap maps[kMaps];
#endif
};
#endif  // MK_SERVING

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// sum over the 16 lanes that share a row in the row-wise thread layout
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
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

__device__ __forceinline__ float laddexp(float a, float b) {
  const float mx = fmaxf(a, b);
  return mx + logf(expf(a - mx) + expf(b - mx));
}

// ---------------------------------------------------------------------------
// the two thread layouts of a (64-row) tile work item
// ---------------------------------------------------------------------------
// Row-wise (LayerNorm, loads, cross-attention): 16 lanes a row, thread (ty,
// tx) owns columns 4 tx .. 4 tx + 3 of rows ty + 16 i. Accumulator (every
// product and its epilogue): warp (wm, wn) owns rows 32 wm .. + 31 and a
// quarter of the columns; a thread holds columns 2 tig, 2 tig + 1 of each
// 8-column tile for rows 32 wm + 16 mt + 8 hf + g, indexed i = 2 mt + hf.
//
// Which (row-branch, position) a tile row is. Packed (K3): rows 16 j .. 16 j
// + 15 are branch j & 1 of positions t0 + 16 (j >> 1) .., so that a warp's
// two 16-row tiles are the two branches of the same 16 positions. Branch
// grid (K4): 64 positions of one (row, branch).
template <bool PACKED>
__device__ __forceinline__ int tile_items(const Params& p) {
  return PACKED ? p.B * ((p.L + 31) / 32)
                : p.B * p.n_br * ((p.L + kRows - 1) / kRows);
}

template <bool PACKED>
__device__ __forceinline__ void tile_row(const Params& p, int item, int r,
                                         int& b, int& rb, int& tok) {
  if (PACKED) {
    const int ntile = (p.L + 31) / 32;
    b = item / ntile;
    rb = b * 2 + ((r >> 4) & 1);
    tok = (item % ntile) * 32 + (r >> 5) * 16 + (r & 15);
  } else {
    const int ntile = (p.L + kRows - 1) / kRows;
    const int per = p.n_br * ntile;
    b = item / per;
    const int rem = item % per;
    rb = b * p.n_br + rem / ntile;
    tok = (rem % ntile) * kRows + r;
  }
}

// the four rows of a tile that a thread holds in the accumulator layout
struct RowMap {
  int rb[4];    // row-branch index b * n_br + branch
  int tok[4];   // position
  bool ok[4];   // position < L
};

template <bool PACKED>
__device__ __forceinline__ RowMap map_rows(const Params& p, int item, int wm,
                                           int g) {
  RowMap m;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int b;
    tile_row<PACKED>(p, item, 32 * wm + 8 * i + g, b, m.rb[i], m.tok[i]);
    m.ok[i] = m.tok[i] < p.L;
  }
  return m;
}

// ---------------------------------------------------------------------------
// the tile product: (64 x 64) f32 activations x (64 x 32 NT) weights on the
// tensor cores, with no rounding of the activations
// ---------------------------------------------------------------------------
// TF32 holds 11 bits of significand, an f32 24. An activation a is split
// into hi = tf32(a), rounded to nearest, and lo = a - hi (exact in f32) cut
// to 11 bits, so hi + lo misses a by less than 2^-21 |a|. A bf16 weight is a
// TF32 value, so a w = hi w + lo w, two mma.m16n8k8 into the same f32
// accumulator; an f32 weight is split the same way and hi_a lo_w joins (lo_a
// lo_w, at most 2^-21 |a w|, is dropped). The contraction index is permuted
// (slots tig and tig + 4 of an 8-deep step take k = 2 tig and 2 tig + 1, in
// A and B alike), so that an A fragment is one 8-byte load from the
// row-major tile (row stride 72: conflict-free) and the B fragments of an
// 8-deep step come from one ldmatrix.trans of the bf16 weight tile (a
// register holds W[2 tig][n] and W[2 tig + 1][n]; a bf16 is the top half of
// a TF32) or, for f32 weights, from 8-byte loads of a tile staged as rows of
// (k, k + 1) pairs, Ws[(k >> 1) * ldp + 2 n + (k & 1)], ldp = 2 NB + 8.
__device__ __forceinline__ void mma_tf32(float (&c)[4], unsigned a0,
                                         unsigned a1, unsigned a2, unsigned a3,
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// hi: v rounded to TF32 (to nearest, ties away; finite v), lo: what is left,
// cut to TF32. Four integer / float instructions (cvt.rna.tf32.f32 is a
// sequence of five on this card).
__device__ __forceinline__ void split_tf32(float v, unsigned& hi,
                                           unsigned& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) & 0xffffe000u;
}
#if MK_SERVING

// Stage rows 0..63, columns col0 .. col0 + NB - 1 (of which the first ncol
// exist) of a row-major weight (row stride ld, first element at base).
// bf16 weights land as they are, [k][NB + 8] bf16, by 16-byte cp.async
// (scalar stores where a row is not 16-byte aligned or the tile is ragged):
// the copy is in flight while the block multiplies the tile before, and
// sync_staged() publishes it. f32 weights land as f32 in the pair layout.
template <int NB>
__device__ __forceinline__ void stage_w(float* Ws, const void* w, int bf16,
                                        size_t base, int ld, int col0,
                                        int ncol) {
  if (bf16) {
    constexpr int ldw = NB + 8;
    const unsigned short* wb =
        static_cast<const unsigned short*>(w) + base + col0;
    unsigned short* W16 = reinterpret_cast<unsigned short*>(Ws);
    if (ncol == NB && ((ld | col0) & 7) == 0) {
      for (int u = threadIdx.x; u < kC * (NB / 8); u += kThreads) {
        const int n8 = u % (NB / 8), k = u / (NB / 8);
        const unsigned dst = static_cast<unsigned>(
            __cvta_generic_to_shared(W16 + k * ldw + n8 * 8));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                     "l"(wb + static_cast<size_t>(k) * ld + n8 * 8));
      }
    } else {
      for (int e = threadIdx.x; e < kC * NB; e += kThreads) {
        const int k = e / NB, c = e % NB;
        W16[k * ldw + c] =
            c < ncol ? wb[static_cast<size_t>(k) * ld + c] : 0;
      }
    }
  } else {
    constexpr int ldp = 2 * NB + 8;
    const float* wf = static_cast<const float*>(w) + base + col0;
    for (int e = threadIdx.x; e < kC * NB; e += kThreads) {
      const int k = e / NB, c = e % NB;
      Ws[(k >> 1) * ldp + 2 * c + (k & 1)] =
          c < ncol ? wf[static_cast<size_t>(k) * ld + c] : 0.f;
    }
  }
}
#else   // MK_SERVING

// Stage rows 0..63 (of which the first nrow exist; the rest are zero),
// columns col0 .. col0 + NB - 1 (of which the first ncol exist) of a
// row-major weight (row stride ld, first element at base).
// bf16 weights land as they are, [k][NB + 8] bf16, by 16-byte cp.async
// (scalar stores where a row is not 16-byte aligned or the tile is ragged):
// the copy is in flight while the block multiplies the tile before, and
// sync_staged() publishes it. f32 weights land as f32 in the pair layout.
template <int NB>
__device__ __forceinline__ void stage_w(float* Ws, const void* w, int bf16,
                                        size_t base, int ld, int col0,
                                        int ncol, int nrow = 64) {
  if (bf16) {
    constexpr int ldw = NB + 8;
    const unsigned short* wb =
        static_cast<const unsigned short*>(w) + base + col0;
    unsigned short* W16 = reinterpret_cast<unsigned short*>(Ws);
    if (ncol == NB && ((ld | col0) & 7) == 0) {
      for (int u = threadIdx.x; u < 64 * (NB / 8); u += kThreads) {
        const int n8 = u % (NB / 8), k = u / (NB / 8);
        if (k < nrow) {
          const unsigned dst = static_cast<unsigned>(
              __cvta_generic_to_shared(W16 + k * ldw + n8 * 8));
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                       ::"r"(dst),
                       "l"(wb + static_cast<size_t>(k) * ld + n8 * 8));
        } else {
          *reinterpret_cast<uint4*>(W16 + k * ldw + n8 * 8) =
              make_uint4(0u, 0u, 0u, 0u);
        }
      }
    } else {
      for (int e = threadIdx.x; e < 64 * NB; e += kThreads) {
        const int k = e / NB, c = e % NB;
        W16[k * ldw + c] =
            c < ncol && k < nrow ? wb[static_cast<size_t>(k) * ld + c] : 0;
      }
    }
  } else {
    constexpr int ldp = 2 * NB + 8;
    const float* wf = static_cast<const float*>(w) + base + col0;
    for (int e = threadIdx.x; e < 64 * NB; e += kThreads) {
      const int k = e / NB, c = e % NB;
      Ws[(k >> 1) * ldp + 2 * c + (k & 1)] =
          c < ncol && k < nrow ? wf[static_cast<size_t>(k) * ld + c] : 0.f;
    }
  }
}
#endif  // MK_SERVING

// the staged tile (and whatever the block wrote to shared memory) is whole
__device__ __forceinline__ void sync_staged() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// NT 8 x 8 bf16 tiles, transposed: register nt holds (W[k0 + 2 tig][n],
// W[k0 + 2 tig + 1][n]) for n = 8 nt + g of the tile row the lane points at
template <int NT>
__device__ __forceinline__ void ldmatrix_trans(unsigned (&r)[NT],
                                               const unsigned short* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  if (NT == 4)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
        : "=r"(r[0]), "=r"(r[1])
        : "r"(addr));
}
#if MK_SERVING

// acc[mt][nt][2 hf + j] += sum_k As[32 wm + 16 mt + 8 hf + g][k] *
//                                 W[k][8 (NT wn + nt) + 2 tig + j]
template <int NT>
__device__ __forceinline__ void mma_tile(const float* As, const float* Ws,
                                         int w_bf16, float (&acc)[2][NT][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const float* ap = As + (32 * (warp & 1) + g) * kLda + 2 * tig;
  // bf16: the lane's row of the 8 x 8 tiles of an 8-deep step
  const unsigned short* bp16 = reinterpret_cast<const unsigned short*>(Ws) +
                               (lane & 7) * (32 * NT + 8) +
                               8 * NT * (warp >> 1) + 8 * ((lane >> 3) % NT);
  constexpr int ldp = 64 * NT + 8;
  const float* bp = Ws + tig * ldp + (8 * NT * (warp >> 1) + g) * 2;
#pragma unroll 2
  for (int ks = 0; ks < 8; ++ks) {
    unsigned ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float2 v = ld2(ap + (16 * mt + 8 * hf) * kLda + 8 * ks);
        split_tf32(v.x, ah[mt][hf], al[mt][hf]);
        split_tf32(v.y, ah[mt][hf + 2], al[mt][hf + 2]);
      }
    if (w_bf16) {
      unsigned r[NT];
      ldmatrix_trans<NT>(r, bp16 + 8 * ks * (32 * NT + 8));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const unsigned b0 = r[nt] << 16, b1 = r[nt] & 0xffff0000u;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_tf32(acc[mt][nt], al[mt][0], al[mt][1], al[mt][2], al[mt][3],
                   b0, b1);
          mma_tf32(acc[mt][nt], ah[mt][0], ah[mt][1], ah[mt][2], ah[mt][3],
                   b0, b1);
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 w = ld2(bp + 4 * ks * ldp + 16 * nt);
        unsigned b0, b1, l0, l1;
        split_tf32(w.x, b0, l0);
        split_tf32(w.y, b1, l1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_tf32(acc[mt][nt], ah[mt][0], ah[mt][1], ah[mt][2], ah[mt][3],
                   l0, l1);
          mma_tf32(acc[mt][nt], al[mt][0], al[mt][1], al[mt][2], al[mt][3],
                   b0, b1);
          mma_tf32(acc[mt][nt], ah[mt][0], ah[mt][1], ah[mt][2], ah[mt][3],
                   b0, b1);
        }
      }
    }
  }
}
#else   // MK_SERVING

// acc[mt][nt][2 hf + j] += sum_k As[32 wm + 16 mt + 8 hf + g][k] *
//                                 W[k][8 (NT wn + nt) + 2 tig + j],
// k = 0 .. 63 (As: row stride LDA)
template <int NT, int LDA = kLda>
__device__ __forceinline__ void mma_tile(const float* As, const float* Ws,
                                         int w_bf16, float (&acc)[2][NT][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const float* ap = As + (32 * (warp & 1) + g) * LDA + 2 * tig;
  // bf16: the lane's row of the 8 x 8 tiles of an 8-deep step
  const unsigned short* bp16 = reinterpret_cast<const unsigned short*>(Ws) +
                               (lane & 7) * (32 * NT + 8) +
                               8 * NT * (warp >> 1) + 8 * ((lane >> 3) % NT);
  constexpr int ldp = 64 * NT + 8;
  const float* bp = Ws + tig * ldp + (8 * NT * (warp >> 1) + g) * 2;
#pragma unroll 2
  for (int ks = 0; ks < 8; ++ks) {
    unsigned ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float2 v = ld2(ap + (16 * mt + 8 * hf) * LDA + 8 * ks);
        split_tf32(v.x, ah[mt][hf], al[mt][hf]);
        split_tf32(v.y, ah[mt][hf + 2], al[mt][hf + 2]);
      }
    if (w_bf16) {
      unsigned r[NT];
      ldmatrix_trans<NT>(r, bp16 + 8 * ks * (32 * NT + 8));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const unsigned b0 = r[nt] << 16, b1 = r[nt] & 0xffff0000u;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_tf32(acc[mt][nt], al[mt][0], al[mt][1], al[mt][2], al[mt][3],
                   b0, b1);
          mma_tf32(acc[mt][nt], ah[mt][0], ah[mt][1], ah[mt][2], ah[mt][3],
                   b0, b1);
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 w = ld2(bp + 4 * ks * ldp + 16 * nt);
        unsigned b0, b1, l0, l1;
        split_tf32(w.x, b0, l0);
        split_tf32(w.y, b1, l1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_tf32(acc[mt][nt], ah[mt][0], ah[mt][1], ah[mt][2], ah[mt][3],
                   l0, l1);
          mma_tf32(acc[mt][nt], al[mt][0], al[mt][1], al[mt][2], al[mt][3],
                   b0, b1);
          mma_tf32(acc[mt][nt], ah[mt][0], ah[mt][1], ah[mt][2], ah[mt][3],
                   b0, b1);
        }
      }
    }
  }
}
#endif  // MK_SERVING

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[2][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
}
#if MK_SERVING

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

// rows ty + 16 i of Src (a tile in the accumulator layout's own row order)
// through LN into As, all 64 rows
__device__ __forceinline__ void norm_tile(float* As, const float* Src, int ty,
                                          int tx, float4 sc, float4 sh,
                                          bool plus1) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    store_norm(As, ty + 16 * i, tx, ld4(Src + (ty + 16 * i) * kLda + tx * 4),
               sc, sh, plus1);
}

__device__ __forceinline__ float dot4(const float (&q)[4], float4 k) {
  return fmaf(q[3], k.w, fmaf(q[2], k.z, fmaf(q[1], k.y, q[0] * k.x)));
}

// the thread's accumulator-layout values into a tile: row 32 wm + 8 i + g,
// columns 8 (NT wn + nt) + 2 tig, + 1
template <int NT>
__device__ __forceinline__ void store_acc(float* T, const float (&v)[2][NT][4],
                                          int wm, int wn, int g, int tig) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(T + (32 * wm + 16 * mt + 8 * hf + g) * kLda +
                                   8 * (NT * wn + nt) + 2 * tig) =
            make_float2(v[mt][nt][2 * hf], v[mt][nt][2 * hf + 1]);
}

// ---------------------------------------------------------------------------
// phase A: (embedding) -> AdaLN-LN -> QKV -> q/k/v scratch
// ---------------------------------------------------------------------------
template <bool PACKED>
__device__ void phase_qkv(const Params& p, int layer, float* As, float* W0,
                          float* W1) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3, wm = warp & 1, wn = warp >> 1;
  const int n_items = tile_items<PACKED>(p);
  const float* ada = p.adaln + static_cast<size_t>(layer) * 4 * kC;
  const float4 sc = ld4(ada + tx * 4), sh = ld4(ada + kC + tx * 4);
  const size_t wbase = static_cast<size_t>(layer) * kC * 3 * kC;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    float4 prev = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int b, rb, tok;
      tile_row<PACKED>(p, item, ty + 16 * i, b, rb, tok);
      float4 xr = make_float4(0.f, 0.f, 0.f, 0.f);
      if (tok < p.L) {
        float* xp = p.x + (static_cast<size_t>(rb) * p.L + tok) * kC + tx * 4;
        if (layer != 0) {
          xr = ld4(xp);
        } else {
          if (PACKED && (i & 1)) {   // the other branch of the same token
            xr = prev;
          } else {
            const long long t = p.tokens[static_cast<size_t>(b) * p.L + tok];
            xr = add4(ld4(p.emb + static_cast<size_t>(t) * kC + tx * 4),
                      ld4(p.pos + static_cast<size_t>(tok) * kC + tx * 4));
          }
          *reinterpret_cast<float4*>(xp) = xr;
        }
      }
      prev = xr;
      store_norm(As, ty + 16 * i, tx, xr, sc, sh, true);
    }
    stage_w<64>(W0, p.wqkv, p.w_bf16, wbase, 3 * kC, 0, kC);
    sync_staged();
    const RowMap m = map_rows<PACKED>(p, item, wm, g);
    for (int c = 0; c < 3; ++c) {
      // the next tile lands in the other buffer during this product
      if (c < 2)
        stage_w<64>((c & 1) ? W0 : W1, p.wqkv, p.w_bf16, wbase, 3 * kC,
                    (c + 1) * kC, kC);
      float acc[2][2][4];
      zero<2>(acc);
      mma_tile<2>(As, (c & 1) ? W1 : W0, p.w_bf16, acc);
      __nv_bfloat16* dst = c == 0 ? p.q : (c == 1 ? p.k : p.v);
      const float s = c == 0 ? kQScale : 1.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = 8 * (2 * wn + nt) + 2 * tig;
        const float2 bias =
            ld2(p.bqkv + static_cast<size_t>(layer) * 3 * kC + c * kC + col);
        float kmx[2][2] = {{0.f, 0.f}, {0.f, 0.f}};   // [mt][column]
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (m.ok[i]) {
            const __nv_bfloat162 v = __floats2bfloat162_rn(
                (acc[i >> 1][nt][2 * (i & 1)] + bias.x) * s,
                (acc[i >> 1][nt][2 * (i & 1) + 1] + bias.y) * s);
            *reinterpret_cast<__nv_bfloat162*>(
                dst + ((static_cast<size_t>(m.rb[i]) * kH + (col >> 2)) * p.L +
                       m.tok[i]) * 4 + (col & 3)) = v;
            kmx[i >> 1][0] = fmaxf(kmx[i >> 1][0], fabsf(__low2float(v)));
            kmx[i >> 1][1] = fmaxf(kmx[i >> 1][1], fabsf(__high2float(v)));
          }
        if (c == 1) {
          // max over a head's keys of |k| per dim, which bounds a query's
          // scores from above (phase S): the 16 rows of a warp's tile are
          // one row-branch; |x| orders like its bit pattern
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              float v = kmx[mt][j];
#pragma unroll
              for (int off = 4; off < 32; off <<= 1)
                v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
              if (g == 0 && v > 0.f)
                atomicMax(p.kmax + (static_cast<size_t>(m.rb[2 * mt]) * kH +
                                    (col >> 2)) * 4 + (col & 3) + j,
                          __float_as_uint(v));
            }
        }
      }
      sync_staged();
    }
  }
}

// ---------------------------------------------------------------------------
// phase S: self-attention on the tensor cores, one warp per 32 queries
// ---------------------------------------------------------------------------
// q / sqrt(d), k, v and the probabilities are bf16 values and a product of
// two of them is exact in f32, so a bf16 mma with f32 accumulation computes
// what f32 FMAs on the rounded operands would. QK^T is mma.m16n8k8 (16
// queries x 8 keys; the head's 4 dims fill half the contraction, the rest of
// A is zero). Its accumulator layout (keys 2 tig, 2 tig + 1 of rows g and g
// + 8) is, packed to bf16 pairs, the A layout of mma.m16n8k16, so the
// probabilities of two key blocks feed P V without a shuffle or an unpack;
// V fills 4 of its 8 output columns.
__device__ __forceinline__ void mma_qk(float (&d)[4], unsigned a0, unsigned a1,
                                       unsigned b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "f"(0.f));
}
#else   // MK_SERVING

// A weight product's tiles: the rows 0 .. krows - 1 of a row-major weight
// (row stride ld, first element at base), columns col0 .. col0 + ncol - 1
// (ncol <= 64 or 128), in 64-deep tiles: tile i holds rows 64 i .. 64 i +
// 63. w == nullptr: no product.
struct WTile {
  const void* w;
  size_t base;
  int ld, col0, ncol, krows;
};

template <int NB>
__device__ __forceinline__ void stage_tile(float* Ws, const WTile& t, int i,
                                           int wb) {
  stage_w<NB>(Ws, t.w, wb, t.base + static_cast<size_t>(64 * i) * t.ld,
              t.ld, t.col0, t.ncol, min(64, t.krows - 64 * i));
}

// acc += A[:, 0 .. krows) x W over the tiles of t (A's columns 64 i .. 64 i
// + 63 against tile i). On entry tile 0 is staged in the buffer cur names
// and published; each tile's successor (the next tile of t, else `next`'s
// first) is staged into the other buffer while it is multiplied. On return
// the last tile was multiplied and `next` is in flight: the caller runs its
// epilogue, then sync_staged() and flips cur.
#define WB(i) ((i) ? W1 : W0)
#if MK_WIDE
// The tensor cores' f32 accumulation truncates toward zero: a chain of
// mma into one sum drifts by up to an ulp of it a step, and a product
// 2048 deep chains 512 (the MLP's projection up to 2048). So each 64-deep
// tile of a product is summed from zero and added to the product's sum in
// f32, rounded to nearest: at n_embd 2048 the hidden state's RMS distance
// from the plain version fell from 0.18-0.59 of the one-TF32 control's to
// 0.05-0.15 (PERF.md).

// Stage chunk `src` of a slab (64 rows of 64 columns, of which the first
// ncol exist; the rest land as zeros) into a tile of row stride kLdh.
__device__ __forceinline__ void stage_chunk(float* dst, const float* src,
                                            int ncol) {
  for (int u = threadIdx.x; u < kRows * 16; u += kThreads) {
    const int r = u >> 4, c4 = u & 15;
    const unsigned d = static_cast<unsigned>(
        __cvta_generic_to_shared(dst + r * kLdh + 4 * c4));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(d), "l"(src + r * 64 + 4 * c4),
                 "r"(4 * c4 < ncol ? 16 : 0));
  }
}

// The same product where A is a slab in device memory: its chunk i is
// staged beside weight tile i, in the staged-A buffer that goes with the
// weight buffer (two of kRows x kLdh floats after W1). The slab is written
// by the product's caller, so its first chunk is staged on entry (the
// previous product prefetched only the weights) and published with the
// others.
template <int NB, int NT, int LDA = kLda>
__device__ __forceinline__ void chunk_product(const float* A, float* W0,
                                              float* W1, int& cur, int wb,
                                              const WTile& t,
                                              const WTile& next,
                                              float (&acc)[2][NT][4]) {
  float* ab = W1 + kWBytes / 4;
  const int nk = (t.krows + 63) / 64;
  stage_chunk(ab + cur * kRows * kLdh, A, min(64, t.krows));
  sync_staged();
  for (int i = 0; i < nk; ++i) {
    if (i + 1 < nk) {
      stage_tile<NB>(WB(cur ^ 1), t, i + 1, wb);
      stage_chunk(ab + (cur ^ 1) * kRows * kLdh, A + kSlabChunk * (i + 1),
                  min(64, t.krows - 64 * (i + 1)));
    } else if (next.w != nullptr) {
      stage_tile<NB>(WB(cur ^ 1), next, 0, wb);
    }
    float part[2][NT][4];
    zero<NT>(part);
    mma_tile<NT, kLdh>(ab + cur * kRows * kLdh, WB(cur), wb, part);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][nt][c] += part[mt][nt][c];
    if (i + 1 < nk) {
      sync_staged();
      cur ^= 1;
    }
  }
}
#else
template <int NB, int NT, int LDA = kLda>
__device__ __forceinline__ void chunk_product(const float* A, float* W0,
                                              float* W1, int& cur, int wb,
                                              const WTile& t,
                                              const WTile& next,
                                              float (&acc)[2][NT][4]) {
  const int nk = (t.krows + 63) / 64;
  for (int i = 0; i < nk; ++i) {
    if (i + 1 < nk)
      stage_tile<NB>(WB(cur ^ 1), t, i + 1, wb);
    else if (next.w != nullptr)
      stage_tile<NB>(WB(cur ^ 1), next, 0, wb);
    mma_tile<NT, LDA>(A + 64 * i, WB(cur), wb, acc);
    if (i + 1 < nk) {
      sync_staged();
      cur ^= 1;
    }
  }
}
#endif

#if MK_WG

// ---------------------------------------------------------------------------
// the products with bf16 weights: wgmma fed by TMA
// ---------------------------------------------------------------------------
// At every width but the serving one, every product of phases A and B runs
// on wgmma.mma_async: the block's two warpgroups take the tile's 64 rows x
// kWgN columns each of a pass of kPassCols output columns (256; 128 where
// two blocks share an SM), the sums in registers, both operands in shared
// memory.
// The f32 activations are split once, where their slab is written, into
// three bf16 planes: hi = bf16(a), mid = bf16(a - hi), lo = bf16(a - hi -
// mid) (each difference exact in f32), which hold a exactly wherever |a|
// >= 2^-109 (ops/megakernel.py: split3_bf16). A bf16 x bf16
// product is exact in f32, so lo w + mid w + hi w is a w up to the order of
// the sums, three products at the bf16 rate where the TF32 split took two
// at half of it. The weights stay as packed, row-major (k, n): wgmma reads
// them as an MN-major B operand. A plane of a slab of k8 columns (a
// multiple of 8) lies as [column / 8][row][column % 8]
// (ops/megakernel.py: slab_plane_offset), the planes one after another:
// each 64-deep chunk of a plane is 8 KB, already wgmma's K-major core
// matrices (8 rows x 16 bytes; 128 bytes apart along the rows, 1024 along
// the contraction), which one TMA box copies as it lies, in 128-byte
// lines, the three planes at once. A weight tile of 64 rows x kPassCols
// columns comes as boxes of 64 x 64 in TMA's 128-byte swizzle (a row's 128
// bytes a line), the layout wgmma reads as an MN-major operand with that
// swizzle. (Boxes 16 bytes wide, the core matrices' own width, held the
// first build to about half this speed: PERF.md.) Both come through a ring
// of kRingStages slots, a stage each (the three planes' chunk and the
// weight tile beside it), filled by TMA on an mbarrier, thread 0 issuing
// the copies kRingStages - 1 stages ahead; a warp frees a slot once its
// warpgroup's wgmmas on it have retired. Each stage is summed from zero
// and added to the pass's sum in f32 (the split sums above). TMA fills
// what lies past a slab's columns or a weight's rows and columns with
// zeros: the ragged last chunks of n_embd 1000 or of an MLP width.
// ptxas issues a stage's 12 wgmmas one after another, each waited for
// (warning C7510: the step's body, which holds them, is a function the
// kernel calls). Inlining the body into the kernel lifted that and gained
// 7 %, but took nvcc 636-820 s a width and spilled (PERF.md): not kept.
// One product function (wg_product) serves every product, its epilogues
// one switch over what a pass's sums go to (WgOut); as a function of its
// own, not inlined, it ran 2-3 % slower at n_embd 1024 (PERF.md).

// a into its three bf16 planes
__device__ __forceinline__ void split3(float a, __nv_bfloat16 (&s)[3]) {
  s[0] = __float2bfloat16_rn(a);
  const float r = a - __bfloat162float(s[0]);
  s[1] = __float2bfloat16_rn(r);
  s[2] = __float2bfloat16_rn(r - __bfloat162float(s[1]));
}

__device__ __forceinline__ unsigned pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(lo)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16);
}

// columns c .. c + N - 1 (N = 2 or 4, c a multiple of N) of row r, split,
// into the three planes of a slab of k8 columns
template <int N>
__device__ __forceinline__ void store_planes(__nv_bfloat16* slab, int k8,
                                             int r, int c,
                                             const float (&v)[N]) {
  __nv_bfloat16 s[N][3];
#pragma unroll
  for (int i = 0; i < N; ++i) split3(v[i], s[i]);
  const size_t at = (static_cast<size_t>(c >> 3) * kRows + r) * 8 + (c & 7);
  const size_t plane = static_cast<size_t>(k8) * kRows;
#pragma unroll
  for (int pl = 0; pl < 3; ++pl) {
    if constexpr (N == 4)
      *reinterpret_cast<uint2*>(slab + pl * plane + at) =
          make_uint2(pack_bf16(s[0][pl], s[1][pl]),
                     pack_bf16(s[2][pl], s[3][pl]));
    else
      *reinterpret_cast<unsigned*>(slab + pl * plane + at) =
          pack_bf16(s[0][pl], s[1][pl]);
  }
}

// A pass of kPassCols output columns, kWgN a warpgroup: 128 (m64n128k16)
// where a block has the SM to itself; 64 (m64n64k16) where two blocks share
// it (n_embd up to 64, kMinBlocks), so that a ring of two stages fits each
// block's half of the shared memory and a thread's sums its 128 registers.
constexpr int kWgN = kMinBlocks == 2 ? 64 : 128;
constexpr int kPassCols = 2 * kWgN;               // output columns of a pass
constexpr int kPlaneBytes = kRows * 64 * 2;       // a plane's 64-deep chunk
constexpr int kAStage = 3 * kPlaneBytes;
constexpr int kStage = kAStage + 64 * kPassCols * 2;
// Where two blocks share an SM (n_embd up to 64: one 64-deep chunk), the
// tile's activations' planes live in the block's shared memory, not in its
// slab: written there (norm_row, copy_row; 64 columns a plane, those past
// n_embd zero), read there by the products' wgmma, so that neither a round
// trip through device memory nor a TMA copy stands between them, and each
// product's weights are copied before its activations are written
// (wg_prefetch). The MLP's hidden units stay in the slab.
constexpr bool kActShared = kMinBlocks == 2;
constexpr int kActBytes = kActShared ? kAStage : 0;
constexpr int kActK8 = kActShared ? 64 : kC;      // a plane's columns
// the ring's slots: four, or as many as fit (the slots start on a
// 1024-byte boundary of the block's shared memory, after the activations'
// planes; two barriers a slot)
constexpr int kRingFit = (kSmemBytes - 1023 - kActBytes) / (kStage + 16);
constexpr int kRingStages = kRingFit < 4 ? kRingFit : 4;
static_assert(kRingStages >= 2, "the ring fits");

struct Ring {
  unsigned char* act;    // the activations' planes (kActShared)
  unsigned char* base;   // the slots
  uint64_t* full;        // a slot's copies have landed
  uint64_t* empty;       // the block's warps are done with a slot
  int n;                 // stages taken since the ring began
};

// At the start of a phase (its shared memory held phase S's tiles): the
// barriers made anew, and the activations' planes' columns past n_embd
// zeroed (kActShared: their rows of the weights are TMA's zeros, and a
// stale value may be no finite number).
__device__ __forceinline__ Ring ring_begin(unsigned char* smem) {
  smem += (1024 - (mha::smem_addr(smem) & 1023)) & 1023;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kActBytes +
                                               kRingStages * kStage);
  const Ring rg{smem, smem + kActBytes, bars, bars + kRingStages, 0};
  if constexpr (kActShared && kC < 64) {
    // plane pl's columns kC .. 63: its elements from kC * kRows on
    constexpr int pad = (64 - kC) * kRows / 2;    // bf16 pairs a plane
    for (int i = threadIdx.x; i < 3 * pad; i += kThreads)
      reinterpret_cast<unsigned*>(smem)[(i / pad) * (kPlaneBytes / 4) +
                                        kC * kRows / 2 + i % pad] = 0u;
  }
  mha::wg::fence_async();   // the phase before's stores, then TMA's
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRingStages; ++i) {
      mha::wg::mbar_init(rg.full + i, 1);
      mha::wg::mbar_init(rg.empty + i, kThreads / 32);
    }
    mha::wg::mbar_init_fence();
  }
  __syncthreads();
  return rg;
}

// At the end of the phase: every stage taken, the barriers given up.
__device__ __forceinline__ void ring_end(const Ring& rg) {
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < 2 * kRingStages; ++i)
      asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(
                       mha::smem_addr(rg.full + i)) : "memory");
}

// the block's stores to a slab (and to x), seen by the TMA copies that read
// it next
__device__ __forceinline__ void slab_written() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
  __syncthreads();
}

// d (+)= a b, m64n128k16, bf16 from shared memory: a K-major, b MN-major
__device__ __forceinline__ void wg_mma(float (&d)[64], uint64_t a,
                                       uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// the same, m64n64k16
__device__ __forceinline__ void wg_mma(float (&d)[32], uint64_t a,
                                       uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// the two rows of a tile a thread holds in the wgmma accumulator: 16 w +
// 8 hf + g (one row-branch a warp: 16 tokens of one branch, K3; of one
// (row, branch), K4)
struct WgRows {
  int rb[2], tok[2];
  bool ok[2];
};

template <bool PACKED>
__device__ __forceinline__ WgRows wg_rows(const Params& p, int item) {
  const int w = (threadIdx.x >> 5) & 3, g = (threadIdx.x & 31) >> 2;
  WgRows m;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    int b;
    tile_row<PACKED>(p, item, 16 * w + 8 * hf + g, b, m.rb[hf], m.tok[hf]);
    m.ok[hf] = m.tok[hf] < p.L;
  }
  return m;
}

// the first column of accumulator group nt of a pass
__device__ __forceinline__ int wg_col(int pass, int nt) {
  return kPassCols * pass + kWgN * (threadIdx.x >> 7) + 8 * nt +
         2 * (threadIdx.x & 3);
}

// What a product's sums go to (wg_product's epilogue), element by element
// as the shared tile's epilogues (phase_qkv, phase_mlp):
//   E_QKV       + bias, q's scale, bf16 -> the head-major q / k / v scratch,
//               and the largest |k| (a warp's 16 rows are one row-branch);
//   E_RESIDUAL  x += sums + bias (+ the cross-attention bias);
//   E_QUERY     the cross-attention's queries, bf16((sums + bias) q scale),
//               into the tile's rows of the attention output;
//   E_GELU      GELU2(sums + bias) as three planes into the MLP's slab.
enum WgKind { E_QKV, E_RESIDUAL, E_QUERY, E_GELU };
struct WgOut {
  int kind;
  const float* bias;     // E_RESIDUAL: n_embd wide a layer
  int cross_bias;        // E_RESIDUAL: the cross-attention bias too
  float* hact;           // E_GELU: the MLP's slab (p.hidden columns)
};

__device__ __forceinline__ void wg_epilogue(const Params& p, int layer,
                                            const WgRows& m, const WgOut& e,
                                            int pass,
                                            const float (&acc)[kWgN / 2]) {
  const int w = (threadIdx.x >> 5) & 3, g = (threadIdx.x & 31) >> 2;
  const size_t lb = static_cast<size_t>(layer) * kC;
  if (e.kind == E_QKV) {
#pragma unroll
    for (int nt = 0; nt < kWgN / 8; ++nt) {
      // a warp's 8-column group lies inside the product or past it as a
      // whole, and inside one section (kC is a multiple of 8)
      const int col = wg_col(pass, nt);
      if (col >= 3 * kC) break;
      const int sec = col / kC, c = col - sec * kC;
      const bool in = c < kCT;
      const int head = c / kD, dim = c % kD;
      __nv_bfloat16* dst = sec == 0 ? p.q : (sec == 1 ? p.k : p.v);
      const float s = sec == 0 ? p.qscale : 1.f;
      const float2 bias =
          ld2(p.bqkv + static_cast<size_t>(layer) * 3 * kC + col);
      float kmx[2] = {0.f, 0.f};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        if (m.ok[hf]) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              (acc[4 * nt + 2 * hf] + bias.x) * s,
              (acc[4 * nt + 2 * hf + 1] + bias.y) * s);
          const size_t row = static_cast<size_t>(m.rb[hf]) * kH;
          if (in) {
            if constexpr (kD % 2 == 0) {
              *reinterpret_cast<__nv_bfloat162*>(
                  dst + ((row + head) * p.L + m.tok[hf]) * kDS + dim) = v;
            } else {
              dst[((row + head) * p.L + m.tok[hf]) * kDS + dim] =
                  __low2bfloat16(v);
              if (c + 1 < kCT)
                dst[((row + (c + 1) / kD) * p.L + m.tok[hf]) * kDS +
                    (c + 1) % kD] = __high2bfloat16(v);
            }
          }
          kmx[0] = fmaxf(kmx[0], fabsf(__low2float(v)));
          kmx[1] = fmaxf(kmx[1], fabsf(__high2float(v)));
        }
      if (sec == 1) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          float v = kmx[jj];
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
          if (g == 0 && v > 0.f && c + jj < kCT)
            atomicMax(p.kmax + static_cast<size_t>(m.rb[0]) * kCT + c + jj,
                      __float_as_uint(v));
        }
      }
    }
  } else if (e.kind == E_RESIDUAL) {
#pragma unroll
    for (int nt = 0; nt < kWgN / 8; ++nt) {
      const int col = wg_col(pass, nt);
      if (col >= kC) break;
      const float2 bv = ld2(e.bias + lb + col);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if (!m.ok[hf]) continue;
        float2 add = bv;
        if (e.cross_bias) {
          const float2 cb = ld2(p.kc + (static_cast<size_t>(m.rb[hf]) *
                                        p.n_layer + layer) * p.sp * kC +
                                col);
          add.x += cb.x;
          add.y += cb.y;
        }
        float2* xp = reinterpret_cast<float2*>(
            p.x + (static_cast<size_t>(m.rb[hf]) * p.L + m.tok[hf]) * kC +
            col);
        float2 x = *xp;
        x.x += acc[4 * nt + 2 * hf] + add.x;
        x.y += acc[4 * nt + 2 * hf + 1] + add.y;
        *xp = x;
      }
    }
  } else if (e.kind == E_QUERY) {
#pragma unroll
    for (int nt = 0; nt < kWgN / 8; ++nt) {
      const int col = wg_col(pass, nt);
      if (col >= kC) break;
      const float2 bq = ld2(p.bq_c + lb + col);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        if (m.ok[hf])
          *reinterpret_cast<float2*>(
              p.o + (static_cast<size_t>(m.rb[hf]) * p.L + m.tok[hf]) * kC +
              col) =
              make_float2(bf16r((acc[4 * nt + 2 * hf] + bq.x) * p.qscale),
                          bf16r((acc[4 * nt + 2 * hf + 1] + bq.y) *
                                p.qscale));
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < kWgN / 8; ++nt) {
      const int col = wg_col(pass, nt);
      if (col >= p.hidden) break;
      const float2 bias =
          ld2(p.bfc + static_cast<size_t>(layer) * p.hidden + col);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {   // GELU2: h * sigmoid(1.702 h)
          const float hv = acc[4 * nt + 2 * hf + j] + (j ? bias.y : bias.x);
          v[j] = hv / (1.f + expf(-1.702f * hv));
        }
        store_planes<2>(reinterpret_cast<__nv_bfloat16*>(e.hact), p.hidden,
                        16 * w + 8 * hf + g, col, v);
      }
    }
  }
}

// (thread 0) stage t of a product whose stages start at the ring's stage
// j0 (pass t / nk, rows 64 (t % nk) ..): into its slot once the warps are
// done with the stage that held it before; the activations' chunk by TMA
// unless it lies in shared memory (kActShared), the weight tile's
// kPassCols / 64 boxes beside it
__device__ __forceinline__ void wg_issue(const Params& p, const Ring& rg,
                                         int amap, int wmap, int layer,
                                         int nk, int j0, int t) {
  namespace wg = mha::wg;
  const int j = j0 + t, slot = j % kRingStages, use = j / kRingStages;
  const bool a_shared = kActShared && amap == M_ACT;
  if (use > 0) wg::mbar_wait(rg.empty + slot, (use - 1) & 1);
  unsigned char* st = rg.base + slot * kStage;
  wg::mbar_expect(rg.full + slot, a_shared ? kStage - kAStage : kStage);
  const int ks = t % nk, pass = t / nk;
  if (!a_shared)
    wg::tma_load(st, &p.maps[amap], rg.full + slot, 0, 64 * ks, 0,
                 blockIdx.x);
#pragma unroll
  for (int q = 0; q < kPassCols / 64; ++q)
    wg::tma_load(st + kAStage + q * 64 * 128, &p.maps[wmap], rg.full + slot,
                 kPassCols * pass + 64 * q, 64 * ks, layer, 0);
}

// The first stages of the product wg_product takes next, before the block
// writes its activations, where they lie in shared memory (kActShared, map
// M_ACT): a stage holds only weights, and their copies overlap that
// writing. Elsewhere nothing: the stages carry the activations.
__device__ __forceinline__ void wg_prefetch(const Params& p, const Ring& rg,
                                            int amap, int wmap, int layer,
                                            int krows, int ncols) {
  if (!kActShared || amap != M_ACT || threadIdx.x != 0) return;
  const int nk = (krows + 63) / 64, np = (ncols + kPassCols - 1) / kPassCols;
  for (int t = 0; t < min(kRingStages - 1, nk * np); ++t)
    wg_issue(p, rg, amap, wmap, layer, nk, rg.n, t);
}

// The block's activations (map amap: its planes, krows columns; M_ACT
// where kActShared: the planes in shared memory) times layer's weight (map
// wmap: krows x ncols, row-major bf16) in passes of kPassCols output
// columns, each pass's sums to wg_epilogue: warp w of warpgroup wg holds
// rows 16 w + g and 16 w + g + 8 (m), columns kPassCols pass + kWgN wg + 8
// nt + 2 tig and + 1, as acc[4 nt + 2 hf + j] (hf: the row, j: the
// column). The block has written the activations (slab_written) before;
// prefetched: wg_prefetch came first (and issued the first stages where
// the activations lie in shared memory). Returns the count of stages the
// ring has taken.
__device__ __forceinline__ int wg_product(const Params& p, Ring rg, int amap,
                                          int wmap, int layer, int krows,
                                          int ncols, WgRows m, WgOut e,
                                          bool prefetched = false) {
  namespace wg = mha::wg;
  const int nk = (krows + 63) / 64, np = (ncols + kPassCols - 1) / kPassCols;
  const int total = nk * np, j0 = rg.n;
  const int half = threadIdx.x >> 7;
  const bool a_shared = kActShared && amap == M_ACT;
  if (threadIdx.x == 0 && !(prefetched && a_shared))
    for (int t = 0; t < min(kRingStages - 1, total); ++t)
      wg_issue(p, rg, amap, wmap, layer, nk, j0, t);
  __syncwarp();
  for (int pass = 0; pass < np; ++pass) {
    float acc[kWgN / 2];
#pragma unroll
    for (int i = 0; i < kWgN / 2; ++i) acc[i] = 0.f;
    for (int ks = 0; ks < nk; ++ks) {
      const int t = pass * nk + ks;
      if (threadIdx.x == 0 && t + kRingStages - 1 < total)
        wg_issue(p, rg, amap, wmap, layer, nk, j0, t + kRingStages - 1);
      const int j = j0 + t, slot = j % kRingStages;
      wg::mbar_wait(rg.full + slot, (j / kRingStages) & 1);
      __syncwarp();
      const unsigned char* st = rg.base + slot * kStage;
      // the activations' chunk: the stage's, or (one chunk) shared memory's
      const unsigned char* at = a_shared ? rg.act : st;
      // this warpgroup's kWgN columns of the weight tile: swizzled boxes
      // of 64 columns (8 KB apart), 16-row steps 2 KB apart, 8-row groups
      // 1 KB
      const unsigned char* wt = st + kAStage + half * kWgN * 128;
      // the stage's own sum, from zero (ptxas folds the zeros into the
      // first wgmma)
      float part[kWgN / 2];
#pragma unroll
      for (int i = 0; i < kWgN / 2; ++i) part[i] = 0.f;
      wg::wg_fence();
#pragma unroll
      for (int pl = 2; pl >= 0; --pl)    // lo, mid, hi
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint64_t a = wg::desc_k<kRows>(at + pl * kPlaneBytes, s);
          const uint64_t b =
              wg::desc(wt + s * 2048, 64 * 128, 1024) | (1ull << 62);
          wg_mma(part, a, b, 1);   // m64n128k16 or m64n64k16
        }
      wg::wg_commit();
      wg::wg_wait();
      wg::hold(part);
#pragma unroll
      for (int i = 0; i < kWgN / 2; ++i) acc[i] += part[i];
      __syncwarp();
      if ((threadIdx.x & 31) == 0) wg::mbar_arrive(rg.empty + slot);
    }
    wg_epilogue(p, layer, m, e, pass, acc);
  }
  return j0 + total;
}
#endif

// whether column 4 tx .. 4 tx + 3 of chunk j of a row lies inside n_embd
__device__ __forceinline__ bool col_in(int j, int tx) {
  return 64 * j + 4 * tx < kC;
}

// (x - mean) * rsqrt(var + eps) of a row spread over 16 lanes, a float4 a
// lane in each 64-column chunk, over the true n_embd (the padding columns
// are zero in and out)
__device__ __forceinline__ void ln_row(float4 (&x)[kNCH], int tx) {
  float s = x[0].x + x[0].y + x[0].z + x[0].w;
#pragma unroll
  for (int j = 1; j < kNCH; ++j) s += x[j].x + x[j].y + x[j].z + x[j].w;
  const float mu = sum16(s) / static_cast<float>(kCT);
  float v = 0.f;
#pragma unroll
  for (int j = 0; j < kNCH; ++j) {
    if (col_in(j, tx)) {
      x[j] = make_float4(x[j].x - mu, x[j].y - mu, x[j].z - mu, x[j].w - mu);
      if constexpr (kCT != kC) {   // the padding columns back to zero
        const int c0 = 64 * j + 4 * tx;
        if (c0 >= kCT) x[j].x = 0.f;
        if (c0 + 1 >= kCT) x[j].y = 0.f;
        if (c0 + 2 >= kCT) x[j].z = 0.f;
        if (c0 + 3 >= kCT) x[j].w = 0.f;
      }
      const float vj =
          x[j].x * x[j].x + x[j].y * x[j].y + x[j].z * x[j].z + x[j].w * x[j].w;
      v = j == 0 ? vj : v + vj;
    }
  }
  const float var = sum16(v) / static_cast<float>(kCT);
  const float r = rsqrtf(var + kLnEps);
#pragma unroll
  for (int j = 0; j < kNCH; ++j)
    x[j] = make_float4(x[j].x * r, x[j].y * r, x[j].z * r, x[j].w * r);
}

// a lane's float4 of each chunk of an n_embd-wide row (zero in the padding)
__device__ __forceinline__ void load_row(const float* src, int tx,
                                         float4 (&v)[kNCH]) {
#pragma unroll
  for (int j = 0; j < kNCH; ++j)
    v[j] = col_in(j, tx) ? ld4(src + 64 * j + tx * 4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
}

// LN(x) * scale + shift into the thread's slots of row `row` of an
// activation tile (sc, sh: the lane's float4s of the scale and shift rows);
// plus1: the AdaLN form LN(x) * (1 + scale) + shift
__device__ __forceinline__ void store_norm(float* As, int row, int tx,
                                           float4 (&x)[kNCH],
                                           const float4 (&sc)[kNCH],
                                           const float4 (&sh)[kNCH],
                                           bool plus1) {
  ln_row(x, tx);
  const float o = plus1 ? 1.f : 0.f;
#pragma unroll
  for (int j = 0; j < kNCH; ++j)
    *reinterpret_cast<float4*>(As + row * kLda + 64 * j + tx * 4) =
        make_float4(x[j].x * (o + sc[j].x) + sh[j].x,
                    x[j].y * (o + sc[j].y) + sh[j].y,
                    x[j].z * (o + sc[j].z) + sh[j].z,
                    x[j].w * (o + sc[j].w) + sh[j].w);
}

// rows ty + 16 i of Src (a tile of row stride LDS in the accumulator
// layout's own row order) through LN into As, all 64 rows (Src may be As)
template <int LDS>
__device__ __forceinline__ void norm_tile(float* As, const float* Src, int ty,
                                          int tx, const float* scale,
                                          const float* shift, bool plus1) {
  float4 sc[kNCH], sh[kNCH];
  load_row(scale, tx, sc);
  load_row(shift, tx, sh);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 x[kNCH];
#pragma unroll
    for (int j = 0; j < kNCH; ++j)
      x[j] = ld4(Src + (ty + 16 * i) * LDS + 64 * j + tx * 4);
    store_norm(As, ty + 16 * i, tx, x, sc, sh, plus1);
  }
}

// the thread's accumulator-layout values into a tile (row stride LDT): row
// 32 wm + 8 i + g, columns 8 (NT wn + nt) + 2 tig, + 1
template <int LDT, int NT>
__device__ __forceinline__ void store_acc(float* T, const float (&v)[2][NT][4],
                                          int wm, int wn, int g, int tig) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(T + (32 * wm + 16 * mt + 8 * hf + g) * LDT +
                                   8 * (NT * wn + nt) + 2 * tig) =
            make_float2(v[mt][nt][2 * hf], v[mt][nt][2 * hf + 1]);
}
#if MK_WG

// LN(src) * scale + shift (plus1: the AdaLN form LN(src) * (1 + scale) +
// shift) of an n_embd-wide row into row r of a slab, the columns past
// n_embd zero; src == nullptr: a row of zeros. The row is read three times
// (the sum, the squares about the mean, the output), a float4 a lane in
// each chunk, so that no register holds more than a float4 of it; the
// arithmetic is ln_row's. planes: the slab takes the row as the wgmma
// products read it (store_planes, kC columns), else in f32 chunks.
__device__ __forceinline__ void norm_row(float* slab, int r, int tx,
                                         const float* src,
                                         const float* scale,
                                         const float* shift, bool plus1,
                                         bool planes) {
  const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
  auto x_at = [&](int j) {
    return src != nullptr && col_in(j, tx) ? ld4(src + 64 * j + tx * 4) : z4;
  };
  // (x - mean), the padding columns zero
  auto centred = [&](int j, float mu) {
    float4 x = x_at(j);
    if (col_in(j, tx)) {
      x = make_float4(x.x - mu, x.y - mu, x.z - mu, x.w - mu);
      if constexpr (kCT != kC) {
        const int c0 = 64 * j + 4 * tx;
        if (c0 >= kCT) x.x = 0.f;
        if (c0 + 1 >= kCT) x.y = 0.f;
        if (c0 + 2 >= kCT) x.z = 0.f;
        if (c0 + 3 >= kCT) x.w = 0.f;
      }
    }
    return x;
  };
  float s = 0.f;
#pragma unroll 4
  for (int j = 0; j < kNCH; ++j) {
    const float4 x = x_at(j);
    const float t = x.x + x.y + x.z + x.w;
    s = j == 0 ? t : s + t;
  }
  const float mu = sum16(s) / static_cast<float>(kCT);
  float v = 0.f;
#pragma unroll 4
  for (int j = 0; j < kNCH; ++j) {
    if (col_in(j, tx)) {
      const float4 x = centred(j, mu);
      const float vj = x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
      v = j == 0 ? vj : v + vj;
    }
  }
  const float var = sum16(v) / static_cast<float>(kCT);
  const float rs = rsqrtf(var + kLnEps);
  const float o = plus1 ? 1.f : 0.f;
#pragma unroll 4
  for (int j = 0; j < kNCH; ++j) {
    float4 x = centred(j, mu);
    x = make_float4(x.x * rs, x.y * rs, x.z * rs, x.w * rs);
    const float4 sc = col_in(j, tx) ? ld4(scale + 64 * j + tx * 4) : z4;
    const float4 sh = col_in(j, tx) ? ld4(shift + 64 * j + tx * 4) : z4;
    const float v[4] = {x.x * (o + sc.x) + sh.x, x.y * (o + sc.y) + sh.y,
                        x.z * (o + sc.z) + sh.z, x.w * (o + sc.w) + sh.w};
    if (!planes)
      *reinterpret_cast<float4*>(slab + kSlabChunk * j + 64 * r + tx * 4) =
          make_float4(v[0], v[1], v[2], v[3]);
    else if (col_in(j, tx))
      store_planes<4>(reinterpret_cast<__nv_bfloat16*>(slab), kActK8, r,
                      64 * j + tx * 4, v);
  }
}

// an n_embd-wide row (row stride kC; nullptr: zeros) into row r of a slab,
// the columns past n_embd zero; planes as norm_row's
__device__ __forceinline__ void copy_row(float* slab, int r, int tx,
                                         const float* src, bool planes) {
#pragma unroll 4
  for (int j = 0; j < kNCH; ++j) {
    const float4 x = src != nullptr && col_in(j, tx)
                         ? ld4(src + 64 * j + tx * 4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    const float v[4] = {x.x, x.y, x.z, x.w};
    if (!planes)
      *reinterpret_cast<float4*>(slab + kSlabChunk * j + 64 * r + tx * 4) =
          x;
    else if (col_in(j, tx))
      store_planes<4>(reinterpret_cast<__nv_bfloat16*>(slab), kActK8, r,
                      64 * j + tx * 4, v);
  }
}
#endif

// ---------------------------------------------------------------------------
// phase A: (embedding) -> AdaLN-LN -> QKV -> q/k/v scratch
// ---------------------------------------------------------------------------
#if MK_WG
// (layer 0) the embedding into the hidden state, both branches of a token
// alike; then AdaLN-LN of the tile's rows into the slab As (a thread reads
// back only what it wrote; planes: as norm_row's)
template <bool PACKED>
__device__ __forceinline__ void embed_norm_rows(const Params& p, int layer,
                                                int item, float* As,
                                                bool planes) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* ada = p.adaln + static_cast<size_t>(layer) * 4 * kC;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int b, rb, tok;
    tile_row<PACKED>(p, item, ty + 16 * i, b, rb, tok);
    float* xp = p.x + (static_cast<size_t>(rb) * p.L + tok) * kC;
    if (tok < p.L && layer == 0) {
      const long long t = p.tokens[static_cast<size_t>(b) * p.L + tok];
      const float* e = p.emb + static_cast<size_t>(t) * kC;
      const float* ps = p.pos + static_cast<size_t>(tok) * kC;
      for (int j = 0; j < kNCH; ++j)
        if (col_in(j, tx))
          *reinterpret_cast<float4*>(xp + 64 * j + tx * 4) =
              add4(ld4(e + 64 * j + tx * 4), ld4(ps + 64 * j + tx * 4));
    }
    norm_row(As, ty + 16 * i, tx, tok < p.L ? xp : nullptr, ada, ada + kC,
             true, planes);
  }
}

// floats of a block's slab: the activations' (0) and the MLP's (1), which
// also holds the cross-attention's output (n_embd wide): as three bf16
// planes (bf16 weights); above n_embd 512 in f32 chunks too (f32 weights,
// and the tail)
__host__ __device__ __forceinline__ long long slab_floats(int which,
                                                          int hidden) {
  const long long planes = 3LL * kRows * (which == 0 ? kC : hidden) / 2;
#if MK_WIDE
  const int chunks = (hidden + 63) / 64;
  const long long f32 = static_cast<long long>(kSlabChunk) *
                        (which == 0 ? kNCH : (chunks > kNCH ? chunks : kNCH));
#else
  const long long f32 = which == 0 ? 0 : static_cast<long long>(kRows) * kC;
#endif
  return f32 > planes ? f32 : planes;
}

// the block's slab in device memory (which: as slab_floats')
__device__ __forceinline__ float* block_slab(const Params& p, int which) {
  return (which ? p.hact : p.act) +
         blockIdx.x * slab_floats(which, p.hidden);
}

// the block's dynamic shared memory from its start (the ring's, in phases
// A and B with bf16 weights)
__device__ __forceinline__ unsigned char* block_smem() {
  extern __shared__ __align__(16) unsigned char smem[];
  return smem;
}

// Phase A with bf16 weights: QKV on wgmma (wg_product, E_QKV), the tile's
// rows normalised into the block's slab as three planes.
template <bool PACKED>
__device__ void phase_qkv_wg(const Params& p, int layer) {
  const int n_items = tile_items<PACKED>(p);
  Ring rg = ring_begin(block_smem());
  float* As = kActShared ? reinterpret_cast<float*>(rg.act)
                         : block_slab(p, 0);
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    // (the warps are done with the planes of the item before)
    if (kActShared) __syncthreads();
    wg_prefetch(p, rg, M_ACT, M_WQKV, layer, kC, 3 * kC);
    embed_norm_rows<PACKED>(p, layer, item, As, true);
    slab_written();
    rg.n = wg_product(p, rg, M_ACT, M_WQKV, layer, kC, 3 * kC,
                      wg_rows<PACKED>(p, item),
                      WgOut{E_QKV, nullptr, 0, nullptr}, true);
  }
  ring_end(rg);
}
#endif

template <bool PACKED>
__device__ MK_PHASE_A void phase_qkv(const Params& p, int layer, float* As, float* W0,
                          float* W1) {
#if MK_WG
  if (p.w_bf16) {
    phase_qkv_wg<PACKED>(p, layer);
    return;
  }
#endif
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3, wm = warp & 1, wn = warp >> 1;
  const int n_items = tile_items<PACKED>(p);
#if !MK_WIDE
  const float* ada = p.adaln + static_cast<size_t>(layer) * 4 * kC;
  float4 sc[kNCH], sh[kNCH];
  load_row(ada, tx, sc);
  load_row(ada + kC, tx, sh);
#endif
  const size_t wbase = static_cast<size_t>(layer) * kC * 3 * kC;
  // output chunk j of section sec (q, k, v) of the QKV product
  auto qkv = [&](int sec, int j) {
    return WTile{p.wqkv, wbase, 3 * kC, sec * kC + 64 * j,
                 min(64, kC - 64 * j), kC};
  };
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
#if MK_WIDE
    embed_norm_rows<PACKED>(p, layer, item, As, false);
#else
    float4 prev[kNCH];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int b, rb, tok;
      tile_row<PACKED>(p, item, ty + 16 * i, b, rb, tok);
      float4 xr[kNCH];
#pragma unroll
      for (int j = 0; j < kNCH; ++j) xr[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (tok < p.L) {
        float* xp = p.x + (static_cast<size_t>(rb) * p.L + tok) * kC;
        if (layer != 0) {
          load_row(xp, tx, xr);
        } else {
          if (PACKED && (i & 1)) {   // the other branch of the same token
#pragma unroll
            for (int j = 0; j < kNCH; ++j) xr[j] = prev[j];
          } else {
            const long long t = p.tokens[static_cast<size_t>(b) * p.L + tok];
            float4 e[kNCH], ps[kNCH];
            load_row(p.emb + static_cast<size_t>(t) * kC, tx, e);
            load_row(p.pos + static_cast<size_t>(tok) * kC, tx, ps);
#pragma unroll
            for (int j = 0; j < kNCH; ++j) xr[j] = add4(e[j], ps[j]);
          }
#pragma unroll
          for (int j = 0; j < kNCH; ++j)
            if (col_in(j, tx))
              *reinterpret_cast<float4*>(xp + 64 * j + tx * 4) = xr[j];
        }
      }
#pragma unroll
      for (int j = 0; j < kNCH; ++j) prev[j] = xr[j];
      store_norm(As, ty + 16 * i, tx, xr, sc, sh, true);
    }
#endif
    int cur = 0;
    stage_tile<64>(W0, qkv(0, 0), 0, p.w_bf16);
    sync_staged();
    const RowMap m = map_rows<PACKED>(p, item, wm, g);
    for (int c = 0; c < 3 * kNCH; ++c) {
      const int sec = c / kNCH, j = c % kNCH;
      // the next tile lands in the other buffer during this product
      const WTile none{nullptr, 0, 0, 0, 0, 0};
      float acc[2][2][4];
      zero<2>(acc);
      chunk_product<64, 2>(As, W0, W1, cur, p.w_bf16, qkv(sec, j),
                           c + 1 < 3 * kNCH
                               ? qkv((c + 1) / kNCH, (c + 1) % kNCH)
                               : none,
                           acc);
      __nv_bfloat16* dst = sec == 0 ? p.q : (sec == 1 ? p.k : p.v);
      const float s = sec == 0 ? p.qscale : 1.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        // a column of this section and its head: with an even head dim a
        // pair (col, col + 1) never straddles two heads; with an odd one
        // each column goes to its own head and dim. A warp's 8-column group
        // lies inside the padded row or outside it as a whole (the shuffles
        // below need every lane); the padding columns store nothing.
        const int col = 64 * j + 8 * (2 * wn + nt) + 2 * tig;
        if (col >= kC) continue;
        const bool in = col < kCT;
        const int head = col / kD, dim = col % kD;
        const float2 bias =
            ld2(p.bqkv + static_cast<size_t>(layer) * 3 * kC + sec * kC + col);
        float kmx[2][2] = {{0.f, 0.f}, {0.f, 0.f}};   // [mt][column]
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (m.ok[i]) {
            const __nv_bfloat162 v = __floats2bfloat162_rn(
                (acc[i >> 1][nt][2 * (i & 1)] + bias.x) * s,
                (acc[i >> 1][nt][2 * (i & 1) + 1] + bias.y) * s);
            const size_t row = static_cast<size_t>(m.rb[i]) * kH;
            if (in) {
              if constexpr (kD % 2 == 0) {
                *reinterpret_cast<__nv_bfloat162*>(
                    dst + ((row + head) * p.L + m.tok[i]) * kDS + dim) = v;
              } else {
                dst[((row + head) * p.L + m.tok[i]) * kDS + dim] =
                    __low2bfloat16(v);
                if (col + 1 < kCT)
                  dst[((row + (col + 1) / kD) * p.L + m.tok[i]) * kDS +
                      (col + 1) % kD] = __high2bfloat16(v);
              }
            }
            kmx[i >> 1][0] = fmaxf(kmx[i >> 1][0], fabsf(__low2float(v)));
            kmx[i >> 1][1] = fmaxf(kmx[i >> 1][1], fabsf(__high2float(v)));
          }
        if (sec == 1) {
          // max over a head's keys of |k| per dim, which bounds a query's
          // scores from above (phase S): the 16 rows of a warp's tile are
          // one row-branch; |x| orders like its bit pattern. The table is
          // (R, H, D): (row-branch, true column).
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              float v = kmx[mt][jj];
#pragma unroll
              for (int off = 4; off < 32; off <<= 1)
                v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
              if (g == 0 && v > 0.f && col + jj < kCT)
                atomicMax(p.kmax + static_cast<size_t>(m.rb[2 * mt]) * kCT +
                              col + jj,
                          __float_as_uint(v));
            }
        }
      }
      sync_staged();
      cur ^= 1;
    }
  }
}

// ---------------------------------------------------------------------------
// phase S: self-attention on the tensor cores, one warp per 32 queries
// ---------------------------------------------------------------------------
// q / sqrt(d), k, v and the probabilities are bf16 values and a product of
// two of them is exact in f32, so a bf16 mma with f32 accumulation computes
// what f32 FMAs on the rounded operands would. QK^T is mma.m16n8k16 (16
// queries x 8 keys x 16 dims) over the head's dims in steps of 16, then
// one mma.m16n8k8 where 8 dims are left; at head dim 4 that one k8 step
// alone, its upper half of A zero. Its accumulator layout (keys 2 tig, 2 tig
// + 1 of rows g and g + 8) is, packed to bf16 pairs, the A layout of
// mma.m16n8k16, so the probabilities of two key blocks feed P V without a
// shuffle or an unpack; P V writes the head's dims 8 at a time (at head dim
// 4, V fills 4 of its 8 output columns).
__device__ __forceinline__ void mma_qk(float (&d)[4], unsigned a0, unsigned a1,
                                       unsigned b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "f"(0.f));
}

__device__ __forceinline__ void mma_k8(float (&c)[4], unsigned a0, unsigned a1,
                                       unsigned b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}
#endif  // MK_SERVING

__device__ __forceinline__ void mma_pv(float (&c)[4], unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 2^x without the special function unit: x = n + f, |f| <= 1/2, a
// polynomial for 2^f on the FMA pipe, n added to the exponent. DEG 6 is
// good to f32's last bits (what ex2.approx is), DEG 3 to 2^-13.
template <int DEG>
__device__ __forceinline__ float ex2_poly(float x) {
  x = fmaxf(x, -126.f);
  const float t = x + 12582912.f;          // 1.5 * 2^23: n in the low bits
  const float f = x - (t - 12582912.f);
  float p;
  if (DEG == 6) {
    p = 1.5403530393e-4f;
    p = fmaf(p, f, 1.3333558146e-3f);
    p = fmaf(p, f, 9.6181291076e-3f);
    p = fmaf(p, f, 5.5504108665e-2f);
  } else {
    p = 5.5171665e-2f;   // minimax on [-1/2, 1/2] to degree 3
  }
  p = fmaf(p, f, DEG == 6 ? 2.4022650696e-1f : 2.4261112e-1f);
  p = fmaf(p, f, DEG == 6 ? 6.9314718056e-1f : 6.9326099e-1f);
  p = fmaf(p, f, DEG == 6 ? 1.f : 0.99992807f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}

// of the 16 exponentials a thread takes per block of 16 keys, how many go
// to the polynomial in sweep 1 (row sum) and sweep 2 (probabilities)
#ifndef MK_POLY1
#define MK_POLY1 4
#endif
#ifndef MK_POLY2
#define MK_POLY2 0
#endif
// For timing only (with bits 0-2 the step's result is wrong): bit 0 leaves
// out the softmax shift, bit 1 the row-sum sweep, bit 2 replaces every
// exponential of phase S by an add, bit 3 takes the exact row maximum
// everywhere (the result stays right). probes/megakernel_variants.py builds
// such variants beside the real one and reads the phase's time of each.
#ifndef MK_ABLATE
#define MK_ABLATE 0
#endif

// 16-query tiles a warp works on at once (3 and 4 share a key fragment's
// load over more queries and measured slower: 15.1 and 14.1 ms against 13.1)
constexpr int kMT = 2;
constexpr int kQTile = 8 * 16 * kMT;   // queries a block works on at once
#if MK_SERVING

// a warp's running softmax state for its kMT tiles of 16 queries: rows g and
// g + 8 of each tile
struct AttnState {
  float ml[kMT][2];    // the shift of the scores x log2(e); sweep 0: the max
  float l[kMT][2];     // row sum, then its reciprocal
  float acc[kMT][4];   // P V
};

// One block of 16 keys for the warp's 16 kMT queries. SWEEP 0: row maximum
// (into ml); 1: row sum of exp(s - shift); 2: exp(s - shift) / sum -> bf16 ->
// P V. MASKED: the last block, of which only the keys below n exist. ks:
// [key][4] bf16; vs: [key / 2][dim] pairs (V[key][dim], V[key + 1][dim]).
template <int SWEEP, bool MASKED>
__device__ __forceinline__ void attn_block(const unsigned* ks,
                                           const unsigned* vs, int kb, int n,
                                           int g, int tig,
                                           const unsigned (&qa)[kMT][2],
                                           AttnState& st) {
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr int kPoly = SWEEP == 1 ? MK_POLY1 : MK_POLY2;
  unsigned kf[2];
#pragma unroll
  for (int sb = 0; sb < 2; ++sb)
    kf[sb] = ks[(kb + 8 * sb + g) * 2 + (tig & 1)];
  unsigned v0 = 0u, v1 = 0u;
  if (SWEEP == 2 && g < 4) {
    v0 = vs[((kb >> 1) + tig) * 4 + g];
    v1 = vs[((kb >> 1) + 4 + tig) * 4 + g];
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    float s[2][4];
#pragma unroll
    for (int sb = 0; sb < 2; ++sb) {
      mma_qk(s[sb], qa[mt][0], qa[mt][1], kf[sb]);
      if (MASKED) {
        if (kb + 8 * sb + 2 * tig >= n) s[sb][0] = s[sb][2] = -INFINITY;
        if (kb + 8 * sb + 2 * tig + 1 >= n) s[sb][1] = s[sb][3] = -INFINITY;
      }
    }
    if constexpr (SWEEP == 0) {
#pragma unroll
      for (int sb = 0; sb < 2; ++sb) {
        st.ml[mt][0] = fmaxf(st.ml[mt][0], fmaxf(s[sb][0], s[sb][1]));
        st.ml[mt][1] = fmaxf(st.ml[mt][1], fmaxf(s[sb][2], s[sb][3]));
      }
    } else {
      float e[2][4];
#pragma unroll
      for (int sb = 0; sb < 2; ++sb)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float x = fmaf(s[sb][c], kLog2e, -st.ml[mt][c >> 1]);
          // the thread's 16 exponentials of this block in a fixed order, of
          // which kPoly, evenly spread, go to the FMA pipe
          const bool poly =
              ((mt & 1) * 8 + sb * 4 + c) * kPoly % 16 + kPoly > 15;
          e[sb][c] = (MK_ABLATE & 4) ? x + 1.f
                     : poly          ? ex2_poly<SWEEP == 1 ? 3 : 6>(x)
                                     : ex2(x);
        }
      if constexpr (SWEEP == 1) {
        st.l[mt][0] += (e[0][0] + e[0][1]) + (e[1][0] + e[1][1]);
        st.l[mt][1] += (e[0][2] + e[0][3]) + (e[1][2] + e[1][3]);
      } else {
        unsigned a[4];
#pragma unroll
        for (int sb = 0; sb < 2; ++sb)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            // exp / sum -> bf16, two keys a register
            const __nv_bfloat162 pk = __floats2bfloat162_rn(
                e[sb][2 * hf] * st.l[mt][hf],
                e[sb][2 * hf + 1] * st.l[mt][hf]);
            a[2 * sb + hf] = *reinterpret_cast<const unsigned*>(&pk);
          }
        mma_pv(st.acc[mt], a[0], a[1], a[2], a[3], v0, v1);
      }
    }
  }
}

// One sweep over the keys kb0 .. L - 1 of a (row-branch, head), staged
// whole.
template <int SWEEP>
__device__ __forceinline__ void attn_sweep(const unsigned* ks,
                                           const unsigned* vs, int kb0, int L,
                                           int g, int tig,
                                           const unsigned (&qa)[kMT][2],
                                           AttnState& st) {
  const int nfull = L & ~15;
#pragma unroll 2
  for (int kb = kb0; kb < nfull; kb += 16)
    attn_block<SWEEP, false>(ks, vs, kb, L, g, tig, qa, st);
  if (nfull < L && kb0 <= nfull)
    attn_block<SWEEP, true>(ks, vs, nfull, L, g, tig, qa, st);
}
#else   // MK_SERVING

// a warp's running softmax state for its kMT tiles of 16 queries: rows g and
// g + 8 of each tile
struct AttnState {
  float ml[kMT][2];          // the shift of the scores x log2(e); sweep 0: max
  float l[kMT][2];           // row sum, then its reciprocal
  float acc[kMT][kNTA][4];   // P V (wide heads: one chunk of output dims)
};

// The warp's queries: the A fragments of its kMT tiles in registers
// (load_queries), or, for wide heads, its 2 kMT query rows in the q scratch
// (rows past the end read the last row; their results are not stored)
struct QRows {
  const unsigned* r[kMT][2];   // rows 16 mt + 8 hf + g, as bf16 pairs
};
using Queries = std::conditional<kWide, QRows, unsigned[kMT][kQA]>::type;

// the row maximum (SWEEP 0) or the row sum (1) of one 16-query tile's
// scores s over 16 keys, or (2) its probabilities exp / sum -> bf16, two
// keys a register, into a (the A fragment of P V); kPoly of the thread's 16
// exponentials go to the polynomial (mt: the tile's index)
template <int SWEEP>
__device__ __forceinline__ void attn_probs(float (&s)[2][4], int mt,
                                           AttnState& st, unsigned (&a)[4]) {
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr int kPoly = SWEEP == 1 ? MK_POLY1 : MK_POLY2;
  if constexpr (SWEEP == 0) {
#pragma unroll
    for (int sb = 0; sb < 2; ++sb) {
      st.ml[mt][0] = fmaxf(st.ml[mt][0], fmaxf(s[sb][0], s[sb][1]));
      st.ml[mt][1] = fmaxf(st.ml[mt][1], fmaxf(s[sb][2], s[sb][3]));
    }
  } else {
    float e[2][4];
#pragma unroll
    for (int sb = 0; sb < 2; ++sb)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float x = fmaf(s[sb][c], kLog2e, -st.ml[mt][c >> 1]);
        // the thread's 16 exponentials of this block in a fixed order, of
        // which kPoly, evenly spread, go to the FMA pipe
        const bool poly =
            ((mt & 1) * 8 + sb * 4 + c) * kPoly % 16 + kPoly > 15;
        e[sb][c] = (MK_ABLATE & 4) ? x + 1.f
                   : poly          ? ex2_poly<SWEEP == 1 ? 3 : 6>(x)
                                   : ex2(x);
      }
    if constexpr (SWEEP == 1) {
      st.l[mt][0] += (e[0][0] + e[0][1]) + (e[1][0] + e[1][1]);
      st.l[mt][1] += (e[0][2] + e[0][3]) + (e[1][2] + e[1][3]);
    } else {
#pragma unroll
      for (int sb = 0; sb < 2; ++sb)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const __nv_bfloat162 pk = __floats2bfloat162_rn(
              e[sb][2 * hf] * st.l[mt][hf], e[sb][2 * hf + 1] * st.l[mt][hf]);
          a[2 * sb + hf] = *reinterpret_cast<const unsigned*>(&pk);
        }
    }
  }
}

// attn_probs, then (SWEEP 2) P V into the tile's output
template <int SWEEP>
__device__ __forceinline__ void attn_scores(float (&s)[2][4], int mt,
                                            const unsigned (&vf)[kNTA][2],
                                            AttnState& st) {
  unsigned a[4];
  attn_probs<SWEEP>(s, mt, st, a);
  if constexpr (SWEEP == 2) {
#pragma unroll
    for (int nt = 0; nt < kNTA; ++nt)
      mma_pv(st.acc[mt][nt], a[0], a[1], a[2], a[3], vf[nt][0], vf[nt][1]);
  }
}

// One block of 16 keys for the warp's 16 kMT queries. SWEEP 0: row maximum
// (into ml); 1: row sum of exp(s - shift); 2: exp(s - shift) / sum -> bf16 ->
// P V. MASKED: the last block, of which only the keys below n exist.
// Heads of 1-4 dims: ks [key][4] bf16, vs [key / 2][dim] pairs (V[key][dim],
// V[key + 1][dim]). Wider heads: ks and vs [key][kRowS] bf16, V's fragments
// by ldmatrix.trans. qa: the queries' A registers (load_queries).
template <int SWEEP, bool MASKED>
__device__ __forceinline__ void attn_block(const unsigned* ks,
                                           const unsigned* vs, int kb, int n,
                                           int g, int tig,
                                           const unsigned (&qa)[kMT][kQA],
                                           AttnState& st, int /*oc*/) {
  constexpr int kQB = 2 * kQ16 + kQ8;   // B registers of 8 keys
  unsigned kf[2][kQB];
  unsigned vf[kNTV][2];
#pragma unroll
  for (int sb = 0; sb < 2; ++sb) {
    if constexpr (kDS == 4) {
      kf[sb][0] = ks[(kb + 8 * sb + g) * 2 + (tig & 1)];
    } else {
      const unsigned* kr = ks + (kb + 8 * sb + g) * (kRowS / 2);
#pragma unroll
      for (int q = 0; q < kQ16; ++q) {
        kf[sb][2 * q] = kr[8 * q + tig];
        kf[sb][2 * q + 1] = kr[8 * q + 4 + tig];
      }
      if (kQ8) kf[sb][2 * kQ16] = kr[8 * kQ16 + tig];
    }
  }
  if constexpr (SWEEP == 2) {
    if constexpr (kDS == 4) {
      vf[0][0] = vf[0][1] = 0u;
      if (g < 4) {
        vf[0][0] = vs[((kb >> 1) + tig) * 4 + g];
        vf[0][1] = vs[((kb >> 1) + 4 + tig) * 4 + g];
      }
    } else {
      // keys kb + (lane & 15), dims 8 (nt + (lane >> 4)): matrices (keys
      // 0-7 | 8-15) x (this | the next 8 dims), transposed
      const int lane = threadIdx.x & 31;
      const unsigned short* vr = reinterpret_cast<const unsigned short*>(vs) +
                                 (kb + (lane & 15)) * kRowS + 8 * (lane >> 4);
#pragma unroll
      for (int nt = 0; nt < kNTV; nt += 2) {
        const unsigned addr =
            static_cast<unsigned>(__cvta_generic_to_shared(vr + 8 * nt));
        if (nt + 1 < kNTV)
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
              "{%0, %1, %2, %3}, [%4];\n"
              : "=r"(vf[nt][0]), "=r"(vf[nt][1]), "=r"(vf[nt + 1][0]),
                "=r"(vf[nt + 1][1])
              : "r"(addr));
        else
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, "
              "[%2];\n"
              : "=r"(vf[nt][0]), "=r"(vf[nt][1])
              : "r"(addr));
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    float s[2][4];
#pragma unroll
    for (int sb = 0; sb < 2; ++sb) {
      if constexpr (kQ16 == 0) {
        mma_qk(s[sb], qa[mt][0], qa[mt][1], kf[sb][0]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) s[sb][c] = 0.f;
#pragma unroll
        for (int q = 0; q < kQ16; ++q)
          mma_pv(s[sb], qa[mt][4 * q], qa[mt][4 * q + 1], qa[mt][4 * q + 2],
                 qa[mt][4 * q + 3], kf[sb][2 * q], kf[sb][2 * q + 1]);
        if (kQ8)
          mma_k8(s[sb], qa[mt][4 * kQ16], qa[mt][4 * kQ16 + 1],
                 kf[sb][2 * kQ16]);
      }
      if (MASKED) {
        if (kb + 8 * sb + 2 * tig >= n) s[sb][0] = s[sb][2] = -INFINITY;
        if (kb + 8 * sb + 2 * tig + 1 >= n) s[sb][1] = s[sb][3] = -INFINITY;
      }
    }
    attn_scores<SWEEP>(s, mt, vf, st);
  }
}

// attn_block for wide heads: QK^T a 16-dim step at a time, the step's query
// fragments read from the q scratch and its key fragments from shared
// memory, so that neither is held whole; SWEEP 2 adds the probabilities'
// product with output chunk oc of V (tiles kNTA oc ..), V's fragments taken
// two tiles at a time. The scores' sums run in the same order in every
// sweep and chunk.
template <int SWEEP, bool MASKED>
__device__ __forceinline__ void attn_block(const unsigned* ks,
                                           const unsigned* vs, int kb, int n,
                                           int g, int tig, const QRows& qa,
                                           AttnState& st, int oc) {
  float s[kMT][2][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int sb = 0; sb < 2; ++sb)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[mt][sb][c] = 0.f;
  const unsigned* kr0 = ks + (kb + g) * (kRowS / 2);
  const unsigned* kr1 = kr0 + 8 * (kRowS / 2);
#pragma unroll 4
  for (int q = 0; q < kQ16; ++q) {
    const unsigned k00 = kr0[8 * q + tig], k01 = kr0[8 * q + 4 + tig];
    const unsigned k10 = kr1[8 * q + tig], k11 = kr1[8 * q + 4 + tig];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const unsigned a0 = qa.r[mt][0][8 * q + tig];
      const unsigned a1 = qa.r[mt][1][8 * q + tig];
      const unsigned a2 = qa.r[mt][0][8 * q + 4 + tig];
      const unsigned a3 = qa.r[mt][1][8 * q + 4 + tig];
      mma_pv(s[mt][0], a0, a1, a2, a3, k00, k01);
      mma_pv(s[mt][1], a0, a1, a2, a3, k10, k11);
    }
  }
  if constexpr (kQ8 != 0) {
    const unsigned k0 = kr0[8 * kQ16 + tig], k1 = kr1[8 * kQ16 + tig];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const unsigned a0 = qa.r[mt][0][8 * kQ16 + tig];
      const unsigned a1 = qa.r[mt][1][8 * kQ16 + tig];
      mma_k8(s[mt][0], a0, a1, k0);
      mma_k8(s[mt][1], a0, a1, k1);
    }
  }
  unsigned a[kMT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    if (MASKED) {
#pragma unroll
      for (int sb = 0; sb < 2; ++sb) {
        if (kb + 8 * sb + 2 * tig >= n) s[mt][sb][0] = s[mt][sb][2] = -INFINITY;
        if (kb + 8 * sb + 2 * tig + 1 >= n)
          s[mt][sb][1] = s[mt][sb][3] = -INFINITY;
      }
    }
    attn_probs<SWEEP>(s[mt], mt, st, a[mt]);
  }
  if constexpr (SWEEP == 2) {
    const int lane = threadIdx.x & 31;
    const unsigned short* vr = reinterpret_cast<const unsigned short*>(vs) +
                               (kb + (lane & 15)) * kRowS + 8 * (lane >> 4);
#pragma unroll
    for (int nt = 0; nt < kNTA; nt += 2) {
      const int t = kNTA * oc + nt;   // the tile of the head's dims
      const unsigned addr =
          static_cast<unsigned>(__cvta_generic_to_shared(vr + 8 * t));
      unsigned v[2][2] = {{0u, 0u}, {0u, 0u}};
      if (nt + 1 < kNTA && t + 1 < kNTV)
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
            "{%0, %1, %2, %3}, [%4];\n"
            : "=r"(v[0][0]), "=r"(v[0][1]), "=r"(v[1][0]), "=r"(v[1][1])
            : "r"(addr));
      else if (t < kNTV)
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, "
            "[%2];\n"
            : "=r"(v[0][0]), "=r"(v[0][1])
            : "r"(addr));
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        mma_pv(st.acc[mt][nt], a[mt][0], a[mt][1], a[mt][2], a[mt][3],
               v[0][0], v[0][1]);
        if (nt + 1 < kNTA)
          mma_pv(st.acc[mt][nt + 1], a[mt][0], a[mt][1], a[mt][2], a[mt][3],
                 v[1][0], v[1][1]);
      }
    }
  }
}

// One sweep over the keys kb0 .. L - 1 of the staged keys (SWEEP 2: into
// output chunk oc).
template <int SWEEP, class Q>
__device__ __forceinline__ void attn_sweep(const unsigned* ks,
                                           const unsigned* vs, int kb0, int L,
                                           int g, int tig, const Q& qa,
                                           AttnState& st, int oc = 0) {
  const int nfull = L & ~15;
#pragma unroll 2
  for (int kb = kb0; kb < nfull; kb += 16)
    attn_block<SWEEP, false>(ks, vs, kb, L, g, tig, qa, st, oc);
  if (nfull < L && kb0 <= nfull)
    attn_block<SWEEP, true>(ks, vs, nfull, L, g, tig, qa, st, oc);
}
#endif  // MK_SERVING

// The softmax shift of the warp's queries, x log2(e), into st.ml. Softmax
// does not change under a shift of the scores, so the exact row maximum (a
// sweep of its own over all keys) is taken only where it has to be. An upper
// bound of a query's scores comes for nothing: sum_d |q_d| max_keys |k_d|,
// the maxima from phase A. It serves as the shift wherever it provably lies
// within kShiftSlack of the row maximum, of which the maximum over the first
// 16 keys is a lower bound: the largest exponential is then at least
// exp(-kShiftSlack), and neither the row sum nor a probability that bf16
// would keep falls under f32's range. If any query of the warp fails that
// test, the warp sweeps all keys for the exact maxima.
constexpr float kShiftSlack = 40.f;
#if MK_SERVING

__device__ __forceinline__ void softmax_shift(const unsigned* ks,
                                              const unsigned* vs, int L, int g,
                                              int tig, float km0, float km1,
                                              const unsigned (&qa)[kMT][2],
                                              AttnState& st) {
  constexpr float kLog2e = 1.4426950408889634f;
  float bound[kMT][2];
  bool safe = true;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      // the thread holds q's dims 2 tig, 2 tig + 1 (tig < 2) as a bf16 pair
      const float q0 = __uint_as_float(qa[mt][hf] << 16);
      const float q1 = __uint_as_float(qa[mt][hf] & 0xffff0000u);
      bound[mt][hf] = quad_sum(fabsf(q0) * km0 + fabsf(q1) * km1);
      st.ml[mt][hf] = -INFINITY;
    }
  if (L >= 16)
    attn_block<0, false>(ks, vs, 0, L, g, tig, qa, st);
  else
    attn_block<0, true>(ks, vs, 0, L, g, tig, qa, st);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float lower = quad_max(st.ml[mt][hf]);   // every lane shuffles
      safe = safe && bound[mt][hf] - lower <= kShiftSlack;
    }
  if (__all_sync(0xffffffffu, safe) && !(MK_ABLATE & 8)) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) st.ml[mt][hf] = bound[mt][hf] * kLog2e;
  } else {
    attn_sweep<0>(ks, vs, 16, L, g, tig, qa, st);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        st.ml[mt][hf] = quad_max(st.ml[mt][hf]) * kLog2e;
  }
}

// the warp's queries from row q0 on: rows q0 + 16 mt + 8 hf + g; a
// thread holds dims 2 tig, 2 tig + 1 (the contraction's upper half: 0)
__device__ __forceinline__ void load_queries(const unsigned* qg, int q0, int L,
                                             int g, int tig,
                                             unsigned (&qa)[kMT][2]) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = q0 + 16 * mt + g + 8 * hf;
      qa[mt][hf] = (row < L && tig < 2)
          ? qg[static_cast<size_t>(row) * 2 + tig] : 0u;
    }
}

// A work item is one (row-branch, head), or a part of its queries. Its keys
// and values (16 bytes a key: up to kMaxSeq) are staged once as they are,
// bf16, K as [key][4], V transposed to pairs of keys; the block then walks
// the head's queries kQTile at a time, a warp per 16 kMT, without a
// block-wide barrier. Per query the shift (softmax_shift), then two sweeps
// over the keys: the row sum, then exp / sum -> bf16 -> P V. Two, because
// the probabilities are rounded to bf16 after the division by their row sum
// (an online rescale would round them elsewhere).
__device__ void phase_self_attention(const Params& p, unsigned char* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int L16 = (p.L + 15) & ~15;
  uint2* ks = reinterpret_cast<uint2*>(smem);
  uint4* vs = reinterpret_cast<uint4*>(smem + static_cast<size_t>(L16) * 8);
  const unsigned* ksw = reinterpret_cast<const unsigned*>(ks);
  const unsigned* vsw = reinterpret_cast<const unsigned*>(vs);
  const int nq = (p.L + kQTile - 1) / kQTile;
  // a head's nq query tiles are split over n_split items where that shortens
  // the longest block's share (rounds of items x tiles an item)
  const int n_heads = p.B * p.n_br * kH;
  const int grid = static_cast<int>(gridDim.x);
  int n_split = 1, best = ((n_heads + grid - 1) / grid) * nq;
  for (int sp = 2; sp <= nq; ++sp) {
    const int span = ((n_heads * sp + grid - 1) / grid) * ((nq + sp - 1) / sp);
    if (span < best) {
      best = span;
      n_split = sp;
    }
  }
  const int n_items = n_heads * n_split;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int rh = item / n_split, part = item % n_split;
    const int qt0 = part * nq / n_split, qt1 = (part + 1) * nq / n_split;
    const int h = rh % kH;
    const int r = rh / kH;
    const size_t base = static_cast<size_t>(rh) * p.L;
    const uint2* kg = reinterpret_cast<const uint2*>(p.k) + base;
    const uint2* vg = reinterpret_cast<const uint2*>(p.v) + base;
    const unsigned* qg = reinterpret_cast<const unsigned*>(p.q) + base * 2;
    const uint2 z2 = make_uint2(0u, 0u);
    for (int j = threadIdx.x; j < L16; j += kThreads)
      ks[j] = j < p.L ? kg[j] : z2;
    for (int j = threadIdx.x; j < L16 / 2; j += kThreads) {
      const uint2 a = 2 * j < p.L ? vg[2 * j] : z2;
      const uint2 b = 2 * j + 1 < p.L ? vg[2 * j + 1] : z2;
      vs[j] = make_uint4(__byte_perm(a.x, b.x, 0x5410),
                         __byte_perm(a.x, b.x, 0x7632),
                         __byte_perm(a.y, b.y, 0x5410),
                         __byte_perm(a.y, b.y, 0x7632));
    }
    // max over this head's keys of |k|, dims 2 tig and 2 tig + 1
    const uint2 kmb = tig < 2
        ? __ldcg(reinterpret_cast<const uint2*>(p.kmax) +
                 static_cast<size_t>(rh) * 2 + tig)
        : z2;
    const float km0 = __uint_as_float(kmb.x), km1 = __uint_as_float(kmb.y);
    __syncthreads();
    // (a warp whose queries lie past the end has nothing to do: no barrier
    // is met before the item ends)
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * kQTile + warp * 16 * kMT;
      if (q0 >= p.L) break;
      unsigned qa[kMT][2];
      AttnState st;
      load_queries(qg, q0, p.L, g, tig, qa);
      if (MK_ABLATE & 1) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) st.ml[mt][0] = st.ml[mt][1] = 0.f;
      } else {
        softmax_shift(ksw, vsw, p.L, g, tig, km0, km1, qa, st);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        st.l[mt][0] = st.l[mt][1] = (MK_ABLATE & 2) ? 1.f : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) st.acc[mt][c] = 0.f;
      }
      if (!(MK_ABLATE & 2)) attn_sweep<1>(ksw, vsw, 0, p.L, g, tig, qa, st);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          st.l[mt][hf] = 1.f / quad_sum(st.l[mt][hf]);
      attn_sweep<2>(ksw, vsw, 0, p.L, g, tig, qa, st);
      if (tig < 2) {   // output columns 2 tig, 2 tig + 1 of the head's 4
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
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
    __syncthreads();   // every warp has read the staged keys and values
  }
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
// The weight tiles of an item come in a fixed order and alternate between
// two buffers: each product stages its successor's tile before its own mma,
// and one block-wide barrier a product publishes both that tile and the
// product's epilogue. The residual stream stays in registers, in the
// accumulator layout; it passes through shared memory (Hs) only to be
// normalised row by row.
#define WB(i) ((i) ? W1 : W0)
template <bool PACKED>
__device__ void phase_mlp(const Params& p, int layer, float* As, float* Hs,
                          float* W0, float* W1) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3, wm = warp & 1, wn = warp >> 1;
  const int n_items = tile_items<PACKED>(p);
  const int wb = p.w_bf16;
  const size_t lw = static_cast<size_t>(layer) * kC * kC;   // a (C, C) layer
  const size_t lb = static_cast<size_t>(layer) * kC;
  const size_t lfc = static_cast<size_t>(layer) * kC * p.hidden;
  const int nch = p.hidden / kC;
  // phase S has read this layer's key maxima: clear them for the next
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < p.B * p.n_br * kC;
       i += gridDim.x * kThreads)
    p.kmax[i] = 0u;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const RowMap m = map_rows<PACKED>(p, item, wm, g);
    int cur = 0;   // the buffer that holds the next product's weights
    float xr[2][2][4], acc[2][2][4];
    // the residual stream (accumulator layout); the attention output -> As
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float2 v = make_float2(0.f, 0.f);
        if (m.ok[i])
          v = ld2(p.x + (static_cast<size_t>(m.rb[i]) * p.L + m.tok[i]) * kC +
                  8 * (2 * wn + nt) + 2 * tig);
        xr[i >> 1][nt][2 * (i & 1)] = v.x;
        xr[i >> 1][nt][2 * (i & 1) + 1] = v.y;
      }
      int b, rb, tok;
      tile_row<PACKED>(p, item, ty + 16 * i, b, rb, tok);
      *reinterpret_cast<float4*>(As + (ty + 16 * i) * kLda + tx * 4) =
          tok < p.L ? ld4(p.o + (static_cast<size_t>(rb) * p.L + tok) * kC +
                          tx * 4)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    stage_w<64>(WB(cur), p.wproj, wb, lw, kC, 0, kC);
    sync_staged();
    // proj + residual (+ the cross-attention bias)
    if (p.cross_bias)
      stage_w<64>(WB(cur ^ 1), p.wfc, wb, lfc, p.hidden, 0, kC);
    else
      stage_w<64>(WB(cur ^ 1), p.wq_c, wb, lw, kC, 0, kC);
    zero<2>(acc);
    mma_tile<2>(As, WB(cur), wb, acc);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = 8 * (2 * wn + nt) + 2 * tig;
      const float2 bias = ld2(p.bproj + lb + col);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float2 add = bias;
        if (p.cross_bias) {
          const float2 cb = ld2(p.kc + (static_cast<size_t>(m.rb[i]) *
                                        p.n_layer + layer) * p.sp * kC + col);
          add.x += cb.x;
          add.y += cb.y;
        }
        xr[i >> 1][nt][2 * (i & 1)] += acc[i >> 1][nt][2 * (i & 1)] + add.x;
        xr[i >> 1][nt][2 * (i & 1) + 1] +=
            acc[i >> 1][nt][2 * (i & 1) + 1] + add.y;
      }
    }
    store_acc<2>(Hs, xr, wm, wn, g, tig);
    sync_staged();
    cur ^= 1;
    if (!p.cross_bias) {
      const float* ada =
          p.adaln + (static_cast<size_t>(layer) * 2 + 1) * 2 * kC;
      norm_tile(As, Hs, ty, tx, ld4(ada + tx * 4), ld4(ada + kC + tx * 4),
                true);
      sync_staged();
      // the cross-attention's queries, through bf16, into Hs
      stage_w<64>(WB(cur ^ 1), p.wproj_c, wb, lw, kC, 0, kC);
      zero<2>(acc);
      mma_tile<2>(As, WB(cur), wb, acc);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float2 bq = ld2(p.bq_c + lb + 8 * (2 * wn + nt) + 2 * tig);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            acc[mt][nt][2 * hf] =
                bf16r((acc[mt][nt][2 * hf] + bq.x) * kQScale);
            acc[mt][nt][2 * hf + 1] =
                bf16r((acc[mt][nt][2 * hf + 1] + bq.y) * kQScale);
          }
      }
      store_acc<2>(Hs, acc, wm, wn, g, tig);
      sync_staged();
      cur ^= 1;
      // a (row, head) a thread, row-wise: Hs -> attention -> As
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int b, rb, tok;
        tile_row<PACKED>(p, item, ty + 16 * i, b, rb, tok);
        float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
        if (tok < p.L) {
          const float4 qv = ld4(Hs + (ty + 16 * i) * kLda + tx * 4);
          const float q[4] = {qv.x, qv.y, qv.z, qv.w};
          const size_t off = (static_cast<size_t>(rb) * p.n_layer + layer) *
                                 p.sp * kC + tx * 4;
          o = cross_attend(p, p.kc + off, p.vc + off, q);
        }
        *reinterpret_cast<float4*>(As + (ty + 16 * i) * kLda + tx * 4) = o;
      }
      sync_staged();
      stage_w<64>(WB(cur ^ 1), p.wfc, wb, lfc, p.hidden, 0, kC);
      zero<2>(acc);
      mma_tile<2>(As, WB(cur), wb, acc);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float2 bias = ld2(p.bproj_c + lb + 8 * (2 * wn + nt) + 2 * tig);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            xr[mt][nt][2 * hf] += acc[mt][nt][2 * hf] + bias.x;
            xr[mt][nt][2 * hf + 1] += acc[mt][nt][2 * hf + 1] + bias.y;
          }
      }
      store_acc<2>(Hs, xr, wm, wn, g, tig);
      sync_staged();
      cur ^= 1;
    }
    // LN -> MLP, one chunk of 64 hidden units at a time; WB(cur) holds wfc's
    // first chunk
    norm_tile(As, Hs, ty, tx, ld4(p.ln2_s + lb + tx * 4),
              ld4(p.ln2_b + lb + tx * 4), false);
    sync_staged();
    float out[2][2][4];
    zero<2>(out);
    for (int c = 0; c < nch; ++c) {
      stage_w<64>(WB(cur ^ 1), p.wpj, wb,
                  lfc + static_cast<size_t>(c) * kC * kC, kC, 0, kC);
      zero<2>(acc);
      mma_tile<2>(As, WB(cur), wb, acc);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float2 bias = ld2(p.bfc + static_cast<size_t>(layer) * p.hidden +
                                c * kC + 8 * (2 * wn + nt) + 2 * tig);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {   // GELU2: h * sigmoid(1.702 h)
            const float hv = acc[mt][nt][e] + ((e & 1) ? bias.y : bias.x);
            acc[mt][nt][e] = hv / (1.f + expf(-1.702f * hv));
          }
      }
      store_acc<2>(Hs, acc, wm, wn, g, tig);
      sync_staged();
      cur ^= 1;
      if (c + 1 < nch)
        stage_w<64>(WB(cur ^ 1), p.wfc, wb, lfc, p.hidden, (c + 1) * kC, kC);
      mma_tile<2>(Hs, WB(cur), wb, out);
      sync_staged();
      cur ^= 1;
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = 8 * (2 * wn + nt) + 2 * tig;
      const float2 bias = ld2(p.bpj + lb + col);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (m.ok[i])
          *reinterpret_cast<float2*>(
              p.x + (static_cast<size_t>(m.rb[i]) * p.L + m.tok[i]) * kC +
              col) =
              make_float2(xr[i >> 1][nt][2 * (i & 1)] +
                              out[i >> 1][nt][2 * (i & 1)] + bias.x,
                          xr[i >> 1][nt][2 * (i & 1) + 1] +
                              out[i >> 1][nt][2 * (i & 1) + 1] + bias.y);
    }
  }
}
#else   // MK_SERVING

// The bound sum_d |q_d| max_keys |k_d| of each of the warp's queries (over
// the head's true dims). km: max |k| of the dims the thread holds in qa
// (zero past the head dim).
__device__ __forceinline__ void query_bounds(const float (&km)[kQA],
                                             const unsigned (&qa)[kMT][kQA],
                                             int tig,
                                             float (&bound)[kMT][2]) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      // the thread holds q's dims 2 tig, 2 tig + 1 (+ 8, + 16 ...) as bf16
      // pairs: register 4 q + hf (+ 2) of each 16-dim step, 4 kQ16 + hf of
      // the 8-dim one
      float b = 0.f;
#pragma unroll
      for (int r = 0; r < 2 * kQ16 + kQ8; ++r) {
        const int reg = r < 2 * kQ16 ? 4 * (r >> 1) + 2 * (r & 1) + hf
                                     : 4 * kQ16 + hf;
        const int kmi = r < 2 * kQ16 ? 2 * r : 4 * kQ16;
        const float q0 = __uint_as_float(qa[mt][reg] << 16);
        const float q1 = __uint_as_float(qa[mt][reg] & 0xffff0000u);
        const float t = fabsf(q0) * km[kmi] + fabsf(q1) * km[kmi + 1];
        b = r == 0 ? t : b + t;
      }
      bound[mt][hf] = quad_sum(b);
    }
}

// the same for wide heads: kt, the head's row of the key maxima in device
// memory; q's dims 8 r + 2 tig, + 1 read from the rows
__device__ __forceinline__ void query_bounds(const unsigned* kt,
                                             const QRows& qa, int tig,
                                             float (&bound)[kMT][2]) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float b = 0.f;
#pragma unroll 4
      for (int r = 0; r < kDS / 8; ++r) {
        const int dim = 8 * r + 2 * tig;
        const unsigned v = qa.r[mt][hf][4 * r + tig];
        const float k0 = dim < kD ? __uint_as_float(__ldcg(kt + dim)) : 0.f;
        const float k1 =
            dim + 1 < kD ? __uint_as_float(__ldcg(kt + dim + 1)) : 0.f;
        const float t = fabsf(__uint_as_float(v << 16)) * k0 +
                        fabsf(__uint_as_float(v & 0xffff0000u)) * k1;
        b = r == 0 ? t : b + t;
      }
      bound[mt][hf] = quad_sum(b);
    }
}

// The bound of each of the warp's queries (into st.ml, x log2(e)), and
// the maximum of the first 16 keys' scores (st.ml before that): whether the
// bound may serve for every query of the warp. km: load_kmax's.
template <class KM, class Q>
__device__ __forceinline__ bool shift_by_bound(const unsigned* ks,
                                               const unsigned* vs, int L,
                                               int g, int tig, const KM& km,
                                               const Q& qa, AttnState& st) {
  constexpr float kLog2e = 1.4426950408889634f;
  float bound[kMT][2];
  bool safe = true;
  query_bounds(km, qa, tig, bound);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) st.ml[mt][0] = st.ml[mt][1] = -INFINITY;
  if (L >= 16)
    attn_block<0, false>(ks, vs, 0, L, g, tig, qa, st, 0);
  else
    attn_block<0, true>(ks, vs, 0, L, g, tig, qa, st, 0);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float lower = quad_max(st.ml[mt][hf]);   // every lane shuffles
      safe = safe && bound[mt][hf] - lower <= kShiftSlack;
      st.ml[mt][hf] = bound[mt][hf] * kLog2e;
    }
  return __all_sync(0xffffffffu, safe) && !(MK_ABLATE & 8);
}

// the exact row maxima from st.ml's running maxima, x log2(e)
__device__ __forceinline__ void shift_by_max(AttnState& st) {
  constexpr float kLog2e = 1.4426950408889634f;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      st.ml[mt][hf] = quad_max(st.ml[mt][hf]) * kLog2e;
}

__device__ __forceinline__ void start_max(AttnState& st) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) st.ml[mt][0] = st.ml[mt][1] = -INFINITY;
}

// the warp's queries from row q0 on, rows q0 + 16 mt + 8 hf + g: per
// 16-dim step, registers (g, dims 2 tig, + 1), (g + 8, ...), (g, dims 2 tig
// + 8, + 9), (g + 8, ...); then the 8-dim step's (g, dims 2 tig, + 1), (g +
// 8, ...) (at head dim 4 the dims past 3 are zero). qg: the head's (L, DS)
// rows as bf16 pairs.
__device__ __forceinline__ void load_queries(const unsigned* qg, int q0, int L,
                                             int g, int tig,
                                             unsigned (&qa)[kMT][kQA]) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = q0 + 16 * mt + g + 8 * hf;
      const unsigned* qr = qg + static_cast<size_t>(row) * (kDS / 2);
      const bool ok = row < L;
#pragma unroll
      for (int q = 0; q < kQ16; ++q) {
        qa[mt][4 * q + hf] = ok ? qr[8 * q + tig] : 0u;
        qa[mt][4 * q + 2 + hf] = ok ? qr[8 * q + 4 + tig] : 0u;
      }
      if (kQ8)
        qa[mt][4 * kQ16 + hf] =
            (ok && 16 * kQ16 + 2 * tig < kDS) ? qr[8 * kQ16 + tig] : 0u;
    }
}

// wide heads: the rows themselves (past L: the last row)
__device__ __forceinline__ void load_queries(const unsigned* qg, int q0, int L,
                                             int g, int /*tig*/,
                                             QRows& qa) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      qa.r[mt][hf] = qg + static_cast<size_t>(min(q0 + 16 * mt + g + 8 * hf,
                                                   L - 1)) * (kDS / 2);
}

// max |k| over the head's keys of the dims the thread holds in qa
__device__ __forceinline__ void load_kmax(const Params& p, int rh, int tig,
                                          float (&km)[kQA]) {
  const unsigned* kt = p.kmax + static_cast<size_t>(rh) * kD;
#pragma unroll
  for (int r = 0; r < 2 * kQ16 + kQ8; ++r) {
    const int dim = r < 2 * kQ16 ? 16 * (r >> 1) + 8 * (r & 1) + 2 * tig
                                 : 16 * kQ16 + 2 * tig;
    const int kmi = r < 2 * kQ16 ? 2 * r : 4 * kQ16;
    km[kmi] = dim < kD ? __uint_as_float(__ldcg(kt + dim)) : 0.f;
    km[kmi + 1] = dim + 1 < kD ? __uint_as_float(__ldcg(kt + dim + 1)) : 0.f;
  }
}

// wide heads: where the head's maxima lie (read as the bound needs them)
__device__ __forceinline__ void load_kmax(const Params& p, int rh, int /*tig*/,
                                          const unsigned*& kt) {
  kt = p.kmax + static_cast<size_t>(rh) * kD;
}

// what load_kmax fills
using KMax = std::conditional<kWide, const unsigned*, float[kQA]>::type;

// P V of the warp's queries into the attention output, rows q0 + 16 mt + g
// (+ 8), the head's dims 8 (kNTA oc + nt) + 2 tig, + 1
__device__ __forceinline__ void store_attention(const Params& p, int r, int h,
                                                int q0, int g, int tig,
                                                const AttnState& st,
                                                int oc = 0) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = q0 + 16 * mt + g + 8 * hf;
      if (row >= p.L) continue;
      float* o = p.o + (static_cast<size_t>(r) * p.L + row) * kC + h * kD;
#pragma unroll
      for (int nt = 0; nt < kNTA; ++nt) {
        const int dim = 8 * (kNTA * oc + nt) + 2 * tig;
        if constexpr (kD % 2 == 0) {
          if (dim < kD)
            *reinterpret_cast<float2*>(o + dim) = make_float2(
                st.acc[mt][nt][2 * hf], st.acc[mt][nt][2 * hf + 1]);
        } else {
          if (dim < kD) o[dim] = st.acc[mt][nt][2 * hf];
          if (dim + 1 < kD) o[dim + 1] = st.acc[mt][nt][2 * hf + 1];
        }
      }
    }
}

// P V's sums back to zero (the next output chunk)
__device__ __forceinline__ void clear_acc(AttnState& st) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNTA; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) st.acc[mt][nt][c] = 0.f;
}

__device__ __forceinline__ void clear_sums(AttnState& st) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
    st.l[mt][0] = st.l[mt][1] = (MK_ABLATE & 2) ? 1.f : 0.f;
  clear_acc(st);
}

__device__ __forceinline__ void invert_sums(AttnState& st) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) st.l[mt][hf] = 1.f / quad_sum(st.l[mt][hf]);
}

// a head's nq query tiles are split over n_split items where that shortens
// the longest block's share (rounds of items x tiles an item)
__device__ __forceinline__ int query_splits(const Params& p, int nq) {
  const int n_heads = p.B * p.n_br * kH;
  const int grid = static_cast<int>(gridDim.x);
  int n_split = 1, best = ((n_heads + grid - 1) / grid) * nq;
  for (int sp = 2; sp <= nq; ++sp) {
    const int span = ((n_heads * sp + grid - 1) / grid) * ((nq + sp - 1) / sp);
    if (span < best) {
      best = span;
      n_split = sp;
    }
  }
  return n_split;
}

// stage keys k0 .. k0 + n - 1 (zero past L) of a head's K and V rows (bf16,
// DS wide in device memory) as rows of kRowS, by 16-byte cp.async (wider
// heads)
__device__ __forceinline__ void stage_keys(unsigned short* ks,
                                           unsigned short* vs,
                                           const __nv_bfloat16* kg,
                                           const __nv_bfloat16* vg, int k0,
                                           int n, int L) {
  constexpr int kU = kDS >= 8 ? kDS / 8 : 1;   // 16-byte units of a row
  for (int u = threadIdx.x; u < 2 * n * kU; u += kThreads) {
    const int which = u / (n * kU), rem = u % (n * kU);
    const int j = rem / kU, c = rem % kU;
    const bool in = k0 + j < L;
    const __nv_bfloat16* src = (which ? vg : kg) +
        static_cast<size_t>(in ? k0 + j : 0) * kDS + 8 * c;
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(
        (which ? vs : ks) + j * kRowS + 8 * c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(dst), "l"(src), "r"(in ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// A work item is one (row-branch, head), or a part of its queries. Its keys
// and values are staged once as they are, bf16 (head dim 4: 16 bytes a key,
// K as [key][4], V transposed to pairs of keys; wider heads: rows of kRowS),
// where the whole head fits the block's shared memory; the block then walks
// the head's queries kQTile at a time, a warp per 16 kMT, without a
// block-wide barrier. Per query the shift (shift_by_bound), then two sweeps
// over the keys: the row sum, then exp / sum -> bf16 -> P V. Two, because
// the probabilities are rounded to bf16 after the division by their row sum
// (an online rescale would round them elsewhere). Where a head does not fit
// (wider heads over long grids), phase_attention_streamed.
__device__ MK_PHASE_S void phase_attention_whole(const Params& p, unsigned char* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int L16 = (p.L + 15) & ~15;
  const unsigned* ksw = reinterpret_cast<const unsigned*>(smem);
  unsigned char* vsp = smem + static_cast<size_t>(L16) * 2 * kRowS;
  const unsigned* vsw = reinterpret_cast<const unsigned*>(vsp);
  const int nq = (p.L + kQTile - 1) / kQTile;
  const int n_split = query_splits(p, nq);
  const int n_items = p.B * p.n_br * kH * n_split;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int rh = item / n_split, part = item % n_split;
    const int qt0 = part * nq / n_split, qt1 = (part + 1) * nq / n_split;
    const int h = rh % kH;
    const int r = rh / kH;
    const size_t base = static_cast<size_t>(rh) * p.L;
    if constexpr (kDS == 4) {
      uint2* ks = reinterpret_cast<uint2*>(smem);
      uint4* vs = reinterpret_cast<uint4*>(vsp);
      const uint2* kg = reinterpret_cast<const uint2*>(p.k) + base;
      const uint2* vg = reinterpret_cast<const uint2*>(p.v) + base;
      const uint2 z2 = make_uint2(0u, 0u);
      for (int j = threadIdx.x; j < L16; j += kThreads)
        ks[j] = j < p.L ? kg[j] : z2;
      for (int j = threadIdx.x; j < L16 / 2; j += kThreads) {
        const uint2 a = 2 * j < p.L ? vg[2 * j] : z2;
        const uint2 b = 2 * j + 1 < p.L ? vg[2 * j + 1] : z2;
        vs[j] = make_uint4(__byte_perm(a.x, b.x, 0x5410),
                           __byte_perm(a.x, b.x, 0x7632),
                           __byte_perm(a.y, b.y, 0x5410),
                           __byte_perm(a.y, b.y, 0x7632));
      }
    } else {
      stage_keys(reinterpret_cast<unsigned short*>(smem),
                 reinterpret_cast<unsigned short*>(vsp), p.k + base * kDS,
                 p.v + base * kDS, 0, L16, p.L);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    KMax km;
    load_kmax(p, rh, tig, km);
    const unsigned* qg =
        reinterpret_cast<const unsigned*>(p.q) + base * (kDS / 2);
    __syncthreads();
    // (a warp whose queries lie past the end has nothing to do: no barrier
    // is met before the item ends)
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * kQTile + warp * 16 * kMT;
      if (q0 >= p.L) break;
      Queries qa;
      AttnState st;
      load_queries(qg, q0, p.L, g, tig, qa);
      if (MK_ABLATE & 1) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) st.ml[mt][0] = st.ml[mt][1] = 0.f;
      } else if (!shift_by_bound(ksw, vsw, p.L, g, tig, km, qa, st)) {
        start_max(st);
        attn_sweep<0>(ksw, vsw, 0, p.L, g, tig, qa, st);
        shift_by_max(st);
      }
      clear_sums(st);
      if (!(MK_ABLATE & 2)) attn_sweep<1>(ksw, vsw, 0, p.L, g, tig, qa, st);
      invert_sums(st);
      for (int oc = 0; oc < kNOC; ++oc) {   // (one chunk unless wide)
        if (oc) clear_acc(st);
        attn_sweep<2>(ksw, vsw, 0, p.L, g, tig, qa, st, oc);
        store_attention(p, r, h, q0, g, tig, st, oc);
      }
    }
    __syncthreads();   // every warp has read the staged keys and values
  }
}

// One sweep over all keys of a head that does not fit shared memory: tiles
// of kSKT keys through kSBuf buffers (with two, the next tile's copy in
// flight while this one is read), the whole block in step. active: whether
// this warp computes (every warp meets the barriers); oc: SWEEP 2's output
// chunk.
template <int SWEEP, class Q>
__device__ __forceinline__ void stream_sweep(const Params& p,
                                             unsigned char* smem,
                                             const __nv_bfloat16* kg,
                                             const __nv_bfloat16* vg,
                                             bool active, int g, int tig,
                                             const Q& qa, AttnState& st,
                                             int oc = 0) {
  constexpr int kTile = kSKT * kRowS;   // bf16 of a K (or V) tile
  unsigned short* buf = reinterpret_cast<unsigned short*>(smem);
  const int nt = (p.L + kSKT - 1) / kSKT;
  stage_keys(buf, buf + kSBuf * kTile, kg, vg, 0, kSKT, p.L);
  for (int t = 0; t < nt; ++t) {
    if (kSBuf == 2 && t + 1 < nt) {
      const int o = ((t + 1) & 1) * kTile;
      stage_keys(buf + o, buf + 2 * kTile + o, kg, vg, (t + 1) * kSKT, kSKT,
                 p.L);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    if (active) {
      const int o = kSBuf == 2 ? (t & 1) * kTile : 0;
      attn_sweep<SWEEP>(
          reinterpret_cast<const unsigned*>(buf + o),
          reinterpret_cast<const unsigned*>(buf + kSBuf * kTile + o), 0,
          min(kSKT, p.L - t * kSKT), g, tig, qa, st, oc);
    }
    __syncthreads();   // the tile is read: its buffer may be refilled
    if (kSBuf == 1 && t + 1 < nt)
      stage_keys(buf, buf + kTile, kg, vg, (t + 1) * kSKT, kSKT, p.L);
  }
}

// Phase S where a head's keys and values do not fit a block's shared
// memory: per query tile, the block streams the keys once for the shift's
// check (the first tile), once more for the exact maxima if a warp needs
// them, then for the row sum and for P V.
__device__ MK_PHASE_S void phase_attention_streamed(
    const Params& p, unsigned char* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int nq = (p.L + kQTile - 1) / kQTile;
  const int n_split = query_splits(p, nq);
  const int n_items = p.B * p.n_br * kH * n_split;
  unsigned short* buf = reinterpret_cast<unsigned short*>(smem);
  const unsigned* ksw = reinterpret_cast<const unsigned*>(buf);
  const unsigned* vsw =
      reinterpret_cast<const unsigned*>(buf + kSBuf * kSKT * kRowS);
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int rh = item / n_split, part = item % n_split;
    const int qt0 = part * nq / n_split, qt1 = (part + 1) * nq / n_split;
    const int h = rh % kH;
    const int r = rh / kH;
    const size_t base = static_cast<size_t>(rh) * p.L;
    const __nv_bfloat16* kg = p.k + base * kDS;
    const __nv_bfloat16* vg = p.v + base * kDS;
    const unsigned* qg =
        reinterpret_cast<const unsigned*>(p.q) + base * (kDS / 2);
    KMax km;
    load_kmax(p, rh, tig, km);
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * kQTile + warp * 16 * kMT;
      Queries qa;
      AttnState st;
      load_queries(qg, q0, p.L, g, tig, qa);
      // the first tile, for the shift's check against the first 16 keys
      stage_keys(buf, buf + kSBuf * kSKT * kRowS, kg, vg, 0, kSKT, p.L);
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      bool by_bound = true;
      if (MK_ABLATE & 1) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) st.ml[mt][0] = st.ml[mt][1] = 0.f;
      } else {
        by_bound = shift_by_bound(ksw, vsw, min(p.L, kSKT), g, tig, km, qa,
                                  st);
      }
      // (a barrier: the first tile is read)
      if (__syncthreads_or(!by_bound)) {
        if (!by_bound) start_max(st);
        stream_sweep<0>(p, smem, kg, vg, !by_bound, g, tig, qa, st);
        if (!by_bound) shift_by_max(st);
      }
      clear_sums(st);
      if (!(MK_ABLATE & 2))
        stream_sweep<1>(p, smem, kg, vg, true, g, tig, qa, st);
      invert_sums(st);
      for (int oc = 0; oc < kNOC; ++oc) {   // (one chunk unless wide)
        if (oc) clear_acc(st);
        stream_sweep<2>(p, smem, kg, vg, true, g, tig, qa, st, oc);
        store_attention(p, r, h, q0, g, tig, st, oc);
      }
    }
  }
}

__device__ __forceinline__ void phase_self_attention(const Params& p,
                                                     unsigned char* smem) {
  if (kDS == 4 || p.keys_whole)
    phase_attention_whole(p, smem);
  else
    phase_attention_streamed(p, smem);
}

// q . bf16(k) over a head's dims, summed dim after dim
__device__ __forceinline__ float cross_score(const float (&q)[kD],
                                             const float* k) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < kD; d += 4) {
    const float4 kv = __ldg(reinterpret_cast<const float4*>(k + d));
    s = d == 0 ? q[0] * bf16r(kv.x) : fmaf(q[d], bf16r(kv.x), s);
    s = fmaf(q[d + 1], bf16r(kv.y), s);
    s = fmaf(q[d + 2], bf16r(kv.z), s);
    s = fmaf(q[d + 3], bf16r(kv.w), s);
  }
  return s;
}

// cross-attention of one (row, head) over the first s_valid of the
// condition's keys, read from device memory: q, the head's dims (rounded
// already); kc, vc: the (row-branch, layer)'s first key and value at this
// head's columns (row stride n_embd); o: the head's dims of the output
__device__ __forceinline__ void cross_attend(const Params& p,
                                             const float* kc,
                                             const float* vc,
                                             const float* q, float* o) {
  float qv[kD];
#pragma unroll
  for (int d = 0; d < kD; d += 4) {
    const float4 v = ld4(q + d);
    qv[d] = v.x;
    qv[d + 1] = v.y;
    qv[d + 2] = v.z;
    qv[d + 3] = v.w;
  }
  float mx = -INFINITY;
  for (int j = 0; j < p.s_valid; ++j)
    mx = fmaxf(mx, cross_score(qv, kc + j * kC));
  float l = 0.f;
  for (int j = 0; j < p.s_valid; ++j)
    l += expf(cross_score(qv, kc + j * kC) - mx);
  float ov[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) ov[d] = 0.f;
  for (int j = 0; j < p.s_valid; ++j) {
    const float pj = bf16r(expf(cross_score(qv, kc + j * kC) - mx) / l);
#pragma unroll
    for (int d = 0; d < kD; d += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(vc + j * kC + d));
      ov[d] = fmaf(pj, bf16r(v.x), ov[d]);
      ov[d + 1] = fmaf(pj, bf16r(v.y), ov[d + 1]);
      ov[d + 2] = fmaf(pj, bf16r(v.z), ov[d + 2]);
      ov[d + 3] = fmaf(pj, bf16r(v.w), ov[d + 3]);
    }
  }
#pragma unroll
  for (int d = 0; d < kD; d += 4)
    *reinterpret_cast<float4*>(o + d) =
        make_float4(ov[d], ov[d + 1], ov[d + 2], ov[d + 3]);
}

// cross_attend for heads whose dim is no multiple of 4 or wider than 128:
// q is read where it lies, dim by dim (no float4 fits its columns, or the
// registers would not hold it), and the scores, summed in cross_score's
// order, are recomputed for each chunk of kCrossOD output dims
constexpr bool kCrossVec = kD % 4 == 0 && kD <= 128;
constexpr int kCrossOD = 32;

__device__ __forceinline__ float cross_score_any(const float* q,
                                                 const float* k) {
  float s = q[0] * bf16r(__ldg(k));
  for (int d = 1; d < kD; ++d) s = fmaf(q[d], bf16r(__ldg(k + d)), s);
  return s;
}

__device__ __forceinline__ void cross_attend_any(const Params& p,
                                                 const float* kc,
                                                 const float* vc,
                                                 const float* q, float* o) {
  float mx = -INFINITY;
  for (int j = 0; j < p.s_valid; ++j)
    mx = fmaxf(mx, cross_score_any(q, kc + j * kC));
  float l = 0.f;
  for (int j = 0; j < p.s_valid; ++j)
    l += expf(cross_score_any(q, kc + j * kC) - mx);
  for (int d0 = 0; d0 < kD; d0 += kCrossOD) {
    float ov[kCrossOD];
#pragma unroll
    for (int d = 0; d < kCrossOD; ++d) ov[d] = 0.f;
    for (int j = 0; j < p.s_valid; ++j) {
      const float pj =
          bf16r(expf(cross_score_any(q, kc + j * kC) - mx) / l);
#pragma unroll
      for (int d = 0; d < kCrossOD; ++d)
        if (d0 + d < kD)
          ov[d] = fmaf(pj, bf16r(__ldg(vc + j * kC + d0 + d)), ov[d]);
    }
#pragma unroll
    for (int d = 0; d < kCrossOD; ++d)
      if (d0 + d < kD) o[d0 + d] = ov[d];
  }
}

// ---------------------------------------------------------------------------
// phase B: proj + residual -> cross -> LN -> MLP + residual
// ---------------------------------------------------------------------------
// The weight tiles of an item come in a fixed order and alternate between
// two buffers: each tile's product stages its successor before its own mma,
// and one block-wide barrier a tile publishes both that successor and the
// product's epilogue. The residual stream stays in registers, in the
// accumulator layout (past n_embd 256 it waits in the hidden state's
// scratch during the MLP, whose output chunks take the registers); it passes
// through shared memory only to be normalised row by row: through Hs where
// one chunk is the whole row, else through As in place.
#if !MK_WIDE
constexpr bool kResidualOut = kNCH > 4;
#endif

// output chunk j of layer's (C, C) weight w
__device__ __forceinline__ WTile layer_tile(const void* w, int layer, int j) {
  return WTile{w, static_cast<size_t>(layer) * kC * kC, kC, 64 * j,
               min(64, kC - 64 * j), kC};
}
#if MK_WG

// LN of the tile's rows of the hidden state into the slab As (plus1: the
// AdaLN form; planes: as norm_row's), then the barrier that publishes it
template <bool PACKED>
__device__ __forceinline__ void norm_tile_rows(const Params& p, int item,
                                               float* As, const float* scale,
                                               const float* shift,
                                               bool plus1, bool planes) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int b, rb, tok;
    tile_row<PACKED>(p, item, ty + 16 * i, b, rb, tok);
    norm_row(As, ty + 16 * i, tx,
             tok < p.L ? p.x + (static_cast<size_t>(rb) * p.L + tok) * kC
                       : nullptr,
             scale, shift, plus1, planes);
  }
  if (planes)
    slab_written();
  else
    sync_staged();
}

// Phase B with bf16 weights: every product on wgmma (wg_product), each
// epilogue the shared tile's per element. The slabs hold bf16 planes: As
// the product's input rows, Hs the MLP's hidden units (p.hidden columns);
// the residual stream is the hidden state x itself (each product's
// epilogue adds its columns there), LayerNorm reads its rows back from
// there; the cross-attention's output waits in Hs in f32 (row stride kC)
// before it is split into As.
template <bool PACKED>
__device__ void phase_mlp_wg(const Params& p, int layer) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n_items = tile_items<PACKED>(p);
  const size_t lb = static_cast<size_t>(layer) * kC;
  float* Hs = block_slab(p, 1);
  // phase S has read this layer's key maxima: clear them for the next
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < p.B * p.n_br * kCT;
       i += gridDim.x * kThreads)
    p.kmax[i] = 0u;
  Ring rg = ring_begin(block_smem());
  float* As = kActShared ? reinterpret_cast<float*>(rg.act)
                         : block_slab(p, 0);
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const WgRows m = wg_rows<PACKED>(p, item);
    wg_prefetch(p, rg, M_ACT, M_WPROJ, layer, kC, kC);
    // the attention output -> As
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int b, rb, tok;
      tile_row<PACKED>(p, item, ty + 16 * i, b, rb, tok);
      copy_row(As, ty + 16 * i, tx,
               tok < p.L ? p.o + (static_cast<size_t>(rb) * p.L + tok) * kC
                         : nullptr, true);
    }
    slab_written();
    // proj + residual (+ the cross-attention bias)
    rg.n = wg_product(p, rg, M_ACT, M_WPROJ, layer, kC, kC, m,
                      WgOut{E_RESIDUAL, p.bproj, p.cross_bias, nullptr},
                      true);
    __syncthreads();
    if (!p.cross_bias) {
      const float* ada =
          p.adaln + (static_cast<size_t>(layer) * 2 + 1) * 2 * kC;
      wg_prefetch(p, rg, M_ACT, M_WQC, layer, kC, kC);
      norm_tile_rows<PACKED>(p, item, As, ada, ada + kC, true, true);
      // the cross-attention's queries, through bf16, into this item's rows
      // of the attention output in device memory (read already)
      rg.n = wg_product(p, rg, M_ACT, M_WQC, layer, kC, kC, m,
                        WgOut{E_QUERY, nullptr, 0, nullptr}, true);
      __syncthreads();
      // a (row, head) a thread: the queries -> attention -> Hs -> As
      for (int it = threadIdx.x; it < kRows * kH; it += kThreads) {
        const int r = it / kH, h = it % kH;
        int b, rb, tok;
        tile_row<PACKED>(p, item, r, b, rb, tok);
        float* o = Hs + r * kC + h * kD;
        if (tok < p.L) {
          const float* q =
              p.o + (static_cast<size_t>(rb) * p.L + tok) * kC + h * kD;
          const size_t off = (static_cast<size_t>(rb) * p.n_layer + layer) *
                                 p.sp * kC + h * kD;
          if constexpr (kCrossVec)
            cross_attend(p, p.kc + off, p.vc + off, q, o);
          else
            cross_attend_any(p, p.kc + off, p.vc + off, q, o);
        }
      }
      __syncthreads();
      wg_prefetch(p, rg, M_ACT, M_WPROJC, layer, kC, kC);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int b, rb, tok;
        tile_row<PACKED>(p, item, ty + 16 * i, b, rb, tok);
        copy_row(As, ty + 16 * i, tx,
                 tok < p.L ? Hs + (ty + 16 * i) * kC : nullptr, true);
      }
      slab_written();
      rg.n = wg_product(p, rg, M_ACT, M_WPROJC, layer, kC, kC, m,
                        WgOut{E_RESIDUAL, p.bproj_c, 0, nullptr}, true);
      __syncthreads();
    }
    // LN -> the MLP's hidden units through GELU2 into Hs
    wg_prefetch(p, rg, M_ACT, M_WFC, layer, kC, p.hidden);
    norm_tile_rows<PACKED>(p, item, As, p.ln2_s + lb, p.ln2_b + lb, false,
                           true);
    rg.n = wg_product(p, rg, M_ACT, M_WFC, layer, kC, p.hidden, m,
                      WgOut{E_GELU, nullptr, 0, Hs}, true);
    slab_written();
    // x += Hs x wpj + bias
    rg.n = wg_product(p, rg, M_HACT, M_WPJ, layer, p.hidden, kC, m,
                      WgOut{E_RESIDUAL, p.bpj, 0, nullptr});
  }
  ring_end(rg);
}
#endif

#if MK_WIDE

// Phase B with f32 weights above n_embd 512, where neither a row of the
// tile nor the residual stream's chunks fit the block: the residual stream
// is the hidden state itself (each product's epilogue adds its chunk
// there, in the accumulator layout, as the registers' copy would),
// LayerNorm reads its rows back from there into the slab As, and the MLP's
// hidden units go whole to the slab Hs (its output sums over them in the
// same order as a chunk at a time would). The cross-attention's output
// waits in Hs (row stride kC) before it is copied into As.

// x += As x w + bias (+ the cross-attention bias) over the output chunks of
// layer's (C, C) weight w; next: the tile after the product
template <bool PACKED>
__device__ __forceinline__ void residual_product(
    const Params& p, int layer, const RowMap& m, const float* As, float* W0,
    float* W1, int& cur, const void* w, const float* bias, bool cross_bias,
    const WTile& next) {
  const int tig = threadIdx.x & 3, wn = (threadIdx.x >> 5) >> 1;
  const size_t lb = static_cast<size_t>(layer) * kC;
  for (int j = 0; j < kNCH; ++j) {
    float acc[2][2][4];
    zero<2>(acc);
    chunk_product<64, 2>(As, W0, W1, cur, p.w_bf16, layer_tile(w, layer, j),
                         j + 1 < kNCH ? layer_tile(w, layer, j + 1) : next,
                         acc);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = 64 * j + 8 * (2 * wn + nt) + 2 * tig;
      if (col >= kC) continue;
      const float2 bv = ld2(bias + lb + col);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!m.ok[i]) continue;
        float2 add = bv;
        if (cross_bias) {
          const float2 cb = ld2(p.kc + (static_cast<size_t>(m.rb[i]) *
                                        p.n_layer + layer) * p.sp * kC + col);
          add.x += cb.x;
          add.y += cb.y;
        }
        float2* xp = reinterpret_cast<float2*>(
            p.x + (static_cast<size_t>(m.rb[i]) * p.L + m.tok[i]) * kC + col);
        float2 x = *xp;
        x.x += acc[i >> 1][nt][2 * (i & 1)] + add.x;
        x.y += acc[i >> 1][nt][2 * (i & 1) + 1] + add.y;
        *xp = x;
      }
    }
    sync_staged();
    cur ^= 1;
  }
}

template <bool PACKED>
__device__ MK_PHASE_B void phase_mlp(const Params& p, int layer, float* As,
                                     float* Hs, float* W0, float* W1) {
  if (p.w_bf16) {
    phase_mlp_wg<PACKED>(p, layer);
    return;
  }
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3, wm = warp & 1, wn = warp >> 1;
  const int n_items = tile_items<PACKED>(p);
  const int wb = p.w_bf16;
  const size_t lb = static_cast<size_t>(layer) * kC;
  const size_t lfc = static_cast<size_t>(layer) * kC * p.hidden;
  const int nhc = (p.hidden + 63) / 64;
  const WTile none{nullptr, 0, 0, 0, 0, 0};
  // output chunk j of a (C, C) weight; MLP chunk hc of wfc; output chunk j
  // of wpj over all the hidden units
  auto cw = [&](const void* w, int j) { return layer_tile(w, layer, j); };
  auto fc = [&](int hc) {
    return WTile{p.wfc, lfc, p.hidden, 64 * hc, min(64, p.hidden - 64 * hc),
                 kC};
  };
  auto pj = [&](int j) {
    return WTile{p.wpj, lfc, kC, 64 * j, min(64, kC - 64 * j), p.hidden};
  };
  // phase S has read this layer's key maxima: clear them for the next
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < p.B * p.n_br * kCT;
       i += gridDim.x * kThreads)
    p.kmax[i] = 0u;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const RowMap m = map_rows<PACKED>(p, item, wm, g);
    int cur = 0;   // the buffer that holds the next product's weights
    float acc[2][2][4];
    // the attention output -> As
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int b, rb, tok;
      tile_row<PACKED>(p, item, ty + 16 * i, b, rb, tok);
      copy_row(As, ty + 16 * i, tx,
               tok < p.L ? p.o + (static_cast<size_t>(rb) * p.L + tok) * kC
                         : nullptr, false);
    }
    stage_tile<64>(WB(cur), cw(p.wproj, 0), 0, wb);
    sync_staged();
    // proj + residual (+ the cross-attention bias)
    residual_product<PACKED>(p, layer, m, As, W0, W1, cur, p.wproj, p.bproj,
                             p.cross_bias,
                             p.cross_bias ? fc(0) : cw(p.wq_c, 0));
    if (!p.cross_bias) {
      const float* ada =
          p.adaln + (static_cast<size_t>(layer) * 2 + 1) * 2 * kC;
      norm_tile_rows<PACKED>(p, item, As, ada, ada + kC, true, false);
      // the cross-attention's queries, through bf16, into this item's rows
      // of the attention output in device memory (read already)
      for (int j = 0; j < kNCH; ++j) {
        zero<2>(acc);
        chunk_product<64, 2>(As, W0, W1, cur, wb, cw(p.wq_c, j),
                             j + 1 < kNCH ? cw(p.wq_c, j + 1)
                                          : cw(p.wproj_c, 0),
                             acc);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = 64 * j + 8 * (2 * wn + nt) + 2 * tig;
          if (col >= kC) continue;
          const float2 bq = ld2(p.bq_c + lb + col);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (m.ok[i])
              *reinterpret_cast<float2*>(
                  p.o + (static_cast<size_t>(m.rb[i]) * p.L + m.tok[i]) * kC +
                  col) =
                  make_float2(
                      bf16r((acc[i >> 1][nt][2 * (i & 1)] + bq.x) * p.qscale),
                      bf16r((acc[i >> 1][nt][2 * (i & 1) + 1] + bq.y) *
                            p.qscale));
        }
        sync_staged();
        cur ^= 1;
      }
      // a (row, head) a thread: the queries -> attention -> Hs -> As
      for (int it = threadIdx.x; it < kRows * kH; it += kThreads) {
        const int r = it / kH, h = it % kH;
        int b, rb, tok;
        tile_row<PACKED>(p, item, r, b, rb, tok);
        float* o = Hs + r * kC + h * kD;
        if (tok < p.L) {
          const float* q =
              p.o + (static_cast<size_t>(rb) * p.L + tok) * kC + h * kD;
          const size_t off = (static_cast<size_t>(rb) * p.n_layer + layer) *
                                 p.sp * kC + h * kD;
          if constexpr (kCrossVec)
            cross_attend(p, p.kc + off, p.vc + off, q, o);
          else
            cross_attend_any(p, p.kc + off, p.vc + off, q, o);
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int b, rb, tok;
        tile_row<PACKED>(p, item, ty + 16 * i, b, rb, tok);
        copy_row(As, ty + 16 * i, tx,
                 tok < p.L ? Hs + (ty + 16 * i) * kC : nullptr, false);
      }
      sync_staged();
      residual_product<PACKED>(p, layer, m, As, W0, W1, cur, p.wproj_c,
                               p.bproj_c, false, fc(0));
    }
    // LN -> the MLP's hidden units, a chunk of 64 at a time, into Hs;
    // WB(cur) holds wfc's first chunk
    norm_tile_rows<PACKED>(p, item, As, p.ln2_s + lb, p.ln2_b + lb, false,
                           false);
    for (int hc = 0; hc < nhc; ++hc) {
      zero<2>(acc);
      chunk_product<64, 2>(As, W0, W1, cur, wb, fc(hc),
                           hc + 1 < nhc ? fc(hc + 1) : pj(0), acc);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = 64 * hc + 8 * (2 * wn + nt) + 2 * tig;
        const float2 bias =
            col < p.hidden
                ? ld2(p.bfc + static_cast<size_t>(layer) * p.hidden + col)
                : make_float2(0.f, 0.f);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {   // GELU2: h * sigmoid(1.702 h)
            const float hv = acc[mt][nt][e] + ((e & 1) ? bias.y : bias.x);
            acc[mt][nt][e] = hv / (1.f + expf(-1.702f * hv));
          }
      }
      store_acc<64, 2>(Hs + kSlabChunk * hc, acc, wm, wn, g, tig);
      sync_staged();
      cur ^= 1;
    }
    // x += Hs x wpj + bias, an output chunk at a time
    for (int j = 0; j < kNCH; ++j) {
      zero<2>(acc);
      chunk_product<64, 2>(Hs, W0, W1, cur, wb, pj(j),
                           j + 1 < kNCH ? pj(j + 1) : none, acc);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = 64 * j + 8 * (2 * wn + nt) + 2 * tig;
        if (col >= kC) continue;
        const float2 bias = ld2(p.bpj + lb + col);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (m.ok[i]) {
            float2* xp = reinterpret_cast<float2*>(
                p.x + (static_cast<size_t>(m.rb[i]) * p.L + m.tok[i]) * kC +
                col);
            const float2 x0 = *xp;
            *xp = make_float2(x0.x + acc[i >> 1][nt][2 * (i & 1)] + bias.x,
                              x0.y + acc[i >> 1][nt][2 * (i & 1) + 1] +
                                  bias.y);
          }
      }
      sync_staged();
      cur ^= 1;
    }
  }
}
#else

// xr += As x w + bias (+ the cross-attention bias) over the output chunks
// of layer's (C, C) weight w, then xr -> Xs, the tile LN reads; next: the
// tile after the product
template <bool PACKED>
__device__ __forceinline__ void residual_product(
    const Params& p, int layer, const RowMap& m, const float* As, float* Xs,
    float* W0, float* W1, int& cur, const void* w, const float* bias,
    bool cross_bias, const WTile& next, float (&xr)[kNCH][2][2][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3, wm = warp & 1, wn = warp >> 1;
  const size_t lb = static_cast<size_t>(layer) * kC;
#pragma unroll
  for (int j = 0; j < kNCH; ++j) {
    float acc[2][2][4];
    zero<2>(acc);
    chunk_product<64, 2>(As, W0, W1, cur, p.w_bf16, layer_tile(w, layer, j),
                         j + 1 < kNCH ? layer_tile(w, layer, j + 1) : next,
                         acc);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = 64 * j + 8 * (2 * wn + nt) + 2 * tig;
      if (col >= kC) continue;
      const float2 bv = ld2(bias + lb + col);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float2 add = bv;
        if (cross_bias) {
          const float2 cb = ld2(p.kc + (static_cast<size_t>(m.rb[i]) *
                                        p.n_layer + layer) * p.sp * kC + col);
          add.x += cb.x;
          add.y += cb.y;
        }
        xr[j][i >> 1][nt][2 * (i & 1)] += acc[i >> 1][nt][2 * (i & 1)] + add.x;
        xr[j][i >> 1][nt][2 * (i & 1) + 1] +=
            acc[i >> 1][nt][2 * (i & 1) + 1] + add.y;
      }
    }
    if (j + 1 < kNCH) {
      sync_staged();
      cur ^= 1;
    }
  }
  if (kNCH > 1) __syncthreads();   // every warp has read As
#pragma unroll
  for (int j = 0; j < kNCH; ++j)
    store_acc<kLda, 2>(Xs + 64 * j, xr[j], wm, wn, g, tig);
  sync_staged();
  cur ^= 1;
}

template <bool PACKED>
__device__ MK_PHASE_B void phase_mlp(const Params& p, int layer, float* As, float* Hs,
                          float* W0, float* W1) {
  if (p.w_bf16) {
    phase_mlp_wg<PACKED>(p, layer);
    return;
  }
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3, wm = warp & 1, wn = warp >> 1;
  const int n_items = tile_items<PACKED>(p);
  const int wb = p.w_bf16;
  const size_t lb = static_cast<size_t>(layer) * kC;
  const size_t lfc = static_cast<size_t>(layer) * kC * p.hidden;
  const int nhc = (p.hidden + 63) / 64;
  float* Xs = kNCH == 1 ? Hs : As;
  const WTile none{nullptr, 0, 0, 0, 0, 0};
  // output chunk j of a (C, C) weight; MLP chunk hc of wfc; its rows of wpj
  auto cw = [&](const void* w, int j) { return layer_tile(w, layer, j); };
  auto fc = [&](int hc) {
    return WTile{p.wfc, lfc, p.hidden, 64 * hc, min(64, p.hidden - 64 * hc),
                 kC};
  };
  auto pj = [&](int hc, int j) {
    return WTile{p.wpj, lfc + static_cast<size_t>(64 * hc) * kC, kC, 64 * j,
                 min(64, kC - 64 * j), min(64, p.hidden - 64 * hc)};
  };
  // phase S has read this layer's key maxima: clear them for the next
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < p.B * p.n_br * kCT;
       i += gridDim.x * kThreads)
    p.kmax[i] = 0u;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const RowMap m = map_rows<PACKED>(p, item, wm, g);
    int cur = 0;   // the buffer that holds the next product's weights
    float xr[kNCH][2][2][4], acc[2][2][4];
    // the residual stream (accumulator layout); the attention output -> As
#pragma unroll
    for (int j = 0; j < kNCH; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = 64 * j + 8 * (2 * wn + nt) + 2 * tig;
          float2 v = make_float2(0.f, 0.f);
          if (m.ok[i] && col < kC)
            v = ld2(p.x + (static_cast<size_t>(m.rb[i]) * p.L + m.tok[i]) *
                              kC + col);
          xr[j][i >> 1][nt][2 * (i & 1)] = v.x;
          xr[j][i >> 1][nt][2 * (i & 1) + 1] = v.y;
        }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int b, rb, tok;
      tile_row<PACKED>(p, item, ty + 16 * i, b, rb, tok);
      float4 o[kNCH];
      if (tok < p.L) {
        load_row(p.o + (static_cast<size_t>(rb) * p.L + tok) * kC, tx, o);
      } else {
#pragma unroll
        for (int j = 0; j < kNCH; ++j) o[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < kNCH; ++j)
        *reinterpret_cast<float4*>(As + (ty + 16 * i) * kLda + 64 * j +
                                   tx * 4) = o[j];
    }
    stage_tile<64>(WB(cur), cw(p.wproj, 0), 0, wb);
    sync_staged();
    // proj + residual (+ the cross-attention bias)
    residual_product<PACKED>(p, layer, m, As, Xs, W0, W1, cur, p.wproj,
                             p.bproj, p.cross_bias,
                             p.cross_bias ? fc(0) : cw(p.wq_c, 0), xr);
    if (!p.cross_bias) {
      const float* ada =
          p.adaln + (static_cast<size_t>(layer) * 2 + 1) * 2 * kC;
      norm_tile<kLda>(As, Xs, ty, tx, ada, ada + kC, true);
      sync_staged();
      // the cross-attention's queries, through bf16: into Hs where one
      // chunk is the whole row, else into this item's rows of the attention
      // output in device memory (read already)
      for (int j = 0; j < kNCH; ++j) {
        zero<2>(acc);
        chunk_product<64, 2>(As, W0, W1, cur, wb, cw(p.wq_c, j),
                             j + 1 < kNCH ? cw(p.wq_c, j + 1)
                                          : cw(p.wproj_c, 0),
                             acc);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = 64 * j + 8 * (2 * wn + nt) + 2 * tig;
          const float2 bq =
              col < kC ? ld2(p.bq_c + lb + col) : make_float2(0.f, 0.f);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              acc[mt][nt][2 * hf] =
                  bf16r((acc[mt][nt][2 * hf] + bq.x) * p.qscale);
              acc[mt][nt][2 * hf + 1] =
                  bf16r((acc[mt][nt][2 * hf + 1] + bq.y) * p.qscale);
            }
          if (kNCH > 1 && col < kC) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (m.ok[i])
                *reinterpret_cast<float2*>(
                    p.o + (static_cast<size_t>(m.rb[i]) * p.L + m.tok[i]) *
                              kC + col) =
                    make_float2(acc[i >> 1][nt][2 * (i & 1)],
                                acc[i >> 1][nt][2 * (i & 1) + 1]);
          }
        }
        if (kNCH == 1) store_acc<kLda, 2>(Hs, acc, wm, wn, g, tig);
        sync_staged();
        cur ^= 1;
      }
      // a (row, head) a thread: the queries -> attention -> As
      for (int it = threadIdx.x; it < kRows * kH; it += kThreads) {
        const int r = it / kH, h = it % kH;
        int b, rb, tok;
        tile_row<PACKED>(p, item, r, b, rb, tok);
        float* o = As + r * kLda + h * kD;
        if (tok < p.L) {
          const float* q = kNCH == 1
              ? Hs + r * kLda + h * kD
              : p.o + (static_cast<size_t>(rb) * p.L + tok) * kC + h * kD;
          const size_t off = (static_cast<size_t>(rb) * p.n_layer + layer) *
                                 p.sp * kC + h * kD;
          if constexpr (kCrossVec)
            cross_attend(p, p.kc + off, p.vc + off, q, o);
          else
            cross_attend_any(p, p.kc + off, p.vc + off, q, o);
        } else if constexpr (kCrossVec) {
#pragma unroll
          for (int d = 0; d < kD; d += 4)
            *reinterpret_cast<float4*>(o + d) =
                make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
          for (int d = 0; d < kD; ++d) o[d] = 0.f;
        }
      }
      sync_staged();
      residual_product<PACKED>(p, layer, m, As, Xs, W0, W1, cur, p.wproj_c,
                               p.bproj_c, false, fc(0), xr);
    }
    // LN -> MLP, one chunk of 64 hidden units at a time; WB(cur) holds wfc's
    // first chunk
    norm_tile<kLda>(As, Xs, ty, tx, p.ln2_s + lb, p.ln2_b + lb, false);
    sync_staged();
    if (kResidualOut) {
#pragma unroll
      for (int j = 0; j < kNCH; ++j)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = 64 * j + 8 * (2 * wn + nt) + 2 * tig;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (m.ok[i] && col < kC)
              *reinterpret_cast<float2*>(
                  p.x + (static_cast<size_t>(m.rb[i]) * p.L + m.tok[i]) *
                            kC + col) =
                  make_float2(xr[j][i >> 1][nt][2 * (i & 1)],
                              xr[j][i >> 1][nt][2 * (i & 1) + 1]);
        }
    }
    float out[kNCH][2][2][4];
#pragma unroll
    for (int j = 0; j < kNCH; ++j) zero<2>(out[j]);
    for (int hc = 0; hc < nhc; ++hc) {
      zero<2>(acc);
      chunk_product<64, 2>(As, W0, W1, cur, wb, fc(hc), pj(hc, 0), acc);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = 64 * hc + 8 * (2 * wn + nt) + 2 * tig;
        const float2 bias =
            col < p.hidden
                ? ld2(p.bfc + static_cast<size_t>(layer) * p.hidden + col)
                : make_float2(0.f, 0.f);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {   // GELU2: h * sigmoid(1.702 h)
            const float hv = acc[mt][nt][e] + ((e & 1) ? bias.y : bias.x);
            acc[mt][nt][e] = hv / (1.f + expf(-1.702f * hv));
          }
      }
      store_acc<kLdh, 2>(Hs, acc, wm, wn, g, tig);
      sync_staged();
      cur ^= 1;
#pragma unroll
      for (int j = 0; j < kNCH; ++j) {
        chunk_product<64, 2, kLdh>(Hs, W0, W1, cur, wb, pj(hc, j),
                                   j + 1 < kNCH  ? pj(hc, j + 1)
                                   : hc + 1 < nhc ? fc(hc + 1)
                                                  : none,
                                   out[j]);
        sync_staged();
        cur ^= 1;
      }
    }
#pragma unroll
    for (int j = 0; j < kNCH; ++j)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = 64 * j + 8 * (2 * wn + nt) + 2 * tig;
        if (col >= kC) continue;
        const float2 bias = ld2(p.bpj + lb + col);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (m.ok[i]) {
            float2* xp = reinterpret_cast<float2*>(
                p.x + (static_cast<size_t>(m.rb[i]) * p.L + m.tok[i]) * kC +
                col);
            const float2 x0 = kResidualOut
                ? *xp
                : make_float2(xr[j][i >> 1][nt][2 * (i & 1)],
                              xr[j][i >> 1][nt][2 * (i & 1) + 1]);
            *xp = make_float2(x0.x + out[j][i >> 1][nt][2 * (i & 1)] + bias.x,
                              x0.y + out[j][i >> 1][nt][2 * (i & 1) + 1] +
                                  bias.y);
          }
      }
  }
}
#endif  // MK_WIDE
#endif  // MK_SERVING
#undef WB

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

// The class axis' inner loops (4096 classes x 4 passes a token) take their
// exponentials and logarithms by the special function unit's approximations
// (relative error ~1e-6): they feed a log-sum-exp, noise, or a comparison,
// never the hidden state.
__device__ __forceinline__ float gumbel_of(unsigned bits) {
  const float u = static_cast<float>(bits >> 8) * (1.f / 16777216.f);
  return -__logf(-__logf(u + 1e-30f) + 1e-30f);
}

// log(exp(a) + exp(b)) with one exponential
__device__ __forceinline__ float laddexp_fast(float a, float b) {
  return fmaxf(a, b) + __logf(1.f + __expf(-fabsf(a - b)));
}

// running log-sum-exp (m, s) over eight more values, the valid ones
__device__ __forceinline__ void lse_update(float& m, float& s,
                                           const float (&z)[8],
                                           const bool (&ok)[8]) {
  float mn = m;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (ok[j]) mn = fmaxf(mn, z[j]);
  float add = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (ok[j]) add += __expf(z[j] - mn);
  s = s * __expf(m - mn) + add;
  m = mn;
}

// Close a pass: a token's (m, s) lives in the 4 lanes of a quad in each of
// the 4 warps that share its rows. The quad is combined by shuffles, the
// warps through red[slot][wn] in shared memory, in a fixed order, so that
// every thread of the token holds the same log(sum) + max. (m0, s0): one
// more term. Block-wide: all threads call it.
__device__ __forceinline__ float lse_finish(float m, float s, float m0,
                                            float s0, float2* red, int slot,
                                            int wn, int tig) {
  const float mq = quad_max(m);
  const float sq = quad_sum(s * expf(m - mq));
  if (tig == 0) red[slot * 4 + wn] = make_float2(mq, sq);
  __syncthreads();
  float mt = m0;
#pragma unroll
  for (int w = 0; w < 4; ++w) mt = fmaxf(mt, red[slot * 4 + w].x);
  float st = s0 * expf(m0 - mt);
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const float2 v = red[slot * 4 + w];
    st += v.y * expf(v.x - mt);
  }
  __syncthreads();   // red is free for the next token
  return logf(st) + mt;
}

// A work item is a tile of 64 rows: under CFG 32 positions of a batch row in
// both branches (the packed row order, gathered from the hidden state of
// either kernel), else 64 positions. The class axis is walked in chunks of
// 128, once per reduction, each pass recomputing its logits on the tensor
// cores; a warp owns 32 rows x 32 classes of a chunk, so a thread holds NTOK
// tokens x 8 classes, and both branches of a token. The passes:
//   0  log-sum-exp of each branch's logits; under CFG also that of the
//      guided logits zu + g (zc - zu) and each branch's smallest logit;
//   1  (CFG) log-sum-exp of the guided log-probabilities. The plain version
//      clamps each branch's log-probabilities at -70 first; where no class of
//      the tile's tokens reaches the clamp (pass 0's minima say), the guided
//      normaliser follows from pass 0's three sums and this pass is skipped;
//   2  log-sum-exp of the posterior's inner term;
//   3  the posterior, the noise, the argmax; the token is written.
constexpr int kTailChunk = 128;

struct Sched {
  float ct_ct, ct_bt, qt_v, ct, qt1_v, bt, ct_at_p, ct_bt_p, ct_ct_p,
      om_ct_ct_p;
};

template <bool CFG>
struct TailTokens {
  static constexpr int N = CFG ? 2 : 4;
  int tok[N], cur[N];
  bool ok[N];
  float lse_c[N], lse_u[N], lse_n[N], lse_q[N];
  float lse_g[N];    // pass 0: log-sum-exp of the guided logits
  float min_c[N], min_u[N];
};
#if MK_SERVING

template <int PASS, bool CFG>
__device__ void tail_pass(const Params& p, const Sched& sd, int b,
                          const float* As, float* W0, float* W1, float2* red,
                          TailTokens<CFG>& tt) {
  constexpr int NTOK = CFG ? 2 : 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3, wm = warp & 1, wn = warp >> 1;
  const int kv = p.kv;
  const int nchunk = (kv + kTailChunk - 1) / kTailChunk;
  const float gd = p.guidance;
  const uint2 key = make_uint2(p.seed_lo, p.seed_hi);
  float m1[NTOK], s1[NTOK], m2[NTOK], s2[NTOK], m3[NTOK], s3[NTOK];
  float best[NTOK];
  int best_i[NTOK];
#pragma unroll
  for (int t = 0; t < NTOK; ++t) {
    m1[t] = m2[t] = m3[t] = kNegBig;
    s1[t] = s2[t] = s3[t] = 0.f;
    best[t] = -INFINITY;
    best_i[t] = 0;
    if (PASS == 0) tt.min_c[t] = tt.min_u[t] = INFINITY;
  }
  stage_w<kTailChunk>(W0, p.wlog, p.w_bf16, 0, kv, 0, min(kTailChunk, kv));
  sync_staged();   // the tile (first pass) and the chunk are whole
  for (int c = 0; c < nchunk; ++c) {
    const int c0 = c * kTailChunk;
    if (c + 1 < nchunk)
      stage_w<kTailChunk>((c & 1) ? W0 : W1, p.wlog, p.w_bf16, 0, kv,
                          c0 + kTailChunk,
                          min(kTailChunk, kv - c0 - kTailChunk));
    float acc[2][4][4];
    zero<4>(acc);
    mma_tile<4>(As, (c & 1) ? W1 : W0, p.w_bf16, acc);
    // this thread's 8 classes of the chunk: colb + 8 (e >> 1) + (e & 1)
    const int colb = c0 + 32 * wn + 2 * tig;
    bool cv[8];
    float bias[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int col = colb + 8 * (e >> 1) + (e & 1);
      cv[e] = col < kv;
      bias[e] = cv[e] ? p.blog[col] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < NTOK; ++t) {
      // this token's logits: cond zc, uncond zu
      float zc[8], zu[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (CFG) {
          zc[e] = acc[0][e >> 1][2 * t + (e & 1)] + bias[e];
          zu[e] = acc[1][e >> 1][2 * t + (e & 1)] + bias[e];
        } else {
          zc[e] = acc[t >> 1][e >> 1][2 * (t & 1) + (e & 1)] + bias[e];
          zu[e] = 0.f;
        }
      }
      if constexpr (PASS == 0) {
        lse_update(m1[t], s1[t], zc, cv);
        if (CFG) {
          lse_update(m2[t], s2[t], zu, cv);
          float zg[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            zg[e] = zu[e] + gd * (zc[e] - zu[e]);
            if (cv[e]) {
              tt.min_c[t] = fminf(tt.min_c[t], zc[e]);
              tt.min_u[t] = fminf(tt.min_u[t], zu[e]);
            }
          }
          lse_update(m3[t], s3[t], zg, cv);
        }
      } else {
        // the guided log-probabilities before their normaliser
        float r[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float lc = fmaxf(zc[e] - tt.lse_c[t], kClamp);
          if (CFG) {
            const float lu = fmaxf(zu[e] - tt.lse_u[t], kClamp);
            r[e] = lu + gd * (lc - lu);
          } else {
            r[e] = lc;
          }
        }
        if constexpr (PASS == 1) {
          lse_update(m1[t], s1[t], r, cv);
        } else {
          const bool is_mask = tt.cur[t] == kv;
          float q[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (CFG) r[e] = fmaxf(r[e] - tt.lse_n[t], kClamp);
            const bool is_v = tt.cur[t] == colb + 8 * (e >> 1) + (e & 1);
            q[e] = r[e] - (is_mask ? sd.ct_ct : (is_v ? sd.qt_v : sd.ct_bt));
          }
          if constexpr (PASS == 2) {
            lse_update(m1[t], s1[t], q, cv);
          } else {
#pragma unroll
            for (int np = 0; np < 2; ++np) {
              // The noise of a class is word (class & 3) of the Philox
              // block (class / 4, position, batch row), whichever thread
              // draws it. The two lanes that share a block of 4 classes
              // (tig even: words 0, 1; odd: 2, 3) draw one block each of
              // this pair of 8-class tiles and hand the other lane the
              // words it needs.
              unsigned bits[2][2] = {{0u, 0u}, {0u, 0u}};
              if (p.sample) {
                const int odd = tig & 1;
                const uint4 rnd = philox4x32_10(
                    make_uint4(
                        static_cast<unsigned>((colb + 8 * (2 * np + odd)) >> 2),
                        static_cast<unsigned>(tt.tok[t]),
                        static_cast<unsigned>(b), 0u), key);
                const unsigned o0 =
                    __shfl_xor_sync(0xffffffffu, odd ? rnd.x : rnd.z, 1);
                const unsigned o1 =
                    __shfl_xor_sync(0xffffffffu, odd ? rnd.y : rnd.w, 1);
                const unsigned w0 = odd ? rnd.z : rnd.x;
                const unsigned w1 = odd ? rnd.w : rnd.y;
                bits[0][0] = odd ? o0 : w0;
                bits[0][1] = odd ? o1 : w1;
                bits[1][0] = odd ? w0 : o0;
                bits[1][1] = odd ? w1 : o1;
              }
#pragma unroll
              for (int e2 = 0; e2 < 4; ++e2) {
                const int e = 4 * np + e2;
                const int col = colb + 8 * (e >> 1) + (e & 1);
                const bool is_v = tt.cur[t] == col;
                const float qt1 = is_mask ? sd.ct : (is_v ? sd.qt1_v : sd.bt);
                float post = laddexp_fast(q[e] - tt.lse_q[t] + sd.ct_at_p,
                                          sd.ct_bt_p) + qt1 + tt.lse_q[t];
                post = fminf(fmaxf(post, kClamp), 0.f);
                if (p.sample) post += gumbel_of(bits[e2 >> 1][e2 & 1]);
                if (cv[e] && post > best[t]) {
                  best[t] = post;
                  best_i[t] = col;
                }
              }
            }
          }
        }
      }
    }
    sync_staged();   // the next chunk is whole, this one is read
  }
  // close the pass: combine the quad and the 4 warps of each token
#pragma unroll
  for (int t = 0; t < NTOK; ++t) {
    const int slot = (CFG ? 16 : 32) * wm + 8 * t + g;
    if (PASS == 0) {
      tt.lse_c[t] = lse_finish(m1[t], s1[t], kNegBig, 0.f, red, slot, wn, tig);
      if (CFG) {
        tt.lse_u[t] =
            lse_finish(m2[t], s2[t], kNegBig, 0.f, red, slot, wn, tig);
        tt.lse_g[t] =
            lse_finish(m3[t], s3[t], kNegBig, 0.f, red, slot, wn, tig);
      }
    } else if (PASS == 1) {
      tt.lse_n[t] = lse_finish(m1[t], s1[t], kNegBig, 0.f, red, slot, wn, tig);
    } else if (PASS == 2) {
      // the MASK class's log(1e-30) term joins the sum once
      tt.lse_q[t] = lse_finish(m1[t], s1[t], kNeg30, 1.f, red, slot, wn, tig);
    } else {
      // ties go to the lowest class index, in the quad and across warps
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best[t], off);
        const int oi = __shfl_xor_sync(0xffffffffu, best_i[t], off);
        if (ob > best[t] || (ob == best[t] && oi < best_i[t])) {
          best[t] = ob;
          best_i[t] = oi;
        }
      }
      if (tig == 0)
        red[slot * 4 + wn] = make_float2(best[t], __int_as_float(best_i[t]));
      sync_staged();
      if (wn == 0 && tig == 0 && tt.ok[t]) {
        float bb = -INFINITY;
        int bi = 0;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float2 v = red[slot * 4 + w];
          const int oi = __float_as_int(v.y);
          if (v.x > bb || (v.x == bb && oi < bi)) {
            bb = v.x;
            bi = oi;
          }
        }
        const bool is_mask = tt.cur[t] == kv;
        float pm = laddexp(kNeg30 - tt.lse_q[t] + sd.om_ct_ct_p, sd.ct_ct_p) +
                   (is_mask ? 0.f : kNeg30) + tt.lse_q[t];
        pm = fminf(fmaxf(pm, kClamp), 0.f);
        if (p.sample)
          pm += gumbel_of(philox4x32_10(
              make_uint4(0xFFFFFFFFu, static_cast<unsigned>(tt.tok[t]),
                         static_cast<unsigned>(b), 0u), key).x);
        p.out[static_cast<size_t>(b) * p.L + tt.tok[t]] = pm > bb ? kv : bi;
      }
      sync_staged();   // red is free for the next token
    }
  }
}

template <bool CFG>
__device__ void phase_tail(const Params& p, float* As, float* Hs, float* W0,
                           float* W1) {
  constexpr int NTOK = CFG ? 2 : 4;
  constexpr int TT = CFG ? 32 : kRows;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, wm = warp & 1;
  const int ntile = (p.L + TT - 1) / TT;
  const int n_items = p.B * ntile;
  const float4 sc = ld4(p.lno_s + tx * 4), sh = ld4(p.lno_b + tx * 4);
  const float* s = p.sched;
  Sched sd;
  sd.ct_bt = s[1];
  sd.ct_ct = s[2];
  sd.bt = s[4];
  sd.ct = s[5];
  sd.ct_at_p = s[6];
  sd.ct_bt_p = s[7];
  sd.ct_ct_p = s[8];
  sd.om_ct_ct_p = s[9];
  sd.qt_v = laddexp(s[0], s[1]);
  sd.qt1_v = laddexp(s[3], s[4]);
  float2* red = reinterpret_cast<float2*>(Hs);

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int b = item / ntile;
    const int t0 = (item % ntile) * TT;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int rb = CFG ? b * 2 + ((r >> 4) & 1) : b;
      const int t = CFG ? t0 + (r >> 5) * 16 + (r & 15) : t0 + r;
      store_norm(As, r, tx,
                 t < p.L ? ld4(p.x + (static_cast<size_t>(rb) * p.L + t) * kC +
                               tx * 4)
                         : make_float4(0.f, 0.f, 0.f, 0.f),
                 sc, sh, false);
    }
    // this thread's tokens: slot t is row 8 t + g of the warp's 32 (CFG:
    // of its first 16, both branches)
    TailTokens<CFG> tt;
#pragma unroll
    for (int t = 0; t < NTOK; ++t) {
      tt.tok[t] = t0 + (CFG ? 16 : 32) * wm + 8 * t + g;
      tt.ok[t] = tt.tok[t] < p.L;
      tt.cur[t] = tt.ok[t]
          ? static_cast<int>(p.tokens[static_cast<size_t>(b) * p.L + tt.tok[t]])
          : 0;
      tt.lse_u[t] = tt.lse_n[t] = tt.lse_g[t] = 0.f;
    }
    tail_pass<0, CFG>(p, sd, b, As, W0, W1, red, tt);
    if (CFG) {
      // no class of these tokens under the clamp in either branch?
      bool free_of_clamp = true;
#pragma unroll
      for (int t = 0; t < NTOK; ++t) {
        // a token's classes are spread over a quad and 4 warps: every one of
        // them votes on its own classes' minimum
        free_of_clamp = free_of_clamp &&
                        tt.min_c[t] - tt.lse_c[t] >= kClamp &&
                        tt.min_u[t] - tt.lse_u[t] >= kClamp;
        tt.lse_n[t] = tt.lse_g[t] -
                      (tt.lse_u[t] + p.guidance * (tt.lse_c[t] - tt.lse_u[t]));
      }
      if (!__syncthreads_and(free_of_clamp))
        tail_pass<1, CFG>(p, sd, b, As, W0, W1, red, tt);
    }
    tail_pass<2, CFG>(p, sd, b, As, W0, W1, red, tt);
    tail_pass<3, CFG>(p, sd, b, As, W0, W1, red, tt);
  }
}
#else   // MK_SERVING

template <int PASS, bool CFG>
__device__ void tail_pass(const Params& p, const Sched& sd, int b,
                          const float* As, float* W0, float* W1, float2* red,
                          TailTokens<CFG>& tt) {
  constexpr int NTOK = CFG ? 2 : 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3, wm = warp & 1, wn = warp >> 1;
  const int kv = p.kv;
  const int nchunk = (kv + kTailChunk - 1) / kTailChunk;
  const float gd = p.guidance;
  const uint2 key = make_uint2(p.seed_lo, p.seed_hi);
  float m1[NTOK], s1[NTOK], m2[NTOK], s2[NTOK], m3[NTOK], s3[NTOK];
  float best[NTOK];
  int best_i[NTOK];
#pragma unroll
  for (int t = 0; t < NTOK; ++t) {
    m1[t] = m2[t] = m3[t] = kNegBig;
    s1[t] = s2[t] = s3[t] = 0.f;
    best[t] = -INFINITY;
    best_i[t] = 0;
    if (PASS == 0) tt.min_c[t] = tt.min_u[t] = INFINITY;
  }
  // class chunk c of the logits' weight (rows: n_embd, in 64-deep tiles)
  auto logits = [&](int c) {
    return WTile{p.wlog, 0, kv, c * kTailChunk,
                 min(kTailChunk, kv - c * kTailChunk), kC};
  };
  const WTile none{nullptr, 0, 0, 0, 0, 0};
  int cur = 0;
  stage_tile<kTailChunk>(W0, logits(0), 0, p.w_bf16);
  sync_staged();   // the tile (first pass) and the chunk are whole
  for (int c = 0; c < nchunk; ++c) {
    const int c0 = c * kTailChunk;
    float acc[2][4][4];
    zero<4>(acc);
    chunk_product<kTailChunk, 4>(As, W0, W1, cur, p.w_bf16, logits(c),
                                 c + 1 < nchunk ? logits(c + 1) : none, acc);
    // this thread's 8 classes of the chunk: colb + 8 (e >> 1) + (e & 1)
    const int colb = c0 + 32 * wn + 2 * tig;
    bool cv[8];
    float bias[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int col = colb + 8 * (e >> 1) + (e & 1);
      cv[e] = col < kv;
      bias[e] = cv[e] ? p.blog[col] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < NTOK; ++t) {
      // this token's logits: cond zc, uncond zu
      float zc[8], zu[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (CFG) {
          zc[e] = acc[0][e >> 1][2 * t + (e & 1)] + bias[e];
          zu[e] = acc[1][e >> 1][2 * t + (e & 1)] + bias[e];
        } else {
          zc[e] = acc[t >> 1][e >> 1][2 * (t & 1) + (e & 1)] + bias[e];
          zu[e] = 0.f;
        }
      }
      if constexpr (PASS == 0) {
        lse_update(m1[t], s1[t], zc, cv);
        if (CFG) {
          lse_update(m2[t], s2[t], zu, cv);
          float zg[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            zg[e] = zu[e] + gd * (zc[e] - zu[e]);
            if (cv[e]) {
              tt.min_c[t] = fminf(tt.min_c[t], zc[e]);
              tt.min_u[t] = fminf(tt.min_u[t], zu[e]);
            }
          }
          lse_update(m3[t], s3[t], zg, cv);
        }
      } else {
        // the guided log-probabilities before their normaliser
        float r[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float lc = fmaxf(zc[e] - tt.lse_c[t], kClamp);
          if (CFG) {
            const float lu = fmaxf(zu[e] - tt.lse_u[t], kClamp);
            r[e] = lu + gd * (lc - lu);
          } else {
            r[e] = lc;
          }
        }
        if constexpr (PASS == 1) {
          lse_update(m1[t], s1[t], r, cv);
        } else {
          const bool is_mask = tt.cur[t] == kv;
          float q[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (CFG) r[e] = fmaxf(r[e] - tt.lse_n[t], kClamp);
            const bool is_v = tt.cur[t] == colb + 8 * (e >> 1) + (e & 1);
            q[e] = r[e] - (is_mask ? sd.ct_ct : (is_v ? sd.qt_v : sd.ct_bt));
          }
          if constexpr (PASS == 2) {
            lse_update(m1[t], s1[t], q, cv);
          } else {
#pragma unroll
            for (int np = 0; np < 2; ++np) {
              // The noise of a class is word (class & 3) of the Philox
              // block (class / 4, position, batch row), whichever thread
              // draws it. The two lanes that share a block of 4 classes
              // (tig even: words 0, 1; odd: 2, 3) draw one block each of
              // this pair of 8-class tiles and hand the other lane the
              // words it needs.
              unsigned bits[2][2] = {{0u, 0u}, {0u, 0u}};
              if (p.sample) {
                const int odd = tig & 1;
                const uint4 rnd = philox4x32_10(
                    make_uint4(
                        static_cast<unsigned>((colb + 8 * (2 * np + odd)) >> 2),
                        static_cast<unsigned>(tt.tok[t]),
                        static_cast<unsigned>(b), 0u), key);
                const unsigned o0 =
                    __shfl_xor_sync(0xffffffffu, odd ? rnd.x : rnd.z, 1);
                const unsigned o1 =
                    __shfl_xor_sync(0xffffffffu, odd ? rnd.y : rnd.w, 1);
                const unsigned w0 = odd ? rnd.z : rnd.x;
                const unsigned w1 = odd ? rnd.w : rnd.y;
                bits[0][0] = odd ? o0 : w0;
                bits[0][1] = odd ? o1 : w1;
                bits[1][0] = odd ? w0 : o0;
                bits[1][1] = odd ? w1 : o1;
              }
#pragma unroll
              for (int e2 = 0; e2 < 4; ++e2) {
                const int e = 4 * np + e2;
                const int col = colb + 8 * (e >> 1) + (e & 1);
                const bool is_v = tt.cur[t] == col;
                const float qt1 = is_mask ? sd.ct : (is_v ? sd.qt1_v : sd.bt);
                float post = laddexp_fast(q[e] - tt.lse_q[t] + sd.ct_at_p,
                                          sd.ct_bt_p) + qt1 + tt.lse_q[t];
                post = fminf(fmaxf(post, kClamp), 0.f);
                if (p.sample) post += gumbel_of(bits[e2 >> 1][e2 & 1]);
                if (cv[e] && post > best[t]) {
                  best[t] = post;
                  best_i[t] = col;
                }
              }
            }
          }
        }
      }
    }
    sync_staged();   // the next chunk is whole, this one is read
    cur ^= 1;
  }
  // close the pass: combine the quad and the 4 warps of each token
#pragma unroll
  for (int t = 0; t < NTOK; ++t) {
    const int slot = (CFG ? 16 : 32) * wm + 8 * t + g;
    if (PASS == 0) {
      tt.lse_c[t] = lse_finish(m1[t], s1[t], kNegBig, 0.f, red, slot, wn, tig);
      if (CFG) {
        tt.lse_u[t] =
            lse_finish(m2[t], s2[t], kNegBig, 0.f, red, slot, wn, tig);
        tt.lse_g[t] =
            lse_finish(m3[t], s3[t], kNegBig, 0.f, red, slot, wn, tig);
      }
    } else if (PASS == 1) {
      tt.lse_n[t] = lse_finish(m1[t], s1[t], kNegBig, 0.f, red, slot, wn, tig);
    } else if (PASS == 2) {
      // the MASK class's log(1e-30) term joins the sum once
      tt.lse_q[t] = lse_finish(m1[t], s1[t], kNeg30, 1.f, red, slot, wn, tig);
    } else {
      // ties go to the lowest class index, in the quad and across warps
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best[t], off);
        const int oi = __shfl_xor_sync(0xffffffffu, best_i[t], off);
        if (ob > best[t] || (ob == best[t] && oi < best_i[t])) {
          best[t] = ob;
          best_i[t] = oi;
        }
      }
      if (tig == 0)
        red[slot * 4 + wn] = make_float2(best[t], __int_as_float(best_i[t]));
      sync_staged();
      if (wn == 0 && tig == 0 && tt.ok[t]) {
        float bb = -INFINITY;
        int bi = 0;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float2 v = red[slot * 4 + w];
          const int oi = __float_as_int(v.y);
          if (v.x > bb || (v.x == bb && oi < bi)) {
            bb = v.x;
            bi = oi;
          }
        }
        const bool is_mask = tt.cur[t] == kv;
        float pm = laddexp(kNeg30 - tt.lse_q[t] + sd.om_ct_ct_p, sd.ct_ct_p) +
                   (is_mask ? 0.f : kNeg30) + tt.lse_q[t];
        pm = fminf(fmaxf(pm, kClamp), 0.f);
        if (p.sample)
          pm += gumbel_of(philox4x32_10(
              make_uint4(0xFFFFFFFFu, static_cast<unsigned>(tt.tok[t]),
                         static_cast<unsigned>(b), 0u), key).x);
        p.out[static_cast<size_t>(b) * p.L + tt.tok[t]] = pm > bb ? kv : bi;
      }
      sync_staged();   // red is free for the next token
    }
  }
}

template <bool CFG>
__device__ MK_PHASE_T void phase_tail(const Params& p, float* As, float* Hs, float* W0,
                           float* W1) {
  constexpr int NTOK = CFG ? 2 : 4;
  constexpr int TT = CFG ? 32 : kRows;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, wm = warp & 1;
  const int ntile = (p.L + TT - 1) / TT;
  const int n_items = p.B * ntile;
#if !MK_WIDE
  float4 sc[kNCH], sh[kNCH];
  load_row(p.lno_s, tx, sc);
  load_row(p.lno_b, tx, sh);
#endif
  const float* s = p.sched;
  Sched sd;
  sd.ct_bt = s[1];
  sd.ct_ct = s[2];
  sd.bt = s[4];
  sd.ct = s[5];
  sd.ct_at_p = s[6];
  sd.ct_bt_p = s[7];
  sd.ct_ct_p = s[8];
  sd.om_ct_ct_p = s[9];
  sd.qt_v = laddexp(s[0], s[1]);
  sd.qt1_v = laddexp(s[3], s[4]);
  float2* red = reinterpret_cast<float2*>(Hs);

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int b = item / ntile;
    const int t0 = (item % ntile) * TT;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int rb = CFG ? b * 2 + ((r >> 4) & 1) : b;
      const int t = CFG ? t0 + (r >> 5) * 16 + (r & 15) : t0 + r;
#if MK_WIDE
      norm_row(As, r, tx,
               t < p.L ? p.x + (static_cast<size_t>(rb) * p.L + t) * kC
                       : nullptr,
               p.lno_s, p.lno_b, false, false);
#else
      float4 x[kNCH];
      if (t < p.L) {
        load_row(p.x + (static_cast<size_t>(rb) * p.L + t) * kC, tx, x);
      } else {
#pragma unroll
        for (int j = 0; j < kNCH; ++j) x[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      store_norm(As, r, tx, x, sc, sh, false);
#endif
    }
    // this thread's tokens: slot t is row 8 t + g of the warp's 32 (CFG:
    // of its first 16, both branches)
    TailTokens<CFG> tt;
#pragma unroll
    for (int t = 0; t < NTOK; ++t) {
      tt.tok[t] = t0 + (CFG ? 16 : 32) * wm + 8 * t + g;
      tt.ok[t] = tt.tok[t] < p.L;
      tt.cur[t] = tt.ok[t]
          ? static_cast<int>(p.tokens[static_cast<size_t>(b) * p.L + tt.tok[t]])
          : 0;
      tt.lse_u[t] = tt.lse_n[t] = tt.lse_g[t] = 0.f;
    }
    tail_pass<0, CFG>(p, sd, b, As, W0, W1, red, tt);
    if (CFG) {
      // no class of these tokens under the clamp in either branch?
      bool free_of_clamp = true;
#pragma unroll
      for (int t = 0; t < NTOK; ++t) {
        // a token's classes are spread over a quad and 4 warps: every one of
        // them votes on its own classes' minimum
        free_of_clamp = free_of_clamp &&
                        tt.min_c[t] - tt.lse_c[t] >= kClamp &&
                        tt.min_u[t] - tt.lse_u[t] >= kClamp;
        tt.lse_n[t] = tt.lse_g[t] -
                      (tt.lse_u[t] + p.guidance * (tt.lse_c[t] - tt.lse_u[t]));
      }
      if (!__syncthreads_and(free_of_clamp))
        tail_pass<1, CFG>(p, sd, b, As, W0, W1, red, tt);
    }
    tail_pass<2, CFG>(p, sd, b, As, W0, W1, red, tt);
    tail_pass<3, CFG>(p, sd, b, As, W0, W1, red, tt);
  }
}
#endif  // MK_SERVING

__device__ __forceinline__ void stamp(const Params& p, int& i) {
  if (p.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.stamps[i] = t;
  }
  ++i;
}
#if MK_SERVING

template <bool PACKED>
__device__ void step_body(const Params& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);
  float* Hs = As + kRows * kLda;
  float* W0 = Hs + kRows * kLda;
  float* W1 = W0 + kWBytes / 4;
  cg::grid_group grid = cg::this_grid();
  int si = 0;
  stamp(p, si);
  for (int layer = 0; layer < p.n_layer; ++layer) {
    phase_qkv<PACKED>(p, layer, As, W0, W1);
    grid.sync();
    stamp(p, si);
    phase_self_attention(p, smem);
    grid.sync();
    stamp(p, si);
    phase_mlp<PACKED>(p, layer, As, Hs, W0, W1);
    grid.sync();
    stamp(p, si);
  }
  if (p.n_br == 2)
    phase_tail<true>(p, As, Hs, W0, W1);
  else
    phase_tail<false>(p, As, Hs, W0, W1);
  if (p.stamps != nullptr) {   // uniform over the grid
    grid.sync();
    stamp(p, si);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
megakernel_step_packed_kernel(const Params p) { step_body<true>(p); }

__global__ void __launch_bounds__(kThreads, 2)
megakernel_step_branch_kernel(const Params p) { step_body<false>(p); }
#else   // MK_SERVING

#if MK_WG
// a 4-d bf16 tensor map (dims innermost first, strides of dims 1-3 in
// bytes) with boxes `box` in TMA's swizzle `sw`; false if refused (its
// CUresult in mha::wg::tma_error())
bool map_bf16(CUtensorMap* map, const void* base,
              const cuuint64_t (&dims)[4], const cuuint64_t (&strides)[3],
              const cuuint32_t (&box)[4], CUtensorMapSwizzle sw) {
  const mha::wg::EncodeTiled encode = mha::wg::encode_tiled();
  if (encode == nullptr) {
    mha::wg::tma_error() = -1;
    return false;
  }
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) mha::wg::tma_error() = static_cast<int>(r);
  return r == CUDA_SUCCESS;
}

// The tensor maps of the products with bf16 weights (wg_product) for a
// grid of `grid` blocks: each slab's planes as (64 elements: a 128-byte
// line, 8 rows of 8 columns; line, plane, block), boxes of (64, 64, 3)
// (the three planes' 64-deep chunks, 24 KB, as they lie; lines past the
// slab's columns read zero); each weight (k rows, n columns, row-major, by
// layer) as (n, k, layer), boxes of (64, 64) in the 128-byte swizzle.
// False if cuTensorMapEncodeTiled refused one (its CUresult in
// mha::wg::tma_error()).
bool wg_maps(Params& p, int grid) {
  using cu64 = cuuint64_t;
  auto slab = [&](Map m, const float* base, cu64 cols, int which) {
    const cu64 block = static_cast<cu64>(slab_floats(which, p.hidden)) * 4;
    return map_bf16(&p.maps[m], base,
                    {64, cols, 3, static_cast<cu64>(grid)},
                    {128, cols * 128, block}, {64, 64, 3, 1},
                    CU_TENSOR_MAP_SWIZZLE_NONE);
  };
  auto weight = [&](Map m, const void* base, cu64 k, cu64 n) {
    return map_bf16(&p.maps[m], base,
                    {n, k, static_cast<cu64>(p.n_layer), 1},
                    {n * 2, k * n * 2, k * n * 2 * p.n_layer},
                    {64, 64, 1, 1}, CU_TENSOR_MAP_SWIZZLE_128B);
  };
  const cu64 c = kC, h = p.hidden;
  return slab(M_ACT, p.act, c, 0) && slab(M_HACT, p.hact, h, 1) &&
         weight(M_WQKV, p.wqkv, c, 3 * c) && weight(M_WPROJ, p.wproj, c, c) &&
         weight(M_WQC, p.wq_c, c, c) && weight(M_WPROJC, p.wproj_c, c, c) &&
         weight(M_WFC, p.wfc, c, h) && weight(M_WPJ, p.wpj, h, c);
}
#endif

template <bool PACKED>
__device__ void step_body(const Params& p) {
  extern __shared__ __align__(16) unsigned char smem[];
#if MK_WIDE
  // shared: the two weight buffers, the two staged activation chunks
  // (chunk_product), the tail's partial sums; the slabs in device memory
  float* W0 = reinterpret_cast<float*>(smem);
  float* W1 = W0 + kWBytes / 4;
  float* red = W1 + kWBytes / 4 + 2 * kRows * kLdh;
  float* As = p.act + blockIdx.x * slab_floats(0, p.hidden);
  float* Hs = p.hact + blockIdx.x * slab_floats(1, p.hidden);
#else
  float* As = reinterpret_cast<float*>(smem);
  float* Hs = As + kRows * kLda;
  float* W0 = Hs + kRows * kLdh;
  float* W1 = W0 + kWBytes / 4;
#endif
  cg::grid_group grid = cg::this_grid();
  int si = 0;
  stamp(p, si);
  for (int layer = 0; layer < p.n_layer; ++layer) {
    phase_qkv<PACKED>(p, layer, As, W0, W1);
    grid.sync();
    stamp(p, si);
    phase_self_attention(p, smem);
    grid.sync();
    stamp(p, si);
    phase_mlp<PACKED>(p, layer, As, Hs, W0, W1);
    grid.sync();
    stamp(p, si);
  }
#if MK_WIDE
  if (p.n_br == 2)
    phase_tail<true>(p, As, red, W0, W1);
  else
    phase_tail<false>(p, As, red, W0, W1);
#else
  if (p.n_br == 2)
    phase_tail<true>(p, As, Hs, W0, W1);
  else
    phase_tail<false>(p, As, Hs, W0, W1);
#endif
  if (p.stamps != nullptr) {   // uniform over the grid
    grid.sync();
    stamp(p, si);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
megakernel_step_packed_kernel(MK_KERNEL_PARAMS p) { step_body<true>(p); }

__global__ void __launch_bounds__(kThreads, kMinBlocks)
megakernel_step_branch_kernel(MK_KERNEL_PARAMS p) { step_body<false>(p); }
#endif  // MK_SERVING

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
#if MK_SERVING

// The longest sequence the kernels take (a head's keys and values must fit a
// block's shared memory).
extern "C" int megakernel_max_seq() { return kMaxSeq; }

// The widths this library was built for: n_embd (0) and head dim (1).
extern "C" int megakernel_width(int which) { return which ? 4 : kC; }

// The factor the queries take before their rounding to bf16.
extern "C" float megakernel_qscale() { return kQScale; }

// Whether phase S stages a head's keys and values whole at L tokens.
extern "C" int megakernel_keys_whole(int L) { return L <= kMaxSeq; }

// One reverse step on `stream`. ptrs, ints and floats are host tables in the
// order of enum Ptr, enum Int and {guidance}. Returns a cudaError_t: a grid
// that cannot be co-resident is refused (a grid-wide barrier would hang).
// ints[I_GRID], when not 0, caps the number of blocks below what fits.
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
  p.kmax = static_cast<unsigned*>(const_cast<void*>(ptrs[P_KMAX]));
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
  if (p.B < 1 || p.L < 1 || p.L > kMaxSeq || p.n_layer < 1 || p.kv < 1 ||
      p.hidden < kC || p.hidden % kC != 0 || p.s_valid < 1 ||
      p.s_valid > p.sp || (p.n_br != 1 && p.n_br != 2) ||
      (packed && p.n_br != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  int cap = grid_cap(packed ? 1 : 0);
  if (cap < 0) return -cap;
  if (ints[I_GRID] != 0 && static_cast<int>(ints[I_GRID]) < cap)
    cap = static_cast<int>(ints[I_GRID]);
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
#else   // MK_SERVING

// The longest sequence the kernels take (at head dim 4 a head's keys and
// values must fit a block's shared memory; wider heads stream them).
extern "C" int megakernel_max_seq() { return kMaxSeq; }

// The widths this library was built for: n_embd (0) and head dim (1).
extern "C" int megakernel_width(int which) { return which ? kD : kCT; }

// The factor the queries take before their rounding to bf16: 1 / sqrt(d)
// in double, rounded once to f32, as the TPU kernels and the plain version
// take it (a division, or rsqrtf, would round elsewhere).
extern "C" float megakernel_qscale() {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(kD)));
}

// Whether phase S stages a head's keys and values whole at L tokens (else
// it streams them in tiles).
extern "C" int megakernel_keys_whole(int L) {
  return kDS == 4 ||
         static_cast<long long>((L + 15) & ~15) * kKeyBytes <= kSmemBytes;
}
#if MK_WG

// The floats a block's slab takes at this MLP width (hidden, its storage
// width): the activations' (which 0) and the MLP's (1). The launch reads
// ptrs[P_ACT] and ptrs[P_HACT], each megakernel_grid_blocks of them (above
// n_embd 512 at either weight type, below with bf16 weights).
extern "C" long long megakernel_slab_floats(int which, int hidden) {
  return slab_floats(which, hidden);
}

// The CUresult with which cuTensorMapEncodeTiled refused a tensor map of
// the last launch with bf16 weights (which then returned
// cudaErrorNotSupported), or 0.
extern "C" int megakernel_tma_error() { return mha::wg::tma_error(); }
#endif

// One reverse step on `stream`. ptrs, ints and floats are host tables in the
// order of enum Ptr, enum Int and {guidance}. Returns a cudaError_t: a grid
// that cannot be co-resident is refused (a grid-wide barrier would hang).
// ints[I_GRID], when not 0, caps the number of blocks below what fits.
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
  p.kmax = static_cast<unsigned*>(const_cast<void*>(ptrs[P_KMAX]));
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
  p.qscale = megakernel_qscale();
  p.keys_whole = megakernel_keys_whole(p.L);
  const bool packed = ints[I_PACKED] != 0;
  if (p.B < 1 || p.L < 1 || p.L > kMaxSeq || p.n_layer < 1 || p.kv < 1 ||
      p.hidden < 8 || p.hidden % 8 != 0 || p.s_valid < 1 ||
      p.s_valid > p.sp || (p.n_br != 1 && p.n_br != 2) ||
      (packed && p.n_br != 2))
    return static_cast<int>(cudaErrorInvalidValue);
#if MK_WG
  // the slabs: above n_embd 512 at either weight type, below with bf16
  // weights (the f32 weights' products keep the tile in shared memory)
  p.act = static_cast<float*>(const_cast<void*>(ptrs[P_ACT]));
  p.hact = static_cast<float*>(const_cast<void*>(ptrs[P_HACT]));
  if ((MK_WIDE || p.w_bf16) && (p.act == nullptr || p.hact == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
#endif
  int cap = grid_cap(packed ? 1 : 0);
  if (cap < 0) return -cap;
  if (ints[I_GRID] != 0 && static_cast<int>(ints[I_GRID]) < cap)
    cap = static_cast<int>(ints[I_GRID]);
  const long long tiles =
      packed ? static_cast<long long>(p.B) * ((p.L + 31) / 32)
             : static_cast<long long>(p.B) * p.n_br *
                   ((p.L + kRows - 1) / kRows);
  const long long attn = static_cast<long long>(p.B) * p.n_br * kH *
                         ((p.L + kQTile - 1) / kQTile);
  const long long items = tiles > attn ? tiles : attn;
  const int grid = static_cast<int>(items < cap ? items : cap);
#if MK_WG
  mha::wg::tma_error() = 0;
  if (p.w_bf16 && !wg_maps(p, grid))
    return static_cast<int>(cudaErrorNotSupported);
#endif
  const void* fn = packed
      ? reinterpret_cast<const void*>(megakernel_step_packed_kernel)
      : reinterpret_cast<const void*>(megakernel_step_branch_kernel);
  void* args[] = {&p};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(kThreads), args, kSmemBytes,
      static_cast<cudaStream_t>(stream)));
}
#endif  // MK_SERVING
