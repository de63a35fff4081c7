// Tensor-core tiles of the attention kernels, K2 (csrc/fused_mha_fwd.cu) and
// K5 (csrc/fused_mha_bwd.cu), for f32 and bf16 inputs.
//
// Every product of both kernels is one of two shapes, computed by a warp for
// its 16 kMT rows against 8 columns of a tile staged in shared memory:
//   * a "dot" product S = A X^T over the head dim (scores, dP): the warp's
//     rows of A (queries, dO, keys or values) against 8 staged rows of X;
//     the result comes out in the mma accumulator layout: lane (g, tig)
//     holds rows g, g + 8 at columns 2 tig, 2 tig + 1;
//   * a "pair" product acc += P X over those 8 columns (P V, dS K, P^T dO,
//     dS^T Q): the accumulator of a dot product is fed back as the A
//     operand without a shuffle, because the sum over the 8 columns does not
//     depend on their order. X is staged in the order that makes it so.
//
// f32 inputs (Tf32) are never rounded: each value is split into hi = its
// TF32 rounding and lo = the rest cut to TF32 (hi + lo misses it by less
// than 2^-21 of it), and the products run as mma.m16n8k8 .tf32:
//   * dot, head dim 4: A = [a_hi | a_lo] fills the 8-deep contraction, and
//     two mma against B = [x_hi; x_hi] and [x_lo; x_lo] give all four
//     partial products (a head dim of 8 takes two such 4-dim chunks);
//   * pair: the 8 columns are the contraction, with A slot tig holding
//     column 2 tig and slot tig + 4 column 2 tig + 1 (the accumulator's own
//     columns), and the 8 output columns are [x_hi | x_lo] of 4 dims, added
//     in the epilogue. The fed-back operand (P or dS, an f32 intermediate)
//     is split too (rounded to TF32 instead, K5's gradients miss their
//     tolerance: probes/attention_variants.py, variant nosplit).
// bf16 inputs (Bf16) are exact in f32 products, so the dot product is one
// mma.m16n8k8 .bf16 (head dim 4 fills half the contraction, the rest of A
// is zero). The fed-back operand stays f32, as the TPU kernels keep it: a
// bf16 hi (the value cut to bf16) + lo (the rest, rounded) pair, within
// 2^-16 of it, fills the 16-deep contraction of one mma.m16n8k16 against the
// same 8 columns of X twice.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace mha {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = 2;                          // 16-row tiles a warp
constexpr int kRowsWarp = 16 * kMT;
constexpr int kRowsBlock = kRowsWarp * kWarps;  // rows a block
constexpr int kTile = 64;                       // columns a staged tile
constexpr int kNB = kTile / 8;                  // 8-column blocks a tile
constexpr float kLog2e = 1.4426950408889634f;
// a tile is staged by the block's threads, one row each of two arrays
static_assert(kThreads >= 2 * kTile && kTile % 8 == 0, "tile size");

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16_k8(float (&c)[4], unsigned a0,
                                            unsigned a1, unsigned b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ void mma_bf16_k16(float (&c)[4],
                                             const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four consecutive elements as f32, and back (rounded once to bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&a),
                 *reinterpret_cast<const unsigned*>(&b));
}

// hi: v rounded to TF32 (to nearest, ties away; finite v); lo: the rest,
// cut to TF32 (csrc/megakernel_step.cu: split_tf32)
__device__ __forceinline__ void split_tf32(float v, unsigned& hi,
                                           unsigned& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) & 0xffffe000u;
}

// ---------------------------------------------------------------------------
// f32 inputs
// ---------------------------------------------------------------------------
template <int D>
struct Tf32 {
  using T = float;
  // K2's blocks an SM: four (at most 128 registers) measured slower
  static constexpr int kMinBlocks = 1;
  static constexpr int NC = D / 4;   // 4-dim chunks of a head
  // A of a dot product: slot tig / tig + 4 = hi / lo of dim 4 c + tig;
  // a[mt][c] = {row g hi, row g + 8 hi, row g lo, row g + 8 lo}
  struct RowsA {
    unsigned a[kMT][NC][4];
  };
  // a pair product's sum: chunk c, columns [dims 4c.. hi | dims 4c.. lo]
  struct Acc {
    float c[kMT][NC][4];
  };
  // X for dot products: [col][chunk][tig] = (hi, lo) of dim 4 c + tig
  struct __align__(16) DotTile {
    uint2 w[kTile * NC * 4];
  };
  // X for pair products: [col pair p][chunk][n] = (x'[2p][n], x'[2p+1][n]),
  // x'[.][n] = hi of dim 4 c + n for n < 4, lo of dim 4 c + n - 4 else;
  // 9 entries a (pair, chunk): conflict-free stores and loads
  struct __align__(16) PairTile {
    uint2 w[kTile / 2 * NC * 9];
  };
  struct Row {   // one staged row, in registers
    float4 x[NC];
  };

  static __device__ __forceinline__ void load_row(Row& r, const float* p,
                                                  bool valid) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      r.x[c] = valid ? reinterpret_cast<const float4*>(p)[c]
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // sum over the head dims of a row times an f32 row
  static __device__ __forceinline__ float dot_row(const Row& a,
                                                  const float4 (&b)[NC]) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      s = fmaf(a.x[c].x, b[c].x, s);
      s = fmaf(a.x[c].y, b[c].y, s);
      s = fmaf(a.x[c].z, b[c].z, s);
      s = fmaf(a.x[c].w, b[c].w, s);
    }
    return s;
  }

  static __device__ __forceinline__ void put_dot(DotTile& t, int col,
                                                 const Row& r) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float v[4] = {r.x[c].x, r.x[c].y, r.x[c].z, r.x[c].w};
      unsigned hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(v[i], hi[i], lo[i]);
      uint4* dst = reinterpret_cast<uint4*>(&t.w[(col * NC + c) * 4]);
      dst[0] = make_uint4(hi[0], lo[0], hi[1], lo[1]);
      dst[1] = make_uint4(hi[2], lo[2], hi[3], lo[3]);
    }
  }

  static __device__ __forceinline__ void put_pair(PairTile& t, int col,
                                                  const Row& r) {
    unsigned* w = reinterpret_cast<unsigned*>(t.w);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float v[4] = {r.x[c].x, r.x[c].y, r.x[c].z, r.x[c].w};
      const int base = (((col >> 1) * NC + c) * 9) * 2 + (col & 1);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        unsigned hi, lo;
        split_tf32(v[n], hi, lo);
        w[base + 2 * n] = hi;
        w[base + 2 * (n + 4)] = lo;
      }
    }
  }

  // the warp's rows row0 + 16 mt + 8 hf + g (zero from nrows on) of the
  // head starting at base, row stride ld
  static __device__ __forceinline__ void load_a(RowsA& a, const float* base,
                                                int row0, int nrows, int ld,
                                                int g, int tig) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = row0 + 16 * mt + 8 * hf + g;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float x =
              row < nrows ? base[static_cast<size_t>(row) * ld + 4 * c + tig]
                          : 0.f;
          split_tf32(x, a.a[mt][c][hf], a.a[mt][c][2 + hf]);
        }
      }
  }

  // the lane's part of rowsum(x * y) (y f32) for rows g, g + 8 of each
  // 16-row tile (its dims 4 c + tig); quad_sum completes it
  static __device__ __forceinline__ void row_dot_part(
      float (&s)[kMT][2], const float* x, const float* y, int row0,
      int nrows, int ld, int g, int tig) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = row0 + 16 * mt + 8 * hf + g;
        float v = 0.f;
        if (row < nrows) {
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const size_t i = static_cast<size_t>(row) * ld + 4 * c + tig;
            v = fmaf(x[i], y[i], v);
          }
        }
        s[mt][hf] = v;
      }
  }

  // s[mt] = A X^T for the tile's columns 8 nb .. 8 nb + 7
  static __device__ __forceinline__ void mma_dot(float (&s)[kMT][4],
                                                 const RowsA& a,
                                                 const DotTile& t, int nb,
                                                 int g, int tig) {
    uint2 x[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) x[c] = t.w[((8 * nb + g) * NC + c) * 4 + tig];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[mt][j] = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        mma_tf32(s[mt], a.a[mt][c], x[c].x, x[c].x);
        mma_tf32(s[mt], a.a[mt][c], x[c].y, x[c].y);
      }
    }
  }

  // acc[mt] += p[mt] X over the tile's columns 8 nb .. 8 nb + 7; p in the
  // accumulator layout of mma_dot
  static __device__ __forceinline__ void mma_pair(Acc& acc,
                                                  const float (&p)[kMT][4],
                                                  const PairTile& t, int nb,
                                                  int g, int tig) {
    uint2 x[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) x[c] = t.w[((4 * nb + tig) * NC + c) * 9 + g];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      // slot tig <- column 2 tig, slot tig + 4 <- column 2 tig + 1
      const int order[4] = {0, 2, 1, 3};
      unsigned hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = p[mt][order[i]];
        hi[i] = __float_as_uint(v) & 0xffffe000u;
        lo[i] = __float_as_uint(v - __uint_as_float(hi[i]));
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        mma_tf32(acc.c[mt][c], hi, x[c].x, x[c].y);
        mma_tf32(acc.c[mt][c], lo, x[c].x, x[c].y);
      }
    }
  }

  static __device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc.c[mt][c][j] = 0.f;
  }

  static __device__ __forceinline__ void scale_rows(Acc& acc, int mt, int hf,
                                                    float f) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc.c[mt][c][2 * hf] *= f;
      acc.c[mt][c][2 * hf + 1] *= f;
    }
  }

  // rows row0 + 16 mt + 8 hf + g (below nrows) of out = acc (hi + lo) x
  // f[mt][hf]; out is a head's first column, row stride ld
  template <typename OutT>
  static __device__ __forceinline__ void store(OutT* out, const Acc& acc,
                                               const float (&f)[kMT][2],
                                               int row0, int nrows, int ld,
                                               int g, int tig) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)   // lanes tig + 2 hold the lo columns
          v[j] = acc.c[mt][c][j] + __shfl_xor_sync(0xffffffffu,
                                                   acc.c[mt][c][j], 2);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = row0 + 16 * mt + 8 * hf + g;
          if (tig < 2 && row < nrows)
            *reinterpret_cast<float2*>(
                out + static_cast<size_t>(row) * ld + 4 * c + 2 * tig) =
                make_float2(v[2 * hf] * f[mt][hf], v[2 * hf + 1] * f[mt][hf]);
        }
      }
  }
};

// ---------------------------------------------------------------------------
// bf16 inputs
// ---------------------------------------------------------------------------
template <int D>
struct Bf16 {
  using T = __nv_bfloat16;
  // K2's blocks an SM: four (at most 128 registers) measured faster
  static constexpr int kMinBlocks = 4;
  static constexpr int NW = D / 2;   // 32-bit words of a head row
  // A of a dot product: dims 2 tig, 2 tig + 1 of rows g, g + 8 (head dim
  // 4: lanes tig >= 2 hold zero)
  struct RowsA {
    unsigned a[kMT][2];
  };
  // a pair product's sum: columns n < D are the dims (head dim 4: 4..7
  // repeat 0..3 and are not stored)
  struct Acc {
    float c[kMT][4];
  };
  struct __align__(16) DotTile {      // the rows as they are: [col][word]
    unsigned w[kTile * NW];
  };
  struct __align__(16) PairTile {     // [col pair p][n] = (x[2p][n], x[2p+1][n])
    unsigned w[kTile / 2 * D];
  };
  struct Row {
    unsigned x[NW];
  };

  static __device__ __forceinline__ float lo_half(unsigned w) {
    return __uint_as_float(w << 16);
  }
  static __device__ __forceinline__ float hi_half(unsigned w) {
    return __uint_as_float(w & 0xffff0000u);
  }

  static __device__ __forceinline__ void load_row(Row& r, const T* p,
                                                  bool valid) {
#pragma unroll
    for (int i = 0; i < NW; i += 2) {
      const uint2 v = valid ? reinterpret_cast<const uint2*>(p)[i / 2]
                            : make_uint2(0u, 0u);
      r.x[i] = v.x;
      r.x[i + 1] = v.y;
    }
  }

  static __device__ __forceinline__ float dot_row(const Row& a,
                                                  const float4 (&b)[D / 4]) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < D / 4; ++c) {
      s = fmaf(lo_half(a.x[2 * c]), b[c].x, s);
      s = fmaf(hi_half(a.x[2 * c]), b[c].y, s);
      s = fmaf(lo_half(a.x[2 * c + 1]), b[c].z, s);
      s = fmaf(hi_half(a.x[2 * c + 1]), b[c].w, s);
    }
    return s;
  }

  static __device__ __forceinline__ void put_dot(DotTile& t, int col,
                                                 const Row& r) {
#pragma unroll
    for (int i = 0; i < NW; ++i) t.w[col * NW + i] = r.x[i];
  }

  static __device__ __forceinline__ void put_pair(PairTile& t, int col,
                                                  const Row& r) {
    unsigned short* w = reinterpret_cast<unsigned short*>(t.w);
#pragma unroll
    for (int n = 0; n < D; ++n) {
      const unsigned word = r.x[n >> 1];
      w[((col >> 1) * D + n) * 2 + (col & 1)] =
          static_cast<unsigned short>((n & 1) ? word >> 16 : word);
    }
  }

  static __device__ __forceinline__ void load_a(RowsA& a, const T* base,
                                                int row0, int nrows, int ld,
                                                int g, int tig) {
    const unsigned* b32 = reinterpret_cast<const unsigned*>(base);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = row0 + 16 * mt + 8 * hf + g;
        a.a[mt][hf] = (row < nrows && tig < NW)
                          ? b32[(static_cast<size_t>(row) * ld) / 2 + tig]
                          : 0u;
      }
  }

  // the lane's part of rowsum(x * y) (y f32): dims 2 tig, 2 tig + 1
  static __device__ __forceinline__ void row_dot_part(
      float (&s)[kMT][2], const T* x, const float* y, int row0, int nrows,
      int ld, int g, int tig) {
    const unsigned* x32 = reinterpret_cast<const unsigned*>(x);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = row0 + 16 * mt + 8 * hf + g;
        float v = 0.f;
        if (row < nrows && tig < NW) {
          const size_t i = static_cast<size_t>(row) * ld + 2 * tig;
          const unsigned w = x32[i / 2];
          const float2 z = *reinterpret_cast<const float2*>(y + i);
          v = fmaf(lo_half(w), z.x, v);
          v = fmaf(hi_half(w), z.y, v);
        }
        s[mt][hf] = v;
      }
  }

  static __device__ __forceinline__ void mma_dot(float (&s)[kMT][4],
                                                 const RowsA& a,
                                                 const DotTile& t, int nb,
                                                 int g, int tig) {
    // head dim 4: lanes tig >= 2 meet zeros in A; any finite B will do
    const unsigned x = t.w[(8 * nb + g) * NW + (tig % NW)];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[mt][j] = 0.f;
      mma_bf16_k8(s[mt], a.a[mt][0], a.a[mt][1], x);
    }
  }

  // acc[mt] += p[mt] X: slots k 0..7 take bf16 hi of the 8 columns in the
  // accumulator's order (the lane's columns 2 tig, 2 tig + 1), slots 8..15
  // their lo; B holds the same 8 rows of X in both halves
  static __device__ __forceinline__ void mma_pair(Acc& acc,
                                                  const float (&p)[kMT][4],
                                                  const PairTile& t, int nb,
                                                  int g, int tig) {
    const unsigned x = t.w[(4 * nb + tig) * D + (g % D)];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      unsigned hi[4];
      float lo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        hi[j] = __float_as_uint(p[mt][j]) & 0xffff0000u;
        lo[j] = p[mt][j] - __uint_as_float(hi[j]);
      }
      const __nv_bfloat162 l01 = __floats2bfloat162_rn(lo[0], lo[1]);
      const __nv_bfloat162 l23 = __floats2bfloat162_rn(lo[2], lo[3]);
      const unsigned a[4] = {__byte_perm(hi[0], hi[1], 0x7632),
                             __byte_perm(hi[2], hi[3], 0x7632),
                             *reinterpret_cast<const unsigned*>(&l01),
                             *reinterpret_cast<const unsigned*>(&l23)};
      mma_bf16_k16(acc.c[mt], a, x, x);
    }
  }

  static __device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc.c[mt][j] = 0.f;
  }

  static __device__ __forceinline__ void scale_rows(Acc& acc, int mt, int hf,
                                                    float f) {
    acc.c[mt][2 * hf] *= f;
    acc.c[mt][2 * hf + 1] *= f;
  }

  // as bf16 (rounded once) or, for partial sums, as f32
  template <typename OutT>
  static __device__ __forceinline__ void store(OutT* out, const Acc& acc,
                                               const float (&f)[kMT][2],
                                               int row0, int nrows, int ld,
                                               int g, int tig) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = row0 + 16 * mt + 8 * hf + g;
        if (2 * tig >= D || row >= nrows) continue;
        const float x = acc.c[mt][2 * hf] * f[mt][hf];
        const float y = acc.c[mt][2 * hf + 1] * f[mt][hf];
        OutT* dst = out + static_cast<size_t>(row) * ld + 2 * tig;
        if constexpr (std::is_same_v<OutT, float>)
          *reinterpret_cast<float2*>(dst) = make_float2(x, y);
        else
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(x, y);
      }
  }
};

// ---------------------------------------------------------------------------
// what the wg and stream designs (csrc/mha_wg.cuh) share with the tiles above
// ---------------------------------------------------------------------------
constexpr int kMaxHeadDim = 128;   // the wg design's largest D

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// N bytes from src to dst, or N zero bytes where !valid (src not read)
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const int n = valid ? N : 0;
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "n"(N), "r"(n) : "memory");
}

// the bytes of one copy into shared memory: the largest of 16, 8, 4, 2 that
// divides a head row's bytes (the tensors start on 16 bytes)
inline int copy_bytes(int row_bytes) {
  return row_bytes % 16 == 0 ? 16 : row_bytes % 8 == 0 ? 8
                                    : row_bytes % 4 == 0 ? 4 : 2;
}

// K5's dk/dv partial sums over query chunks (csrc/fused_mha_bwd*.cu):
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

}  // namespace mha
