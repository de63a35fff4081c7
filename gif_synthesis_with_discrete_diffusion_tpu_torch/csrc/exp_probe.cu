// How fast the card takes base-2 exponentials, by the way they are issued:
// what the self-attention phase of csrc/megakernel_step.cu is planned from.
//
// Every thread runs `iters` rounds of eight independent exponentials whose
// arguments depend on the round before (so nothing is hoisted), and the
// grid fills every SM with 8 blocks of 256 threads. MODE 0: ex2.approx.ftz
// .f32, one a special-function slot. MODE 1: ex2.approx.f16x2, two packed
// arguments an instruction (the cvt that packs them included). MODE 2: no
// special function: range reduction x = n + f, a degree-5 polynomial for
// 2^f on the FMA pipe, the exponent added as an integer. MODE 3: half of the
// eight as MODE 0, half as MODE 2, so that both pipes work.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float ex2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 2^x for x <= 0 on the FMA pipe (Taylor to degree 5: ~2e-6 relative; a
// degree more for f32's last bits costs one more FMA)
__device__ __forceinline__ float ex2_poly(float x) {
  x = fmaxf(x, -126.f);
  const float t = x + 12582912.f;          // 1.5 * 2^23: n in the low bits
  const float f = x - (t - 12582912.f);    // in [-0.5, 0.5]
  float p = 1.3333558146e-3f;
  p = fmaf(p, f, 9.6181291076e-3f);
  p = fmaf(p, f, 5.5504108665e-2f);
  p = fmaf(p, f, 2.4022650696e-1f);
  p = fmaf(p, f, 6.9314718056e-1f);
  p = fmaf(p, f, 1.f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}

__device__ __forceinline__ float2 ex2_h2(float a, float b) {
  unsigned packed, y;
  asm("cvt.rn.f16x2.f32 %0, %1, %2;" : "=r"(packed) : "f"(b), "f"(a));
  asm("ex2.approx.f16x2 %0, %1;" : "=r"(y) : "r"(packed));
  const __half2 h = *reinterpret_cast<const __half2*>(&y);
  return __half22float2(h);
}

template <int MODE>
__global__ void __launch_bounds__(256) exp_kernel(float* out, int iters) {
  float x[8], acc = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = -0.01f * (threadIdx.x % 7 + j);
  for (int i = 0; i < iters; ++i) {
    float y[8];
    if (MODE == 1) {
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const float2 r = ex2_h2(x[j], x[j + 1]);
        y[j] = r.x;
        y[j + 1] = r.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        y[j] = (MODE == 0 || (MODE == 3 && (j & 1))) ? ex2_sfu(x[j])
                                                     : ex2_poly(x[j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc += y[j];
      x[j] = fmaf(y[j], -0.37f, -0.01f * j);
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

}  // namespace

// Launch one mode over `blocks` blocks of 256 threads; `out` holds blocks *
// 256 floats. Returns a cudaError_t.
extern "C" int exp_probe(float* out, int mode, int blocks, int iters,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: exp_kernel<0><<<blocks, 256, 0, s>>>(out, iters); break;
    case 1: exp_kernel<1><<<blocks, 256, 0, s>>>(out, iters); break;
    case 2: exp_kernel<2><<<blocks, 256, 0, s>>>(out, iters); break;
    case 3: exp_kernel<3><<<blocks, 256, 0, s>>>(out, iters); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
