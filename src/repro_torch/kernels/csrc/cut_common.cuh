// Device code shared by the cut-layer kernels (cut_fwd.cu, cut_bwd.cu,
// cut_prior_fwd.cu, cut_prior_bwd.cu).
//
// The quantizer chain lives here once, so the forward and the backward
// recompute the same u: a backward that rounded differently from its
// forward would disagree on u at the rounding midpoints.  Numerics, held
// bit for bit against the plain PyTorch versions (kernels/ref.py):
//   * rintf rounds half to even, as jnp.round and torch.round do;
//   * scale = ((1 << b) - 1) / (2 r) is computed in double and cast to
//     fp32, as JAX casts the Python float;
//   * the dequantize is a true division, idx / scale - r;
//   * the arithmetic is written with __fmul_rn / __fadd_rn / __fsub_rn /
//     __fdiv_rn, so nvcc cannot contract it into an FMA (the files are
//     built without --use_fast_math) and every step rounds where the plain
//     version's separate elementwise ops round;
//   * expf, not __expf.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cut {

constexpr int kSample = 0;
constexpr int kAnalytic = 1;
constexpr int kNone = 2;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// fp32 arithmetic rounded at every step, never contracted into an FMA
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// Q_b: clip to +-r, round onto the (2^b - 1)-level midtread grid, dequantize.
// on == 0 (b >= 32) is the identity.
__device__ __forceinline__ float quantize(float pre, int on, float scale,
                                          float r) {
  if (!on) return pre;
  // comparisons (not fminf/fmaxf) so a NaN propagates as jnp.clip does
  const float cl = pre < -r ? -r : (pre > r ? r : pre);
  const float idx = rintf(mul(add(cl, r), scale));
  return sub(__fdiv_rn(idx, scale), r);
}

// The warp's sum of `acc`, in every lane.
__device__ __forceinline__ float warp_sum(float acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// Host side: the quantizer's scale for `bits`, computed in double and cast.
inline float quant_scale(int bits, float r) {
  if (bits >= 32) return 1.f;
  return (float)((double)((1ull << bits) - 1ull) / (2.0 * (double)r));
}

}  // namespace cut
