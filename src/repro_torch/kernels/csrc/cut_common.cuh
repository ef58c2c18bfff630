// Device code shared by the cut-layer kernels (cut_fwd.cu, cut_bwd.cu,
// cut_prior_fwd.cu, cut_prior_bwd.cu) and the packed-wire kernels
// (cut_fwd_pack.cu, pack.cu, unpack_dequant.cu).
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
// The forward's per-element rate term lives here too, so cut_fwd and
// cut_fwd_pack, which add the same terms in the same order, return the same
// rate bit for bit.
//
// The packed wire: a b-bit codeword index (1 <= b <= 16) is
// rintf((clip(pre) + r) * scale), and 32 / b of them share a uint32 lane,
// little-endian (codeword k of a lane at bit k*b), the tail of a row's last
// lane zero.
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

// The codeword index of `pre` (an integer held in a float): clip to +-r and
// round onto the (2^b - 1)-level midtread grid.
__device__ __forceinline__ float quantize_index(float pre, float scale,
                                                float r) {
  // comparisons (not fminf/fmaxf) so a NaN propagates as jnp.clip does
  const float cl = pre < -r ? -r : (pre > r ? r : pre);
  return rintf(mul(add(cl, r), scale));
}

// The value of a codeword index: a true division, idx / scale - r.
__device__ __forceinline__ float dequantize_index(float idx, float scale,
                                                  float r) {
  return sub(__fdiv_rn(idx, scale), r);
}

// Q_b: quantize_index, then dequantize_index.  on == 0 (b >= 32) is the
// identity.
__device__ __forceinline__ float quantize(float pre, int on, float scale,
                                          float r) {
  if (!on) return pre;
  return dequantize_index(quantize_index(pre, scale, r), scale, r);
}

// One element's term of the forward's rate, every step rounded as the plain
// version's separate ops round:
//   sample:   u^2 - (u - mu)^2 e^-lv - lv      (at the quantized u)
//   analytic: e^lv + mu^2 - 1 - lv
__device__ __forceinline__ float rate_term(float q, float m, float l,
                                           int mode) {
  if (mode == kSample) {
    const float diff = sub(q, m);
    return sub(sub(mul(q, q), mul(mul(diff, diff), expf(-l))), l);
  }
  return sub(sub(add(expf(l), mul(m, m)), 1.f), l);
}

// Codewords per lane at b = 1, the most a lane holds.
constexpr int kMaxVals = 32;

// The warp's lanes of one chunk of a row.  The warp has put the codewords of
// columns [c0, c0 + 32 * vpw) into stage[c - c0]; thread `lane` assembles
// output lane c0 / vpw + lane from stage[lane * vpw, (lane + 1) * vpw) and
// writes it whole (no atomics, no two threads on one lane).  Columns at or
// past d contribute zero bits.  Every thread of the warp must call it.
__device__ __forceinline__ void write_lanes(const uint16_t* stage,
                                            uint32_t* out_row, int c0, int d,
                                            int W, int bits, int vpw,
                                            int lane) {
  __syncwarp();
  const int w = c0 / vpw + lane;
  if (w < W) {
    const int first = lane * vpw;
    uint32_t word = 0u;
    for (int k = 0; k < vpw && c0 + first + k < d; ++k)
      word |= (uint32_t)stage[first + k] << (k * bits);
    out_row[w] = word;
  }
  __syncwarp();  // the stage is rewritten by the next chunk
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

// Host side: uint32 lanes per d-vector at a packable width.
inline int packed_width(int d, int bits) {
  const int vpw = 32 / bits;
  return (d + vpw - 1) / vpw;
}

}  // namespace cut
