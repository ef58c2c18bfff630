// Fused cut-layer forward for Hopper (sm_90a).
//
// Replaces: the Pallas kernel `_cut_fwd_kernel` in
//   src/repro/kernels/inl_bottleneck.py (launched by `_fwd_pallas`, entry
//   point `cutlayer_fused`).
//
// Computes, for every row of (rows, d):
//   u    = Q_b(mu + exp(lv/2) * eps)                 stored in mu's type
//   rate = sample:   1/2 sum(u^2 - (u-mu)^2 e^-lv - lv)  (at the quantized u)
//          analytic: 1/2 sum(e^lv + mu^2 - 1 - lv)
//          none:     0
// where Q_b clips to +-r, rounds onto a (2^b - 1)-level midtread grid and
// is the identity for b >= 32.
//
// Bound: bytes.  Each element is read three times (mu, lv, eps) and written
// once (u) with a handful of flops in between, so an fp32 call moves
// rows*d*(4+4+4+4) + 4*rows bytes (bf16 mu/lv/u: rows*d*(2+2+4+2) + 4*rows)
// and is limited by device memory, never by arithmetic.
//
// Design: one warp per row, lanes striding over d, so neighbouring lanes read
// neighbouring addresses; the per-row rate is reduced in registers with
// __shfl_xor_sync and written by lane 0.  The grid covers ceil(rows / 8)
// blocks of 8 warps and a warp whose row lies past the end returns, so ragged
// row counts need no padding.  All arithmetic is fp32; the quantizer chain,
// the rate's per-element term and their numerics are in cut_common.cuh,
// shared with the backward and with cut_fwd_pack.cu, whose (u, rate) equal
// this kernel's bit for bit: each lane adds its columns' terms in the same
// order (lane, lane + 32, ...) before the same warp sum.
#include "cut_common.cuh"

namespace {

using namespace cut;

template <typename T>
__global__ void cut_fwd_kernel(const T* __restrict__ mu,
                               const T* __restrict__ lv,
                               const float* __restrict__ eps,
                               T* __restrict__ u, float* __restrict__ rate,
                               int64_t rows, int d, int quant, float scale,
                               float r, int mode) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const int64_t base = row * (int64_t)d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float m = to_f32(mu[base + c]);
    const float l = to_f32(lv[base + c]);
    const float e = eps[base + c];
    const float sigma = expf(mul(0.5f, l));
    const float q = quantize(add(m, mul(sigma, e)), quant, scale, r);
    store(u + base + c, q);
    if (mode != kNone) acc = add(acc, rate_term(q, m, l, mode));
  }
  acc = warp_sum(acc);
  if (lane == 0) rate[row] = 0.5f * acc;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  mode: 0 sample, 1 analytic,
// 2 none.  is_bf16 selects the type of mu, lv and u (eps is always fp32).
// Returns cudaGetLastError() after the launch; the caller raises if nonzero.
extern "C" int cut_fwd_launch(const void* mu, const void* lv, const void* eps,
                              void* u, void* rate, long long rows, int d,
                              int bits, float r, int mode, int is_bf16,
                              void* stream) {
  if (rows <= 0 || d <= 0 || bits < 1) return (int)cudaErrorInvalidValue;
  const int quant = bits < 32;
  const float scale = quant_scale(bits, r);
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    cut_fwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)mu, (const __nv_bfloat16*)lv,
        (const float*)eps, (__nv_bfloat16*)u, (float*)rate, rows, d,
        quant, scale, r, mode);
  } else {
    cut_fwd_kernel<float><<<grid, block, 0, s>>>(
        (const float*)mu, (const float*)lv, (const float*)eps, (float*)u,
        (float*)rate, rows, d, quant, scale, r, mode);
  }
  return (int)cudaGetLastError();
}
