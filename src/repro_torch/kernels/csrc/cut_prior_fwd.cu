// Fused cut-layer forward against a learned Gaussian prior, for Hopper
// (sm_90a).
//
// Replaces: the Pallas kernel `_cut_prior_fwd_kernel` in
//   src/repro/kernels/inl_bottleneck.py (launched by `_prior_fwd_pallas`
//   through `_cutlayer_prior_call`, entry point `cutlayer_fused` with
//   prior_mu / prior_logvar).
//
// Rows come as J node groups of T rows each, (J*T, d); node j's rows read
// its prior N(pmu_j, e^plv_j) from the (J, d) fp32 prior arrays (a shared
// (d,) prior is J = 1).  For every row:
//   u    = Q_b(mu + exp(lv/2) * eps)                       stored in mu's type
//   rate = sample:   1/2 sum((u-pmu)^2 e^-plv + plv - (u-mu)^2 e^-lv - lv)
//          analytic: 1/2 sum(plv - lv + (e^lv + (mu-pmu)^2) e^-plv - 1)
// with the sample mode's rate taken at the quantized u, as the reference
// takes it.
//
// Bound: bytes.  An fp32 call reads mu, lv, eps and writes u, 16*rows*d
// bytes, plus 4*rows for the rate and 8*J*d for the priors, which stay in
// L1/L2 after their first read.
//
// Design: the Pallas grid (J, row-blocks) becomes the row index itself:
// one warp per row as in cut_fwd.cu, node j = row / T, no padding of T to a
// block size.  The quantizer chain is cut_common.cuh's, so u equals the
// standard kernel's u bit for bit.
#include "cut_common.cuh"

namespace {

using namespace cut;

template <typename T>
__global__ void cut_prior_fwd_kernel(const T* __restrict__ mu,
                                     const T* __restrict__ lv,
                                     const float* __restrict__ eps,
                                     const float* __restrict__ pmu,
                                     const float* __restrict__ plv,
                                     T* __restrict__ u,
                                     float* __restrict__ rate, int64_t rows,
                                     int64_t per_node, int d, int quant,
                                     float scale, float r, int mode) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const int64_t base = row * (int64_t)d;
  const int64_t pbase = (row / per_node) * (int64_t)d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float m = to_f32(mu[base + c]);
    const float l = to_f32(lv[base + c]);
    const float e = eps[base + c];
    const float pm = pmu[pbase + c];
    const float pv = plv[pbase + c];
    const float sigma = expf(mul(0.5f, l));
    const float q = quantize(add(m, mul(sigma, e)), quant, scale, r);
    store(u + base + c, q);
    if (mode == kSample) {
      const float dq = q - pm;
      const float dx = q - m;
      acc += dq * dq * expf(-pv) + pv - dx * dx * expf(-l) - l;
    } else {
      const float dm = m - pm;
      acc += pv - l + (expf(l) + dm * dm) * expf(-pv) - 1.f;
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) rate[row] = 0.5f * acc;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  mode: 0 sample, 1 analytic (the
// prior has no "none" mode: a zero rate needs no prior).  is_bf16 selects
// the type of mu, lv and u; eps, pmu, plv and rate are fp32.  mu is
// (J*per_node, d), pmu/plv (J, d).  Returns cudaGetLastError() after the
// launch; the caller raises if nonzero.
extern "C" int cut_prior_fwd_launch(const void* mu, const void* lv,
                                    const void* eps, const void* pmu,
                                    const void* plv, void* u, void* rate,
                                    int J, long long per_node, int d,
                                    int bits, float r, int mode, int is_bf16,
                                    void* stream) {
  if (J <= 0 || per_node <= 0 || d <= 0 || bits < 1 ||
      (mode != kSample && mode != kAnalytic))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)J * per_node;
  const int quant = bits < 32;
  const float scale = quant_scale(bits, r);
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    cut_prior_fwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)mu, (const __nv_bfloat16*)lv,
        (const float*)eps, (const float*)pmu, (const float*)plv,
        (__nv_bfloat16*)u, (float*)rate, rows, per_node, d, quant, scale, r,
        mode);
  } else {
    cut_prior_fwd_kernel<float><<<grid, block, 0, s>>>(
        (const float*)mu, (const float*)lv, (const float*)eps,
        (const float*)pmu, (const float*)plv, (float*)u, (float*)rate, rows,
        per_node, d, quant, scale, r, mode);
  }
  return (int)cudaGetLastError();
}
