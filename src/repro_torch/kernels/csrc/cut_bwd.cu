// Fused cut-layer backward for Hopper (sm_90a): the paper's eq.-(10) split.
//
// Replaces: the Pallas kernel `_cut_bwd_kernel` in
//   src/repro/kernels/inl_bottleneck.py (launched by `_bwd_pallas`, through
//   the custom VJP `_cutlayer_bwd` and the plain dispatch
//   `cutlayer_backward`).
//
// Inputs per row: the forward's residuals (mu, lv, eps), the cotangent gu of
// u (the decoder's error-vector chunk, passed straight through the
// quantizer) and grate, the cotangent of the row's rate.  With
// sigma = exp(lv/2) and, in the sample mode, u recomputed as the forward
// computed it and w = (u - mu) e^-lv:
//   sample:   g_pre = gu + grate (u - w)
//             dmu   = gu + grate u
//             dlv   = g_pre (sigma eps / 2) + grate/2 (w (u - mu) - 1)
//             deps  = g_pre sigma
//   analytic: dmu   = gu + grate mu
//             dlv   = gu (sigma eps / 2) + grate/2 (e^lv - 1)
//             deps  = gu sigma
//   none:     dmu = gu, dlv = gu (sigma eps / 2), deps = gu sigma
// dmu and dlv are stored in mu's type (fp32 or bf16), deps in fp32.
//
// Bound: bytes.  Four (rows, d) inputs read, three written and one float per
// row: an fp32 call moves rows*d*28 + 4*rows bytes (bf16 mu/lv/gu/dmu/dlv:
// rows*d*18 + 4*rows) for a few dozen flops per element.
//
// Design: as cut_fwd.cu, one warp per row with lanes striding over d and
// ragged rows masked, no padding.  u is recomputed with the quantizer chain
// of cut_common.cuh, the one the forward runs, so forward and backward agree
// on u at rounding midpoints.  Every step is a rounded fp32 op in the order
// of the plain version (kernels/ref.py, cutlayer_bwd_ref), so the card's
// kernel and plain version give the same bits.
#include "cut_common.cuh"

namespace {

using namespace cut;

template <typename T>
__global__ void cut_bwd_kernel(const T* __restrict__ mu,
                               const T* __restrict__ lv,
                               const float* __restrict__ eps,
                               const T* __restrict__ gu,
                               const float* __restrict__ grate,
                               T* __restrict__ dmu, T* __restrict__ dlv,
                               float* __restrict__ deps, int64_t rows, int d,
                               int quant, float scale, float r, int mode) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const int64_t base = row * (int64_t)d;
  const float gr = mode == kNone ? 0.f : grate[row];
  const float gr_half = mul(gr, 0.5f);
  for (int c = lane; c < d; c += 32) {
    const float m = to_f32(mu[base + c]);
    const float l = to_f32(lv[base + c]);
    const float e = eps[base + c];
    const float g = to_f32(gu[base + c]);
    const float sigma = expf(mul(0.5f, l));
    const float half_se = mul(mul(0.5f, sigma), e);
    float o_mu, o_lv, o_eps;
    if (mode == kSample) {
      const float u = quantize(add(m, mul(sigma, e)), quant, scale, r);
      const float um = sub(u, m);
      const float w = mul(um, expf(-l));
      const float g_pre = add(g, mul(gr, sub(u, w)));
      o_mu = add(g, mul(gr, u));
      o_lv = add(mul(g_pre, half_se), mul(gr_half, sub(mul(w, um), 1.f)));
      o_eps = mul(g_pre, sigma);
    } else if (mode == kAnalytic) {
      o_mu = add(g, mul(gr, m));
      o_lv = add(mul(g, half_se), mul(gr_half, sub(expf(l), 1.f)));
      o_eps = mul(g, sigma);
    } else {
      o_mu = g;
      o_lv = mul(g, half_se);
      o_eps = mul(g, sigma);
    }
    store(dmu + base + c, o_mu);
    store(dlv + base + c, o_lv);
    deps[base + c] = o_eps;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  mode: 0 sample, 1 analytic,
// 2 none (grate is not read).  is_bf16 selects the type of mu, lv, gu, dmu
// and dlv; eps, grate and deps are fp32.  Returns cudaGetLastError() after
// the launch; the caller raises if nonzero.
extern "C" int cut_bwd_launch(const void* mu, const void* lv, const void* eps,
                              const void* gu, const void* grate, void* dmu,
                              void* dlv, void* deps, long long rows, int d,
                              int bits, float r, int mode, int is_bf16,
                              void* stream) {
  if (rows <= 0 || d <= 0 || bits < 1) return (int)cudaErrorInvalidValue;
  const int quant = bits < 32;
  const float scale = quant_scale(bits, r);
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    cut_bwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)mu, (const __nv_bfloat16*)lv,
        (const float*)eps, (const __nv_bfloat16*)gu, (const float*)grate,
        (__nv_bfloat16*)dmu, (__nv_bfloat16*)dlv, (float*)deps, rows, d,
        quant, scale, r, mode);
  } else {
    cut_bwd_kernel<float><<<grid, block, 0, s>>>(
        (const float*)mu, (const float*)lv, (const float*)eps,
        (const float*)gu, (const float*)grate, (float*)dmu, (float*)dlv,
        (float*)deps, rows, d, quant, scale, r, mode);
  }
  return (int)cudaGetLastError();
}
