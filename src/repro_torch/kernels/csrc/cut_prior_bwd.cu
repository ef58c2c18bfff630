// Fused cut-layer backward against a learned Gaussian prior, for Hopper
// (sm_90a): the eq.-(10) split with Q_psi = N(pmu, e^plv).
//
// Replaces: the Pallas kernel `_cut_prior_bwd_kernel` in
//   src/repro/kernels/inl_bottleneck.py (launched by `_prior_bwd_pallas`
//   through the custom VJP `_cutlayer_prior_bwd`).
//
// Rows come as J node groups of T rows, (J*T, d); pmu/plv are (J, d) fp32.
// Per row, from the SAVED forward output u (not a recomputed one), with
// sigma = exp(lv/2), w = (u - mu) e^-lv and wq = (u - pmu) e^-plv:
//   sample:   g_pre = gu + grate (wq - w)
//             dmu   = g_pre + grate w
//             dlv   = g_pre (sigma eps / 2) + grate/2 (w (u - mu) - 1)
//             deps  = g_pre sigma
//             dpmu  = -sum_rows grate wq
//             dplv  = 1/2 (sum_rows grate - sum_rows grate wq (u - pmu))
//   analytic: with dm = (mu - pmu) e^-plv and e_lp = e^(lv - plv):
//             dmu   = gu + grate dm
//             dlv   = gu (sigma eps / 2) + grate/2 (e_lp - 1)
//             deps  = gu sigma
//             dpmu  = -sum_rows grate dm
//             dplv  = 1/2 (sum_rows grate - sum_rows grate e_lp
//                          - sum_rows grate dm (mu - pmu))
// where sum_rows runs over the T rows of one node.
//
// Bound: bytes.  An fp32 call reads mu, lv, eps, u, gu and writes dmu, dlv,
// deps: 32*rows*d bytes, plus 4*rows for grate and 16*J*d for the priors and
// their gradients; the scratch below adds 32*d bytes per block of 64 rows.
//
// Design.  The Pallas kernel sums the prior gradients with += over its
// sequential grid.  Here blocks run in parallel and in no fixed order, so the
// sum is a deterministic two-stage reduction with no atomics:
//   stage 1 (cut_prior_bwd_rows): grid (row-chunks of 64, J).  Each block
//     takes one chunk of one node.  Its 8 warps take every 8th row, one warp
//     per row, lanes striding over d, and write the per-row outputs.  Each
//     lane adds its columns' terms, row after row, into its warp's own slice
//     of shared memory; then the block sums its 8 warp slices in warp order
//     and writes one partial per (node, chunk, column) to `partial`.
//   stage 2 (cut_prior_bwd_reduce): one thread per (node, column) sums that
//     node's partials in chunk order and writes dpmu, dplv.
// Every sum has one fixed order, so two launches on the same inputs give the
// same bits.  The per-row outputs use the rounded fp32 ops of cut_common.cuh
// in the plain version's order (kernels/ref.py, cutlayer_prior_bwd_ref).
#include "cut_common.cuh"

namespace {

using namespace cut;

constexpr int kRowsPerBlock = 64;
constexpr int kSums = 4;  // per column: grate, c, x, y (see stage 1)

template <typename T>
__global__ void cut_prior_bwd_rows(
    const T* __restrict__ mu, const T* __restrict__ lv,
    const float* __restrict__ eps, const float* __restrict__ pmu,
    const float* __restrict__ plv, const T* __restrict__ u,
    const T* __restrict__ gu, const float* __restrict__ grate,
    T* __restrict__ dmu, T* __restrict__ dlv, float* __restrict__ deps,
    float* __restrict__ partial, int64_t per_node, int d, int mode) {
  extern __shared__ float sums[];  // [kSums][kWarpsPerBlock][d]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t chunk = blockIdx.x;
  const int j = blockIdx.y;
  float* s_gr = sums + (0 * kWarpsPerBlock + warp) * d;
  float* s_c = sums + (1 * kWarpsPerBlock + warp) * d;
  float* s_x = sums + (2 * kWarpsPerBlock + warp) * d;
  float* s_y = sums + (3 * kWarpsPerBlock + warp) * d;
  for (int c = lane; c < d; c += 32) {
    s_gr[c] = 0.f;
    s_c[c] = 0.f;
    s_x[c] = 0.f;
    s_y[c] = 0.f;
  }
  const float* pm_j = pmu + (int64_t)j * d;
  const float* pv_j = plv + (int64_t)j * d;
  const int64_t t0 = chunk * kRowsPerBlock;
  const int64_t t1 = min(per_node, t0 + kRowsPerBlock);
  for (int64_t t = t0 + warp; t < t1; t += kWarpsPerBlock) {
    const int64_t row = (int64_t)j * per_node + t;
    const int64_t base = row * (int64_t)d;
    const float gr = grate[row];
    const float gr_half = mul(gr, 0.5f);
    for (int c = lane; c < d; c += 32) {
      const float m = to_f32(mu[base + c]);
      const float l = to_f32(lv[base + c]);
      const float e = eps[base + c];
      const float g = to_f32(gu[base + c]);
      const float pm = pm_j[c];
      const float pv = pv_j[c];
      const float sigma = expf(mul(0.5f, l));
      const float half_se = mul(mul(0.5f, sigma), e);
      float o_mu, o_lv, o_eps;
      s_gr[c] += gr;
      if (mode == kSample) {
        const float q = to_f32(u[base + c]);
        const float um = sub(q, m);
        const float w = mul(um, expf(-l));
        const float upm = sub(q, pm);
        const float wq = mul(upm, expf(-pv));
        const float g_pre = add(g, mul(gr, sub(wq, w)));
        o_mu = add(g_pre, mul(gr, w));
        o_lv = add(mul(g_pre, half_se), mul(gr_half, sub(mul(w, um), 1.f)));
        o_eps = mul(g_pre, sigma);
        const float cv = mul(gr, wq);
        s_c[c] += cv;
        s_x[c] += mul(cv, upm);
      } else {
        const float mpm = sub(m, pm);
        const float dm = mul(mpm, expf(-pv));
        const float e_lp = expf(sub(l, pv));
        o_mu = add(g, mul(gr, dm));
        o_lv = add(mul(g, half_se), mul(gr_half, sub(e_lp, 1.f)));
        o_eps = mul(g, sigma);
        const float cv = mul(gr, dm);
        s_c[c] += cv;
        s_x[c] += mul(gr, e_lp);
        s_y[c] += mul(cv, mpm);
      }
      store(dmu + base + c, o_mu);
      store(dlv + base + c, o_lv);
      deps[base + c] = o_eps;
    }
  }
  __syncthreads();
  // this block's partial sums, warp slices added in warp order
  const int64_t nchunks = gridDim.x;
  float* out = partial + (((int64_t)j * nchunks + chunk) * kSums) * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    for (int k = 0; k < kSums; ++k) {
      float v = 0.f;
      for (int w = 0; w < kWarpsPerBlock; ++w)
        v += sums[(k * kWarpsPerBlock + w) * d + c];
      out[k * d + c] = v;
    }
  }
}

__global__ void cut_prior_bwd_reduce(const float* __restrict__ partial,
                                     float* __restrict__ dpmu,
                                     float* __restrict__ dplv, int J,
                                     int64_t nchunks, int d) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)J * d) return;
  const int64_t j = idx / d;
  const int c = (int)(idx % d);
  float s_gr = 0.f, s_c = 0.f, s_x = 0.f, s_y = 0.f;
  for (int64_t k = 0; k < nchunks; ++k) {  // chunk order: fixed
    const float* p = partial + ((j * nchunks + k) * kSums) * d;
    s_gr += p[c];
    s_c += p[d + c];
    s_x += p[2 * d + c];
    s_y += p[3 * d + c];
  }
  dpmu[idx] = -s_c;
  dplv[idx] = 0.5f * ((s_gr - s_x) - s_y);
}

int64_t chunks(long long per_node) {
  return (per_node + kRowsPerBlock - 1) / kRowsPerBlock;
}

template <typename T>
int set_smem(size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(cut_prior_bwd_rows<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace

// Floats of scratch one launch needs for J nodes of per_node rows of width d
// (the wrapper allocates them with torch.empty).
extern "C" long long cut_prior_bwd_scratch(int J, long long per_node, int d) {
  return (long long)J * chunks(per_node) * kSums * d;
}

// Plain C entry point, loaded with ctypes.  mode: 0 sample, 1 analytic.
// is_bf16 selects the type of mu, lv, u, gu, dmu and dlv; eps, pmu, plv,
// grate, deps, dpmu, dplv and the scratch `partial` are fp32.  It launches
// the two stages one after the other on `stream` and returns
// cudaGetLastError(); the caller raises if nonzero.
extern "C" int cut_prior_bwd_launch(
    const void* mu, const void* lv, const void* eps, const void* pmu,
    const void* plv, const void* u, const void* gu, const void* grate,
    void* dmu, void* dlv, void* deps, void* dpmu, void* dplv, void* partial,
    int J, long long per_node, int d, int mode, int is_bf16, void* stream) {
  if (J <= 0 || J > 65535 || per_node <= 0 || d <= 0 ||
      (mode != kSample && mode != kAnalytic))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kSums * kWarpsPerBlock * d * sizeof(float);
  const int err = is_bf16 ? set_smem<__nv_bfloat16>(smem) : set_smem<float>(smem);
  if (err) return err;
  const int64_t nchunks = chunks(per_node);
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((unsigned)nchunks, (unsigned)J);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    using B = __nv_bfloat16;
    cut_prior_bwd_rows<B><<<grid, block, smem, s>>>(
        (const B*)mu, (const B*)lv, (const float*)eps, (const float*)pmu,
        (const float*)plv, (const B*)u, (const B*)gu, (const float*)grate,
        (B*)dmu, (B*)dlv, (float*)deps, (float*)partial, per_node, d, mode);
  } else {
    cut_prior_bwd_rows<float><<<grid, block, smem, s>>>(
        (const float*)mu, (const float*)lv, (const float*)eps,
        (const float*)pmu, (const float*)plv, (const float*)u,
        (const float*)gu, (const float*)grate, (float*)dmu, (float*)dlv,
        (float*)deps, (float*)partial, per_node, d, mode);
  }
  const int launched = (int)cudaGetLastError();
  if (launched) return launched;
  const int64_t n = (int64_t)J * d;
  const int threads = 256;
  cut_prior_bwd_reduce<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                         s>>>((const float*)partial, (float*)dpmu,
                              (float*)dplv, J, nchunks, d);
  return (int)cudaGetLastError();
}
