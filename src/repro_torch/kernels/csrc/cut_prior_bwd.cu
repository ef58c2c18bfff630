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
// their gradients.
//
// Design: one launch, grid (nb, J, ceil(d / 64)).  The Pallas kernel sums
// the prior gradients with += over its sequential grid; here the blocks of
// a node run in parallel, and the sums keep one order that depends only on
// (J, T, d) (kernels/ref.py, cutlayer_prior_bwd_sums_ordered, repeats it):
//   * A node's rows fall into chunks of kWarps rows; block b of the node
//     takes chunks b, b + nb, b + 2 nb, ... and a 64-column tile, warp w
//     the chunk's row w.  The caller gives nb, a function of (J, T, d)
//     alone (kernels/ref.py, prior_bwd_blocks: min(chunks, ceil(264 /
//     (J tiles)))), so a small call still spreads over tens of blocks and a
//     large one has about 264, each walking many chunks (two at a time, both
//     rows' loads issued before either is used).
//   * Each lane owns two columns of the tile (a float2 / bf16x2 pair where
//     d and the pointers allow it, else columns lane and lane + 32) and
//     adds its terms in registers, chunk after chunk: grate, c, x, y.
//   * The block adds its 8 warps' sums in warp order and writes one partial
//     per (node, block, sum, column) to `partial`.
//   * Hand-off without float atomics: each block fences its partials and
//     takes a ticket, an integer atomicAdd on the (node, tile)'s counter in
//     `tickets`.
//     The block that draws the last ticket resets the counter to 0 (so the
//     next launch, and every replay of a captured CUDA graph, starts from
//     zero) and sums the node's nb partials in block order, one thread per
//     (sum, column), 8 loads ahead of the adds; then writes dpmu, dplv.
// The per-row outputs use the rounded fp32 ops of cut_common.cuh in the
// plain version's order (kernels/ref.py, cutlayer_prior_bwd_ref); e^-plv is
// computed once per column, the same expf of the same value.
//
// The counters belong to the caller, zero before a launch and after it:
// the wrapper keeps one set per (device, stream), so launches on two streams
// never share them.
#include "cut_common.cuh"

namespace {

using namespace cut;

constexpr int kWarps = 8;            // rows of a chunk: one for each warp
constexpr int kTileCols = 64;        // columns of a block: two a lane
constexpr int kSums = 4;             // per column: grate, c, x, y
constexpr int kAhead = 8;            // partials loaded ahead of the adds

// One lane's share of one row: two columns.
struct RowPart {
  float m[2], l[2], e[2], q[2], g[2], gr;
};

// A pair of adjacent columns, 8 bytes in fp32 and 4 in bf16 (aligned).
__device__ __forceinline__ void load2(const float* p, float out[2]) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  out[0] = v.x;
  out[1] = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float out[2]) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  out[0] = __low2float(v);
  out[1] = __high2float(v);
}
__device__ __forceinline__ void store2(float* p, const float v[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, const float v[2]) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
}

template <typename T, bool kVec>
__device__ __forceinline__ void load_row(RowPart& r, const T* mu,
                                         const T* lv, const float* eps,
                                         const T* u, const T* gu,
                                         const float* grate, int64_t row,
                                         int64_t base, int c0, int c1,
                                         bool has0, bool has1) {
  r.gr = grate[row];
  if (kVec && has1) {  // c1 == c0 + 1, both in range, pairs aligned
    load2(mu + base + c0, r.m);
    load2(lv + base + c0, r.l);
    load2(eps + base + c0, r.e);
    load2(u + base + c0, r.q);
    load2(gu + base + c0, r.g);
    return;
  }
  const int cs[2] = {c0, c1};
  const bool hs[2] = {has0, has1};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!hs[i]) continue;
    const int64_t at = base + cs[i];
    r.m[i] = to_f32(mu[at]);
    r.l[i] = to_f32(lv[at]);
    r.e[i] = eps[at];
    r.q[i] = to_f32(u[at]);
    r.g[i] = to_f32(gu[at]);
  }
}

// The per-row outputs and this row's terms of the lane's sums.
template <typename T, bool kVec>
__device__ __forceinline__ void use_row(
    const RowPart& r, const float pm[2], const float pv[2],
    const float epv[2], int mode, T* dmu, T* dlv, float* deps, int64_t base,
    int c0, int c1, bool has0, bool has1, float& s_gr, float s_c[2],
    float s_x[2], float s_y[2]) {
  const float gr = r.gr;
  const float gr_half = mul(gr, 0.5f);
  s_gr = add(s_gr, gr);
  float o_mu[2], o_lv[2], o_eps[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m = r.m[i], l = r.l[i], e = r.e[i], g = r.g[i];
    const float sigma = expf(mul(0.5f, l));
    const float half_se = mul(mul(0.5f, sigma), e);
    if (mode == kSample) {
      const float q = r.q[i];
      const float um = sub(q, m);
      const float w = mul(um, expf(-l));
      const float upm = sub(q, pm[i]);
      const float wq = mul(upm, epv[i]);
      const float g_pre = add(g, mul(gr, sub(wq, w)));
      o_mu[i] = add(g_pre, mul(gr, w));
      o_lv[i] = add(mul(g_pre, half_se), mul(gr_half, sub(mul(w, um), 1.f)));
      o_eps[i] = mul(g_pre, sigma);
      const float cv = mul(gr, wq);
      s_c[i] = add(s_c[i], cv);
      s_x[i] = add(s_x[i], mul(cv, upm));
    } else {
      const float mpm = sub(m, pm[i]);
      const float dm = mul(mpm, epv[i]);
      const float e_lp = expf(sub(l, pv[i]));
      o_mu[i] = add(g, mul(gr, dm));
      o_lv[i] = add(mul(g, half_se), mul(gr_half, sub(e_lp, 1.f)));
      o_eps[i] = mul(g, sigma);
      const float cv = mul(gr, dm);
      s_c[i] = add(s_c[i], cv);
      s_x[i] = add(s_x[i], mul(gr, e_lp));
      s_y[i] = add(s_y[i], mul(cv, mpm));
    }
  }
  if (kVec && has1) {
    store2(dmu + base + c0, o_mu);
    store2(dlv + base + c0, o_lv);
    store2(deps + base + c0, o_eps);
    return;
  }
  const int cs[2] = {c0, c1};
  const bool hs[2] = {has0, has1};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!hs[i]) continue;
    store(dmu + base + cs[i], o_mu[i]);
    store(dlv + base + cs[i], o_lv[i]);
    deps[base + cs[i]] = o_eps[i];
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(32 * kWarps) cut_prior_bwd_kernel(
    const T* __restrict__ mu, const T* __restrict__ lv,
    const float* __restrict__ eps, const float* __restrict__ pmu,
    const float* __restrict__ plv, const T* __restrict__ u,
    const T* __restrict__ gu, const float* __restrict__ grate,
    T* __restrict__ dmu, T* __restrict__ dlv, float* __restrict__ deps,
    float* __restrict__ dpmu, float* __restrict__ dplv,
    float* __restrict__ partial, unsigned int* __restrict__ tickets,
    int64_t per_node, int d, int mode) {
  __shared__ float sums[kSums][kWarps][kTileCols];
  __shared__ float total[kSums][kTileCols];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nb = gridDim.x;
  const int b = blockIdx.x;
  const int j = blockIdx.y;
  const int tile = blockIdx.z;
  const int col0 = tile * kTileCols;
  // this lane's two columns
  const int c0 = col0 + (kVec ? 2 * lane : lane);
  const int c1 = kVec ? c0 + 1 : c0 + 32;
  const bool has0 = c0 < d, has1 = c1 < d;
  float pm[2] = {0.f, 0.f}, pv[2] = {0.f, 0.f}, epv[2] = {0.f, 0.f};
  if (has0) {
    pm[0] = pmu[(int64_t)j * d + c0];
    pv[0] = plv[(int64_t)j * d + c0];
  }
  if (has1) {
    pm[1] = pmu[(int64_t)j * d + c1];
    pv[1] = plv[(int64_t)j * d + c1];
  }
  epv[0] = expf(-pv[0]);
  epv[1] = expf(-pv[1]);

  float s_gr = 0.f, s_c[2] = {0.f, 0.f}, s_x[2] = {0.f, 0.f},
        s_y[2] = {0.f, 0.f};
  const int64_t nchunks = (per_node + kWarps - 1) / kWarps;
  const int64_t node0 = (int64_t)j * per_node;
  // chunks b, b + nb, ...: two at a time, both rows loaded before either
  // is used; the terms are added in chunk order all the same
  for (int64_t k = b; k < nchunks; k += 2 * (int64_t)nb) {
    const int64_t ta = k * kWarps + warp;
    const int64_t tb = (k + nb) * kWarps + warp;
    const bool va = has0 && ta < per_node;
    const bool vb = has0 && k + nb < nchunks && tb < per_node;
    RowPart ra{}, rb{};
    if (va)
      load_row<T, kVec>(ra, mu, lv, eps, u, gu, grate, node0 + ta,
                        (node0 + ta) * d, c0, c1, has0, has1);
    if (vb)
      load_row<T, kVec>(rb, mu, lv, eps, u, gu, grate, node0 + tb,
                        (node0 + tb) * d, c0, c1, has0, has1);
    if (va)
      use_row<T, kVec>(ra, pm, pv, epv, mode, dmu, dlv, deps,
                       (node0 + ta) * d, c0, c1, has0, has1, s_gr, s_c, s_x,
                       s_y);
    if (vb)
      use_row<T, kVec>(rb, pm, pv, epv, mode, dmu, dlv, deps,
                       (node0 + tb) * d, c0, c1, has0, has1, s_gr, s_c, s_x,
                       s_y);
  }

  // this block's partials: the warps' sums added in warp order
  const int l0 = c0 - col0, l1 = c1 - col0;
  sums[0][warp][l0] = s_gr;
  sums[0][warp][l1] = s_gr;
  sums[1][warp][l0] = s_c[0];
  sums[1][warp][l1] = s_c[1];
  sums[2][warp][l0] = s_x[0];
  sums[2][warp][l1] = s_x[1];
  sums[3][warp][l0] = s_y[0];
  sums[3][warp][l1] = s_y[1];
  __syncthreads();
  const int ks = threadIdx.x / kTileCols;  // 256 threads: (sum, column)
  const int cl = threadIdx.x % kTileCols;
  const int col = col0 + cl;
  const int64_t node_part = (int64_t)j * nb * kSums * d;
  if (col < d) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v = add(v, sums[ks][w][cl]);
    partial[node_part + ((int64_t)b * kSums + ks) * d + col] = v;
  }
  // hand-off: the last block of this (node, tile) to arrive sums them all
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int* ticket = &tickets[j * gridDim.z + tile];
    last = atomicAdd(ticket, 1u) == (unsigned int)nb - 1u;
    if (last) *ticket = 0u;  // every block has drawn: reset for the next
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (col < d) {
    const float* p = partial + node_part + (int64_t)ks * d + col;
    const int64_t step = (int64_t)kSums * d;
    float s = 0.f;
    for (int b0 = 0; b0 < nb; b0 += kAhead) {
      float v[kAhead];
#pragma unroll
      for (int i = 0; i < kAhead; ++i)
        v[i] = b0 + i < nb ? __ldcg(p + (int64_t)(b0 + i) * step) : 0.f;
#pragma unroll
      for (int i = 0; i < kAhead; ++i)
        if (b0 + i < nb) s = add(s, v[i]);  // block order: fixed
    }
    total[ks][cl] = s;
  }
  __syncthreads();
  if (ks == 0 && col < d) {
    const int64_t at = (int64_t)j * d + col;
    dpmu[at] = -total[1][cl];
    dplv[at] = mul(0.5f, sub(sub(total[0][cl], total[2][cl]), total[3][cl]));
  }
}

inline bool aligned(const void* p, size_t bytes) {
  return (uintptr_t)p % bytes == 0;
}

template <typename T>
int launch(const void* mu, const void* lv, const void* eps, const void* pmu,
           const void* plv, const void* u, const void* gu, const void* grate,
           void* dmu, void* dlv, void* deps, void* dpmu, void* dplv,
           void* partial, unsigned int* tickets, dim3 grid,
           long long per_node, int d, int mode, cudaStream_t s) {
  // the float2 / bf16x2 path: even d, every row pair aligned
  const bool vec = d % 2 == 0 && aligned(eps, 8) && aligned(deps, 8) &&
                   aligned(mu, 2 * sizeof(T)) && aligned(lv, 2 * sizeof(T)) &&
                   aligned(u, 2 * sizeof(T)) && aligned(gu, 2 * sizeof(T)) &&
                   aligned(dmu, 2 * sizeof(T)) && aligned(dlv, 2 * sizeof(T));
  const dim3 block(32 * kWarps);
  auto kernel = vec ? cut_prior_bwd_kernel<T, true>
                    : cut_prior_bwd_kernel<T, false>;
  kernel<<<grid, block, 0, s>>>(
      (const T*)mu, (const T*)lv, (const float*)eps, (const float*)pmu,
      (const float*)plv, (const T*)u, (const T*)gu, (const float*)grate,
      (T*)dmu, (T*)dlv, (float*)deps, (float*)dpmu, (float*)dplv,
      (float*)partial, tickets, per_node, d, mode);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  mode: 0 sample, 1 analytic.
// is_bf16 selects the type of mu, lv, u, gu, dmu and dlv; eps, pmu, plv,
// grate, deps, dpmu, dplv and the scratch `partial` (J * nb * 4 * d
// floats) are fp32.  nb is the blocks of a node, 1 <= nb <= ceil(T / 8);
// `tickets` holds J * ceil(d / 64) zeros, which the launch leaves zero.  One
// launch on `stream`; returns cudaGetLastError(), the caller raises if
// nonzero.
extern "C" int cut_prior_bwd_launch(
    const void* mu, const void* lv, const void* eps, const void* pmu,
    const void* plv, const void* u, const void* gu, const void* grate,
    void* dmu, void* dlv, void* deps, void* dpmu, void* dplv, void* partial,
    void* tickets, int nb, int J, long long per_node, int d, int mode,
    int is_bf16, void* stream) {
  const long long tiles = (d + kTileCols - 1) / kTileCols;
  const long long nchunks = (per_node + kWarps - 1) / kWarps;
  if (J <= 0 || J > 65535 || per_node <= 0 || d <= 0 || tiles > 65535 ||
      nb <= 0 || nb > nchunks || (mode != kSample && mode != kAnalytic))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)nb, (unsigned)J, (unsigned)tiles);
  cudaStream_t s = (cudaStream_t)stream;
  unsigned int* t = (unsigned int*)tickets;
  if (is_bf16)
    return launch<__nv_bfloat16>(mu, lv, eps, pmu, plv, u, gu, grate, dmu,
                                 dlv, deps, dpmu, dplv, partial, t, grid,
                                 per_node, d, mode, s);
  return launch<float>(mu, lv, eps, pmu, plv, u, gu, grate, dmu, dlv, deps,
                       dpmu, dplv, partial, t, grid, per_node, d, mode, s);
}
