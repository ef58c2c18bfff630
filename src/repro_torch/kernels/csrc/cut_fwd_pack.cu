// Pack-emitting fused cut-layer forward for Hopper (sm_90a).
//
// Replaces: the Pallas kernel `_cut_fwd_pack_kernel` in
//   src/repro/kernels/inl_bottleneck.py (launched by `_fwd_pack_pallas`,
//   entry point `cutlayer_pack_forward`).
//
// Computes, for every row of (rows, d), from one read of (mu, lv, eps):
//   idx  = rintf((clip(mu + exp(lv/2) * eps) + r) * scale)   codeword index
//   u    = idx / scale - r                                   stored in mu's type
//   lanes: 32 / b codewords per uint32, little-endian, the tail zero
//   rate = the mode's per-row rate at u (sample, analytic or none)
// for a packable width 1 <= b <= 16.  (u, rate) equal cut_fwd.cu's bit for
// bit: the quantizer chain and the rate's per-element term are cut_common.cuh's,
// and each lane adds its columns' terms in cut_fwd's order.
//
// Bound: bytes.  An fp32 call reads mu, lv and eps and writes u (16 bytes a
// column), writes W = ceil(d / (32 / b)) lanes (4 W bytes a row) and the
// rate (4 bytes a row), with a handful of flops a column.
//
// Design: one warp per row, as cut_fwd.  The row is walked in chunks of
// 32 * vpw columns (vpw = 32 / b, the codewords of a lane).  In a chunk,
// lane t computes columns c0 + t + 32 i, i < vpw: neighbouring lanes read
// neighbouring addresses, and over the whole row lane t meets its columns in
// cut_fwd's order (t, t + 32, t + 64, ...), so its rate sum is cut_fwd's.
// Each codeword goes into the warp's slice of shared memory (uint16, 32 * vpw
// <= 1024 of them, 2 KB); after __syncwarp, lane t assembles the chunk's
// lane t from its vpw consecutive codewords and writes it whole, so no two
// threads touch one lane and no atomics are needed.  A warp whose row lies
// past the end returns, so ragged row counts need no padding.
#include "cut_common.cuh"

namespace {

using namespace cut;

template <typename T>
__global__ void cut_fwd_pack_kernel(const T* __restrict__ mu,
                                    const T* __restrict__ lv,
                                    const float* __restrict__ eps,
                                    T* __restrict__ u,
                                    uint32_t* __restrict__ packed,
                                    float* __restrict__ rate, int64_t rows,
                                    int d, int W, int bits, float scale,
                                    float r, int mode) {
  __shared__ uint16_t stages[kWarpsPerBlock][32 * kMaxVals];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (row >= rows) return;  // the whole warp leaves together
  uint16_t* stage = stages[warp];
  const int vpw = 32 / bits;
  const int64_t base = row * (int64_t)d;
  uint32_t* out_row = packed + row * (int64_t)W;
  float acc = 0.f;
  for (int c0 = 0; c0 < d; c0 += 32 * vpw) {
    for (int i = 0; i < vpw; ++i) {
      const int c = c0 + lane + 32 * i;
      if (c >= d) break;
      const float m = to_f32(mu[base + c]);
      const float l = to_f32(lv[base + c]);
      const float e = eps[base + c];
      const float sigma = expf(mul(0.5f, l));
      const float idx = quantize_index(add(m, mul(sigma, e)), scale, r);
      const float q = dequantize_index(idx, scale, r);
      store(u + base + c, q);
      if (mode != kNone) acc = add(acc, rate_term(q, m, l, mode));
      stage[lane + 32 * i] = (uint16_t)idx;
    }
    write_lanes(stage, out_row, c0, d, W, bits, vpw, lane);
  }
  acc = warp_sum(acc);
  if (lane == 0) rate[row] = 0.5f * acc;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  mode: 0 sample, 1 analytic,
// 2 none.  is_bf16 selects the type of mu, lv and u (eps is always fp32).
// `packed` holds rows * packed_width(d, bits) uint32.  Returns
// cudaGetLastError() after the launch; the caller raises if nonzero.
extern "C" int cut_fwd_pack_launch(const void* mu, const void* lv,
                                   const void* eps, void* u, void* packed,
                                   void* rate, long long rows, int d,
                                   int bits, float r, int mode, int is_bf16,
                                   void* stream) {
  if (rows <= 0 || d <= 0 || bits < 1 || bits > 16)
    return (int)cudaErrorInvalidValue;
  const float scale = quant_scale(bits, r);
  const int W = packed_width(d, bits);
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    cut_fwd_pack_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)mu, (const __nv_bfloat16*)lv,
        (const float*)eps, (__nv_bfloat16*)u, (uint32_t*)packed,
        (float*)rate, rows, d, W, bits, scale, r, mode);
  } else {
    cut_fwd_pack_kernel<float><<<grid, block, 0, s>>>(
        (const float*)mu, (const float*)lv, (const float*)eps, (float*)u,
        (uint32_t*)packed, (float*)rate, rows, d, W, bits, scale, r, mode);
  }
  return (int)cudaGetLastError();
}
