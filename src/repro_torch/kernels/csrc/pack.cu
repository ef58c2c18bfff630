// Standalone pack for Hopper (sm_90a): quantized values -> codeword lanes.
//
// Replaces: the Pallas kernel `_pack_kernel` in
//   src/repro/kernels/inl_bottleneck.py (launched by `_pack_pallas`, entry
//   point `pack_values`).  It puts on the packed wire a latent whose forward
//   kernel emits no lanes: split learning's deterministic cut and the
//   learned-prior cut.
//
// Computes, for every row of (rows, d) values u (fp32 or bf16):
//   idx   = rintf((clip(u) + r) * scale)       the codeword index
//   lanes = 32 / b codewords per uint32, little-endian, the tail zero
// for 1 <= b <= 16.  On values already on the b-bit grid this is lossless:
// unpack_dequant.cu gives u back bit for bit.
//
// Bound: bytes.  An fp32 call reads 4 d bytes and writes 4 W bytes a row
// (W = ceil(d / (32 / b))), with three flops a value.
//
// Design: cut_fwd_pack.cu's without the cut: one warp per row, chunks of
// 32 * vpw columns read by neighbouring lanes at neighbouring addresses,
// codewords staged in the warp's slice of shared memory, each lane written
// whole by one thread (cut_common.cuh, write_lanes).
#include "cut_common.cuh"

namespace {

using namespace cut;

template <typename T>
__global__ void pack_kernel(const T* __restrict__ u,
                            uint32_t* __restrict__ packed, int64_t rows,
                            int d, int W, int bits, float scale, float r) {
  __shared__ uint16_t stages[kWarpsPerBlock][32 * kMaxVals];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (row >= rows) return;  // the whole warp leaves together
  uint16_t* stage = stages[warp];
  const int vpw = 32 / bits;
  const int64_t base = row * (int64_t)d;
  uint32_t* out_row = packed + row * (int64_t)W;
  for (int c0 = 0; c0 < d; c0 += 32 * vpw) {
    for (int i = 0; i < vpw; ++i) {
      const int c = c0 + lane + 32 * i;
      if (c >= d) break;
      stage[lane + 32 * i] =
          (uint16_t)quantize_index(to_f32(u[base + c]), scale, r);
    }
    write_lanes(stage, out_row, c0, d, W, bits, vpw, lane);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  is_bf16 selects the type of u;
// `packed` holds rows * packed_width(d, bits) uint32.  Returns
// cudaGetLastError() after the launch; the caller raises if nonzero.
extern "C" int pack_launch(const void* u, void* packed, long long rows, int d,
                           int bits, float r, int is_bf16, void* stream) {
  if (rows <= 0 || d <= 0 || bits < 1 || bits > 16)
    return (int)cudaErrorInvalidValue;
  const float scale = quant_scale(bits, r);
  const int W = packed_width(d, bits);
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    pack_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)u, (uint32_t*)packed, rows, d, W, bits, scale,
        r);
  } else {
    pack_kernel<float><<<grid, block, 0, s>>>(
        (const float*)u, (uint32_t*)packed, rows, d, W, bits, scale, r);
  }
  return (int)cudaGetLastError();
}
