// Fusion-node unpack for Hopper (sm_90a): codeword lanes -> dense values.
//
// Replaces: the Pallas kernel `_unpack_dequant_kernel` in
//   src/repro/kernels/inl_bottleneck.py (launched by `_unpack_pallas`, entry
//   point `unpack_dequant`).
//
// Computes, for every row of (rows, W) uint32 lanes and every column
// c < d (vpw = 32 / b codewords a lane, 1 <= b <= 16):
//   idx = (lanes[c / vpw] >> ((c % vpw) * b)) & (2^b - 1)
//   out = idx / scale - r                         stored as fp32 or bf16
// the dequantize of cut_common.cuh, a true division, so the fusion node
// receives the edge's u bit for bit.
//
// Bound: bytes.  A call reads 4 W bytes and writes d values (4 d bytes in
// fp32) a row, with two flops a value.
//
// Design: one warp per row, lanes striding over the output columns, so the
// writes are coalesced; the vpw threads that share a lane read the same
// word, which the cache serves.  Output columns are written by one thread
// each; no thread writes a lane.
#include "cut_common.cuh"

namespace {

using namespace cut;

template <typename T>
__global__ void unpack_dequant_kernel(const uint32_t* __restrict__ packed,
                                      T* __restrict__ out, int64_t rows,
                                      int d, int W, int bits, float scale,
                                      float r) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int vpw = 32 / bits;
  const uint32_t mask = (1u << bits) - 1u;
  const uint32_t* in_row = packed + row * (int64_t)W;
  const int64_t base = row * (int64_t)d;
  for (int c = lane; c < d; c += 32) {
    const uint32_t idx = (in_row[c / vpw] >> ((c % vpw) * bits)) & mask;
    store(out + base + c, dequantize_index((float)idx, scale, r));
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  `packed` holds
// rows * packed_width(d, bits) uint32; is_bf16 selects the output type.
// Returns cudaGetLastError() after the launch; the caller raises if
// nonzero.
extern "C" int unpack_dequant_launch(const void* packed, void* out,
                                     long long rows, int d, int bits,
                                     float r, int is_bf16, void* stream) {
  if (rows <= 0 || d <= 0 || bits < 1 || bits > 16)
    return (int)cudaErrorInvalidValue;
  const float scale = quant_scale(bits, r);
  const int W = packed_width(d, bits);
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    unpack_dequant_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const uint32_t*)packed, (__nv_bfloat16*)out, rows, d, W, bits,
        scale, r);
  } else {
    unpack_dequant_kernel<float><<<grid, block, 0, s>>>(
        (const uint32_t*)packed, (float*)out, rows, d, W, bits, scale, r);
  }
  return (int)cudaGetLastError();
}
