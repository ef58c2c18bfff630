// Warp-level bf16 tensor-core helpers shared by the LLM kernels
// (flash_attn_fwd.cu, ssd_scan.cu): `mma.sync` m16n8k16 with fp32
// accumulation, `ldmatrix` (plain and transposed) and 16-byte `cp.async`.
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32,
// lane = 4 g + t (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major)  a[0] = (g,   2t..2t+1)   a[1] = (g+8, 2t..2t+1)
//                           a[2] = (g,   2t+8..+9)   a[3] = (g+8, 2t+8..+9)
//   B (16 x 8, k x n)       b[0] = (k 2t..2t+1, n g) b[1] = (k 2t+8..+9, n g)
//   C (16 x 8, fp32)        c[0..1] = (g, 2t..2t+1)  c[2..3] = (g+8, 2t..2t+1)
// so an accumulator of two neighbouring n-tiles, converted to bf16 pairs,
// is the A fragment of the next product (k = those 16 columns): the
// FlashAttention-2 register reuse.  A tile in shared memory keeps rows of
// an odd number of 16-byte units (`padded`), so the eight row addresses of
// an `ldmatrix` 8 x 8 matrix fall in eight different bank groups.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// row stride, in bf16 elements, of a tile whose rows hold `cols` (a
// multiple of 8) values: one 16-byte unit more, which makes it odd when
// cols is a multiple of 16
__host__ __device__ constexpr int padded(int cols) { return cols + 8; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a . b, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices; lanes 8m..8m+7 give the row addresses of
// matrix m, and r[m] is this lane's pair of matrix m
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// A fragment (16 x 16) of a row-major tile: rows r0.., columns k0..
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int stride,
                                       int r0, int k0, int lane) {
  ldmatrix_x4(a, tile + (r0 + (lane & 15)) * stride + k0 + (lane >> 4) * 8);
}

// A fragment (16 x 16) of the transpose of a row-major tile: A[m][k] =
// tile[k0 + k][m0 + m]
__device__ __forceinline__ void load_a_trans(uint32_t (&a)[4],
                                             const __nv_bfloat16* tile,
                                             int stride, int m0, int k0,
                                             int lane) {
  const int m = lane >> 3;
  ldmatrix_x4_trans(a, tile + (k0 + (lane & 7) + (m >> 1) * 8) * stride +
                           m0 + (m & 1) * 8);
}

// B fragments of two n-tiles (n0.., n0+8..) over k0..k0+15, from a tile
// stored n-major (tile[n][k], as K rows are): b[0], b[1] for n0 and b[2],
// b[3] for n0 + 8
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4],
                                          const __nv_bfloat16* tile,
                                          int stride, int n0, int k0,
                                          int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * stride + k0 +
                     ((lane >> 3) & 1) * 8);
}

// the same from a tile stored k-major (tile[k][n], as V rows are)
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4],
                                          const __nv_bfloat16* tile,
                                          int stride, int n0, int k0,
                                          int lane) {
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  stride + n0 + (lane >> 4) * 8);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes global -> shared; with `valid` false the 16 bytes are zeros
// (src is not read, but must be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile(
      "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace tc
