// Chunked Mamba2 / SSD selective scan for Hopper (sm_90a).
//
// Replaces: the Pallas kernel `_ssd_kernel` in src/repro/kernels/ssm_scan.py
//   (launched by `ssd_scan`); the JAX model runs the same contract as
//   `_ssd_chunked` in src/repro/models/ssm.py, which also returns the final
//   state.
//
// Computes, for each (b, h), with ngroups = 1 (B and C shared by the heads),
// over chunks of L rows, cum = the in-chunk cumsum of dt * a:
//   y_i   = sum_{j <= i in the chunk} (C_i . B_j) e^{cum_i - cum_j} dt_j x_j
//         + e^{cum_i} C_i . state  +  D x_i
//   state <- e^{cum_last} state + sum_j B_j (e^{cum_last - cum_j} dt_j) x_j^T
// starting from a zero state; y (B, S, H, P) in x's type, and the final
// state (B, H, N, P) in fp32, which the model's prefill keeps in its cache
// (the Pallas kernel drops it; the model path needs it).
//
// Bound: bytes.  At (B=4, S=2048, H=80, P=64, N=64, L=256, bf16) the call
// reads x (84 MB), B, C, dt and writes y (84 MB) and the state, about
// 178 MB or 0.053 ms at 3.35 TB/s; its causal work, C.B^T once per (b,
// chunk) plus the per-head products, is about 2.2e10 flops, 0.022 ms at
// the 989 TFLOP/s bf16 rate.  This first kernel computes with fp32 FMAs
// out of shared memory and recomputes C.B^T for every head, so it is bound
// by its own instruction issue, well above the bytes bound; tensor-core
// tiles and sharing C.B^T across heads are the later redesign.
//
// Design: one block of 256 threads per (b, h) walks the chunks in order and
// holds the (N, P) fp32 state in shared memory, as the Pallas sequential
// grid holds it in VMEM.  Per chunk: dt and cum (warp 0 scans the chunk in
// 32-row pieces with shuffles, one fixed order); then the chunk's rows in
// tiles of 64: the inter-chunk term from the C tile and the state, and for
// each kv tile j <= i the decay-weighted G = (C_i B_j^T) e^{cum_i - cum_j}
// dt_j, formed only where j <= i (e^{cum_i - cum_j} overflows above the
// diagonal), then y += G x_j.  The 256 x 256 fp32 G of a whole chunk (256
// KB) would not fit the 227 KB a block may use, so G lives one 64 x 64 tile
// at a time.  The last row tile's walk over the kv tiles also accumulates
// the state update, in registers, and the state is replaced after the
// chunk's last use of the old one.  Each thread owns a 4 x 4 patch of every
// 64 x 64 product (rows 4 * (t / 16) + i, columns t % 16 + 16 j); tiles are
// padded to an odd row stride so column-strided reads hit distinct banks.
// N, P <= 64; any chunk length L (a ragged row tile is masked).
#include "cut_common.cuh"

namespace {

using cut::store;
using cut::to_f32;

constexpr int kT = 64;             // rows of a tile; also max N and P
constexpr int kThreads = 256;
constexpr int kStride = kT + 1;    // odd row stride of every tile
constexpr int kTile = kT * kStride;

size_t smem_bytes(int L) { return sizeof(float) * (5 * (size_t)kTile + 2 * (size_t)L); }

template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int rows,
                                          int cols) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads) {
    const int r = idx / cols, c = idx - r * cols;
    dst[r * kStride + c] = to_f32(src[(int64_t)r * row_stride + c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a,
                    const T* __restrict__ bm, const T* __restrict__ cm,
                    const float* __restrict__ dskip, T* __restrict__ y,
                    float* __restrict__ state_out, int S, int H, int P, int N,
                    int L) {
  extern __shared__ float smem[];
  float* St = smem;            // state (N, P)
  float* Ci = St + kTile;      // C rows of the row tile (ni, N)
  float* Bj = Ci + kTile;      // B rows of the kv tile (nj, N)
  float* Xj = Bj + kTile;      // x rows of the kv tile (nj, P)
  float* G = Xj + kTile;       // decay-weighted C_i B_j^T (ni, nj)
  float* cum = G + kTile;      // (L,)
  float* dts = cum + L;        // (L,)

  const int b = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const float ah = a[h], dh = dskip[h];
  const int64_t xrow = (int64_t)H * P;       // x and y row stride
  const T* xb = x + (int64_t)b * S * xrow + (int64_t)h * P;
  T* yb = y + (int64_t)b * S * xrow + (int64_t)h * P;
  const T* bb = bm + (int64_t)b * S * N;
  const T* cb = cm + (int64_t)b * S * N;
  const float* dtb = dt + (int64_t)b * S * H + h;

  for (int idx = tid; idx < kTile; idx += kThreads) St[idx] = 0.f;

  const int nT = (L + kT - 1) / kT;
  for (int c0 = 0; c0 < S; c0 += L) {
    __syncthreads();  // the previous chunk is done with cum, dts and St
    for (int t = tid; t < L; t += kThreads) dts[t] = dtb[(int64_t)(c0 + t) * H];
    __syncthreads();
    if (tid < 32) {
      float carry = 0.f;
      for (int base = 0; base < L; base += 32) {
        const int t = base + tid;
        float v = t < L ? dts[t] * ah : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (tid >= off) v += u;
        }
        v += carry;
        if (t < L) cum[t] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float cum_last = cum[L - 1];

    float st[4][4];  // the state update, accumulated on the last row tile
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = 0.f;

    for (int it = 0; it < nT; ++it) {
      const int i0 = it * kT, ni = min(kT, L - i0);
      const bool last = it == nT - 1;
      __syncthreads();
      load_tile(Ci, cb + (int64_t)(c0 + i0) * N, N, ni, N);
      __syncthreads();

      // inter-chunk term: e^{cum_i} C_i . state
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Ci[(4 * rg + i) * kStride + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = St[n * kStride + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], sv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * rg + i;
        const float e = r < ni ? expf(cum[i0 + r]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }

      // intra-chunk terms, one kv tile at a time
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT, nj = min(kT, L - j0);
        __syncthreads();  // the previous kv tile's readers are done
        load_tile(Bj, bb + (int64_t)(c0 + j0) * N, N, nj, N);
        load_tile(Xj, xb + (int64_t)(c0 + j0) * xrow, xrow, nj, P);
        __syncthreads();
        float g[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Ci[(4 * rg + i) * kStride + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bj[(cg + 16 * j) * kStride + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int gi = i0 + 4 * rg + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int gj = j0 + cg + 16 * j;
            float w = 0.f;
            if (4 * rg + i < ni && cg + 16 * j < nj && gj <= gi)
              w = g[i][j] * expf(cum[gi] - cum[gj]) * dts[gj];
            G[(4 * rg + i) * kStride + cg + 16 * j] = w;
          }
        }
        __syncthreads();
        for (int j = 0; j < nj; ++j) {
          float gv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) gv[i] = G[(4 * rg + i) * kStride + j];
#pragma unroll
          for (int q = 0; q < 4; ++q) xv[q] = Xj[j * kStride + cg + 16 * q];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(gv[i], xv[q], acc[i][q]);
        }
        if (last) {
          // state update: B_j^T diag(e^{cum_last - cum_j} dt_j) x_j
          for (int j = 0; j < nj; ++j) {
            const float w = expf(cum_last - cum[j0 + j]) * dts[j0 + j];
            float bv[4], xv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) bv[i] = Bj[j * kStride + 4 * rg + i] * w;
#pragma unroll
            for (int q = 0; q < 4; ++q) xv[q] = Xj[j * kStride + cg + 16 * q];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int q = 0; q < 4; ++q) st[i][q] = fmaf(bv[i], xv[q], st[i][q]);
          }
        }
      }

      // the skip D x_i (the last kv tile was this row tile) and the store
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * rg + i;
        if (r >= ni) continue;
        T* out = yb + (int64_t)(c0 + i0 + r) * xrow;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = cg + 16 * q;
          if (p < P) store(out + p, acc[i][q] + dh * Xj[r * kStride + p]);
        }
      }
    }

    // every reader of the old state is past the last row tile's syncs
    const float gamma = expf(cum_last);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = 4 * rg + i;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = cg + 16 * q;
        if (n < N && p < P)
          St[n * kStride + p] = gamma * St[n * kStride + p] + st[i][q];
      }
    }
  }

  __syncthreads();
  float* so = state_out + (int64_t)blockIdx.x * N * P;
  for (int idx = tid; idx < N * P; idx += kThreads) {
    const int n = idx / P, p = idx - n * P;
    so[idx] = St[n * kStride + p];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, const void* dskip, void* y, void* state, int B,
           int S, int H, int P, int N, int L, cudaStream_t stream) {
  auto kern = ssd_scan_kernel<T>;
  const size_t smem = smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<B * H, kThreads, smem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)a, (const T*)bm,
      (const T*)cm, (const float*)dskip, (T*)y, (float*)state, S, H, P, N,
      L);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  x (B, S, H, P), bm and cm
// (B, S, N) of one type (is_bf16: bf16, else fp32); dt (B, S, H), a and
// dskip (H,) and the state (B, H, N, P) fp32; y (B, S, H, P) in x's type;
// all contiguous.  1 <= N, P <= 64, S % L == 0, L <= 8192.  Returns the
// CUDA error of the launch (0 on success); the caller raises if not 0.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* bm, const void* cm,
                               const void* dskip, void* y, void* state,
                               int B, int S, int H, int P, int N, int L,
                               int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P < 1 || P > kT || N < 1 || N > kT ||
      L < 1 || L > 8192 || S % L != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(x, dt, a, bm, cm, dskip, y, state, B, S, H,
                                 P, N, L, s);
  return launch<float>(x, dt, a, bm, cm, dskip, y, state, B, S, H, P, N, L,
                       s);
}
