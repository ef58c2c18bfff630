// Chunked Mamba2 / SSD selective scan for Hopper (sm_90a).
//
// Replaces: the Pallas kernel `_ssd_kernel` in src/repro/kernels/ssm_scan.py
//   (launched by `ssd_scan`); the JAX model runs the same contract as
//   `_ssd_chunked` in src/repro/models/ssm.py, which also returns the final
//   state.
//
// Computes, for each (b, h), with B and C in G groups (B, S, G, N), head h
// reading group h / (H / G) (G = 1: B and C shared by the heads), over
// chunks of L rows, cum = the in-chunk cumsum of dt * a:
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
// the 989 TFLOP/s bf16 rate.
//
// bf16: the SSD decomposition, chunk-parallel, on warp-level tensor cores
// (mma.sync.m16n8k16.f32.bf16.bf16.f32, mma_bf16.cuh), as four launches of
// one call on the caller's stream, with scratch the wrapper allocates:
//   (a) ssd_cb_kernel     C.B^T once per (b, chunk, group), over the N
//                         contraction, for the 64 x 64 tiles on or below
//                         the diagonal, into fp32 scratch (B * nc * G,
//                         tiles, 64, 64).  A group's heads share it, so it
//                         is formed once a group, not once per head.
//   (b) ssd_state_kernel  per (b, chunk, h) the in-chunk cumsum of dt * a,
//                         once, in one fixed order (warp 0 scans 32-row
//                         pieces with shuffles and carries the sum),
//                         written chunk-major for (c) and (d) beside dt and
//                         e^{cum_r - cum_j} dt_j (r the last row of j's
//                         64-row tile); and the chunk's own state s_c =
//                         B^T diag(e^{cum_last - cum_j} dt_j) x into fp32
//                         (B, nc, H, N, P), the weight applied to B's rows
//                         in the A fragments.
//   (c) ssd_pass_kernel   per (b, h, state entry), sequential over the nc
//                         chunks: S <- e^{cum_last} S + s_c, in fp32, which
//                         is never rounded; each chunk's incoming state is
//                         written in bf16 (an MMA operand of (d)) and the
//                         last S is the final state.
//   (d) ssd_out_kernel    per (b, chunk, 64-row tile, pair of heads), 8
//                         warps, 4 per head: y = (CB o decay o dt) x +
//                         e^{cum} C S_in + D x.  Each C.B^T tile is read
//                         once for both heads (of one group: with G > 1
//                         a group holds an even number of heads); the
//                         accumulators and C's A
//                         fragments stay in registers.  The decay-weighted
//                         G is formed in registers as the A fragment of
//                         G x: on the diagonal tile e^{cum_i - cum_j} only
//                         where j <= i (it overflows above the diagonal),
//                         the k-steps above a warp's rows skipped; below
//                         it through the kv tile's last row r, e^{cum_i -
//                         cum_r} times (b)'s e^{cum_r - cum_j} dt_j, both
//                         <= 1, so no exp per element.  e^{cum_i} scales
//                         the fp32 product C S_in, not C.
// (b) and (d) walk their kv tiles with the next one in flight by 16-byte
// cp.async (double buffers).  The work is chains of dependent shared loads,
// exps and MMAs, so (d) runs 8 warps a block, 2 blocks (16 warps) an SM.
// Tiles are 64 rows; N and P (<= 64) are padded with zeros to multiples of
// 16 in shared memory, ragged row and kv tiles are zero-filled and masked,
// and bf16 tiles keep rows of 72 values (9 16-byte units, odd) so
// `ldmatrix` is free of bank conflicts.
// Numerics: C and B are bf16, so C.B^T is exact products summed in fp32;
// the error against the fp32 plain version comes from rounding G, the
// weighted B rows of (b) and the incoming state to bf16 (2^-9 relative
// each), then y's own bf16 rounding.
//
// fp32: the first, SIMT version of this kernel, kept unchanged so fp32 runs
// agree with the fp32 plain version to rounding (the fp32 parity checks
// need fp32 products).  One block of 256 threads per (b, h) walks the
// chunks in order and holds the (N, P) fp32 state in shared memory, as the
// Pallas sequential grid holds it in VMEM.  Per chunk: dt and cum (warp 0
// scans the chunk in 32-row pieces with shuffles, one fixed order); then
// the chunk's rows in tiles of 64: the inter-chunk term from the C tile and
// the state, and for each kv tile j <= i the decay-weighted G = (C_i B_j^T)
// e^{cum_i - cum_j} dt_j, formed only where j <= i, then y += G x_j.  The
// 256 x 256 fp32 G of a whole chunk (256 KB) would not fit the 227 KB a
// block may use, so G lives one 64 x 64 tile at a time.  The last row
// tile's walk over the kv tiles also accumulates the state update, in
// registers, and the state is replaced after the chunk's last use of the
// old one.  Each thread owns a 4 x 4 patch of every 64 x 64 product (rows
// 4 * (t / 16) + i, columns t % 16 + 16 j); tiles are padded to an odd row
// stride so column-strided reads hit distinct banks.  It computes with
// fp32 FMAs out of shared memory and recomputes C.B^T for every head.
// N, P <= 64; any chunk length L (a ragged row tile is masked).
#include "cut_common.cuh"
#include "mma_bf16.cuh"

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
                    int ngroups, int L) {
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
  const int64_t bcrow = (int64_t)ngroups * N;  // B and C row stride
  const int64_t grp = h / (H / ngroups);
  const T* bb = bm + (int64_t)b * S * bcrow + grp * N;
  const T* cb = cm + (int64_t)b * S * bcrow + grp * N;
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
      load_tile(Ci, cb + (int64_t)(c0 + i0) * bcrow, bcrow, ni, N);
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
        load_tile(Bj, bb + (int64_t)(c0 + j0) * bcrow, bcrow, nj, N);
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
           int S, int H, int P, int N, int G, int L, cudaStream_t stream) {
  auto kern = ssd_scan_kernel<T>;
  const size_t smem = smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<B * H, kThreads, smem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)a, (const T*)bm,
      (const T*)cm, (const float*)dskip, (T*)y, (float*)state, S, H, P, N,
      G, L);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16: the four stages on tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;          // 4 warps, 16 tile rows each
constexpr int kTS = tc::padded(kT);       // bf16 tile row stride (72)
constexpr int kCS = kT + 8;               // fp32 C.B^T tile row stride
constexpr int kTileB = kT * kTS;          // elements of a bf16 tile
constexpr int kTileC = kT * kCS;          // elements of an fp32 tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPassThreads = 128;

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ constexpr int round16(int n) { return ceil_div(n, 16) * 16; }
__host__ __device__ constexpr int64_t n_pairs(int tiles) {
  return (int64_t)tiles * (tiles + 1) / 2;
}

size_t align256(size_t n) { return (n + 255) / 256 * 256; }

// the scratch of one call, carved in this order; Lp = L rounded up to 64
struct Workspace {
  float* cb;      // (B * nc * G, pairs, 64, 64) C.B^T tiles on/below the
                  // diagonal
  float* sc;      // (B, nc, H, N, P) each chunk's own state
  bf16* sin;      // (B, nc, H, N, P) the state entering each chunk
  float* cum;     // (B, nc, H, Lp) the in-chunk cumsum of dt * a
  float* dtc;     // (B, nc, H, Lp) dt, chunk-major
  float* fac;     // (B, nc, H, Lp) e^{cum_r - cum_j} dt_j, r = j's tile end
};

size_t workspace_bytes(int B, int S, int H, int P, int N, int G, int L,
                       Workspace* ws, char* base) {
  const int64_t bnc = (int64_t)B * (S / L);
  const int T = ceil_div(L, kT);
  const size_t cb =
      align256(sizeof(float) * bnc * G * n_pairs(T) * kT * kT);
  const size_t sc = align256(sizeof(float) * bnc * H * N * P);
  const size_t sin = align256(sizeof(bf16) * bnc * H * N * P);
  const size_t cum = align256(sizeof(float) * bnc * H * T * kT);
  if (ws != nullptr) {
    ws->cb = reinterpret_cast<float*>(base);
    ws->sc = reinterpret_cast<float*>(base + cb);
    ws->sin = reinterpret_cast<bf16*>(base + cb + sc);
    ws->cum = reinterpret_cast<float*>(base + cb + sc + sin);
    ws->dtc = reinterpret_cast<float*>(base + cb + sc + sin + cum);
    ws->fac = reinterpret_cast<float*>(base + cb + sc + sin + 2 * cum);
  }
  return cb + sc + sin + 3 * cum;
}

// rows x cols (cols <= cols_pad <= 64, cols_pad a multiple of 16) of a
// row-major bf16 matrix (row stride ld) into a 64-row shared tile of
// stride kTS, zero-filled around: 16-byte `cp.async` (the caller commits
// the group) where the rows allow it, element copies elsewhere
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src,
                                          int64_t ld, int rows, int cols,
                                          int cols_pad) {
  const bool vec = ((uintptr_t)src % 16 == 0) && ld % 8 == 0 && cols % 8 == 0;
  for (int idx = threadIdx.x; idx < kT * kT / 8; idx += blockDim.x) {
    const int r = idx >> 3, c = (idx & 7) * 8;
    if (c >= cols_pad) continue;
    if (vec) {
      const bool ok = r < rows && c < cols;
      tc::cp_async16(dst + r * kTS + c, ok ? src + r * ld + c : src, ok);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        dst[r * kTS + c + i] = (r < rows && c + i < cols)
                                   ? src[r * ld + c + i]
                                   : __float2bfloat16(0.f);
    }
  }
}

// 64 floats (16-byte aligned) into shared memory by cp.async
__device__ __forceinline__ void copy_row64(float* dst, const float* src) {
  if (threadIdx.x < kT / 4)
    tc::cp_async16(dst + 4 * threadIdx.x, src + 4 * threadIdx.x, true);
}

// a 64 x 64 fp32 tile (row stride 64) into shared memory (stride kCS)
__device__ __forceinline__ void copy_cb_tile(float* dst, const float* src) {
  for (int idx = threadIdx.x; idx < kT * kT / 4; idx += blockDim.x) {
    const int r = idx / (kT / 4), q = idx - r * (kT / 4);
    tc::cp_async16(dst + r * kCS + 4 * q, src + 4 * idx, true);
  }
}

// rows x cols of a shared tile (stride kTS) to a row-major bf16 matrix,
// by threads tid of nthreads
__device__ __forceinline__ void store_tile(bf16* dst, const bf16* src,
                                           int64_t ld, int rows, int cols,
                                           int tid, int nthreads) {
  const bool vec = ((uintptr_t)dst % 16 == 0) && ld % 8 == 0;
  const int units = ceil_div(cols, 8);
  for (int idx = tid; idx < rows * units; idx += nthreads) {
    const int r = idx / units, c = (idx - r * units) * 8;
    if (vec && c + 8 <= cols) {
      *reinterpret_cast<uint4*>(dst + r * ld + c) =
          *reinterpret_cast<const uint4*>(src + r * kTS + c);
    } else {
      for (int i = 0; i < 8 && c + i < cols; ++i)
        dst[r * ld + c + i] = src[r * kTS + c + i];
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

__device__ __forceinline__ int tri_row(int pr) {
  int it = (int)((sqrtf(8.f * pr + 1.f) - 1.f) * 0.5f);
  while ((it + 1) * (it + 2) / 2 <= pr) ++it;
  while (it * (it + 1) / 2 > pr) --it;
  return it;
}

// (a) C.B^T: one block per (tile pair it >= jt, (b * nc + c) * G + group)
__global__ void __launch_bounds__(kMmaThreads)
    ssd_cb_kernel(const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                  float* __restrict__ cb, int S, int N, int G, int L) {
  __shared__ __align__(16) bf16 Cs[kTileB];
  __shared__ __align__(16) bf16 Bs[kTileB];
  const int T = ceil_div(L, kT), nc = S / L;
  const int64_t pairs = n_pairs(T);
  const int pr = blockIdx.x % pairs, bcg = blockIdx.x / pairs;
  const int bc = bcg / G, grp = bcg - bc * G;
  const int b = bc / nc, c = bc - b * nc;
  const int it = tri_row(pr), jt = pr - it * (it + 1) / 2;
  const int i0 = it * kT, j0 = jt * kT;
  const int Np = round16(N);
  const int64_t ld = (int64_t)G * N;
  const int64_t row0 = (int64_t)b * S + (int64_t)c * L;
  copy_tile(Cs, cm + (row0 + i0) * ld + grp * N, ld, min(kT, L - i0), N, Np);
  copy_tile(Bs, bm + (row0 + j0) * ld + grp * N, ld, min(kT, L - j0), N, Np);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[8][4];
  zero(acc);
#pragma unroll
  for (int ks = 0; ks < kT / 16; ++ks) {
    if (ks * 16 >= Np) break;
    uint32_t af[4];
    tc::load_a(af, Cs, kTS, warp * 16, ks * 16, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      tc::load_b_nk(bf, Bs, kTS, np * 16, ks * 16, lane);
      tc::mma(acc[2 * np], af, bf[0], bf[1]);
      tc::mma(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
  float* out = cb + ((int64_t)bcg * pairs + pr) * kT * kT;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(out + (warp * 16 + g + 8 * r) * kT + j * 8 +
                                 2 * t) =
          make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
}

size_t state_smem_bytes(int L) {
  return sizeof(bf16) * 4 * kTileB +
         sizeof(float) * 2 * (size_t)ceil_div(L, kT) * kT;
}

// (b) each chunk's own state: one block per (h, b * nc + c).  The
// in-chunk cumsum is computed here, once, in one fixed order (warp 0 scans
// 32-row pieces with shuffles and carries the sum), and written with dt in
// the chunk-major layout that (c) and (d) read.  The B and x tiles are
// double-buffered by cp.async; the weight e^{cum_last - cum_j} dt_j is
// applied to B's rows in the A fragments, rounded to bf16 there.
__global__ void __launch_bounds__(kMmaThreads)
    ssd_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const bf16* __restrict__ bm,
                     float* __restrict__ sc, float* __restrict__ cum_out,
                     float* __restrict__ dt_out, float* __restrict__ fac_out,
                     int S, int H, int P, int N, int G, int L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int T = ceil_div(L, kT), Lp = T * kT;
  bf16* Bs = reinterpret_cast<bf16*>(smem_raw);   // two buffers
  bf16* Xs = Bs + 2 * kTileB;                      // two buffers
  float* cum = reinterpret_cast<float*>(Xs + 2 * kTileB);
  float* w = cum + Lp;                             // dt, then the weight
  const int nc = S / L;
  const int h = blockIdx.x % H, bc = blockIdx.x / H;
  const int b = bc / nc, c = bc - b * nc;
  const int64_t row0 = (int64_t)b * S + (int64_t)c * L;
  const int64_t xld = (int64_t)H * P;
  const int64_t bld = (int64_t)G * N, grp = h / (H / G);
  const int Np = round16(N), Pp = round16(P);
  auto fetch = [&](int jt) {
    const int j0 = jt * kT, nj = min(kT, L - j0), buf = jt & 1;
    copy_tile(Bs + buf * kTileB, bm + (row0 + j0) * bld + grp * N, bld, nj,
              N, Np);
    copy_tile(Xs + buf * kTileB, x + (row0 + j0) * xld + (int64_t)h * P,
              xld, nj, P, Pp);
  };
  fetch(0);
  tc::cp_async_commit();

  const float ah = a[h];
  for (int j = threadIdx.x; j < L; j += blockDim.x)
    w[j] = dt[(row0 + j) * H + h];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {
    float carry = 0.f;
    for (int base = 0; base < L; base += 32) {
      const int j = base + lane;
      float v = j < L ? w[j] * ah : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      v += carry;
      if (j < L) cum[j] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  const float last = cum[L - 1];
  const int64_t crow = ((int64_t)bc * H + h) * Lp;
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    cum_out[crow + j] = cum[j];
    dt_out[crow + j] = w[j];
    fac_out[crow + j] = expf(cum[min(j | (kT - 1), L - 1)] - cum[j]) * w[j];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < Lp; j += blockDim.x)
    w[j] = j < L ? expf(last - cum[j]) * w[j] : 0.f;

  const int g = lane >> 2, t = lane & 3;
  float acc[8][4];
  zero(acc);
  for (int jt = 0; jt < T; ++jt) {
    if (jt + 1 < T) {
      fetch(jt + 1);  // its buffer's readers passed the last sync
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Bt = Bs + (jt & 1) * kTileB;
    const bf16* Xt = Xs + (jt & 1) * kTileB;
    const int j0 = jt * kT, nj = min(kT, L - j0);
    if (warp * 16 < Np) {
#pragma unroll
      for (int ks = 0; ks < kT / 16; ++ks) {
        if (ks * 16 >= nj) break;
        // A = B^T diag(w): a[q] holds k = j0 + 16 ks + 2t (+8 for q >= 2)
        uint32_t af[4];
        tc::load_a_trans(af, Bt, kTS, warp * 16, ks * 16, lane);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + ks * 16 + 8 * (q >> 1) + 2 * t;
          const __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&af[q]);
          af[q] = tc::pack(__low2float(v) * w[j], __high2float(v) * w[j + 1]);
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (np * 16 >= Pp) break;
          uint32_t bf[4];
          tc::load_b_kn(bf, Xt, kTS, np * 16, ks * 16, lane);
          tc::mma(acc[2 * np], af, bf[0], bf[1]);
          tc::mma(acc[2 * np + 1], af, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
  float* out = sc + ((int64_t)bc * H + h) * N * P;
  const bool pairs = P % 2 == 0;  // then float2 stores, a quad's 32 bytes
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = warp * 16 + g + 8 * r, p = j * 8 + 2 * t;
      if (n >= N || p >= P) continue;
      if (pairs)
        *reinterpret_cast<float2*>(out + n * P + p) =
            make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
      else {
        out[n * P + p] = acc[j][2 * r];
        if (p + 1 < P) out[n * P + p + 1] = acc[j][2 * r + 1];
      }
    }
}

// (c) state passing: one thread per (b, h, state entry), over the chunks
__global__ void __launch_bounds__(kPassThreads)
    ssd_pass_kernel(const float* __restrict__ sc,
                    const float* __restrict__ cum, bf16* __restrict__ sin,
                    float* __restrict__ state_out, int nc, int H, int NP,
                    int L) {
  const int eb = ceil_div(NP, kPassThreads);
  const int e = (blockIdx.x % eb) * kPassThreads + threadIdx.x;
  const int bh = blockIdx.x / eb;
  if (e >= NP) return;
  const int b = bh / H, h = bh - b * H;
  const int64_t Lp = (int64_t)ceil_div(L, kT) * kT;
  float st = 0.f;
  for (int c = 0; c < nc; ++c) {
    const int64_t bch = ((int64_t)b * nc + c) * H + h;
    const int64_t off = bch * NP + e;
    sin[off] = __float2bfloat16(st);
    st = st * expf(cum[bch * Lp + L - 1]) + sc[off];
  }
  state_out[(int64_t)bh * NP + e] = st;
}

constexpr int kOutWarps = 8;                 // (d): two heads, 4 warps each
constexpr int kOutThreads = 32 * kOutWarps;
constexpr int kStages = 2;                   // (d)'s ring of kv-tile items
// one ring slot: the two heads' x tiles, then [head][cum_j, dt_j, fac_j][64]
constexpr size_t kSlotBytes =
    sizeof(bf16) * 2 * kTileB + sizeof(float) * 6 * kT;

size_t out_smem_bytes() {
  return sizeof(float) * 2 * kTileC      // C.B^T tiles, double-buffered
         + sizeof(bf16) * 2 * kTileB     // the two heads' incoming states
         + sizeof(float) * 2 * kT        // the two heads' row cum
         + kStages * kSlotBytes;
}

// acc += G x for one k-step kk of 16 kv rows, x from a shared tile
__device__ __forceinline__ void mma_x(float (&acc)[8][4],
                                      const uint32_t (&af)[4],
                                      const bf16* xs, int kk, int Pp,
                                      int lane) {
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    if (np * 16 >= Pp) break;
    uint32_t bf[4];
    tc::load_b_kn(bf, xs, kTS, np * 16, kk * 16, lane);
    tc::mma(acc[2 * np], af, bf[0], bf[1]);
    tc::mma(acc[2 * np + 1], af, bf[2], bf[3]);
  }
}

// (d) the output: one block of 8 warps per (64-row tile it, pair of heads,
// b * nc + c), the row tiles of one (pair, chunk) adjacent so their x
// tiles are shared in L2.  Warps 0-3 take the pair's first head, warps 4-7
// the second, 16 rows each.  The block walks the kv tiles jt <= it: each
// C.B^T tile is read once for both heads (double-buffered), the next kv
// tile's x, cum, dt and factor of both heads in flight by cp.async while
// this one computes; the incoming states and C, whose A fragments stay in
// registers, arrive with the first.
__global__ void __launch_bounds__(kOutThreads, 2)
    ssd_out_kernel(const bf16* __restrict__ x, const bf16* __restrict__ cm,
                   const float* __restrict__ dskip,
                   const float* __restrict__ cb, const bf16* __restrict__ sin,
                   const float* __restrict__ cumg,
                   const float* __restrict__ dtg,
                   const float* __restrict__ facg, bf16* __restrict__ y,
                   int S, int H, int P, int N, int G, int L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int T = ceil_div(L, kT), nc = S / L, Lp = T * kT;
  const int ng = ceil_div(H, 2);
  const int it = T - 1 - (int)(blockIdx.x % T);
  const int hg = (blockIdx.x / T) % ng, bc = blockIdx.x / (T * ng);
  const int b = bc / nc, c = bc - b * nc;
  float* CBs = reinterpret_cast<float*>(smem_raw);   // two tiles
  bf16* Ss = reinterpret_cast<bf16*>(CBs + 2 * kTileC);  // two heads
  float* ci = reinterpret_cast<float*>(Ss + 2 * kTileB);  // two heads
  unsigned char* ring = reinterpret_cast<unsigned char*>(ci + 2 * kT);
  auto slot_x = [&](int jt) {
    return reinterpret_cast<bf16*>(ring + (jt % kStages) * kSlotBytes);
  };
  auto slot_f = [&](int jt) {
    return reinterpret_cast<float*>(ring + (jt % kStages) * kSlotBytes +
                                    sizeof(bf16) * 2 * kTileB);
  };

  const int i0 = it * kT, ni = min(kT, L - i0);
  const int64_t row0 = (int64_t)b * S + (int64_t)c * L;
  const int Np = round16(N), Pp = round16(P);
  const int64_t xld = (int64_t)H * P;
  // the pair's group (with G > 1 a group holds an even number of heads)
  const int64_t cld = (int64_t)G * N, grp = 2 * hg / (H / G);
  const float* cbrow =
      cb + (((int64_t)bc * G + grp) * n_pairs(T) + n_pairs(it)) * kT * kT;
  const int nh = min(2, H - 2 * hg);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hs = warp >> 2, g = lane >> 2, t = lane & 3;
  const bool active = hs < nh;
  const int h = 2 * hg + hs;
  const int ri[2] = {(warp & 3) * 16 + g, (warp & 3) * 16 + g + 8};
  auto crow = [&](int head) { return ((int64_t)bc * H + head) * Lp; };

  auto fetch = [&](int jt) {  // kv tile jt of both heads; one group
    const int j0 = jt * kT, nj = min(kT, L - j0);
    for (int u = 0; u < nh; ++u) {
      const int64_t cr = crow(2 * hg + u);
      float* fs = slot_f(jt) + u * 3 * kT;
      copy_tile(slot_x(jt) + u * kTileB,
                x + (row0 + j0) * xld + (int64_t)(2 * hg + u) * P, xld, nj,
                P, Pp);
      copy_row64(fs, cumg + cr + j0);
      copy_row64(fs + kT, dtg + cr + j0);
      copy_row64(fs + 2 * kT, facg + cr + j0);
    }
    copy_cb_tile(CBs + (jt & 1) * kTileC, cbrow + jt * kT * kT);
    tc::cp_async_commit();
  };

  // C (staged in the second C.B^T buffer), the incoming states and row
  // cum; then kv tile 0 behind them
  bf16* Cst = reinterpret_cast<bf16*>(CBs + kTileC);
  copy_tile(Cst, cm + (row0 + i0) * cld + grp * N, cld, ni, N, Np);
  for (int u = 0; u < nh; ++u) {
    copy_tile(Ss + u * kTileB, sin + ((int64_t)bc * H + 2 * hg + u) * N * P,
              P, N, P, Pp);
    copy_row64(ci + u * kT, cumg + crow(2 * hg + u) + i0);
  }
  tc::cp_async_commit();
  fetch(0);
  tc::cp_async_wait<1>();
  __syncthreads();
  uint32_t cf[kT / 16][4];
#pragma unroll
  for (int ks = 0; ks < kT / 16; ++ks)
    if (ks * 16 < Np)
      tc::load_a(cf[ks], Cst, kTS, (warp & 3) * 16, ks * 16, lane);
  float cr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    cr[r] = active && ri[r] < ni ? ci[hs * kT + ri[r]] : 0.f;

  // inter-chunk term: e^{cum_i} (C_i . S_in)
  float acc[8][4];
  zero(acc);
  if (active) {
    const bf16* St = Ss + hs * kTileB;
#pragma unroll
    for (int ks = 0; ks < kT / 16; ++ks) {
      if (ks * 16 >= Np) break;
      mma_x(acc, cf[ks], St, ks, Pp, lane);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float e = ri[r] < ni ? expf(cr[r]) : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][2 * r] *= e;
        acc[j][2 * r + 1] *= e;
      }
    }
  }
  __syncthreads();  // C's buffer is tile 1's

  for (int jt = 0; jt <= it; ++jt) {
    if (jt < it) {
      fetch(jt + 1);  // its buffers' readers passed the last sync
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    bf16* xs = slot_x(jt) + hs * kTileB;
    const float* cum_j = slot_f(jt) + hs * 3 * kT;
    const float* dt_j = cum_j + kT;
    const float* fac_j = cum_j + 2 * kT;
    const float* CBt = CBs + (jt & 1) * kTileC;
    const bool diag = jt == it;

    // intra-chunk: G = C.B^T o e^{cum_i - cum_j} dt_j (j <= i), then
    // G x_j, G's A fragment formed in registers (a[q]: row ri[q & 1],
    // columns 2t + 8 (q >> 1) of the k-step).  Below the diagonal (jt <
    // it: the kv tile is full, every j < every i) the decay factors
    // through the kv tile's last row r, e^{cum_i - cum_r} e^{cum_r -
    // cum_j} dt_j, both factors <= 1, the second from (b), so no exp per
    // element; the diagonal tile takes e^{cum_i - cum_j} where j <= i,
    // its k-steps above this warp's rows skipped.
    if (active && !diag) {
      float er[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        er[r] = ri[r] < ni ? exp2f((cr[r] - cum_j[kT - 1]) * kLog2e) : 0.f;
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        uint32_t af[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int jc = kk * 16 + 8 * (q >> 1) + 2 * t;
          const float2 cv =
              *reinterpret_cast<const float2*>(CBt + ri[q & 1] * kCS + jc);
          const float2 fv = *reinterpret_cast<const float2*>(fac_j + jc);
          af[q] = tc::pack(cv.x * er[q & 1] * fv.x, cv.y * er[q & 1] * fv.y);
        }
        mma_x(acc, af, xs, kk, Pp, lane);
      }
    } else if (active) {
      const int kmax = min((warp & 3) + 1, ceil_div(ni, 16));
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        if (kk >= kmax) break;
        uint32_t af[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = ri[q & 1];
          const int jc = kk * 16 + 8 * (q >> 1) + 2 * t;
          const float2 cv =
              *reinterpret_cast<const float2*>(CBt + r * kCS + jc);
          const float gv[2] = {cv.x, cv.y};
          float w[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int j = jc + u;
            w[u] = j <= r && r < ni
                       ? gv[u] * exp2f((cr[q & 1] - cum_j[j]) * kLog2e) *
                             dt_j[j]
                       : 0.f;
          }
          af[q] = tc::pack(w[0], w[1]);
        }
        mma_x(acc, af, xs, kk, Pp, lane);
      }
    }

    if (diag) {  // + D x_i (this kv tile is the row tile); y through xs
      if (active) {
        const float dh = dskip[h];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = j * 8 + 2 * t + (e & 1);
            if (p < Pp)
              acc[j][e] += dh * __bfloat162float(xs[ri[e >> 1] * kTS + p]);
          }
      }
      __syncthreads();  // every reader of x_i is done
      if (active) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (j * 8 < Pp)
              *reinterpret_cast<__nv_bfloat162*>(xs + ri[r] * kTS + j * 8 +
                                                 2 * t) =
                  __floats2bfloat162_rn(acc[j][2 * r], acc[j][2 * r + 1]);
      }
      __syncthreads();
      if (active)
        store_tile(y + (row0 + i0) * xld + (int64_t)h * P, xs, xld, ni, P,
                   threadIdx.x & 127, 128);
    }
    __syncthreads();  // this slot is refilled two tiles on
  }
}

int launch_mma(const void* x, const void* dt, const void* a, const void* bm,
               const void* cm, const void* dskip, void* y, void* state,
               int B, int S, int H, int P, int N, int G, int L,
               void* workspace, cudaStream_t stream) {
  Workspace ws;
  workspace_bytes(B, S, H, P, N, G, L, &ws, static_cast<char*>(workspace));
  const int T = ceil_div(L, kT), nc = S / L;
  const int64_t bnc = (int64_t)B * nc;
  const bf16 *xb = (const bf16*)x, *bb = (const bf16*)bm, *cb = (const bf16*)cm;

  ssd_cb_kernel<<<(unsigned)(n_pairs(T) * bnc * G), kMmaThreads, 0,
                  stream>>>(bb, cb, ws.cb, S, N, G, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  size_t smem = state_smem_bytes(L);
  err = cudaFuncSetAttribute(ssd_state_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_state_kernel<<<(unsigned)(bnc * H), kMmaThreads, smem, stream>>>(
      xb, (const float*)dt, (const float*)a, bb, ws.sc, ws.cum, ws.dtc,
      ws.fac, S, H, P, N, G, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int NP = N * P;
  ssd_pass_kernel<<<(unsigned)((int64_t)B * H * ceil_div(NP, kPassThreads)),
                    kPassThreads, 0, stream>>>(ws.sc, ws.cum, ws.sin,
                                               (float*)state, nc, H, NP, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  smem = out_smem_bytes();
  err = cudaFuncSetAttribute(ssd_out_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_out_kernel<<<(unsigned)(bnc * T * ceil_div(H, 2)), kOutThreads, smem,
                   stream>>>(
      xb, cb, (const float*)dskip, ws.cb, ws.sin, ws.cum, ws.dtc, ws.fac,
      (bf16*)y, S, H, P, N, G, L);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of scratch the bf16 path of `ssd_scan_launch` needs (0 for fp32);
// the caller allocates them and passes the pointer as `workspace`.
extern "C" long long ssd_scan_workspace_bytes(int B, int S, int H, int P,
                                              int N, int G, int L,
                                              int is_bf16) {
  if (!is_bf16 || L < 1 || S % L != 0 || G < 1) return 0;
  return (long long)workspace_bytes(B, S, H, P, N, G, L, nullptr, nullptr);
}

// Plain C entry point, loaded with ctypes.  x (B, S, H, P), bm and cm
// (B, S, G, N) of one type (is_bf16: bf16, else fp32), G dividing H (and
// with bf16 and G > 1, H / G even); dt (B, S, H), a and
// dskip (H,) and the state (B, H, N, P) fp32; y (B, S, H, P) in x's type;
// all contiguous; workspace of ssd_scan_workspace_bytes bytes, 256-byte
// aligned (unused for fp32).  1 <= N, P <= 64, S % L == 0, L <= 8192.
// The bf16 path is four launches on `stream`.  Returns the CUDA error of
// the launches (0 on success); the caller raises if not 0.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* bm, const void* cm,
                               const void* dskip, void* y, void* state,
                               int B, int S, int H, int P, int N, int G,
                               int L, int is_bf16, void* workspace,
                               void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P < 1 || P > kT || N < 1 || N > kT ||
      L < 1 || L > 8192 || S % L != 0 || G < 1 || H % G != 0 ||
      (is_bf16 && G > 1 && (H / G) % 2 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    if (workspace == nullptr || (uintptr_t)workspace % 256 != 0)
      return (int)cudaErrorInvalidValue;
    return launch_mma(x, dt, a, bm, cm, dskip, y, state, B, S, H, P, N, G, L,
                      workspace, s);
  }
  return launch<float>(x, dt, a, bm, cm, dskip, y, state, B, S, H, P, N, G,
                       L, s);
}
