// Causal flash-attention forward for Hopper (sm_90a).
//
// Replaces: the Pallas kernel `_attn_kernel` in
//   src/repro/kernels/flash_attention.py (launched by `flash_attention`);
//   the JAX model runs the same contract as `blockwise_attention` in
//   src/repro/models/attention.py.
//
// Computes, for q (B, Sq, H, Dh) and k, v (B, Sk, KV, Dh), H % KV == 0:
//   o[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, h / (H / KV)]) v[...]
// over the keys j that the mask keeps: j < Sk, and with `causal`
// j <= i + q_offset, and with `window` > 0 (i + q_offset) - j < window.
// Masked scores are -1e30 and the sum is divided by max(l, 1e-30), as in
// the reference.  o is written in q's type; everything inside is fp32.
//
// Bound: operations.  A causal call does 4 * Dh * (kept (i, j) pairs) flops
// for B * H heads, about 8.6e10 at (B=4, S=2048, H=32, Dh=80), or 0.087 ms
// at the card's 989 TFLOP/s bf16 tensor-core rate; its q/k/v/o bytes take
// 0.050 ms at 3.35 TB/s.  This first kernel computes both products with
// fp32 FMAs out of shared memory (67 TFLOP/s at best), so it sits far
// above that bound; `mma.sync`/`wgmma` tiles are the later redesign.  That
// redesign will round P to bf16 before P.V, as the TPU kernel does
// (p.astype(v.dtype)); this kernel keeps P in fp32, like the plain version,
// so fp32 runs agree to rounding.
//
// Design: one block of 256 threads per (64-row q tile, b * H + h), heavy
// (late) q tiles launched first.  The block walks its kv tiles of 64 rows
// with the online softmax: running max m, sum l and an fp32 accumulator in
// registers.  Each thread owns a 4 x 4 patch of the 64 x 64 score tile
// (rows 4 * (t / 16) + i, columns t % 16 + 16 j) and the same four rows of
// the accumulator at columns t % 16 + 16 j, j < NJ = ceil(Dh / 16); a row's
// 16 threads are one half-warp, so its max and sum are shuffles.  Shared
// memory holds the q tile (pre-scaled), the k and v tiles and the
// probabilities, rows padded to an odd stride so the column-strided reads
// hit 16 different banks.  Tiles wholly above the causal diagonal or below
// the window are not visited (their terms are exactly zero after the
// rescale); a ragged last tile is masked, so no row is padded in memory.
// q, k and v are read in their (B, S, heads, Dh) layout and the kv head is
// h / (H / KV): GQA copies nothing.
#include "cut_common.cuh"

namespace {

using cut::store;
using cut::to_f32;

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kPStride = kBK + 1;
constexpr float kNegInf = -1e30f;

__host__ __device__ constexpr int head_stride(int dh) { return dh + 1; }

size_t smem_bytes(int dh) {
  return sizeof(float) *
         ((size_t)(kBQ + 2 * kBK) * head_stride(dh) + (size_t)kBQ * kPStride);
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int Sq,
                     int Sk, int H, int KV, int Dh, int causal, int window,
                     int q_offset, float scale) {
  extern __shared__ float smem[];
  const int ds = head_stride(Dh);
  float* Qs = smem;
  float* Ks = Qs + kBQ * ds;
  float* Vs = Ks + kBK * ds;
  float* Ps = Vs + kBK * ds;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int hk = h / (H / KV);
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int q0 = qt * kBQ;
  const int nrows = min(kBQ, Sq - q0);

  for (int idx = tid; idx < kBQ * Dh; idx += kThreads) {
    const int r = idx / Dh, d = idx - r * Dh;
    float x = 0.f;
    if (r < nrows)
      x = to_f32(q[((int64_t)(b * Sq + q0 + r) * H + h) * Dh + d]) * scale;
    Qs[r * ds + d] = x;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // the kv tiles some row of this q tile keeps
  int k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + nrows + q_offset);
  int k_lo = 0;
  if (window) k_lo = max(0, q0 + q_offset - window + 1);
  const int t_lo = k_lo / kBK, t_hi = (k_hi + kBK - 1) / kBK;

  for (int kt = t_lo; kt < t_hi; ++kt) {
    const int k0 = kt * kBK;
    const int nk = min(kBK, Sk - k0);
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBK * Dh; idx += kThreads) {
      const int r = idx / Dh, d = idx - r * Dh;
      float kx = 0.f, vx = 0.f;
      if (r < nk) {
        const int64_t off = ((int64_t)(b * Sk + k0 + r) * KV + hk) * Dh + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      Ks[r * ds + d] = kx;
      Vs[r * ds + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < Dh; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * rg + i) * ds + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(cg + 16 * j) * ds + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * rg + i + q_offset;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + cg + 16 * j;
        const bool keep = kp < Sk && (!causal || kp <= qp) &&
                          (!window || qp - kp < window);
        if (!keep) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - mn);
      l[i] = l[i] * corr + rs;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(4 * rg + i) * kPStride + cg + 16 * j] = s[i][j];
    }
    __syncthreads();

    for (int c = 0; c < nk; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(4 * rg + i) * kPStride + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = cg + 16 * j;
        if (d < Dh) {
          const float vx = Vs[c * ds + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vx, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * rg + i;
    if (r >= nrows) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* out = o + ((int64_t)(b * Sq + q0 + r) * H + h) * Dh;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = cg + 16 * j;
      if (d < Dh) store(out + d, acc[i][j] / den);
    }
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KV, int Dh, int causal, int window,
           int q_offset, float scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, NJ>;
  const size_t smem = smem_bytes(Dh);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Sk, H, KV, Dh,
      causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

// Only the head dims the port supports are instantiated (Dh 32, 64, 80
// and 128: NJ 2, 4, 5 and 8); the wrapper raises on any other.
template <typename T>
int dispatch(int Dh, const void* q, const void* k, const void* v, void* o,
             int B, int Sq, int Sk, int H, int KV, int causal, int window,
             int q_offset, float scale, cudaStream_t s) {
  switch (Dh) {
    case 32: return launch<T, 2>(q, k, v, o, B, Sq, Sk, H, KV, Dh, causal, window, q_offset, scale, s);
    case 64: return launch<T, 4>(q, k, v, o, B, Sq, Sk, H, KV, Dh, causal, window, q_offset, scale, s);
    case 80: return launch<T, 5>(q, k, v, o, B, Sq, Sk, H, KV, Dh, causal, window, q_offset, scale, s);
    case 128: return launch<T, 8>(q, k, v, o, B, Sq, Sk, H, KV, Dh, causal, window, q_offset, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q, k, v, o contiguous in the
// (B, S, heads, Dh) layout; is_bf16 selects their type (fp32 otherwise).
// Dh in {32, 64, 80, 128}.  Returns the CUDA error of the launch (0 on
// success); the caller raises if it is not 0.
extern "C" int flash_attn_fwd_launch(const void* q, const void* k,
                                     const void* v, void* o, int B, int Sq,
                                     int Sk, int H, int KV, int Dh,
                                     int causal, int window, int q_offset,
                                     float scale, int is_bf16, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      q_offset < 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(Dh, q, k, v, o, B, Sq, Sk, H, KV, causal,
                                   window, q_offset, scale, s);
  return dispatch<float>(Dh, q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                         q_offset, scale, s);
}
