// Causal flash-attention backward for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference computes this backward in jnp
// (`_flash_bwd` in src/repro/models/attention.py, the custom VJP of
// `blockwise_attention`), and the port's plain version of it is
// `kernels/ref.flash_bwd_ref`.  It was added because the card needs it:
// the plain version runs a Python loop of fp32 einsums over 512 x 512
// tiles, which held most of an LLM train step.
//
// Computes FlashAttention-2's backward from the forward's saved (q, k, v,
// o, lse) and the output's gradient do, all in the forward's layout:
// q, o, do (B, Sq, H, Dh); k, v (B, Sk, KV, Dh), H % KV == 0, query head h
// reading kv head h / (H / KV); lse (B, Sq, H) fp32 in natural-log units
// of the scaled scores.  With the mask of the forward (j < Sk; with
// `causal` j <= i + q_offset; with `window` > 0 (i + q_offset) - j <
// window) and the forward's scale (1 / sqrt(Dh) but for Zamba2-7B):
//   P    = exp(scale q k^T - lse)           (0 where masked)
//   D_i  = sum_d do[i, d] o[i, d]
//   dS   = P * (do v^T - D)
//   dq   = scale dS k,   dk = scale dS^T q (summed over a kv head's
//   group of query heads),   dv = P^T do (likewise)
// S, P, D and dS are fp32; dq, dk and dv are rounded once, to the inputs'
// type, as the plain version rounds them.
//
// Bound: operations.  Per kept (query, key) pair and head the backward
// needs 2.5x the forward's 4 Dh flops (S, dP, dv, dk, dq at 2 Dh each):
// at (B=1, S=4096, H=24, Dh=128), causal, 2.6e11 flops, 0.26 ms at the
// card's 989 TFLOP/s bf16 rate.  This design recomputes S and dP in its
// second launch and feeds P and dS as two bf16 halves (below), 20 Dh flops
// a pair on the tensor cores, 2x the bound's count.
//
// Three launches, no atomics, every sum in a fixed order, so two runs on
// the same inputs give the same bits:
//   1. dq (flash_bwd_dq_*): one block per (b * H + h, 64-row q tile), late
//      (heavy) q tiles first.  It first computes D for its rows (written to
//      `delta` for launch 2), then walks the key tiles its rows keep
//      (double-buffered), recomputing S and dP, and sums dS k in registers.
//   2. dk, dv (flash_bwd_dkdv_*): one block per (b, kv head, split of the
//      group, 64-key tile), early (heavy, under causal) key tiles first.
//      The key tile's k and v stay in shared memory; the block walks the q
//      tiles at or below the diagonal (and inside the window) of each query
//      head of its split of the group, q and do double-buffered, and sums
//      dS^T q and P^T do in registers: GQA's sum over the group is made
//      there, with no copy of k or v.  A batch of one and two kv heads (the
//      4k train step) gives only 128 such blocks of very unequal work, so
//      the group is split (`splits`, a divisor of H / KV the wrapper
//      chooses from the shapes alone) and each split writes fp32 partials.
//   3. the partials of the splits are added in split order and rounded
//      (flash_bwd_sum_kernel).
// Names: no kernel name contains the forward's (`flash_fwd_kernel`,
// `flash_fwd_mma_kernel`), which trace readers count by substring.
//
// bf16: warp-level tensor cores (mma.sync m16n8k16, fp32 accumulators,
// mma_bf16.cuh), 4 warps a block.  In launch 1 a warp owns 16 q rows: S =
// q k^T and dP = do v^T from q and do resident in shared memory and k, v
// tiles by `ldmatrix`; dS (the accumulator layout of S is the A layout of
// the next product) goes to dS k in registers.  In launch 2 a warp owns 16
// keys and computes the transposes S^T = k q^T and dP^T = v do^T, so P^T
// and dS^T are A fragments of P^T do and dS^T q without a trip through
// shared memory.  Tiles by Dh: launch 1 takes 64 keys a tile (32 at Dh =
// 192, whose 96 accumulator floats a lane leave less room, 16 at Dh = 224,
// Zamba2-7B's, with 112), launch 2 64 q rows an iteration at Dh <= 80, 32
// up to 192 and 16 at 224; at Dh > 128 launch 2 runs twice, once for dv
// and once for dk, each with one accumulator of Dh / 2 floats a lane.  Rows in shared memory are padded to Dh + 8 elements (an
// odd number of 16-byte units), as in the forward, so `ldmatrix` is free of
// bank conflicts; tiles arrive by 16-byte `cp.async`, zero-filled past the
// ragged edge, which the mask then hides: nothing is padded in memory.
// Numerics: q, k, v and do enter their products as the bf16 values they
// are, so S and dP are exact products summed in fp32.  P and dS are fp32;
// each is fed to its products as P = P_hi + P_lo (both bf16, two MMAs on
// the same B fragments), which carries it to about 2^-16 of itself, as the
// plain version's fp32 carries it, rather than the 2^-9 of one bf16.
//
// fp32: SIMT kernels in the forward's first design (256 threads, each a 4 x
// 4 patch of a 64 x 64 score tile and 4 rows of an accumulator at columns
// t % 16 + 16 j), the same three launches, fp32 FMAs out of shared memory.
// They serve the fp32 runs on the card (smoke steps, the crash-resume
// children), whose parity checks need fp32 products; no benchmark cell
// runs them.  At Dh = 224 four 64-row tiles of 225 floats and the score
// tile would pass the 227 KB a block may hold, so there launch 1's q tile
// and launch 2's key tile are 32 rows (RI = 2 rows a thread, not 4).
// Dispatch is by dtype, never by failure.
//
// The scale is an argument: 1/sqrt(Dh) for every model but Zamba2-7B,
// whose shared attention runs at (Dh / 2)^-1/2.
#include "cut_common.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using cut::to_f32;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTile = 64;       // q rows of launch 1, keys of launch 2

__device__ __forceinline__ bool kept(int qp, int kp, int Sk, int causal,
                                     int window) {
  return kp < Sk && (!causal || kp <= qp) && (!window || qp - kp < window);
}

// whether some (row, key) of a q tile [r0, r0 + nr) x key tile [k0, k0 +
// nk) (nr, nk: the tiles' full sizes) is masked: only such tiles test the
// mask entry by entry
__device__ __forceinline__ bool crosses_edge(int r0, int nr, int k0, int nk,
                                             int Sq, int Sk, int causal,
                                             int window, int q_offset) {
  return k0 + nk > Sk || r0 + nr > Sq ||
         (causal && k0 + nk - 1 > r0 + q_offset) ||
         (window && r0 + nr - 1 + q_offset - k0 >= window);
}

// launch 2's q rows: those some key of [k0, k0 + nk) is kept for, as the
// tile range [*t_lo, *t_hi) of `rows`-row tiles
__device__ __forceinline__ void q_tiles(int k0, int nk, int Sq, int Sk,
                                        int causal, int window, int q_offset,
                                        int rows, int* t_lo, int* t_hi) {
  const int k_last = min(k0 + nk, Sk) - 1;
  const int lo = causal ? max(0, k0 - q_offset) : 0;
  const int hi = window ? min(Sq, k_last + window - q_offset) : Sq;
  *t_lo = lo / rows;
  *t_hi = hi > lo ? (hi + rows - 1) / rows : *t_lo;
}

// launch 1's key tiles: those some row of [q0, q0 + nrows) keeps
__device__ __forceinline__ void k_tiles(int q0, int nrows, int Sk, int causal,
                                        int window, int q_offset, int cols,
                                        int* t_lo, int* t_hi) {
  const int hi = causal ? min(Sk, q0 + nrows + q_offset) : Sk;
  const int lo = window ? max(0, q0 + q_offset - window + 1) : 0;
  *t_lo = lo / cols;
  *t_hi = hi > lo ? (hi + cols - 1) / cols : *t_lo;
}

// ---------------------------------------------------------------------------
// 3. the splits' partials, added in split order and rounded
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(bf16* p, float4 x) {
  uint2 u;
  u.x = tc::pack(x.x, x.y);
  u.y = tc::pack(x.z, x.w);
  *reinterpret_cast<uint2*>(p) = u;
}

// blockIdx.y 0: dk, 1: dv; part (splits, n) fp32, n % 4 == 0
template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_sum_kernel(const float* __restrict__ dk_part,
                         const float* __restrict__ dv_part, T* __restrict__ dk,
                         T* __restrict__ dv, int64_t n, int splits) {
  const float* part = blockIdx.y ? dv_part : dk_part;
  T* out = blockIdx.y ? dv : dk;
  for (int64_t i = 4 * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x);
       i < n; i += 4 * (int64_t)gridDim.x * blockDim.x) {
    float4 acc = *reinterpret_cast<const float4*>(part + i);
    for (int s = 1; s < splits; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(part + s * n + i);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    store4(out + i, acc);
  }
}

template <typename T>
int launch_sum(const float* dk_part, const float* dv_part, void* dk, void* dv,
               int64_t n, int splits, cudaStream_t stream) {
  int64_t blocks = (n / 4 + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  flash_bwd_sum_kernel<T><<<dim3((unsigned)blocks, 2), 256, 0, stream>>>(
      dk_part, dv_part, (T*)dk, (T*)dv, n, splits);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: SIMT
// ---------------------------------------------------------------------------

constexpr int kSimtThreads = 256;
constexpr int kSStride = kTile + 1;   // the score tile's row stride

__host__ __device__ constexpr int head_stride(int dh) { return dh + 1; }

size_t simt_smem_bytes(int dh, int rows) {
  // two tiles of `rows` (launch 1's q and do, launch 2's k and v) and two of
  // 64 rows, the score tile (rows x 64), two 64-float vectors
  return sizeof(float) * ((size_t)2 * (rows + kTile) * head_stride(dh) +
                          (size_t)rows * kSStride + 2 * kTile);
}

// rows [r0, r0 + nr) of a (B, S, heads, Dh) tensor's head `hd` into a
// ROWS-row tile of stride ds, zeros past nr
template <int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int b,
                                          int S, int heads, int hd, int r0,
                                          int nr, int Dh, int ds, int tid) {
  for (int idx = tid; idx < ROWS * Dh; idx += kSimtThreads) {
    const int r = idx / Dh, d = idx - r * Dh;
    dst[r * ds + d] =
        r < nr ? src[(((int64_t)b * S + r0 + r) * heads + hd) * Dh + d] : 0.f;
  }
}

template <int NJ, int RI>
__global__ void __launch_bounds__(kSimtThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ o,
                        const float* __restrict__ lse,
                        const float* __restrict__ dout,
                        float* __restrict__ dq, float* __restrict__ delta,
                        int Sq, int Sk, int H, int KV, int Dh, int causal,
                        int window, int q_offset, float scale) {
  constexpr int TR = 16 * RI;  // q rows of the tile
  extern __shared__ float smem[];
  const int ds = head_stride(Dh);
  float* Qs = smem;
  float* dOs = Qs + TR * ds;
  float* Ks = dOs + TR * ds;
  float* Vs = Ks + kTile * ds;
  float* Ss = Vs + kTile * ds;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int hk = h / (H / KV);
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int q0 = qt * TR;
  const int nrows = min(TR, Sq - q0);

  load_rows<TR>(Qs, q, b, Sq, H, h, q0, nrows, Dh, ds, tid);
  load_rows<TR>(dOs, dout, b, Sq, H, h, q0, nrows, Dh, ds, tid);
  __syncthreads();

  // D and lse of this thread's RI rows (a row's 16 threads are a half-warp)
  float dl[RI], lr[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = RI * rg + i;
    const int64_t row = ((int64_t)b * Sq + q0 + r) * H + h;
    float acc = 0.f;
    if (r < nrows)
      for (int d = cg; d < Dh; d += 16)
        acc = fmaf(dOs[r * ds + d], o[row * Dh + d], acc);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    dl[i] = acc;
    lr[i] = r < nrows ? lse[row] : 0.f;
    if (cg == 0 && r < nrows) delta[row] = acc;
  }

  float acc[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  int t_lo, t_hi;
  k_tiles(q0, nrows, Sk, causal, window, q_offset, kTile, &t_lo, &t_hi);
  for (int kt = t_lo; kt < t_hi; ++kt) {
    const int k0 = kt * kTile;
    const int nk = min(kTile, Sk - k0);
    __syncthreads();  // the previous tile's readers are done
    load_rows<kTile>(Ks, k, b, Sk, KV, hk, k0, nk, Dh, ds, tid);
    load_rows<kTile>(Vs, v, b, Sk, KV, hk, k0, nk, Dh, ds, tid);
    __syncthreads();

    float s[RI][4], dp[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < Dh; ++d) {
      float qv[RI], ov[RI], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qv[i] = Qs[(RI * rg + i) * ds + d];
        ov[i] = dOs[(RI * rg + i) * ds + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(cg + 16 * j) * ds + d];
        vv[j] = Vs[(cg + 16 * j) * ds + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qp = q0 + RI * rg + i + q_offset;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool keep = RI * rg + i < nrows &&
                          kept(qp, k0 + cg + 16 * j, Sk, causal, window);
        const float p = keep ? expf(s[i][j] * scale - lr[i]) : 0.f;
        Ss[(RI * rg + i) * kSStride + cg + 16 * j] = p * (dp[i][j] - dl[i]);
      }
    }
    __syncthreads();

    for (int c = 0; c < nk; ++c) {
      float dsv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) dsv[i] = Ss[(RI * rg + i) * kSStride + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = cg + 16 * j;
        if (d < Dh) {
          const float kx = Ks[c * ds + d];
#pragma unroll
          for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(dsv[i], kx, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = RI * rg + i;
    if (r >= nrows) continue;
    float* out = dq + (((int64_t)b * Sq + q0 + r) * H + h) * Dh;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = cg + 16 * j;
      if (d < Dh) out[d] = acc[i][j] * scale;
    }
  }
}

template <int NJ, int RI>
__global__ void __launch_bounds__(kSimtThreads)
    flash_bwd_dkdv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const float* __restrict__ dout,
                          float* __restrict__ dk_part,
                          float* __restrict__ dv_part, int B, int Sq, int Sk,
                          int H, int KV, int Dh, int causal, int window,
                          int q_offset, int splits, float scale) {
  constexpr int TR = 16 * RI;  // keys of the tile
  extern __shared__ float smem[];
  const int ds = head_stride(Dh);
  float* Ks = smem;
  float* Vs = Ks + TR * ds;
  float* Qs = Vs + TR * ds;
  float* dOs = Qs + kTile * ds;
  float* Ps = dOs + kTile * ds;
  float* Ls = Ps + TR * kSStride;
  float* Dl = Ls + kTile;

  const int split = blockIdx.x % splits, bk = blockIdx.x / splits;
  const int b = bk / KV, hk = bk - b * KV;
  const int gs = H / KV / splits, h0 = hk * (H / KV) + split * gs;
  const int kt = blockIdx.y;
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int k0 = kt * TR;
  const int nk = min(TR, Sk - k0);

  load_rows<TR>(Ks, k, b, Sk, KV, hk, k0, nk, Dh, ds, tid);
  load_rows<TR>(Vs, v, b, Sk, KV, hk, k0, nk, Dh, ds, tid);

  float dka[RI][NJ], dva[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dka[i][j] = dva[i][j] = 0.f;

  int t_lo, t_hi;
  q_tiles(k0, TR, Sq, Sk, causal, window, q_offset, kTile, &t_lo, &t_hi);
  const int n_qt = t_hi - t_lo;
  for (int it = 0; it < gs * n_qt; ++it) {
    const int hh = it / n_qt, h = h0 + hh;
    const int r0 = (t_lo + it - hh * n_qt) * kTile;
    const int nr = min(kTile, Sq - r0);
    __syncthreads();  // the previous tile's readers are done
    load_rows<kTile>(Qs, q, b, Sq, H, h, r0, nr, Dh, ds, tid);
    load_rows<kTile>(dOs, dout, b, Sq, H, h, r0, nr, Dh, ds, tid);
    if (tid < 2 * kTile) {
      const int r = tid & (kTile - 1);
      const int64_t row = ((int64_t)b * Sq + r0 + r) * H + h;
      const float x = r < nr ? (tid < kTile ? lse[row] : delta[row]) : 0.f;
      (tid < kTile ? Ls : Dl)[r] = x;
    }
    __syncthreads();

    float s[RI][4], dp[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < Dh; ++d) {
      float kv[RI], vv[RI], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        kv[i] = Ks[(RI * rg + i) * ds + d];
        vv[i] = Vs[(RI * rg + i) * ds + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = Qs[(cg + 16 * j) * ds + d];
        ov[j] = dOs[(cg + 16 * j) * ds + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }
    // s[i][j] = S^T: key 4 rg + i, q row cg + 16 j
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = cg + 16 * j;
        const bool keep = r < nr && kept(r0 + r + q_offset, k0 + RI * rg + i,
                                         Sk, causal, window);
        s[i][j] = keep ? expf(s[i][j] * scale - Ls[r]) : 0.f;
        Ps[(RI * rg + i) * kSStride + r] = s[i][j];
      }
    __syncthreads();
    for (int c = 0; c < nr; ++c) {
      float pv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = Ps[(RI * rg + i) * kSStride + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = cg + 16 * j;
        if (d < Dh) {
          const float ox = dOs[c * ds + d];
#pragma unroll
          for (int i = 0; i < RI; ++i) dva[i][j] = fmaf(pv[i], ox, dva[i][j]);
        }
      }
    }
    __syncthreads();  // P's readers are done: the tile takes dS
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = cg + 16 * j;
        Ps[(RI * rg + i) * kSStride + r] = s[i][j] * (dp[i][j] - Dl[r]);
      }
    __syncthreads();
    for (int c = 0; c < nr; ++c) {
      float dsv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) dsv[i] = Ps[(RI * rg + i) * kSStride + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = cg + 16 * j;
        if (d < Dh) {
          const float qx = Qs[c * ds + d];
#pragma unroll
          for (int i = 0; i < RI; ++i) dka[i][j] = fmaf(dsv[i], qx, dka[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = RI * rg + i;
    if (r >= nk) continue;
    const int64_t off =
        ((((int64_t)split * B + b) * Sk + k0 + r) * KV + hk) * Dh;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = cg + 16 * j;
      if (d < Dh) {
        dk_part[off + d] = dka[i][j] * scale;
        dv_part[off + d] = dva[i][j];
      }
    }
  }
}

template <int NJ, int RI>
int launch_simt(const void* q, const void* k, const void* v, const void* o,
                const float* lse, const void* dout, void* dq, void* dk,
                void* dv, float* delta, float* dk_part, float* dv_part, int B,
                int Sq, int Sk, int H, int KV, int Dh, int causal, int window,
                int q_offset, int splits, float scale, cudaStream_t stream) {
  constexpr int TR = 16 * RI;  // launch 1's q rows, launch 2's keys a block
  const size_t smem = simt_smem_bytes(Dh, TR);
  auto dq_kern = flash_bwd_dq_kernel<NJ, RI>;
  auto kv_kern = flash_bwd_dkdv_kernel<NJ, RI>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dq_kern<<<dim3(B * H, (Sq + TR - 1) / TR), kSimtThreads, smem,
            stream>>>((const float*)q, (const float*)k, (const float*)v,
                      (const float*)o, lse, (const float*)dout, (float*)dq,
                      delta, Sq, Sk, H, KV, Dh, causal, window, q_offset,
                      scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  kv_kern<<<dim3(B * KV * splits, (Sk + TR - 1) / TR), kSimtThreads,
            smem, stream>>>((const float*)q, (const float*)k,
                            (const float*)v, lse, delta, (const float*)dout,
                            dk_part, dv_part, B, Sq, Sk, H, KV, Dh, causal,
                            window, q_offset, splits, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return launch_sum<float>(dk_part, dv_part, dk, dv,
                           (int64_t)B * Sk * KV * Dh, splits, stream);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;   // 4 warps of 16 rows (launch 1) or keys

// launch 1's key tile and launch 2's q rows an iteration, by head dim:
// at Dh = 224 (112 accumulator floats a lane) 16, so that S and dP (or S^T
// and dP^T) take 16 floats a lane and the lane stays within its registers
__host__ __device__ constexpr int dq_keys(int dh) {
  return dh > 192 ? 16 : (dh > 128 ? 32 : 64);
}
__host__ __device__ constexpr int dkdv_rows(int dh) {
  return dh <= 80 ? 64 : (dh <= 192 ? 32 : 16);
}

__host__ __device__ constexpr size_t dq_smem_bytes(int dh) {
  // q and do tiles, two buffers each of the k and v tiles; D and lse
  return sizeof(bf16) * (size_t)(2 * kTile + 4 * dq_keys(dh)) * tc::padded(dh)
         + sizeof(float) * 2 * kTile;
}
__host__ __device__ constexpr size_t dkdv_smem_bytes(int dh) {
  // the k and v tiles, two buffers each of the q and do tiles and of their
  // rows' (lse, D)
  return sizeof(bf16) * (size_t)(2 * kTile + 4 * dkdv_rows(dh)) *
             tc::padded(dh) +
         sizeof(float) * 4 * dkdv_rows(dh);
}

// o += (X_hi + X_lo) B over one k-step of 16 columns of x (the accumulators
// of n-tiles 2 kk and 2 kk + 1 are its A fragment), for every n-tile pair
// of a (16 x DH) product whose B tile `tile` is stored k-major
template <int DH, int N>
__device__ __forceinline__ void add_split_product(float (&acc)[DH / 8][4],
                                                  const float (&x)[N][4],
                                                  int kk, const bf16* tile,
                                                  int lane) {
  constexpr int DS = tc::padded(DH);
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {  // e: n-tile 2kk + e / 2, rows e % 2
    const float x0 = x[2 * kk + (e >> 1)][2 * (e & 1)];
    const float x1 = x[2 * kk + (e >> 1)][2 * (e & 1) + 1];
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
    hi[e] = *reinterpret_cast<const uint32_t*>(&h2);
    lo[e] = tc::pack(x0 - __low2float(h2), x1 - __high2float(h2));
  }
#pragma unroll
  for (int np = 0; np < DH / 16; ++np) {
    uint32_t bf[4];
    tc::load_b_kn(bf, tile, DS, np * 16, kk * 16, lane);
    tc::mma(acc[2 * np], hi, bf[0], bf[1]);
    tc::mma(acc[2 * np + 1], hi, bf[2], bf[3]);
    tc::mma(acc[2 * np], lo, bf[0], bf[1]);
    tc::mma(acc[2 * np + 1], lo, bf[2], bf[3]);
  }
}

// acc (16 x 8 NT, fp32) = A B^T over DH: A rows r0.. of `a` (row-major),
// B the rows n0.. of `bt` (row-major: B's n-major storage)
template <int DH, int NT>
__device__ __forceinline__ void product_nt(float (&acc)[NT][4], const bf16* a,
                                           int r0, const bf16* bt, int lane) {
  constexpr int DS = tc::padded(DH);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    uint32_t af[4];
    tc::load_a(af, a, DS, r0, ks * 16, lane);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      tc::load_b_nk(bf, bt, DS, np * 16, ks * 16, lane);
      tc::mma(acc[2 * np], af, bf[0], bf[1]);
      tc::mma(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// rows [r0, r0 + rows) of a (B, S, heads, DH) bf16 tensor's head `hd`
// into a tile of stride padded(DH), by 16-byte cp.async, zeros past S
template <int DH>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, int b,
                                          int S, int heads, int hd, int r0,
                                          int rows, int tid) {
  constexpr int DS = tc::padded(DH), CH = DH / 8;
  const int64_t row = (int64_t)heads * DH;
  const bf16* base = src + (int64_t)b * S * row + (int64_t)hd * DH;
  for (int idx = tid; idx < rows * CH; idx += kMmaThreads) {
    const int r = idx / CH, c = idx - r * CH;
    const bool ok = r0 + r < S;
    tc::cp_async16(dst + r * DS + c * 8,
                   base + (ok ? r0 + r : 0) * row + c * 8, ok);
  }
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads, 2)
    flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ o,
                            const float* __restrict__ lse,
                            const bf16* __restrict__ dout,
                            bf16* __restrict__ dq, float* __restrict__ delta,
                            int Sq, int Sk, int H, int KV, int causal,
                            int window, int q_offset, float scale) {
  constexpr int DS = tc::padded(DH);
  constexpr int BK = dq_keys(DH);
  constexpr int SN = BK / 8;          // n-tiles of S and dP
  constexpr int NT = DH / 8;          // n-tiles of dq
  constexpr int CH = DH / 8;          // 16-byte units of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kTile * DS;
  bf16* Ks = dOs + kTile * DS;        // two buffers
  bf16* Vs = Ks + 2 * BK * DS;        // two buffers
  float* Ls = reinterpret_cast<float*>(Vs + 2 * BK * DS);
  float* Dl = Ls + kTile;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int hk = h / (H / KV);
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kTile;
  const int nrows = min(kTile, Sq - q0);
  const float scale_log2 = scale * kLog2e;

  copy_rows<DH>(Qs, q, b, Sq, H, h, q0, kTile, tid);
  copy_rows<DH>(dOs, dout, b, Sq, H, h, q0, kTile, tid);
  tc::cp_async_commit();
  int t_lo, t_hi;
  k_tiles(q0, nrows, Sk, causal, window, q_offset, BK, &t_lo, &t_hi);
  auto load_kv = [&](int kt, int buf) {
    copy_rows<DH>(Ks + buf * BK * DS, k, b, Sk, KV, hk, kt * BK, BK, tid);
    copy_rows<DH>(Vs + buf * BK * DS, v, b, Sk, KV, hk, kt * BK, BK, tid);
  };
  if (t_lo < t_hi) load_kv(t_lo, 0);
  tc::cp_async_commit();
  tc::cp_async_wait<1>();  // q and do are in
  __syncthreads();

  // D = rowsum(do o) and lse (log2 units) of the tile's rows: two threads a
  // row, each over half of it, do from shared memory and o from memory
  {
    const int r = tid >> 1, half = tid & 1;
    const int64_t row = ((int64_t)b * Sq + q0 + r) * H + h;
    float acc = 0.f;
    if (r < nrows) {
      const bf16* orow = o + row * DH;
      for (int c = half * (CH / 2); c < (half + 1) * (CH / 2); ++c) {
        const uint4 ou = *reinterpret_cast<const uint4*>(orow + c * 8);
        const uint4 du = *reinterpret_cast<const uint4*>(dOs + r * DS + c * 8);
        const bf16* op = reinterpret_cast<const bf16*>(&ou);
        const bf16* dp = reinterpret_cast<const bf16*>(&du);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc = fmaf(to_f32(dp[e]), to_f32(op[e]), acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      Dl[r] = acc;
      Ls[r] = r < nrows ? lse[row] * kLog2e : 0.f;
      if (r < nrows) delta[row] = acc;
    }
  }
  __syncthreads();
  const int w0 = warp * 16;
  const float lse2[2] = {Ls[w0 + g], Ls[w0 + g + 8]};
  const float dl[2] = {Dl[w0 + g], Dl[w0 + g + 8]};
  // this lane's two rows: the query's position minus the key's origin
  const int qp0 = q0 + w0 + g + q_offset;

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = t_lo; kt < t_hi; ++kt) {
    const int buf = (kt - t_lo) & 1;
    if (kt + 1 < t_hi) {
      load_kv(kt + 1, buf ^ 1);  // its buffer's readers passed the last sync
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kb = Ks + buf * BK * DS;
    const bf16* Vb = Vs + buf * BK * DS;

    float s[SN][4], dp[SN][4];
    product_nt<DH, SN>(s, Qs, w0, Kb, lane);
    product_nt<DH, SN>(dp, dOs, w0, Vb, lane);
    const int k0 = kt * BK;
    const bool edge = crosses_edge(q0, kTile, k0, BK, Sq, Sk, causal, window,
                                   q_offset);
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = exp2f(fmaf(s[j][e], scale_log2, -lse2[r]));
        if (edge && !(w0 + g + 8 * r < nrows &&
                      kept(qp0 + 8 * r, k0 + j * 8 + 2 * t + (e & 1), Sk,
                           causal, window)))
          p = 0.f;
        s[j][e] = p * (dp[j][e] - dl[r]);  // dS
      }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      add_split_product<DH, SN>(acc, s, kk, Kb, lane);
    __syncthreads();  // this buffer is refilled two tiles on
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row >= nrows) continue;
    bf16* out = dq + (((int64_t)b * Sq + q0 + row) * H + h) * DH;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * r] * scale,
                                acc[j][2 * r + 1] * scale);
  }
}

// DV, DK: which of the two this launch sums (both, or one at Dh = 192)
template <int DH, bool DV, bool DK>
__global__ void __launch_bounds__(kMmaThreads, 2)
    flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const bf16* __restrict__ dout,
                              float* __restrict__ dk_part,
                              float* __restrict__ dv_part, int B, int Sq,
                              int Sk, int H, int KV, int causal, int window,
                              int q_offset, int splits, float scale) {
  constexpr int DS = tc::padded(DH);
  constexpr int BR = dkdv_rows(DH);
  constexpr int RN = BR / 8;          // n-tiles of S^T and dP^T
  constexpr int NT = DH / 8;          // n-tiles of dk and dv
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kTile * DS;
  bf16* Qs = Vs + kTile * DS;         // two buffers
  bf16* dOs = Qs + 2 * BR * DS;       // two buffers
  float* LD = reinterpret_cast<float*>(dOs + 2 * BR * DS);  // two (lse, D)

  const int split = blockIdx.x % splits, bk = blockIdx.x / splits;
  const int b = bk / KV, hk = bk - b * KV;
  const int gs = H / KV / splits, h0 = hk * (H / KV) + split * gs;
  const int kt = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kt * kTile, w0 = warp * 16;
  const float scale_log2 = scale * kLog2e;

  copy_rows<DH>(Ks, k, b, Sk, KV, hk, k0, kTile, tid);
  copy_rows<DH>(Vs, v, b, Sk, KV, hk, k0, kTile, tid);
  int t_lo, t_hi;
  q_tiles(k0, kTile, Sq, Sk, causal, window, q_offset, BR, &t_lo, &t_hi);
  const int n_qt = t_hi - t_lo, n_it = gs * n_qt;
  // iteration `it`: head h0 + it / n_qt, q tile t_lo + it % n_qt
  auto head_of = [&](int it) { return it / n_qt; };
  auto row_of = [&](int it) { return (t_lo + it % n_qt) * BR; };
  auto load_q = [&](int it, int buf) {
    const int h = h0 + head_of(it), r0 = row_of(it);
    copy_rows<DH>(Qs + buf * BR * DS, q, b, Sq, H, h, r0, BR, tid);
    copy_rows<DH>(dOs + buf * BR * DS, dout, b, Sq, H, h, r0, BR, tid);
  };
  // the (lse in log2 units, D) of an iteration's rows: thread r < BR reads
  // row r's lse, thread BR + r its D
  auto fetch_ld = [&](int it) {
    const int r = tid % BR, row = row_of(it) + r;
    if (tid >= 2 * BR || row >= Sq) return 0.f;
    const int64_t idx = ((int64_t)b * Sq + row) * H + h0 + head_of(it);
    return tid < BR ? lse[idx] * kLog2e : delta[idx];
  };
  if (n_it > 0) {
    load_q(0, 0);
    if (tid < 2 * BR) LD[tid] = fetch_ld(0);
  }
  tc::cp_async_commit();

  float dva[DV ? NT : 1][4], dka[DK ? NT : 1][4];
#pragma unroll
  for (int j = 0; j < (DV ? NT : 1); ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < (DK ? NT : 1); ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = 0.f;
  // this lane's two keys
  const int kp0 = k0 + w0 + g;

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    float next_ld = 0.f;
    if (it + 1 < n_it) {
      load_q(it + 1, buf ^ 1);  // its buffer's readers passed the last sync
      tc::cp_async_commit();
      next_ld = fetch_ld(it + 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qb = Qs + buf * BR * DS;
    const bf16* dOb = dOs + buf * BR * DS;
    const float* Lb = LD + buf * 2 * BR;
    const float* Db = Lb + BR;
    const int r0 = row_of(it);

    // P^T: keys are rows (kp0, kp0 + 8), q rows columns
    float st[RN][4];
    product_nt<DH, RN>(st, Ks, w0, Qb, lane);
    const bool edge = crosses_edge(r0, BR, k0, kTile, Sq, Sk, causal, window,
                                   q_offset);
#pragma unroll
    for (int j = 0; j < RN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        float p = exp2f(fmaf(st[j][e], scale_log2, -Lb[c]));
        if (edge && !(r0 + c < Sq && kept(r0 + c + q_offset,
                                          kp0 + 8 * (e >> 1), Sk, causal,
                                          window)))
          p = 0.f;
        st[j][e] = p;
      }
    if constexpr (DV) {
#pragma unroll
      for (int kk = 0; kk < BR / 16; ++kk)
        add_split_product<DH, RN>(dva, st, kk, dOb, lane);
    }
    if constexpr (DK) {
      float dpt[RN][4];
      product_nt<DH, RN>(dpt, Vs, w0, dOb, lane);
#pragma unroll
      for (int j = 0; j < RN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[j][e] *= dpt[j][e] - Db[j * 8 + 2 * t + (e & 1)];  // dS^T
#pragma unroll
      for (int kk = 0; kk < BR / 16; ++kk)
        add_split_product<DH, RN>(dka, st, kk, Qb, lane);
    }
    if (it + 1 < n_it && tid < 2 * BR) LD[(buf ^ 1) * 2 * BR + tid] = next_ld;
    __syncthreads();  // this buffer is refilled two iterations on
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = kp0 + 8 * r;
    if (kp >= Sk) continue;
    const int64_t off = ((((int64_t)split * B + b) * Sk + kp) * KV + hk) * DH;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int d = j * 8 + 2 * t;
      if constexpr (DV)
        *reinterpret_cast<float2*>(dv_part + off + d) =
            make_float2(dva[j][2 * r], dva[j][2 * r + 1]);
      if constexpr (DK)
        *reinterpret_cast<float2*>(dk_part + off + d) =
            make_float2(dka[j][2 * r] * scale, dka[j][2 * r + 1] * scale);
    }
  }
}

template <int DH, bool DV, bool DK>
int launch_dkdv_mma(const void* q, const void* k, const void* v,
                    const float* lse, const float* delta, const void* dout,
                    float* dk_part, float* dv_part, int B, int Sq, int Sk,
                    int H, int KV, int causal, int window, int q_offset,
                    int splits, float scale, cudaStream_t stream) {
  auto kern = flash_bwd_dkdv_mma_kernel<DH, DV, DK>;
  const size_t smem = dkdv_smem_bytes(DH);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(B * KV * splits, (Sk + kTile - 1) / kTile), kMmaThreads, smem,
         stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v, lse,
                   delta, (const bf16*)dout, dk_part, dv_part, B, Sq, Sk, H,
                   KV, causal, window, q_offset, splits, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, const void* o,
               const float* lse, const void* dout, void* dq, void* dk,
               void* dv, float* delta, float* dk_part, float* dv_part, int B,
               int Sq, int Sk, int H, int KV, int causal, int window,
               int q_offset, int splits, float scale, cudaStream_t stream) {
  auto dq_kern = flash_bwd_dq_mma_kernel<DH>;
  const size_t smem = dq_smem_bytes(DH);
  cudaError_t err = cudaFuncSetAttribute(
      dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dq_kern<<<dim3(B * H, (Sq + kTile - 1) / kTile), kMmaThreads, smem,
            stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                      (const bf16*)o, lse, (const bf16*)dout, (bf16*)dq,
                      delta, Sq, Sk, H, KV, causal, window, q_offset, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  int rc;
  if constexpr (DH > 128) {
    rc = launch_dkdv_mma<DH, true, false>(q, k, v, lse, delta, dout, dk_part,
                                          dv_part, B, Sq, Sk, H, KV, causal,
                                          window, q_offset, splits, scale,
                                          stream);
    if (rc == 0)
      rc = launch_dkdv_mma<DH, false, true>(q, k, v, lse, delta, dout,
                                            dk_part, dv_part, B, Sq, Sk, H,
                                            KV, causal, window, q_offset,
                                            splits, scale, stream);
  } else {
    rc = launch_dkdv_mma<DH, true, true>(q, k, v, lse, delta, dout, dk_part,
                                         dv_part, B, Sq, Sk, H, KV, causal,
                                         window, q_offset, splits, scale,
                                         stream);
  }
  if (rc != 0) return rc;
  return launch_sum<bf16>(dk_part, dv_part, dk, dv,
                          (int64_t)B * Sk * KV * DH, splits, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q, o, dout, dq (B, Sq, H, Dh)
// and k, v, dk, dv (B, Sk, KV, Dh) contiguous, all fp32 or all bf16
// (is_bf16), bf16 pointers 16-byte aligned; lse (B, Sq, H) fp32; scratch
// the caller allocates: delta (B, Sq, H) fp32 and the partials dk_part,
// dv_part (splits, B, Sk, KV, Dh) fp32, 16-byte aligned.  splits divides
// H / KV.  Dh in {32, 64, 80, 128, 192, 224}.  Returns the CUDA error of the
// launches (0 on success); the caller raises if it is not 0.
extern "C" int flash_attn_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, void* dk_part, void* dv_part, int B, int Sq, int Sk, int H,
    int KV, int Dh, int causal, int window, int q_offset, int splits,
    float scale, int is_bf16, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      q_offset < 0 || window < 0 || splits <= 0 || (H / KV) % splits != 0)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)dk_part | (uintptr_t)dv_part) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  const float* L = (const float*)lse;
  float *D = (float*)delta, *pk = (float*)dk_part, *pv = (float*)dv_part;
  if (is_bf16) {
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o |
         (uintptr_t)dout | (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv) %
            16 != 0)
      return (int)cudaErrorMisalignedAddress;
    switch (Dh) {
      case 32: return launch_mma<32>(q, k, v, o, L, dout, dq, dk, dv, D, pk, pv, B, Sq, Sk, H, KV, causal, window, q_offset, splits, scale, s);
      case 64: return launch_mma<64>(q, k, v, o, L, dout, dq, dk, dv, D, pk, pv, B, Sq, Sk, H, KV, causal, window, q_offset, splits, scale, s);
      case 80: return launch_mma<80>(q, k, v, o, L, dout, dq, dk, dv, D, pk, pv, B, Sq, Sk, H, KV, causal, window, q_offset, splits, scale, s);
      case 128: return launch_mma<128>(q, k, v, o, L, dout, dq, dk, dv, D, pk, pv, B, Sq, Sk, H, KV, causal, window, q_offset, splits, scale, s);
      case 192: return launch_mma<192>(q, k, v, o, L, dout, dq, dk, dv, D, pk, pv, B, Sq, Sk, H, KV, causal, window, q_offset, splits, scale, s);
      case 224: return launch_mma<224>(q, k, v, o, L, dout, dq, dk, dv, D, pk, pv, B, Sq, Sk, H, KV, causal, window, q_offset, splits, scale, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (((uintptr_t)dk | (uintptr_t)dv) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  switch (Dh) {
    case 32: return launch_simt<2, 4>(q, k, v, o, L, dout, dq, dk, dv, D, pk, pv, B, Sq, Sk, H, KV, Dh, causal, window, q_offset, splits, scale, s);
    case 64: return launch_simt<4, 4>(q, k, v, o, L, dout, dq, dk, dv, D, pk, pv, B, Sq, Sk, H, KV, Dh, causal, window, q_offset, splits, scale, s);
    case 80: return launch_simt<5, 4>(q, k, v, o, L, dout, dq, dk, dv, D, pk, pv, B, Sq, Sk, H, KV, Dh, causal, window, q_offset, splits, scale, s);
    case 128: return launch_simt<8, 4>(q, k, v, o, L, dout, dq, dk, dv, D, pk, pv, B, Sq, Sk, H, KV, Dh, causal, window, q_offset, splits, scale, s);
    case 192: return launch_simt<12, 4>(q, k, v, o, L, dout, dq, dk, dv, D, pk, pv, B, Sq, Sk, H, KV, Dh, causal, window, q_offset, splits, scale, s);
    case 224: return launch_simt<14, 2>(q, k, v, o, L, dout, dq, dk, dv, D, pk, pv, B, Sq, Sk, H, KV, Dh, causal, window, q_offset, splits, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
