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
// the reference.  o is written in q's type.  With a non-null `lse` (fp32,
// (B, Sq, H)) each query row also writes its logsumexp, m + log(max(l,
// 1e-30)) in natural-log units of the scaled scores, as the reference's
// `_flash_fwd_core` saves it for its backward (src/repro/models/
// attention.py:86-87): the lane that holds a row's final (m, l) writes it
// after o, so o is the same bit for bit with or without it, and a null
// `lse` (the prefill) writes nothing more.  The TPU kernel casts k and v
// to fp32 (flash_attention.py:46-47), so its p.astype(v.dtype) is a cast
// to fp32: the reference keeps P in fp32.  Tiles wholly above the causal
// diagonal or below the window are not visited (their terms are exactly
// zero after the rescale); only the tiles that cross an edge (diagonal,
// window, ragged Sk) are masked; late (heavy) q tiles are launched first.
// q, k and v are read in their (B, S, heads, Dh) layout and the kv head is
// h / (H / KV): GQA copies nothing, and no row is padded in memory.
//
// Bound: operations.  A causal call does 4 * Dh * (kept (i, j) pairs) flops
// for B * H heads, about 8.6e10 at (B=4, S=2048, H=32, Dh=80), or 0.087 ms
// at the card's 989 TFLOP/s bf16 tensor-core rate; its q/k/v/o bytes take
// 0.050 ms at 3.35 TB/s.
//
// bf16: FlashAttention-2 on warp-level tensor cores
// (mma.sync.m16n8k16.f32.bf16.bf16.f32, mma_bf16.cuh).  One block of 4
// warps per (64-row q tile, b * H + h); each warp owns 16 q rows.  The q
// tile stays resident in shared memory; the kv tiles of 64 rows are
// double-buffered there by 16-byte `cp.async` (zero-filled past Sk), the
// next tile in flight while this one is used, and reach the MMA by
// `ldmatrix` (`.trans` for V).  Rows are padded to Dh + 8 elements, an odd
// number of 16-byte units (Dh = 80: 176 bytes), so `ldmatrix` is free of
// bank conflicts.  S = q k^T accumulates in fp32 fragments; the scale
// (times log2 e) is applied to S, not to bf16 q, which it would round; the
// online softmax runs on the fragments, a row's max and sum over the 4
// lanes of a quad (2 shuffles).  P goes to P.V as bf16 A fragments in
// registers (the accumulator layout of S is the A layout of P.V), so it
// never goes through shared memory, and O accumulates in fp32 registers
// (Dh = 80: 10 n-tiles, 40 floats a lane).  At Dh <= 80 a lane keeps
// under 168 registers, so 3 blocks (12 warps) share an SM.
// Why not `wgmma` and TMA: Zamba2's Dh = 80 makes 160-byte rows, which fit
// none of the 32/64/128-byte `wgmma` swizzle widths without splitting the
// head dimension, while `mma.sync` takes Dh = 80 as 5 k-steps of 16.
// Dh = 192 is DeepSeek-V2's MLA prefill (qk 128 + 64 rope, v padded from
// 128 by the caller, so a third of its P.V multiplies zeros): 24 n-tiles,
// 96 floats of o a lane, 128,000 bytes of shared memory, one block an SM.
// Dh = 224 is Zamba2-7B's shared attention: 28 n-tiles, 112 floats of o a
// lane, so its kv tiles are 32 rows (`fwd_keys`), which halves S (16
// floats a lane) to keep a lane within its 255 registers; 89,088 bytes of
// shared memory.  Every other Dh takes tiles of 64.  The scale is an
// argument: 1/sqrt(Dh) for every model but Zamba2-7B, (Dh/2)^-1/2 there.
// Numerics: in bf16 a score's products are exact in fp32, so rounding P is
// the error a tensor-core P.V adds to the plain fp32 version: with P in
// one bf16, |dp| <= 2^-9 p, so |do| <= 2^-9 sum_j p_j |v_j| / l <=
// 2^-9 max|v| before o's own bf16 rounding (the row sum l is of the
// unrounded fp32 p).  Both o's are rounded to bf16, so that error flips
// o's last bit where o lies near a rounding midpoint, and at |o| >= 4 one
// flip is 2^-5 = 0.031, above the 2e-2 bar (the serving prefill's
// attention outputs reach 4.47).  So P is split, P = P_hi + P_lo, both
// bf16, at two MMAs on the same V fragments: |dp| <= 2^-17 p, and such a
// flip needs o within 2^-17 max|v| of a midpoint.
//
// fp32: the first, SIMT version of this kernel, kept unchanged so fp32 runs
// agree with the fp32 plain version to rounding (the fp32 parity checks
// need fp32 products; TF32 would not meet them).  One block of 256 threads
// per (64-row q tile, b * H + h), heavy (late) q tiles launched first.  The
// block walks its kv tiles of 64 rows with the online softmax: running max
// m, sum l and an fp32 accumulator in registers.  Each thread owns a 4 x 4
// patch of the 64 x 64 score tile (rows 4 * (t / 16) + i, columns t % 16 +
// 16 j) and the same four rows of the accumulator at columns t % 16 + 16 j,
// j < NJ = ceil(Dh / 16); a row's 16 threads are one half-warp, so its max
// and sum are shuffles.  Shared memory holds the q tile (pre-scaled), the k
// and v tiles and the probabilities, rows padded to an odd stride so the
// column-strided reads hit 16 different banks.  It computes both products
// with fp32 FMAs out of shared memory (67 TFLOP/s at best).
#include "cut_common.cuh"
#include "mma_bf16.cuh"

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
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                     int Dh, int causal, int window, int q_offset,
                     float scale) {
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
    // m and l are the half-warp's reduced pair, in natural-log units
    if (lse != nullptr && cg == 0)
      lse[(int64_t)(b * Sq + q0 + r) * H + h] = m[i] + logf(den);
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Sk, int H, int KV, int Dh, int causal,
           int window, int q_offset, float scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, NJ>;
  const size_t smem = smem_bytes(Dh);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, Sq, Sk, H, KV, Dh,
      causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// kv rows a tile of the bf16 kernel
__host__ __device__ constexpr int fwd_keys(int dh) {
  return dh > 192 ? 32 : kBK;
}

__host__ __device__ constexpr size_t mma_smem_bytes(int dh) {
  // the q tile and two buffers each of the k and v tiles
  return sizeof(bf16) * (size_t)(kBQ + 4 * fwd_keys(dh)) * tc::padded(dh);
}

// Dh <= 80 fits 3 blocks (12 warps) an SM in registers (<= 168 a lane);
// Dh = 192 (MLA's prefill) takes 128,000 bytes of shared memory, so one
// block an SM, and 96 accumulator floats a lane
template <int DH>
__global__ void __launch_bounds__(kMmaThreads,
                                  DH <= 80 ? 3 : (DH <= 128 ? 2 : 1))
    flash_fwd_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         float* __restrict__ lse, int Sq, int Sk, int H,
                         int KV, int causal, int window, int q_offset,
                         float scale_log2) {
  constexpr int DS = tc::padded(DH);  // shared row stride, elements
  constexpr int KS = DH / 16;         // k-steps of q k^T
  constexpr int NT = DH / 8;          // n-tiles of o
  constexpr int CH = DH / 8;          // 16-byte units of a row
  constexpr int BK = fwd_keys(DH);    // kv rows a tile
  constexpr int SN = BK / 8;          // n-tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kBQ * DS;           // two buffers
  bf16* Vs = Ks + 2 * BK * DS;        // two buffers

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int hk = h / (H / KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kBQ;
  const int nrows = min(kBQ, Sq - q0);
  const int64_t q_row = (int64_t)H * DH, kv_row = (int64_t)KV * DH;
  const bf16* qg = q + ((int64_t)b * Sq + q0) * q_row + (int64_t)h * DH;
  const bf16* kg = k + (int64_t)b * Sk * kv_row + (int64_t)hk * DH;
  const bf16* vg = v + (int64_t)b * Sk * kv_row + (int64_t)hk * DH;

  for (int idx = tid; idx < kBQ * CH; idx += kMmaThreads) {
    const int r = idx / CH, c = idx - r * CH;
    const bool ok = r < nrows;
    tc::cp_async16(Qs + r * DS + c * 8, qg + (ok ? r : 0) * q_row + c * 8,
                   ok);
  }
  auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * BK;
    bf16* kd = Ks + buf * BK * DS;
    bf16* vd = Vs + buf * BK * DS;
    for (int idx = tid; idx < BK * CH; idx += kMmaThreads) {
      const int r = idx / CH, c = idx - r * CH;
      const bool ok = k0 + r < Sk;
      const int64_t off = (ok ? k0 + r : 0) * kv_row + c * 8;
      tc::cp_async16(kd + r * DS + c * 8, kg + off, ok);
      tc::cp_async16(vd + r * DS + c * 8, vg + off, ok);
    }
  };

  // the kv tiles some row of this q tile keeps
  int k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + nrows + q_offset);
  int k_lo = 0;
  if (window) k_lo = max(0, q0 + q_offset - window + 1);
  const int t_lo = k_lo / BK, t_hi = (k_hi + BK - 1) / BK;
  if (t_lo < t_hi) load_kv(t_lo, 0);
  tc::cp_async_commit();

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // this lane's two rows: position of the query minus the key's origin
  const int qp0 = q0 + warp * 16 + g + q_offset, qp1 = qp0 + 8;

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

    float s[SN][4];
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qf[4];  // the resident q tile's A fragment
      tc::load_a(qf, Qs, DS, warp * 16, ks * 16, lane);
#pragma unroll
      for (int np = 0; np < SN / 2; ++np) {
        uint32_t kb[4];
        tc::load_b_nk(kb, Kb, DS, np * 16, ks * 16, lane);
        tc::mma(s[2 * np], qf, kb[0], kb[1]);
        tc::mma(s[2 * np + 1], qf, kb[2], kb[3]);
      }
    }

    // scores in log2 units; the mask only on a tile that crosses an edge
    const int k0 = kt * BK;
    const bool edge = k0 + BK > Sk ||
                      (causal && k0 + BK - 1 > q0 + q_offset) ||
                      (window && q0 + kBQ - 1 + q_offset - k0 >= window);
#pragma unroll
    for (int j = 0; j < SN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int kp = k0 + j * 8 + 2 * t + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          const bool keep = kp < Sk && (!causal || kp <= qp) &&
                            (!window || qp - kp < window);
          if (!keep) x = kNegInf;
        }
        s[j][e] = x;
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < SN; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      const float corr = exp2f(m[r] - mn);
      m[r] = mn;
      l[r] *= corr;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][2 * r] *= corr;
        acc[j][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int j = 0; j < SN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += p;
        s[j][e] = p;
      }
    }

    // o += (P_hi + P_lo) v, P_hi = bf16(p), P_lo = bf16(p - P_hi): the
    // accumulators of n-tiles 2kk, 2kk+1 are the A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < SN / 2; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // q: n-tile 2kk + q / 2, rows q % 2
        const float p0 = s[2 * kk + (q >> 1)][2 * (q & 1)];
        const float p1 = s[2 * kk + (q >> 1)][2 * (q & 1) + 1];
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(p0, p1);
        hi[q] = *reinterpret_cast<const uint32_t*>(&h2);
        lo[q] = tc::pack(p0 - __low2float(h2), p1 - __high2float(h2));
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t vb[4];
        tc::load_b_kn(vb, Vb, DS, np * 16, kk * 16, lane);
        tc::mma(acc[2 * np], hi, vb[0], vb[1]);
        tc::mma(acc[2 * np + 1], hi, vb[2], vb[3]);
        tc::mma(acc[2 * np], lo, vb[0], vb[1]);
        tc::mma(acc[2 * np + 1], lo, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = warp * 16 + g + 8 * r;
    if (row >= nrows) continue;
    const float den = fmaxf(l[r], 1e-30f);
    bf16* out = o + ((int64_t)b * Sq + q0 + row) * q_row + (int64_t)h * DH;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(
          acc[j][2 * r] / den, acc[j][2 * r + 1] / den);
      *reinterpret_cast<__nv_bfloat162*>(out + j * 8 + 2 * t) = pair;
    }
    // every lane of the quad holds the reduced pair; m is in log2 units
    if (lse != nullptr && t == 0)
      lse[((int64_t)b * Sq + q0 + row) * H + h] =
          (m[r] + log2f(den)) * kLn2;
  }
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Sq, int Sk, int H, int KV, int causal,
               int window, int q_offset, float scale, cudaStream_t stream) {
  auto kern = flash_fwd_mma_kernel<DH>;
  const size_t smem = mma_smem_bytes(DH);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, Sq, Sk,
      H, KV, causal, window, q_offset, scale * kLog2e);
  return (int)cudaGetLastError();
}

// Only the head dims the port supports are instantiated (Dh 32, 64, 80,
// 128, 192 and 224; fp32: NJ 2, 4, 5, 8, 12 and 14); the wrapper raises on
// any other.
int dispatch_f32(int Dh, const void* q, const void* k, const void* v,
                 void* o, float* lse, int B, int Sq, int Sk, int H, int KV,
                 int causal, int window, int q_offset, float scale,
                 cudaStream_t s) {
  switch (Dh) {
    case 32: return launch<float, 2>(q, k, v, o, lse, B, Sq, Sk, H, KV, Dh, causal, window, q_offset, scale, s);
    case 64: return launch<float, 4>(q, k, v, o, lse, B, Sq, Sk, H, KV, Dh, causal, window, q_offset, scale, s);
    case 80: return launch<float, 5>(q, k, v, o, lse, B, Sq, Sk, H, KV, Dh, causal, window, q_offset, scale, s);
    case 128: return launch<float, 8>(q, k, v, o, lse, B, Sq, Sk, H, KV, Dh, causal, window, q_offset, scale, s);
    case 192: return launch<float, 12>(q, k, v, o, lse, B, Sq, Sk, H, KV, Dh, causal, window, q_offset, scale, s);
    case 224: return launch<float, 14>(q, k, v, o, lse, B, Sq, Sk, H, KV, Dh, causal, window, q_offset, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

int dispatch_bf16(int Dh, const void* q, const void* k, const void* v,
                  void* o, float* lse, int B, int Sq, int Sk, int H, int KV,
                  int causal, int window, int q_offset, float scale,
                  cudaStream_t s) {
  switch (Dh) {
    case 32: return launch_mma<32>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, window, q_offset, scale, s);
    case 64: return launch_mma<64>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, window, q_offset, scale, s);
    case 80: return launch_mma<80>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, window, q_offset, scale, s);
    case 128: return launch_mma<128>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, window, q_offset, scale, s);
    case 192: return launch_mma<192>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, window, q_offset, scale, s);
    case 224: return launch_mma<224>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, window, q_offset, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q, k, v, o contiguous in the
// (B, S, heads, Dh) layout; is_bf16 selects their type (fp32 otherwise);
// bf16 pointers 16-byte aligned.  lse: null, or fp32 (B, Sq, H), each
// row's logsumexp.  Dh in {32, 64, 80, 128, 192, 224}.  Returns
// the CUDA error of the launch (0 on success); the caller raises if it is
// not 0.
extern "C" int flash_attn_fwd_launch(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int B, int Sq,
                                     int Sk, int H, int KV, int Dh,
                                     int causal, int window, int q_offset,
                                     float scale, int is_bf16, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      q_offset < 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
    return dispatch_bf16(Dh, q, k, v, o, (float*)lse, B, Sq, Sk, H, KV,
                         causal, window, q_offset, scale, s);
  }
  return dispatch_f32(Dh, q, k, v, o, (float*)lse, B, Sq, Sk, H, KV, causal,
                      window, q_offset, scale, s);
}
