// Multi-tensor AdamW for Hopper (sm_90a): the global-norm clip, both
// moments, the fp32 master and the weights, updated in place in one pass.
//
// Replaces: no TPU kernel.  The reference's optimizer (`adamw` in
//   src/repro/optim/__init__.py) is jnp, which XLA fuses into its step; the
//   port's functional `optim.adamw(...).update` runs it as about ten fp32
//   passes a leaf, each into a new tensor, ~190 bytes moved a parameter.
//   Added for the LLM train step, where that update took 131 ms of a
//   288-319 ms step over 1.8 B parameters; reached through
//   `kernels/ops.grad_norm` and `kernels/ops.adamw_` from
//   `optim.adamw(...).update_`, which `launch/steps.make_scan_train_step`
//   takes where it owns the buffers.
//
// Computes, for every element of every leaf, given the clip scale s, the
// learning rate lr and the bias corrections bc1 = 1 - b1^t, bc2 = 1 - b2^t
// (device scalars: the K steps of a scan call never read the host):
//   g = g * s, rounded to g's type           (clip_by_global_norm)
//   m = b1 m + (1 - b1) g;   v = b2 v + (1 - b2) g^2
//   u = (m / bc1) / (sqrt(v / bc2) + eps)  [+ wd w]
//   w = w - lr u;  the weight = w rounded to its type
// w the fp32 master where the state holds one, else the weight itself.
// Each step is one fp32 operation rounded to nearest, in the plain
// update's order (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn, which the
// compiler never contracts into an FMA), so given the same s the kernel
// equals `kernels/ref.adamw_update_ref_` bit for bit.
//
// And the norm: sqrt of the sum of every gradient's squares, and the clip
// scale min(1, max_norm / max(norm, 1e-9)) in clip_by_global_norm's
// operations (1 without a clip).  One block a chunk sums its squares in
// fp64 in a fixed order and writes one partial; one block adds the
// partials in chunk order.  No atomics: the same bits every run, in an
// order other than the plain norm's (fp32 sums by leaf), so once the clip
// engages the scale can differ from the plain path's by an ulp.
//
// Bound: bytes.  The update reads a bf16 gradient and the fp32 m, v and
// master and writes m, v, the master and the bf16 weight: 28 bytes a
// parameter; the norm reads the gradient once more, 2 bytes.  Over the
// StarCoder2-3B cells' 1,797,892,608 parameters that is 53.9 GB, 16.1 ms
// at 3.35 TB/s.
//
// Design: the leaves are cut into chunks of kChunk elements, one block of
// 256 threads a chunk; a thread loads kUnroll vectors of 8 elements (16
// bytes of bf16, 32 of fp32), a block's width apart, before it computes
// any.  A leaf with a pointer not 16-byte aligned, and the tail of a leaf
// past its last full vector, go element by element.  Three int64 tables
// on the device, built by the wrapper (kernels/adamw.py), carry the
// leaves: the chunks (start, leaf, length), the leaves' m, v, master and
// weight pointers, sizes and types (built once for a state and cached: an
// in-place update never moves them), and each call's gradient pointers and
// types.  No table rides on a launch's arguments.
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kFinishThreads = 1024;
constexpr int kVec = 8;        // elements a vector
constexpr int kUnroll = 2;     // vectors a thread has in flight
constexpr int kChunk = 65536;  // elements a block; CHUNK in adamw.py

// flags: the gradient's type (Grad) or the weight's (Leaf); a master; every
// pointer of the entry 16-byte aligned
constexpr long long kBf16 = 1;
constexpr long long kMaster = 2;
constexpr long long kAligned = 4;

struct Leaf {
  float* m;
  float* v;
  float* master;  // null without a master
  void* w;
  long long n;
  long long flags;
};
struct Grad {
  const void* g;
  long long flags;
};
struct Chunk {
  long long start;
  int leaf;
  int len;
};
struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;
  int has_wd;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const uint16_t* p) {
  return __uint_as_float((uint32_t)*p << 16);
}
__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(uint16_t* p, float x) { *p = bf16_bits(x); }

// x rounded to T, as a float
__device__ __forceinline__ float rounded(float x, float*) { return x; }
__device__ __forceinline__ float rounded(float x, uint16_t*) {
  return __uint_as_float((uint32_t)bf16_bits(x) << 16);
}

__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
__device__ __forceinline__ void load8(const uint16_t* p, float* x) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // the lower address is the low half
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store8(float* p, const float* x) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ void store8(uint16_t* p, const float* x) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (uint32_t)bf16_bits(x[2 * i]) |
           ((uint32_t)bf16_bits(x[2 * i + 1]) << 16);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// One element: g the gradient (its type's value, widened), s the scale in
// g's type, w the master (or the weight) in fp32.
template <typename G>
__device__ __forceinline__ void adam(float g, float s, float& m, float& v,
                                     float& w, const Hyper& h, float lr,
                                     float bc1, float bc2) {
  g = rounded(__fmul_rn(g, s), (G*)nullptr);
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(h.omb2, __fmul_rn(g, g)));
  const float mh = __fdiv_rn(m, bc1);
  const float vh = __fdiv_rn(v, bc2);
  float u = __fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), h.eps));
  if (h.has_wd) u = __fadd_rn(u, __fmul_rn(h.wd, w));
  w = __fsub_rn(w, __fmul_rn(lr, u));
}

template <typename G, typename W, bool kHasMaster>
__device__ void update_chunk(const Leaf& L, const G* __restrict__ g,
                             long long start, int len, bool aligned,
                             float s, float lr, float bc1, float bc2,
                             const Hyper& h) {
  float* __restrict__ m = L.m + start;
  float* __restrict__ v = L.v + start;
  float* master = kHasMaster ? L.master + start : nullptr;
  W* w = static_cast<W*>(L.w) + start;
  g += start;
  const int nvec = aligned ? len / kVec * kVec : 0;
  for (int i0 = threadIdx.x * kVec; i0 < nvec;
       i0 += kThreads * kVec * kUnroll) {
    float gx[kUnroll][kVec], mx[kUnroll][kVec], vx[kUnroll][kVec],
        wx[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads * kVec;
      if (i < nvec) {
        load8(g + i, gx[u]);
        load8(m + i, mx[u]);
        load8(v + i, vx[u]);
        if constexpr (kHasMaster)
          load8(master + i, wx[u]);
        else
          load8(w + i, wx[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads * kVec;
      if (i < nvec) {
#pragma unroll
        for (int k = 0; k < kVec; ++k)
          adam<G>(gx[u][k], s, mx[u][k], vx[u][k], wx[u][k], h, lr, bc1,
                  bc2);
        store8(m + i, mx[u]);
        store8(v + i, vx[u]);
        if constexpr (kHasMaster) store8(master + i, wx[u]);
        store8(w + i, wx[u]);
      }
    }
  }
  for (int i = nvec + threadIdx.x; i < len; i += kThreads) {
    float mi = m[i], vi = v[i];
    float wi = kHasMaster ? master[i] : ld(w + i);
    adam<G>(ld(g + i), s, mi, vi, wi, h, lr, bc1, bc2);
    m[i] = mi;
    v[i] = vi;
    if constexpr (kHasMaster) master[i] = wi;
    st(w + i, wi);
  }
}

template <typename G, typename W>
__device__ __forceinline__ void update_typed(const Leaf& L, const Grad& gr,
                                             const Chunk& c, bool aligned,
                                             float s, float lr, float bc1,
                                             float bc2, const Hyper& h) {
  const G* g = static_cast<const G*>(gr.g);
  s = rounded(s, (G*)nullptr);  // scale.to(g.dtype)
  if (L.flags & kMaster)
    update_chunk<G, W, true>(L, g, c.start, c.len, aligned, s, lr, bc1, bc2,
                             h);
  else
    update_chunk<G, W, false>(L, g, c.start, c.len, aligned, s, lr, bc1,
                              bc2, h);
}

__global__ void __launch_bounds__(kThreads) adamw_update_kernel(
    const Leaf* __restrict__ leaves, const Grad* __restrict__ grads,
    const Chunk* __restrict__ chunks, const float* __restrict__ scale,
    const float* __restrict__ lr, const float* __restrict__ bc1,
    const float* __restrict__ bc2, Hyper h) {
  const Chunk c = chunks[blockIdx.x];
  const Leaf L = leaves[c.leaf];
  const Grad gr = grads[c.leaf];
  const bool aligned = (L.flags & gr.flags & kAligned) != 0;
  const float s = *scale, lr_t = *lr, b1c = *bc1, b2c = *bc2;
  if (gr.flags & kBf16) {
    if (L.flags & kBf16)
      update_typed<uint16_t, uint16_t>(L, gr, c, aligned, s, lr_t, b1c, b2c,
                                       h);
    else
      update_typed<uint16_t, float>(L, gr, c, aligned, s, lr_t, b1c, b2c, h);
  } else {
    if (L.flags & kBf16)
      update_typed<float, uint16_t>(L, gr, c, aligned, s, lr_t, b1c, b2c, h);
    else
      update_typed<float, float>(L, gr, c, aligned, s, lr_t, b1c, b2c, h);
  }
}

// The sum of x over a block of kN threads, in a fixed order; thread 0's.
template <int kN>
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double part[kN / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if (lane == 0) part[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < kN / 32 ? part[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, o);
  }
  return x;
}

template <typename G>
__device__ double sum_squares(const G* __restrict__ g, int len,
                              bool aligned) {
  double acc = 0.0;
  const int nvec = aligned ? len / kVec * kVec : 0;
  for (int i0 = threadIdx.x * kVec; i0 < nvec;
       i0 += kThreads * kVec * kUnroll) {
    float x[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads * kVec;
      if (i < nvec) load8(g + i, x[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads * kVec;
      if (i < nvec) {
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const double d = x[u][k];
          acc = fma(d, d, acc);
        }
      }
    }
  }
  for (int i = nvec + threadIdx.x; i < len; i += kThreads) {
    const double d = ld(g + i);
    acc = fma(d, d, acc);
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads) adamw_norm_kernel(
    const Grad* __restrict__ grads, const Chunk* __restrict__ chunks,
    double* __restrict__ partials) {
  const Chunk c = chunks[blockIdx.x];
  const Grad gr = grads[c.leaf];
  const bool aligned = (gr.flags & kAligned) != 0;
  const double acc =
      gr.flags & kBf16
          ? sum_squares(static_cast<const uint16_t*>(gr.g) + c.start, c.len,
                        aligned)
          : sum_squares(static_cast<const float*>(gr.g) + c.start, c.len,
                        aligned);
  const double total = block_sum<kThreads>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kFinishThreads) adamw_norm_finish_kernel(
    const double* __restrict__ partials, int n, float max_norm, int clip,
    float* __restrict__ norm, float* __restrict__ scale) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kFinishThreads) acc += partials[i];
  acc = block_sum<kFinishThreads>(acc);
  if (threadIdx.x == 0) {
    const float nrm = (float)sqrt(acc);
    float s = 1.0f;
    if (clip) {
      // torch.clamp(full(max_norm) / torch.clamp(norm, min=1e-9), max=1):
      // a NaN passes both clamps
      const float den = isnan(nrm) ? nrm : fmaxf(nrm, 1e-9f);
      const float q = __fdiv_rn(max_norm, den);
      s = isnan(q) ? q : fminf(q, 1.0f);
    }
    *norm = nrm;
    *scale = s;
  }
}

}  // namespace

// The elements a chunk holds; the wrapper builds its chunk table with it.
extern "C" int adamw_chunk_elements() { return kChunk; }

// Plain C entry point, loaded with ctypes.  grads: (leaves, 2) int64, each
// gradient's pointer and flags; chunks: (n_chunks, 2) int64 (start, leaf |
// length << 32); partials: n_chunks doubles of scratch.  Writes the global
// norm and the clip scale (1 where clip is 0) to the fp32 scalars norm and
// scale.  Two launches on `stream`.  Returns the CUDA error of the
// launches (0 on success); the caller raises if not 0.
extern "C" int adamw_norm_launch(const void* grads, const void* chunks,
                                 int n_chunks, void* partials,
                                 float max_norm, int clip, void* norm,
                                 void* scale, void* stream) {
  if (n_chunks < 0 || grads == nullptr || chunks == nullptr ||
      (n_chunks > 0 && partials == nullptr) || norm == nullptr ||
      scale == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_chunks > 0)
    adamw_norm_kernel<<<n_chunks, kThreads, 0, s>>>(
        (const Grad*)grads, (const Chunk*)chunks, (double*)partials);
  adamw_norm_finish_kernel<<<1, kFinishThreads, 0, s>>>(
      (const double*)partials, n_chunks, max_norm, clip, (float*)norm,
      (float*)scale);
  return (int)cudaGetLastError();
}

// Plain C entry point.  leaves: (leaves, 6) int64, each leaf's m, v,
// master (0: none) and weight pointers, size and flags; grads and chunks
// as adamw_norm_launch's; scale, lr, bc1, bc2 fp32 device scalars.
// Updates m, v, the masters and the weights in place, one launch on
// `stream`.  Returns the CUDA error of the launch.
extern "C" int adamw_update_launch(const void* leaves, const void* grads,
                                   const void* chunks, int n_chunks,
                                   const void* scale, const void* lr,
                                   const void* bc1, const void* bc2,
                                   float b1, float omb1, float b2,
                                   float omb2, float eps, float wd,
                                   int has_wd, void* stream) {
  if (n_chunks < 0 || leaves == nullptr || grads == nullptr ||
      chunks == nullptr || scale == nullptr || lr == nullptr ||
      bc1 == nullptr || bc2 == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return 0;
  const Hyper h{b1, omb1, b2, omb2, eps, wd, has_wd};
  adamw_update_kernel<<<n_chunks, kThreads, 0, (cudaStream_t)stream>>>(
      (const Leaf*)leaves, (const Grad*)grads, (const Chunk*)chunks,
      (const float*)scale, (const float*)lr, (const float*)bc1,
      (const float*)bc2, h);
  return (int)cudaGetLastError();
}
