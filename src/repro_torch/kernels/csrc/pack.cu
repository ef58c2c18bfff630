// Standalone pack for Hopper (sm_90a): quantized values -> codeword lanes.
//
// Replaces: the Pallas kernel `_pack_kernel` in
//   src/repro/kernels/inl_bottleneck.py (launched by `_pack_pallas`, entry
//   point `pack_values`).  It puts on the packed wire a latent whose forward
//   kernel emits no lanes: split learning's deterministic cut, the
//   learned-prior cut, and every packed edge of a multi-hop topology, which
//   re-encodes the payload it forwards (one launch an edge).
//
// Computes, for every row of (rows, d) values u (fp32 or bf16):
//   idx   = rintf((clip(u) + r) * scale)       the codeword index
//   lanes = 32 / b codewords per uint32, little-endian, the tail zero
// for 1 <= b <= 16, with the quantizer chain of cut_common.cuh.  On values
// already on the b-bit grid this is lossless: unpack_dequant.cu gives u back
// bit for bit.
//
// Bound: bytes.  An fp32 call reads 4 d bytes and writes 4 W bytes a row
// (W = ceil(d / (32 / b))), with three flops a value.
//
// Design: one thread per lane word, as unpack_dequant.cu.  The (rows, W)
// words are one flat index space; each thread takes kWords of them, a
// grid's width apart (so a warp's loads and stores stay contiguous), issues
// the loads of all its words before it builds any, and runs a grid-stride
// loop past that.  Nothing goes through shared memory and no thread waits
// on another: a word's vpw values are quantized in registers, OR'ed into
// the word and written with one 4-byte store.  Where vpw is a power of two
// (every b but 3, 5, 6, 9 and 10) a word's values are read as vector loads
// of up to 16 bytes (at b = 8: one 16-byte load in fp32, 8 bytes in bf16);
// where it is not, where a row's last word stops short of vpw columns, or
// where the values' start is not aligned to the vector (d not a multiple of
// it), value by value, up to column d.  vpw is a template parameter, so the
// values of a word stay in registers on every path.
#include <type_traits>

#include "cut_common.cuh"

namespace {

using namespace cut;

constexpr int kThreads = 256;
constexpr long long kFillBlocks = 264;  // 2 blocks an SM on 132 SMs

// Words a thread: 4, or fewer where a word holds 16 or 32 values, so a
// thread keeps at most 40 values in registers.
template <int kVpw>
constexpr int kWordsPerThread = kVpw >= 16 ? 32 / kVpw : 4;

// N values from p (N * sizeof(T) in {4, 8, 16} bytes, aligned to that) as
// one load, widened to fp32.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  static_assert(N == 2 || N == 4, "8 or 16 bytes of fp32");
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  }
}
template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  static_assert(N == 2 || N == 4 || N == 8, "4, 8 or 16 bytes of bf16");
  uint32_t w[N / 2];
  if constexpr (N == 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
  } else if constexpr (N == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x, w[1] = x.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    // the lower address is the low half
    const __nv_bfloat162 h =
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    v[2 * i] = __low2float(h);
    v[2 * i + 1] = __high2float(h);
  }
}

// Loads the values of word g (row g / W, word g % W) into v and returns how
// many of its kVpw columns lie before d.
template <typename T, int kVpw>
__device__ __forceinline__ int load_word(const T* __restrict__ u, int64_t g,
                                         int64_t W, int d, float* v) {
  const int64_t row = g / W;
  const int c0 = (int)(g - row * W) * kVpw;
  const T* src = u + row * d + c0;
  const int n = min(kVpw, d - c0);
  if constexpr ((kVpw & (kVpw - 1)) == 0) {
    constexpr int kVec = kVpw * sizeof(T) < 16 ? kVpw : 16 / sizeof(T);
    if (n == kVpw && (uintptr_t)src % (kVec * sizeof(T)) == 0) {
#pragma unroll
      for (int k0 = 0; k0 < kVpw; k0 += kVec)
        load_vec<kVec>(src + k0, v + k0);
      return n;
    }
  }
#pragma unroll
  for (int k = 0; k < kVpw; ++k) v[k] = k < n ? to_f32(src[k]) : 0.f;
  return n;
}

// The lane of n values: codeword k at bit k * bits, the columns past d zero.
template <int kVpw>
__device__ __forceinline__ uint32_t build_word(const float* v, int n,
                                               int bits, float scale,
                                               float r) {
  uint32_t word = 0u;
#pragma unroll
  for (int k = 0; k < kVpw; ++k)
    if (k < n)
      word |= (uint32_t)quantize_index(v[k], scale, r) << (k * bits);
  return word;
}

template <typename T, int kVpw>
__global__ void __launch_bounds__(kThreads) pack_kernel(
    const T* __restrict__ u, uint32_t* __restrict__ packed, int64_t n_words,
    int64_t W, int d, int bits, float scale, float r) {
  constexpr int kWords = kWordsPerThread<kVpw>;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t g0 = (int64_t)blockIdx.x * kThreads + threadIdx.x;
       g0 < n_words; g0 += kWords * stride) {
    float v[kWords][kVpw];
    int n[kWords];
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      const int64_t g = g0 + i * stride;
      n[i] = g < n_words ? load_word<T, kVpw>(u, g, W, d, v[i]) : 0;
    }
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      const int64_t g = g0 + i * stride;
      if (g < n_words)
        packed[g] = build_word<kVpw>(v[i], n[i], bits, scale, r);
    }
  }
}

template <typename T>
void launch(const T* u, uint32_t* packed, long long n_words, int W, int d,
            int bits, float scale, float r, cudaStream_t s) {
  auto run = [&](auto vpw) {
    constexpr int kVpw = decltype(vpw)::value;
    constexpr int kWords = kWordsPerThread<kVpw>;
    // enough blocks to fill the card; kWords words a thread once there are
    // that many
    const long long one_each = (n_words + kThreads - 1) / kThreads;
    const long long all_each =
        (n_words + kThreads * kWords - 1) / (kThreads * kWords);
    const long long blocks =
        all_each >= kFillBlocks ? all_each
                                : (one_each < kFillBlocks ? one_each
                                                          : kFillBlocks);
    const dim3 grid(
        (unsigned)(blocks < 0x7fffffffLL ? blocks : 0x7fffffffLL));
    pack_kernel<T, kVpw><<<grid, kThreads, 0, s>>>(u, packed, n_words, W, d,
                                                    bits, scale, r);
  };
  switch (32 / bits) {  // vpw
    case 32: return run(std::integral_constant<int, 32>());
    case 16: return run(std::integral_constant<int, 16>());
    case 10: return run(std::integral_constant<int, 10>());
    case 8: return run(std::integral_constant<int, 8>());
    case 6: return run(std::integral_constant<int, 6>());
    case 5: return run(std::integral_constant<int, 5>());
    case 4: return run(std::integral_constant<int, 4>());
    case 3: return run(std::integral_constant<int, 3>());
    default: return run(std::integral_constant<int, 2>());
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
  const long long n_words = rows * (long long)W;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    launch<__nv_bfloat16>((const __nv_bfloat16*)u, (uint32_t*)packed,
                          n_words, W, d, bits, scale, r, s);
  else
    launch<float>((const float*)u, (uint32_t*)packed, n_words, W, d, bits,
                  scale, r, s);
  return (int)cudaGetLastError();
}
