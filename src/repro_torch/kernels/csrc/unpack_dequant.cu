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
// Design: one thread per lane word.  The (rows, W) words are one flat index
// space; each thread takes kWordsPerThread of them, a grid's width apart
// (so a warp's loads and stores stay contiguous), loads all its words
// before it writes any, and runs a grid-stride loop past that.  At b <= 10
// (vpw >= 3) a block first fills a shared table of the 2^b values, each by
// the same division, and looks the values up: the division, not the memory,
// held the L2-resident sizes back.  Each word is read once and its vpw
// values are written by the thread that read it:
// where vpw is a power of two (every b but 3, 5, 6, 9 and 10) as vector
// stores of up to 16 bytes (at b = 8: one 16-byte store in fp32, 8 bytes in
// bf16); where it is not, where a row's last word stops short of vpw
// columns, or where the values' start is not aligned to the vector (d not
// a multiple of it), value by value, up to column d.
#include <type_traits>

#include "cut_common.cuh"

namespace {

using namespace cut;

constexpr int kThreads = 256;
constexpr int kWordsPerThread = 4;
constexpr long long kFillBlocks = 264;  // 2 blocks an SM on 132 SMs
constexpr int kTableSize = 1024;        // 2^b values at b <= 10

// N values (N * sizeof(T) in {4, 8, 16} bytes, aligned to that) as one
// store, rounded as cut_common's store() rounds.
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  static_assert(N == 2 || N == 4, "8 or 16 bytes of fp32");
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}
template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  static_assert(N == 2 || N == 4 || N == 8, "4, 8 or 16 bytes of bf16");
  uint32_t w[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  if constexpr (N == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (N == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  }
}

// The value of codeword `idx`: the block's table where there is one (every
// b <= 10, vpw != 2), else the division itself.
template <int kVpw>
__device__ __forceinline__ float value(uint32_t idx, const float* table,
                                       float scale, float r) {
  if constexpr (kVpw != 2) return table[idx];
  return dequantize_index((float)idx, scale, r);
}

// The values of word `g` (row g / W, word g % W).  kVpw > 0: vpw is that
// power of two; kVpw == 0: vpw is the runtime `vpw`, value by value.
template <typename T, int kVpw>
__device__ __forceinline__ void emit(uint32_t word, int64_t g, T* out,
                                     int64_t W, int d, int bits, int vpw,
                                     const float* table, float scale,
                                     float r) {
  const int64_t row = g / W;
  const int c0 = (int)(g - row * W) * (kVpw > 0 ? kVpw : vpw);
  T* dst = out + row * d + c0;
  const uint32_t mask = (1u << bits) - 1u;
  if constexpr (kVpw > 0) {
    constexpr int kVec = kVpw * sizeof(T) < 16 ? kVpw : 16 / sizeof(T);
    if (c0 + kVpw <= d && (uintptr_t)dst % (kVec * sizeof(T)) == 0) {
#pragma unroll
      for (int k0 = 0; k0 < kVpw; k0 += kVec) {
        float v[kVec];
#pragma unroll
        for (int k = 0; k < kVec; ++k)
          v[k] = value<kVpw>((word >> ((k0 + k) * bits)) & mask, table,
                             scale, r);
        store_vec<kVec>(dst + k0, v);
      }
      return;
    }
  }
  const int n = min(kVpw > 0 ? kVpw : vpw, d - c0);
  for (int k = 0; k < n; ++k)
    store(dst + k, value<kVpw>((word >> (k * bits)) & mask, table, scale, r));
}

template <typename T, int kVpw>
__global__ void __launch_bounds__(kThreads) unpack_dequant_kernel(
    const uint32_t* __restrict__ packed, T* __restrict__ out,
    int64_t n_words, int64_t W, int d, int bits, float scale, float r) {
  const int vpw = 32 / bits;
  // b <= 10: the 2^b values, each the same division, once per block
  __shared__ float table[kVpw != 2 ? kTableSize : 1];
  if constexpr (kVpw != 2) {
    for (int i = threadIdx.x; i < (1 << bits); i += kThreads)
      table[i] = dequantize_index((float)i, scale, r);
    __syncthreads();
  }
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t g0 = (int64_t)blockIdx.x * kThreads + threadIdx.x;
       g0 < n_words; g0 += kWordsPerThread * stride) {
    uint32_t word[kWordsPerThread];
#pragma unroll
    for (int i = 0; i < kWordsPerThread; ++i) {
      const int64_t g = g0 + i * stride;
      word[i] = g < n_words ? packed[g] : 0u;
    }
#pragma unroll
    for (int i = 0; i < kWordsPerThread; ++i) {
      const int64_t g = g0 + i * stride;
      if (g < n_words)
        emit<T, kVpw>(word[i], g, out, W, d, bits, vpw, table, scale, r);
    }
  }
}

template <typename T>
void launch(const uint32_t* packed, T* out, long long n_words, int W, int d,
            int bits, float scale, float r, cudaStream_t s) {
  // enough blocks to fill the card; kWordsPerThread words a thread once
  // there are that many
  const long long one_each = (n_words + kThreads - 1) / kThreads;
  const long long four_each =
      (n_words + kThreads * kWordsPerThread - 1) / (kThreads * kWordsPerThread);
  const long long blocks =
      four_each >= kFillBlocks ? four_each
                               : (one_each < kFillBlocks ? one_each
                                                         : kFillBlocks);
  const dim3 grid((unsigned)(blocks < 0x7fffffffLL ? blocks : 0x7fffffffLL));
  auto run = [&](auto vpw) {
    unpack_dequant_kernel<T, decltype(vpw)::value><<<grid, kThreads, 0, s>>>(
        packed, out, n_words, W, d, bits, scale, r);
  };
  switch (32 / bits) {  // vpw: a power of two, or 0 for the others
    case 32: return run(std::integral_constant<int, 32>());
    case 16: return run(std::integral_constant<int, 16>());
    case 8: return run(std::integral_constant<int, 8>());
    case 4: return run(std::integral_constant<int, 4>());
    case 2: return run(std::integral_constant<int, 2>());
    default: return run(std::integral_constant<int, 0>());
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
  const long long n_words = rows * (long long)W;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    launch<__nv_bfloat16>((const uint32_t*)packed, (__nv_bfloat16*)out,
                          n_words, W, d, bits, scale, r, s);
  else
    launch<float>((const uint32_t*)packed, (float*)out, n_words, W, d, bits,
                  scale, r, s);
  return (int)cudaGetLastError();
}
