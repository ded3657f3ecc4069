// K8: the scan's wire-codec decode.  K8a decodes a fixed-width column,
// K8b a dictionary string column.
//
// Replaces spark_rapids_tpu/columnar/wirecodec.py:104 `_unpack_bits_device`,
// :269 `decode_data`, :259 `decode_validity` and the decode branches of
// columnar/batch.py:212 `_packed_unpack_cached` (:250-269), which XLA runs
// inside one jitted unpack program per batch layout.
//
// The stream format is the host encoder's (wirecodec.py pack_bits_host):
// value i of a b-bit stream occupies bits [i*b, i*b + b) of a little-endian
// uint32 word stream, b in 1..32, so a value may straddle two words.  A
// validity stream is the same format with b = 1.  The frame-of-reference
// base is one int64 in device memory (the batch's parameter leaf); the
// divisor or scale is a launch argument.
//
// K8a: one thread a row (grid-stride).  It reads the row's word, and the
// next one only when the value straddles, joins them with
// __funnelshift_r, adds the base and applies the factor:
//   integers  (raw + base) * div in wrapping 64-bit arithmetic, then the
//             narrowing cast;
//   bools     raw != 0;
//   doubles   __dmul_rn(__dadd_rn(raw, base), scale): each step rounded
//             on its own (no FMA contraction), so the value equals the one
//             the host checked, bit for bit.
// Null slots are written as zero, and validity as 0/1 bytes.  With no data
// stream it writes the validity alone.
//
// K8b: one thread per vector of min(W, 16) bytes of an output row, W a
// power of two (16-byte stores from W 16 up).  The thread unpacks the
// row's index inline, as K8a does, and copies its vector of the
// dictionary row; the row's first vector thread writes its length and
// validity.  A null row gets zero bytes and length 0.
//
// Bound on the H100: bytes.  Each packed word and validity word is read
// once (neighbouring threads share words through L1), each output byte
// written once; the dictionary is small and stays in L2.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace srt_wirecodec {

constexpr int kBlock = 256;

enum Kind { kValidOnly = 0, kInt = 1, kBool = 2, kScaled = 3 };

__device__ __forceinline__ uint32_t unpack(const uint32_t* __restrict__ w,
                                           int64_t i, int bits,
                                           uint32_t mask) {
  const uint64_t o = (uint64_t)i * (uint64_t)bits;
  const uint64_t wi = o >> 5;
  const uint32_t sh = (uint32_t)o & 31u;
  const uint32_t lo = __ldg(w + wi);
  const uint32_t hi = sh + (uint32_t)bits > 32u ? __ldg(w + wi + 1) : 0u;
  return __funnelshift_r(lo, hi, sh) & mask;
}

__device__ __forceinline__ bool valid_at(const uint32_t* __restrict__ v,
                                         int64_t i) {
  return v == nullptr || ((__ldg(v + (i >> 5)) >> (i & 31)) & 1u) != 0u;
}

__device__ __forceinline__ uint32_t mask_of(int bits) {
  return bits >= 32 ? 0xFFFFFFFFu : ((1u << bits) - 1u);
}

template <typename T, int KIND>
__global__ void __launch_bounds__(kBlock) decode_fixed_kernel(
    const uint32_t* __restrict__ words, int bits,
    const long long* __restrict__ base, long long div, double scale,
    const uint32_t* __restrict__ vwords, T* __restrict__ out,
    uint8_t* __restrict__ out_valid, int64_t n) {
  const uint32_t mask = mask_of(bits);
  const long long b = base == nullptr ? 0ll : __ldg(base);
  const int64_t stride = (int64_t)gridDim.x * kBlock;
  for (int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x; i < n;
       i += stride) {
    const bool ok = valid_at(vwords, i);
    out_valid[i] = ok ? 1 : 0;
    if constexpr (KIND != kValidOnly) {
      T v = T(0);
      if (ok) {
        const uint32_t raw = unpack(words, i, bits, mask);
        if constexpr (KIND == kInt) {
          const unsigned long long x =
              ((unsigned long long)raw + (unsigned long long)b) *
              (unsigned long long)div;
          v = (T)(long long)x;
        } else if constexpr (KIND == kBool) {
          v = (T)(raw != 0u ? 1 : 0);
        } else {
          v = (T)__dmul_rn(__dadd_rn((double)raw, (double)b), scale);
        }
      }
      out[i] = v;
    }
  }
}

template <typename V>
__global__ void __launch_bounds__(kBlock) decode_dict_kernel(
    const uint32_t* __restrict__ words, int bits,
    const long long* __restrict__ base, const uint32_t* __restrict__ vwords,
    const V* __restrict__ dict, const int32_t* __restrict__ dict_len,
    int vec_shift, V* __restrict__ out, int32_t* __restrict__ out_len,
    uint8_t* __restrict__ out_valid, int64_t n) {
  const uint32_t mask = mask_of(bits);
  const long long b = base == nullptr ? 0ll : __ldg(base);
  const int64_t total = n << vec_shift;
  const int64_t cmask = ((int64_t)1 << vec_shift) - 1;
  const int64_t stride = (int64_t)gridDim.x * kBlock;
  for (int64_t t = (int64_t)blockIdx.x * kBlock + threadIdx.x; t < total;
       t += stride) {
    const int64_t row = t >> vec_shift;
    const int64_t c = t & cmask;
    const bool ok = valid_at(vwords, row);
    V v{};
    int32_t len = 0;
    if (ok) {
      const int64_t idx = (int64_t)unpack(words, row, bits, mask) + b;
      v = dict[(idx << vec_shift) + c];
      if (c == 0) len = __ldg(dict_len + idx);
    }
    out[t] = v;
    if (c == 0) {
      out_len[row] = len;
      out_valid[row] = ok ? 1 : 0;
    }
  }
}

template <typename T, int KIND>
void launch_fixed(const void* words, int bits, const void* base,
                  long long div, double scale, const void* vwords, void* out,
                  void* out_valid, int64_t n, cudaStream_t stream) {
  decode_fixed_kernel<T, KIND><<<srt::grid_for(n), kBlock, 0, stream>>>(
      (const uint32_t*)words, bits, (const long long*)base, div, scale,
      (const uint32_t*)vwords, (T*)out, (uint8_t*)out_valid, n);
}

template <typename V>
void launch_dict(const void* words, int bits, const void* base,
                 const void* vwords, const void* dict, const void* dict_len,
                 int vec_shift, void* out, void* out_len, void* out_valid,
                 int64_t n, cudaStream_t stream) {
  decode_dict_kernel<V><<<srt::grid_for(n << vec_shift), kBlock, 0,
                          stream>>>(
      (const uint32_t*)words, bits, (const long long*)base,
      (const uint32_t*)vwords, (const V*)dict, (const int32_t*)dict_len,
      vec_shift, (V*)out, (int32_t*)out_len, (uint8_t*)out_valid, n);
}

}  // namespace srt_wirecodec

using namespace srt_wirecodec;

extern "C" {

// K8a.  words: uint32 stream of `bits`-bit values (NULL with kind 0:
// validity alone); base: one int64 (NULL: 0); kind: 0 validity only,
// 1 integer of out_bytes 1/2/4/8 ((raw + base) * div), 2 bool, 3 float64
// ((raw + base) * scale); vwords: 1-bit validity stream (NULL: all
// valid); out: [n] of the kind's type; out_valid: uint8 [n].
int srt_decode_fixed(const void* words, int bits, const void* base,
                     long long div, double scale, int kind, int out_bytes,
                     const void* vwords, void* out, void* out_valid,
                     int64_t n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (bits < 1 || bits > 32) {
    if (kind != kValidOnly) return (int)cudaErrorInvalidValue;
    bits = 1;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case kValidOnly:
      launch_fixed<uint8_t, kValidOnly>(nullptr, bits, nullptr, 1, 1.0,
                                        vwords, nullptr, out_valid, n, s);
      break;
    case kBool:
      launch_fixed<uint8_t, kBool>(words, bits, base, 1, 1.0, vwords, out,
                                   out_valid, n, s);
      break;
    case kScaled:
      launch_fixed<double, kScaled>(words, bits, base, 1, scale, vwords,
                                    out, out_valid, n, s);
      break;
    case kInt:
      switch (out_bytes) {
        case 1:
          launch_fixed<int8_t, kInt>(words, bits, base, div, 1.0, vwords,
                                     out, out_valid, n, s);
          break;
        case 2:
          launch_fixed<int16_t, kInt>(words, bits, base, div, 1.0, vwords,
                                      out, out_valid, n, s);
          break;
        case 4:
          launch_fixed<int32_t, kInt>(words, bits, base, div, 1.0, vwords,
                                      out, out_valid, n, s);
          break;
        case 8:
          launch_fixed<long long, kInt>(words, bits, base, div, 1.0,
                                        vwords, out, out_valid, n, s);
          break;
        default:
          return (int)cudaErrorInvalidValue;
      }
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K8b.  words: uint32 stream of `bits`-bit indices, base: one int64 (NULL:
// 0); vwords: 1-bit validity (NULL: all valid); dict: uint8 [k, width]
// (16-byte aligned), dict_len: int32 [k]; out: uint8 [n, width], out_len:
// int32 [n], out_valid: uint8 [n].  width is a power of two >= 4.
int srt_decode_dict(const void* words, int bits, const void* base,
                    const void* vwords, const void* dict,
                    const void* dict_len, int width, void* out,
                    void* out_len, void* out_valid, int64_t n,
                    void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (bits < 1 || bits > 32 || width < 4 || (width & (width - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (width >= 16) {
    int shift = 0;
    while ((16 << shift) < width) ++shift;
    launch_dict<uint4>(words, bits, base, vwords, dict, dict_len, shift, out,
                       out_len, out_valid, n, s);
  } else if (width == 8) {
    launch_dict<uint2>(words, bits, base, vwords, dict, dict_len, 0, out,
                       out_len, out_valid, n, s);
  } else {
    launch_dict<uint32_t>(words, bits, base, vwords, dict, dict_len, 0, out,
                          out_len, out_valid, n, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
