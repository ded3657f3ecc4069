// K8: the scan's wire-codec decode.  K8a decodes every bit-packed stream
// of a batch in one launch, K8b a dictionary string column.
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
// base is one int64 in device memory (the batch's parameter leaf).
//
// K8a (srt_decode_batch): one launch a batch, as the reference's one
// program a batch.  The wrapper (columnar/wirecodec.py decode_table) lists
// each stream to decode -- a column's data stream, a string column's
// lengths, or a validity stream alone -- as kDecodeJobWords words: the
// packed words, the validity words, the FOR base, the data and validity
// outputs, the divisor or scale, and bits | kind << 8 | output bytes << 16;
// a raw leaf's validity (ones where it ships none) is a job too, so a
// batch's fixed-width columns cost one launch and no fill;
// the table goes by value in the kernel's parameters (__grid_constant__,
// two sizes) or, where longer, as a device copy.  Every stream of a batch
// has its n rows, so the blocks take (job, row tile) pairs from the
// flattened list job * tiles + tile: a block's branch on the kind is
// uniform.  A thread decodes 4 consecutive rows: their validity is 4 bits
// of one word and goes out in one 4-byte store, their values (neighbouring
// threads on neighbouring words, so the loads coalesce) in one store of 4
// values (two 16-byte stores for 8-byte values).  It joins a value's word
// with the next one only when the value straddles (__funnelshift_r), adds
// the base and applies the factor:
//   integers  (raw + base) * div in wrapping 64-bit arithmetic, then the
//             narrowing cast;
//   bools     raw != 0;
//   doubles   __dmul_rn(__dadd_rn(raw, base), scale): each step rounded
//             on its own (no FMA contraction), so the value equals the one
//             the host checked, bit for bit.
// Null slots are written as zero, and validity as 0/1 bytes.  A job with
// no data stream writes the validity alone.
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
#include <cstring>
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

// Table words of a job, rows a thread, rows a block's tile, and the
// small and large parameter tables.
constexpr int kDecodeJobWords = 7;
constexpr int kDecodeRows = 4;
constexpr int kDecodeTile = kBlock * kDecodeRows;
constexpr int kDecodeSmallWords = 448;  // 64 jobs, 3,584 bytes
constexpr int kDecodeLargeWords = 4000;  // 32,000 bytes

template <int kWords>
struct DecodeParams {
  const long long* dev;  // non-null: the table is here
  long long n;
  long long tiles;  // row tiles a job
  int njobs;
  long long w[kWords];
};

template <typename T>
struct Vec4;  // four values in one store
template <> struct Vec4<int8_t> { typedef uint32_t V; };
template <> struct Vec4<uint8_t> { typedef uint32_t V; };
template <> struct Vec4<int16_t> { typedef uint2 V; };
template <> struct Vec4<int32_t> { typedef uint4 V; };

template <typename T>
__device__ __forceinline__ void store4(T* out, int64_t r0, int64_t n,
                                       const T (&v)[kDecodeRows]) {
  T* p = out + r0;
  if constexpr (sizeof(T) == 8) {
    if (r0 + kDecodeRows <= n && ((uintptr_t)p & 15) == 0) {
      union {
        T t[kDecodeRows];
        uint4 q[2];
      } u;
#pragma unroll
      for (int k = 0; k < kDecodeRows; ++k) u.t[k] = v[k];
      reinterpret_cast<uint4*>(p)[0] = u.q[0];
      reinterpret_cast<uint4*>(p)[1] = u.q[1];
      return;
    }
  } else {
    typedef typename Vec4<T>::V V;
    if (r0 + kDecodeRows <= n && ((uintptr_t)p % sizeof(V)) == 0) {
      union {
        T t[kDecodeRows];
        V q;
      } u;
#pragma unroll
      for (int k = 0; k < kDecodeRows; ++k) u.t[k] = v[k];
      *reinterpret_cast<V*>(p) = u.q;
      return;
    }
  }
  for (int k = 0; k < kDecodeRows && r0 + k < n; ++k) p[k] = v[k];
}

// One job's rows r0 .. r0 + 3 (r0 a multiple of 4, below n).
template <typename T, int KIND>
__device__ __forceinline__ void decode_rows(const long long* jw, int64_t r0,
                                            int64_t n) {
  const uint32_t* vwords = reinterpret_cast<const uint32_t*>(jw[1]);
  // the 4 rows' validity bits lie in one word
  const uint32_t vb = vwords == nullptr
                          ? 0xfu
                          : (__ldg(vwords + (r0 >> 5)) >> (r0 & 31)) & 0xfu;
  uint8_t* out_valid = reinterpret_cast<uint8_t*>(jw[4]);
  const uint8_t ok[kDecodeRows] = {(uint8_t)(vb & 1u), (uint8_t)((vb >> 1) & 1u),
                                   (uint8_t)((vb >> 2) & 1u),
                                   (uint8_t)((vb >> 3) & 1u)};
  store4<uint8_t>(out_valid, r0, n, ok);
  if constexpr (KIND != kValidOnly) {
    const uint32_t* words = reinterpret_cast<const uint32_t*>(jw[0]);
    const int bits = (int)(jw[6] & 0xff);
    const uint32_t mask = mask_of(bits);
    const long long* basep = reinterpret_cast<const long long*>(jw[2]);
    const long long b = basep == nullptr ? 0ll : __ldg(basep);
    T v[kDecodeRows];
#pragma unroll
    for (int k = 0; k < kDecodeRows; ++k) {
      v[k] = T(0);
      if (ok[k] && r0 + k < n) {
        const uint32_t raw = unpack(words, r0 + k, bits, mask);
        if constexpr (KIND == kInt) {
          const unsigned long long x =
              ((unsigned long long)raw + (unsigned long long)b) *
              (unsigned long long)jw[5];
          v[k] = (T)(long long)x;
        } else if constexpr (KIND == kBool) {
          v[k] = (T)(raw != 0u ? 1 : 0);
        } else {
          v[k] = (T)__dmul_rn(__dadd_rn((double)raw, (double)b),
                              __longlong_as_double(jw[5]));
        }
      }
    }
    store4<T>(reinterpret_cast<T*>(jw[3]), r0, n, v);
  }
}

template <int kWords>
__global__ void __launch_bounds__(kBlock)
decode_batch_kernel(const __grid_constant__ DecodeParams<kWords> p) {
  const long long* tab = p.dev != nullptr ? p.dev : p.w;
  const long long job = (long long)blockIdx.x / p.tiles;
  const long long tile = (long long)blockIdx.x - job * p.tiles;
  const int64_t r0 = (tile * kBlock + threadIdx.x) * kDecodeRows;
  if (r0 >= p.n) return;
  const long long* jw = tab + job * kDecodeJobWords;
  const int kind = (int)((jw[6] >> 8) & 0xff);
  switch (kind) {
    case kValidOnly: decode_rows<uint8_t, kValidOnly>(jw, r0, p.n); break;
    case kBool: decode_rows<uint8_t, kBool>(jw, r0, p.n); break;
    case kScaled: decode_rows<double, kScaled>(jw, r0, p.n); break;
    default:
      switch ((int)((jw[6] >> 16) & 0xff)) {
        case 1: decode_rows<int8_t, kInt>(jw, r0, p.n); break;
        case 2: decode_rows<int16_t, kInt>(jw, r0, p.n); break;
        case 4: decode_rows<int32_t, kInt>(jw, r0, p.n); break;
        default: decode_rows<long long, kInt>(jw, r0, p.n); break;
      }
  }
}

template <int kWords>
int launch_batch(const void* words, int64_t nwords, int njobs,
                 const void* words_dev, int64_t n, cudaStream_t stream) {
  DecodeParams<kWords> p;
  p.dev = static_cast<const long long*>(words_dev);
  p.n = n;
  p.tiles = (n + kDecodeTile - 1) / kDecodeTile;
  p.njobs = njobs;
  if (words_dev == nullptr)
    std::memcpy(p.w, words, sizeof(long long) * (size_t)nwords);
  const long long blocks = p.tiles * njobs;
  if (blocks > 2147483647ll) return (int)cudaErrorInvalidValue;
  decode_batch_kernel<kWords><<<(unsigned)blocks, kBlock, 0, stream>>>(p);
  return (int)cudaGetLastError();
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

// K8a.  words: the table above (nwords = kDecodeJobWords * njobs, copied
// into the kernel's parameters; words_dev, when not null, a device copy
// that the kernel reads instead: the wrapper makes one past
// kDecodeLargeWords), every job over n rows.  A job's kind: 0 validity
// only (no words, no data output; without validity words, ones), 1 integer of output bytes 1/2/4/8
// ((raw + base) * div), 2 bool, 3 float64 ((raw + base) * scale, the
// scale's bits in the factor word); its validity words null: all valid;
// its base null: 0.  Outputs: [n] of the kind's type, validity uint8 [n].
int srt_decode_batch(const void* words, int64_t nwords, int njobs,
                     const void* words_dev, int64_t n, void* stream) {
  if (n <= 0 || njobs <= 0) return (int)cudaGetLastError();
  if (words == nullptr || nwords != (int64_t)kDecodeJobWords * njobs)
    return (int)cudaErrorInvalidValue;
  const long long* w = static_cast<const long long*>(words);
  for (int j = 0; j < njobs; ++j) {
    const long long* jw = w + (long long)j * kDecodeJobWords;
    const int bits = (int)(jw[6] & 0xff), kind = (int)((jw[6] >> 8) & 0xff);
    const int ob = (int)((jw[6] >> 16) & 0xff);
    if (jw[4] == 0 || kind > kScaled) return (int)cudaErrorInvalidValue;
    if (kind == kValidOnly) continue;
    if (jw[0] == 0 || jw[3] == 0 || bits < 1 || bits > 32 ||
        (kind == kInt && ob != 1 && ob != 2 && ob != 4 && ob != 8) ||
        (kind == kBool && ob != 1) || (kind == kScaled && ob != 8))
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (words_dev != nullptr)
    return launch_batch<1>(words, nwords, njobs, words_dev, n, s);
  if (nwords <= kDecodeSmallWords)
    return launch_batch<kDecodeSmallWords>(words, nwords, njobs, nullptr, n,
                                           s);
  if (nwords <= kDecodeLargeWords)
    return launch_batch<kDecodeLargeWords>(words, nwords, njobs, nullptr, n,
                                           s);
  return (int)cudaErrorInvalidValue;
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

// The constants the Python wrapper shares with this file, in the order of
// columnar/wirecodec.py's ``native.share_limits`` call: table words a job,
// rows a tile, and the small and large parameter tables.  Writes the first
// n of them.
int srt_wirecodec_limits(int64_t* out, int n) {
  const int64_t v[] = {kDecodeJobWords, kDecodeTile, kDecodeSmallWords,
                       kDecodeLargeWords};
  for (int i = 0; i < n && i < (int)(sizeof(v) / sizeof(v[0])); ++i)
    out[i] = v[i];
  return 0;
}

}  // extern "C"
