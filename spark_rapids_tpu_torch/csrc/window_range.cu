// K12c: min/max over per-row frames with a bounded lower edge.
//
// Replaces spark_rapids_tpu/ops/window.py:126 `_sparse_table` and :140
// `_range_query` as used by `running_or_bounded_agg` (:198-247): XLA
// builds log2(capacity) levels of a sparse table over the whole padded
// batch (level k holds the extreme of each 2^k-row span) and reads two
// overlapping spans per row, plus prefix sums of the contributing and NaN
// rows for the result's validity and Spark's NaN rules.
//
// Design, for rows sorted by (partition keys, order keys) with each row's
// inclusive frame [lo, hi] (ops/window.py `_frame_edges`, clamped to the
// partition):
//   * values become order-preserving unsigned keys: integers with the sign
//     bit flipped, bools 0/1, floats in the sign-flip encoding after -0.0
//     -> 0.0 and every NaN -> the canonical NaN, which is then the largest
//     value.  So max is NaN when any contributing value is NaN and min only
//     when all are, with no NaN count.  A null row holds the identity (all
//     ones for min, 0 for max) and a clear "has" byte.
//   * the table stops at level K = floor(log2(widest frame)), which the
//     wrapper reads from one max-reduction of hi - lo + 1 (its one sync),
//     not at log2(n): q51-style moving frames of 7 rows need 3 levels, not
//     22.  Level k is one elementwise pass over level k - 1.  Keys are 4
//     bytes for types of up to 4 bytes and 8 otherwise.
//   * one query pass combines two overlapping spans of level
//     floor(log2(hi - lo + 1)) per row, keys and has bytes; an empty frame
//     (lo > hi) or one with no contributing row gives null (zero data).
//   Min and max pick a value and add nothing, so the result is exact.
//
// Bound on the H100: bytes.  The function reads the value, its validity
// and the two frame edges and writes the result and its validity; the
// levels are scratch, written once and read twice each.
#include "common.cuh"

namespace srt_wrange {

using namespace srt;

enum Kind { kInt = 0, kFloat = 1, kBool = 2 };

template <typename K>
struct KeyBits {
  static constexpr K kSign = (K)1 << (sizeof(K) * 8 - 1);
};

template <typename K>
__device__ __forceinline__ K encode(const void* data, int kind, int item,
                                    int64_t i) {
  if (kind == kBool) return static_cast<const uint8_t*>(data)[i] != 0;
  if (kind == kFloat) {
    if (item == 4) {
      const float x = static_cast<const float*>(data)[i];
      uint32_t b = x != x ? 0x7fc00000u : (x == 0.0f ? 0u : __float_as_uint(x));
      return (K)((b & 0x80000000u) ? ~b : (b | 0x80000000u));
    }
    const double x = static_cast<const double*>(data)[i];
    unsigned long long b =
        x != x ? 0x7ff8000000000000ull
               : (x == 0.0 ? 0ull
                           : (unsigned long long)__double_as_longlong(x));
    return (K)((b & 0x8000000000000000ull) ? ~b
                                           : (b | 0x8000000000000000ull));
  }
  long long v;
  switch (item) {
    case 1: v = static_cast<const int8_t*>(data)[i]; break;
    case 2: v = static_cast<const int16_t*>(data)[i]; break;
    case 4: v = static_cast<const int32_t*>(data)[i]; break;
    default: v = static_cast<const long long*>(data)[i]; break;
  }
  return (K)v ^ KeyBits<K>::kSign;
}

template <typename K>
__device__ __forceinline__ void decode(K key, int kind, int item, void* out,
                                       int64_t i) {
  if (kind == kBool) {
    static_cast<uint8_t*>(out)[i] = (uint8_t)key;
    return;
  }
  if (kind == kFloat) {
    if (item == 4) {
      const uint32_t k = (uint32_t)key;
      static_cast<uint32_t*>(out)[i] = (k & 0x80000000u) ? (k & 0x7fffffffu)
                                                         : ~k;
    } else {
      const unsigned long long k = (unsigned long long)key;
      static_cast<unsigned long long*>(out)[i] =
          (k & 0x8000000000000000ull) ? (k & 0x7fffffffffffffffull) : ~k;
    }
    return;
  }
  const K u = key ^ KeyBits<K>::kSign;
  switch (item) {
    case 1: static_cast<int8_t*>(out)[i] = (int8_t)u; break;
    case 2: static_cast<int16_t*>(out)[i] = (int16_t)u; break;
    case 4: static_cast<int32_t*>(out)[i] = (int32_t)u; break;
    default: static_cast<long long*>(out)[i] = (long long)u; break;
  }
}

template <typename K, bool kMax>
__device__ __forceinline__ K pick(K a, K b) {
  return kMax ? (a > b ? a : b) : (a < b ? a : b);
}

template <typename K, bool kMax>
__global__ void level0_kernel(const void* __restrict__ data,
                              const uint8_t* __restrict__ valid, int kind,
                              int item, int64_t n, K* __restrict__ keys,
                              uint8_t* __restrict__ has) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const bool v = valid[i] != 0;
    has[i] = v;
    keys[i] = v ? encode<K>(data, kind, item, i) : (kMax ? (K)0 : ~(K)0);
  }
}

// level k from level k - 1: the extreme of [i, i + 2^k), clamped at n - 1.
template <typename K, bool kMax>
__global__ void level_kernel(const K* __restrict__ prev_k,
                             const uint8_t* __restrict__ prev_h, int64_t n,
                             int64_t half, K* __restrict__ cur_k,
                             uint8_t* __restrict__ cur_h) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t j = i + half < n ? i + half : n - 1;
    cur_k[i] = pick<K, kMax>(prev_k[i], prev_k[j]);
    cur_h[i] = prev_h[i] | prev_h[j];
  }
}

template <typename K, bool kMax>
__global__ void query_kernel(const K* __restrict__ keys,
                             const uint8_t* __restrict__ has,
                             const int32_t* __restrict__ lo,
                             const int32_t* __restrict__ hi, int64_t n,
                             int kind, int item,
                             void* __restrict__ out,
                             uint8_t* __restrict__ out_valid) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int32_t l = lo[i], h = hi[i];
    bool any = false;
    K res = 0;
    if (h >= l) {
      // k <= levels: the wrapper's width is the widest of these frames
      const int k = 31 - __clz(h - l + 1);
      const int64_t base = (int64_t)k * n;
      const int64_t b = (int64_t)h - (1 << k) + 1;
      res = pick<K, kMax>(keys[base + l], keys[base + b]);
      any = (has[base + l] | has[base + b]) != 0;
    }
    out_valid[i] = any;
    if (any) {
      decode<K>(res, kind, item, out, i);
    } else {  // a null slot holds zero bytes
      switch (item) {
        case 1: static_cast<uint8_t*>(out)[i] = 0; break;
        case 2: static_cast<uint16_t*>(out)[i] = 0; break;
        case 4: static_cast<uint32_t*>(out)[i] = 0; break;
        default: static_cast<unsigned long long*>(out)[i] = 0; break;
      }
    }
  }
}

template <typename K, bool kMax>
void launch(const void* data, const uint8_t* valid, int kind, int item,
            const int32_t* lo, const int32_t* hi, int64_t n, int levels,
            void* keys, uint8_t* has, void* out, uint8_t* out_valid,
            cudaStream_t st) {
  K* kk = (K*)keys;
  const int g = grid_for(n);
  level0_kernel<K, kMax><<<g, kThreads, 0, st>>>(data, valid, kind, item, n,
                                                 kk, has);
  for (int k = 1; k <= levels; ++k)
    level_kernel<K, kMax><<<g, kThreads, 0, st>>>(
        kk + (int64_t)(k - 1) * n, has + (int64_t)(k - 1) * n, n,
        (int64_t)1 << (k - 1), kk + (int64_t)k * n, has + (int64_t)k * n);
  query_kernel<K, kMax><<<g, kThreads, 0, st>>>(kk, has, lo, hi, n, kind,
                                                item, out, out_valid);
}

struct MaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a > b ? a : b;
  }
};

__global__ void width_kernel(const int32_t* __restrict__ lo,
                             const int32_t* __restrict__ hi, int64_t n,
                             int32_t* __restrict__ out) {
  using BlockReduce = cub::BlockReduce<int, kThreads>;
  __shared__ typename BlockReduce::TempStorage tmp;
  int w = 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int d = hi[i] - lo[i] + 1;
    w = d > w ? d : w;
  }
  const int m = BlockReduce(tmp).Reduce(w, MaxOp());
  if (threadIdx.x == 0 && m > 0) atomicMax(out, m);
}

}  // namespace srt_wrange

extern "C" {

// out[0] (0 on entry) = the widest frame, max(hi - lo + 1), 0 if every
// frame is empty.
int srt_window_range_width(const void* lo, const void* hi, int64_t n,
                           void* out, void* stream) {
  using namespace srt_wrange;
  if (n > 0)
    width_kernel<<<grid_for(n, 4), kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)lo, (const int32_t*)hi, n, (int32_t*)out);
  return (int)cudaGetLastError();
}

// Min (is_max 0) or max (1) of each row's frame [lo[i], hi[i]] over n >= 1
// rows.  kind 0 int (item 1/2/4/8), 1 float (4/8), 2 bool (1).  levels:
// floor(log2) of the widest frame (0 if none is wider than a row).  keys:
// (levels + 1) * n keys of 4 bytes (item <= 4) or 8; has: (levels + 1) * n
// bytes.  out: n values of the input's type; out_valid: n bytes.
int srt_window_range(int is_max, int kind, int item, const void* data,
                     const void* valid, const void* lo, const void* hi,
                     int64_t n, int levels, void* keys, void* has, void* out,
                     void* out_valid, void* stream) {
  using namespace srt_wrange;
  if (n <= 0 || n > 0x7fffffffLL || levels < 0 || levels > 30 ||
      !(item == 1 || item == 2 || item == 4 || item == 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* v = (const uint8_t*)valid;
  const int32_t* l = (const int32_t*)lo;
  const int32_t* h = (const int32_t*)hi;
  uint8_t* hs = (uint8_t*)has;
  uint8_t* ov = (uint8_t*)out_valid;
  if (item <= 4) {
    if (is_max)
      launch<uint32_t, true>(data, v, kind, item, l, h, n, levels, keys, hs,
                             out, ov, st);
    else
      launch<uint32_t, false>(data, v, kind, item, l, h, n, levels, keys, hs,
                              out, ov, st);
  } else {
    if (is_max)
      launch<unsigned long long, true>(data, v, kind, item, l, h, n, levels,
                                       keys, hs, out, ov, st);
    else
      launch<unsigned long long, false>(data, v, kind, item, l, h, n, levels,
                                        keys, hs, out, ov, st);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
