// K13a: Spark substring(str, pos, len) over byte-matrix strings.
//
// Replaces spark_rapids_tpu/expr/strings.py:29 `_char_starts` and :174
// `Substring._device`, which XLA runs as a bool [n, W] start mask, a
// cumsum over it, two argmax searches for the first and past-the-end
// characters and a take_along_axis shift of the whole matrix.
//
// Semantics (UTF8String.substringSQL): a byte inside the row's length is
// the start of a character when (b & 0xC0) != 0x80; with numChars starts,
// start = pos - 1 (pos > 0), numChars + pos (pos < 0) or 0; end = start +
// len saturated; start = max(start, 0); the result is empty when start >=
// end, else the characters [min(start, n), min(end, n)).  All of it in
// 64-bit arithmetic: the reference's int32 `start + len` wraps for len
// near INT32_MAX.  The output row is the input's width W, the bytes of
// the result first and zeros after them.  A null string, pos or len
// gives a null row (zeros, length 0).
//
// Design.  Rows of 4 to 32 bytes (q15's zips and q22's phones are 8 and
// 16): one thread a row (substring_row_kernel below): the row in one or
// two vector loads, its character starts as one 32-bit mask, the two
// characters found by a select over popcounts.  Wider rows: a group of
// G = min(W / 4, 32) lanes a row (in general the largest power of two
// dividing W / 4), each lane one 4-byte word of the row per chunk of 4G
// bytes, all reads and writes of a row coalesced:
//   1. each lane counts the starts in its words; a butterfly over the
//      group gives numChars;
//   2. a second pass scans the per-lane counts within the group
//      (shuffles over segments of width G) and the lane that holds the
//      first or the past-the-end character reports its byte offset;
//   3. each lane writes its output word from two input words, funnel
//      shifted by the start byte, masked past the result's length.
// The second and third passes read the row again from L1.
//
// Bound on the H100: bytes.  The function reads each row's bytes up to
// its length, its length and validity (and pos/len columns), and writes
// the whole output row, its length and validity; the arithmetic per byte
// is a few integer operations.
#include <cstdint>
#include <cuda_runtime.h>

namespace srt_substr {

constexpr int kBlock = 256;

struct Args {
  const uint32_t* data;  // [n, nw] words
  const int32_t* lengths;
  const uint8_t* valid;
  const int64_t* pos;  // null: pos_scalar for every row
  const uint8_t* pos_valid;
  int64_t pos_scalar;
  const int64_t* len;  // null: len_scalar for every row
  const uint8_t* len_valid;
  int64_t len_scalar;
  int64_t n;
  int nw;  // words per row (W / 4)
  uint32_t* out;
  int32_t* out_len;
  uint8_t* out_valid;
};

// Bit k (k < 4) set when byte 4w + k of the row starts a character that
// lies inside the row's length.
__device__ __forceinline__ unsigned start_bits(uint32_t x, int w, int len) {
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t b = (x >> (8 * k)) & 0xFFu;
    if (4 * w + k < len && (b & 0xC0u) != 0x80u) bits |= 1u << k;
  }
  return bits;
}

// Index of the k-th (0-based) set bit of a 32-bit mask that has more
// than k set bits: a binary search over popcounts of its halves.
__device__ __forceinline__ int select_bit(unsigned mask, int k) {
  int pos = 0;
#pragma unroll
  for (int width = 16; width >= 1; width >>= 1) {
    const int c = __popc((mask >> pos) & ((1u << width) - 1u));
    if (k >= c) {
      k -= c;
      pos += width;
    }
  }
  return pos;
}

__device__ __forceinline__ int64_t sat_add(int64_t a, int64_t b) {
  if (b > 0 && a > INT64_MAX - b) return INT64_MAX;
  if (b < 0 && a < INT64_MIN - b) return INT64_MIN;
  return a + b;
}

template <int G>
__device__ __forceinline__ int group_sum(int v) {
#pragma unroll
  for (int d = G / 2; d >= 1; d >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, d, G);
  return v;
}

template <int G>
__device__ __forceinline__ int group_max(int v) {
#pragma unroll
  for (int d = G / 2; d >= 1; d >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, d, G));
  return v;
}

template <int G>
__global__ void __launch_bounds__(kBlock) substring_kernel(Args a) {
  const unsigned full = 0xffffffffu;
  const int sub = threadIdx.x & (G - 1);
  const int64_t rows_per_block = kBlock / G;
  const int chunks = a.nw / G;
  // the loop bound is uniform over the block, so every lane of a warp
  // takes part in each shuffle (lanes past the last row carry zeros)
  for (int64_t base = (int64_t)blockIdx.x * rows_per_block; base < a.n;
       base += (int64_t)gridDim.x * rows_per_block) {
    const int64_t row = base + threadIdx.x / G;
    const bool live = row < a.n;
    const uint32_t* src = a.data + (live ? row : 0) * a.nw;
    int len = 0;
    bool ok = false;
    int64_t p = a.pos_scalar, l = a.len_scalar;
    if (live) {
      len = a.lengths[row];
      ok = a.valid[row] != 0;
      if (a.pos != nullptr) {
        p = a.pos[row];
        ok = ok && a.pos_valid[row] != 0;
      }
      if (a.len != nullptr) {
        l = a.len[row];
        ok = ok && a.len_valid[row] != 0;
      }
    }
    // 1. numChars
    int cnt = 0;
    for (int c = 0; c < chunks; ++c) {
      const int w = c * G + sub;
      cnt += __popc(start_bits(live ? __ldg(src + w) : 0u, w, len));
    }
    const int64_t nchars = group_sum<G>(cnt);
    // resolve pos and len (UTF8String.substringSQL), in 64 bits
    int64_t start = p > 0 ? p - 1 : (p < 0 ? nchars + p : 0);
    const int64_t end = sat_add(start, l);
    start = start > 0 ? start : 0;
    const int64_t first = start < nchars ? start : nchars;
    const int64_t last = end < nchars ? end : nchars;
    const bool empty = !ok || start >= end || first >= last;
    // 2. byte offsets of the characters `first` and `last` (-1: none
    // found in this lane; `last` == nchars has none: the row's length)
    const int64_t kf = empty ? -1 : first;
    const int64_t kl = empty ? -1 : last;
    int sb = -1, eb = -1, carry = 0;
    for (int c = 0; c < chunks; ++c) {
      const int w = c * G + sub;
      const unsigned bits = start_bits(live ? __ldg(src + w) : 0u, w, len);
      const int pc = __popc(bits);
      int incl = pc;
#pragma unroll
      for (int d = 1; d < G; d <<= 1) {
        const int t = __shfl_up_sync(full, incl, d, G);
        if (sub >= d) incl += t;
      }
      const int excl = carry + incl - pc;
      if (kf >= excl && kf < excl + pc)
        sb = 4 * w + select_bit(bits, (int)(kf - excl));
      if (kl >= excl && kl < excl + pc)
        eb = 4 * w + select_bit(bits, (int)(kl - excl));
      carry += __shfl_sync(full, incl, G - 1, G);
    }
    sb = group_max<G>(sb);
    eb = group_max<G>(eb);
    if (eb < 0) eb = len;
    const int new_len = empty ? 0 : eb - sb;
    if (empty) sb = 0;
    // 3. the output row: bytes [sb, sb + new_len) first, zeros after
    const int q0 = sb >> 2, r = (sb & 3) * 8;
    for (int c = 0; c < chunks; ++c) {
      const int w = c * G + sub;
      const int keep = new_len - 4 * w;
      uint32_t v = 0;
      if (keep > 0) {
        const int q = q0 + w;
        const uint32_t lo = __ldg(src + q);
        const uint32_t hi = (r != 0 && q + 1 < a.nw) ? __ldg(src + q + 1) : 0u;
        v = r != 0 ? __funnelshift_r(lo, hi, r) : lo;
        if (keep < 4) v &= (1u << (8 * keep)) - 1u;
      }
      if (live) a.out[row * a.nw + w] = v;
    }
    if (live && sub == 0) {
      a.out_len[row] = new_len;
      a.out_valid[row] = ok ? 1 : 0;
    }
  }
}

template <int NW>
__device__ __forceinline__ void load_row(const uint32_t* p, uint32_t* w) {
  if constexpr (NW == 1) {
    w[0] = __ldg(p);
  } else if constexpr (NW == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x; w[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < NW; i += 4) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p + i));
      w[i] = v.x; w[i + 1] = v.y; w[i + 2] = v.z; w[i + 3] = v.w;
    }
  }
}

template <int NW>
__device__ __forceinline__ void store_row(uint32_t* p, const uint32_t* w) {
  if constexpr (NW == 1) {
    p[0] = w[0];
  } else if constexpr (NW == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int i = 0; i < NW; i += 4)
      *reinterpret_cast<uint4*>(p + i) =
          make_uint4(w[i], w[i + 1], w[i + 2], w[i + 3]);
  }
}

// Rows of at most 32 bytes (NW <= 8 words): one thread a row.  The row
// comes in as one or two vector loads, its starts make one 32-bit mask,
// the two characters are found by a select over popcounts, and the output
// words are funnel shifted from the row's words re-read from L1 (a
// dynamic index into the registers would spill them to local memory).
template <int NW>
__global__ void __launch_bounds__(kBlock) substring_row_kernel(Args a) {
  for (int64_t row = (int64_t)blockIdx.x * kBlock + threadIdx.x; row < a.n;
       row += (int64_t)gridDim.x * kBlock) {
    const uint32_t* src = a.data + row * NW;
    uint32_t w[NW];
    load_row<NW>(src, w);
    const int len = a.lengths[row];
    bool ok = a.valid[row] != 0;
    int64_t p = a.pos_scalar, l = a.len_scalar;
    if (a.pos != nullptr) {
      p = a.pos[row];
      ok = ok && a.pos_valid[row] != 0;
    }
    if (a.len != nullptr) {
      l = a.len[row];
      ok = ok && a.len_valid[row] != 0;
    }
    unsigned mask = 0;
#pragma unroll
    for (int i = 0; i < NW; ++i) mask |= start_bits(w[i], i, len) << (4 * i);
    const int64_t nchars = __popc(mask);
    int64_t start = p > 0 ? p - 1 : (p < 0 ? nchars + p : 0);
    const int64_t end = sat_add(start, l);
    start = start > 0 ? start : 0;
    const int64_t first = start < nchars ? start : nchars;
    const int64_t last = end < nchars ? end : nchars;
    const bool empty = !ok || start >= end || first >= last;
    int sb = 0, new_len = 0;
    if (!empty) {
      sb = select_bit(mask, (int)first);
      new_len = (last < nchars ? select_bit(mask, (int)last) : len) - sb;
    }
    const int q0 = sb >> 2, r = (sb & 3) * 8;
    uint32_t o[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int keep = new_len - 4 * i;
      uint32_t v = 0;
      if (keep > 0) {
        const int q = q0 + i;
        const uint32_t lo = __ldg(src + q);
        const uint32_t hi = (r != 0 && q + 1 < NW) ? __ldg(src + q + 1) : 0u;
        v = r != 0 ? __funnelshift_r(lo, hi, r) : lo;
        if (keep < 4) v &= (1u << (8 * keep)) - 1u;
      }
      o[i] = v;
    }
    store_row<NW>(a.out + row * NW, o);
    a.out_len[row] = new_len;
    a.out_valid[row] = ok ? 1 : 0;
  }
}

template <int NW>
void launch_rows(const Args& a, cudaStream_t stream) {
  int64_t blocks = (a.n + kBlock - 1) / kBlock;
  const int64_t cap = 132 * 16;
  if (blocks > cap) blocks = cap;
  substring_row_kernel<NW><<<(int)blocks, kBlock, 0, stream>>>(a);
}

template <int G>
void launch(const Args& a, cudaStream_t stream) {
  const int64_t rows_per_block = kBlock / G;
  int64_t blocks = (a.n + rows_per_block - 1) / rows_per_block;
  const int64_t cap = 132 * 16;
  if (blocks > cap) blocks = cap;
  substring_kernel<G><<<(int)blocks, kBlock, 0, stream>>>(a);
}

}  // namespace srt_substr

using namespace srt_substr;

extern "C" {

// out [n, W] uint8, out_len int32 [n], out_valid uint8 [n].  pos/len are
// int64 columns with validity, or null for the scalar beside them.  W is
// a multiple of 4 and data 16-byte aligned.
int srt_substring(const void* data, const void* lengths, const void* valid,
                  int64_t n, int width, const void* pos,
                  const void* pos_valid, int64_t pos_scalar, const void* len,
                  const void* len_valid, int64_t len_scalar, void* out,
                  void* out_len, void* out_valid, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (width < 4 || width % 4 != 0) return (int)cudaErrorInvalidValue;
  Args a;
  a.data = (const uint32_t*)data;
  a.lengths = (const int32_t*)lengths;
  a.valid = (const uint8_t*)valid;
  a.pos = (const int64_t*)pos;
  a.pos_valid = (const uint8_t*)pos_valid;
  a.pos_scalar = pos_scalar;
  a.len = (const int64_t*)len;
  a.len_valid = (const uint8_t*)len_valid;
  a.len_scalar = len_scalar;
  a.n = n;
  a.nw = width / 4;
  a.out = (uint32_t*)out;
  a.out_len = (int32_t*)out_len;
  a.out_valid = (uint8_t*)out_valid;
  cudaStream_t s = (cudaStream_t)stream;
  // a thread a row for the power-of-two widths up to 32 bytes
  switch (a.nw) {
    case 1: launch_rows<1>(a, s); return (int)cudaGetLastError();
    case 2: launch_rows<2>(a, s); return (int)cudaGetLastError();
    case 4: launch_rows<4>(a, s); return (int)cudaGetLastError();
    case 8: launch_rows<8>(a, s); return (int)cudaGetLastError();
    default: break;
  }
  // else G lanes a row: the largest power of two that divides W / 4, at
  // most 32 (W / 4 itself for the power-of-two widths 64 and 128)
  const int g = a.nw & -a.nw;
  switch (g >= 32 ? 32 : g) {
    case 1: launch<1>(a, s); break;
    case 2: launch<2>(a, s); break;
    case 4: launch<4>(a, s); break;
    case 8: launch<8>(a, s); break;
    case 16: launch<16>(a, s); break;
    default: launch<32>(a, s); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
