// K1's order-preserving key encoding, one field at a time.
//
// A sort key column maps to a fixed sequence of unsigned bit fields whose
// concatenation, most significant first, orders rows exactly as the
// reference's stable lax.sort orders its operands (spark_rapids_tpu/ops/
// sort.py:83 `encode_key_operands`, with the null indicator in front):
//
//   field 0        the null indicator (1 bit): valid rows 1 under nulls
//                  first, 0 under nulls last;
//   ints/date/ts   the value with the sign bit flipped (8*item bits);
//   bool           the value (1 bit);
//   floats         a NaN flag (1 bit; NaN is the largest value), then the
//                  value with NaN and -0.0 mapped to +0.0, negated when
//                  descending, in the sign-flip float encoding (8*item bits);
//   strings        the byte matrix as big-endian 32-bit words at the packed
//                  width W (zero words past the matrix's width `item`), then
//                  the length (bit_length(W) bits).
//
// Descending keys store the complement of each field (W - length for the
// length).  K1 (sort.cu: its plan kernel reduces each field's OR and AND,
// its encode kernel packs the bits that vary into words) and K11's
// comparison of rows with range bounds (range_partition.cu, which compares
// field by field) read the fields from key_field() below, so the two
// orders cannot drift apart.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace srt {

enum KeyKind { kInt = 0, kFloat = 1, kBool = 2, kString = 3 };

// One key column, as 64-bit words so that a host array of descriptors has
// the same layout on the card (csrc/range_partition.cu reads them from
// kernel parameters or from a device copy).  item: bytes a row (the
// matrix width for strings, any value); width: the packed string width W
// (a multiple of 4, >= item rounded up to 4), ignored for other kinds.
struct SortKey {
  long long data, valid, lens;
  long long kind, item, width, asc, nulls_first;
};

__host__ __device__ __forceinline__ int key_bit_length(int w) {
  int b = 0;
  while (w > 0) {
    ++b;
    w >>= 1;
  }
  return b;
}

// Number of fields of a key, the null indicator included.
__host__ __device__ __forceinline__ int key_nfields(int kind, int width) {
  return kind == kString ? 2 + width / 4 : (kind == kFloat ? 3 : 2);
}

__device__ __forceinline__ unsigned long long low_bits(unsigned long long v,
                                                       int bits) {
  return bits < 64 ? v & ((1ull << bits) - 1ull) : v;
}

// The ways string_word reads a matrix: decided on each call (kWordsAny),
// or fixed by a caller that checked once for a whole loop: a 4-byte
// aligned matrix of a width divisible by 4 a word at a time
// (kWordsAligned), any other one a byte at a time (kWordsBytes).
enum WordPath { kWordsAny = 0, kWordsAligned = 1, kWordsBytes = 2 };

__device__ __forceinline__ bool words_aligned(const void* data, int item) {
  return (item & 3) == 0 && (reinterpret_cast<uintptr_t>(data) & 3) == 0;
}

// Big-endian 32-bit word w of string row `row` (bytes past `item` read as
// zero).  A 4-byte aligned matrix of a width divisible by 4 is read a word
// at a time (a load under a predicate, so that a caller's loop over rows
// keeps its loads in flight together), any other one a byte at a time.
template <int kWords = kWordsAny>
__device__ __forceinline__ uint32_t string_word(const uint8_t* data,
                                                int64_t row, int item,
                                                int w) {
  const int col = 4 * w;
  const uint8_t* p = data + row * item + col;
  if (kWords == kWordsAligned ||
      (kWords == kWordsAny && words_aligned(data, item)))
    return col < item
               ? __byte_perm(*reinterpret_cast<const uint32_t*>(p), 0, 0x0123)
               : 0u;
  if (col >= item) return 0u;
  uint32_t x = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    x = (x << 8) | (col + b < item ? (uint32_t)p[b] : 0u);
  return x;
}

// Which field of a string key a caller asks for, where it knows: any
// (decided from f), a word (f >= 1, a string key), or the length.
enum StringField { kStrAny = 0, kStrWord = 1, kStrLength = 2 };

// Field f (0 = most significant) of key `k` at row `row`, masked to its
// width, which is stored in *bits.  kWords: how a string key's matrix is
// read (string_word); kStr: a string field known at compile time, so that
// a loop over rows runs no branch between the word and the length.  The
// value is the same every way.
template <int kWords = kWordsAny, int kStr = kStrAny>
__device__ __forceinline__ unsigned long long key_field(const SortKey& k,
                                                        int64_t row, int f,
                                                        int* bits) {
  const int kind = kStr != kStrAny ? (int)kString : (int)k.kind;
  const bool asc = k.asc != 0;
  if (kStr == kStrAny && f == 0) {
    *bits = 1;
    const bool v = reinterpret_cast<const uint8_t*>(k.valid)[row] != 0;
    return v == (k.nulls_first != 0) ? 1ull : 0ull;
  }
  const int item = (int)k.item;
  const void* data = reinterpret_cast<const void*>(k.data);
  if (kind == kString) {
    const int width = (int)k.width;
    if (kStr == kStrWord || (kStr == kStrAny && f <= width / 4)) {
      *bits = 32;
      uint32_t x = string_word<kWords>(static_cast<const uint8_t*>(data),
                                       row, item, f - 1);
      return asc ? x : (uint32_t)~x;
    }
    const int lb = width > 0 ? 32 - __clz(width) : 0;  // key_bit_length
    *bits = lb;
    const int32_t len = reinterpret_cast<const int32_t*>(k.lens)[row];
    return (unsigned long long)(asc ? len : width - len);
  }
  if (kind == kInt) {
    long long v;
    switch (item) {
      case 1: v = static_cast<const int8_t*>(data)[row]; break;
      case 2: v = static_cast<const int16_t*>(data)[row]; break;
      case 4: v = static_cast<const int32_t*>(data)[row]; break;
      default: v = static_cast<const long long*>(data)[row]; break;
    }
    const int b = 8 * item;
    *bits = b;
    unsigned long long u = (unsigned long long)v ^ (1ull << (b - 1));
    return low_bits(asc ? u : ~u, b);
  }
  if (kind == kBool) {
    *bits = 1;
    const unsigned long long b = static_cast<const uint8_t*>(data)[row] != 0;
    return asc ? b : 1ull - b;
  }
  // kFloat: f == 1 the NaN flag, f == 2 the value
  bool is_nan;
  unsigned long long key;
  if (item == 4) {
    float x = static_cast<const float*>(data)[row];
    is_nan = x != x;
    if (is_nan || x == 0.0f) x = 0.0f;
    if (!asc) x = -x;
    if (x == 0.0f) x = 0.0f;
    const uint32_t b = __float_as_uint(x);
    key = (b & 0x80000000u) ? (uint32_t)~b : (b | 0x80000000u);
  } else {
    double x = static_cast<const double*>(data)[row];
    is_nan = x != x;
    if (is_nan || x == 0.0) x = 0.0;
    if (!asc) x = -x;
    if (x == 0.0) x = 0.0;
    const unsigned long long b = (unsigned long long)__double_as_longlong(x);
    key = (b & 0x8000000000000000ull) ? ~b : (b | 0x8000000000000000ull);
  }
  if (f == 1) {
    *bits = 1;
    return asc == is_nan ? 1ull : 0ull;
  }
  *bits = 8 * item;
  return key;
}

}  // namespace srt
