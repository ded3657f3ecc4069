// K13e-h: trims, Length, StringLocate and SubstringIndex over byte-matrix
// strings.
//
// Replaces, in spark_rapids_tpu/expr/strings.py:
//   * K13e, :91-123 `_TrimBase._device` (StringTrim, StringTrimLeft,
//     StringTrimRight): a non-space mask, two argmax searches and a
//     take_along_axis shift of the whole [n, W] matrix;
//   * K13f, :126-145 `Length` over `_char_starts` (:29-33): a sum of the
//     [n, W] character-start mask;
//   * K13g, :539-570 the device branch of `StringLocate._eval`: one [n, W]
//     gather and compare per needle byte, a cumsum of the start mask and
//     an argmax;
//   * K13h, :612-646 the device branch of `SubstringIndex._eval` (one-byte
//     delimiters, `device_supported` :592-594): a cumsum of the delimiter
//     mask, an argmax and a take_along_axis shift.
//
// Semantics are the reference's device branches.  A byte inside the row's
// length starts a character when (b & 0xC0) != 0x80.  Trims remove spaces
// (0x20) only.  locate gives the 1-based character position of the first
// match that begins on a character start at or after character start - 1,
// 0 when there is none or start < 1; an empty needle gives start when
// start - 1 <= the character count, else 0.  substring_index keeps the
// bytes before the count-th delimiter (count > 0; the whole row when there
// are fewer), the bytes after the (ndelim + count + 1)-th one (count < 0;
// the whole row when that is not positive), or nothing (count == 0).  A
// null row has length 0 and zero bytes, and stays so.
//
// Design: one thread per row.  The row is read as 16-byte vectors when W
// is a multiple of 16 (the wrapper hands 16-byte-aligned data), else as
// 4-byte words, and only the vectors that hold bytes of the row's length.
// Each 4-byte word is tested for spaces, delimiters or character starts
// four bytes at a time with the byte-SIMD compares (__vcmpne4,
// __vcmpeq4) and popcounts.  The trims and substring_index find the first
// byte and the length of the result, then write every word of the output
// row from two input words funnel-shifted by the first byte, masked past
// the result's length: output width = input width, zeros after the
// result, as the reference keeps it.  locate compares the needle byte by
// byte at each character start (a naive search; the needle is one row for
// a literal, read by every thread, or the row's own for a column).
//
// Bound on the H100: bytes.  Each function must read each row's bytes up
// to its length (locate: at most the whole row), its length and validity,
// and write the output row, its length (or the int32 result) and, for
// locate, the validity; a few integer operations a byte.
#include <cstdint>
#include <cuda_runtime.h>

namespace srt_funcs {

constexpr int kBlock = 256;
constexpr uint32_t kSpaces = 0x20202020u;

inline int grid_for(int64_t n) {
  const int64_t blocks = (n + kBlock - 1) / kBlock;
  const int64_t cap = 132 * 16;
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

// 0xFF in each byte of word k that lies inside the first len bytes.
__device__ __forceinline__ uint32_t len_mask(int k, int len) {
  const int r = len - 4 * k;
  return r >= 4 ? 0xFFFFFFFFu : (r <= 0 ? 0u : 0xFFFFFFFFu >> (32 - 8 * r));
}

// Chunk c of a row: V words (V = 4: one 16-byte vector).
template <int V>
__device__ __forceinline__ void load_chunk(const uint32_t* row, int c,
                                           uint32_t (&x)[V]) {
  if constexpr (V == 4) {
    const uint4 v = reinterpret_cast<const uint4*>(row)[c];
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = row[c];
  }
}

// Byte index (0..3) of the k-th (0-based) marked byte of a byte mask
// (0xFF or 0 in each byte).
__device__ __forceinline__ int nth_byte(uint32_t m, int k) {
  m &= 0x80808080u;  // one bit a marked byte
  for (; k > 0; --k) m &= m - 1u;
  return (__ffs(m) - 1) >> 3;
}

// Count of the character starts among the first len bytes of a row.
template <int V>
__device__ __forceinline__ int count_starts(const uint32_t* row, int len) {
  int cnt = 0;
  const int chunks = (len + 4 * V - 1) / (4 * V);
  for (int c = 0; c < chunks; ++c) {
    uint32_t x[V];
    load_chunk<V>(row, c, x);
#pragma unroll
    for (int q = 0; q < V; ++q)
      cnt += __popc(__vcmpne4(x[q] & 0xC0C0C0C0u, 0x80808080u) &
                    len_mask(c * V + q, len)) >> 3;
  }
  return cnt;
}

// out[0 .. nw) = bytes [first, first + new_len) of src, zeros after them.
template <int V>
__device__ __forceinline__ void write_shifted(const uint32_t* src,
                                              uint32_t* out, int nw,
                                              int first, int new_len) {
  const int sh = 8 * (first & 3);
  const int w0 = first >> 2;
  for (int c = 0; c < nw / V; ++c) {
    uint32_t y[V];
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const int k = c * V + q;
      const uint32_t m = len_mask(k, new_len);
      uint32_t v = 0;
      if (m != 0) {  // then word w0 + k lies inside the row
        const uint32_t lo = src[w0 + k];
        const uint32_t hi = w0 + k + 1 < nw ? src[w0 + k + 1] : 0u;
        v = __funnelshift_r(lo, hi, sh) & m;
      }
      y[q] = v;
    }
    if constexpr (V == 4)
      reinterpret_cast<uint4*>(out)[c] = make_uint4(y[0], y[1], y[2], y[3]);
    else
      out[c] = y[0];
  }
}

struct SliceArgs {
  const uint32_t* data;  // [n, nw] words
  const int32_t* lengths;
  const uint8_t* valid;
  int64_t n;
  int nw;
  int mode;         // trims: bit 0 left, bit 1 right; 0: substring_index
  uint32_t delim4;  // substring_index: the delimiter byte in every byte
  int count;
  uint32_t* out;
  int32_t* out_len;
};

// (first byte, length) of the trimmed row.
template <int V>
__device__ __forceinline__ void trim_span(const uint32_t* src, int len,
                                          int mode, int& first,
                                          int& new_len) {
  int lo = -1, hi = -1;
  const int chunks = (len + 4 * V - 1) / (4 * V);
  for (int c = 0; c < chunks; ++c) {
    uint32_t x[V];
    load_chunk<V>(src, c, x);
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const int k = c * V + q;
      const uint32_t ns = __vcmpne4(x[q], kSpaces) & len_mask(k, len);
      if (ns != 0) {
        if (lo < 0) lo = 4 * k + ((__ffs(ns) - 1) >> 3);
        hi = 4 * k + ((31 - __clz(ns)) >> 3);
      }
    }
  }
  first = 0;
  new_len = 0;
  if (lo >= 0) {  // some byte is not a space
    first = (mode & 1) ? lo : 0;
    const int last = (mode & 2) ? hi : len - 1;
    new_len = last - first + 1;
  }
}

// Byte position of the k-th (0-based) delimiter inside len, -1 if none.
template <int V>
__device__ __forceinline__ int find_delim(const uint32_t* src, int len,
                                          uint32_t d4, long long k) {
  const int chunks = (len + 4 * V - 1) / (4 * V);
  for (int c = 0; c < chunks; ++c) {
    uint32_t x[V];
    load_chunk<V>(src, c, x);
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const int w = c * V + q;
      const uint32_t dm = __vcmpeq4(x[q], d4) & len_mask(w, len);
      const int cnt = __popc(dm) >> 3;
      if (k < cnt) return 4 * w + nth_byte(dm, (int)k);
      k -= cnt;
    }
  }
  return -1;
}

template <int V>
__device__ __forceinline__ int count_delims(const uint32_t* src, int len,
                                            uint32_t d4) {
  int cnt = 0;
  const int chunks = (len + 4 * V - 1) / (4 * V);
  for (int c = 0; c < chunks; ++c) {
    uint32_t x[V];
    load_chunk<V>(src, c, x);
#pragma unroll
    for (int q = 0; q < V; ++q)
      cnt += __popc(__vcmpeq4(x[q], d4) & len_mask(c * V + q, len)) >> 3;
  }
  return cnt;
}

template <int V>
__global__ void __launch_bounds__(kBlock) slice_kernel(SliceArgs a) {
  for (int64_t row = (int64_t)blockIdx.x * kBlock + threadIdx.x; row < a.n;
       row += (int64_t)gridDim.x * kBlock) {
    const uint32_t* src = a.data + row * a.nw;
    const int len = a.valid[row] ? a.lengths[row] : 0;
    int first = 0, new_len = 0;
    if (a.mode != 0) {
      trim_span<V>(src, len, a.mode, first, new_len);
    } else if (a.count > 0) {
      const int p = find_delim<V>(src, len, a.delim4, a.count - 1);
      new_len = p >= 0 ? p : len;
    } else if (a.count < 0) {
      const long long k =
          (long long)count_delims<V>(src, len, a.delim4) + a.count + 1;
      if (k > 0) first = find_delim<V>(src, len, a.delim4, k - 1) + 1;
      new_len = len - first;
    }
    write_shifted<V>(src, a.out + row * a.nw, a.nw, first, new_len);
    a.out_len[row] = new_len;
  }
}

template <int V>
__global__ void __launch_bounds__(kBlock) length_kernel(
    const uint32_t* __restrict__ data, const int32_t* __restrict__ lengths,
    const uint8_t* __restrict__ valid, int64_t n, int nw,
    int32_t* __restrict__ out) {
  for (int64_t row = (int64_t)blockIdx.x * kBlock + threadIdx.x; row < n;
       row += (int64_t)gridDim.x * kBlock) {
    const int len = valid[row] ? lengths[row] : 0;
    out[row] = count_starts<V>(data + row * nw, len);
  }
}

struct LocateArgs {
  const uint32_t* data;
  const int32_t* lengths;
  const uint8_t* valid;
  int64_t n;
  int nw;
  const uint8_t* needle;  // [1 or n, wn]
  const int32_t* needle_len;
  const uint8_t* needle_valid;
  int needle_is_col;
  int wn;
  int start;
  int32_t* out;
  uint8_t* out_valid;
};

template <int V>
__global__ void __launch_bounds__(kBlock) locate_kernel(LocateArgs a) {
  for (int64_t row = (int64_t)blockIdx.x * kBlock + threadIdx.x; row < a.n;
       row += (int64_t)gridDim.x * kBlock) {
    const int64_t nr = a.needle_is_col ? row : 0;
    const bool ok = a.valid[row] != 0 && a.needle_valid[nr] != 0;
    a.out_valid[row] = ok ? 1 : 0;
    int res = 0;
    if (ok && a.start >= 1) {
      const uint32_t* src = a.data + row * a.nw;
      const int len = a.lengths[row];
      const int nlen = a.needle_len[nr];
      if (nlen == 0) {
        res = a.start - 1 <= count_starts<V>(src, len) ? a.start : 0;
      } else {
        const uint8_t* s = reinterpret_cast<const uint8_t*>(src);
        const uint8_t* nd = a.needle + nr * a.wn;
        const uint8_t n0 = nd[0];
        int c = 0;  // character index of byte j (starts before it)
        for (int j = 0; j + nlen <= len; ++j) {
          const uint8_t b = s[j];
          if ((b & 0xC0) == 0x80) continue;
          if (c >= a.start - 1 && b == n0) {
            int k = 1;
            while (k < nlen && s[j + k] == nd[k]) ++k;
            if (k == nlen) {
              res = c + 1;
              break;
            }
          }
          ++c;
        }
      }
    }
    a.out[row] = res;
  }
}

}  // namespace srt_funcs

using namespace srt_funcs;

extern "C" {

// K13e: mode bit 0 trims the left end, bit 1 the right end.  data uint8
// [n, w] (w a multiple of 4; of 16: 16-byte aligned), out the same shape.
int srt_trim(const void* data, const void* lengths, const void* valid,
             int64_t n, int w, int mode, void* out, void* out_len,
             void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (w <= 0 || w % 4 || mode < 1 || mode > 3)
    return (int)cudaErrorInvalidValue;
  SliceArgs a = {(const uint32_t*)data, (const int32_t*)lengths,
                 (const uint8_t*)valid, n, w / 4, mode, 0u, 0,
                 (uint32_t*)out, (int32_t*)out_len};
  cudaStream_t st = (cudaStream_t)stream;
  if (w % 16 == 0)
    slice_kernel<4><<<grid_for(n), kBlock, 0, st>>>(a);
  else
    slice_kernel<1><<<grid_for(n), kBlock, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// K13h: delim a byte (0..255), count any int.
int srt_substring_index(const void* data, const void* lengths,
                        const void* valid, int64_t n, int w, int delim,
                        int count, void* out, void* out_len, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (w <= 0 || w % 4 || delim < 0 || delim > 255)
    return (int)cudaErrorInvalidValue;
  SliceArgs a = {(const uint32_t*)data, (const int32_t*)lengths,
                 (const uint8_t*)valid, n, w / 4, 0,
                 (uint32_t)delim * 0x01010101u, count, (uint32_t*)out,
                 (int32_t*)out_len};
  cudaStream_t st = (cudaStream_t)stream;
  if (w % 16 == 0)
    slice_kernel<4><<<grid_for(n), kBlock, 0, st>>>(a);
  else
    slice_kernel<1><<<grid_for(n), kBlock, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// K13f: out int32 [n].
int srt_char_length(const void* data, const void* lengths, const void* valid,
                    int64_t n, int w, void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (w <= 0 || w % 4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (w % 16 == 0)
    length_kernel<4><<<grid_for(n), kBlock, 0, st>>>(
        (const uint32_t*)data, (const int32_t*)lengths,
        (const uint8_t*)valid, n, w / 4, (int32_t*)out);
  else
    length_kernel<1><<<grid_for(n), kBlock, 0, st>>>(
        (const uint32_t*)data, (const int32_t*)lengths,
        (const uint8_t*)valid, n, w / 4, (int32_t*)out);
  return (int)cudaGetLastError();
}

// K13g: needle uint8 [needle_is_col ? n : 1, wn]; out int32 [n] and
// out_valid [n] (the two validities and-ed).
int srt_locate(const void* data, const void* lengths, const void* valid,
               int64_t n, int w, const void* needle, const void* needle_len,
               const void* needle_valid, int needle_is_col, int wn,
               int start, void* out, void* out_valid, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (w <= 0 || w % 4 || wn <= 0) return (int)cudaErrorInvalidValue;
  LocateArgs a = {(const uint32_t*)data, (const int32_t*)lengths,
                  (const uint8_t*)valid, n, w / 4, (const uint8_t*)needle,
                  (const int32_t*)needle_len, (const uint8_t*)needle_valid,
                  needle_is_col, wn, start, (int32_t*)out,
                  (uint8_t*)out_valid};
  cudaStream_t st = (cudaStream_t)stream;
  if (w % 16 == 0)
    locate_kernel<4><<<grid_for(n), kBlock, 0, st>>>(a);
  else
    locate_kernel<1><<<grid_for(n), kBlock, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
