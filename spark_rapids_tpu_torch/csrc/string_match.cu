// K13b: match a needle against every row of a byte-matrix string column.
//
// Replaces the device branches of spark_rapids_tpu/expr/strings.py:294
// StartsWith, :310 EndsWith, :329 Contains and :404 `Like._eval` (whose
// %-only patterns reduce to those three and to `_string_eq`,
// expr/predicates.py:58).  XLA runs them as [n, W] byte compares; Contains
// as one gathered [n, W] compare per start offset (W of them).
//
// Semantics, over the bytes inside each row's length la and the needle's
// length lb: prefix and suffix compare lb bytes at the row's start or end
// and need la >= lb; contains tries every offset s with s + lb <= la;
// equals needs la == lb and equal bytes.  An empty needle matches every
// valid row (in equals mode only the empty row).  A needle longer than
// the row never matches, and no byte past either length is read, so a
// needle wider than the column's W is safe.  A null row or needle gives
// false with validity false.
//
// Design: one thread per row, grid-stride.  The needle is one row read by
// every thread (a literal, served from L1 as a broadcast) or the row's
// own (a column).  Prefix and equals compare aligned 4-byte words, the
// last one masked; suffix and contains compare bytes (their offsets are
// not aligned), contains stopping at the first hit.
//
// Bound on the H100: bytes.  The function reads the row bytes it compares
// (the first sector of each row for a short prefix), the lengths and
// validities, and writes two bytes a row.
#include <cstdint>
#include <cuda_runtime.h>

namespace srt_match {

constexpr int kBlock = 256;
enum Mode { kPrefix = 0, kSuffix = 1, kContains = 2, kEquals = 3 };

// a[0, k) == b[0, k) for 4-byte aligned a and b, word by word.
__device__ __forceinline__ bool eq_words(const uint8_t* a, const uint8_t* b,
                                         int k) {
  const uint32_t* aw = reinterpret_cast<const uint32_t*>(a);
  const uint32_t* bw = reinterpret_cast<const uint32_t*>(b);
  const int full = k >> 2;
  for (int i = 0; i < full; ++i)
    if (__ldg(aw + i) != __ldg(bw + i)) return false;
  const int tail = k & 3;
  if (tail == 0) return true;
  const uint32_t mask = (1u << (8 * tail)) - 1u;
  return ((__ldg(aw + full) ^ __ldg(bw + full)) & mask) == 0;
}

__device__ __forceinline__ bool eq_bytes(const uint8_t* a, const uint8_t* b,
                                         int k) {
  for (int i = 0; i < k; ++i)
    if (__ldg(a + i) != __ldg(b + i)) return false;
  return true;
}

__global__ void __launch_bounds__(kBlock) match_kernel(
    int mode, const uint8_t* __restrict__ a, const int32_t* __restrict__ la,
    const uint8_t* __restrict__ va, int64_t n, int wa,
    const uint8_t* __restrict__ b, const int32_t* __restrict__ lb,
    const uint8_t* __restrict__ vb, int b_per_row, int wb,
    uint8_t* __restrict__ out, uint8_t* __restrict__ out_valid) {
  for (int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kBlock) {
    const int64_t bi = b_per_row ? i : 0;
    const bool ok = va[i] != 0 && vb[bi] != 0;
    bool m = false;
    if (ok) {
      const uint8_t* ar = a + i * wa;
      const uint8_t* br = b + bi * wb;
      const int x = la[i], y = lb[bi];
      switch (mode) {
        case kPrefix: m = y <= x && eq_words(ar, br, y); break;
        case kSuffix: m = y <= x && eq_bytes(ar + (x - y), br, y); break;
        case kEquals: m = y == x && eq_words(ar, br, y); break;
        default:
          for (int s = 0; s + y <= x && !m; ++s) m = eq_bytes(ar + s, br, y);
          break;
      }
    }
    out[i] = m ? 1 : 0;
    out_valid[i] = ok ? 1 : 0;
  }
}

}  // namespace srt_match

using namespace srt_match;

extern "C" {

// out and out_valid: uint8 [n].  The needle is b [1, wb] (b_per_row 0) or
// [n, wb] (b_per_row 1); wa and wb are multiples of 4, a and b 16-byte
// aligned.
int srt_string_match(int mode, const void* a, const void* la, const void* va,
                     int64_t n, int wa, const void* b, const void* lb,
                     const void* vb, int b_per_row, int wb, void* out,
                     void* out_valid, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (mode < kPrefix || mode > kEquals || wa % 4 != 0 || wb % 4 != 0)
    return (int)cudaErrorInvalidValue;
  int64_t blocks = (n + kBlock - 1) / kBlock;
  const int64_t cap = 132 * 16;
  if (blocks > cap) blocks = cap;
  match_kernel<<<(int)blocks, kBlock, 0, (cudaStream_t)stream>>>(
      mode, (const uint8_t*)a, (const int32_t*)la, (const uint8_t*)va, n, wa,
      (const uint8_t*)b, (const int32_t*)lb, (const uint8_t*)vb, b_per_row,
      wb, (uint8_t*)out, (uint8_t*)out_valid);
  return (int)cudaGetLastError();
}

}  // extern "C"
