// K13i: hex(long) -- upper-case hexadecimal of an int64 column.
//
// Replaces spark_rapids_tpu/expr/strings.py:756-803 `Hex._eval` (its device
// branch, :781-803), which XLA runs as a [n, 16] nibble matrix, an argmax
// for the first non-zero nibble and a take_along_axis shift to the front.
// Spark's Hex: the two's complement bits, most significant nibble first,
// leading zero nibbles dropped ("0" for 0), so a negative value has 16
// digits.  The result is the column contract's W 16 byte matrix, int32
// lengths and the input's validity; bytes past a row's length, and null
// rows, are zero (the reference repeats the last digit past the length).
//
// Design: one thread a row.  The digit count is
// n = max(1, (64 - clz(v) + 3) / 4); digit j (0 <= j < n) is nibble
// n - 1 - j from the bottom.  The thread assembles the row as four
// little-endian words and writes them with one 16-byte store.
//
// Bound on the H100: bytes (8 B read, 1 B validity read, 16 B + 4 B
// written a row).
#include <cstdint>
#include <cuda_runtime.h>

namespace srt_hexfmt {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock) hex_kernel(
    const long long* __restrict__ in, const uint8_t* __restrict__ valid,
    uint4* __restrict__ out, int32_t* __restrict__ out_len, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  int len = 0;
  if (valid[i]) {
    const unsigned long long v = (unsigned long long)in[i];
    len = v == 0ull ? 1 : (64 - __clzll((long long)v) + 3) >> 2;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j < len) {
        const uint32_t nib = (uint32_t)(v >> (4 * (len - 1 - j))) & 0xFu;
        const uint32_t ch = nib < 10u ? nib + 48u : nib + 55u;
        w[j >> 2] |= ch << (8 * (j & 3));
      }
    }
  }
  out[i] = make_uint4(w[0], w[1], w[2], w[3]);
  out_len[i] = len;
}

}  // namespace srt_hexfmt

using namespace srt_hexfmt;

extern "C" {

// in: int64[n]; valid: uint8[n]; out: uint8[n, 16] (16-byte aligned);
// out_len: int32[n].
int srt_hex(const void* in, const void* valid, void* out, void* out_len,
            int64_t n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int64_t blocks = (n + kBlock - 1) / kBlock;
  hex_kernel<<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(
      (const long long*)in, (const uint8_t*)valid, (uint4*)out,
      (int32_t*)out_len, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
