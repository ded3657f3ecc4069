// K13d: ASCII upper / lower case of a byte-matrix string column.
//
// Replaces spark_rapids_tpu/expr/strings.py:63 `Upper._device` and :76
// `Lower._device`, which XLA runs as a compare, a subtract and a select
// over the [n, W] matrix.  Only a-z (upper) or A-Z (lower) change, by
// 0x20; bytes >= 0x80 -- UTF-8 lead and continuation bytes -- and the
// zero tail pass unchanged, so lengths stay and the caller shares the
// input's lengths and validity.  Spark's Upper and Lower are Unicode;
// this is the reference's device branch, ASCII only.
//
// Design: a flat grid-stride pass over the matrix as 16-byte vectors
// (the rows are contiguous, so row edges do not matter), each 4-byte word
// mapped at once: with h = x & 0x7f7f7f7f, the high bit of each byte of
// h + (0x80 - lo) says h >= lo and that of h + (0x80 - hi - 1) says h >
// hi (no carry crosses a byte, since h <= 0x7f); masked by ~x (ASCII
// bytes only) and shifted down to 0x20, it is XORed in.  A tail of fewer
// than 16 bytes goes word by word.
//
// Bound on the H100: bytes (n * W read and n * W written).
#include <cstdint>
#include <cuda_runtime.h>

namespace srt_case {

constexpr int kBlock = 256;

__device__ __forceinline__ uint32_t map_word(uint32_t x, uint32_t lo_add,
                                             uint32_t hi_add) {
  const uint32_t h = x & 0x7f7f7f7fu;
  const uint32_t ge_lo = h + lo_add;
  const uint32_t gt_hi = h + hi_add;
  const uint32_t hit = ge_lo & ~gt_hi & ~x & 0x80808080u;
  return x ^ (hit >> 2);
}

__global__ void __launch_bounds__(kBlock) case_kernel(
    const uint4* __restrict__ in, uint4* __restrict__ out, int64_t nvec,
    const uint32_t* __restrict__ in_tail, uint32_t* __restrict__ out_tail,
    int ntail, uint32_t lo_add, uint32_t hi_add) {
  const int64_t stride = (int64_t)gridDim.x * kBlock;
  for (int64_t v = (int64_t)blockIdx.x * kBlock + threadIdx.x; v < nvec;
       v += stride) {
    uint4 x = __ldg(in + v);
    x.x = map_word(x.x, lo_add, hi_add);
    x.y = map_word(x.y, lo_add, hi_add);
    x.z = map_word(x.z, lo_add, hi_add);
    x.w = map_word(x.w, lo_add, hi_add);
    out[v] = x;
  }
  if (blockIdx.x == 0 && threadIdx.x < ntail)
    out_tail[threadIdx.x] = map_word(in_tail[threadIdx.x], lo_add, hi_add);
}

}  // namespace srt_case

using namespace srt_case;

extern "C" {

// in and out: nbytes bytes (a multiple of 4), 16-byte aligned; upper 1
// maps a-z to A-Z, 0 maps A-Z to a-z.
int srt_case_map(const void* in, void* out, int64_t nbytes, int upper,
                 void* stream) {
  if (nbytes <= 0) return (int)cudaGetLastError();
  if (nbytes % 4 != 0) return (int)cudaErrorInvalidValue;
  const uint32_t lo = upper ? 'a' : 'A', hi = upper ? 'z' : 'Z';
  const uint32_t lo_add = (0x80u - lo) * 0x01010101u;
  const uint32_t hi_add = (0x80u - hi - 1u) * 0x01010101u;
  const int64_t nvec = nbytes / 16;
  const int ntail = (int)((nbytes % 16) / 4);
  int64_t blocks = (nvec + kBlock - 1) / kBlock;
  const int64_t cap = 132 * 16;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  case_kernel<<<(int)blocks, kBlock, 0, (cudaStream_t)stream>>>(
      (const uint4*)in, (uint4*)out, nvec,
      (const uint32_t*)((const uint8_t*)in + nvec * 16),
      (uint32_t*)((uint8_t*)out + nvec * 16), ntail, lo_add, hi_add);
  return (int)cudaGetLastError();
}

}  // extern "C"
