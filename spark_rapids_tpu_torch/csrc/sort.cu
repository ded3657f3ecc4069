// K1: stable multi-key sort permutation, as an LSD radix sort.
//
// Replaces spark_rapids_tpu/ops/sort.py:105 `sort_permutation` (with
// `encode_key_operands` :83 and `string_key_words` :72), which XLA runs as
// one stable multi-operand lax.sort over, per key column, a null indicator
// and the encoded key words.
//
// Design:
//   * encode_kernel packs each key column's order-preserving bit fields
//     (sort_key.cuh key_field: the null indicator, then the value's
//     fields; strings at a packed width W that may exceed the matrix's, so
//     that two batches of different widths pack comparably), most
//     significant key first, into one wide integer per row, stored as
//     64-bit limbs (limb-major, limb 0 least significant).  The order of
//     the packed integer is exactly the lexicographic order lax.sort
//     applies to the reference's operands.  Hopper has native 64-bit
//     bitcasts, so none of the TPU workarounds of ops/sort.py:20-22 are
//     needed.
//   * or_and_kernel reduces each limb to the OR and AND of all rows; the
//     wrapper reads them once and sorts only the 8-bit digits whose bits
//     vary (q1's two one-letter keys need four of the nine digits).
//   * per varying digit, from the least significant limb and digit up:
//     radix_hist_kernel counts the digit per tile, scan_exclusive_kernel
//     turns the digit-major counts into output offsets, and
//     radix_scatter_kernel moves (key, row index) pairs stably: each warp
//     owns 512 consecutive rows of the tile, ranks equal digits with
//     __match_any_sync, and the per-warp counts are scanned in warp order,
//     so equal digits keep their input order.
//   * a later limb is first gathered by the permutation so far.
//
// Bound on the H100: bytes.  Each varying digit pass reads and writes 12
// bytes a row (key and index) and the scatter is random within 256 runs; the
// encode reads each key column once and writes 8 bytes a row per limb.
#include "common.cuh"
#include "sort_key.cuh"

namespace srt_sort {

using namespace srt;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = kTile / kWarps;

__device__ __forceinline__ void put_bits(unsigned long long* limbs, int64_t n,
                                         int64_t row, unsigned long long v,
                                         int bits, int pos) {
  if (bits < 64) v &= (1ull << bits) - 1ull;
  const int l = pos >> 6;
  const int sh = pos & 63;
  limbs[(int64_t)l * n + row] |= v << sh;
  if (sh + bits > 64) limbs[(int64_t)(l + 1) * n + row] |= v >> (64 - sh);
}

// OR one key column's fields (sort_key.cuh key_field) into the limbs, the
// least significant field at bit pos0.
__global__ void encode_kernel(const SortKey k, int pos0,
                              unsigned long long* __restrict__ limbs,
                              int64_t n) {
  const int nf = key_nfields((int)k.kind, (int)k.width);
  for (int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; row < n;
       row += (int64_t)gridDim.x * blockDim.x) {
    int pos = pos0;
    for (int f = nf - 1; f >= 0; --f) {
      int bits;
      const unsigned long long v = key_field(k, row, f, &bits);
      put_bits(limbs, n, row, v, bits, pos);
      pos += bits;
    }
  }
}

__device__ __forceinline__ unsigned long long warp_or(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) v |= __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ unsigned long long warp_and(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) v &= __shfl_xor_sync(kFull, v, o);
  return v;
}

// out[2l] |= OR of limb l, out[2l+1] &= AND of limb l.
__global__ void or_and_kernel(const unsigned long long* __restrict__ limbs,
                              int64_t n, int nlimbs,
                              unsigned long long* __restrict__ out) {
  for (int l = 0; l < nlimbs; ++l) {
    unsigned long long o = 0ull, a = ~0ull;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
      const unsigned long long k = limbs[(int64_t)l * n + i];
      o |= k;
      a &= k;
    }
    o = warp_or(o);
    a = warp_and(a);
    if ((threadIdx.x & 31) == 0) {
      atomicOr(&out[2 * l], o);
      atomicAnd(&out[2 * l + 1], a);
    }
  }
}

__global__ void iota_kernel(int32_t* __restrict__ out, int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    out[i] = (int32_t)i;
}

__global__ void gather_u64_kernel(const unsigned long long* __restrict__ src,
                                  const int32_t* __restrict__ idx,
                                  unsigned long long* __restrict__ dst,
                                  int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    dst[i] = src[idx[i]];
}

// counts[d * ntiles + t] = rows of tile t whose digit is d.
__global__ void radix_hist_kernel(const unsigned long long* __restrict__ keys,
                                  int64_t n, int shift,
                                  int32_t* __restrict__ counts, int ntiles) {
  __shared__ int sh[256];
  for (int d = threadIdx.x; d < 256; d += blockDim.x) sh[d] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t base = (int64_t)blockIdx.x * kTile;
#pragma unroll 4
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + (int64_t)k * kThreads + threadIdx.x;
    const bool act = i < n;
    const unsigned amask = __ballot_sync(kFull, act);
    if (act) {
      const unsigned d = (unsigned)(keys[i] >> shift) & 0xffu;
      const unsigned peers = __match_any_sync(amask, d);
      if (lane == __ffs(peers) - 1) atomicAdd(&sh[d], __popc(peers));
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < 256; d += blockDim.x)
    counts[(int64_t)d * ntiles + blockIdx.x] = sh[d];
}

__global__ void radix_scatter_kernel(
    const unsigned long long* __restrict__ keys_in,
    const int32_t* __restrict__ vals_in, unsigned long long* __restrict__ keys_out,
    int32_t* __restrict__ vals_out, int64_t n, int shift,
    const int32_t* __restrict__ offsets, int ntiles) {
  __shared__ int s_cnt[kWarps][256];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  for (int i = threadIdx.x; i < kWarps * 256; i += blockDim.x)
    (&s_cnt[0][0])[i] = 0;
  __syncthreads();
  const int64_t wbase = (int64_t)blockIdx.x * kTile + (int64_t)warp * kWarpRows;
  // per-warp digit counts over the warp's own rows
  for (int j = 0; j < kWarpRows; j += 32) {
    const int64_t i = wbase + j + lane;
    const bool act = i < n;
    const unsigned amask = __ballot_sync(kFull, act);
    if (act) {
      const unsigned d = (unsigned)(keys_in[i] >> shift) & 0xffu;
      const unsigned peers = __match_any_sync(amask, d);
      if (lane == __ffs(peers) - 1) s_cnt[warp][d] += __popc(peers);
    }
  }
  __syncthreads();
  // warp-order exclusive scan per digit, on top of the tile's offset
  for (int d = threadIdx.x; d < 256; d += blockDim.x) {
    int run = offsets[(int64_t)d * ntiles + blockIdx.x];
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_cnt[w][d];
      s_cnt[w][d] = run;
      run += c;
    }
  }
  __syncthreads();
  for (int j = 0; j < kWarpRows; j += 32) {
    const int64_t i = wbase + j + lane;
    const bool act = i < n;
    const unsigned amask = __ballot_sync(kFull, act);
    if (act) {
      const unsigned long long k = keys_in[i];
      const unsigned d = (unsigned)(k >> shift) & 0xffu;
      const unsigned peers = __match_any_sync(amask, d);
      const int rank = __popc(peers & lt_mask);
      const int start = s_cnt[warp][d];
      __syncwarp(amask);
      if (rank == 0) s_cnt[warp][d] = start + __popc(peers);
      __syncwarp(amask);
      const int64_t dst = (int64_t)start + rank;
      keys_out[dst] = k;
      vals_out[dst] = vals_in[i];
    }
  }
}

}  // namespace srt_sort

using namespace srt_sort;

extern "C" {

// OR the fields of one key column into the limbs (zeroed by the caller);
// the column's least significant field starts at bit pos0.  item: bytes a
// row (the matrix width for strings, a multiple of 4); width: the packed
// string width (>= item, a multiple of 4), ignored for other kinds.
int srt_sort_encode(const void* data, const void* valid, const void* lens,
                    int kind, int item, int width, int asc, int nulls_first,
                    int pos0, void* limbs, int64_t n, void* stream) {
  if (kind == kString && (item % 4 || width % 4 || width < item))
    return (int)cudaErrorInvalidValue;
  if (n > 0)
    encode_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        SortKey{(long long)data, (long long)valid, (long long)lens, kind,
                item, width, asc, nulls_first},
        pos0, (unsigned long long*)limbs, n);
  return (int)cudaGetLastError();
}

// out[2l], out[2l+1] must hold 0 and ~0 on entry.
int srt_sort_or_and(const void* limbs, int64_t n, int nlimbs, void* out,
                    void* stream) {
  if (n > 0)
    or_and_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned long long*)limbs, n, nlimbs, (unsigned long long*)out);
  return (int)cudaGetLastError();
}

// Stable passes over the digits of one limb set in digit_mask (bit d =
// digit d, least significant first).  perm_in null: the rows are in input
// order.  keys_a/keys_b: n u64; vals_a/vals_b: n int32 distinct from
// perm_in; counts: 256*ntiles ints; offsets: 256*ntiles+1 ints.
// *where_out: 0 = result in vals_a, 1 = in vals_b, 2 = perm_in unchanged.
int srt_sort_limb(const void* limb, const void* perm_in, int64_t n,
                  int digit_mask, void* keys_a, void* keys_b, void* vals_a,
                  void* vals_b, void* counts, void* offsets, int* where_out,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  typedef unsigned long long u64;
  const u64* cur_k = (const u64*)limb;
  const int32_t* cur_v = (const int32_t*)perm_in;
  *where_out = 2;
  if (n == 0 || digit_mask == 0) return (int)cudaGetLastError();
  if (perm_in != nullptr) {
    gather_u64_kernel<<<grid_for(n), kThreads, 0, st>>>(
        (const u64*)limb, (const int32_t*)perm_in, (u64*)keys_a, n);
    cur_k = (const u64*)keys_a;
  } else {
    iota_kernel<<<grid_for(n), kThreads, 0, st>>>((int32_t*)vals_a, n);
    cur_v = (const int32_t*)vals_a;
  }
  const int nt = num_tiles(n);
  for (int d = 0; d < 8; ++d) {
    if (!((digit_mask >> d) & 1)) continue;
    u64* out_k = (cur_k == (const u64*)keys_a) ? (u64*)keys_b : (u64*)keys_a;
    int32_t* out_v = (cur_v == (const int32_t*)vals_a) ? (int32_t*)vals_b
                                                       : (int32_t*)vals_a;
    radix_hist_kernel<<<nt, kThreads, 0, st>>>(cur_k, n, 8 * d,
                                              (int32_t*)counts, nt);
    scan_exclusive_kernel<<<1, kScanThreads, 0, st>>>(
        (const int32_t*)counts, (int32_t*)offsets, (int64_t)256 * nt);
    radix_scatter_kernel<<<nt, kThreads, 0, st>>>(
        cur_k, cur_v, out_k, out_v, n, 8 * d, (const int32_t*)offsets, nt);
    cur_k = out_k;
    cur_v = out_v;
  }
  *where_out = (cur_v == (const int32_t*)vals_a) ? 0 : 1;
  return (int)cudaGetLastError();
}

}  // extern "C"
