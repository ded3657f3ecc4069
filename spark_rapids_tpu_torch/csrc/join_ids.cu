// K6: dense cross-side key ids of the equi-join rank path.
//
// Replaces spark_rapids_tpu/ops/join.py:62 `_key_ids` after its sort: the
// reference flags key changes between neighbouring sorted rows
// (`_cols_differ`), takes a jnp.cumsum of the flags as the segment id of
// every sorted row, scatters the ids back to the original rows
// (`.at[order].set`) and writes INT32_MAX / INT32_MAX - 1 for left / right
// rows with a null key.  The sort (K1 over [null flag, encoded keys]), the
// gather of the sorted keys (K3) and the flags (K4's seg_flags_kernel:
// null == null, NaN == NaN, -0.0 == 0.0, strings by bytes and length) are
// the earlier kernels; this file is the rest.
//
// Design: the flag scan shared with K2/K4 (common.cuh flag_scan: per-tile
// counts, one block scanning the tiles), then key_ids_kernel: each block
// re-ranks its tile's flags with cub::BlockScan (striped, as compact.cu
// does) and writes id = (flags up to and including the row) - 1 straight
// to the row's original position order[i].  The ids are never materialised
// in sorted order.
//
// Bound on the H100: bytes.  One flag byte and one order index read per
// row, one validity byte and one id written per row (a scattered write,
// 4 bytes per row).
#include "common.cuh"

namespace srt_ids {

using namespace srt;

constexpr int32_t kI32Max = 2147483647;

__global__ void key_ids_kernel(const uint8_t* __restrict__ flags,
                               const int32_t* __restrict__ order,
                               const uint8_t* __restrict__ valid, int64_t n,
                               int64_t cl,
                               const int32_t* __restrict__ tile_offsets,
                               int32_t* __restrict__ ids) {
  using BlockScan = cub::BlockScan<int, kThreads>;
  __shared__ typename BlockScan::TempStorage tmp;
  const int64_t base = (int64_t)blockIdx.x * kTile;
  int carry = tile_offsets[blockIdx.x];
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + (int64_t)k * kThreads + threadIdx.x;
    const int f = (i < n && flags[i] != 0) ? 1 : 0;
    int pos, agg;
    BlockScan(tmp).ExclusiveSum(f, pos, agg);
    __syncthreads();
    if (i < n) {
      const int32_t r = order[i];
      ids[r] = valid[r] != 0 ? (int32_t)(carry + pos + f - 1)
                             : (r < cl ? kI32Max : kI32Max - 1);
    }
    carry += agg;
  }
}

}  // namespace srt_ids

using namespace srt_ids;

extern "C" {

// flags: key changes over the n sorted rows (flags[0] = 1); order: the
// sort permutation; valid: per original row, every key non-null; rows
// [0, cl) are the left side.  ids[row] = dense rank, or INT32_MAX (left) /
// INT32_MAX - 1 (right) for a row with a null key.  tile_counts and
// tile_offsets are scratch of ntiles and ntiles + 1 ints.
int srt_join_key_ids(const void* flags, const void* order, const void* valid,
                     int64_t n, int64_t cl, void* tile_counts,
                     void* tile_offsets, void* ids, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nt = srt::num_tiles(n);
  if (nt == 0) return (int)cudaGetLastError();
  srt::flag_scan((const uint8_t*)flags, n, (int32_t*)tile_counts,
                 (int32_t*)tile_offsets, st);
  key_ids_kernel<<<nt, srt::kThreads, 0, st>>>(
      (const uint8_t*)flags, (const int32_t*)order, (const uint8_t*)valid, n,
      cl, (const int32_t*)tile_offsets, (int32_t*)ids);
  return (int)cudaGetLastError();
}

}  // extern "C"
