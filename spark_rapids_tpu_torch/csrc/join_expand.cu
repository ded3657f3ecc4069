// K7: join index expansion, the full-outer tail and the matched-build
// bitmap.
//
// Replaces spark_rapids_tpu/ops/join.py:216 `join_indices_from_probe`
// (a jnp.cumsum of the per-stream-row output counts, a jnp.searchsorted of
// every output slot into those offsets, and a scatter that appends the
// unmatched build rows of a full outer join) and :182 `matched_build_rows`
// (a scatter of flags over the build rows that output slots reference).
// The output gather (:261 `gather_join_output`) is K3 over both sides.
//
// Design:
//   * offsets: per-tile sums of the int32 counts, one block scanning the
//     tiles (common.cuh scan_exclusive_kernel), then offsets_kernel re-scans
//     each tile with cub::BlockScan and writes the exclusive offsets and,
//     last, the total.  The wrapper has checked that one batch's total fits
//     in int32, so no partial sum can wrap.
//   * expand_kernel, one thread per output slot j: a binary search over the
//     offsets finds the stream row li whose run holds j, then k = j -
//     offsets[li], and the build row is rsort_perm[start[li] + k] when k <
//     cnt[li] (else -1: an outer non-match, or a semi/anti slot).  One
//     search per slot balances the load whatever the key skew: a stream row
//     that matches 2^16 build rows spreads over 2^16 threads, where one
//     thread per stream row writing its run would serialise it.
//   * tail_kernel: unmatched build row r goes to slot total_left +
//     (exclusive scan of the unmatched flags)[r], with li = -1.
//   * mark_kernel: matched[ri[j]] = 1 for every slot with a build row
//     (benign duplicate writes of the same byte).
//
// Bound on the H100: bytes.  The counts are read twice (tile sums and
// offsets) and the offsets written once; each output slot writes two
// int32s and reads its stream row's offset, count and start and one
// rsort_perm entry.  The ~log2(rows) dependent offset loads per slot hit
// L2 (neighbouring slots walk the same path).
#include "common.cuh"

namespace srt_expand {

using namespace srt;

__global__ void tile_sum_kernel(const int32_t* __restrict__ v, int64_t n,
                                int32_t* __restrict__ sums) {
  using BlockReduce = cub::BlockReduce<int, kThreads>;
  __shared__ typename BlockReduce::TempStorage tmp;
  const int64_t base = (int64_t)blockIdx.x * kTile;
  int s = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + (int64_t)k * kThreads + threadIdx.x;
    if (i < n) s += v[i];
  }
  const int total = BlockReduce(tmp).Sum(s);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

__global__ void offsets_kernel(const int32_t* __restrict__ v, int64_t n,
                               const int32_t* __restrict__ tile_offsets,
                               int32_t* __restrict__ out) {
  using BlockScan = cub::BlockScan<int, kThreads>;
  __shared__ typename BlockScan::TempStorage tmp;
  const int64_t base = (int64_t)blockIdx.x * kTile;
  int carry = tile_offsets[blockIdx.x];
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + (int64_t)k * kThreads + threadIdx.x;
    const int x = i < n ? v[i] : 0;
    int pos, agg;
    BlockScan(tmp).ExclusiveSum(x, pos, agg);
    __syncthreads();
    if (i < n) out[i] = carry + pos;
    carry += agg;
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0)
    out[n] = tile_offsets[gridDim.x];
}

// Last stream row whose offset is <= j (offsets are non-decreasing).
__device__ __forceinline__ int64_t row_of(const int32_t* __restrict__ off,
                                          int64_t cl, int32_t j) {
  int64_t lo = 0, hi = cl;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (off[mid] <= j)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo - 1;
}

__global__ void expand_kernel(const int32_t* __restrict__ offsets, int64_t cl,
                              const int32_t* __restrict__ cnt,
                              const int32_t* __restrict__ start,
                              const int32_t* __restrict__ rperm, int64_t m,
                              int take_right, int32_t* __restrict__ li,
                              int32_t* __restrict__ ri) {
  const int32_t total_left = offsets[cl];
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < m;
       j += (int64_t)gridDim.x * blockDim.x) {
    if (j >= total_left) continue;  // the full-outer tail
    const int64_t row = row_of(offsets, cl, (int32_t)j);
    const int32_t k = (int32_t)j - offsets[row];
    li[j] = (int32_t)row;
    ri[j] = (take_right && k < cnt[row]) ? rperm[start[row] + k] : -1;
  }
}

__global__ void tail_kernel(const int32_t* __restrict__ unmatched,
                            const int32_t* __restrict__ uoff, int64_t cr,
                            const int32_t* __restrict__ total_left,
                            int32_t* __restrict__ li,
                            int32_t* __restrict__ ri) {
  const int64_t base = *total_left;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < cr;
       r += (int64_t)gridDim.x * blockDim.x) {
    if (unmatched[r] == 0) continue;
    const int64_t slot = base + uoff[r];
    li[slot] = -1;
    ri[slot] = (int32_t)r;
  }
}

__global__ void mark_kernel(const int32_t* __restrict__ ri, int64_t m,
                            uint8_t* __restrict__ matched) {
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < m;
       j += (int64_t)gridDim.x * blockDim.x) {
    const int32_t r = ri[j];
    if (r >= 0) matched[r] = 1;
  }
}

}  // namespace srt_expand

using namespace srt_expand;

extern "C" {

// out[i] = sum(v[0..i)) for i in [0, n], so out[n] is the total.
// tile_sums: max(ntiles, 1) ints of scratch; tile_offsets: ntiles + 1.
int srt_join_offsets(const void* v, int64_t n, void* tile_sums,
                     void* tile_offsets, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nt = srt::num_tiles(n);
  if (nt == 0) {
    cudaMemsetAsync(out, 0, sizeof(int32_t), st);
    return (int)cudaGetLastError();
  }
  tile_sum_kernel<<<nt, srt::kThreads, 0, st>>>((const int32_t*)v, n,
                                                (int32_t*)tile_sums);
  srt::scan_exclusive_kernel<<<1, srt::kScanThreads, 0, st>>>(
      (const int32_t*)tile_sums, (int32_t*)tile_offsets, nt);
  offsets_kernel<<<nt, srt::kThreads, 0, st>>>(
      (const int32_t*)v, n, (const int32_t*)tile_offsets, (int32_t*)out);
  return (int)cudaGetLastError();
}

// Slots [0, offsets[cl]) of the m output slots: li = stream row, ri =
// build row or -1.  Slots from offsets[cl] on belong to the tail.
int srt_join_expand(const void* offsets, int64_t cl, const void* cnt,
                    const void* start, const void* rperm, int64_t m,
                    int take_right, void* li, void* ri, void* stream) {
  if (m > 0)
    expand_kernel<<<grid_for(m, 32), srt::kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)offsets, cl, (const int32_t*)cnt,
        (const int32_t*)start, (const int32_t*)rperm, m, take_right,
        (int32_t*)li, (int32_t*)ri);
  return (int)cudaGetLastError();
}

// Full outer: unmatched build row r -> slot *total_left + uoff[r].
int srt_join_tail(const void* unmatched, const void* uoff, int64_t cr,
                  const void* total_left, void* li, void* ri, void* stream) {
  if (cr > 0)
    tail_kernel<<<grid_for(cr, 32), srt::kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)unmatched, (const int32_t*)uoff, cr,
        (const int32_t*)total_left, (int32_t*)li, (int32_t*)ri);
  return (int)cudaGetLastError();
}

// matched[ri[j]] = 1 for every slot j with ri[j] >= 0.
int srt_join_mark(const void* ri, int64_t m, void* matched, void* stream) {
  if (m > 0)
    mark_kernel<<<grid_for(m, 32), srt::kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ri, m, (uint8_t*)matched);
  return (int)cudaGetLastError();
}

}  // extern "C"
