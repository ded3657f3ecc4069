// Shared building blocks of the Hopper kernels.
//
// Every source under csrc/ is built on its own into a shared library with a
// plain C interface (nvcc -gencode arch=compute_90a,code=sm_90a) and loaded
// with ctypes (spark_rapids_tpu_torch/ops/native.py).  The C entry points
// launch on the stream they are given, allocate nothing (the Python wrapper
// passes outputs and scratch as torch tensors) and return cudaGetLastError().
//
// Tiling: a tile is kThreads * kItems consecutive rows handled by one block.
// K4's boundary pass, K2's count, K5's search and K7's own offsets count and
// scan in one launch with the decoupled look-back below; K12a's window
// segments still scan their tile counts in one block (scan_exclusive_kernel).
// The scatter/reduce kernels recompute the in-tile ranks, so the scanned row
// positions are never written out.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

namespace srt {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // rows per tile (4096)
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;

inline int num_tiles(int64_t n) { return (int)((n + kTile - 1) / kTile); }

// Blocks of kThreads for a grid-stride loop over `work` items, capped at
// `waves` resident waves of the H100's 132 SMs.
inline int grid_for(int64_t work, int64_t waves = 16) {
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = 132 * waves;
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

// One column of a gather or compaction: a row is row_bytes bytes (1/2/4/8
// for fixed-width types, the byte-matrix width W for strings), copied in
// vec_bytes chunks.  dst slots of null rows get zero bytes, validity 0 and
// length 0 -- the column invariant of columnar/column.py.
struct ColDesc {
  const void* src_data;
  void* dst_data;
  const uint8_t* src_valid;
  uint8_t* dst_valid;
  const int32_t* src_len;  // null for fixed-width columns
  int32_t* dst_len;
  int32_t row_bytes;
  int32_t vec_bytes;
};

template <typename V>
__device__ __forceinline__ void copy_vecs(const ColDesc& c, int64_t s,
                                          int64_t d, bool valid) {
  const int nv = c.row_bytes / (int)sizeof(V);
  V* dp = reinterpret_cast<V*>(c.dst_data) + d * nv;
  if (valid) {
    const V* sp = reinterpret_cast<const V*>(c.src_data) + s * nv;
    for (int j = 0; j < nv; ++j) dp[j] = sp[j];
  } else {
    const V z = V();
    for (int j = 0; j < nv; ++j) dp[j] = z;
  }
}

// Copy source row s to destination row d (s < 0: a null output row).
__device__ __forceinline__ void copy_row(const ColDesc& c, int64_t s,
                                         int64_t d) {
  const bool valid = s >= 0 && c.src_valid[s] != 0;
  c.dst_valid[d] = valid ? 1 : 0;
  if (c.dst_len != nullptr) c.dst_len[d] = valid ? c.src_len[s] : 0;
  switch (c.vec_bytes) {
    case 16: copy_vecs<uint4>(c, s, d, valid); break;
    case 8: copy_vecs<unsigned long long>(c, s, d, valid); break;
    case 4: copy_vecs<uint32_t>(c, s, d, valid); break;
    case 2: copy_vecs<uint16_t>(c, s, d, valid); break;
    default: copy_vecs<uint8_t>(c, s, d, valid); break;
  }
}

// Largest power-of-two chunk (<= 16 bytes) that divides the row width and
// both base addresses.
inline int pick_vec_bytes(const void* a, const void* b, int row_bytes) {
  const uintptr_t bits = (uintptr_t)a | (uintptr_t)b | (uintptr_t)row_bytes;
  int v = 16;
  while (v > 1 && (bits & (uintptr_t)(v - 1)) != 0) v >>= 1;
  return v;
}

inline ColDesc make_desc(const void* src_data, void* dst_data,
                         const void* src_valid, void* dst_valid,
                         const void* src_len, void* dst_len, int row_bytes) {
  ColDesc c;
  c.src_data = src_data;
  c.dst_data = dst_data;
  c.src_valid = (const uint8_t*)src_valid;
  c.dst_valid = (uint8_t*)dst_valid;
  c.src_len = (const int32_t*)src_len;
  c.dst_len = (int32_t*)dst_len;
  c.row_bytes = row_bytes;
  c.vec_bytes = pick_vec_bytes(src_data, dst_data, row_bytes);
  return c;
}

// One block: out[i] = sum(in[0..i)) for i in [0, m], so out[m] is the total.
__global__ void scan_exclusive_kernel(const int32_t* __restrict__ in,
                                      int32_t* __restrict__ out, int64_t m) {
  using BlockScan = cub::BlockScan<int, kScanThreads>;
  __shared__ typename BlockScan::TempStorage tmp;
  int carry = 0;
  for (int64_t base = 0; base < m; base += kScanThreads * kScanItems) {
    int v[kScanItems];
    int s = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int64_t i = base + (int64_t)threadIdx.x * kScanItems + k;
      v[k] = i < m ? in[i] : 0;
      s += v[k];
    }
    int excl, agg;
    BlockScan(tmp).ExclusiveSum(s, excl, agg);
    __syncthreads();
    int run = carry + excl;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int64_t i = base + (int64_t)threadIdx.x * kScanItems + k;
      if (i < m) out[i] = run;
      run += v[k];
    }
    carry += agg;
  }
  if (threadIdx.x == 0) out[m] = carry;
}

// Decoupled look-back (Merrill and Garland's single-pass prefix scan) over
// the tiles of one launch, in place of a tile count and a one-block scan.
// A block takes its tile from a ticket, so a tile only ever waits on tiles
// that have started.  status (uint64): [0] the ticket, [1] the tiles done,
// [2 + t] tile t's state -- its own count or its inclusive prefix in the
// low 62 bits, which of the two in the top two -- zero on entry.  The last
// tile done zeroes [0, 2 + ntiles) again, so a caller keeps one status
// array and never clears it.  Counts are integers whose sums stay below
// 2^62 (a caller may pack two 31-bit counts into one).
constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned long long kLbAgg = 1ull << 62;
constexpr unsigned long long kLbPrefix = 2ull << 62;
constexpr unsigned long long kLbValue = kLbAgg - 1ull;

__device__ __forceinline__ unsigned long long lb_load(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}
__device__ __forceinline__ void lb_store(unsigned long long* p,
                                         unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// The block's tile; every thread calls it (one __syncthreads).
__device__ __forceinline__ long long lookback_ticket(
    unsigned long long* status, long long* s_tile) {
  if (threadIdx.x == 0) *s_tile = (long long)atomicAdd(status, 1ull);
  __syncthreads();
  return *s_tile;
}

// Warp 0 of the block, every lane: publishes the tile's count `agg`, reads
// the earlier tiles' states 32 at a time back to the nearest published
// prefix, publishes the tile's inclusive prefix and returns the exclusive
// one (on every lane).
__device__ __forceinline__ unsigned long long lookback_prefix(
    unsigned long long* status, long long tile, unsigned long long agg) {
  unsigned long long* st = status + 2;
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) lb_store(st, kLbPrefix | agg);
    return 0ull;
  }
  if (lane == 0) lb_store(st + tile, kLbAgg | agg);
  unsigned long long before = 0ull;
  for (long long j = tile - 1;; j -= 32) {
    const long long q = j - lane;  // lane 0 the nearest
    unsigned long long s = q >= 0 ? lb_load(st + q) : kLbPrefix;
    while (__any_sync(kFullMask, (s & ~kLbValue) == 0ull))
      if ((s & ~kLbValue) == 0ull) s = lb_load(st + q);
    const unsigned pre = __ballot_sync(kFullMask, (s & kLbPrefix) != 0ull);
    // the counts up to and including the nearest published prefix
    const int stop = pre ? __ffs(pre) - 1 : 31;
    unsigned long long v = lane <= stop ? (s & kLbValue) : 0ull;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
    before += v;
    if (pre) break;
  }
  if (lane == 0) lb_store(st + tile, kLbPrefix | (before + agg));
  return before;
}

// Every thread of the block, once warp 0's look-back is over: the last
// tile done zeroes the status for the next launch.
__device__ __forceinline__ void lookback_done(unsigned long long* status,
                                              long long ntiles,
                                              int* s_last) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    *s_last = atomicAdd(status + 1, 1ull) ==
              (unsigned long long)(ntiles - 1);
  }
  __syncthreads();
  if (*s_last) {
    __threadfence();
    for (long long i = threadIdx.x; i < ntiles + 2; i += blockDim.x)
      status[i] = 0ull;
  }
}

}  // namespace srt
