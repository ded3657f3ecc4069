// K12a: partition and peer-group extents of a sorted window batch.
//
// Replaces spark_rapids_tpu/ops/window.py:72 `sorted_segments`, which XLA
// runs as a cumsum of the partition flags (segment ids), a cummax of
// flag * index (starts) and a reversed cummin of the next flag's index
// (ends), once for the partitions and once for the peer groups, over a
// power-of-two padded capacity.
//
// Input: the boundary flags of rows already sorted by (partition keys,
// order keys), from K4's flag pass (csrc/segmented.cu seg_flags_kernel:
// null == null, NaN == NaN, -0.0 == 0.0): part[i] = 1 where row i starts
// a partition (part[0] = 1), order[i] = 1 where its order keys differ
// from row i-1's.  A peer group starts where either flag is set.
//
// Output, int32 per row: seg_start/seg_end (first and last row of the
// row's partition), peer_start/peer_end (of its peer group: equal order
// keys inside the partition), seg_id (partition ordinal) and order_rank
// (inclusive count of order flags, which dense_rank differences).
//
// Design: three flag counts per tile (partition, peer, order starts), one
// single-block exclusive scan over the tiles for each (common.cuh), then a
// striped rescan of each tile that writes the ids and the running count
// and compacts the row of every partition and peer-group start into a
// scratch list.  A last elementwise pass reads each row's extents from
// those lists: the start is the list entry of the row's id, the end is the
// next entry minus one (or the last row).  No host sync: the group counts
// stay on the device.
//
// Bound on the H100: bytes.  Two flag bytes in and six int32 out a row;
// the scratch lists add two int32 writes and up to four int32 reads.
#include "common.cuh"

namespace srt_wseg {

using namespace srt;

struct Tri {
  int a, b, c;  // partition starts, peer starts, order changes
};

struct TriSum {
  __device__ Tri operator()(const Tri& x, const Tri& y) const {
    return {x.a + y.a, x.b + y.b, x.c + y.c};
  }
};

__global__ void wseg_count_kernel(const uint8_t* __restrict__ part,
                                  const uint8_t* __restrict__ order,
                                  int64_t n, int32_t* __restrict__ counts) {
  using BlockReduce = cub::BlockReduce<int, kThreads>;
  __shared__ typename BlockReduce::TempStorage tmp;
  const int nt = gridDim.x;
  const int64_t base = (int64_t)blockIdx.x * kTile;
  int cp = 0, cq = 0, co = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + (int64_t)k * kThreads + threadIdx.x;
    if (i < n) {
      const int p = part[i] != 0, o = order[i] != 0;
      cp += p;
      cq += p | o;
      co += o;
    }
  }
  const int tp = BlockReduce(tmp).Sum(cp);
  __syncthreads();
  const int tq = BlockReduce(tmp).Sum(cq);
  __syncthreads();
  const int to = BlockReduce(tmp).Sum(co);
  if (threadIdx.x == 0) {
    counts[blockIdx.x] = tp;
    counts[nt + blockIdx.x] = tq;
    counts[2 * nt + blockIdx.x] = to;
  }
}

__global__ void wseg_rescan_kernel(const uint8_t* __restrict__ part,
                                   const uint8_t* __restrict__ order,
                                   int64_t n,
                                   const int32_t* __restrict__ offsets,
                                   int32_t* __restrict__ seg_list,
                                   int32_t* __restrict__ peer_list,
                                   int32_t* __restrict__ seg_id,
                                   int32_t* __restrict__ peer_id,
                                   int32_t* __restrict__ order_rank) {
  using BlockScan = cub::BlockScan<Tri, kThreads>;
  __shared__ typename BlockScan::TempStorage tmp;
  const int nt = gridDim.x;
  const int64_t base = (int64_t)blockIdx.x * kTile;
  Tri carry = {offsets[blockIdx.x], offsets[nt + 1 + blockIdx.x],
               offsets[2 * (nt + 1) + blockIdx.x]};
  const Tri zero = {0, 0, 0};
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + (int64_t)k * kThreads + threadIdx.x;
    int p = 0, o = 0;
    if (i < n) {
      p = part[i] != 0;
      o = order[i] != 0;
    }
    const Tri mine = {p, p | o, o};
    Tri pos, agg;
    BlockScan(tmp).ExclusiveScan(mine, pos, zero, TriSum(), agg);
    __syncthreads();
    if (i < n) {
      const int sid = carry.a + pos.a + p - 1;
      const int pid = carry.b + pos.b + (p | o) - 1;
      seg_id[i] = sid;
      peer_id[i] = pid;
      order_rank[i] = carry.c + pos.c + o;
      if (p) seg_list[sid] = (int32_t)i;
      if (p | o) peer_list[pid] = (int32_t)i;
    }
    carry = TriSum()(carry, agg);
  }
}

// peer_start holds each row's peer id on entry and its peer start on exit.
__global__ void wseg_extents_kernel(int64_t n, int nt,
                                    const int32_t* __restrict__ offsets,
                                    const int32_t* __restrict__ seg_list,
                                    const int32_t* __restrict__ peer_list,
                                    const int32_t* __restrict__ seg_id,
                                    int32_t* __restrict__ seg_start,
                                    int32_t* __restrict__ seg_end,
                                    int32_t* __restrict__ peer_start,
                                    int32_t* __restrict__ peer_end) {
  const int G = offsets[nt];
  const int P = offsets[nt + 1 + nt];
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int sid = seg_id[i];
    const int pid = peer_start[i];
    seg_start[i] = seg_list[sid];
    seg_end[i] = (sid + 1 < G ? seg_list[sid + 1] : (int32_t)n) - 1;
    peer_start[i] = peer_list[pid];
    peer_end[i] = (pid + 1 < P ? peer_list[pid + 1] : (int32_t)n) - 1;
  }
}

}  // namespace srt_wseg

using namespace srt_wseg;

extern "C" {

// n >= 1 rows, part[0] = 1.  counts: 3 * ntiles int32 scratch; offsets:
// 3 * (ntiles + 1) int32 scratch; seg_list, peer_list: n int32 scratch.
int srt_window_segments(const void* part, const void* order, int64_t n,
                        void* counts, void* offsets, void* seg_list,
                        void* peer_list, void* seg_start, void* seg_end,
                        void* peer_start, void* peer_end, void* seg_id,
                        void* order_rank, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int nt = srt::num_tiles(n);
  int32_t* c = (int32_t*)counts;
  int32_t* o = (int32_t*)offsets;
  const uint8_t* pf = (const uint8_t*)part;
  const uint8_t* of = (const uint8_t*)order;
  wseg_count_kernel<<<nt, srt::kThreads, 0, st>>>(pf, of, n, c);
  for (int j = 0; j < 3; ++j)
    srt::scan_exclusive_kernel<<<1, srt::kScanThreads, 0, st>>>(
        c + j * nt, o + j * (nt + 1), nt);
  wseg_rescan_kernel<<<nt, srt::kThreads, 0, st>>>(
      pf, of, n, o, (int32_t*)seg_list, (int32_t*)peer_list,
      (int32_t*)seg_id, (int32_t*)peer_start, (int32_t*)order_rank);
  wseg_extents_kernel<<<grid_for(n), srt::kThreads, 0, st>>>(
      n, nt, o, (const int32_t*)seg_list, (const int32_t*)peer_list,
      (const int32_t*)seg_id, (int32_t*)seg_start, (int32_t*)seg_end,
      (int32_t*)peer_start, (int32_t*)peer_end);
  return (int)cudaGetLastError();
}

}  // extern "C"
