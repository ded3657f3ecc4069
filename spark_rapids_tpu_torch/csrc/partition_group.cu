// K10: group a batch's rows by shuffle partition id, stably.
//
// Replaces spark_rapids_tpu/exec/exchange.py:62 `_jit_group_by_part`, which
// XLA runs as a stable argsort of the ids, a [P, n] comparison for the
// counts and a cumsum for the starts (the slicing, `_jit_slice_part` :83,
// is a view in the port).  Here a counting sort takes the place of the
// comparison sort.
//
// Design, over tiles of kTile (4096) rows:
//   1. hist_kernel: one block per tile counts its rows per bucket in shared
//      memory (warp-aggregated with __match_any_sync, one shared atomic per
//      distinct id in a warp) and writes hist[b * ntiles + tile], bucket-
//      major.  Bucket P collects ids outside [0, P), which sort last and
//      belong to no partition, as the reference's padding rows do.
//   2. scan_exclusive_kernel (common.cuh): one block scans the (P + 1) x
//      ntiles counts, so offsets[b * ntiles + t] is where tile t's rows of
//      bucket b start in the output.
//   3. counts_kernel: counts[p] and starts[p] from the scanned offsets.
//   4. scatter_kernel: one warp per tile walks its rows in order, 32 at a
//      time; lanes with the same id find each other with __match_any_sync,
//      take rank = popc(peers below me), write their row index to
//      counter[id] + rank, and the group's lowest lane advances the
//      counter.  Rows of one partition keep their input order: stable, as
//      argsort(stable=True) is, so the final aggregate sees each map batch
//      in map order.
// The wrapper gathers the columns through K3 with the permutation; only
// `counts` crosses to the host, once per map batch (ops/partition.py).
//
// Bound on the H100: bytes.  The ids are read twice (histogram, scatter)
// and one int32 index is written per row; the histogram scan moves
// (P + 1) x ntiles ints, small beside n for the exchange's batch sizes.
#include "common.cuh"

namespace srt_part {

using namespace srt;

constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ int bucket_of(int32_t id, int num_parts) {
  return (id >= 0 && id < num_parts) ? id : num_parts;
}

__global__ void hist_kernel(const int32_t* __restrict__ ids, int64_t n,
                            int num_parts, int64_t ntiles,
                            int32_t* __restrict__ hist) {
  extern __shared__ int32_t sh[];  // num_parts + 1 counters
  for (int b = threadIdx.x; b <= num_parts; b += blockDim.x) sh[b] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t base = (int64_t)blockIdx.x * kTile;
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + (int64_t)k * kThreads + threadIdx.x;
    const int b = i < n ? bucket_of(ids[i], num_parts) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    if (b >= 0 && lane == __ffs(peers) - 1) atomicAdd(&sh[b], __popc(peers));
  }
  __syncthreads();
  for (int b = threadIdx.x; b <= num_parts; b += blockDim.x)
    hist[(int64_t)b * ntiles + blockIdx.x] = sh[b];
}

__global__ void counts_kernel(const int32_t* __restrict__ offsets,
                              int num_parts, int64_t ntiles,
                              int32_t* __restrict__ counts,
                              int32_t* __restrict__ starts) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < num_parts) {
    const int32_t s = offsets[(int64_t)p * ntiles];
    starts[p] = s;
    counts[p] = offsets[(int64_t)(p + 1) * ntiles] - s;
  }
}

__global__ void scatter_kernel(const int32_t* __restrict__ ids, int64_t n,
                               int num_parts, int64_t ntiles,
                               const int32_t* __restrict__ offsets,
                               int32_t* __restrict__ perm) {
  extern __shared__ int32_t sh[];  // kWarpsPerBlock x (num_parts + 1)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t t = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (t >= ntiles) return;  // the whole warp leaves together
  int32_t* cnt = sh + warp * (num_parts + 1);
  for (int b = lane; b <= num_parts; b += 32)
    cnt[b] = offsets[(int64_t)b * ntiles + t];
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
  const int64_t base = t * kTile;
  for (int64_t s = 0; s < kTile && base + s < n; s += 32) {
    const int64_t i = base + s + lane;
    const int b = i < n ? bucket_of(ids[i], num_parts) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    if (b >= 0) perm[cnt[b] + __popc(peers & below)] = (int32_t)i;
    __syncwarp();
    if (b >= 0 && lane == __ffs(peers) - 1) cnt[b] += __popc(peers);
    __syncwarp();
  }
}

}  // namespace srt_part

using namespace srt_part;

extern "C" {

// ids: int32[n]; hist: scratch of (num_parts + 1) * ntiles ints; offsets:
// scratch of that plus one; counts, starts: int32[num_parts]; perm:
// int32[n], the rows grouped by partition (ids outside [0, num_parts)
// last).  num_parts <= 232448 / 16 - 1 (the scatter's shared counters).
int srt_partition_group(const void* ids, int64_t n, int num_parts, void* hist,
                        void* offsets, void* counts, void* starts, void* perm,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t nt = srt::num_tiles(n);
  const int64_t m = (int64_t)(num_parts + 1) * nt;
  const size_t hist_smem = sizeof(int32_t) * (size_t)(num_parts + 1);
  const size_t scatter_smem = hist_smem * kWarpsPerBlock;
  cudaError_t e;
  if (hist_smem > 48 * 1024) {
    e = cudaFuncSetAttribute(hist_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)hist_smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (scatter_smem > 48 * 1024) {
    e = cudaFuncSetAttribute(scatter_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)scatter_smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (nt > 0)
    hist_kernel<<<(unsigned)nt, srt::kThreads, hist_smem, st>>>(
        (const int32_t*)ids, n, num_parts, nt, (int32_t*)hist);
  srt::scan_exclusive_kernel<<<1, srt::kScanThreads, 0, st>>>(
      (const int32_t*)hist, (int32_t*)offsets, m);
  counts_kernel<<<(num_parts + 255) / 256, 256, 0, st>>>(
      (const int32_t*)offsets, num_parts, nt, (int32_t*)counts,
      (int32_t*)starts);
  if (nt > 0)
    scatter_kernel<<<(unsigned)((nt + kWarpsPerBlock - 1) / kWarpsPerBlock),
                     kWarpsPerBlock * 32, scatter_smem, st>>>(
        (const int32_t*)ids, n, num_parts, nt, (const int32_t*)offsets,
        (int32_t*)perm);
  return (int)cudaGetLastError();
}

}  // extern "C"
