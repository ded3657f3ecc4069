// K11: range-partition ids.
//
// Replaces spark_rapids_tpu/exec/partitioning.py:258-268
// `RangePartitioning.device_ids` over `_rank_operands` (:157) and
// `_combined_rank_ids` (:170): XLA sorts the batch's rows together with
// the P - 1 bound rows in one stable multi-operand lax.sort, takes dense
// ranks and searchsorts each row's rank among the bounds' ranks.  The
// partition id that gives is the number of bounds whose sort key is
// strictly below the row's.
//
// Design: the wrapper packs the rows' keys and the bounds' keys into K1's
// order-preserving limbs at one layout (csrc/sort.cu encode_kernel; equal
// keys pack equal, and unsigned comparison from the most significant limb
// down is the sort order).  One thread a row binary-searches the bounds,
// which are sorted, for the first one that is not below the row: that
// index is the id.  The bounds' limbs sit in shared memory when they fit in
// the default 48 KB (P up to ~6000 at one limb a key), else the search
// reads them from global memory, where they stay cached (at most a few
// hundred KB).  No sort, no ranks and no host sync.
//
// Bound on the H100: bytes.  Each row's limbs are read once (the top limb
// at every step of the search, from L1) and its id written once;
// log2(P) comparisons a row are far below the card's integer rate.
#include "common.cuh"

namespace srt_rp {

using namespace srt;
typedef unsigned long long u64;

constexpr int kSharedBytes = 48 * 1024;

// bounds: nb x nlimbs, bound-major, limb 0 least significant.  rows:
// nlimbs x n, limb-major.
template <bool kShared>
__global__ void range_ids_kernel(const u64* __restrict__ rows, int64_t n,
                                 int nlimbs, const u64* __restrict__ bounds,
                                 int nb, int32_t* __restrict__ ids) {
  extern __shared__ u64 smem[];
  const u64* b = bounds;
  if (kShared) {
    for (int t = threadIdx.x; t < nb * nlimbs; t += blockDim.x)
      smem[t] = bounds[t];
    __syncthreads();
    b = smem;
  }
  const int top = nlimbs - 1;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; row < n;
       row += (int64_t)gridDim.x * blockDim.x) {
    const u64 r_top = rows[(int64_t)top * n + row];
    int lo = 0, hi = nb;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const u64* bm = b + (int64_t)mid * nlimbs;
      u64 bl = bm[top], rl = r_top;
      for (int l = top - 1; bl == rl && l >= 0; --l) {
        bl = bm[l];
        rl = rows[(int64_t)l * n + row];
      }
      if (bl < rl) lo = mid + 1;  // the bound is below the row
      else hi = mid;
    }
    ids[row] = lo;
  }
}

}  // namespace srt_rp

extern "C" {

// ids[i] = the number of the nb sorted bounds strictly below row i.
// rows: nlimbs x n limbs; bounds: nb x nlimbs limbs of the same layout.
int srt_range_partition(const void* rows, int64_t n, int nlimbs,
                        const void* bounds, int nb, void* ids,
                        void* stream) {
  using namespace srt_rp;
  if (nlimbs < 1 || nb < 0) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t bytes = (int64_t)nb * nlimbs * sizeof(u64);
  const int grid = grid_for(n, 4);
  if (bytes <= kSharedBytes)
    range_ids_kernel<true><<<grid, kThreads, (size_t)bytes, st>>>(
        (const u64*)rows, n, nlimbs, (const u64*)bounds, nb, (int32_t*)ids);
  else
    range_ids_kernel<false><<<grid, kThreads, 0, st>>>(
        (const u64*)rows, n, nlimbs, (const u64*)bounds, nb, (int32_t*)ids);
  return (int)cudaGetLastError();
}

}  // extern "C"
