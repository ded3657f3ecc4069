// K7: join index expansion with the full-outer tail, the matched-build
// bitmap, and the exclusive scan of K14's emit counts.
//
// Replaces spark_rapids_tpu/ops/join.py:216 `join_indices_from_probe`
// (a jnp.cumsum of the per-stream-row output counts, a jnp.searchsorted of
// every output slot into those offsets, and a scatter that appends the
// unmatched build rows of a full outer join) and :182 `matched_build_rows`
// (a scatter of flags over the build rows that output slots reference).
// The output gather (:261 `gather_join_output`) is K3 over both sides.
//
// Design:
//   * expand_kernel is a load-balancing search (Merrill's merge path, as
//     moderngpu's "load-balancing search" uses it): the run ends of the
//     stream rows, ends[i] = offsets[i + 1] for i < cl, merged with the
//     slot indices 0..total_left-1, an end before slot j where ends[i] <=
//     j.  A block owns kExpShare consecutive merged items.  Half the
//     block finds its start diagonal and half its end diagonal on global
//     memory, 128 probes a step (one search each a block, not one a slot).
//     A block whose share holds no slot (a stretch of rows without output)
//     leaves.  Otherwise it stages its window of offsets in shared memory
//     with coalesced loads; each thread finds its own diagonal there and
//     walks its kExpItems items in shared memory: an end moves to the next
//     stream row, a slot j of row r records r and k = j - offsets[r].
//     Then the block takes its slots in slot order: li = r, and ri =
//     rperm[start[r] + k] where take_right and k < cnt[r], else -1 (an
//     outer non-match, a semi/anti slot), so neighbouring threads read
//     neighbouring rows and a run's consecutive build rows, every load of
//     a thread in flight at once, and the stores coalesce.  cnt and start
//     are read only for rows with slots.  Every slot lies in exactly one
//     block's share and one thread's walk, so each is written once at any
//     skew: a row with 2^16 slots spreads over 32 blocks.  Without a
//     full-outer tail, total_left is the m the host passed, not a load.
//   * the full-outer tail runs in the same launch: the blocks past the
//     expansion's (the host sizes that part from cl + m >= cl +
//     total_left, so some of its blocks may find no work) take kExpShare
//     build rows each, and unmatched row r goes to slot total_left +
//     uoff[r] with li = -1, total_left read on the device.
//   * offsets_kernel (K14's emit offsets; the join paths read the offsets
//     K5's search wrote): one launch, a tile a block in ticket order, the
//     tile's sum published through the decoupled look-back of common.cuh,
//     so no tile-sum pass and no one-block scan.  The last tile writes the
//     total.
//   * mark_kernel: matched[ri[j]] = 1 for every slot with a build row
//     (benign duplicate writes of the same byte).
//
// Bound on the H100: bytes.  The offsets are read once (cl + 1 int32);
// each output slot writes two int32s and reads one rperm entry; cnt and
// start are read for the rows that have slots; the tail reads the
// unmatched flags and their offsets once.
#include "common.cuh"

namespace srt_expand {

using namespace srt;

constexpr int kExpThreads = 256;
constexpr int kExpItems = 8;
// merged items (run ends and slots) a block; also build rows a tail block
constexpr int kExpShare = kExpThreads * kExpItems;

// a stream row's run end is before slot b: off[a + 1] <= b
__device__ __forceinline__ bool end_first(const int32_t* off, long long a,
                                          long long b) {
  return (long long)off[a + 1] <= b;
}

constexpr int kSplitProbes = kExpThreads / 2;  // 4 warps a diagonal

// The block's two merge-path searches on global memory, half the block
// each: the run ends among the first d merged items of cl ends and nslots
// slots, for d = d0 and d1, into s_split[0] and s_split[1].  Each step
// probes 128 evenly spaced candidates, so a range of 2^20 rows takes
// three dependent loads instead of twenty.  Every thread calls it.
__device__ void block_split(const int32_t* __restrict__ off, long long cl,
                            long long nslots, long long d0, long long d1,
                            long long* s_split, long long* s_hi,
                            int* s_true) {
  const int t = threadIdx.x, g = t / kSplitProbes, q = t % kSplitProbes;
  const long long d = g == 0 ? d0 : d1;
  if (q == 0) {
    s_split[g] = d - nslots > 0 ? d - nslots : 0;
    s_hi[g] = d < cl ? d : cl;
  }
  __syncthreads();
  for (;;) {
    const long long lo = s_split[g], hi = s_hi[g];
    if (!__syncthreads_or(lo < hi)) break;
    const long long step = (hi - lo + kSplitProbes - 1) / kSplitProbes;
    const long long at = lo + (q + 1) * step - 1;
    // the end at `at` is among the first d items (the true probes of a
    // diagonal are a prefix of its 128)
    const bool pred = lo < hi && at < hi && end_first(off, at, d - 1 - at);
    const unsigned ok = __ballot_sync(kFullMask, pred);
    if ((t & 31) == 0) s_true[t >> 5] = __popc(ok);
    __syncthreads();
    if (q == 0 && lo < hi) {
      const int w = g * (kSplitProbes / 32);
      const long long c = s_true[w] + s_true[w + 1] + s_true[w + 2] +
                          s_true[w + 3];
      const long long at_c = lo + (c + 1) * step - 1;
      if (c < kSplitProbes && at_c < hi) s_hi[g] = at_c;
      s_split[g] = lo + c * step;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kExpThreads)
expand_kernel(const int32_t* __restrict__ off, long long cl,
              const int32_t* __restrict__ cnt,
              const int32_t* __restrict__ start,
              const int32_t* __restrict__ rperm, int take_right, long long m,
              long long exp_blocks, const int32_t* __restrict__ unmatched,
              const int32_t* __restrict__ uoff, long long cr,
              int32_t* __restrict__ li, int32_t* __restrict__ ri) {
  __shared__ int32_t s_off[kExpShare + 1];
  __shared__ int32_t s_row[kExpShare];
  __shared__ int32_t s_k[kExpShare];
  __shared__ long long s_split[2], s_hi[2];
  __shared__ int s_true[kExpThreads / 32];
  const int t = threadIdx.x;
  // without a tail every slot is the expansion's: no load to wait on
  const long long total_left = unmatched != nullptr ? off[cl] : m;
  if ((long long)blockIdx.x >= exp_blocks) {  // the full-outer tail
    const long long r0 = ((long long)blockIdx.x - exp_blocks) * kExpShare;
    const long long r1 = r0 + kExpShare < cr ? r0 + kExpShare : cr;
    for (long long r = r0 + t; r < r1; r += kExpThreads) {
      if (unmatched[r] == 0) continue;
      const long long slot = total_left + uoff[r];
      li[slot] = -1;
      ri[slot] = (int32_t)r;
    }
    return;
  }
  const long long items = cl + total_left;
  const long long d0 = (long long)blockIdx.x * kExpShare;
  if (d0 >= items) return;
  const long long d1 = d0 + kExpShare < items ? d0 + kExpShare : items;
  block_split(off, cl, total_left, d0, d1, s_split, s_hi, s_true);
  const long long a0 = s_split[0], a1 = s_split[1];
  const long long b0 = d0 - a0;
  const int na = (int)(a1 - a0), nb = (int)(d1 - a1 - b0);
  if (nb == 0) return;  // only run ends: rows without output
  for (int i = t; i <= na; i += kExpThreads) s_off[i] = off[a0 + i];
  __syncthreads();
  // this thread's diagonal in the window: ends s_off[1..na], slots b0..
  const int n = na + nb;
  const int dl = t * kExpItems < n ? t * kExpItems : n;
  int lo = dl - nb > 0 ? dl - nb : 0, hi = dl < na ? dl : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((long long)s_off[mid + 1] <= b0 + (dl - 1 - mid))
      lo = mid + 1;
    else
      hi = mid;
  }
  // the walk, in shared memory only: each slot's row and rank in its run
  int a = lo, b = dl - lo;
  const int steps = n - dl < kExpItems ? n - dl : kExpItems;
  for (int v = 0; v < steps; ++v) {
    if (a < na && (b >= nb || (long long)s_off[a + 1] <= b0 + b)) {
      ++a;  // the run of row a0 + a ends here
      continue;
    }
    s_row[b] = (int32_t)(a0 + a);
    s_k[b] = (int32_t)(b0 + b - s_off[a]);
    ++b;
  }
  __syncthreads();
  // the slots in slot order: neighbouring threads read neighbouring rows'
  // cnt and start and a run's consecutive build rows, and store together
#pragma unroll
  for (int v = 0; v < kExpItems; ++v) {
    const int i = v * kExpThreads + t;
    if (i < nb) {
      const int32_t row = s_row[i], k = s_k[i];
      int32_t r = -1;
      if (take_right) {  // cnt and start in flight together
        const int32_t c = cnt[row], s0 = start[row];
        if (k < c) r = rperm[s0 + k];
      }
      li[b0 + i] = row;
      ri[b0 + i] = r;
    }
  }
}

// One tile of counts a block, in ticket order: out[i] = the exclusive sum
// (int32, wrapping as the int32 offsets do; the tile sums travel exactly
// in 64 bits), out[n] the total from the last tile.
__global__ void __launch_bounds__(kThreads)
offsets_kernel(const int32_t* __restrict__ v, long long n, long long ntiles,
               unsigned long long* __restrict__ status,
               int32_t* __restrict__ out) {
  __shared__ int32_t s_v[kTile + kTile / 32];
  __shared__ unsigned s_wincl[kThreads / 32];
  __shared__ long long s_wsum[kThreads / 32];
  __shared__ unsigned long long s_before;
  __shared__ long long s_tile;
  __shared__ int s_last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long tile = lookback_ticket(status, &s_tile);
  const long long base = tile * kTile;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int q = k * kThreads + t;
    const long long i = base + q;
    s_v[q + (q >> 5)] = i < n ? v[i] : 0;
  }
  __syncthreads();
  const int q0 = t * kItems, pad = t >> 1;  // (q0 + j) >> 5 for j < 16
  unsigned s32 = 0u;
  long long s64 = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int32_t x = s_v[q0 + j + pad];
    s32 += (unsigned)x;
    s64 += x;
  }
  unsigned incl = s32;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(kFullMask, incl, d);
    if (lane >= d) incl += y;
  }
  long long w64 = s64;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) w64 += __shfl_xor_sync(kFullMask, w64, d);
  if (lane == 31) s_wincl[warp] = incl;
  if (lane == 0) s_wsum[warp] = w64;
  __syncthreads();
  if (warp == 0) {
    long long agg = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) agg += s_wsum[w];
    const unsigned long long before =
        lookback_prefix(status, tile, (unsigned long long)agg);
    if (lane == 0) {
      s_before = before;
      if (tile == ntiles - 1)
        out[n] = (int32_t)(long long)(before + (unsigned long long)agg);
    }
  }
  __syncthreads();
  unsigned run = (unsigned)s_before + incl - s32;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w)
    if (w < warp) run += s_wincl[w];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int idx = q0 + j + pad;
    const unsigned x = (unsigned)s_v[idx];
    s_v[idx] = (int32_t)run;
    run += x;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int q = k * kThreads + t;
    const long long i = base + q;
    if (i < n) out[i] = s_v[q + (q >> 5)];
  }
  lookback_done(status, ntiles, &s_last);
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

// out[i] = sum(v[0..i)) for i in [0, n], so out[n] is the total.  One
// launch of max(ceil(n / kTile), 1) blocks; status: the look-back's
// uint64 words (at least that many blocks + 2), zero on entry and left
// zero.
int srt_join_offsets(const void* v, int64_t n, void* status, void* out,
                     void* stream) {
  const long long nt = n > 0 ? (n + kTile - 1) / kTile : 1;
  offsets_kernel<<<(unsigned)nt, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)v, n, nt, (unsigned long long*)status,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

// The m output slots, one launch: slots [0, offsets[cl]) from the
// expansion (li = stream row, ri = build row or -1), and where unmatched
// is not null (a full outer join), unmatched build row r of the cr at
// slot offsets[cl] + uoff[r] (li = -1, ri = r).  m is the probe's total,
// which the host has read; nothing is launched for m == 0.
int srt_join_expand(const void* offsets, int64_t cl, const void* cnt,
                    const void* start, const void* rperm, int64_t m,
                    int take_right, const void* unmatched, const void* uoff,
                    int64_t cr, void* li, void* ri, void* stream) {
  if (m <= 0) return (int)cudaGetLastError();
  const long long exp_blocks = (cl + m + kExpShare - 1) / kExpShare;
  const long long tail_blocks =
      unmatched != nullptr ? (cr + kExpShare - 1) / kExpShare : 0;
  expand_kernel<<<(unsigned)(exp_blocks + tail_blocks), kExpThreads, 0,
                  (cudaStream_t)stream>>>(
      (const int32_t*)offsets, cl, (const int32_t*)cnt,
      (const int32_t*)start, (const int32_t*)rperm, take_right, m,
      exp_blocks,
      (const int32_t*)unmatched, (const int32_t*)uoff, cr, (int32_t*)li,
      (int32_t*)ri);
  return (int)cudaGetLastError();
}

// matched[ri[j]] = 1 for every slot j with ri[j] >= 0.
int srt_join_mark(const void* ri, int64_t m, void* matched, void* stream) {
  if (m > 0)
    mark_kernel<<<grid_for(m, 32), srt::kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ri, m, (uint8_t*)matched);
  return (int)cudaGetLastError();
}

// The constants the Python wrapper shares with this file, in the order of
// ops/join.py's ``native.share_limits("join_expand", ...)``: threads and
// items of an expansion block, rows a tile of the offsets scan.
int srt_join_expand_limits(int64_t* out, int n) {
  const int64_t v[] = {kExpThreads, kExpItems, kTile};
  for (int i = 0; i < n && i < (int)(sizeof(v) / sizeof(v[0])); ++i)
    out[i] = v[i];
  return 0;
}

}  // extern "C"
