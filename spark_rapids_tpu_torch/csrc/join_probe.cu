// K5: the prepared-build probe of the equi-join fast path (and the search
// of K6's rank path).
//
// Replaces spark_rapids_tpu/ops/join.py:127 `build_prepare_fast` (the
// rewrite of the sorted build keys: slots at or past nv become the dtype
// max) and :152 `probe_fast` (two jnp.searchsorted passes, the clip to nv,
// the per-join-type counts of `_out_cnt` :170 and a jnp.sum for the total),
// and writes the exclusive offsets of the output counts that
// :216 `join_indices_from_probe` takes with jnp.cumsum.
//
// Design:
//   * build_keys_kernel runs once a build side, after K1 has sorted its
//     rows as [null flag, key]: a thread a sorted slot writes the key (or
//     the dtype max for a null row), the thread at the last valid slot
//     writes nv (nv never leaves the device), and the slots at multiples
//     of F^j write the search layout's level j.  The layout is a static
//     tree whose leaves are the sorted keys themselves: a node is one
//     32-byte sector of F = 32 / sizeof(key) keys, level j holds every
//     F^j-th sorted key (each level padded to whole nodes), and the levels
//     stop at the first, k, that fits kStageBytes.  Over K6's sorted rank
//     ids the same kernel writes only the levels.
//   * search_kernel, one launch a probe over tiles of kTile stream rows
//     taken in ticket order.  With a layout, a block copies level k into
//     shared memory and, for each of a thread's rows (kRows at a time, all
//     their loads issued together), finds in it the node to read at level
//     k - 1, reads that one sector, counts the keys below the row's key
//     and descends, down to the leaf sector of the sorted keys: a row
//     reads k sectors from L2, where a binary search over the whole array
//     reads ~log2(nb) sectors of which the lower ~10 are different for
//     every row.  The leaf sector also gives the upper bound of a key that
//     ends inside it (no further load); a key whose run reaches the
//     sector's end gallops on from there.  end is clipped to nv and start
//     to end, a null stream key counts 0, and the join type picks
//     out_cnt (inner: cnt; left/full: max(cnt, 1); semi: cnt > 0; anti:
//     cnt == 0).  The tile then ranks its out_cnt in row order (a thread's
//     16 counts read back in row order from shared memory, a warp scan,
//     the warps' sums) and takes its exclusive offset from the ticketed
//     decoupled look-back of common.cuh (62-bit sums: no tile's or batch's
//     total wraps), and writes the int32 offsets of out_cnt with the total
//     at offsets[n], which K7's expansion reads; the last tile writes (or,
//     for full outer's second search, adds) the int64 total the host reads,
//     so no fill launch precedes the search, and clears the status.  The
//     int32 offsets are meaningful only where that total fits in int32,
//     which the wrapper checks before K7 reads them.
//   * Over K6's rank ids the kernel runs with no validity and no nv: a
//     left id of INT32_MAX (a null key) lies above every right id and
//     finds an empty range.  The rank path's sorted ids are new each call;
//     their layout is staged whole in shared memory up to kStageBytes (no
//     build), and past that its levels are written by one levels-only
//     launch of the build kernel before the search.
//
// Bound on the H100: bytes.  Each stream row reads its key and validity and
// writes four int32s (start, cnt, out_cnt, its offset); the sorted build
// keys and the layout are read once.  The design reads k + 1 random
// sectors a row from L2 (k = 2 at 501,187 int32 keys) and level k once a
// block.
#include <cstring>

#include "common.cuh"

namespace srt_probe {

using namespace srt;

constexpr int kNodeBytes = 32;      // a node: one 32-byte sector
constexpr int kStageBytes = 32768;  // the level staged in shared memory
constexpr int kMaxLevels = 16;
constexpr int kRows = 4;  // rows a thread searches at once
// the tile's out_cnt in row order, one pad word every 32 (no bank
// conflicts when a thread reads its 16 consecutive rows)
constexpr int kPadded = kTile + kTile / 32;
constexpr int kSharedBytes =
    kStageBytes > 4 * kPadded ? kStageBytes : 4 * kPadded;

template <typename T>
__device__ __forceinline__ T max_value();
template <> __device__ __forceinline__ int8_t max_value<int8_t>() { return 127; }
template <> __device__ __forceinline__ int16_t max_value<int16_t>() { return 32767; }
template <> __device__ __forceinline__ int32_t max_value<int32_t>() { return 2147483647; }
template <> __device__ __forceinline__ long long max_value<long long>() {
  return 9223372036854775807LL;
}

// The layout's geometry, from nb, the key width and k alone (the wrapper,
// ops/join.py `search_levels`, computes the same): size[j] = ceil(nb /
// F^j), level j (1 <= j <= k) at element off[j] of the levels array, each
// level padded to whole nodes.
struct Levels {
  long long off[kMaxLevels + 1];
  long long size[kMaxLevels + 1];
  int k;
};

inline bool make_levels(long long nb, int item, int k, Levels* lv) {
  if (k < 0 || k > kMaxLevels ||
      (item != 1 && item != 2 && item != 4 && item != 8))
    return false;
  const long long f = kNodeBytes / item;
  lv->k = k;
  lv->size[0] = nb;
  lv->off[0] = 0;
  long long at = 0;
  for (int j = 1; j <= k; ++j) {
    lv->size[j] = (lv->size[j - 1] + f - 1) / f;
    lv->off[j] = at;
    at += (lv->size[j] + f - 1) / f * f;
  }
  return true;
}

template <typename T>
__global__ void build_keys_kernel(const T* __restrict__ key,
                                  const uint8_t* __restrict__ valid,
                                  const int32_t* __restrict__ perm, int64_t n,
                                  T* __restrict__ skey,
                                  int32_t* __restrict__ nv,
                                  T* __restrict__ levels, Levels lv) {
  constexpr long long F = kNodeBytes / sizeof(T);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int32_t r = perm != nullptr ? perm[i] : (int32_t)i;
    const bool v = valid == nullptr || valid[r] != 0;
    const T x = v ? key[r] : max_value<T>();
    if (skey != nullptr) skey[i] = x;
    if (nv != nullptr && v &&
        (i + 1 == n || valid[perm[i + 1]] == 0))
      *nv = (int32_t)(i + 1);
    long long step = F;
    for (int j = 1; j <= lv.k && i % step == 0; ++j, step *= F)
      levels[lv.off[j] + i / step] = x;
  }
}

template <typename T>
struct SearchParams {
  const T* lkey;
  const uint8_t* lvalid;  // null: every row valid
  const T* skey;
  const int32_t* nv;      // null: nv = nb
  const T* levels;        // the layout's levels 1..k (tree search only)
  int32_t* start;         // start and cnt may be null
  int32_t* cnt;
  int32_t* out_cnt;
  int32_t* offsets;       // [n + 1]
  long long* total;
  unsigned long long* status;
  long long n, nb, ntiles;
  int jt, add_total;
  Levels lv;
};

// Per row r, the first position in a[0, len) whose value is >= x[r]
// (kUpper: > x[r]): uniform steps, every row's load of a step together.
template <typename T, bool kUpper>
__device__ __forceinline__ void bounds(const T* a, long long len,
                                       const T (&x)[kRows],
                                       long long (&out)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[r] = 0;
  while (len > 1) {
    const long long half = len >> 1;
    T v[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) v[r] = a[out[r] + half];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (kUpper ? !(x[r] < v[r]) : (v[r] < x[r])) out[r] += half;
    len -= half;
  }
  if (len == 1) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const T v = a[out[r]];
      out[r] += (kUpper ? !(x[r] < v) : (v < x[r])) ? 1 : 0;
    }
  }
}

// First position in a[lo, nb) whose value is > x, given a[lo - 1] == x:
// probe lo, lo + 1, lo + 3, lo + 7, ... until a value above x, then search
// the last stride.
template <typename T>
__device__ __forceinline__ long long gallop_upper(const T* __restrict__ a,
                                                  long long lo, long long nb,
                                                  T x) {
  long long step = 1;
  while (true) {
    const long long probe = lo + step - 1;
    long long hi;
    if (probe >= nb) {
      hi = nb;
    } else if (a[probe] > x) {
      hi = probe;
    } else {
      lo = probe + 1;
      step <<= 1;
      continue;
    }
    while (lo < hi) {
      const long long mid = lo + ((hi - lo) >> 1);
      if (a[mid] <= x)
        lo = mid + 1;
      else
        hi = mid;
    }
    return lo;
  }
}

template <typename T>
__device__ __forceinline__ T shfl_xor1(T v) {
  if (sizeof(T) == 8)
    return (T)__shfl_xor_sync(kFullMask, (long long)v, 1);
  return (T)__shfl_xor_sync(kFullMask, (int)v, 1);
}

// Keys of half `h` (16 bytes) of a node at `node`, of a level of `size`
// keys, that are below x (kUpper: at most x).
template <typename T, bool kUpper>
__device__ __forceinline__ int half_count(const uint4& u, long long node,
                                          int h, long long size, T x) {
  constexpr int H = 16 / sizeof(T);
  const T* k = reinterpret_cast<const T*>(&u);
  const long long first = node * (2 * H) + h * H;
  int c = 0;
#pragma unroll
  for (int q = 0; q < H; ++q)
    c += (first + q < size && (kUpper ? !(x < k[q]) : (k[q] < x))) ? 1 : 0;
  return c;
}

// The tree search of kRows rows: [lo, hi) in the sorted keys.  The two
// lanes of a pair read each node together, one 16-byte half each (a warp
// load touches 16 sectors, not 32), and add their counts by a shuffle;
// every lane of the warp takes part, so the levels run in step.
template <typename T>
__device__ __forceinline__ void tree_search(const SearchParams<T>& p,
                                            const T* s_stage,
                                            const T (&x)[kRows],
                                            long long (&lo)[kRows],
                                            long long (&hi)[kRows]) {
  constexpr int F = kNodeBytes / sizeof(T);
  const long long nb = p.nb;
  const int k = p.lv.k;
  long long b[kRows];
  bounds<T, false>(s_stage, p.lv.size[k], x, b);
  if (k == 0) {  // the sorted keys are all in shared memory
    bounds<T, true>(s_stage, nb, x, hi);
#pragma unroll
    for (int r = 0; r < kRows; ++r) lo[r] = b[r];
    return;
  }
  const int me = threadIdx.x & 1;
  T xo[kRows];  // the partner's keys
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    xo[r] = shfl_xor1(x[r]);
    // b: the node to read at level k - 1 (the last key of level k below x)
    b[r] = b[r] > 0 ? b[r] - 1 : 0;
  }
  for (int j = k - 1; j >= 0; --j) {
    const T* level = j == 0 ? p.skey : p.levels + p.lv.off[j];
    const long long nj = p.lv.size[j];
    long long bo[kRows];
    uint4 ue[kRows], uo[kRows];  // my half of the even and the odd lane's
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      bo[r] = __shfl_xor_sync(kFullMask, b[r], 1);
      const long long be = me ? bo[r] : b[r], bd = me ? b[r] : bo[r];
      ue[r] = reinterpret_cast<const uint4*>(level + F * be)[me];
      uo[r] = reinterpret_cast<const uint4*>(level + F * bd)[me];
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long be = me ? bo[r] : b[r], bd = me ? b[r] : bo[r];
      const T xe = me ? xo[r] : x[r], xd = me ? x[r] : xo[r];
      int ce = half_count<T, false>(ue[r], be, me, nj, xe);
      int cd = half_count<T, false>(uo[r], bd, me, nj, xd);
      ce += __shfl_xor_sync(kFullMask, ce, 1);
      cd += __shfl_xor_sync(kFullMask, cd, 1);
      const int c = me ? cd : ce;
      if (j > 0) {
        b[r] = F * b[r] + (c > 0 ? c - 1 : 0);
        continue;
      }
      // the leaf sector of the sorted keys: the lower bound, and the
      // upper one where the key's run ends inside the sector
      int ke = half_count<T, true>(ue[r], be, me, nj, xe);
      int kd = half_count<T, true>(uo[r], bd, me, nj, xd);
      ke += __shfl_xor_sync(kFullMask, ke, 1);
      kd += __shfl_xor_sync(kFullMask, kd, 1);
      const int c2 = me ? kd : ke;
      const long long p0 = F * b[r];
      const long long m = nb - p0 < F ? nb - p0 : F;
      lo[r] = p0 + c;
      hi[r] = c2 > c ? ((c2 < m || p0 + m == nb) ? p0 + c2 : -1)
                     : ((c < m || lo[r] >= nb) ? lo[r] : -2);
    }
  }
  // the runs that leave their sector gallop on (lanes apart)
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (hi[r] == -1) {
      hi[r] = gallop_upper(p.skey, F * b[r] + F, nb, x[r]);
    } else if (hi[r] == -2) {  // every key of the sector is below x
      hi[r] = !(x[r] < p.skey[lo[r]])
                  ? gallop_upper(p.skey, lo[r] + 1, nb, x[r])
                  : lo[r];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
search_kernel(const __grid_constant__ SearchParams<T> p) {
  __shared__ __align__(16) unsigned char s_raw[kSharedBytes];
  __shared__ unsigned s_wincl[kThreads / 32];
  __shared__ long long s_wsum[kThreads / 32];
  __shared__ unsigned long long s_before;
  __shared__ long long s_tile;
  __shared__ int s_last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long tile = lookback_ticket(p.status, &s_tile);
  const long long base = tile * kTile;
  {  // level k into shared memory, 16 bytes a load
    const int k = p.lv.k;
    const uint4* src = reinterpret_cast<const uint4*>(
        k == 0 ? p.skey : p.levels + p.lv.off[k]);
    const long long nvec =
        (p.lv.size[k] * (long long)sizeof(T) + 15) / 16;
    uint4* dst = reinterpret_cast<uint4*>(s_raw);
#pragma unroll 4
    for (long long q = t; q < nvec; q += kThreads) dst[q] = src[q];
    __syncthreads();
  }
  const T* s_stage = reinterpret_cast<const T*>(s_raw);
  const long long nv = p.nv != nullptr ? (long long)*p.nv : p.nb;
  int o[kItems];
#pragma unroll
  for (int k0 = 0; k0 < kItems; k0 += kRows) {
    T x[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long i = base + (long long)(k0 + r) * kThreads + t;
      x[r] = i < p.n ? p.lkey[i] : T(0);
    }
    long long lo[kRows], hi[kRows];
    tree_search(p, s_stage, x, lo, hi);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long i = base + (long long)(k0 + r) * kThreads + t;
      o[k0 + r] = 0;
      if (i >= p.n) continue;
      const long long e = hi[r] < nv ? hi[r] : nv;
      const long long s = lo[r] < e ? lo[r] : e;
      const bool v = p.lvalid == nullptr || p.lvalid[i] != 0;
      const int32_t c = v ? (int32_t)(e - s) : 0;
      int32_t out;
      switch (p.jt) {
        case 0: out = c; break;                 // inner
        case 1: out = c > 1 ? c : 1; break;     // left, full
        case 2: out = c > 0 ? 1 : 0; break;     // semi
        default: out = c == 0 ? 1 : 0; break;   // anti
      }
      if (p.start != nullptr) p.start[i] = (int32_t)s;
      if (p.cnt != nullptr) p.cnt[i] = c;
      p.out_cnt[i] = out;
      o[k0 + r] = out;
    }
  }
  // the tile's offsets: out_cnt in row order in shared memory, a thread's
  // 16 consecutive rows summed (int32 offsets wrap with the int32 the host
  // checks; the tile's sum is kept exactly in 64 bits)
  __syncthreads();  // the staged level is read no more
  int32_t* s_o = reinterpret_cast<int32_t*>(s_raw);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int q = k * kThreads + t;
    s_o[q + (q >> 5)] = o[k];
  }
  __syncthreads();
  const int q0 = t * kItems, pad = t >> 1;  // (q0 + j) >> 5 for j < 16
  unsigned s32 = 0u;
  long long s64 = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int32_t v = s_o[q0 + j + pad];
    s32 += (unsigned)v;
    s64 += v;
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
        lookback_prefix(p.status, tile, (unsigned long long)agg);
    if (lane == 0) {
      s_before = before;
      if (tile == p.ntiles - 1) {
        const long long all = (long long)(before + (unsigned long long)agg);
        p.offsets[p.n] = (int32_t)all;
        if (p.add_total)
          *p.total += all;
        else
          *p.total = all;
      }
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
    const unsigned v = (unsigned)s_o[idx];
    s_o[idx] = (int32_t)run;
    run += v;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int q = k * kThreads + t;
    const long long i = base + q;
    if (i < p.n) p.offsets[i] = s_o[q + (q >> 5)];
  }
  lookback_done(p.status, p.ntiles, &s_last);
}

template <typename T>
int search(const void* lkey, const void* lvalid, int64_t n, const void* skey,
           int64_t nb, const void* nv, const void* levels, int k, int jt,
           void* start, void* cnt, void* out_cnt, void* offsets, void* total,
           int add_total, void* status, cudaStream_t st) {
  SearchParams<T> p;
  p.lkey = (const T*)lkey;
  p.lvalid = (const uint8_t*)lvalid;
  p.skey = (const T*)skey;
  p.nv = (const int32_t*)nv;
  p.levels = (const T*)levels;
  p.start = (int32_t*)start;
  p.cnt = (int32_t*)cnt;
  p.out_cnt = (int32_t*)out_cnt;
  p.offsets = (int32_t*)offsets;
  p.total = (long long*)total;
  p.status = (unsigned long long*)status;
  p.n = n;
  p.nb = nb;
  p.ntiles = num_tiles(n);
  p.jt = jt;
  p.add_total = add_total;
  // the staged level fits, and every level the search reads is a whole
  // number of aligned sectors
  if (!make_levels(nb, (int)sizeof(T), k, &p.lv) ||
      p.lv.size[k] * (long long)sizeof(T) > kStageBytes ||
      (k > 0 && p.lv.size[k - 1] * (long long)sizeof(T) <= kStageBytes) ||
      ((uintptr_t)skey & (kNodeBytes - 1)) != 0 ||
      (k > 0 && (levels == nullptr ||
                 ((uintptr_t)levels & (kNodeBytes - 1)) != 0)))
    return (int)cudaErrorInvalidValue;
  search_kernel<T><<<(int)p.ntiles, kThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
void launch_build(const void* key, const void* valid, const void* perm,
                  int64_t n, void* skey, void* nv, void* levels,
                  const Levels& lv, cudaStream_t st) {
  build_keys_kernel<T><<<grid_for(n, 32), kThreads, 0, st>>>(
      (const T*)key, (const uint8_t*)valid, (const int32_t*)perm, n,
      (T*)skey, (int32_t*)nv, (T*)levels, lv);
}

}  // namespace srt_probe

using namespace srt_probe;

extern "C" {

// skey[i] = key[perm[i]] for the valid rows (sorted first by K1), the dtype
// max for the rest; nv (zeroed by the caller) = number of valid rows; and
// the search layout's levels 1..k (ops/join.py `search_levels`) where k >
// 0.  perm null: the identity; valid null: every row valid (then nv must
// be null); skey null: the keys are not written (the rank path's levels
// over ids already sorted, read from key).
int srt_join_build_keys(const void* key, const void* valid, const void* perm,
                        int64_t n, int item, void* skey, void* nv,
                        void* levels, int k, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Levels lv;
  if (!make_levels(n, item, k, &lv)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  if ((k > 0 && levels == nullptr) ||
      (nv != nullptr && (valid == nullptr || perm == nullptr)))
    return (int)cudaErrorInvalidValue;
  switch (item) {
    case 1: launch_build<int8_t>(key, valid, perm, n, skey, nv, levels, lv, st); break;
    case 2: launch_build<int16_t>(key, valid, perm, n, skey, nv, levels, lv, st); break;
    case 4: launch_build<int32_t>(key, valid, perm, n, skey, nv, levels, lv, st); break;
    case 8: launch_build<long long>(key, valid, perm, n, skey, nv, levels, lv, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Per stream row: start/cnt (either may be NULL), out_cnt by join type (0
// inner, 1 left/full, 2 semi, 3 anti) and offsets[n + 1], its exclusive
// int32 offsets with the total last; the int64 total is written to *total
// (add_total: added to it).  lvalid NULL: every row valid; nv NULL: nv =
// nb.  k: the search layout's staged level (the first that fits
// kStageBytes; ops/join.py `search_levels`), whose levels 1..k the build
// wrote to levels.
// status: uint64[ntiles + 2] of zeros (left zero).  n >= 1.
int srt_join_search(const void* lkey, const void* lvalid, int64_t n,
                    const void* skey, int64_t nb, const void* nv,
                    const void* levels, int k, int item, int jt, void* start,
                    void* cnt, void* out_cnt, void* offsets, void* total,
                    int add_total, void* status, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 1 || lkey == nullptr || out_cnt == nullptr || offsets == nullptr ||
      total == nullptr || status == nullptr || jt < 0 || jt > 3 ||
      (nb > 0 && skey == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (item) {
    case 1: return search<int8_t>(lkey, lvalid, n, skey, nb, nv, levels, k, jt, start, cnt, out_cnt, offsets, total, add_total, status, st);
    case 2: return search<int16_t>(lkey, lvalid, n, skey, nb, nv, levels, k, jt, start, cnt, out_cnt, offsets, total, add_total, status, st);
    case 4: return search<int32_t>(lkey, lvalid, n, skey, nb, nv, levels, k, jt, start, cnt, out_cnt, offsets, total, add_total, status, st);
    case 8: return search<long long>(lkey, lvalid, n, skey, nb, nv, levels, k, jt, start, cnt, out_cnt, offsets, total, add_total, status, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The constants the Python wrapper shares with this file, in the order of
// ops/join.py's ``native.share_limits`` call: stream rows a tile, node
// bytes, staged bytes, the most levels.  Writes the first n of them.
int srt_join_probe_limits(int64_t* out, int n) {
  const int64_t v[] = {srt::kTile, kNodeBytes, kStageBytes, kMaxLevels};
  for (int i = 0; i < n && i < (int)(sizeof(v) / sizeof(v[0])); ++i)
    out[i] = v[i];
  return 0;
}

}  // extern "C"
