// K4: segmented aggregation over key-sorted rows, three launches a call
// over every aggregate.
//
// Replaces spark_rapids_tpu/ops/segmented.py:68 `sorted_group_by` (with
// `_cols_differ` :50 and `_compute_agg` :163), which XLA runs as boundary
// flags, a cumsum into segment ids, and one segment_sum/min/max per
// aggregate over a capacity-sized segment space.
//
// Design, for rows already sorted by the keys (K1 + K3).  A tile is kTile
// (4096) consecutive rows, one block.
//   * srt_seg_bounds, one launch over every key column (the key table by
//     value, __grid_constant__, or a device copy where it is long): a
//     thread takes the tile's rows t, t + 256, ... so that every warp load
//     covers 32 neighbouring rows, flags each row whose key differs from
//     the row before it (null == null, NaN == NaN, -0.0 == 0.0, strings by
//     bytes and length; flag[0] = `first`) -- no load waits on a compare,
//     so four rows' loads are in flight at a time, not one row's -- and the
//     tile's flags go out through shared memory as 16-byte stores.  With the tile offsets
//     wanted, an integer decoupled look-back (common.cuh) over the tiles'
//     (flag count, has a flag) pairs gives each tile the segments started
//     before it and the tiles with a flag before it: tile_offsets[t], the
//     list of tiles that hold a flag (span_tiles), and, from the last tile,
//     the group count G and that list's length S at tile_offsets[ntiles]
//     and [ntiles + 1], which the wrapper reads once to size the outputs.
//   * srt_seg_agg_tiles, one launch over every aggregate.  The wrapper
//     deduplicates the specs into jobs (one accumulator each: a sum of
//     doubles serves sum and avg, a count rides on any job whose rows are
//     the valid ones) and groups the jobs by input column into a table by
//     value.  A block takes one tile: it reads the tile's flags once (a
//     16-byte load a thread of its 16 consecutive rows), ranks them with one
//     block scan and writes `starts` (each group's first row; K3 gathers
//     the keys from them).  It reads each distinct input column and its
//     validity once: the values striped across the threads (coalesced)
//     into shared memory (one pad slot every 16 rows, so that each thread
//     reads its 16 consecutive rows without bank conflicts), 8-byte columns
//     by cp.async into two buffers, so that column c + 1 lands while the
//     block folds column c.  For every job over the column a thread folds its rows, one
//     cub::BlockScan with the segmented operator (flag, state) hands each
//     thread the open segment's state so far, and a segment that starts
//     and ends in the tile is finished there: its outputs are written.  A
//     tile without a flag (most of them where groups are few) is one
//     piece, folded in a fixed tree with no scan; a thread without a flag
//     makes no second pass over its rows.
//     Per job the tile leaves two pieces: its head (rows before its first
//     flag, or the whole tile) and its tail (from its last flag to its
//     end; empty without a flag).
//   * srt_seg_agg_combine, one launch over every (spanning segment, job)
//     pair: a segment that crosses a tile boundary is the last one started
//     in a tile a that holds a flag; its pieces are tail(a), then head and
//     tail of each tile up to the tile b of the next group's start (the
//     tails empty between), consecutive slots [2a + 1, 2b + 1) of the job.
//     A block folds them in a fixed order and tree shape (each thread a
//     contiguous run, an ordered shuffle tree, the warps in order) and
//     writes the outputs; blocks are a warp where the pieces are few.
// No atomics on values and no float look-back: a double sum comes out with
// the same bits on every run (its association depends only on the data),
// and first/last keep their row order.  A grand aggregate (no keys) needs
// no boundary pass: the tile launch takes row 0 as the only flag.
//
// Covered ops: sum (int64 and double accumulation), avg, count,
// count_star, min/max over integers, booleans, dates and floats (Spark
// NaN semantics: NaN is the largest value), and first/last with or without
// ignoreNulls (as a row index; the wrapper gathers the values with K3).
//
// Bound on the H100: bytes.  Each key column and each distinct input
// column and its validity are read once; the outputs hold one row per
// group.  The design adds a flag byte a row, written once and read once.
//
// K4p, the percentile pick (srt_seg_percentile), replaces
// spark_rapids_tpu/ops/segmented.py:262-281: rows arrive sorted by (keys,
// value ascending, value nulls last) from K1 (:84-91), so segment g's valid
// values are values[start[g] .. start[g] + count[g]), NaN last (the counts
// are a count job of the tile launch).  One thread per (q, segment)
// computes pos = (count - 1) * q, lo = floor(pos), hi = ceil(pos) and v[lo]
// + (v[hi] - v[lo]) * (pos - lo); one launch serves every q over a column.
// Every step is written with an explicitly rounded intrinsic, so nvcc
// cannot contract the multiply-add into an FMA and the result equals the
// plain PyTorch version (and the reference's formula) bit for bit: inf -
// inf gives NaN, as there.  Bound: bytes, per (q, segment) a 4 B start, an
// 8 B count, two 8 B gathers, 8 B + 1 B out.
//
// K4s, string min/max (srt_seg_string_minmax), replaces
// spark_rapids_tpu/ops/segmented.py:216-238, which sorts (segment,
// non-contributing flag, the string's key words) with lax.sort and takes
// each segment's first row.  Rows reach K4 already sorted by the keys,
// with the segment flags, tile offsets and starts of the launches above,
// so the second sort is not needed: K4s is a tile + combine reduction of
// its own (string_tile_kernel, string_combine_kernel), its state the row
// index of the least (greatest) valid string so far.  Two rows compare as
// the reference's sort operands order them (ops/sort.py
// encode_key_operands): the padded bytes as big-endian 32-bit words, then
// the length (a NUL tail sorts by length); rows equal in both hold the
// same bytes, so which of them wins does not change the result.  Null rows
// never win; a segment without a valid row gets -1, and the wrapper
// gathers the winners with K3 (-1: a null row).  One segment of 2^24 rows
// is folded by 4096 tiles and one warp over their pieces; 2^20 one-row
// segments by one warp each.  Bound: bytes, each row read once (its words
// up to the first difference), plus its length, validity and flag; the
// winners' rows once more by K3.
#include <cstring>

#include "common.cuh"

namespace srt_seg {

using namespace srt;

enum ValKind { kInt = 0, kFloat = 1, kBool = 2, kString = 3, kFlag = 4 };

// The jobs' accumulators (kMinS/kMaxS: K4s).
enum AggOp {
  kSumI = 0, kSumF = 1, kCount = 3, kCountStar = 4, kMinI = 5, kMaxI = 6,
  kMinF = 7, kMaxF = 8, kFirst = 9, kLast = 10, kFirstNonNull = 11,
  kLastNonNull = 12, kMinS = 13, kMaxS = 14
};

// What an output takes of its job's state.
enum OutMode { kOutValue = 0, kOutAvg = 1, kOutCount = 2, kOutPick = 3 };

// Table words: a key column of the boundary pass -- data, validity (0:
// every row valid), lengths (0: fixed width), kind | row bytes << 8; an
// input column of the aggregate -- data (0: none), validity (0: every row
// valid), kind | staged << 8 | item << 16, first job | jobs << 32; a job --
// its op, first output | outputs << 32; an output -- data, validity (0:
// none), mode | kind << 8 | item << 16.  The aggregate's table is its
// columns, then its jobs, then its outputs.
constexpr int kKeyWords = 4;
constexpr int kColWords = 4;
constexpr int kJobWords = 2;
constexpr int kOutWords = 3;
constexpr int kKeySmallWords = 128;  // 1,024 bytes of parameters
constexpr int kAggSmallWords = 480;  // 3,840 bytes
constexpr int kAggLargeWords = 4000;  // 32,000 bytes
// the count fields of the boundary pass's look-back: flags | tiles << 31
constexpr unsigned long long kCountMask = (1ull << 31) - 1ull;
// rows of a tile staged in shared memory: one pad slot every kItems rows
constexpr int kStage = kTile + kTile / kItems;

template <typename A>
struct St {
  A acc;
  long long cnt;
};

// A state as it lies in a slot: the accumulator's bits and the count.
struct St8 {
  long long a;
  long long c;
};

__device__ __forceinline__ St8 pack(St<long long> s) { return {s.acc, s.cnt}; }
__device__ __forceinline__ St8 pack(St<double> s) {
  return {__double_as_longlong(s.acc), s.cnt};
}
template <typename A>
__device__ __forceinline__ St<A> unpack(St8 s);
template <>
__device__ __forceinline__ St<long long> unpack<long long>(St8 s) {
  return {s.a, s.c};
}
template <>
__device__ __forceinline__ St<double> unpack<double>(St8 s) {
  return {__longlong_as_double(s.a), s.c};
}

// Spark order for doubles: NaN is larger than every other value.
__device__ __forceinline__ bool nan_less(double a, double b) {
  return (a < b) || (b != b && a == a);
}

// A staged value: a sign-extended integer, or a double's bits (kFloat).
__device__ __forceinline__ double as_f64(long long x, bool fl) {
  return fl ? __longlong_as_double(x) : (double)x;
}

struct SumI {
  typedef long long A;
  static constexpr bool kStaged = true;
  static __device__ bool elig(bool valid) { return valid; }
  static __device__ A lift(long long x, bool, long long) { return x; }
  static __device__ St<A> comb(St<A> a, St<A> b) {
    return {(A)((unsigned long long)a.acc + (unsigned long long)b.acc),
            a.cnt + b.cnt};
  }
};
struct SumF {
  typedef double A;
  static constexpr bool kStaged = true;
  static __device__ bool elig(bool valid) { return valid; }
  static __device__ A lift(long long x, bool fl, long long) {
    return as_f64(x, fl);
  }
  static __device__ St<A> comb(St<A> a, St<A> b) {
    return {a.acc + b.acc, a.cnt + b.cnt};
  }
};
template <bool kAll>
struct CountOp {
  typedef long long A;
  static constexpr bool kStaged = false;
  static __device__ bool elig(bool valid) { return kAll || valid; }
  static __device__ A lift(long long, bool, long long) { return 0; }
  static __device__ St<A> comb(St<A> a, St<A> b) { return {0, a.cnt + b.cnt}; }
};
template <bool kMax>
struct MinMaxI {
  typedef long long A;
  static constexpr bool kStaged = true;
  static __device__ bool elig(bool valid) { return valid; }
  static __device__ A lift(long long x, bool, long long) { return x; }
  static __device__ St<A> comb(St<A> a, St<A> b) {
    if (a.cnt == 0) return b;
    if (b.cnt == 0) return a;
    const bool take_b = kMax ? (b.acc > a.acc) : (b.acc < a.acc);
    return {take_b ? b.acc : a.acc, a.cnt + b.cnt};
  }
};
template <bool kMax>
struct MinMaxF {
  typedef double A;
  static constexpr bool kStaged = true;
  static __device__ bool elig(bool valid) { return valid; }
  static __device__ A lift(long long x, bool fl, long long) {
    const double v = as_f64(x, fl);
    return v == 0.0 ? 0.0 : v;  // -0.0 -> 0.0
  }
  static __device__ St<A> comb(St<A> a, St<A> b) {
    if (a.cnt == 0) return b;
    if (b.cnt == 0) return a;
    const bool take_b = kMax ? nan_less(a.acc, b.acc) : nan_less(b.acc, a.acc);
    return {take_b ? b.acc : a.acc, a.cnt + b.cnt};
  }
};
template <bool kLastOp, bool kAll>
struct Pick {  // first/last row index among eligible rows
  typedef long long A;
  static constexpr bool kStaged = false;
  static __device__ bool elig(bool valid) { return kAll || valid; }
  static __device__ A lift(long long, bool, long long row) { return row; }
  static __device__ St<A> comb(St<A> a, St<A> b) {
    if (kLastOp) return b.cnt > 0 ? St<A>{b.acc, a.cnt + b.cnt} : a;
    return a.cnt > 0 ? St<A>{a.acc, a.cnt + b.cnt} : b;
  }
};

// K4s: the state holds a row index; comb reads both rows' bytes.
template <bool kMax>
struct MinMaxS {
  typedef long long A;
  const uint32_t* data;  // [n, nw] words, 4-byte aligned
  const int32_t* lens;
  int nw;
  // <0, 0, >0 as row i sorts before, with or after row j
  __device__ int cmp(long long i, long long j) const {
    const uint32_t* x = data + i * nw;
    const uint32_t* y = data + j * nw;
    for (int k = 0; k < nw; ++k) {
      const uint32_t a = x[k], b = y[k];
      if (a != b)
        return __byte_perm(a, 0, 0x0123) < __byte_perm(b, 0, 0x0123) ? -1 : 1;
    }
    return lens[i] < lens[j] ? -1 : (lens[i] > lens[j] ? 1 : 0);
  }
  __device__ St<A> comb(St<A> a, St<A> b) const {
    if (a.cnt == 0) return b;
    if (b.cnt == 0) return a;
    const int c = cmp(a.acc, b.acc);
    const bool take_b = kMax ? (c < 0) : (c > 0);
    return {take_b ? b.acc : a.acc, a.cnt + b.cnt};
  }
};

// A thread's run of rows for the segmented block scan: whether it holds a
// flag, and the state of its rows after its last flag.
template <typename A>
struct Piece {
  int f;
  St<A> s;
};

template <class Op>
struct PieceScanOp {
  Op fold;
  __device__ Piece<typename Op::A> operator()(
      const Piece<typename Op::A>& x, const Piece<typename Op::A>& y) const {
    Piece<typename Op::A> r;
    r.f = x.f | y.f;
    r.s = y.f ? y.s : fold.comb(x.s, y.s);
    return r;
  }
};

// Warp scans, then the warps' totals: little shared memory, the operands'
// order kept (first/last are not commutative).
typedef cub::BlockScan<int, kThreads, cub::BLOCK_SCAN_WARP_SCANS> IntScan;
template <typename A>
using PieceScan =
    cub::BlockScan<Piece<A>, kThreads, cub::BLOCK_SCAN_WARP_SCANS>;
typedef PieceScan<long long> IScan;
typedef PieceScan<double> FScan;
union ScanStorage {
  typename IntScan::TempStorage n;
  typename IScan::TempStorage i;
  typename FScan::TempStorage f;
  St8 w[kThreads / 32];  // block_fold's warp results
};

template <typename A>
__device__ __forceinline__ typename PieceScan<A>::TempStorage& piece_storage(
    ScanStorage& s);
template <>
__device__ __forceinline__ IScan::TempStorage& piece_storage<long long>(
    ScanStorage& s) {
  return s.i;
}
template <>
__device__ __forceinline__ FScan::TempStorage& piece_storage<double>(
    ScanStorage& s) {
  return s.f;
}

// ---------------------------------------------------------------------------
// srt_seg_bounds: flags, tile offsets and the tiles that hold a flag
// ---------------------------------------------------------------------------

template <int kWords>
struct BoundParams {
  const long long* dev;  // non-null: the key table is here
  uint8_t* flags;
  int32_t* tile_offsets;  // null: the flags alone (no look-back)
  int32_t* span_tiles;
  unsigned long long* status;
  long long n;
  int ntiles, ncols, first;
  long long w[kWords];
};

// Bit k: the row base + k * kThreads + t (1 <= row < n) of a fixed-width
// key column differs from the row before it (null == null; floats: NaN ==
// NaN, -0.0 == 0.0).  No load waits on a compare (rows out of range read
// row 0), so four rows' loads are in flight at a time.
template <typename T, bool kFloatKey>
__device__ __forceinline__ unsigned fixed_diffs(const long long* c,
                                                long long base, int t,
                                                long long n) {
  const T* d = reinterpret_cast<const T*>(c[0]);
  const uint8_t* valid = reinterpret_cast<const uint8_t*>(c[1]);
  unsigned bits = 0u;
#pragma unroll 4
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + (long long)k * kThreads + t;
    const bool in = i > 0 && i < n;
    const long long a = in ? i : 0, b = in ? i - 1 : 0;
    const T x = d[a], xp = d[b];
    const bool v = valid == nullptr || valid[a] != 0;
    const bool vp = valid == nullptr || valid[b] != 0;
    const bool diff = kFloatKey ? (x != xp) && !(x != x && xp != xp)
                                : x != xp;
    if (in && ((v != vp) || (v && vp && diff))) bits |= 1u << k;
  }
  return bits;
}

// The same for a string key of NW 4-byte words a row (NW 0: any width,
// compared byte by byte or word by word until a difference): the lengths,
// then the bytes.
template <int NW>
__device__ __forceinline__ unsigned string_diffs(const long long* c,
                                                 long long base, int t,
                                                 long long n, int w) {
  const uint8_t* d = reinterpret_cast<const uint8_t*>(c[0]);
  const uint8_t* valid = reinterpret_cast<const uint8_t*>(c[1]);
  const int32_t* lens = reinterpret_cast<const int32_t*>(c[2]);
  const bool words = (((uintptr_t)d | (uintptr_t)w) & 3) == 0;
  unsigned bits = 0u;
#pragma unroll 4
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + (long long)k * kThreads + t;
    const bool in = i > 0 && i < n;
    const long long a = in ? i : 0, b = in ? i - 1 : 0;
    const bool v = valid[a] != 0, vp = valid[b] != 0;
    bool diff = lens[a] != lens[b];
    if (NW > 0) {
      const uint32_t* x = reinterpret_cast<const uint32_t*>(d) + a * NW;
      const uint32_t* xp = reinterpret_cast<const uint32_t*>(d) + b * NW;
#pragma unroll
      for (int j = 0; j < NW; ++j) diff |= x[j] != xp[j];
    } else if (words) {
      const uint32_t* x = reinterpret_cast<const uint32_t*>(d + a * w);
      const uint32_t* xp = reinterpret_cast<const uint32_t*>(d + b * w);
      for (int j = 0; j < w / 4 && !diff; ++j) diff = x[j] != xp[j];
    } else {
      for (int j = 0; j < w && !diff; ++j) diff = d[a * w + j] != d[b * w + j];
    }
    if (in && ((v != vp) || (v && vp && diff))) bits |= 1u << k;
  }
  return bits;
}

// The rows of key column c that differ from the row before them.
__device__ __forceinline__ unsigned key_diffs(const long long* c,
                                              long long base, int t,
                                              long long n) {
  const int kind = (int)(c[3] & 0xff);
  const int item = (int)((c[3] >> 8) & 0xffffff);
  if (kind == kFlag) {  // a given flag column: nonzero where a row starts
    const uint8_t* f = reinterpret_cast<const uint8_t*>(c[0]);
    unsigned bits = 0u;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long i = base + (long long)k * kThreads + t;
      if (i > 0 && i < n && f[i] != 0) bits |= 1u << k;
    }
    return bits;
  }
  if (kind == kString) {
    const bool aligned = (((uintptr_t)c[0] | (uintptr_t)item) & 3) == 0;
    if (aligned && item == 4) return string_diffs<1>(c, base, t, n, item);
    if (aligned && item == 8) return string_diffs<2>(c, base, t, n, item);
    if (aligned && item == 16) return string_diffs<4>(c, base, t, n, item);
    return string_diffs<0>(c, base, t, n, item);
  }
  if (kind == kFloat)
    return item == 4 ? fixed_diffs<float, true>(c, base, t, n)
                     : fixed_diffs<double, true>(c, base, t, n);
  switch (item) {
    case 1: return fixed_diffs<uint8_t, false>(c, base, t, n);
    case 2: return fixed_diffs<uint16_t, false>(c, base, t, n);
    case 4: return fixed_diffs<uint32_t, false>(c, base, t, n);
    default: return fixed_diffs<unsigned long long, false>(c, base, t, n);
  }
}

template <int kWords>
__global__ void __launch_bounds__(kThreads)
bounds_kernel(const __grid_constant__ BoundParams<kWords> p) {
  typedef cub::BlockReduce<int, kThreads> Reduce;
  __shared__ typename Reduce::TempStorage s_red;
  __shared__ __align__(16) uint8_t s_flag[kTile];
  __shared__ long long s_tile;
  __shared__ int s_last;
  const long long* tab = p.dev != nullptr ? p.dev : p.w;
  const int t = threadIdx.x;
  const long long tile = p.tile_offsets != nullptr
                             ? lookback_ticket(p.status, &s_tile)
                             : (long long)blockIdx.x;
  const long long base = tile * kTile;
  // bit k: the row base + k * kThreads + t differs from the row before it
  unsigned diff = 0u;
  for (int c = 0; c < p.ncols; ++c)
    diff |= key_diffs(tab + (long long)c * kKeyWords, base, t, p.n);
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + (long long)k * kThreads + t;
    const int f = i < p.n ? (i == 0 ? p.first : (int)((diff >> k) & 1u)) : 0;
    s_flag[k * kThreads + t] = (uint8_t)f;
    cnt += f;
  }
  __syncthreads();
  // a thread's 16 consecutive flags in one store
  const long long r0 = base + (long long)t * kItems;
  uint8_t* out = p.flags + r0;
  if (r0 + kItems <= p.n && ((uintptr_t)out & 15) == 0) {
    *reinterpret_cast<uint4*>(out) =
        *reinterpret_cast<const uint4*>(s_flag + t * kItems);
  } else {
    for (int k = 0; k < kItems && r0 + k < p.n; ++k)
      out[k] = s_flag[t * kItems + k];
  }
  if (p.tile_offsets == nullptr) return;
  const int total = Reduce(s_red).Sum(cnt);
  if (t < 32) {
    const unsigned long long agg =
        (unsigned long long)__shfl_sync(kFullMask, total, 0) |
        ((unsigned long long)(__shfl_sync(kFullMask, total, 0) > 0) << 31);
    const unsigned long long before = lookback_prefix(p.status, tile, agg);
    if (t == 0) {
      p.tile_offsets[tile] = (int32_t)(before & kCountMask);
      if (total > 0) p.span_tiles[before >> 31] = (int32_t)tile;
      if (tile == p.ntiles - 1) {
        const unsigned long long all = before + agg;
        p.tile_offsets[p.ntiles] = (int32_t)(all & kCountMask);
        p.tile_offsets[p.ntiles + 1] = (int32_t)(all >> 31);
      }
    }
  }
  lookback_done(p.status, p.ntiles, &s_last);
}

template <int kWords>
int launch_bounds(const void* words, int64_t nwords, int ncols,
                  const void* words_dev, int first, void* flags,
                  void* tile_offsets, void* span_tiles, void* status,
                  int64_t n, cudaStream_t st) {
  BoundParams<kWords> p;
  p.dev = static_cast<const long long*>(words_dev);
  p.flags = static_cast<uint8_t*>(flags);
  p.tile_offsets = static_cast<int32_t*>(tile_offsets);
  p.span_tiles = static_cast<int32_t*>(span_tiles);
  p.status = static_cast<unsigned long long*>(status);
  p.n = n;
  p.ntiles = num_tiles(n);
  p.ncols = ncols;
  p.first = first;
  if (words_dev == nullptr && nwords > 0)
    std::memcpy(p.w, words, sizeof(long long) * (size_t)nwords);
  bounds_kernel<kWords><<<p.ntiles, kThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// srt_seg_agg_tiles and srt_seg_agg_combine: every aggregate in one pass
// ---------------------------------------------------------------------------

template <int kWords>
struct AggParams {
  const long long* dev;           // non-null: the table is here
  const uint8_t* flags;           // null: one group, flagged at row 0
  const int32_t* tile_offsets;    // null with the flags
  const int32_t* span_tiles;      // null with the flags
  int32_t* starts;                // [G]
  St8* slots;                     // [jobs][2 * ntiles]: head, tail a tile
  long long n;
  int ntiles, G, ncols, njobs, nouts;
  long long w[kWords];
};

__device__ __forceinline__ void store_i64(void* data, int item, long long g,
                                          long long x) {
  switch (item) {
    case 1: static_cast<int8_t*>(data)[g] = (int8_t)x; break;
    case 2: static_cast<int16_t*>(data)[g] = (int16_t)x; break;
    case 4: static_cast<int32_t*>(data)[g] = (int32_t)x; break;
    default: static_cast<long long*>(data)[g] = x; break;
  }
}

__device__ __forceinline__ void store_f64(void* data, int item, long long g,
                                          double x) {
  if (item == 4) static_cast<float*>(data)[g] = (float)x;
  else static_cast<double*>(data)[g] = x;
}

// Group g's outputs of job `job` from its final state.
template <typename A>
__device__ void finish(const long long* tab, int ncols, int njobs, int job,
                       long long g, St<A> s) {
  const long long* jw = tab + (long long)ncols * kColWords +
                        (long long)job * kJobWords;
  const long long* outs = tab + (long long)ncols * kColWords +
                          (long long)njobs * kJobWords;
  const int o0 = (int)(jw[1] & 0xffffffffll), no = (int)(jw[1] >> 32);
  const bool has = s.cnt > 0;
  for (int q = o0; q < o0 + no; ++q) {
    const long long* o = outs + (long long)q * kOutWords;
    void* data = reinterpret_cast<void*>(o[0]);
    uint8_t* valid = reinterpret_cast<uint8_t*>(o[1]);
    const int mode = (int)(o[2] & 0xff), kind = (int)((o[2] >> 8) & 0xff);
    const int item = (int)((o[2] >> 16) & 0xff);
    switch (mode) {
      case kOutCount:
        static_cast<long long*>(data)[g] = s.cnt;
        valid[g] = 1;
        break;
      case kOutAvg:
        static_cast<double*>(data)[g] =
            has ? (double)s.acc / (double)s.cnt : 0.0;
        valid[g] = has;
        break;
      case kOutPick:
        static_cast<int32_t*>(data)[g] = has ? (int32_t)s.acc : -1;
        break;
      default:  // sums and min/max: the result type's zero when empty
        if (kind == kFloat) store_f64(data, item, g, has ? (double)s.acc : 0.0);
        else store_i64(data, item, g, has ? (long long)s.acc : 0);
        valid[g] = has;
        break;
    }
  }
}

// Rows a thread folds: the bits of its 16 consecutive rows, from a 16-byte
// load where the run is whole and aligned.
__device__ __forceinline__ unsigned byte_bits(const uint8_t* p, long long r0,
                                              long long n) {
  unsigned m = 0u;
  if (r0 + kItems <= n && (((uintptr_t)(p + r0)) & 15) == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(p + r0);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if ((w[j] >> (8 * b)) & 0xffu) m |= 1u << (4 * j + b);
    return m;
  }
  for (int k = 0; k < kItems && r0 + k < n; ++k)
    if (p[r0 + k]) m |= 1u << k;
  return m;
}

// What a block knows of its tile and of a thread's rows.
struct TileCtx {
  long long tile, r0, last;  // the tile's last row
  unsigned fm, vm;           // flag and validity bits of the thread's rows
  int nrows;                 // the thread's rows that exist (0..16)
  int kbefore;               // flags of the tile before the thread's rows
  int nflags;                // flags in the tile
  int g0;                    // the first group started in the tile
};

// One job over the tile: fold, scan, finish whole groups, leave the
// tile's head and tail pieces.
// The block's states folded in thread order, in a fixed tree (an ordered
// shuffle tree a warp, then the warps in order); thread 0 holds the result.
template <class Op>
__device__ __forceinline__ St<typename Op::A> block_fold(
    St<typename Op::A> st, St8* s_warp) {
  typedef typename Op::A A;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    St<A> o;
    o.acc = __shfl_down_sync(kFullMask, st.acc, off);
    o.cnt = __shfl_down_sync(kFullMask, st.cnt, off);
    if ((lane & (2 * off - 1)) == 0) st = Op::comb(st, o);
  }
  if (lane == 0) s_warp[warp] = pack(st);
  __syncthreads();
  if (threadIdx.x == 0) {
    st = unpack<A>(s_warp[0]);
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
      st = Op::comb(st, unpack<A>(s_warp[w]));
  }
  return st;
}

template <class Op, int kWords>
__device__ __forceinline__ void tile_job(const AggParams<kWords>& p,
                                         const long long* tab, int job,
                                         const TileCtx& c,
                                         const long long* s_val, bool fl,
                                         ScanStorage& s_scan) {
  typedef typename Op::A A;
  typedef St<A> S;
  const S ident = {A(0), 0};
  const int t = threadIdx.x;
  S tail = ident;
  for (int k = 0; k < c.nrows; ++k) {
    if ((c.fm >> k) & 1u) tail = ident;
    if (Op::elig((c.vm >> k) & 1u)) {
      const long long x = Op::kStaged ? s_val[17 * t + k] : 0ll;
      tail = Op::comb(tail, S{Op::lift(x, fl, c.r0 + k), 1});
    }
  }
  St8* slots = p.slots + (long long)job * 2 * p.ntiles;
  __syncthreads();  // the scan storage is reused job after job
  if (c.nflags == 0) {  // the tile is one piece, its head: a fold, no scan
    const S all = block_fold<Op>(tail, s_scan.w);
    if (t == 0) {
      slots[2 * c.tile] = pack(all);
      slots[2 * c.tile + 1] = pack(ident);
    }
    return;
  }
  Piece<A> in, init, carry;
  in.f = c.fm != 0u;
  in.s = tail;
  init.f = 0;
  init.s = ident;
  PieceScan<A>(piece_storage<A>(s_scan))
      .ExclusiveScan(in, carry, init, PieceScanOp<Op>{Op()});
  const bool last_tile = c.tile == p.ntiles - 1;
  if (c.fm == 0u) {  // no flag in the thread's rows: only the tile's end
    if (c.nrows > 0 && c.r0 + c.nrows - 1 == c.last) {
      const S run = Op::comb(carry.s, tail);  // the flags all lie before
      if (last_tile) finish<A>(tab, p.ncols, p.njobs, job,
                               c.g0 + c.kbefore - 1, run);
      else slots[2 * c.tile + 1] = pack(run);
    }
    return;
  }
  S run = carry.s;
  int L = c.kbefore - 1;  // the tile's group open at the row; -1: the head
  for (int k = 0; k < c.nrows; ++k) {
    if ((c.fm >> k) & 1u) {
      if (L < 0) slots[2 * c.tile] = pack(run);
      else finish<A>(tab, p.ncols, p.njobs, job, c.g0 + L, run);
      ++L;
      run = ident;
    }
    if (Op::elig((c.vm >> k) & 1u)) {
      const long long x = Op::kStaged ? s_val[17 * t + k] : 0ll;
      run = Op::comb(run, S{Op::lift(x, fl, c.r0 + k), 1});
    }
    if (c.r0 + k == c.last) {
      if (L < 0) {  // no flag in the tile: the head is the whole tile
        slots[2 * c.tile] = pack(run);
        slots[2 * c.tile + 1] = pack(ident);
      } else if (last_tile) {
        finish<A>(tab, p.ncols, p.njobs, job, c.g0 + L, run);
      } else {
        slots[2 * c.tile + 1] = pack(run);
      }
    }
  }
}

template <int kWords>
__device__ __forceinline__ void tile_dispatch(const AggParams<kWords>& p,
                                              const long long* tab, int job,
                                              const TileCtx& c,
                                              const long long* s_val,
                                              bool fl, ScanStorage& s) {
  const int op = (int)tab[(long long)p.ncols * kColWords +
                          (long long)job * kJobWords];
  switch (op) {
    case kSumI: tile_job<SumI>(p, tab, job, c, s_val, fl, s); break;
    case kSumF: tile_job<SumF>(p, tab, job, c, s_val, fl, s); break;
    case kCount: tile_job<CountOp<false>>(p, tab, job, c, s_val, fl, s); break;
    case kCountStar: tile_job<CountOp<true>>(p, tab, job, c, s_val, fl, s); break;
    case kMinI: tile_job<MinMaxI<false>>(p, tab, job, c, s_val, fl, s); break;
    case kMaxI: tile_job<MinMaxI<true>>(p, tab, job, c, s_val, fl, s); break;
    case kMinF: tile_job<MinMaxF<false>>(p, tab, job, c, s_val, fl, s); break;
    case kMaxF: tile_job<MinMaxF<true>>(p, tab, job, c, s_val, fl, s); break;
    case kFirst: tile_job<Pick<false, true>>(p, tab, job, c, s_val, fl, s); break;
    case kLast: tile_job<Pick<true, true>>(p, tab, job, c, s_val, fl, s); break;
    case kFirstNonNull: tile_job<Pick<false, false>>(p, tab, job, c, s_val, fl, s); break;
    default: tile_job<Pick<true, false>>(p, tab, job, c, s_val, fl, s); break;
  }
}

// A staged value of row i: integers sign-extended, floats as doubles.
__device__ __forceinline__ long long load_raw(const void* data, int kind,
                                              int item, long long i) {
  if (kind == kFloat)
    return __double_as_longlong(
        item == 4 ? (double)static_cast<const float*>(data)[i]
                  : static_cast<const double*>(data)[i]);
  switch (item) {
    case 1: return static_cast<const int8_t*>(data)[i];
    case 2: return static_cast<const int16_t*>(data)[i];
    case 4: return static_cast<const int32_t*>(data)[i];
    default: return static_cast<const long long*>(data)[i];
  }
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage input column `col`'s values of the tile into `s`, rows striped over
// the threads (coalesced), one pad slot every 16 rows: 8-byte columns by
// cp.async (landing while the block folds the previous column), narrower
// ones converted through registers.  Commits one cp.async group either
// way.
__device__ __forceinline__ void stage_column(const long long* cw, long long base,
                                             long long n, long long* s) {
  const void* data = reinterpret_cast<const void*>(cw[0]);
  const int kind = (int)(cw[2] & 0xff), item = (int)(cw[2] >> 16);
  if (((cw[2] >> 8) & 1) != 0) {
    const int t = threadIdx.x;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int r = k * kThreads + t;
      if (base + r >= n) continue;
      if (item == 8)
        cp_async8(s + r + (r >> 4),
                  static_cast<const long long*>(data) + base + r);
      else
        s[r + (r >> 4)] = load_raw(data, kind, item, base + r);
    }
  }
  cp_async_commit();
}

// Two staging buffers: column c + 1 lands while the block folds column c.
constexpr int kStageBytes = 2 * kStage * (int)sizeof(long long);

template <int kWords>
__global__ void __launch_bounds__(kThreads)
agg_tile_kernel(const __grid_constant__ AggParams<kWords> p) {
  __shared__ ScanStorage s_scan;
  extern __shared__ long long s_stage[];  // [2][kStage]
  const long long* tab = p.dev != nullptr ? p.dev : p.w;
  const int t = threadIdx.x;
  TileCtx c;
  c.tile = blockIdx.x;
  const long long base = c.tile * kTile;
  c.r0 = base + (long long)t * kItems;
  c.last = (base + kTile < p.n ? base + kTile : p.n) - 1;
  const long long left = p.n - c.r0;
  c.nrows = left <= 0 ? 0 : (left < kItems ? (int)left : kItems);
  const unsigned rows = c.nrows == kItems ? 0xffffu : (1u << c.nrows) - 1u;
  c.fm = p.flags != nullptr ? byte_bits(p.flags, c.r0, p.n)
                            : (c.r0 == 0 ? 1u : 0u);
  IntScan(s_scan.n).ExclusiveSum(__popc(c.fm), c.kbefore, c.nflags);
  c.g0 = p.tile_offsets != nullptr ? p.tile_offsets[c.tile]
                                   : (c.tile > 0 ? 1 : 0);
  for (unsigned m = c.fm, k = 0; m; m &= m - 1u, ++k)
    p.starts[c.g0 + c.kbefore + (int)k] = (int32_t)(c.r0 + __ffs(m) - 1);
  if (p.ncols > 0) stage_column(tab, base, p.n, s_stage);
  for (int col = 0; col < p.ncols; ++col) {
    const long long* cw = tab + (long long)col * kColWords;
    const uint8_t* valid = reinterpret_cast<const uint8_t*>(cw[1]);
    long long* s_val = s_stage + (col & 1) * kStage;
    // the next column's copies go out before this one's are awaited; its
    // buffer was last read by column col - 1, before the barrier below
    if (col + 1 < p.ncols)
      stage_column(cw + kColWords, base, p.n,
                   s_stage + ((col + 1) & 1) * kStage);
    c.vm = valid != nullptr ? byte_bits(valid, c.r0, p.n) : rows;
    if (col + 1 < p.ncols) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();  // every thread's copies of this column have landed
    const int j0 = (int)(cw[3] & 0xffffffffll), nj = (int)(cw[3] >> 32);
    for (int j = j0; j < j0 + nj; ++j)
      tile_dispatch(p, tab, j, c, s_val, (cw[2] & 0xff) == kFloat, s_scan);
    __syncthreads();  // this column's buffer is read before it is refilled
  }
}

// One (spanning group, job): fold slots [lo, hi) in a fixed order and tree.
template <class Op, int kWords>
__device__ __forceinline__ void combine_job(const AggParams<kWords>& p,
                                            const long long* tab, int job,
                                            long long g, long long lo,
                                            long long hi, St8* s_warp) {
  typedef typename Op::A A;
  typedef St<A> S;
  const St8* slots = p.slots + (long long)job * 2 * p.ntiles;
  const long long chunk = (hi - lo + blockDim.x - 1) / blockDim.x;
  const long long a = lo + (long long)threadIdx.x * chunk;
  const long long b = a + chunk < hi ? a + chunk : hi;
  S st = {A(0), 0};
  for (long long i = a; i < b; ++i) st = Op::comb(st, unpack<A>(slots[i]));
  st = block_fold<Op>(st, s_warp);
  if (threadIdx.x == 0) finish<A>(tab, p.ncols, p.njobs, job, g, st);
}

template <int kWords>
__global__ void __launch_bounds__(kThreads)
agg_combine_kernel(const __grid_constant__ AggParams<kWords> p) {
  __shared__ St8 s_warp[kThreads / 32];
  const long long* tab = p.dev != nullptr ? p.dev : p.w;
  const long long a = p.span_tiles != nullptr ? p.span_tiles[blockIdx.x] : 0;
  // the last tile's last group ends in it: the tile launch finished it
  if (a >= p.ntiles - 1) return;
  const long long g = (p.tile_offsets != nullptr ? p.tile_offsets[a + 1] : 1) - 1;
  const long long b = g + 1 < p.G ? p.starts[g + 1] / kTile : p.ntiles - 1;
  const long long lo = 2 * a + 1, hi = 2 * b + 1;
  const int job = blockIdx.y;
  const int op = (int)tab[(long long)p.ncols * kColWords +
                          (long long)job * kJobWords];
  switch (op) {
    case kSumI: combine_job<SumI>(p, tab, job, g, lo, hi, s_warp); break;
    case kSumF: combine_job<SumF>(p, tab, job, g, lo, hi, s_warp); break;
    case kCount: combine_job<CountOp<false>>(p, tab, job, g, lo, hi, s_warp); break;
    case kCountStar: combine_job<CountOp<true>>(p, tab, job, g, lo, hi, s_warp); break;
    case kMinI: combine_job<MinMaxI<false>>(p, tab, job, g, lo, hi, s_warp); break;
    case kMaxI: combine_job<MinMaxI<true>>(p, tab, job, g, lo, hi, s_warp); break;
    case kMinF: combine_job<MinMaxF<false>>(p, tab, job, g, lo, hi, s_warp); break;
    case kMaxF: combine_job<MinMaxF<true>>(p, tab, job, g, lo, hi, s_warp); break;
    case kFirst: combine_job<Pick<false, true>>(p, tab, job, g, lo, hi, s_warp); break;
    case kLast: combine_job<Pick<true, true>>(p, tab, job, g, lo, hi, s_warp); break;
    case kFirstNonNull: combine_job<Pick<false, false>>(p, tab, job, g, lo, hi, s_warp); break;
    default: combine_job<Pick<true, false>>(p, tab, job, g, lo, hi, s_warp); break;
  }
}

template <int kWords>
void fill_agg(AggParams<kWords>& p, const void* words, int64_t nwords,
              int ncols, int njobs, int nouts, const void* words_dev,
              const void* flags, const void* tile_offsets,
              const void* span_tiles, void* starts, void* slots, int64_t n,
              int G) {
  p.dev = static_cast<const long long*>(words_dev);
  p.flags = static_cast<const uint8_t*>(flags);
  p.tile_offsets = static_cast<const int32_t*>(tile_offsets);
  p.span_tiles = static_cast<const int32_t*>(span_tiles);
  p.starts = static_cast<int32_t*>(starts);
  p.slots = static_cast<St8*>(slots);
  p.n = n;
  p.ntiles = num_tiles(n);
  p.G = G;
  p.ncols = ncols;
  p.njobs = njobs;
  p.nouts = nouts;
  if (words_dev == nullptr && nwords > 0)
    std::memcpy(p.w, words, sizeof(long long) * (size_t)nwords);
}

template <int kWords>
int launch_tiles(const void* words, int64_t nwords, int ncols, int njobs,
                 int nouts, const void* words_dev, const void* flags,
                 const void* tile_offsets, void* starts, void* slots,
                 int64_t n, int G, cudaStream_t st) {
  AggParams<kWords> p;
  fill_agg(p, words, nwords, ncols, njobs, nouts, words_dev, flags,
           tile_offsets, nullptr, starts, slots, n, G);
  const cudaError_t attr = cudaFuncSetAttribute(
      agg_tile_kernel<kWords>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kStageBytes);
  if (attr != cudaSuccess) return (int)attr;
  agg_tile_kernel<kWords><<<p.ntiles, kThreads, kStageBytes, st>>>(p);
  return (int)cudaGetLastError();
}

template <int kWords>
int launch_combine(const void* words, int64_t nwords, int ncols, int njobs,
                   int nouts, const void* words_dev, const void* tile_offsets,
                   const void* span_tiles, int nspans, const void* starts,
                   void* slots, int64_t n, int G, int threads,
                   cudaStream_t st) {
  AggParams<kWords> p;
  fill_agg(p, words, nwords, ncols, njobs, nouts, words_dev, nullptr,
           tile_offsets, span_tiles, const_cast<void*>(starts), slots, n, G);
  agg_combine_kernel<kWords><<<dim3(nspans, njobs), threads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K4s: string min/max as a row index, tile + combine over its own slots
// ---------------------------------------------------------------------------

template <class Op>
__global__ void string_tile_kernel(Op fold, const uint8_t* __restrict__ valid,
                                   const uint8_t* __restrict__ flags,
                                   int64_t n,
                                   const int32_t* __restrict__ tile_offsets,
                                   St<long long>* __restrict__ slots) {
  typedef St<long long> S;
  typedef Piece<long long> P;
  __shared__ union {
    typename IntScan::TempStorage i;
    typename IScan::TempStorage p;
  } tmp;
  const S ident = {0, 0};
  const int64_t base = (int64_t)blockIdx.x * kTile;
  const int64_t r0 = base + (int64_t)threadIdx.x * kItems;
  int nflags = 0;
  S tail = ident;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = r0 + k;
    if (i < n) {
      if (flags[i]) {
        ++nflags;
        tail = ident;
      }
      if (valid[i] != 0) tail = fold.comb(tail, S{i, 1});
    }
  }
  int kbefore;
  IntScan(tmp.i).ExclusiveSum(nflags, kbefore);
  __syncthreads();
  P in, init, carry;
  in.f = nflags > 0;
  in.s = tail;
  init.f = 0;
  init.s = ident;
  IScan(tmp.p).ExclusiveScan(in, carry, init, PieceScanOp<Op>{fold});
  const int64_t slot0 = (int64_t)tile_offsets[blockIdx.x] + blockIdx.x;
  const int64_t last = (base + kTile < n ? base + kTile : n) - 1;
  S run = carry.s;
  int k = kbefore;
#pragma unroll
  for (int kk = 0; kk < kItems; ++kk) {
    const int64_t i = r0 + kk;
    if (i < n) {
      if (flags[i]) {
        slots[slot0 + k] = run;
        ++k;
        run = ident;
      }
      if (valid[i] != 0) run = fold.comb(run, S{i, 1});
      if (i == last) slots[slot0 + k] = run;
    }
  }
}

// One warp a segment: its pieces are the consecutive slots [g + 1 +
// tile(start g), g + 2 + tile(start g+1)); out: the winner's row or -1.
template <class Op>
__global__ void string_combine_kernel(Op fold,
                                      const St<long long>* __restrict__ slots,
                                      const int32_t* __restrict__ starts,
                                      int G, int ntiles,
                                      int32_t* __restrict__ out) {
  typedef St<long long> S;
  const int64_t g = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= G) return;  // warp-uniform
  const int64_t lo = g + 1 + starts[g] / kTile;
  const int64_t hi = (g + 1 < G) ? g + 2 + starts[g + 1] / kTile
                                 : (int64_t)G + ntiles;
  const int64_t chunk = (hi - lo + 31) / 32;
  const int64_t a = lo + lane * chunk;
  const int64_t b = (a + chunk < hi) ? a + chunk : hi;
  S st = {0, 0};
  for (int64_t j = a; j < b; ++j) st = fold.comb(st, slots[j]);
  for (int off = 1; off < 32; off <<= 1) {
    S o;
    o.acc = __shfl_down_sync(kFullMask, st.acc, off);
    o.cnt = __shfl_down_sync(kFullMask, st.cnt, off);
    if ((lane & (2 * off - 1)) == 0) st = fold.comb(st, o);
  }
  if (lane == 0) out[g] = st.cnt > 0 ? (int32_t)st.acc : -1;
}

template <class Op>
void launch_string(Op fold, const uint8_t* valid, const uint8_t* flags,
                   int64_t n, const int32_t* tile_offsets,
                   const int32_t* starts, int G, void* slots, int32_t* out,
                   cudaStream_t st) {
  const int nt = num_tiles(n);
  string_tile_kernel<Op><<<nt, kThreads, 0, st>>>(
      fold, valid, flags, n, tile_offsets, (St<long long>*)slots);
  const int64_t threads = (int64_t)G * 32;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  string_combine_kernel<Op><<<blocks, kThreads, 0, st>>>(
      fold, (const St<long long>*)slots, starts, G, nt, out);
}

__global__ void seg_percentile_kernel(const double* __restrict__ values,
                                      int64_t n,
                                      const int32_t* __restrict__ starts,
                                      const long long* __restrict__ counts,
                                      int G, const double* __restrict__ qs,
                                      int nq, double* __restrict__ out,
                                      uint8_t* __restrict__ out_valid) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)G * nq) return;
  const int64_t g = t % G;
  const long long cnt = counts[g];
  if (cnt <= 0) {
    out[t] = 0.0;
    out_valid[t] = 0;
    return;
  }
  const double pos = __dmul_rn((double)(cnt - 1), qs[t / G]);
  const double flo = floor(pos);
  const long long lo = (long long)flo;
  const long long hi = (long long)ceil(pos);
  const double frac = __dsub_rn(pos, flo);
  const int64_t base = starts[g];
  const int64_t ilo = base + lo < n ? base + lo : n - 1;
  const int64_t ihi = base + hi < n ? base + hi : n - 1;
  const double vlo = values[ilo];
  const double vhi = values[ihi];
  out[t] = __dadd_rn(vlo, __dmul_rn(__dsub_rn(vhi, vlo), frac));
  out_valid[t] = 1;
}

}  // namespace srt_seg

using namespace srt_seg;

extern "C" {

// The boundary pass over ncols >= 0 key columns (the table above, nwords
// = kKeyWords * ncols, copied into the kernel's parameters; words_dev, when
// not null, a device copy that the kernel reads instead: the wrapper makes
// one past kKeySmallWords).  flags: uint8 [n], every byte written, flag[0]
// = first.  tile_offsets (null: the flags alone): int32 [ntiles + 2], the
// groups started before each tile, then G and S; span_tiles: int32
// [ntiles], the first S the tiles that hold a flag, in order; status:
// uint64 [ntiles + 2], zero on entry and on exit.
int srt_seg_bounds(const void* words, int64_t nwords, int ncols,
                   const void* words_dev, int first, void* flags,
                   void* tile_offsets, void* span_tiles, void* status,
                   int64_t n, void* stream) {
  if (n < 1 || n > 2147483647ll || ncols < 0 || flags == nullptr ||
      nwords != (int64_t)kKeyWords * ncols ||
      (ncols > 0 && words == nullptr) ||
      (tile_offsets != nullptr && (span_tiles == nullptr || status == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long* w = static_cast<const long long*>(words);
  for (int c = 0; c < ncols; ++c) {
    const long long* k = w + (long long)c * kKeyWords;
    const int kind = (int)(k[3] & 0xff);
    const long long item = k[3] >> 8;
    if (k[0] == 0 || item < 1 || kind > kFlag ||
        (kind == kString && k[2] == 0) ||
        (kind != kString && kind != kFlag && item != 1 && item != 2 &&
         item != 4 && item != 8))
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (words_dev != nullptr)
    return launch_bounds<1>(words, nwords, ncols, words_dev, first, flags,
                            tile_offsets, span_tiles, status, n, st);
  if (nwords <= kKeySmallWords)
    return launch_bounds<kKeySmallWords>(words, nwords, ncols, nullptr,
                                         first, flags, tile_offsets,
                                         span_tiles, status, n, st);
  return (int)cudaErrorInvalidValue;
}

// The aggregate's tile launch: ncols input columns, njobs jobs, nouts
// outputs (the table above; words_dev as for srt_seg_bounds, past
// kAggLargeWords).  flags and tile_offsets: the boundary pass's, or both
// null for one group (G 1).  starts: int32 [G]; slots: 16-byte states
// [njobs][2 * ntiles].  Writes starts, every job's head and tail pieces
// and the outputs of the groups that start and end in one tile.
int srt_seg_agg_tiles(const void* words, int64_t nwords, int ncols,
                      int njobs, int nouts, const void* words_dev,
                      const void* flags, const void* tile_offsets,
                      void* starts, void* slots, int64_t n, int G,
                      void* stream) {
  if (n < 1 || n > 2147483647ll || G < 1 || ncols < 0 || njobs < 0 ||
      nouts < 0 || starts == nullptr || (njobs > 0 && slots == nullptr) ||
      (flags == nullptr) != (tile_offsets == nullptr) ||
      (flags == nullptr && G != 1) ||
      nwords != (int64_t)kColWords * ncols + (int64_t)kJobWords * njobs +
                    (int64_t)kOutWords * nouts ||
      (nwords > 0 && words == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (words_dev != nullptr)
    return launch_tiles<1>(words, nwords, ncols, njobs, nouts, words_dev,
                           flags, tile_offsets, starts, slots, n, G, st);
  if (nwords <= kAggSmallWords)
    return launch_tiles<kAggSmallWords>(words, nwords, ncols, njobs, nouts,
                                        nullptr, flags, tile_offsets, starts,
                                        slots, n, G, st);
  if (nwords <= kAggLargeWords)
    return launch_tiles<kAggLargeWords>(words, nwords, ncols, njobs, nouts,
                                        nullptr, flags, tile_offsets, starts,
                                        slots, n, G, st);
  return (int)cudaErrorInvalidValue;
}

// The aggregate's combine launch over nspans spanning candidates (the
// boundary pass's S and span_tiles; 1 and null for one group) x njobs
// jobs, blocks of `threads` (32..256, a multiple of 32).  Reads the tile
// launch's starts and slots; writes the outputs of the groups that cross a
// tile boundary.
int srt_seg_agg_combine(const void* words, int64_t nwords, int ncols,
                        int njobs, int nouts, const void* words_dev,
                        const void* tile_offsets, const void* span_tiles,
                        int nspans, const void* starts, void* slots,
                        int64_t n, int G, int threads, void* stream) {
  if (nspans < 1 || njobs < 1) return (int)cudaGetLastError();
  if (n < 1 || G < 1 || starts == nullptr || slots == nullptr ||
      threads < 32 || threads > kThreads || threads % 32 != 0 ||
      (tile_offsets == nullptr) != (span_tiles == nullptr) ||
      (span_tiles == nullptr && nspans != 1) || njobs > 65535 ||
      nwords != (int64_t)kColWords * ncols + (int64_t)kJobWords * njobs +
                    (int64_t)kOutWords * nouts || words == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (words_dev != nullptr)
    return launch_combine<1>(words, nwords, ncols, njobs, nouts, words_dev,
                             tile_offsets, span_tiles, nspans, starts, slots,
                             n, G, threads, st);
  if (nwords <= kAggSmallWords)
    return launch_combine<kAggSmallWords>(
        words, nwords, ncols, njobs, nouts, nullptr, tile_offsets,
        span_tiles, nspans, starts, slots, n, G, threads, st);
  if (nwords <= kAggLargeWords)
    return launch_combine<kAggLargeWords>(
        words, nwords, ncols, njobs, nouts, nullptr, tile_offsets,
        span_tiles, nspans, starts, slots, n, G, threads, st);
  return (int)cudaErrorInvalidValue;
}

// K4s: out_idx int32 [G], per segment the row of the least (is_max: the
// greatest) valid string, -1 where the segment has none.  data uint8
// [n, w] (w a multiple of 4, 4-byte aligned), lens int32 [n]; flags and
// tile_offsets of the boundary pass, starts of the tile launch; slots:
// (G + ntiles) 16-byte states.
int srt_seg_string_minmax(int is_max, const void* data, const void* lens,
                          const void* valid, int w, const void* flags,
                          int64_t n, const void* tile_offsets,
                          const void* starts, int G, void* slots,
                          void* out_idx, void* stream) {
  if (n <= 0 || G <= 0 || w <= 0 || w % 4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* v = (const uint8_t*)valid;
  const uint8_t* f = (const uint8_t*)flags;
  const int32_t* to = (const int32_t*)tile_offsets;
  const int32_t* s = (const int32_t*)starts;
  const uint32_t* words = (const uint32_t*)data;
  const int32_t* l = (const int32_t*)lens;
  int32_t* out = (int32_t*)out_idx;
  if (is_max)
    launch_string(MinMaxS<true>{words, l, w / 4}, v, f, n, to, s, G, slots,
                  out, st);
  else
    launch_string(MinMaxS<false>{words, l, w / 4}, v, f, n, to, s, G, slots,
                  out, st);
  return (int)cudaGetLastError();
}

// K4p: out and out_valid are [nq, G] (q-major); values float64 [n] sorted
// within each segment, counts int64 [G] valid values per segment.
int srt_seg_percentile(const void* values, int64_t n, const void* starts,
                       const void* counts, int G, const void* qs, int nq,
                       void* out, void* out_valid, void* stream) {
  const int64_t threads = (int64_t)G * nq;
  if (threads <= 0) return (int)cudaGetLastError();
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  seg_percentile_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)values, n, (const int32_t*)starts,
      (const long long*)counts, G, (const double*)qs, nq, (double*)out,
      (uint8_t*)out_valid);
  return (int)cudaGetLastError();
}

// The constants the Python wrapper shares with this file, in the order of
// ops/segmented.py's ``native.share_limits`` call: rows a tile, rows a
// thread, table words of a key column, an input column, a job and an
// output, and of the small key table and the small and large aggregate
// tables.  Writes the first n of them.
int srt_segmented_limits(int64_t* out, int n) {
  const int64_t v[] = {kTile, kItems, kKeyWords, kColWords, kJobWords,
                       kOutWords, kKeySmallWords, kAggSmallWords,
                       kAggLargeWords};
  for (int i = 0; i < n && i < (int)(sizeof(v) / sizeof(v[0])); ++i)
    out[i] = v[i];
  return 0;
}

}  // extern "C"
