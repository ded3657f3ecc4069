// K2: order-preserving compaction (the filter kernel), two launches a call
// whatever the number of columns.
//
// Replaces spark_rapids_tpu/ops/kernels.py:62 `compact`, which XLA runs as
// cumsum(keep) followed by a scatter of every column into zeroed buffers.
//
// Design: tiles of kTile (4096) rows; a thread owns 16 consecutive rows of
// its tile, whose keep flags it reads in one 16-byte load.
//   1. srt_compact_count (count_kernel), once over the flags: each tile
//      ranks its kept rows -- a thread's popcount, a warp scan by shuffles,
//      the warps' counts in shared memory -- and writes their tile rows in
//      rank order (uint16, the tile's list), then takes its exclusive
//      offset by the ticketed decoupled look-back of common.cuh (no tile
//      count pass, no one-block scan, no memset: the last tile clears the
//      status).  The last tile writes the total, which the wrapper reads
//      once to size the outputs exactly (port batches are unpadded).
//   2. srt_compact_copy (copy_kernel): one launch over every column, the
//      column table (ops/kernels.py `gather_table`'s words, kColWords a
//      column) by value in the kernel's parameters (__grid_constant__, two
//      sizes), or a device copy where it is longer.  A block takes one tile
//      and a group of its columns (all of them, or one where the tiles
//      alone would leave the card idle) and copies every column of the
//      group from the tile's list: output row q of the tile is kept row q,
//      so neighbouring lanes store neighbouring output rows, and no block
//      re-ranks the flags.  A column whose row is one load wide (1, 2, 4, 8
//      or 16 bytes dividing its addresses) issues a thread's loads for kRun
//      rows before any store; a wider or misaligned matrix row is copied in
//      chunks of the widest load its addresses allow, neighbouring threads
//      on neighbouring chunks.  Null rows come out zeroed (data, validity
//      and length), the column invariant of columnar/column.py.
//
// Bound on the H100: bytes.  Every input byte of the columns is read once
// (the kept rows' sectors), every output byte written once, and the keep
// flags read once; the lists (two bytes a kept row) are written once and
// read from L2 once a column group.
#include <cstring>

#include "common.cuh"

namespace srt_compact {

using namespace srt;

// Table words a column, as the gather kernel's (csrc/gather.cu): src data,
// dst data, src validity, dst validity, src lengths, dst lengths (0: fixed
// width), row bytes | vec << 32 (vec: the widest power-of-two load, at
// most 16 bytes, that divides the row bytes and both data addresses).
constexpr int kColWords = 7;
constexpr int kRun = 4;  // output rows a thread loads before it stores
// below this many tiles a call's columns are split across blocks
constexpr long long kSplitTiles = 2 * 132;
constexpr int kSmallWords = 480;   // 3,840 bytes of parameters
constexpr int kLargeWords = 4000;  // 32,000 bytes

// Bit j: row r0 + j is kept (rows at or past n are not).
__device__ __forceinline__ unsigned thread_flags(const uint8_t* keep,
                                                 long long n, long long r0) {
  unsigned bits = 0u;
  if (r0 + kItems <= n && ((uintptr_t)(keep + r0) & 15) == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(keep + r0);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned m = __vcmpne4(w[q], 0u) & 0x08040201u;
      bits |= ((m | (m >> 8) | (m >> 16) | (m >> 24)) & 0xfu) << (4 * q);
    }
  } else {
    for (int j = 0; j < kItems && r0 + j < n; ++j)
      bits |= (unsigned)(keep[r0 + j] != 0) << j;
  }
  return bits;
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ keep, long long n, long long ntiles,
             int32_t* __restrict__ tile_offsets, uint16_t* __restrict__ rows,
             unsigned long long* __restrict__ status) {
  __shared__ uint16_t s_rows[kTile];  // the tile row of each kept rank
  __shared__ int s_warp[kThreads / 32];
  __shared__ long long s_tile;
  __shared__ int s_last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long tile = lookback_ticket(status, &s_tile);
  const unsigned bits =
      thread_flags(keep, n, tile * kTile + (long long)t * kItems);
  const int c = __popc(bits);
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFullMask, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int pos = incl - c, kept = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const int v = s_warp[w];
    if (w < warp) pos += v;
    kept += v;
  }
  for (unsigned b = bits; b != 0u; b &= b - 1u)
    s_rows[pos++] = (uint16_t)(t * kItems + __ffs(b) - 1);
  if (warp == 0) {
    const unsigned long long before =
        lookback_prefix(status, tile, (unsigned long long)kept);
    if (lane == 0) {
      tile_offsets[tile] = (int32_t)before;
      if (tile == ntiles - 1)
        tile_offsets[ntiles] = (int32_t)(before + (unsigned long long)kept);
    }
  }
  __syncthreads();
  uint16_t* out = rows + tile * kTile;
  for (int q = t; q < kept; q += kThreads) out[q] = s_rows[q];
  lookback_done(status, ntiles, &s_last);
}

template <int kWords>
struct CopyParams {
  const long long* dev;  // non-null: the table is here
  const uint16_t* rows;  // each tile's kept rows, from the count
  const int32_t* tile_offsets;
  long long n, ntiles;
  int ncols, groups;
  long long w[kWords];
};

template <int E> struct Elem;
template <> struct Elem<1> { typedef uint8_t T; };
template <> struct Elem<2> { typedef uint16_t T; };
template <> struct Elem<4> { typedef uint32_t T; };
template <> struct Elem<8> { typedef unsigned long long T; };
template <> struct Elem<16> { typedef uint4 T; };

// Output rows q = t, t + kThreads, ... < kept of the tile: validity,
// lengths and, with kData, the data where a row is one E-byte load; every
// load of kRun rows before their stores.
template <int E, bool kData>
__device__ __forceinline__ void copy_rows(const long long* c, long long base,
                                          long long out0, int kept,
                                          const uint16_t* __restrict__ s_rows) {
  typedef typename Elem<E>::T T;
  const T* src = reinterpret_cast<const T*>(c[0]);
  T* dst = reinterpret_cast<T*>(c[1]);
  const uint8_t* sv = reinterpret_cast<const uint8_t*>(c[2]);
  uint8_t* dv = reinterpret_cast<uint8_t*>(c[3]);
  const int32_t* sl = reinterpret_cast<const int32_t*>(c[4]);
  int32_t* dl = reinterpret_cast<int32_t*>(c[5]);
  const bool lens = c[5] != 0;
  for (int q0 = threadIdx.x; q0 < kept; q0 += kThreads * kRun) {
    uint8_t v[kRun];
    T x[kRun];
    int32_t ln[kRun];
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const int q = q0 + k * kThreads;
      if (q < kept) {
        const long long s = base + s_rows[q];
        v[k] = sv[s];
        if (kData) x[k] = src[s];
        if (lens) ln[k] = sl[s];
      }
    }
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const int q = q0 + k * kThreads;
      if (q < kept) {
        const bool o = v[k] != 0;
        const long long d = out0 + q;
        dv[d] = o ? 1 : 0;
        if (lens) dl[d] = o ? ln[k] : 0;
        if (kData) dst[d] = o ? x[k] : T();
      }
    }
  }
}

// A matrix column whose row is wider than one load: the tile's kept rows
// in V chunks, neighbouring threads on neighbouring chunks, the chunk's row
// and column stepped without a division; a null row's chunks zeroed.
template <typename V>
__device__ __forceinline__ void copy_chunks(const long long* c, long long base,
                                            long long out0, int kept, int rb,
                                            const uint16_t* __restrict__ s_rows) {
  const int nv = rb / (int)sizeof(V);
  const V* src = reinterpret_cast<const V*>(c[0]);
  V* dst = reinterpret_cast<V*>(c[1]) + out0 * nv;
  const uint8_t* sv = reinterpret_cast<const uint8_t*>(c[2]);
  const long long total = (long long)kept * nv;
  int row = threadIdx.x / nv, col = threadIdx.x - row * nv;
  const int drow = kThreads / nv, dcol = kThreads - drow * nv;
#pragma unroll 4
  for (long long q = threadIdx.x; q < total; q += kThreads) {
    const long long s = base + s_rows[row];
    V x = V();
    if (sv[s] != 0) x = src[s * nv + col];
    dst[q] = x;
    row += drow;
    col += dcol;
    if (col >= nv) {
      col -= nv;
      ++row;
    }
  }
}

// at most 64 registers a thread: four blocks of a tile's column resident
// on a multiprocessor, so their loads hide each other's latency
template <int kWords>
__global__ void __launch_bounds__(kThreads, 4)
copy_kernel(const __grid_constant__ CopyParams<kWords> p) {
  const long long* tab = p.dev != nullptr ? p.dev : p.w;
  const long long items = p.ntiles * p.groups;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const long long tile = it / p.groups;
    const int g = (int)(it - tile * p.groups);
    const int j0 = p.groups == 1 ? 0 : g;
    const int j1 = p.groups == 1 ? p.ncols : g + 1;
    const long long base = tile * kTile;
    const long long out0 = p.tile_offsets[tile];
    const int kept = (int)(p.tile_offsets[tile + 1] - out0);
    const uint16_t* rows = p.rows + base;
    for (int j = j0; j < j1; ++j) {
      const long long* col = tab + (long long)j * kColWords;
      const int rb = (int)(col[6] & 0xffffffffll);
      const int vec = (int)((col[6] >> 32) & 0xff);
      if (rb == vec) {
        switch (vec) {
          case 16: copy_rows<16, true>(col, base, out0, kept, rows); break;
          case 8: copy_rows<8, true>(col, base, out0, kept, rows); break;
          case 4: copy_rows<4, true>(col, base, out0, kept, rows); break;
          case 2: copy_rows<2, true>(col, base, out0, kept, rows); break;
          default: copy_rows<1, true>(col, base, out0, kept, rows); break;
        }
        continue;
      }
      copy_rows<1, false>(col, base, out0, kept, rows);
      switch (vec) {
        case 16: copy_chunks<uint4>(col, base, out0, kept, rb, rows); break;
        case 8:
          copy_chunks<unsigned long long>(col, base, out0, kept, rb, rows);
          break;
        case 4: copy_chunks<uint32_t>(col, base, out0, kept, rb, rows); break;
        case 2: copy_chunks<uint16_t>(col, base, out0, kept, rb, rows); break;
        default: copy_chunks<uint8_t>(col, base, out0, kept, rb, rows); break;
      }
    }
  }
}

template <int kWords>
int launch_copy(const void* words, int64_t nwords, int ncols,
                const void* words_dev, const uint16_t* rows, int64_t n,
                const int32_t* tile_offsets, cudaStream_t stream) {
  CopyParams<kWords> p;
  p.dev = static_cast<const long long*>(words_dev);
  p.rows = rows;
  p.tile_offsets = tile_offsets;
  p.n = n;
  p.ntiles = num_tiles(n);
  p.ncols = ncols;
  // split the columns across blocks where the tiles alone would leave
  // most of the card's 132 multiprocessors idle
  p.groups = p.ntiles < kSplitTiles ? ncols : 1;
  if (words_dev == nullptr)
    std::memcpy(p.w, words, sizeof(long long) * (size_t)nwords);
  const long long items = p.ntiles * p.groups;
  const long long cap = 132 * 16;
  const int grid = (int)(items < cap ? items : cap);
  copy_kernel<kWords><<<grid, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace srt_compact

using namespace srt_compact;

extern "C" {

// keep: n flag bytes (nonzero: kept).  tile_offsets: int32[ntiles + 1],
// the kept rows before each tile, the total last.  rows: uint16[ntiles *
// kTile], each tile's kept rows (their rows in the tile) in order, from
// the tile's first slot.  status: uint64[ntiles + 2] of zeros (the
// look-back's; left zero).  n >= 1.
int srt_compact_count(const void* keep, int64_t n, void* tile_offsets,
                      void* rows, void* status, void* stream) {
  if (n < 1 || keep == nullptr || tile_offsets == nullptr ||
      rows == nullptr || status == nullptr)
    return (int)cudaErrorInvalidValue;
  const int nt = srt::num_tiles(n);
  count_kernel<<<nt, srt::kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)keep, n, nt, (int32_t*)tile_offsets, (uint16_t*)rows,
      (unsigned long long*)status);
  return (int)cudaGetLastError();
}

// words: the column table described above (nwords = kColWords * ncols:
// ops/kernels.py `gather_table`'s words), copied into the kernel's
// parameters; words_dev, when not null, a device copy of it that the
// kernel reads instead (the wrapper makes one where nwords exceeds
// kLargeWords).  rows and tile_offsets: the count's.  Each source has n
// rows; each output as many as the count's total.
int srt_compact_copy(const void* words, int64_t nwords, int ncols,
                     const void* words_dev, const void* rows, int64_t n,
                     const void* tile_offsets, void* stream) {
  if (ncols < 1 || n < 1 || rows == nullptr || tile_offsets == nullptr ||
      words == nullptr || nwords != (int64_t)kColWords * ncols)
    return (int)cudaErrorInvalidValue;
  const long long* w = static_cast<const long long*>(words);
  for (int j = 0; j < ncols; ++j) {
    const long long* c = w + (long long)j * kColWords;
    const long long rb = c[6] & 0xffffffffll, vec = (c[6] >> 32) & 0xff;
    if (rb < 1 || vec < 1 || vec > 16 || (vec & (vec - 1)) != 0 ||
        rb % vec != 0 || c[0] == 0 || c[1] == 0 || c[2] == 0 || c[3] == 0 ||
        (c[4] == 0) != (c[5] == 0))
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const uint16_t* rp = static_cast<const uint16_t*>(rows);
  const int32_t* to = static_cast<const int32_t*>(tile_offsets);
  if (words_dev != nullptr)
    return launch_copy<1>(words, nwords, ncols, words_dev, rp, n, to, st);
  if (nwords <= kSmallWords)
    return launch_copy<kSmallWords>(words, nwords, ncols, nullptr, rp, n, to,
                                    st);
  if (nwords <= kLargeWords)
    return launch_copy<kLargeWords>(words, nwords, ncols, nullptr, rp, n, to,
                                    st);
  return (int)cudaErrorInvalidValue;
}

// The constants the Python wrapper shares with this file, in the order of
// ops/kernels.py's ``native.share_limits`` call: rows a tile, words a
// column, table words of the small and the large parameter struct.
// Writes the first n of them.
int srt_compact_limits(int64_t* out, int n) {
  const int64_t v[] = {srt::kTile, kColWords, kSmallWords, kLargeWords};
  for (int i = 0; i < n && i < (int)(sizeof(v) / sizeof(v[0])); ++i)
    out[i] = v[i];
  return 0;
}

}  // extern "C"
