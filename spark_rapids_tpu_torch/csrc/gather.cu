// K3: row gather by index with null-slot zeroing, every column in one
// launch.
//
// Replaces spark_rapids_tpu/ops/kernels.py:42 `_gather_column` (used by
// `gather_columns` :55 and `take` :97): out[i] = col[perm[i]], validity
// out[i] = validity[perm[i]], and zero data / zero length in null slots.
// An index below 0 yields a null row (the segmented aggregate uses it for
// first/last over a group with no eligible row; the joins for the null
// side of an outer row).
//
// One launch for all the columns of a call.  The wrapper (ops/kernels.py
// `gather_table`) passes a table of kGatherColWords words a column -- the
// source and destination data, validity and lengths, the row bytes, the
// widest load that divides them and the source's address, and whether the
// source has rows at all -- by value in the kernel's parameters
// (__grid_constant__, two sizes; sm_90 with CUDA 12.1+ takes up to 32,764
// bytes), or, where it is longer, as a device copy the wrapper makes.
//
// A block takes tiles of kGatherTile output rows; a warp takes kWarpRows
// of them, and its lane l the rows l, l + 32, ... (kRun rows), so that
// every warp-wide load or store covers 32 consecutive output rows: the
// index loads and the output stores are contiguous, and the source rows
// a load gathers lie as close together as the index lets them.  A thread
// loads its kRun indices once and keeps them in registers for every
// column, so the index is read once a row, not once a column.  For each
// column it gathers its rows' validity bytes, lengths and, where a row is
// one load wide (every fixed-width column, and a string or array matrix
// whose row width is 1, 2, 4, 8 or 16 bytes and divides its addresses),
// the data: all of a run's loads issued before any is used, none waiting
// on another (a null row's data is read, then zeroed), so a column costs
// one round trip to memory.  Wider or misaligned matrix rows take the
// chunk path, chosen once per column: the runs leave each row's source
// index (or -1 for a null row) in shared memory, then the block copies
// the tile's rows in chunks of the widest load the column allows,
// neighbouring threads on neighbouring chunks, the chunk's row and column
// stepped without a division.  A call with fewer than kSplitTiles tiles
// (a join's output of a few thousand rows) would leave most of the card
// idle, so there a block takes one column of a tile and the blocks of a
// tile read its index from L2.
//
// Bound on the H100: bytes.  The index is read once, each output row is
// written once and each gathered source row read once; the reads are
// random, so the achieved rate depends on how the index scatters rows over
// 32-byte sectors (a sort permutation of few keys reads each source sector
// once per key group that holds one of its rows).
#include <cstring>

#include "common.cuh"

namespace srt_gather_rows {

using namespace srt;

// Table words a column: src data, dst data, src validity, dst validity,
// src lengths, dst lengths (0: fixed width), row bytes | vec << 32 |
// empty << 40 (vec: the widest power-of-two load, at most 16 bytes, that
// divides the row bytes and both data addresses; empty: the source has no
// rows, so every output row is null).
constexpr int kGatherColWords = 7;
// rows a thread owns, 32 apart
constexpr int kRun = 8;
constexpr int kWarpRows = 32 * kRun;
constexpr int kGatherTile = kThreads * kRun;  // output rows a tile (2048)
// below this many tiles a call's columns are split across blocks
constexpr long long kSplitTiles = 2 * 132;
constexpr int kGatherSmallWords = 480;   // 3,840 bytes of parameters
constexpr int kGatherLargeWords = 4000;  // 32,000 bytes

template <int kWords>
struct GatherParams {
  const long long* dev;  // non-null: the table is here
  const int32_t* perm;
  long long m, ntiles;
  int ncols, groups;
  long long w[kWords];
};

template <int E> struct Elem;
template <> struct Elem<1> { typedef uint8_t T; };
template <> struct Elem<2> { typedef uint16_t T; };
template <> struct Elem<4> { typedef uint32_t T; };
template <> struct Elem<8> { typedef unsigned long long T; };
template <> struct Elem<16> { typedef uint4 T; };

// A thread's rows: r0, r0 + 32, ..., those below m real.
struct Run {
  long long r0, m;
  __device__ __forceinline__ long long row(int k) const {
    return r0 + 32ll * k;
  }
  __device__ __forceinline__ bool real(int k) const { return row(k) < m; }
};

// One column of a thread's rows: every load -- validity bytes, lengths
// and, with kData, the data where a row is one E-byte load -- is issued
// before any is used, then the stores.  Returns the rows' validity bits.
template <int E, bool kData>
__device__ __forceinline__ unsigned run_column(const long long* c,
                                               const int32_t* idx,
                                               const Run& run) {
  typedef typename Elem<E>::T T;
  const T* src = reinterpret_cast<const T*>(c[0]);
  const uint8_t* sv = reinterpret_cast<const uint8_t*>(c[2]);
  const int32_t* sl = reinterpret_cast<const int32_t*>(c[4]);
  const bool lens = c[5] != 0;  // a matrix column: lengths too
  const bool empty = ((c[6] >> 40) & 1) != 0;
  uint8_t vin[kRun];
  T x[kRun];
  int32_t ln[kRun];
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    const int32_t s = idx[k];
    const bool in = run.real(k) && s >= 0 && !empty;
    vin[k] = in ? sv[s] : 0;
    if (kData) x[k] = in ? src[s] : T();
    if (lens) ln[k] = in ? sl[s] : 0;
  }
  T* dst = reinterpret_cast<T*>(c[1]);
  uint8_t* dv = reinterpret_cast<uint8_t*>(c[3]);
  int32_t* dl = reinterpret_cast<int32_t*>(c[5]);
  unsigned ok = 0u;
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    const bool o = vin[k] != 0;
    ok |= (unsigned)o << k;
    if (run.real(k)) {
      const long long r = run.row(k);
      dv[r] = o ? 1 : 0;
      if (lens) dl[r] = o ? ln[k] : 0;
      if (kData) dst[r] = o ? x[k] : T();
    }
  }
  return ok;
}

// The block copies the tile's rows (from output row t0, nrows of them) of
// a matrix column in V chunks; s_src[r] is row r's source row or -1.
template <typename V>
__device__ __forceinline__ void tile_chunks(const long long* c, long long t0,
                                            int nrows, int rb,
                                            const int32_t* s_src) {
  const int nv = rb / (int)sizeof(V);
  const V* src = reinterpret_cast<const V*>(c[0]);
  V* dst = reinterpret_cast<V*>(c[1]) + t0 * nv;
  const int total = nrows * nv;
  int row = threadIdx.x / nv, col = threadIdx.x - row * nv;
  const int drow = kThreads / nv, dcol = kThreads - drow * nv;
#pragma unroll 4
  for (int q = threadIdx.x; q < total; q += kThreads) {
    const int32_t s = s_src[row];
    V x = V();
    if (s >= 0) x = src[(long long)s * nv + col];
    dst[q] = x;
    row += drow;
    col += dcol;
    if (col >= nv) {
      col -= nv;
      ++row;
    }
  }
}

// A work item is one tile and one group of its columns: every column
// (groups 1: the index is read once a row for all of them), or, where a
// call has too few tiles to fill the card, one column (groups = ncols:
// the blocks of one tile run together and read its index from L2).
template <int kWords>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const __grid_constant__ GatherParams<kWords> p) {
  __shared__ int32_t s_src[kGatherTile];
  const long long* tab = p.dev != nullptr ? p.dev : p.w;
  const long long items = p.ntiles * p.groups;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const long long tile = it / p.groups;
    const int g = (int)(it - tile * p.groups);
    const int j0 = p.groups == 1 ? 0 : g;
    const int j1 = p.groups == 1 ? p.ncols : g + 1;
    const long long t0 = tile * kGatherTile;
    const long long tr = p.m - t0;
    const int nrows = (int)(tr < kGatherTile ? tr : kGatherTile);
    Run run;
    run.r0 = t0 + (long long)warp * kWarpRows + lane;
    run.m = p.m;
    int32_t idx[kRun];
#pragma unroll
    for (int k = 0; k < kRun; ++k)
      idx[k] = run.real(k) ? p.perm[run.row(k)] : -1;
    for (int j = j0; j < j1; ++j) {
      const long long* c = tab + (long long)j * kGatherColWords;
      const int rb = (int)(c[6] & 0xffffffffll);
      const int vec = (int)((c[6] >> 32) & 0xff);
      if (rb == vec) {
        switch (vec) {
          case 16: run_column<16, true>(c, idx, run); break;
          case 8: run_column<8, true>(c, idx, run); break;
          case 4: run_column<4, true>(c, idx, run); break;
          case 2: run_column<2, true>(c, idx, run); break;
          default: run_column<1, true>(c, idx, run); break;
        }
        continue;
      }
      // the chunk path: every thread of the block takes part
      const unsigned ok = run_column<1, false>(c, idx, run);
#pragma unroll
      for (int k = 0; k < kRun; ++k)
        s_src[warp * kWarpRows + 32 * k + lane] =
            (ok >> k) & 1u ? idx[k] : -1;
      __syncthreads();
      switch (vec) {
        case 16: tile_chunks<uint4>(c, t0, nrows, rb, s_src); break;
        case 8:
          tile_chunks<unsigned long long>(c, t0, nrows, rb, s_src);
          break;
        case 4: tile_chunks<uint32_t>(c, t0, nrows, rb, s_src); break;
        case 2: tile_chunks<uint16_t>(c, t0, nrows, rb, s_src); break;
        default: tile_chunks<uint8_t>(c, t0, nrows, rb, s_src); break;
      }
      __syncthreads();  // s_src is rewritten for the next column
    }
  }
}

template <int kWords>
int launch_gather(const void* words, int64_t nwords, int ncols,
                  const void* words_dev, const int32_t* perm, int64_t m,
                  cudaStream_t stream) {
  GatherParams<kWords> p;
  p.dev = static_cast<const long long*>(words_dev);
  p.perm = perm;
  p.m = m;
  p.ntiles = (m + kGatherTile - 1) / kGatherTile;
  p.ncols = ncols;
  // split the columns across blocks where the tiles alone would leave
  // most of the card's 132 multiprocessors idle
  p.groups = p.ntiles < kSplitTiles ? ncols : 1;
  if (words_dev == nullptr)
    std::memcpy(p.w, words, sizeof(long long) * (size_t)nwords);
  const long long items = p.ntiles * p.groups;
  const long long cap = 132 * 16;
  const int grid = (int)(items < cap ? items : cap);
  gather_kernel<kWords><<<grid, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace srt_gather_rows

using namespace srt_gather_rows;

extern "C" {

// words: the host table described above (nwords = kGatherColWords *
// ncols: ops/kernels.py `gather_table`), copied into the kernel's
// parameters; words_dev, when not null, a device copy of it that the
// kernel reads instead (the wrapper makes one where nwords exceeds
// kGatherLargeWords).  perm: m int32 source rows (below 0: a null row).
// A source without rows (empty set) is never read: its addresses may be
// 0.
int srt_gather(const void* words, int64_t nwords, int ncols,
               const void* words_dev, const void* perm, int64_t m,
               void* stream) {
  if (ncols < 1 || m < 1 || perm == nullptr || words == nullptr ||
      nwords != (int64_t)kGatherColWords * ncols)
    return (int)cudaErrorInvalidValue;
  const long long* w = static_cast<const long long*>(words);
  for (int j = 0; j < ncols; ++j) {
    const long long* c = w + (long long)j * kGatherColWords;
    const long long rb = c[6] & 0xffffffffll, vec = (c[6] >> 32) & 0xff;
    const bool empty = ((c[6] >> 40) & 1) != 0;
    if (rb < 1 || vec < 1 || vec > 16 || (vec & (vec - 1)) != 0 ||
        rb % vec != 0 || c[1] == 0 || c[3] == 0 ||
        (c[5] == 0 && c[4] != 0) ||
        (!empty && (c[0] == 0 || c[2] == 0 || (c[5] != 0 && c[4] == 0))))
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* ix = static_cast<const int32_t*>(perm);
  if (words_dev != nullptr)
    return launch_gather<1>(words, nwords, ncols, words_dev, ix, m, st);
  if (nwords <= kGatherSmallWords)
    return launch_gather<kGatherSmallWords>(words, nwords, ncols, nullptr,
                                            ix, m, st);
  if (nwords <= kGatherLargeWords)
    return launch_gather<kGatherLargeWords>(words, nwords, ncols, nullptr,
                                            ix, m, st);
  return (int)cudaErrorInvalidValue;
}

// The constants the Python wrapper shares with this file, in the order of
// ops/kernels.py's ``native.share_limits`` call: words a column, output
// rows a tile, rows a thread (32 apart), table words of the small and the
// large parameter struct.  Writes the first n of them.
int srt_gather_limits(int64_t* out, int n) {
  const int64_t v[] = {kGatherColWords, kGatherTile, kRun, kGatherSmallWords,
                       kGatherLargeWords};
  for (int i = 0; i < n && i < (int)(sizeof(v) / sizeof(v[0])); ++i)
    out[i] = v[i];
  return 0;
}

}  // extern "C"
