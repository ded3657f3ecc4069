// K15: the mesh shuffle's pack and unpack.
//
// K15a srt_mesh_pack replaces spark_rapids_tpu/parallel/mesh_shuffle.py:70
// `_bucketize` (and the send half of `exchange_local_checked` :148-171):
// count rows per destination, order them stably by destination and scatter
// every column into [P, C] send buffers.  The port takes K10's stable
// permutation and per-destination counts (csrc/partition_group.cu, not
// recounted here) and writes ONE uint8 send buffer of P sections.  Section
// d holds, 16-byte aligned, each column's rows for d in order: the data
// (row_bytes a row: the item size, or W for a string's byte matrix), the
// int32 lengths (strings and arrays only) and the validity bytes.  Section
// d is exactly as long as its rows need, so no row is dropped and a cross-
// card exchange moves one contiguous copy per (source, destination) pair.
// The pad bytes after each block are written as zeros, so the buffer is
// deterministic byte for byte.
//
// K15b srt_mesh_unpack replaces :114 `_repack` (and the gathers of
// exec/mesh_exec.py:164 `all_gather_batch` and exec/mesh_region.py:125-141):
// for one destination, P received segments front-packed in source-major
// order, stable within a source, string rows zero-padded to the widest W
// of the sources (the reference's `_pad_widths`).  A segment is either a
// section of a K15a send buffer or a shard's own columns, so an all-gather
// needs no K15a.
//
// K15a is one launch for all columns, in tiles: a tile is up to
// kPackTileRows rows of one (destination, column) block, so a block finds
// its section, column and rows once a tile, not once a row; the tiles of all
// destinations that read the same stretch of source rows run together, so
// the source is read from memory about once.  The table travels by value in
// the kernel's parameters (__grid_constant__, the two sizes K15b uses), or,
// where it is longer, as a device copy the wrapper makes: no pinned copy per
// call.  The tile's permutation entries are staged in shared memory; then
// each thread builds 16-byte output chunks, each from the rows it covers
// gathered through the permutation (four int32 rows, sixteen validity bytes
// or four lengths a chunk; a string row 16 bytes at a time where W and the
// matrix's address allow), all of a chunk's loads in flight together, and
// stores them as one uint4.  The tile that ends a block writes its pad bytes
// as zeros in its last chunks, so every byte of the send buffer is written
// once and the buffer is byte-identical to the plain version's.
//
// K15b is a batched copy of spans, one launch for all columns.  For one
// destination every (column, source) block -- data, lengths, validity --
// whose row width equals the output's is one contiguous byte range, so the
// host lists the spans (src, dst, rows, src_w, dst_w; ops/mesh_exchange.py
// `unpack_plan`) and cuts each into tiles of kTileBytes output bytes (a
// string or array source narrower than the output W is a row-padded span:
// src_w bytes a row copied, the rest zeroed, whole rows a tile).  A block
// takes one tile at a time; one thread finds its span by a binary search of
// the tile prefix and the block copies it: 16-byte stores on the aligned
// body of the destination (a destination at prefix[s] * row_bytes is in
// general not 16-byte aligned), bytes on the unaligned head and tail, and
// the source realigned with funnel shifts from two aligned 16-byte loads
// where its misalignment differs from the destination's.  Those loads read
// whole aligned 16-byte granules that hold at least one byte of the span,
// so they stay inside the source's allocation.  The span table travels by
// value in the kernel's parameters (__grid_constant__, two sizes; sm_90
// with CUDA 12.1+ takes up to 32,764 bytes), or, where it is longer, as a
// device copy the wrapper makes: no pinned copy per call.
//
// Bound on the H100: bytes.  Each input row is read once and each output
// row written once (K15a reads its rows through the permutation, so its
// reads are as scattered as K10's order of the rows; its writes and all of
// K15b's reads and writes are sequential).
#include <cstring>

#include "common.cuh"

namespace srt_mesh {

using namespace srt;

// K15b: the span table holds kSpanWords words a span (src, dst, rows,
// src_w, dst_w), then the first tile of each span and the tile count.
constexpr int kSpanWords = 5;
constexpr long long kTileBytes = 32 * 1024;
constexpr int kUnpackSmallWords = 480;   // 3,840 bytes of parameters
constexpr int kUnpackLargeWords = 4000;  // 32,000 bytes

template <int kWords>
struct UnpackParams {
  const long long* dev;  // non-null: the table is here
  long long ntiles;
  int nspans;
  long long w[kWords];
};

// Bytes [sh, sh + 16) of the 32 bytes a:b (little endian).
__device__ __forceinline__ uint4 shift_bytes(const uint4 a, const uint4 b,
                                             int sh) {
  const unsigned r = 8u * (unsigned)(sh & 3);
#define SRT_F(lo, hi) __funnelshift_r((lo), (hi), r)
  switch (sh >> 2) {
    case 0: return make_uint4(SRT_F(a.x, a.y), SRT_F(a.y, a.z),
                              SRT_F(a.z, a.w), SRT_F(a.w, b.x));
    case 1: return make_uint4(SRT_F(a.y, a.z), SRT_F(a.z, a.w),
                              SRT_F(a.w, b.x), SRT_F(b.x, b.y));
    case 2: return make_uint4(SRT_F(a.z, a.w), SRT_F(a.w, b.x),
                              SRT_F(b.x, b.y), SRT_F(b.y, b.z));
    default: return make_uint4(SRT_F(a.w, b.x), SRT_F(b.x, b.y),
                               SRT_F(b.y, b.z), SRT_F(b.z, b.w));
  }
#undef SRT_F
}

// The block copies n bytes from src to dst.
__device__ __forceinline__ void copy_range(uint8_t* dst, const uint8_t* src,
                                           int n) {
  int head = (int)((16 - ((uintptr_t)dst & 15)) & 15);
  if (head > n) head = n;
  const int body = (n - head) >> 4;  // 16-byte aligned destination chunks
  const int tail = head + 16 * body;
  const int t = threadIdx.x;
  if (t < head) dst[t] = src[t];
  if (tail + t < n) dst[tail + t] = src[tail + t];
  uint4* d = reinterpret_cast<uint4*>(dst + head);
  const uint8_t* s = src + head;
  const int sh = (int)((uintptr_t)s & 15);
  if (sh == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(s);
#pragma unroll 4
    for (int i = t; i < body; i += kThreads) d[i] = s4[i];
  } else {
    const uint4* s4 = reinterpret_cast<const uint4*>(s - sh);
#pragma unroll 4
    for (int i = t; i < body; i += kThreads)
      d[i] = shift_bytes(s4[i], s4[i + 1], sh);
  }
}

// The block copies nr rows of sw bytes into rows of dw bytes, zeroing the
// dw - sw bytes past each.
__device__ __forceinline__ void copy_padded(uint8_t* dst, const uint8_t* src,
                                            int nr, int sw, int dw) {
  const long long total = (long long)nr * dw;
  int row = threadIdx.x / dw, col = threadIdx.x % dw;
  const int q = kThreads / dw, rem = kThreads % dw;
  for (long long o = threadIdx.x; o < total; o += kThreads) {
    dst[o] = col < sw ? src[(long long)row * sw + col] : 0;
    row += q;
    col += rem;
    if (col >= dw) {
      col -= dw;
      ++row;
    }
  }
}

template <int kWords>
__global__ void __launch_bounds__(kThreads)
unpack_kernel(const __grid_constant__ UnpackParams<kWords> p) {
  __shared__ int s_span;
  const long long* tab = p.dev != nullptr ? p.dev : p.w;
  const long long* start = tab + (long long)p.nspans * kSpanWords;
  for (long long t = blockIdx.x; t < p.ntiles; t += gridDim.x) {
    if (threadIdx.x == 0) {  // the last span whose first tile is <= t
      int lo = 0, hi = p.nspans - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (start[mid] <= t) lo = mid; else hi = mid - 1;
      }
      s_span = lo;
    }
    __syncthreads();
    const int s = s_span;
    const long long* sp = tab + (long long)s * kSpanWords;
    const uint8_t* src = reinterpret_cast<const uint8_t*>(sp[0]);
    uint8_t* dst = reinterpret_cast<uint8_t*>(sp[1]);
    const long long rows = sp[2], sw = sp[3], dw = sp[4];
    const long long k = t - start[s];
    if (sw == dw) {
      const long long lo = k * kTileBytes;
      const long long rest = rows * dw - lo;
      copy_range(dst + lo, src + lo,
                 (int)(rest < kTileBytes ? rest : kTileBytes));
    } else {
      const long long per = kTileBytes / dw > 0 ? kTileBytes / dw : 1;
      const long long r0 = k * per;
      const long long nr = rows - r0 < per ? rows - r0 : per;
      copy_padded(dst + r0 * dw, src + r0 * sw, (int)nr, (int)sw, (int)dw);
    }
    __syncthreads();  // s_span is rewritten for the next tile
  }
}

template <int kWords>
int launch_unpack(const void* words, int64_t nwords, int nspans,
                  int64_t ntiles, const void* words_dev,
                  cudaStream_t stream) {
  UnpackParams<kWords> p;
  p.dev = static_cast<const long long*>(words_dev);
  p.ntiles = ntiles;
  p.nspans = nspans;
  if (words_dev == nullptr)
    std::memcpy(p.w, words, sizeof(long long) * (size_t)nwords);
  const long long cap = 132 * 16;
  const int grid = (int)(ntiles < cap ? ntiles : cap);
  unpack_kernel<kWords><<<grid, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// K15a: the table holds kPackColWords words a column (data, validity,
// lengths or 0, row bytes | vec << 32, vec the widest power-of-two load,
// at most 16 bytes, that divides the row bytes and the data's address),
// then prefix[P + 1] (where each destination's rows start in the
// permutation), then the data offset of each (destination, column) block
// in the send buffer (destination-major).  Tile t is chunk t / (P * ncols)
// (kPackTileRows rows) of destination (t / ncols) % P, column t % ncols:
// the tiles that run together read the same stretch of the source rows
// (K10's order keeps each destination's rows in row order), so the
// source stays in L2 while every destination takes its rows from it.  A
// tile past its destination's rows does nothing.
constexpr int kPackColWords = 4;
constexpr int kPackTileRows = 2048;

template <int kWords>
struct PackParams {
  const long long* dev;  // non-null: the table is here
  const int32_t* perm;
  uint8_t* out;
  long long ntiles;
  int P, ncols;
  long long w[kWords];
};

__device__ __forceinline__ long long align16(long long x) {
  return (x + 15) & ~15ll;
}

template <int E> struct Elem;
template <> struct Elem<1> { typedef uint8_t T; };
template <> struct Elem<2> { typedef uint16_t T; };
template <> struct Elem<4> { typedef uint32_t T; };
template <> struct Elem<8> { typedef unsigned long long T; };
template <> struct Elem<16> { typedef uint4 T; };

// The block writes the 16-byte chunks of dst[0, nbytes): byte b of it is
// byte b % rb of the tile's row b / rb (of nr rows, their source rows in
// rows[]), zero past the last row; E-byte loads (E divides rb and 16).
template <int E>
__device__ __forceinline__ void pack_rows(uint8_t* dst, int nbytes,
                                          const uint8_t* src, int rb,
                                          const int32_t* rows, int nr) {
  typedef typename Elem<E>::T T;
  const int nch = nbytes >> 4;
  for (int q = threadIdx.x; q < nch; q += kThreads) {
    union {
      uint4 v;
      T e[16 / E];
    } chunk;
#pragma unroll
    for (int k = 0; k < 16 / E; ++k) {
      const int b = 16 * q + E * k;
      const int r = rb == E ? b / E : b / rb;
      if (r < nr)
        chunk.e[k] = *reinterpret_cast<const T*>(
            src + (long long)rows[r] * rb + (b - r * rb));
      else
        chunk.e[k] = T();
    }
    *reinterpret_cast<uint4*>(dst + 16 * q) = chunk.v;
  }
}

// Validity bytes (0/1) of the tile's rows, sixteen a chunk.
__device__ __forceinline__ void pack_valid(uint8_t* dst, int nbytes,
                                           const uint8_t* src,
                                           const int32_t* rows, int nr) {
  const int nch = nbytes >> 4;
  for (int q = threadIdx.x; q < nch; q += kThreads) {
    union {
      uint4 v;
      uint8_t b[16];
    } chunk;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int r = 16 * q + k;
      chunk.b[k] = r < nr && src[rows[r]] != 0 ? 1 : 0;
    }
    *reinterpret_cast<uint4*>(dst + 16 * q) = chunk.v;
  }
}

template <int kWords>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const __grid_constant__ PackParams<kWords> p) {
  __shared__ int32_t s_rows[kPackTileRows];
  const long long* cols = p.dev != nullptr ? p.dev : p.w;
  const long long* prefix = cols + (long long)p.ncols * kPackColWords;
  const long long* offs = prefix + p.P + 1;
  for (long long t = blockIdx.x; t < p.ntiles; t += gridDim.x) {
    const int j = (int)(t % p.ncols);
    const long long dk = t / p.ncols;
    const int d = (int)(dk % p.P);
    const long long rows = prefix[d + 1] - prefix[d];
    const long long r0 = dk / p.P * kPackTileRows;
    if (r0 >= rows) continue;  // the whole block: no barrier skipped
    const long long* c = cols + (long long)j * kPackColWords;
    const int nr = (int)(rows - r0 < kPackTileRows ? rows - r0
                                                   : kPackTileRows);
    const bool last = r0 + nr == rows;
    const int32_t* perm = p.perm + prefix[d] + r0;
    for (int i = threadIdx.x; i < nr; i += kThreads) s_rows[i] = perm[i];
    __syncthreads();
    const int rb = (int)(c[3] & 0xffffffffll);
    const int vec = (int)(c[3] >> 32);
    const uint8_t* src = reinterpret_cast<const uint8_t*>(c[0]);
    uint8_t* blk = p.out + offs[(long long)d * p.ncols + j];
    // data: bytes [r0 * rb, ...) of the block, its pad with the last tile
    const long long dbytes = align16(rows * rb);
    const int nd = (int)(last ? dbytes - r0 * rb : (long long)nr * rb);
    uint8_t* dd = blk + r0 * rb;
    switch (vec) {
      case 16: pack_rows<16>(dd, nd, src, rb, s_rows, nr); break;
      case 8: pack_rows<8>(dd, nd, src, rb, s_rows, nr); break;
      case 4: pack_rows<4>(dd, nd, src, rb, s_rows, nr); break;
      case 2: pack_rows<2>(dd, nd, src, rb, s_rows, nr); break;
      default: pack_rows<1>(dd, nd, src, rb, s_rows, nr); break;
    }
    uint8_t* after = blk + dbytes;
    if (c[2] != 0) {  // the int32 lengths
      const long long lbytes = align16(4 * rows);
      pack_rows<4>(after + 4 * r0,
                   (int)(last ? lbytes - 4 * r0 : 4ll * nr),
                   reinterpret_cast<const uint8_t*>(c[2]), 4, s_rows, nr);
      after += lbytes;
    }
    pack_valid(after + r0, (int)(last ? align16(rows) - r0 : nr),
               reinterpret_cast<const uint8_t*>(c[1]), s_rows, nr);
    __syncthreads();  // s_rows is rewritten for the next tile
  }
}

template <int kWords>
int launch_pack(const void* words, int64_t nwords, int P, int ncols,
                int64_t ntiles, const void* words_dev, const void* perm,
                void* out, cudaStream_t stream) {
  PackParams<kWords> p;
  p.dev = static_cast<const long long*>(words_dev);
  p.perm = static_cast<const int32_t*>(perm);
  p.out = static_cast<uint8_t*>(out);
  p.ntiles = ntiles;
  p.P = P;
  p.ncols = ncols;
  if (words_dev == nullptr)
    std::memcpy(p.w, words, sizeof(long long) * (size_t)nwords);
  const long long cap = 132 * 16;
  const int grid = (int)(ntiles < cap ? ntiles : cap);
  pack_kernel<kWords><<<grid, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace srt_mesh

using namespace srt_mesh;

extern "C" {

// K15a: words is the host table described above (nwords = kPackColWords
// * ncols + P * ncols + P + 1 words: ops/mesh_exchange.py `pack_plan`),
// copied into the kernel's parameters; ntiles: P * ncols times the most
// tiles a destination needs; words_dev, when not
// null, a device copy of it that the kernel reads instead (the wrapper
// makes one where nwords exceeds kUnpackLargeWords).  perm: the sorted
// row indices (K10); out: the send buffer (ops/mesh_exchange.py
// `pack_layout`).
int srt_mesh_pack(const void* words, int64_t nwords, int P, int ncols,
                  int64_t ntiles, const void* words_dev, const void* perm,
                  void* out, void* stream) {
  if (P < 1 || P > 4096 || ncols < 1 || ncols > 65535 || ntiles < 1 ||
      ntiles % ((int64_t)P * ncols) != 0 ||
      nwords != (int64_t)kPackColWords * ncols + (int64_t)P * ncols + P + 1 ||
      (words == nullptr && words_dev == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (words_dev != nullptr)
    return launch_pack<1>(words, nwords, P, ncols, ntiles, words_dev, perm,
                          out, st);
  if (nwords <= kUnpackSmallWords)
    return launch_pack<kUnpackSmallWords>(words, nwords, P, ncols, ntiles,
                                          nullptr, perm, out, st);
  if (nwords <= kUnpackLargeWords)
    return launch_pack<kUnpackLargeWords>(words, nwords, P, ncols, ntiles,
                                          nullptr, perm, out, st);
  return (int)cudaErrorInvalidValue;
}

// K15b: words is the host span table described above (nwords = 6 * nspans
// + 1 words: ops/mesh_exchange.py `unpack_plan`), copied into the
// kernel's parameters; words_dev, when not null, a device copy of it that
// the kernel reads instead (the wrapper makes one where nwords exceeds
// kUnpackLargeWords).
int srt_mesh_unpack(const void* words, int64_t nwords, int nspans,
                    int64_t ntiles, const void* words_dev, void* stream) {
  if (nspans < 1 || ntiles < 1 || nwords != 6ll * nspans + 1 ||
      (words == nullptr && words_dev == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (words_dev != nullptr)
    return launch_unpack<1>(words, nwords, nspans, ntiles, words_dev, st);
  if (nwords <= kUnpackSmallWords)
    return launch_unpack<kUnpackSmallWords>(words, nwords, nspans, ntiles,
                                            nullptr, st);
  if (nwords <= kUnpackLargeWords)
    return launch_unpack<kUnpackLargeWords>(words, nwords, nspans, ntiles,
                                            nullptr, st);
  return (int)cudaErrorInvalidValue;
}

// The constants the Python wrapper shares with this file, in the order of
// ops/mesh_exchange.py's ``native.share_limits`` call: words a span,
// output bytes a tile, table words of the small and the large parameter
// struct (K15a's table takes the same two sizes), K15a's words a column
// and rows a tile.  Writes the first n of them.
int srt_mesh_exchange_limits(int64_t* out, int n) {
  const int64_t v[] = {kSpanWords, kTileBytes, kUnpackSmallWords,
                       kUnpackLargeWords, kPackColWords, kPackTileRows};
  for (int i = 0; i < n && i < (int)(sizeof(v) / sizeof(v[0])); ++i)
    out[i] = v[i];
  return 0;
}

}  // extern "C"
