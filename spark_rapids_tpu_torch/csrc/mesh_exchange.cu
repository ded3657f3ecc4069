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
// K15a is one launch for all columns: blockIdx.y is the column, and a
// device-side int64 table (written by the wrapper, ops/mesh_exchange.py)
// holds the row prefix of the destinations, each column's pointers and row
// widths, and the byte offsets of every (destination, column) block.  A
// thread moves one `vec`-byte chunk of one row: 16 bytes where the row
// width and every base address allow it; the row's validity and length go
// with its chunk 0.  Its row's section comes from a binary search of the
// prefix, kept in shared memory.
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

// K15a table: prefix[P + 1] (sorted positions of each destination's rows),
// then per column kPackDesc words, then per (destination, column) three
// byte offsets into the send buffer (data, lengths, validity).
constexpr int kPackDesc = 5;  // data, validity, lengths, row_bytes, vec

// Largest d in [0, P) with prefix[d] <= i: for i below prefix[P], the
// segment that holds row i (empty segments share their start with the
// next one and are skipped).
__device__ __forceinline__ int find_segment(const long long* prefix, int P,
                                            long long i) {
  int lo = 0, hi = P - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (prefix[mid] <= i) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ void copy_chunk(uint8_t* dst, const uint8_t* src,
                                           int vec) {
  switch (vec) {
    case 16: *reinterpret_cast<uint4*>(dst) =
        *reinterpret_cast<const uint4*>(src); break;
    case 8: *reinterpret_cast<unsigned long long*>(dst) =
        *reinterpret_cast<const unsigned long long*>(src); break;
    case 4: *reinterpret_cast<uint32_t*>(dst) =
        *reinterpret_cast<const uint32_t*>(src); break;
    case 2: *reinterpret_cast<uint16_t*>(dst) =
        *reinterpret_cast<const uint16_t*>(src); break;
    default: *dst = *src; break;
  }
}

__device__ __forceinline__ long long align16(long long x) {
  return (x + 15) & ~15ll;
}

__device__ __forceinline__ void zero_tail(uint8_t* p, long long used) {
  const long long end = align16(used);
  for (long long b = used; b < end; ++b) p[b] = 0;
}

__global__ void pack_kernel(const long long* __restrict__ tab, int P,
                            int ncols, const int32_t* __restrict__ perm,
                            long long n, uint8_t* __restrict__ out) {
  extern __shared__ long long prefix[];  // P + 1
  for (int d = threadIdx.x; d <= P; d += blockDim.x) prefix[d] = tab[d];
  __syncthreads();
  const int j = blockIdx.y;
  const long long* desc = tab + (P + 1) + (long long)j * kPackDesc;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(desc[0]);
  const uint8_t* src_valid = reinterpret_cast<const uint8_t*>(desc[1]);
  const int32_t* src_len = reinterpret_cast<const int32_t*>(desc[2]);
  const int rb = (int)desc[3];
  const int vec = (int)desc[4];
  const int chunks = rb / vec;
  const long long* offs = tab + (P + 1) + (long long)ncols * kPackDesc;
  const long long work = n * chunks;
  for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       w < work; w += (long long)gridDim.x * blockDim.x) {
    const long long i = w / chunks;
    const int k = (int)(w - i * chunks);
    const int d = find_segment(prefix, P, i);
    const long long r = i - prefix[d];
    const long long s = perm[i];
    const long long* o = offs + ((long long)d * ncols + j) * 3;
    copy_chunk(out + o[0] + r * rb + (long long)k * vec,
               src + s * rb + (long long)k * vec, vec);
    if (k == 0) {
      out[o[2] + r] = src_valid[s] != 0 ? 1 : 0;
      if (src_len != nullptr)
        reinterpret_cast<int32_t*>(out + o[1])[r] = src_len[s];
      const long long c = prefix[d + 1] - prefix[d];
      if (r == c - 1) {
        zero_tail(out + o[0], c * rb);
        if (src_len != nullptr) zero_tail(out + o[1], c * 4);
        zero_tail(out + o[2], c);
      }
    }
  }
}

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

inline int grid_x(long long work, int ncols) {
  // spread a launch's ~16 waves over its columns
  long long waves = 16 / (ncols > 0 ? ncols : 1);
  return grid_for(work, waves > 1 ? waves : 1);
}

}  // namespace srt_mesh

using namespace srt_mesh;

extern "C" {

// K15a: tab is the device table described above; perm the n sorted row
// indices (K10); out the send buffer of the table's summed section bytes.
int srt_mesh_pack(const void* tab, int P, int ncols, const void* perm,
                  int64_t n, void* out, int64_t max_chunks, void* stream) {
  if (P < 1 || P > 4096 || ncols < 1 || ncols > 65535)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  dim3 grid(grid_x(n * max_chunks, ncols), ncols);
  pack_kernel<<<grid, kThreads, (P + 1) * sizeof(long long),
                (cudaStream_t)stream>>>(
      (const long long*)tab, P, ncols, (const int32_t*)perm, n,
      (uint8_t*)out);
  return (int)cudaGetLastError();
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
// struct.  Writes the first n of them.
int srt_mesh_exchange_limits(int64_t* out, int n) {
  const int64_t v[] = {kSpanWords, kTileBytes, kUnpackSmallWords,
                       kUnpackLargeWords};
  for (int i = 0; i < n && i < (int)(sizeof(v) / sizeof(v[0])); ++i)
    out[i] = v[i];
  return 0;
}

}  // extern "C"
