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
// Both kernels are one launch for all columns: blockIdx.y is the column,
// and a device-side int64 table (written by the wrapper, ops/
// mesh_exchange.py) holds the row prefix of the destinations (K15a) or of
// the sources (K15b), each column's pointers and row widths, and (K15a) the
// byte offsets of every (destination, column) block.  A thread moves one
// `vec`-byte chunk of one row: 16 bytes where the row width and every base
// address allow it; the row's validity and length go with its chunk 0.
// Its row's section (K15a) or source (K15b) comes from a binary search of
// the prefix, kept in shared memory.
//
// Bound on the H100: bytes.  Each input row is read once and each output
// row written once (K15a reads its rows through the permutation, so its
// reads are as scattered as K10's order of the rows; its writes and all of
// K15b's reads and writes are sequential).
#include "common.cuh"

namespace srt_mesh {

using namespace srt;

// K15a table: prefix[P + 1] (sorted positions of each destination's rows),
// then per column kPackDesc words, then per (destination, column) three
// byte offsets into the send buffer (data, lengths, validity).
constexpr int kPackDesc = 5;  // data, validity, lengths, row_bytes, vec
// K15b table: prefix[P + 1] (output rows of each source), then per column
// kOutDesc words, then per (column, source) kSegDesc words.
constexpr int kOutDesc = 5;  // out data, out validity, out lengths,
                             // out row_bytes, vec
constexpr int kSegDesc = 4;  // data, validity, lengths, row_bytes

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

__device__ __forceinline__ void zero_chunk(uint8_t* dst, int vec) {
  switch (vec) {
    case 16: *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0); break;
    case 8: *reinterpret_cast<unsigned long long*>(dst) = 0ull; break;
    case 4: *reinterpret_cast<uint32_t*>(dst) = 0u; break;
    case 2: *reinterpret_cast<uint16_t*>(dst) = 0; break;
    default: *dst = 0; break;
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

__global__ void unpack_kernel(const long long* __restrict__ tab, int P,
                              int ncols, long long total) {
  extern __shared__ long long prefix[];  // P + 1
  for (int s = threadIdx.x; s <= P; s += blockDim.x) prefix[s] = tab[s];
  __syncthreads();
  const int j = blockIdx.y;
  const long long* od = tab + (P + 1) + (long long)j * kOutDesc;
  uint8_t* dst = reinterpret_cast<uint8_t*>(od[0]);
  uint8_t* dst_valid = reinterpret_cast<uint8_t*>(od[1]);
  int32_t* dst_len = reinterpret_cast<int32_t*>(od[2]);
  const int rb = (int)od[3];
  const int vec = (int)od[4];
  const int chunks = rb / vec;
  const long long* segs = tab + (P + 1) + (long long)ncols * kOutDesc
      + (long long)j * P * kSegDesc;
  const long long work = total * chunks;
  for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       w < work; w += (long long)gridDim.x * blockDim.x) {
    const long long i = w / chunks;
    const int k = (int)(w - i * chunks);
    const int s = find_segment(prefix, P, i);
    const long long r = i - prefix[s];
    const long long* sd = segs + (long long)s * kSegDesc;
    const uint8_t* src = reinterpret_cast<const uint8_t*>(sd[0]);
    const int src_rb = (int)sd[3];
    uint8_t* to = dst + i * rb + (long long)k * vec;
    if ((long long)k * vec < src_rb)
      copy_chunk(to, src + r * src_rb + (long long)k * vec, vec);
    else
      zero_chunk(to, vec);
    if (k == 0) {
      dst_valid[i] =
          reinterpret_cast<const uint8_t*>(sd[1])[r] != 0 ? 1 : 0;
      if (dst_len != nullptr)
        dst_len[i] = reinterpret_cast<const int32_t*>(sd[2])[r];
    }
  }
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

// K15b: tab is the device table described above; total the summed rows
// of the P sources.
int srt_mesh_unpack(const void* tab, int P, int ncols, int64_t total,
                    int64_t max_chunks, void* stream) {
  if (P < 1 || P > 4096 || ncols < 1 || ncols > 65535)
    return (int)cudaErrorInvalidValue;
  if (total == 0) return (int)cudaGetLastError();
  dim3 grid(grid_x(total * max_chunks, ncols), ncols);
  unpack_kernel<<<grid, kThreads, (P + 1) * sizeof(long long),
                  (cudaStream_t)stream>>>(
      (const long long*)tab, P, ncols, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
