// K3: row gather by index with null-slot zeroing.
//
// Replaces spark_rapids_tpu/ops/kernels.py:42 `_gather_column` (used by
// `gather_columns` :55 and `take` :97): out[i] = col[perm[i]], validity
// out[i] = validity[perm[i]], and zero data / zero length in null slots.
// An index below 0 yields a null row (the segmented aggregate uses it for
// first/last over a group with no eligible row).
//
// Two kernels: gather_fixed_kernel for 1/2/4/8-byte columns (one thread per
// row), and gather_rows_kernel for W-byte rows of a byte matrix (one thread
// per 16-byte chunk, so a wide string row is copied by W/16 neighbouring
// threads and every access is a full 16-byte load or store).
//
// Bound on the H100: bytes.  The index is read once, each output row is
// written once and each gathered source row read once; the reads are
// random, so the achieved rate depends on how the index scatters rows over
// 32-byte sectors (a sort permutation of clustered keys stays close to
// sequential).
#include "common.cuh"

namespace srt_gather {

using namespace srt;

template <typename T>
__global__ void gather_fixed_kernel(const int32_t* __restrict__ idx,
                                    int64_t m, const T* __restrict__ src,
                                    T* __restrict__ dst,
                                    const uint8_t* __restrict__ src_valid,
                                    uint8_t* __restrict__ dst_valid) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int32_t s = idx[i];
    const bool valid = s >= 0 && src_valid[s] != 0;
    dst_valid[i] = valid ? 1 : 0;
    dst[i] = valid ? src[s] : T(0);
  }
}

template <typename V>
__global__ void gather_rows_kernel(const int32_t* __restrict__ idx,
                                   int64_t m, int chunks_per_row,
                                   const V* __restrict__ src,
                                   V* __restrict__ dst,
                                   const uint8_t* __restrict__ src_valid,
                                   uint8_t* __restrict__ dst_valid,
                                   const int32_t* __restrict__ src_len,
                                   int32_t* __restrict__ dst_len) {
  const int64_t total = m * chunks_per_row;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < total;
       j += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i = j / chunks_per_row;
    const int chunk = (int)(j - i * chunks_per_row);
    const int32_t s = idx[i];
    const bool valid = s >= 0 && src_valid[s] != 0;
    if (chunk == 0) {
      dst_valid[i] = valid ? 1 : 0;
      dst_len[i] = valid ? src_len[s] : 0;
    }
    dst[j] = valid ? src[(int64_t)s * chunks_per_row + chunk] : V();
  }
}

template <typename V>
void launch_rows(const int32_t* idx, int64_t m, int row_bytes,
                 const void* src, void* dst, const uint8_t* sv, uint8_t* dv,
                 const int32_t* sl, int32_t* dl, cudaStream_t stream) {
  const int cpr = row_bytes / (int)sizeof(V);
  gather_rows_kernel<V><<<grid_for(m * cpr), kThreads, 0, stream>>>(
      idx, m, cpr, (const V*)src, (V*)dst, sv, dv, sl, dl);
}

}  // namespace srt_gather

using namespace srt_gather;

extern "C" {

// Gather one column.  src_len/dst_len are null for fixed-width columns, in
// which case row_bytes is the item size (1, 2, 4 or 8).
int srt_gather_column(const void* idx, int64_t m, const void* src_data,
                      void* dst_data, const void* src_valid, void* dst_valid,
                      const void* src_len, void* dst_len, int row_bytes,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* ix = (const int32_t*)idx;
  const uint8_t* sv = (const uint8_t*)src_valid;
  uint8_t* dv = (uint8_t*)dst_valid;
  if (m == 0) return (int)cudaGetLastError();
  if (src_len == nullptr) {
    const int g = grid_for(m);
    switch (row_bytes) {
      case 1: gather_fixed_kernel<uint8_t><<<g, kThreads, 0, st>>>(
          ix, m, (const uint8_t*)src_data, (uint8_t*)dst_data, sv, dv); break;
      case 2: gather_fixed_kernel<uint16_t><<<g, kThreads, 0, st>>>(
          ix, m, (const uint16_t*)src_data, (uint16_t*)dst_data, sv, dv); break;
      case 4: gather_fixed_kernel<uint32_t><<<g, kThreads, 0, st>>>(
          ix, m, (const uint32_t*)src_data, (uint32_t*)dst_data, sv, dv); break;
      case 8: gather_fixed_kernel<unsigned long long><<<g, kThreads, 0, st>>>(
          ix, m, (const unsigned long long*)src_data,
          (unsigned long long*)dst_data, sv, dv); break;
      default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
  }
  const int32_t* sl = (const int32_t*)src_len;
  int32_t* dl = (int32_t*)dst_len;
  switch (pick_vec_bytes(src_data, dst_data, row_bytes)) {
    case 16: launch_rows<uint4>(ix, m, row_bytes, src_data, dst_data, sv, dv, sl, dl, st); break;
    case 8: launch_rows<unsigned long long>(ix, m, row_bytes, src_data, dst_data, sv, dv, sl, dl, st); break;
    case 4: launch_rows<uint32_t>(ix, m, row_bytes, src_data, dst_data, sv, dv, sl, dl, st); break;
    case 2: launch_rows<uint16_t>(ix, m, row_bytes, src_data, dst_data, sv, dv, sl, dl, st); break;
    default: launch_rows<uint8_t>(ix, m, row_bytes, src_data, dst_data, sv, dv, sl, dl, st); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
