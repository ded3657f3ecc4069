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
// Design: one launch per batch, and no intermediate for the rows.  The
// order is K1's packed order (sort_key.cuh): each key column maps to a
// fixed sequence of unsigned fields, and comparing two rows field by field,
// key by key, the first difference deciding, is comparing their packed
// limbs from the top down.  So:
//   * srt_range_bound_fields encodes the P - 1 sorted bounds once per
//     layout (the wrapper caches them): per bound its top key folded into
//     one 128-bit value, then every field.
//   * srt_range_partition: a thread takes kRows rows and counts, for each,
//     the sorted bounds below it by a lower-bound search in fixed
//     power-of-two steps, the rows' steps interleaved.  The row's key
//     columns are read in place through their descriptors (kind, item
//     size, packed width, direction, null order, data/validity/length
//     pointers).  The top key, unless it is a string, is encoded once into
//     registers, its fields folded into one 128-bit value (the kernel is
//     specialised on its type, so the rows' loads issue back to back), and
//     most comparisons end there; lower keys are read and encoded only on a
//     tie.
//   * The descriptors travel by value in the kernel's parameters
//     (__grid_constant__): no upload and no pinned allocation per call.  A
//     table of more than kParamKeys keys is read from a device copy the
//     wrapper makes instead.  A block stages the bounds in shared memory
//     when they fit in the default 48 KB (their top keys issued first, so
//     the rows' loads overlap the staging), else reads them from global
//     memory, where they stay cached.
//
// Bound on the H100: bytes.  Each key column and its validity read once,
// the id written once; a lower key is read only for rows that tie with a
// bound on every key above it.  log2(P) comparisons a row are far below
// the card's integer rate.
#include <cstring>

#include "common.cuh"
#include "sort_key.cuh"

namespace srt_rp {

using namespace srt;
typedef unsigned long long u64;

constexpr int kSharedBytes = 48 * 1024;
// most key descriptors held in the kernel's parameters
constexpr int kParamKeys = 32;
// most key descriptors a block copies into shared memory
constexpr int kSharedKeys = 64;
// leading words of a bound's row in the bounds table: its top key folded
constexpr int kTopWords = 2;
// rows a thread handles, their loads and search steps interleaved
constexpr int kRows = 4;

struct RangeParams {
  const SortKey* keys_dev;  // non-null: read the descriptors here
  const u64* bounds;        // nb rows of kTopWords + nfields words
  int32_t* ids;
  long long n;              // rows (bound rows for bound_fields_kernel)
  int nkeys, nfields, nb, top_fields;
  int top_kind_item;        // kind * 16 + item of a fixed-width top key
  int top_step;             // the largest power of two <= nb (0: nb 0)
  SortKey top;              // keys[0], read at a fixed parameter offset
  SortKey keys[kParamKeys];
};

// The top key's fields (all of them fixed-width, the last one the widest)
// folded into one 128-bit value (hi, lo) that orders as the fields do: a
// 64-bit value field goes whole into lo, the 1-2 bits above it into hi;
// narrower keys fit in lo (at most 34 bits).
__device__ __forceinline__ void fold_top(const SortKey& k, int64_t row,
                                         int nf, u64* hi, u64* lo) {
  u64 h = 0, l = 0;
  for (int f = 0; f < nf; ++f) {
    int bits;
    const u64 v = key_field(k, row, f, &bits);
    if (bits == 64) {
      h = l;
      l = v;
    } else {
      l = (l << bits) | v;
    }
  }
  *hi = h;
  *lo = l;
}

// Sign of (bound - row) over every field of keys [k0, nkeys); b holds the
// bound's fields from key k0's first.
__device__ __forceinline__ int compare_from(const SortKey* keys, int k0,
                                            int nkeys, int64_t row,
                                            const u64* b) {
  for (int k = k0; k < nkeys; ++k) {
    const SortKey& key = keys[k];
    const int nf = key_nfields((int)key.kind, (int)key.width);
    for (int f = 0; f < nf; ++f) {
      int bits;
      const u64 r = key_field(key, row, f, &bits);
      const u64 v = *b++;
      if (v != r) return v < r ? -1 : 1;
    }
  }
  return 0;
}

// Each bound row's top key folded (kTopWords; zero for a string top key),
// then every key's fields.
__global__ void __launch_bounds__(kThreads)
bound_fields_kernel(const __grid_constant__ RangeParams p, u64* out) {
  const SortKey* keys = p.keys_dev != nullptr ? p.keys_dev : p.keys;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       row < p.n; row += (int64_t)gridDim.x * blockDim.x) {
    u64* o = out + row * (kTopWords + p.nfields);
    o[0] = o[1] = 0;
    if (p.top_fields > 0) fold_top(keys[0], row, p.top_fields, o, o + 1);
    o += kTopWords;
    for (int k = 0; k < p.nkeys; ++k) {
      const SortKey key = keys[k];
      const int nf = key_nfields((int)key.kind, (int)key.width);
      for (int f = 0; f < nf; ++f) {
        int bits;
        *o++ = key_field(key, row, f, &bits);
      }
    }
  }
}

// kShared: the bounds are staged in shared memory (else read from the
// global table).  kKind/kItem: the top key's kind and item size where it
// is fixed-width (the compiler then folds key_field's branches and issues
// the kRows rows' loads back to back), kKind -1 for a string top key.
// Dynamic shared memory: the descriptors (up to kSharedKeys), then
// (kShared) the bounds' top keys and whole rows.
template <bool kShared, int kKind, int kItem>
__global__ void __launch_bounds__(kThreads)
range_ids_kernel(const __grid_constant__ RangeParams p) {
  extern __shared__ u64 smem[];
  SortKey top = p.top;
  if (kKind >= 0) {
    top.kind = kKind;
    top.item = kItem;
  }
  // the top key folds into lo alone unless its value field is 64 bits wide
  constexpr bool kHi = kKind < 0 || (kKind != kBool && kItem == 8);
  const int tf = kKind >= 0 ? (kKind == kFloat ? 3 : 2) : p.top_fields;
  const int rest = tf > 0 ? 1 : 0;
  const bool deeper = tf == 0 || p.nkeys > 1;  // a tie reads lower keys
  // the rows' top key first, so that its loads overlap the staging below
  const int64_t base = (int64_t)blockIdx.x * (kThreads * kRows) + threadIdx.x;
  u64 hi[kRows], lo[kRows];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int64_t row = base + u * kThreads;
    hi[u] = lo[u] = 0;
    if (tf > 0 && row < p.n) fold_top(top, row, tf, &hi[u], &lo[u]);
  }
  const int nb = p.nb;
  const int stride = kTopWords + p.nfields;
  const SortKey* keys = p.keys_dev != nullptr ? p.keys_dev : p.keys;
  // staging: the descriptors, then (kShared) the bounds' folded top keys
  // as two arrays and their whole rows
  const u64* full = p.bounds;
  const u64* thi = p.bounds;
  const u64* tlo = p.bounds + 1;
  int ts = stride;
  u64* s = smem;
  if (p.nkeys <= kSharedKeys) {
    SortKey* sk = reinterpret_cast<SortKey*>(s);
    for (int t = threadIdx.x; t < p.nkeys; t += blockDim.x) sk[t] = keys[t];
    keys = sk;
    s += p.nkeys * (int)(sizeof(SortKey) / sizeof(u64));
  }
  if (kShared) {
    u64* sh = s;
    u64* sl = s + nb;
    u64* sf = s + 2 * nb;
    for (int t = threadIdx.x; t < nb * stride; t += blockDim.x) {
      const u64 w = p.bounds[t];
      sf[t] = w;
      const int c = t % stride;
      if (c == 0) sh[t / stride] = w;
      else if (c == 1) sl[t / stride] = w;
    }
    full = sf;
    thi = sh;
    tlo = sl;
    ts = 1;
  }
  __syncthreads();
  // lower bound in fixed power-of-two steps, the kRows rows interleaved:
  // l[u] counts the sorted bounds below row u
  int l[kRows];
#pragma unroll
  for (int u = 0; u < kRows; ++u) l[u] = 0;
  for (int step = p.top_step; step > 0; step >>= 1) {
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int m = l[u] + step;
      if (m <= nb) {
        const int i = m - 1;
        const u64 bl = tlo[i * ts];
        bool below, tie;
        if (kHi) {
          const u64 bh = thi[i * ts];
          below = bh < hi[u] || (bh == hi[u] && bl < lo[u]);
          tie = bh == hi[u] && bl == lo[u];
        } else {
          below = bl < lo[u];
          tie = bl == lo[u];
        }
        const int64_t row = base + u * kThreads;
        if (tie && deeper && row < p.n)
          below = compare_from(keys, rest, p.nkeys, row,
                               full + (int64_t)i * stride + kTopWords + tf)
              < 0;
        if (below) l[u] = m;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int64_t row = base + u * kThreads;
    if (row < p.n) p.ids[row] = l[u];
  }
}

template <bool kShared>
void launch_ids(const RangeParams& p, int grid, size_t smem,
                cudaStream_t st) {
  switch (p.top_kind_item) {
    case kInt * 16 + 1:
      range_ids_kernel<kShared, kInt, 1><<<grid, kThreads, smem, st>>>(p);
      break;
    case kInt * 16 + 2:
      range_ids_kernel<kShared, kInt, 2><<<grid, kThreads, smem, st>>>(p);
      break;
    case kInt * 16 + 4:
      range_ids_kernel<kShared, kInt, 4><<<grid, kThreads, smem, st>>>(p);
      break;
    case kInt * 16 + 8:
      range_ids_kernel<kShared, kInt, 8><<<grid, kThreads, smem, st>>>(p);
      break;
    case kFloat * 16 + 4:
      range_ids_kernel<kShared, kFloat, 4><<<grid, kThreads, smem, st>>>(p);
      break;
    case kFloat * 16 + 8:
      range_ids_kernel<kShared, kFloat, 8><<<grid, kThreads, smem, st>>>(p);
      break;
    case kBool * 16 + 1:
      range_ids_kernel<kShared, kBool, 1><<<grid, kThreads, smem, st>>>(p);
      break;
    default:
      range_ids_kernel<kShared, -1, 0><<<grid, kThreads, smem, st>>>(p);
      break;
  }
}

// Fill the descriptor part of p from the host table; 0 or a cudaError_t.
inline int fill_keys(RangeParams& p, const void* keys, const void* keys_dev,
                     int nkeys, int nfields) {
  if (keys == nullptr || nkeys < 1) return (int)cudaErrorInvalidValue;
  const SortKey* hk = static_cast<const SortKey*>(keys);
  int total = 0;
  for (int k = 0; k < nkeys; ++k) {
    const SortKey& s = hk[k];
    if (s.kind < kInt || s.kind > kString || s.item < 0)
      return (int)cudaErrorInvalidValue;
    if (s.kind == kString &&
        (s.width % 4 || s.width < (s.item + 3) / 4 * 4))
      return (int)cudaErrorInvalidValue;
    if (s.kind != kString && s.item != 1 && s.item != 2 && s.item != 4 &&
        s.item != 8)
      return (int)cudaErrorInvalidValue;
    total += key_nfields((int)s.kind, (int)s.width);
  }
  if (total != nfields) return (int)cudaErrorInvalidValue;
  p.nkeys = nkeys;
  p.nfields = nfields;
  p.top_fields = hk[0].kind == kString
      ? 0 : key_nfields((int)hk[0].kind, (int)hk[0].width);
  p.top_kind_item = hk[0].kind == kString
      ? -1 : (int)(hk[0].kind * 16 + (hk[0].item & 15));
  p.top = hk[0];
  if (nkeys <= kParamKeys) {
    std::memcpy(p.keys, hk, sizeof(SortKey) * nkeys);
    p.keys_dev = nullptr;
  } else {
    if (keys_dev == nullptr) return (int)cudaErrorInvalidValue;
    p.keys_dev = static_cast<const SortKey*>(keys_dev);
  }
  return 0;
}

}  // namespace srt_rp

extern "C" {

// keys: host array of nkeys SortKey descriptors (sort_key.cuh), 8 int64
// words each; keys_dev: a device copy of it, read instead when nkeys
// exceeds kParamKeys (else ignored).  nfields: the keys' summed field
// counts.

// Row i of out (kTopWords + nfields words) for each of the nb bound rows:
// the top key folded (fold_top), then every field.
int srt_range_bound_fields(const void* keys, const void* keys_dev,
                           int nkeys, int nfields, int64_t nb, void* out,
                           void* stream) {
  using namespace srt_rp;
  RangeParams p;
  std::memset(&p, 0, sizeof(p));
  const int rc = fill_keys(p, keys, keys_dev, nkeys, nfields);
  if (rc != 0) return rc;
  if (nb <= 0) return (int)cudaGetLastError();
  p.n = nb;
  bound_fields_kernel<<<grid_for(nb, 1), kThreads, 0,
                        (cudaStream_t)stream>>>(p, (u64*)out);
  return (int)cudaGetLastError();
}

// ids[i] = the number of the nb sorted bounds (their fields as
// srt_range_bound_fields wrote them, at the same layout) strictly below
// row i of the n rows.
int srt_range_partition(const void* keys, const void* keys_dev, int nkeys,
                        int nfields, const void* bounds, int nb, int64_t n,
                        void* ids, void* stream) {
  using namespace srt_rp;
  RangeParams p;
  std::memset(&p, 0, sizeof(p));
  const int rc = fill_keys(p, keys, keys_dev, nkeys, nfields);
  if (rc != 0) return rc;
  if (nb < 0 || (nb > 0 && bounds == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  p.bounds = (const u64*)bounds;
  p.ids = (int32_t*)ids;
  p.n = n;
  p.nb = nb;
  p.top_step = nb > 0 ? 1 : 0;
  while (nb > 0 && p.top_step <= nb / 2) p.top_step *= 2;
  cudaStream_t st = (cudaStream_t)stream;
  const int grid = (int)((n + (int64_t)kThreads * kRows - 1) /
                         ((int64_t)kThreads * kRows));
  const int64_t key_bytes =
      nkeys <= kSharedKeys ? (int64_t)nkeys * sizeof(SortKey) : 0;
  const int64_t bytes =
      (int64_t)nb * (2 + kTopWords + nfields) * sizeof(u64);
  if (key_bytes + bytes <= kSharedBytes)
    launch_ids<true>(p, grid, (size_t)(key_bytes + bytes), st);
  else
    launch_ids<false>(p, grid, (size_t)key_bytes, st);
  return (int)cudaGetLastError();
}

// The constants the Python wrapper shares with this file, in the order of
// ops/range_partition.py's ``native.share_limits`` call: words a key
// descriptor, most keys in the parameters, leading words of a bound row,
// shared memory a block may stage into.  Writes the first n of them.
int srt_range_partition_limits(int64_t* out, int n) {
  using namespace srt_rp;
  const int64_t v[] = {(int64_t)(sizeof(SortKey) / sizeof(u64)), kParamKeys,
                       kTopWords, kSharedBytes};
  for (int i = 0; i < n && i < (int)(sizeof(v) / sizeof(v[0])); ++i)
    out[i] = v[i];
  return 0;
}

}  // extern "C"
