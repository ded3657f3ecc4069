// K6: dense cross-side key ids of the equi-join rank path.
//
// Replaces spark_rapids_tpu/ops/join.py:62 `_key_ids`: one stable lax.sort
// of both sides' keys (rows with a null key last), `_cols_differ` between
// neighbouring sorted rows, a jnp.cumsum of the flags as the id of every
// sorted row, the ids scattered back to the rows (`.at[order].set`), and
// INT32_MAX / INT32_MAX - 1 for a left / right row with a null key.
//
// The sort is K1 (csrc/sort.cu), called through ops/sort.py `sort_words`,
// which keeps what K1 builds: the permutation and the packed words of the
// key bits that vary, in row order.  Two rows whose keys are both non-null
// have equal words exactly when `_cols_differ` finds their keys equal: a
// bit that is the same in every row decides no equality; a float field is
// a NaN flag and the value with NaN and -0.0 mapped to +0.0 (sort_key.cuh);
// a string field is every byte of the matrix at the packed width, then the
// length, as `_cols_differ` compares whole rows and lengths.  The wrapper
// keeps, of the leading validity key, only its null indicator (rows with a
// null key sort last), and drops every key's own null indicator, which is
// the same in all valid rows.  So the words are all this kernel reads of
// the keys: no gather of the sorted keys, no boundary flags, no memset.
//
// Design: one launch, one tile of kIdsTile sorted rows a block, the tile
// taken from an atomic ticket (as K1's scatter does), so a tile never waits
// on one that has not started.  A thread owns kIdsItems consecutive sorted
// rows: it loads their rows of `order` and their most significant word in
// 16-byte loads (K1's last pass writes that word in sorted order, so it is
// read in order; a lower word is read through the permutation), compares
// each row's words with those of the row before it (flags, in a bit mask),
// and counts its flags.  A row's validity is the validity key's bit, the
// top word's most significant, where it varies; where it does not, the
// plan's host read already says whether every row is valid or none is.  A
// block scan ranks the counts; a decoupled look-back over the earlier
// tiles' published counts gives the tile's prefix (one warp reads 32
// earlier tiles' states at a time, so a tile that waits on many running
// ones waits about one load for every 32).  Each thread then writes
// ids[order[i]] = the flags up to and including sorted row i (row 0 is
// never flagged), or INT32_MAX / INT32_MAX - 1 by the row's validity and
// side.  The ticket and the look-back state lie in K1's scratch, zeroed by
// K1's encode launch.  With no varying bit (every row has the same key) K1
// runs no pass and this kernel writes 0 or the null ids in row order, with
// no look-back.
//
// Bound on the H100: bytes.  Per row: the permutation and the top word
// (read in order), each lower word (4 or 8 bytes, read through the
// permutation, so scattered) and the id (4 bytes, a scattered write).  At
// q6's 56,931 rows that is microseconds: the call's time is K1's host read
// and the launches, which is why the rest went.
#include "common.cuh"

namespace srt_ids {

using namespace srt;
typedef unsigned int u32;

constexpr int32_t kI32Max = 2147483647;
constexpr int kIdsThreads = 256;
constexpr int kIdsItems = 16;
constexpr int kIdsTile = kIdsThreads * kIdsItems;  // sorted rows a tile
// the largest row count (K1's): look-back counts hold 30 bits
constexpr long long kMaxRows = 1073741823;

// Look-back state of a tile: the flag in the top two bits.
constexpr u32 kFlagAgg = 1u << 30;     // the tile's own count
constexpr u32 kFlagPrefix = 2u << 30;  // the count of every tile up to it
constexpr u32 kValueMask = kFlagAgg - 1u;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ u32 load_status(const u32* p) {
  return *reinterpret_cast<const volatile u32*>(p);
}
__device__ __forceinline__ void store_status(u32* p, u32 v) {
  *reinterpret_cast<volatile u32*>(p) = v;
}

__device__ __forceinline__ int32_t null_id(int32_t r, long long cl) {
  return r < cl ? kI32Max : kI32Max - 1;
}

// No varying bit: every row has the same key, so id 0 where it is non-null
// (all_valid), else the null ids, in row order.
__global__ void __launch_bounds__(kIdsThreads)
constant_ids_kernel(int all_valid, long long n, long long cl,
                    int32_t* __restrict__ ids) {
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (long long)gridDim.x * blockDim.x)
    ids[r] = all_valid ? 0 : null_id((int32_t)r, cl);
}

// kIdsItems consecutive values of a sorted array from `first`, 16-byte
// loads where the run is whole (the entry checks the alignment).
template <typename T>
__device__ __forceinline__ void load_run(const T* __restrict__ p,
                                         long long first, long long n,
                                         T (&out)[kIdsItems]) {
  if (first + kIdsItems <= n) {
    const uint4* q = reinterpret_cast<const uint4*>(p + first);
    constexpr int kPer = 16 / (int)sizeof(T);
#pragma unroll
    for (int i = 0; i < kIdsItems / kPer; ++i) {
      union {
        uint4 v;
        T e[kPer];
      } u;
      u.v = q[i];
#pragma unroll
      for (int j = 0; j < kPer; ++j) out[kPer * i + j] = u.e[j];
    }
  } else {
#pragma unroll
    for (int k = 0; k < kIdsItems; ++k)
      out[k] = first + k < n ? p[first + k] : (T)0;
  }
}

// K: uint32 (one word) or unsigned long long (nwords 64-bit words,
// word-major, n each).  top: the most significant word (nwords - 1) in
// sorted order, as K1's last pass wrote it; the lower words are read
// through the permutation.  valid_bit >= 0: the bit of the top word that
// is set where a key is null (the validity key's null indicator, the
// most significant kept bit); else every row is valid (all_valid) or
// none is.  status: the ticket, then one word a tile; zeroed.
template <typename K>
__global__ void __launch_bounds__(kIdsThreads)
key_ids_kernel(const K* __restrict__ top, const K* __restrict__ words,
               int nwords, const int32_t* __restrict__ order, int valid_bit,
               int all_valid, long long n, long long cl,
               u32* __restrict__ status, int32_t* __restrict__ ids) {
  using BlockScan = cub::BlockScan<u32, kIdsThreads>;
  __shared__ typename BlockScan::TempStorage s_scan;
  __shared__ u32 s_tile, s_prefix;
  const int t = threadIdx.x;
  if (t == 0) s_tile = atomicAdd(status, 1u);
  __syncthreads();
  const u32 tile = s_tile;
  u32* tiles = status + 1;
  const long long first =
      (long long)tile * kIdsTile + (long long)t * kIdsItems;
  int32_t row[kIdsItems];
  K cur[kIdsItems];
  load_run(order, first, n, row);
  load_run(top, first, n, cur);
  // bit k: sorted row first + k differs from the row before it; vbits:
  // its keys are all non-null
  unsigned differ = 0u, vbits = 0u;
  if (first < n) {
    K prev = first > 0 ? top[first - 1] : cur[0];
#pragma unroll
    for (int k = 0; k < kIdsItems; ++k) {
      if (cur[k] != prev) differ |= 1u << k;
      prev = cur[k];
      const bool v = valid_bit >= 0 ? ((cur[k] >> valid_bit) & 1) == 0
                                    : all_valid != 0;
      vbits |= (unsigned)v << k;
    }
    const int32_t before = first > 0 ? order[first - 1] : 0;
    for (int w = 0; w + 1 < nwords; ++w) {  // the lower words
      const K* wd = words + (long long)w * n;
      K low[kIdsItems];
#pragma unroll
      for (int k = 0; k < kIdsItems; ++k)
        low[k] = first + k < n ? wd[row[k]] : (K)0;
      K lprev = first > 0 ? wd[before] : low[0];
#pragma unroll
      for (int k = 0; k < kIdsItems; ++k) {
        if (low[k] != lprev) differ |= 1u << k;
        lprev = low[k];
      }
    }
    const long long rest = n - first;
    if (rest < kIdsItems) differ &= (1u << rest) - 1u;
  }
  u32 excl, agg;
  BlockScan(s_scan).ExclusiveSum((u32)__popc(differ), excl, agg);
  if (t < 32) {  // warp 0: the tile's prefix, 32 earlier tiles a step
    u32 before = 0u;
    if (tile == 0) {
      if (t == 0) store_status(tiles, kFlagPrefix | agg);
    } else {
      if (t == 0) store_status(tiles + tile, kFlagAgg | agg);
      for (long long j = (long long)tile - 1;; j -= 32) {
        const long long q = j - t;  // lane 0 the nearest
        u32 s = q >= 0 ? load_status(tiles + q) : kFlagPrefix;
        while (__any_sync(kFull, (s & ~kValueMask) == 0u))
          if ((s & ~kValueMask) == 0u) s = load_status(tiles + q);
        const unsigned pre = __ballot_sync(kFull, (s & kFlagPrefix) != 0u);
        // the counts up to and including the nearest published prefix
        const int stop = pre ? __ffs(pre) - 1 : 31;
        u32 v = t <= stop ? (s & kValueMask) : 0u;
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
        before += v;
        if (pre) break;
      }
      if (t == 0) store_status(tiles + tile, kFlagPrefix | (before + agg));
    }
    if (t == 0) s_prefix = before;
  }
  __syncthreads();
  u32 run = s_prefix + excl;
#pragma unroll
  for (int k = 0; k < kIdsItems; ++k) {
    if (first + k < n) {
      run += (differ >> k) & 1u;
      const int32_t r = row[k];
      ids[r] = (vbits >> k) & 1u ? (int32_t)run : null_id(r, cl);
    }
  }
}

}  // namespace srt_ids

using namespace srt_ids;

extern "C" {

// words: K1's packed words in row order (key_bytes 4: one uint32 word;
// 8: nwords uint64 words, word-major, n each); top: the most significant
// one in sorted order (K1's last pass, sort.cu keys_last); order: K1's
// permutation; top and order 16-byte aligned; rows [0, cl) are the left
// side.  valid_bit: the bit of the top word set where a row has a null
// key, or -1 where that does not vary: then every row is valid
// (all_valid 1) or none is.  nwords 0 (no varying bit: every row has the
// same key) writes 0 or the null ids and reads no word.  status: 1 +
// ceil(n / kIdsTile) uint32, zero on entry (K1's encode zeroes them).
// ids[row] = the dense rank of the row's key, or INT32_MAX (left) /
// INT32_MAX - 1 (right) for a row with a null key.
int srt_join_key_ids(const void* top, const void* words, int key_bytes,
                     int nwords, const void* order, int valid_bit,
                     int all_valid, int64_t n, int64_t cl, void* status,
                     void* ids, void* stream) {
  if (n < 1 || n > kMaxRows || cl < 0 || cl > n || nwords < 0 ||
      ids == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* out = (int32_t*)ids;
  if (nwords == 0) {
    constant_ids_kernel<<<grid_for(n), kIdsThreads, 0, st>>>(all_valid, n,
                                                             cl, out);
    return (int)cudaGetLastError();
  }
  if (words == nullptr || top == nullptr || status == nullptr ||
      order == nullptr || ((uintptr_t)order & 15) != 0 ||
      ((uintptr_t)top & 15) != 0 || (key_bytes != 4 && key_bytes != 8) ||
      (key_bytes == 4 && nwords != 1) || valid_bit >= 8 * key_bytes)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((n + kIdsTile - 1) / kIdsTile);
  const int32_t* ord = (const int32_t*)order;
  u32* stat = (u32*)status;
  if (key_bytes == 4)
    key_ids_kernel<u32><<<grid, kIdsThreads, 0, st>>>(
        (const u32*)top, (const u32*)words, 1, ord, valid_bit, all_valid, n,
        cl, stat, out);
  else
    key_ids_kernel<unsigned long long><<<grid, kIdsThreads, 0, st>>>(
        (const unsigned long long*)top, (const unsigned long long*)words,
        nwords, ord, valid_bit, all_valid, n, cl, stat, out);
  return (int)cudaGetLastError();
}

// The constants the Python wrapper shares with this file, in the order of
// ops/join.py's ``native.share_limits`` call: sorted rows a tile.  Writes
// the first n of them.
int srt_join_ids_limits(int64_t* out, int n) {
  const int64_t v[] = {kIdsTile};
  for (int i = 0; i < n && i < (int)(sizeof(v) / sizeof(v[0])); ++i)
    out[i] = v[i];
  return 0;
}

}  // extern "C"
