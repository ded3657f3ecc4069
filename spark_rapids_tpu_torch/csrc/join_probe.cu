// K5: the prepared-build probe of the equi-join fast path (and the search
// of K6's rank path).
//
// Replaces spark_rapids_tpu/ops/join.py:127 `build_prepare_fast` (the
// rewrite of the sorted build keys: slots at or past nv become the dtype
// max) and :152 `probe_fast` (two jnp.searchsorted passes, the clip to nv,
// the per-join-type counts of `_out_cnt` :170 and a jnp.sum for the total).
//
// Design:
//   * build_keys_kernel runs once per query, after K1 has sorted the build
//     rows as [null flag, key]: one thread per sorted slot writes the key
//     (or the dtype max for a null row) and the thread at the last valid
//     slot writes nv, so nv never leaves the device.
//   * search_kernel, one thread per stream row: a lower-bound search over
//     the sorted build keys, then, where the key is present, a galloping
//     upper-bound search from start (one more load for a unique key);
//     end is clipped to nv and start to end, a null stream key counts 0,
//     and the join type picks out_cnt (inner: cnt; left/full: max(cnt, 1);
//     semi: cnt > 0; anti: cnt == 0).  Each block sums its out_cnt and adds
//     it to one int64 total with an integer atomic (exact, order-free), so
//     the host reads one number per stream batch.
//   * Over K6's rank ids the same kernel runs with no validity and no nv:
//     a left id of INT32_MAX (a null key) lies above every right id and
//     finds an empty range.
//
// Bound on the H100: bytes.  Each stream row reads its key and validity and
// writes three int32s; the sorted build keys (at most a few MB on q6) stay
// in L2, so the ~log2(nb) dependent loads per row are latency, hidden by
// the number of rows in flight.
#include "common.cuh"

namespace srt_probe {

using namespace srt;

template <typename T>
__device__ __forceinline__ T max_value();
template <> __device__ __forceinline__ int8_t max_value<int8_t>() { return 127; }
template <> __device__ __forceinline__ int16_t max_value<int16_t>() { return 32767; }
template <> __device__ __forceinline__ int32_t max_value<int32_t>() { return 2147483647; }
template <> __device__ __forceinline__ long long max_value<long long>() {
  return 9223372036854775807LL;
}

template <typename T>
__global__ void build_keys_kernel(const T* __restrict__ key,
                                  const uint8_t* __restrict__ valid,
                                  const int32_t* __restrict__ perm, int64_t n,
                                  T* __restrict__ skey,
                                  int32_t* __restrict__ nv) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int32_t r = perm[i];
    const bool v = valid[r] != 0;
    skey[i] = v ? key[r] : max_value<T>();
    if (v && (i + 1 == n || valid[perm[i + 1]] == 0)) *nv = (int32_t)(i + 1);
  }
}

// First position in a[lo, hi) whose value is >= x (kUpper: > x).
template <typename T, bool kUpper>
__device__ __forceinline__ int64_t bound(const T* __restrict__ a, int64_t lo,
                                         int64_t hi, T x) {
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    const T v = a[mid];
    if (kUpper ? (v <= x) : (v < x))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// First position in a[lo, nb) whose value is > x, given a[lo - 1] == x:
// probe lo, lo + 1, lo + 3, lo + 7, ... until a value above x, then search
// the last stride.  A unique key (a foreign-key join) costs one load.
template <typename T>
__device__ __forceinline__ int64_t gallop_upper(const T* __restrict__ a,
                                                int64_t lo, int64_t nb, T x) {
  int64_t step = 1;
  while (true) {
    const int64_t probe = lo + step - 1;
    if (probe >= nb) return bound<T, true>(a, lo, nb, x);
    if (a[probe] > x) return bound<T, true>(a, lo, probe, x);
    lo = probe + 1;
    step <<= 1;
  }
}

template <typename T>
__global__ void search_kernel(const T* __restrict__ lkey,
                              const uint8_t* __restrict__ lvalid, int64_t n,
                              const T* __restrict__ skey, int64_t nb,
                              const int32_t* __restrict__ nv_ptr, int jt,
                              int32_t* __restrict__ start,
                              int32_t* __restrict__ cnt,
                              int32_t* __restrict__ out_cnt,
                              unsigned long long* __restrict__ total) {
  using BlockReduce = cub::BlockReduce<long long, kThreads>;
  __shared__ typename BlockReduce::TempStorage tmp;
  const int64_t nv = nv_ptr != nullptr ? (int64_t)*nv_ptr : nb;
  long long local = 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const T x = lkey[i];
    int64_t s = bound<T, false>(skey, 0, nb, x);
    int64_t e = s;
    if (s < nb && !(x < skey[s])) e = gallop_upper(skey, s + 1, nb, x);
    e = e < nv ? e : nv;
    s = s < e ? s : e;
    const bool v = lvalid == nullptr || lvalid[i] != 0;
    const int32_t c = v ? (int32_t)(e - s) : 0;
    int32_t o;
    switch (jt) {
      case 0: o = c; break;                 // inner
      case 1: o = c > 1 ? c : 1; break;     // left, full
      case 2: o = c > 0 ? 1 : 0; break;     // semi
      default: o = c == 0 ? 1 : 0; break;   // anti
    }
    if (start != nullptr) start[i] = (int32_t)s;
    if (cnt != nullptr) cnt[i] = c;
    out_cnt[i] = o;
    local += o;
  }
  const long long sum = BlockReduce(tmp).Sum(local);
  if (threadIdx.x == 0 && sum != 0)
    atomicAdd(total, (unsigned long long)sum);
}

inline int grid_for(int64_t work) {
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 32;
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

template <typename T>
void launch_search(const void* lkey, const void* lvalid, int64_t n,
                   const void* skey, int64_t nb, const void* nv, int jt,
                   void* start, void* cnt, void* out_cnt, void* total,
                   cudaStream_t st) {
  search_kernel<T><<<grid_for(n), kThreads, 0, st>>>(
      (const T*)lkey, (const uint8_t*)lvalid, n, (const T*)skey, nb,
      (const int32_t*)nv, jt, (int32_t*)start, (int32_t*)cnt,
      (int32_t*)out_cnt, (unsigned long long*)total);
}

template <typename T>
void launch_build(const void* key, const void* valid, const void* perm,
                  int64_t n, void* skey, void* nv, cudaStream_t st) {
  build_keys_kernel<T><<<grid_for(n), kThreads, 0, st>>>(
      (const T*)key, (const uint8_t*)valid, (const int32_t*)perm, n,
      (T*)skey, (int32_t*)nv);
}

}  // namespace srt_probe

using namespace srt_probe;

extern "C" {

// skey[i] = key[perm[i]] for the valid rows (sorted first by K1), the dtype
// max for the rest; nv (zeroed by the caller) = number of valid rows.
int srt_join_build_keys(const void* key, const void* valid, const void* perm,
                        int64_t n, int item, void* skey, void* nv,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  switch (item) {
    case 1: launch_build<int8_t>(key, valid, perm, n, skey, nv, st); break;
    case 2: launch_build<int16_t>(key, valid, perm, n, skey, nv, st); break;
    case 4: launch_build<int32_t>(key, valid, perm, n, skey, nv, st); break;
    case 8: launch_build<long long>(key, valid, perm, n, skey, nv, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Per stream row: start/cnt (either may be NULL) and out_cnt by join type
// (0 inner, 1 left/full, 2 semi, 3 anti); the sum of out_cnt is added to
// *total (int64).  lvalid NULL: every row valid; nv NULL: nv = nb.
int srt_join_search(const void* lkey, const void* lvalid, int64_t n,
                    const void* skey, int64_t nb, const void* nv, int item,
                    int jt, void* start, void* cnt, void* out_cnt,
                    void* total, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  switch (item) {
    case 1: launch_search<int8_t>(lkey, lvalid, n, skey, nb, nv, jt, start, cnt, out_cnt, total, st); break;
    case 2: launch_search<int16_t>(lkey, lvalid, n, skey, nb, nv, jt, start, cnt, out_cnt, total, st); break;
    case 4: launch_search<int32_t>(lkey, lvalid, n, skey, nb, nv, jt, start, cnt, out_cnt, total, st); break;
    case 8: launch_search<long long>(lkey, lvalid, n, skey, nb, nv, jt, start, cnt, out_cnt, total, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
