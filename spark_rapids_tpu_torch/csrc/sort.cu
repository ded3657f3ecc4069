// K1: stable multi-key sort permutation, as an LSD radix sort over only the
// key bits that vary.
//
// Replaces spark_rapids_tpu/ops/sort.py:105 `sort_permutation` (with
// `encode_key_operands` :83 and `string_key_words` :72), which XLA runs as
// one stable multi-operand lax.sort over, per key column, a null indicator
// and the encoded key words.
//
// Every key column maps to a fixed sequence of order-preserving bit fields
// (sort_key.cuh key_field, shared with K11); their concatenation, most
// significant key first, orders rows exactly as lax.sort orders the
// reference's operands.  A bit that holds the same value in every row
// cannot decide the order of two rows, so only the bits that vary are
// sorted.  The wrapper (ops/sort.py) drives four kernels:
//
//   * plan_kernel reads every key column's fields in place (the
//     descriptors travel by value in the kernel's parameters) and reduces,
//     per block, the OR and the AND of each field over its rows.  It
//     writes no limbs.  The wrapper reads the per-block results once (the
//     call's one host read), folds them and keeps the bits where OR != AND
//     (ops/sort.py `sort_plan`).  If no bit varies, the result is the
//     identity and no pass runs.
//   * encode_kernel packs only those bits, most significant key first,
//     into as few words as they need: one 32-bit word for up to 32 bits,
//     else 64-bit words, word 0 least significant.  A list of segments (a
//     run of varying bits of one field -> a bit position of one word) says
//     where each bit goes; every word is built in registers and written
//     once: no memset, no read-modify-write.  Kept whole, the same segments
//     give K1's full packed limbs (`pack_keys`, K11's yardstick).
//   * per word, an onesweep LSD radix sort (Adinets & Merrill, "Onesweep: A
//     Faster Least Significant Digit Radix Sort for GPUs", 2022):
//     upsweep_kernel histograms every 8-bit digit of the word in one read,
//     one tile a block (and zeroes the look-back state of the word's passes);
//     scan_kernel, one block, turns the histograms into each digit's global
//     offsets; one scatter_kernel per digit (the last digit of a word only as
//     wide as its bits).  A scatter block takes its tile from an atomic
//     ticket, so every tile before it has started and the look-back cannot
//     deadlock.  It loads kSortTile (key, row) pairs, ranks them stably in
//     shared memory (each warp owns consecutive rows; equal digits are found
//     with __match_any_sync and counted in warp order, then lane order),
//     publishes its digit counts, looks back over the earlier tiles'
//     published counts for its digit prefixes (decoupled look-back, one
//     thread a digit value), sorts the pairs by digit in shared memory and
//     writes them as digit-sorted runs, so that the global stores coalesce.
//     The first pass of a later word reads its keys through the permutation
//     so far (no separate gather); the first pass of the first word takes the
//     row index as its value (no iota).  Every digit of the compacted words
//     holds a varying bit, so no pass is skipped.
//
// Bound on the H100: bytes.  The key columns are read twice (plan and
// encode), each word once by its upsweep, and each pass reads and writes a
// key (4 or 8 bytes) and a row index (4 bytes) a row; q1's two one-letter
// keys vary in 7 bits, so one word and one pass.
#include <cstring>

#include "common.cuh"
#include "sort_key.cuh"

namespace srt_sort {

using namespace srt;
typedef unsigned long long u64;
typedef unsigned int u32;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRadix = 256;
// threads of a plan, upsweep or scatter block: one per digit value
constexpr int kSortThreads = kRadix;
constexpr int kSortItems = 16;
// rows a tile
constexpr int kSortTile = 4096;
static_assert(kSortTile == kSortThreads * kSortItems, "tile shape");
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kWarpRows = 32 * kSortItems;
// digit passes of a 64-bit word
constexpr int kMaxPasses = 8;
// key descriptors held in the kernels' parameters; more are read from a
// device copy the wrapper makes
constexpr int kParamKeys = 32;
// segments held in the encode kernel's small and large parameters; more
// are read from a device copy
constexpr int kSmallSegs = 64;
constexpr int kLargeSegs = 2048;
// fields a plan block reduces in one sweep of its rows (each thread keeps
// an OR and an AND of each in shared memory: 32 KB)
constexpr int kPlanFields = 8;
// blocks of a plan launch (at most): eight a multiprocessor, so that
// enough loads are in flight
constexpr int kPlanBlocks = 1056;
// rows an encode thread packs at once, their loads in flight together
constexpr int kEncodeRows = 4;
// the largest row count (2^30 - 1): look-back counts hold 30 bits
constexpr long long kMaxRows = 1073741823;

// Look-back state of a (tile, digit): the flag in the top two bits.
constexpr u32 kFlagAgg = 1u << 30;     // the tile's own count
constexpr u32 kFlagPrefix = 2u << 30;  // the count of every tile up to it
constexpr u32 kValueMask = kFlagAgg - 1u;

struct PlanParams {
  const SortKey* keys_dev;  // non-null: read the descriptors here
  u64* partials;            // OR, AND of every field (rows) by block
  long long n;
  int nkeys, nfields;
  SortKey keys[kParamKeys];
};

// A segment word (ops/sort.py `segment_words`): bits 0-5 the run's lowest
// bit in its field, 6-11 its length - 1, 12-17 its lowest bit in the word,
// 18-33 the field (0 = the null indicator) of key 34-49 (0 = the most
// significant key); bit 50 set on the last segment of a word.
template <int kSegs>
struct EncodeParams {
  const SortKey* keys_dev;  // non-null: read the descriptors here
  const u64* segs_dev;      // non-null: read the segments here
  void* out;                // the words, word-major, n rows each
  u32* zero;                // words to zero (the sort's histograms)
  long long n, nzero;
  int nkeys, nsegs;
  SortKey keys[kParamKeys];
  u64 segs[kSegs];
};

__device__ __forceinline__ u64 warp_or(u64 v) {
  for (int o = 16; o > 0; o >>= 1) v |= __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ u64 warp_and(u64 v) {
  for (int o = 16; o > 0; o >>= 1) v &= __shfl_xor_sync(kFull, v, o);
  return v;
}

// key_field of field f with the key's kind, item size and field position
// fixed at compile time (kItem 0: the item stays the descriptor's, a
// string matrix's width; kF -1: f stays runtime, a string's word, kStr
// saying whether it is a word or the length) and a string's word path
// chosen once (sort_key.cuh WordPath, StringField),
// so that a loop over rows runs only the field's own arithmetic and keeps
// its loads in flight together.
template <int kKind, int kItem, int kF, int kWords, int kStr>
__device__ __forceinline__ u64 field_at(const SortKey& k, long long row,
                                        int f) {
  SortKey c = k;
  c.kind = kKind;
  if (kItem != 0) c.item = kItem;
  int bits;
  return key_field<kWords, kStr>(c, row, kF >= 0 ? kF : f, &bits);
}

// op.run<kKind, kItem, kF, kWords, kStr>(k, f) specialised for field f of
// key k, chosen once for a loop over rows.
template <class Op>
__device__ __forceinline__ void with_field(const SortKey& k, int f, Op& op) {
  if (f == 0) {  // the null indicator reads the validity alone
    op.template run<kInt, 4, 0, kWordsAny, kStrAny>(k, f);
    return;
  }
  switch ((int)k.kind) {
    case kInt:
      switch ((int)k.item) {
        case 1: op.template run<kInt, 1, 1, kWordsAny, kStrAny>(k, f); return;
        case 2: op.template run<kInt, 2, 1, kWordsAny, kStrAny>(k, f); return;
        case 4: op.template run<kInt, 4, 1, kWordsAny, kStrAny>(k, f); return;
        default: op.template run<kInt, 8, 1, kWordsAny, kStrAny>(k, f); return;
      }
    case kBool: op.template run<kBool, 1, 1, kWordsAny, kStrAny>(k, f); return;
    case kFloat:
      if (k.item == 4) {
        if (f == 1) op.template run<kFloat, 4, 1, kWordsAny, kStrAny>(k, f);
        else op.template run<kFloat, 4, 2, kWordsAny, kStrAny>(k, f);
      } else {
        if (f == 1) op.template run<kFloat, 8, 1, kWordsAny, kStrAny>(k, f);
        else op.template run<kFloat, 8, 2, kWordsAny, kStrAny>(k, f);
      }
      return;
    default:
      if (f > (int)k.width / 4)
        op.template run<kString, 0, -1, kWordsAny, kStrLength>(k, f);
      else if (words_aligned(reinterpret_cast<const void*>(k.data),
                             (int)k.item))
        op.template run<kString, 0, -1, kWordsAligned, kStrWord>(k, f);
      else
        op.template run<kString, 0, -1, kWordsBytes, kStrWord>(k, f);
      return;
  }
}

// The OR and the AND of one field over a thread's kSortItems rows of a
// tile (base: its first row).
struct OrAndRows {
  long long base, n;
  u64 o, a;
  template <int kKind, int kItem, int kF, int kWords, int kStr>
  __device__ __forceinline__ void run(const SortKey& k, int f) {
#pragma unroll
    for (int it = 0; it < kSortItems; ++it) {
      const long long row = base + (long long)it * kSortThreads;
      if (row < n) {
        const u64 v = field_at<kKind, kItem, kF, kWords, kStr>(k, row, f);
        o |= v;
        a &= v;
      }
    }
  }
};

// One field of a thread's kEncodeRows rows (row0, a stride apart).
struct FieldRows {
  long long row0, stride, n;
  u64 v[kEncodeRows];
  template <int kKind, int kItem, int kF, int kWords, int kStr>
  __device__ __forceinline__ void run(const SortKey& k, int f) {
#pragma unroll
    for (int r = 0; r < kEncodeRows; ++r) {
      const long long row = row0 + (long long)r * stride;
      if (row < n) v[r] = field_at<kKind, kItem, kF, kWords, kStr>(k, row, f);
    }
  }
};

// Each block reduces the OR and the AND of every field over the rows of
// its tiles (grid-stride) and writes them to its column of the partials:
// row 2g the OR of field g, row 2g + 1 its AND (fields in key order), one
// column a block, so that the host folds contiguous rows.  A block
// without rows writes 0 and ~0.  The fields go kPlanFields at a time: a
// thread keeps its own OR and AND of each in shared memory over all the
// block's tiles (a tile's fields read together, so a string's words share
// their cache lines), and the block folds them once at the end.
__global__ void __launch_bounds__(kSortThreads)
plan_kernel(const __grid_constant__ PlanParams p) {
  __shared__ u64 s_or[kPlanFields][kSortThreads];
  __shared__ u64 s_and[kPlanFields][kSortThreads];
  const SortKey* keys = p.keys_dev != nullptr ? p.keys_dev : p.keys;
  const long long ntiles = (p.n + kSortTile - 1) / kSortTile;
  const int t = threadIdx.x;
  u64* part = p.partials + blockIdx.x;
  const long long col = gridDim.x;
  for (int g0 = 0; g0 < p.nfields; g0 += kPlanFields) {
    const int gn = min(kPlanFields, p.nfields - g0);
    for (int i = 0; i < gn; ++i) {
      s_or[i][t] = 0ull;
      s_and[i][t] = ~0ull;
    }
    for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const long long base = tile * kSortTile + t;
      int g = 0;
      for (int k = 0; k < p.nkeys && g < g0 + gn; ++k) {
        const SortKey key = keys[k];  // in registers, not re-read a row
        const int nf = key_nfields((int)key.kind, (int)key.width);
        for (int f = 0; f < nf; ++f, ++g) {
          if (g < g0 || g >= g0 + gn) continue;
          OrAndRows op{base, p.n, s_or[g - g0][t], s_and[g - g0][t]};
          with_field(key, f, op);
          s_or[g - g0][t] = op.o;
          s_and[g - g0][t] = op.a;
        }
      }
    }
    __syncthreads();
    // warp w folds fields w, w + kSortWarps, ...
    const int lane = t & 31;
    for (int i = t >> 5; i < gn; i += kSortWarps) {
      u64 o = 0ull, a = ~0ull;
      for (int j = lane; j < kSortThreads; j += 32) {
        o |= s_or[i][j];
        a &= s_and[i][j];
      }
      o = warp_or(o);
      a = warp_and(a);
      if (lane == 0) {
        part[(2ll * (g0 + i)) * col] = o;
        part[(2ll * (g0 + i) + 1) * col] = a;
      }
    }
    __syncthreads();
  }
}

// A thread packs kEncodeRows rows (a block's stride apart) at a time: each
// word gathered from its segments in registers and written once.  K: u32
// (one word) or u64.
template <typename K, int kSegs>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const __grid_constant__ EncodeParams<kSegs> p) {
  const SortKey* keys = p.keys_dev != nullptr ? p.keys_dev : p.keys;
  const u64* segs = p.segs_dev != nullptr ? p.segs_dev : p.segs;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = first; i < p.nzero;
       i += (long long)gridDim.x * blockDim.x)
    p.zero[i] = 0u;
  K* out = static_cast<K*>(p.out);
  const long long span = (long long)kEncodeRows * blockDim.x;
  for (long long row0 = (long long)blockIdx.x * span + threadIdx.x;
       row0 < p.n; row0 += (long long)gridDim.x * span) {
    K acc[kEncodeRows] = {};
    FieldRows fr{row0, blockDim.x, p.n, {}};
    long long word = 0;
    int last = -1;
    for (int s = 0; s < p.nsegs; ++s) {
      const u64 sg = segs[s];
      const int kf = (int)((sg >> 18) & 0xffffffffull);  // key << 16 | field
      if (kf != last) {
        const SortKey key = keys[kf >> 16];
        with_field(key, kf & 0xffff, fr);
        last = kf;
      }
      const int shift = (int)(sg & 63);
      const int len = (int)((sg >> 6) & 63) + 1;
      const int dst = (int)((sg >> 12) & 63);
#pragma unroll
      for (int r = 0; r < kEncodeRows; ++r)
        acc[r] |= (K)(low_bits(fr.v[r] >> shift, len) << dst);
      if ((sg >> 50) & 1) {
#pragma unroll
        for (int r = 0; r < kEncodeRows; ++r) {
          const long long row = row0 + (long long)r * blockDim.x;
          if (row < p.n) out[word * p.n + row] = acc[r];
          acc[r] = 0;
        }
        ++word;
      }
    }
  }
}

// The lanes of `amask` whose digit equals this lane's (every lane of the
// warp takes part).
__device__ __forceinline__ unsigned match_digit(unsigned d, unsigned amask) {
  return __match_any_sync(kFull, d) & amask;
}

// hist[p][d] += rows whose digit p (bits 8p.., the last one nbits - 8p
// wide) is d; status[0, nstatus) = 0 (the look-back state of the word's
// passes, before any of its scatters runs).  One tile a block, its keys
// loaded before any is ranked.
template <typename K>
__global__ void __launch_bounds__(kSortThreads)
upsweep_kernel(const K* __restrict__ keys, long long n, int nbits,
               u32* __restrict__ hist, u32* __restrict__ status,
               long long nstatus) {
  __shared__ u32 s_hist[kMaxPasses * kRadix];
  const int npasses = (nbits + 7) / 8;
  for (int i = threadIdx.x; i < npasses * kRadix; i += blockDim.x)
    s_hist[i] = 0u;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nstatus; i += stride)
    status[i] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long base = (long long)blockIdx.x * kSortTile + threadIdx.x;
  K key[kSortItems];
#pragma unroll
  for (int it = 0; it < kSortItems; ++it) {
    const long long i = base + (long long)it * kSortThreads;
    key[it] = i < n ? keys[i] : (K)0;
  }
#pragma unroll
  for (int it = 0; it < kSortItems; ++it) {
    const bool act = base + (long long)it * kSortThreads < n;
    const unsigned amask = __ballot_sync(kFull, act);
    for (int p = 0; p < npasses; ++p) {
      const int bits = min(8, nbits - 8 * p);
      const unsigned d =
          (unsigned)(key[it] >> (8 * p)) & ((1u << bits) - 1u);
      const unsigned peers = match_digit(d, amask);
      if (act && lane == __ffs(peers) - 1)
        atomicAdd(&s_hist[p * kRadix + d], (u32)__popc(peers));
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < npasses * kRadix; i += blockDim.x) {
    const u32 c = s_hist[i];
    if (c) atomicAdd(&hist[i], c);
  }
}

// One block: base[p][d] = rows whose digit p is below d; tickets zeroed.
__global__ void __launch_bounds__(kRadix)
scan_kernel(const u32* __restrict__ hist, int npasses, u32* __restrict__ base,
            u32* __restrict__ tickets) {
  using BlockScan = cub::BlockScan<u32, kRadix>;
  __shared__ typename BlockScan::TempStorage tmp;
  if (threadIdx.x < kMaxPasses) tickets[threadIdx.x] = 0u;
  for (int p = 0; p < npasses; ++p) {
    u32 excl;
    BlockScan(tmp).ExclusiveSum(hist[p * kRadix + threadIdx.x], excl);
    base[p * kRadix + threadIdx.x] = excl;
    __syncthreads();
  }
}

template <typename K>
struct ScatterArgs {
  const K* keys_in;        // gather ? the word in row order : the keys
  const int32_t* vals_in;  // null: the row index
  K* keys_out;             // null: the pass's keys are not needed again
  int32_t* vals_out;
  const u32* base;         // the digit's global offsets
  u32* status;             // ntiles * kRadix look-back words, zeroed
  u32* ticket;             // zeroed
  long long n;
  int shift, bits, gather;
};

__device__ __forceinline__ u32 load_status(const u32* p) {
  return *reinterpret_cast<const volatile u32*>(p);
}
__device__ __forceinline__ void store_status(u32* p, u32 v) {
  *reinterpret_cast<volatile u32*>(p) = v;
}

// One stable counting pass over one digit (see the file's head).  Held to
// 85 registers with 32-bit keys (three blocks a multiprocessor), 128 with
// 64-bit keys (two).
template <typename K>
__global__ void __launch_bounds__(kSortThreads, sizeof(K) == 4 ? 3 : 2)
scatter_kernel(const ScatterArgs<K> a) {
  using BlockScan = cub::BlockScan<u32, kSortThreads>;
  __shared__ u32 s_count[kSortWarps][kRadix];
  __shared__ int s_off[kRadix];
  __shared__ u32 s_tile;
  __shared__ typename BlockScan::TempStorage s_scan;
  __shared__ K s_keys[kSortTile];  // the pairs' exchange; values reuse it
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) s_tile = atomicAdd(a.ticket, 1u);
  for (int i = t; i < kSortWarps * kRadix; i += kSortThreads)
    (&s_count[0][0])[i] = 0u;
  __syncthreads();
  const u32 tile = s_tile;
  const long long tbase = (long long)tile * kSortTile;
  const long long rest = a.n - tbase;
  const int tile_n = (int)(rest < kSortTile ? rest : kSortTile);
  const unsigned dmask = (1u << a.bits) - 1u;
  const unsigned lt = (1u << lane) - 1u;
  const long long wbase = tbase + (long long)warp * kWarpRows + lane;
  K key[kSortItems];
  int32_t val[kSortItems];
  u32 rank[kSortItems];
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    const long long i = wbase + 32 * k;
    key[k] = 0;
    val[k] = 0;
    if (i < a.n) {
      val[k] = a.vals_in != nullptr ? a.vals_in[i] : (int32_t)i;
      key[k] = a.keys_in[a.gather ? (long long)val[k] : i];
    }
  }
  // warp-local stable ranks: items in (k, lane) order are in row order
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    const bool act = wbase + 32 * k < a.n;
    const unsigned amask = __ballot_sync(kFull, act);
    const unsigned d = (unsigned)(key[k] >> a.shift) & dmask;
    const unsigned peers = match_digit(d, amask);
    u32 c = 0;
    if (act) c = s_count[warp][d];
    __syncwarp();
    if (act) {
      rank[k] = c + __popc(peers & lt);
      if (lane == __ffs(peers) - 1) s_count[warp][d] = c + __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();
  // thread t owns digit value t: its warps' prefix and the tile's count
  u32 cnt = 0;
  for (int w = 0; w < kSortWarps; ++w) {
    const u32 c = s_count[w][t];
    s_count[w][t] = cnt;
    cnt += c;
  }
  u32* mine = a.status + (long long)tile * kRadix + t;
  store_status(mine, (tile == 0 ? kFlagPrefix : kFlagAgg) | cnt);
  u32 start;
  BlockScan(s_scan).ExclusiveSum(cnt, start);
  u32 excl = 0;
  if (tile > 0) {
    for (long long j = (long long)tile - 1;; --j) {
      u32 s;
      do {
        s = load_status(a.status + j * kRadix + t);
      } while ((s & ~kValueMask) == 0u);
      excl += s & kValueMask;
      if (s & kFlagPrefix) break;
    }
    store_status(mine, kFlagPrefix | (excl + cnt));
  }
  s_off[t] = (int)(a.base[t] + excl) - (int)start;
  for (int w = 0; w < kSortWarps; ++w) s_count[w][t] += start;
  __syncthreads();
  // the tile's pairs sorted by digit in shared memory
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    if (wbase + 32 * k < a.n) {
      const unsigned d = (unsigned)(key[k] >> a.shift) & dmask;
      rank[k] += s_count[warp][d];
      s_keys[rank[k]] = key[k];
    }
  }
  __syncthreads();
  int dst[kSortItems];
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    const int j = k * kSortThreads + t;
    if (j < tile_n) {
      const K kk = s_keys[j];
      dst[k] = s_off[(unsigned)(kk >> a.shift) & dmask] + j;
      if (a.keys_out != nullptr) a.keys_out[dst[k]] = kk;
    }
  }
  __syncthreads();
  int32_t* s_vals = reinterpret_cast<int32_t*>(s_keys);
#pragma unroll
  for (int k = 0; k < kSortItems; ++k)
    if (wbase + 32 * k < a.n) s_vals[rank[k]] = val[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kSortItems; ++k) {
    const int j = k * kSortThreads + t;
    if (j < tile_n) a.vals_out[dst[k]] = s_vals[j];
  }
}

inline int fill_keys(const void* keys, const void* keys_dev, int nkeys,
                     SortKey* dst, const SortKey** dev) {
  if (nkeys < 1) return (int)cudaErrorInvalidValue;
  if (nkeys <= kParamKeys) {
    std::memcpy(dst, keys, sizeof(SortKey) * nkeys);
    *dev = nullptr;
  } else {
    if (keys_dev == nullptr) return (int)cudaErrorInvalidValue;
    *dev = static_cast<const SortKey*>(keys_dev);
  }
  return 0;
}

template <typename K, int kSegs>
int launch_encode(const void* keys, const void* keys_dev, int nkeys,
                  const void* segs, const void* segs_dev, int nsegs,
                  int64_t n, void* out, void* zero, int64_t nzero,
                  cudaStream_t st) {
  EncodeParams<kSegs> p;
  std::memset(&p, 0, sizeof(p));
  const int rc = fill_keys(keys, keys_dev, nkeys, p.keys, &p.keys_dev);
  if (rc != 0) return rc;
  if (segs_dev != nullptr)
    p.segs_dev = static_cast<const u64*>(segs_dev);
  else
    std::memcpy(p.segs, segs, sizeof(u64) * nsegs);
  p.out = out;
  p.zero = static_cast<u32*>(zero);
  p.n = n;
  p.nzero = nzero;
  p.nkeys = nkeys;
  p.nsegs = nsegs;
  const int64_t rows = (n + kEncodeRows - 1) / kEncodeRows;
  const int64_t work = rows > nzero ? rows : nzero;
  encode_kernel<K, kSegs><<<grid_for(work), kThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename K>
int encode_words(const void* keys, const void* keys_dev, int nkeys,
                 const void* segs, const void* segs_dev, int nsegs,
                 int64_t n, void* out, void* zero, int64_t nzero,
                 cudaStream_t st) {
  if (segs_dev != nullptr)
    return launch_encode<K, 1>(keys, keys_dev, nkeys, segs, segs_dev, nsegs,
                               n, out, zero, nzero, st);
  if (nsegs <= kSmallSegs)
    return launch_encode<K, kSmallSegs>(keys, keys_dev, nkeys, segs, nullptr,
                                        nsegs, n, out, zero, nzero, st);
  if (nsegs <= kLargeSegs)
    return launch_encode<K, kLargeSegs>(keys, keys_dev, nkeys, segs, nullptr,
                                        nsegs, n, out, zero, nzero, st);
  return (int)cudaErrorInvalidValue;
}

template <typename K>
int sort_word(const void* word, int nbits, const void* perm_in, int64_t n,
              void* keys_a, void* keys_b, void* vals_a, void* vals_b,
              void* hist, void* base, void* status, void* tickets,
              int* where_out, cudaStream_t st) {
  const int npasses = (nbits + 7) / 8;
  const long long ntiles = (n + kSortTile - 1) / kSortTile;
  const long long nstatus = (long long)npasses * ntiles * kRadix;
  upsweep_kernel<K><<<(unsigned)ntiles, kSortThreads, 0, st>>>(
      (const K*)word, n, nbits, (u32*)hist, (u32*)status, nstatus);
  scan_kernel<<<1, kRadix, 0, st>>>((const u32*)hist, npasses, (u32*)base,
                                    (u32*)tickets);
  ScatterArgs<K> a;
  a.keys_in = (const K*)word;
  a.vals_in = (const int32_t*)perm_in;
  a.n = n;
  a.gather = perm_in != nullptr;
  int32_t* vout = (int32_t*)vals_a;
  K* kout = (K*)keys_a;
  for (int p = 0; p < npasses; ++p) {
    a.shift = 8 * p;
    a.bits = nbits - 8 * p < 8 ? nbits - 8 * p : 8;
    a.keys_out = p + 1 < npasses ? kout : nullptr;
    a.vals_out = vout;
    a.base = (const u32*)base + p * kRadix;
    a.status = (u32*)status + p * ntiles * kRadix;
    a.ticket = (u32*)tickets + p;
    scatter_kernel<K><<<(unsigned)ntiles, kSortThreads, 0, st>>>(a);
    a.keys_in = kout;
    a.vals_in = vout;
    a.gather = 0;
    kout = kout == (K*)keys_a ? (K*)keys_b : (K*)keys_a;
    vout = vout == (int32_t*)vals_a ? (int32_t*)vals_b : (int32_t*)vals_a;
  }
  *where_out = a.vals_in == (const int32_t*)vals_a ? 0 : 1;
  return (int)cudaGetLastError();
}

}  // namespace srt_sort

using namespace srt_sort;

extern "C" {

// keys: host array of nkeys SortKey descriptors (sort_key.cuh), 8 int64
// words each; keys_dev: a device copy of it, read instead when nkeys
// exceeds kParamKeys (else ignored).

// partials: 2 * nfields x grid int64 (nfields: the keys' summed field
// counts); column b holds block b's OR and AND of each field over its
// rows (row 2g, 2g + 1).  grid in [1, kPlanBlocks].
int srt_sort_plan(const void* keys, const void* keys_dev, int nkeys,
                  int nfields, int64_t n, void* partials, int grid,
                  void* stream) {
  PlanParams p;
  std::memset(&p, 0, sizeof(p));
  const int rc = fill_keys(keys, keys_dev, nkeys, p.keys, &p.keys_dev);
  if (rc != 0) return rc;
  const SortKey* hk = static_cast<const SortKey*>(keys);
  int total = 0;
  for (int k = 0; k < nkeys; ++k)
    total += key_nfields((int)hk[k].kind, (int)hk[k].width);
  if (total != nfields || grid < 1 || grid > kPlanBlocks || n < 0 ||
      n > kMaxRows)
    return (int)cudaErrorInvalidValue;
  p.partials = static_cast<u64*>(partials);
  p.n = n;
  p.nkeys = nkeys;
  p.nfields = nfields;
  plan_kernel<<<grid, kSortThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The nsegs segment words (host; segs_dev: a device copy, read instead
// when not null) pack each row's key bits into words: wide 0 one 32-bit
// word (out: n uint32), wide 1 64-bit words (out: words x n uint64,
// word-major, word 0 least significant).  zero: nzero uint32 set to 0 by
// the same launch (the histograms of srt_sort_word; may be null).
int srt_sort_encode(const void* keys, const void* keys_dev, int nkeys,
                    const void* segs, const void* segs_dev, int nsegs,
                    int wide, int64_t n, void* out, void* zero,
                    int64_t nzero, void* stream) {
  if (nsegs < 1 || n < 0 || nzero < 0 || (nzero > 0 && zero == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0 && nzero == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  return wide ? encode_words<u64>(keys, keys_dev, nkeys, segs, segs_dev,
                                  nsegs, n, out, zero, nzero, st)
              : encode_words<u32>(keys, keys_dev, nkeys, segs, segs_dev,
                                  nsegs, n, out, zero, nzero, st);
}

// Sort one word (nbits of it, key_bytes 4 or 8; word: n keys in row
// order) stably on top of perm_in (null: the rows in input order), one
// upsweep, one scan and one scatter a digit.  keys_a/keys_b: n keys each;
// vals_a/vals_b: n int32 each, distinct from perm_in; hist: kMaxPasses *
// 256 uint32, zero on entry (srt_sort_encode zeroes them); base:
// kMaxPasses * 256 uint32; status: ceil(nbits / 8) * ceil(n / kSortTile)
// * 256 uint32; tickets: kMaxPasses uint32.  *where_out: 0 = the
// permutation is in vals_a, 1 = in vals_b.
int srt_sort_word(const void* word, int key_bytes, int nbits,
                  const void* perm_in, int64_t n, void* keys_a, void* keys_b,
                  void* vals_a, void* vals_b, void* hist, void* base,
                  void* status, void* tickets, int* where_out,
                  void* stream) {
  if (n < 1 || n > kMaxRows || nbits < 1 || nbits > 8 * key_bytes ||
      (key_bytes != 4 && key_bytes != 8) || vals_a == perm_in ||
      vals_b == perm_in)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return key_bytes == 8
             ? sort_word<u64>(word, nbits, perm_in, n, keys_a, keys_b, vals_a,
                              vals_b, hist, base, status, tickets, where_out,
                              st)
             : sort_word<u32>(word, nbits, perm_in, n, keys_a, keys_b, vals_a,
                              vals_b, hist, base, status, tickets, where_out,
                              st);
}

// The constants the Python wrapper shares with this file, in the order of
// ops/sort.py's ``native.share_limits`` call: words a key descriptor, most
// keys in the parameters, most segments in the parameters, rows a tile,
// most plan blocks, passes a word, the largest row count.  Writes the
// first n of them.
int srt_sort_limits(int64_t* out, int n) {
  const int64_t v[] = {(int64_t)(sizeof(SortKey) / sizeof(u64)), kParamKeys,
                       kLargeSegs, kSortTile, kPlanBlocks, kMaxPasses,
                       kMaxRows};
  for (int i = 0; i < n && i < (int)(sizeof(v) / sizeof(v[0])); ++i)
    out[i] = v[i];
  return 0;
}

}  // extern "C"
