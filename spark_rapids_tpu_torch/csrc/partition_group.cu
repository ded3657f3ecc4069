// K10: group a batch's rows by shuffle partition id, stably.
//
// Replaces spark_rapids_tpu/exec/exchange.py:62 `_jit_group_by_part`, which
// XLA runs as a stable argsort of the ids, a [P, n] comparison for the
// counts and a cumsum for the starts (the slicing, `_jit_slice_part` :83,
// is a view in the port).  Here a counting sort takes the place of the
// comparison sort, in the onesweep form of K1's radix passes (Adinets and
// Merrill, "Onesweep", 2022) with the bucket as the digit.
//
// A row's bucket is its id, or P for ids outside [0, P) (they sort last
// and belong to no partition, as the reference's padding rows do).  With
// B = P + 1 buckets, B <= kRadix sorts in one pass of its bucket as one
// digit; a larger B in one stable pass a byte of the bucket, least
// significant first (two passes up to kMaxBuckets).
//
//   1. upsweep_kernel, one tile a block: the tile's rows counted per bucket
//      in shared memory (warp-aggregated, one shared atomic per distinct
//      bucket in a warp), added into B global counts.  The blocks also
//      zero the passes' tickets and look-back states.  The last block done
//      (a ticket of finished blocks) writes counts[P], the exclusive
//      starts[P] and each pass's digit bases, and zeroes the B counts and
//      its ticket again: the scratch's first part is zero between calls,
//      so no memset launch is needed.
//   2. scatter_kernel, one per pass, one tile a block in ticket order: each
//      warp ranks its 512 consecutive rows stably (equal digits counted in
//      warp order, then lane order); thread d owns digit d: the warps'
//      counts scanned in shared memory, the tile's count published, a
//      decoupled look-back over the earlier tiles' published counts for
//      the digit's prefix, four tiles read at once.  The tile's rows are
//      then sorted by digit in shared memory and written as digit runs, so
//      the stores coalesce: perm[base[d] + prefix[d] + rank].  Rows of one
//      partition keep their input order: stable, as argsort(stable=True)
//      is, so the final aggregate sees each map batch in map order.  A
//      later pass reads the bucket through the permutation so far.
// A warp finds its lanes of one bucket or digit with __match_any_sync up
// to 16 values and with a ballot a bit past that (peers_of).
// The wrapper gathers the columns through K3 with the permutation; only
// `counts` crosses to the host, once per map batch (ops/partition.py).
//
// Bound on the H100: bytes.  The ids are read twice (upsweep, scatter) and
// one int32 index is written per row; a second pass reads the permutation
// and the ids through it and writes the permutation again.
#include "common.cuh"

namespace srt_part {

using namespace srt;
typedef unsigned long long u64;
typedef unsigned int u32;

constexpr int kPartThreads = 256;
constexpr int kPartItems = 16;
constexpr int kPartTile = kPartThreads * kPartItems;  // rows a tile (4096)
constexpr int kPartWarps = kPartThreads / 32;
constexpr int kWarpRows = 32 * kPartItems;
// digit values a pass: the most buckets one pass sorts
constexpr int kRadix = 256;
static_assert(kRadix == kPartThreads, "a thread a digit value");
constexpr int kMaxPasses = 2;
// earlier tiles' states a digit's look-back reads at once
constexpr int kLookBack = 4;
// the widest values whose equal lanes __match_any_sync finds faster than a
// ballot a bit (H100: 9 buckets, 4 bits, faster by match; 201, 8 bits, by
// ballots)
constexpr int kMatchBits = 4;
// the most partitions: B = P + 1 buckets in two 8-bit passes, the
// upsweep's B shared counters within a block's shared memory
constexpr int kMaxParts = 14527;
constexpr int kMaxBuckets = kMaxParts + 1;
static_assert(kMaxBuckets <= kRadix * kRadix, "two passes");
// the scratch (uint32 words): the global counts and the upsweep's ticket,
// zero between calls; the passes' tickets and digit bases; then the
// passes' look-back states (uint64, 8-byte aligned)
constexpr long long kDoneWord = kMaxBuckets;
constexpr long long kTicketWord = kDoneWord + 1;
constexpr long long kBaseWord = kTicketWord + kMaxPasses;
constexpr long long kStatusWord =
    (kBaseWord + (long long)kMaxPasses * kRadix + 1) & ~1ll;

__device__ __forceinline__ int bucket_of(int32_t id, int num_parts) {
  return (id >= 0 && id < num_parts) ? id : num_parts;
}

// The lanes of the warp whose value v equals this lane's, over v's low
// nbits bits (nbits uniform across the warp): __match_any_sync, whose cost
// grows with the distinct values in the warp, up to kMatchBits bits, else
// one ballot a bit.
__device__ __forceinline__ unsigned peers_of(u32 v, int nbits) {
  if (nbits <= kMatchBits) return __match_any_sync(kFullMask, v);
  unsigned m = kFullMask;
  for (int i = 0; i < nbits; ++i) {
    const unsigned bit = (v >> i) & 1u;
    const unsigned b = __ballot_sync(kFullMask, bit);
    m &= bit ? b : ~b;
  }
  return m;
}

inline int bits_for(int values) {  // bits of values - 1, at least 1
  int b = 1;
  while ((1 << b) < values) ++b;
  return b;
}

// a count other blocks added at L2, read past this block's L1
__device__ __forceinline__ u32 load_l2(const u32* p) {
  return *reinterpret_cast<const volatile u32*>(p);
}

struct UpsweepArgs {
  const int32_t* ids;
  long long n;
  int num_parts, nbuckets, npasses;
  int nbits;    // bits of a bucket
  u32* scratch;
  u64* status;  // the passes' look-back states, nstatus words
  long long nstatus;
  int32_t* counts;
  int32_t* starts;
};

__global__ void __launch_bounds__(kPartThreads)
upsweep_kernel(const UpsweepArgs a) {
  using BlockScan = cub::BlockScan<u32, kPartThreads>;
  extern __shared__ u32 s_hist[];  // nbuckets counters
  __shared__ u32 s_dig[kMaxPasses][kRadix];
  __shared__ typename BlockScan::TempStorage s_scan;
  __shared__ int s_last;
  const int t = threadIdx.x, lane = t & 31;
  const int nbk = a.nbuckets;
  for (int b = t; b < nbk; b += kPartThreads) s_hist[b] = 0u;
  const long long stride = (long long)gridDim.x * kPartThreads;
  for (long long i = (long long)blockIdx.x * kPartThreads + t;
       i < a.nstatus; i += stride)
    a.status[i] = 0ull;
  if (blockIdx.x == 0 && t < kMaxPasses) a.scratch[kTicketWord + t] = 0u;
  __syncthreads();
  const long long base = (long long)blockIdx.x * kPartTile;
  int bk[kPartItems];  // every load of the tile in flight at once
#pragma unroll
  for (int k = 0; k < kPartItems; ++k) {
    const long long i = base + (long long)k * kPartThreads + t;
    bk[k] = i < a.n ? bucket_of(a.ids[i], a.num_parts) : -1;
  }
#pragma unroll
  for (int k = 0; k < kPartItems; ++k) {
    const unsigned amask = __ballot_sync(kFullMask, bk[k] >= 0);
    const unsigned peers = peers_of((u32)bk[k], a.nbits) & amask;
    if (bk[k] >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&s_hist[bk[k]], (u32)__popc(peers));
  }
  __syncthreads();
  u32* hist = a.scratch;
  for (int b = t; b < nbk; b += kPartThreads) {
    const u32 c = s_hist[b];
    if (c) atomicAdd(&hist[b], c);
  }
  __threadfence();
  __syncthreads();
  if (t == 0)
    s_last = atomicAdd(&a.scratch[kDoneWord], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  // the last block: the counts and starts, each pass's digit bases
  __threadfence();
  for (int i = t; i < kMaxPasses * kRadix; i += kPartThreads)
    (&s_dig[0][0])[i] = 0u;
  __syncthreads();
  u32 carry = 0u;
  for (int b0 = 0; b0 < nbk; b0 += kPartThreads) {
    const int b = b0 + t;
    const u32 c = b < nbk ? load_l2(&hist[b]) : 0u;
    u32 excl, agg;
    BlockScan(s_scan).ExclusiveSum(c, excl, agg);
    __syncthreads();
    if (b < a.num_parts) {
      a.counts[b] = (int32_t)c;
      a.starts[b] = (int32_t)(carry + excl);
    }
    if (b < nbk) {
      if (a.npasses == 1) {
        s_dig[0][b] = carry + excl;  // the bucket is the digit
      } else if (c) {
        atomicAdd(&s_dig[0][b & 255], c);
        atomicAdd(&s_dig[1][b >> 8], c);
      }
      hist[b] = 0u;
    }
    carry += agg;
  }
  __syncthreads();
  u32* bases = a.scratch + kBaseWord;
  if (a.npasses == 1) {
    bases[t] = s_dig[0][t];
  } else {
    for (int p = 0; p < kMaxPasses; ++p) {
      u32 excl;
      BlockScan(s_scan).ExclusiveSum(s_dig[p][t], excl);
      __syncthreads();
      bases[p * kRadix + t] = excl;
    }
  }
  if (t == 0) a.scratch[kDoneWord] = 0u;
}

struct ScatterArgs {
  const int32_t* ids;
  const int32_t* perm_in;  // null: the row index (the first pass)
  int32_t* perm_out;
  const u32* base;         // the pass's digit bases
  u64* status;             // ntiles * ndig look-back words, zeroed
  u32* ticket;             // zeroed
  long long n;
  int num_parts, shift, ndig;
  int nbits;               // bits of a digit value below ndig
};

// One stable counting pass over one byte of the bucket (see the head).
// Held to 80 registers: three blocks a multiprocessor.
__global__ void __launch_bounds__(kPartThreads, 3)
scatter_kernel(const ScatterArgs a) {
  using BlockScan = cub::BlockScan<u32, kPartThreads>;
  __shared__ u32 s_count[kPartWarps][kRadix];
  __shared__ int32_t s_vals[kPartTile];
  __shared__ uint8_t s_digit[kPartTile];
  __shared__ long long s_off[kRadix];
  __shared__ u32 s_tile;
  __shared__ typename BlockScan::TempStorage s_scan;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) s_tile = atomicAdd(a.ticket, 1u);
  for (int i = t; i < kPartWarps * kRadix; i += kPartThreads)
    (&s_count[0][0])[i] = 0u;
  __syncthreads();
  const long long tile = s_tile;
  const long long tbase = tile * kPartTile;
  const long long rest = a.n - tbase;
  const int tile_n = (int)(rest < kPartTile ? rest : kPartTile);
  const unsigned lt = (1u << lane) - 1u;
  const long long wbase = tbase + (long long)warp * kWarpRows + lane;
  int32_t val[kPartItems];
  u32 dig[kPartItems];
  u32 rank[kPartItems];
#pragma unroll
  for (int k = 0; k < kPartItems; ++k) {
    const long long i = wbase + 32 * k;
    val[k] = 0;
    dig[k] = 0u;
    if (i < a.n) {
      val[k] = a.perm_in != nullptr ? a.perm_in[i] : (int32_t)i;
      const int b = bucket_of(a.ids[val[k]], a.num_parts);
      dig[k] = ((u32)b >> a.shift) & (kRadix - 1);
    }
  }
  // warp-local stable ranks: items in (k, lane) order are in row order
#pragma unroll
  for (int k = 0; k < kPartItems; ++k) {
    const bool act = wbase + 32 * k < a.n;
    const unsigned amask = __ballot_sync(kFullMask, act);
    const unsigned peers = peers_of(dig[k], a.nbits) & amask;
    u32 c = 0;
    if (act) c = s_count[warp][dig[k]];
    __syncwarp();
    if (act) {
      rank[k] = c + __popc(peers & lt);
      if (lane == __ffs(peers) - 1) s_count[warp][dig[k]] = c + __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();
  // thread t owns digit value t: its warps' prefix and the tile's count
  u32 cnt = 0;
  for (int w = 0; w < kPartWarps; ++w) {
    const u32 c = s_count[w][t];
    s_count[w][t] = cnt;
    cnt += c;
  }
  unsigned long long excl = 0ull;
  if (t < a.ndig) {
    u64* mine = a.status + tile * a.ndig + t;
    lb_store(mine, (tile == 0 ? kLbPrefix : kLbAgg) | cnt);
    if (tile > 0) {
      // kLookBack earlier tiles read at once, nearest first; a tile that
      // has published nothing yet is read again from there
      for (long long j = tile - 1;;) {
        u64 s[kLookBack];
#pragma unroll
        for (int q = 0; q < kLookBack; ++q)
          s[q] = j - q >= 0 ? lb_load(a.status + (j - q) * a.ndig + t)
                            : kLbPrefix;
        int q = 0;
        bool found = false;
        for (; q < kLookBack; ++q) {
          if ((s[q] & ~kLbValue) == 0ull) break;
          excl += s[q] & kLbValue;
          if (s[q] & kLbPrefix) {
            found = true;
            break;
          }
        }
        if (found) break;
        j -= q;
      }
      lb_store(mine, kLbPrefix | (excl + cnt));
    }
  }
  u32 start;
  BlockScan(s_scan).ExclusiveSum(cnt, start);
  s_off[t] = (long long)a.base[t] + (long long)excl - (long long)start;
  for (int w = 0; w < kPartWarps; ++w) s_count[w][t] += start;
  __syncthreads();
  // the tile's rows sorted by digit in shared memory
#pragma unroll
  for (int k = 0; k < kPartItems; ++k) {
    if (wbase + 32 * k < a.n) {
      const u32 r = rank[k] + s_count[warp][dig[k]];
      s_vals[r] = val[k];
      s_digit[r] = (uint8_t)dig[k];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPartItems; ++k) {
    const int j = k * kPartThreads + t;
    if (j < tile_n) a.perm_out[s_off[s_digit[j]] + j] = s_vals[j];
  }
}

inline int passes_of(int nbuckets) { return nbuckets <= kRadix ? 1 : 2; }

inline long long tiles_of(int64_t n) {
  return (n + kPartTile - 1) / kPartTile;
}

// digit values of pass p
inline int digits_of(int nbuckets, int p) {
  if (passes_of(nbuckets) == 1) return nbuckets;
  return p == 0 ? kRadix : ((nbuckets - 1) >> 8) + 1;
}

inline long long status_words(int64_t n, int nbuckets) {
  long long s = 0;
  for (int p = 0; p < passes_of(nbuckets); ++p)
    s += tiles_of(n) * digits_of(nbuckets, p);
  return s;
}

}  // namespace srt_part

using namespace srt_part;

extern "C" {

// Launch 1: counts, starts: int32[num_parts]; the digit bases and zeroed
// look-back states in the scratch.  One launch of max(ceil(n / 4096), 1)
// blocks.  num_parts in [1, kMaxParts], n in [0, 2^31).  scratch: uint32
// words, kStatusWord and then two a tile and digit value of every pass
// (ops/partition.py ``scratch_words``); its first kTicketWord words (the
// counts and the upsweep's ticket) zero before the first call, which
// every call leaves zero.
int srt_partition_upsweep(const void* ids, int64_t n, int num_parts,
                          void* scratch, void* counts, void* starts,
                          void* stream) {
  if (num_parts < 1 || num_parts > kMaxParts || n < 0 ||
      n > 2147483647ll)
    return (int)cudaErrorInvalidValue;
  const int nbk = num_parts + 1;
  UpsweepArgs a;
  a.ids = (const int32_t*)ids;
  a.n = n;
  a.num_parts = num_parts;
  a.nbuckets = nbk;
  a.npasses = passes_of(nbk);
  a.nbits = bits_for(nbk);
  a.scratch = (u32*)scratch;
  a.status = (u64*)((u32*)scratch + kStatusWord);
  a.nstatus = status_words(n, nbk);
  a.counts = (int32_t*)counts;
  a.starts = (int32_t*)starts;
  const size_t smem = sizeof(u32) * (size_t)nbk;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        upsweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long nt = tiles_of(n);
  upsweep_kernel<<<(unsigned)(nt > 0 ? nt : 1), kPartThreads, smem,
                   (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Launch 2 (one per pass, pass = 0 .. passes - 1, after the upsweep):
// the stable order of the rows by bucket.  perm_in: null for pass 0, the
// previous pass's output after it; perm_out: int32[n].  Launches nothing
// for n == 0.
int srt_partition_scatter(const void* ids, int64_t n, int num_parts,
                          int pass, const void* perm_in, void* perm_out,
                          void* scratch, void* stream) {
  const int nbk = num_parts + 1;
  if (num_parts < 1 || num_parts > kMaxParts || pass < 0 ||
      pass >= passes_of(nbk) || n < 0 || n > 2147483647ll)
    return (int)cudaErrorInvalidValue;
  const long long nt = tiles_of(n);
  if (nt == 0) return (int)cudaGetLastError();
  if ((pass == 0) != (perm_in == nullptr) || perm_in == perm_out)
    return (int)cudaErrorInvalidValue;
  ScatterArgs a;
  a.ids = (const int32_t*)ids;
  a.perm_in = (const int32_t*)perm_in;
  a.perm_out = (int32_t*)perm_out;
  a.base = (const u32*)scratch + kBaseWord + (long long)pass * kRadix;
  u64* status = (u64*)((u32*)scratch + kStatusWord);
  for (int p = 0; p < pass; ++p) status += nt * digits_of(nbk, p);
  a.status = status;
  a.ticket = (u32*)scratch + kTicketWord + pass;
  a.n = n;
  a.num_parts = num_parts;
  a.shift = 8 * pass;
  a.ndig = digits_of(nbk, pass);
  a.nbits = bits_for(a.ndig);
  scatter_kernel<<<(unsigned)nt, kPartThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The constants the Python wrapper shares with this file, in the order of
// ops/partition.py's ``native.share_limits`` call: rows a tile, the most
// buckets one pass sorts, the most passes, the most partitions, the
// scratch's zero part (uint32 words).
int srt_partition_group_limits(int64_t* out, int n) {
  const int64_t v[] = {kPartTile, kRadix, kMaxPasses, kMaxParts,
                       kStatusWord};
  for (int i = 0; i < n && i < (int)(sizeof(v) / sizeof(v[0])); ++i)
    out[i] = v[i];
  return 0;
}

}  // extern "C"
